"""Time the bf16 VL-CABS forward of a checkout on one card.

    python3 radzero_torch/ops/time_vlcabs_fwd.py [--tree DIR] [--seed 0]

Times K5 ``vlcabs_fused`` at serving's shape (8 images x 1370 tokens x 768,
14 prompts) and K10 ``vlcabs_train_forward`` with its statistics at the
training step's (64 images x 512 sentences) through the entry points that
every tree of the port has, so one call can time two checkouts side by side
(``--tree`` puts DIR first on ``sys.path``; by default this file's
checkout). The timers are ``chip_smoke.py``'s, from this file's checkout:
device time is the sum of the device kernels of five calls under
torch.profiler, a call's share; CUDA-event time the median of 20 calls;
host time the host's microseconds a call over 200 calls enqueued back to
back (the card runs behind). Prints one JSON line with the tree, the card
and, per kernel, the three times and the device ms of each kernel that ran.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(REPO))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from radzero_torch.ops import vlcabs_fused as vf

    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def unit(n):
        q = torch.randn((n, cs.D), generator=gen, device="cuda")
        return (q / q.norm(dim=-1, keepdim=True)).to(torch.bfloat16)

    def tokens(b):
        return torch.randn((b, cs.L, cs.D), generator=gen, device="cuda").to(torch.bfloat16)

    k5 = (unit(cs.N), tokens(cs.B), torch.tensor(0.07, device="cuda"))
    k10 = (unit(cs.TN), tokens(cs.TB), torch.tensor([0.07], device="cuda"))
    calls = {"K5": lambda: vf.vlcabs_fused(*k5),
             "K10": lambda: vf.vlcabs_train_forward(*k10, with_stats=True)}
    out = {"tree": str(Path(args.tree).resolve()), "card": cs.card_line()}
    for name, fn in calls.items():
        kernels = cs.device_kernels(fn)
        out[name] = {"device_ms": sum(kernels.values()), "events_ms": cs.median_ms(fn),
                     "host_us": cs.host_us(fn), "kernels": kernels}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
