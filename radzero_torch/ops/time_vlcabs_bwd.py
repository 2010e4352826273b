"""Time the bf16 VL-CABS backward of a checkout on one card.

    python3 radzero_torch/ops/time_vlcabs_bwd.py [--tree DIR] [--seed 0] [--variants]

At the training step's shape (64 images x 512 sentences x 1370 tokens x
768, bf16) times the backward of ``vlcabs_fused_train`` alone (its forward
runs once, outside the timed calls, as in a training step) and K11
``vlcabs_train_bwd_dq`` and K12 ``vlcabs_train_bwd_dtn`` alone from the
forward's statistics, through the entry points that every tree of the port
has, so one call can time two checkouts side by side (``--tree`` puts DIR
first on ``sys.path``; by default this file's checkout). The timers are
``chip_smoke.py``'s, from this file's checkout: device time is the sum of
the device kernels of five calls under torch.profiler, a call's share;
CUDA-event time the median of 20 calls. With ``--variants`` (a tree with
``vlcabs_dq_from_ce``) also the device time of K11's product over K12's dc
both ways: added into dz ghat in place (gemm_sm90_kernel<EPI_ADDF_F32,
GEMM_BFWD>, the route) and written to a separate fp32 buffer
(<EPI_F32, GEMM_BFWD>, whose reduce would then read that buffer too).
Prints one JSON line with the tree, the card and, per call, the times and
the device ms of each kernel that ran.
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
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from radzero_torch.ops import _build
    from radzero_torch.ops import vlcabs_fused as vf

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    q = torch.randn((cs.TN, cs.D), generator=gen, device="cuda")
    q = (q / q.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
    t = torch.randn((cs.TB, cs.L, cs.D), generator=gen, device="cuda").to(torch.bfloat16)
    tau = torch.tensor([0.07], device="cuda")
    dz = torch.randn((cs.TN, cs.TB), generator=gen, device="cuda")
    leaves = [x.clone().requires_grad_(True) for x in (q, t, tau)]
    logits = vf.vlcabs_fused_train(*leaves)
    _, stats = vf.vlcabs_train_forward(q, t, tau, with_stats=True)
    calls = {"backward": lambda: torch.autograd.grad(logits, leaves, dz, retain_graph=True),
             "K11": lambda: vf.vlcabs_train_bwd_dq(q, t, tau, dz, stats=stats),
             "K12": lambda: vf.vlcabs_train_bwd_dtn(q, t, tau, dz, stats=stats)}
    out = {"tree": str(Path(args.tree).resolve()), "card": cs.card_line()}
    for name, fn in calls.items():
        kernels = cs.device_kernels(fn)
        out[name] = {"device_ms": sum(kernels.values()), "events_ms": cs.median_ms(fn),
                     "kernels": kernels}
    if args.variants:
        n, (b, l, d) = cs.TN, t.shape
        np_, lp = -(-n // 64) * 64, -(-l // 64) * 64
        tn = vf.vlcabs_rownorm(t)
        dg, dq_part = vf.vlcabs_bwd_rows(q, stats[1], dz, want_dq_part=True)
        ce, slots = vf.vlcabs_dtn_phase1(q, tn, dg, stats[0], tau, with_dtau=True)
        separate = torch.empty_like(dq_part)
        lib = _build.load()

        def to_buffer():  # the same product, written rather than added
            _build.check(lib.rz_vlcabs_fwd_g(
                ce.data_ptr(), tn.data_ptr(), separate.data_ptr(), n, 2 * np_, b, l, lp, d,
                _build.stream_ptr(tn)), "rz_vlcabs_fwd_g")

        # dq_part is spent by each call (the product is added into it): times only
        variants = {"in place": lambda: vf.vlcabs_dq_from_ce(ce, tn, dq_part, slots, n),
                    "separate buffer": to_buffer}
        out["dq product"] = {name: cs.device_kernels(fn) for name, fn in variants.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
