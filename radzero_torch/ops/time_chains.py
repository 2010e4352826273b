"""Time the bf16 backward chains K6, K8 and K9 of a checkout on one card,
launch by launch.

    python3 radzero_torch/ops/time_chains.py [--tree DIR] [--seed 0] [--calls 5]

At the training step's shapes (K6 and K8 at 64 images x 1370 tokens =
87 680 rows, K9 at 512 sentences x 32 tokens = 16 384 rows; D 768, F 3072,
bf16) runs ``fused_preattn_bwd``, ``fused_postattn_bwd`` and
``fused_mpnet_post_bwd`` through the entry points that every tree of the
port has, so one call can time two checkouts side by side (``--tree`` puts
DIR first on ``sys.path``; by default this file's checkout). Device time:
``--calls`` calls under torch.profiler, each device kernel of a call in
launch order with its duration, the median over the calls per launch; the
whole call's device time is the sum. CUDA-event time: ``chip_smoke.py``'s
median of 20 calls. Prints a table per chain and, last, one JSON line with
the tree, the card and, per chain, the times and the launches.

With ``--ablate`` (a tree whose ``_Chain`` has ``ln_bwd(..., sums=, stats=)``)
also K6's LayerNorm backward row pass alone at its shape, device time of
three variants on the same x and fp32 dh: as the chain runs it (the stored
statistics, the sums of dh * xn and dh), computing the statistics itself,
and from the stored statistics with no column sums at all (the pure row
pass that moving the sums into dh's GEMM epilogue would leave: that
design's best case for the pass).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def launches(fn, calls):
    """[(kernel name, median device ms)] of one call of ``fn``, in launch
    order, over ``calls`` calls under torch.profiler (empty sessions are
    profiled again, up to three times)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = sorted((e.time_range.start, e.name, e.time_range.elapsed_us() / 1e3)
                         for e in prof.events() if e.device_type == DeviceType.CUDA)
        if kernels and len(kernels) % calls == 0:
            break
    per = len(kernels) // calls
    return [(kernels[i][1], statistics.median(kernels[c * per + i][2] for c in range(calls)))
            for i in range(per)]


def chain_inputs(k, gen, m, d, f):
    import torch

    def rn(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std + mean).to(torch.bfloat16)

    if k == "K6":
        return (rn(m, d), rn(d, std=0.1, mean=1.0), rn(d, std=0.1), rn(d, 3 * d, std=0.02),
                rn(3 * d, std=0.02), rn(m, 3 * d))
    if k == "K8":
        return (rn(m, d), rn(m, d), rn(d, d, std=0.02), rn(d, std=0.02), rn(d, std=0.1, mean=1.0),
                rn(d, std=0.1, mean=1.0), rn(d, std=0.1), rn(d, f, std=0.02), rn(f, std=0.02),
                rn(f, d, std=0.02), rn(d, std=0.02), rn(d, std=0.1, mean=1.0), rn(m, d))
    return (rn(m, d), rn(m, d), rn(d, d, std=0.02), rn(d, std=0.02), rn(d, std=0.1, mean=1.0),
            rn(d, std=0.1), rn(d, f, std=0.02), rn(f, std=0.02), rn(f, d, std=0.02),
            rn(d, std=0.02), rn(d, std=0.1, mean=1.0), rn(d, std=0.1), rn(m, d))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(REPO))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from radzero_torch.ops import fused_layer as fl

    fns = {"K6": fl.fused_preattn_bwd, "K8": fl.fused_postattn_bwd, "K9": fl.fused_mpnet_post_bwd}
    rows = {"K6": cs.TB * cs.L, "K8": cs.TB * cs.L, "K9": cs.TN * cs.T_LEN}
    out = {"tree": str(Path(args.tree).resolve()), "card": cs.card_line()}
    for k, fn in fns.items():
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        ops = chain_inputs(k, gen, rows[k], cs.D, cs.F)
        call = lambda: fn(*ops)  # noqa: E731
        call()
        each = launches(call, args.calls)
        device = sum(t for _, t in each)
        events = cs.median_ms(call, reps=20, warmup=3)
        print(f"{k} bf16 at {rows[k]} rows ({out['tree']}): {len(each)} launches, "
              f"{device:.4f} ms of device time, {events:.4f} ms by CUDA events")
        for i, (name, t) in enumerate(each):
            print(f"  {i:2d} {t:8.4f} ms  {name[:110]}")
        out[k] = {"rows": rows[k], "device_ms": device, "events_ms": events,
                  "launches": [{"kernel": name, "device_ms": t} for name, t in each]}
        del ops
        torch.cuda.empty_cache()
    if args.ablate:
        out["K6 ln_bwd"] = ablate_ln_bwd(fl, args.seed, args.calls)
    print(json.dumps(out))
    return 0


def ablate_ln_bwd(fl, seed, calls):
    """K6's LayerNorm backward pass three ways -> {variant: device ms}."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, scale, bias, *_ = chain_inputs("K6", gen, 64 * 1370, 768, 3072)
    k = fl._Chain("ablate", x, 1)
    dh = torch.randn(x.shape, generator=gen, device="cuda")
    _, _, stats = k.ln_rows(x, scale, bias, 1e-6, want_stats=True)
    m, d = x.shape
    chunk, _ = fl.row_partition(m, fl._LN_BWD_BLOCKS_PER_SM * k.sms)
    out1 = k.t(m, d)

    def pure():  # no column sums: nothing written but dx
        k._ok(k.lib.rz_ln_bwd_rows(x.data_ptr(), 0, dh.data_ptr(), 1, scale.data_ptr(), None,
                                   None, None, stats.data_ptr(), out1.data_ptr(), None, None,
                                   None, 0, chunk, m, d, 1e-6, 1, k.stream))

    sums = fl._SUM_DH_XN | fl._SUM_DH
    variants = {
        "stored statistics, two sums (the route)":
            lambda: k.ln_bwd(x, dh, scale, 1e-6, sums=sums, stats=stats),
        "statistics computed in the pass, two sums":
            lambda: k.ln_bwd(x, dh, scale, 1e-6, sums=sums),
        "stored statistics, no sums (the epilogue design's row pass)": pure,
    }
    res = {}
    for name, fn in variants.items():
        fn()
        each = launches(fn, calls)
        res[name] = {"device_ms": sum(t for _, t in each),
                     "launches": [{"kernel": n, "device_ms": t} for n, t in each]}
        print(f"K6 ln_bwd, {name}: {res[name]['device_ms']:.4f} ms of device time in "
              f"{len(each)} launches")
    return res


if __name__ == "__main__":
    sys.exit(main())
