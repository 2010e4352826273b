#!/usr/bin/env python3
"""Drive radzero_torch once on one NVIDIA GPU: zero-shot serving and training.

    python3 chip_smoke.py [--seed 0] [--profile]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Phases, in order; any failure exits non-zero:

1. device: require CUDA; print the card (nvidia-smi), CUDA and nvcc versions;
2. build the kernels from radzero_torch/ops/csrc with nvcc (sm_90a); ptxas
   must report no spills for the Hopper kernels of K2 / K13 (forward) and
   K7 / K14 (backward);
3. each kernel against its plain PyTorch twin, in fp32 with TF32 off and in
   bf16, with CUDA-event timings (one call a sample, the host's launch
   included; K2, K7, K13 and K14 also by torch.profiler, which asserts the
   device kernels by name: fwd_sm90_kernel, and bwd_dq_sm90_kernel with
   bwd_dkdv_sm90_kernel, in bf16, the kernels of flash_attention.cu in fp32,
   and gives their device time alone; the lse the bf16 forward writes for
   the backward against its twin), library yardsticks where one PyTorch
   call computes the same function (K2 / K13 at 8 and 64 images, the
   backward alone of K7 / K14 and of K16 with its bias a leaf; for the GEMM
   kernels K1, K3, K4, K6, K8 and K9 the cuBLAS products alone, which no
   one call fuses with their LN, GELU or residual): K1
   fused_preattn, K2 flash_attention_packed, K3 fused_postattn and K5 vlcabs_fused at the
   serving shapes (8 images x 1370 tokens x 768, 12 heads, 14 prompts);
   K1-K3 again at the training step's 64 images (87 680 rows); K4
   fused_mpnet_post at 896 rows (14 prompts x 64 tokens) and at 16 384 (512
   sentences x 32); K10-K12, the VL-CABS training kernels, at 512 sentences
   x 64 images x 1370 tokens x 768 (value, dq, dt, dtau); K6
   fused_preattn_bwd, K7 flash_attention_packed_bwd and K8
   fused_postattn_bwd at 64 images and at 2 (2740 rows, no multiple of a
   tile), K9 fused_mpnet_post_bwd at 16 384 rows and at 1370, every
   gradient they return; K13 flash_attention at 8 and 64 images x 1370 x 12 x
   64, at L = 1408 with kv_len = 1370 and at 1 x 4097 tokens, K14
   flash_attention_bwd at 64 images, at 2 and at 4097 tokens, K15
   flash_attention_bias and K16 flash_attention_bias_bwd at 512 sentences x
   32 tokens, 14 x 64, 64 x 256 and 8 x 37 with real lengths drawn per
   sentence (dq, dk, dv, d bias; a second backward of K7, K14 and K16 gives
   the same bits);
4. serving: full-width RadZero (ViT-B/14 at 518, 2 align layers, MPNet
   12 x 768 with the default fuse_post=True) from seeded random weights in
   bf16 behind ServingEngine(max_batch=8, channels=1); 20 grayscale
   requests; checks of the answers and of the kernel launch counts, the
   kernel path against the eager reference path, and requests/s with
   p50/p99 latency of that burst and of five repeats on the warm engine;
5. scoring through ZeroShotScorer(fused_tower=False) with
   TextConfig(attn_impl="flash"): 16 seeded images at batch 8 x the 14
   prompts in bf16 with maps (the tower on K13, the align layers on K1-K3,
   MPNet on K15 and K4, K5), launch counts per batch and images/s; the same
   in fp32 against compute_logits(eager=True) with the repo's gate; and
   model_inference on one PNG in a temporary directory;
6. training: the same weights as fp32 masters, tower frozen (K1-K3 without
   a tape), at the defaults AlignConfig() / TextConfig() /
   LossConfig(train_impl="fused"): align layers on K1-K3 with the backward
   kernels K6-K8, every MPNet layer on K4 with K9, the loss on K10-K12; 6
   AdamW steps in bf16 on one seeded batch of 64 images x 512 sentences,
   with checks of the losses, the gradient norm and the launch counts per
   step, and images/s of the warm steps; then 3 steps of the eager-layer
   configuration (attn_impl="xla", fuse_post=False) beside it, step time
   and peak memory of both; then 3 steps with attn_impl="flash" in the align
   layers (K13 / K14) and the text tower (K15 / K16); then loss and every
   gradient leaf of all three against the all-eager path on an fp32 batch of
   2 images.

--profile also prints the kernels of one training step by device time
(torch.profiler). A line with {"kernels": [...]} reports every kernel; the
line before the last is the card's name and power limit; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
B, L, D, H, F, N = 8, 1370, 768, 12, 3072, 14
M_TEXT = N * 64                       # K4 in serving: 14 prompts x 64 tokens
TB, TN, T_LEN = 64, 512, 32           # training: images, sentences, tokens per sentence
M_RAGGED = 1370                       # K9 at a row count that is no multiple of any tile
L_PAD, L_LONG = 1408, 4097            # K13 / K14: a lane-padded tower (kv_len 1370), a long one
PEAK_FLOPS = {"bf16": 989e12}         # H100 SXM dense bf16, operations per second
PEAK_BYTES = 3.35e12                  # H100 SXM device memory, bytes per second
HOPPER_FWD = "fwd_sm90_kernel"        # K2 / K13 in bf16 (csrc/flash_fwd_sm90.cu)
HOPPER_BWD = ("bwd_dq_sm90_kernel", "bwd_dkdv_sm90_kernel")  # K7 / K14 in bf16 (flash_bwd_sm90.cu)
# the device kernels of one call, by dtype (csrc/flash_attention.cu in fp32)
ROUTES = {"fwd": {"bf16": (HOPPER_FWD,), "fp32": ("fwd_kernel<float",)},
          "bwd": {"bf16": HOPPER_BWD,
                  "fp32": ("bwd_stats_kernel<float", "bwd_dkdv_kernel<float",
                           "bwd_dq_kernel<float")}}
CHEXPERT = [
    "No Finding", "Enlarged Cardiomediastinum", "Cardiomegaly", "Lung Opacity",
    "Lung Lesion", "Edema", "Consolidation", "Pneumonia", "Atelectasis",
    "Pneumothorax", "Pleural Effusion", "Pleural Other", "Fracture", "Support Devices",
]
# tolerance per (kernel output, dtype): |kernel - plain| <= atol + rtol * |plain|.
# fp32: the JAX suite's parity tolerances. bf16: both sides round at the same
# points, but their fp32 sums run in another order, so a value near a bf16
# rounding boundary may round either way: up to 2 bf16 ulps (2^-7) relative at
# the output, plus such flips in the operands (LN output, softmax weights,
# normalised tokens) carried through the next product, < 2e-3 absolute here.
# K1, K3 and K4 end in a product whose left operand the kernel itself rounded
# (K1 the LN output, K3 and K4 the GELU output), over many rows: a rounded
# operand of size up to 8 (K1) or 4 (K3, K4) that falls the other way is off
# by one bf16 ulp, 2^-5 or 2^-6, and meets a weight of up to 0.1 (times ls2
# <= 1.4 in K3), so one flip moves an output entry by up to 3e-3 (K1) or
# 2e-3 (K3, K4) whatever the entry's own size, and a row of 768 or 3072
# operands may hold a few. Their bf16 atol is stated as a share of the
# largest |reference| entry (flag "scaled"): 2^-9 for K1 (|qkv| <= 3.4) and
# 2^-10 for K3 and K4 (|out| <= 7.5), each about 6e-3, two to three of the
# largest flips; the smoke passes with any --seed, not with one draw.
# K4 in fp32: the JAX suite's 2e-5; its twin and kernel use the exact erf,
# the TPU kernel a rational erf <= 1.5e-7 away. K10 value and K11/K12
# gradients in fp32: the JAX suite's rtol 1e-5 / atol 1e-6 and rtol 1e-4 /
# atol 1e-5. The gradients are sums over 64 images x 1370 tokens (dq, dtau)
# or 512 sentences (dt) of products of rounded factors, so in bf16 a rounding
# flip moves an entry by a share of the largest entry, not of itself: their
# bf16 atol is 2^-7 of the largest |reference| entry (flag "scaled").
# K6-K9 return gradients. fp32: the JAX suite's gradient tolerance, 2e-4 (5e-4
# for the MPNet chain), taken of the largest |reference| entry of each output.
# bf16: kernel and twin round the same factors (LN output, GELU output, dm,
# dh1, dproj; p, dO, dS) at the same points, but their fp32 sums run in
# another order, so a factor near a rounding boundary falls either way: one
# bf16 ulp, 2^-8 of that factor. Every output entry is a sum over hundreds to
# tens of thousands of such products (rows for the parameter gradients,
# columns or keys for dx, da and d qkv), so one flipped factor moves an entry
# by a share of the output's largest entry whatever the entry's own size, a
# row or column holds a few of them, and the entry's own final rounding may
# flip too (2^-8 of itself): 2^-7 of the largest |reference| entry plus 2^-7
# relative, as for K11 / K12.
# K13-K16. fp32: the JAX suite's (tests/test_flash_attention.py): rtol 1e-4 /
# atol 1e-5 for the forward, 2e-5 with the bias, rtol 1e-4 / atol 1e-4 for the
# gradients; a 1370- or 4097-key sum in another order stays a decade inside
# them. bf16: K13 rounds the softmax weights before P.V as K2 does, so K2's
# tolerance. K15 runs over 2 to 256 real keys of unit variance, where one
# softmax weight p can be near 1: a weight that rounds the other way in kernel
# and twin is off by one bf16 ulp of itself, 2^-8 p, and moves the output by
# 2^-8 p |v| whatever the output's own size, so its atol is 2^-9 of the largest
# |reference| entry (flag "scaled"; about 9e-3 at |ref| <= 4.5), about one such
# flip at p = 1/2. K2's fixed atol of 2e-3 was K15's at first and does not hold
# for every draw: with --seed 1 one entry of 12.6 M at 512 x 32 is 2.1e-3 off at
# |ref| 0.004, with --seed 2 one at 64 x 256 is 2.4e-3 off at |ref| 0.05 (103-104%
# of that tolerance), each a sum of cancelling terms that holds such a flip; the
# kernel was not changed for it (fp32 errors <= 1.4e-6). The share of K2's
# tolerance that each run's worst entry takes is printed beside. K14 and K16 round P, dO and dS as K7 does, so K7's (a share
# of the largest |reference| entry of each gradient). d(bias) is an fp32 sum of
# unrounded dS on both sides and only its order differs. K7 / K14 in bf16 run
# the Hopper kernels, which take delta as rowsum(dO O) over the forward's bf16
# output (FlashAttention-2's identity) where the TPU kernel and the twin take
# rowsum(dP P) with P unrounded: the same sum reassociated, off by the
# rounding of P before P.V and of O, ~2^-9 of |delta|, far below dS's own
# bf16 rounding; the tolerance is unchanged. The lse the bf16 forward writes
# (m + log2 l, fp32 from the same bf16 operands, sums in another order, ex2 to
# 2 ulp) is held to 1e-4 + 1e-5 relative: the order of 64 fp32 products moves
# a score by <= 64 2^-24 sum|q k| sl2, under 4e-5 at |q k| sums <= 50.
BWD_OUTPUTS = {
    "K14": ("dq", "dk", "dv"),
    "K16": ("dq", "dk", "dv", "dbias"),
    "K6": ("dx", "dln_s", "dln_b", "dw", "db"),
    "K7": ("dq", "dk", "dv"),
    "K8": ("dx", "da", "dwo", "dbo", "dls1", "dln_s", "dln_b", "dw1", "db1", "dw2", "db2",
           "dls2"),
    "K9": ("dx", "da", "dwo", "dbo", "dlnsa", "dlnba", "dw1", "db1", "dw2", "db2", "dlnso",
           "dlnbo"),
}
TOL = {
    ("K6", "fp32"): (2e-4, 0.0, "scaled"), ("K7", "fp32"): (2e-4, 0.0, "scaled"),
    ("K8", "fp32"): (2e-4, 0.0, "scaled"), ("K9", "fp32"): (5e-4, 0.0, "scaled"),
    ("K1", "fp32"): (2e-5, 2e-5), ("K2", "fp32"): (1e-4, 1e-4),
    ("K3", "fp32"): (2e-5, 2e-5), ("K5 logits", "fp32"): (1e-5, 1e-4),
    ("K5 maps", "fp32"): (1e-4, 1e-4),
    ("K4", "fp32"): (2e-5, 2e-5), ("K4 16384", "fp32"): (2e-5, 2e-5),
    ("K1 train", "fp32"): (2e-5, 2e-5), ("K2 train", "fp32"): (1e-4, 1e-4),
    ("K3 train", "fp32"): (2e-5, 2e-5),
    ("K10 logits", "fp32"): (1e-6, 1e-5), ("K11 dq", "fp32"): (1e-5, 1e-4),
    ("K11 dtau", "fp32"): (1e-5, 1e-4), ("K12 dt", "fp32"): (1e-5, 1e-4),
    ("K13", "fp32"): (1e-5, 1e-4), ("K15", "fp32"): (2e-5, 1e-4),
    ("K14", "fp32"): (1e-4, 1e-4), ("K16", "fp32"): (1e-4, 1e-4),
}
for _k in ("K2", "K2 train", "K5 logits", "K5 maps", "K10 logits", "K13"):
    TOL[(_k, "bf16")] = (2e-3, 2.0**-7)
TOL[("K15", "bf16")] = (2.0**-9, 2.0**-7, "scaled")
for _k in ("K1", "K1 train"):
    TOL[(_k, "bf16")] = (2.0**-9, 2.0**-7, "scaled")
for _k in ("K3", "K3 train", "K4", "K4 16384"):
    TOL[(_k, "bf16")] = (2.0**-10, 2.0**-7, "scaled")
for _k in ("K11 dq", "K11 dtau", "K12 dt", "K6", "K7", "K8", "K9", "K14", "K16"):
    TOL[(_k, "bf16")] = (2.0**-7, 2.0**-7, "scaled")
TOL[("lse", "bf16")] = (1e-4, 1e-5)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def compare(name, dtype_name, out, ref, tol=None, quiet=False):
    """``tol`` names the TOL entry when it is not ``name``; ``quiet`` prints
    nothing and returns (max_abs_err, worst share of the tolerance)."""
    import torch

    out, ref = out.float(), ref.float()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        fail(f"{name} {dtype_name}: shape {tuple(out.shape)} vs {tuple(ref.shape)} or non-finite")
    err = (out - ref).abs()
    rel = (err / ref.abs().clamp_min(1e-6)).max().item()
    atol, rtol, *scaled = TOL[(tol or name, dtype_name)]
    if scaled:
        atol *= ref.abs().max().item()
    used = (err / (atol + rtol * ref.abs())).max().item()  # worst share of the tolerance
    ok = used <= 1.0
    if quiet and ok:
        return err.max().item(), used
    print(f"  {name:10s} {dtype_name}: max_abs_err {err.max().item():.3e}  max_rel_err "
          f"{rel:.3e}  (atol {atol:.3g}, rtol {rtol:.3g}; |ref| <= {ref.abs().max().item():.3g}; "
          f"worst entry at {100 * used:.0f}% of its tolerance) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} {dtype_name} kernel disagrees with its plain twin")
    return err.max().item()


def device_kernels(fn, calls=5):
    """{device kernel name: its device ms a call} over ``calls`` calls of ``fn``
    under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def check_route(k, dname, fn, way="fwd"):
    """A call of K2 / K13 (way "fwd") or K7 / K14 ("bwd") runs exactly the
    device kernels of ROUTES: fwd_sm90_kernel, or bwd_dq_sm90_kernel and
    bwd_dkdv_sm90_kernel, in bf16 (never bwd_stats_kernel) -> their device ms
    a call (no host time)."""
    ran = device_kernels(fn)
    want = ROUTES[way][dname]
    if len(ran) != len(want) or not all(any(w in name for name in ran) for w in want):
        fail(f"{k} {dname}: expected the device kernels {want}, ran {list(ran)}")
    ms = sum(ran.values())
    names = ", ".join(f"{name[:48]}... {t:.4f}" for name, t in ran.items())
    print(f"  {k:10s} {dname}: torch.profiler: {names}; {ms:.4f} ms a call on the device")
    return ms


def host_us(fn, n=200):
    """Host microseconds a call of ``fn`` (the enqueue; the card runs behind)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def sdpa_backward_ms(q, k, v, g, bias=None, neg=None):
    """The yardstick of an attention backward: F.scaled_dot_product_attention's
    backward alone on (B, H, L, 64) operands, its forward run once outside the
    timed call; with ``bias`` (H, L, L) a leaf broadcast over the batch beside
    the key mask ``neg`` (B, L), so the time includes autograd's sum of the
    broadcast. -> (CUDA-event ms, device ms by torch.profiler); (None, None),
    with the reason printed, where no backend computes it."""
    import torch
    import torch.nn.functional as Fn

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    mask = None
    if bias is not None:
        leaves.append(bias.detach().requires_grad_(True))
        mask = (leaves[3][None] + neg[:, None, None, :]).to(q.dtype)
    try:
        out = Fn.scaled_dot_product_attention(*leaves[:3], attn_mask=mask)
        call = lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)  # noqa: E731
        return median_ms(call, reps=5, warmup=1), sum(device_kernels(call, calls=3).values())
    except RuntimeError as err:
        print(f"  no library backward: {str(err).splitlines()[0][:200]}")
        return None, None


def median_ms(fn, reps=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def kernel_inputs(dtype, gen):
    import torch

    def rn(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std + mean).to(dtype)

    def unit(n):
        q = torch.randn((n, D), generator=gen, device="cuda")
        return (q / q.norm(dim=-1, keepdim=True)).to(dtype)

    def k4(m):
        return (rn(m, D), rn(m, D), rn(D, D, std=0.02), rn(D, std=0.02),
                rn(D, std=0.1, mean=1.0), rn(D, std=0.1), rn(D, F, std=0.02), rn(F, std=0.02),
                rn(F, D, std=0.02), rn(D, std=0.02), rn(D, std=0.1, mean=1.0), rn(D, std=0.1))

    def k1(m):
        return (rn(m, D), rn(D, std=0.1, mean=1.0), rn(D, std=0.1), rn(D, 3 * D, std=0.02),
                rn(3 * D, std=0.02))

    def k3(m):
        return (rn(m, D), rn(m, D), rn(D, D, std=0.02), rn(D, std=0.02), rn(D, std=0.1, mean=1.0),
                rn(D, std=0.1, mean=1.0), rn(D, std=0.1), rn(D, F, std=0.02), rn(F, std=0.02),
                rn(F, D, std=0.02), rn(D, std=0.02), rn(D, std=0.1, mean=1.0))

    return {
        "K1": k1(B * L),
        "K2": (rn(B, L, 3 * D),),
        "K3": k3(B * L),
        "K5": (unit(N), rn(B, L, D), torch.tensor(0.07, device="cuda")),
        # the frozen tower of the training step: the same kernels at 64 images
        "K1 train": k1(TB * L),
        "K2 train": (rn(TB, L, 3 * D),),
        "K3 train": k3(TB * L),
        "K4": k4(M_TEXT),
        "K4 16384": k4(TN * T_LEN),
        # qn, tokens, tau, cotangent: the training step's VL-CABS operands
        "train": (unit(TN), rn(TB, L, D), torch.tensor([0.07], device="cuda"),
                  torch.randn((TN, TB), generator=gen, device="cuda")),
    }


def bounds(dtype_bytes=2):
    """Least time the card could take, per kernel, from the shapes above: the
    larger of bytes / memory rate (each input read once, each output written
    once) and operations / peak bf16 rate -> {key: (bound_ms, bound_by)}."""
    e = dtype_bytes
    vl = TB * TN * L * D  # one VL-CABS product is 2 * vl operations

    def tower(b):  # K1-K3 at b images -> (operations, bytes) each
        m = b * L
        return ((2 * m * D * 3 * D, (m * D + D * 3 * D + 3 * D + 2 * D + m * 3 * D) * e),
                (4 * b * H * L * L * (D // H), (b * L * 3 * D + b * L * D) * e),
                (2 * m * D * (D + 2 * F), (3 * m * D + D * D + 2 * D * F + 6 * D + F) * e))

    work = dict(zip(("K1", "K2", "K3"), tower(B)))
    work.update(zip(("K1 train", "K2 train", "K3 train"), tower(TB)))
    work |= {  # key: (operations, bytes)
        "K4": (2 * M_TEXT * D * (D + 2 * F),
               (3 * M_TEXT * D + D * D + 2 * D * F + 6 * D + F) * e),
        "K5": (4 * B * N * L * D, (B * L * D + N * D) * e + (B * N * L + N * B) * 4),
        # K10: s and g; K11: s, g, de, dc.tn; K12: s, g, de, dc^T.qn, e^T.dg
        "K10": (4 * vl, (TB * L * D + TN * D) * e + TN * TB * 4),
        "K11": (8 * vl, (TB * L * D + 2 * TN * D) * e + TN * TB * 4 + 4),
        "K12": (10 * vl, (2 * TB * L * D + TN * D) * e + TN * TB * 4),
    }
    for tag, b in (("", TB), (" 2img", 2)):  # K6-K8 at b images: operations, bytes
        m = b * L
        work |= {
            # dh = g W^T and dW = h^T g; reads x, g, W, writes dx, dW, db, dln
            "K6" + tag: (4 * m * D * 3 * D, (2 * m * D + m * 3 * D + 2 * D * 3 * D + 3 * D + 4 * D) * e),
            # S, dP, dV, dQ, dK per head; reads qkv, dout, out and lse, writes d qkv
            "K7" + tag: (10 * b * H * L * L * (D // H),
                         (2 * b * L * 3 * D + 2 * b * L * D) * e + b * H * L * 4),
            # the three forward products again and two backward products for each
            "K8" + tag: (6 * m * D * (D + 2 * F),
                         (5 * m * D + 2 * (D * D + 2 * D * F) + 2 * (6 * D + F)) * e),
        }
    for tag, m in (("", TN * T_LEN), (" 1370", M_RAGGED)):
        work["K9" + tag] = (6 * m * D * (D + 2 * F),
                            (5 * m * D + 2 * (D * D + 2 * D * F) + 2 * (6 * D + F)) * e)
    out = {}
    for k, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / PEAK_FLOPS["bf16"] * 1e3, nbytes / PEAK_BYTES * 1e3
        out[k] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


def check_no_spills(log):
    """ptxas must report no spills for the Hopper kernels: the forward of
    K2 / K13 and the two of the K7 / K14 backward."""
    if not log:
        print("  ptxas: no report in this process (the library was built before)")
        return
    lines = log.splitlines()
    for name in (HOPPER_FWD, *HOPPER_BWD):  # every instantiation of each
        at = [i for i, line in enumerate(lines) if "Compiling entry" in line and name in line]
        if not at:
            fail(f"ptxas reported no {name}")
        for i in at:
            report = " ".join(lines[i + 1:i + 4])
            if "0 bytes spill stores, 0 bytes spill loads" not in report:
                fail(f"{name} spills: {report}")
    print(f"  {', '.join((HOPPER_FWD, *HOPPER_BWD))} (K2 / K13, K7 / K14 in bf16): no spills")


def phase_kernels(seed):
    """Kernel vs plain twin at the main paths' shapes; returns rows for the JSON."""
    import torch
    import torch.nn.functional as Fn
    from radzero_torch.ops import fused_layer as fl
    from radzero_torch.ops import vlcabs_fused as vf

    pairs = {
        "K1": (fl.fused_preattn, fl.fused_preattn_plain, {}),
        "K2": (fl.flash_attention_packed, fl.flash_attention_packed_plain, {"n_heads": H}),
        "K3": (fl.fused_postattn, fl.fused_postattn_plain, {}),
        "K1 train": (fl.fused_preattn, fl.fused_preattn_plain, {}),
        "K2 train": (fl.flash_attention_packed, fl.flash_attention_packed_plain, {"n_heads": H}),
        "K3 train": (fl.fused_postattn, fl.fused_postattn_plain, {}),
        "K4": (fl.fused_mpnet_post, fl.fused_mpnet_post_plain, {}),
        "K4 16384": (fl.fused_mpnet_post, fl.fused_mpnet_post_plain, {}),
        "K5": (vf.vlcabs_fused, vf.vlcabs_fused_plain, {}),
    }
    train_pairs = {
        "K10": (vf.vlcabs_train_forward, vf.vlcabs_train_forward_plain),
        "K11": (vf.vlcabs_train_bwd_dq, vf.vlcabs_train_bwd_dq_plain),
        "K12": (vf.vlcabs_train_bwd_dtn, vf.vlcabs_train_bwd_dtn_plain),
    }
    rows = {}
    for dtype, dname in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        inputs = kernel_inputs(dtype, gen)
        print(f"kernels vs plain twins, {dname}:")
        for k, (kern, plain, kw) in pairs.items():
            args = inputs[k]
            out, ref = kern(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            if k == "K5":
                err = max(compare("K5 logits", dname, out[0], ref[0]),
                          compare("K5 maps", dname, out[1], ref[1]))
            else:
                err = compare(k, dname, out, ref)
            del out, ref
            reps = 10 if k.endswith(" train") else 20
            ms = median_ms(lambda: kern(*args, **kw), reps=reps)
            plain_ms = median_ms(lambda: plain(*args, **kw), reps=reps)
            print(f"  {k:10s} {dname}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms "
                  f"(median of {reps})")
            if k in ("K2", "K2 train"):  # the device kernel that ran, by name
                dev_ms = check_route(k, dname, lambda: kern(*args, **kw))
            if k == "K2 train" and dname == "bf16":  # the row statistic K7 reads, against its twin
                _, lse = fl.flash_attention_packed_lse(args[0], H)
                ref_lse = torch.cat([fl.flash_attention_packed_lse_plain(args[0][i:i + 8], H)[1]
                                     for i in range(0, TB, 8)])
                lse_err = compare("K2 lse", dname, lse, ref_lse, tol="lse")
                del lse, ref_lse
            if dname != "bf16":
                continue
            if k.endswith(" train"):  # beside the serving shape's numbers of the same kernel
                rows[k[:2]].update(max_abs_err_training=err, ms_training=ms,
                                   plain_ms_training=plain_ms)
            else:
                rows[k] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "library_ms": None}
            if k == "K2":
                rows[k]["device_ms"] = dev_ms
            elif k == "K2 train":
                rows["K2"].update(device_ms_training=dev_ms, max_abs_err_lse_training=lse_err)

        # K10-K12 through the autograd function, as the training step runs them
        qn, tokens, tau, dz = inputs["train"]
        leaves = [x.clone().requires_grad_(True) for x in (qn, tokens, tau)]
        logits = vf.vlcabs_fused_train(*leaves)
        grads = torch.autograd.grad(logits, leaves, dz)
        ref_logits = vf.vlcabs_train_forward_plain(qn, tokens, tau)
        ref_grads = vf.vlcabs_train_backward_plain(qn, tokens, tau, dz)
        torch.cuda.synchronize()
        errs = {"K10": compare("K10 logits", dname, logits.detach(), ref_logits),
                "K11": compare("K11 dq", dname, grads[0], ref_grads[0]),
                "K12": compare("K12 dt", dname, grads[1], ref_grads[1])}
        dtau_err = compare("K11 dtau", dname, grads[2], ref_grads[2])
        del leaves, logits, grads, ref_logits, ref_grads
        for k, (kern, plain) in train_pairs.items():
            args = (qn, tokens, tau) + ((dz,) if k != "K10" else ())
            ms = median_ms(lambda: kern(*args), reps=10)
            plain_ms = median_ms(lambda: plain(*args), reps=10)
            print(f"  {k:10s} {dname}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms (median of 10)")
            if dname == "bf16":
                rows[k] = {"max_abs_err": errs[k], "ms": ms, "plain_ms": plain_ms,
                           "library_ms": None}
        if dname == "bf16":
            rows["K11"]["max_abs_err_dtau"] = dtau_err
            # K2's yardstick, timed here and called nowhere in the port: one
            # library attention call on the unpacked heads of the same input,
            # at 8 images and at the training step's 64
            for key, tag, b in (("K2", "", B), ("K2 train", "_training", TB)):
                q, k_, v = (inputs[key][0][..., i * D:(i + 1) * D].reshape(b, L, H, D // H)
                            .transpose(1, 2) for i in range(3))
                lib = median_ms(lambda: Fn.scaled_dot_product_attention(q, k_, v))
                lib_dev = sum(device_kernels(
                    lambda: Fn.scaled_dot_product_attention(q, k_, v)).values())
                rows["K2"].update({f"library_ms{tag}": lib, f"library_device_ms{tag}": lib_dev})
                print(f"  {key:10s} yardstick: F.scaled_dot_product_attention {lib:.4f} ms "
                      f"(median of 20), {lib_dev:.4f} ms a call on the device")
                del q, k_, v
            # the host's share of a call at 1 x 128 tokens: the bf16 wrapper encodes three
            # TMA tensor maps, the fp32 one none
            small = torch.randn((1, 128, 3 * D), generator=gen, device="cuda")
            small16 = small.to(torch.bfloat16)
            us = {name: host_us(lambda: fl.flash_attention_packed(t, H))
                  for name, t in (("bf16", small16), ("fp32", small))}
            rows["K2"].update(host_us_bf16=us["bf16"], host_us_fp32=us["fp32"])
            print(f"  K2 host time a call at 1 x 128: bf16 {us['bf16']:.1f} us (three tensor maps "
                  f"encoded), fp32 {us['fp32']:.1f} us")
            del small, small16
        del inputs, qn, tokens, dz
        torch.cuda.empty_cache()
        backward_kernels(dtype, dname, gen, rows)
        attention_kernels(dtype, dname, gen, rows)
    cublas_products(rows)
    for k, (bound_ms, bound_by) in bounds().items():
        if k.endswith((" 2img", " 1370")):
            rows[k[:2]].update(bound_ms_small=bound_ms)
            ms = rows[k[:2]]["ms_small"]
        elif k.endswith(" train"):
            rows[k[:2]].update(bound_ms_training=bound_ms)
            ms = rows[k[:2]]["ms_training"]
        else:
            rows[k].update(bound_ms=bound_ms, bound_by=bound_by)
            ms = rows[k]["ms"]
        print(f"  {k:8s} bound {bound_ms:.4f} ms by {bound_by}: kernel at "
              f"{100 * bound_ms / ms:.1f}% of it (bf16)")
    return rows


def cublas_products(rows):
    """The yardsticks of the GEMM kernels, for which no one PyTorch call
    computes the fused function: each bf16 product of K1 (qkv), K3 and K4
    (o-proj, fc1, fc2) and the dX / dW products of K6, K8 and K9, as one
    cuBLAS call on operands of the same shapes (F.linear, or torch.mm of a^T g
    for a dW), timed alone, without the LN, GELU, residual or column sums the
    kernels fuse; called nowhere in the port -> rows[k]["cublas_products_ms.."]."""
    import torch
    import torch.nn.functional as Fn

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    def dx(m, k, n):  # (m, k) @ (k, n): a forward product or a dX = g W^T
        a, w = rn(m, k), rn(n, k)
        return median_ms(lambda: Fn.linear(a, w), reps=10)

    def dw(m, k, n):  # (k, m) @ (m, n): a dW = a^T g over m rows
        a, g = rn(m, k), rn(m, n)
        return median_ms(lambda: torch.mm(a.t(), g), reps=10)

    def post(m):  # o-proj, fc1, fc2
        return {"o-proj": dx(m, D, D), "fc1": dx(m, D, F), "fc2": dx(m, F, D)}

    def post_bwd(m):  # the dX and dW of fc2, fc1 and o-proj
        return {"dX fc2": dx(m, D, F), "dX fc1": dx(m, F, D), "dX o-proj": dx(m, D, D),
                "dW fc2": dw(m, F, D), "dW fc1": dw(m, D, F), "dW o-proj": dw(m, D, D)}

    cases = {  # (kernel, suffix of its row's keys, the kernel's row): the products
        ("K1", "", "K1"): lambda: {"qkv": dx(B * L, D, 3 * D)},
        ("K1", "_training", "K1"): lambda: {"qkv": dx(TB * L, D, 3 * D)},
        ("K3", "", "K3"): lambda: post(B * L),
        ("K3", "_training", "K3"): lambda: post(TB * L),
        ("K4", "", "K4"): lambda: post(M_TEXT),
        ("K4", "_16384", "K4 16384"): lambda: post(TN * T_LEN),
        ("K6", "", "K6"): lambda: {"dX": dx(TB * L, 3 * D, D), "dW": dw(TB * L, D, 3 * D)},
        ("K8", "", "K8"): lambda: post_bwd(TB * L),
        ("K9", "", "K9"): lambda: post_bwd(TN * T_LEN),
    }
    print("cuBLAS products alone (no LN, GELU or residual), bf16, one call each, median of 10:")
    for (k, sfx, row), make in cases.items():
        times = make()
        total = sum(times.values())
        rows[k][f"cublas_products_ms{sfx}"] = total
        kernel = rows[row]["ms" + ("" if row != k else sfx)]
        parts = ", ".join(f"{name} {ms:.4f}" for name, ms in times.items())
        print(f"  {k + sfx:12s} {parts}: {total:.4f} ms in all; the kernel {kernel:.4f} ms")
        torch.cuda.empty_cache()


def backward_kernels(dtype, dname, gen, rows):
    """K6-K9 against their plain twins at the training step's shapes (64
    images, 16 384 text rows) and at 2 images / 1370 rows; fills ``rows``
    from the bf16 run."""
    import torch
    from radzero_torch.ops import fused_layer as fl

    def rn(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std + mean).to(dtype)

    def k6(m):
        return (rn(m, D), rn(D, std=0.1, mean=1.0), rn(D, std=0.1), rn(D, 3 * D, std=0.02),
                rn(3 * D, std=0.02), rn(m, 3 * D))

    def k8(m):
        return (rn(m, D), rn(m, D), rn(D, D, std=0.02), rn(D, std=0.02), rn(D, std=0.1, mean=1.0),
                rn(D, std=0.1, mean=1.0), rn(D, std=0.1), rn(D, F, std=0.02), rn(F, std=0.02),
                rn(F, D, std=0.02), rn(D, std=0.02), rn(D, std=0.1, mean=1.0), rn(m, D))

    def k9(m):
        return (rn(m, D), rn(m, D), rn(D, D, std=0.02), rn(D, std=0.02),
                rn(D, std=0.1, mean=1.0), rn(D, std=0.1), rn(D, F, std=0.02), rn(F, std=0.02),
                rn(F, D, std=0.02), rn(D, std=0.02), rn(D, std=0.1, mean=1.0), rn(D, std=0.1),
                rn(m, D))

    def k7_inputs(b):  # qkv, dout, and in bf16 the forward's out and lse, which K7 reads
        qkv = rn(b, L, 3 * D)
        stats = fl.flash_attention_packed_lse(qkv, H) if dname == "bf16" else (None, None)
        return (qkv, rn(b, L, D), *stats)

    def k7(qkv, dout, out, lse):
        return fl.flash_attention_packed_bwd(qkv, H, dout, out=out, lse=lse)

    def k7_plain(qkv, dout, out, lse):  # the twin holds (images, 12, 1370, 1370) fp32: 8 at a time
        return torch.cat([fl.flash_attention_packed_bwd_plain(qkv[i:i + 8], H, dout[i:i + 8])
                          for i in range(0, qkv.shape[0], 8)])

    def thirds(t):
        return tuple(t[..., i * D:(i + 1) * D] for i in range(3))

    cases = {  # key: (make inputs, kernel, plain twin, outputs as a tuple)
        "K6": (lambda: k6(TB * L), fl.fused_preattn_bwd, fl.fused_preattn_bwd_plain, tuple),
        "K6 2img": (lambda: k6(2 * L), fl.fused_preattn_bwd, fl.fused_preattn_bwd_plain, tuple),
        "K7": (lambda: k7_inputs(TB), k7, k7_plain, thirds),
        "K7 2img": (lambda: k7_inputs(2), k7, k7_plain, thirds),
        "K8": (lambda: k8(TB * L), fl.fused_postattn_bwd, fl.fused_postattn_bwd_plain, tuple),
        "K8 2img": (lambda: k8(2 * L), fl.fused_postattn_bwd, fl.fused_postattn_bwd_plain, tuple),
        "K9": (lambda: k9(TN * T_LEN), fl.fused_mpnet_post_bwd, fl.fused_mpnet_post_bwd_plain,
               tuple),
        "K9 1370": (lambda: k9(M_RAGGED), fl.fused_mpnet_post_bwd,
                    fl.fused_mpnet_post_bwd_plain, tuple),
    }
    for k, (make, kern, plain, split) in cases.items():
        args = make()
        out, ref = split(kern(*args)), split(plain(*args))
        torch.cuda.synchronize()
        if k.startswith("K7") and not all(torch.equal(a, b)
                                          for a, b in zip(out, split(kern(*args)))):
            fail(f"{k} {dname}: a second backward gives other bits")
        worst = [compare(f"{k} {name}", dname, a, b, tol=k[:2], quiet=True)
                 for name, a, b in zip(BWD_OUTPUTS[k[:2]], out, ref)]
        scale = max(b.float().abs().max().item() for b in ref)
        i = max(range(len(worst)), key=lambda j: worst[j][1])
        del out, ref
        small = " " in k
        reps = 10 if small else 5
        ms = median_ms(lambda: kern(*args), reps=reps, warmup=1)
        plain_ms = median_ms(lambda: plain(*args), reps=3, warmup=1)
        err = max(w[0] for w in worst)
        lib = lib_dev = dev_ms = None
        if k == "K7":  # the device kernels that ran, by name
            dev_ms = check_route(k, dname, lambda: kern(*args), "bwd")
        if k == "K7" and dname == "bf16":  # the yardstick, called nowhere in the port
            heads = [t.reshape(TB, L, H, D // H).transpose(1, 2) for t in (*thirds(args[0]),
                                                                           args[1])]
            lib, lib_dev = sdpa_backward_ms(*heads)
            del heads
        print(f"  {k:10s} {dname}: {len(worst)} gradients, max_abs_err {err:.3e} (largest "
              f"|ref| {scale:.3g}); worst {BWD_OUTPUTS[k[:2]][i]} at {100 * worst[i][1]:.0f}% "
              f"of its tolerance; kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
              f"{'' if lib is None else f'  library backward {lib:.4f} ms'}"
              f"{'' if lib_dev is None else f' ({lib_dev:.4f} ms on the device)'} ok")
        if dname == "bf16":
            if small:
                rows[k[:2]].update(max_abs_err_small=err, ms_small=ms, plain_ms_small=plain_ms)
            else:
                rows[k] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "library_ms": lib}
                if k == "K7":
                    rows[k].update(device_ms=dev_ms, library_device_ms=lib_dev)
        del args
        torch.cuda.empty_cache()


def attention_kernels(dtype, dname, gen, rows):
    """K13-K16 against their plain twins: K13 / K14 at the tower's shapes (8
    images as the scorer batches them, 64 and 2 as the flash training step
    and its fp32 check do), at a lane-padded length with kv_len and at 4097
    tokens; K15 / K16 at the text shapes, real lengths drawn per sentence.
    Fills ``rows`` from the bf16 run, the bound of each case beside its time."""
    import torch
    import torch.nn.functional as Fn
    from radzero_torch.ops import flash_attention as fa

    hd, e = D // H, 2  # the bounds are the bf16 run's: 2 bytes an element

    def rn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

    def by_images(fn):  # the twins hold (images, 12, L, L) fp32: 8 images at a time
        def run(*ops, **kw):
            parts = [fn(*(t[i:i + 8] for t in ops), **kw) for i in range(0, ops[0].shape[0], 8)]
            if isinstance(parts[0], tuple):
                return tuple(torch.cat(col) for col in zip(*parts))
            return torch.cat(parts)
        return run

    def record(k, tag, worst, ms, plain_ms, ops, nbytes, library_ms=None):
        err, used = worst  # the largest error, the worst share of the tolerance
        t_ops, t_bytes = ops / PEAK_FLOPS["bf16"] * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms, by = max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
        lib = "" if library_ms is None else f"  library {library_ms:.4f} ms"
        print(f"  {k + ' ' + tag:14s} {dname}: max_abs_err {err:.3e} (worst entry at "
              f"{100 * used:.0f}% of its tolerance)  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
              f"{lib}  bound {bound_ms:.4f} ms by {by} ok")
        if dname != "bf16":
            return
        if not tag:
            rows[k] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": by}
        else:
            rows[k].update({f"max_abs_err_{tag}": err, f"ms_{tag}": ms,
                            f"plain_ms_{tag}": plain_ms, f"bound_ms_{tag}": bound_ms})
            if library_ms is not None:
                rows[k][f"library_ms_{tag}"] = library_ms

    def gradients(k, kern, plain, args, kw):
        """The backward kernel twice against its twin -> (largest error, worst share)."""
        out, again, ref = kern(*args, **kw), kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            fail(f"{k} {dname}: a second backward gives other bits")
        worst = [compare(f"{k} {name}", dname, a, b, tol=k, quiet=True)
                 for name, a, b in zip(BWD_OUTPUTS[k], out, ref)]
        return max(w[0] for w in worst), max(w[1] for w in worst)

    def timed(kern, plain, args, kw, big):
        reps, warm = (5, 1) if big else (20, 3)
        return (median_ms(lambda: kern(*args, **kw), reps=reps, warmup=warm),
                median_ms(lambda: plain(*args, **kw), reps=3 if big else reps, warmup=1))

    # images, tokens, kv_len, q / k / v as views of one packed product, the tags of K13 and K14
    for b, l, kv, packed, tag13, tag14 in (
            (B, L, None, True, "", None), (TB, L, None, True, "64img", ""),
            (2, L, None, True, None, "2img"), (B, L_PAD, L, False, "kv_len", "kv_len"),
            (1, L_LONG, None, False, "4097", "4097")):
        if packed:
            qkv = rn(b, l, 3 * D)
            q, k_, v = (qkv[..., i * D:(i + 1) * D].reshape(b, l, H, hd) for i in range(3))
        else:
            q, k_, v = (rn(b, l, H, hd) for _ in range(3))
        kw, big = {"kv_len": kv}, b * l * l > 5e7
        score_ops, tensor = b * H * l * (kv or l) * hd, b * l * D * e
        if tag13 is not None:
            plain = by_images(fa.flash_attention_plain)
            out, ref = fa.flash_attention(q, k_, v, **kw), plain(q, k_, v, **kw)
            torch.cuda.synchronize()
            err = compare(f"K13 {tag13}", dname, out, ref, tol="K13", quiet=True)
            del out, ref
            ms, plain_ms = timed(fa.flash_attention, plain, (q, k_, v), kw, big)
            lib = None
            if tag13 in ("", "64img"):  # the device kernel that ran, by name
                dev_ms = check_route(f"K13 {tag13}", dname, lambda: fa.flash_attention(q, k_, v))
                if dname == "bf16":  # the yardstick, called nowhere in the port
                    qh, kh, vh = (t.transpose(1, 2) for t in (q, k_, v))
                    lib = median_ms(lambda: Fn.scaled_dot_product_attention(qh, kh, vh))
                    lib_dev = sum(device_kernels(
                        lambda: Fn.scaled_dot_product_attention(qh, kh, vh)).values())
                    print(f"  K13 {tag13:9s} yardstick: F.scaled_dot_product_attention "
                          f"{lib:.4f} ms, {lib_dev:.4f} ms a call on the device")
                    del qh, kh, vh
            record("K13", tag13, err, ms, plain_ms, 4 * score_ops, 4 * tensor, lib)
            sfx = f"_{tag13}" if tag13 else ""
            if tag13 in ("", "64img") and dname == "bf16":
                rows["K13"].update({f"device_ms{sfx}": dev_ms, f"library_device_ms{sfx}": lib_dev})
            if dname == "bf16":  # the row statistic the bf16 backward reads, against its twin
                _, lse = fa.flash_attention_lse(q, k_, v, **kw)
                ref_lse = by_images(lambda *t, **a: fa.flash_attention_lse_plain(*t, **a)[1])(
                    q, k_, v, **kw)
                lse_err, used = compare(f"K13 lse {tag13}", dname, lse, ref_lse, tol="lse",
                                        quiet=True)
                print(f"  K13 lse {tag13:6s} bf16: max_abs_err {lse_err:.3e} (worst entry at "
                      f"{100 * used:.0f}% of its tolerance) ok")
                rows["K13"][f"max_abs_err_lse{sfx}"] = lse_err
                del lse, ref_lse
        if tag14 is not None:
            g = rn(b, l, H, hd)
            if dname == "bf16":  # the forward's output and row statistic, which K14 reads
                kw = {**kw, **dict(zip(("out", "lse"), fa.flash_attention_lse(q, k_, v, **kw)))}
            plain = by_images(fa.flash_attention_bwd_plain)
            err = gradients("K14", fa.flash_attention_bwd, plain, (q, k_, v, g), kw)
            ms, plain_ms = timed(fa.flash_attention_bwd, plain, (q, k_, v, g), kw, big)
            lib = lib_dev = dev_ms = None
            if not tag14:  # the device kernels that ran, by name
                dev_ms = check_route("K14", dname, lambda: fa.flash_attention_bwd(q, k_, v, g, **kw),
                                     "bwd")
            if not tag14 and dname == "bf16":  # the yardstick, called nowhere in the port
                lib, lib_dev = sdpa_backward_ms(*(t.transpose(1, 2) for t in (q, k_, v, g)))
            # reads q, k, v, g, the forward's out and lse; writes dq, dk, dv
            record("K14", tag14, err, ms, plain_ms, 10 * score_ops,
                   8 * tensor + b * H * l * 4, lib)
            if not tag14 and dname == "bf16":
                rows["K14"].update(device_ms=dev_ms, library_device_ms=lib_dev)
            del g, kw
        del q, k_, v
        torch.cuda.empty_cache()

    # sentences x tokens: the training step's, the serving prompts', a long text, a ragged one
    for s_, l, tag in ((TN, T_LEN, ""), (N, 64, "14x64"), (64, 256, "64x256"), (8, 37, "8x37")):
        q, k_, v, g = (rn(s_, l, H, hd) for _ in range(4))
        bias = (torch.randn((H, l, l), generator=gen, device="cuda") * 0.5)
        lengths = torch.randint(2, l + 1, (s_,), generator=gen, device="cuda")
        mask = (torch.arange(l, device="cuda")[None] < lengths[:, None]).float()
        neg = (1.0 - mask) * torch.finfo(dtype).min
        score_ops, tensor = s_ * H * l * l * hd, s_ * l * D * e
        extra = H * l * l * 4 + s_ * l * 4  # bias and mask, fp32
        args = (q, k_, v, bias, neg)
        out, ref = fa.flash_attention_bias(*args), fa.flash_attention_bias_plain(*args)
        torch.cuda.synchronize()
        err = compare(f"K15 {tag}", dname, out, ref, tol="K15", quiet=True)
        if dname == "bf16":  # the same errors under K2's fixed atol, which K15 is not held to
            a2, r2 = TOL[("K2", "bf16")]
            share = ((out.float() - ref.float()).abs() / (a2 + r2 * ref.float().abs())).max()
            print(f"  K15 {tag:10s} bf16: under K2's atol {a2:g} the worst entry is at "
                  f"{100 * share.item():.0f}% of its tolerance (not held to it)")
        del out, ref
        ms, plain_ms = timed(fa.flash_attention_bias, fa.flash_attention_bias_plain, args, {},
                             False)
        lib = None
        if not tag and dname == "bf16":  # the mask is summed before the timed call
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k_, v))
            both = (bias[None] + neg[:, None, None, :]).to(dtype)
            lib = median_ms(lambda: Fn.scaled_dot_product_attention(qh, kh, vh, attn_mask=both))
            del both
        record("K15", tag, err, ms, plain_ms, 4 * score_ops, 4 * tensor + extra, lib)
        args = (q, k_, v, bias, neg, g)
        err = gradients("K16", fa.flash_attention_bias_bwd, fa.flash_attention_bias_bwd_plain,
                        args, {})
        ms, plain_ms = timed(fa.flash_attention_bias_bwd, fa.flash_attention_bias_bwd_plain,
                             args, {}, False)
        lib = None
        if not tag and dname == "bf16":  # the yardstick: d(bias) includes the batch sum
            lib, _ = sdpa_backward_ms(*(t.transpose(1, 2) for t in (q, k_, v, g)), bias=bias,
                                      neg=neg)
        record("K16", tag, err, ms, plain_ms, 10 * score_ops,
               7 * tensor + extra + H * l * l * 4, lib)
        del q, k_, v, g, args
        torch.cuda.empty_cache()


def phase_slice(seed, card):
    import numpy as np
    import torch
    from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
    from radzero_torch.eval.serving import ServingEngine
    from radzero_torch.models.configuration import (
        AlignConfig, LossConfig, RadZeroConfig, TextConfig, ViTConfig,
    )
    from radzero_torch.models.radzero import compute_logits, init_radzero
    from radzero_torch.ops.layers import normalize_pixels

    cfg = RadZeroConfig(vision=ViTConfig(), text=TextConfig(), align=AlignConfig(),
                        loss=LossConfig())
    # the reference path: eager layers, eager VL-CABS and the eager MPNet chain
    cfg_eager = dataclasses.replace(cfg, text=TextConfig(fuse_post=False))
    n_layers = cfg.vision.num_hidden_layers + cfg.align.num_hidden_layers
    t0 = time.perf_counter()
    params = init_radzero(torch.Generator(device="cuda").manual_seed(seed), cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"slice: full-width RadZero, {n_params / 1e6:.1f} M parameters from seed {seed} "
          f"({time.perf_counter() - t0:.2f} s), {n_layers} DINOv2-style layers")

    tok = WhitespaceHashTokenizer(vocab_size=cfg.text.vocab_size, max_length=64)
    prompts = [f"There is {c}" for c in CHEXPERT]
    engine = ServingEngine(params, cfg, tok, device="cuda", max_batch=8, channels=1,
                           max_delay_ms=20.0)
    try:
        engine.register_prompt_set("chexpert", prompts)
        t0 = time.perf_counter()
        engine.warmup()
        print(f"  warmup batch of 8: {time.perf_counter() - t0:.3f} s")

        rng = np.random.default_rng(seed)
        images = rng.integers(0, 256, (20, 518, 518), dtype=np.uint8)
        want = ["patch" if i % 2 == 0 else "none" for i in range(20)]

        def burst():
            """Submit the 20 requests at once -> (answers, sorted latencies ms)."""
            done, answered = [0.0] * 20, threading.Semaphore(0)

            def on_done(_f, i):
                done[i] = time.perf_counter()
                answered.release()

            t_sub = time.perf_counter()
            futs = []
            for i in range(20):
                futs.append(engine.submit(images[i], "chexpert", want_maps=want[i]))
                futs[-1].add_done_callback(lambda f, i=i: on_done(f, i))
            if not all(answered.acquire(timeout=600) for _ in range(20)):
                fail("requests not answered within 600 s")
            return [f.result() for f in futs], sorted((d - t_sub) * 1e3 for d in done)

        reset_counters()
        engine.batch_sizes.clear()
        results, lat = burst()
        launches = read_counters()
        batches = list(engine.batch_sizes)
        # the same burst again on the warm engine: the spread of the metric
        repeats = [burst()[1] for _ in range(5)]
    finally:
        engine.close()

    for i, r in enumerate(results):
        p = r["probs"]
        if p.shape != (N,) or not np.all(np.isfinite(p)) or not np.all((p > 0) & (p < 1)):
            fail(f"request {i}: probs {p}")
        m = r["similarity_maps"]
        if want[i] == "patch" and (m is None or m.shape != (N, 37, 37) or not np.all(np.isfinite(m))):
            fail(f"request {i}: maps {None if m is None else m.shape}")
        if want[i] == "none" and m is not None:
            fail(f"request {i}: maps returned though none were asked for")
    nb = len(batches)
    # per batch: 14 DINOv2-style layers, one text-tower forward of 12 MPNet
    # layers (K4 once per layer), one VL-CABS; no training kernel
    expect = expected(fused_preattn=n_layers * nb, flash_attention_packed=n_layers * nb,
                      fused_postattn=n_layers * nb,
                      fused_mpnet_post=cfg.text.num_hidden_layers * nb, vlcabs_fused=nb)
    print(f"  20 requests answered in batches {batches}; launches {launches}")
    if batches != [8, 8, 4] or launches != expect:
        fail(f"expected batches [8, 8, 4] and launches {expect}")

    def stats(lat):  # -> requests/s, p50, p99 of one burst
        return (20e3 / lat[-1], lat[len(lat) // 2],
                lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)])

    rps, p50, p99 = stats(lat)
    print(f"  serving: {rps:.3f} requests/s, latency p50 {p50:.1f} ms p99 {p99:.1f} ms "
          f"(20 requests submitted at once, max_batch 8, bf16, fuse_post=True) on {card}")
    rep = [stats(r) for r in repeats]
    med = [sorted(col)[len(col) // 2] for col in zip(*rep)]
    print(f"  serving, the burst 5 times more: requests/s {[round(r[0], 1) for r in rep]}; "
          f"median {med[0]:.3f} requests/s, p50 {med[1]:.1f} ms, p99 {med[2]:.1f} ms")

    # the kernel path against the eager reference path on the first batch
    ids, mask = (torch.as_tensor(a, dtype=torch.long, device="cuda") for a in tok(prompts))
    u8 = torch.as_tensor(images[:8, :, :, None], device="cuda").expand(8, 518, 518, 3)
    probs = np.stack([r["probs"] for r in results[:8]])
    with torch.inference_mode():
        for dtype, pv_n, ptree in ((torch.bfloat16, 8, engine.params), (torch.float32, 2, params)):
            pv = normalize_pixels(u8[:pv_n], engine.image_spec.mean, engine.image_spec.std,
                                  dtype=dtype)
            kern = compute_logits(ptree, cfg, pv, ids, mask, dtype=dtype)
            ref = compute_logits(ptree, cfg_eager, pv, ids, mask, dtype=dtype, eager=True)
            lk, lr = kern["logits"].float(), ref["logits"].float()
            sk, sr = kern["similarity_scores"].float(), ref["similarity_scores"].float()
            lerr = (lk - lr).abs().max().item()
            mae = (sk - sr).abs().mean().item()
            name = "bf16" if dtype == torch.bfloat16 else "fp32"
            print(f"  kernel path vs eager path, {name}, {pv_n} images: logits max_abs_err "
                  f"{lerr:.3e} (|logit| <= {lr.abs().max().item():.3f}), map MAE {mae:.3e}, "
                  f"map max_abs_err {(sk - sr).abs().max().item():.3e}")
            if dtype == torch.bfloat16:
                same = np.abs(probs - torch.sigmoid(lk).cpu().numpy()).max()
                print(f"  engine probs vs sigmoid(kernel-path logits): max_abs_err {same:.3e}")
                # bf16: the eager path rounds at more points (o-proj, fc1,
                # residual adds, MPNet's LayerNorm inputs) than the fused
                # kernels, across 14 + 12 layers
                if same > 1e-5 or lerr > 0.25 or mae > 0.05:
                    fail("bf16 slice disagrees with the eager path or the engine output")
            else:
                # the repo's compute_logits gate (tests/test_radzero_model.py)
                close = torch.allclose(lk, lr, rtol=1e-3, atol=2e-4)
                if not close or mae >= 1e-3:
                    fail("fp32 slice disagrees with the eager path")
    return launches, params


def phase_scorer(seed, card, params):
    """The attn_impl="flash" serving path through ZeroShotScorer and
    model_inference; returns the launches of the bf16 scoring run."""
    import tempfile

    import numpy as np
    import torch
    from PIL import Image
    from radzero_torch.data.processing import BlipStyleImageProcessor
    from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
    from radzero_torch.eval.api import model_inference
    from radzero_torch.eval.scorer import ZeroShotScorer
    from radzero_torch.models.configuration import RadZeroConfig, TextConfig
    from radzero_torch.models.radzero import compute_logits

    cfg = RadZeroConfig(text=TextConfig(attn_impl="flash"))
    # the reference path: eager layers, eager attention and chain, eager VL-CABS
    cfg_eager = RadZeroConfig(text=TextConfig(fuse_post=False))
    tok = WhitespaceHashTokenizer(vocab_size=cfg.text.vocab_size, max_length=64)
    proc = BlipStyleImageProcessor(size=cfg.vision.img_size)
    prompts = [f"There is {c}" for c in CHEXPERT]
    rng = np.random.default_rng(seed + 3)
    # 16 grayscale studies at other sizes than the model's: the host resize does real work
    images = [rng.integers(0, 256, (640 + 16 * i, 600), dtype=np.uint8) for i in range(16)]
    n_tower, n_align = cfg.vision.num_hidden_layers, cfg.align.num_hidden_layers
    n_text = cfg.text.num_hidden_layers

    def load(im):
        return im

    print('scorer: ZeroShotScorer(fused_tower=False), ViTConfig.attn_impl="flash", '
          'TextConfig(attn_impl="flash"), 16 images at batch 8 x 14 prompts with maps')
    scorer = ZeroShotScorer(params, cfg, proc, tok, batch_size=8, dtype=torch.bfloat16,
                            fused_tower=False)
    scorer.score(images[:8], load, prompts, need_scores=True)  # warm: allocators, cuBLAS
    runs = []
    for _ in range(3):
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, maps = scorer.score(images, load, prompts, need_scores=True)
        runs.append(time.perf_counter() - t0)
        launches = read_counters()
    n_patches = (cfg.vision.img_size // cfg.vision.patch_size) ** 2
    if logits.shape != (16, N) or maps.shape != (16, N, n_patches):
        fail(f"scorer: shapes {logits.shape}, {maps.shape}")
    if not (np.isfinite(logits).all() and np.isfinite(maps).all()):
        fail("scorer: non-finite logits or maps")
    nb = 2
    expect = expected(flash_attention=n_tower * nb, fused_preattn=n_align * nb,
                      flash_attention_packed=n_align * nb, fused_postattn=n_align * nb,
                      flash_attention_bias=n_text * nb, fused_mpnet_post=n_text * nb,
                      vlcabs_fused=nb)
    print(f"  launches of one run (2 batches) {launches}")
    if launches != expect:
        fail(f"scorer: expected launches {expect}")
    # the card's share of a batch: the flash path and the fused K1-K3 path in turns
    pv = torch.as_tensor(proc(images[:8])["pixel_values"]).to("cuda", torch.bfloat16)
    ids, mask = scorer.encode_prompts(prompts)
    with torch.inference_mode():
        device_ms = [median_ms(lambda: compute_logits(scorer.params, cfg, pv, ids, mask,
                                                      dtype=torch.bfloat16, fused_towers=fused),
                               reps=10) for fused in (False, True, True, False)]
    print(f"  one batch of 8 x 14 on the card: {device_ms[0]:.2f} / {device_ms[3]:.2f} ms with "
          f"fused_towers=False (K13, cuBLAS products), {device_ms[1]:.2f} / {device_ms[2]:.2f} "
          f"ms with fused_towers=True (K1-K3)")
    del pv
    med = sorted(runs)[1]
    print(f"  scorer: {16 / med:.2f} images/s, median {med:.4f} s of 3 runs of 16 images "
          f"({[round(r, 4) for r in runs]} s; bf16, batch 8, host resize on 8 threads) on {card}")
    del scorer

    # fp32 (the scorer turns TF32 off itself) against the eager path, the repo's gate
    scorer = ZeroShotScorer(params, cfg, proc, tok, batch_size=2, dtype=torch.float32,
                            fused_tower=False)
    logits, maps = scorer.score(images[:2], load, prompts, need_scores=True)
    pv = torch.as_tensor(proc(images[:2])["pixel_values"], device="cuda")
    ids, mask = (torch.as_tensor(a, dtype=torch.long, device="cuda") for a in tok(prompts))
    with torch.inference_mode():
        ref = compute_logits(params, cfg_eager, pv, ids, mask, dtype=torch.float32, eager=True)
    lr, sr = ref["logits"].cpu(), ref["similarity_scores"].cpu()
    lk, sk = torch.from_numpy(logits), torch.from_numpy(maps)
    mae = (sk - sr).abs().mean().item()
    print(f"  scorer vs eager path, fp32, 2 images: logits max_abs_err "
          f"{(lk - lr).abs().max().item():.3e} (|logit| <= {lr.abs().max().item():.3f}), map MAE "
          f"{mae:.3e}, map max_abs_err {(sk - sr).abs().max().item():.3e}")
    if not torch.allclose(lk, lr, rtol=1e-3, atol=2e-4) or mae >= 1e-3:
        fail("scorer: the fp32 flash path disagrees with the eager path")
    del scorer

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "study.png")
        Image.fromarray(images[0]).save(path)  # one 8-bit grayscale PNG
        t0 = time.perf_counter()
        prob, smap = model_inference(path, prompts[:3], tok, proc, (params, cfg))
        seconds = time.perf_counter() - t0
    h, w = images[0].shape[:2]
    if prob.shape != (3,) or smap.shape != (3, h, w):
        fail(f"model_inference: shapes {prob.shape}, {smap.shape}")
    if not (np.all((prob > 0) & (prob < 1)) and np.all((smap >= 0) & (smap <= 1))):
        fail("model_inference: probabilities or maps outside [0, 1]")
    close = np.abs(prob - 1.0 / (1.0 + np.exp(-logits[0, :3]))).max()
    print(f"  model_inference on one {w} x {h} PNG, 3 texts, fp32: probs {np.round(prob, 4)}, "
          f"map {smap.shape}, {seconds:.3f} s; against the scorer's logits {close:.3e}")
    if close > 1e-4:
        fail("model_inference disagrees with the scorer on the same image")
    return launches


def _counters():
    from radzero_torch.ops import flash_attention as fa
    from radzero_torch.ops import fused_layer as fl
    from radzero_torch.ops import vlcabs_fused as vf

    return (fl.fused_preattn, fl.flash_attention_packed, fl.fused_postattn, fl.fused_mpnet_post,
            vf.vlcabs_fused, fl.fused_preattn_bwd, fl.flash_attention_packed_bwd,
            fl.fused_postattn_bwd, fl.fused_mpnet_post_bwd, vf.vlcabs_train_forward,
            vf.vlcabs_train_bwd_dq, vf.vlcabs_train_bwd_dtn, fa.flash_attention,
            fa.flash_attention_bwd, fa.flash_attention_bias, fa.flash_attention_bias_bwd)


def reset_counters():
    for c in _counters():
        c.launches = 0


def read_counters():
    return {c.__name__: c.launches for c in _counters()}


def expected(**launches):
    """The launch counts a path must show: 0 for every kernel but those named."""
    return {c.__name__: 0 for c in _counters()} | launches


def train_batch(seed, n_images, n_sentences, vocab_size, pixel_dtype):
    """One seeded batch on the card: 518 x 518 images, n_sentences / n_images
    sentences each of 6..32 tokens in T_LEN slots (<s> ... </s>, pad 1)."""
    import numpy as np
    import torch
    from radzero_torch.eval.serving import ImageSpec
    from radzero_torch.ops.layers import normalize_pixels

    rng = np.random.default_rng(seed + 1)
    u8 = torch.as_tensor(rng.integers(0, 256, (n_images, 518, 518, 1), dtype=np.uint8),
                         device="cuda").expand(n_images, 518, 518, 3)
    ids = np.full((n_sentences, T_LEN), 1, np.int64)
    mask = np.zeros((n_sentences, T_LEN), np.int64)
    for i in range(n_sentences):
        k = int(rng.integers(6, T_LEN + 1))
        ids[i, :k] = rng.integers(3, vocab_size, k)
        ids[i, 0], ids[i, k - 1] = 0, 2
        mask[i, :k] = 1
    spec = ImageSpec()
    return {
        "pixel_values": normalize_pixels(u8, spec.mean, spec.std, dtype=pixel_dtype),
        "input_ids": torch.as_tensor(ids, device="cuda"),
        "attention_mask": torch.as_tensor(mask, device="cuda"),
        "group_map": torch.arange(n_images, device="cuda").repeat_interleave(
            n_sentences // n_images),
        "row_mask": torch.ones(n_sentences, device="cuda"),
    }


def phase_training(seed, card, params, profile):
    """AdamW steps at full width through make_train_step: 6 at the default
    configuration (every layer on its kernels), 3 at the eager-layer one, 3
    with attn_impl="flash"; returns the launches of one default step and of
    one flash step."""
    import torch
    from radzero_torch.models.configuration import (
        AlignConfig, LossConfig, RadZeroConfig, TextConfig, ViTConfig,
    )
    from radzero_torch.models.radzero import forward_train
    from radzero_torch.train.optim import (
        build_optimizer, merge_params, partition_params, tree_leaves,
    )
    from radzero_torch.train.step import make_train_step

    # the JAX package's own defaults: attn_impl="fused_vjp", fuse_post=True
    cfg = RadZeroConfig(vision=ViTConfig(), align=AlignConfig(), text=TextConfig(),
                        loss=LossConfig(train_impl="fused"))
    # eager align layers and eager MPNet chain under autograd, the loss on K10-K12
    cfg_eager_layers = dataclasses.replace(cfg, align=AlignConfig(attn_impl="xla"),
                                           text=TextConfig(fuse_post=False))
    cfg_flash = dataclasses.replace(cfg, align=AlignConfig(attn_impl="flash"),
                                    text=TextConfig(attn_impl="flash"))
    modules = ("align_transformer", "text_model", "loss_fns")
    n_images, n_sentences = TB, TN

    def run(c, steps, profile_it=False):
        # fresh fp32 masters each time: the step updates them in place
        trainable, frozen = partition_params(params, modules)
        trainable = _clone(trainable)
        opt, _ = build_optimizer(learning_rate=1e-4, warmup_steps=1, total_steps=6)
        state = opt.init(trainable)
        step = make_train_step(c, opt, dtype=torch.bfloat16)
        batch = train_batch(seed, n_images, n_sentences, c.text.vocab_size, torch.bfloat16)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        history, seconds, per_step = [], [], []
        for _ in range(steps):
            reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainable, state, losses = step(trainable, frozen, state, batch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            per_step.append(read_counters())
            history.append({k: v.item() for k, v in losses.items()})
        peak = torch.cuda.max_memory_allocated()
        if profile_it:
            profile_step(lambda: step(trainable, frozen, state, batch))
        return history, seconds, per_step, peak

    def report(label, history, seconds, per_step, peak, expect):
        print(f"  {label}: peak memory {peak / 2**30:.2f} GiB")
        for i, (h, sec) in enumerate(zip(history, seconds)):
            print(f"    step {i}: loss {h['loss']:.5f}  grad_norm {h['grad_norm']:.4f}  {sec:.3f} s")
        print(f"    launches per step {per_step[-1]}")
        if any(c != expect for c in per_step):
            fail(f"{label}: expected launches per step {expect}, got {per_step}")
        for h in history:
            if not all(math.isfinite(v) for v in h.values()) or h["grad_norm"] <= 0.0:
                fail(f"{label}: non-finite loss or a dead gradient: {h}")
        warm = sorted(seconds[1:])
        med = warm[len(warm) // 2]
        print(f"    {n_images / med:.2f} images/s ({n_sentences / med:.1f} sentences/s), median "
              f"step {med:.4f} s of steps 1-{len(seconds) - 1} (step 0 {seconds[0]:.3f} s) "
              f"on {card}")
        return med

    n_train = sum(t.numel() for t in tree_leaves(partition_params(params, modules)[0]))
    print(f"training: {n_images} images x {n_sentences} sentences x {T_LEN} tokens, bf16 compute, "
          f"fp32 masters, {n_train / 1e6:.1f} M trainable parameters (align, text, loss; tower "
          f"frozen), lr 1e-4 after 1 warmup step")
    n_tower, n_align = cfg.vision.num_hidden_layers, cfg.align.num_hidden_layers
    n_text = cfg.text.num_hidden_layers
    loss_kernels = {"vlcabs_train_forward": 1, "vlcabs_train_bwd_dq": 1,
                    "vlcabs_train_bwd_dtn": 1}
    expect = expected(fused_preattn=n_tower + n_align, flash_attention_packed=n_tower + n_align,
                      fused_postattn=n_tower + n_align, fused_mpnet_post=n_text,
                      fused_preattn_bwd=n_align, flash_attention_packed_bwd=n_align,
                      fused_postattn_bwd=n_align, fused_mpnet_post_bwd=n_text, **loss_kernels)
    history, seconds, per_step, peak = run(cfg, 6, profile_it=profile)
    med = report('defaults (attn_impl="fused_vjp", fuse_post=True: K1-K4, K6-K12)', history,
                 seconds, per_step, peak, expect)
    if not history[-1]["loss"] < history[1]["loss"]:
        fail(f"training: loss did not fall: {[h['loss'] for h in history]}")
    training = per_step[-1]

    expect_eager = expected(fused_preattn=n_tower, flash_attention_packed=n_tower,
                            fused_postattn=n_tower, **loss_kernels)
    h2, s2, p2, peak2 = run(cfg_eager_layers, 3)
    med2 = report('eager layers (attn_impl="xla", fuse_post=False: K1-K3, K10-K12)', h2, s2, p2,
                  peak2, expect_eager)
    print(f"  training: {n_images / med:.2f} images/s, median step {med:.4f} s, peak "
          f"{peak / 2**30:.2f} GiB at the defaults; {n_images / med2:.2f} images/s, {med2:.4f} s, "
          f"{peak2 / 2**30:.2f} GiB with eager layers, on {card}")
    # attn_impl="flash": the align layers' attention on K13 / K14 between eager
    # ops, MPNet's on K15 / K16; the frozen tower stays on K1-K3
    expect_flash = expected(fused_preattn=n_tower, flash_attention_packed=n_tower,
                            fused_postattn=n_tower, flash_attention=n_align,
                            flash_attention_bwd=n_align, flash_attention_bias=n_text,
                            flash_attention_bias_bwd=n_text, fused_mpnet_post=n_text,
                            fused_mpnet_post_bwd=n_text, **loss_kernels)
    h3, s3, p3, peak3 = run(cfg_flash, 3, profile_it=profile)
    med3 = report('flash (attn_impl="flash" in align and text: K1-K4, K9-K16)', h3, s3, p3, peak3,
                  expect_flash)
    print(f"  training, attn_impl=\"flash\": {n_images / med3:.2f} images/s, median step "
          f"{med3:.4f} s, peak {peak3 / 2**30:.2f} GiB, on {card}")
    for name, h in (("eager-layer", h2), ("flash", h3)):
        if abs(h[0]["loss"] - history[0]["loss"]) > 0.02 * abs(history[0]["loss"]):
            fail(f"training: step-0 losses of the default and the {name} configuration "
                 f"differ: {history[0]['loss']} vs {h[0]['loss']}")

    # fp32, 2 images x 16 sentences: the all-kernel path, the eager-layer path and
    # the flash path against the all-eager path (eager layers, chain and VL-CABS)
    batch = train_batch(seed + 7, 2, 16, cfg.text.vocab_size, torch.float32)
    trainable, frozen = partition_params(params, modules)
    leaves = tree_leaves(trainable)
    legs = {"kernels": cfg, "eager layers": cfg_eager_layers, "flash": cfg_flash,
            "eager": dataclasses.replace(cfg_eager_layers, loss=LossConfig(train_impl="xla"))}
    got = {}
    for name, c in legs.items():
        for p in leaves:
            p.requires_grad_(True)
        out = forward_train(merge_params(trainable, frozen), c, batch, dtype=torch.float32,
                            stop_vision_gradient=True)
        grads = torch.autograd.grad(out["losses"]["loss"], leaves, allow_unused=True)
        for p in leaves:
            p.requires_grad_(False)
        got[name] = (out["losses"]["loss"].item(),
                     [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)])
    lx, gx = got["eager"]
    for name in ("kernels", "eager layers", "flash"):
        lf, gf = got[name]
        # per leaf: |path - eager| <= 2e-4 of the leaf's largest |gradient| + 1e-7:
        # the JAX suite holds the fused layers' gradients to 2e-4; here the fp32
        # sums run over 1370 tokens x 768 in another order on the two sides
        worst = max(((a - b).abs().max() / (b.abs().max() + 1e-30)).item()
                    for a, b in zip(gf, gx) if b.abs().max() > 1e-7)
        print(f"  fp32, 2 images: loss {name} {lf:.7f} vs eager {lx:.7f}; worst gradient "
              f"leaf error {worst:.3e} of its largest entry, over {len(gf)} leaves")
        if abs(lf - lx) > 1e-5 * abs(lx) + 1e-6:
            fail(f"training: the loss of the {name} path disagrees with the eager loss")
        for a, b in zip(gf, gx):
            if not bool(((a - b).abs() <= 2e-4 * b.abs().max() + 1e-7).all()):
                fail(f"training: a gradient of the {name} path disagrees with the eager path")
    return training, p3[-1]


def profile_step(fn):
    """One call of ``fn`` under torch.profiler: device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda k: -k[1])
    total = sum(k[1] for k in kernels)
    names = {"vt": "VL-CABS kernels K10-K12 (rz::vt::*)",
             "fa": "attention kernels K2, K7, K13-K16 (rz::fa::*)",
             "bw": "backward-only kernels of K6, K8, K9 (rz::bw::*: dW products, row passes)",
             "rz": "K1, K3, K4 forward and the products of K6, K8, K9 (rz::gemm_*, "
                   "rz::row_layernorm)",
             "torch": "torch ops (everything else)"}
    groups = {v: 0.0 for v in names.values()}
    for name, ms, _ in kernels:
        key = ("vt" if "rz::vt::" in name else "fa" if "rz::fa::" in name
               else "bw" if "rz::bw::" in name
               else "rz" if "rz::" in name else "torch")
        groups[names[key]] += ms
    print(f"  profile of one training step: {total:.1f} ms of device time in "
          f"{sum(k[2] for k in kernels)} kernel launches")
    for key, ms in groups.items():
        print(f"    {ms:8.2f} ms {100 * ms / total:5.1f}%  {key}")
    for name, ms, count in kernels[:40]:
        print(f"    {ms:8.2f} ms {100 * ms / total:5.1f}%  x{count:<4d} {name[:150]}")


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also print one training step's kernels by device time")
    args = ap.parse_args()
    if not (REPO / "radzero_torch" / "ops" / "csrc").is_dir():
        print("FAIL: radzero_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    from radzero_torch.ops import _build

    nvcc = _build.find_nvcc()
    nvcc_v = "none" if nvcc is None else subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True).stdout.strip().splitlines()[-1]
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"nvcc {nvcc_v}; {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    nvcc_s = ("no nvcc run: built before from these sources" if _build.build_seconds is None
              else f"nvcc {_build.build_seconds:.2f} s")
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s ({nvcc_s})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas {line.strip()}")
    check_no_spills(_build.build_log)

    rows = phase_kernels(args.seed)
    serving, params = phase_slice(args.seed, card)
    scoring = phase_scorer(args.seed, card, params)
    training, flash_step = phase_training(args.seed, card, params, args.profile)

    meta = {
        "K1": ("fused_preattn", "radzero_torch/ops/csrc/fused_layer.cu",
               "radzero_tpu/ops/fused_layer.py:92"),
        "K2": ("flash_attention_packed", "radzero_torch/ops/csrc/flash_fwd_sm90.cu",
               "radzero_tpu/ops/fused_layer.py:175"),
        "K3": ("fused_postattn", "radzero_torch/ops/csrc/fused_layer.cu",
               "radzero_tpu/ops/fused_layer.py:913"),
        "K4": ("fused_mpnet_post", "radzero_torch/ops/csrc/fused_layer.cu",
               "radzero_tpu/ops/fused_layer.py:760"),
        "K5": ("vlcabs_fused", "radzero_torch/ops/csrc/vlcabs_fused.cu",
               "radzero_tpu/ops/pallas_vlcabs.py:115"),
        "K6": ("fused_preattn_bwd", "radzero_torch/ops/csrc/fused_layer_bwd.cu",
               "radzero_tpu/ops/fused_layer.py:390"),
        "K7": ("flash_attention_packed_bwd", "radzero_torch/ops/csrc/flash_bwd_sm90.cu",
               "radzero_tpu/ops/fused_layer.py:281"),
        "K8": ("fused_postattn_bwd", "radzero_torch/ops/csrc/fused_layer_bwd.cu",
               "radzero_tpu/ops/fused_layer.py:568"),
        "K9": ("fused_mpnet_post_bwd", "radzero_torch/ops/csrc/fused_layer_bwd.cu",
               "radzero_tpu/ops/fused_layer.py:820"),
        "K10": ("vlcabs_train_forward", "radzero_torch/ops/csrc/vlcabs_train.cu",
                "radzero_tpu/ops/pallas_vlcabs.py:310"),
        "K11": ("vlcabs_train_bwd_dq", "radzero_torch/ops/csrc/vlcabs_train.cu",
                "radzero_tpu/ops/pallas_vlcabs.py:381"),
        "K12": ("vlcabs_train_bwd_dtn", "radzero_torch/ops/csrc/vlcabs_train.cu",
                "radzero_tpu/ops/pallas_vlcabs.py:403"),
        "K13": ("flash_attention", "radzero_torch/ops/csrc/flash_fwd_sm90.cu",
                "radzero_tpu/ops/flash_attention.py:122"),
        "K14": ("flash_attention_bwd", "radzero_torch/ops/csrc/flash_bwd_sm90.cu",
                "radzero_tpu/ops/flash_attention.py:214"),
        "K15": ("flash_attention_bias", "radzero_torch/ops/csrc/flash_attention.cu",
                "radzero_tpu/ops/flash_attention.py:333"),
        "K16": ("flash_attention_bias_bwd", "radzero_torch/ops/csrc/flash_attention.cu",
                "radzero_tpu/ops/flash_attention.py:470"),
    }
    # launches: the serving burst's count, the scorer run's, one default training
    # step's and one flash training step's; each path was driven with every count
    # at 0 and read right after
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": serving[name] + scoring[name] + training[name] + flash_step[name],
         "launches_serving": serving[name], "launches_scorer": scoring[name],
         "launches_training_step": training[name],
         "launches_flash_training_step": flash_step[name], **rows[k]}
        for k, (name, src, rep) in meta.items()
    ]
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        fail(f"kernels never launched on a main path: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
