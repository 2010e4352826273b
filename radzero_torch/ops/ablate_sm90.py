"""Where the time of the Hopper kernels goes: time copies of
``csrc/flash_fwd_sm90.cu`` (the bf16 forward of K2 / K13), of
``csrc/flash_bwd_sm90.cu`` (the bf16 backward of K7 / K14) or of
``csrc/gemm_sm90.cu`` (the bf16 products of K1 / K3) with one part cut out,
side by side on one card.

    python3 -m radzero_torch.ops.ablate_sm90 [fwd | bwd | gemm]

Each variant is the source, with ``csrc/sm90.cuh`` written into it, under a
text replacement (the results of every variant but ``base`` are wrong on
purpose); each is compiled by nvcc into its own library in
``radzero_torch/build/ablate/`` and called through ctypes on packed (B, L,
3 x 768) bf16 operands, 12 heads, at the serving shape (8 x 1370, forward
only), the training step's (64 x 1370), two images (backward only) and a long
one (1 x 4097); the GEMM's on (B x 1370, 768) bf16 operands at 8 and 64
images: K1's product (N 2304, bias) and K3's o-proj, fc1 and fc2 with their
epilogues. Printed per shape and variant: the CUDA-event median of
single calls (the host's launch included) and the device time a call by
torch.profiler (per device kernel for the backward), beside
F.scaled_dot_product_attention (forward, or its backward alone), or for the
GEMM F.linear, on the same operands. The backward's out and lse come from the
built library's forward.
Needs a card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

from radzero_torch.ops import _build

D, H = 768, 12
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ORDER = ('asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(CONSUMERS) : "memory");',
          'asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(CONSUMERS) : "memory");')
_EXP = 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));'

# kernel: (source, shapes, shim, shim argtypes, {variant: (what it cuts, [(text, replacement)])})
KERNELS = {
    "fwd": ("flash_fwd_sm90.cu", ((8, 1370), (64, 1370), (1, 4097)), """
extern "C" int shim(const void* q, const void* k, const void* v, long long bs, long long rs,
                    void* out, long long obs, long long ors, int B, int L, int H, int Lk,
                    float scale) {
  return (int)rz::fa::forward_sm90(q, k, v, bs, rs, bs, rs, bs, rs, out, obs, ors, nullptr, B, L,
                                   H, Lk, scale, 0);
}
""", [_P] * 3 + [_L] * 2 + [_P] + [_L] * 2 + [_I] * 4 + [ctypes.c_float], {
        "base": ("nothing", []),
        "noorder": ("the warpgroups' turn-taking", [(_ORDER[0], ""), (_ORDER[1], "")]),
        "nosoftmax": ("the softmax of every tile but the first", [
            ("softmax(acc, t * BN, Lk, quad, sl2, m, l, alpha);", "")]),
        "noexp": ("exp2 (the SFU)", [(_EXP, "y = x;")]),
        "nomma": ("both products", [
            ("for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_n64(o, pa + 4 * kk, dv + 128 * kk);",
             ""),
            ("for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss_n128(acc, dq + 2 * kk, dk + 2 * kk, kk);",
             "")]),
        "halfload": ("the loads of V", [
            ("        bar_expect_tx(full(t), 2 * TILE);", "        bar_expect_tx(full(t), TILE);"),
            ("        tma_load(sK(t) + TILE, &mv, full(t), h, t * BN, b);\n", "")]),
        "noepi": ("the output stores", [
            ("      *reinterpret_cast<uint32_t*>(dst + 8 * j) = v;",
             "      if (v == 0x7fc17fc1u) *reinterpret_cast<uint32_t*>(dst + 8 * j) = v;")]),
        "stages2": ("two of the four K / V stages", [
            ("constexpr int STAGES = 4;", "constexpr int STAGES = 2;")]),
    }),
    "bwd": ("flash_bwd_sm90.cu", ((64, 1370), (2, 1370), (1, 4097)), """
extern "C" int shim(const void* q, const void* k, const void* v, long long bs, long long rs,
                    const void* out, const void* dout, const float* lse, float* delta, void* dq,
                    void* dk, void* dv, int B, int L, int H, int Lk, float scale) {
  return (int)rz::fa::backward_sm90(q, k, v, bs, rs, bs, rs, bs, rs, out, dout, lse, delta, dq,
                                    dk, dv, bs, rs, B, L, H, Lk, scale, 0);
}
""", [_P] * 3 + [_L] * 2 + [_P] * 7 + [_I] * 4 + [ctypes.c_float], {
        "base": ("nothing", []),
        "noorder": ("the dQ kernel's turn-taking", [(_ORDER[0], ""), (_ORDER[1], "")]),
        "nods": ("P and dS on the registers (both kernels)", [
            ("    ds_rows(s, dp, j * SUB, Lk, quad, sl2, scale, lse_r, delta_r);\n", ""),
            ("    ds_cols(s, dp, stats(t) + (j % 2) * SUB, dead, quad, sl2, scale);\n", "")]),
        "noexp": ("exp2 (the SFU)", [(_EXP, "y = x;")]),
        "nodq": ("dQ += dS K", [("    issue_rs(dqa, da, kh(j - 1));\n", ""),
                                ("  issue_rs(dqa, da, kh(nsub - 1));\n", "")]),
        "nodkdv": ("dV += P^T dO and dK += dS^T Q", [
            ("    issue_rs(dva, pa, gb);\n    issue_rs(dka, da, qb);\n", "")]),
        "stages2": ("two of the four ring stages", [
            ("constexpr int STAGES = 4;", "constexpr int STAGES = 2;")]),
    }),
    "gemm": ("gemm_sm90.cu", (8, 64), """
extern "C" int shim(const void* a, const void* w, const void* bias, const void* resid,
                    const void* ls, void* out, int M, int N, int K, int epi) {
  rz::GemmArgs g{a, w, bias, nullptr, nullptr, 0.f, resid, ls, out, M, N, K};
  return (int)rz::gemm_sm90(g, epi, 0);
}
""", [_P] * 6 + [_I] * 4, {
        "base": ("nothing", []),
        "nomma": ("the products", [
            ("        wgmma_n128<AT, MODE != GEMM_DX>(acc, da + SA * kk,",
             "        if (ks < 0) wgmma_n128<AT, MODE != GEMM_DX>(acc, da + SA * kk,")]),
        "nostore": ("the TMA stores of the output", [
            ("    const bool rows = w.m0 + wg * 64 < g.M;", "    const bool rows = w.m0 + wg * 64 < 0;")]),
        "noloada": ("the loads of A (W alone by TMA)", [
            ("            tma_load_2d(st, &ma, full(it), k, w.m0);\n", ""),
            ("A_BYTES + (MODE == GEMM_DX ? A_BYTES : (right ? 2 : 1) * BOX64));",
             "(MODE == GEMM_DX ? A_BYTES : (right ? 2 : 1) * BOX64));")]),
        "stages3": ("one or two of the ring's four or five stages", [
            ("static constexpr int STAGES = EXTRA <= 65536 ? 5 : 4;",
             "static constexpr int STAGES = 3;")]),
        "stages6": ("nothing; six stages where the output is bf16 and nothing comes in", [
            ("static constexpr int STAGES = EXTRA <= 65536 ? 5 : 4;",
             "static constexpr int STAGES = EXTRA <= 32768 ? 6 : EXTRA <= 65536 ? 5 : 4;")]),
    }),
}

# the GEMM's products: (name, K, N, epilogue code of csrc/gemm.cuh)
GEMMS = (("qkv", D, 3 * D, 0), ("o-proj", D, D, 1), ("fc1", D, 4 * D, 2), ("fc2", 4 * D, D, 3))


def build_variants(kernel: str, out_dir: Path) -> dict:
    """Compile every variant of ``kernel`` at once -> {name: ctypes library}."""
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    source, _, shim, argtypes, variants = KERNELS[kernel]
    header = (_build.CSRC / "sm90.cuh").read_text().replace("#pragma once\n", "")
    src = (_build.CSRC / source).read_text().replace('#include "sm90.cuh"\n', header)
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, pairs) in variants.items():
        text = src
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = out_dir / f"{kernel}_{name}.cu"
        cu.write_text(text + shim)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC), "-o",
             str(out_dir / f"{kernel}_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        spills = [line.strip() for line in log.splitlines() if "spill" in line]
        print(f"{name:10s} cuts {variants[name][0]}; ptxas: {spills}")
        lib = ctypes.CDLL(str(out_dir / f"{kernel}_{name}.so"))
        lib.shim.argtypes = argtypes
        libs[name] = lib
    return libs


def event_ms(fn, reps=30, warmup=5):
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
    return sorted(times)[reps // 2]


def device_ms(fn, calls=5):
    """{device kernel name: its device ms a call} under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / calls for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def _checked(code):
    if code:
        raise RuntimeError(f"CUDA error {code}")


def main() -> int:
    import torch
    import torch.nn.functional as Fn

    from radzero_torch.ops import fused_layer as fl

    kernel = sys.argv[1] if len(sys.argv) > 1 else "fwd"
    if kernel not in KERNELS:
        print(f"FAIL: kernel must be one of {sorted(KERNELS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    libs = build_variants(kernel, _build.BUILD_DIR / "ablate")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if kernel == "gemm":
        gemm_main(libs, gen)
        print(card)
        return 0
    for b, l in KERNELS[kernel][1]:
        qkv = torch.randn((b, l, 3 * D), generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = (qkv[..., i * D:(i + 1) * D] for i in range(3))
        heads = [t.reshape(b, l, H, D // H).transpose(1, 2) for t in (q, k, v)]
        if kernel == "fwd":
            out = torch.empty((b, l, D), device="cuda", dtype=torch.bfloat16)

            def call(lib):
                _checked(lib.shim(q.data_ptr(), k.data_ptr(), v.data_ptr(), 3 * D * l, 3 * D,
                                  out.data_ptr(), D * l, D, b, l, H, l, 0.125))

            lib_call = lambda: Fn.scaled_dot_product_attention(*heads)  # noqa: E731
        else:
            out, lse = fl.flash_attention_packed_lse(qkv, H)
            dout = torch.randn((b, l, D), generator=gen, device="cuda").to(torch.bfloat16)
            delta = torch.empty((b, H, l), device="cuda")
            dqkv = torch.empty_like(qkv)
            dq, dk, dv = (dqkv[..., i * D:(i + 1) * D] for i in range(3))

            def call(lib):
                _checked(lib.shim(q.data_ptr(), k.data_ptr(), v.data_ptr(), 3 * D * l, 3 * D,
                                  out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                                  delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                  b, l, H, l, 0.125))

            leaves = [t.detach().requires_grad_(True) for t in heads]
            o = Fn.scaled_dot_product_attention(*leaves)
            g = dout.reshape(b, l, H, D // H).transpose(1, 2)
            lib_call = lambda: torch.autograd.grad(o, leaves, g, retain_graph=True)  # noqa: E731
        print(f"{b} x {l}: variant  events ms  device ms")
        for name, lib in libs.items():
            dev = device_ms(lambda lib=lib: call(lib))
            parts = "" if len(dev) < 2 else "  (" + ", ".join(
                f"{key.split('(')[0].split('::')[-1]} {ms:.4f}" for key, ms in dev.items()) + ")"
            print(f"  {name:10s} {event_ms(lambda lib=lib: call(lib)):.4f} "
                  f"{sum(dev.values()):.4f}{parts}")
        print(f"  {'library':10s} {event_ms(lib_call):.4f} {sum(device_ms(lib_call).values()):.4f}",
              flush=True)
        del qkv, q, k, v, heads, out
        torch.cuda.empty_cache()
    print(card)
    return 0


def gemm_main(libs, gen):
    import torch
    import torch.nn.functional as Fn

    def rn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(torch.bfloat16)

    for b in KERNELS["gemm"][1]:
        m = b * 1370
        x = rn(m, D)
        for name, k, n, epi in GEMMS:
            a, w, bias, ls = rn(m, k), rn(k, n, std=0.02), rn(n, std=0.02), rn(n)
            resid = x if epi == 1 else torch.randn((m, n), generator=gen, device="cuda")
            out = torch.empty((m, n), device="cuda",
                              dtype=torch.float32 if epi == 1 else torch.bfloat16)

            def call(lib):
                _checked(lib.shim(a.data_ptr(), w.data_ptr(), bias.data_ptr(), resid.data_ptr(),
                                  ls.data_ptr(), out.data_ptr(), m, n, k, epi))

            wt = w.t().contiguous()
            lib_call = lambda: Fn.linear(a, wt)  # noqa: E731
            print(f"{b} images, {name} ({m} x {k} x {n}): variant  events ms  device ms")
            for vname, lib in libs.items():
                print(f"  {vname:10s} {event_ms(lambda lib=lib: call(lib)):.4f} "
                      f"{sum(device_ms(lambda lib=lib: call(lib)).values()):.4f}")
            print(f"  {'library':10s} {event_ms(lib_call):.4f} "
                  f"{sum(device_ms(lib_call).values()):.4f}", flush=True)
            del a, w, bias, ls, resid, out, wt
        del x
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
