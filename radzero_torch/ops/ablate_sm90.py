"""Where the time of the Hopper attention forward goes: time copies of
``csrc/flash_fwd_sm90.cu`` with one part cut out, side by side on one card.

    python3 -m radzero_torch.ops.ablate_sm90

Each variant is the source with a text replacement (the results of every
variant but ``base`` are wrong on purpose); each is compiled by nvcc into its
own library in ``radzero_torch/build/ablate/`` and called through ctypes on
packed (B, L, 3 x 768) bf16 operands, 12 heads, at the serving shape (8 x
1370), the training step's (64 x 1370) and a long one (1 x 4097). Printed per
shape and variant: the CUDA-event median of single calls (the host's launch
included) and the device time a call by torch.profiler, beside
F.scaled_dot_product_attention on the same operands. Needs a card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

from radzero_torch.ops import _build

SHAPES = ((8, 1370), (64, 1370), (1, 4097))
D, H = 768, 12

# variant: (what it cuts, [(text in the source, its replacement)])
VARIANTS = {
    "base": ("nothing", []),
    "noorder": ("the warpgroups' turn-taking", [
        ('asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(CONSUMERS) : "memory");', ""),
        ('asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(CONSUMERS) : "memory");', "")]),
    "nosoftmax": ("the softmax of every tile but the first", [
        ("softmax(acc, t * BN, Lk, quad, sl2, m, l, alpha);", "")]),
    "noexp": ("exp2 (the SFU)", [
        ('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = x;")]),
    "nomma": ("both products", [
        ("for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_n64(o, pa + 4 * kk, dv + 128 * kk);", ""),
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
}

SHIM = """
extern "C" int shim(const void* q, const void* k, const void* v, long long bs, long long rs,
                    void* out, long long obs, long long ors, int B, int L, int H, int Lk,
                    float scale) {
  return (int)rz::fa::forward_sm90(q, k, v, bs, rs, bs, rs, bs, rs, out, obs, ors, B, L, H, Lk,
                                   scale, 0);
}
"""


def build_variants(out_dir: Path) -> dict:
    """Compile every variant at once -> {name: ctypes library}."""
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    src = (_build.CSRC / "flash_fwd_sm90.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, pairs) in VARIANTS.items():
        text = src
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text + SHIM)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC), "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        spills = [line.strip() for line in log.splitlines() if "spill" in line]
        print(f"{name:10s} cuts {VARIANTS[name][0]}; ptxas: {spills[:1]}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.shim.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
                             + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float])
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
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / calls


def main() -> int:
    import torch
    import torch.nn.functional as Fn

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    libs = build_variants(_build.BUILD_DIR / "ablate")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, l in SHAPES:
        qkv = torch.randn((b, l, 3 * D), generator=gen, device="cuda").to(torch.bfloat16)
        out = torch.empty((b, l, D), device="cuda", dtype=torch.bfloat16)
        q, k, v = (qkv[..., i * D:(i + 1) * D] for i in range(3))
        print(f"{b} x {l}: variant  events ms  device ms")
        for name, lib in libs.items():
            def call(lib=lib):
                code = lib.shim(q.data_ptr(), k.data_ptr(), v.data_ptr(), 3 * D * l, 3 * D,
                                out.data_ptr(), D * l, D, b, l, H, l, 0.125)
                if code:
                    raise RuntimeError(f"CUDA error {code}")
            print(f"  {name:10s} {event_ms(call):.4f} {device_ms(call):.4f}")
        heads = [t.reshape(b, l, H, D // H).transpose(1, 2) for t in (q, k, v)]
        lib_call = lambda: Fn.scaled_dot_product_attention(*heads)  # noqa: E731
        print(f"  {'library':10s} {event_ms(lib_call):.4f} {device_ms(lib_call):.4f}", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
