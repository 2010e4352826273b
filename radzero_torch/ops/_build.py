"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (Hopper), one process
per source and all of them at once, and links the objects into one shared
library with a plain C interface, in ``radzero_torch/build/`` (listed in
``.gitignore``), at first use; the library is loaded with ``ctypes``. The
library name carries a hash of the sources, so an edit rebuilds and an
unchanged tree reuses the last build.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` turns a non-zero code into a ``RuntimeError``. There is no
fallback: without ``nvcc`` or a card, :func:`load` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures: every pointer and the stream are c_void_p (a bare int
# would be cut to 32 bits), then ints / floats as declared in csrc.
SIGNATURES = {
    # x, ln_s, ln_b, w, b, ln, out, M, K, N, eps, dtype, stream
    "rz_fused_preattn": [_P] * 7 + [_I, _I, _I, _F, _I, _P],
    # qkv, out, lse, B, L, H, hd, scale, dtype, stream
    "rz_packed_attention": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # x, a, wo, bo, ls1, ln_s, ln_b, w1, b1, w2, b2, ls2, y32, ln, h, out,
    # M, D, F, eps, dtype, stream
    "rz_fused_postattn": [_P] * 16 + [_I, _I, _I, _F, _I, _P],
    # qn, t, tau, scores, logits, N, B, L, D, dtype, stream
    "rz_vlcabs_fused": [_P] * 5 + [_I, _I, _I, _I, _I, _P],
    # x, a, wo, bo, lnsa, lnba, w1, b1, w2, b2, lnso, lnbo, u32, y32, yln, h, out,
    # M, D, F, eps, dtype, stream
    "rz_fused_mpnet_post": [_P] * 17 + [_I, _I, _I, _F, _I, _P],
    # qn, t, tau, tn, logits, rowmax, g, N, B, L, D, dtype, stream
    "rz_vlcabs_train_fwd": [_P] * 7 + [_I, _I, _I, _I, _I, _P],
    # t, tn, rows, D, dtype, stream
    "rz_vlcabs_rownorm": [_P, _P, _I, _I, _I, _P],
    # qn, g, dz, dg, dq_part, N, B, D, dtype, stream
    "rz_vlcabs_bwd_rows": [_P] * 5 + [_I, _I, _I, _I, _P],
    # qn, tn, tau, dg, rowmax, dq_part, dtau_part, dq, dtau, N, B, L, D, dtype, stream
    "rz_vlcabs_dq": [_P] * 9 + [_I, _I, _I, _I, _I, _P],
    # ce, tn, dq_part, dtau_slots, dq, dtau, N, Np, B, L, Lp, D, nslots, stream
    "rz_vlcabs_dq_sm90": [_P] * 6 + [_I] * 7 + [_P],
    # qn, tn, tau, dg, rowmax, dtn, N, B, L, D, dtype, stream
    "rz_vlcabs_dtn_tiles": [_P] * 6 + [_I, _I, _I, _I, _I, _P],
    # qn, tn, dg, rowmax, tau, ce, dtau_slots, N, Np, B, L, Lp, D, stream
    "rz_vlcabs_dtn_phase1": [_P] * 7 + [_I] * 6 + [_P],
    # ce, qn, dg, dtn, N, Np, B, L, Lp, D, stream
    "rz_vlcabs_dtn_phase2": [_P] * 4 + [_I] * 6 + [_P],
    # qn, tn, tau, s, tmax, N, B, L, Lp, D, stream
    "rz_vlcabs_fwd_scores": [_P] * 5 + [_I] * 5 + [_P],
    # s, tmax, e, rowmax, map, N, Np, B, L, Lp, stream
    "rz_vlcabs_fwd_rows": [_P] * 5 + [_I] * 5 + [_P],
    # e, tn, g, N, Np, B, L, Lp, D, stream
    "rz_vlcabs_fwd_g": [_P] * 3 + [_I] * 6 + [_P],
    # qn, g, logits, N, B, D, dtype, stream
    "rz_vlcabs_logits": [_P] * 3 + [_I] * 4 + [_P],
    # a, w, bias, resid, ls, aux, out, out2, colpart, M, N, K, epi, w_t, dtype, stream
    "rz_bwd_gemm": [_P] * 9 + [_I, _I, _I, _I, _I, _I, _P],
    # a, g, part, M, Ka, Nb, splits, dtype, stream
    "rz_wgrad": [_P] * 3 + [_I, _I, _I, _I, _I, _P],
    # part, out, S, n, dtype, stream
    "rz_reduce_parts": [_P, _P, _I, _L, _I, _P],
    # w, wt, K, N, dtype, stream
    "rz_transpose": [_P, _P, _I, _I, _I, _P],
    # u, u_f32, scale, bias, out_t, out_f, M, D, eps, dtype, stream
    "rz_ln_rows": [_P, _I, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    # u, u_f32, dh, dh_f32, scale, add, ls, proj, out1, out2, out32, cpart,
    # M, D, eps, dtype, stream
    "rz_ln_bwd_rows": [_P, _I, _P, _I] + [_P] * 8 + [_I, _I, _F, _I, _P],
    # g, m, ls, out, cpart, M, D, dtype, stream
    "rz_scale_colsum": [_P] * 5 + [_I, _I, _I, _P],
    # qkv, dout, out, lse, row_m, row_il, row_delta, dqkv, B, L, H, hd, scale, dtype,
    # stream
    "rz_packed_attention_bwd": [_P] * 8 + [_I, _I, _I, _I, _F, _I, _P],
    # q, k, v, out, lse, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, B, L, H, hd, kv_len,
    # scale, dtype, stream
    "rz_flash_attention": [_P] * 5 + [_L] * 6 + [_I] * 5 + [_F, _I, _P],
    # q, k, v, bias, neg, out, chunks, then as rz_flash_attention from q_bs on
    "rz_flash_attention_bias": [_P] * 6 + [_I] + [_L] * 6 + [_I] * 5 + [_F, _I, _P],
    # q, k, v, dout, out, lse, stats, dq, dk, dv, then as rz_flash_attention from
    # q_bs on
    "rz_flash_attention_bwd": [_P] * 10 + [_L] * 6 + [_I] * 5 + [_F, _I, _P],
    # q, k, v, bias, neg, dout, stats, dq, dk, dv, dbias_part, dbias, chunks,
    # then as rz_flash_attention from q_bs on
    "rz_flash_attention_bias_bwd": [_P] * 12 + [_I] + [_L] * 6 + [_I] * 5 + [_F, _I, _P],
    "rz_bwd_row_block": [],
    # dtype
    "rz_bwd_gemm_row_tile": [_I],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log: str = ""


def find_nvcc() -> Optional[str]:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    return None


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if the current sources have no library yet;
    return the library path. Raises when ``nvcc`` is missing or fails."""
    global build_seconds, build_log
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "radzero_torch CUDA kernels cannot be built on this host"
        )
    out = BUILD_DIR / f"libradzero_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    compiles = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
                for src, obj in zip(_sources(), objects)]
    tmp = BUILD_DIR / f"{tag}.tmp"
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
    t0 = time.perf_counter()
    build_log = ""
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in compiles]
        failed = None
        for cmd, proc in zip(compiles, procs):  # every process is waited for
            build_log += proc.communicate()[0]
            if proc.returncode != 0 and failed is None:
                failed = (proc.returncode, cmd)
        if failed is None:
            proc = subprocess.run(link, capture_output=True, text=True)
            build_log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                failed = (proc.returncode, link)
        build_seconds = time.perf_counter() - t0
        if failed is not None:
            raise RuntimeError(
                f"nvcc failed ({failed[0]}):\n{' '.join(failed[1])}\n{build_log}")
        os.replace(tmp, out)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, with argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.rz_error_string.argtypes = [ctypes.c_int]
            lib.rz_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code != 0:
        msg = load().rz_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device, as a raw pointer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
