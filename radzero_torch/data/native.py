"""ctypes bindings for the native host-preprocessing library (port of
radzero_tpu/data/native.py).

Compiles ``native/preproc.cpp`` (C++ with libjpeg, shared by both
packages and left as it is) with the flags of ``native/Makefile`` into
``radzero_torch/build/`` (listed in ``.gitignore``) on first use, and
exposes the fused decode / resize / normalise ops to the image pipeline.
The library name carries a hash of the source, the flags and the host's
``-march=native`` target, so an edited source or another CPU builds anew
and nothing is written into ``native/``. Without a compiler or libjpeg's
headers ``available()`` is False, and callers that asked for the native
path raise (``ServingEngine(host_backend="native")``) or keep PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_REPO = Path(__file__).resolve().parent.parent.parent
SOURCE = _REPO / "native" / "preproc.cpp"
BUILD_DIR = _REPO / "radzero_torch" / "build"
# native/Makefile: CXXFLAGS, then -shared ... -ljpeg
CXX = os.environ.get("CXX", "g++")
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native"]

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()
build_log: str = ""


def _march() -> str:
    """What ``-march=native`` resolves to on this host ('' if unknown): a
    library built for one CPU may use instructions another lacks."""
    try:
        out = subprocess.run([CXX, "-march=native", "-Q", "--help=target"],
                             capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    for line in out.splitlines():
        parts = line.split()
        if len(parts) == 2 and parts[0] == "-march=":
            return parts[1]
    return ""


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join([CXX, *CXXFLAGS, _march()]).encode())
    return BUILD_DIR / f"libradzero_preproc_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """Compile the source into ``out`` (through a temporary name, so a
    concurrent process never loads half a file); False on any failure."""
    global build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([CXX, *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE), "-ljpeg"],
                              capture_output=True, text=True, timeout=120)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            return False
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        build_log = str(e)
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = _bind(ctypes.CDLL(str(path)))
        except (OSError, AttributeError):
            lib = None
        if lib is None and _build(path):
            # a stale or broken library under this name: rebuild once and retry
            try:
                lib = _bind(ctypes.CDLL(str(path)))
            except (OSError, AttributeError):
                lib = None
        _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare signatures; raises AttributeError on a stale .so."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    ci = ctypes.c_int
    lib.resize_bicubic_u8.argtypes = [u8p, ci, ci, ci, u8p, ci, ci]
    lib.resize_bilinear_u8.argtypes = [u8p, ci, ci, ci, u8p, ci, ci]
    lib.normalize_u8_to_f32.argtypes = [u8p, ci, ci, ci, f32p, f32p, f32p]
    lib.resize_normalize_u8.argtypes = [u8p, ci, ci, ci, f32p, ci, ci, f32p, f32p, ci]
    lib.minmax_u8.argtypes = [u8p, ci, u8p]
    cip = ctypes.POINTER(ctypes.c_int)
    lib.jpeg_dims.argtypes = [u8p, ci, cip, cip]
    lib.jpeg_dims.restype = ci
    lib.decode_jpeg_rgb.argtypes = [u8p, ci, u8p, ctypes.c_long, cip, cip]
    lib.decode_jpeg_rgb.restype = ci
    lib.decode_resize_normalize_jpeg.argtypes = [u8p, ci, f32p, ci, ci, f32p, f32p, ci, ci]
    lib.decode_resize_normalize_jpeg.restype = ci
    lib.decode_resize_jpeg_u8.argtypes = [u8p, ci, u8p, ci, ci, ci, ci]
    lib.decode_resize_jpeg_u8.restype = ci
    lib.decode_resize_jpeg_gray_u8.argtypes = [u8p, ci, u8p, ci, ci, ci, ci]
    lib.decode_resize_jpeg_gray_u8.restype = ci
    return lib


def available() -> bool:
    return _load() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resize_u8(img: np.ndarray, oh: int, ow: int, mode: str = "bicubic") -> np.ndarray:
    lib = _load()
    assert lib is not None
    img = np.ascontiguousarray(img, np.uint8)
    ih, iw, c = img.shape
    out = np.empty((oh, ow, c), np.uint8)
    fn = lib.resize_bicubic_u8 if mode == "bicubic" else lib.resize_bilinear_u8
    fn(_u8p(img), ih, iw, c, _u8p(out), oh, ow)
    return out


def normalize(img: np.ndarray, mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    lib = _load()
    assert lib is not None
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty((h, w, c), np.float32)
    m = np.asarray(mean, np.float32)
    s = np.asarray(std, np.float32)
    lib.normalize_u8_to_f32(_u8p(img), h, w, c, _f32p(m), _f32p(s), _f32p(out))
    return out


def resize_normalize(
    img: np.ndarray,
    oh: int,
    ow: int,
    mean: Sequence[float],
    std: Sequence[float],
    mode: str = "bicubic",
) -> np.ndarray:
    lib = _load()
    assert lib is not None
    img = np.ascontiguousarray(img, np.uint8)
    ih, iw, c = img.shape
    out = np.empty((oh, ow, c), np.float32)
    m = np.asarray(mean, np.float32)
    s = np.asarray(std, np.float32)
    lib.resize_normalize_u8(
        _u8p(img), ih, iw, c, _f32p(out), oh, ow, _f32p(m), _f32p(s), 1 if mode == "bicubic" else 0
    )
    return out


def minmax_normalize(img: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty_like(img)
    lib.minmax_u8(_u8p(img), img.size, _u8p(out))
    return out


def jpeg_dims(data: bytes) -> tuple:
    """(height, width) from the JPEG header only (no pixel decode)."""
    lib = _load()
    assert lib is not None
    buf = np.frombuffer(data, np.uint8)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.jpeg_dims(_u8p(buf), len(data), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError("invalid JPEG")
    return h.value, w.value


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> RGB u8 (H, W, 3) via libjpeg."""
    lib = _load()
    assert lib is not None
    buf = np.frombuffer(data, np.uint8)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.jpeg_dims(_u8p(buf), len(data), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError("invalid JPEG")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.decode_jpeg_rgb(
        _u8p(buf), len(data), _u8p(out), out.nbytes, ctypes.byref(h), ctypes.byref(w)
    )
    if rc != 0:
        raise ValueError(f"JPEG decode failed (rc={rc})")
    return out


def decode_resize_normalize(
    data: bytes,
    oh: int,
    ow: int,
    mean: Sequence[float],
    std: Sequence[float],
    mode: str = "bicubic",
    fast_scale: bool = False,
) -> np.ndarray:
    """The whole data-loader hot path in one native call:
    JPEG bytes -> RGB -> resize -> rescale+normalise f32 (oh, ow, 3).

    ``fast_scale`` enables libjpeg DCT-domain scaled decoding (1/2..1/8)
    when the source is much larger than the target — ~15-40% faster but
    with a box-filtered downscale, so it is a TRAINING-only option
    (eval keeps the full decode for parity)."""
    lib = _load()
    assert lib is not None
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((oh, ow, 3), np.float32)
    m = np.asarray(mean, np.float32)
    s = np.asarray(std, np.float32)
    rc = lib.decode_resize_normalize_jpeg(
        _u8p(buf), len(data), _f32p(out), oh, ow, _f32p(m), _f32p(s),
        1 if mode == "bicubic" else 0, 1 if fast_scale else 0,
    )
    if rc != 0:
        raise ValueError(f"JPEG decode failed (rc={rc})")
    return out


def decode_resize_u8(
    data: bytes, oh: int, ow: int, mode: str = "bicubic", fast_scale: bool = False
) -> np.ndarray:
    """Serving hot path for uint8 upload: JPEG bytes -> RGB -> resize ->
    (oh, ow, 3) u8. Normalisation happens on device (4x less transfer
    than the f32 variant)."""
    lib = _load()
    assert lib is not None
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((oh, ow, 3), np.uint8)
    rc = lib.decode_resize_jpeg_u8(
        _u8p(buf), len(data), _u8p(out), oh, ow,
        1 if mode == "bicubic" else 0, 1 if fast_scale else 0,
    )
    if rc != 0:
        raise ValueError(f"JPEG decode failed (rc={rc})")
    return out


def decode_resize_gray_u8(
    data: bytes, oh: int, ow: int, mode: str = "bicubic", fast_scale: bool = False
) -> np.ndarray:
    """Grayscale serving path: JPEG bytes -> luma -> resize ->
    (oh, ow, 1) u8. 3x fewer upload bytes than RGB for single-channel
    CXR sources; the model broadcasts to 3 channels on device."""
    lib = _load()
    assert lib is not None
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((oh, ow, 1), np.uint8)
    rc = lib.decode_resize_jpeg_gray_u8(
        _u8p(buf), len(data), _u8p(out), oh, ow,
        1 if mode == "bicubic" else 0, 1 if fast_scale else 0,
    )
    if rc != 0:
        raise ValueError(f"JPEG decode failed (rc={rc})")
    return out


def native_jpeg_loader(
    size: int, mean: Sequence[float], std: Sequence[float], fast_scale: bool = True
):
    """image_loader factory for a training loader: record['image'] (a .jpg
    path) -> processed (size, size, 3) f32, entirely in native code.
    fast_scale defaults on (training tolerates the scaled decode)."""

    def load(record: dict) -> np.ndarray:
        with open(record["image"], "rb") as f:
            return decode_resize_normalize(f.read(), size, size, mean, std,
                                           fast_scale=fast_scale)

    return load
