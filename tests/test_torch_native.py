"""The port's native host library (radzero_torch.data.native) against the
JAX package's (radzero_tpu.data.native): both bind native/preproc.cpp, the
port through its own build in radzero_torch/build/, so every entry point
must give the same bits on the same arrays and JPEG bytes, ``fast_scale``
included. The tests of tests/test_native_preproc.py are mirrored on the
port's bindings, and the processors with ``use_native=True`` are held to
the JAX processors with ``use_native=True``. Skips where libjpeg's
headers or a compiler are missing.
"""

import io

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from radzero_torch.data import native

from radzero_tpu.data import native as jax_native

pytestmark = pytest.mark.skipif(
    not (native.available() and jax_native.available()),
    reason="native library unavailable (no compiler or libjpeg headers)",
)

MEAN, STD = (0.48, 0.45, 0.41), (0.27, 0.26, 0.28)


def _jpeg(arr, quality=95):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _image(seed, shape):
    """A smooth image with noise (a JPEG of pure noise exercises little)."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 90 * np.sin(xx / (w / 5.0)) * np.cos(yy / (h / 3.0))
    if len(shape) == 3:
        base = base[..., None] + np.arange(shape[2]) * 20
    return np.clip(base + rng.normal(0, 12, shape), 0, 255).astype(np.uint8)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_library_is_built_outside_native_dir():
    path = native.library_path()
    assert path.parent.name == "build" and path.parent.parent.name == "radzero_torch"
    assert path.exists() and path.name.startswith("libradzero_preproc_")


@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
@pytest.mark.parametrize("shape,out", [((60, 45, 3), (120, 90)), ((70, 55, 1), (56, 56)),
                                       ((300, 260, 3), (28, 28))])
def test_resize_u8_bit_equal(shape, out, mode):
    img = _image(1, shape)
    _same(native.resize_u8(img, *out, mode), jax_native.resize_u8(img, *out, mode))


def test_normalize_and_minmax_bit_equal():
    img = _image(2, (20, 24, 3))
    _same(native.normalize(img, MEAN, STD), jax_native.normalize(img, MEAN, STD))
    gray = _image(3, (30, 31))
    _same(native.minmax_normalize(gray), jax_native.minmax_normalize(gray))


@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
def test_resize_normalize_bit_equal(mode):
    img = _image(4, (70, 55, 3))
    _same(native.resize_normalize(img, 56, 56, MEAN, STD, mode),
          jax_native.resize_normalize(img, 56, 56, MEAN, STD, mode))


@pytest.mark.parametrize("fast_scale", [False, True])
@pytest.mark.parametrize("shape", [(90, 70, 3), (400, 330, 3), (420, 300)])
def test_jpeg_entry_points_bit_equal(shape, fast_scale):
    """Every JPEG entry point at a source near the target and at one
    several times larger (where fast_scale takes libjpeg's scaled decode)."""
    data = _jpeg(_image(5, shape))
    assert native.jpeg_dims(data) == jax_native.jpeg_dims(data) == shape[:2]
    _same(native.decode_jpeg(data), jax_native.decode_jpeg(data))
    for mode in ("bicubic", "bilinear"):
        _same(native.decode_resize_normalize(data, 56, 56, MEAN, STD, mode, fast_scale),
              jax_native.decode_resize_normalize(data, 56, 56, MEAN, STD, mode, fast_scale))
        _same(native.decode_resize_u8(data, 56, 56, mode, fast_scale),
              jax_native.decode_resize_u8(data, 56, 56, mode, fast_scale))
        _same(native.decode_resize_gray_u8(data, 56, 56, mode, fast_scale),
              jax_native.decode_resize_gray_u8(data, 56, 56, mode, fast_scale))


def test_fast_scale_changes_a_large_source():
    """fast_scale is live: on a source 7x the target the scaled decode
    box-filters, so the pixels differ from the full decode (slightly)."""
    data = _jpeg(_image(6, (400, 400, 3)))
    full = native.decode_resize_u8(data, 56, 56).astype(int)
    fast = native.decode_resize_u8(data, 56, 56, fast_scale=True).astype(int)
    assert 0 < np.abs(full - fast).mean() < 8


def test_invalid_jpeg_raises():
    for fn in (native.jpeg_dims, native.decode_jpeg,
               lambda d: native.decode_resize_u8(d, 8, 8),
               lambda d: native.decode_resize_gray_u8(d, 8, 8)):
        with pytest.raises(ValueError):
            fn(b"not a jpeg at all")


def test_native_jpeg_loader_bit_equal(tmp_path):
    p = tmp_path / "x.jpg"
    p.write_bytes(_jpeg(_image(7, (80, 60, 3))))
    for fast_scale in (True, False):
        ours = native.native_jpeg_loader(28, MEAN, STD, fast_scale=fast_scale)({"image": str(p)})
        ref = jax_native.native_jpeg_loader(28, MEAN, STD, fast_scale=fast_scale)(
            {"image": str(p)})
        assert ours.shape == (28, 28, 3) and ours.dtype == np.float32
        _same(ours, ref)


# --- tests/test_native_preproc.py, on the port's bindings ----------------------

def test_resize_bicubic_matches_torch_semantics():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (60, 45, 3), dtype=np.uint8)
    out = native.resize_u8(img, 120, 90, "bicubic")
    ref = F.interpolate(
        torch.from_numpy(img.transpose(2, 0, 1)[None].astype(np.float32)),
        size=(120, 90), mode="bicubic", align_corners=False,
    )[0].numpy().transpose(1, 2, 0)
    ref_u8 = np.clip(np.floor(ref + 0.5), 0, 255).astype(np.uint8)
    # rounding at the .5 boundary may differ by 1 lsb
    assert np.abs(out.astype(int) - ref_u8.astype(int)).max() <= 1


def test_resize_bilinear_matches_torch_semantics():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (33, 50, 1), dtype=np.uint8)
    out = native.resize_u8(img, 66, 100, "bilinear")
    ref = F.interpolate(
        torch.from_numpy(img.transpose(2, 0, 1)[None].astype(np.float32)),
        size=(66, 100), mode="bilinear", align_corners=False,
    )[0].numpy().transpose(1, 2, 0)
    assert np.abs(out.astype(float) - ref).max() <= 1.0


def test_normalize_matches_numpy():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
    out = native.normalize(img, mean, std)
    ref = (img.astype(np.float32) / 255.0 - np.asarray(mean, np.float32)) / np.asarray(
        std, np.float32)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_fused_resize_normalize_matches_two_stage():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (70, 55, 3), dtype=np.uint8)
    fused = native.resize_normalize(img, 56, 56, MEAN, STD, "bicubic")
    two_stage = native.normalize(native.resize_u8(img, 56, 56, "bicubic"), MEAN, STD)
    np.testing.assert_allclose(fused, two_stage, rtol=1e-5, atol=1e-5)


def test_minmax_matches_cv2():
    import cv2

    rng = np.random.default_rng(4)
    img = rng.integers(40, 200, (30, 30), dtype=np.uint8)
    out = native.minmax_normalize(img)
    ref = cv2.normalize(img, None, 0, 255, norm_type=cv2.NORM_MINMAX, dtype=cv2.CV_8U)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_jpeg_decode_matches_pil():
    rng = np.random.default_rng(5)
    data = _jpeg(rng.integers(0, 256, (60, 50, 3), dtype=np.uint8))
    ours = native.decode_jpeg(data)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert ours.shape == ref.shape
    # decoders may differ by small IDCT rounding
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 2


def test_fused_jpeg_pipeline_matches_stages():
    rng = np.random.default_rng(6)
    data = _jpeg(rng.integers(0, 256, (90, 70, 3), dtype=np.uint8))
    fused = native.decode_resize_normalize(data, 56, 56, MEAN, STD)
    staged = native.normalize(native.resize_u8(native.decode_jpeg(data), 56, 56, "bicubic"),
                              MEAN, STD)
    np.testing.assert_allclose(fused, staged, rtol=1e-5, atol=1e-5)


# --- the processors ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["BlipStyleImageProcessor", "AspectRatioImageProcessor"])
def test_processors_use_native_bit_equal(name):
    from radzero_torch.data import processing as tproc

    from radzero_tpu.data import processing as jproc

    images = [_image(8, (70, 52, 3)), _image(9, (40, 64)), _image(10, (56, 56, 3))]
    ours = getattr(tproc, name)(size=56, use_native=True)(images)["pixel_values"]
    ref = getattr(jproc, name)(size=56, use_native=True)(images)["pixel_values"]
    _same(ours, ref)
    # and the native path is the one taken: torch-bicubic, not PIL's filter
    pil = getattr(tproc, name)(size=56)(images)["pixel_values"]
    assert np.abs(ours - pil).max() > 0
