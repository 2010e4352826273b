"""The port's host image modules, ZeroShotScorer and model_inference against
the JAX package's, on the CPU.

Sizes: D = 64, 2 tower + 2 align + 2 text layers, images resized to 56 px.
Weights come from the JAX init through the bridge. The processors and the
DICOM reader are pure numpy + PIL on both sides and must agree bit for bit.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from radzero_tpu.data import dicom as jdicom
from radzero_tpu.data import processing as jproc
from radzero_tpu.data.tokenizer import WhitespaceHashTokenizer as JaxTokenizer
from radzero_tpu.eval.api import model_inference as jax_model_inference
from radzero_tpu.eval.scorer import ZeroShotScorer as JaxScorer
from radzero_tpu.models import configuration as jconf
from radzero_tpu.models.radzero import init_radzero as jax_init_radzero
from radzero_torch.data import dicom as tdicom
from radzero_torch.data import processing as tproc
from radzero_torch.data.dicom_parse import dicom_read
from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
from radzero_torch.eval.api import model_inference
from radzero_torch.eval.scorer import ZeroShotScorer
from radzero_torch.models import configuration as tconf
from radzero_torch.models.from_jax import params_from_jax

from test_dicom import _EXPLICIT_LE, _IMPLICIT_LE, _JPEG_BASELINE, _make_dicom
from test_torch_modules import TEXT, VIT, perturbed

D = 64
PROMPTS = ["There is pneumothorax", "There is edema", "No finding"]


# ---------------------------------------------------------------------------
# host image modules
# ---------------------------------------------------------------------------

def _images(rng):
    return [rng.integers(0, 256, shape, dtype=np.uint8)
            for shape in ((40, 30, 3), (23, 57, 3), (64, 64, 3), (31, 45))]


@pytest.mark.parametrize("name,kw", [
    ("blip", dict(size=56)),
    ("aspect_ratio_blip", dict(size=56)),
    ("bit", dict(size=28)),
    ("m3ae", dict(resize_size=64, crop_size=56)),
])
def test_image_processors_match_jax_bit_for_bit(name, kw):
    ours = tproc.IMAGE_PROCESSORS[name](**kw)
    theirs = jproc.IMAGE_PROCESSORS.get(name)(**kw)
    assert ours.geometry == theirs.geometry
    for im in _images(np.random.default_rng(0)):
        for image in (im, Image.fromarray(im)):
            a, b = ours(image)["pixel_values"], theirs(image)["pixel_values"]
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    if hasattr(theirs, "resize_u8"):
        im = _images(np.random.default_rng(1))[0]
        np.testing.assert_array_equal(ours.resize_u8(im), theirs.resize_u8(im))


def test_build_image_processor_matches_jax():
    for vc in ({}, {"model_type": "dinov2", "img_size": 224}, {"keep_aspect_ratio": True},
               {"model_type": "biomedclip", "img_size": 224}, {"model_type": "m3ae"}):
        ours, theirs = tproc.build_image_processor(vc), jproc.build_image_processor(vc)
        assert type(ours).__name__ == type(theirs).__name__
        for f in ("size", "mean", "std", "geometry", "resize_size", "crop_size"):
            assert getattr(ours, f, None) == getattr(theirs, f, None), f
    with pytest.raises(NotImplementedError):
        tproc.build_image_processor({"model_type": "nope"})


@pytest.mark.parametrize("photometric,syntax,dtype", [
    ("MONOCHROME1", _EXPLICIT_LE, np.uint16),
    ("MONOCHROME2", _IMPLICIT_LE, np.uint8),
    ("MONOCHROME2", _JPEG_BASELINE, np.uint8),
])
def test_load_eval_image_matches_jax_on_synthetic_dicom(tmp_path, photometric, syntax, dtype):
    import io

    rng = np.random.default_rng(3)
    px = rng.integers(0, 4096 if dtype == np.uint16 else 256, (32, 40)).astype(dtype)
    jpeg = None
    if syntax == _JPEG_BASELINE:
        buf = io.BytesIO()
        Image.fromarray(px, "L").save(buf, "JPEG", quality=95)
        jpeg = buf.getvalue()
    path = tmp_path / "x.dcm"
    path.write_bytes(_make_dicom(px, photometric, syntax, jpeg_bytes=jpeg))
    arr, attrs = dicom_read(str(path))
    assert arr.shape == (32, 40) and attrs["PhotometricInterpretation"] == photometric
    ours, theirs = tdicom.load_eval_image(str(path)), jdicom.load_eval_image(str(path))
    assert ours.mode == theirs.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))
    np.testing.assert_array_equal(np.asarray(tdicom.minmax_normalize_uint8(ours)),
                                  np.asarray(jdicom.minmax_normalize_uint8(theirs)))


def test_load_eval_image_opens_a_png(tmp_path):
    im = _images(np.random.default_rng(4))[0]
    path = tmp_path / "x.png"
    Image.fromarray(im).save(path)
    with tdicom.load_eval_image(str(path)) as got:
        np.testing.assert_array_equal(np.asarray(got), im)


# ---------------------------------------------------------------------------
# scorer and model_inference
# ---------------------------------------------------------------------------

def _cfg(m):
    return m.RadZeroConfig(
        vision=m.ViTConfig(**VIT),
        text=m.TextConfig(**TEXT, attn_impl="flash"),
        align=m.AlignConfig(hidden_size=D, num_hidden_layers=2, num_attention_heads=4,
                            mlp_ratio=2.0),
        loss=m.LossConfig(hidden_dim=D),
    )


JCFG, TCFG = _cfg(jconf), _cfg(tconf)


@pytest.fixture(scope="module")
def weights():
    tree = perturbed(jax_init_radzero(jax.random.PRNGKey(0), JCFG), np.random.default_rng(0))
    return tree, params_from_jax(tree)


def _scorers(weights, batch_size, **kw):
    tree, params = weights
    theirs = JaxScorer(tree, JCFG, jproc.BlipStyleImageProcessor(size=56),
                       JaxTokenizer(vocab_size=211, max_length=12), batch_size=batch_size,
                       num_threads=2, fused_tower=False, **kw)
    ours = ZeroShotScorer(params, TCFG, tproc.BlipStyleImageProcessor(size=56),
                          WhitespaceHashTokenizer(vocab_size=211, max_length=12), device="cpu",
                          batch_size=batch_size, num_threads=2, fused_tower=False, **kw)
    return ours, theirs


@pytest.mark.parametrize("device_normalize", [False, True])
def test_scorer_score_matches_jax(weights, device_normalize):
    """5 items at batch 2 (the last batch is partial: the JAX scorer pads it,
    the port does not), maps requested; the repo's compute_logits gate."""
    ours, theirs = _scorers(weights, 2, device_normalize=device_normalize)
    assert ours.device_normalize == theirs.device_normalize == device_normalize
    items = (_images(np.random.default_rng(5)) + _images(np.random.default_rng(6)))[:5]
    saved = torch.backends.cudnn.allow_tf32
    logits, maps = ours.score(items, lambda it: it, PROMPTS, need_scores=True)
    assert torch.backends.cudnn.allow_tf32 == saved  # the scorer restores what it set
    ref_logits, ref_maps = theirs.score(items, lambda it: it, PROMPTS, need_scores=True)
    assert logits.shape == (5, 3) and maps.shape == (5, 3, 16) and logits.dtype == np.float32
    np.testing.assert_allclose(logits, ref_logits, rtol=1e-3, atol=2e-4)
    assert np.abs(maps - ref_maps).mean() < 1e-3
    only_logits, none = ours.score(items[:3], lambda it: it, PROMPTS)
    assert none is None
    np.testing.assert_allclose(only_logits, logits[:3], rtol=1e-5, atol=1e-6)


def test_scorer_score_paired_matches_jax(weights):
    ours, theirs = _scorers(weights, 2)
    items = _images(np.random.default_rng(7))[:3]
    texts = ["There is edema", "No finding", "There is a large pleural effusion"]
    logits, maps = ours.score_paired(items, lambda it: it, texts, need_scores=True)
    ref_logits, ref_maps = theirs.score_paired(items, lambda it: it, texts, need_scores=True)
    assert logits.shape == (3,) and maps.shape == (3, 16)
    np.testing.assert_allclose(logits, ref_logits, rtol=1e-3, atol=2e-4)
    assert np.abs(maps - ref_maps).mean() < 1e-3


def test_scorer_fused_tower_agrees_with_the_configured_layers(weights):
    """fused_tower=True (K1-K3 twins) and False (K13 twin in the tower) are
    the same function of the weights."""
    _, params = weights
    items = _images(np.random.default_rng(8))[:2]
    out = []
    for fused in (True, False):
        scorer = ZeroShotScorer(params, TCFG, tproc.BlipStyleImageProcessor(size=56),
                                WhitespaceHashTokenizer(vocab_size=211, max_length=12),
                                device="cpu", batch_size=2, num_threads=2, fused_tower=fused)
        out.append(scorer.score(items, lambda it: it, PROMPTS, need_scores=True))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=1e-4, atol=1e-5)


def test_model_inference_matches_jax(weights, tmp_path):
    tree, params = weights
    im = np.random.default_rng(9).integers(0, 256, (45, 60, 3), dtype=np.uint8)
    path = str(tmp_path / "cxr.png")
    Image.fromarray(im).save(path)
    ref_prob, ref_map = jax_model_inference(
        path, PROMPTS, JaxTokenizer(vocab_size=211, max_length=12),
        jproc.BlipStyleImageProcessor(size=56), (tree, JCFG))
    prob, smap = model_inference(
        path, PROMPTS, WhitespaceHashTokenizer(vocab_size=211, max_length=12),
        tproc.BlipStyleImageProcessor(size=56), (params, TCFG), device="cpu")
    assert prob.shape == (3,) and smap.shape == (3, 45, 60)
    assert ((prob > 0) & (prob < 1)).all() and ((smap >= 0) & (smap <= 1)).all()
    np.testing.assert_allclose(prob, ref_prob, atol=1e-4)
    assert np.abs(smap - ref_map).mean() < 1e-3
    one_prob, one_map = model_inference(
        path, PROMPTS[0], WhitespaceHashTokenizer(vocab_size=211, max_length=12),
        tproc.BlipStyleImageProcessor(size=56), (params, TCFG), device="cpu")
    assert one_prob.shape == (1,) and one_map.shape == (1, 45, 60)
    np.testing.assert_allclose(one_prob[0], prob[0], atol=1e-5)
