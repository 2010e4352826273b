"""Port modules against their JAX counterparts, fp32 on the CPU.

Weights come from the JAX initialisers through the parameter bridge
(radzero_torch.models.from_jax), with LN/LayerScale/bias leaves perturbed
so that identities cannot hide a wrong layout; inputs come from numpy.
The JAX fused layers run their Pallas kernels in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radzero_tpu.eval.geometry import upsample_similarity_map as jax_upsample
from radzero_tpu.models import align as jalign
from radzero_tpu.models import mpnet as jmpnet
from radzero_tpu.models import vit as jvit
from radzero_tpu.models.configuration import AlignConfig as JAlign
from radzero_tpu.models.configuration import TextConfig as JText
from radzero_tpu.models.configuration import ViTConfig as JViT
from radzero_torch.eval.geometry import FILL, upsample_similarity_map
from radzero_torch.models import align as talign
from radzero_torch.models import mpnet as tmpnet
from radzero_torch.models import vit as tvit
from radzero_torch.models.configuration import AlignConfig, TextConfig, ViTConfig
from radzero_torch.models.from_jax import params_from_jax

D = 64
VIT = dict(hidden_size=D, num_hidden_layers=2, num_attention_heads=4, mlp_ratio=2.0,
           patch_size=14, pretrain_img_size=42, img_size=56)
TEXT = dict(hidden_size=D, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
            vocab_size=211, max_position_embeddings=66)
_PERTURB = ("scale", "bias", "ls1", "ls2")


def perturbed(tree, rng, key=None):
    """numpy copy of a JAX tree with LN / LayerScale / bias leaves moved
    off their init values."""
    if isinstance(tree, dict):
        return {k: perturbed(v, rng, k) for k, v in tree.items()}
    a = np.asarray(tree, np.float32).copy()
    if key in _PERTURB:
        a += (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    return a


def _close(out, ref, tol=2e-5):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("eager", [False, True])
def test_vit_forward_matches_jax(eager):
    """Fused layers (the port's K1-K3 twins) against the JAX fused tower,
    eager layers against the JAX xla tower; 42 -> 56 px exercises the
    bicubic pos-embed resample (3x3 -> 4x4 grid)."""
    jcfg = JViT(**VIT, attn_impl="xla" if eager else "fused")
    tree = perturbed(jvit.init_vit(jax.random.PRNGKey(0), jcfg), np.random.default_rng(0))
    params = params_from_jax({"vision_model": tree})["vision_model"]
    pv = np.random.default_rng(1).standard_normal((2, 56, 56, 3)).astype(np.float32)

    ref = jvit.vit_forward(tree, jcfg, jnp.asarray(pv))
    out = tvit.vit_forward(params, ViTConfig(**VIT), torch.from_numpy(pv), eager=eager)
    assert out.shape == (2, 17, D)
    _close(out, ref)


def test_interpolate_pos_embed_matches_jax():
    rng = np.random.default_rng(2)
    pos = rng.standard_normal((1, 1 + 9, D)).astype(np.float32)
    ref = jvit.interpolate_pos_embed(jnp.asarray(pos), (4, 5))
    out = tvit.interpolate_pos_embed(torch.from_numpy(pos), (4, 5))
    _close(out, ref, 1e-6)


def test_patchify_matches_jax():
    x = np.arange(2 * 28 * 42 * 3, dtype=np.float32).reshape(2, 28, 42, 3)
    np.testing.assert_array_equal(
        tvit.patchify(torch.from_numpy(x), 14).numpy(), np.asarray(jvit.patchify(jnp.asarray(x), 14))
    )


@pytest.mark.parametrize("use_layer_norm", [False, True])
def test_align_adapter_matches_jax(use_layer_norm):
    kw = dict(hidden_size=D, num_hidden_layers=2, num_attention_heads=4, mlp_ratio=2.0,
              use_layer_norm=use_layer_norm)
    jcfg = JAlign(**kw, attn_impl="fused")
    jinit, japply = jalign.build_align_adapter("align_transformer")
    tree = perturbed(jinit(jax.random.PRNGKey(3), jcfg), np.random.default_rng(3))
    params = params_from_jax({"align_transformer": tree})["align_transformer"]
    tokens = np.random.default_rng(4).standard_normal((2, 17, D)).astype(np.float32)

    ref = japply(tree, jcfg, jnp.asarray(tokens))
    _, apply = talign.build_align_adapter("align_transformer")
    _close(apply(params, AlignConfig(**kw), torch.from_numpy(tokens)), ref)


def test_identity_adapter_passes_tokens():
    init, apply = talign.build_align_adapter("identity")
    t = torch.randn(2, 5, 8)
    assert init(torch.Generator(), AlignConfig()) == {}
    assert apply({}, AlignConfig(), t) is t
    with pytest.raises(NotImplementedError):
        talign.build_align_adapter("mlp")


def _text_inputs(rng, s=4, l=12):
    ids = np.full((s, l), 1, np.int32)
    mask = np.zeros((s, l), np.int32)
    for i in range(s):
        n = int(rng.integers(4, l + 1))
        ids[i, :n] = rng.integers(3, 211, n)
        ids[i, 0], ids[i, n - 1] = 0, 2
        mask[i, :n] = 1
    return ids, mask


@pytest.mark.parametrize("fuse_post", [False, True])
def test_mpnet_forward_matches_jax(fuse_post):
    """fuse_post=False: the XLA text path on both sides. fuse_post=True:
    the JAX side runs kernel K4 (interpreted); on the CPU the port's plain
    chain is that kernel's twin."""
    jcfg = JText(**TEXT, fuse_post=fuse_post)
    tree = perturbed(jmpnet.init_mpnet(jax.random.PRNGKey(5), jcfg), np.random.default_rng(5))
    params = params_from_jax({"text_model": tree})["text_model"]
    ids, mask = _text_inputs(np.random.default_rng(6))

    ref = jmpnet.mpnet_forward(tree, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    out = tmpnet.mpnet_forward(params, TextConfig(**TEXT, fuse_post=fuse_post),
                               torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    _close(out, ref)
    pooled = tmpnet.masked_mean_pool(out, torch.from_numpy(mask))
    _close(pooled, jmpnet.masked_mean_pool(ref, jnp.asarray(mask)))


def test_relative_position_buckets_match_jax():
    for l in (1, 12, 64, 300):
        np.testing.assert_array_equal(tmpnet.relative_position_bucket_table(l),
                                      jmpnet.relative_position_bucket_table(l))


def test_mpnet_fuse_post_on_cuda_raises():
    """fuse_post=True never quietly takes plain code in K4's place: only a
    CPU tensor runs the plain twin. Checked without a card: a tensor on
    another device raises. A tensor that requires a gradient goes through
    K4's autograd Function (backward K9) and gives the gradients of the eager
    chain; without a tape the same call stays off it."""
    cfg = TextConfig(**TEXT, fuse_post=True)
    params = tmpnet.init_mpnet(torch.Generator().manual_seed(0), cfg)
    rel = torch.zeros(4, 12, 12)
    neg = torch.zeros(4, 12)
    with pytest.raises(ValueError, match="device"):
        tmpnet.mpnet_layer(torch.zeros((4, 12, D), device="meta"),
                           _to_meta(params["layers"][0]), rel.to("meta"), neg.to("meta"), cfg)
    grads = {}
    for fuse_post in (True, False):
        x = torch.randn((4, 12, D), generator=torch.Generator().manual_seed(1),
                        requires_grad=True)
        out = tmpnet.mpnet_layer(x, params["layers"][0], rel, neg,
                                 dataclasses.replace(cfg, fuse_post=fuse_post))
        assert out.grad_fn is not None
        out.square().sum().backward()
        grads[fuse_post] = x.grad
    np.testing.assert_allclose(grads[True].numpy(), grads[False].numpy(), rtol=5e-4, atol=5e-4)
    with torch.no_grad():  # the same call without a tape runs the twin, off the tape
        out = tmpnet.mpnet_layer(x, params["layers"][0], rel, neg, cfg)
        assert out.shape == (4, 12, D) and out.grad_fn is None


def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    return tree.to("meta")


@pytest.mark.parametrize("geometry", ["resize", "aspect_pad", "center_crop", "m3ae"])
@pytest.mark.parametrize("origin", [(40, 30), (23, 57)])
def test_upsample_similarity_map_matches_jax(geometry, origin):
    scores = np.random.default_rng(8).standard_normal((3, 25)).astype(np.float32)
    out = upsample_similarity_map(scores, origin, geometry, device="cpu")
    ref = jax_upsample(scores, origin, geometry)
    assert out.shape == (3, *origin) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    if geometry in ("center_crop", "m3ae"):
        assert (out == FILL).any() == (ref == FILL).any()


def test_configs_load_the_yaml_preset_like_jax():
    import yaml
    from pathlib import Path

    from radzero_tpu.models.configuration import radzero_config_from_dict as jload
    from radzero_torch.models.configuration import radzero_config_from_dict as tload

    preset = Path(__file__).resolve().parent.parent / "radzero_tpu/config/configs/radzero.yaml"
    block = yaml.safe_load(preset.read_text())["model"]["model_config"]
    j, t = jload(dict(block)), tload(dict(block))
    for name in ("vision", "text", "align", "loss"):
        assert dataclasses.asdict(getattr(t, name)) == dataclasses.asdict(getattr(j, name))
    assert t.compute_logits_type == j.compute_logits_type
