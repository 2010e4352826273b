"""The port's SAM ViT-det tower against the JAX package's on the CPU:
``convert_sam``, the trunk and the neck (and HF ``SamVisionEncoder`` where
transformers is installed), the relative tables' linear resample and the
absolute grid's bicubic one off the stored grid, the registry entry, the
serving resample, the YAML dispatch of every alternate vision type, and
the tower inside compute_logits and forward_train.

Tolerances: the trunk and neck rtol 1e-4 / atol 1e-5
(tests/test_sam_vit.py); the composite's logits rtol 1e-3 / atol 2e-4 with
map MAE < 1e-3 (the repo's compute_logits gate), forward_train's loss and
gradients at the fused layers' 2e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radzero_tpu.models import configuration as jconf
from radzero_tpu.models import convert as jconvert
from radzero_tpu.models import sam_vit as jsam
from radzero_tpu.models.radzero import compute_logits as jax_compute_logits
from radzero_tpu.models.radzero import init_radzero as jax_init_radzero
from radzero_torch.models import configuration as tconf
from radzero_torch.models import convert, encoders, sam_vit
from radzero_torch.models.from_jax import params_from_jax
from radzero_torch.models.radzero import compute_logits, init_radzero

from test_torch_encoders import _same_tree

TOL = dict(rtol=1e-4, atol=1e-5)
TINY = dict(hidden_size=32, num_hidden_layers=3, num_attention_heads=2, mlp_dim=64,
            patch_size=8, image_size=32, img_size=32, window_size=3,
            global_attn_indexes=(1,), output_channels=16)


def _hf_state(seed, d=32, layers=3, heads=2, mlp=64, patch=8, grid=4, window=3,
              global_idx=(1,), out=16, prefix=""):
    """A random state dict in HF SamVisionEncoder's names (numpy), every leaf
    nonzero, so the position paths contribute."""
    rng = np.random.default_rng(seed)

    def t(*s):
        return (rng.standard_normal(s) * 0.05).astype(np.float32)

    hd = d // heads
    sd = {"patch_embed.projection.weight": t(d, 3, patch, patch),
          "patch_embed.projection.bias": t(d), "pos_embed": t(1, grid, grid, d),
          "neck.conv1.weight": t(out, d, 1, 1), "neck.layer_norm1.weight": 1 + t(out),
          "neck.layer_norm1.bias": t(out), "neck.conv2.weight": t(out, out, 3, 3),
          "neck.layer_norm2.weight": 1 + t(out), "neck.layer_norm2.bias": t(out)}
    for i in range(layers):
        edge = grid if i in global_idx else window
        p = f"layers.{i}"
        sd.update({f"{p}.layer_norm1.weight": 1 + t(d), f"{p}.layer_norm1.bias": t(d),
                   f"{p}.attn.qkv.weight": t(3 * d, d), f"{p}.attn.qkv.bias": t(3 * d),
                   f"{p}.attn.proj.weight": t(d, d), f"{p}.attn.proj.bias": t(d),
                   f"{p}.attn.rel_pos_h": t(2 * edge - 1, hd),
                   f"{p}.attn.rel_pos_w": t(2 * edge - 1, hd),
                   f"{p}.layer_norm2.weight": 1 + t(d), f"{p}.layer_norm2.bias": t(d),
                   f"{p}.mlp.lin1.weight": t(mlp, d), f"{p}.mlp.lin1.bias": t(mlp),
                   f"{p}.mlp.lin2.weight": t(d, mlp), f"{p}.mlp.lin2.bias": t(d)})
    return {prefix + k: v for k, v in sd.items()}


def perturbed(tree, rng, key=None):
    """numpy copy of a JAX tree (SAM's layers a list) with its LN, bias and
    position leaves (zero at init) moved off their init values."""
    if isinstance(tree, list):
        return [perturbed(v, rng, key) for v in tree]
    if isinstance(tree, dict):
        return {k: perturbed(v, rng, k) for k, v in tree.items()}
    a = np.asarray(tree, np.float32).copy()
    if key in ("scale", "bias", "ls1", "ls2", "pos_embed", "rel_pos_h", "rel_pos_w"):
        a += (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    return a


def _pair(seed=0, **kw):
    """(JAX tree, port tree, JAX cfg, port cfg) from one converted state dict."""
    cfg = {**TINY, **kw}
    tree = convert.convert_sam(_hf_state(seed), cfg["num_hidden_layers"])
    return (tree, params_from_jax({"vision_model": tree})["vision_model"],
            jsam.SamViTConfig(**cfg), sam_vit.SamViTConfig(**cfg))


def _pixels(seed, b, size):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("prefix", ["", "vision_encoder."])
def test_convert_sam_matches_jax(prefix):
    """Bare encoder names and a whole SamModel's (prefix stripped); layers
    stay a list, tables keep their per-layer shapes."""
    sd = _hf_state(1, prefix=prefix)
    if prefix:
        sd["prompt_encoder.shared_embedding.positional_embedding"] = np.zeros((2, 8), np.float32)
    tree = convert.convert_sam(sd, 3)
    _same_tree(tree, jconvert.convert_sam(sd, 3))
    assert isinstance(tree["layers"], list)
    assert [p["rel_pos_h"].shape[0] for p in tree["layers"]] == [5, 7, 5]
    port = params_from_jax({"vision_model": tree})["vision_model"]
    assert isinstance(port["layers"], list) and port["layers"][1]["rel_pos_w"].shape == (7, 16)


def test_sam_trunk_and_neck_match_jax():
    tree, params, jcfg, tcfg = _pair(0)
    x = _pixels(0, 2, 32)
    trunk = sam_vit.sam_trunk(params, tcfg, torch.from_numpy(x))
    ref_trunk = np.asarray(jsam.sam_trunk(tree, jcfg, jnp.asarray(x)))
    np.testing.assert_allclose(trunk.numpy(), ref_trunk, **TOL)
    neck = sam_vit.sam_neck(params, tcfg, trunk)
    assert neck.shape == (2, 4, 4, 16)
    np.testing.assert_allclose(neck.numpy(), np.asarray(jsam.sam_neck(tree, jcfg, ref_trunk)),
                               **TOL)


def test_sam_trunk_and_neck_match_hf():
    """tests/test_sam_vit.py's HF oracle, held by the port."""
    pytest.importorskip("transformers")
    import test_sam_vit as ts

    model, tree, jcfg = ts._tiny_pair(seed=2)
    params = params_from_jax({"vision_model": tree})["vision_model"]
    tcfg = sam_vit.SamViTConfig(**dataclasses.asdict(jcfg))
    x = _pixels(3, 2, 32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    with torch.no_grad():
        hidden = model.patch_embed(xt) + model.pos_embed
        for layer in model.layers:
            hidden = layer(hidden)
        ref_neck = model(xt).last_hidden_state.numpy()
    trunk = sam_vit.sam_trunk(params, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(trunk.numpy(), hidden.numpy(), **TOL)
    np.testing.assert_allclose(sam_vit.sam_neck(params, tcfg, trunk).permute(0, 3, 1, 2).numpy(),
                               ref_neck, **TOL)


@pytest.mark.parametrize("img", [48, 24])
def test_sam_offgrid_resample_matches_jax(img):
    """Runtime grid 6 x 6 (or 3 x 3) against the stored 4 x 4: the absolute grid
    resamples bicubically, the global layer's tables linearly (7 -> 11 or 5);
    then the serving resample once gives the per-call forward's bits."""
    tree, params, jcfg, tcfg = _pair(1)
    jcfg, tcfg = (dataclasses.replace(c, img_size=img) for c in (jcfg, tcfg))
    x = _pixels(2, 1, img)
    out = sam_vit.sam_vit_forward(params, tcfg, torch.from_numpy(x))
    g = img // 8
    assert out.shape == (1, 1 + g * g, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(jsam.sam_vit_forward(tree, jcfg, x)),
                               **TOL)
    np.testing.assert_allclose(
        sam_vit._rel_pos_table(params["layers"][1]["rel_pos_h"], g).numpy(),
        np.asarray(jsam._rel_pos_table(jnp.asarray(tree["layers"][1]["rel_pos_h"]), g)),
        rtol=1e-6, atol=1e-7)
    at_grid = encoders.vision_params_at_grid(params, tcfg, g)
    assert at_grid["pos_embed"].shape == (1, g, g, 32)
    assert at_grid["layers"][1]["rel_pos_h"].shape == (2 * g - 1, 16)
    assert at_grid["layers"][0]["rel_pos_h"] is params["layers"][0]["rel_pos_h"]
    assert torch.equal(sam_vit.sam_vit_forward(at_grid, tcfg, torch.from_numpy(x)), out)


def test_sam_registry_entry_matches_jax():
    kw = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2, mlp_dim=32,
              patch_size=8, image_size=16, img_size=16, window_size=2, global_attn_indexes=(),
              output_channels=8)
    init, apply = encoders.build_vision_encoder("sam")
    tree = perturbed(jsam.init_sam_vit(jax.random.PRNGKey(0), jsam.SamViTConfig(**kw)),
                     np.random.default_rng(0))
    fresh = init(torch.Generator().manual_seed(0), sam_vit.SamViTConfig(**kw))
    assert sorted(fresh) == sorted(tree) and len(fresh["layers"]) == 1
    assert fresh["layers"][0]["rel_pos_h"].shape == (3, 8)  # window 2
    x = _pixels(0, 1, 16)
    out = apply(params_from_jax({"vision_model": tree})["vision_model"],
                sam_vit.SamViTConfig(**kw), torch.from_numpy(x))
    assert out.shape == (1, 1 + 4, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(jsam.sam_vit_forward(tree, jsam.SamViTConfig(**kw), x)),
                               **TOL)


@pytest.mark.parametrize("block", [
    {"model_type": "sam", "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
     "mlp_dim": 64, "patch_size": 8, "image_size": 32, "img_size": 32, "window_size": 2,
     "global_attn_indexes": [1], "output_channels": 16},
    {"model_type": "siglip", "hidden_size": 64, "use_class_token": False},
    {"model_type": "biomedclip", "img_size": 224, "hidden_act": "gelu"},
    {"model_type": "xrayclip", "img_size": 512},
    {"model_type": "m3ae", "hidden_size": 64},
    {"model_type": "raddino", "patch_size": 14},
])
def test_vision_config_yaml_dispatch_matches_jax(block):
    """radzero_config_from_dict routes vision_config.model_type to the same
    config class with the same fields as the JAX package (a tuple for SAM's
    global_attn_indexes, so the config stays hashable)."""
    mc = {"vision_config": dict(block), "text_config": {"hidden_size": 32}}
    ours = tconf.radzero_config_from_dict(mc).vision
    ref = jconf.radzero_config_from_dict({"vision_config": dict(block),
                                          "text_config": {"hidden_size": 32}}).vision
    assert type(ours).__name__ == type(ref).__name__
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    hash(ours)
    with pytest.raises(NotImplementedError):
        tconf.radzero_config_from_dict({"vision_config": {"model_type": "convnext"}})


D = 32


def _composite(m, vision):
    """The JAX suite's composite at D 32 (tests/test_sam_vit.py); the JAX side
    runs the eager align layer and MPNet chain, the port its kernels' twins."""
    jax_side = m is jconf
    return m.RadZeroConfig(
        vision=vision,
        text=m.TextConfig(hidden_size=D, num_hidden_layers=1, num_attention_heads=2,
                          intermediate_size=64, vocab_size=101, max_position_embeddings=40,
                          fuse_post=not jax_side),
        align=m.AlignConfig(hidden_size=D, num_hidden_layers=1, num_attention_heads=2,
                            mlp_ratio=2.0, attn_impl="xla" if jax_side else "fused_vjp"),
        loss=m.LossConfig(hidden_dim=D),
    )


SAM_COMPOSITE = dict(hidden_size=D, num_hidden_layers=2, num_attention_heads=2, mlp_dim=64,
                     patch_size=8, image_size=32, img_size=32, window_size=2,
                     global_attn_indexes=(1,), output_channels=16)


def test_sam_tower_in_compute_logits_matches_jax():
    jcfg = _composite(jconf, jsam.SamViTConfig(**SAM_COMPOSITE))
    tcfg = _composite(tconf, sam_vit.SamViTConfig(**SAM_COMPOSITE))
    tree = perturbed(jax_init_radzero(jax.random.PRNGKey(0), jcfg), np.random.default_rng(0))
    assert isinstance(init_radzero(torch.Generator().manual_seed(0), tcfg)["vision_model"]
                      ["layers"], list)
    rng = np.random.default_rng(0)
    pv = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(3, 101, (3, 8)).astype(np.int64)
    mask = np.ones((3, 8), np.int64)
    mask[2, 5:] = 0
    ref = jax_compute_logits(tree, jcfg, pv, ids, mask)
    params = params_from_jax(tree)
    for eager in (False, True):
        out = compute_logits(params, tcfg, torch.from_numpy(pv), torch.from_numpy(ids),
                             torch.from_numpy(mask), eager=eager)
        assert out["logits"].shape == (2, 3) and out["similarity_scores"].shape == (2, 3, 16)
        np.testing.assert_allclose(out["logits"].numpy(), np.asarray(ref["logits"]), rtol=1e-3,
                                   atol=2e-4)
        assert np.abs(out["similarity_scores"].numpy()
                      - np.asarray(ref["similarity_scores"])).mean() < 1e-3
