"""The composite model with the alternate towers, the port against the JAX
package on the CPU: compute_logits with the MAE, BiomedCLIP (timm layout)
and SigLIP vision towers and the BERT-family text towers (the projector
after pooling), forward_train's loss and gradients with SAM, MAE, BERT and
BiomedCLIP text, the CLIP text tower refused where the JAX composite
refuses it, the scorer and the serving engine with an alternate vision
tower (the kernels' plain versions), and the tower cache's tokens.

The JAX side runs its eager align layer and MPNet chain, the port the
plain versions of K1-K4 and K6-K9 (the defaults). Gates: logits rtol 1e-3 /
atol 2e-4 with map MAE < 1e-3 (the repo's compute_logits gate), the loss
and every gradient leaf of the trainable modules rtol 2e-4 / atol 1e-5
(the fused layers' 2e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radzero_tpu.data import processing as jproc
from radzero_tpu.data.tokenizer import WhitespaceHashTokenizer as JaxTokenizer
from radzero_tpu.eval.scorer import ZeroShotScorer as JaxScorer
from radzero_tpu.models import clip_vit as jclip
from radzero_tpu.models import configuration as jconf
from radzero_tpu.models import mae_vit as jmae
from radzero_tpu.models import sam_vit as jsam
from radzero_tpu.models.radzero import compute_logits as jax_compute_logits
from radzero_tpu.models.radzero import forward_text as jax_forward_text
from radzero_tpu.models.radzero import forward_train as jax_forward_train
from radzero_tpu.models.radzero import init_radzero as jax_init_radzero
from radzero_tpu.train.tower_cache import make_tower_fn as jax_make_tower_fn
from radzero_torch.data import processing as tproc
from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
from radzero_torch.eval.scorer import ZeroShotScorer
from radzero_torch.eval.serving import ImageSpec, ServingEngine, serving_params
from radzero_torch.models import clip_vit, mae_vit, sam_vit
from radzero_torch.models import configuration as tconf
from radzero_torch.models.from_jax import params_from_jax, params_to_numpy
from radzero_torch.models.radzero import (
    compute_logits, forward_text, forward_train, forward_vision, init_radzero,
)
from radzero_torch.ops.layers import normalize_pixels
from radzero_torch.train import optim as toptim
from radzero_torch.train.tower_cache import make_tower_fn

from test_torch_sam import perturbed
from test_torch_train import _leaves

D = 32
TRAINABLE = ("align_transformer", "text_model", "loss_fns")
PROMPTS = ["There is pneumothorax", "There is edema", "No finding"]
VISION = {
    "mae": (jmae.MAEViTConfig, mae_vit.MAEViTConfig,
            dict(hidden_size=D, num_hidden_layers=1, num_attention_heads=2, patch_size=8,
                 img_size=32)),
    "sam": (jsam.SamViTConfig, sam_vit.SamViTConfig,
            dict(hidden_size=D, num_hidden_layers=2, num_attention_heads=2, mlp_dim=64,
                 patch_size=8, image_size=32, img_size=32, window_size=2,
                 global_attn_indexes=(1,), output_channels=16)),
    # the timm layout BiomedCLIP's tower converts from: gelu, final LN
    "biomedclip": (jclip.ClipViTConfig, clip_vit.ClipViTConfig,
                   dict(model_type="biomedclip", hidden_size=D, num_hidden_layers=1,
                        num_attention_heads=2, intermediate_size=64, patch_size=8,
                        pretrain_img_size=32, img_size=32, hidden_act="gelu",
                        final_layernorm=True)),
    "siglip": (jclip.ClipViTConfig, clip_vit.ClipViTConfig,
               dict(model_type="siglip", hidden_size=D, num_hidden_layers=1,
                    num_attention_heads=2, intermediate_size=64, patch_size=8,
                    pretrain_img_size=32, img_size=32, hidden_act="gelu_pytorch_tanh",
                    use_class_token=False, final_layernorm=True)),
}


def _cfgs(vision="mae", text="mpnet", **text_kw):
    """(JAX config, port config): the JAX side's align layer and MPNet chain
    eager, the port's on the kernels' plain versions."""
    jv, tv, vkw = VISION[vision]
    out = []
    for m, v in ((jconf, jv), (tconf, tv)):
        jax_side = m is jconf
        out.append(m.RadZeroConfig(
            vision=v(**vkw),
            text=m.TextConfig(model_type=text, hidden_size=D, num_hidden_layers=1,
                              num_attention_heads=2, intermediate_size=64, vocab_size=101,
                              max_position_embeddings=40, fuse_post=not jax_side, **text_kw),
            align=m.AlignConfig(hidden_size=D, num_hidden_layers=1, num_attention_heads=2,
                                mlp_ratio=2.0, attn_impl="xla" if jax_side else "fused_vjp"),
            loss=m.LossConfig(hidden_dim=D),
        ))
    return out


def _weights(jcfg, seed):
    tree = perturbed(jax_init_radzero(jax.random.PRNGKey(seed), jcfg), np.random.default_rng(seed))
    return tree, params_from_jax(tree)


def _text(seed, n=3, l=8):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 101, (n, l)).astype(np.int64)
    mask = np.ones((n, l), np.int64)
    mask[-1, 5:] = 0
    return ids, mask


def _logits_gate(out, ref):
    assert set(out) == set(ref)
    np.testing.assert_allclose(out["logits"].detach().numpy(), np.asarray(ref["logits"]),
                               rtol=1e-3, atol=2e-4)
    if "similarity_scores" in ref:
        mae = np.abs(out["similarity_scores"].detach().numpy()
                     - np.asarray(ref["similarity_scores"])).mean()
        assert mae < 1e-3


@pytest.mark.parametrize("vision,text,projection", [
    ("mae", "mpnet", False), ("biomedclip", "mpnet", False), ("siglip", "mpnet", False),
    ("mae", "bioclinicalmpbert", False), ("biomedclip", "biomedclip", True),
    ("mae", "bert", True),
])
def test_compute_logits_with_alternate_towers_matches_jax(vision, text, projection):
    """Each alternate vision tower and BERT-family text tower in compute_logits,
    the kernel route (fused_towers) and the eager route; with the projector the
    BERT path projects the pooled features (ref modeling.py:202-203)."""
    jcfg, tcfg = _cfgs(vision, text, use_text_projection=projection)
    tree, params = _weights(jcfg, 1)
    assert ("token_type" in params["text_model"]["embeddings"]) == (text != "mpnet")
    pv = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ids, mask = _text(3)
    ref = jax_compute_logits(tree, jcfg, pv, ids, mask)
    l_maps = 15 if vision == "siglip" else 16  # SigLIP has no CLS slot to strip
    for eager in (False, True):
        out = compute_logits(params, tcfg, torch.from_numpy(pv), torch.from_numpy(ids),
                             torch.from_numpy(mask), eager=eager)
        assert out["similarity_scores"].shape == (2, 3, l_maps)
        _logits_gate(out, ref)


def _batch(seed, b=2, s_per=2, l=8, size=32):
    rng = np.random.default_rng(seed)
    ids, mask = _text(seed, b * s_per, l)
    row_mask = np.ones(b * s_per, np.float32)
    row_mask[-1] = 0.0
    return {"pixel_values": rng.standard_normal((b, size, size, 3)).astype(np.float32),
            "input_ids": ids, "attention_mask": mask,
            "group_map": np.repeat(np.arange(b), s_per).astype(np.int64), "row_mask": row_mask}


@pytest.mark.parametrize("vision,text", [("sam", "mpnet"), ("mae", "mpnet"),
                                         ("sam", "bioclinicalmpbert"), ("mae", "biomedclip")])
def test_forward_train_with_alternate_towers_matches_jax(vision, text):
    """The loss and the gradient tree of the trainable modules (align layers on
    K1-K3 / K6-K8's plain versions, the text tower, the loss head) against
    jax.value_and_grad of the JAX forward_train, tower frozen."""
    jcfg, tcfg = _cfgs(vision, text)
    tree, params = _weights(jcfg, 4)
    batch = _batch(5)
    jtrain = {k: v for k, v in tree.items() if k in TRAINABLE}
    jfrozen = {k: v for k, v in tree.items() if k not in TRAINABLE}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(trainable):
        return jax_forward_train({**trainable, **jfrozen}, jcfg, jbatch,
                                 stop_vision_gradient=True)["losses"]["loss"]

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, jtrain))
    trainable, frozen = toptim.partition_params(params, TRAINABLE)
    for p in toptim.tree_leaves(trainable):
        p.requires_grad_(True)
    out = forward_train(toptim.merge_params(trainable, frozen), tcfg,
                        {k: torch.from_numpy(v) for k, v in batch.items()},
                        stop_vision_gradient=True)
    out["losses"]["loss"].backward()
    np.testing.assert_allclose(out["losses"]["loss"].item(), np.asarray(ref_loss), rtol=2e-4,
                               atol=1e-5)
    ref = dict(_leaves(params_to_numpy(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                              ref_grads)))))
    got = {path: p.grad.numpy() for path, p in _leaves(trainable)}
    assert sorted(got) == sorted(ref)
    for path in ref:
        np.testing.assert_allclose(got[path], ref[path], rtol=2e-4, atol=1e-5, err_msg=path)


@pytest.mark.parametrize("text", ["clip_text", "siglip_text_model"])
def test_clip_text_tower_refused_where_jax_refuses_it(text):
    """Both packages build the CLIP text tower's weights, and both composites
    refuse it in forward_text with NotImplementedError
    (radzero_tpu/models/radzero.py:240-241): compute_logits and forward_train
    stop there too."""
    jcfg, tcfg = _cfgs("mae", text)
    tree, params = _weights(jcfg, 6)
    assert sorted(params["text_model"]) == ["embeddings", "final_ln", "layers"]
    fresh = init_radzero(torch.Generator().manual_seed(0), tcfg)
    assert sorted(fresh["text_model"]) == sorted(params["text_model"])
    ids, mask = _text(7)
    with pytest.raises(NotImplementedError, match="in composite model"):
        jax_forward_text(tree, jcfg, ids, mask)
    with pytest.raises(NotImplementedError, match="in composite model"):
        forward_text(params, tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    pv = torch.zeros(1, 32, 32, 3)
    with pytest.raises(NotImplementedError, match="in composite model"):
        compute_logits(params, tcfg, pv, torch.from_numpy(ids), torch.from_numpy(mask))
    batch = {k: torch.from_numpy(v) for k, v in _batch(7).items()}
    with pytest.raises(NotImplementedError, match="in composite model"):
        forward_train(params, tcfg, batch)


def _u8(seed, n, size=32):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("vision", ["mae", "sam"])
def test_scorer_with_alternate_vision_tower_matches_jax(vision):
    """ZeroShotScorer(fused_tower=True) with an alternate vision tower (the align
    layers on K1-K3's plain versions) against the JAX scorer, 5 images at batch 2,
    maps requested, the repo's gate."""
    jcfg, tcfg = _cfgs(vision)
    tree, params = _weights(jcfg, 8)
    theirs = JaxScorer(tree, jcfg, jproc.BlipStyleImageProcessor(size=32),
                       JaxTokenizer(vocab_size=101, max_length=8), batch_size=2, num_threads=2,
                       fused_tower=False)
    ours = ZeroShotScorer(params, tcfg, tproc.BlipStyleImageProcessor(size=32),
                          WhitespaceHashTokenizer(vocab_size=101, max_length=8), device="cpu",
                          batch_size=2, num_threads=2, fused_tower=True)
    items = _u8(9, 5)
    logits, maps = ours.score(items, lambda it: it, PROMPTS, need_scores=True)
    ref_logits, ref_maps = theirs.score(items, lambda it: it, PROMPTS, need_scores=True)
    assert logits.shape == (5, 3) and maps.shape == (5, 3, 16)
    np.testing.assert_allclose(logits, ref_logits, rtol=1e-3, atol=2e-4)
    assert np.abs(maps - ref_maps).mean() < 1e-3


@pytest.mark.parametrize("vision", ["sam", "biomedclip", "mae"])
def test_serving_engine_with_alternate_vision_tower(vision):
    """ServingEngine at 48 px against towers stored for 32 (SAM's absolute grid
    and global tables, the CLIP table resampled once by serving_params): the
    engine's probabilities and 6 x 6 maps against compute_logits on the raw
    weights, which resamples every call, and against the JAX package."""
    jcfg, tcfg = _cfgs(vision)
    jcfg, tcfg = (dataclasses.replace(c, vision=dataclasses.replace(c.vision, img_size=48))
                  for c in (jcfg, tcfg))
    tree, params = _weights(jcfg, 10)
    tok = WhitespaceHashTokenizer(vocab_size=101, max_length=8)
    images = [im[..., 0] for im in _u8(11, 3, 48)]
    with ServingEngine(params, tcfg, tok, device="cpu", dtype=torch.float32, max_batch=4,
                       channels=1, preprocess_threads=2) as engine:
        assert engine.image_spec.size == 48
        engine.register_prompt_set("p", PROMPTS)
        results = [f.result(timeout=120) for f in
                   [engine.submit(im, "p", want_maps=True) for im in images]]
    ids, mask = (torch.as_tensor(a).long() for a in tok(PROMPTS))
    u8 = torch.from_numpy(np.stack(images))[..., None].expand(-1, 48, 48, 3)
    pv = normalize_pixels(u8, ImageSpec().mean, ImageSpec().std, dtype=torch.float32)
    out = compute_logits(params, tcfg, pv, ids, mask)
    ref = jax_compute_logits(tree, jcfg, pv.numpy(), ids.numpy(), mask.numpy())
    _logits_gate(out, ref)
    for i, r in enumerate(results):
        assert r["similarity_maps"].shape == (3, 6, 6)
        np.testing.assert_allclose(r["probs"], torch.sigmoid(out["logits"][i]).numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["similarity_maps"].reshape(3, -1),
                                   torch.sigmoid(out["similarity_scores"][i]).numpy(),
                                   rtol=1e-5, atol=1e-6)
    # the tree the engine holds: the forward on it passes every table through
    held = serving_params(params, tcfg, torch.float32, "cpu", 48)
    with torch.no_grad():
        a = forward_vision(held, tcfg, pv)["vision_tokens"]
        b = forward_vision(params, tcfg, pv)["vision_tokens"]
    assert torch.equal(a, b)


@pytest.mark.parametrize("vision", ["sam", "mae", "biomedclip"])
def test_tower_cache_tokens_with_alternate_vision_tower(vision):
    """make_tower_fn's tokens are the in-step tower's, bit for bit, and the
    JAX make_tower_fn's at the towers' tolerance; a step from the cached
    tokens gives the step's losses and gradients bit for bit."""
    jcfg, tcfg = _cfgs(vision)
    tree, params = _weights(jcfg, 12)
    batch = {k: torch.from_numpy(v) for k, v in _batch(13).items()}
    tokens = make_tower_fn(tcfg, dtype=torch.float32)(params["vision_model"],
                                                      batch["pixel_values"])
    assert tokens.shape[:2] == (2, 17) and not tokens.requires_grad
    ref = jax_make_tower_fn(jcfg, dtype=jnp.float32)(tree["vision_model"],
                                                     batch["pixel_values"].numpy())
    np.testing.assert_allclose(tokens.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)

    def step(b):
        trainable, frozen = toptim.partition_params(params, TRAINABLE)
        trainable = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), trainable)
        out = forward_train(toptim.merge_params(trainable, frozen), tcfg, b,
                            stop_vision_gradient=True)
        out["losses"]["loss"].backward()
        return out["losses"]["loss"], [p.grad for _, p in _leaves(trainable)]

    loss_a, grads_a = step(batch)
    cached = {k: v for k, v in batch.items() if k != "pixel_values"} | {"tower_tokens": tokens}
    loss_b, grads_b = step(cached)
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(a, b) for a, b in zip(grads_a, grads_b))
