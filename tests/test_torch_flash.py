"""K13-K16 and the layers that run them, against the JAX package, fp32 on
the CPU.

The JAX side runs ``flash_attention`` / ``flash_attention_bias`` with its
Pallas kernels in interpret mode (as tests/test_flash_attention.py does);
the port side runs the wrappers on CPU tensors, which take the plain twins.
Inputs come from numpy with fixed seeds. Tolerances are the JAX suite's:
rtol 1e-4 / atol 1e-5 forward (2e-5 with the bias), rtol 1e-4 / atol 1e-4
on gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radzero_tpu.models import align as jalign
from radzero_tpu.models import configuration as jconf
from radzero_tpu.models import mpnet as jmpnet
from radzero_tpu.models.radzero import compute_logits as jax_compute_logits
from radzero_tpu.models.radzero import init_radzero as jax_init_radzero
from radzero_tpu.ops.flash_attention import flash_attention as jax_flash
from radzero_tpu.ops.flash_attention import flash_attention_bias as jax_flash_bias
from radzero_torch.models import align as talign
from radzero_torch.models import configuration as tconf
from radzero_torch.models import mpnet as tmpnet
from radzero_torch.models.from_jax import params_from_jax
from radzero_torch.models.radzero import compute_logits
from radzero_torch.models.vit import layer_impl
from radzero_torch.ops import flash_attention as tfa
from radzero_torch.ops.layers import attention

from test_torch_backward import _leaves, params_to_numpy
from test_torch_modules import TEXT, VIT, perturbed

D, HEADS = 64, 4


def _qkv(rng, b, l, h=4, hd=32, n=3):
    return [rng.standard_normal((b, l, h, hd)).astype(np.float32) for _ in range(n)]


def _bias_and_mask(rng, b, l, h, lengths=None):
    bias = (0.5 * rng.standard_normal((h, l, l))).astype(np.float32)
    lengths = rng.integers(2, l + 1, b) if lengths is None else np.asarray(lengths)
    mask = (np.arange(l)[None] < lengths[:, None]).astype(np.float32)
    return bias, ((1.0 - mask) * np.finfo(np.float32).min).astype(np.float32)


def _t(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


# ---------------------------------------------------------------------------
# K13 / K14
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stable", [None, True, False])
@pytest.mark.parametrize("l", [19, 37, 130, 257])
def test_flash_attention_twin_matches_jax(l, stable):
    """The port always subtracts the row maximum; at these magnitudes the
    JAX kernel's ``stable=False`` shortcut agrees within the same tolerance."""
    q, k, v = _qkv(np.random.default_rng(l), 2, l)
    ref = jax_flash(*map(jnp.asarray, (q, k, v)), None, stable)
    launches = tfa.flash_attention.launches
    out = tfa.flash_attention(*_t(q, k, v), stable=stable)
    assert tfa.flash_attention.launches == launches  # CPU tensors: plain twin, no kernel
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("l,kv_len", [(128, 100), (256, 130), (37, None)])
def test_flash_attention_function_matches_jax_vjp(l, kv_len):
    """Forward and dq, dk, dv through the port's Function against jax.vjp,
    with ``kv_len < L`` (the persistent-padding contract: padded keys are
    masked, padded query rows are computed) and without; a custom scale."""
    rng = np.random.default_rng(l)
    q, k, v, g = _qkv(rng, 2, l, n=4)
    ref, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, 0.2, None, kv_len),
                       *map(jnp.asarray, (q, k, v)))
    ref_g = vjp(jnp.asarray(g))
    tq, tk, tv = _t(q, k, v, grad=True)
    out = tfa.flash_attention(tq, tk, tv, scale=0.2, kv_len=kv_len)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=name)
    if kv_len is not None:  # keys past kv_len get no gradient
        assert not grads[1][:, kv_len:].any() and not grads[2][:, kv_len:].any()


def test_flash_attention_takes_views_of_a_packed_product():
    """q, k, v sliced from one (B, L, 3D) tensor give what copies give."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((2, 19, 3 * D)).astype(np.float32))
    views = [qkv[..., i * D:(i + 1) * D].reshape(2, 19, HEADS, D // HEADS) for i in range(3)]
    assert not views[1].is_contiguous()
    out = tfa.flash_attention(*views)
    ref = tfa.flash_attention(*(t.contiguous() for t in views))
    assert torch.equal(out, ref)
    np.testing.assert_allclose(out.numpy(), attention(*views).numpy(), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# K15 / K16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stable", [None, False])
@pytest.mark.parametrize("l", [19, 37, 130, 257])
def test_flash_attention_bias_twin_matches_jax(l, stable):
    rng = np.random.default_rng(100 + l)
    q, k, v = _qkv(rng, 3, l)
    bias, neg = _bias_and_mask(rng, 3, l, 4)
    ref = jax_flash_bias(*map(jnp.asarray, (q, k, v, bias, neg)), None, stable)
    launches = tfa.flash_attention_bias.launches
    out = tfa.flash_attention_bias(*_t(q, k, v, bias, neg), stable=stable)
    assert tfa.flash_attention_bias.launches == launches
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("l,kv_len", [(19, None), (37, None), (130, None), (128, 100)])
def test_flash_attention_bias_function_matches_jax_vjp(l, kv_len):
    """Forward, dq, dk, dv and d(bias) (the sum over the batch of dS before
    the scale) against jax.vjp; the mask gets no gradient."""
    rng = np.random.default_rng(200 + l)
    q, k, v, g = _qkv(rng, 3, l, n=4)
    bias, neg = _bias_and_mask(rng, 3, l, 4, lengths=[l, max(2, l // 3), l - 1])
    ref, vjp = jax.vjp(
        lambda q, k, v, b: jax_flash_bias(q, k, v, b, jnp.asarray(neg), 0.3, None, kv_len),
        *map(jnp.asarray, (q, k, v, bias)))
    ref_g = vjp(jnp.asarray(g))
    tq, tk, tv, tb = _t(q, k, v, bias, grad=True)
    tneg = torch.from_numpy(neg).requires_grad_(True)
    out = tfa.flash_attention_bias(tq, tk, tv, tb, tneg, scale=0.3, kv_len=kv_len)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=2e-5)
    grads = torch.autograd.grad(out, (tq, tk, tv, tb, tneg), torch.from_numpy(g),
                                allow_unused=True)
    assert grads[4] is None  # d(neg_mask): a structural mask, by contract
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), grads, ref_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=name)


def test_fully_padded_sentence_is_nan_as_in_jax():
    """A sentence whose mask is all zero: the mask times log2(e) overflows
    to -inf on every key, and -inf minus the row maximum -inf is NaN, in the
    JAX kernel and in the port alike. The other sentences are untouched, and
    padded query rows of a real sentence are computed."""
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 3, 19)
    bias, neg = _bias_and_mask(rng, 3, 19, 4, lengths=[19, 0, 5])
    ref = np.asarray(jax_flash_bias(*map(jnp.asarray, (q, k, v, bias, neg))))
    out = tfa.flash_attention_bias(*_t(q, k, v, bias, neg)).numpy()
    assert np.isnan(ref[1]).all() and np.isnan(out[1]).all()
    assert np.isfinite(out[[0, 2]]).all()
    np.testing.assert_allclose(out[[0, 2]], ref[[0, 2]], rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("biased", [False, True])
def test_backward_twin_matches_autograd_of_eager_attention(biased):
    """The backward twins hold the flash-attention identities: their output
    equals autograd through the eager ``attention`` on the same operands."""
    rng = np.random.default_rng(9)
    q, k, v, g = _qkv(rng, 2, 37, n=4)
    bias, neg = _bias_and_mask(rng, 2, 37, 4, lengths=[37, 11])
    tq, tk, tv, tb = _t(q, k, v, bias, grad=True)
    tneg, tg = _t(neg, g)
    if biased:
        out = attention(tq, tk, tv, bias=tb[None] + tneg[:, None, None, :], scale=0.25)
        ref = torch.autograd.grad(out, (tq, tk, tv, tb), tg)
        got = tfa.flash_attention_bias_bwd_plain(*_t(q, k, v, bias, neg, g), scale=0.25)
    else:
        out = attention(tq, tk, tv, scale=0.25)
        ref = torch.autograd.grad(out, (tq, tk, tv), tg)
        got = tfa.flash_attention_bwd_plain(*_t(q, k, v, g), scale=0.25)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_functions_keep_their_inputs_and_return_operand_types():
    q, k, v = (torch.randn(2, 9, 2, 16, dtype=torch.bfloat16).requires_grad_(i == 0)
               for i in range(3))
    bias = torch.randn(2, 9, 9).requires_grad_(True)
    out = tfa.flash_attention_bias(q, k, v, bias, torch.zeros(2, 9))
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert {t.data_ptr() for t in out.grad_fn.saved_tensors} >= {q.data_ptr(), bias.data_ptr()}
    out.float().sum().backward()
    assert q.grad.dtype == torch.bfloat16 and k.grad is None
    assert bias.grad.dtype == torch.float32 and bias.grad.shape == bias.shape
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v).grad_fn is None
    with pytest.raises(ValueError, match="kv_len"):
        tfa.flash_attention(q, k, v, kv_len=10)


# ---------------------------------------------------------------------------
# layers and the slice
# ---------------------------------------------------------------------------

def test_dinov2_layer_flash_matches_jax_values_and_gradients():
    """One align layer with ``attn_impl="flash"`` on both sides: output,
    every parameter gradient and the input gradient."""
    kw = dict(hidden_size=D, num_hidden_layers=1, num_attention_heads=HEADS, mlp_ratio=2.0)
    jcfg = jconf.AlignConfig(**kw, attn_impl="flash", remat=False)
    jinit, japply = jalign.build_align_adapter("align_transformer")
    tree = perturbed(jinit(jax.random.PRNGKey(3), jcfg), np.random.default_rng(3))
    rng = np.random.default_rng(4)
    tokens = rng.standard_normal((2, 37, D)).astype(np.float32)
    cot = rng.standard_normal((2, 37, D)).astype(np.float32)

    def loss(p, t):
        return jnp.sum(japply(p, jcfg, t) * jnp.asarray(cot))

    ref_out = japply(tree, jcfg, jnp.asarray(tokens))
    ref_gp, ref_gx = jax.grad(loss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens))

    params = params_from_jax({"align_transformer": tree})["align_transformer"]
    for _, p in _leaves(params):
        p.requires_grad_(True)
    x = torch.from_numpy(tokens).requires_grad_(True)
    _, apply = talign.build_align_adapter("align_transformer")
    assert layer_impl("flash") == "flash"
    out = apply(params, tconf.AlignConfig(**kw, attn_impl="flash"), x, impl=layer_impl("flash"))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=2e-5, atol=2e-5)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_gx), rtol=2e-4, atol=2e-4)
    ref = dict(_leaves(params_to_numpy(params_from_jax(
        {"align_transformer": jax.tree_util.tree_map(np.asarray, ref_gp)})["align_transformer"])))
    got = {path: p.grad.numpy() for path, p in _leaves(params)}
    assert sorted(got) == sorted(ref)
    for path in ref:
        np.testing.assert_allclose(got[path], ref[path], rtol=2e-4, atol=2e-4, err_msg=path)


def _text_inputs(rng, s=4, l=12):
    ids = np.full((s, l), 1, np.int32)
    mask = np.zeros((s, l), np.int32)
    for i in range(s):
        k = int(rng.integers(4, l + 1))
        ids[i, :k] = rng.integers(3, TEXT["vocab_size"], k)
        ids[i, 0], ids[i, k - 1] = 0, 2
        mask[i, :k] = 1
    return ids, mask


@pytest.mark.parametrize("fuse_post", [False, True])
def test_mpnet_flash_matches_jax_values_and_gradients(fuse_post):
    """Two MPNet layers with ``attn_impl="flash"`` (K15 / K16 twins against
    the JAX kernels): hidden states and every parameter gradient, ``rel_bias``
    among them through d(bias) and the bucket gather."""
    jcfg = jconf.TextConfig(**TEXT, attn_impl="flash", fuse_post=fuse_post)
    tree = perturbed(jmpnet.init_mpnet(jax.random.PRNGKey(5), jcfg), np.random.default_rng(5))
    ids, mask = _text_inputs(np.random.default_rng(6))
    cot = np.random.default_rng(7).standard_normal((*ids.shape, D)).astype(np.float32)

    def loss(p):
        return jnp.sum(jmpnet.mpnet_forward(p, jcfg, jnp.asarray(ids), jnp.asarray(mask))
                       * jnp.asarray(cot))

    ref_out = jmpnet.mpnet_forward(tree, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    ref_g = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, tree))
    params = params_from_jax({"text_model": tree})["text_model"]
    for _, p in _leaves(params):
        p.requires_grad_(True)
    out = tmpnet.mpnet_forward(params, tconf.TextConfig(**TEXT, attn_impl="flash",
                                                        fuse_post=fuse_post),
                               torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=2e-5, atol=2e-5)
    (out * torch.from_numpy(cot)).sum().backward()
    ref = dict(_leaves(params_to_numpy(params_from_jax(
        {"text_model": jax.tree_util.tree_map(np.asarray, ref_g)})["text_model"])))
    got = {path: (p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32))
           for path, p in _leaves(params)}
    assert sorted(got) == sorted(ref) and np.abs(got["/rel_bias"]).max() > 0
    for path in ref:
        np.testing.assert_allclose(got[path], ref[path], rtol=5e-4, atol=5e-4, err_msg=path)


def _cfg(m, text_attn):
    return m.RadZeroConfig(
        vision=m.ViTConfig(**VIT),  # attn_impl="flash", the dataclass default
        text=m.TextConfig(**TEXT, attn_impl=text_attn),
        align=m.AlignConfig(hidden_size=D, num_hidden_layers=2, num_attention_heads=4,
                            mlp_ratio=2.0),
        loss=m.LossConfig(hidden_dim=D),
    )


@pytest.mark.parametrize("text_attn", ["xla", "flash"])
def test_compute_logits_unfused_towers_matches_jax(text_attn):
    """The slice as a whole: ``compute_logits(fused_towers=False)`` reads
    ``attn_impl`` as the JAX ``compute_logits`` does without
    ``with_fused_towers`` (flash tower: K13; fused_vjp align layers: K1-K3;
    text: K15 when "flash"; K4, K5), same weights through the bridge. The
    repo's gate: logits rtol 1e-3 / atol 2e-4, map MAE < 1e-3."""
    jcfg, tcfg = _cfg(jconf, text_attn), _cfg(tconf, text_attn)
    assert jcfg.vision.attn_impl == tcfg.vision.attn_impl == "flash"
    tree = perturbed(jax_init_radzero(jax.random.PRNGKey(0), jcfg), np.random.default_rng(0))
    rng = np.random.default_rng(1)
    pv = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    ids, mask = _text_inputs(rng, s=3)
    ref = jax_compute_logits(tree, jcfg, jnp.asarray(pv), jnp.asarray(ids), jnp.asarray(mask))
    out = compute_logits(params_from_jax(tree), tcfg, torch.from_numpy(pv),
                         torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                         fused_towers=False)
    logits, maps = out["logits"].numpy(), out["similarity_scores"].numpy()
    assert logits.shape == (2, 3) and maps.shape == (2, 3, 16)
    np.testing.assert_allclose(logits, np.asarray(ref["logits"]), rtol=1e-3, atol=2e-4)
    assert np.abs(maps - np.asarray(ref["similarity_scores"])).mean() < 1e-3


def test_attn_impl_selects_the_layers(monkeypatch):
    """``fused_towers=False`` sends the tower to the layer its config names
    and the align adapter to its own; True and ``eager`` override both."""
    from radzero_torch.models import radzero as tradzero

    seen = []

    def fake_vit_forward(params, cfg, pv, *, dtype, impl):
        seen.append(("tower", impl))
        return torch.zeros(1, 17, D)

    def fake_align(params, cfg, tokens, *, impl):
        seen.append(("align", impl))
        return tokens

    monkeypatch.setattr(tradzero, "vit_forward", fake_vit_forward)
    monkeypatch.setattr(tradzero, "build_align_adapter", lambda _: (None, fake_align))
    cfg = _cfg(tconf, "xla")
    packed = dataclasses.replace(cfg, align=dataclasses.replace(cfg.align, attn_impl="packed"))
    for kw, c, want in (
        (dict(fused_towers=False), cfg, ["flash", "fused"]),
        (dict(fused_towers=False), packed, ["flash", "packed"]),
        (dict(), packed, ["fused", "fused"]),
        (dict(eager=True, fused_towers=False), packed, ["eager", "eager"]),
        (dict(fused_towers=False, align_impl="flash"), cfg, ["flash", "flash"]),
    ):
        seen.clear()
        tradzero.forward_vision({"vision_model": {}, "align_transformer": {}}, c, None, **kw)
        assert [impl for _, impl in seen] == want, (kw, seen)
