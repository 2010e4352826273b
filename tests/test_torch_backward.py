"""The differentiable fused layers of the port against the JAX package,
fp32 on the CPU.

The same numpy-seeded inputs and cotangent go through ``jax.vjp`` of the JAX
custom-VJP functions (their Pallas backward kernels K6-K9 run in interpret
mode, as the JAX suite runs them on the CPU) and through the port's public
wrappers, which go through their ``torch.autograd.Function``s and, on CPU
tensors, the plain twins. Sizes: D = 128 as 2 heads of 64 (the head width
the card's K2 / K7 take), F = 256, rows 96 and 257, L = 37 and 128.
Tolerances are the JAX suite's (tests/test_fused_layer.py): 2e-5 on the
forward, 2e-4 on gradients, 5e-4 on the gradients of the MPNet chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radzero_tpu.models import align as jalign
from radzero_tpu.models import mpnet as jmpnet
from radzero_tpu.models.configuration import AlignConfig as JAlign
from radzero_tpu.models.configuration import TextConfig as JText
from radzero_tpu.ops import fused_layer as jfl
from radzero_torch.models import align as talign
from radzero_torch.models import mpnet as tmpnet
from radzero_torch.models.configuration import AlignConfig, TextConfig
from radzero_torch.models.from_jax import params_from_jax, params_to_numpy
from radzero_torch.models.vit import layer_impl
from radzero_torch.ops import fused_layer as tfl

from test_torch_modules import TEXT, _text_inputs, perturbed

D, F, HEADS = 128, 256, 2


def _rand(rng, *shape, std=1.0, mean=0.0):
    return (rng.standard_normal(shape) * std + mean).astype(np.float32)


def _k1_arrays(rng, n):
    return (_rand(rng, n, D), _rand(rng, D, std=0.1, mean=1.0), _rand(rng, D, std=0.1),
            _rand(rng, D, 3 * D, std=0.1), _rand(rng, 3 * D, std=0.1))


def _k3_arrays(rng, n):
    return (_rand(rng, n, D), _rand(rng, n, D), _rand(rng, D, D, std=0.1),
            _rand(rng, D, std=0.1), _rand(rng, D, std=0.1, mean=0.7),
            _rand(rng, D, std=0.1, mean=1.0), _rand(rng, D, std=0.1),
            _rand(rng, D, F, std=0.1), _rand(rng, F, std=0.1), _rand(rng, F, D, std=0.1),
            _rand(rng, D, std=0.1), _rand(rng, D, std=0.1, mean=1.3))


def _k4_arrays(rng, n):
    return (_rand(rng, n, D), _rand(rng, n, D), _rand(rng, D, D, std=0.1),
            _rand(rng, D, std=0.1), _rand(rng, D, std=0.1, mean=1.0), _rand(rng, D, std=0.1),
            _rand(rng, D, F, std=0.1), _rand(rng, F, std=0.1), _rand(rng, F, D, std=0.1),
            _rand(rng, D, std=0.1), _rand(rng, D, std=0.1, mean=1.3), _rand(rng, D, std=0.1))


def _torch_vjp(fn, arrays, cot):
    """-> (output, gradients) of ``fn`` at leaves made from ``arrays``."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*leaves)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _assert_vjp_matches(out, grads, ref_out, ref_grads, names, gtol):
    np.testing.assert_allclose(out, np.asarray(ref_out), rtol=2e-5, atol=2e-5)
    assert len(grads) == len(ref_grads) == len(names)
    for g, r, name in zip(grads, ref_grads, names):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, np.asarray(r), rtol=gtol, atol=gtol, err_msg=name)


_K6_NAMES = ("dx", "dln_scale", "dln_bias", "dw_qkv", "db_qkv")
_K8_NAMES = ("dx", "da", "dwo", "dbo", "dls1", "dln_scale", "dln_bias", "dw1", "db1", "dw2",
             "db2", "dls2")
_K9_NAMES = ("dx", "da", "dwo", "dbo", "dlnsa", "dlnba", "dw1", "db1", "dw2", "db2", "dlnso",
             "dlnbo")


@pytest.mark.parametrize("n", [96, 257])
def test_fused_preattn_function_matches_jax_vjp(n):
    """K1 forward and K6 backward against jax.vjp of fused_preattn_vjp."""
    rng = np.random.default_rng(n)
    arrays, cot = _k1_arrays(rng, n), _rand(rng, n, 3 * D)
    ref_out, vjp = jax.vjp(lambda *a: jfl.fused_preattn_vjp(*a, 1e-6), *map(jnp.asarray, arrays))
    launches = tfl.fused_preattn_bwd.launches
    out, grads = _torch_vjp(lambda *a: tfl.fused_preattn(*a, eps=1e-6), arrays, cot)
    assert tfl.fused_preattn_bwd.launches == launches  # CPU tensors: plain twins
    _assert_vjp_matches(out, grads, ref_out, vjp(jnp.asarray(cot)), _K6_NAMES, 2e-4)


@pytest.mark.parametrize("l", [37, 128])
def test_flash_attention_packed_function_matches_jax_vjp(l):
    """K2 forward and K7 backward against jax.vjp of
    flash_attention_packed_vjp. The JAX kernel runs the sequence lane-padded
    to 128 with ``kv_len`` masking the tail and a zero cotangent on the padded
    rows; the port runs the real length."""
    rng = np.random.default_rng(l)
    qkv, cot = _rand(rng, 2, l, 3 * D), _rand(rng, 2, l, D)
    l_pad = (l + 127) // 128 * 128
    pad = ((0, 0), (0, l_pad - l), (0, 0))
    kv_len = l if l_pad != l else None
    ref_out, vjp = jax.vjp(lambda t: jfl.flash_attention_packed_vjp(t, HEADS, kv_len),
                           jnp.pad(jnp.asarray(qkv), pad))
    (ref_grad,) = vjp(jnp.pad(jnp.asarray(cot), pad))
    out, grads = _torch_vjp(lambda t: tfl.flash_attention_packed(t, HEADS), (qkv,), cot)
    np.testing.assert_allclose(out, np.asarray(ref_out)[:, :l], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(grads[0], np.asarray(ref_grad)[:, :l], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n", [96, 257])
def test_fused_postattn_function_matches_jax_vjp(n):
    """K3 forward and K8 backward against jax.vjp of fused_postattn_vjp (its
    rational erf is <= 1.5e-7 from the exact erf used here)."""
    rng = np.random.default_rng(100 + n)
    arrays, cot = _k3_arrays(rng, n), _rand(rng, n, D)
    ref_out, vjp = jax.vjp(lambda *a: jfl.fused_postattn_vjp(*a, 1e-6), *map(jnp.asarray, arrays))
    out, grads = _torch_vjp(lambda *a: tfl.fused_postattn(*a, eps=1e-6), arrays, cot)
    _assert_vjp_matches(out, grads, ref_out, vjp(jnp.asarray(cot)), _K8_NAMES, 2e-4)


@pytest.mark.parametrize("n", [96, 257])
def test_fused_mpnet_post_function_matches_jax_vjp(n):
    """K4 forward and K9 backward against jax.vjp of fused_mpnet_post_vjp."""
    rng = np.random.default_rng(200 + n)
    arrays, cot = _k4_arrays(rng, n), _rand(rng, n, D)
    ref_out, vjp = jax.vjp(lambda *a: jfl.fused_mpnet_post_vjp(*a, 1e-12),
                           *map(jnp.asarray, arrays))
    out, grads = _torch_vjp(lambda *a: tfl.fused_mpnet_post(*a, eps=1e-12), arrays, cot)
    _assert_vjp_matches(out, grads, ref_out, vjp(jnp.asarray(cot)), _K9_NAMES, 5e-4)


# ---------------------------------------------------------------------------
# the written-out backward twins against autograd of the forward twins
# ---------------------------------------------------------------------------

_TWINS = {
    "K6": (tfl.fused_preattn_plain, tfl.fused_preattn_bwd_plain, _k1_arrays, 3 * D),
    "K8": (tfl.fused_postattn_plain, tfl.fused_postattn_bwd_plain, _k3_arrays, D),
    "K9": (tfl.fused_mpnet_post_plain, tfl.fused_mpnet_post_bwd_plain, _k4_arrays, D),
}


@pytest.mark.parametrize("kernel", sorted(_TWINS))
def test_backward_twin_matches_autograd_of_forward_twin(kernel):
    fwd, bwd, make, width = _TWINS[kernel]
    rng = np.random.default_rng(7)
    arrays, cot = make(rng, 75), _rand(rng, 75, width)
    _, ref = _torch_vjp(fwd, arrays, cot)
    got = bwd(*map(torch.from_numpy, arrays), torch.from_numpy(cot))
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-5 * max(1.0, np.abs(r).max()),
                                   err_msg=f"{kernel} output {i}")


def test_attention_backward_twin_matches_autograd_of_forward_twin():
    rng = np.random.default_rng(8)
    qkv, cot = _rand(rng, 2, 50, 3 * D), _rand(rng, 2, 50, D)
    _, (ref,) = _torch_vjp(lambda t: tfl.flash_attention_packed_plain(t, HEADS), (qkv,), cot)
    got = tfl.flash_attention_packed_bwd_plain(torch.from_numpy(qkv), HEADS, torch.from_numpy(cot))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_functions_keep_only_their_inputs_and_skip_frozen_operands():
    """The tape holds the operands, nothing of width F or (L, L); an operand
    that requires no gradient gets none; without a tape no Function runs."""
    rng = np.random.default_rng(9)
    x, *params = map(torch.from_numpy, _k3_arrays(rng, 40))
    params = [p.requires_grad_(True) for p in params[1:]]
    a = torch.from_numpy(_rand(rng, 40, D))
    out = tfl.fused_postattn(x, a, *params)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 12 and max(t.numel() for t in saved) == D * F
    out.sum().backward()
    assert x.grad is None and a.grad is None and all(p.grad is not None for p in params)
    with torch.no_grad():
        assert tfl.fused_postattn(x, a, *params).grad_fn is None
    qkv = torch.from_numpy(_rand(rng, 1, 20, 3 * D)).requires_grad_(True)
    attn = tfl.flash_attention_packed(qkv, HEADS)
    assert [tuple(t.shape) for t in attn.grad_fn.saved_tensors] == [(1, 20, 3 * D)]


def test_gradients_come_back_in_the_operand_type():
    """bf16 operands: bf16 gradients after fp32 accumulation, through the
    cast into fp32 masters as the train step does."""
    rng = np.random.default_rng(10)
    masters = [torch.from_numpy(a).requires_grad_(True) for a in _k4_arrays(rng, 33)]
    out = tfl.fused_mpnet_post(*[m.to(torch.bfloat16) for m in masters])
    assert out.dtype == torch.bfloat16
    out.float().square().sum().backward()
    assert all(m.grad is not None and m.grad.dtype == torch.float32 for m in masters)
    cot = torch.ones(33, D, dtype=torch.bfloat16)
    grads = tfl.fused_mpnet_post_bwd_plain(*[m.detach().to(torch.bfloat16) for m in masters], cot)
    assert all(g.dtype == torch.bfloat16 for g in grads)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("attn_impl", ["fused_vjp", "packed"])
def test_dinov2_layer_matches_jax_values_and_gradients(attn_impl):
    """One align layer with the JAX ``attn_impl`` on both sides: output,
    every parameter gradient and the input gradient. 37 tokens: the JAX side
    pads the sequence to 128 lanes itself."""
    kw = dict(hidden_size=D, num_hidden_layers=1, num_attention_heads=HEADS, mlp_ratio=2.0)
    jcfg = JAlign(**kw, attn_impl=attn_impl, remat=False)
    jinit, japply = jalign.build_align_adapter("align_transformer")
    tree = perturbed(jinit(jax.random.PRNGKey(3), jcfg), np.random.default_rng(3))
    rng = np.random.default_rng(4)
    tokens, cot = _rand(rng, 2, 37, D), _rand(rng, 2, 37, D)

    def loss(p, t):
        return jnp.sum(japply(p, jcfg, t) * jnp.asarray(cot))

    ref_out = japply(tree, jcfg, jnp.asarray(tokens))
    ref_gp, ref_gx = jax.grad(loss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens))

    params = params_from_jax({"align_transformer": tree})["align_transformer"]
    leaves = [p.requires_grad_(True) for _, p in _leaves(params)]
    x = torch.from_numpy(tokens).requires_grad_(True)
    _, apply = talign.build_align_adapter("align_transformer")
    out = apply(params, AlignConfig(**kw, attn_impl=attn_impl), x, impl=layer_impl(attn_impl))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=2e-5, atol=2e-5)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_gx), rtol=2e-4, atol=2e-4)
    ref = dict(_leaves(params_to_numpy(params_from_jax(
        {"align_transformer": jax.tree_util.tree_map(np.asarray, ref_gp)})["align_transformer"])))
    got = {path: p.grad.numpy() for path, p in _leaves(params)}
    assert sorted(got) == sorted(ref) and len(leaves) == len(ref)
    for path in ref:
        np.testing.assert_allclose(got[path], ref[path], rtol=2e-4, atol=2e-4, err_msg=path)


def test_mpnet_fuse_post_matches_jax_values_and_gradients():
    """Two MPNet layers with fuse_post=True (K4 / K9 twins against the JAX
    kernels): hidden states and every parameter gradient, 5e-4."""
    jcfg = JText(**TEXT, fuse_post=True)
    tree = perturbed(jmpnet.init_mpnet(jax.random.PRNGKey(5), jcfg), np.random.default_rng(5))
    ids, mask = _text_inputs(np.random.default_rng(6))
    cot = _rand(np.random.default_rng(7), *ids.shape, TEXT["hidden_size"])

    def loss(p):
        return jnp.sum(jmpnet.mpnet_forward(p, jcfg, jnp.asarray(ids), jnp.asarray(mask))
                       * jnp.asarray(cot))

    ref_g = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, tree))
    params = params_from_jax({"text_model": tree})["text_model"]
    for _, p in _leaves(params):
        p.requires_grad_(True)
    out = tmpnet.mpnet_forward(params, TextConfig(**TEXT, fuse_post=True),
                               torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    (out * torch.from_numpy(cot)).sum().backward()
    ref = dict(_leaves(params_to_numpy(params_from_jax(
        {"text_model": jax.tree_util.tree_map(np.asarray, ref_g)})["text_model"])))
    got = {path: (p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32))
           for path, p in _leaves(params)}
    assert sorted(got) == sorted(ref)
    for path in ref:
        np.testing.assert_allclose(got[path], ref[path], rtol=5e-4, atol=5e-4, err_msg=path)


def test_layer_impl_names():
    assert [layer_impl(n) for n in ("fused_vjp", "fused", "flash", "packed", "xla")] == [
        "fused", "fused", "flash", "packed", "eager"]
    with pytest.raises(ValueError, match="attn_impl"):
        layer_impl("flsh")
