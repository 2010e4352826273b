"""The row statistic of the Hopper attention forward and the arithmetic of
the Hopper backward (K7 / K14 in bf16 on the card), in their plain forms on
the CPU.

- ``flash_attention_lse_plain``, the twin of the ``lse`` (B, H, L) that the
  bf16 forward writes (m + log2 l per query row, in the log2 domain of the
  scores), against a numpy log2-sum-exp of the same scores in float64, with
  ``kv_len`` and lengths that are no multiple of 64.
- ``flash_attention_bwd_stats_plain`` and
  ``flash_attention_packed_bwd_stats_plain`` (P = exp2(s - lse), delta =
  rowsum(dO O) over the forward's output) against ``jax.vjp`` of
  ``radzero_tpu.ops.flash_attention.flash_attention`` and of
  ``radzero_tpu.ops.fused_layer.flash_attention_packed_vjp``, whose Pallas
  backward kernels run in interpret mode. fp32: rtol 1e-4 / atol 1e-5. bf16:
  both sides round P, dO and dS at the same points, but P and delta come
  from other sums, so a factor near a rounding boundary may fall either way;
  as for the kernels on the card (``chip_smoke.py``'s K7 / K14 ``TOL``):
  2^-7 of the largest |reference| entry plus 2^-7 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radzero_tpu.ops import fused_layer as jfl
from radzero_tpu.ops.flash_attention import flash_attention as jax_flash
from radzero_torch.ops import flash_attention as tfa
from radzero_torch.ops import fused_layer as tfl

LOG2E = 1.4426950408889634


def _heads(rng, b, l, h=3, hd=64, n=3):
    return [rng.standard_normal((b, l, h, hd)).astype(np.float32) for _ in range(n)]


def _lse_numpy(q, k, scale, kv_len):
    """(B, H, L) float64 log2-sum-exp of the scores q k^T scale log2(e)."""
    s = np.einsum("blhd,bkhd->bhlk", q.astype(np.float64), k.astype(np.float64))
    s = s * scale * LOG2E
    s[..., kv_len:] = -np.inf
    m = s.max(axis=-1, keepdims=True)
    return (m + np.log2(np.exp2(s - m).sum(axis=-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("l,kv_len", [(37, None), (100, 77), (129, 90), (200, None),
                                      (257, 130)])
def test_lse_twin_matches_numpy_log2_sum_exp(l, kv_len):
    rng = np.random.default_rng(300 + l)
    q, k, v = _heads(rng, 2, l)
    out, lse = tfa.flash_attention_lse(*map(torch.from_numpy, (q, k, v)), scale=0.2,
                                       kv_len=kv_len)
    assert lse.shape == (2, 3, l) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), _lse_numpy(q, k, 0.2, kv_len or l), rtol=1e-5,
                               atol=1e-5)
    ref = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), scale=0.2, kv_len=kv_len)
    assert torch.equal(out, ref)


def test_packed_lse_twin_is_the_lse_of_its_thirds():
    rng = np.random.default_rng(11)
    qkv = rng.standard_normal((2, 70, 3 * 128)).astype(np.float32)
    out, lse = tfl.flash_attention_packed_lse(torch.from_numpy(qkv), 2)
    q, k = (qkv[..., i * 128:(i + 1) * 128].reshape(2, 70, 2, 64) for i in range(2))
    np.testing.assert_allclose(lse.numpy(), _lse_numpy(q, k, 0.125, 70), rtol=1e-5, atol=1e-5)
    assert torch.equal(out, tfl.flash_attention_packed(torch.from_numpy(qkv), 2))


def _stats_vs_jax(q, k, v, g, scale, kv_len, dtype):
    """(port's stats-form gradients, JAX's) as float32 numpy, in ``dtype``."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, scale, True, kv_len),
                     *(jnp.asarray(a, jdt) for a in (q, k, v)))
    ref = vjp(jnp.asarray(g, jdt))
    tq, tk, tv, tg = (torch.from_numpy(a).to(dtype) for a in (q, k, v, g))
    out, lse = tfa.flash_attention_lse(tq, tk, tv, scale=scale, kv_len=kv_len)
    got = tfa.flash_attention_bwd_stats_plain(tq, tk, tv, tg, out, lse, scale, kv_len)
    assert all(t.dtype == dtype for t in got)
    return ([t.float().numpy() for t in got],
            [np.asarray(jnp.asarray(r, jnp.float32)) for r in ref])


@pytest.mark.parametrize("l,kv_len", [(37, None), (128, 100), (129, 90), (200, None)])
def test_stats_backward_matches_jax_vjp(l, kv_len):
    """P from the forward's lse and delta from its output give the JAX
    kernel's dq, dk, dv (delta = rowsum(dP P) there) in fp32; keys past
    kv_len get no gradient."""
    rng = np.random.default_rng(400 + l)
    q, k, v, g = _heads(rng, 2, l, n=4)
    got, ref = _stats_vs_jax(q, k, v, g, 0.2, kv_len, torch.float32)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)
    if kv_len is not None:
        assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


@pytest.mark.parametrize("l", [65, 129])
def test_stats_backward_bf16_matches_jax_vjp(l):
    rng = np.random.default_rng(500 + l)
    q, k, v, g = _heads(rng, 2, l, n=4)
    got, ref = _stats_vs_jax(q, k, v, g, 0.125, None, torch.bfloat16)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        atol = 2.0**-7 * np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=2.0**-7, atol=atol, err_msg=name)


@pytest.mark.parametrize("l,dtype", [(37, torch.float32), (128, torch.float32),
                                     (70, torch.bfloat16)])
def test_packed_stats_backward_matches_jax_vjp(l, dtype):
    """K7's stats form over the packed layout against jax.vjp of
    flash_attention_packed_vjp; the JAX kernel runs the sequence lane-padded
    to 128 with kv_len masking the tail and a zero cotangent on the padded
    rows."""
    rng = np.random.default_rng(600 + l)
    qkv = rng.standard_normal((2, l, 3 * 128)).astype(np.float32)
    cot = rng.standard_normal((2, l, 128)).astype(np.float32)
    l_pad = (l + 127) // 128 * 128
    pad = ((0, 0), (0, l_pad - l), (0, 0))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    _, vjp = jax.vjp(lambda t: jfl.flash_attention_packed_vjp(t, 2, l if l_pad != l else None),
                     jnp.pad(jnp.asarray(qkv, jdt), pad))
    (ref,) = vjp(jnp.pad(jnp.asarray(cot, jdt), pad))
    ref = np.asarray(jnp.asarray(ref, jnp.float32))[:, :l]
    tqkv, tcot = torch.from_numpy(qkv).to(dtype), torch.from_numpy(cot).to(dtype)
    out, lse = tfl.flash_attention_packed_lse(tqkv, 2)
    got = tfl.flash_attention_packed_bwd_stats_plain(tqkv, 2, tcot, out, lse)
    assert got.dtype == dtype and got.shape == tqkv.shape
    got = got.float().numpy()
    for i, name in enumerate(("dq", "dk", "dv")):
        a, b = got[..., i * 128:(i + 1) * 128], ref[..., i * 128:(i + 1) * 128]
        if dtype == torch.float32:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=2.0**-7, atol=2.0**-7 * np.abs(b).max(),
                                       err_msg=name)


def test_backward_entry_points_ignore_the_statistics_off_the_card():
    """On the CPU (as in fp32 on the card) the public backward entry points
    accept the forward's out and lse and run the contract's twin."""
    rng = np.random.default_rng(12)
    q, k, v, g = (torch.from_numpy(a) for a in _heads(rng, 1, 40, n=4))
    out, lse = tfa.flash_attention_lse(q, k, v)
    with_stats = tfa.flash_attention_bwd(q, k, v, g, out=out, lse=lse)
    for a, b in zip(with_stats, tfa.flash_attention_bwd(q, k, v, g)):
        assert torch.equal(a, b)
    qkv = torch.from_numpy(rng.standard_normal((1, 40, 384)).astype(np.float32))
    dout = torch.from_numpy(rng.standard_normal((1, 40, 128)).astype(np.float32))
    out, lse = tfl.flash_attention_packed_lse(qkv, 2)
    assert torch.equal(tfl.flash_attention_packed_bwd(qkv, 2, dout, out=out, lse=lse),
                       tfl.flash_attention_packed_bwd(qkv, 2, dout))


def test_lse_is_forward_only():
    q = torch.zeros((1, 8, 2, 64), requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        tfa.flash_attention_lse(q, q, q)
    with pytest.raises(RuntimeError, match="forward-only"):
        tfl.flash_attention_packed_lse(torch.zeros((1, 8, 384), requires_grad=True), 2)
