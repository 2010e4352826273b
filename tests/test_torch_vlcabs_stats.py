"""The VL-CABS backward from the forward's statistics, on the CPU.

On the card K10 writes the row max of s and g = e @ tn under autograd, and
K11 / K12 start from them: a row pass (dg, dz ghat from g), then in bf16
K12's first Hopper phase (e and dc into one (B, 2 Np, Lp) buffer, and
K11's dtau in one slot per work item), K11's product over dc with a reduce
over images, and K12's second phase (dtn = [dc; e]^T [qn; dg] as one
product). Here every stage's
plain twin is composed and held against the whole-function twins
(``vlcabs_train_bwd_dq_plain`` / ``vlcabs_train_bwd_dtn_plain``) and the
whole composed backward against ``jax.vjp`` of the JAX package's custom-VJP
kernels, run in interpret mode as tests/test_pallas_vlcabs.py runs them.
Inputs are drawn with numpy from a seed at N 16, B 3, L 37, D 128 (L no
multiple of 64, N no multiple of 64: the buffer's zero padding is exercised).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radzero_tpu.ops.pallas_vlcabs import vlcabs_fused_train as jax_vlcabs_fused_train
from radzero_torch.ops import vlcabs_fused as tvl

N, B, L, D = 16, 3, 37, 128


def _case(seed, dtype=torch.float32, tau=0.07):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((N, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.standard_normal((B, L, D)).astype(np.float32)
    dz = rng.standard_normal((N, B)).astype(np.float32)
    tq, tt = torch.from_numpy(q).to(dtype), torch.from_numpy(t).to(dtype)
    return tq, tt, torch.tensor([tau], dtype=torch.float32), torch.from_numpy(dz)


def _close_share(got, want, share, rtol):
    """|got - want| <= share * max|want| + rtol |want|: in bf16 a factor that
    rounds the other way moves an entry by a share of the largest entry (the
    sums run over queries or tokens), whatever the entry's own size."""
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=rtol,
                               atol=share * want.abs().max().item())


def test_forward_statistics_twin_matches_numpy():
    """K10's statistics: the row max of s = qn tn^T / tau and g = e @ tn,
    held against float64 numpy at fp32's 1e-6 / 1e-5; the forward with
    statistics returns the same logits as without."""
    q, t, tau, _ = _case(0)
    logits, (rowmax, g) = tvl.vlcabs_train_forward(q, t, tau, with_stats=True)
    torch.testing.assert_close(logits, tvl.vlcabs_train_forward(q, t, tau), rtol=0, atol=0)
    q64, t64 = q.double().numpy(), t.double().numpy()
    tn = t64 / np.sqrt((t64 ** 2).sum(-1, keepdims=True) + 1e-24)
    s = np.einsum("nd,bld->bnl", q64, tn) / 0.07
    m = s.max(-1)
    e = np.exp(s - m[..., None])
    assert rowmax.shape == (B, N) and g.shape == (B, N, D)
    assert rowmax.dtype == torch.float32 and g.dtype == torch.float32
    np.testing.assert_allclose(rowmax.numpy(), m, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), e @ tn, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_phase1_buffer_layout(dtype):
    """ce is (B, 2 Np, Lp): dc in rows [0, N), e in rows [Np, Np + N), zeros
    in the rows past N of each half and in the columns past L; e in (0, 1]
    with a 1 in every row (its max, rounded)."""
    q, t, tau, dz = _case(1, dtype)
    rowmax, g = tvl.vlcabs_train_stats_plain(q, t, tau)
    tn = tvl.vlcabs_rownorm(t)
    dg, _ = tvl.vlcabs_bwd_rows(q, g, dz)
    ce = tvl.vlcabs_dtn_phase1(q, tn, dg, rowmax, tau)
    assert ce.shape == (B, 128, 64) and ce.dtype == dtype
    assert not ce[:, N:64].any() and not ce[:, 64 + N:].any() and not ce[:, :, L:].any()
    e = ce[:, 64:64 + N, :L].float()
    assert (e > 0).all() and (e <= 1).all()
    assert torch.equal(e.amax(-1), torch.ones((B, N)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tau", [0.07, 0.008])
def test_stage_twins_compose_to_the_whole_twins(dtype, tau):
    """Row pass, phase 1 and phase 2 from the forward's statistics give K12's
    dtn, and phase 1's dc and dtau slots with K11's product and reduce give
    dq and dtau, as the whole-function twins that recompute everything: the
    same operations on
    the same values, so fp32 within 1e-6 / 1e-5 and bf16 within one bf16 ulp
    of the largest entry plus 2^-8 relative (a sum reassociated by
    einsum may flip a rounding)."""
    q, t, tau_t, dz = _case(2, dtype, tau)
    stats = tvl.vlcabs_train_stats_plain(q, t, tau_t)
    rowmax, g = stats
    tn = tvl.vlcabs_rownorm(t)
    dg, dq_part = tvl.vlcabs_bwd_rows(q, g, dz, want_dq_part=True)
    ce, slots = tvl.vlcabs_dtn_phase1(q, tn, dg, rowmax, tau_t, with_dtau=True)
    assert torch.equal(ce, tvl.vlcabs_dtn_phase1(q, tn, dg, rowmax, tau_t))
    dtn = tvl.vlcabs_dtn_phase2(ce, q, dg, L)
    dq, dtau = tvl.vlcabs_dq_from_ce(ce, tn, dq_part, slots, N)
    want_dtn = tvl.vlcabs_train_bwd_dtn_plain(q, t, tau_t, dz)
    want_dq, want_dtau = tvl.vlcabs_train_bwd_dq_plain(q, t, tau_t, dz)
    assert dtn.dtype == dtype and dq.dtype == dtype and dtau.shape == (1,)
    if dtype == torch.float32:
        for got, want in ((dtn, want_dtn), (dq, want_dq), (dtau, want_dtau)):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        for got, want in ((dtn, want_dtn), (dq, want_dq), (dtau, want_dtau)):
            _close_share(got, want, 2.0**-8, 2.0**-8)
    # the wrappers take the statistics by keyword and, on a CPU tensor, run
    # the whole twins
    torch.testing.assert_close(tvl.vlcabs_train_bwd_dtn(q, t, tau_t, dz, stats=stats), want_dtn,
                               rtol=0, atol=0)
    got_dq, got_dtau = tvl.vlcabs_train_bwd_dq(q, t, tau_t, dz, stats=stats)
    torch.testing.assert_close(got_dq, want_dq, rtol=0, atol=0)
    torch.testing.assert_close(got_dtau, want_dtau, rtol=0, atol=0)


def _jax_grads(q, t, tau, dz):
    """(dq, dt, dtau) of sum(dz * logits) by jax.vjp of the JAX kernels."""
    jdt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32
    jq = jnp.asarray(q.float().numpy()).astype(jdt)
    jt = jnp.asarray(t.float().numpy()).astype(jdt)
    _, vjp = jax.vjp(jax_vlcabs_fused_train, jq, jt, jnp.float32(tau.item()))
    return [np.asarray(x, dtype=np.float32) for x in vjp(jnp.asarray(dz.numpy()))]


@pytest.mark.parametrize("tau", [0.07, 0.008])
def test_backward_through_statistics_matches_jax_vjp(tau):
    """fp32: the card's route twin by twin (statistics from the forward, row
    pass, dq stage, phase 1, phase 2, the row-normalise VJP) against jax.vjp
    at the JAX suite's gradient tolerance, rtol 1e-4 / atol 1e-5."""
    q, t, tau_t, dz = _case(3, tau=tau)
    stats = tvl.vlcabs_train_stats_plain(q, t, tau_t)
    got = tvl.vlcabs_train_backward_stats_plain(q, t, tau_t, dz, stats)
    want = _jax_grads(q, t, tau_t, dz)
    for g, w, name in zip(got, want, ("dq", "dt", "dtau")):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy().reshape(w.shape), w, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_backward_through_statistics_matches_jax_vjp_bf16():
    """bf16 operands: the same composition against jax.vjp of the JAX kernels
    in bf16. Both round tn, e, dg and dc before their products, from fp32
    values computed in another order, so a factor near a rounding boundary
    falls either way and moves a gradient entry by a share of the largest
    one: 2^-7 of the largest |entry| plus 2^-7 relative, chip_smoke.py's
    bf16 tolerance of K11 / K12 (dtau, an fp32 sum of unrounded terms on
    both sides, is held to 2^-7 relative with the same share)."""
    q, t, tau_t, dz = _case(4, torch.bfloat16)
    stats = tvl.vlcabs_train_stats_plain(q, t, tau_t)
    got = tvl.vlcabs_train_backward_stats_plain(q, t, tau_t, dz, stats)
    want = _jax_grads(q, t, tau_t, dz)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.bfloat16
    for g, w in zip(got, want):
        _close_share(g.reshape(w.shape), torch.tensor(w), 2.0**-7, 2.0**-7)


def test_cpu_autograd_keeps_no_statistics():
    """On the CPU the autograd function saves the inputs only and its
    gradients are the whole twins' bits."""
    q, t, tau_t, dz = _case(5)
    leaves = [x.clone().requires_grad_(True) for x in (q, t, tau_t)]
    logits = tvl.vlcabs_fused_train(*leaves)
    assert len(logits.grad_fn.saved_tensors) == 3
    grads = torch.autograd.grad(logits, leaves, dz)
    for a, b in zip(grads, tvl.vlcabs_train_backward_plain(q, t, tau_t, dz)):
        assert torch.equal(a, b)
