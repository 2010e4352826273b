"""The VL-CABS backward through its shared stages, on the CPU.

In bf16 on the card K11 and K12 share their first stages: the tokens' row
pass, the backward's row pass and K12's first Hopper phase, which writes e
and dc into one (B, 2 Np, Lp) buffer and, from its epilogue, K11's dtau in
one slot per (image, 64-query, 128-token) work item. K11 is then one
product per image over the dc rows with a reduce over images
(``vlcabs_dq_from_ce``), and ``vlcabs_train_bwd`` runs the stages once for
both. Here the stage twins are held against float64 numpy and the
whole-function twins, the shared backward against ``jax.vjp`` of the JAX
package's custom-VJP kernels (interpret mode, as tests/test_pallas_vlcabs.py
runs them), and the autograd function's backward is shown to run each
shared stage once, by counting calls of monkeypatched twins. Inputs are
drawn with numpy from a seed; N 70 and L 150 leave a ragged second query
block and token tile, N 16 and L 37 match the JAX suite's small case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radzero_tpu.ops.pallas_vlcabs import vlcabs_fused_train as jax_vlcabs_fused_train
from radzero_torch.ops import vlcabs_fused as tvl

D = 128


def _case(seed, n, b, l, dtype=torch.float32, tau=0.07):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.standard_normal((b, l, D)).astype(np.float32)
    dz = rng.standard_normal((n, b)).astype(np.float32)
    tq, tt = torch.from_numpy(q).to(dtype), torch.from_numpy(t).to(dtype)
    return tq, tt, torch.tensor([tau], dtype=torch.float32), torch.from_numpy(dz)


def _stages(q, t, tau, dz):
    """The operands of phase 1 and of K11's product: (tn, dg, dz ghat, row max)."""
    rowmax, g = tvl.vlcabs_train_stats_plain(q, t, tau)
    tn = tvl.vlcabs_rownorm(t)
    dg, dq_part = tvl.vlcabs_bwd_rows(q, g, dz, want_dq_part=True)
    return tn, dg, dq_part, rowmax


def _close_share(got, want, share, rtol):
    """|got - want| <= share * max|want| + rtol |want| (bf16: a factor that
    rounds the other way moves an entry by a share of the largest entry)."""
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=rtol,
                               atol=share * want.abs().max().item())


@pytest.mark.parametrize("tau", [0.07, 0.008])
def test_phase1_dtau_slots_match_numpy(tau):
    """One slot per work item, images slowest, then 64-query blocks, then
    128-token tiles: the item's sum of dc (s - rowmax) with dc unrounded,
    against float64 numpy on the same tn, dg and row max (fp32 sums of up to
    64 x 128 terms: 1e-4 of the largest slot); rows past N and tokens past L
    add nothing; minus their sum is K11's dtau."""
    n, b, l = 70, 2, 150
    q, t, tau_t, dz = _case(10, n, b, l, tau=tau)
    tn, dg, _, rowmax = _stages(q, t, tau_t, dz)
    ce, slots = tvl.vlcabs_dtn_phase1(q, tn, dg, rowmax, tau_t, with_dtau=True)
    assert slots.shape == (b * 2 * 2,) and slots.dtype == torch.float32
    q64, tn64, dg64 = q.double().numpy(), tn.double().numpy(), dg.double().numpy()
    s = np.einsum("nd,bld->bnl", q64, tn64) / np.float64(np.float32(tau))
    sh = s - rowmax.double().numpy()[..., None]
    dc = np.einsum("bnd,bld->bnl", dg64, tn64) * np.exp(sh) / np.float64(np.float32(tau))
    want = np.zeros((b, 2, 2))
    for qb in range(2):
        for lt in range(2):
            want[:, qb, lt] = (dc * sh)[:, 64 * qb:64 * qb + 64, 128 * lt:128 * lt + 128].sum((1, 2))
    np.testing.assert_allclose(slots.numpy().reshape(b, 2, 2), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    want_dtau = tvl.vlcabs_train_bwd_dq_plain(q, t, tau_t, dz)[1]
    _, dtau = tvl.vlcabs_dq_from_ce(ce, tn, torch.zeros((b, n, D)), slots, n)
    torch.testing.assert_close(dtau, want_dtau, rtol=1e-5, atol=1e-6)


def test_dq_product_reads_only_the_dc_rows():
    """K11's product reads the first N of each image's 2 Np rows of ce (the
    dc rows): what the e rows hold does not reach dq; dq is the images'
    sum of dz ghat + dc tn, the e rows' own product is not in it."""
    n, b, l = 70, 3, 150
    q, t, tau, dz = _case(11, n, b, l)
    tn, dg, dq_part, rowmax = _stages(q, t, tau, dz)
    ce, slots = tvl.vlcabs_dtn_phase1(q, tn, dg, rowmax, tau, with_dtau=True)
    dq, dtau = tvl.vlcabs_dq_from_ce(ce, tn, dq_part, slots, n)
    other = ce.clone()
    other[:, 128:] = 7.0
    dq2, dtau2 = tvl.vlcabs_dq_from_ce(other, tn, dq_part, slots, n)
    assert torch.equal(dq, dq2) and torch.equal(dtau, dtau2)
    want = (dq_part + ce[:, :n, :l] @ tn).sum(0)
    torch.testing.assert_close(dq, want, rtol=1e-5, atol=1e-6)


def test_dtau_fold_adds_the_slots_in_lanes():
    """The reduce folds the slots in 32 lanes and then a butterfly; on
    integer slots every order gives the same exact sum, and on random ones
    the fold stays within fp32 rounding of a float64 sum."""
    ints = torch.arange(1.0, 5633.0)
    assert tvl._fold_slots(ints).item() == -float(ints.double().sum())
    rnd = torch.from_numpy(np.random.default_rng(12).standard_normal(5632).astype(np.float32))
    np.testing.assert_allclose(tvl._fold_slots(rnd).item(), -rnd.double().sum().item(),
                               rtol=1e-5, atol=1e-4)


def _jax_grads(q, t, tau, dz):
    """(dq, dt, dtau) of sum(dz * logits) by jax.vjp of the JAX kernels."""
    jdt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32
    jq = jnp.asarray(q.float().numpy()).astype(jdt)
    jt = jnp.asarray(t.float().numpy()).astype(jdt)
    _, vjp = jax.vjp(jax_vlcabs_fused_train, jq, jt, jnp.float32(tau.item()))
    return [np.asarray(x, dtype=np.float32) for x in vjp(jnp.asarray(dz.numpy()))]


@pytest.mark.parametrize("dtype,tau", [(torch.float32, 0.07), (torch.float32, 0.008),
                                       (torch.bfloat16, 0.07)])
def test_shared_backward_matches_jax_vjp(dtype, tau):
    """vlcabs_train_bwd from the forward's statistics (the shared stages
    once: row passes, phase 1 with the dtau slots, K11's product and reduce,
    phase 2), then the row-normalise VJP, against jax.vjp: fp32 at the JAX
    suite's gradient tolerance, rtol 1e-4 / atol 1e-5; bf16 at chip_smoke.py's
    K11 / K12 tolerance, 2^-7 of the largest |entry| plus 2^-7 relative (both
    sides round tn, e, dg and dc from fp32 values summed in another order)."""
    q, t, tau_t, dz = _case(13, 16, 3, 37, dtype, tau)
    stats = tvl.vlcabs_train_stats_plain(q, t, tau_t)
    dq, dtn, dtau = tvl.vlcabs_train_bwd(q, t, tau_t, dz, stats=stats)
    assert dq.dtype == dtype and dtn.dtype == dtype and dtau.shape == (1,)
    got = (dq, tvl._rownorm_vjp(dtn, t), dtau)
    want = _jax_grads(q, t, tau_t, dz)
    for g, w, name in zip(got, want, ("dq", "dt", "dtau")):
        assert torch.isfinite(g.float()).all(), name
        if dtype == torch.float32:
            np.testing.assert_allclose(g.numpy().reshape(w.shape), w, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        else:
            _close_share(g.reshape(w.shape), torch.tensor(w), 2.0**-7, 2.0**-7)


class _Counted:
    """A stage wrapper that counts its calls and runs the stage's twin."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


def _count_stages(monkeypatch):
    """The card's stage wrappers, each replaced by its counted CPU twin."""
    twins = {
        "vlcabs_rownorm": lambda t: tvl._normalized_tokens(t)[0].to(t.dtype),
        "vlcabs_bwd_rows": lambda q, g, dz, want_dq_part=False: tvl.vlcabs_bwd_rows_plain(q, g, dz),
        "vlcabs_dtn_phase1": lambda *a, with_dtau=False: tvl.vlcabs_dtn_phase1_plain(*a, with_dtau),
        "vlcabs_dq_from_ce": tvl.vlcabs_dq_from_ce_plain,
        "vlcabs_dtn_phase2": tvl.vlcabs_dtn_phase2_plain,
    }
    counted = {name: _Counted(fn) for name, fn in twins.items()}
    for name, stage in counted.items():
        monkeypatch.setattr(tvl, name, stage)
    return counted


def test_autograd_backward_runs_each_shared_stage_once(monkeypatch):
    """The autograd function's backward on the card's bf16 route (the device
    switch set to the card, every stage its counted twin, K10's forward its
    twin with the statistics): the tokens' row pass, the backward's row pass,
    phase 1, K11's product and phase 2 each run once, one launch each of K11
    and K12 is counted, and the gradients are the stage-twin route's bits."""
    q, t, tau, dz = _case(14, 16, 3, 37, torch.bfloat16)
    counted = _count_stages(monkeypatch)
    monkeypatch.setattr(tvl, "on_cuda", lambda x: True)
    monkeypatch.setattr(tvl, "vlcabs_train_forward", tvl.vlcabs_train_forward_plain)
    before = (tvl.vlcabs_train_bwd_dq.launches, tvl.vlcabs_train_bwd_dtn.launches)
    leaves = [x.clone().requires_grad_(True) for x in (q, t, tau)]
    logits = tvl.vlcabs_fused_train(*leaves)
    assert len(logits.grad_fn.saved_tensors) == 5  # the inputs and the statistics
    grads = torch.autograd.grad(logits, leaves, dz)
    assert {name: c.calls for name, c in counted.items()} == dict.fromkeys(counted, 1)
    assert (tvl.vlcabs_train_bwd_dq.launches, tvl.vlcabs_train_bwd_dtn.launches) == (
        before[0] + 1, before[1] + 1)
    want = tvl.vlcabs_train_backward_stats_plain(q, t, tau, dz,
                                                 tvl.vlcabs_train_stats_plain(q, t, tau))
    for a, b in zip(grads, want):
        assert torch.equal(a, b.reshape(a.shape))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shared_backward_on_cpu_runs_each_stage_once(monkeypatch, dtype):
    """On CPU tensors with the statistics vlcabs_train_bwd runs the stage
    twins, each once, and counts no launch (nothing ran on a card); its
    results are vlcabs_train_backward_stats_plain's bits, and K11 / K12
    alone (the whole twins on the CPU) agree with them: fp32 within 1e-6 /
    1e-5, bf16 within 2^-8 of the largest entry plus 2^-8 relative."""
    q, t, tau, dz = _case(15, 70, 2, 150, dtype)
    stats = tvl.vlcabs_train_stats_plain(q, t, tau)
    counted = _count_stages(monkeypatch)
    before = (tvl.vlcabs_train_bwd_dq.launches, tvl.vlcabs_train_bwd_dtn.launches)
    dq, dtn, dtau = tvl.vlcabs_train_bwd(q, t, tau, dz, stats=stats)
    assert {name: c.calls for name, c in counted.items()} == dict.fromkeys(counted, 1)
    assert (tvl.vlcabs_train_bwd_dq.launches, tvl.vlcabs_train_bwd_dtn.launches) == before
    want = tvl.vlcabs_train_backward_stats_plain(q, t, tau, dz, stats)
    assert torch.equal(dq, want[0]) and torch.equal(dtau, want[2])
    assert torch.equal(tvl._rownorm_vjp(dtn, t), want[1])
    whole = (*tvl.vlcabs_train_bwd_dq_plain(q, t, tau, dz),
             tvl.vlcabs_train_bwd_dtn_plain(q, t, tau, dz))
    for got, ref in ((dq, whole[0]), (dtau, whole[1]), (dtn, whole[2])):
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
        else:
            _close_share(got, ref, 2.0**-8, 2.0**-8)
