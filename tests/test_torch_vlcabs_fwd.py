"""The bf16 forward of K5 / K10 as the card runs it, stage twin by stage twin, on the CPU.

On the card bf16 K5 (``vlcabs_fused``) and K10 (``vlcabs_train_forward``)
are one forward split over tokens: the tokens' row pass, s into a (B, N, Lp)
buffer and each row's maximum per 128-token tile (phase 1), a row pass that
writes e into a (B, Np, Lp) buffer padded with zeros, the row max and, for
K5, the map, g = e tn per image (phase 2), and the logits.
``vlcabs_forward_stages`` composes the stage wrappers, which take their
plain twins on CPU tensors. Here the composition is held
bit for bit against the whole-function twins (``vlcabs_fused_plain``,
``vlcabs_train_forward_plain(with_stats=True)``) in fp32 and bf16 (the same
operations at the same rounding points), and against the JAX package's
kernels in interpret mode at the JAX suite's tolerances
(tests/test_pallas_vlcabs.py: logits rtol 1e-4 / atol 1e-5, maps 1e-4).
Inputs come from numpy with fixed seeds at D 64; N and L are no multiple of
16, 64 or 128, and L = 37 is shorter than one token tile.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radzero_tpu.ops import pallas_vlcabs as jvl
from radzero_torch.ops import vlcabs_fused as tvl

B, D = 3, 64
SHAPES = [(14, 130), (14, 200), (70, 130), (70, 200)]
DTYPES = [torch.float32, torch.bfloat16]


def _case(n, l, dtype=torch.float32, tau=0.07):
    rng = np.random.default_rng(100 * n + l)
    q = rng.standard_normal((n, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.standard_normal((B, l, D)).astype(np.float32)
    return (torch.from_numpy(q).to(dtype), torch.from_numpy(t).to(dtype),
            torch.tensor([tau], dtype=torch.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tau", [0.07, 0.008])
@pytest.mark.parametrize("n,l", SHAPES)
def test_stage_twins_compose_to_the_whole_twins(n, l, tau, dtype):
    """Logits, map, row max and g of the stages equal the whole twins' bits."""
    q, t, tau_t = _case(n, l, dtype, tau)
    logits, s, (rowmax, g) = tvl.vlcabs_forward_stages(q, t, tau_t, maps=True)
    want_logits, want_s = tvl.vlcabs_fused_plain(q, t, tau_t)
    train_logits, (want_m, want_g) = tvl.vlcabs_train_forward_plain(q, t, tau_t, with_stats=True)
    assert logits.shape == (n, B) and s.shape == (B, n, l)
    assert rowmax.shape == (B, n) and g.shape == (B, n, D)
    for got, want in ((logits, want_logits), (s, want_s), (logits, train_logits),
                      (rowmax, want_m), (g, want_g)):
        assert got.dtype == torch.float32
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("l", [37, 130, 200])
def test_row_pass_pads_e_with_zeros(l, dtype):
    """Phase 1's s is (B, N, Lp) with zeros past L and its tile maxima are the
    maxima of the real s over each 128-token tile (one tile at L = 37); the row
    pass's e is (B, Np, Lp) with zeros past N and L, in (0, 1] with a 1 in
    every real row, its row max is s's and its map s without the padding."""
    n = 14
    q, t, tau = _case(n, l, dtype)
    s, tmax = tvl.vlcabs_fwd_scores(q, tvl.vlcabs_rownorm(t), tau)
    lp, tiles = -(-l // 64) * 64, -(-l // 128)
    assert s.shape == (B, n, lp) and tmax.shape == (B, n, tiles)
    assert not s[..., l:].any()
    for k in range(tiles):
        assert torch.equal(tmax[..., k], s[..., 128 * k:min(128 * (k + 1), l)].amax(-1))
    e, rowmax, scores = tvl.vlcabs_fwd_rows(s, tmax, l, dtype, maps=True)
    assert e.shape == (B, 64, lp) and e.dtype == dtype
    assert not e[:, n:].any() and not e[:, :, l:].any()
    real = e[:, :n, :l].float()
    assert (real >= 0).all() and (real <= 1).all()
    assert torch.equal(real.amax(-1), torch.ones((B, n)))
    assert torch.equal(rowmax, s[..., :l].amax(-1))
    assert scores.is_contiguous() and torch.equal(scores, s[..., :l])
    assert tvl.vlcabs_fwd_rows(s, tmax, l, dtype)[2] is None


@pytest.mark.parametrize("tau", [0.07, 0.008])
@pytest.mark.parametrize("n,l", SHAPES)
def test_stages_match_the_jax_kernels(n, l, tau):
    """fp32: the composition against JAX's vlcabs_fused (logits and maps) and
    the forward of vlcabs_fused_train, at the JAX suite's tolerances."""
    q, t, tau_t = _case(n, l, tau=tau)
    logits, s, _ = tvl.vlcabs_forward_stages(q, t, tau_t, maps=True)
    jq, jt, jtau = jnp.asarray(q.numpy()), jnp.asarray(t.numpy()), jnp.float32(tau)
    ref_logits, ref_scores = jvl.vlcabs_fused(jq, jt, jtau)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_scores), rtol=1e-4, atol=1e-4)
    train_logits = jvl.vlcabs_fused_train(jq, jt, jtau)
    np.testing.assert_allclose(logits.numpy(), np.asarray(train_logits), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_entry_points_take_the_whole_twins(dtype):
    """On CPU tensors K5 and K10 run the whole twins, count no launch, and
    agree with the stages bit for bit."""
    q, t, tau = _case(70, 130, dtype)
    before = (tvl.vlcabs_fused.launches, tvl.vlcabs_train_forward.launches)
    logits, s = tvl.vlcabs_fused(q, t, tau.reshape(()))
    train_logits, (rowmax, g) = tvl.vlcabs_train_forward(q, t, tau, with_stats=True)
    assert (tvl.vlcabs_fused.launches, tvl.vlcabs_train_forward.launches) == before
    stage_logits, stage_s, (stage_m, stage_g) = tvl.vlcabs_forward_stages(q, t, tau, maps=True)
    for got, want in ((logits, stage_logits), (s, stage_s), (train_logits, stage_logits),
                      (rowmax, stage_m), (g, stage_g)):
        assert torch.equal(got, want)
