"""K1 and K3 in bf16: the plain twins against the JAX kernels on the CPU.

On the card K1 and K3 run their bf16 products on gemm_sm90_kernel
(radzero_torch/ops/csrc/gemm_sm90.cu) after a row pass that writes each
row's LayerNorm once as a bf16 operand; their plain twins
(``fused_preattn_plain`` / ``fused_postattn_plain``) are what chip_smoke.py
holds them to. Here the twins meet the JAX kernels (``fused_preattn`` /
``fused_postattn`` of radzero_tpu/ops/fused_layer.py, in interpret mode) on
the same bf16 inputs, made from numpy with fixed seeds, at chip_smoke.py's
bf16 tolerance for K1 and K3: atol a share of the largest |reference| entry
(2^-9 for K1, 2^-10 for K3) and rtol 2^-7. Both sides round the LN output
and the GELU output to bf16 before the next product, but their fp32 sums run
in another order, so a value near a bf16 rounding boundary may fall either
way; the JAX kernel's rational erf is <= 1.5e-7 from the exact erf of the
twin. The LN operand itself (fp32 statistics, the normalised row rounded to
bf16) is held to the JAX ``_ln`` within one bf16 ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radzero_tpu.ops import fused_layer as jfl
from radzero_torch.ops import fused_layer as tfl

K1_SHARE, K3_SHARE, RTOL = 2.0**-9, 2.0**-10, 2.0**-7


def _bf16(rng, *shape, std=1.0, mean=0.0):
    """A seeded normal array, rounded to bf16 -> (jax array, torch tensor)."""
    a = (rng.standard_normal(shape) * std + mean).astype(np.float32)
    t = torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _close(out, ref, share):
    out = out.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=share * np.abs(ref).max())


# rows: a multiple of the JAX row block, ragged ones it pads, one of the port's
# 128-row tile edges; widths of one k-step and of three
@pytest.mark.parametrize("n,d", [(512, 64), (74, 64), (129, 192), (3, 64)])
def test_fused_preattn_bf16_twin_matches_jax(n, d):
    rng = np.random.default_rng(300 + n)
    (jx, tx), (js, ts), (jb, tb), (jw, tw), (jwb, twb) = (
        _bf16(rng, n, d), _bf16(rng, d, std=0.1, mean=1.0), _bf16(rng, d, std=0.1),
        _bf16(rng, d, 3 * d, std=0.05), _bf16(rng, 3 * d, std=0.05))
    ref = jfl.fused_preattn(jx, js, jb, jw, jwb, eps=1e-6)
    launches = tfl.fused_preattn.launches
    out = tfl.fused_preattn(tx, ts, tb, tw, twb, eps=1e-6)
    assert tfl.fused_preattn.launches == launches  # CPU tensor: plain twin, no kernel
    assert out.dtype == torch.bfloat16 and out.shape == (n, 3 * d)
    _close(out, ref, K1_SHARE)


@pytest.mark.parametrize("n,d,f", [(256, 64, 128), (74, 64, 128), (129, 128, 256)])
def test_fused_postattn_bf16_twin_matches_jax(n, d, f):
    rng = np.random.default_rng(400 + n)
    pairs = (
        _bf16(rng, n, d), _bf16(rng, n, d), _bf16(rng, d, d, std=0.05), _bf16(rng, d, std=0.05),
        _bf16(rng, d, std=0.1, mean=0.7), _bf16(rng, d, std=0.1, mean=1.0),
        _bf16(rng, d, std=0.1), _bf16(rng, d, f, std=0.05), _bf16(rng, f, std=0.05),
        _bf16(rng, f, d, std=0.05), _bf16(rng, d, std=0.05), _bf16(rng, d, std=0.1, mean=1.3),
    )
    ref = jfl.fused_postattn(*(p[0] for p in pairs), eps=1e-6)
    launches = tfl.fused_postattn.launches
    out = tfl.fused_postattn(*(p[1] for p in pairs), eps=1e-6)
    assert tfl.fused_postattn.launches == launches
    assert out.dtype == torch.bfloat16 and out.shape == (n, d)
    _close(out, ref, K3_SHARE)


@pytest.mark.parametrize("src", ["bf16", "fp32"])
def test_ln_operand_matches_jax(src):
    """The bf16 operand that the row pass writes (K1 from bf16 x, K3's fc1 from
    fp32 y32): fp32 two-pass statistics, biased variance, eps inside the rsqrt,
    rounded to bf16 once; the twins' _ln32(...).to(bf16) against JAX's
    _ln(...).astype(bf16), within one bf16 ulp."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((300, 768)) * 3.0 + 0.5).astype(np.float32)
    if src == "bf16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    (js, ts), (jb, tb) = _bf16(rng, 768, std=0.1, mean=1.0), _bf16(rng, 768, std=0.1)
    ref = jfl._ln(jnp.asarray(x), js.astype(jnp.float32), jb.astype(jnp.float32), 1e-6)
    ref = np.asarray(ref.astype(jnp.bfloat16).astype(jnp.float32))
    out = tfl._ln32(torch.from_numpy(x), ts, tb, 1e-6).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=1e-6)
