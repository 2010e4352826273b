"""K6, K8 and K9 in bf16: the plain backward twins against the JAX kernels on
the CPU.

On the card the bf16 backward chains of K6, K8 and K9 run every product on
gemm_sm90_kernel (radzero_torch/ops/csrc/gemm_sm90.cu): the forward
recompute, the dX products with W read K-major and the row-split dW
products; their plain twins (``fused_preattn_bwd_plain``,
``fused_postattn_bwd_plain``, ``fused_mpnet_post_bwd_plain``) are what
chip_smoke.py holds them to. Here the twins meet ``jax.vjp`` of the JAX
custom-VJP functions (their Pallas backward kernels in interpret mode, as the
JAX suite runs them on the CPU) on the same bf16 inputs and cotangent, made
from numpy with fixed seeds, at chip_smoke.py's bf16 tolerance for K6 / K8 /
K9: 2^-7 of the largest |reference| entry of each gradient plus 2^-7
relative. Both sides round the same factors (LN output, GELU output, dm,
dh1, dproj) at the same points, but their fp32 sums run in another order, so
a factor near a bf16 rounding boundary may fall either way and move an entry
by a share of the largest one; the JAX kernel's rational erf is <= 1.5e-7
from the exact erf of the twin. D = 128, F = 256, rows 96 and 257 (no
multiple of the JAX row block).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radzero_tpu.ops import fused_layer as jfl
from radzero_torch.ops import fused_layer as tfl

D, F = 128, 256
SHARE = RTOL = 2.0**-7


def _bf16(rng, *shape, std=1.0, mean=0.0):
    """A seeded normal array, rounded to bf16 -> (jax array, torch tensor)."""
    a = (rng.standard_normal(shape) * std + mean).astype(np.float32)
    t = torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _k1(rng, n):
    return (_bf16(rng, n, D), _bf16(rng, D, std=0.1, mean=1.0), _bf16(rng, D, std=0.1),
            _bf16(rng, D, 3 * D, std=0.05), _bf16(rng, 3 * D, std=0.05))


def _k3(rng, n):
    return (_bf16(rng, n, D), _bf16(rng, n, D), _bf16(rng, D, D, std=0.05),
            _bf16(rng, D, std=0.05), _bf16(rng, D, std=0.1, mean=0.7),
            _bf16(rng, D, std=0.1, mean=1.0), _bf16(rng, D, std=0.1),
            _bf16(rng, D, F, std=0.05), _bf16(rng, F, std=0.05), _bf16(rng, F, D, std=0.05),
            _bf16(rng, D, std=0.05), _bf16(rng, D, std=0.1, mean=1.3))


def _k4(rng, n):
    return (_bf16(rng, n, D), _bf16(rng, n, D), _bf16(rng, D, D, std=0.05),
            _bf16(rng, D, std=0.05), _bf16(rng, D, std=0.1, mean=1.0), _bf16(rng, D, std=0.1),
            _bf16(rng, D, F, std=0.05), _bf16(rng, F, std=0.05), _bf16(rng, F, D, std=0.05),
            _bf16(rng, D, std=0.05), _bf16(rng, D, std=0.1, mean=1.3), _bf16(rng, D, std=0.1))


# kernel: (inputs, JAX custom-VJP function with its eps, the port's backward
# wrapper, which on CPU tensors runs its plain twin, and its eps, width of the
# cotangent, gradient names)
CASES = {
    "K6": (_k1, lambda *a: jfl.fused_preattn_vjp(*a, 1e-6), tfl.fused_preattn_bwd, 1e-6,
           3 * D, ("dx", "dln_scale", "dln_bias", "dw_qkv", "db_qkv")),
    "K8": (_k3, lambda *a: jfl.fused_postattn_vjp(*a, 1e-6), tfl.fused_postattn_bwd, 1e-6, D,
           ("dx", "da", "dwo", "dbo", "dls1", "dln_scale", "dln_bias", "dw1", "db1", "dw2",
            "db2", "dls2")),
    "K9": (_k4, lambda *a: jfl.fused_mpnet_post_vjp(*a, 1e-12), tfl.fused_mpnet_post_bwd,
           1e-12, D, ("dx", "da", "dwo", "dbo", "dlnsa", "dlnba", "dw1", "db1", "dw2", "db2",
                      "dlnso", "dlnbo")),
}


@pytest.mark.parametrize("n", [96, 257])
@pytest.mark.parametrize("k", sorted(CASES))
def test_bf16_backward_twin_matches_jax_vjp(k, n):
    make, jax_fn, bwd, eps, width, names = CASES[k]
    rng = np.random.default_rng(900 + n)
    pairs = make(rng, n)
    jcot, tcot = _bf16(rng, n, width)
    _, vjp = jax.vjp(jax_fn, *(p[0] for p in pairs))
    refs = vjp(jcot)
    launches = bwd.launches
    grads = bwd(*(p[1] for p in pairs), tcot, eps=eps)
    assert bwd.launches == launches  # CPU tensors: the plain twin, no kernel
    assert len(grads) == len(refs) == len(names)
    for got, ref, (_, t), name in zip(grads, refs, pairs, names):
        assert got.dtype == torch.bfloat16 and got.shape == t.shape, name
        ref = np.asarray(ref.astype(jnp.float32))
        got = got.float().numpy()
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=SHARE * np.abs(ref).max(),
                                   err_msg=name)
