"""Kernels K1-K3 and K5 against their plain twins on an NVIDIA card.

Marked ``cuda``: without a card (or nvcc) every test skips. On a machine
with one, and without JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports jax). Shapes are small
and ragged: rows not a multiple of the 64-row tile, sequences shorter than
one key tile, query counts across two query blocks.
"""

import pytest
import torch

from radzero_torch.ops import fused_layer as fl
from radzero_torch.ops import vlcabs_fused as vf

pytestmark = pytest.mark.cuda

# (atol, rtol) per dtype; bf16 allows two bf16 ulps (see chip_smoke.py)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-3, 2.0**-7)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from radzero_torch.ops import _build

    if _build.find_nvcc() is None:
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rn(gen, dtype, *shape, std=1.0, mean=0.0):
    return (torch.randn(shape, generator=gen, device="cuda") * std + mean).to(dtype)


def _check(out, ref, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,d", [(37, 64), (130, 768)])
def test_fused_preattn_kernel(dtype, m, d):
    g = torch.Generator(device="cuda").manual_seed(m)
    args = (_rn(g, dtype, m, d), _rn(g, dtype, d, std=0.1, mean=1.0), _rn(g, dtype, d, std=0.1),
            _rn(g, dtype, d, 3 * d, std=0.05), _rn(g, dtype, 3 * d, std=0.05))
    n0 = fl.fused_preattn.launches
    out = fl.fused_preattn(*args)
    assert fl.fused_preattn.launches == n0 + 1
    _check(out, fl.fused_preattn_plain(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("l", [17, 64, 130])
def test_packed_attention_kernel(dtype, l):
    g = torch.Generator(device="cuda").manual_seed(l)
    qkv = _rn(g, dtype, 2, l, 3 * 128)
    _check(fl.flash_attention_packed(qkv, 2), fl.flash_attention_packed_plain(qkv, 2), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [37, 200])
def test_fused_postattn_kernel(dtype, m):
    g = torch.Generator(device="cuda").manual_seed(m)
    d, f = 128, 256
    args = (_rn(g, dtype, m, d), _rn(g, dtype, m, d), _rn(g, dtype, d, d, std=0.05),
            _rn(g, dtype, d, std=0.05), _rn(g, dtype, d, std=0.1, mean=0.7),
            _rn(g, dtype, d, std=0.1, mean=1.0), _rn(g, dtype, d, std=0.1),
            _rn(g, dtype, d, f, std=0.05), _rn(g, dtype, f, std=0.05),
            _rn(g, dtype, f, d, std=0.05), _rn(g, dtype, d, std=0.05),
            _rn(g, dtype, d, std=0.1, mean=1.3))
    _check(fl.fused_postattn(*args), fl.fused_postattn_plain(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,l,d", [(3, 17, 64), (17, 100, 768), (14, 1370, 768)])
def test_vlcabs_fused_kernel(dtype, n, l, d):
    g = torch.Generator(device="cuda").manual_seed(n * l)
    q = torch.randn((n, d), generator=g, device="cuda")
    q = (q / q.norm(dim=-1, keepdim=True)).to(dtype)
    t = _rn(g, dtype, 2, l, d)
    tau = torch.tensor(0.07, device="cuda")
    logits, scores = vf.vlcabs_fused(q, t, tau)
    ref_logits, ref_scores = vf.vlcabs_fused_plain(q, t, tau)
    _check(logits, ref_logits, dtype)
    _check(scores, ref_scores, dtype)


def test_wrapper_rejects_mixed_dtypes():
    x = torch.zeros((4, 64), device="cuda")
    with pytest.raises(TypeError):
        fl.fused_preattn(x, x[0], x[0], torch.zeros((64, 192), device="cuda",
                                                   dtype=torch.bfloat16), x.new_zeros(192))


def test_vlcabs_rejects_query_width_mismatch():
    q = torch.zeros((3, 64), device="cuda")
    with pytest.raises(ValueError, match="queries_normed"):
        vf.vlcabs_fused(q, torch.zeros((2, 5, 128), device="cuda"), torch.tensor(0.07, device="cuda"))
