"""Kernels K1-K16 against their plain twins on an NVIDIA card.

Marked ``cuda``: without a card (or nvcc) every test skips. On a machine
with one, and without JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports jax). Shapes are small
and ragged: rows not a multiple of the 64-row tile, sequences shorter than
one key tile, query counts across two query blocks.
"""

import pytest
import torch

from radzero_torch.ops import flash_attention as fa
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


def _check(out, ref, dtype, atol=None):
    default_atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=default_atol if atol is None else atol)


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [37, 200])
def test_fused_mpnet_post_kernel(dtype, m):
    g = torch.Generator(device="cuda").manual_seed(m)
    d, f = 128, 256
    args = (_rn(g, dtype, m, d), _rn(g, dtype, m, d), _rn(g, dtype, d, d, std=0.05),
            _rn(g, dtype, d, std=0.05), _rn(g, dtype, d, std=0.1, mean=1.0),
            _rn(g, dtype, d, std=0.1), _rn(g, dtype, d, f, std=0.05), _rn(g, dtype, f, std=0.05),
            _rn(g, dtype, f, d, std=0.05), _rn(g, dtype, d, std=0.05),
            _rn(g, dtype, d, std=0.1, mean=1.3), _rn(g, dtype, d, std=0.1))
    n0 = fl.fused_mpnet_post.launches
    out = fl.fused_mpnet_post(*args)
    assert fl.fused_mpnet_post.launches == n0 + 1
    # outputs of a LayerNorm reach ~4: bf16 allows two ulps of that
    _check(out, fl.fused_mpnet_post_plain(*args), dtype)


# queries across two 32-row blocks, L short of / past one 64-token tile, D of
# one and of three 256-column chunks; tau 0.008 is the JAX suite's tiny one
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,b,l,d,tau", [(5, 2, 37, 64, 0.07), (40, 3, 130, 128, 0.008),
                                         (33, 2, 100, 768, 0.07)])
def test_vlcabs_train_kernels(dtype, n, b, l, d, tau):
    g = torch.Generator(device="cuda").manual_seed(n * l)
    q = torch.randn((n, d), generator=g, device="cuda")
    q = (q / q.norm(dim=-1, keepdim=True)).to(dtype).requires_grad_(True)
    t = _rn(g, dtype, b, l, d).requires_grad_(True)
    tau_t = torch.tensor(tau, device="cuda", requires_grad=True)
    w = torch.randn((n, b), generator=g, device="cuda")
    counters = (vf.vlcabs_train_forward, vf.vlcabs_train_bwd_dq, vf.vlcabs_train_bwd_dtn)
    before = [c.launches for c in counters]
    logits = vf.vlcabs_fused_train(q, t, tau_t)
    (logits * w).sum().backward()
    assert [c.launches for c in counters] == [n0 + 1 for n0 in before]
    with torch.no_grad():
        ref = vf.vlcabs_train_forward_plain(q, t, tau_t.reshape(1))
        rdq, rdt, rdtau = vf.vlcabs_train_backward_plain(q, t, tau_t, w)
    _check(logits, ref, dtype)
    # gradients: the tolerance scales with the largest entry of each (the
    # sums run in another order; dtau adds N * B * L terms of both signs)
    for got, want in ((q.grad, rdq), (t.grad, rdt), (tau_t.grad, rdtau)):
        atol, rtol = TOL[dtype]
        scale = want.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), atol=atol * max(scale, 1.0),
                                   rtol=rtol)
    assert q.grad.dtype == dtype and t.grad.dtype == dtype and tau_t.grad.shape == ()
    # fixed-order sums, no atomics: a second backward gives the same bits
    first = [x.grad.clone() for x in (q, t, tau_t)]
    for x in (q, t, tau_t):
        x.grad = None
    (vf.vlcabs_fused_train(q, t, tau_t) * w).sum().backward()
    for a, x in zip(first, (q, t, tau_t)):
        assert torch.equal(a, x.grad)


def _k1_args(g, dtype, m, d):
    return (_rn(g, dtype, m, d), _rn(g, dtype, d, std=0.1, mean=1.0), _rn(g, dtype, d, std=0.1),
            _rn(g, dtype, d, 3 * d, std=0.05), _rn(g, dtype, 3 * d, std=0.05))


def _k3_args(g, dtype, m, d, f):
    return (_rn(g, dtype, m, d), _rn(g, dtype, m, d), _rn(g, dtype, d, d, std=0.05),
            _rn(g, dtype, d, std=0.05), _rn(g, dtype, d, std=0.1, mean=0.7),
            _rn(g, dtype, d, std=0.1, mean=1.0), _rn(g, dtype, d, std=0.1),
            _rn(g, dtype, d, f, std=0.05), _rn(g, dtype, f, std=0.05),
            _rn(g, dtype, f, d, std=0.05), _rn(g, dtype, d, std=0.05),
            _rn(g, dtype, d, std=0.1, mean=1.3))


def _k4_args(g, dtype, m, d, f):
    return (_rn(g, dtype, m, d), _rn(g, dtype, m, d), _rn(g, dtype, d, d, std=0.05),
            _rn(g, dtype, d, std=0.05), _rn(g, dtype, d, std=0.1, mean=1.0),
            _rn(g, dtype, d, std=0.1), _rn(g, dtype, d, f, std=0.05), _rn(g, dtype, f, std=0.05),
            _rn(g, dtype, f, d, std=0.05), _rn(g, dtype, d, std=0.05),
            _rn(g, dtype, d, std=0.1, mean=1.3), _rn(g, dtype, d, std=0.1))


def _check_grads(got, want, dtype, names):
    """Each gradient within 2e-4 (fp32: the JAX suite's gradient tolerance) or
    2^-7 (bf16: rounding flips move an entry by a share of the largest one,
    the sums run over many rows) of the twin's largest entry."""
    share = 2e-4 if dtype == torch.float32 else 2.0**-7
    for a, b, name in zip(got, want, names):
        assert a.dtype == dtype and a.shape == b.shape, name
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all(), name
        err, top = (a - b).abs().max().item(), b.abs().max().item()
        assert err <= share * top + 1e-7, f"{name}: {err:.3e} against {top:.3e}"


def _backward_twice(fn, args, cot, counter):
    """Gradients of ``fn`` at ``args`` through autograd on the card, twice:
    -> (first, second), with one launch of ``counter`` per backward."""
    runs = []
    for _ in range(2):
        leaves = [a.clone().requires_grad_(True) for a in args]
        out = fn(*leaves)
        n0 = counter.launches
        runs.append(torch.autograd.grad(out, leaves, cot))
        assert counter.launches == n0 + 1
    return runs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,d", [(96, 128), (257, 128), (130, 768)])
def test_fused_preattn_bwd_kernel(dtype, m, d):
    """K6 through the autograd Function against its twin; fixed-order sums
    give the same bits on a second backward."""
    g = torch.Generator(device="cuda").manual_seed(m)
    args, cot = _k1_args(g, dtype, m, d), _rn(g, dtype, m, 3 * d)
    first, second = _backward_twice(fl.fused_preattn, args, cot, fl.fused_preattn_bwd)
    want = fl.fused_preattn_bwd_plain(*args, cot)
    _check_grads(first, want, dtype, ("dx", "dln_scale", "dln_bias", "dw", "db"))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("l", [17, 37, 64, 128, 130])
def test_packed_attention_bwd_kernel(dtype, l):
    g = torch.Generator(device="cuda").manual_seed(l)
    qkv, cot = _rn(g, dtype, 2, l, 3 * 128), _rn(g, dtype, 2, l, 128)
    first, second = _backward_twice(lambda t: fl.flash_attention_packed(t, 2), (qkv,), cot,
                                    fl.flash_attention_packed_bwd)
    want = fl.flash_attention_packed_bwd_plain(qkv, 2, cot)
    d = 128
    for i, name in enumerate(("dq", "dk", "dv")):  # each third against its own largest entry
        _check_grads((first[0][..., i * d:(i + 1) * d],), (want[..., i * d:(i + 1) * d],),
                     dtype, (name,))
    assert torch.equal(first[0], second[0])


_K8_NAMES = ("dx", "da", "dwo", "dbo", "dls1", "dln_scale", "dln_bias", "dw1", "db1", "dw2",
             "db2", "dls2")
_K9_NAMES = ("dx", "da", "dwo", "dbo", "dlnsa", "dlnba", "dw1", "db1", "dw2", "db2", "dlnso",
             "dlnbo")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [96, 257])
def test_fused_postattn_bwd_kernel(dtype, m):
    g = torch.Generator(device="cuda").manual_seed(m)
    args, cot = _k3_args(g, dtype, m, 128, 256), _rn(g, dtype, m, 128)
    first, second = _backward_twice(fl.fused_postattn, args, cot, fl.fused_postattn_bwd)
    _check_grads(first, fl.fused_postattn_bwd_plain(*args, cot), dtype, _K8_NAMES)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [96, 257])
def test_fused_mpnet_post_bwd_kernel(dtype, m):
    g = torch.Generator(device="cuda").manual_seed(m)
    args, cot = _k4_args(g, dtype, m, 128, 256), _rn(g, dtype, m, 128)
    first, second = _backward_twice(fl.fused_mpnet_post, args, cot, fl.fused_mpnet_post_bwd)
    _check_grads(first, fl.fused_mpnet_post_bwd_plain(*args, cot), dtype, _K9_NAMES)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _bias_and_mask(g, dtype, b, l, h):
    bias = _rn(g, torch.float32, h, l, l, std=0.5)
    lengths = torch.randint(1, l + 1, (b,), generator=g, device="cuda")
    lengths[0] = l
    mask = (torch.arange(l, device="cuda")[None] < lengths[:, None]).float()
    return bias, (1.0 - mask) * torch.finfo(dtype).min


# lengths below one key tile, at the small tiles' edges (32, 64), ragged, and
# across several query blocks; kv_len masks the padded tail
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("l,kv_len", [(17, None), (32, None), (37, None), (64, 50), (130, None),
                                      (256, 200)])
def test_flash_attention_kernels(dtype, l, kv_len):
    """K13 against its twin on views of one packed product, and K14 through
    the autograd Function: dq, dk, dv, the same bits on a second backward."""
    g = torch.Generator(device="cuda").manual_seed(l)
    qkv, cot = _rn(g, dtype, 2, l, 3 * 192), _rn(g, dtype, 2, l, 3, 64)
    q, k, v = (qkv[..., i * 192:(i + 1) * 192].reshape(2, l, 3, 64) for i in range(3))
    n0 = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, kv_len=kv_len)
    assert fa.flash_attention.launches == n0 + 1
    _check(out, fa.flash_attention_plain(q, k, v, kv_len=kv_len), dtype)
    first, second = _backward_twice(lambda *t: fa.flash_attention(*t, kv_len=kv_len), (q, k, v),
                                    cot, fa.flash_attention_bwd)
    _check_grads(first, fa.flash_attention_bwd_plain(q, k, v, cot, kv_len=kv_len), dtype,
                 ("dq", "dk", "dv"))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,l,kv_len", [(5, 17, None), (40, 32, None), (3, 37, None), (6, 64, 50),
                                        (3, 130, None)])
def test_flash_attention_bias_kernels(dtype, b, l, kv_len):
    """K15 against its twin, and K16 through the autograd Function: dq, dk,
    dv and d(bias) summed over the batch in a fixed order (the same bits on a
    second backward); the key mask gets no gradient."""
    g = torch.Generator(device="cuda").manual_seed(l)
    q, k, v, cot = (_rn(g, dtype, b, l, 3, 64) for _ in range(4))
    bias, neg = _bias_and_mask(g, dtype, b, l, 3)
    n0 = fa.flash_attention_bias.launches
    out = fa.flash_attention_bias(q, k, v, bias, neg, kv_len=kv_len)
    assert fa.flash_attention_bias.launches == n0 + 1
    ref = fa.flash_attention_bias_plain(q, k, v, bias, neg, kv_len=kv_len)
    # bf16, few keys: a softmax weight near 1 that rounds the other way moves an entry
    # by one bf16 ulp of the weight times |v|, whatever the entry's own size
    _check(out, ref, dtype,
           atol=2.0**-9 * ref.float().abs().max().item() if dtype == torch.bfloat16 else None)
    first, second = _backward_twice(
        lambda q, k, v, bias: fa.flash_attention_bias(q, k, v, bias, neg, kv_len=kv_len),
        (q, k, v, bias), cot, fa.flash_attention_bias_bwd)
    want = fa.flash_attention_bias_bwd_plain(q, k, v, bias, neg, cot, kv_len=kv_len)
    _check_grads(first[:3], want[:3], dtype, ("dq", "dk", "dv"))
    _check_grads(first[3:], want[3:], torch.float32, ("dbias",))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_attention_fully_padded_sentence_is_nan_like_the_twin():
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (_rn(g, torch.float32, 3, 37, 2, 64) for _ in range(3))
    bias, neg = _bias_and_mask(g, torch.float32, 3, 37, 2)
    neg[1] = torch.finfo(torch.float32).min
    out = fa.flash_attention_bias(q, k, v, bias, neg)
    ref = fa.flash_attention_bias_plain(q, k, v, bias, neg)
    assert torch.isnan(out[1]).all() and torch.isnan(ref[1]).all()
    _check(out[[0, 2]], ref[[0, 2]], torch.float32)


def test_flash_attention_rejects_other_head_dims():
    q = torch.zeros((1, 8, 2, 32), device="cuda")
    with pytest.raises(ValueError, match="head_dim 64"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head_dim 64"):
        fa.flash_attention_bias(q, q, q, torch.zeros((2, 8, 8), device="cuda"),
                                torch.zeros((1, 8), device="cuda"))


def test_wrapper_rejects_mixed_dtypes():
    x = torch.zeros((4, 64), device="cuda")
    with pytest.raises(TypeError):
        fl.fused_preattn(x, x[0], x[0], torch.zeros((64, 192), device="cuda",
                                                   dtype=torch.bfloat16), x.new_zeros(192))


def test_vlcabs_rejects_query_width_mismatch():
    q = torch.zeros((3, 64), device="cuda")
    with pytest.raises(ValueError, match="queries_normed"):
        vf.vlcabs_fused(q, torch.zeros((2, 5, 128), device="cuda"), torch.tensor(0.07, device="cuda"))
