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


# bf16 runs the Hopper forward of csrc/flash_fwd_sm90.cu, 128 query rows and 128
# keys a tile: lengths on both sides of its tile edges, a ragged 1370, an odd batch.
# fp32 runs the warp-tiled forward of csrc/flash_attention.cu at its old cases.
PACKED_CASES = ([(dtype, 2, l) for dtype in DTYPES for l in (17, 64, 130)]
                + [(torch.bfloat16, 2, l) for l in (63, 65, 127, 128, 129, 257, 1370)]
                + [(torch.bfloat16, 3, 129)])


@pytest.mark.parametrize("dtype,b,l", PACKED_CASES)
def test_packed_attention_kernel(dtype, b, l):
    g = torch.Generator(device="cuda").manual_seed(l)
    qkv = _rn(g, dtype, b, l, 3 * 128)
    n0 = fl.flash_attention_packed.launches
    out = fl.flash_attention_packed(qkv, 2)
    assert fl.flash_attention_packed.launches == n0 + 1
    _check(out, fl.flash_attention_packed_plain(qkv, 2), dtype)


def _device_kernels(fn):
    """The names of the device kernels that one call of ``fn`` ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_forward_runs_the_hopper_kernel_in_bf16(dtype):
    """K2 and K13 in bf16 run fwd_sm90_kernel (csrc/flash_fwd_sm90.cu) and
    nothing else; in fp32 they run fwd_kernel<float, ...> of flash_attention.cu."""
    g = torch.Generator(device="cuda").manual_seed(5)
    qkv = _rn(g, dtype, 2, 130, 3 * 128)
    q, k, v = (qkv[..., i * 128:(i + 1) * 128].reshape(2, 130, 2, 64) for i in range(3))
    for fn in (lambda: fl.flash_attention_packed(qkv, 2), lambda: fa.flash_attention(q, k, v)):
        names = _device_kernels(fn)
        if dtype == torch.bfloat16:
            assert len(names) == 1 and "fwd_sm90_kernel" in names[0], names
        else:
            assert len(names) == 1 and "fwd_kernel<float" in names[0], names


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


# bf16 runs the Hopper backward of csrc/flash_bwd_sm90.cu, 128-row blocks and 64-row
# inner steps: lengths on both sides of their edges, a ragged 1370, an odd batch
PACKED_BWD_CASES = ([(dtype, 2, l) for dtype in DTYPES for l in (17, 37, 64, 128, 130)]
                    + [(torch.bfloat16, 2, l) for l in (63, 65, 127, 129, 257, 1370)]
                    + [(torch.bfloat16, 3, 129)])


@pytest.mark.parametrize("dtype,b,l", PACKED_BWD_CASES)
def test_packed_attention_bwd_kernel(dtype, b, l):
    g = torch.Generator(device="cuda").manual_seed(l)
    qkv, cot = _rn(g, dtype, b, l, 3 * 128), _rn(g, dtype, b, l, 128)
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
# across several query blocks; kv_len masks the padded tail. bf16 adds the edges
# of the Hopper forward's 128-row tiles, kv_len inside one tile (90 of 128) and
# over a lane-padded tower (1370 of 1408), and an odd batch
FLASH_CASES = ([(dtype, 2, l, kv) for dtype in DTYPES
                for l, kv in ((17, None), (32, None), (37, None), (64, 50), (130, None),
                              (256, 200))]
               + [(torch.bfloat16, 2, l, kv)
                  for l, kv in ((63, None), (65, None), (127, None), (128, None), (129, None),
                                (257, None), (128, 90), (1408, 1370))]
               + [(torch.bfloat16, 3, 129, None)])


@pytest.mark.parametrize("layout", ["packed", "contiguous"])
@pytest.mark.parametrize("dtype,b,l,kv_len", FLASH_CASES)
def test_flash_attention_kernels(dtype, b, l, kv_len, layout):
    """K13 against its twin on views of one packed product or on contiguous
    (B, L, H, 64) tensors, and K14 through the autograd Function: dq, dk, dv,
    the same bits on a second backward."""
    g = torch.Generator(device="cuda").manual_seed(l)
    qkv, cot = _rn(g, dtype, b, l, 3 * 192), _rn(g, dtype, b, l, 3, 64)
    q, k, v = (qkv[..., i * 192:(i + 1) * 192].reshape(b, l, 3, 64) for i in range(3))
    if layout == "contiguous":
        q, k, v = (t.contiguous() for t in (q, k, v))
    n0 = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, kv_len=kv_len)
    assert fa.flash_attention.launches == n0 + 1
    _check(out, fa.flash_attention_plain(q, k, v, kv_len=kv_len), dtype)
    first, second = _backward_twice(lambda *t: fa.flash_attention(*t, kv_len=kv_len), (q, k, v),
                                    cot, fa.flash_attention_bwd)
    _check_grads(first, fa.flash_attention_bwd_plain(q, k, v, cot, kv_len=kv_len), dtype,
                 ("dq", "dk", "dv"))
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    if dtype == torch.bfloat16:  # the row statistic the Hopper forward writes for its backward
        out2, lse = fa.flash_attention_lse(q, k, v, kv_len=kv_len)
        assert torch.equal(out2, out)
        torch.testing.assert_close(lse, fa.flash_attention_lse_plain(q, k, v, kv_len=kv_len)[1],
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_backward_runs_the_hopper_kernels_in_bf16(dtype):
    """K7 and K14 in bf16 run bwd_dq_sm90_kernel and bwd_dkdv_sm90_kernel
    (csrc/flash_bwd_sm90.cu) and nothing else, never bwd_stats_kernel; in
    fp32 the statistics, dK/dV and dQ kernels of flash_attention.cu. The
    bf16 Functions keep the forward's output and lse."""
    g = torch.Generator(device="cuda").manual_seed(6)
    qkv, cot = _rn(g, dtype, 2, 130, 3 * 128), _rn(g, dtype, 2, 130, 128)
    q, k, v = (qkv[..., i * 128:(i + 1) * 128].reshape(2, 130, 2, 64) for i in range(3))
    kw = {}
    if dtype == torch.bfloat16:
        out, lse = fa.flash_attention_lse(q, k, v)
        kw = {"out": out, "lse": lse}
        leaf = q.clone().requires_grad_(True)
        y = fa.flash_attention(leaf, k, v)  # kept alive: its Function saved it
        assert [tuple(t.shape) for t in y.grad_fn.saved_tensors[3:]] == [(2, 130, 2, 64),
                                                                         (2, 2, 130)]
    for fn in (lambda: fl.flash_attention_packed_bwd(qkv, 2, cot, **kw),
               lambda: fa.flash_attention_bwd(q, k, v, cot.reshape(q.shape), **kw)):
        names = _device_kernels(fn)
        if dtype == torch.bfloat16:
            assert len(names) == 2, names
            assert all(any(want in n for n in names)
                       for want in ("bwd_dq_sm90_kernel", "bwd_dkdv_sm90_kernel")), names
        else:
            assert len(names) == 3 and any("bwd_stats_kernel<float" in n for n in names), names
        assert not (dtype == torch.bfloat16 and any("bwd_stats_kernel" in n for n in names))


def test_bf16_backward_requires_the_forward_statistics():
    """No route back to the recomputing kernels: without out and lse the
    bf16 backward raises; lse exists in bf16 only."""
    g = torch.Generator(device="cuda").manual_seed(7)
    qkv, cot = _rn(g, torch.bfloat16, 1, 70, 3 * 128), _rn(g, torch.bfloat16, 1, 70, 128)
    q, k, v = (qkv[..., i * 128:(i + 1) * 128].reshape(1, 70, 2, 64) for i in range(3))
    with pytest.raises(ValueError, match="out and lse"):
        fl.flash_attention_packed_bwd(qkv, 2, cot)
    with pytest.raises(ValueError, match="out and lse"):
        fa.flash_attention_bwd(q, k, v, cot.reshape(q.shape))
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_attention_lse(q.float(), k.float(), v.float())


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
