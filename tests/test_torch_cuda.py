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


# bf16 K1 and K3 run their products on gemm_sm90_kernel (csrc/gemm_sm90.cu): 128 x 128
# output tiles of two 64-row warpgroups, 64-deep k-steps. Rows on both sides of those
# edges and the tower's 1370 and 2 x 1370; widths of one tile and of the model. Inputs
# at chip_smoke.py's scales, held to its K1 / K3 bf16 tolerance: atol a share of the
# largest |reference| entry (2^-9 for K1, 2^-10 for K3) and rtol 2^-7, because at
# width 768 / 3072 a rounded operand (the LN or GELU output) that falls the other way
# in kernel and twin moves an entry by a share of the largest whatever its own size.
EDGE_ROWS = (1, 63, 64, 65, 127, 128, 129, 1370, 2 * 1370)


def _check_share(out, ref, share):
    ref = ref.float()
    torch.testing.assert_close(out.float(), ref, rtol=2.0**-7,
                               atol=share * ref.abs().max().item())


def _k1_edge_args(g, m, d):
    dt = torch.bfloat16
    return (_rn(g, dt, m, d), _rn(g, dt, d, std=0.1, mean=1.0), _rn(g, dt, d, std=0.1),
            _rn(g, dt, d, 3 * d, std=0.02), _rn(g, dt, 3 * d, std=0.02))


def _k3_edge_args(g, m, d, f):
    dt = torch.bfloat16
    return (_rn(g, dt, m, d), _rn(g, dt, m, d), _rn(g, dt, d, d, std=0.02), _rn(g, dt, d, std=0.02),
            _rn(g, dt, d, std=0.1, mean=1.0), _rn(g, dt, d, std=0.1, mean=1.0),
            _rn(g, dt, d, std=0.1), _rn(g, dt, d, f, std=0.02), _rn(g, dt, f, std=0.02),
            _rn(g, dt, f, d, std=0.02), _rn(g, dt, d, std=0.02), _rn(g, dt, d, std=0.1, mean=1.0))


@pytest.mark.parametrize("d", [64, 768])
@pytest.mark.parametrize("m", EDGE_ROWS)
def test_fused_preattn_bf16_tile_edges(m, d):
    g = torch.Generator(device="cuda").manual_seed(m + d)
    args = _k1_edge_args(g, m, d)
    n0 = fl.fused_preattn.launches
    out = fl.fused_preattn(*args)
    assert fl.fused_preattn.launches == n0 + 1
    _check_share(out, fl.fused_preattn_plain(*args), 2.0**-9)


@pytest.mark.parametrize("d,f", [(128, 256), (768, 3072)])
@pytest.mark.parametrize("m", EDGE_ROWS)
def test_fused_postattn_bf16_tile_edges(m, d, f):
    g = torch.Generator(device="cuda").manual_seed(m + f)
    args = _k3_edge_args(g, m, d, f)
    n0 = fl.fused_postattn.launches
    out = fl.fused_postattn(*args)
    assert fl.fused_postattn.launches == n0 + 1
    _check_share(out, fl.fused_postattn_plain(*args), 2.0**-10)


def test_fused_forwards_under_autograd_take_the_kernels():
    """K1 and K3 handed leaves that require a gradient run their forward through
    _FusedPreattn / _FusedPostattn, on the same kernels (one launch each) and
    against the same twins."""
    g = torch.Generator(device="cuda").manual_seed(11)
    for fn, plain, args, share in (
            (fl.fused_preattn, fl.fused_preattn_plain, _k1_edge_args(g, 1370, 768), 2.0**-9),
            (fl.fused_postattn, fl.fused_postattn_plain, _k3_edge_args(g, 1370, 768, 3072),
             2.0**-10)):
        leaves = [a.clone().requires_grad_(True) for a in args]
        n0 = fn.launches
        out = fn(*leaves)
        assert out.grad_fn is not None and fn.launches == n0 + 1
        _check_share(out.detach(), plain(*args), share)


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


def _device_kernels(fn, tries=3):
    """The names of the device kernels that one call of ``fn`` ran. A profiler
    session that recorded no device activity at all (CUPTI now and then
    delivers none) is run again, up to ``tries`` sessions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()  # no earlier launch still in flight when the session opens
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ran = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if ran:
            break
    return ran


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


def _kernel_kinds(names, kinds):
    """Each device kernel name as the first of ``kinds`` it contains, sorted."""
    return sorted(next((k for k in kinds if k in name), name) for name in names)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_gemm_routes_by_name(dtype):
    """bf16 K1 runs the LN row pass and one gemm_sm90_kernel (csrc/gemm_sm90.cu),
    K3 three gemm_sm90_kernel (o-proj, fc1, fc2) and the row pass, with or without
    a tape; fp32 runs gemm_f32_kernel alone (once for K1, three times for K3)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    k1, k3 = _k1_args(g, dtype, 130, 128), _k3_args(g, dtype, 130, 128, 256)
    leaves1, leaves3 = ([a.clone().requires_grad_(True) for a in args] for args in (k1, k3))
    kinds = ("gemm_sm90_kernel", "row_layernorm_kernel", "gemm_f32_kernel")
    for call, want in ((lambda: fl.fused_preattn(*k1), 1), (lambda: fl.fused_preattn(*leaves1), 1),
                       (lambda: fl.fused_postattn(*k3), 3),
                       (lambda: fl.fused_postattn(*leaves3), 3)):
        names = _device_kernels(call)
        if dtype == torch.bfloat16:
            expect = ["gemm_sm90_kernel"] * want + ["row_layernorm_kernel"]
        else:
            expect = ["gemm_f32_kernel"] * want
        assert _kernel_kinds(names, kinds) == expect, names


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


# bf16 K4 runs K9's forward chain: o-proj (gemm_sm90_kernel<4, 0>, u = x + .), the
# LN rows pass that writes y rounded and in fp32 from one value (ln_rows_kernel),
# fc1 + GELU (<2, 0>), fc2 + y in place (<5, 0>) and row_layernorm_kernel. Rows on
# both sides of the 64- and 128-row edges, serving's 896, the tower's 1370 and the
# training step's 16 384, at the model's widths; chip_smoke.py's K4 tolerance.
@pytest.mark.parametrize("m", [1, 127, 128, 896, 1370, 16384])
def test_fused_mpnet_post_bf16_rows(m):
    g = torch.Generator(device="cuda").manual_seed(m)
    args = _k4_args(g, torch.bfloat16, m, 768, 3072)
    out = fl.fused_mpnet_post(*args)
    _check_share(out, fl.fused_mpnet_post_plain(*args), 2.0**-10)


K4_ROUTE = ["gemm_sm90_kernel<2, 0>", "gemm_sm90_kernel<4, 0>", "gemm_sm90_kernel<5, 0>",
            "ln_rows_kernel<__nv_bfloat16, float, 1>", "row_layernorm_kernel"]


def test_fused_mpnet_post_runs_the_hopper_gemm_in_bf16():
    """bf16 K4 runs exactly its five launches, with or without a tape: three
    gemm_sm90_kernel instantiations and two row passes (gemm_bf16_kernel is
    gone from the build)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    args = _k4_args(g, torch.bfloat16, 200, 128, 256)
    leaves = [a.clone().requires_grad_(True) for a in args]
    for call in (lambda: fl.fused_mpnet_post(*args), lambda: fl.fused_mpnet_post(*leaves)):
        names = _device_kernels(call)
        assert _kernel_kinds(names, K4_ROUTE) == K4_ROUTE, names


def _vlcabs_case(g, dtype, n, b, l, d, tau=0.07):
    q = torch.randn((n, d), generator=g, device="cuda")
    q = (q / q.norm(dim=-1, keepdim=True)).to(dtype)
    t = _rn(g, dtype, b, l, d)
    return q, t, torch.tensor([tau], device="cuda"), torch.randn((n, b), generator=g, device="cuda")


# K12's phases at one image short of a 64-token tile and at the tower's 1370
# tokens, N not a multiple of the 64-query tile: phase 1 against its twin on the
# same tn, dg and row max (e and dc rounded to bf16 from fp32 values whose sums
# run in another order: a flip of one bf16 ulp, 2^-7 relative, or a share of the
# largest dc where dE cancels), zeros where the twin has them; phase 2 against its
# twin on the kernel's own ce (one fp32 sum rounded once: one bf16 ulp)
@pytest.mark.parametrize("l", [37, 1370])
def test_vlcabs_dtn_phases_bf16(l):
    g = torch.Generator(device="cuda").manual_seed(l)
    n, b, d = 100, 2, 768
    q, t, tau, dz = _vlcabs_case(g, torch.bfloat16, n, b, l, d)
    _, (rowmax, gs) = vf.vlcabs_train_forward(q, t, tau, with_stats=True)
    tn = vf.vlcabs_rownorm(t)
    dg, _ = vf.vlcabs_bwd_rows(q, gs, dz)
    ce = vf.vlcabs_dtn_phase1(q, tn, dg, rowmax, tau)
    ref = vf.vlcabs_dtn_phase1_plain(q, tn, dg, rowmax, tau)
    assert ce.shape == ref.shape == (b, 256, -(-l // 64) * 64)
    assert not ce[:, n:128].any() and not ce[:, 128 + n:].any() and not ce[:, :, l:].any()
    _check_share(ce[:, :n, :l], ref[:, :n, :l], 2.0**-9)              # dc
    _check_share(ce[:, 128:128 + n, :l], ref[:, 128:128 + n, :l], 2.0**-9)  # e
    dtn = vf.vlcabs_dtn_phase2(ce, q, dg, l)
    _check_share(dtn, vf.vlcabs_dtn_phase2_plain(ce, q, dg, l), 2.0**-10)
    want = vf.vlcabs_train_bwd_dtn_plain(q, t, tau, dz)
    got = vf.vlcabs_train_bwd_dtn(q, t, tau, dz, stats=(rowmax, gs))
    _check_share(got, want, 2.0**-7)
    assert torch.equal(got, vf.vlcabs_train_bwd_dtn(q, t, tau, dz, stats=(rowmax, gs)))


VLCABS_ROUTES = {  # the backward's device kernels: never pass 1 again
    ("K11", torch.bfloat16): ["gemm_sm90_kernel<5, 4>", "rownorm_kernel", "vlc_bwd_rows_kernel",
                              "vlc_dtn_phase1_sm90_kernel", "vlc_reduce_kernel"],
    ("K11", torch.float32): ["rownorm_kernel", "vlc_bwd_rows_kernel", "vlc_dq_kernel<float>",
                             "vlc_reduce_kernel"],
    ("K12", torch.bfloat16): ["gemm_sm90_kernel<0, 3>", "rownorm_kernel", "vlc_bwd_rows_kernel",
                              "vlc_dtn_phase1_sm90_kernel"],
    ("K12", torch.float32): ["rownorm_kernel", "vlc_bwd_rows_kernel", "vlc_dtn_kernel<float>"],
    ("K11+K12", torch.bfloat16): ["gemm_sm90_kernel<0, 3>", "gemm_sm90_kernel<5, 4>",
                                  "rownorm_kernel", "vlc_bwd_rows_kernel",
                                  "vlc_dtn_phase1_sm90_kernel", "vlc_reduce_kernel"],
    ("K11+K12", torch.float32): ["rownorm_kernel", "vlc_bwd_rows_kernel", "vlc_dq_kernel<float>",
                                 "vlc_dtn_kernel<float>", "vlc_reduce_kernel"],
}
VLCABS_BACKWARDS = {"K11": lambda: vf.vlcabs_train_bwd_dq, "K12": lambda: vf.vlcabs_train_bwd_dtn,
                    "K11+K12": lambda: vf.vlcabs_train_bwd}


@pytest.mark.parametrize("k,dtype", sorted(VLCABS_ROUTES, key=str))
def test_vlcabs_backward_routes_by_name(k, dtype):
    """K11 and K12 start from the forward's statistics: no vlc_pass1_kernel;
    bf16 K12 runs its two Hopper phases and no vlc_dtn_kernel, bf16 K11 K12's
    first phase, its product over dc (gemm_sm90_kernel<EPI_ADDF_F32,
    GEMM_BFWD>) and the reduce, and no vlc_dq_kernel; the shared backward
    runs each shared stage once: one device kernel of each kind."""
    g = torch.Generator(device="cuda").manual_seed(17)
    q, t, tau, dz = _vlcabs_case(g, dtype, 70, 2, 130, 128)
    _, stats = vf.vlcabs_train_forward(q, t, tau, with_stats=True)
    fn = VLCABS_BACKWARDS[k]()
    names = _device_kernels(lambda: fn(q, t, tau, dz, stats=stats))
    want = VLCABS_ROUTES[(k, dtype)]
    assert _kernel_kinds(names, want) == want, names
    assert not any("vlc_dq_kernel<__nv_bfloat16>" in name for name in names), names


# bf16 K11 from K12's first phase: the dtau slots phase 1 writes from its epilogue
# against their twin on the same tn, dg and row max (fp32 sums of 64 x 128 terms
# of fp32 factors in another order: 1e-4 of the largest slot), ce with and without
# them the same bits; then K11's product and reduce on the kernel's own ce against
# their twin (fp32 sums of the same bf16 products in another order, rounded once to
# bf16: one bf16 ulp, 2^-8, of the largest entry; dtau is the same slots folded in
# another order) at a ragged shape (N and L past a 64-query block and a 128-token
# tile) and at the training step's 64 images x 512 sentences x 1370 x 768
@pytest.mark.parametrize("n,b,l", [(70, 3, 150), (512, 64, 1370)])
def test_vlcabs_dq_stages_bf16(n, b, l):
    g = torch.Generator(device="cuda").manual_seed(n + l)
    q, t, tau, dz = _vlcabs_case(g, torch.bfloat16, n, b, l, 768)
    _, (rowmax, gs) = vf.vlcabs_train_forward(q, t, tau, with_stats=True)
    tn = vf.vlcabs_rownorm(t)
    dg, dq_part = vf.vlcabs_bwd_rows(q, gs, dz, want_dq_part=True)
    ce, slots = vf.vlcabs_dtn_phase1(q, tn, dg, rowmax, tau, with_dtau=True)
    assert torch.equal(ce, vf.vlcabs_dtn_phase1(q, tn, dg, rowmax, tau))
    ref_slots = vf.vlcabs_dtn_phase1_plain(q, tn, dg, rowmax, tau, with_dtau=True)[1]
    assert slots.shape == ref_slots.shape == (b * -(-n // 64) * -(-l // 128),)
    torch.testing.assert_close(slots, ref_slots, rtol=1e-4,
                               atol=1e-4 * ref_slots.abs().max().item())
    ref_dq, ref_dtau = vf.vlcabs_dq_from_ce_plain(ce, tn, dq_part, slots, n)
    dq, dtau = vf.vlcabs_dq_from_ce(ce, tn, dq_part.clone(), slots, n)
    _check_share(dq, ref_dq, 2.0**-8)
    torch.testing.assert_close(dtau, ref_dtau, rtol=1e-5, atol=1e-5 * slots.abs().sum().item())
    again = vf.vlcabs_dq_from_ce(ce, tn, dq_part.clone(), slots, n)
    assert torch.equal(dq, again[0]) and torch.equal(dtau, again[1])


# bf16 K5 / K10: the tokens' row pass, phase 1 (S on wgmma, s and the tile
# maxima), the row pass into e, phase 2 (gemm_sm90_kernel<EPI_F32, GEMM_BFWD>) and
# the logits; fp32 K5 its one kernel, fp32 K10 the row pass and pass 1
VLCABS_FWD_BF16 = ["gemm_sm90_kernel<8, 4>", "rownorm_kernel", "vlc_exp_rows_kernel",
                   "vlc_logits_kernel", "vlc_scores_sm90_kernel"]
VLCABS_FWD_ROUTES = {
    ("K5", torch.bfloat16): VLCABS_FWD_BF16, ("K10", torch.bfloat16): VLCABS_FWD_BF16,
    ("K5", torch.float32): ["vlcabs_kernel<float>"],
    ("K10", torch.float32): ["rownorm_kernel", "vlc_pass1_kernel<float"],
}


@pytest.mark.parametrize("dtype", DTYPES)
def test_vlcabs_forward_with_statistics_runs_pass1_once(dtype):
    """Under autograd K10 runs its forward once, which writes the statistics
    beside the logits (bf16: the five stages, never vlc_pass1_kernel; fp32:
    the token row pass and pass 1); the logits are those of the forward
    without them, bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(21)
    q, t, tau, _ = _vlcabs_case(g, dtype, 70, 2, 130, 128)
    names = _device_kernels(lambda: vf.vlcabs_train_forward(q, t, tau, with_stats=True))
    want = VLCABS_FWD_ROUTES[("K10", dtype)]
    assert _kernel_kinds(names, want) == want, names
    logits, (rowmax, gs) = vf.vlcabs_train_forward(q, t, tau, with_stats=True)
    assert torch.equal(logits, vf.vlcabs_train_forward(q, t, tau))
    ref_m, ref_g = vf.vlcabs_train_stats_plain(q, t, tau)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(rowmax, ref_m, atol=atol, rtol=rtol)
    torch.testing.assert_close(gs, ref_g, atol=atol * ref_g.abs().max().item(), rtol=rtol)


@pytest.mark.parametrize("k,dtype", sorted(VLCABS_FWD_ROUTES, key=str))
def test_vlcabs_forward_routes_by_name(k, dtype):
    """bf16 K5 and K10 run the five launches of the Hopper forward and neither
    vlcabs_kernel<__nv_bfloat16> nor vlc_pass1_kernel<__nv_bfloat16, .>; fp32
    keeps its kernels."""
    g = torch.Generator(device="cuda").manual_seed(29)
    q, t, tau, _ = _vlcabs_case(g, dtype, 14, 3, 200, 128)
    fn = vf.vlcabs_fused if k == "K5" else vf.vlcabs_train_forward
    names = _device_kernels(lambda: fn(q, t, tau))
    want = VLCABS_FWD_ROUTES[(k, dtype)]
    assert _kernel_kinds(names, want) == want, names
    assert not any("__nv_bfloat16" in name and ("vlcabs_kernel" in name or "vlc_pass1" in name)
                   for name in names), names


# the bf16 forward's stages, each against its twin on the kernel's own inputs:
# a ragged shape (N, L no multiple of 16, 64 or 128; L short of one token tile),
# serving's 14 prompts x 8 images and the training step's 512 x 64 at 1370 x 768.
# s and the tile maxima are fp32 sums of the same bf16 products in another order
# (the JAX suite's 1e-4 on maps); e is rounded to bf16 from fp32 values on both
# sides (a flip is one bf16 ulp, 2^-8 relative, plus exp2's few fp32 ulps); g is
# an fp32 sum of the same products in another order (1e-4 relative and of the
# largest entry); the logits repeat the twin's fp32 arithmetic on the same g.
@pytest.mark.parametrize("n,b,l,d", [(14, 3, 37, 64), (70, 2, 200, 128), (14, 8, 1370, 768),
                                     (512, 64, 1370, 768)])
def test_vlcabs_forward_stages_bf16(n, b, l, d):
    g = torch.Generator(device="cuda").manual_seed(n + l)
    q, t, tau, _ = _vlcabs_case(g, torch.bfloat16, n, b, l, d)
    tn = vf.vlcabs_rownorm(t)
    s, tmax = vf.vlcabs_fwd_scores(q, tn, tau)
    ref_s, ref_tmax = vf.vlcabs_fwd_scores_plain(q, tn, tau)
    assert s.shape == ref_s.shape == (b, n, -(-l // 64) * 64) and not s[..., l:].any()
    torch.testing.assert_close(s, ref_s, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(tmax, ref_tmax, rtol=1e-4, atol=1e-4)
    e, rowmax, maps = vf.vlcabs_fwd_rows(s, tmax, l, maps=True)
    ref_e, ref_m, _ = vf.vlcabs_fwd_rows_plain(s, tmax, l, torch.bfloat16)
    assert e.shape == ref_e.shape == (b, -(-n // 64) * 64, -(-l // 64) * 64)
    assert not e[:, n:].any() and not e[:, :, l:].any()
    torch.testing.assert_close(e.float(), ref_e.float(), rtol=2.0**-7, atol=1e-6)
    assert torch.equal(rowmax, ref_m) and torch.equal(maps, s[..., :l])
    gs = vf.vlcabs_fwd_g(e, tn, n)
    ref_g = vf.vlcabs_fwd_g_plain(e, tn, n)
    torch.testing.assert_close(gs, ref_g, rtol=1e-4, atol=1e-4 * ref_g.abs().max().item())
    logits = vf.vlcabs_logits(q, gs)
    torch.testing.assert_close(logits, vf.vlcabs_logits_plain(q, gs), rtol=1e-5, atol=1e-6)
    del s, tmax, ref_s, ref_tmax, e, ref_e
    # the entry points: K5 against its whole twin at chip_smoke.py's bf16
    # tolerance, the same bits from a second call, K10's statistics from the
    # same stages
    if d % 64 == 0:
        out = vf.vlcabs_train_forward(q, t, tau, with_stats=True)
        again = vf.vlcabs_train_forward(q, t, tau, with_stats=True)
        assert torch.equal(out[0], again[0]) and torch.equal(out[1][1], again[1][1])
        assert torch.equal(out[1][0], rowmax)
    k5 = vf.vlcabs_fused(q, t, tau.reshape(()))
    assert all(torch.equal(a, b_) for a, b_ in zip(k5, vf.vlcabs_fused(q, t, tau.reshape(()))))
    ref_logits, ref_scores = vf.vlcabs_fused_plain(q, t, tau)
    _check(k5[0], ref_logits, torch.bfloat16)
    _check(k5[1], ref_scores, torch.bfloat16)


def test_vlcabs_backward_requires_the_forward_statistics():
    """On the card K11 and K12 raise without the forward's statistics or with
    ones of another shape."""
    g = torch.Generator(device="cuda").manual_seed(19)
    q, t, tau, dz = _vlcabs_case(g, torch.bfloat16, 20, 2, 40, 128)
    for fn in (vf.vlcabs_train_bwd_dq, vf.vlcabs_train_bwd_dtn):
        with pytest.raises(ValueError, match="statistics"):
            fn(q, t, tau, dz)
        _, (rowmax, gs) = vf.vlcabs_train_forward(q, t, tau, with_stats=True)
        with pytest.raises(ValueError, match="rowmax"):
            fn(q, t, tau, dz, stats=(rowmax[:1], gs))


def test_vlcabs_bf16_full_width_backward_repeats_its_bits():
    """At the training step's widths (512 queries, 1370 tokens, D 768; two
    images) a second backward through the autograd function gives the same
    bits: fixed-order sums, no atomics; so do the shared backward and K11
    and K12 alone, which give the autograd function's dq, dtau and dtn."""
    g = torch.Generator(device="cuda").manual_seed(23)
    q, t, tau, dz = _vlcabs_case(g, torch.bfloat16, 512, 2, 1370, 768)
    runs = []
    for _ in range(2):
        leaves = [x.clone().requires_grad_(True) for x in (q, t, tau)]
        runs.append(torch.autograd.grad(vf.vlcabs_fused_train(*leaves), leaves, dz))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    for got, want in zip(runs[0], vf.vlcabs_train_backward_plain(q, t, tau, dz)):
        _check_share(got.reshape(want.shape), want, 2.0**-7)
    _, stats = vf.vlcabs_train_forward(q, t, tau, with_stats=True)
    shared = [vf.vlcabs_train_bwd(q, t, tau, dz, stats=stats) for _ in range(2)]
    for a, b in zip(*shared):
        assert torch.equal(a, b)
    dq, dtn, dtau = shared[0]
    assert torch.equal(dq, runs[0][0]) and torch.equal(dtau.reshape(runs[0][2].shape), runs[0][2])
    alone = vf.vlcabs_train_bwd_dq(q, t, tau, dz, stats=stats)
    assert torch.equal(alone[0], dq) and torch.equal(alone[1], dtau)
    assert torch.equal(vf.vlcabs_train_bwd_dtn(q, t, tau, dz, stats=stats), dtn)


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


# bf16 K6, K8 and K9 run every product on gemm_sm90_kernel<EPI, MODE>
# (csrc/gemm_sm90.cu; MODE 0: A . W, 1: G . W^T with W read as stored, 2: the
# row-split dW = A^T . G) between the row passes and the fixed-order reduces
# (csrc/fused_layer_bwd.cu): at D = 128 a warp holds a row as one 8-column chunk
# a lane; the LayerNorm backward holds 2 column sums (K6) or 4; reduce_chunks_kernel
# is the first level of the two-level reduce, reduce_parts_kernel the second and the
# one-level reduce of the dW partial tiles
CHAIN_ROUTES = {
    "K6": {"<8, 2>", "<8, 1>"},
    "K8": {"<6, 0>", "<7, 0>", "<8, 0>", "<8, 2>", "<9, 1>", "<8, 1>", "<0, 1>"},
    "K9": {"<4, 0>", "<7, 0>", "<5, 0>", "<8, 2>", "<9, 1>", "<5, 1>", "<0, 1>"},
}
_BF, _ROWS = "__nv_bfloat16", "ln_rows_kernel<__nv_bfloat16, "
_LNB, _COLSUM = "ln_bwd_rows_kernel<__nv_bfloat16, ", "scale_colsum_kernel<__nv_bfloat16, "
_REDUCES = {"reduce_chunks_kernel", "reduce_parts_kernel<__nv_bfloat16>"}
CHAIN_PASSES = {
    "K6": {_ROWS + _BF + ", 1>", _LNB + _BF + ", float, 1, 2>", _COLSUM + "false>"} | _REDUCES,
    "K8": {_ROWS + "float, 1>", _LNB + "float, float, 1, 4>", _COLSUM + "true>"} | _REDUCES,
    "K9": {_ROWS + "float, 1>", _LNB + f"float, {_BF}, 1, 4>", _LNB + "float, float, 1, 4>"}
    | _REDUCES,
}
CHAIN_KINDS = ("gemm_sm90_kernel", "ln_rows_kernel", "ln_bwd_rows_kernel",
               "scale_colsum_kernel", "reduce_chunks_kernel", "reduce_parts_kernel")


def _short_name(name):
    """A device kernel's name with its template arguments, no namespace or parameters."""
    return name.removeprefix("void ").split("(")[0].split("::")[-1]


def _chain_call(k, g, dtype, m, d, f):
    """One call of the backward wrapper of ``k`` at (m, d, f) -> (fn, twin's grads, names)."""
    if k == "K6":
        args, cot = _k1_args(g, dtype, m, d), _rn(g, dtype, m, 3 * d)
        return (lambda: fl.fused_preattn_bwd(*args, cot), lambda: fl.fused_preattn_bwd_plain(
            *args, cot), ("dx", "dln_scale", "dln_bias", "dw", "db"))
    if k == "K8":
        args, cot = _k3_args(g, dtype, m, d, f), _rn(g, dtype, m, d)
        return (lambda: fl.fused_postattn_bwd(*args, cot),
                lambda: fl.fused_postattn_bwd_plain(*args, cot), _K8_NAMES)
    args, cot = _k4_args(g, dtype, m, d, f), _rn(g, dtype, m, d)
    return (lambda: fl.fused_mpnet_post_bwd(*args, cot),
            lambda: fl.fused_mpnet_post_bwd_plain(*args, cot), _K9_NAMES)


@pytest.mark.parametrize("k", sorted(CHAIN_ROUTES))
def test_backward_chains_run_the_hopper_gemm_in_bf16(k):
    """bf16 K6, K8 and K9 run exactly their gemm_sm90_kernel instantiations,
    row passes and reduces: no gemm_bf16_kernel, wgrad_bf16_kernel or
    transpose_kernel."""
    g = torch.Generator(device="cuda").manual_seed(13)
    call, _, _ = _chain_call(k, g, torch.bfloat16, 200, 128, 256)
    names = _device_kernels(call)
    assert set(_kernel_kinds(names, CHAIN_KINDS)) <= set(CHAIN_KINDS), names
    gemms = {n[n.index("gemm_sm90_kernel") + 16:].split(">")[0] + ">"
             for n in names if "gemm_sm90_kernel" in n}
    assert gemms == CHAIN_ROUTES[k], names
    passes = {_short_name(n) for n in names if "gemm_sm90_kernel" not in n}
    assert passes == CHAIN_PASSES[k], names


def _close_share(out, ref, share, rtol):
    ref = ref.float()
    torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=share * ref.abs().max().item())


def _close32(out, ref):  # fp32 sums of the same bf16 products in another order
    assert out.dtype == torch.float32
    _close_share(out, ref, 1e-4, 1e-4)


def _close16(out, ref):  # the same, rounded once: up to one bf16 ulp either way
    assert out.dtype == torch.bfloat16
    _close_share(out, ref, 2.0**-8, 2.0**-7)


# the epilogues of the chains on gemm_sm90_kernel: (name, W read as stored, W^T)
CHAIN_EPIS = [("bias", True), ("add_f32", False), ("addf_f32", False), ("addf_f32", True),
              ("proj2", False), ("gelu_h1", False), ("f32", False), ("f32", True),
              ("dgelu", True)]
CHAIN_ROWS = (1, 127, 128, 129, 1370)
CHAIN_NK = ((128, 128), (768, 3072), (3072, 768))


@pytest.mark.parametrize("n,k", CHAIN_NK)
@pytest.mark.parametrize("m", CHAIN_ROWS)
@pytest.mark.parametrize("epi,w_t", CHAIN_EPIS)
def test_chain_epilogue_bf16_tile_edges(epi, w_t, m, n, k):
    """Each epilogue of the chains on gemm_sm90_kernel against the same product
    in fp32 on torch (TF32 off), across the 64- and 128-row tile edges, at one
    tile and at the model's widths; W (k, n), or (n, k) read as stored for
    out = a . W^T."""
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(m + n + k)
    a = _rn(g, bf, m, k)
    w = _rn(g, bf, n, k, std=0.02) if w_t else _rn(g, bf, k, n, std=0.02)
    acc = a.float() @ (w.float().t() if w_t else w.float())
    bias, ls = _rn(g, bf, n, std=0.02), _rn(g, bf, n, std=0.1, mean=1.0)
    ch = fl._Chain("test", a, 1)
    f32 = ch.f32(m, n)
    kw = {"w_t": w_t}
    if epi == "bias":  # da: no bias
        _close16(ch.gemm(a, w, fl._EPI_BIAS, ch.t(m, n), **kw), acc)
    elif epi == "add_f32":  # u = x + a Wo + bo
        x = _rn(g, bf, m, n)
        _close32(ch.gemm(a, w, fl._EPI_ADD_F32, f32, bias=bias, resid=x, **kw),
                 x.float() + acc + bias.float())
    elif epi in ("addf_f32", "f32"):  # v = y + gl W2 (+ b2), dyln = dv + dh1 W1^T; m, dh
        b = None if w_t else bias
        y = torch.randn((m, n), generator=g, device="cuda") if epi == "addf_f32" else None
        ref = acc + (0.0 if b is None else b.float()) + (0.0 if y is None else y)
        code = fl._EPI_ADDF_F32 if y is not None else fl._EPI_F32
        _close32(ch.gemm(a, w, code, f32, bias=b, resid=y, **kw), ref)
    elif epi == "proj2":  # proj = a Wo + bo and y = x + ls1 proj, both fp32
        x, proj = _rn(g, bf, m, n), ch.f32(m, n)
        out = ch.gemm(a, w, fl._EPI_PROJ2, f32, bias=bias, resid=x, ls=ls, out2=proj, **kw)
        _close32(proj, acc + bias.float())
        _close32(out, x.float() + ls.float() * (acc + bias.float()))
    elif epi == "gelu_h1":  # h1 fp32 and gelu(h1) rounded
        h1 = ch.f32(m, n)
        gl = ch.gemm(a, w, fl._EPI_GELU_H1, ch.t(m, n), bias=bias, out2=h1, **kw)
        ref = acc + bias.float()
        _close32(h1, ref)
        _close16(gl, ref * fl._gelu_parts(ref)[0])
    else:  # dh1 = (dm W2^T) gelu'(h1) rounded and db1, its unrounded column sums
        h1 = torch.randn((m, n), generator=g, device="cuda")
        dh1, db1 = ch.dgelu_gemm(a, w, h1)
        ref = acc * fl._gelu_parts(h1)[1]
        _close16(dh1, ref)
        _close16(db1, ref.sum(0))
    torch.cuda.synchronize()


@pytest.mark.parametrize("nb,ka", CHAIN_NK)
@pytest.mark.parametrize("m", CHAIN_ROWS)
def test_wgrad_bf16_tile_edges(m, ka, nb):
    """dW = a^T g over m rows on gemm_sm90_kernel's row-split product: the
    partial tiles of 1, 3 and 7 chunks (whole 64-row k-steps; at m <= 128
    some chunks lie past the rows and come back as zeros) add up to the fp32
    product, and the wrapper's own split rounds it once."""
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(m + ka + 2 * nb)
    a, gr = _rn(g, bf, m, ka), _rn(g, bf, m, nb)
    ref = a.float().t() @ gr.float()
    ch = fl._Chain("test", a, 1)
    for splits in (1, 3, 7):
        part = torch.full((splits, ka, nb), float("nan"), device="cuda")
        ch._ok(ch.lib.rz_wgrad(a.data_ptr(), gr.data_ptr(), part.data_ptr(), m, ka, nb, splits,
                               1, ch.stream))
        chunk = -(-m // (64 * splits)) * 64  # ceil(m / splits) in whole 64-row k-steps
        for z in range(splits):
            rows = slice(z * chunk, min(m, (z + 1) * chunk))
            want = a[rows].float().t() @ gr[rows].float()
            _close_share(part[z], want, 1e-4, 1e-4)
        _close32(part.sum(0), ref)
    _close16(ch.wgrad(a, gr), ref)


@pytest.mark.parametrize("m", [1370, 2740])
@pytest.mark.parametrize("k", sorted(CHAIN_ROUTES))
def test_backward_chain_bf16_full_width_repeats_its_bits(k, m):
    """K6, K8 and K9 in bf16 at the model's widths (D 768, F 3072): a second
    backward gives the same bits (fixed-order sums, no atomics), and both meet
    chip_smoke.py's bf16 tolerance against the twin (2^-7 of the largest
    |reference| entry plus 2^-7 relative)."""
    g = torch.Generator(device="cuda").manual_seed(m)
    call, plain, names = _chain_call(k, g, torch.bfloat16, m, 768, 3072)
    first, second = call(), call()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for got, want, name in zip(first, plain(), names):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape, name
        _close_share(got, want, 2.0**-7, 2.0**-7)


# The row passes that sum columns run a grid of a fixed number of blocks an SM
# (fused_layer.py: 2 for the LayerNorm backward, 4 for scale_colsum), each block
# over one range of rows (row_partition): row counts on both sides of each edge
# (one row, fewer rows than blocks, one row a block, the first two-row block),
# ragged ones, in both dtypes at D 128, F 256 against the twins at
# _check_grads's tolerance, and a second backward's bits
def _edge_rows(edge, sms):
    if isinstance(edge, int):
        return edge
    per_sm, offset = edge
    return per_sm * sms + offset


PARTITION_EDGES = [1, 100, (2, -1), (2, 0), (2, 1), (4, 0), (4, 1), 257, 1370]


@pytest.mark.parametrize("edge", PARTITION_EDGES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", sorted(CHAIN_ROUTES))
def test_backward_chain_partition_edges(k, dtype, edge):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    m = _edge_rows(edge, sms)
    g = torch.Generator(device="cuda").manual_seed(m)
    call, plain, names = _chain_call(k, g, dtype, m, 128, 256)
    first, second = call(), call()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _check_grads(first, plain(), dtype, names)


def test_backward_chain_k6_bf16_at_the_training_rows():
    """bf16 K6 at the training step's 64 images x 1370 tokens (87 680 rows)
    and the model's width: chip_smoke.py's tolerance (2^-7 of the largest
    |reference| entry plus 2^-7 relative), the same bits from a second call."""
    g = torch.Generator(device="cuda").manual_seed(6)
    call, plain, names = _chain_call("K6", g, torch.bfloat16, 64 * 1370, 768, 3072)
    first, second = call(), call()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for got, want, name in zip(first, plain(), names):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape, name
        _close_share(got, want, 2.0**-7, 2.0**-7)


# (partial rows, columns): the two-level reduce's shapes (few columns, many
# partial rows: K6's LayerNorm sums and db at 64 images, the old 32-row
# partials, K8's dgelu column partials) and the one-level kernel's (K16's batch
# sum of d(bias), many columns and few rows; a dW partial tile)
REDUCE_SHAPES = [(263, 2 * 768), (527, 2304), (2740, 768), (685, 3072), (4, 12 * 64 * 64),
                 (7, 768 * 2304)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,n", REDUCE_SHAPES)
def test_reduce_matches_an_fp64_sum(s, n, dtype):
    """_Chain.reduce (two levels where fl.reduce_split says so, else one) and
    the two-level entry point called directly at both kinds of shape, against
    an fp64 torch.sum: fp32 sums of s terms, off by at most s 2^-23 of the sum
    of |terms|, then one rounding to the operand type; the same bits again."""
    g = torch.Generator(device="cuda").manual_seed(s)
    part = torch.randn((s, n), generator=g, device="cuda")
    ch = fl._Chain("test", part.to(dtype), 1 if dtype == torch.bfloat16 else 0)
    ref = part.double().sum(0)
    bound = s * 2.0**-23 * part.double().abs().sum(0) + ref.abs() * (
        2.0**-8 if dtype == torch.bfloat16 else 0.0)
    per = fl.reduce_split(s, n, ch.sms)

    def two_level(p):
        out = ch.t(n)
        scratch = ch.f32(-(-s // p), n)
        ch._ok(ch.lib.rz_reduce_two_level(part.data_ptr(), scratch.data_ptr(), out.data_ptr(), s,
                                          n, p, ch.code, ch.stream))
        return out

    calls = [lambda: ch.reduce(part, s, (n,)), lambda: two_level(per or max(1, s // 2))]
    for call in calls:
        out = call()
        assert out.dtype == dtype
        assert ((out.double() - ref).abs() <= bound).all()
        assert torch.equal(out, call())


@pytest.mark.parametrize("m", [1, 257, 1370])
@pytest.mark.parametrize("d", [64, 768])
@pytest.mark.parametrize("dtype,u_f32", [(torch.float32, True), (torch.bfloat16, True),
                                         (torch.bfloat16, False)])
def test_ln_rows_statistics_equal_the_recomputed_ones(dtype, u_f32, d, m):
    """The mean and rstd ln_rows_kernel stores per row are those of the row in
    fp64 (within fp32 sums of d terms), and the LayerNorm backward that reads
    them writes the same bits as the one that computes them itself: the
    stored statistics equal the recomputed ones."""
    g = torch.Generator(device="cuda").manual_seed(m + d)
    u = torch.randn((m, d), generator=g, device="cuda") * 2.0 + 0.5
    u = u if u_f32 else u.to(dtype)
    scale, bias = _rn(g, dtype, d, std=0.1, mean=1.0), _rn(g, dtype, d, std=0.1)
    dh = torch.randn((m, d), generator=g, device="cuda")
    ch = fl._Chain("test", scale, 1 if dtype == torch.bfloat16 else 0)
    _, _, stats = ch.ln_rows(u, scale, bias, 1e-6, want_stats=True)
    u64 = u.double()
    mean = u64.mean(-1)
    rstd = torch.rsqrt(((u64 - mean[:, None]) ** 2).mean(-1) + 1e-6)
    torch.testing.assert_close(stats[:, 0].double(), mean, rtol=0, atol=1e-6)
    torch.testing.assert_close(stats[:, 1].double(), rstd, rtol=2e-6, atol=0)
    sums = fl._SUM_DH_XN | fl._SUM_DH | fl._SUM_D_LS
    stored = ch.ln_bwd(u, dh, scale, 1e-6, sums=sums, stats=stats, want_f32=True)
    recomputed = ch.ln_bwd(u, dh, scale, 1e-6, sums=sums, want_f32=True)
    assert torch.equal(stored[0], recomputed[0]) and torch.equal(stored[2], recomputed[2])
    assert all(torch.equal(a, b) for a, b in zip(stored[3], recomputed[3]))


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


# bf16 at L <= 64 runs csrc/flash_bias_small.cu (tiles of 32 or 64 tokens): lengths
# of one token, no multiple of 16 or 8, at and across 32 and 64, kv_len < L, odd
# batches, 512 sentences in chunks that do not divide it evenly (d(bias) summed
# within and across chunks); 130 runs the tiled kernels of flash_attention.cu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,l,kv_len", [(5, 17, None), (40, 32, None), (3, 37, None), (6, 64, 50),
                                        (3, 130, None), (1, 1, None), (7, 17, 12), (7, 31, None),
                                        (512, 32, None), (3, 33, 20), (13, 64, 50), (7, 63, 61),
                                        (1, 32, 17)])
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


def test_flash_attention_bf16_fully_padded_sentence_is_nan_like_the_twin():
    """The short-sentence kernels at L = 32: a sentence whose mask is all
    padding is NaN in the output and in dq, dk, dv, and d(bias), which sums
    over it, is NaN everywhere, as from the twin; the other sentences match."""
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, cot = (_rn(g, torch.bfloat16, 3, 32, 2, 64) for _ in range(4))
    bias, neg = _bias_and_mask(g, torch.bfloat16, 3, 32, 2)
    neg[1] = torch.finfo(torch.bfloat16).min
    out = fa.flash_attention_bias(q, k, v, bias, neg)
    ref = fa.flash_attention_bias_plain(q, k, v, bias, neg)
    assert torch.isnan(out[1]).all() and torch.isnan(ref[1]).all()
    _check(out[[0, 2]], ref[[0, 2]], torch.bfloat16, atol=2.0**-9 * ref[[0, 2]].float().abs().max().item())
    got = fa.flash_attention_bias_bwd(q, k, v, bias, neg, cot)
    want = fa.flash_attention_bias_bwd_plain(q, k, v, bias, neg, cot)
    for a, b in zip(got[:3], want[:3]):
        assert torch.isnan(a[1]).all() and torch.isnan(b[1]).all()
    _check_grads([t[[0, 2]] for t in got[:3]], [t[[0, 2]] for t in want[:3]], torch.bfloat16,
                 ("dq", "dk", "dv"))
    assert torch.isnan(got[3]).all() and torch.isnan(want[3]).all()


def test_bias_attention_runs_the_short_sentence_kernels_in_bf16():
    """K15 / K16 in bf16 at L <= 64 run flash_bias_fwd_small_kernel, and
    flash_bias_bwd_small_kernel with the fixed-order reduce, and nothing
    else (no statistics kernel); at L = 130 the tiled kernels of
    flash_attention.cu."""
    g = torch.Generator(device="cuda").manual_seed(8)
    for l, small in ((32, True), (64, True), (130, False)):
        q, k, v, cot = (_rn(g, torch.bfloat16, 3, l, 2, 64) for _ in range(4))
        bias, neg = _bias_and_mask(g, torch.bfloat16, 3, l, 2)
        assert fa.small_bias(q) == small
        names = _device_kernels(lambda: fa.flash_attention_bias(q, k, v, bias, neg))
        want = ["flash_bias_fwd_small_kernel"] if small else ["fwd_kernel<"]
        assert len(names) == 1 and want[0] in names[0], names
        names = _device_kernels(lambda: fa.flash_attention_bias_bwd(q, k, v, bias, neg, cot))
        want = (["flash_bias_bwd_small_kernel", "reduce_parts_kernel"] if small else
                ["bwd_stats_kernel<", "bwd_dkdv_kernel<", "bwd_dq_kernel<", "bwd_dbias_kernel<",
                 "reduce_parts_kernel"])
        assert len(names) == len(want) and all(any(w in n for n in names) for w in want), names


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


@pytest.mark.parametrize("flash", [False, True])
def test_exported_program_runs_the_kernels_by_name(flash, tmp_path):
    """A bf16 program of radzero_torch.eval.export, loaded back, runs the
    serving kernels by name (K1 / K3's row pass and gemm_sm90_kernel, K2's
    fwd_sm90_kernel, K5's vlc_scores_sm90_kernel; with fused_tower=False and
    TextConfig(attn_impl="flash") also K13 on fwd_sm90_kernel and K15 on
    flash_bias_fwd_small_kernel), no upload from host memory and no softmax
    beyond compute_logits', the eager call's launch counts, and the same bits."""
    from radzero_torch.eval.export import export_zero_shot, load_zero_shot
    from radzero_torch.eval.serving import ImageSpec, serving_params
    from radzero_torch.models import configuration as tconf
    from radzero_torch.models.radzero import compute_logits, init_radzero
    from radzero_torch.ops import registry
    from radzero_torch.ops.layers import normalize_pixels

    d = 128
    cfg = tconf.RadZeroConfig(
        vision=tconf.ViTConfig(hidden_size=d, num_hidden_layers=1, num_attention_heads=2,
                               mlp_ratio=2.0, patch_size=14, pretrain_img_size=56, img_size=56),
        text=tconf.TextConfig(hidden_size=d, num_hidden_layers=1, num_attention_heads=2,
                              intermediate_size=256, vocab_size=101, max_position_embeddings=40,
                              attn_impl="flash" if flash else "xla"),
        align=tconf.AlignConfig(hidden_size=d, num_hidden_layers=1, num_attention_heads=2,
                                mlp_ratio=2.0),
        loss=tconf.LossConfig(hidden_dim=d))
    params = init_radzero(torch.Generator(device="cuda").manual_seed(0), cfg)
    export_zero_shot(params, cfg, str(tmp_path), batch_size=2, n_prompts=3, max_tokens=8,
                     dtype=torch.bfloat16, from_uint8=True, channels=1, fused_tower=not flash)
    runner, _ = load_zero_shot(str(tmp_path))
    g = torch.Generator(device="cuda").manual_seed(1)
    pv = torch.randint(0, 256, (2, 56, 56, 1), generator=g, device="cuda", dtype=torch.uint8)
    ids = torch.randint(3, 101, (3, 8), generator=g, device="cuda")
    mask = torch.ones((3, 8), dtype=torch.long, device="cuda")
    p = serving_params(params, cfg, torch.bfloat16, torch.device("cuda"), 56)

    def eager():
        with torch.inference_mode():
            x = normalize_pixels(pv.expand(2, 56, 56, 3), ImageSpec().mean, ImageSpec().std,
                                 dtype=torch.bfloat16)
            return compute_logits(p, cfg, x, ids, mask, dtype=torch.bfloat16,
                                  fused_towers=not flash)

    counters = (fl.fused_preattn, fl.flash_attention_packed, fl.fused_postattn,
                fl.fused_mpnet_post, vf.vlcabs_fused, fa.flash_attention, fa.flash_attention_bias)

    def launches(fn):
        before = [c.launches for c in counters]
        out = fn()
        return out, [c.launches - b for c, b in zip(counters, before)]

    registry.reset_calls()
    (logits, scores), program_n = launches(lambda: runner(pv, ids, mask))
    ref, eager_n = launches(eager)
    assert program_n == eager_n and sum(registry.calls.values()) == sum(eager_n)
    assert torch.equal(logits, ref["logits"]) and torch.equal(scores, ref["similarity_scores"])
    names = _device_kernels(lambda: runner(pv, ids, mask))
    eager_names = _device_kernels(eager)
    want = ["row_layernorm_kernel", "gemm_sm90_kernel<0, 0>", "fwd_sm90_kernel",
            "vlc_scores_sm90_kernel"] + (["flash_bias_fwd_small_kernel"] if flash else [])
    assert all(any(w in n for n in names) for w in want), names
    # no upload from host memory on a call, and no twin's softmax in a kernel's place
    # (other library kernels may differ: the graph lays out a few copies otherwise)
    assert not any("Memcpy HtoD" in n for n in names), names
    assert (sum("softmax" in n.lower() for n in names)
            == sum("softmax" in n.lower() for n in eager_names)), names
