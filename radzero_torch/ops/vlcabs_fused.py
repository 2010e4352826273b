"""K5 and K10-K12: the fused VL-CABS kernels (port of
radzero_tpu/ops/pallas_vlcabs.py).

Per image, with queries already l2-normalised:

    tn     = t * rsqrt(sum(t^2) + 1e-24)     (rounded to the operand type)
    s      = qn @ tn^T / tau                 (fp32)
    e      = exp(s - rowmax(s))              (rounded to the operand type)
    agg    = e @ tn                          (fp32)
    logits = (qn . agg) / max(|agg|, 1e-12)

- :func:`vlcabs_fused` (K5, serving): logits and the raw pre-softmax score
  maps in one pass. Forward-only: under gradients it raises and points to
  :func:`vlcabs_fused_train`.
- :func:`vlcabs_fused_train` (training): logits only, a
  ``torch.autograd.Function``. Its forward launches K10
  (:func:`vlcabs_train_forward`), which on the card also writes the
  statistics the backward reads: the row max of s (B, N) and g (B, N, D),
  fp32. Its backward runs K11 (dq and dtau) and K12 (the gradient of the
  normalised tokens) in one pass over their shared stages
  (:func:`vlcabs_train_bwd`; alone they are :func:`vlcabs_train_bwd_dq` and
  :func:`vlcabs_train_bwd_dtn`) and then applies the row-normalise VJP dt =
  (dtn - (dtn.tn) tn) / |t| in plain torch, as the JAX package leaves it to
  XLA. The fp32 (B, N, L) score tensor never reaches device memory: the
  backward recomputes s from the tokens; in bf16 e and dc are written once,
  rounded, by K12's first phase (:func:`vlcabs_dtn_phase1`) and read by
  K11's product and K12's second phase.

The backward formulas, with g = e @ tn (the softmax denominator cancels in
the cosine) and the cotangent dz (N, B):

    z  = (qn . g) / |g|            dg = dz (qn - z ghat) / |g|
    de = dg @ tn^T                 ds = de * e           dc = ds / tau
    dqn  = sum_b dc @ tn + dz ghat
    dtau = -sum dc * (s - rowmax(s))     (sum_l dc = 0 per row, so the shift
                                          is free and keeps tiny tau stable)
    dtn  = dc^T @ qn + e^T @ dg

Rounding points, kernels and twins alike: tn, e, dg and dc are rounded to
the operand type before each product; s, the exponent, g, the norm, z, de,
ds and every accumulator are fp32. One difference from the TPU kernel:
that one adds K12's partial sums into a buffer of the tokens' dtype once
per 128-query block; here dtn is accumulated in fp32 over all queries and
rounded to the tokens' dtype once.

Each wrapper runs its plain twin (``*_plain``) on a CPU tensor and its CUDA
kernel (``csrc/vlcabs_fused.cu``, ``csrc/vlcabs_train.cu``,
``csrc/vlcabs_sm90.cu``) on a CUDA tensor; ``<wrapper>.launches`` counts
kernel launches, one a call of an entry point whatever its stages. In bf16
K5 and K10 are one forward split over tokens (:func:`vlcabs_forward_stages`):
the tokens' row pass (:func:`vlcabs_rownorm`), s and each row's maximum per
128-token tile on wgmma (:func:`vlcabs_fwd_scores`), a row pass writing e
into a zero-padded (B, Np, Lp) buffer, the row max and, for K5, the map
(:func:`vlcabs_fwd_rows`), g = e tn per image on the Hopper GEMM
(:func:`vlcabs_fwd_g`), and the logits (:func:`vlcabs_logits`); the row max
and g are K10's statistics. In fp32 K5 is one kernel that walks L in tiles
with a running max (the cosine is invariant to scaling agg, so that is
exact) and K10 takes the row max in a first sweep. On the card K11
and K12 compose stages that can each be held against a twin: the tokens'
row pass (:func:`vlcabs_rownorm`), the backward's row pass
(:func:`vlcabs_bwd_rows`: dg and dz ghat from g), then in bf16 K12's first
Hopper phase (:func:`vlcabs_dtn_phase1`: e and dc, and for K11 each work
item's share of dtau), K11's product over its dc with the reduce
(:func:`vlcabs_dq_from_ce`) and K12's second phase
(:func:`vlcabs_dtn_phase2`), in fp32 K11's dq kernel and reduce and K12's
tiled kernel; :func:`vlcabs_train_backward_stats_plain` runs the bf16 route
twin by twin.
"""

from __future__ import annotations

import torch

from radzero_torch.ops import _build
from radzero_torch.ops._checks import check_operands, exported, forbid_grad, on_cuda

_LOG2E = 1.4426950408889634


def _scores(queries_normed, tn):
    """qn tn^T in fp32, (B, N, L) laid out as the kernels write it: einsum's
    own layout would send exp2 down another vector path on the CPU."""
    return torch.einsum("nd,bld->bnl", queries_normed.float(), tn.float()).contiguous()


def vlcabs_fused_plain(queries_normed, tokens, tau):
    cdt = tokens.dtype
    t32 = tokens.float()
    tn = (t32 * torch.rsqrt(t32.square().sum(-1, keepdim=True) + 1e-24)).to(cdt)
    s = _scores(queries_normed, tn)
    s = s * (1.0 / tau.float().reshape(()))
    e = torch.exp2((s - s.amax(-1, keepdim=True)) * _LOG2E).to(cdt)
    agg = e.float() @ tn.float()                                # (B, N, D)
    num = (queries_normed.float() * agg).sum(-1)
    norm = agg.square().sum(-1).sqrt()
    logits = num / norm.clamp_min(1e-12)                        # (B, N)
    return logits.T, s


def vlcabs_fused(queries_normed, tokens, tau):
    """(N, D) l2-normalised queries, (B, L, D) tokens, scalar fp32 tau ->
    (logits (N, B) fp32, scores (B, N, L) fp32). On the card bf16 runs
    :func:`vlcabs_forward_stages` (D % 8 == 0), fp32 one kernel (D <= 1024)."""
    if (op := exported("vlcabs_fused")) is not None:
        return op(queries_normed, tokens, tau)
    forbid_grad("vlcabs_fused (K5)", "use vlcabs_fused_train, whose backward runs K11 and K12",
                queries_normed, tokens, tau)
    if not on_cuda(tokens):
        return vlcabs_fused_plain(queries_normed, tokens, tau)
    n = queries_normed.shape[0]
    b, l, d = tokens.shape
    code = check_operands("vlcabs_fused", tokens, queries_normed=((n, d), queries_normed))
    tau = tau.reshape(1)
    if tau.dtype != torch.float32 or tau.device != tokens.device:
        raise TypeError("vlcabs_fused: tau must be a float32 tensor on the tokens' device")
    if tokens.dtype == torch.bfloat16:
        if d % 8:
            raise ValueError(f"vlcabs_fused: the bf16 kernels take D % 8 == 0, got {d}")
        logits, scores, _ = vlcabs_forward_stages(queries_normed, tokens, tau, maps=True)
        vlcabs_fused.launches += 1
        return logits, scores
    if d > 1024:
        raise ValueError(f"vlcabs_fused: the kernel takes D <= 1024, got {d}")
    scores = torch.empty((b, n, l), dtype=torch.float32, device=tokens.device)
    logits = torch.empty((n, b), dtype=torch.float32, device=tokens.device)
    lib = _build.load()
    err = lib.rz_vlcabs_fused(
        queries_normed.data_ptr(), tokens.data_ptr(), tau.data_ptr(), scores.data_ptr(),
        logits.data_ptr(), n, b, l, d, code, _build.stream_ptr(tokens),
    )
    _build.check(err, "vlcabs_fused")
    vlcabs_fused.launches += 1
    return logits, scores


vlcabs_fused.launches = 0


# ---------------------------------------------------------------------------
# The stages of the bf16 forward of K5 and K10 (csrc/vlcabs_sm90.cu) and their
# plain twins. Each stage wrapper runs its twin on a CPU tensor and its kernel
# on a CUDA tensor; the stages count no launches of their own (K5 and K10,
# which compose them, do).
# ---------------------------------------------------------------------------

_TOKEN_TILE = 128  # tokens of a tile maximum: phase 1's work item


def _tiles(l):
    return -(-l // _TOKEN_TILE)


def vlcabs_fwd_scores_plain(queries_normed, tn, tau):
    n = queries_normed.shape[0]
    b, l, _ = tn.shape
    s = _scores(queries_normed, tn) * (1.0 / tau.float().reshape(()))
    padded = torch.nn.functional.pad(s, (0, _tiles(l) * _TOKEN_TILE - l), value=-torch.inf)
    tmax = padded.reshape(b, n, _tiles(l), _TOKEN_TILE).amax(-1)
    return torch.nn.functional.pad(s, (0, _pad64(l) - l)), tmax


def vlcabs_fwd_scores(queries_normed, tn, tau):
    """The forward's first phase: (N, D) queries, the normalised tokens tn
    (B, L, D) and tau (1,) -> (s = qn tn^T / tau (B, N, Lp) fp32, Lp L rounded
    up to 64, zeros in [L, Lp); tmax (B, N, ceil(L / 128)) fp32: each row's
    maximum over each 128-token tile of real tokens). On the card bf16 only:
    per (image, 128 queries, 128 tokens) item, S on wgmma fed by a TMA ring,
    the maximum from the accumulators, s stored by TMA."""
    if not on_cuda(tn):
        return vlcabs_fwd_scores_plain(queries_normed, tn, tau)
    n, d = queries_normed.shape
    b, l, _ = tn.shape
    _check_bf16("vlcabs_fwd_scores", tn, queries_normed=((n, d), queries_normed))
    _check_f32("vlcabs_fwd_scores", tn.device, tau=((1,), tau))
    s = torch.empty((b, n, _pad64(l)), dtype=torch.float32, device=tn.device)
    tmax = torch.empty((b, n, _tiles(l)), dtype=torch.float32, device=tn.device)
    _build.check(_build.load().rz_vlcabs_fwd_scores(
        queries_normed.data_ptr(), tn.data_ptr(), tau.data_ptr(), s.data_ptr(), tmax.data_ptr(),
        n, b, l, _pad64(l), d, _build.stream_ptr(tn)), "vlcabs_fwd_scores")
    return s, tmax


def vlcabs_fwd_rows_plain(s, tmax, l, dtype, maps=False):
    b, n, lp = s.shape
    real = s[..., :l].contiguous()
    m = tmax.amax(-1)
    e = torch.zeros((b, _pad64(n), lp), dtype=dtype, device=s.device)
    e[:, :n, :l] = torch.exp2((real - m[..., None]) * _LOG2E).to(dtype)
    return e, m, real if maps else None


def vlcabs_fwd_rows(s, tmax, l, dtype=torch.bfloat16, maps=False):
    """The forward's row pass: s (B, N, Lp) and tmax from
    :func:`vlcabs_fwd_scores`, L real tokens -> (e (B, Np, Lp) in ``dtype``,
    Np N rounded up to 64: e = exp(s - rowmax) rounded, zeros past N and L;
    the row max (B, N) fp32; with ``maps`` the map (B, N, L) fp32, s without
    its padding, else None). On the card bf16 only, a warp a row."""
    if not on_cuda(s):
        return vlcabs_fwd_rows_plain(s, tmax, l, dtype, maps)
    b, n, lp = s.shape
    if dtype != torch.bfloat16:
        raise TypeError(f"vlcabs_fwd_rows: the card's row pass writes bfloat16, not {dtype}")
    if lp != _pad64(l):
        raise ValueError(f"vlcabs_fwd_rows: s has {lp} columns, expected {_pad64(l)} for L {l}")
    _check_f32("vlcabs_fwd_rows", s.device, s=((b, n, lp), s), tmax=((b, n, _tiles(l)), tmax))
    e = torch.empty((b, _pad64(n), lp), dtype=dtype, device=s.device)
    rowmax = torch.empty((b, n), dtype=torch.float32, device=s.device)
    scores = torch.empty((b, n, l), dtype=torch.float32, device=s.device) if maps else None
    _build.check(_build.load().rz_vlcabs_fwd_rows(
        s.data_ptr(), tmax.data_ptr(), e.data_ptr(), rowmax.data_ptr(), _ptr(scores), n,
        _pad64(n), b, l, lp, _build.stream_ptr(s)), "vlcabs_fwd_rows")
    return e, rowmax, scores


def vlcabs_fwd_g_plain(e, tn, n):
    l = tn.shape[1]
    return e[:, :n, :l].float().contiguous() @ tn.float()


def vlcabs_fwd_g(e, tn, n):
    """The forward's second phase: g[b] = e[b] tn[b] -> (B, N, D) fp32 from
    :func:`vlcabs_fwd_rows`' e (B, Np, Lp) and tn (B, L, D), summed in fp32.
    On the card bf16 only: gemm_sm90_kernel's GEMM_FWD layout with an image
    coordinate (csrc/gemm_sm90.cu)."""
    if not on_cuda(e):
        return vlcabs_fwd_g_plain(e, tn, n)
    b, l, d = tn.shape
    np_, lp = _pad64(n), _pad64(l)
    _check_bf16("vlcabs_fwd_g", tn, e=((b, np_, lp), e))
    g = torch.empty((b, n, d), dtype=torch.float32, device=tn.device)
    _build.check(_build.load().rz_vlcabs_fwd_g(
        e.data_ptr(), tn.data_ptr(), g.data_ptr(), n, np_, b, l, lp, d, _build.stream_ptr(tn)),
        "vlcabs_fwd_g")
    return g


def vlcabs_logits_plain(queries_normed, g):
    num = (queries_normed.float() * g).sum(-1)
    norm = g.square().sum(-1).sqrt()
    return (num / norm.clamp_min(1e-12)).T


def vlcabs_logits(queries_normed, g):
    """(N, D) queries and g (B, N, D) fp32 -> logits (N, B) fp32, z = qn . g /
    max(|g|, 1e-12): a warp an (image, query), the arithmetic and order of the
    backward's row pass (:func:`vlcabs_bwd_rows`), so the two z agree bit for
    bit."""
    if not on_cuda(g):
        return vlcabs_logits_plain(queries_normed, g)
    (b, n, d), dev = g.shape, g.device
    code = check_operands("vlcabs_logits", queries_normed)
    _check_f32("vlcabs_logits", dev, g=((b, n, d), g))
    logits = torch.empty((n, b), dtype=torch.float32, device=dev)
    _build.check(_build.load().rz_vlcabs_logits(
        queries_normed.data_ptr(), g.data_ptr(), logits.data_ptr(), n, b, d, code,
        _build.stream_ptr(g)), "vlcabs_logits")
    return logits


def vlcabs_forward_stages(queries_normed, tokens, tau, maps=False):
    """The forward as the card runs it in bf16, stage by stage -> (logits (N,
    B), with ``maps`` the map s (B, N, L) else None, (row max (B, N), g (B, N,
    D))), all fp32; on CPU tensors the stage twins, rounding where the kernels
    round."""
    tn = vlcabs_rownorm(tokens)
    s, tmax = vlcabs_fwd_scores(queries_normed, tn, tau)
    e, rowmax, scores = vlcabs_fwd_rows(s, tmax, tokens.shape[1], tokens.dtype, maps)
    del s
    g = vlcabs_fwd_g(e, tn, queries_normed.shape[0])
    return vlcabs_logits(queries_normed, g), scores, (rowmax, g)


# ---------------------------------------------------------------------------
# K10-K12: the differentiable training variant, logits only
# ---------------------------------------------------------------------------

def _check_train_operands(name, queries_normed, tokens, tau):
    n, d = queries_normed.shape
    b, l, _ = tokens.shape
    code = check_operands(name, tokens, queries_normed=((n, d), queries_normed))
    if tau.dtype != torch.float32 or tau.device != tokens.device or tau.numel() != 1:
        raise TypeError(f"{name}: tau must be one float32 value on the tokens' device")
    if d % 64 or d > 768:
        raise ValueError(f"{name}: the kernel takes D % 64 == 0 and D <= 768, got {d}")
    return n, b, l, d, code


def _normalized_tokens(tokens):
    t32 = tokens.float()
    inv_t = torch.rsqrt(t32.square().sum(-1, keepdim=True) + 1e-24)
    return t32 * inv_t, inv_t


def _pad64(n):
    return -(-n // 64) * 64


def _ptr(t):
    return None if t is None else t.data_ptr()


def vlcabs_train_stats_plain(queries_normed, tokens, tau):
    """K10's statistics for the backward: (row max of s (B, N), g = e @ tn
    (B, N, D)), fp32."""
    cdt = tokens.dtype
    tn = _normalized_tokens(tokens)[0].to(cdt).float()
    s = _scores(queries_normed, tn) * (1.0 / tau.float().reshape(()))
    m = s.amax(-1)
    e = torch.exp2((s - m[..., None]) * _LOG2E)
    return m, e.to(cdt).float() @ tn


def vlcabs_train_forward_plain(queries_normed, tokens, tau, *, with_stats=False):
    logits = vlcabs_fused_plain(queries_normed, tokens, tau)[0]
    if not with_stats:
        return logits
    return logits, vlcabs_train_stats_plain(queries_normed, tokens, tau)


def vlcabs_train_forward(queries_normed, tokens, tau, *, with_stats=False):
    """K10: (N, D) l2-normalised queries, (B, L, D) tokens, fp32 tau ->
    logits (N, B) fp32. No map is returned. With ``with_stats`` -> (logits,
    (row max (B, N), g (B, N, D))), the fp32 statistics that the backward
    kernels read (:func:`vlcabs_fused_train` keeps them). On the card bf16
    runs :func:`vlcabs_forward_stages`, fp32 the tokens' row pass and one
    kernel. No tape: differentiate through :func:`vlcabs_fused_train`."""
    forbid_grad("vlcabs_train_forward (K10)", "call vlcabs_fused_train, the autograd function",
                queries_normed, tokens, tau)
    if not on_cuda(tokens):
        return vlcabs_train_forward_plain(queries_normed, tokens, tau, with_stats=with_stats)
    n, b, l, d, code = _check_train_operands("vlcabs_train_forward", queries_normed, tokens, tau)
    if tokens.dtype == torch.bfloat16:  # the statistics come with every call
        logits, _, stats = vlcabs_forward_stages(queries_normed, tokens, tau.reshape(1))
        vlcabs_train_forward.launches += 1
        return (logits, stats) if with_stats else logits
    tn = torch.empty_like(tokens)
    logits = torch.empty((n, b), dtype=torch.float32, device=tokens.device)
    rowmax = g = None
    if with_stats:
        rowmax = torch.empty((b, n), dtype=torch.float32, device=tokens.device)
        g = torch.empty((b, n, d), dtype=torch.float32, device=tokens.device)
    lib = _build.load()
    err = lib.rz_vlcabs_train_fwd(
        queries_normed.data_ptr(), tokens.data_ptr(), tau.data_ptr(), tn.data_ptr(),
        logits.data_ptr(), _ptr(rowmax), _ptr(g), n, b, l, d, code, _build.stream_ptr(tokens),
    )
    _build.check(err, "vlcabs_train_forward")
    vlcabs_train_forward.launches += 1
    return (logits, (rowmax, g)) if with_stats else logits


vlcabs_train_forward.launches = 0


def _bwd_common_plain(queries_normed, tokens, tau, dz):
    """The shared recompute of both backward kernels (the formulas of the
    module docstring), whole arrays at once -> fp32 pieces."""
    cdt = tokens.dtype
    q32 = queries_normed.float()
    tn = _normalized_tokens(tokens)[0].to(cdt).float()          # (B, L, D)
    inv_tau = 1.0 / tau.float().reshape(())
    s = torch.einsum("nd,bld->bnl", q32, tn) * inv_tau
    s_shift = s - s.amax(-1, keepdim=True)
    e = torch.exp2(s_shift * _LOG2E)
    g = e.to(cdt).float() @ tn                                  # (B, N, D)
    norm = g.square().sum(-1, keepdim=True).sqrt().clamp_min(1e-12)
    ghat = g / norm
    z = (q32 * ghat).sum(-1, keepdim=True)
    dzc = dz.float().T[..., None]                               # (B, N, 1)
    dg = dzc * (q32 - z * ghat) / norm
    de = dg.to(cdt).float() @ tn.transpose(1, 2)                # (B, N, L)
    dc = de * e * inv_tau
    return q32, tn, s_shift, e, dzc, dg, ghat, dc


def vlcabs_train_bwd_dq_plain(queries_normed, tokens, tau, dz):
    cdt = tokens.dtype
    _, tn, s_shift, _, dzc, _, ghat, dc = _bwd_common_plain(queries_normed, tokens, tau, dz)
    dtau = -(dc * s_shift).sum()
    dq = (dc.to(cdt).float() @ tn + dzc * ghat).sum(0)
    return dq.to(queries_normed.dtype), dtau.reshape(1)


def vlcabs_train_bwd_dtn_plain(queries_normed, tokens, tau, dz):
    cdt = tokens.dtype
    q32, _, _, e, _, dg, _, dc = _bwd_common_plain(queries_normed, tokens, tau, dz)
    dtn = (torch.einsum("bnl,nd->bld", dc.to(cdt).float(), q32)
           + torch.einsum("bnl,bnd->bld", e.to(cdt).float(), dg.to(cdt).float()))
    return dtn.to(cdt)


# ---------------------------------------------------------------------------
# The stages of the card's backward (csrc/vlcabs_train.cu, csrc/vlcabs_sm90.cu)
# and their plain twins. Each stage wrapper runs its twin on a CPU tensor and
# its kernel on a CUDA tensor; the stages count no launches of their own (K11
# and K12, which compose them, do).
# ---------------------------------------------------------------------------

def vlcabs_rownorm(tokens):
    """tn = tokens * rsqrt(sum(tokens^2) + 1e-24), rounded to the tokens' dtype."""
    if not on_cuda(tokens):
        return _normalized_tokens(tokens)[0].to(tokens.dtype)
    code = check_operands("vlcabs_rownorm", tokens)
    tn = torch.empty_like(tokens)
    _build.check(_build.load().rz_vlcabs_rownorm(
        tokens.data_ptr(), tn.data_ptr(), tokens.numel() // tokens.shape[-1], tokens.shape[-1],
        code, _build.stream_ptr(tokens)), "vlcabs_rownorm")
    return tn


def vlcabs_bwd_rows_plain(queries_normed, g, dz):
    q32 = queries_normed.float()
    norm = g.square().sum(-1, keepdim=True).sqrt().clamp_min(1e-12)
    ghat = g / norm
    z = (q32 * ghat).sum(-1, keepdim=True)
    dzc = dz.float().T[..., None]                               # (B, N, 1)
    dg = dzc * (q32 - z * ghat) / norm
    return dg.to(queries_normed.dtype), dzc * ghat


def vlcabs_bwd_rows(queries_normed, g, dz, *, want_dq_part=False):
    """The backward's row pass, from K10's g (B, N, D) fp32 and the cotangent
    dz (N, B) -> (dg (B, N, D) in the queries' dtype, dz ghat (B, N, D) fp32
    or None), ghat = g / |g|: one warp per (image, query) row."""
    if not on_cuda(g):
        dg, dq_part = vlcabs_bwd_rows_plain(queries_normed, g, dz)
        return dg, dq_part if want_dq_part else None
    (b, n, d), dev = g.shape, g.device
    code = check_operands("vlcabs_bwd_rows", queries_normed)
    _check_f32("vlcabs_bwd_rows", dev, g=((b, n, d), g), dz=((n, b), dz))
    dg = torch.empty((b, n, d), dtype=queries_normed.dtype, device=dev)
    dq_part = torch.empty((b, n, d), dtype=torch.float32, device=dev) if want_dq_part else None
    _build.check(_build.load().rz_vlcabs_bwd_rows(
        queries_normed.data_ptr(), g.data_ptr(), dz.data_ptr(), dg.data_ptr(), _ptr(dq_part),
        n, b, d, code, _build.stream_ptr(g)), "vlcabs_bwd_rows")
    return dg, dq_part


def vlcabs_dtn_phase1_plain(queries_normed, tn, dg, rowmax, tau, with_dtau=False):
    cdt = tn.dtype
    n = queries_normed.shape[0]
    b, l, _ = tn.shape
    inv_tau = 1.0 / tau.float().reshape(())
    tn32 = tn.float()
    s = torch.einsum("nd,bld->bnl", queries_normed.float(), tn32) * inv_tau
    e = torch.exp2((s - rowmax[..., None]) * _LOG2E)
    dc = (dg.float() @ tn32.transpose(1, 2)) * e * inv_tau
    np_ = _pad64(n)
    ce = torch.zeros((b, 2 * np_, _pad64(l)), dtype=cdt, device=tn.device)
    ce[:, :n, :l] = dc.to(cdt)
    ce[:, np_:np_ + n, :l] = e.to(cdt)
    if not with_dtau:
        return ce
    # one slot per work item (image, 64 queries, 128 tokens), images slowest:
    # its sum of dc (s - rowmax), dc unrounded
    terms = torch.zeros((b, np_, _tiles(l) * _TOKEN_TILE), device=tn.device)
    terms[:, :n, :l] = dc * (s - rowmax[..., None])
    slots = terms.reshape(b, np_ // 64, 64, _tiles(l), _TOKEN_TILE).sum((2, 4))
    return ce, slots.reshape(-1)


def vlcabs_dtn_phase1(queries_normed, tn, dg, rowmax, tau, *, with_dtau=False):
    """K12's first phase: (N, D) queries, the normalised tokens tn (B, L, D),
    dg (B, N, D), the forward's row max (B, N) and tau -> ce (B, 2 Np, Lp)
    in the tokens' dtype, Np and Lp N and L rounded up to 64: per image, dc =
    (dg tn^T) e / tau in rows [0, Np) and e = exp(qn tn^T / tau - rowmax) in
    rows [Np, 2 Np), both rounded (e unrounded inside dc), zeros past N and
    L. With ``with_dtau`` -> (ce, slots): K11's dtau in parts, slots (B * Np
    / 64 * ceil(L / 128),) fp32, each (image, 64-query, 128-token) work
    item's sum of dc (s - rowmax) with dc unrounded, from the epilogue. On
    the card bf16 only (one Hopper kernel, csrc/vlcabs_sm90.cu)."""
    if not on_cuda(tn):
        return vlcabs_dtn_phase1_plain(queries_normed, tn, dg, rowmax, tau, with_dtau)
    n, d = queries_normed.shape
    b, l, _ = tn.shape
    _check_bf16("vlcabs_dtn_phase1", tn, queries_normed=((n, d), queries_normed),
                dg=((b, n, d), dg))
    _check_f32("vlcabs_dtn_phase1", tn.device, rowmax=((b, n), rowmax), tau=((1,), tau))
    np_, lp = _pad64(n), _pad64(l)
    ce = torch.empty((b, 2 * np_, lp), dtype=tn.dtype, device=tn.device)
    slots = (torch.empty((b * np_ // 64 * _tiles(l),), dtype=torch.float32, device=tn.device)
             if with_dtau else None)
    _build.check(_build.load().rz_vlcabs_dtn_phase1(
        queries_normed.data_ptr(), tn.data_ptr(), dg.data_ptr(), rowmax.data_ptr(),
        tau.data_ptr(), ce.data_ptr(), _ptr(slots), n, np_, b, l, lp, d, _build.stream_ptr(tn)),
        "vlcabs_dtn_phase1")
    return (ce, slots) if with_dtau else ce


def vlcabs_dtn_phase2_plain(ce, queries_normed, dg, l):
    n = queries_normed.shape[0]
    np_ = ce.shape[1] // 2
    dc, e = ce[:, :n, :l].float(), ce[:, np_:np_ + n, :l].float()
    dtn = (torch.einsum("bnl,nd->bld", dc, queries_normed.float())
           + torch.einsum("bnl,bnd->bld", e, dg.float()))
    return dtn.to(dg.dtype)


def vlcabs_dtn_phase2(ce, queries_normed, dg, l):
    """K12's second phase: dtn[b] = [dc[b]; e[b]]^T @ [qn; dg[b]] from
    :func:`vlcabs_dtn_phase1`'s ce -> (B, L, D) in dg's dtype, summed in fp32
    over the 2 Np rows and rounded once. On the card bf16 only: one product a
    (128-token, 128-column) tile on gemm_sm90_kernel (csrc/gemm_sm90.cu)."""
    if not on_cuda(ce):
        return vlcabs_dtn_phase2_plain(ce, queries_normed, dg, l)
    n, d = queries_normed.shape
    b = dg.shape[0]
    np_, lp = _pad64(n), _pad64(l)
    _check_bf16("vlcabs_dtn_phase2", ce, queries_normed=((n, d), queries_normed),
                dg=((b, n, d), dg))
    if tuple(ce.shape) != (b, 2 * np_, lp):
        raise ValueError(f"vlcabs_dtn_phase2: ce is {tuple(ce.shape)}, expected {(b, 2 * np_, lp)}")
    dtn = torch.empty((b, l, d), dtype=dg.dtype, device=dg.device)
    _build.check(_build.load().rz_vlcabs_dtn_phase2(
        ce.data_ptr(), queries_normed.data_ptr(), dg.data_ptr(), dtn.data_ptr(), n, np_, b, l, lp,
        d, _build.stream_ptr(ce)), "vlcabs_dtn_phase2")
    return dtn


def _fold_slots(slots):
    """-(sum of the slots) in the reduce's order: 32 lanes, lane i adds slots i,
    i + 32, ... in turn, then a butterfly of shuffles over the lanes."""
    lanes = torch.zeros(32, dtype=torch.float32, device=slots.device)
    padded = torch.nn.functional.pad(slots.float(), (0, -slots.numel() % 32)).reshape(-1, 32)
    for row in padded:
        lanes = lanes + row
    idx = torch.arange(32, device=slots.device)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[idx ^ o]
    return -lanes[:1]


def vlcabs_dq_from_ce_plain(ce, tn, dq_part, slots, n):
    l = tn.shape[1]
    parts = dq_part + ce[:, :n, :l].float() @ tn.float()       # (B, N, D)
    dq = torch.zeros_like(parts[0])
    for part in parts:  # the images in order, as the reduce adds them
        dq = dq + part
    return dq.to(tn.dtype), _fold_slots(slots)


def vlcabs_dq_from_ce(ce, tn, dq_part, slots, n):
    """K11 after K12's first phase: ce (B, 2 Np, Lp) and its dtau ``slots``
    from :func:`vlcabs_dtn_phase1` (``with_dtau=True``), the normalised
    tokens tn (B, L, D) and the row pass's dz ghat (B, N, D) fp32 -> (dq =
    sum_b (dz ghat[b] + dc[b] tn[b]) (N, D) in tn's dtype, dtau = -sum slots
    (1,) fp32), the images and the slots added in a fixed order. On the card
    bf16 only: dc[b] tn[b] is one product per image on gemm_sm90_kernel's
    GEMM_BFWD layout, added into ``dq_part`` in place (its contents are then
    spent), and a reduce over images (csrc/vlcabs_train.cu)."""
    if not on_cuda(ce):
        return vlcabs_dq_from_ce_plain(ce, tn, dq_part, slots, n)
    b, l, d = tn.shape
    np_, lp = _pad64(n), _pad64(l)
    _check_bf16("vlcabs_dq_from_ce", tn, ce=((b, 2 * np_, lp), ce))
    nslots = b * np_ // 64 * _tiles(l)
    _check_f32("vlcabs_dq_from_ce", tn.device, dq_part=((b, n, d), dq_part),
               slots=((nslots,), slots))
    dq = torch.empty((n, d), dtype=tn.dtype, device=tn.device)
    dtau = torch.empty((1,), dtype=torch.float32, device=tn.device)
    _build.check(_build.load().rz_vlcabs_dq_sm90(
        ce.data_ptr(), tn.data_ptr(), dq_part.data_ptr(), slots.data_ptr(), dq.data_ptr(),
        dtau.data_ptr(), n, np_, b, l, lp, d, nslots, _build.stream_ptr(tn)),
        "vlcabs_dq_from_ce")
    return dq, dtau


def vlcabs_train_backward_stats_plain(queries_normed, tokens, tau, dz, stats):
    """The card's bf16 backward route from the forward's statistics, stage
    twin by stage twin (the tokens' row pass; the backward's row pass; K12's
    phase 1 with K11's dtau slots; K11's product and reduce over its dc; K12's
    phase 2; in fp32 the same twins compute what vlc_dq_kernel and
    vlc_dtn_kernel do) -> (dq, dt, dtau) as :func:`vlcabs_train_backward_plain`
    returns them."""
    rowmax, g = stats
    n, l = queries_normed.shape[0], tokens.shape[1]
    tn = _normalized_tokens(tokens)[0].to(tokens.dtype)
    dg, dq_part = vlcabs_bwd_rows_plain(queries_normed, g, dz)
    ce, slots = vlcabs_dtn_phase1_plain(queries_normed, tn, dg, rowmax, tau, with_dtau=True)
    dq, dtau = vlcabs_dq_from_ce_plain(ce, tn, dq_part, slots, n)
    dtn = vlcabs_dtn_phase2_plain(ce, queries_normed, dg, l)
    return dq, _rownorm_vjp(dtn, tokens), dtau.to(tau.dtype).reshape(tau.shape)


def _check_f32(name, device, **named):
    for arg, (shape, t) in named.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"{name}: {arg} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"expected {tuple(shape)} float32 on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _check_bf16(name, x, **named):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the Hopper kernel takes bfloat16, got {x.dtype}")
    check_operands(name, x, **named)


def _stats_operands(name, stats, n, b, d, device):
    """The forward's (row max (B, N), g (B, N, D)), checked; missing ones
    raise: the backward kernels have no path without them."""
    if stats is None:
        raise ValueError(f"{name}: the kernel reads the forward's statistics; pass stats= "
                         "(vlcabs_train_forward(..., with_stats=True) gives them)")
    rowmax, g = stats
    _check_f32(name, device, rowmax=((b, n), rowmax), g=((b, n, d), g))
    return rowmax, g


def _bwd_operands(name, queries_normed, tokens, tau, dz, stats):
    """The card's checks of a backward entry point -> (n, b, l, d, code, dz
    fp32, row max, g)."""
    n, b, l, d, code = _check_train_operands(name, queries_normed, tokens, tau)
    dz = _check_cotangent(name, dz, n, b, tokens.device)
    rowmax, g = _stats_operands(name, stats, n, b, d, tokens.device)
    return n, b, l, d, code, dz, rowmax, g


def _dq_fp32(queries_normed, tn, tau, dg, rowmax, dq_part, code):
    """fp32 K11 after the row pass: vlc_dq_kernel, per (32-query block, image)
    partial sums in fp32, then the reduce over images -> (dq, dtau)."""
    n, d = queries_normed.shape
    b, l, _ = tn.shape
    dev = tn.device
    dtau_part = torch.empty((b * ((n + 31) // 32),), dtype=torch.float32, device=dev)
    dq = torch.empty_like(queries_normed)
    dtau = torch.empty((1,), dtype=torch.float32, device=dev)
    _build.check(_build.load().rz_vlcabs_dq(
        queries_normed.data_ptr(), tn.data_ptr(), tau.data_ptr(), dg.data_ptr(),
        rowmax.data_ptr(), dq_part.data_ptr(), dtau_part.data_ptr(), dq.data_ptr(),
        dtau.data_ptr(), n, b, l, d, code, _build.stream_ptr(tn)), "vlcabs_train_bwd_dq")
    return dq, dtau


def _dtn_fp32(queries_normed, tn, tau, dg, rowmax, code):
    """fp32 K12 after the row pass: one kernel whose block owns a token tile
    of one image and walks every query block itself."""
    n, d = queries_normed.shape
    b, l, _ = tn.shape
    dtn = torch.empty_like(tn)
    _build.check(_build.load().rz_vlcabs_dtn_tiles(
        queries_normed.data_ptr(), tn.data_ptr(), tau.data_ptr(), dg.data_ptr(),
        rowmax.data_ptr(), dtn.data_ptr(), n, b, l, d, code, _build.stream_ptr(tn)),
        "vlcabs_train_bwd_dtn")
    return dtn


def vlcabs_train_bwd_dq(queries_normed, tokens, tau, dz, *, stats=None):
    """K11: cotangent dz (N, B) fp32 -> (dq (N, D) in the queries' dtype,
    dtau (1,) fp32). On the card ``stats``, the forward's (row max, g), is
    required: the tokens' row pass, the backward's row pass (dg and dz ghat
    from g), then in bf16 K12's first phase (:func:`vlcabs_dtn_phase1`,
    whose e rows go unused here) and :func:`vlcabs_dq_from_ce`, in fp32 per
    (query block, image) partial sums; either way a reduce over images in a
    fixed order: no atomics, the same bits each run."""
    if not on_cuda(tokens):
        return vlcabs_train_bwd_dq_plain(queries_normed, tokens, tau, dz)
    n, _, _, _, code, dz, rowmax, g = _bwd_operands("vlcabs_train_bwd_dq", queries_normed,
                                                    tokens, tau, dz, stats)
    tn = vlcabs_rownorm(tokens)
    dg, dq_part = vlcabs_bwd_rows(queries_normed, g, dz, want_dq_part=True)
    if tokens.dtype == torch.bfloat16:
        ce, slots = vlcabs_dtn_phase1(queries_normed, tn, dg, rowmax, tau, with_dtau=True)
        dq, dtau = vlcabs_dq_from_ce(ce, tn, dq_part, slots, n)
    else:
        dq, dtau = _dq_fp32(queries_normed, tn, tau, dg, rowmax, dq_part, code)
    vlcabs_train_bwd_dq.launches += 1
    return dq, dtau


vlcabs_train_bwd_dq.launches = 0


def vlcabs_train_bwd_dtn(queries_normed, tokens, tau, dz, *, stats=None):
    """K12: cotangent dz (N, B) fp32 -> dtn (B, L, D), the gradient of the
    row-normalised tokens, in the tokens' dtype. On the card ``stats``, the
    forward's (row max, g), is required: the tokens' row pass, the
    backward's row pass (dg from g), then in bf16 :func:`vlcabs_dtn_phase1`
    and :func:`vlcabs_dtn_phase2` (TMA and wgmma), in fp32 one kernel whose
    block owns a token tile of one image and walks every query block itself.
    Either way the sum over queries has a fixed order and is rounded once."""
    if not on_cuda(tokens):
        return vlcabs_train_bwd_dtn_plain(queries_normed, tokens, tau, dz)
    _, _, l, _, code, dz, rowmax, g = _bwd_operands("vlcabs_train_bwd_dtn", queries_normed,
                                                    tokens, tau, dz, stats)
    tn = vlcabs_rownorm(tokens)
    dg, _ = vlcabs_bwd_rows(queries_normed, g, dz)
    if tokens.dtype == torch.bfloat16:
        ce = vlcabs_dtn_phase1(queries_normed, tn, dg, rowmax, tau)
        dtn = vlcabs_dtn_phase2(ce, queries_normed, dg, l)
    else:
        dtn = _dtn_fp32(queries_normed, tn, tau, dg, rowmax, code)
    vlcabs_train_bwd_dtn.launches += 1
    return dtn


vlcabs_train_bwd_dtn.launches = 0


def vlcabs_train_bwd(queries_normed, tokens, tau, dz, *, stats=None):
    """K11 and K12 in one pass over their shared stages -> (dq (N, D) in the
    queries' dtype, dtn (B, L, D) in the tokens' dtype, dtau (1,) fp32), as
    :func:`vlcabs_train_bwd_dq` and :func:`vlcabs_train_bwd_dtn` return them;
    one launch of each is counted. From the forward's statistics ``stats``
    (required on the card) the tokens' row pass and the backward's row pass
    run once, then in bf16 K12's first phase once (e, dc and K11's dtau
    slots), K11's product and reduce (:func:`vlcabs_dq_from_ce`) and K12's
    second phase; in fp32 K11's dq kernel and reduce and K12's tiled kernel.
    On CPU tensors with ``stats`` the stage twins run that bf16 route, and
    without them the whole-function twins."""
    card = on_cuda(tokens)
    if card:
        n, _, l, _, code, dz, rowmax, g = _bwd_operands("vlcabs_train_bwd", queries_normed,
                                                        tokens, tau, dz, stats)
    elif stats is None:
        dq, dtau = vlcabs_train_bwd_dq_plain(queries_normed, tokens, tau, dz)
        return dq, vlcabs_train_bwd_dtn_plain(queries_normed, tokens, tau, dz), dtau
    else:
        (rowmax, g), n, l = stats, queries_normed.shape[0], tokens.shape[1]
    tn = vlcabs_rownorm(tokens)
    dg, dq_part = vlcabs_bwd_rows(queries_normed, g, dz, want_dq_part=True)
    if not card or tokens.dtype == torch.bfloat16:
        ce, slots = vlcabs_dtn_phase1(queries_normed, tn, dg, rowmax, tau, with_dtau=True)
        dq, dtau = vlcabs_dq_from_ce(ce, tn, dq_part, slots, n)
        dtn = vlcabs_dtn_phase2(ce, queries_normed, dg, l)
    else:
        dq, dtau = _dq_fp32(queries_normed, tn, tau, dg, rowmax, dq_part, code)
        dtn = _dtn_fp32(queries_normed, tn, tau, dg, rowmax, code)
    if card:
        vlcabs_train_bwd_dq.launches += 1
        vlcabs_train_bwd_dtn.launches += 1
    return dq, dtn, dtau


def _check_cotangent(name, dz, n, b, device):
    if tuple(dz.shape) != (n, b) or dz.device != device:
        raise ValueError(f"{name}: cotangent must be ({n}, {b}) on {device}, got "
                         f"{tuple(dz.shape)} on {dz.device}")
    return dz.float().contiguous()


def _rownorm_vjp(dtn, tokens):
    """dt = (dtn - (dtn . tn) tn) / |t| for tn = t / |t|, fp32, plain torch."""
    tn32, inv_t = _normalized_tokens(tokens)
    dtn = dtn.float()
    return ((dtn - (dtn * tn32).sum(-1, keepdim=True) * tn32) * inv_t).to(tokens.dtype)


def vlcabs_train_backward_plain(queries_normed, tokens, tau, dz):
    """The whole backward from the plain twins -> (dq, dt, dtau), dtau in
    tau's dtype and shape."""
    dq, dtau = vlcabs_train_bwd_dq_plain(queries_normed, tokens, tau, dz)
    dtn = vlcabs_train_bwd_dtn_plain(queries_normed, tokens, tau, dz)
    return dq, _rownorm_vjp(dtn, tokens), dtau.to(tau.dtype).reshape(tau.shape)


class _VlcabsFusedTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, queries_normed, tokens, tau):
        queries_normed, tokens = queries_normed.contiguous(), tokens.contiguous()
        tau32 = tau.detach().float().reshape(1)
        ctx.tau_like = (tau.dtype, tau.shape)
        if on_cuda(tokens):  # the backward kernels read the forward's statistics
            logits, stats = vlcabs_train_forward(queries_normed, tokens, tau32, with_stats=True)
            ctx.save_for_backward(queries_normed, tokens, tau32, *stats)
            return logits
        ctx.save_for_backward(queries_normed, tokens, tau32)
        return vlcabs_train_forward(queries_normed, tokens, tau32)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dz):
        queries_normed, tokens, tau32, *stats = ctx.saved_tensors
        dq, dtn, dtau = vlcabs_train_bwd(queries_normed, tokens, tau32, dz,
                                         stats=tuple(stats) or None)
        dtype, shape = ctx.tau_like
        return dq, _rownorm_vjp(dtn, tokens), dtau.to(dtype).reshape(shape)


def vlcabs_fused_train(queries_normed, tokens, tau):
    """Differentiable fused VL-CABS -> logits (N, B) fp32; gradients flow
    to the queries, the tokens and tau."""
    return _VlcabsFusedTrain.apply(queries_normed, tokens, tau)
