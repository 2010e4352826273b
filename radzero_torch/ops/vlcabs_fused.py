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
  (:func:`vlcabs_train_forward`); its backward launches K11
  (:func:`vlcabs_train_bwd_dq`: dq and dtau) and K12
  (:func:`vlcabs_train_bwd_dtn`: the gradient of the normalised tokens) and
  then applies the row-normalise VJP dt = (dtn - (dtn.tn) tn) / |t| in
  plain torch, as the JAX package leaves it to XLA. The (B, N, L) score
  tensor never reaches device memory in either pass: the backward
  recomputes it per (query block, image).

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
kernel (``csrc/vlcabs_fused.cu``, ``csrc/vlcabs_train.cu``) on a CUDA
tensor; ``<wrapper>.launches`` counts kernel launches. The kernels walk L
in tiles; K5 keeps a running max (the cosine is invariant to scaling agg,
so that is exact), K10-K12 take the row max in a first sweep.
"""

from __future__ import annotations

import torch

from radzero_torch.ops import _build
from radzero_torch.ops._checks import check_operands, forbid_grad, on_cuda

_LOG2E = 1.4426950408889634


def vlcabs_fused_plain(queries_normed, tokens, tau):
    cdt = tokens.dtype
    t32 = tokens.float()
    tn = (t32 * torch.rsqrt(t32.square().sum(-1, keepdim=True) + 1e-24)).to(cdt)
    s = torch.einsum("nd,bld->bnl", queries_normed.float(), tn.float())
    s = s * (1.0 / tau.float().reshape(()))
    e = torch.exp2((s - s.amax(-1, keepdim=True)) * _LOG2E).to(cdt)
    agg = e.float() @ tn.float()                                # (B, N, D)
    num = (queries_normed.float() * agg).sum(-1)
    norm = agg.square().sum(-1).sqrt()
    logits = num / norm.clamp_min(1e-12)                        # (B, N)
    return logits.T, s


def vlcabs_fused(queries_normed, tokens, tau):
    """(N, D) l2-normalised queries, (B, L, D) tokens, scalar fp32 tau ->
    (logits (N, B) fp32, scores (B, N, L) fp32)."""
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


def vlcabs_train_forward_plain(queries_normed, tokens, tau):
    return vlcabs_fused_plain(queries_normed, tokens, tau)[0]


def vlcabs_train_forward(queries_normed, tokens, tau):
    """K10: (N, D) l2-normalised queries, (B, L, D) tokens, fp32 tau ->
    logits (N, B) fp32. No map is written. No tape: differentiate through
    :func:`vlcabs_fused_train`."""
    forbid_grad("vlcabs_train_forward (K10)", "call vlcabs_fused_train, the autograd function",
                queries_normed, tokens, tau)
    if not on_cuda(tokens):
        return vlcabs_train_forward_plain(queries_normed, tokens, tau)
    n, b, l, d, code = _check_train_operands("vlcabs_train_forward", queries_normed, tokens, tau)
    tn = torch.empty_like(tokens)
    logits = torch.empty((n, b), dtype=torch.float32, device=tokens.device)
    lib = _build.load()
    err = lib.rz_vlcabs_train_fwd(
        queries_normed.data_ptr(), tokens.data_ptr(), tau.data_ptr(), tn.data_ptr(),
        logits.data_ptr(), n, b, l, d, code, _build.stream_ptr(tokens),
    )
    _build.check(err, "vlcabs_train_forward")
    vlcabs_train_forward.launches += 1
    return logits


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


def _bwd_scratch(queries_normed, tokens):
    n, d = queries_normed.shape
    b = tokens.shape[0]
    dev = tokens.device
    return (torch.empty_like(tokens),                                  # tn
            torch.empty((b, n, d), dtype=tokens.dtype, device=dev),    # dg
            torch.empty((b, n), dtype=torch.float32, device=dev))      # row max


def vlcabs_train_bwd_dq(queries_normed, tokens, tau, dz):
    """K11: cotangent dz (N, B) fp32 -> (dq (N, D) in the queries' dtype,
    dtau (1,) fp32). Per (query block, image) partial sums in fp32, then a
    reduce over images in a fixed order: no atomics, the same bits each run."""
    if not on_cuda(tokens):
        return vlcabs_train_bwd_dq_plain(queries_normed, tokens, tau, dz)
    n, b, l, d, code = _check_train_operands("vlcabs_train_bwd_dq", queries_normed, tokens, tau)
    dz = _check_cotangent("vlcabs_train_bwd_dq", dz, n, b, tokens.device)
    tn, dg, rowmax = _bwd_scratch(queries_normed, tokens)
    dev = tokens.device
    dq_part = torch.empty((b, n, d), dtype=torch.float32, device=dev)
    dtau_part = torch.empty((b * ((n + 31) // 32),), dtype=torch.float32, device=dev)
    dq = torch.empty_like(queries_normed)
    dtau = torch.empty((1,), dtype=torch.float32, device=dev)
    lib = _build.load()
    err = lib.rz_vlcabs_train_bwd_dq(
        queries_normed.data_ptr(), tokens.data_ptr(), tau.data_ptr(), dz.data_ptr(),
        tn.data_ptr(), dg.data_ptr(), rowmax.data_ptr(), dq_part.data_ptr(),
        dtau_part.data_ptr(), dq.data_ptr(), dtau.data_ptr(), n, b, l, d, code,
        _build.stream_ptr(tokens),
    )
    _build.check(err, "vlcabs_train_bwd_dq")
    vlcabs_train_bwd_dq.launches += 1
    return dq, dtau


vlcabs_train_bwd_dq.launches = 0


def vlcabs_train_bwd_dtn(queries_normed, tokens, tau, dz):
    """K12: cotangent dz (N, B) fp32 -> dtn (B, L, D), the gradient of the
    row-normalised tokens, in the tokens' dtype. One block owns a token
    tile of one image and walks every query block itself, so the sum over
    queries has a fixed order and is rounded once."""
    if not on_cuda(tokens):
        return vlcabs_train_bwd_dtn_plain(queries_normed, tokens, tau, dz)
    n, b, l, d, code = _check_train_operands("vlcabs_train_bwd_dtn", queries_normed, tokens, tau)
    dz = _check_cotangent("vlcabs_train_bwd_dtn", dz, n, b, tokens.device)
    tn, dg, rowmax = _bwd_scratch(queries_normed, tokens)
    dtn = torch.empty_like(tokens)
    lib = _build.load()
    err = lib.rz_vlcabs_train_bwd_dtn(
        queries_normed.data_ptr(), tokens.data_ptr(), tau.data_ptr(), dz.data_ptr(),
        tn.data_ptr(), dg.data_ptr(), rowmax.data_ptr(), dtn.data_ptr(), n, b, l, d, code,
        _build.stream_ptr(tokens),
    )
    _build.check(err, "vlcabs_train_bwd_dtn")
    vlcabs_train_bwd_dtn.launches += 1
    return dtn


vlcabs_train_bwd_dtn.launches = 0


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
        ctx.save_for_backward(queries_normed, tokens, tau32)
        ctx.tau_like = (tau.dtype, tau.shape)
        return vlcabs_train_forward(queries_normed, tokens, tau32)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dz):
        queries_normed, tokens, tau32 = ctx.saved_tensors
        dq, dtau = vlcabs_train_bwd_dq(queries_normed, tokens, tau32, dz)
        dtn = vlcabs_train_bwd_dtn(queries_normed, tokens, tau32, dz)
        dtype, shape = ctx.tau_like
        return dq, _rownorm_vjp(dtn, tokens), dtau.to(dtype).reshape(shape)


def vlcabs_fused_train(queries_normed, tokens, tau):
    """Differentiable fused VL-CABS -> logits (N, B) fp32; gradients flow
    to the queries, the tokens and tau."""
    return _VlcabsFusedTrain.apply(queries_normed, tokens, tau)
