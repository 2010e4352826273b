"""K13-K16: attention over (B, L, H, hd) heads, with and without the
batch-shared bias (port of radzero_tpu/ops/flash_attention.py).

- :func:`flash_attention` (K13): softmax(q k^T scale) v; keys >= ``kv_len``
  are masked. Its backward is :func:`flash_attention_bwd` (K14).
- :func:`flash_attention_bias` (K15): softmax(q k^T scale + bias[h] +
  neg_mask[b]) v with ``bias`` (H, L, L) shared by the batch and ``neg_mask``
  (B, L) an additive key mask (0 real / most negative number on padding).
  Its backward is :func:`flash_attention_bias_bwd` (K16), which also
  returns d(bias), the sum over the batch of dS *before* the scale;
  ``neg_mask`` is a structural mask and gets no gradient (``None``).

Each wrapper runs its plain twin (``*_plain``, same module) when handed CPU
tensors and launches its CUDA kernel (``csrc/flash_attention.cu``; bf16
K13 / K14 on the Hopper kernels of ``csrc/flash_fwd_sm90.cu`` and
``csrc/flash_bwd_sm90.cu``) when handed CUDA tensors; anything else raises.
``<wrapper>.launches`` counts kernel launches. Handed an operand that
requires a gradient, with gradients enabled, the forward goes through a
``torch.autograd.Function``. In bf16 on the card, K13's Function keeps its
inputs, its output and the row statistic ``lse`` (B, H, L) fp32 that the
forward writes (m + log2 l per query row, in the log2 domain of the
scores): the Hopper backward reads P = exp2(s - lse) and delta =
rowsum(dO O) from them (:func:`flash_attention_lse` returns both). In fp32,
on the CPU and for K15, the Functions keep their inputs only and the
backward recomputes the fp32 softmax.

Numerics are the TPU kernels' contract: fp32 scores, exp2 with log2(e)
folded into the score, the division deferred to the (L, hd) output; the
softmax weights are rounded to the operand type before P.V, P and dS before
their products; ``bias`` and ``neg_mask`` enter in fp32. One difference,
in the kernels and their twins alike: ``stable`` is accepted and ignored,
the row maximum is always subtracted (the TPU's bf16 default,
``stable=False``, skips it). A sentence whose keys are all masked comes out
as NaN, in the forward and in every gradient that sums over it (d(bias)
included), as from the TPU kernel: ``neg_mask`` times log2(e) overflows to
-inf, and -inf minus the row maximum -inf is NaN.

q, k and v may be views with a row and a batch stride (three slices of one
packed (B, L, 3D) product): the kernels read by stride, no copy is made.
The kernels take head_dim 64 and any L; there is no length limit and no
eager fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from radzero_torch.ops import _build
from radzero_torch.ops._checks import DTYPE_CODES, forbid_grad, needed, on_cuda, tracked

_LOG2E = 1.4426950408889634
_SPLIT_BLOCKS = 4 * 132  # blocks the d(bias) kernel aims at when it splits the batch


def _resolve(q, scale, kv_len):
    l, hd = q.shape[1], q.shape[3]
    scale = hd**-0.5 if scale is None else float(scale)
    kv_len = l if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= l:
        raise ValueError(f"kv_len must be in [1, {l}], got {kv_len}")
    return scale, kv_len


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def _heads32(t):  # (B, L, H, hd) -> (B, H, L, hd) fp32
    return t.transpose(1, 2).float()


def _scores_log2(q, k, bias, neg_mask, scale, kv_len):
    """(B, H, L, L) fp32 scores times log2 e, masked keys at -inf."""
    s = _heads32(q) @ _heads32(k).transpose(-1, -2)
    if bias is None:
        s = s * (scale * _LOG2E)
    else:
        s = (s * scale + bias.float()[None] + neg_mask.float()[:, None, None, :]) * _LOG2E
    if kv_len < s.shape[-1]:
        s[..., kv_len:] = float("-inf")
    return s


def _fwd_plain(q, k, v, bias, neg_mask, scale, kv_len):
    scale, kv_len = _resolve(q, scale, kv_len)
    s = _scores_log2(q, k, bias, neg_mask, scale, kv_len)
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    den = e.sum(dim=-1, keepdim=True)
    num = e.to(q.dtype).float() @ _heads32(v)
    return (num / den).to(q.dtype).transpose(1, 2).contiguous()


def _lse_plain(s):
    """(B, H, L) fp32 m + log2(sum exp2(s - m)) of log2-domain scores s."""
    m = s.amax(dim=-1, keepdim=True)
    return (m + torch.log2(torch.exp2(s - m).sum(dim=-1, keepdim=True))).squeeze(-1)


def _bwd_plain(q, k, v, bias, neg_mask, g, scale, kv_len, out=None, lse=None):
    """The contract's backward; with the forward's ``out`` and ``lse`` the
    Hopper kernel's arithmetic instead: P = exp2(s - lse), delta = rowsum(dO O)."""
    scale, kv_len = _resolve(q, scale, kv_len)
    cdt = q.dtype
    s = _scores_log2(q, k, bias, neg_mask, scale, kv_len)
    do = _heads32(g.to(cdt))
    dp = do @ _heads32(v).transpose(-1, -2)
    if lse is None:
        e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        delta = (dp * p).sum(dim=-1, keepdim=True)
    else:
        p = torch.exp2(s - lse.float()[..., None])
        delta = (do * _heads32(out.to(cdt))).sum(dim=-1, keepdim=True)
    dv = p.to(cdt).float().transpose(-1, -2) @ do
    ds0 = p * (dp - delta)  # d(raw scores)
    dsc = (ds0 * scale).to(cdt).float()
    dq = dsc @ _heads32(k)
    dk = dsc.transpose(-1, -2) @ _heads32(q)
    dq, dk, dv = (t.to(cdt).transpose(1, 2).contiguous() for t in (dq, dk, dv))
    return dq, dk, dv, ds0.sum(dim=0)


def flash_attention_plain(q, k, v, scale=None, stable=None, kv_len=None):
    return _fwd_plain(q, k, v, None, None, scale, kv_len)


def flash_attention_lse_plain(q, k, v, scale=None, kv_len=None):
    scale, kv_len = _resolve(q, scale, kv_len)
    return (_fwd_plain(q, k, v, None, None, scale, kv_len),
            _lse_plain(_scores_log2(q, k, None, None, scale, kv_len)))


def flash_attention_bwd_plain(q, k, v, g, scale=None, kv_len=None, *, out=None, lse=None):
    """The contract (P from the scores, delta = rowsum(dP P)); ``out`` and
    ``lse`` are accepted and ignored, as the fp32 kernels ignore them."""
    return _bwd_plain(q, k, v, None, None, g, scale, kv_len)[:3]


def flash_attention_bwd_stats_plain(q, k, v, g, out, lse, scale=None, kv_len=None):
    """The bf16 Hopper backward's arithmetic (csrc/flash_bwd_sm90.cu): P =
    exp2(s - lse) from the forward's row statistic, delta = rowsum(dO O) over
    its output, the contract's roundings otherwise. The CPU tests hold it to
    the JAX kernels; the card holds the kernel to the contract twin."""
    return _bwd_plain(q, k, v, None, None, g, scale, kv_len, out, lse)[:3]


def flash_attention_bias_plain(q, k, v, bias, neg_mask, scale=None, stable=None, kv_len=None):
    return _fwd_plain(q, k, v, bias, neg_mask, scale, kv_len)


def flash_attention_bias_bwd_plain(q, k, v, bias, neg_mask, g, scale=None, kv_len=None):
    dq, dk, dv, dbias = _bwd_plain(q, k, v, bias, neg_mask, g, scale, kv_len)
    return dq, dk, dv, dbias.to(bias.dtype)


# ---------------------------------------------------------------------------
# operands on the card
# ---------------------------------------------------------------------------

def _by_stride(t: torch.Tensor) -> torch.Tensor:
    """``t`` (B, L, H, hd) as the kernels read it: unit stride over hd, heads
    side by side, 16-byte aligned rows (TMA's rule for the bf16 forward) and
    no zero stride over images or rows; a copy only when ``t`` is no such view."""
    vec = 16 // t.element_size()
    ok = (t.stride(3) == 1 and t.stride(2) == t.shape[3] and t.stride(1) % vec == 0
          and t.stride(0) % vec == 0 and t.data_ptr() % 16 == 0
          and all(t.stride(i) > 0 or t.shape[i] == 1 for i in (0, 1)))
    return t if ok else t.contiguous()


def _check_qkv(name, q, k, v):
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: operands must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (B, L, H, hd), got {tuple(q.shape)}")
    if q.shape[3] != 64:
        raise ValueError(f"{name}: the kernel takes head_dim 64, got {q.shape[3]}")
    for arg, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name}: {arg} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                            f"expected {tuple(q.shape)} {q.dtype} on {q.device}")
    return DTYPE_CODES[q.dtype]


def _check_bias(name, q, bias, neg_mask):
    b, l, h, _ = q.shape
    if tuple(bias.shape) != (h, l, l) or tuple(neg_mask.shape) != (b, l):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} / neg_mask {tuple(neg_mask.shape)}, "
                         f"expected {(h, l, l)} / {(b, l)}")
    if bias.device != q.device or neg_mask.device != q.device:
        raise TypeError(f"{name}: bias and neg_mask must be on {q.device}")
    return bias.float().contiguous(), neg_mask.float().contiguous()


def _strides(*ops):
    return [s for t in ops for s in (t.stride(0), t.stride(1))]


# ---------------------------------------------------------------------------
# K13 / K14
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, scale: Optional[float] = None, stable: Optional[bool] = None,
                    kv_len: Optional[int] = None):
    """(B, L, H, hd) q, k, v -> (B, L, H, hd), the contract of
    :func:`radzero_torch.ops.layers.attention` without a bias. ``scale``
    defaults to hd ** -0.5; ``kv_len`` is the number of real keys when the
    caller padded the sequence (keys beyond it are masked, every query row
    is computed); ``stable`` is ignored, the row maximum is always
    subtracted. Differentiable: the backward is :func:`flash_attention_bwd`."""
    if tracked(q, k, v):
        return _FlashAttention.apply(q, k, v, scale, kv_len)
    return _flash_attention_fwd(q, k, v, scale, kv_len)


def flash_attention_lse(q, k, v, scale: Optional[float] = None, kv_len: Optional[int] = None):
    """:func:`flash_attention` that also returns the row statistic its
    backward reads: (out, lse), ``lse`` (B, H, L) fp32 = m + log2(l) of every
    query row in the log2 domain of the scores (scale * log2 e folded in).
    Forward only: an operand that requires a gradient raises (the
    differentiable :func:`flash_attention` keeps ``lse`` itself). On the
    card bf16 only (the Hopper kernel writes it); on the CPU the twin."""
    forbid_grad("flash_attention_lse", "call flash_attention", q, k, v)
    return _flash_attention_fwd(q, k, v, scale, kv_len, with_lse=True)


def _flash_attention_fwd(q, k, v, scale, kv_len, with_lse=False):
    if not on_cuda(q):
        if with_lse:
            return flash_attention_lse_plain(q, k, v, scale, kv_len)
        return flash_attention_plain(q, k, v, scale, None, kv_len)
    code = _check_qkv("flash_attention", q, k, v)
    if with_lse and q.dtype != torch.bfloat16:
        raise ValueError("flash_attention: only the bf16 kernel writes lse")
    scale, kv_len = _resolve(q, scale, kv_len)
    q, k, v = _by_stride(q), _by_stride(k), _by_stride(v)
    b, l, h, hd = q.shape
    out = torch.empty((b, l, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device) if with_lse else None
    err = _build.load().rz_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), *_strides(q, k, v),
        b, l, h, hd, kv_len, scale, code, _build.stream_ptr(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


flash_attention.launches = 0


def stats_operands(name, want, out, lse):
    """The forward's ``out`` (``want`` = (B, L, H, hd) bf16, read by TMA:
    contiguous) and ``lse`` (B, H, L) fp32 for the bf16 Hopper backward,
    checked; missing ones raise: that kernel has no path without them."""
    b, l, h, hd = want.shape
    if out is None or lse is None:
        raise ValueError(f"{name}: the bf16 kernel reads the forward's out and lse; pass out= "
                         "and lse= (flash_attention_lse / flash_attention_packed_lse give them)")
    if out.numel() != want.numel() or out.dtype != want.dtype or out.device != want.device:
        raise ValueError(f"{name}: out is {tuple(out.shape)} {out.dtype} on {out.device}, "
                         f"expected {tuple(want.shape)} {want.dtype} on {want.device}")
    if tuple(lse.shape) != (b, h, l) or lse.dtype != torch.float32 or lse.device != want.device:
        raise ValueError(f"{name}: lse is {tuple(lse.shape)} {lse.dtype} on {lse.device}, "
                         f"expected {(b, h, l)} float32 on {want.device}")
    return out.contiguous(), lse.contiguous()


def flash_attention_bwd(q, k, v, g, scale=None, kv_len=None, *, out=None, lse=None):
    """K14: cotangent g (B, L, H, hd) of :func:`flash_attention` -> (dq, dk,
    dv) in the operands' type; one count. In bf16 on the card two Hopper
    kernels (csrc/flash_bwd_sm90.cu) that read the forward's ``out`` and
    ``lse`` (required, see :func:`flash_attention_lse`): dQ per 128 query
    rows walking the key tiles, which also writes delta = rowsum(dO O), then
    dK and dV per 128 keys walking the query tiles. In fp32 three kernels over
    64-key tiles, the first recomputing the row statistics (max, 1 / sum,
    delta = rowsum(dP P)); ``out`` and ``lse`` are ignored there and on the
    CPU."""
    if not on_cuda(q):
        return flash_attention_bwd_plain(q, k, v, g, scale, kv_len)
    code = _check_qkv("flash_attention_bwd", q, k, v)
    scale, kv_len = _resolve(q, scale, kv_len)
    sm90 = hopper(q)
    if sm90:
        out, lse = stats_operands("flash_attention_bwd", q, out, lse)
    q, k, v = _by_stride(q), _by_stride(k), _by_stride(v)
    g = g.to(q.dtype).contiguous()
    b, l, h, hd = q.shape
    stats = torch.empty((1 if sm90 else 3, b, h, l), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty((b, l, h, hd), dtype=q.dtype, device=q.device) for _ in range(3))
    err = _build.load().rz_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        out.data_ptr() if sm90 else None, lse.data_ptr() if sm90 else None,
        stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_strides(q, k, v),
        b, l, h, hd, kv_len, scale, code, _build.stream_ptr(q))
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


# ---------------------------------------------------------------------------
# K15 / K16
# ---------------------------------------------------------------------------

def flash_attention_bias(q, k, v, bias, neg_mask, scale: Optional[float] = None,
                         stable: Optional[bool] = None, kv_len: Optional[int] = None):
    """softmax(q k^T scale + bias[h] + neg_mask[b]) v over (B, L, H, hd)
    heads: ``bias`` (H, L, L) is shared by the batch and differentiable,
    ``neg_mask`` (B, L) is a structural additive key mask and gets no
    gradient. Padded query rows of a real sentence are computed, not
    skipped. Differentiable: the backward is
    :func:`flash_attention_bias_bwd`."""
    if tracked(q, k, v, bias):
        return _FlashAttentionBias.apply(q, k, v, bias, neg_mask, scale, kv_len)
    return _flash_attention_bias_fwd(q, k, v, bias, neg_mask, scale, kv_len)


def _flash_attention_bias_fwd(q, k, v, bias, neg_mask, scale, kv_len):
    if not on_cuda(q):
        return flash_attention_bias_plain(q, k, v, bias, neg_mask, scale, None, kv_len)
    code = _check_qkv("flash_attention_bias", q, k, v)
    bias32, neg32 = _check_bias("flash_attention_bias", q, bias, neg_mask)
    scale, kv_len = _resolve(q, scale, kv_len)
    q, k, v = _by_stride(q), _by_stride(k), _by_stride(v)
    b, l, h, hd = q.shape
    out = torch.empty((b, l, h, hd), dtype=q.dtype, device=q.device)
    err = _build.load().rz_flash_attention_bias(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias32.data_ptr(), neg32.data_ptr(),
        out.data_ptr(), *_strides(q, k, v), b, l, h, hd, kv_len, scale, code,
        _build.stream_ptr(q))
    _build.check(err, "flash_attention_bias")
    flash_attention_bias.launches += 1
    return out


flash_attention_bias.launches = 0


def flash_attention_bias_bwd(q, k, v, bias, neg_mask, g, scale=None, kv_len=None):
    """K16: cotangent g of :func:`flash_attention_bias` -> (dq, dk, dv,
    d bias), d bias (H, L, L) in ``bias``'s type: the sum over the batch of
    dS before the scale. On the card K14's three kernels with the bias and
    the mask in the score, a fourth whose blocks walk a chunk of the batch in
    order with the dS tile in registers, and the fixed-order reduce over the
    chunks; one count."""
    if not on_cuda(q):
        return flash_attention_bias_bwd_plain(q, k, v, bias, neg_mask, g, scale, kv_len)
    code = _check_qkv("flash_attention_bias_bwd", q, k, v)
    bias32, neg32 = _check_bias("flash_attention_bias_bwd", q, bias, neg_mask)
    scale, kv_len = _resolve(q, scale, kv_len)
    q, k, v = _by_stride(q), _by_stride(k), _by_stride(v)
    g = g.to(q.dtype).contiguous()
    b, l, h, hd = q.shape
    q_rows = 32 if l <= 32 else 64  # query rows of a block of the d(bias) kernel
    tiles = -(-l // q_rows) * -(-l // 64) * h
    per = -(-b // max(1, min(b, -(-_SPLIT_BLOCKS // tiles))))  # sentences a chunk
    chunks = -(-b // per)
    stats = torch.empty((3, b, h, l), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty((b, l, h, hd), dtype=q.dtype, device=q.device) for _ in range(3))
    part = torch.empty((chunks, h, l, l), dtype=torch.float32, device=q.device)
    dbias = torch.empty((h, l, l), dtype=torch.float32, device=q.device)
    lib = _build.load()
    stream = _build.stream_ptr(q)
    err = lib.rz_flash_attention_bias_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias32.data_ptr(), neg32.data_ptr(),
        g.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        part.data_ptr(), chunks, *_strides(q, k, v), b, l, h, hd, kv_len, scale, code, stream)
    _build.check(err, "flash_attention_bias_bwd")
    err = lib.rz_reduce_parts(part.data_ptr(), dbias.data_ptr(), chunks, dbias.numel(),
                              DTYPE_CODES[torch.float32], stream)
    _build.check(err, "flash_attention_bias_bwd")
    flash_attention_bias_bwd.launches += 1
    return dq, dk, dv, dbias.to(bias.dtype)


flash_attention_bias_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd: forward K13 / K15, backward K14 / K16. The residuals are the
# inputs, and in bf16 on the card K13's output and lse as well
# ---------------------------------------------------------------------------

def hopper(t) -> bool:
    """Whether the attention of ``t`` runs the bf16 Hopper kernels, whose
    backward reads the forward's output and lse."""
    return on_cuda(t) and t.dtype == torch.bfloat16


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, kv_len):
        ctx.scale, ctx.kv_len = scale, kv_len
        if hopper(q):
            out, lse = _flash_attention_fwd(q, k, v, scale, kv_len, with_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
            return out
        ctx.save_for_backward(q, k, v)
        return _flash_attention_fwd(q, k, v, scale, kv_len)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, *stats = ctx.saved_tensors
        grads = flash_attention_bwd(q, k, v, g, ctx.scale, ctx.kv_len,
                                    **dict(zip(("out", "lse"), stats)))
        return needed(ctx, grads) + (None, None)


class _FlashAttentionBias(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, neg_mask, scale, kv_len):
        ctx.save_for_backward(q, k, v, bias, neg_mask)
        ctx.scale, ctx.kv_len = scale, kv_len
        return _flash_attention_bias_fwd(q, k, v, bias, neg_mask, scale, kv_len)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        grads = flash_attention_bias_bwd(*ctx.saved_tensors, g, ctx.scale, ctx.kv_len)
        return needed(ctx, grads) + (None, None, None)
