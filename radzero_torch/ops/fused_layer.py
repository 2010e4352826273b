"""K1-K4: the fused DINOv2 layer and the fused MPNet post-attention chain
(port of radzero_tpu/ops/fused_layer.py).

- :func:`fused_preattn`  (K1): qkv = ln1(x) @ Wqkv + b
- :func:`flash_attention_packed` (K2): attention over the packed
  (B, L, 3D) [q | k | v] buffer -> merged heads (B, L, D)
- :func:`fused_postattn` (K3): y = x + ls1 * (a @ Wo + bo);
  out = y + ls2 * (gelu(ln2(y) @ W1 + b1) @ W2 + b2)
- :func:`fused_mpnet_post` (K4): y = ln(x + a @ Wo + bo);
  out = ln(y + gelu(y @ W1 + b1) @ W2 + b2)   (post-LN, eps 1e-12)
- :func:`fused_postattn_tp` / :func:`fused_mpnet_post_tp`: K3 and K4
  row-parallel over a model group (``tp=``, the JAX tensor-parallel rules):
  the split o-proj and fc2 give fp32 partials that an all-reduce completes,
  and the row kernel :func:`tp_rows` (``csrc/tp_rows.cu``) runs the bias,
  LayerScale, residual and LayerNorm after each sum

Each wrapper runs its plain twin (``*_plain``, same module) when handed a
CPU tensor and launches its CUDA kernel (``csrc/fused_layer.cu``, whose K1,
K3 and K4 run their bf16 products on ``csrc/gemm_sm90.cu``; K2 and K7 are in
``csrc/flash_attention.cu`` and its Hopper sources, the strided attention
kernels K13 / K14 over the thirds of the packed buffer) when handed a CUDA
tensor; anything else raises. ``<wrapper>.launches`` counts
kernel launches. Numerics are the TPU kernels' contract: fp32 LayerNorm,
softmax and accumulation; the LN output, the GELU output and the softmax
weights are rounded to the operand type before the next product.

Each of the four is differentiable: handed an operand that requires a
gradient, with gradients enabled, it goes through a
``torch.autograd.Function`` whose forward is the same kernel and whose
backward is the matching backward kernel (port of the JAX ``*_vjp``
functions), otherwise straight to the forward (a frozen tower and serving
keep no tape):

- :func:`fused_preattn_bwd` (K6), :func:`flash_attention_packed_bwd` (K7),
  :func:`fused_postattn_bwd` (K8), :func:`fused_mpnet_post_bwd` (K9), each
  with its plain twin ``*_bwd_plain`` and a ``.launches`` counter;
- over a model group, split at their all-reduces:
  :func:`fused_preattn_bwd_tp` (K6, the backward of :func:`fused_preattn_tp`,
  K1 on a rank's heads), :func:`fused_postattn_bwd_tp` (K8) and
  :func:`fused_mpnet_post_bwd_tp` (K9), the backwards of the row-parallel K3
  and K4, each with its twin ``*_bwd_tp_plain(..., reduce=)`` and a
  counter. The cotangent of a layer's output is whole and the same on every
  rank (the forward's all-reduces give every rank the same bits); each
  chain runs one all-reduce, of an fp32 partial d(LN input) before the
  LayerNorm's backward rows, so the gradients of x and of the replicated
  operands come back whole and bit-equal on every rank, and a split
  operand's gradient is the rank's share. K3 and K4's Functions keep the
  forward's two fp32 sums for it (:class:`_RowParallelTp`).

:func:`fused_layer_save_attn` runs K1-K3 as one Function that keeps the
layer's input and the attention output and reruns K1 in its backward (the
``save_attn`` remat policy of a trainable tower).

The four kernels' Functions keep the inputs only (the row-parallel K3 and K4
also their two sums), but for K2 in bf16 on the card, which
also keeps its output and the row statistic ``lse`` its Hopper forward
writes (the Hopper backward of K7 reads P and delta = rowsum(dO O) from
them, :func:`flash_attention_packed_lse`). The backward recomputes the
forward chain (LN, fc1, GELU, fc2; in K7 otherwise the fp32 softmax) and
rounds to the operand type where the TPU kernels do: the LN output, the
GELU output, dm, dh1 and dproj, and in K7 p, dO and dS. Everything else is fp32. Gradients come back in the
operand's type after fp32 accumulation. On the card K6, K8 and K9 are
chains of launches composed here from the entry points of
``csrc/fused_layer_bwd.cu`` (products, row passes, fixed-order reduces: no
atomics, so every gradient has the same bits from run to run), with their
scratch allocated for the call and freed with it; no product of a chain
goes through ``torch.matmul``. In bf16 every product of a chain runs the
Hopper GEMM of ``csrc/gemm_sm90.cu`` (TMA and wgmma): the forward recompute
and the dX products with their epilogues, a dX = g W^T reading W as it is
stored (K-major), and the row-split dW products; fp32 runs ``gemm_f32_kernel``
/ ``wgrad_f32_kernel`` on the CUDA cores, its dX through a transposed copy.

Two differences from the TPU forward, both in the kernel and its twin:
GELU uses the exact erf (the TPU kernel's rational erf approximation,
<= 1.5e-7 off, exists because Mosaic has no erf), and the attention
softmax always subtracts the row max and never rounds the exponent
argument (the JAX bf16 serving shortcuts ``stable=False`` and
``round_bf16=True`` are not mirrored).
"""

from __future__ import annotations

import torch

from radzero_torch.ops import _build
from radzero_torch.ops._checks import (
    DTYPE_CODES, check_operands, exported, forbid_grad, needed, on_cuda, tracked,
)
from radzero_torch.ops.flash_attention import (
    flash_attention_bwd_plain, flash_attention_bwd_stats_plain, flash_attention_lse_plain,
    flash_attention_plain, hopper, stats_operands,
)
from radzero_torch.parallel.collectives import all_reduce_sum

_LOG2E = 1.4426950408889634
_INV_SQRT_2PI = 0.3989422804014327
# epilogue codes of csrc/gemm.cuh
(_EPI_BIAS, _EPI_GELU, _EPI_ADD_F32, _EPI_ADDF_F32, _EPI_PROJ2, _EPI_GELU_H1, _EPI_F32,
 _EPI_DGELU) = (0, 2, 4, 5, 6, 7, 8, 9)
_SPLIT_BLOCKS = 4 * 132  # blocks a row-split fp32 weight-gradient product aims at
# the bf16 dW product's cost model (_Chain.wgrad): a 128 x 128 tile's k-step of 64
# rows at ~600 TFLOP/s shared by the card's SMs (about what K1's product reaches on
# an H100), and the partial tiles written once and read once at 3.35 TB/s
_TILE_STEP_S = 2 * 128 * 128 * 64 / 600e12
_PART_BYTE_S = 2 / 3.35e12
# the row passes that sum columns run a fixed grid of this many blocks an SM,
# each block over one contiguous range of rows (row_partition)
_LN_BWD_BLOCKS_PER_SM = 2
_COLSUM_BLOCKS_PER_SM = 4
# the column sums a row pass writes (SUM_* of csrc/fused_layer_bwd.cu): the
# LayerNorm backward's dh * xn, dh, d * ls, d * proj; scale_colsum's g * m, g * ls
_SUM_DH_XN, _SUM_DH, _SUM_D_LS, _SUM_D_PROJ = 1, 2, 4, 8
_SUM_G_M, _SUM_G_LS = 1, 2
_REDUCE_COLS = 256  # columns of a reduce block (csrc/fused_layer_bwd.cu RT)
_REDUCE_MIN_ROWS = 8  # fewest partial rows a chunk of the two-level reduce adds


def row_partition(m, blocks):
    """The rows of a row pass that sums columns, over at most ``blocks``
    blocks -> (chunk, parts): block b owns rows [b chunk, min(m, (b + 1)
    chunk)), and the parts = ceil(m / chunk) blocks that hold rows write one
    partial row each. It depends only on m and ``blocks``, a multiple of
    the card's SM count, so the sums' order, and their bits, do too."""
    chunk = -(-m // blocks)
    return chunk, -(-m // chunk)


def reduce_split(s, n, sms):
    """Partial rows a chunk of the two-level reduce adds, for s partial rows
    of n columns on a card of ``sms`` SMs; None where one level suits: the
    columns alone fill the card twice over, or chunks would hold fewer than
    _REDUCE_MIN_ROWS rows."""
    chunks = min(-(-2 * sms // -(-n // _REDUCE_COLS)), s // _REDUCE_MIN_ROWS)
    return None if chunks < 2 else -(-s // chunks)


def _ln32(x32, scale, bias, eps):
    mu = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _ln_scratch(x, n, d):
    """The (n, d) bf16 buffer into which the bf16 kernels of K1, K3 and K4
    write each row's LayerNorm once, the A operand of gemm_sm90_kernel; None
    in fp32, where gemm_f32_kernel reads the LN from its prologue (K1, K3) or
    from K4's fp32 y."""
    if x.dtype != torch.bfloat16:
        return None
    return torch.empty((n, d), dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# K1: pre-attention LN -> packed qkv projection
# ---------------------------------------------------------------------------

def fused_preattn_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, *, eps=1e-6):
    h = _ln32(x.float(), ln_scale, ln_bias, eps).to(x.dtype)
    return (h.float() @ w_qkv.float() + b_qkv.float()).to(x.dtype)


def fused_preattn(x, ln_scale, ln_bias, w_qkv, b_qkv, *, eps=1e-6):
    """(N, D) x -> (N, 3D) packed qkv = ln1(x) @ w_qkv + b_qkv. On the card,
    one count: in bf16 two launches (the LN row pass, the product on
    gemm_sm90_kernel), in fp32 one (LN as the product's prologue).
    Differentiable: the backward is :func:`fused_preattn_bwd` (K6)."""
    if (op := exported("fused_preattn")) is not None:
        return op(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    if tracked(x, ln_scale, ln_bias, w_qkv, b_qkv):
        return _FusedPreattn.apply(x, ln_scale, ln_bias, w_qkv, b_qkv, eps, None)
    return _fused_preattn_fwd(x, ln_scale, ln_bias, w_qkv, b_qkv, eps=eps)


def _fused_preattn_fwd(x, ln_scale, ln_bias, w_qkv, b_qkv, *, eps):
    if not on_cuda(x):
        return fused_preattn_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, eps=eps)
    n, d = x.shape
    d3 = w_qkv.shape[1]
    code = check_operands(
        "fused_preattn", x,
        ln_scale=((d,), ln_scale), ln_bias=((d,), ln_bias),
        w_qkv=((d, d3), w_qkv), b_qkv=((d3,), b_qkv),
    )
    if d % 32 or d3 % 64:
        raise ValueError(f"fused_preattn: needs D % 32 == 0 and 3D % 64 == 0, got {d}, {d3}")
    out = torch.empty((n, d3), dtype=x.dtype, device=x.device)
    ln = _ln_scratch(x, n, d)
    lib = _build.load()
    err = lib.rz_fused_preattn(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w_qkv.data_ptr(),
        b_qkv.data_ptr(), None if ln is None else ln.data_ptr(), out.data_ptr(), n, d, d3,
        float(eps), code, _build.stream_ptr(x),
    )
    _build.check(err, "fused_preattn")
    fused_preattn.launches += 1
    return out


fused_preattn.launches = 0


def fused_preattn_tp(x, ln_scale, ln_bias, w_qkv, b_qkv, *, tp, eps=1e-6):
    """K1 on this rank's heads over the model group ``tp``: ``w_qkv`` (D,
    3D/P) / ``b_qkv`` its [q_r | k_r | v_r] columns, x and LN1 whole. The
    forward is :func:`fused_preattn`'s (no collective); under gradients the
    backward is :func:`fused_preattn_bwd_tp` (K6 over the axis, one
    all-reduce), so x's gradient comes back whole on every rank."""
    if tracked(x, ln_scale, ln_bias, w_qkv, b_qkv):
        return _FusedPreattn.apply(x, ln_scale, ln_bias, w_qkv, b_qkv, eps, tp)
    return _fused_preattn_fwd(x, ln_scale, ln_bias, w_qkv, b_qkv, eps=eps)


# ---------------------------------------------------------------------------
# K2: packed-layout attention
# ---------------------------------------------------------------------------

def _thirds(qkv, n_heads: int):
    """The q, k and v thirds of a packed (B, L, 3D) buffer as (B, L, H, hd) views."""
    b, l, d3 = qkv.shape
    d = d3 // 3
    return [qkv[..., i * d : (i + 1) * d].reshape(b, l, n_heads, d // n_heads) for i in range(3)]


def flash_attention_packed_plain(qkv, n_heads: int):
    b, l, d3 = qkv.shape
    return flash_attention_plain(*_thirds(qkv, n_heads)).reshape(b, l, d3 // 3)


def flash_attention_packed_lse_plain(qkv, n_heads: int):
    b, l, d3 = qkv.shape
    out, lse = flash_attention_lse_plain(*_thirds(qkv, n_heads))
    return out.reshape(b, l, d3 // 3), lse


def flash_attention_packed(qkv, n_heads: int):
    """(B, L, 3D) packed [q | k | v] -> (B, L, D) merged heads, softmax
    scale head_dim ** -0.5. No lane padding: the kernel masks keys >= L
    in its last tile itself. Differentiable: the backward is
    :func:`flash_attention_packed_bwd` (K7)."""
    if (op := exported("flash_attention_packed")) is not None:
        return op(qkv, n_heads)
    if tracked(qkv):
        return _FlashAttentionPacked.apply(qkv, n_heads)
    return _flash_attention_packed_fwd(qkv, n_heads)


def flash_attention_packed_lse(qkv, n_heads: int):
    """:func:`flash_attention_packed` that also returns the row statistic
    its backward reads: (out, lse), ``lse`` (B, H, L) fp32 as
    :func:`radzero_torch.ops.flash_attention.flash_attention_lse` gives it.
    Forward only; on the card bf16 only; on the CPU the twin."""
    forbid_grad("flash_attention_packed_lse", "call flash_attention_packed", qkv)
    return _flash_attention_packed_fwd(qkv, n_heads, with_lse=True)


def _flash_attention_packed_fwd(qkv, n_heads: int, with_lse=False):
    if not on_cuda(qkv):
        if with_lse:
            return flash_attention_packed_lse_plain(qkv, n_heads)
        return flash_attention_packed_plain(qkv, n_heads)
    b, l, d3 = qkv.shape
    d = d3 // 3
    hd = d // n_heads
    code = check_operands("flash_attention_packed", qkv)
    if hd != 64 or d3 != 3 * n_heads * hd:
        raise ValueError(f"flash_attention_packed: the kernel takes head_dim 64, got {hd}")
    if with_lse and qkv.dtype != torch.bfloat16:
        raise ValueError("flash_attention_packed: only the bf16 kernel writes lse")
    out = torch.empty((b, l, d), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((b, n_heads, l), dtype=torch.float32, device=qkv.device) if with_lse
           else None)
    lib = _build.load()
    err = lib.rz_packed_attention(
        qkv.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(), b, l, n_heads,
        hd, float(hd**-0.5), code, _build.stream_ptr(qkv),
    )
    _build.check(err, "flash_attention_packed")
    flash_attention_packed.launches += 1
    return (out, lse) if with_lse else out


flash_attention_packed.launches = 0


# ---------------------------------------------------------------------------
# K3: post-attention o-proj + residual + LN2 + MLP + residual
# ---------------------------------------------------------------------------

def fused_postattn_plain(x, attn_out, wo, bo, ls1, ln_scale, ln_bias,
                         w1, b1, w2, b2, ls2, *, eps=1e-6):
    cdt = x.dtype
    proj = attn_out.float() @ wo.float() + bo.float()
    y32 = x.float() + ls1.float() * proj
    h = _ln32(y32, ln_scale, ln_bias, eps).to(cdt)
    h = torch.nn.functional.gelu(h.float() @ w1.float() + b1.float()).to(cdt)
    m = h.float() @ w2.float() + b2.float()
    return (y32 + ls2.float() * m).to(cdt)


def fused_postattn(x, attn_out, wo, bo, ls1, ln_scale, ln_bias,
                   w1, b1, w2, b2, ls2, *, eps=1e-6):
    """(N, D) residual stream + merged-head attention output -> next
    residual stream. On the card, one count: in bf16 four launches (o-proj
    with the fp32 residual y, the LN2 row pass, fc1 + GELU, fc2 + residual,
    the products on gemm_sm90_kernel), in fp32 three (LN2 as fc1's prologue).
    Differentiable: the backward is :func:`fused_postattn_bwd` (K8)."""
    ops = (x, attn_out, wo, bo, ls1, ln_scale, ln_bias, w1, b1, w2, b2, ls2)
    if (op := exported("fused_postattn")) is not None:
        return op(*ops, eps)
    if tracked(*ops):
        return _FusedPostattn.apply(*ops, eps)
    return _fused_postattn_fwd(*ops, eps=eps)


def _fused_postattn_fwd(x, attn_out, wo, bo, ls1, ln_scale, ln_bias,
                        w1, b1, w2, b2, ls2, *, eps):
    if not on_cuda(x):
        return fused_postattn_plain(x, attn_out, wo, bo, ls1, ln_scale, ln_bias,
                                    w1, b1, w2, b2, ls2, eps=eps)
    n, d = x.shape
    f = w1.shape[1]
    code = check_operands(
        "fused_postattn", x,
        attn_out=((n, d), attn_out), wo=((d, d), wo), bo=((d,), bo), ls1=((d,), ls1),
        ln_scale=((d,), ln_scale), ln_bias=((d,), ln_bias), w1=((d, f), w1),
        b1=((f,), b1), w2=((f, d), w2), b2=((d,), b2), ls2=((d,), ls2),
    )
    if d % 64 or f % 64:
        raise ValueError(f"fused_postattn: needs D % 64 == 0 and F % 64 == 0, got {d}, {f}")
    y32 = torch.empty((n, d), dtype=torch.float32, device=x.device)
    ln = _ln_scratch(x, n, d)
    h = torch.empty((n, f), dtype=x.dtype, device=x.device)
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    lib = _build.load()
    err = lib.rz_fused_postattn(
        x.data_ptr(), attn_out.data_ptr(), wo.data_ptr(), bo.data_ptr(), ls1.data_ptr(),
        ln_scale.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), ls2.data_ptr(), y32.data_ptr(),
        None if ln is None else ln.data_ptr(), h.data_ptr(), out.data_ptr(), n, d, f,
        float(eps), code, _build.stream_ptr(x),
    )
    _build.check(err, "fused_postattn")
    fused_postattn.launches += 1
    return out


fused_postattn.launches = 0


# ---------------------------------------------------------------------------
# K4: MPNet post-attention chain, post-LN
# ---------------------------------------------------------------------------

def fused_mpnet_post_plain(x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2,
                           lnso, lnbo, *, eps=1e-12):
    cdt = x.dtype
    u = x.float() + attn_out.float() @ wo.float() + bo.float()
    y32 = _ln32(u, lnsa, lnba, eps)  # stays fp32: fc1 operand (rounded) and residual
    h = torch.nn.functional.gelu(y32.to(cdt).float() @ w1.float() + b1.float()).to(cdt)
    m = h.float() @ w2.float() + b2.float()
    return _ln32(y32 + m, lnso, lnbo, eps).to(cdt)


def fused_mpnet_post(x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2,
                     lnso, lnbo, *, eps=1e-12):
    """(M, D) layer input + merged-head attention output -> layer output:
    y = ln(x + attn_out @ wo + bo); out = ln(y + gelu(y @ w1 + b1) @ w2 + b2).
    On the card: five launches, one count: o-proj + residual into fp32 u, row
    LN of u, fc1 + GELU, fc2 + y into fp32, row LN into the output. In bf16
    the three products run gemm_sm90_kernel and the first row pass writes y
    twice from one fp32 value, rounded (fc1's operand) and in fp32 (the
    residual), as K9's recompute does; fp32 runs gemm_f32_kernel. Rows need
    not be a multiple of any tile. Differentiable: the backward is
    :func:`fused_mpnet_post_bwd` (K9)."""
    ops = (x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2, lnso, lnbo)
    if (op := exported("fused_mpnet_post")) is not None:
        return op(*ops, eps)
    if tracked(*ops):
        return _FusedMpnetPost.apply(*ops, eps)
    return _fused_mpnet_post_fwd(*ops, eps=eps)


def _fused_mpnet_post_fwd(x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2,
                          lnso, lnbo, *, eps):
    if not on_cuda(x):
        return fused_mpnet_post_plain(x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2,
                                      lnso, lnbo, eps=eps)
    m, d = x.shape
    f = w1.shape[1]
    code = check_operands(
        "fused_mpnet_post", x,
        attn_out=((m, d), attn_out), wo=((d, d), wo), bo=((d,), bo),
        lnsa=((d,), lnsa), lnba=((d,), lnba), w1=((d, f), w1), b1=((f,), b1),
        w2=((f, d), w2), b2=((d,), b2), lnso=((d,), lnso), lnbo=((d,), lnbo),
    )
    if d % 64 or f % 64:
        raise ValueError(f"fused_mpnet_post: needs D % 64 == 0 and F % 64 == 0, got {d}, {f}")
    u32 = torch.empty((m, d), dtype=torch.float32, device=x.device)
    y32 = torch.empty((m, d), dtype=torch.float32, device=x.device)
    yln = _ln_scratch(x, m, d)
    h = torch.empty((m, f), dtype=x.dtype, device=x.device)
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    lib = _build.load()
    err = lib.rz_fused_mpnet_post(
        x.data_ptr(), attn_out.data_ptr(), wo.data_ptr(), bo.data_ptr(), lnsa.data_ptr(),
        lnba.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        lnso.data_ptr(), lnbo.data_ptr(), u32.data_ptr(), y32.data_ptr(),
        None if yln is None else yln.data_ptr(), h.data_ptr(), out.data_ptr(), m, d, f,
        float(eps), code, _build.stream_ptr(x),
    )
    _build.check(err, "fused_mpnet_post")
    fused_mpnet_post.launches += 1
    return out


fused_mpnet_post.launches = 0


# ---------------------------------------------------------------------------
# K3 and K4 over a model axis: row-parallel o-proj and fc2, the row kernel
# ---------------------------------------------------------------------------

def tp_rows_plain(base, acc, bias, *, ls=None, ln=None, dtype, eps=1e-6, keep_u=False,
                  keep_ln32=False, keep_v=False, want_out=True):
    """v = acc + bias (without ``bias``: acc) and u = base + ls * v (without
    ``ls``: base + v) in fp32 -> (LN(u) under ``ln`` = (scale, bias), else u,
    in ``dtype``, or None without ``want_out``; u in fp32 with ``keep_u``,
    else None; LN(u) in fp32 with ``keep_ln32``, else None; v in fp32 with
    ``keep_v``, else None)."""
    v = acc.float() if bias is None else acc.float() + bias.float()
    u = base.float() + (v if ls is None else ls.float() * v)
    y = u if ln is None else _ln32(u, *ln, eps)
    return (y.to(dtype) if want_out else None, u if keep_u else None, y if keep_ln32 else None,
            v if keep_v else None)


def tp_rows(base, acc, bias, *, ls=None, ln=None, dtype, eps=1e-6, keep_u=False,
            keep_ln32=False, keep_v=False, want_out=True):
    """The row kernel after the all-reduce of a row-parallel product
    (``csrc/tp_rows.cu`` ``tp_rows_kernel``; no TPU kernel of its own: the
    epilogue that K3's and K4's split o-proj and fc2 cannot run before the
    sum, and the rows that K8's and K9's split backwards rerun on the sums
    the forward kept): ``base`` (M, D) in ``dtype`` or fp32, ``acc`` (M, D)
    fp32, the (D,) vectors in ``dtype`` (``bias`` may be None) -> what
    :func:`tp_rows_plain` returns. One launch, one count; D % 8 == 0 and D
    <= 1024."""
    if not on_cuda(acc):
        return tp_rows_plain(base, acc, bias, ls=ls, ln=ln, dtype=dtype, eps=eps, keep_u=keep_u,
                             keep_ln32=keep_ln32, keep_v=keep_v, want_out=want_out)
    m, d = acc.shape
    if dtype not in DTYPE_CODES:
        raise TypeError(f"tp_rows: dtype must be float32 or bfloat16, got {dtype}")
    vecs = {"bias": bias, "ls": ls, **({} if ln is None else {"ln_scale": ln[0], "ln_bias": ln[1]})}
    for name, t in vecs.items():
        if t is None:
            continue
        if t.dtype != dtype or t.device != acc.device or tuple(t.shape) != (d,):
            raise ValueError(f"tp_rows: {name} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {dtype} ({d},) on {acc.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"tp_rows: {name} must be contiguous and 16-byte aligned")
    for name, t, types in (("base", base, (dtype, torch.float32)), ("acc", acc, (torch.float32,))):
        if t.dtype not in types or t.device != acc.device or tuple(t.shape) != (m, d):
            raise ValueError(f"tp_rows: {name} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected one of {types} ({m}, {d}) on {acc.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"tp_rows: {name} must be contiguous and 16-byte aligned")
    if d % 8 or d > 1024:
        raise ValueError(f"tp_rows: needs D % 8 == 0 and D <= 1024, got {d}")
    if keep_ln32 and ln is None:
        raise ValueError("tp_rows: keep_ln32 needs ln")
    out = torch.empty((m, d), dtype=dtype, device=acc.device) if want_out else None
    u32, y32, v32 = (torch.empty((m, d), dtype=torch.float32, device=acc.device) if keep else None
                     for keep in (keep_u, keep_ln32, keep_v))
    p = _Chain._ptr
    err = _build.load().rz_tp_rows(
        base.data_ptr(), int(base.dtype == torch.float32), acc.data_ptr(), p(bias), p(ls),
        p(None if ln is None else ln[0]), p(None if ln is None else ln[1]), p(out), p(u32),
        p(y32), p(v32), m, d, float(eps), DTYPE_CODES[dtype], _build.stream_ptr(acc))
    _build.check(err, "tp_rows")
    tp_rows.launches += 1
    return out, u32, y32, v32


tp_rows.launches = 0


def _reducer(tp):
    """The sum over the model group ``tp`` as a chain's ``reduce``."""
    return lambda t: all_reduce_sum(t, tp)


def fused_postattn_tp_plain(x, attn_out, wo, bo, ls1, ln_scale, ln_bias, w1, b1, w2, b2, ls2, *,
                            reduce, eps=1e-6, keep=False):
    """K3's plain twin over a model axis; ``reduce`` sums a partial product
    over the ranks (the identity on one rank's share alone). ``keep`` ->
    (out, kept): kept = (the o-proj sum, m = the fc2 sum + b2), fp32, what
    :func:`fused_postattn_bwd_tp` reads in place of the forward's products."""
    cdt = x.dtype
    acc1 = reduce(attn_out.float() @ wo.float())
    hln, y32, _, _ = tp_rows_plain(x, acc1, bo, ls=ls1, ln=(ln_scale, ln_bias), dtype=cdt,
                                   eps=eps, keep_u=True)
    h = torch.nn.functional.gelu(hln.float() @ w1.float() + b1.float()).to(cdt)
    acc = reduce(h.float() @ w2.float())
    out, _, _, m32 = tp_rows_plain(y32, acc, b2, ls=ls2, dtype=cdt, keep_v=keep)
    return (out, (acc1, m32)) if keep else out


def fused_postattn_tp(x, attn_out, wo, bo, ls1, ln_scale, ln_bias, w1, b1, w2, b2, ls2, *, tp,
                      eps=1e-6):
    """K3 row-parallel over the model group ``tp`` (the JAX rules' split):
    ``attn_out`` (N, D/P) holds this rank's heads, ``wo`` (D/P, D) their
    rows, ``w1`` (D, F/P) / ``b1`` (F/P,) this rank's MLP columns and ``w2``
    (F/P, D) their rows; x, ``bo``, the LayerScales, LN2 and ``b2`` are
    whole. Each rank returns the whole (N, D) output. On the card, one count:
    the o-proj partial (gemm_sm90_kernel ``EPI_F32`` in bf16,
    gemm_f32_kernel in fp32) into fp32, :func:`all_reduce_sum`, the row
    kernel (y32 = x + ls1 (acc + bo) and LN2), fc1 + GELU, the fc2 partial,
    the all-reduce, the row kernel's end form (y32 + ls2 (acc + b2)). The
    biases of the split products are added once, after the sum.
    Differentiable: under gradients it keeps the two sums (see
    :func:`postattn_tp_chain`) and its backward is
    :func:`fused_postattn_bwd_tp` (K8 over the axis)."""
    ops = (x, attn_out, wo, bo, ls1, ln_scale, ln_bias, w1, b1, w2, b2, ls2)
    if tracked(*ops):
        return _RowParallelTp.apply(postattn_tp_chain, fused_postattn_bwd_tp, eps, tp, *ops)
    return postattn_tp_chain(*ops, reduce=_reducer(tp), eps=eps)


def postattn_tp_chain(x, attn_out, wo, bo, ls1, ln_scale, ln_bias, w1, b1, w2, b2, ls2, *,
                      reduce, eps=1e-6, keep=False):
    """:func:`fused_postattn_tp` with the sum over the ranks given as
    ``reduce``: the twin for a CPU tensor, the chain of launches on the card.
    ``keep`` -> (out, kept) as :func:`fused_postattn_tp_plain`: the end row
    kernel also writes m = acc + b2 in fp32."""
    if not on_cuda(x):
        return fused_postattn_tp_plain(x, attn_out, wo, bo, ls1, ln_scale, ln_bias, w1, b1, w2,
                                       b2, ls2, reduce=reduce, eps=eps, keep=keep)
    n, d = x.shape
    dl, fl = wo.shape[0], w1.shape[1]
    code = check_operands(
        "fused_postattn_tp", x,
        attn_out=((n, dl), attn_out), wo=((dl, d), wo), bo=((d,), bo), ls1=((d,), ls1),
        ln_scale=((d,), ln_scale), ln_bias=((d,), ln_bias), w1=((d, fl), w1),
        b1=((fl,), b1), w2=((fl, d), w2), b2=((d,), b2), ls2=((d,), ls2),
    )
    if d % 64 or dl % 32 or fl % 64:
        raise ValueError(f"fused_postattn_tp: needs D % 64, D/P % 32 and F/P % 64 == 0, got "
                         f"{d}, {dl}, {fl}")
    k = _Chain("fused_postattn_tp", x, code)
    acc1 = reduce(k.gemm(attn_out, wo, _EPI_F32, k.f32(n, d)))
    hln, y32, _, _ = tp_rows(x, acc1, bo, ls=ls1, ln=(ln_scale, ln_bias), dtype=x.dtype, eps=eps,
                             keep_u=True)
    h = k.gemm(hln, w1, _EPI_GELU, k.t(n, fl), bias=b1)
    del hln
    acc = reduce(k.gemm(h, w2, _EPI_F32, k.f32(n, d)))
    out, _, _, m32 = tp_rows(y32, acc, b2, ls=ls2, dtype=x.dtype, keep_v=keep)
    fused_postattn_tp.launches += 1
    return (out, (acc1, m32)) if keep else out


fused_postattn_tp.launches = 0


def fused_mpnet_post_tp_plain(x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2, lnso, lnbo, *,
                              reduce, eps=1e-12, keep=False):
    """K4's plain twin over a model axis; ``reduce`` as in
    :func:`fused_postattn_tp_plain`. ``keep`` -> (out, kept): kept = (the
    o-proj sum, v = y + the fc2 sum + b2, the output LN's input), fp32."""
    cdt = x.dtype
    acc1 = reduce(attn_out.float() @ wo.float())
    yln, _, y32, _ = tp_rows_plain(x, acc1, bo, ln=(lnsa, lnba), dtype=cdt, eps=eps,
                                   keep_ln32=True)
    h = torch.nn.functional.gelu(yln.float() @ w1.float() + b1.float()).to(cdt)
    acc = reduce(h.float() @ w2.float())
    out, v32, _, _ = tp_rows_plain(y32, acc, b2, ln=(lnso, lnbo), dtype=cdt, eps=eps, keep_u=keep)
    return (out, (acc1, v32)) if keep else out


def fused_mpnet_post_tp(x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2, lnso, lnbo, *, tp,
                        eps=1e-12):
    """K4 row-parallel over the model group ``tp``, split as
    :func:`fused_postattn_tp`'s operands are. On the card, one count: the
    o-proj partial into fp32, the all-reduce, the row kernel (u = x + (acc +
    bo), y = LN(u) written rounded, fc1's operand, and in fp32, the
    residual, from one fp32 value), fc1 + GELU, the fc2 partial, the
    all-reduce, the row kernel's end form (LN(y32 + (acc + b2))).
    Differentiable: the backward is :func:`fused_mpnet_post_bwd_tp` (K9 over
    the axis)."""
    ops = (x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2, lnso, lnbo)
    if tracked(*ops):
        return _RowParallelTp.apply(mpnet_post_tp_chain, fused_mpnet_post_bwd_tp, eps, tp,
                                   *ops)
    return mpnet_post_tp_chain(*ops, reduce=_reducer(tp), eps=eps)


def mpnet_post_tp_chain(x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2, lnso, lnbo, *, reduce,
                        eps=1e-12, keep=False):
    """:func:`fused_mpnet_post_tp` with the sum over the ranks given as
    ``reduce``; ``keep`` as in :func:`fused_mpnet_post_tp_plain` (the end row
    kernel also writes v in fp32)."""
    if not on_cuda(x):
        return fused_mpnet_post_tp_plain(x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2, lnso,
                                         lnbo, reduce=reduce, eps=eps, keep=keep)
    m, d = x.shape
    dl, fl = wo.shape[0], w1.shape[1]
    code = check_operands(
        "fused_mpnet_post_tp", x,
        attn_out=((m, dl), attn_out), wo=((dl, d), wo), bo=((d,), bo),
        lnsa=((d,), lnsa), lnba=((d,), lnba), w1=((d, fl), w1), b1=((fl,), b1),
        w2=((fl, d), w2), b2=((d,), b2), lnso=((d,), lnso), lnbo=((d,), lnbo),
    )
    if d % 64 or dl % 32 or fl % 64:
        raise ValueError(f"fused_mpnet_post_tp: needs D % 64, D/P % 32 and F/P % 64 == 0, got "
                         f"{d}, {dl}, {fl}")
    k = _Chain("fused_mpnet_post_tp", x, code)
    bf16 = x.dtype == torch.bfloat16
    acc1 = reduce(k.gemm(attn_out, wo, _EPI_F32, k.f32(m, d)))
    yln, _, y32, _ = tp_rows(x, acc1, bo, ln=(lnsa, lnba), dtype=x.dtype, eps=eps,
                             keep_ln32=bf16)
    h = k.gemm(yln, w1, _EPI_GELU, k.t(m, fl), bias=b1)
    if bf16:
        del yln
    else:  # fp32: one buffer is fc1's operand and the residual
        y32 = yln
    acc = reduce(k.gemm(h, w2, _EPI_F32, k.f32(m, d)))
    out, v32, _, _ = tp_rows(y32, acc, b2, ln=(lnso, lnbo), dtype=x.dtype, eps=eps, keep_u=keep)
    fused_mpnet_post_tp.launches += 1
    return (out, (acc1, v32)) if keep else out


fused_mpnet_post_tp.launches = 0


# ---------------------------------------------------------------------------
# The backward kernels: plain twins
# ---------------------------------------------------------------------------

def _ln_parts(u32, eps):
    """-> (xn, rstd) of fp32 rows: the normalised rows and 1 / std."""
    xc = u32 - u32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return xc * rstd, rstd


def _ln_input_grad(dh, xn, rstd, scale32):
    """Gradient of LN's input from the gradient ``dh`` of its output."""
    dxn = dh * scale32
    m1 = dxn.mean(dim=-1, keepdim=True)
    m2 = (dxn * xn).mean(dim=-1, keepdim=True)
    return rstd * (dxn - m1 - xn * m2)


def _gelu_parts(h1):
    """-> (Phi(h1), gelu'(h1)) with the exact erf and the exp2 density."""
    phi = 0.5 * (1.0 + torch.erf(h1 * 2.0**-0.5))
    pdf = _INV_SQRT_2PI * torch.exp2(-(h1 * h1) * (0.5 * _LOG2E))
    return phi, phi + h1 * pdf


def _same(t):
    """The sum over one rank: the identity."""
    return t


def fused_preattn_bwd_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, g, *, eps=1e-6):
    return fused_preattn_bwd_tp_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, g, reduce=_same, eps=eps)


def fused_preattn_bwd_tp_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, g, *, reduce, eps=1e-6):
    """K6's twin over a model axis: ``w_qkv`` / ``b_qkv`` / ``g`` this rank's
    [q_r | k_r | v_r] columns; dh = g @ w_qkv^T is a partial that ``reduce``
    sums before LN1's backward, so dx, d ln_scale and d ln_bias are whole."""
    cdt = x.dtype
    scale = ln_scale.float()
    xn, rstd = _ln_parts(x.float(), eps)
    h = xn * scale + ln_bias.float()
    g32 = g.float()
    dh = reduce(g32 @ w_qkv.float().T)
    dw = h.to(cdt).float().T @ g32
    dx = _ln_input_grad(dh, xn, rstd, scale)
    return (dx.to(cdt), (dh * xn).sum(0).to(ln_scale.dtype), dh.sum(0).to(ln_bias.dtype),
            dw.to(w_qkv.dtype), g32.sum(0).to(b_qkv.dtype))


def flash_attention_packed_bwd_plain(qkv, n_heads: int, dout, *, out=None, lse=None):
    """The contract; ``out`` and ``lse`` are accepted and ignored."""
    q, k, v = _thirds(qkv, n_heads)
    grads = flash_attention_bwd_plain(q, k, v, dout.to(qkv.dtype).reshape(q.shape))
    return torch.cat([g.reshape(dout.shape) for g in grads], dim=-1)


def flash_attention_packed_bwd_stats_plain(qkv, n_heads: int, dout, out, lse):
    """The bf16 Hopper backward's arithmetic (P from ``lse``, delta =
    rowsum(dO O)) over the packed layout."""
    q, k, v = _thirds(qkv, n_heads)
    grads = flash_attention_bwd_stats_plain(q, k, v, dout.to(qkv.dtype).reshape(q.shape),
                                            out.reshape(q.shape), lse)
    return torch.cat([g.reshape(dout.shape) for g in grads], dim=-1)


def fused_postattn_bwd_plain(x, attn_out, wo, bo, ls1, ln_scale, ln_bias,
                             w1, b1, w2, b2, ls2, g, *, eps=1e-6):
    return fused_postattn_bwd_tp_plain(x, attn_out, wo, bo, ls1, ln_scale, ln_bias, w1, b1, w2,
                                       b2, ls2, g, reduce=_same, eps=eps)


def fused_postattn_bwd_tp_plain(x, attn_out, wo, bo, ls1, ln_scale, ln_bias, w1, b1, w2, b2, ls2,
                                g, *, reduce, kept=None, eps=1e-6):
    """K8's twin over a model axis, the operands split as
    :func:`fused_postattn_tp`'s; ``g`` whole. Without ``kept`` it sums the
    forward's two partial products again through ``reduce``; with ``kept``
    (:func:`fused_postattn_tp_plain`'s) it reads them. d ls2, dm and db2 come
    from the whole g; dW2, dh1, db1 and dW1 are the rank's; dhln is a
    partial that ``reduce`` sums before LN2's backward rows, which give dy,
    dproj, d LN2, dbo and d ls1 whole; da and dWo are the rank's."""
    cdt = x.dtype
    a32, wo32, w1_32, w2_32 = attn_out.float(), wo.float(), w1.float(), w2.float()
    ls1_32, ls2_32, lnscale = ls1.float(), ls2.float(), ln_scale.float()
    # forward recompute
    proj = (reduce(a32 @ wo32) if kept is None else kept[0]) + bo.float()
    y32 = x.float() + ls1_32 * proj
    yn, rstd = _ln_parts(y32, eps)
    hlnc = (yn * lnscale + ln_bias.float()).to(cdt).float()
    h1 = hlnc @ w1_32 + b1.float()
    phi, dgelu = _gelu_parts(h1)
    glc = (h1 * phi).to(cdt).float()
    m = reduce(glc @ w2_32) + b2.float() if kept is None else kept[1]
    # backward
    g32 = g.float()
    dls2 = (g32 * m).sum(0)
    dm = g32 * ls2_32
    dmc = dm.to(cdt).float()
    dw2 = glc.T @ dmc
    dh1 = (dmc @ w2_32.T) * dgelu
    dh1c = dh1.to(cdt).float()
    dw1 = hlnc.T @ dh1c
    dhln = reduce(dh1c @ w1_32.T)
    dy = g32 + _ln_input_grad(dhln, yn, rstd, lnscale)
    dproj = dy * ls1_32
    dprojc = dproj.to(cdt).float()
    da = dprojc @ wo32.T
    dwo = a32.T @ dprojc
    return (dy.to(cdt), da.to(cdt), dwo.to(wo.dtype), dproj.sum(0).to(bo.dtype),
            (dy * proj).sum(0).to(ls1.dtype), (dhln * yn).sum(0).to(ln_scale.dtype),
            dhln.sum(0).to(ln_bias.dtype), dw1.to(w1.dtype), dh1.sum(0).to(b1.dtype),
            dw2.to(w2.dtype), dm.sum(0).to(b2.dtype), dls2.to(ls2.dtype))


def fused_mpnet_post_bwd_plain(x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2,
                               lnso, lnbo, g, *, eps=1e-12):
    cdt = x.dtype
    a32, wo32, w1_32, w2_32 = attn_out.float(), wo.float(), w1.float(), w2.float()
    lnsa32, lnso32 = lnsa.float(), lnso.float()
    # forward recompute
    u = x.float() + a32 @ wo32 + bo.float()
    un, rstd1 = _ln_parts(u, eps)
    yln = un * lnsa32 + lnba.float()
    ylnc = yln.to(cdt).float()
    h1 = ylnc @ w1_32 + b1.float()
    phi, dgelu = _gelu_parts(h1)
    glc = (h1 * phi).to(cdt).float()
    v = yln + glc @ w2_32 + b2.float()
    return _mpnet_post_grads(x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2, lnso, lnbo, g,
                             u, v, ylnc, h1, glc, reduce=_same, eps=eps)


def fused_mpnet_post_bwd_tp_plain(x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2, lnso, lnbo, g,
                                  *, reduce, kept=None, eps=1e-12):
    """K9's twin over a model axis, the operands split as
    :func:`fused_mpnet_post_tp`'s; ``g`` whole; ``kept`` as in
    :func:`fused_postattn_bwd_tp_plain` (:func:`fused_mpnet_post_tp_plain`'s).
    The output LN's backward rows from the whole g give dv, d LN_out and
    db2 whole; dW2, dh1, db1 and dW1 are the rank's; dyln = dv + the sum of
    the ranks' dh1 @ W1^T; the first LN's rows give du, d LN_attn and dbo
    whole; da and dWo are the rank's."""
    cdt = x.dtype
    a32, w1_32, w2_32 = attn_out.float(), w1.float(), w2.float()
    u = x.float() + ((reduce(a32 @ wo.float()) if kept is None else kept[0]) + bo.float())
    un, _ = _ln_parts(u, eps)
    yln = un * lnsa.float() + lnba.float()
    ylnc = yln.to(cdt).float()
    h1 = ylnc @ w1_32 + b1.float()
    phi, _ = _gelu_parts(h1)
    glc = (h1 * phi).to(cdt).float()
    v = yln + (reduce(glc @ w2_32) + b2.float()) if kept is None else kept[1]
    return _mpnet_post_grads(x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2, lnso, lnbo, g,
                             u, v, ylnc, h1, glc, reduce=reduce, eps=eps)


def _mpnet_post_grads(x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2, lnso, lnbo, g, u, v, ylnc,
                      h1, glc, *, reduce, eps):
    """K9's backward from the forward's u and v (fp32), the rounded y, the
    pre-GELU h1 and the rounded GELU output; ``reduce`` sums dh1 @ W1^T."""
    cdt = x.dtype
    un, rstd1 = _ln_parts(u, eps)
    vn, rstd2 = _ln_parts(v, eps)
    _, dgelu = _gelu_parts(h1)
    g32 = g.float()
    dv = _ln_input_grad(g32, vn, rstd2, lnso.float())
    dmc = dv.to(cdt).float()
    dw2 = glc.T @ dmc
    dh1 = (dmc @ w2.float().T) * dgelu
    dh1c = dh1.to(cdt).float()
    dw1 = ylnc.T @ dh1c
    dyln = dv + reduce(dh1c @ w1.float().T)
    du = _ln_input_grad(dyln, un, rstd1, lnsa.float())
    dprojc = du.to(cdt).float()
    da = dprojc @ wo.float().T
    dwo = attn_out.float().T @ dprojc
    return (du.to(cdt), da.to(cdt), dwo.to(wo.dtype), du.sum(0).to(bo.dtype),
            (dyln * un).sum(0).to(lnsa.dtype), dyln.sum(0).to(lnba.dtype),
            dw1.to(w1.dtype), dh1.sum(0).to(b1.dtype), dw2.to(w2.dtype),
            dv.sum(0).to(b2.dtype), (g32 * vn).sum(0).to(lnso.dtype),
            g32.sum(0).to(lnbo.dtype))


# ---------------------------------------------------------------------------
# The backward kernels on the card
# ---------------------------------------------------------------------------

class _Chain:
    """One backward chain on the card: the entry points of
    csrc/fused_layer_bwd.cu on ``like``'s device, dtype and current stream.
    Every buffer is a torch tensor that lives as long as the caller holds it;
    the launches are stream-ordered, so a buffer may be dropped right after
    the last launch that reads it."""

    def __init__(self, name, like, code):
        self.name, self.code, self.dev, self.dtype = name, code, like.device, like.dtype
        self.lib = _build.load()
        self.stream = _build.stream_ptr(like)
        self.gemm_tile = self.lib.rz_bwd_gemm_row_tile(code)
        self.sms = torch.cuda.get_device_properties(like.device).multi_processor_count

    def f32(self, *shape):
        return torch.empty(shape, dtype=torch.float32, device=self.dev)

    def t(self, *shape):
        return torch.empty(shape, dtype=self.dtype, device=self.dev)

    def _ok(self, err):
        _build.check(err, self.name)

    @staticmethod
    def _ptr(t):
        return None if t is None else t.data_ptr()

    def gemm(self, a, w, epi, out, *, w_t=False, bias=None, resid=None, ls=None, aux=None,
             out2=None, colpart=None):
        """out (M, N) = a (M, K) @ w (K, N) through epilogue ``epi``; with
        ``w_t``, a @ w.T for w (N, K) (bf16 only)."""
        (m, k), n = a.shape, w.shape[0 if w_t else 1]
        p = self._ptr
        self._ok(self.lib.rz_bwd_gemm(p(a), p(w), p(bias), p(resid), p(ls), p(aux), p(out),
                                      p(out2), p(colpart), m, n, k, epi, int(w_t), self.code,
                                      self.stream))
        return out

    def gemm_t(self, a, w, epi, out, **kw):
        """out (M, K_w) = a (M, N_w) @ w.T for a weight w (K_w, N_w): in bf16 the
        product reads w as it is stored; fp32 reads a transposed copy."""
        if self.dtype == torch.bfloat16:
            return self.gemm(a, w, epi, out, w_t=True, **kw)
        k, n = w.shape
        wt = self.t(n, k)
        self._ok(self.lib.rz_transpose(w.data_ptr(), wt.data_ptr(), k, n, self.code, self.stream))
        return self.gemm(a, wt, epi, out, **kw)

    def dgelu_gemm(self, dm, w2, h1):
        """dh1 = (dm @ w2.T) * gelu'(h1) rounded, and db1 = colsum(dh1)."""
        m, f = h1.shape
        tiles = -(-m // self.gemm_tile)
        colpart = self.f32(tiles, f)
        dh1 = self.gemm_t(dm, w2, _EPI_DGELU, self.t(m, f), aux=h1, colpart=colpart)
        return dh1, self.reduce(colpart, tiles, (f,))

    def reduce(self, part, s, shape):
        """Sum ``part`` (s, *shape) fp32 over s in a fixed order, rounded once
        -> operand type: in two levels (chunks of partial rows in order, then
        the chunks in order; reduce_split) where few columns meet many
        partial rows, else one thread a column over all s."""
        out = self.t(*shape)
        n = out.numel()
        per = reduce_split(s, n, self.sms)
        if per is None:
            self._ok(self.lib.rz_reduce_parts(part.data_ptr(), out.data_ptr(), s, n, self.code,
                                              self.stream))
        else:
            scratch = self.f32(-(-s // per), n)
            self._ok(self.lib.rz_reduce_two_level(part.data_ptr(), scratch.data_ptr(),
                                                  out.data_ptr(), s, n, per, self.code,
                                                  self.stream))
        return out

    def wgrad(self, a, g):
        """a (M, Ka)^T @ g (M, Nb) -> (Ka, Nb), split over row chunks."""
        (m, ka), nb = a.shape, g.shape[1]
        tile = self.gemm_tile
        tiles = -(-ka // tile) * -(-nb // tile)
        if self.dtype == torch.bfloat16:
            splits = self._bf16_splits(m, tiles, ka * nb)
        else:
            splits = max(1, min(-(-_SPLIT_BLOCKS // tiles), -(-m // 256)))
        part = self.f32(splits, ka, nb)
        self._ok(self.lib.rz_wgrad(a.data_ptr(), g.data_ptr(), part.data_ptr(), m, ka, nb,
                                   splits, self.code, self.stream))
        return self.reduce(part, splits, (ka, nb))

    def _bf16_splits(self, m, tiles, n):
        """Row chunks of a bf16 dW product over m rows, ``tiles`` output tiles
        and n entries: the persistent kernel runs tiles x splits work items of
        ceil(m / splits) rows (whole 64-row k-steps) in waves of one item an
        SM, and each chunk adds a partial tile written and read once; the
        count that the cost model puts lowest, every chunk holding rows."""
        steps = -(-m // 64)
        if steps <= 1:
            return 1
        best = None
        for s in range(1, min(steps, 64) + 1):
            chunk = -(-steps // s)
            if -(-steps // chunk) != s:  # fewer chunks of this size cover the rows
                continue
            waves = -(-tiles * s // self.sms)
            cost = waves * chunk * _TILE_STEP_S * self.sms + s * n * 4 * _PART_BYTE_S
            if best is None or cost < best[0]:
                best = (cost, s)
        return best[1]

    def ln_rows(self, u, scale, bias, eps, *, want_f32=False, want_stats=False):
        """LN(u) per row, a warp a row -> (rounded, fp32 or None, statistics
        or None); the statistics (M, 2) fp32 are each row's mean and rstd,
        which :meth:`ln_bwd` then reads instead of computing them again."""
        m, d = u.shape
        out_t, out_f = self.t(m, d), self.f32(m, d) if want_f32 else None
        stats = self.f32(m, 2) if want_stats else None
        p = self._ptr
        self._ok(self.lib.rz_ln_rows(p(u), int(u.dtype == torch.float32), p(scale), p(bias),
                                     p(out_t), p(out_f), p(stats), m, d, float(eps), self.code,
                                     self.stream))
        return out_t, out_f, stats

    def ln_bwd(self, u, dh, scale, eps, *, sums, stats=None, add=None, ls=None, proj=None,
               want_out2=False, want_f32=False):
        """LayerNorm backward per row: d = ln_input_grad(dh) [+ add], from the
        row statistics of :meth:`ln_rows` when given, else computed ->
        (d rounded, d * ls rounded or None, d fp32 or None, [the column sums
        that the bits of ``sums`` ask for, in bit order: _SUM_DH_XN dh * xn,
        _SUM_DH dh, _SUM_D_LS d * ls, _SUM_D_PROJ d * proj], in the operand
        type). The pass runs _LN_BWD_BLOCKS_PER_SM blocks an SM over ranges
        of rows (row_partition); each block writes one partial row of each
        sum asked for, and one reduce adds them all."""
        m, d = u.shape
        chunk, parts = row_partition(m, _LN_BWD_BLOCKS_PER_SM * self.sms)
        k = bin(sums).count("1")
        out1 = self.t(m, d)
        out2 = self.t(m, d) if want_out2 else None
        out32 = self.f32(m, d) if want_f32 else None
        cpart = self.f32(parts, k, d)
        p = self._ptr
        self._ok(self.lib.rz_ln_bwd_rows(
            p(u), int(u.dtype == torch.float32), p(dh), int(dh.dtype == torch.float32),
            p(scale), p(add), p(ls), p(proj), p(stats), p(out1), p(out2), p(out32), p(cpart),
            sums, chunk, m, d, float(eps), self.code, self.stream))
        return out1, out2, out32, list(self.reduce(cpart, parts, (k, d)).unbind(0))

    def scale_colsum(self, g, m32, ls, *, sums, want_out=True):
        """-> (g * ls rounded or None, [the column sums that the bits of
        ``sums`` ask for: _SUM_G_M g * m32, _SUM_G_LS g * ls]); ls None -> 1.
        A thread holds 8 columns and walks one range of rows
        (row_partition over _COLSUM_BLOCKS_PER_SM blocks an SM); one reduce
        adds the blocks' partial rows."""
        m, d = g.shape
        chunk, parts = row_partition(m, _COLSUM_BLOCKS_PER_SM * self.sms)
        k = bin(sums).count("1")
        out = self.t(m, d) if want_out else None
        cpart = self.f32(parts, k, d)
        p = self._ptr
        self._ok(self.lib.rz_scale_colsum(p(g), p(m32), p(ls), p(out), p(cpart), sums, chunk, m,
                                          d, self.code, self.stream))
        return out, list(self.reduce(cpart, parts, (k, d)).unbind(0))


def fused_preattn_bwd(x, ln_scale, ln_bias, w_qkv, b_qkv, g, *, eps=1e-6):
    """K6: cotangent g (N, 3D) of :func:`fused_preattn` -> (dx, d ln_scale,
    d ln_bias, d w_qkv, d b_qkv), each in its operand's type. On the card:
    LN rows keeping each row's mean and rstd, the row-split product dw =
    ln(x)^T @ g, dh = g @ w_qkv^T (bf16 reads w_qkv K-major), db = colsum(g),
    the LN backward rows from the stored statistics with the sums of dh * xn
    and dh only, each with its fixed-order reduce; one count."""
    if not on_cuda(x):
        return fused_preattn_bwd_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, g, eps=eps)
    grads = _preattn_bwd_chain("fused_preattn_bwd", x, ln_scale, ln_bias, w_qkv, b_qkv, g,
                               reduce=_same, eps=eps)
    fused_preattn_bwd.launches += 1
    return grads


def fused_preattn_bwd_tp(x, ln_scale, ln_bias, w_qkv, b_qkv, g, *, reduce, eps=1e-6):
    """K6 over a model axis: the backward of K1 on a rank's [q_r | k_r | v_r]
    columns (``w_qkv`` (D, 3D/P), ``b_qkv``, ``g`` (N, 3D/P)). dW and db are
    the rank's; dh = g @ w_qkv^T is an fp32 partial that ``reduce`` (the
    all-reduce over the model group) sums before LN1's backward rows, which
    then give dx, d ln_scale and d ln_bias whole and bit-equal on every
    rank. On the card K6's chain with the sum between the dh product and the
    LN rows; one count."""
    if not on_cuda(x):
        return fused_preattn_bwd_tp_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, g, reduce=reduce,
                                          eps=eps)
    grads = _preattn_bwd_chain("fused_preattn_bwd_tp", x, ln_scale, ln_bias, w_qkv, b_qkv, g,
                               reduce=reduce, eps=eps)
    fused_preattn_bwd_tp.launches += 1
    return grads


def _preattn_bwd_chain(name, x, ln_scale, ln_bias, w_qkv, b_qkv, g, *, reduce, eps):
    n, d = x.shape
    d3 = w_qkv.shape[1]
    code = check_operands(
        name, x, ln_scale=((d,), ln_scale), ln_bias=((d,), ln_bias),
        w_qkv=((d, d3), w_qkv), b_qkv=((d3,), b_qkv), g=((n, d3), g))
    if d % 64 or d3 % 64:
        raise ValueError(f"{name}: needs D % 64 == 0 and 3D % 64 == 0, got {d}, {d3}")
    k = _Chain(name, x, code)
    hc, _, stats = k.ln_rows(x, ln_scale, ln_bias, eps, want_stats=True)
    dw = k.wgrad(hc, g)
    del hc
    dh = reduce(k.gemm_t(g, w_qkv, _EPI_F32, k.f32(n, d)))
    _, (db,) = k.scale_colsum(g, None, None, sums=_SUM_G_LS, want_out=False)
    dx, _, _, (dls, dlb) = k.ln_bwd(x, dh, ln_scale, eps, stats=stats, sums=_SUM_DH_XN | _SUM_DH)
    return dx, dls, dlb, dw, db


fused_preattn_bwd_tp.launches = 0
fused_preattn_bwd.launches = 0


def flash_attention_packed_bwd(qkv, n_heads: int, dout, *, out=None, lse=None):
    """K7: cotangent dout (B, L, D) of :func:`flash_attention_packed` ->
    d qkv (B, L, 3D); one count. K14's kernels over the thirds of the packed
    buffer: in bf16 the two Hopper kernels, which read the forward's ``out``
    (B, L, D) and ``lse`` (required, see :func:`flash_attention_packed_lse`);
    in fp32 the statistics, dK/dV and dQ kernels over 64 x 64 tiles, with
    ``out`` and ``lse`` ignored, as on the CPU."""
    if not on_cuda(qkv):
        return flash_attention_packed_bwd_plain(qkv, n_heads, dout)
    b, l, d3 = qkv.shape
    d = d3 // 3
    hd = d // n_heads
    code = check_operands("flash_attention_packed_bwd", qkv, dout=((b, l, d), dout))
    if hd != 64 or d3 != 3 * n_heads * hd:
        raise ValueError(f"flash_attention_packed_bwd: the kernel takes head_dim 64, got {hd}")
    sm90 = hopper(qkv)
    if sm90:
        out, lse = stats_operands("flash_attention_packed_bwd", _thirds(qkv, n_heads)[0],
                                  out, lse)
    stats = torch.empty((1 if sm90 else 3, b, n_heads, l), dtype=torch.float32,
                        device=qkv.device)
    dqkv = torch.empty_like(qkv)
    lib = _build.load()
    row = [None, None, stats[0].data_ptr()] if sm90 else [t.data_ptr() for t in stats]
    err = lib.rz_packed_attention_bwd(
        qkv.data_ptr(), dout.data_ptr(), out.data_ptr() if sm90 else None,
        lse.data_ptr() if sm90 else None, *row, dqkv.data_ptr(), b, l, n_heads, hd,
        float(hd**-0.5), code, _build.stream_ptr(qkv),
    )
    _build.check(err, "flash_attention_packed_bwd")
    flash_attention_packed_bwd.launches += 1
    return dqkv


flash_attention_packed_bwd.launches = 0


def fused_postattn_bwd(x, attn_out, wo, bo, ls1, ln_scale, ln_bias,
                       w1, b1, w2, b2, ls2, g, *, eps=1e-6):
    """K8: cotangent g (N, D) of :func:`fused_postattn` -> gradients of its
    twelve operands, in their order and types. On the card: the forward
    chain again (o-proj keeping proj and y in fp32, LN2 rows keeping each
    row's mean and rstd, fc1 keeping the pre-GELU h1 in fp32, fc2), then dm
    and its column sums, dw2, dgl with the GELU derivative and db1 in its
    epilogue, dw1, dhln, the LN backward rows from the stored statistics with
    the column sums of d LN2, d ls1 and d bo, da and dwo; one count."""
    ops = (x, attn_out, wo, bo, ls1, ln_scale, ln_bias, w1, b1, w2, b2, ls2)
    if not on_cuda(x):
        return fused_postattn_bwd_plain(*ops, g, eps=eps)
    n, d = x.shape
    f = w1.shape[1]
    code = check_operands(
        "fused_postattn_bwd", x,
        attn_out=((n, d), attn_out), wo=((d, d), wo), bo=((d,), bo), ls1=((d,), ls1),
        ln_scale=((d,), ln_scale), ln_bias=((d,), ln_bias), w1=((d, f), w1),
        b1=((f,), b1), w2=((f, d), w2), b2=((d,), b2), ls2=((d,), ls2), g=((n, d), g),
    )
    if d % 64 or f % 64:
        raise ValueError(f"fused_postattn_bwd: needs D % 64 == 0 and F % 64 == 0, got {d}, {f}")
    k = _Chain("fused_postattn_bwd", x, code)
    y32, proj32 = k.f32(n, d), k.f32(n, d)
    k.gemm(attn_out, wo, _EPI_PROJ2, y32, bias=bo, resid=x, ls=ls1, out2=proj32)
    hln, _, stats = k.ln_rows(y32, ln_scale, ln_bias, eps, want_stats=True)
    h1 = k.f32(n, f)
    gl = k.gemm(hln, w1, _EPI_GELU_H1, k.t(n, f), bias=b1, out2=h1)
    m32 = k.gemm(gl, w2, _EPI_F32, k.f32(n, d), bias=b2)
    dm, (dls2, db2) = k.scale_colsum(g, m32, ls2, sums=_SUM_G_M | _SUM_G_LS)
    dw2 = k.wgrad(gl, dm)
    del gl
    dh1, db1 = k.dgelu_gemm(dm, w2, h1)
    del h1, dm
    dw1 = k.wgrad(hln, dh1)
    del hln
    dhln = k.gemm_t(dh1, w1, _EPI_F32, m32)  # m32's buffer: m is spent
    del dh1
    dx, dproj, _, (dlns, dlnb, dbo, dls1) = k.ln_bwd(
        y32, dhln, ln_scale, eps, stats=stats, sums=_SUM_DH_XN | _SUM_DH | _SUM_D_LS | _SUM_D_PROJ,
        add=g, ls=ls1, proj=proj32, want_out2=True)
    da = k.gemm_t(dproj, wo, _EPI_BIAS, k.t(n, d))
    dwo = k.wgrad(attn_out, dproj)
    fused_postattn_bwd.launches += 1
    return dx, da, dwo, dbo, dls1, dlns, dlnb, dw1, db1, dw2, db2, dls2


fused_postattn_bwd.launches = 0


def fused_mpnet_post_bwd(x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2,
                         lnso, lnbo, g, *, eps=1e-12):
    """K9: cotangent g (M, D) of :func:`fused_mpnet_post` -> gradients of its
    twelve operands, in their order and types. On the card: K4's chain again
    (keeping u, y, the pre-GELU h1 and v in fp32, and the first LN's row
    statistics), the backward rows of the output LN, dw2, dgl with the GELU
    derivative and db1, dw1, dyln = dv + dh1 @ w1^T, the backward rows of
    the first LN from the stored statistics, da and dwo; one count."""
    ops = (x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2, lnso, lnbo)
    if not on_cuda(x):
        return fused_mpnet_post_bwd_plain(*ops, g, eps=eps)
    m, d = x.shape
    f = w1.shape[1]
    code = check_operands(
        "fused_mpnet_post_bwd", x,
        attn_out=((m, d), attn_out), wo=((d, d), wo), bo=((d,), bo),
        lnsa=((d,), lnsa), lnba=((d,), lnba), w1=((d, f), w1), b1=((f,), b1),
        w2=((f, d), w2), b2=((d,), b2), lnso=((d,), lnso), lnbo=((d,), lnbo), g=((m, d), g),
    )
    if d % 64 or f % 64:
        raise ValueError(f"fused_mpnet_post_bwd: needs D % 64 == 0 and F % 64 == 0, got {d}, {f}")
    k = _Chain("fused_mpnet_post_bwd", x, code)
    u32 = k.gemm(attn_out, wo, _EPI_ADD_F32, k.f32(m, d), bias=bo, resid=x)
    yln, y32, stats = k.ln_rows(u32, lnsa, lnba, eps, want_f32=True, want_stats=True)
    h1 = k.f32(m, f)
    gl = k.gemm(yln, w1, _EPI_GELU_H1, k.t(m, f), bias=b1, out2=h1)
    v32 = k.gemm(gl, w2, _EPI_ADDF_F32, k.f32(m, d), bias=b2, resid=y32)
    dm, _, dv32, (dlnso, dlnbo, db2) = k.ln_bwd(v32, g, lnso, eps, want_f32=True,
                                                sums=_SUM_DH_XN | _SUM_DH | _SUM_D_LS)
    dw2 = k.wgrad(gl, dm)
    del gl
    dh1, db1 = k.dgelu_gemm(dm, w2, h1)
    del h1, dm
    dw1 = k.wgrad(yln, dh1)
    dyln = k.gemm_t(dh1, w1, _EPI_ADDF_F32, y32, resid=dv32)  # y's buffer: y is spent
    du, _, _, (dlnsa, dlnba, dbo) = k.ln_bwd(u32, dyln, lnsa, eps, stats=stats,
                                             sums=_SUM_DH_XN | _SUM_DH | _SUM_D_LS)
    da = k.gemm_t(du, wo, _EPI_BIAS, k.t(m, d))
    dwo = k.wgrad(attn_out, du)
    fused_mpnet_post_bwd.launches += 1
    return du, da, dwo, dbo, dlnsa, dlnba, dw1, db1, dw2, db2, dlnso, dlnbo


fused_mpnet_post_bwd.launches = 0


def _kept_operands(name, x, kept):
    """Check the forward's kept fp32 sums against x's rows and device."""
    for i, t in enumerate(kept):
        if (t.dtype != torch.float32 or t.device != x.device or t.shape != x.shape
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: kept[{i}] is {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected contiguous float32 {tuple(x.shape)} on {x.device}")


def fused_postattn_bwd_tp(x, attn_out, wo, bo, ls1, ln_scale, ln_bias, w1, b1, w2, b2, ls2, g, *,
                          reduce, kept, eps=1e-6):
    """K8 over a model axis: the backward of the row-parallel K3
    (:func:`fused_postattn_tp`), operands split as its are, the cotangent g
    (N, D) whole and the same on every rank -> the twelve gradients, the
    rank's share of each split operand's and the whole gradient of the
    rest. ``kept`` is the forward's (o-proj sum, m = fc2 sum + b2), fp32,
    as :func:`postattn_tp_chain` keeps them. On the card,
    one count and one ``reduce``: the row kernel's begin form again on the
    o-proj sum (LN2's input y and its LN, bit-equal to the forward's, and
    proj = sum + bo), fc1 keeping the pre-GELU h1, dm = g ls2 with the column
    sums of g m and dm, dW2, dh1 with the GELU derivative and db1, dW1, the
    partial dhln = dh1 W1^T summed over the ranks, LN2's backward rows with
    add = g and the sums of d LN2, dbo and d ls1, da and dWo. Every product
    runs gemm_sm90_kernel in bf16 and gemm_f32_kernel / wgrad_f32_kernel in
    fp32, the rows and sums csrc/fused_layer_bwd.cu's entry points."""
    ops = (x, attn_out, wo, bo, ls1, ln_scale, ln_bias, w1, b1, w2, b2, ls2)
    if not on_cuda(x):
        return fused_postattn_bwd_tp_plain(*ops, g, reduce=reduce, kept=kept, eps=eps)
    n, d = x.shape
    dl, fl = wo.shape[0], w1.shape[1]
    code = check_operands(
        "fused_postattn_bwd_tp", x,
        attn_out=((n, dl), attn_out), wo=((dl, d), wo), bo=((d,), bo), ls1=((d,), ls1),
        ln_scale=((d,), ln_scale), ln_bias=((d,), ln_bias), w1=((d, fl), w1),
        b1=((fl,), b1), w2=((fl, d), w2), b2=((d,), b2), ls2=((d,), ls2), g=((n, d), g),
    )
    _kept_operands("fused_postattn_bwd_tp", x, kept)
    if d % 64 or dl % 32 or fl % 64:
        raise ValueError(f"fused_postattn_bwd_tp: needs D % 64, D/P % 32 and F/P % 64 == 0, got "
                         f"{d}, {dl}, {fl}")
    acc1, m32 = kept
    k = _Chain("fused_postattn_bwd_tp", x, code)
    hln, y32, _, proj32 = tp_rows(x, acc1, bo, ls=ls1, ln=(ln_scale, ln_bias), dtype=x.dtype,
                                  eps=eps, keep_u=True, keep_v=True)
    h1 = k.f32(n, fl)
    gl = k.gemm(hln, w1, _EPI_GELU_H1, k.t(n, fl), bias=b1, out2=h1)
    dm, (dls2, db2) = k.scale_colsum(g, m32, ls2, sums=_SUM_G_M | _SUM_G_LS)
    dw2 = k.wgrad(gl, dm)
    del gl
    dh1, db1 = k.dgelu_gemm(dm, w2, h1)
    del h1, dm
    dw1 = k.wgrad(hln, dh1)
    del hln
    dhln = reduce(k.gemm_t(dh1, w1, _EPI_F32, k.f32(n, d)))
    del dh1
    dx, dproj, _, (dlns, dlnb, dbo, dls1) = k.ln_bwd(
        y32, dhln, ln_scale, eps, sums=_SUM_DH_XN | _SUM_DH | _SUM_D_LS | _SUM_D_PROJ,
        add=g, ls=ls1, proj=proj32, want_out2=True)
    da = k.gemm_t(dproj, wo, _EPI_BIAS, k.t(n, dl))
    dwo = k.wgrad(attn_out, dproj)
    fused_postattn_bwd_tp.launches += 1
    return dx, da, dwo, dbo, dls1, dlns, dlnb, dw1, db1, dw2, db2, dls2


fused_postattn_bwd_tp.launches = 0


def fused_mpnet_post_bwd_tp(x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2, lnso, lnbo, g, *,
                            reduce, kept, eps=1e-12):
    """K9 over a model axis: the backward of the row-parallel K4
    (:func:`fused_mpnet_post_tp`), as :func:`fused_postattn_bwd_tp` is K8's;
    ``kept`` the forward's (o-proj sum, v = y + fc2 sum + b2). On the card,
    one count and one ``reduce``: the row kernel's begin form again (u in
    fp32, y rounded, fc1's operand), fc1 keeping h1, the output LN's
    backward rows on v (dv rounded and in fp32, the sums of d LN_out and
    db2), dW2, dh1 and db1, dW1, the partial dh1 W1^T summed over the ranks
    and added to dv by the row kernel (no bias, fp32 out), the first LN's
    backward rows on u (du, the sums of d LN_attn and dbo), da and dWo."""
    ops = (x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2, lnso, lnbo)
    if not on_cuda(x):
        return fused_mpnet_post_bwd_tp_plain(*ops, g, reduce=reduce, kept=kept, eps=eps)
    m, d = x.shape
    dl, fl = wo.shape[0], w1.shape[1]
    code = check_operands(
        "fused_mpnet_post_bwd_tp", x,
        attn_out=((m, dl), attn_out), wo=((dl, d), wo), bo=((d,), bo),
        lnsa=((d,), lnsa), lnba=((d,), lnba), w1=((d, fl), w1), b1=((fl,), b1),
        w2=((fl, d), w2), b2=((d,), b2), lnso=((d,), lnso), lnbo=((d,), lnbo), g=((m, d), g),
    )
    _kept_operands("fused_mpnet_post_bwd_tp", x, kept)
    if d % 64 or dl % 32 or fl % 64:
        raise ValueError(f"fused_mpnet_post_bwd_tp: needs D % 64, D/P % 32 and F/P % 64 == 0, "
                         f"got {d}, {dl}, {fl}")
    acc1, v32 = kept
    k = _Chain("fused_mpnet_post_bwd_tp", x, code)
    yln, u32, _, _ = tp_rows(x, acc1, bo, ln=(lnsa, lnba), dtype=x.dtype, eps=eps, keep_u=True)
    h1 = k.f32(m, fl)
    gl = k.gemm(yln, w1, _EPI_GELU_H1, k.t(m, fl), bias=b1, out2=h1)
    dm, _, dv32, (dlnso, dlnbo, db2) = k.ln_bwd(v32, g, lnso, eps, want_f32=True,
                                                sums=_SUM_DH_XN | _SUM_DH | _SUM_D_LS)
    dw2 = k.wgrad(gl, dm)
    del gl
    dh1, db1 = k.dgelu_gemm(dm, w2, h1)
    del h1, dm
    dw1 = k.wgrad(yln, dh1)
    del yln
    part = reduce(k.gemm_t(dh1, w1, _EPI_F32, k.f32(m, d)))
    del dh1
    dyln = tp_rows(dv32, part, None, dtype=x.dtype, keep_u=True, want_out=False)[1]
    del part, dv32
    du, _, _, (dlnsa, dlnba, dbo) = k.ln_bwd(u32, dyln, lnsa, eps,
                                             sums=_SUM_DH_XN | _SUM_DH | _SUM_D_LS)
    da = k.gemm_t(du, wo, _EPI_BIAS, k.t(m, dl))
    dwo = k.wgrad(attn_out, du)
    fused_mpnet_post_bwd_tp.launches += 1
    return du, da, dwo, dbo, dlnsa, dlnba, dw1, db1, dw2, db2, dlnso, dlnbo


fused_mpnet_post_bwd_tp.launches = 0


# ---------------------------------------------------------------------------
# autograd: forward K1-K4, backward K6-K9; the inputs are the only residuals
# ---------------------------------------------------------------------------

class _FusedPreattn(torch.autograd.Function):
    """K1 with K6 as its backward; over a model group ``tp`` (K1 on the rank's
    heads) K6 split at its all-reduce."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_qkv, b_qkv, eps, tp):
        ops = tuple(t.contiguous() for t in (x, ln_scale, ln_bias, w_qkv, b_qkv))
        ctx.save_for_backward(*ops)
        ctx.eps, ctx.tp = eps, tp
        return _fused_preattn_fwd(*ops, eps=eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ops, g = ctx.saved_tensors, g.contiguous()
        if ctx.tp is None:
            grads = fused_preattn_bwd(*ops, g, eps=ctx.eps)
        else:
            grads = fused_preattn_bwd_tp(*ops, g, reduce=_reducer(ctx.tp), eps=ctx.eps)
        return needed(ctx, grads) + (None, None)


class _FlashAttentionPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, n_heads):
        qkv = qkv.contiguous()
        ctx.n_heads = n_heads
        if hopper(qkv):
            out, lse = _flash_attention_packed_fwd(qkv, n_heads, with_lse=True)
            ctx.save_for_backward(qkv, out, lse)
            return out
        ctx.save_for_backward(qkv)
        return _flash_attention_packed_fwd(qkv, n_heads)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        qkv, *stats = ctx.saved_tensors
        return flash_attention_packed_bwd(qkv, ctx.n_heads, g.contiguous(),
                                          **dict(zip(("out", "lse"), stats))), None


class _FusedPostattn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        *ops, eps = args
        ops = tuple(t.contiguous() for t in ops)
        ctx.save_for_backward(*ops)
        ctx.eps = eps
        return _fused_postattn_fwd(*ops, eps=eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        grads = fused_postattn_bwd(*ctx.saved_tensors, g.contiguous(), eps=ctx.eps)
        return needed(ctx, grads) + (None,)


class _RowParallelTp(torch.autograd.Function):
    """K3 or K4 row-parallel (``chain``) with K8 or K9 over the axis (``bwd``)
    as its backward. It keeps the operands and the forward's two fp32 sums
    (``kept``: two (N, D) fp32 tensors a call, 2 x 50 MB at MPNet's 16 384
    rows of 768), so the backward runs no forward product and one
    all-reduce, not three."""

    @staticmethod
    def forward(ctx, chain, bwd, eps, tp, *ops):
        ops = tuple(t.contiguous() for t in ops)
        out, kept = chain(*ops, reduce=_reducer(tp), eps=eps, keep=True)
        ctx.save_for_backward(*ops, *kept)
        ctx.bwd, ctx.eps, ctx.tp = bwd, eps, tp
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *ops, acc1, last = ctx.saved_tensors
        grads = ctx.bwd(*ops, g.contiguous(), reduce=_reducer(ctx.tp), kept=(acc1, last),
                        eps=ctx.eps)
        return (None,) * 4 + needed(ctx, (None,) * 4 + grads)[4:]


def fused_layer_save_attn(x, n_heads: int, ln1_scale, ln1_bias, w_qkv, b_qkv, wo, bo, ls1,
                          ln2_scale, ln2_bias, w1, b1, w2, b2, ls2, *, eps=1e-6, tp=None):
    """(B, L, D) -> (B, L, D): one DINOv2 layer, K1, K2 and K3 in a row,
    that keeps for its backward x, the attention output and, in bf16 on the
    card, K2's ``lse`` (besides the weights), and drops qkv: the layer under
    the JAX ``save_only_these_names("attn_out")`` remat policy. The backward
    runs K8, K1 again for qkv, K7 from the kept output (and ``lse``), then
    K6, and adds x's two gradients in one sum. The same kernels on the same
    values as :func:`fused_preattn`, :func:`flash_attention_packed` and
    :func:`fused_postattn` composed, so the same bits.

    ``tp``, a model group (``n_heads`` and the weights this rank's share):
    K1 and K2 on the rank's heads and K3 row-parallel
    (:func:`fused_postattn_tp`), which also keeps its two fp32 sums; the
    backward runs K8 over the axis, K1 again on the rank's heads, K7, and K6
    over the axis (one all-reduce each), the same as
    :func:`fused_preattn_tp`, K2 and :func:`fused_postattn_tp` composed."""
    w = (ln1_scale, ln1_bias, w_qkv, b_qkv, wo, bo, ls1, ln2_scale, ln2_bias, w1, b1, w2, b2,
         ls2)
    b, l, d = x.shape
    if tracked(x, *w):
        out = _FusedLayerSaveAttn.apply(x.reshape(b * l, d), b, n_heads, eps, tp, *w)
    else:
        qkv = _fused_preattn_fwd(x.reshape(b * l, d), *w[:4], eps=eps).reshape(b, l, -1)
        a = _flash_attention_packed_fwd(qkv, n_heads)
        a2 = a.reshape(b * l, -1)
        if tp is None:
            out = _fused_postattn_fwd(x.reshape(b * l, d), a2, *w[4:], eps=eps)
        else:
            out = postattn_tp_chain(x.reshape(b * l, d), a2, *w[4:], reduce=_reducer(tp),
                                    eps=eps)
    return out.reshape(b, l, d)


class _FusedLayerSaveAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, b, n_heads, eps, tp, *w):
        x2, w = x2.contiguous(), tuple(t.contiguous() for t in w)
        n = x2.shape[0]
        qkv = _fused_preattn_fwd(x2, *w[:4], eps=eps).reshape(b, n // b, -1)
        if hopper(qkv):
            a, lse = _flash_attention_packed_fwd(qkv, n_heads, with_lse=True)
            stats = (lse,)
        else:
            a, stats = _flash_attention_packed_fwd(qkv, n_heads), ()
        del qkv
        a2 = a.reshape(n, -1)
        if tp is None:
            out, kept = _fused_postattn_fwd(x2, a2, *w[4:], eps=eps), ()
        else:
            out, kept = postattn_tp_chain(x2, a2, *w[4:], reduce=_reducer(tp), eps=eps, keep=True)
        ctx.save_for_backward(x2, a2, *w, *kept, *stats)
        ctx.b, ctx.n_heads, ctx.eps, ctx.tp = b, n_heads, eps, tp
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x2, a2, *rest = ctx.saved_tensors
        w, rest = rest[:14], rest[14:]
        b, eps, tp = ctx.b, ctx.eps, ctx.tp
        n, dl = a2.shape
        g = g.contiguous()
        if tp is None:
            post = fused_postattn_bwd(x2, a2, *w[4:], g, eps=eps)  # K8
            stats = rest
        else:  # K8 over the axis, from the forward's two sums
            post = fused_postattn_bwd_tp(x2, a2, *w[4:], g, reduce=_reducer(tp),
                                         kept=tuple(rest[:2]), eps=eps)
            stats = rest[2:]
        qkv = _fused_preattn_fwd(x2, *w[:4], eps=eps).reshape(b, n // b, 3 * dl)  # K1
        kept = {"out": a2.reshape(b, n // b, dl), "lse": stats[0]} if stats else {}
        dqkv = flash_attention_packed_bwd(qkv, ctx.n_heads, post[1].reshape(b, n // b, dl),
                                          **kept)  # K7
        del qkv
        if tp is None:
            pre = fused_preattn_bwd(x2, *w[:4], dqkv.reshape(n, 3 * dl), eps=eps)  # K6
        else:
            pre = fused_preattn_bwd_tp(x2, *w[:4], dqkv.reshape(n, 3 * dl), reduce=_reducer(tp),
                                       eps=eps)  # K6 over the axis
        dx = post[0] + pre[0] if ctx.needs_input_grad[0] else None
        return (dx, None, None, None, None) + needed(ctx, (None,) * 5 + pre[1:] + post[2:])[5:]


class _FusedMpnetPost(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        *ops, eps = args
        ops = tuple(t.contiguous() for t in ops)
        ctx.save_for_backward(*ops)
        ctx.eps = eps
        return _fused_mpnet_post_fwd(*ops, eps=eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        grads = fused_mpnet_post_bwd(*ctx.saved_tensors, g.contiguous(), eps=ctx.eps)
        return needed(ctx, grads) + (None,)
