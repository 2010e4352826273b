"""K1-K4: the fused DINOv2 layer and the fused MPNet post-attention chain
(port of radzero_tpu/ops/fused_layer.py).

- :func:`fused_preattn`  (K1): qkv = ln1(x) @ Wqkv + b
- :func:`flash_attention_packed` (K2): attention over the packed
  (B, L, 3D) [q | k | v] buffer -> merged heads (B, L, D)
- :func:`fused_postattn` (K3): y = x + ls1 * (a @ Wo + bo);
  out = y + ls2 * (gelu(ln2(y) @ W1 + b1) @ W2 + b2)
- :func:`fused_mpnet_post` (K4): y = ln(x + a @ Wo + bo);
  out = ln(y + gelu(y @ W1 + b1) @ W2 + b2)   (post-LN, eps 1e-12)

Each wrapper runs its plain twin (``*_plain``, same module) when handed a
CPU tensor and launches its CUDA kernel (``csrc/fused_layer.cu``) when
handed a CUDA tensor; anything else raises. ``<wrapper>.launches`` counts
kernel launches. Numerics are the TPU kernels' contract: fp32 LayerNorm,
softmax and accumulation; the LN output, the GELU output and the softmax
weights are rounded to the operand type before the next product.

The kernels are forward-only: their backward kernels (K6, K7, K8, K9) are
not ported yet. A wrapper handed an operand that requires a gradient,
with gradients enabled, raises and names the missing kernel; it never
takes the eager layer or the plain twin in the kernel's place.

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
from radzero_torch.ops._checks import check_operands, forbid_grad, on_cuda

_LOG2E = 1.4426950408889634


def _ln32(x32, scale, bias, eps):
    mu = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * scale.float() + bias.float()


# ---------------------------------------------------------------------------
# K1: pre-attention LN -> packed qkv projection
# ---------------------------------------------------------------------------

def fused_preattn_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, *, eps=1e-6):
    h = _ln32(x.float(), ln_scale, ln_bias, eps).to(x.dtype)
    return (h.float() @ w_qkv.float() + b_qkv.float()).to(x.dtype)


def fused_preattn(x, ln_scale, ln_bias, w_qkv, b_qkv, *, eps=1e-6):
    """(N, D) x -> (N, 3D) packed qkv = ln1(x) @ w_qkv + b_qkv."""
    forbid_grad("fused_preattn (K1)", "its backward kernel K6 is not ported yet",
                x, ln_scale, ln_bias, w_qkv, b_qkv)
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
    lib = _build.load()
    err = lib.rz_fused_preattn(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w_qkv.data_ptr(),
        b_qkv.data_ptr(), out.data_ptr(), n, d, d3, float(eps), code,
        _build.stream_ptr(x),
    )
    _build.check(err, "fused_preattn")
    fused_preattn.launches += 1
    return out


fused_preattn.launches = 0


# ---------------------------------------------------------------------------
# K2: packed-layout attention
# ---------------------------------------------------------------------------

def flash_attention_packed_plain(qkv, n_heads: int):
    b, l, d3 = qkv.shape
    d = d3 // 3
    hd = d // n_heads
    scale = hd**-0.5

    def heads(i):  # (B, H, L, hd)
        return qkv[..., i * d : (i + 1) * d].reshape(b, l, n_heads, hd).transpose(1, 2)

    q, k, v = heads(0), heads(1), heads(2)
    s = (q.float() @ k.float().transpose(-1, -2)) * (scale * _LOG2E)
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp2(s)
    den = e.sum(dim=-1, keepdim=True)
    num = e.to(qkv.dtype).float() @ v.float()
    out = (num / den).to(qkv.dtype)
    return out.transpose(1, 2).reshape(b, l, d)


def flash_attention_packed(qkv, n_heads: int):
    """(B, L, 3D) packed [q | k | v] -> (B, L, D) merged heads, softmax
    scale head_dim ** -0.5. No lane padding: the kernel masks keys >= L
    in its last tile itself."""
    forbid_grad("flash_attention_packed (K2)", "its backward kernel K7 is not ported yet",
                qkv)
    if not on_cuda(qkv):
        return flash_attention_packed_plain(qkv, n_heads)
    b, l, d3 = qkv.shape
    d = d3 // 3
    hd = d // n_heads
    code = check_operands("flash_attention_packed", qkv)
    if hd != 64 or d3 != 3 * n_heads * hd:
        raise ValueError(f"flash_attention_packed: the kernel takes head_dim 64, got {hd}")
    out = torch.empty((b, l, d), dtype=qkv.dtype, device=qkv.device)
    lib = _build.load()
    err = lib.rz_packed_attention(
        qkv.data_ptr(), out.data_ptr(), b, l, n_heads, hd, float(hd**-0.5 * _LOG2E),
        code, _build.stream_ptr(qkv),
    )
    _build.check(err, "flash_attention_packed")
    flash_attention_packed.launches += 1
    return out


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
    residual stream. On the card: three launches (o-proj with the fp32
    residual y, LN2 + fc1 + GELU, fc2 + residual), one count."""
    forbid_grad("fused_postattn (K3)", "its backward kernel K8 is not ported yet",
                x, attn_out, wo, bo, ls1, ln_scale, ln_bias, w1, b1, w2, b2, ls2)
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
    h = torch.empty((n, f), dtype=x.dtype, device=x.device)
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    lib = _build.load()
    err = lib.rz_fused_postattn(
        x.data_ptr(), attn_out.data_ptr(), wo.data_ptr(), bo.data_ptr(), ls1.data_ptr(),
        ln_scale.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), ls2.data_ptr(), y32.data_ptr(), h.data_ptr(),
        out.data_ptr(), n, d, f, float(eps), code, _build.stream_ptr(x),
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
    On the card: five launches (o-proj + residual into fp32 u, row LN into
    fp32 y, fc1 + GELU, fc2 + y into fp32, row LN into the output), one
    count. Rows need not be a multiple of any tile."""
    forbid_grad("fused_mpnet_post (K4)", "its backward kernel K9 is not ported yet",
                x, attn_out, wo, bo, lnsa, lnba, w1, b1, w2, b2, lnso, lnbo)
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
    h = torch.empty((m, f), dtype=x.dtype, device=x.device)
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    lib = _build.load()
    err = lib.rz_fused_mpnet_post(
        x.data_ptr(), attn_out.data_ptr(), wo.data_ptr(), bo.data_ptr(), lnsa.data_ptr(),
        lnba.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        lnso.data_ptr(), lnbo.data_ptr(), u32.data_ptr(), y32.data_ptr(), h.data_ptr(),
        out.data_ptr(), m, d, f, float(eps), code, _build.stream_ptr(x),
    )
    _build.check(err, "fused_mpnet_post")
    fused_mpnet_post.launches += 1
    return out


fused_mpnet_post.launches = 0
