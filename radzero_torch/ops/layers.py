"""Shared primitives (port of radzero_tpu/ops/layers.py), plain PyTorch.

- ``layer_norm``: fp32 statistics, biased variance, eps inside the rsqrt;
  the result is cast back to the input dtype
- ``gelu``: exact erf GELU
- ``attention``: eager softmax attention with an fp32 softmax
- ``l2_normalize``: ``x / max(||x||, eps)`` with eps 1e-12
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch


def layer_norm(x: torch.Tensor, params: dict, eps: float) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def linear(x: torch.Tensor, params: dict) -> torch.Tensor:
    """``x @ kernel + bias`` with the kernel in the JAX (d_in, d_out) layout."""
    y = x @ params["kernel"].to(x.dtype)
    if params.get("bias") is not None:
        y = y + params["bias"].to(x.dtype)
    return y


def gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="none")


def normalize_pixels(
    x: torch.Tensor,
    mean: Sequence[float],
    std: Sequence[float],
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """On-device rescale(1/255) + per-channel mean/std for uint8 NHWC
    uploads; float inputs pass through cast to ``dtype``."""
    if x.dtype != torch.uint8:
        return x.to(dtype)
    scale, bias = _pixel_affine(tuple(mean), tuple(std), dtype, x.device)
    return x.to(dtype) * scale + bias


@functools.lru_cache(maxsize=16)
def _pixel_affine(mean, std, dtype, device):
    """Per-channel (scale, bias) on ``device``, made once: a fresh upload
    per batch would be a blocking copy that waits for the stream."""
    mean32 = torch.tensor(mean, dtype=torch.float32, device=device)
    std32 = torch.tensor(std, dtype=torch.float32, device=device)
    return (1.0 / (255.0 * std32)).to(dtype), (-mean32 / std32).to(dtype)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    norm = x.square().sum(dim=dim, keepdim=True).sqrt()
    return x / norm.clamp_min(eps)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, l, h, hd = x.shape
    return x.reshape(b, l, h * hd)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Eager attention over (B, L, H, hd) tensors; returns (B, L, H, hd).

    ``bias`` broadcasts against the (B, H, Lq, Lk) scores and is added
    after scaling. The softmax runs in fp32 and is cast back to q's dtype.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
