"""Shared primitives (port of radzero_tpu/ops/layers.py), plain PyTorch.

- ``layer_norm``: fp32 statistics, biased variance, eps inside the rsqrt;
  the result is cast back to the input dtype
- ``row_linear``: a row-parallel ``linear`` over a model group (the
  partial products all-reduced, then the bias)
- ``column_linear``: a column-parallel ``linear`` over a model group (the
  input through ``copy_to_model``, whose backward sums its gradient)
- ``embed_rows``: a table lookup, the table whole or split on its rows
  over a model group (the rows all-reduced)
- ``gelu``: exact erf GELU
- ``attention``: eager softmax attention with an fp32 softmax
- ``l2_normalize``: ``x / max(||x||, eps)`` with eps 1e-12
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from radzero_torch.parallel.collectives import all_reduce_sum, copy_to_model
from radzero_torch.parallel.tensor_parallel import local_heads, tp_rank, tp_size


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


def row_linear(x: torch.Tensor, params: dict, tp) -> torch.Tensor:
    """:func:`linear` of a row-parallel weight over the model group ``tp``:
    ``x`` holds this rank's input columns and the kernel its rows; the
    partial products are summed over the ranks (fp32, rounded once), then
    the whole bias is added. Without a group, :func:`linear`."""
    if tp is None:
        return linear(x, params)
    y = all_reduce_sum(x @ params["kernel"].to(x.dtype), tp)
    if params.get("bias") is not None:
        y = y + params["bias"].to(x.dtype)
    return y


def column_linear(x: torch.Tensor, params: dict, tp) -> torch.Tensor:
    """:func:`linear` of a column-parallel weight over the model group ``tp``:
    ``x`` is whole on every rank and the kernel and bias hold this rank's
    output columns. The product is local; under gradients ``x`` passes
    through :func:`radzero_torch.parallel.collectives.copy_to_model`, so its
    gradient is the sum of the ranks' partials. Without a group,
    :func:`linear`."""
    return linear(copy_to_model(x, tp), params)


def embed_rows(table, ids, rows: int, tp=None):
    """``table[ids]`` of a table of ``rows`` rows that is whole on this rank,
    or split on its rows over the model group ``tp`` (a shorter ``table``):
    each rank looks up the ids it holds, zero rows elsewhere, and an
    all-reduce adds the ranks' rows, which gives the rows' own bits. Under
    gradients the all-reduce's backward is the identity, so each rank's
    table gets the gradient of the rows it holds. MPNet's and BERT's word
    and position tables."""
    if tp is None or table.shape[0] == rows:
        return table[ids]
    n = table.shape[0]
    local = ids - tp_rank(tp) * n
    held = (local >= 0) & (local < n)
    found = table[local.clamp(0, n - 1)]
    return all_reduce_sum(torch.where(held[..., None], found, torch.zeros_like(found)), tp)


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


def self_attention(h: torch.Tensor, p: dict, heads: int, bias=None, tp=None) -> torch.Tensor:
    """Multi-head self-attention of ``heads`` heads over ``p``'s q / k / v / o
    linears: the eager attention of the BERT, CLIP, MAE and CLIP text layers.
    Over a model group ``tp`` (``p`` this rank's share) q, k and v are
    column-parallel on the rank's heads, ``h`` passing through
    ``copy_to_model`` once for the three, and o is row-parallel
    (:func:`row_linear`: the partial products summed, then o's whole bias).
    ``bias`` broadcasts against the (B, H, Lq, Lk) scores of the rank's
    heads: a bias per key (BERT's mask, the causal mask) as it is, a bias
    per head only as the rank's heads' slice."""
    heads = local_heads(heads, tp_size(tp))
    h = copy_to_model(h, tp)
    q, k, v = (split_heads(linear(h, p[n]), heads) for n in "qkv")
    return row_linear(merge_heads(attention(q, k, v, bias=bias)), p["o"], tp)


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
        del bias  # a large bias (SAM's global layers) need not outlive the sum
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
