"""MPNet text encoder (port of radzero_tpu/models/mpnet.py), plain PyTorch.

- RoBERTa-style position ids: ``cumsum(ids != pad) * (ids != pad) + pad``;
- one relative-attention-bias table shared by all layers (T5-style
  bidirectional buckets, 32 buckets, max distance 128);
- post-LN layers LN(x + attn(x)), LN(y + ffn(y)), eps 1e-12;
- additive key mask of ``finfo(dtype).min`` on padded keys.

``attn_impl="flash"`` runs the attention of every layer through kernel K15
(:func:`radzero_torch.ops.flash_attention.flash_attention_bias`: the bias
and the key mask enter as two operands, no (S, H, L, L) sum is made), in
serving and in training alike; under gradients its backward is K16, whose
d(bias) flows on to ``rel_bias`` through the bucket gather. Anything else
is the eager attention.

``fuse_post=True`` (the default) runs the whole non-attention chain of a
layer through kernel K4 (:func:`radzero_torch.ops.fused_layer.
fused_mpnet_post`; its plain twin for CPU tensors). Under gradients the
same call differentiates through the backward kernel K9 and keeps only the
layer input and the attention output; ``fuse_post=False`` is the eager
chain that autograd differentiates op by op.

``mpnet_forward(..., remat=True)`` (with gradients on) reruns each layer in
the backward, as the JAX ``jax.checkpoint(mpnet_layer)`` does: a
non-reentrant ``torch.utils.checkpoint`` around :func:`mpnet_layer` keeps
the layer's input alone, and the backward runs the layer's forward again
(K4, and K15 under ``attn_impl="flash"``) before its own backward. The
bucket table, the bias ``rel`` and the key mask are made once, outside the
checkpointed layers.
"""

from __future__ import annotations

import functools
import math
from typing import List

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from radzero_torch.models.configuration import TextConfig
from radzero_torch.ops.flash_attention import flash_attention_bias
from radzero_torch.ops.fused_layer import fused_mpnet_post
from radzero_torch.ops.layers import (
    attention,
    gelu,
    layer_norm,
    linear,
    merge_heads,
    split_heads,
)


@functools.lru_cache(maxsize=64)
def relative_position_bucket_table(
    seq_len: int, num_buckets: int = 32, max_distance: int = 128
) -> np.ndarray:
    """(L, L) int32 bucket ids; mirrors MPNetEncoder.relative_position_bucket."""
    context = np.arange(seq_len)[:, None]
    memory = np.arange(seq_len)[None, :]
    relative_position = memory - context
    n = -relative_position

    nb = num_buckets // 2
    ret = (n < 0).astype(np.int64) * nb
    n = np.abs(n)

    max_exact = nb // 2
    is_small = n < max_exact
    with np.errstate(divide="ignore"):
        val_if_large = max_exact + (
            np.log(np.maximum(n, 1).astype(np.float64) / max_exact)
            / math.log(max_distance / max_exact)
            * (nb - max_exact)
        ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, nb - 1)
    ret = ret + np.where(is_small, n, val_if_large)
    return ret.astype(np.int32)


_BUCKET_IDS: dict = {}


def bucket_ids(seq_len: int, num_buckets: int, device: torch.device) -> torch.Tensor:
    """The bucket table as int64 on ``device``, uploaded once: a fresh
    upload per forward would be a blocking copy that waits for the stream.
    While torch.export traces (with fake tensors) a table not uploaded yet
    is made for the trace alone and not kept; an uploaded one enters the
    program as a constant on ``device`` (eval/export.py uploads it first).
    The table is made outside inference mode even when the first caller
    runs in it (serving), so a forward that autograd records (training)
    can read the same cached table."""
    key = (seq_len, num_buckets, torch.device(device))
    ids = _BUCKET_IDS.get(key)
    if ids is None:
        table = relative_position_bucket_table(seq_len, num_buckets)
        with torch.inference_mode(False):
            ids = torch.from_numpy(table).long().to(device)
        if not torch.compiler.is_exporting():
            _BUCKET_IDS[key] = ids
    return ids


def _init_linear(g, d_in, d_out, std=0.02):
    return {"kernel": torch.randn((d_in, d_out), generator=g, device=g.device) * std,
            "bias": torch.zeros(d_out, device=g.device)}


def _init_ln(g, d):
    return {"scale": torch.ones(d, device=g.device), "bias": torch.zeros(d, device=g.device)}


def init_mpnet(g: torch.Generator, cfg: TextConfig) -> dict:
    d, f = cfg.hidden_size, cfg.intermediate_size
    layers: List[dict] = [
        {
            "attn": {name: _init_linear(g, d, d) for name in ("q", "k", "v", "o")},
            "ln_attn": _init_ln(g, d),
            "mlp": {"fc1": _init_linear(g, d, f), "fc2": _init_linear(g, f, d)},
            "ln_out": _init_ln(g, d),
        }
        for _ in range(cfg.num_hidden_layers)
    ]
    randn = functools.partial(torch.randn, generator=g, device=g.device)
    return {
        "embeddings": {
            "word": randn((cfg.vocab_size, d)) * 0.02,
            "position": randn((cfg.max_position_embeddings, d)) * 0.02,
            "ln": _init_ln(g, d),
        },
        "rel_bias": randn((cfg.relative_attention_num_buckets, cfg.num_attention_heads)) * 0.02,
        "layers": layers,
    }


def create_position_ids(input_ids: torch.Tensor, padding_idx: int) -> torch.Tensor:
    mask = (input_ids != padding_idx).long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


def mpnet_layer(x, p, rel, neg, cfg: TextConfig):
    """``rel``: (H, L, L) fp32 relative-position bias shared by the batch;
    ``neg``: (S, L) additive key mask (0 real / -big pad)."""
    h = cfg.num_attention_heads
    q, k, v = (split_heads(linear(x, p["attn"][n]), h) for n in ("q", "k", "v"))
    if cfg.attn_impl == "flash":
        a = merge_heads(flash_attention_bias(q, k, v, rel, neg, cfg.head_dim**-0.5))
    else:
        bias = rel[None].to(x.dtype) + neg[:, None, None, :].to(x.dtype)
        a = merge_heads(attention(q, k, v, bias=bias, scale=cfg.head_dim**-0.5))
    if cfg.fuse_post:
        s, l, d = x.shape
        cdt = x.dtype
        out = fused_mpnet_post(
            x.reshape(s * l, d).contiguous(), a.reshape(s * l, d).contiguous(),
            p["attn"]["o"]["kernel"].to(cdt), p["attn"]["o"]["bias"].to(cdt),
            p["ln_attn"]["scale"].to(cdt), p["ln_attn"]["bias"].to(cdt),
            p["mlp"]["fc1"]["kernel"].to(cdt), p["mlp"]["fc1"]["bias"].to(cdt),
            p["mlp"]["fc2"]["kernel"].to(cdt), p["mlp"]["fc2"]["bias"].to(cdt),
            p["ln_out"]["scale"].to(cdt), p["ln_out"]["bias"].to(cdt),
            eps=cfg.layer_norm_eps,
        )
        return out.reshape(s, l, d)
    a = linear(a, p["attn"]["o"])
    x = layer_norm(x + a, p["ln_attn"], cfg.layer_norm_eps)
    m = linear(gelu(linear(x, p["mlp"]["fc1"])), p["mlp"]["fc2"])
    return layer_norm(x + m, p["ln_out"], cfg.layer_norm_eps)


def mpnet_forward(params: dict, cfg: TextConfig, input_ids, attention_mask, *,
                  dtype=torch.float32, remat: bool = False) -> torch.Tensor:
    """(S, L) int ids + (S, L) mask -> (S, L, D) last hidden state; ``remat``
    reruns each layer in the backward (read only with gradients on)."""
    emb = params["embeddings"]
    pos_ids = create_position_ids(input_ids, cfg.pad_token_id)
    x = emb["word"][input_ids] + emb["position"][pos_ids]
    x = layer_norm(x.to(dtype), emb["ln"], cfg.layer_norm_eps)

    buckets = bucket_ids(input_ids.shape[1], cfg.relative_attention_num_buckets,
                         input_ids.device)
    rel = params["rel_bias"].float()[buckets].permute(2, 0, 1)  # (H, L, L)
    if dtype != torch.float32:
        rel = rel.to(dtype).float()

    neg_v = torch.finfo(torch.float32 if dtype == torch.float32 else dtype).min
    neg = (1.0 - attention_mask.float()) * neg_v

    remat = remat and torch.is_grad_enabled()
    for p in params["layers"]:
        if remat:
            x = checkpoint(mpnet_layer, x, p, rel, neg, cfg, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = mpnet_layer(x, p, rel, neg, cfg)
    return x


def masked_mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    mask = attention_mask.to(hidden.dtype)[..., None]
    summed = (hidden * mask).sum(dim=1)
    counts = mask.sum(dim=1).clamp_min(1e-9)
    return summed / counts
