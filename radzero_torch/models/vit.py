"""DINOv2-style ViT (port of radzero_tpu/models/vit.py).

Parameters are plain dicts of tensors in the JAX layout: dense kernels
(d_in, d_out), the patch embedding over (ph, pw, c)-flattened patches,
and one dict per layer in a list (the JAX package stacks them on a
leading axis). Each layer holds the packed [q | k | v] projection
``attn.qkv`` that the fused layer consumes; the bridge
(``from_jax.py``) packs it once at load.

Layer math (HF Dinov2Layer, pre-LN with LayerScale):
    x = x + ls1 * attn_out(attn(ln1(x)))
    x = x + ls2 * mlp(ln2(x))

:func:`dinov2_layer_fused` runs a layer through the kernels K1-K3
(plain twins on CPU) and, under gradients, their backward kernels K6-K8
(the JAX ``attn_impl="fused_vjp"``); :func:`dinov2_layer_packed` runs only
the attention through K2 / K7 (``"packed"``); :func:`dinov2_layer_flash`
runs it through K13 / K14 over the unpacked heads (``"flash"``, the
``ViTConfig`` default); :func:`dinov2_layer` is the eager reference
(``"xla"``). The port runs the real sequence length (1370 at 518 px): no
lane padding, and no fallback past any length.

Under ``remat=True`` with gradients on (:func:`vit_encoder`; a trainable
tower, the align layers) each layer keeps less for its backward and
recomputes the rest there, as the JAX ``jax.checkpoint`` around the layer
does. ``ViTConfig.remat_policy=None`` keeps the layer's input alone and
reruns the whole layer in the backward (``torch.utils.checkpoint``,
non-reentrant: the first align layer's input comes from a frozen tower run
without a tape, and a reentrant checkpoint would hand its parameters no
gradient). ``"save_attn"`` keeps the input and the attention output
(JAX's ``save_only_these_names("attn_out")``): on the fused layer
:func:`radzero_torch.ops.fused_layer.fused_layer_save_attn` reruns only K1
in the backward, then K8, K7 (from the kept output and, in bf16 on the
card, the kept ``lse``) and K6; the "packed" and "flash" layers rerun LN1
and the qkv product and the eager post-attention chain from the kept
output, and run K7 / K14 without rerunning K2 / K13. The eager attention's
backward reads the softmax, which only a rerun of the attention gives, so
on the eager layer ``save_attn`` keeps x alone and runs as None does.
Either policy gives the layer's gradients without remat bit for bit: the
same operations run on the same values, and the layer input's gradients
add in autograd's order (the fused layer's two, from K8 and K6, in one
sum; the eager-op layers differentiate their rebuilt graph in one pass).

``ViTConfig.token_filter_ratio > 0`` turns on the attention-aware token
filter (PAPERS.md arXiv 2506.01519; radzero_tpu/models/vit.py:365-457):
after layer ``token_filter_layer``'s predecessors, the patches are ranked
by the head-mean CLS attention score from that layer's q / k, the top
``1 - ratio`` are kept (CLS always), the remaining layers run at the
shorter length on the same layer ``impl``, and the final LayerNorm's
output is scattered back onto a zero grid of the full length.
"""

from __future__ import annotations

import functools
from typing import List

import torch
from torch.utils.checkpoint import checkpoint

from radzero_torch.models.configuration import ViTConfig
from radzero_torch.ops import fused_layer as fl
from radzero_torch.ops._checks import needed
from radzero_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_lse,
    hopper,
)
from radzero_torch.ops.fused_layer import (
    flash_attention_packed,
    flash_attention_packed_bwd,
    flash_attention_packed_lse,
    fused_postattn,
    fused_preattn,
)
from radzero_torch.ops.layers import (
    attention,
    gelu,
    layer_norm,
    linear,
    merge_heads,
    split_heads,
)
from radzero_torch.ops.resize import bicubic_resize_2d


# ---------------------------------------------------------------------------
# Init (same distributions as the JAX init; the numbers differ)
# ---------------------------------------------------------------------------

def _normal(g: torch.Generator, shape, std=0.02):
    return torch.randn(shape, generator=g, device=g.device) * std


def _init_linear(g, d_in, d_out, std=0.02):
    return {"kernel": _normal(g, (d_in, d_out), std),
            "bias": torch.zeros(d_out, device=g.device)}


def _init_ln(g, d):
    return {"scale": torch.ones(d, device=g.device), "bias": torch.zeros(d, device=g.device)}


def init_vit_layers(g: torch.Generator, cfg: ViTConfig) -> List[dict]:
    d, f = cfg.hidden_size, cfg.intermediate_size
    dev = g.device
    return [
        {
            "ln1": _init_ln(g, d),
            "attn": {"qkv": _init_linear(g, d, 3 * d), "o": _init_linear(g, d, d)},
            "ls1": torch.full((d,), cfg.layerscale_value, device=dev),
            "ln2": _init_ln(g, d),
            "mlp": {"fc1": _init_linear(g, d, f), "fc2": _init_linear(g, f, d)},
            "ls2": torch.full((d,), cfg.layerscale_value, device=dev),
        }
        for _ in range(cfg.num_hidden_layers)
    ]


def init_vit(g: torch.Generator, cfg: ViTConfig) -> dict:
    d = cfg.hidden_size
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.num_channels
    params = {
        "patch_embed": _init_linear(g, patch_dim, d),
        "cls_token": _normal(g, (1, 1, d)),
        "pos_embed": _normal(g, (1, 1 + cfg.pos_grid**2, d)),
        "layers": init_vit_layers(g, cfg),
    }
    if cfg.use_final_layernorm:
        params["final_ln"] = _init_ln(g, d)
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def interpolate_pos_embed(pos_embed: torch.Tensor, grid_hw) -> torch.Tensor:
    """Bicubic-resample the patch pos-embeds (fp32, align_corners=False)
    to the (h, w) grid; the CLS slot passes through."""
    h, w = grid_hw
    n_pos = pos_embed.shape[1] - 1
    g = int(round(n_pos**0.5))
    if (h, w) == (g, g):
        return pos_embed
    d = pos_embed.shape[-1]
    grid = pos_embed[0, 1:].float().reshape(g, g, d).permute(2, 0, 1)  # (D, g, g)
    grid = bicubic_resize_2d(grid, h, w)
    patch_pos = grid.permute(1, 2, 0).reshape(1, h * w, d).to(pos_embed.dtype)
    return torch.cat([pos_embed[:, :1], patch_pos], dim=1)


def patchify(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, h*w, patch*patch*C), (ph, pw, c) fastest."""
    b, hh, ww, c = pixel_values.shape
    h, w = hh // patch, ww // patch
    x = pixel_values.reshape(b, h, patch, w, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * w, patch * patch * c)


def vit_embed(params: dict, cfg: ViTConfig, pixel_values: torch.Tensor, dtype) -> torch.Tensor:
    b, hh, ww, _ = pixel_values.shape
    grid = (hh // cfg.patch_size, ww // cfg.patch_size)
    x = linear(patchify(pixel_values.to(dtype), cfg.patch_size), params["patch_embed"])
    cls = params["cls_token"].to(dtype).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    return x + interpolate_pos_embed(params["pos_embed"], grid).to(dtype)


# a layer's leaves in the order of K1's operands (4), then K3's (10)
_LEAVES = (("ln1", "scale"), ("ln1", "bias"), ("attn", "qkv", "kernel"), ("attn", "qkv", "bias"),
           ("attn", "o", "kernel"), ("attn", "o", "bias"), ("ls1",), ("ln2", "scale"),
           ("ln2", "bias"), ("mlp", "fc1", "kernel"), ("mlp", "fc1", "bias"),
           ("mlp", "fc2", "kernel"), ("mlp", "fc2", "bias"), ("ls2",))
_N_PRE = 4


def _layer_leaves(p: dict) -> list:
    out = []
    for path in _LEAVES:
        t = p
        for k in path:
            t = t[k]
        out.append(t)
    return out


def _layer_tree(leaves) -> dict:
    p: dict = {}
    for path, t in zip(_LEAVES, leaves):
        node = p
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return p


def dinov2_layer_fused(x: torch.Tensor, p: dict, cfg: ViTConfig) -> torch.Tensor:
    """One layer through K1 (LN1 + packed QKV), K2 (attention) and K3
    (o-proj + residual + LN2 + MLP + residual). Weights are cast to the
    activation dtype (a no-op for a tree already in that dtype); under
    gradients the kernels' Functions keep only (x, qkv, attn_out) and the
    cast weights, and autograd carries the weight gradients back through
    the cast."""
    b, l, d = x.shape
    x2 = x.reshape(b * l, d)
    w = [t.to(x.dtype) for t in _layer_leaves(p)]
    qkv = fused_preattn(x2, *w[:_N_PRE], eps=cfg.layer_norm_eps).reshape(b, l, 3 * d)
    attn_out = flash_attention_packed(qkv, cfg.num_attention_heads)
    out = fused_postattn(x2, attn_out.reshape(b * l, d), *w[_N_PRE:], eps=cfg.layer_norm_eps)
    return out.reshape(b, l, d)


def dinov2_layer_fused_save_attn(x: torch.Tensor, p: dict, cfg: ViTConfig) -> torch.Tensor:
    """:func:`dinov2_layer_fused` under ``remat_policy="save_attn"``: keeps
    x, the attention output, in bf16 on the card K2's ``lse``, and the cast
    weights; drops qkv. The backward reruns K1 for qkv, then K8, K7 and K6."""
    w = [t.to(x.dtype) for t in _layer_leaves(p)]
    return fl.fused_layer_save_attn(x, cfg.num_attention_heads, *w, eps=cfg.layer_norm_eps)


def _pre(x, p, cfg: ViTConfig) -> torch.Tensor:
    """LN1 and the packed QKV linear."""
    return linear(layer_norm(x, p["ln1"], cfg.layer_norm_eps), p["attn"]["qkv"])


def _post(x, attn, p, cfg: ViTConfig) -> torch.Tensor:
    """o-proj, LayerScale residual, LN2, MLP, LayerScale residual."""
    x = x + linear(attn, p["attn"]["o"]) * p["ls1"].to(x.dtype)
    m = layer_norm(x, p["ln2"], cfg.layer_norm_eps)
    m = linear(gelu(linear(m, p["mlp"]["fc1"])), p["mlp"]["fc2"])
    return x + m * p["ls2"].to(x.dtype)


def _eager_layer(x, p, cfg: ViTConfig, attn_fn) -> torch.Tensor:
    """Eager LN1, packed QKV linear, ``attn_fn(qkv) -> (B, L, D)``, eager rest."""
    return _post(x, attn_fn(_pre(x, p, cfg)), p, cfg)


def _heads(qkv, cfg: ViTConfig) -> list:
    """The (B, L, H, hd) q, k, v thirds of the packed projection (views, no copy)."""
    d, h = cfg.hidden_size, cfg.num_attention_heads
    return [split_heads(qkv[..., i * d : (i + 1) * d], h) for i in range(3)]


def _over_heads(cfg: ViTConfig, attn):
    """``attn_fn`` for :func:`_eager_layer`: ``attn(q, k, v)`` over the (B, L, H,
    hd) thirds of the packed projection, heads merged."""
    return lambda qkv: merge_heads(attn(*_heads(qkv, cfg)))


def dinov2_layer(x: torch.Tensor, p: dict, cfg: ViTConfig) -> torch.Tensor:
    """Eager reference layer (the JAX ``attn_impl="xla"`` path)."""
    return _eager_layer(x, p, cfg, _over_heads(cfg, attention))


def dinov2_layer_packed(x: torch.Tensor, p: dict, cfg: ViTConfig) -> torch.Tensor:
    """The JAX ``attn_impl="packed"`` layer: eager ops around the packed
    attention kernel K2, whose backward is K7."""
    return _eager_layer(x, p, cfg,
                        lambda qkv: flash_attention_packed(qkv, cfg.num_attention_heads))


def dinov2_layer_flash(x: torch.Tensor, p: dict, cfg: ViTConfig) -> torch.Tensor:
    """The JAX ``attn_impl="flash"`` layer: eager ops around the attention
    kernel K13 over (B, L, H, hd) heads, whose backward is K14; the kernel
    reads q, k and v by stride."""
    return _eager_layer(x, p, cfg, _over_heads(cfg, flash_attention))


_LAYERS = {"fused": dinov2_layer_fused, "packed": dinov2_layer_packed,
           "flash": dinov2_layer_flash, "eager": dinov2_layer}


# remat_policy="save_attn" on the packed and flash layers. A route is (keep,
# again): keep(qkv, cfg) -> (attention output, what its backward reads besides
# its operands); again(qkv, attn, kept, cfg) -> the kept attention output in
# the backward's graph, behind a node whose backward is the attention's own.

class _Kept(torch.autograd.Function):
    """Returns the kept attention output; its backward is ``bwd(g, *operands)``,
    the backward the attention's own Function would have run."""

    @staticmethod
    def forward(ctx, kept_out, bwd, *operands):
        ctx.bwd = bwd
        ctx.save_for_backward(*operands)
        return kept_out.detach()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return (None, None) + tuple(ctx.bwd(g, *ctx.saved_tensors))


def _packed_keep(qkv, cfg):
    if hopper(qkv):
        a, lse = flash_attention_packed_lse(qkv, cfg.num_attention_heads)
        return a, (lse,)
    return flash_attention_packed(qkv, cfg.num_attention_heads), ()


def _packed_again(qkv, a, kept, cfg):
    stats = {"out": a, "lse": kept[0]} if kept else {}

    def bwd(g, qkv):  # K7
        return (flash_attention_packed_bwd(qkv, cfg.num_attention_heads, g.contiguous(),
                                           **stats),)

    return _Kept.apply(a, bwd, qkv.contiguous())


def _flash_keep(qkv, cfg):
    if hopper(qkv):
        out, lse = flash_attention_lse(*_heads(qkv, cfg))
        return merge_heads(out), (lse,)
    return merge_heads(flash_attention(*_heads(qkv, cfg))), ()


def _flash_again(qkv, a, kept, cfg):
    q = _heads(qkv, cfg)[0]
    stats = {"out": a.reshape(q.shape), "lse": kept[0]} if kept else {}

    def bwd(g, q, k, v):  # K14
        return flash_attention_bwd(q, k, v, g, **stats)

    return merge_heads(_Kept.apply(a.reshape(q.shape), bwd, *_heads(qkv, cfg)))


class _SaveAttn(torch.autograd.Function):
    """One packed or flash layer that keeps x, the attention output and the route's
    statistics (and the layer's weights). Its backward builds the layer's
    graph again from x under autograd, with the kept output in place of the
    attention's, and differentiates it in one pass: the same nodes in the
    same order as the layer's own graph, so the same bits, x's four
    gradients (residual, LN1's mean and its two centrings) added in the
    same order."""

    @staticmethod
    def forward(ctx, x, cfg, route, *w):
        p = _layer_tree(w)
        a, kept = route[0](_pre(x, p, cfg), cfg)
        ctx.save_for_backward(x, a, *w, *kept)
        ctx.cfg, ctx.route = cfg, route
        return _post(x, a, p, cfg)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, a, *rest = ctx.saved_tensors
        w, kept = rest[:len(_LEAVES)], rest[len(_LEAVES):]
        cfg, want_x = ctx.cfg, ctx.needs_input_grad[0]
        with torch.enable_grad():
            xd = x.detach().requires_grad_(want_x)
            wd = [t.detach().requires_grad_() for t in w]
            p = _layer_tree(wd)
            out = _post(xd, ctx.route[1](_pre(xd, p, cfg), a, kept, cfg), p, cfg)
            grads = torch.autograd.grad(out, ([xd] if want_x else []) + wd, g)
        if not want_x:
            grads = (None,) + grads
        return (grads[0], None, None) + needed(ctx, (None,) * 3 + grads[1:])[3:]


def _save_attn_layer(route, doc):
    def layer(x: torch.Tensor, p: dict, cfg: ViTConfig) -> torch.Tensor:
        return _SaveAttn.apply(x, cfg, route, *_layer_leaves(p))

    layer.__doc__ = doc
    return layer


_SAVE_ATTN = {
    "fused": dinov2_layer_fused_save_attn,
    "packed": _save_attn_layer((_packed_keep, _packed_again), """:func:`dinov2_layer_packed`
    under ``remat_policy="save_attn"``: keeps x, the attention output and, in bf16 on
    the card, K2's ``lse``; the backward reruns the eager post-attention chain, LN1 and
    the qkv product, and runs K7 without rerunning K2."""),
    "flash": _save_attn_layer((_flash_keep, _flash_again), """:func:`dinov2_layer_flash`
    under ``remat_policy="save_attn"``: keeps x, the attention output and, in bf16 on
    the card, K13's ``lse``; the backward reruns the eager post-attention chain, LN1 and
    the qkv product, and runs K14 without rerunning K13."""),
}
_IMPL_OF = {"xla": "eager", "packed": "packed", "flash": "flash", "fused": "fused",
            "fused_vjp": "fused"}


def layer_impl(attn_impl: str) -> str:
    """The layer the port runs for a JAX ``attn_impl`` name: "xla" ->
    "eager", "packed" -> "packed" (K2 / K7), "flash" -> "flash" (K13 / K14),
    "fused" and "fused_vjp" -> "fused" (K1-K3 with the K6-K8 backward)."""
    if attn_impl not in _IMPL_OF:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; expected one of {sorted(_IMPL_OF)}")
    return _IMPL_OF[attn_impl]


def vit_encoder(layers: List[dict], cfg: ViTConfig, x: torch.Tensor, *, impl: str = "fused",
                remat: bool = False):
    """``impl`` names the layer: "fused", "packed", "flash" or "eager".
    ``remat`` (read only with gradients on) runs each layer under
    ``cfg.remat_policy``: None, a non-reentrant ``torch.utils.checkpoint``
    around the layer; "save_attn", the layer's ``_SAVE_ATTN`` twin, and on
    the eager layer (whose attention backward needs the softmax again) the
    checkpoint, as None."""
    layer = _LAYERS[impl]
    if remat and torch.is_grad_enabled():
        if cfg.remat_policy == "save_attn" and impl in _SAVE_ATTN:
            layer = _SAVE_ATTN[impl]
        else:
            layer = functools.partial(checkpoint, layer, use_reentrant=False,
                                      preserve_rng_state=False)
    for p in layers:
        x = layer(x, p, cfg)
    return x


def token_filter_indices(x: torch.Tensor, layer_p: dict, cfg: ViTConfig) -> torch.Tensor:
    """(B, 1 + keep) int64 rows to keep: CLS, then the ``keep = round((L - 1)
    (1 - ratio))`` patches of highest head-mean CLS.K score under ``layer_p``'s
    LN1, q and k (times hd^-1/2 / nh), in ascending order."""
    b, l, d = x.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    keep = max(1, int(round((l - 1) * (1.0 - cfg.token_filter_ratio))))
    h = layer_norm(x, layer_p["ln1"], cfg.layer_norm_eps)
    qkv = layer_p["attn"]["qkv"]
    q_cls = linear(h[:, :1], {"kernel": qkv["kernel"][:, :d], "bias": qkv["bias"][:d]})
    keys = linear(h, {"kernel": qkv["kernel"][:, d:2 * d], "bias": qkv["bias"][d:2 * d]})
    scores = torch.einsum("bhd,blhd->bl", q_cls.reshape(b, nh, hd), keys.reshape(b, l, nh, hd))
    scores = scores * (hd**-0.5) / nh
    idx = torch.topk(scores[:, 1:], keep, dim=1).indices + 1
    idx = torch.sort(idx, dim=1).values
    return torch.cat([idx.new_zeros(b, 1), idx], dim=1)


def vit_forward(
    params: dict,
    cfg: ViTConfig,
    pixel_values: torch.Tensor,
    *,
    dtype=torch.float32,
    impl: str = "fused",
    remat: bool = False,
) -> torch.Tensor:
    """(B, H, W, C) NHWC -> (B, 1 + h*w, D) tokens, final LN applied when
    ``cfg.use_final_layernorm``. ``impl`` and ``remat`` name the layer and
    its remat (see :func:`vit_encoder`). With ``cfg.token_filter_ratio > 0``
    the rows the filter drops come out as zeros."""
    x = vit_embed(params, cfg, pixel_values, dtype)
    if cfg.token_filter_ratio > 0.0:
        k = cfg.token_filter_layer
        if not 0 <= k < cfg.num_hidden_layers:
            raise ValueError(f"token_filter_layer={k} out of range for "
                             f"num_hidden_layers={cfg.num_hidden_layers}")
        x = vit_encoder(params["layers"][:k], cfg, x, impl=impl, remat=remat)
        b, l, d = x.shape
        rows = token_filter_indices(x, params["layers"][k], cfg)[..., None].expand(-1, -1, d)
        y = vit_encoder(params["layers"][k:], cfg, torch.gather(x, 1, rows), impl=impl,
                        remat=remat)
        if cfg.use_final_layernorm:
            y = layer_norm(y, params["final_ln"], cfg.layer_norm_eps)
        # after the final LN, so a dropped row is an exact zero (LN of a zero
        # row would be the LN bias)
        return y.new_zeros(b, l, d).scatter(1, rows, y)
    x = vit_encoder(params["layers"], cfg, x, impl=impl, remat=remat)
    if cfg.use_final_layernorm:
        x = layer_norm(x, params["final_ln"], cfg.layer_norm_eps)
    return x
