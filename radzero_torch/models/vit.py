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
"""

from __future__ import annotations

from typing import List, Optional

import torch

from radzero_torch.models.configuration import ViTConfig
from radzero_torch.ops.flash_attention import flash_attention
from radzero_torch.ops.fused_layer import (
    flash_attention_packed,
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


def dinov2_layer_fused(x: torch.Tensor, p: dict, cfg: ViTConfig) -> torch.Tensor:
    """One layer through K1 (LN1 + packed QKV), K2 (attention) and K3
    (o-proj + residual + LN2 + MLP + residual). Weights are cast to the
    activation dtype (a no-op for a tree already in that dtype); under
    gradients the kernels' Functions keep only (x, qkv, attn_out) and the
    cast weights, and autograd carries the weight gradients back through
    the cast."""
    b, l, d = x.shape
    cdt = x.dtype
    x2 = x.reshape(b * l, d)
    a = p["attn"]
    qkv = fused_preattn(
        x2, p["ln1"]["scale"].to(cdt), p["ln1"]["bias"].to(cdt),
        a["qkv"]["kernel"].to(cdt), a["qkv"]["bias"].to(cdt), eps=cfg.layer_norm_eps,
    ).reshape(b, l, 3 * d)
    attn_out = flash_attention_packed(qkv, cfg.num_attention_heads)
    out = fused_postattn(
        x2, attn_out.reshape(b * l, d),
        a["o"]["kernel"].to(cdt), a["o"]["bias"].to(cdt), p["ls1"].to(cdt),
        p["ln2"]["scale"].to(cdt), p["ln2"]["bias"].to(cdt),
        p["mlp"]["fc1"]["kernel"].to(cdt), p["mlp"]["fc1"]["bias"].to(cdt),
        p["mlp"]["fc2"]["kernel"].to(cdt), p["mlp"]["fc2"]["bias"].to(cdt),
        p["ls2"].to(cdt), eps=cfg.layer_norm_eps,
    )
    return out.reshape(b, l, d)


def _eager_layer(x, p, cfg: ViTConfig, attn_fn) -> torch.Tensor:
    """Eager LN1, packed QKV linear, ``attn_fn(qkv) -> (B, L, D)``, eager rest."""
    h = layer_norm(x, p["ln1"], cfg.layer_norm_eps)
    a = linear(attn_fn(linear(h, p["attn"]["qkv"])), p["attn"]["o"])
    x = x + a * p["ls1"].to(x.dtype)
    m = layer_norm(x, p["ln2"], cfg.layer_norm_eps)
    m = linear(gelu(linear(m, p["mlp"]["fc1"])), p["mlp"]["fc2"])
    return x + m * p["ls2"].to(x.dtype)


def _over_heads(cfg: ViTConfig, attn):
    """``attn_fn`` for :func:`_eager_layer`: ``attn(q, k, v)`` over the (B, L, H,
    hd) thirds of the packed projection (views, no copy), heads merged."""
    d, h = cfg.hidden_size, cfg.num_attention_heads

    def attn_fn(qkv):
        return merge_heads(attn(*(split_heads(qkv[..., i * d : (i + 1) * d], h)
                                  for i in range(3))))

    return attn_fn


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
_IMPL_OF = {"xla": "eager", "packed": "packed", "flash": "flash", "fused": "fused",
            "fused_vjp": "fused"}


def layer_impl(attn_impl: str) -> str:
    """The layer the port runs for a JAX ``attn_impl`` name: "xla" ->
    "eager", "packed" -> "packed" (K2 / K7), "flash" -> "flash" (K13 / K14),
    "fused" and "fused_vjp" -> "fused" (K1-K3 with the K6-K8 backward)."""
    if attn_impl not in _IMPL_OF:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; expected one of {sorted(_IMPL_OF)}")
    return _IMPL_OF[attn_impl]


def vit_encoder(layers: List[dict], cfg: ViTConfig, x: torch.Tensor, *, impl: str = "fused"):
    """``impl`` names the layer: "fused", "packed", "flash" or "eager"."""
    layer = _LAYERS[impl]
    for p in layers:
        x = layer(x, p, cfg)
    return x


def vit_forward(
    params: dict,
    cfg: ViTConfig,
    pixel_values: torch.Tensor,
    *,
    dtype=torch.float32,
    eager: bool = False,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """(B, H, W, C) NHWC -> (B, 1 + h*w, D) tokens, final LN applied when
    ``cfg.use_final_layernorm``. ``impl`` names the layer (see
    :func:`vit_encoder`); without it ``eager`` picks the reference layers,
    else the fused ones."""
    if cfg.token_filter_ratio > 0.0:
        raise NotImplementedError(
            "token_filter_ratio > 0 is not ported yet (ROADMAP.md, port queue)"
        )
    x = vit_embed(params, cfg, pixel_values, dtype)
    x = vit_encoder(params["layers"], cfg, x, impl=impl or ("eager" if eager else "fused"))
    if cfg.use_final_layernorm:
        x = layer_norm(x, params["final_ln"], cfg.layer_norm_eps)
    return x
