"""MAE-style ViT vision encoder ("m3ae" / MRM-equivalent; port of
radzero_tpu/models/mae_vit.py).

The reference's optional 'm3ae' vision tower is CARZero's MRM — a
masked-autoencoder ViT whose encoder returns a (global, local) latent
pair consumed as vision tokens (exp/cxr_pt/model/vision_encoders.py:
47-64; modeling.py:100-106). A clean-room MAE encoder with the
standard recipe: patch-16 embedding, CLS token, *fixed 2-D sin-cos*
position embeddings, pre-LN blocks without LayerScale, final LayerNorm;
global latent = normalised CLS, local latents = patch tokens. The sin-cos
table is computed (numpy, float64, cast to fp32), so the tower has no
position parameters to resample. Over a model group ``tp`` the layers split
as the CLIP tower's (``models/clip_vit.py``); the patch embedding, the class
token and the final LayerNorm stay whole.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from radzero_torch.models.clip_vit import init_prenorm_layers, prenorm_layer
from radzero_torch.models.vit import _init_linear, _init_ln, _normal, patchify
from radzero_torch.ops.layers import layer_norm, linear
from radzero_torch.parallel.tensor_parallel import active


@dataclass(frozen=True)
class MAEViTConfig:
    model_type: str = "mae"
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    mlp_ratio: float = 4.0
    patch_size: int = 16
    num_channels: int = 3
    layer_norm_eps: float = 1e-6
    img_size: int = 224

    @property
    def intermediate_size(self):
        return int(self.hidden_size * self.mlp_ratio)


def sincos_pos_embed_2d(dim: int, grid_h: int, grid_w: int, cls_token: bool = True) -> np.ndarray:
    """Standard MAE fixed 2-D sin-cos position embedding (1, [1+]h*w, D)."""
    def one_dim(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2))
        out = np.einsum("p,f->pf", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gh = np.arange(grid_h, dtype=np.float64)
    gw = np.arange(grid_w, dtype=np.float64)
    ww, hh = np.meshgrid(gw, gh)
    emb = np.concatenate([one_dim(dim // 2, hh), one_dim(dim // 2, ww)], axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros((1, dim)), emb], axis=0)
    return emb[None].astype(np.float32)


def init_mae_vit(g: torch.Generator, cfg: MAEViTConfig) -> dict:
    d = cfg.hidden_size
    return {
        "patch_embed": _init_linear(g, cfg.patch_size**2 * cfg.num_channels, d),
        "cls_token": _normal(g, (1, 1, d)),
        "layers": init_prenorm_layers(g, cfg.num_hidden_layers, d, cfg.intermediate_size),
        "final_ln": _init_ln(g, d),
    }


def mae_vit_forward(params: dict, cfg: MAEViTConfig, pixel_values: torch.Tensor, *,
                    dtype=torch.float32, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (global (B, D), local (B, h*w, D)) — the MRM output contract; ``tp``:
    a model group (see the module docstring)."""
    tp = active(tp)
    b, hh, ww, _ = pixel_values.shape
    gh, gw = hh // cfg.patch_size, ww // cfg.patch_size
    x = linear(patchify(pixel_values.to(dtype), cfg.patch_size), params["patch_embed"])
    cls = params["cls_token"].to(dtype).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    pos = torch.from_numpy(sincos_pos_embed_2d(cfg.hidden_size, gh, gw))
    x = x + pos.to(device=x.device, dtype=dtype)
    for p in params["layers"]:
        x = prenorm_layer(x, p, cfg.num_attention_heads, cfg.layer_norm_eps, "gelu", tp=tp)
    x = layer_norm(x, params["final_ln"], cfg.layer_norm_eps)
    return x[:, 0], x[:, 1:]


def mae_vision_tokens(params, cfg, pixel_values, *, dtype=torch.float32,
                      tp=None) -> torch.Tensor:
    """Vision-token layout the composite model consumes: concat of the
    global latent and patch latents (ref modeling.py:100-106)."""
    g, l = mae_vit_forward(params, cfg, pixel_values, dtype=dtype, tp=tp)
    return torch.cat([g[:, None], l], dim=1)
