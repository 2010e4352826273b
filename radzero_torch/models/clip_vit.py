"""CLIP / SigLIP-style vision towers (port of radzero_tpu/models/clip_vit.py).

Alternate vision encoders from the reference factory
(exp/cxr_pt/model/vision_encoders.py:23-43: clip_vision_model,
siglip_vision_model, xrayclip, biomedclip). Architecture facts (HF
CLIPVisionTransformer / SiglipVisionTransformer):

- CLIP: class embedding + bias-free patch conv, learned absolute pos
  embeds (incl. CLS slot), pre-layernorm, pre-LN encoder blocks with
  quick_gelu, last_hidden_state = encoder output (post_layernorm only
  feeds pooling). XrayCLIP and BioMedCLIP are CLIP-shaped.
- SigLIP: no class token, gelu_tanh ("gelu_pytorch_tanh"), trailing
  post_layernorm applied to the hidden states.

High-resolution inference resamples the position embeddings bicubically
(the wrapper behavior of vision_encoders.py:98-125,164-191), reusing the
DINOv2 tower's fp32 resample (:func:`radzero_torch.models.vit.
interpolate_pos_embed`). ``patchify`` needs an image size that the patch
divides: ``ClipViTConfig.img_size`` defaults to the JAX package's 518,
which 16 does not divide, so configs name 224 or 512.

Parameters are the JAX layout with the layers unstacked (a list), q / k /
v kept apart; plain torch ops, as the JAX tower runs no Pallas kernel.
Over a model group ``tp`` (the parameters this rank's share,
``parallel/tensor_parallel.py``) each layer runs the rank's heads, q / k / v
and fc1 column-parallel and o and fc2 row-parallel, as the JAX rules split
them; the patch and position embeddings, the class token and the pre / post
LayerNorms stay whole, and every rank returns the same tokens.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from radzero_torch.models.bert import init_qkvo
from radzero_torch.models.convert import _lin, _ln, _stack
from radzero_torch.models.vit import _init_linear, _init_ln, _normal, interpolate_pos_embed, patchify
from radzero_torch.ops.layers import column_linear, layer_norm, linear, row_linear, self_attention
from radzero_torch.parallel.tensor_parallel import active


@dataclass(frozen=True)
class ClipViTConfig:
    model_type: str = "clip"          # clip | siglip
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    patch_size: int = 16
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    pretrain_img_size: int = 224
    img_size: int = 518
    hidden_act: str = "quick_gelu"    # quick_gelu | gelu_pytorch_tanh
    use_class_token: bool = True      # False for SigLIP
    final_layernorm: bool = False     # True for SigLIP

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name in ("gelu_pytorch_tanh", "gelu_tanh"):
        return torch.nn.functional.gelu(x, approximate="tanh")
    return torch.nn.functional.gelu(x, approximate="none")


def init_prenorm_layers(g: torch.Generator, n: int, d: int, f: int) -> list:
    """``n`` pre-LN layers (ln1, q/k/v/o, ln2, fc1/fc2): CLIP, MAE and the CLIP text tower."""
    return [{"ln1": _init_ln(g, d), "attn": init_qkvo(g, d), "ln2": _init_ln(g, d),
             "mlp": {"fc1": _init_linear(g, d, f), "fc2": _init_linear(g, f, d)}}
            for _ in range(n)]


def init_clip_vit(g: torch.Generator, cfg: ClipViTConfig) -> dict:
    d, f = cfg.hidden_size, cfg.intermediate_size
    grid = cfg.pretrain_img_size // cfg.patch_size
    n_pos = grid * grid + (1 if cfg.use_class_token else 0)
    params = {
        "patch_embed": {"kernel": _normal(g, (cfg.patch_size**2 * cfg.num_channels, d))},
        "pos_embed": _normal(g, (1, n_pos, d)),
        "pre_ln": _init_ln(g, d),
        "layers": init_prenorm_layers(g, cfg.num_hidden_layers, d, f),
    }
    if cfg.use_class_token:
        params["class_embedding"] = _normal(g, (d,))
    if cfg.final_layernorm:
        params["post_ln"] = _init_ln(g, d)
    return params


def prenorm_layer(x, p, heads: int, eps: float, act_name: str, bias=None, tp=None):
    """x + attn(ln1(x)); then + mlp(ln2(x)) with ``act_name`` between fc1 and
    fc2. Over a model group ``tp`` the attention runs the rank's heads, fc1 is
    column-parallel and fc2 row-parallel (its whole bias added after the sum)."""
    x = x + self_attention(layer_norm(x, p["ln1"], eps), p["attn"], heads, bias, tp)
    h = layer_norm(x, p["ln2"], eps)
    return x + row_linear(act(column_linear(h, p["mlp"]["fc1"], tp), act_name),
                          p["mlp"]["fc2"], tp)


def clip_pos_embed(params: dict, cfg: ClipViTConfig, grid) -> torch.Tensor:
    """The position table at ``grid`` (h, w): with the CLS slot, or, for SigLIP's
    table without one, resampled through a zero slot that is cut again."""
    pe = params["pos_embed"]
    if cfg.use_class_token:
        return interpolate_pos_embed(pe, grid)
    fake = torch.cat([torch.zeros_like(pe[:, :1]), pe], dim=1)
    return interpolate_pos_embed(fake, grid)[:, 1:]


def clip_vit_forward(params: dict, cfg: ClipViTConfig, pixel_values: torch.Tensor, *,
                     dtype=torch.float32, tp=None) -> torch.Tensor:
    """(B, H, W, C) NHWC -> (B, [1+]h*w, D) last hidden state; ``tp``: a model
    group (see the module docstring)."""
    tp = active(tp)
    b, hh, ww, _ = pixel_values.shape
    grid = (hh // cfg.patch_size, ww // cfg.patch_size)
    x = patchify(pixel_values.to(dtype), cfg.patch_size) @ params["patch_embed"]["kernel"].to(dtype)
    if "bias" in params["patch_embed"]:  # timm ViTs carry a patch bias
        x = x + params["patch_embed"]["bias"].to(dtype)
    if cfg.use_class_token:
        cls = params["class_embedding"].to(dtype)[None, None].expand(b, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1)
    x = x + clip_pos_embed(params, cfg, grid).to(dtype)
    if "pre_ln" in params:
        x = layer_norm(x, params["pre_ln"], cfg.layer_norm_eps)
    for p in params["layers"]:
        x = prenorm_layer(x, p, cfg.num_attention_heads, cfg.layer_norm_eps, cfg.hidden_act,
                          tp=tp)
    if cfg.final_layernorm and "post_ln" in params:
        x = layer_norm(x, params["post_ln"], cfg.layer_norm_eps)
    return x


def clip_params_at_grid(params: dict, cfg: ClipViTConfig, grid: int) -> dict:
    """``params`` with the position table resampled to a grid x grid patch grid
    once, as :func:`clip_vit_forward` resamples it every call (which then passes
    it through)."""
    pe = clip_pos_embed(params, cfg, (grid, grid))
    return {**params, "pos_embed": pe}


# ---------------------------------------------------------------------------
# Converters (HF CLIPVisionModel / SiglipVisionModel, timm state dicts ->
# the JAX layout, which params_from_jax takes)
# ---------------------------------------------------------------------------

def _patch_kernel(w: np.ndarray) -> np.ndarray:
    """(D, C, P, P) conv weight -> (P*P*C, D) in patchify's (ph, pw, c) order."""
    return w.transpose(2, 3, 1, 0).reshape(-1, w.shape[0]).copy()


def convert_clip_vision(sd: dict, num_layers: int, prefix: str = "vision_model.") -> dict:
    p = prefix
    layers = []
    for i in range(num_layers):
        q = f"{p}encoder.layers.{i}"
        layers.append(
            {
                "ln1": _ln(sd, f"{q}.layer_norm1"),
                "attn": {
                    "q": _lin(sd, f"{q}.self_attn.q_proj"),
                    "k": _lin(sd, f"{q}.self_attn.k_proj"),
                    "v": _lin(sd, f"{q}.self_attn.v_proj"),
                    "o": _lin(sd, f"{q}.self_attn.out_proj"),
                },
                "ln2": _ln(sd, f"{q}.layer_norm2"),
                "mlp": {"fc1": _lin(sd, f"{q}.mlp.fc1"), "fc2": _lin(sd, f"{q}.mlp.fc2")},
            }
        )
    params = {
        # no bias in CLIP's patch conv
        "patch_embed": {"kernel": _patch_kernel(sd[f"{p}embeddings.patch_embedding.weight"])},
        "pos_embed": sd[f"{p}embeddings.position_embedding.weight"][None].copy(),
        "pre_ln": _ln(sd, f"{p}pre_layrnorm")
        if f"{p}pre_layrnorm.weight" in sd
        else _ln(sd, f"{p}pre_layernorm"),
        "layers": _stack(layers),
    }
    if f"{p}embeddings.class_embedding" in sd:
        params["class_embedding"] = sd[f"{p}embeddings.class_embedding"].copy()
    if f"{p}post_layernorm.weight" in sd:
        params["post_ln"] = _ln(sd, f"{p}post_layernorm")
    return params


def convert_timm_vit(sd: dict, num_layers: int, prefix: str = "") -> dict:
    """timm VisionTransformer state dict -> the JAX layout.

    The layout BioMedCLIP's open_clip tower uses
    (ref vision_encoders.py biomedclip wrapper): patch conv WITH bias,
    no pre-layernorm, fused blocks.{i}.attn.qkv, trailing 'norm'.
    Pair with ClipViTConfig(hidden_act='gelu', final_layernorm=True).
    """
    p = prefix
    layers = []
    for i in range(num_layers):
        q = f"{p}blocks.{i}"
        wq, wk, wv = np.split(sd[f"{q}.attn.qkv.weight"], 3, axis=0)  # (3D, D)
        bq, bk, bv = np.split(sd[f"{q}.attn.qkv.bias"], 3, axis=0)
        layers.append(
            {
                "ln1": _ln(sd, f"{q}.norm1"),
                "attn": {
                    "q": {"kernel": wq.T.copy(), "bias": bq.copy()},
                    "k": {"kernel": wk.T.copy(), "bias": bk.copy()},
                    "v": {"kernel": wv.T.copy(), "bias": bv.copy()},
                    "o": _lin(sd, f"{q}.attn.proj"),
                },
                "ln2": _ln(sd, f"{q}.norm2"),
                "mlp": {"fc1": _lin(sd, f"{q}.mlp.fc1"), "fc2": _lin(sd, f"{q}.mlp.fc2")},
            }
        )
    return {
        "patch_embed": {
            "kernel": _patch_kernel(sd[f"{p}patch_embed.proj.weight"]),
            "bias": sd[f"{p}patch_embed.proj.bias"].copy(),
        },
        "class_embedding": sd[f"{p}cls_token"].reshape(-1).copy(),
        "pos_embed": sd[f"{p}pos_embed"].copy(),
        "layers": _stack(layers),
        "post_ln": _ln(sd, f"{p}norm"),
    }
