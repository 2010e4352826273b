"""The composite RadZero model (port of radzero_tpu/models/radzero.py):
DINOv2 tower -> align adapter -> VL-CABS head, plus the MPNet tower, under
one dict of parameters whose top-level keys mirror the JAX tree.

Only the zero-shot ``radzero`` scoring path is ported; the
``cls_alignment`` / ``global_alignment`` logits types and the training
forward come later (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict

import torch

from radzero_torch.losses.radzero_loss import (
    init_radzero_loss,
    radzero_similarity,
    temperatures,
)
from radzero_torch.models.align import build_align_adapter
from radzero_torch.models.configuration import RadZeroConfig
from radzero_torch.models.mpnet import init_mpnet, masked_mean_pool, mpnet_forward
from radzero_torch.models.vit import init_vit, vit_forward
from radzero_torch.ops.layers import l2_normalize, linear


def init_radzero(g: torch.Generator, cfg: RadZeroConfig) -> dict:
    """Weights at the real shapes from ``g`` (fp32, on ``g.device``), in
    the layout :func:`radzero_torch.models.from_jax.params_from_jax`
    produces."""
    if getattr(cfg.vision, "model_type", "dinov2") not in ("dinov2", "raddino"):
        raise NotImplementedError(f"vision model_type {cfg.vision.model_type!r}")
    if cfg.text.model_type != "mpnet":
        raise NotImplementedError(f"text model_type {cfg.text.model_type!r}")
    align_init, _ = build_align_adapter(cfg.align.model_type)
    params = {
        "vision_model": init_vit(g, cfg.vision),
        "align_transformer": align_init(g, cfg.align),
        "text_model": init_mpnet(g, cfg.text),
    }
    if cfg.text.use_text_projection:
        d_in, d_out = cfg.text.hidden_size, 2 * cfg.align.hidden_size
        params["text_projector"] = {
            "kernel": torch.randn((d_in, d_out), generator=g, device=g.device) * 0.02,
            "bias": torch.zeros(d_out, device=g.device),
        }
    params["loss_fns"] = {"RadZeroLoss": init_radzero_loss(cfg.loss, device=g.device)}
    return params


def forward_vision(params: dict, cfg: RadZeroConfig, pixel_values: torch.Tensor, *,
                   dtype=torch.float32, eager: bool = False) -> Dict[str, torch.Tensor]:
    """Tower + align adapter + pooled image features, (B, H, W, 3) NHWC."""
    if getattr(cfg.vision, "model_type", "dinov2") not in ("dinov2", "raddino"):
        raise NotImplementedError(f"vision model_type {cfg.vision.model_type!r}")
    tokens = vit_forward(params["vision_model"], cfg.vision, pixel_values,
                         dtype=dtype, eager=eager)
    _, align_apply = build_align_adapter(cfg.align.model_type)
    tokens = align_apply(params["align_transformer"], cfg.align, tokens, eager=eager)
    cls_token, patch_tokens = tokens[:, 0], tokens[:, 1:]
    image_features = l2_normalize(torch.cat([cls_token, patch_tokens.mean(dim=1)], dim=-1))
    return {
        "vision_tokens": tokens,
        "image_cls_token": cls_token,
        "image_patch_tokens": patch_tokens,
        "image_features": image_features,
    }


def forward_text(params: dict, cfg: RadZeroConfig, input_ids, attention_mask, *,
                 dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """MPNet + optional projector (on token embeddings) + pooling."""
    if cfg.text.model_type != "mpnet":
        raise NotImplementedError(f"text model_type {cfg.text.model_type!r}")
    hidden = mpnet_forward(params["text_model"], cfg.text, input_ids, attention_mask,
                           dtype=dtype)
    if cfg.text.use_text_projection:
        hidden = linear(hidden, params["text_projector"])
    if cfg.text.use_cls_token:
        text_features = hidden[:, 0, :]
    else:
        text_features = masked_mean_pool(hidden, attention_mask)
    return {
        "text_features_wo_l2_norm": text_features,
        "text_features": l2_normalize(text_features),
    }


def compute_logits(
    params: dict,
    cfg: RadZeroConfig,
    pixel_values: torch.Tensor,    # (B, H, W, 3)
    input_ids: torch.Tensor,       # (N, L)
    attention_mask: torch.Tensor,  # (N, L)
    *,
    dtype=torch.float32,
    eager: bool = False,
) -> Dict[str, torch.Tensor]:
    """Zero-shot scoring, ``radzero`` branch:

        logits             (B, N)    = t2i_logits.T / exp(log_loss_temperature)
        similarity_scores  (B, N, L-1)  pre-softmax maps, CLS column removed

    The vision layers and VL-CABS run through the kernels K1-K3 and K5
    (their plain twins for CPU tensors); ``eager=True`` runs the eager
    reference ops instead, for checking the kernels on the card."""
    if cfg.compute_logits_type != "radzero":
        raise NotImplementedError(
            f"compute_logits_type {cfg.compute_logits_type!r} is not ported yet "
            "(ROADMAP.md item 6)"
        )
    vision = forward_vision(params, cfg, pixel_values, dtype=dtype, eager=eager)
    text = forward_text(params, cfg, input_ids, attention_mask, dtype=dtype)
    lparams = params["loss_fns"]["RadZeroLoss"]
    out = radzero_similarity(
        lparams, cfg.loss, text["text_features_wo_l2_norm"], text["text_features"],
        vision["vision_tokens"], eager=eager,
    )
    scores = out["similarity_scores"]
    if cfg.loss.use_vision_cls_token:
        scores = scores[:, :, 1:]
    loss_temp, _ = temperatures(lparams)
    return {"logits": out["t2i_logits"].T / loss_temp, "similarity_scores": scores}
