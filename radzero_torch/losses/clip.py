"""Global-batch CLIP / SigLIP auxiliary losses (port of
radzero_tpu/losses/clip.py), plain torch ops.

CLIP:   symmetric InfoNCE over ``scale * img @ txt.T`` with diagonal labels.
SigLIP: pairwise log-sigmoid loss, positives on the diagonal (init scale
        log(10), bias -10).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def init_clip_loss(init_logit_scale: float = math.log(1 / 0.07), device=None) -> dict:
    return {"log_logit_scale": torch.tensor([init_logit_scale], dtype=torch.float32,
                                            device=device)}


def clip_loss(params: dict, image_features: torch.Tensor,
              text_features: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE; features are l2-normalised (B, D)."""
    scale = torch.exp(params["log_logit_scale"][0])
    logits = scale * image_features @ text_features.T  # (B, B)
    li = -torch.diagonal(F.log_softmax(logits, dim=-1)).mean()
    lt = -torch.diagonal(F.log_softmax(logits.T, dim=-1)).mean()
    return (li + lt) / 2.0


def init_siglip_loss(init_logit_scale: float = math.log(10.0),
                     init_logit_bias: float = -10.0, device=None) -> dict:
    return {
        "log_logit_scale": torch.tensor([init_logit_scale], dtype=torch.float32, device=device),
        "logit_bias": torch.tensor([init_logit_bias], dtype=torch.float32, device=device),
    }


def siglip_loss(params: dict, image_features: torch.Tensor,
                text_features: torch.Tensor) -> torch.Tensor:
    scale = torch.exp(params["log_logit_scale"][0])
    logits = scale * image_features @ text_features.T + params["logit_bias"][0]
    b = logits.shape[0]
    signs = 2.0 * torch.eye(b, dtype=logits.dtype, device=logits.device) - 1.0
    return -F.logsigmoid(signs * logits).sum() / b
