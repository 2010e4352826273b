"""Global-batch CLIP / SigLIP auxiliary losses (port of
radzero_tpu/losses/clip.py), plain torch ops.

CLIP:   symmetric InfoNCE over ``scale * img @ txt.T`` with diagonal labels.
SigLIP: pairwise log-sigmoid loss, positives on the diagonal (init scale
        log(10), bias -10).

With ``group`` (a process group) both gather the image and text features
of every rank (:func:`radzero_torch.parallel.collectives.all_gather_rows`)
and run over the global batch: open_clip's ``local_loss=False``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from radzero_torch.parallel.collectives import all_gather_rows


def _global(image_features, text_features, group):
    if group is None:
        return image_features, text_features
    return all_gather_rows(image_features, group), all_gather_rows(text_features, group)


def init_clip_loss(init_logit_scale: float = math.log(1 / 0.07), device=None) -> dict:
    return {"log_logit_scale": torch.tensor([init_logit_scale], dtype=torch.float32,
                                            device=device)}


def clip_loss(params: dict, image_features: torch.Tensor,
              text_features: torch.Tensor, group=None) -> torch.Tensor:
    """Symmetric InfoNCE; features are l2-normalised (B, D)."""
    image_features, text_features = _global(image_features, text_features, group)
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
                text_features: torch.Tensor, group=None) -> torch.Tensor:
    image_features, text_features = _global(image_features, text_features, group)
    scale = torch.exp(params["log_logit_scale"][0])
    logits = scale * image_features @ text_features.T + params["logit_bias"][0]
    b = logits.shape[0]
    signs = 2.0 * torch.eye(b, dtype=logits.dtype, device=logits.device) - 1.0
    return -F.logsigmoid(signs * logits).sum() / b
