"""RadZeroLoss head, forward part (port of radzero_tpu/losses/radzero_loss.py).

What zero-shot scoring uses: the shared modality LayerNorm (eps 1e-5, the
same parameters on vision tokens and text features), the 2*hidden text
slice, the log-parameterised temperatures, and VL-CABS. The MP-NCE loss
itself comes with the training slice.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from radzero_torch.models.configuration import LossConfig
from radzero_torch.ops.layers import l2_normalize, layer_norm
from radzero_torch.ops.vlcabs import vlcabs_similarity
from radzero_torch.ops.vlcabs_fused import vlcabs_fused

_SHARED_LN_EPS = 1e-5  # torch nn.LayerNorm default


def init_radzero_loss(cfg: LossConfig, device=None) -> dict:
    params = {
        "log_loss_temperature": torch.tensor([math.log(cfg.loss_temperature)],
                                             dtype=torch.float32, device=device),
    }
    if cfg.attn_temperature is not None:
        params["log_attn_temperature"] = torch.tensor(
            [math.log(cfg.attn_temperature)], dtype=torch.float32, device=device)
    if cfg.use_layer_norm:
        params["layer_norm"] = {"scale": torch.ones(cfg.hidden_dim, device=device),
                                "bias": torch.zeros(cfg.hidden_dim, device=device)}
    return params


def _select_text_features(cfg: LossConfig, raw, normed):
    feat = normed if cfg.text_features_l2_norm else raw
    if feat.shape[-1] == 2 * cfg.hidden_dim:
        feat = feat[:, cfg.hidden_dim :]
    return feat


def temperatures(params: dict):
    """-> (loss_temp, attn_temp) scalars, exp taken in the params' dtype."""
    loss_temp = torch.exp(params["log_loss_temperature"][0])
    if "log_attn_temperature" in params:
        return loss_temp, torch.exp(params["log_attn_temperature"][0])
    return loss_temp, loss_temp


def radzero_similarity(
    params: dict,
    cfg: LossConfig,
    text_features_raw: torch.Tensor,     # (S, D) without l2 norm
    text_features_normed: torch.Tensor,  # (S, D) l2-normed
    vision_tokens: torch.Tensor,         # (B, 1+L, D)
    *,
    eager: bool = False,
) -> Dict[str, torch.Tensor]:
    """-> {"t2i_logits": (S, B), "similarity_scores": (B, S, L_attn)}.

    ``cos`` runs the fused kernel K5 unless ``eager``; ``dot`` runs the
    eager path (the JAX package has no kernel for it either)."""
    text = _select_text_features(cfg, text_features_raw, text_features_normed)
    if cfg.use_layer_norm:
        vision_tokens = layer_norm(vision_tokens, params["layer_norm"], _SHARED_LN_EPS)
        text = layer_norm(text, params["layer_norm"], _SHARED_LN_EPS)
    attn_tokens = vision_tokens if cfg.use_vision_cls_token else vision_tokens[:, 1:]
    _, attn_temp = temperatures(params)

    if cfg.sim_op == "cos" and not eager:
        qn = l2_normalize(text.to(attn_tokens.dtype))
        logits, scores = vlcabs_fused(qn, attn_tokens.contiguous(), attn_temp.float())
    else:
        logits, scores = vlcabs_similarity(
            text, attn_tokens, sim_op=cfg.sim_op, temperature=attn_temp)
    return {"t2i_logits": logits, "similarity_scores": scores}
