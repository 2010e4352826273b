"""RadZeroLoss head (port of radzero_tpu/losses/radzero_loss.py).

The shared modality LayerNorm (eps 1e-5, the same parameters on vision
tokens and text features), the 2*hidden text slice, the log-parameterised
temperatures, VL-CABS, and the MP-NCE loss over its t2i logits.
:func:`radzero_loss` is the whole head; :func:`radzero_similarity` is what
zero-shot scoring takes from it (logits and score maps, no loss).

With ``group`` (a process group) the head sees the global batch: VL-CABS
gathers the queries and the logit columns
(:func:`radzero_torch.ops.vlcabs.vlcabs_similarity`), and MP-NCE runs on
the global (S, B) logits with every rank's ``group_map`` and ``row_mask``
gathered in rank order. The loader's ``group_map`` is global already
(``data/pipeline.py``: offset by ``process_index * batch_size``), so every
rank computes the same loss.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from radzero_torch.losses.mpnce import multi_positive_nce_loss
from radzero_torch.models.configuration import LossConfig
from radzero_torch.ops.layers import layer_norm
from radzero_torch.ops.vlcabs import vlcabs_similarity
from radzero_torch.parallel.collectives import gather_rows

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


def radzero_loss(
    params: dict,
    cfg: LossConfig,
    text_features_raw: torch.Tensor,     # (S, D) without l2 norm
    text_features_normed: torch.Tensor,  # (S, D) l2-normed
    group_map: Optional[torch.Tensor],   # (S,) image index per sentence
    row_mask: Optional[torch.Tensor],    # (S,) 1.0 real / 0.0 padding
    vision_tokens: torch.Tensor,         # (B, 1+L, D)
    *,
    need_scores: bool = False,
    compute_loss: bool = True,
    impl: str = "xla",
    group=None,
) -> Dict[str, torch.Tensor]:
    """-> {"t2i_logits": (S, B), "similarity_scores": (B, S, L_attn) when
    asked for, "losses": {"t2i_loss", "loss"} when ``compute_loss``}.
    ``impl`` is :func:`radzero_torch.ops.vlcabs.vlcabs_similarity`'s; with
    ``group`` S and B are the global counts."""
    text = _select_text_features(cfg, text_features_raw, text_features_normed)
    if cfg.use_layer_norm:
        vision_tokens = layer_norm(vision_tokens, params["layer_norm"], _SHARED_LN_EPS)
        text = layer_norm(text, params["layer_norm"], _SHARED_LN_EPS)
    attn_tokens = vision_tokens if cfg.use_vision_cls_token else vision_tokens[:, 1:]
    loss_temp, attn_temp = temperatures(params)

    logits, scores = vlcabs_similarity(
        text, attn_tokens, sim_op=cfg.sim_op, temperature=attn_temp,
        need_scores=need_scores, impl=impl, group=group)
    outputs = {"t2i_logits": logits}
    if scores is not None:
        outputs["similarity_scores"] = scores
    if compute_loss:
        if group is not None:
            group_map, row_mask = (None if t is None else gather_rows(t, group)
                                   for t in (group_map, row_mask))
        t2i_loss = multi_positive_nce_loss(
            logits, group_map, temperature=loss_temp, row_sum=cfg.mpnce_row_sum,
            col_sum=cfg.mpnce_col_sum, row_mask=row_mask)
        outputs["losses"] = {"t2i_loss": t2i_loss, "loss": t2i_loss}
    return outputs


def radzero_similarity(
    params: dict,
    cfg: LossConfig,
    text_features_raw: torch.Tensor,
    text_features_normed: torch.Tensor,
    vision_tokens: torch.Tensor,
    *,
    eager: bool = False,
) -> Dict[str, torch.Tensor]:
    """Zero-shot scoring's share of the head -> {"t2i_logits": (S, B),
    "similarity_scores": (B, S, L_attn)}. ``cos`` runs the fused kernel K5
    unless ``eager``; ``dot`` runs the eager chain."""
    return radzero_loss(
        params, cfg, text_features_raw, text_features_normed, None, None, vision_tokens,
        need_scores=True, compute_loss=False, impl="xla" if eager else "fused")
