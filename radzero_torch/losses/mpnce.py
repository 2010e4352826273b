"""Multi-positive noise-contrastive loss, MP-NCE (port of
radzero_tpu/losses/mpnce.py), masked static-shape form, plain torch ops.

Shapes:
    logits    (S, B)  one row per key-phrase sentence, one column per image
    group_map (S,)    index of the image that owns each sentence
    row_mask  (S,)    1.0 for real sentences, 0.0 for padding rows

Variants:
    row_sum=False : per-row InfoNCE   p_row_i = pos_i / (sum_j e_ij + eps)
    row_sum=True  : grouped row loss, row sums added up per image
    col_sum=False : MP-NCE (UniCLIP)  p_col_i = pos_i / (pos_i + neg_col(g_i) + eps)
    col_sum=True  : MIL-NCE           p_col_j = sum_pos_j / (sum_col_j + eps)

Everything runs in fp32; eps = 1e-8. Padding rows drop out of every sum and
of the final means.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def multi_positive_nce_loss(
    logits: torch.Tensor,
    group_map: torch.Tensor,
    temperature: Union[torch.Tensor, float] = 1.0,
    eps: float = 1e-8,
    row_sum: bool = False,
    col_sum: bool = False,
    row_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    s, b = logits.shape
    logits = logits.float()
    if row_mask is None:
        row_mask = torch.ones(s, dtype=torch.float32, device=logits.device)
    row_mask = row_mask.float()

    scaled = torch.exp(logits / temperature) * row_mask[:, None]  # padded rows -> 0

    cols = torch.arange(b, device=logits.device)
    pos_onehot = (cols[None, :] == group_map[:, None]).float() * row_mask[:, None]
    pos = (scaled * pos_onehot).sum(dim=1)  # (S,) == scaled[i, g_i] on real rows
    n_real = row_mask.sum().clamp_min(1.0)

    if row_sum:
        row_sum_logits = pos_onehot.T @ scaled.sum(dim=1)  # (B,)
        row_pos_sum = pos_onehot.T @ pos                   # (B,)
        p_row = row_pos_sum / (row_sum_logits + eps)
        row_loss_mean = (-torch.log(p_row + eps)).mean()
    else:
        p_row = pos / (scaled.sum(dim=1) + eps)
        row_loss_mean = (-torch.log(p_row + eps) * row_mask).sum() / n_real

    if col_sum:
        column_sum = scaled.sum(dim=0)                     # (B,)
        column_pos = (scaled * pos_onehot).sum(dim=0)      # (B,)
        p_col = column_pos / (column_sum + eps)
        col_loss_mean = (-torch.log(p_col + eps)).mean()
    else:
        neg_mask = (1.0 - pos_onehot) * row_mask[:, None]
        sum_neg = (scaled * neg_mask).sum(dim=0)           # (B,) per-column negatives
        sum_neg_i = (pos_onehot * sum_neg[None, :]).sum(dim=1)  # (S,) = sum_neg[g_i]
        p_col = pos / (pos + sum_neg_i + eps)
        col_loss_mean = (-torch.log(p_col + eps) * row_mask).sum() / n_real

    return (row_loss_mean + col_loss_mean) / 2.0
