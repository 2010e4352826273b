"""VL-CABS, eager (port of radzero_tpu/ops/vlcabs.py): the reference for
the fused kernel K5 and the path for ``sim_op="dot"``.

Per (image b, query n), tokens t_b (L x D), query q_n:

    cos:  s = cos(q_n, t_b) / tau     (aggregation over the NORMALISED tokens)
    dot:  s = (q_n . t_b) / sqrt(D)
    a     = softmax(s)   (fp32)
    logit = l2(q_n) . l2(a @ tokens)

Returns logits (N, B) and the scores (B, N, L).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from radzero_torch.ops.layers import l2_normalize


def vlcabs_similarity(
    queries: torch.Tensor,       # (N, D)
    tokens: torch.Tensor,        # (B, L, D)
    *,
    sim_op: str = "cos",
    temperature: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    cdt = tokens.dtype
    if sim_op == "cos":
        if temperature is None:
            raise ValueError("cos sim_op requires a temperature")
        qn = l2_normalize(queries.to(cdt))
        agg_tokens = l2_normalize(tokens)
        scores = torch.einsum("nd,bld->bnl", qn, agg_tokens) / temperature.to(cdt)
    elif sim_op == "dot":
        denom = torch.sqrt(torch.tensor(float(tokens.shape[-1]), dtype=cdt))
        agg_tokens = tokens
        scores = torch.einsum("nd,bld->bnl", queries.to(cdt), tokens) / denom.to(tokens.device)
    else:
        raise NotImplementedError(f"sim_op {sim_op!r}")

    attn = torch.softmax(scores.float(), dim=-1).to(cdt)
    aggregated = torch.einsum("bnl,bld->bnd", attn, agg_tokens)
    qn2 = l2_normalize(queries.to(cdt).expand_as(aggregated))
    logits = torch.einsum("bnd,bnd->bn", qn2, l2_normalize(aggregated)).T
    return logits, scores
