"""VL-CABS (port of radzero_tpu/ops/vlcabs.py): the eager chain, which is
the reference for the fused kernels, the autograd path of ``impl="xla"``
and the path for ``sim_op="dot"``, and the switch to the fused kernels.

Per (image b, query n), tokens t_b (L x D), query q_n:

    cos:  s = cos(q_n, t_b) / tau     (aggregation over the NORMALISED tokens)
    dot:  s = (q_n . t_b) / sqrt(D)
    a     = softmax(s)   (fp32)
    logit = l2(q_n) . l2(a @ tokens)

Returns logits (N, B) and the scores (B, N, L) or None.

``group`` is the counterpart of the JAX function's ``mesh`` / ``shard_map``
branch (``in_specs=(P(), P("data"), P())``, ``out_specs=P(None, "data")``):
the text queries are gathered to the global N, each rank runs the chain or
the kernels on its own B_r images, and the (N, B_r) logit columns are
gathered to (N, B). Vision tokens never leave their rank. The gathers'
backward sums over the ranks, so a rank's dq from its own columns becomes
the global dq (the ``psum`` of the JAX transpose); no kernel changes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from radzero_torch.ops.layers import l2_normalize
from radzero_torch.ops.vlcabs_fused import vlcabs_fused, vlcabs_fused_train
from radzero_torch.parallel.collectives import all_gather_rows


def vlcabs_similarity(
    queries: torch.Tensor,       # (N, D)
    tokens: torch.Tensor,        # (B, L, D)
    *,
    sim_op: str = "cos",
    temperature: Optional[torch.Tensor] = None,
    need_scores: bool = False,
    impl: str = "xla",
    group=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``impl``:
        xla          eager torch ops: differentiable by autograd, any sim_op
        fused        kernel K5, logits and score maps, forward-only (serving)
        fused_train  kernels K10-K12 behind an autograd function:
                     differentiable, the (B, N, L) scores never reach device
                     memory (cos only; no score maps on this path)

    ``dot`` always takes the eager chain: there is no kernel for it.

    ``group`` (a process group, or None): ``queries`` are this rank's rows
    and ``tokens`` its images; the logits come back (N, B) over every
    rank's queries and images. Score maps stay with their images, so
    ``need_scores`` with a group raises."""
    if impl not in ("xla", "fused", "fused_train"):
        raise ValueError(f"unknown VL-CABS impl {impl!r}")
    if group is not None:
        if need_scores:
            raise ValueError("need_scores with a process group: the maps stay on the rank "
                             "that holds the image")
        logits, _ = vlcabs_similarity(all_gather_rows(queries, group), tokens, sim_op=sim_op,
                                      temperature=temperature, impl=impl)
        out = all_gather_rows(logits.T.contiguous(), group).T
        # the layout of the one-process logits, so that the loss reduces in the same order
        return (out.contiguous() if logits.is_contiguous() else out), None
    cdt = tokens.dtype
    if impl != "xla" and sim_op == "cos":
        if temperature is None:
            raise ValueError("cos sim_op requires a temperature")
        qn = l2_normalize(queries.to(cdt))
        if impl == "fused_train":
            if need_scores:
                raise ValueError("fused_train does not emit score maps")
            return vlcabs_fused_train(qn, tokens.contiguous(), temperature), None
        logits, scores = vlcabs_fused(qn, tokens.contiguous(), temperature.float())
        return logits, (scores if need_scores else None)

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
    return logits, (scores if need_scores else None)
