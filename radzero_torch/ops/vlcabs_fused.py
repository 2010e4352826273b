"""K5: fused VL-CABS forward (port of radzero_tpu/ops/pallas_vlcabs.py:
vlcabs_fused), logits and the raw pre-softmax score maps in one pass.

Per image, with queries already l2-normalised:

    tn     = t * rsqrt(sum(t^2) + 1e-24)     (rounded to the operand type)
    s      = qn @ tn^T / tau                 (fp32, returned as the map)
    e      = exp(s - rowmax(s))              (rounded to the operand type)
    agg    = e @ tn                          (fp32)
    logits = (qn . agg) / max(|agg|, 1e-12)

The wrapper runs :func:`vlcabs_fused_plain` on a CPU tensor and the CUDA
kernel (``csrc/vlcabs_fused.cu``) on a CUDA tensor; ``vlcabs_fused.
launches`` counts kernel launches. The kernel walks L in tiles with a
running max; the cosine is invariant to scaling agg, so that is exact.
"""

from __future__ import annotations

import torch

from radzero_torch.ops import _build
from radzero_torch.ops._checks import check_operands, on_cuda

_LOG2E = 1.4426950408889634


def vlcabs_fused_plain(queries_normed, tokens, tau):
    cdt = tokens.dtype
    t32 = tokens.float()
    tn = (t32 * torch.rsqrt(t32.square().sum(-1, keepdim=True) + 1e-24)).to(cdt)
    s = torch.einsum("nd,bld->bnl", queries_normed.float(), tn.float())
    s = s * (1.0 / tau.float().reshape(()))
    e = torch.exp2((s - s.amax(-1, keepdim=True)) * _LOG2E).to(cdt)
    agg = e.float() @ tn.float()                                # (B, N, D)
    num = (queries_normed.float() * agg).sum(-1)
    norm = agg.square().sum(-1).sqrt()
    logits = num / norm.clamp_min(1e-12)                        # (B, N)
    return logits.T, s


def vlcabs_fused(queries_normed, tokens, tau):
    """(N, D) l2-normalised queries, (B, L, D) tokens, scalar fp32 tau ->
    (logits (N, B) fp32, scores (B, N, L) fp32)."""
    if not on_cuda(tokens):
        return vlcabs_fused_plain(queries_normed, tokens, tau)
    n = queries_normed.shape[0]
    b, l, d = tokens.shape
    code = check_operands("vlcabs_fused", tokens, queries_normed=((n, d), queries_normed))
    tau = tau.reshape(1)
    if tau.dtype != torch.float32 or tau.device != tokens.device:
        raise TypeError("vlcabs_fused: tau must be a float32 tensor on the tokens' device")
    if d > 1024:
        raise ValueError(f"vlcabs_fused: the kernel takes D <= 1024, got {d}")
    scores = torch.empty((b, n, l), dtype=torch.float32, device=tokens.device)
    logits = torch.empty((n, b), dtype=torch.float32, device=tokens.device)
    lib = _build.load()
    err = lib.rz_vlcabs_fused(
        queries_normed.data_ptr(), tokens.data_ptr(), tau.data_ptr(), scores.data_ptr(),
        logits.data_ptr(), n, b, l, d, code, _build.stream_ptr(tokens),
    )
    _build.check(err, "vlcabs_fused")
    vlcabs_fused.launches += 1
    return logits, scores


vlcabs_fused.launches = 0
