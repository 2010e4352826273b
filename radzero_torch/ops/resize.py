"""Separable 2-D resizes (port of the parts of radzero_tpu/ops/resize.py
the slice uses).

The JAX package builds torch-parity interpolation matrices so that the
TPU can resize with matmuls; the port calls ``F.interpolate`` itself,
in fp32 with ``align_corners=False`` and no antialiasing, which are the
semantics those matrices reproduce.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _resize_2d(x: torch.Tensor, out_h: int, out_w: int, mode: str) -> torch.Tensor:
    """Resize the last two axes of ``x`` (any leading dims) in fp32."""
    lead = x.shape[:-2]
    flat = x.float().reshape(-1, 1, x.shape[-2], x.shape[-1])
    out = F.interpolate(flat, size=(out_h, out_w), mode=mode, align_corners=False)
    return out.reshape(*lead, out_h, out_w)


def bilinear_resize_2d(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    return _resize_2d(x, out_h, out_w, "bilinear")


def bicubic_resize_2d(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    return _resize_2d(x, out_h, out_w, "bicubic")
