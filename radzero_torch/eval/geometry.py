"""Similarity-map inverse geometry (port of radzero_tpu/eval/geometry.py):
flat g*g patch maps -> the original image's pixels, through the inverse of
the preprocessing (resize / pad-then-resize / resize-then-crop / M3AE
pad+crop). Bilinear upsampling is ``F.interpolate`` with
``align_corners=False``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from radzero_torch.ops.resize import bilinear_resize_2d

FILL = -999.0  # out-of-crop filler


def _bilinear(x, out_h: int, out_w: int) -> np.ndarray:
    return bilinear_resize_2d(torch.as_tensor(x, dtype=torch.float32), out_h, out_w).numpy()


def upsample_similarity_map(
    scores, origin_size: Tuple[int, int], geometry: str = "resize"
) -> np.ndarray:
    """Project flat patch scores (..., L), L = g*g, to (..., H, W) float32."""
    scores = np.asarray(scores, np.float32)
    height, width = origin_size
    g = int(round(scores.shape[-1] ** 0.5))
    grid = scores.reshape(*scores.shape[:-1], g, g)

    if geometry == "resize":
        return _bilinear(grid, height, width)

    if geometry == "aspect_pad":
        padded = max(height, width)
        up = _bilinear(grid, padded, padded)
        top, left = (padded - height) // 2, (padded - width) // 2
        return up[..., top : top + height, left : left + width]

    if geometry == "center_crop":
        short = min(height, width)
        up = _bilinear(grid, short, short)
        out = np.full((*scores.shape[:-1], height, width), FILL, np.float32)
        top, left = (height - short) // 2, (width - short) // 2
        out[..., top : top + short, left : left + short] = up
        return out

    if geometry == "m3ae":
        padded = max(height, width)
        cropped = int(padded * 224 / 256)
        up = _bilinear(grid, cropped, cropped)
        canvas = np.full((*scores.shape[:-1], padded, padded), FILL, np.float32)
        off = (padded - cropped) // 2
        canvas[..., off : off + cropped, off : off + cropped] = up
        top, left = (padded - height) // 2, (padded - width) // 2
        return canvas[..., top : top + height, left : left + width]

    raise NotImplementedError(f"geometry {geometry!r}")
