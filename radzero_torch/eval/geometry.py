"""Similarity-map inverse geometry (port of radzero_tpu/eval/geometry.py):
flat g*g patch maps -> the original image's pixels, through the inverse of
the preprocessing (resize / pad-then-resize / resize-then-crop / M3AE
pad+crop). Bilinear upsampling is ``F.interpolate`` with
``align_corners=False``.

The upsample, the crop and the fill run on ``device`` (the card unless the
caller passes ``"cpu"``, as the scorer, the engine and ``model_inference``
pass theirs); the result is read back once as a float32 numpy array.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from radzero_torch.ops.resize import bilinear_resize_2d

FILL = -999.0  # out-of-crop filler (ref grounding_utils.py:214, seg:85,96)


def _canvas(lead, height: int, width: int, up: torch.Tensor, top: int, left: int):
    out = torch.full((*lead, height, width), FILL, dtype=torch.float32, device=up.device)
    out[..., top : top + up.shape[-2], left : left + up.shape[-1]] = up
    return out


def upsample_similarity_map(
    scores, origin_size: Tuple[int, int], geometry: str = "resize", *, device="cuda"
) -> np.ndarray:
    """Project flat patch scores (..., L), L = g*g, to (..., H, W) float32."""
    scores = torch.as_tensor(np.asarray(scores, np.float32), device=device)
    height, width = origin_size
    lead = scores.shape[:-1]
    g = int(round(scores.shape[-1] ** 0.5))
    grid = scores.reshape(*lead, g, g)

    if geometry == "resize":  # Blip / XrayDINOv2 (seg_utils.py:62-70)
        out = bilinear_resize_2d(grid, height, width)
    elif geometry == "aspect_pad":  # AspectRatio processor (seg_utils.py:41-60)
        padded = max(height, width)
        top, left = (padded - height) // 2, (padded - width) // 2
        out = bilinear_resize_2d(grid, padded, padded)[
            ..., top : top + height, left : left + width]
    elif geometry == "center_crop":  # Bit processor (seg_utils.py:72-91)
        short = min(height, width)
        up = bilinear_resize_2d(grid, short, short)
        out = _canvas(lead, height, width, up, (height - short) // 2, (width - short) // 2)
    elif geometry == "m3ae":  # M3AE pad+crop composite (seg_utils.py:92-121)
        padded = max(height, width)
        cropped = int(padded * 224 / 256)
        up = bilinear_resize_2d(grid, cropped, cropped)
        off = (padded - cropped) // 2
        top, left = (padded - height) // 2, (padded - width) // 2
        out = _canvas(lead, padded, padded, up, off, off)[
            ..., top : top + height, left : left + width]
    else:
        raise NotImplementedError(f"geometry {geometry!r}")
    return out.contiguous().cpu().numpy()


def grounding_point(
    scores, origin_size: Tuple[int, int], geometry: str = "resize", *, device="cuda"
) -> Tuple[int, int]:
    """(x, y) of the map argmax in original pixel coordinates
    (ref grounding_utils.py:166-261)."""
    height, width = origin_size
    up = upsample_similarity_map(scores, origin_size, geometry, device=device)
    flat_idx = int(np.argmax(up.reshape(-1)))
    y, x = np.unravel_index(flat_idx, (height, width))
    return int(x), int(y)


def is_point_in_bbox(bbox_list, point) -> bool:
    """point-in-any-box test (ref grounding_utils.py:264-280)."""
    x, y = point
    for x_min, y_min, x_max, y_max in bbox_list:
        if x_min <= x <= x_max and y_min <= y <= y_max:
            return True
    return False
