"""Similarity-map extraction and overlay rendering (port of
radzero_tpu/viz/overlays.py).

Rebuilds the core of the reference's visualization suite
(exp/cxr_pt/inference/visualization/attention_map_base.py:12-57,
openvocab_attention_map.py:51-169, visualize_utils.py:74-150):
extract the sigmoid similarity map for (image, prompts), render it over
the radiograph with the inferno colormap and optional Gaussian smoothing,
and draw ground-truth boxes / mask contours.

The maps come from the same ZeroShotScorer as the eval harness, so on the
card its default ``fused_tower=True`` runs the kernels K1-K5; the upsample
runs on the scorer's device. The rest is host code in numpy and PIL, with
no matplotlib and no OpenCV:

- ``_gaussian_blur`` is ``cv2.GaussianBlur(arr, (k, k), sigma)`` with
  ``k = int(4 * sigma) | 1``: OpenCV's taps for ``sigma > 0`` (computed in
  float64, normalised, cast to float32) in a separable float32 pass with
  ``BORDER_REFLECT_101``. OpenCV sums in its own order, so the two agree
  to a few float32 ulps, not bit for bit. The JAX function returns the map
  unblurred where cv2 is missing; this one always blurs.
- ``draw_mask_contours`` is the JAX package's cv2-free branch (the rolled
  edge mask), not OpenCV's contour strokes.
- ``render_attention_panel`` lays the tiles out with PIL on a canvas of
  the JAX figure's pixel size (480 x 480 a tile: ``figsize`` 4 x 4 inches
  at 120 dpi), each overlay fitted into its tile with its aspect kept and
  the title above it. The layout is not matplotlib's.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont

from radzero_torch.data.dicom import load_eval_image
from radzero_torch.eval.geometry import upsample_similarity_map
from radzero_torch.eval.scorer import ZeroShotScorer
from radzero_torch.viz.colormaps import get_cmap

TILE = 480  # pixels a panel tile: matplotlib's 4 inches at the saved 120 dpi


def extract_similarity_map(
    scorer: ZeroShotScorer,
    image_path: str,
    prompts: List[str],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (probs (N,), maps (N, H, W) in [0,1], image uint8 (H, W, 3)).

    Same flow as the reference's attention-map base
    (attention_map_base.py:12-42): compute_logits -> per-prompt map ->
    inverse-geometry upsample -> sigmoid.
    """
    with load_eval_image(image_path) as im:
        image = np.asarray(im.convert("RGB"))
    h, w = image.shape[:2]

    def load(_):
        return load_eval_image(image_path)

    logits, scores = scorer.score([image_path], load, prompts, need_scores=True)
    maps = upsample_similarity_map(scores[0], (h, w), scorer.image_processor.geometry,
                                   device=scorer.device)
    probs = 1.0 / (1.0 + np.exp(-logits[0]))
    maps = 1.0 / (1.0 + np.exp(-maps))
    return probs, maps, image


def gaussian_taps(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma, cv2.CV_32F)`` for sigma > 0."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    taps = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (taps * (1.0 / taps.sum())).astype(np.float32)


def _gaussian_blur(arr: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(arr, (k, k), sigma)``, k = int(4 sigma) | 1, of a
    2-D float32 array, within a few float32 ulps (module docstring)."""
    if sigma <= 0:
        return arr
    k = int(sigma * 4) | 1
    taps, r = gaussian_taps(k, sigma), k // 2
    h, w = arr.shape
    out = arr
    for axis, n in ((0, h), (1, w)):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (r, r)
        src = np.pad(out, pad, mode="reflect")  # numpy's reflect is BORDER_REFLECT_101
        acc = np.zeros((h, w), np.float32)
        term = np.empty((h, w), np.float32)
        for i in range(k):
            view = src[i : i + n] if axis == 0 else src[:, i : i + n]
            np.multiply(view, taps[i], out=term)
            acc += term
        out = acc
    return out


def overlay_heatmap(
    image: np.ndarray,
    heat: np.ndarray,
    alpha: float = 0.5,
    cmap: str = "inferno",
    blur_sigma: float = 0.0,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
) -> np.ndarray:
    """Blend a [0,1] heatmap over an RGB image (uint8 in/out)."""
    heat = _gaussian_blur(heat.astype(np.float32), blur_sigma)
    lo = heat.min() if vmin is None else vmin
    hi = heat.max() if vmax is None else vmax
    norm = (heat - lo) / max(hi - lo, 1e-8)
    colored = (get_cmap(cmap)(np.clip(norm, 0, 1))[..., :3] * 255).astype(np.uint8)
    out = (alpha * colored + (1 - alpha) * image.astype(np.float32)).astype(np.uint8)
    return out


def draw_boxes(
    image: np.ndarray, boxes: Sequence[Sequence[float]], color=(0, 255, 0), width: int = 3
) -> np.ndarray:
    out = image.copy()
    h, w = out.shape[:2]
    for x0, y0, x1, y1 in boxes:
        x0, y0 = max(int(x0), 0), max(int(y0), 0)
        x1, y1 = min(int(x1), w - 1), min(int(y1), h - 1)
        out[y0 : y0 + width, x0:x1] = color
        out[max(y1 - width, 0) : y1, x0:x1] = color
        out[y0:y1, x0 : x0 + width] = color
        out[y0:y1, max(x1 - width, 0) : x1] = color
    return out


def draw_mask_contours(
    image: np.ndarray, mask: np.ndarray, color=(0, 255, 0), width: int = 2
) -> np.ndarray:
    """Outline a binary mask: the pixels where it differs from its
    neighbour above or to the left (``width`` is kept for the JAX
    signature; this outline is one pixel wide)."""
    out = image.copy()
    mask = mask.astype(np.uint8)
    edge = mask ^ np.roll(mask, 1, 0) | mask ^ np.roll(mask, 1, 1)
    out[edge > 0] = color
    return out


def font(size: int = 14):
    """PIL's bundled font (a scalable one where Pillow has FreeType)."""
    try:
        return ImageFont.load_default(size=size)
    except TypeError:  # Pillow before 10.1 has only the bitmap font
        return ImageFont.load_default()


def fit(image: np.ndarray, width: int, height: int) -> Image.Image:
    """``image`` resized to fit (width, height) with its aspect kept."""
    h, w = image.shape[:2]
    scale = min(width / w, height / h)
    size = (max(1, round(w * scale)), max(1, round(h * scale)))
    return Image.fromarray(image).resize(size, Image.Resampling.BILINEAR)


def _tile(canvas: Image.Image, row: int, col: int, image: np.ndarray, title: str) -> None:
    draw = ImageDraw.Draw(canvas)
    x0, y0 = col * TILE, row * TILE
    f = font()
    box = draw.multiline_textbbox((0, 0), title, font=f, align="center")
    title_h = box[3] - box[1] + 12
    draw.multiline_text((x0 + (TILE - (box[2] - box[0])) // 2, y0 + 6), title, fill="black",
                        font=f, align="center")
    pane = fit(image, TILE - 16, TILE - title_h - 8)
    canvas.paste(pane, (x0 + (TILE - pane.width) // 2, y0 + title_h))


def render_attention_panel(
    scorer: ZeroShotScorer,
    image_path: str,
    prompts: List[str],
    save_path: str,
    *,
    boxes: Optional[Sequence[Sequence[float]]] = None,
    mask: Optional[np.ndarray] = None,
    blur_sigma: float = 8.0,
    alpha: float = 0.5,
    ncols: int = 4,
) -> np.ndarray:
    """Grid of per-prompt overlays with probabilities in the title
    (the open-vocab study renderer, openvocab_attention_map.py:172-276)."""
    probs, maps, image = extract_similarity_map(scorer, image_path, prompts)

    n = len(prompts) + 1
    ncols = min(ncols, n)
    nrows = (n + ncols - 1) // ncols
    canvas = Image.new("RGB", (TILE * ncols, TILE * nrows), "white")

    base = image
    if boxes is not None:
        base = draw_boxes(base, boxes)
    if mask is not None:
        base = draw_mask_contours(base, mask)
    _tile(canvas, 0, 0, base, "input")

    for i, prompt in enumerate(prompts):
        r, c = divmod(i + 1, ncols)
        over = overlay_heatmap(image, maps[i], alpha=alpha, blur_sigma=blur_sigma)
        _tile(canvas, r, c, over, f"{prompt}\np={probs[i]:.3f}")

    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    canvas.save(save_path)
    return maps
