"""Open-vocabulary segmentation-map renderers (port of radzero_tpu/viz/segmap.py).

Rebuilds the reference's qualitative assessment renderers
(qualitative_assessment_utils.py:11-188,
disease_qualitative_assessment_utils.py:11-214, anatomy_segmentation.py,
disease_segmentation.py): per-class similarity maps -> argmax /
thresholded multi-class segmentation maps rendered with a color legend.

``render_segmap`` computes the JAX package's overlay array and draws it
with PIL, fitted with its aspect kept into a 960 x 960 canvas (the JAX
figure is ``figsize=(8, 8)`` saved at 120 dpi), with the legend of the
classes present in the overlay's lower right corner.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image, ImageDraw

from radzero_torch.eval.scorer import ZeroShotScorer
from radzero_torch.viz.colormaps import get_cmap
from radzero_torch.viz.overlays import extract_similarity_map, fit, font

CANVAS = 960  # pixels: matplotlib's 8 inches at the saved 120 dpi

# anatomy / disease prompt catalogs from the reference study scripts
ANATOMY_CLASSES = [
    "right lung", "left lung", "heart", "mediastinum", "trachea",
    "right clavicle", "left clavicle", "spine", "aortic arch", "diaphragm",
]
DISEASE_CLASSES = [
    "Atelectasis", "Cardiomegaly", "Consolidation", "Edema",
    "Pleural Effusion", "Pneumonia", "Pneumothorax", "Mass", "Nodule",
]


def compute_segmap(
    scorer: ZeroShotScorer,
    image_path: str,
    class_names: List[str],
    *,
    prompt_template: str = "There is {}",
    threshold: Optional[float] = 0.5,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (segmap (H, W) int; -1 = background, maps (N, H, W), image).

    argmax over per-class sigmoid maps; pixels whose winning probability
    is below ``threshold`` become background (threshold=None disables).
    """
    prompts = [prompt_template.format(c) for c in class_names]
    _, maps, image = extract_similarity_map(scorer, image_path, prompts)
    seg = maps.argmax(axis=0).astype(np.int32)
    if threshold is not None:
        seg = np.where(maps.max(axis=0) >= threshold, seg, -1)
    return seg, maps, image


def segmap_overlay(
    image: np.ndarray, segmap: np.ndarray, n_classes: int, alpha: float = 0.45,
    cmap: str = "tab10",
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (the uint8 overlay the JAX ``render_segmap`` draws, the class
    colours (n_classes, 3) in [0, 1])."""
    colors = get_cmap(cmap)(np.linspace(0, 1, max(n_classes, 2)))[:, :3]
    overlay = image.astype(np.float32).copy()
    for i in range(n_classes):
        m = segmap == i
        overlay[m] = (1 - alpha) * overlay[m] + alpha * (colors[i] * 255)
    return overlay.astype(np.uint8), colors


def rgb8(color) -> Tuple[int, int, int]:
    """A [0, 1] RGB colour as PIL's 8-bit tuple."""
    return tuple(int(round(255 * float(c))) for c in color[:3])


LEGEND_LINE, LEGEND_SWATCH, LEGEND_PAD = 20, 14, 6


def legend_size(entries) -> Tuple[int, int]:
    """(width, height) in pixels of :func:`draw_legend`'s frame."""
    if not entries:
        return 0, 0
    f = font(13)
    probe = ImageDraw.Draw(Image.new("RGB", (1, 1)))
    width = max(probe.textbbox((0, 0), label, font=f)[2] for label, _ in entries)
    return width + LEGEND_SWATCH + 3 * LEGEND_PAD, LEGEND_LINE * len(entries) + 2 * LEGEND_PAD


def draw_legend(canvas: Image.Image, entries, right: int, bottom: int) -> None:
    """A framed legend of (label, [0, 1] RGB) entries whose lower right
    corner is at (right, bottom)."""
    if not entries:
        return
    draw = ImageDraw.Draw(canvas)
    f = font(13)
    width, height = legend_size(entries)
    x0, y0 = right - width, bottom - height
    draw.rectangle([x0, y0, right, bottom], fill="white", outline=(204, 204, 204))
    for j, (label, color) in enumerate(entries):
        y = y0 + LEGEND_PAD + j * LEGEND_LINE
        draw.rectangle([x0 + LEGEND_PAD, y + 3, x0 + LEGEND_PAD + LEGEND_SWATCH,
                        y + 3 + LEGEND_SWATCH], fill=rgb8(color))
        draw.text((x0 + 2 * LEGEND_PAD + LEGEND_SWATCH, y + 2), label, fill="black", font=f)


def render_segmap(
    image: np.ndarray,
    segmap: np.ndarray,
    class_names: List[str],
    save_path: str,
    alpha: float = 0.45,
    cmap: str = "tab10",
) -> None:
    """Colored class overlay with a legend (visualize_segmap flow)."""
    overlay, colors = segmap_overlay(image, segmap, len(class_names), alpha, cmap)
    canvas = Image.new("RGB", (CANVAS, CANVAS), "white")
    pane = fit(overlay, CANVAS - 20, CANVAS - 20)
    left, top = (CANVAS - pane.width) // 2, (CANVAS - pane.height) // 2
    canvas.paste(pane, (left, top))
    present = sorted(set(segmap[segmap >= 0].ravel().tolist()))
    draw_legend(canvas, [(class_names[i], colors[i]) for i in present],
                left + pane.width - LEGEND_PAD, top + pane.height - LEGEND_PAD)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    canvas.save(save_path)


def anatomy_segmentation(
    scorer: ZeroShotScorer, image_path: str, save_dir: str
) -> str:
    seg, _, image = compute_segmap(scorer, image_path, ANATOMY_CLASSES, threshold=None)
    out = os.path.join(save_dir, "anatomy_segmap.png")
    render_segmap(image, seg, ANATOMY_CLASSES, out)
    return out


def disease_segmentation(
    scorer: ZeroShotScorer, image_path: str, save_dir: str, threshold: float = 0.5
) -> str:
    seg, _, image = compute_segmap(
        scorer, image_path, DISEASE_CLASSES, threshold=threshold
    )
    out = os.path.join(save_dir, "disease_segmap.png")
    render_segmap(image, seg, DISEASE_CLASSES, out)
    return out

