"""Qualitative-assessment renderers and per-disease attention-map flows
(port of radzero_tpu/viz/qualitative.py).

Completes the visualization suite with the reference's dataset-study
flows (exp/cxr_pt/inference/visualization/):

- :func:`visualize_segmap` — argmax multi-class segmentation overlay
  with an explicit "background" class, two saved artifacts per image
  (side-by-side panel + overlay-only), per-class bbox drawing
  (qualitative_assessment_utils.py:11-155).
- :func:`visualize_disease_segmap` — same flow with a fixed
  class-name -> color dict and class-colored boxes
  (disease_qualitative_assessment_utils.py:11-214).
- :func:`filter_top_k_percent` — quantile filter keeping the top-k%
  of a similarity map (qualitative_assessment_utils.py:158-188).
- :func:`process_and_visualize_map` — the per-disease attention-map
  flow: blurred inferno blend saved as nobox_/orig_/labeled artifacts
  with ground-truth boxes (disease_attention_map.py:93-181).
- :func:`process_and_visualize_segmentation` — per-text maps + zero
  background map -> visualize_segmap (disease_attention_map.py:53-90).

Unlike the reference (one compute_logits call per text,
disease_attention_map.py:66-74), all prompts of a study run in ONE
batched scorer call.

The arrays are the JAX package's: ``visualize_segmap``'s composite and
``process_and_visualize_map``'s three PIL files are the same bytes given
the same maps. ``visualize_segmap`` lays its two files out with PIL at the
JAX figures' pixel sizes: ``only_segmap_<name>.png`` is the composite
scaled 2x by nearest neighbour (the figure is 2w x 2h pixels), and
``seg_map_<name>.png`` is original | overlay, each 2x, titled, with the
legend at the right.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
from PIL import Image, ImageDraw

from radzero_torch.eval.scorer import ZeroShotScorer
from radzero_torch.viz.colormaps import get_cmap, to_rgb
from radzero_torch.viz.overlays import _gaussian_blur, extract_similarity_map, font
from radzero_torch.viz.segmap import LEGEND_PAD, draw_legend, legend_size, rgb8

SCALE = 2  # the JAX figures' pixels a pixel of the image


def filter_top_k_percent(similarity_map: np.ndarray, k: float) -> np.ndarray:
    """Keep the top k% of values, set the rest to -1
    (qualitative_assessment_utils.py:158-188)."""
    if not (0 < k <= 100):
        raise ValueError("k must be between 0 and 100")
    thr = np.quantile(similarity_map.ravel(), 1 - k / 100.0)
    return np.where(similarity_map >= thr, similarity_map, -1.0)


def _stem(image_path: str) -> str:
    return os.path.splitext(os.path.basename(image_path))[0]


def _resolve_colors(colors, class_names: List[str]) -> np.ndarray:
    """-> (num_classes, 3) float RGB in [0,1]."""
    if isinstance(colors, dict):
        missing = [c for c in class_names if c not in colors]
        if missing:
            raise NotImplementedError(f"{missing[0]} is not in colors")
        return np.array([to_rgb(colors[c]) for c in class_names])
    if isinstance(colors, list):
        return np.array([to_rgb(c) for c in colors])[: len(class_names)]
    if isinstance(colors, str):
        cmap = get_cmap(colors)
        return cmap(np.linspace(0, 1, max(len(class_names), 2)))[: len(class_names), :3]
    raise ValueError("colors must be a dict, list, or colormap name")


def segmap_composite(
    image: np.ndarray,
    probability_map: np.ndarray,
    class_names: List[str],
    overlay_alpha: float = 0.5,
    colors: Union[str, List[str], Dict[str, str]] = "tab10",
):
    """-> (composite uint8 (H, W, 3), class colours (C, 3), background index
    or None): the argmax overlay of :func:`visualize_segmap`."""
    h, w = image.shape[:2]
    segmap = np.argmax(probability_map, axis=0)
    bg_index = class_names.index("background") if "background" in class_names else None
    rgb = _resolve_colors(colors, class_names)

    alpha_mask = np.full((h, w), overlay_alpha, np.float32)
    if bg_index is not None:
        alpha_mask = np.where(segmap == bg_index, 0.0, overlay_alpha)
    colored = rgb[segmap]                                  # (H, W, 3)
    base = image.astype(np.float32) / 255.0
    composite = alpha_mask[..., None] * colored + (1 - alpha_mask[..., None]) * base
    composite = (composite * 255).astype(np.uint8)
    return composite, rgb, bg_index


def _scaled(image: np.ndarray) -> Image.Image:
    h, w = image.shape[:2]
    return Image.fromarray(image).resize((SCALE * w, SCALE * h), Image.Resampling.NEAREST)


def _draw_bboxes(img: Image.Image, bbox, rgb: np.ndarray, bg_index, offset=(0, 0)) -> None:
    """Boxes colored by class order, skipping the background color
    (qualitative_assessment_utils.py draw_bboxes), on a SCALE x canvas."""
    fg = [rgb[i] for i in range(len(rgb)) if i != bg_index]
    draw = ImageDraw.Draw(img)
    for j, (x0, y0, x1, y1) in enumerate(bbox):
        color = fg[j % len(fg)] if fg else (1, 0, 0)
        draw.rectangle([offset[0] + SCALE * x0, offset[1] + SCALE * y0,
                        offset[0] + SCALE * x1, offset[1] + SCALE * y1],
                       outline=rgb8(color), width=2 * SCALE)


def visualize_segmap(
    image: Union[str, np.ndarray],
    probability_map: np.ndarray,        # (num_classes, H, W)
    class_names: List[str],
    save_dir: str,
    *,
    overlay_alpha: float = 0.5,
    colors: Union[str, List[str], Dict[str, str]] = "tab10",
    bbox: Optional[Sequence[Sequence[float]]] = None,
    dpi: int = 200,
    name: Optional[str] = None,
) -> List[str]:
    """argmax segmentation overlay. Saves ``seg_map_<name>.png``
    (original | overlay panel with legend) and ``only_segmap_<name>.png``
    (overlay only). A class literally named "background" renders fully
    transparent and is dropped from the legend. Returns the saved paths.
    ``dpi`` is kept for the JAX signature: the JAX figures' pixel sizes do
    not depend on it.
    """
    if isinstance(image, str):
        name = name or _stem(image)
        with Image.open(image) as im:
            image = np.asarray(im.convert("RGB"))
    elif name is None:
        name = "image"
    h, w = image.shape[:2]
    composite, rgb, bg_index = segmap_composite(image, probability_map, class_names,
                                                overlay_alpha, colors)
    os.makedirs(save_dir, exist_ok=True)
    legend = [(class_names[i], rgb[i]) for i in range(len(class_names)) if i != bg_index]

    # panel artifact: original | overlay + legend
    f = font(max(14, SCALE * h // 40))
    draw = ImageDraw.Draw(Image.new("RGB", (1, 1)))
    title_h = draw.textbbox((0, 0), "Ag", font=f)[3] + 2 * LEGEND_PAD
    legend_w, legend_h = legend_size(legend)
    panel = Image.new("RGB", (2 * SCALE * w + legend_w + 2 * LEGEND_PAD, SCALE * h + title_h),
                      "white")
    draw = ImageDraw.Draw(panel)
    for k, (title, img) in enumerate((("Original Image", image),
                                      ("Segmentation Map Overlay", composite))):
        x0 = k * SCALE * w
        tw = draw.textbbox((0, 0), title, font=f)[2]
        draw.text((x0 + (SCALE * w - tw) // 2, LEGEND_PAD), title, fill="black", font=f)
        panel.paste(_scaled(img), (x0, title_h))
    if bbox is not None:
        _draw_bboxes(panel, bbox, rgb, bg_index, offset=(SCALE * w, title_h))
    draw_legend(panel, legend, panel.width - LEGEND_PAD, title_h + (SCALE * h + legend_h) // 2)
    panel_path = os.path.join(save_dir, f"seg_map_{name}.png")
    panel.save(panel_path)

    # overlay-only artifact
    only = _scaled(composite)
    if bbox is not None:
        _draw_bboxes(only, bbox, rgb, bg_index)
    only_path = os.path.join(save_dir, f"only_segmap_{name}.png")
    only.save(only_path)
    return [panel_path, only_path]


def visualize_disease_segmap(
    image: Union[str, np.ndarray],
    probability_map: np.ndarray,
    class_names: List[str],
    save_dir: str,
    colors: Dict[str, str],
    *,
    overlay_alpha: float = 0.5,
    bbox: Optional[Sequence[Sequence[float]]] = None,
    dpi: int = 200,
    name: Optional[str] = None,
) -> List[str]:
    """Disease variant: colors MUST be a class-name -> color dict (a
    missing class raises, matching
    disease_qualitative_assessment_utils.py:34-39)."""
    if not isinstance(colors, dict):
        raise ValueError("visualize_disease_segmap requires a class->color dict")
    return visualize_segmap(
        image, probability_map, class_names, save_dir,
        overlay_alpha=overlay_alpha, colors=colors, bbox=bbox, dpi=dpi, name=name,
    )


def process_and_visualize_map(
    scorer: ZeroShotScorer,
    image_path: str,
    text_list: List[str],
    save_dir: str,
    *,
    bbox: Optional[Sequence] = None,
    bbox_color: str = "red",
    alpha: float = 0.2,
    width: int = 3,
    image_key: Optional[str] = None,
) -> List[str]:
    """Per-disease attention-map flow (disease_attention_map.py:93-181):
    sigmoid full-res map of text_list[0] -> Gaussian blur -> inferno ->
    PIL blend; saves ``nobox_<texts>_<key>``, ``orig_<key>`` (original +
    boxes), and ``<texts>_<key>`` (blend + boxes). Returns saved paths.
    """
    _, maps, image = extract_similarity_map(scorer, image_path, [text_list[0]])
    sim = _gaussian_blur(maps[0].astype(np.float32), 1.0)

    cmap = get_cmap("inferno")
    colored = (cmap(np.clip(sim, 0, 1))[..., :3] * 255).astype(np.uint8)
    pil_image = Image.fromarray(image)
    blended = Image.blend(pil_image, Image.fromarray(colored), alpha=alpha)

    key = image_key or os.path.basename(image_path)
    tag = "_".join(text_list)
    os.makedirs(save_dir, exist_ok=True)
    paths = []

    nobox = os.path.join(save_dir, f"nobox_{tag}_{key}")
    blended.save(nobox)
    paths.append(nobox)

    def draw_on(img: Image.Image) -> Image.Image:
        if bbox is None:
            return img
        d = ImageDraw.Draw(img)
        boxes = bbox if isinstance(bbox[0], (list, tuple)) else [bbox]
        for box in boxes:
            d.rectangle(list(box), outline=bbox_color, width=width)
        return img

    orig = os.path.join(save_dir, f"orig_{key}")
    draw_on(pil_image).save(orig)
    paths.append(orig)

    labeled = os.path.join(save_dir, f"{tag}_{key}")
    draw_on(blended).save(labeled)
    paths.append(labeled)
    return paths


def process_and_visualize_segmentation(
    scorer: ZeroShotScorer,
    image_path: str,
    text_list: List[str],
    save_dir: str,
    *,
    k: Optional[float] = None,
    dpi: int = 200,
    overlay_alpha: float = 0.5,
    bbox: Optional[Sequence[Sequence[float]]] = None,
    colors: Union[str, List[str], Dict[str, str]] = "tab10",
) -> List[str]:
    """Open-vocabulary segmentation study (disease_attention_map.py:53-90):
    per-text sigmoid maps (optionally top-k filtered) + an explicit zero
    "background" map -> argmax visualize_segmap. One batched scorer call
    replaces the reference's per-text loop."""
    _, maps, image = extract_similarity_map(scorer, image_path, list(text_list))
    if k is not None:
        maps = np.stack([filter_top_k_percent(m, k) for m in maps])
    class_names = list(text_list) + ["background"]
    prob = np.concatenate([maps, np.zeros_like(maps[:1])], axis=0)
    if isinstance(colors, dict) and "background" not in colors:
        colors = {**colors, "background": "#000000"}
    return visualize_segmap(
        image, prob, class_names, save_dir,
        overlay_alpha=overlay_alpha, colors=colors, bbox=bbox, dpi=dpi,
        name=_stem(image_path),
    )
