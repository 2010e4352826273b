"""Zero-shot open-vocabulary segmentation evaluation: the port's copy of
radzero_tpu/eval/segmentation.py (ref inference/segmentation_utils.py:161-425).

SIIM pneumothorax (RLE masks) and RSNA pneumonia (bbox masks), one
fixed prompt each: image-level AUC from logits, sigmoid(upsampled map)
probability masks, best-Dice threshold sweep over positives,
specificity on negatives, optional pixel AUROC.

As in the JAX package, all images run through the batched scorer and only
the variable-size upsampling happens per image, on the scorer's device;
the sigmoid runs in numpy float32 after the readback. ``data`` is the
table ``_table.read_csv`` gives for the dataset's test.csv.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from radzero_torch.data.dicom import load_eval_image
from radzero_torch.eval._table import Table, isna
from radzero_torch.eval.geometry import upsample_similarity_map
from radzero_torch.eval.metrics import (
    StreamingSegmentationMetrics,
    best_threshold_dice,
    pixel_auroc,
    rle2mask,
    roc_auc_score,
)
from radzero_torch.eval.scorer import ZeroShotScorer
from radzero_torch.utils.logging import logger


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _finish_metrics(
    logits: List[np.ndarray],
    labels: List[int],
    probs: List[np.ndarray],
    masks: List[np.ndarray],
    compute_pixel_level_auroc: bool,
    tag: str,
) -> Dict[str, float]:
    result: Dict[str, float] = {}
    result["auc"] = float(roc_auc_score(np.asarray(labels), np.asarray(logits)))

    pos_probs = [p for p, m in zip(probs, masks) if m.sum() > 0]
    pos_masks = [m for m in masks if m.sum() > 0]
    neg_probs = [p for p, m in zip(probs, masks) if m.sum() == 0]

    # per-sample maps have different shapes -> pooled micro dice via concat
    flat_pos_probs = np.concatenate([p.ravel() for p in pos_probs])
    flat_pos_masks = np.concatenate([m.ravel() for m in pos_masks])
    best_dice, best_t = best_threshold_dice(flat_pos_probs, flat_pos_masks)
    result["dice"] = best_dice
    result["best_threshold"] = best_t

    if neg_probs:
        true_neg = sum(1 for p in neg_probs if (p > best_t).sum() == 0)
        result["specificity"] = float(true_neg / len(neg_probs))
    else:
        result["specificity"] = float("nan")

    if compute_pixel_level_auroc:
        all_probs = np.concatenate([p.ravel() for p in probs])
        all_masks = np.concatenate([m.ravel() for m in masks])
        result["pixel_level_auroc"] = pixel_auroc(all_probs, all_masks)

    logger.info(f"{tag} Result: {result}")
    return result


def _stream_metrics(
    logits, scores, sizes, masks, geometry, device, compute_pixel_level_auroc, tag
) -> Dict[str, float]:
    """Single-pass variant: each map is upsampled, consumed, discarded —
    O(1) map memory instead of holding every full-res probability map.
    Dice/specificity/image-AUC are exact; pixel AUROC is the streaming
    histogram approximation (eval/metrics.py)."""
    acc = StreamingSegmentationMetrics()
    for logit, s, size, mask in zip(logits[:, 0], scores, sizes, masks):
        prob = _sigmoid(upsample_similarity_map(s[0], size, geometry, device=device))
        acc.update(float(logit), prob, mask)
    result = acc.finalize(compute_pixel_level_auroc)
    logger.info(f"{tag} Result: {result}")
    return result


def _score_and_finish(scorer, items, sizes, masks, text, compute_pixel_level_auroc,
                      streaming, tag):
    def load(path):
        return load_eval_image(path)

    logits, scores = scorer.score(items, load, [text], need_scores=True)
    geometry = scorer.image_processor.geometry
    if streaming:
        return _stream_metrics(logits, scores, sizes, masks, geometry, scorer.device,
                               compute_pixel_level_auroc, tag)
    probs = [
        _sigmoid(upsample_similarity_map(s[0], size, geometry, device=scorer.device))
        for s, size in zip(scores, sizes)
    ]
    labels = [int(m.sum() > 0) for m in masks]
    return _finish_metrics(
        list(logits[:, 0]), labels, probs, masks, compute_pixel_level_auroc, tag
    )


def eval_segmentation_siim(
    scorer: ZeroShotScorer,
    data: Table,
    text: str,
    data_root_dir: str,
    compute_pixel_level_auroc: bool = False,
    streaming: bool = False,
) -> Dict[str, float]:
    """SIIM: rows grouped by ImageId, ' EncodedPixels' RLE masks,
    prompt 'There is Pneumothorax' (ref segmentation_utils.py:161-287).
    ``streaming=True``: constant map memory (see _stream_metrics)."""
    image_ids = data["ImageId"].tolist()
    dicom_paths = data["dicom_path"].tolist()
    encoded_pixels = data[" EncodedPixels"].tolist()
    groups: Dict[object, List[int]] = {}  # first-seen order, rows in file order
    for row, imgid in enumerate(image_ids):
        groups.setdefault(imgid, []).append(row)

    sizes, masks, items = [], [], []
    for rows in groups.values():
        dicom_path = os.path.join(data_root_dir, dicom_paths[rows[0]])
        with load_eval_image(dicom_path) as img:
            w, h = img.size
        encoded = [encoded_pixels[r] for r in rows]
        mask = np.zeros([h, w])
        if encoded[0] != " -1":
            for e in encoded:
                mask += rle2mask(e, h, w)
        mask = (mask > 0).astype(np.int64)
        sizes.append((h, w))
        masks.append(mask)
        items.append(dicom_path)

    return _score_and_finish(scorer, items, sizes, masks, text, compute_pixel_level_auroc,
                             streaming, "SIIM")


def eval_segmentation_rsna_medklip(
    scorer: ZeroShotScorer,
    data: Table,
    text: str,
    data_root_dir: str,
    compute_pixel_level_auroc: bool = False,
    streaming: bool = False,
) -> Dict[str, float]:
    """RSNA (MedKLIP split): 'boxes' column 'x;y;w;h|...' masks,
    prompt 'There is Pneumonia' (ref segmentation_utils.py:290-425)."""
    image_paths = data["img_path"].tolist()
    bboxs = data["boxes"].tolist()

    sizes, masks, items = [], [], []
    for img_path, bbox in zip(image_paths, bboxs):
        full = os.path.join(data_root_dir, img_path)
        with load_eval_image(full) as img:
            w, h = img.size
        mask = np.zeros([h, w])
        if not isna(bbox) and bbox != "nan":
            for box in str(bbox).split("|"):
                cc = box.split(";")
                x0, y0, bw, bh = (int(float(c)) for c in cc[:4])
                mask[y0 : y0 + bh, x0 : x0 + bw] = 1
        sizes.append((h, w))
        masks.append(mask.astype(np.int64))
        items.append(full)

    return _score_and_finish(scorer, items, sizes, masks, text, compute_pixel_level_auroc,
                             streaming, "RSNA")
