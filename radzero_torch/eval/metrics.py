"""Metric primitives for zero-shot evaluation: the port's copy of
radzero_tpu/eval/metrics.py, in numpy and scipy only.

The JAX package takes AUROC, the precision-recall curve, the trapezoid
area and F1 from scikit-learn. The port carries its own versions, which
give scikit-learn's values bit for bit: the same curve points from the
same sorted scores, the same trapezoid (``np.trapezoid``), the same
averages (``np.average`` / ``np.nanmean``) in the same order. So a
``result.json`` written here is byte-identical to the JAX harness's for
the same similarities. The ROC area equals the tie-averaged rank
(Mann-Whitney) statistic U / (n_pos n_neg); it is computed as the
trapezoid over the ROC curve so that it also agrees in the last bit.

Where scikit-learn returns NaN with a warning (a label column with a single
class) this module does too; where scikit-learn raises (an empty array,
non-finite scores, labels that are not binary) this module raises
``ValueError``.

Also: micro-average Dice (torchmetrics ``DiceScore(num_classes=1)``, the
reference's segmentation_utils.py:254-268), image-level specificity
(segmentation_utils.py:136-158) and the SIIM RLE decoder.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np


class UndefinedMetricWarning(UserWarning):
    """A metric is undefined for these labels and was set to NaN or 0."""


# ---------------------------------------------------------------------------
# input checks (the subset of scikit-learn's type_of_target / check_array the
# harness's label arrays reach)
# ---------------------------------------------------------------------------

_AVERAGES = (None, "micro", "macro", "weighted")


def _is_integral(values: np.ndarray) -> bool:
    return values.dtype.kind in "biu" or bool(np.all(values == values.astype(np.int64)))


def _target_type(y: np.ndarray) -> str:
    """scikit-learn's ``type_of_target`` for dense numeric arrays."""
    if y.ndim > 2 or (y.ndim == 2 and y.shape[1] == 0) or y.size == 0:
        return "unknown"
    if y.dtype.kind not in "biuf":
        raise ValueError(f"labels of dtype {y.dtype} are not supported")
    if not np.isfinite(y).all():
        raise ValueError("Input y_true contains NaN or infinity.")
    labels = np.unique(y)
    if y.ndim == 2 and y.shape[1] > 1:
        if len(labels) < 3 and _is_integral(labels):
            return "multilabel-indicator"
        suffix = "-multioutput"
    else:
        suffix = ""
    if not _is_integral(labels):
        return "continuous" + suffix
    if len(labels) > 2 or (y.ndim == 2 and y.shape[1] > 1):
        return "multiclass" + suffix
    return "binary"


def _check_nonempty_finite(a: np.ndarray, name: str) -> None:
    if a.shape[0] == 0:
        raise ValueError(f"Found array with 0 sample(s) (shape={a.shape}) for {name}.")
    if a.ndim == 2 and a.shape[1] == 0:
        raise ValueError(f"Found array with 0 feature(s) (shape={a.shape}) for {name}.")
    if a.dtype.kind == "f" and not np.isfinite(a).all():
        raise ValueError(f"Input {name} contains NaN or infinity.")


def _column(a: np.ndarray, name: str) -> np.ndarray:
    if a.ndim == 1:
        return a
    if a.ndim == 2 and a.shape[1] == 1:
        return a.ravel()
    raise ValueError(f"{name} should be a 1d array, got an array of shape {a.shape} instead.")


def _positive(y_true: np.ndarray) -> np.ndarray:
    """y_true == 1 as float64, where its classes are one of {0, 1}, {-1, 1}
    or a subset (scikit-learn's pos_label=None rule)."""
    classes = np.unique(y_true)
    if classes.shape[0] > 2 or not any(
        classes.shape == np.shape(c) and np.all(classes == np.asarray(c))
        for c in ([0, 1], [-1, 1], [0], [-1], [1])
    ):
        raise ValueError(f"y_true takes value in {set(classes.tolist())} and pos_label is "
                         "not specified: either make y_true take value in {0, 1} or "
                         "{-1, 1} or pass pos_label explicitly.")
    return (y_true == 1).astype(np.float64)


def _clf_curve(y_true, y_score):
    """(fps, tps, thresholds) at each distinct score, scores descending."""
    y_true, y_score = np.asarray(y_true), np.asarray(y_score)
    if y_true.shape[0] != y_score.shape[0]:
        raise ValueError("Found input variables with inconsistent numbers of samples: "
                         f"[{y_true.shape[0]}, {y_score.shape[0]}]")
    y_true, y_score = _column(y_true, "y_true"), _column(y_score, "y_score")
    _check_nonempty_finite(y_score, "y_score")
    kind = _target_type(y_true)
    if kind != "binary":
        raise ValueError(f"{kind} format is not supported")
    pos = _positive(y_true)
    order = np.argsort(y_score, kind="stable")[::-1]
    y_score, pos = y_score[order], pos[order]
    threshold_idxs = np.r_[np.nonzero(np.diff(y_score))[0], y_score.size - 1]
    tps = np.cumsum(pos, dtype=np.float64)[threshold_idxs]
    fps = 1 + threshold_idxs.astype(np.float64) - tps
    return fps, tps, y_score[threshold_idxs]


# ---------------------------------------------------------------------------
# curves and areas
# ---------------------------------------------------------------------------

def auc(x, y) -> float:
    """Trapezoid area under (x, y); x monotonic (scikit-learn's ``auc``)."""
    x, y = np.asarray(x), np.asarray(y)
    if x.shape[0] != y.shape[0]:
        raise ValueError("x and y have inconsistent numbers of samples")
    x, y = _column(x, "x"), _column(y, "y")
    if x.shape[0] < 2:
        raise ValueError("At least 2 points are needed to compute area under curve, "
                         f"but x.shape = {x.shape}")
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1
        else:
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
    return float(direction * np.trapezoid(y, x))


def precision_recall_curve(y_true, y_score):
    """(precision, recall, thresholds), recall decreasing, with the end
    point (precision 1, recall 0) appended (scikit-learn's order)."""
    fps, tps, thresholds = _clf_curve(y_true, y_score)
    ps = tps + fps
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(ps != 0, np.divide(tps, ps), 0.0)
    if tps[-1] == 0:
        warnings.warn("No positive class found in y_true, recall is set to one for all "
                      "thresholds.", UserWarning)
        recall = np.full(tps.shape, 1.0)
    else:
        recall = tps / tps[-1]
    return (np.concatenate((precision[::-1], [1.0])), np.concatenate((recall[::-1], [0.0])),
            thresholds[::-1])


def _binary_roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Area under the ROC curve (= the tie-averaged Mann-Whitney U over
    n_pos n_neg), as the trapezoid over the curve's corners."""
    if len(np.unique(y_true)) != 2:
        warnings.warn("Only one class is present in y_true. ROC AUC score is not defined "
                      "in that case.", UndefinedMetricWarning)
        return np.nan
    fps, tps, _ = _clf_curve(y_true, y_score)
    if fps.shape[0] > 2:  # drop collinear corners, as roc_curve(drop_intermediate=True)
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps = fps[keep], tps[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    return auc(fps / fps[-1], tps / tps[-1])


def roc_auc_score(y_true, y_score, average: str | None = "macro"):
    """AUROC of binary labels, or of multilabel indicator columns averaged
    by ``average`` (None: per column)."""
    y_true, y_score = np.asarray(y_true), np.asarray(y_score)
    if average not in _AVERAGES:
        raise ValueError(f"average has to be one of {_AVERAGES}")
    kind = _target_type(y_true)
    _check_nonempty_finite(y_true, "y_true")
    _check_nonempty_finite(y_score, "y_score")
    if kind == "multiclass" or (kind == "binary" and y_score.ndim == 2 and y_score.shape[1] > 2):
        raise ValueError("multi_class must be in ('ovo', 'ovr')")
    if kind == "binary":
        labels = np.unique(y_true)
        col = _column(y_true, "y_true")
        y_bin = (col == labels[-1]).astype(np.int64) if len(labels) == 2 else np.zeros_like(
            col, np.int64)
        return _binary_roc_auc(y_bin, y_score)
    if kind != "multilabel-indicator":
        raise ValueError(f"{kind} format is not supported")
    if y_true.shape[0] != y_score.shape[0]:
        raise ValueError("Found input variables with inconsistent numbers of samples: "
                         f"[{y_true.shape[0]}, {y_score.shape[0]}]")
    weight = None
    if average == "micro":
        y_true, y_score = y_true.ravel(), y_score.ravel()
    elif average == "weighted":
        weight = np.sum(y_true, axis=0)
        if np.isclose(np.sum(weight), 0):
            return 0
    y_true = y_true.reshape(y_true.shape[0], -1)
    y_score = y_score.reshape(y_score.shape[0], -1)
    score = np.zeros(y_score.shape[1])
    for c in range(y_score.shape[1]):
        score[c] = _binary_roc_auc(np.ascontiguousarray(y_true[:, c]),
                                   np.ascontiguousarray(y_score[:, c]))
    if average is None:
        return score
    if weight is not None:
        score[weight == 0] = 0
    return float(np.average(score, weights=weight))


def eval_auc(results: np.ndarray, gt_labels: np.ndarray):
    """(macro, micro, weighted, per-class) AUROC (ref utils.py:151-156)."""
    macro = roc_auc_score(gt_labels, results, average="macro")
    micro = roc_auc_score(gt_labels, results, average="micro")
    weighted = roc_auc_score(gt_labels, results, average="weighted")
    per = roc_auc_score(gt_labels, results, average=None)
    return macro, micro, weighted, per


def _nanaverage(a: np.ndarray, weights=None) -> float:
    if a.shape[0] == 0:
        return np.nan
    mask = np.isnan(a)
    if np.all(mask):
        return np.nan
    if weights is None:
        return np.nanmean(a)
    a, weights = a[~mask], np.asarray(weights)[~mask]
    try:
        return np.average(a, weights=weights)
    except ZeroDivisionError:  # every weight 0: unweighted
        return np.average(a)


def f1_score(y_true, y_pred, average: str = "macro") -> float:
    """F1 of multilabel indicator arrays; 0 where a class is neither true
    nor predicted (scikit-learn's zero_division="warn")."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if average not in ("micro", "macro", "weighted"):
        raise ValueError(f"average has to be one of {('micro', 'macro', 'weighted')}")
    kinds = {_target_type(y_true), _target_type(y_pred)}
    if kinds != {"multilabel-indicator"}:
        raise ValueError(f"targets of types {sorted(kinds)}: only multilabel indicator "
                         "arrays are supported")
    if y_true.shape != y_pred.shape:
        raise ValueError(f"y_true and y_pred have shapes {y_true.shape} and {y_pred.shape}")
    tp_sum = np.count_nonzero(y_true * y_pred, axis=0)
    pred_sum = np.count_nonzero(y_pred, axis=0)
    true_sum = np.count_nonzero(y_true, axis=0)
    if average == "micro":
        tp_sum, pred_sum, true_sum = (np.reshape(np.sum(s), (1,))
                                      for s in (tp_sum, pred_sum, true_sum))
    denom = 1.0 * true_sum.astype(np.float64) + pred_sum.astype(np.float64)
    mask = denom == 0
    if mask.any():
        warnings.warn("F-score is ill-defined and being set to 0.0 where a label has no "
                      "true nor predicted samples.", UndefinedMetricWarning)
    denom[mask] = 1
    f = (1 + 1.0) * tp_sum.astype(np.float64) / denom
    f[mask] = 0.0
    return float(_nanaverage(f, weights=true_sum if average == "weighted" else None))


def eval_f1(y_pred: np.ndarray, gt_labels: np.ndarray):
    micro = f1_score(gt_labels, y_pred, average="micro")
    macro = f1_score(gt_labels, y_pred, average="macro")
    weighted = f1_score(gt_labels, y_pred, average="weighted")
    return micro, macro, weighted


def accuracy_score(y_true, y_pred) -> float:
    """Share of equal entries of two label vectors."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if y_true.shape != y_pred.shape or y_true.ndim != 1:
        raise ValueError(f"y_true and y_pred have shapes {y_true.shape} and {y_pred.shape}")
    for a, name in ((y_true, "y_true"), (y_pred, "y_pred")):
        if _target_type(a).startswith("continuous"):
            raise ValueError(f"Classification metrics can't handle continuous {name}")
    return float(np.average(y_true == y_pred))


def calculate_micro_macro_auprc(y_true: np.ndarray, y_scores: np.ndarray) -> Tuple[float, float]:
    """Micro + macro AUPRC over multi-label arrays (ref utils.py:19-47)."""
    n_labels = y_true.shape[1]
    per = []
    for i in range(n_labels):
        precision, recall, _ = precision_recall_curve(y_true[:, i], y_scores[:, i])
        per.append(auc(recall, precision))
    macro_auprc = float(np.mean(per))

    precision, recall, _ = precision_recall_curve(y_true.ravel(), y_scores.ravel())
    micro_auprc = float(auc(recall, precision))
    return micro_auprc, macro_auprc


def long_tail_multi_label_split(y_true: np.ndarray):
    """head/medium/tail class indices: head > 65th-percentile frequency,
    tail <= 10 positives (ref utils.py:184-199)."""
    class_freq = np.sum(y_true, axis=0)
    head_thr = np.percentile(class_freq, 65)
    medium_thr = 10
    head = np.where(class_freq > head_thr)[0]
    medium = np.where((class_freq <= head_thr) & (class_freq > medium_thr))[0]
    tail = np.where(class_freq <= medium_thr)[0]
    return head, medium, tail


# ---------------------------------------------------------------------------
# segmentation
# ---------------------------------------------------------------------------

def micro_dice(pred: np.ndarray, target: np.ndarray, eps: float = 1e-12) -> float:
    """Micro-average Dice over the pooled batch: 2|P∩T| / (|P|+|T|)
    (torchmetrics segmentation.DiceScore(num_classes=1) default,
    the reference's dice primitive: segmentation_utils.py:256-258)."""
    pred = pred.astype(np.float64)
    target = target.astype(np.float64)
    inter = float((pred * target).sum())
    denom = float(pred.sum() + target.sum())
    if denom == 0:
        return 0.0
    return 2.0 * inter / denom


_CHUNK = 1 << 24  # pixels a pass of the threshold counts


def _counts_above(probs: np.ndarray, target: np.ndarray, thresholds: np.ndarray):
    """For each threshold t (sorted ascending): the pixels with p > t and
    the sum of ``target`` over them. A pixel with p lies above every
    threshold before ``searchsorted(thresholds, p, side='left')``, so one
    bincount per chunk and a suffix sum give every count: the counts of
    the comparison ``p > t`` in float64, without a pass per threshold."""
    n_t = thresholds.shape[0]
    pred = np.zeros(n_t + 1, np.int64)
    inter = np.zeros(n_t + 1, np.float64)
    for start in range(0, probs.size, _CHUNK):
        p = probs[start : start + _CHUNK]
        w = target[start : start + _CHUNK]
        valid = ~np.isnan(p)  # NaN exceeds no threshold
        if not valid.all():
            p, w = p[valid], w[valid]
        idx = np.searchsorted(thresholds, p.astype(np.float64), side="left")
        pred += np.bincount(idx, minlength=n_t + 1)
        inter += np.bincount(idx, weights=w.astype(np.float64), minlength=n_t + 1)
    # pixels above threshold k: those whose index is > k
    above = lambda c: (c.sum() - np.cumsum(c))[:n_t]  # noqa: E731
    return above(pred), above(inter)


def best_threshold_dice(
    positive_probs: np.ndarray, positive_masks: np.ndarray, thresholds=None
) -> Tuple[float, float]:
    """Threshold sweep 0..1 step .01 maximising Dice over positives
    (ref segmentation_utils.py:254-268): the first threshold of the
    largest ``micro_dice((p > t), masks)``.

    The counts of every threshold come from one pass over the pixels
    (``_counts_above``) in place of a pass per threshold; for integer masks
    each Dice is the same quotient of the same exact counts as
    ``micro_dice``'s, so the result is bit-equal."""
    thresholds = thresholds if thresholds is not None else np.arange(0, 1.01, 0.01)
    t = np.asarray(thresholds, np.float64)
    order = np.argsort(t, kind="stable")
    probs = np.ascontiguousarray(positive_probs).ravel()
    target = np.ascontiguousarray(positive_masks).ravel()
    pred_sorted, inter_sorted = _counts_above(probs, target, t[order])
    pred, inter = np.empty_like(pred_sorted), np.empty_like(inter_sorted)
    pred[order], inter[order] = pred_sorted, inter_sorted
    target_sum = float(target.astype(np.float64).sum())
    best_dice, best_t = 0.0, 0.0
    for k, tk in enumerate(thresholds):
        denom = float(pred[k] + target_sum)
        d = 0.0 if denom == 0 else 2.0 * float(inter[k]) / denom
        if d > best_dice:
            best_dice, best_t = d, float(tk)
    return best_dice, best_t


def compute_specificity(negative_probs: np.ndarray, threshold: float) -> float:
    """Fraction of negative images with NO pixel above threshold
    (ref segmentation_utils.py:136-158)."""
    flat = negative_probs.reshape(len(negative_probs), -1)
    true_neg = ((flat > threshold).sum(axis=1) == 0).sum()
    return float(true_neg / len(negative_probs))


def pixel_auroc(all_probs: np.ndarray, all_masks: np.ndarray) -> float:
    return float(roc_auc_score(all_masks.ravel().astype(np.int64), all_probs.ravel()))


def eval_precision(results: np.ndarray, gt_labels: np.ndarray):
    """Per-class precision of sign predictions + mAP (ref utils.py:103-111)."""
    y_pred = np.asarray(results) > 0
    tp = gt_labels * y_pred
    fp = (1 - gt_labels) * y_pred
    under = np.sum(tp + fp, axis=0)
    under = np.where(under == 0, 1, under)
    precision = np.sum(tp, axis=0) / under
    return float(np.mean(precision)), precision


def eval_recall(results: np.ndarray, gt_labels: np.ndarray):
    """Per-class recall + mAR (ref utils.py:114-120)."""
    y_pred = np.asarray(results) > 0
    tp = gt_labels * y_pred
    fn = gt_labels * (1 - y_pred)
    recall = np.sum(tp, axis=0) / np.sum(tp + fn, axis=0)
    return float(np.mean(recall)), recall


def eval_bacc(y_pred: np.ndarray, gt_labels: np.ndarray):
    """Balanced accuracy (tpr+tnr)/2 per class + mean (ref utils.py:125-135)."""
    tp = gt_labels * y_pred
    tn = (1 - gt_labels) * (1 - y_pred)
    fp = (1 - gt_labels) * y_pred
    fn = gt_labels * (1 - y_pred)
    tpr = np.sum(tp, axis=0) / np.sum(tp + fn, axis=0)
    tnr = np.sum(tn, axis=0) / np.sum(fp + tn, axis=0)
    per_class = (tpr + tnr) / 2
    return float(np.mean(per_class)), per_class


def eval_sensitivity_specificity(y_pred: np.ndarray, gt_labels: np.ndarray):
    """Mean sensitivity and specificity over classes (ref utils.py:138-148)."""
    tp = gt_labels * y_pred
    tn = (1 - gt_labels) * (1 - y_pred)
    fp = (1 - gt_labels) * y_pred
    fn = gt_labels * (1 - y_pred)
    sen = float(np.mean(np.sum(tp, axis=0) / np.sum(tp + fn, axis=0)))
    spe = float(np.mean(np.sum(tn, axis=0) / np.sum(fp + tn, axis=0)))
    return sen, spe


def rle2mask(rle: str, height: int, width: int) -> np.ndarray:
    """SIIM relative-start RLE -> (height, width) binary mask.

    Column-major decode then transpose (ref segmentation_utils.py:21-33;
    the reference's swapped-argument call at :200 is only consistent for
    the square 1024x1024 SIIM DICOMs — this signature is unambiguous and
    identical to the reference on that data)."""
    mask = np.zeros(width * height)
    array = np.asarray([int(x) for x in rle.split()])
    starts, lengths = array[0::2], array[1::2]
    pos = 0
    for start, length in zip(starts, lengths):
        pos += start
        mask[pos : pos + length] = 1
        pos += length
    return mask.reshape(width, height).T


class StreamingSegmentationMetrics:
    """Single-pass segmentation metrics: maps are consumed one image at a
    time and discarded (the materialising path holds EVERY full-res
    probability map — gigabytes for SIIM/RSNA-sized sets).

    Exactly reproduces the sweep semantics of segmentation_utils.py:
    - best-Dice threshold sweep (0..1 step .01, positives only, first
      max) via per-threshold (TP, pred) count accumulation: a pixel with
      prob p contributes to every threshold t < p, so per-image
      ``searchsorted(grid, p, side='left')`` bincounts + a suffix sum
      yield all 101 counts at once — bit-identical to the naive
      ``(p > t)`` comparisons;
    - specificity from per-negative-image max prob (``(p > t).sum()==0``
      iff ``max(p) <= t``);
    - image-level AUC from the (small) logit/label lists;
    - pixel-level AUROC from fixed-bin histograms (``auroc_bins``,
      default 4096) — a streaming approximation with error O(1/bins),
      flagged in the result as ``pixel_level_auroc_streaming``.
    """

    def __init__(self, auroc_bins: int = 4096):
        self.thresholds = np.arange(0, 1.01, 0.01)
        n = len(self.thresholds)
        self._pos_tp = np.zeros(n, np.int64)
        self._pos_pred = np.zeros(n, np.int64)
        self._pos_target = 0
        self._neg_max: list = []
        self._logits: list = []
        self._labels: list = []
        self._bins = auroc_bins
        edges = np.linspace(0.0, 1.0, auroc_bins + 1)
        self._edges = edges
        self._hist_pos = np.zeros(auroc_bins, np.int64)
        self._hist_neg = np.zeros(auroc_bins, np.int64)

    def _counts_above_thresholds(self, p: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(self.thresholds, p.ravel(), side="left")
        c = np.bincount(idx, minlength=len(self.thresholds) + 1)
        total = c.sum()
        return (total - np.cumsum(c))[: len(self.thresholds)]

    def update(self, logit: float, prob_map: np.ndarray, mask: np.ndarray) -> None:
        mask = mask.astype(bool)
        positive = bool(mask.sum() > 0)
        self._logits.append(float(logit))
        self._labels.append(int(positive))
        if positive:
            self._pos_pred += self._counts_above_thresholds(prob_map)
            self._pos_tp += self._counts_above_thresholds(prob_map[mask])
            self._pos_target += int(mask.sum())
        else:
            self._neg_max.append(float(prob_map.max()))
        flat = np.clip(prob_map.ravel(), 0.0, 1.0)
        self._hist_pos += np.histogram(flat[mask.ravel()], bins=self._edges)[0]
        self._hist_neg += np.histogram(flat[~mask.ravel()], bins=self._edges)[0]

    def finalize(self, compute_pixel_level_auroc: bool = False) -> dict:
        result: dict = {}
        result["auc"] = float(
            roc_auc_score(np.asarray(self._labels), np.asarray(self._logits))
        )
        dice = 2.0 * self._pos_tp / np.maximum(
            self._pos_pred + self._pos_target, 1e-12
        )
        best_dice, best_t = 0.0, 0.0
        for t, d in zip(self.thresholds, dice):  # strict >: first max wins
            if d > best_dice:
                best_dice, best_t = float(d), float(t)
        result["dice"] = best_dice
        result["best_threshold"] = best_t
        if self._neg_max:
            result["specificity"] = float(
                np.mean(np.asarray(self._neg_max) <= best_t)
            )
        else:
            result["specificity"] = float("nan")
        if compute_pixel_level_auroc:
            result["pixel_level_auroc_streaming"] = self._hist_auc()
        return result

    def _hist_auc(self) -> float:
        """Mann-Whitney AUC from binned score histograms (ties within a
        bin handled as half-credit)."""
        pos, neg = self._hist_pos.astype(np.float64), self._hist_neg.astype(np.float64)
        n_pos, n_neg = pos.sum(), neg.sum()
        if n_pos == 0 or n_neg == 0:
            return float("nan")
        neg_below = np.concatenate([[0.0], np.cumsum(neg)[:-1]])
        u = np.sum(pos * (neg_below + 0.5 * neg))
        return float(u / (n_pos * n_neg))
