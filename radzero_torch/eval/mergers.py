"""Per-dataset zero-shot classification metric mergers: the port's copy of
radzero_tpu/eval/mergers.py, on the port's numpy metrics and table reader.

Each takes the raw (n_images, n_prompts) similarity matrix plus the
dataset's label file and returns the headline metrics (macro AUROC incl.
head/medium/tail splits, micro/macro AUPRC, PadChest20 rare-class scores)
of the CARZero result mergers the reference imports
(external/CARZero/inference.py:55-418).
"""

from __future__ import annotations

import json
import re
from typing import Dict

import numpy as np
from scipy.special import softmax

from radzero_torch.eval._table import isna, read_csv
from radzero_torch.eval.metrics import (
    accuracy_score,
    auc,
    calculate_micro_macro_auprc,
    eval_auc,
    eval_f1,
    long_tail_multi_label_split,
    precision_recall_curve,
    roc_auc_score,
)

OPENI_PATHOLOGIES = [
    "Atelectasis", "Cardiomegaly", "Effusion", "Infiltration", "Mass",
    "Nodule", "Pneumonia", "Pneumothorax", "Edema", "Emphysema",
    "Fibrosis", "Pleural_Thickening", "Hernia", "Fracture", "Opacity",
    "Lesion", "Calcified Granuloma", "Granuloma", "No_Finding",
]
OPENI_SYNONYMS = {
    "Pleural_Thickening": ["pleural thickening"],
    "Infiltration": ["Infiltrate"],
    "Atelectasis": ["Atelectases"],
}

CHESTXRAY14_CLASSES = [
    "Atelectasis", "Cardiomegaly", "Effusion", "Infiltration", "Lung Mass",
    "Lung Nodule", "Pneumonia", "Pneumothorax", "Consolidation", "Edema",
    "Emphysema", "Fibrosis", "Pleural Thickening", "Hernia",
]
CHEXPERT5_CLASSES = [
    "Atelectasis", "Cardiomegaly", "Consolidation", "Edema", "Pleural Effusion",
]
CHESTXDET10_CLASSES = [
    "Atelectasis", "Calcification", "Consolidation", "Effusion", "Emphysema",
    "Fibrosis", "Fracture", "Mass", "Nodule", "Pneumothorax",
]


def _multilabel_binarize(label_lists, classes) -> np.ndarray:
    idx = {c: i for i, c in enumerate(classes)}
    out = np.zeros((len(label_lists), len(classes)), np.int64)
    for r, labels in enumerate(label_lists):
        for lab in labels:
            if lab in idx:
                out[r, idx[lab]] = 1
    return out


def _headline(predict: np.ndarray, label: np.ndarray) -> Dict[str, float]:
    head, medium, tail = long_tail_multi_label_split(label)
    result = {}
    result["Head AUC"] = eval_auc(predict[:, head], label[:, head])[0]
    result["Medium AUC"] = eval_auc(predict[:, medium], label[:, medium])[0]
    result["Tail AUC"] = eval_auc(predict[:, tail], label[:, tail])[0]
    result["Total AUC"] = eval_auc(predict, label)[0]
    micro_prc, macro_prc = calculate_micro_macro_auprc(label, predict)
    result["Micro AUPRC"] = micro_prc
    result["Macro AUPRC"] = macro_prc
    return result


def _contains(cells, pattern: str) -> np.ndarray:
    """``Series.str.contains(pattern)`` (a regex search) of string cells."""
    rx = re.compile(pattern)
    return np.asarray([rx.search(c) is not None for c in cells])


def merge_openi(similarities: np.ndarray, label_file_path: str) -> Dict[str, float]:
    """OpenI 18-pathology long-tail AUC (ref inference.py:55-149):
    substring match of pathology (+synonyms) in labels_automatic, rows
    with no finding get No_Finding, which is then dropped."""
    column = read_csv(label_file_path)["labels_automatic"]
    cells = ["-1" if isna(c) else c for c in column.tolist()]  # .replace(np.nan, "-1")
    if not all(isinstance(c, str) for c in cells):
        raise AttributeError("Can only use .str accessor with string values!")
    gt = []
    for pathology in OPENI_PATHOLOGIES:
        mask = _contains(cells, pathology.lower())
        for syn in OPENI_SYNONYMS.get(pathology, []):
            mask |= _contains(cells, syn.lower())
        gt.append(mask)
    gt = np.asarray(gt).T.astype(np.float32)
    gt[np.where(np.sum(gt, axis=1) == 0), -1] = 1
    label = gt[:, :-1]  # drop No_Finding column
    return _headline(np.asarray(similarities), label)


def merge_padchest(similarities: np.ndarray, label_file_path: str) -> Dict[str, float]:
    """PadChest: sorted unique label space minus 'normal', long-tail AUC,
    plus PadChest20 rare classes (<=10 positives) AUROC/AUPRC
    (ref inference.py:152-300)."""
    with open(label_file_path, "r") as f:
        data = json.load(f)
    all_labels = []
    for k in data:
        all_labels += data[k]
    sorted_classes = sorted(set(all_labels))
    normal_idx = sorted_classes.index("normal")

    encoded = _multilabel_binarize([data[k] for k in data], sorted_classes)
    encoded = np.delete(encoded, normal_idx, axis=1)
    predict = np.asarray(similarities)

    result = _headline(predict, encoded)

    # PadChest20: classes with <= 10 positives (ref inference.py:229-258)
    auprcs, aurocs = [], []
    for i in range(encoded.shape[1]):
        if encoded[:, i].sum() <= 10:
            aurocs.append(roc_auc_score(encoded[:, i], predict[:, i]))
            precision, recall, _ = precision_recall_curve(encoded[:, i], predict[:, i])
            auprcs.append(auc(recall, precision))
    result["Padhcest20 AUROC"] = float(np.mean(aurocs)) if aurocs else float("nan")
    result["Padhcest20 AUPRC"] = float(np.mean(auprcs)) if auprcs else float("nan")
    return result


def merge_chestxray14(similarities: np.ndarray, label_file_path: str) -> Dict[str, float]:
    """ChestXray14 (ref inference.py:303-343): space-separated test list."""
    table = read_csv(label_file_path, sep=" ", names=["path"] + CHESTXRAY14_CLASSES)
    label = table.values(CHESTXRAY14_CLASSES)
    predict = np.asarray(similarities)
    total_auc = eval_auc(predict, label)[0]
    micro_prc, macro_prc = calculate_micro_macro_auprc(label, predict)
    return {"Total AUC": total_auc, "Micro AUPRC": micro_prc, "Macro AUPRC": macro_prc}


def merge_chexpert5(similarities: np.ndarray, label_file_path: str) -> Dict[str, float]:
    """CheXpert 5-class (ref inference.py:346-368)."""
    label = read_csv(label_file_path).values(CHEXPERT5_CLASSES)
    predict = np.asarray(similarities)
    total_auc = eval_auc(predict, label)[0]
    micro_prc, macro_prc = calculate_micro_macro_auprc(label, predict)
    return {"Total AUC": total_auc, "Micro AUPRC": micro_prc, "Macro AUPRC": macro_prc}


def merge_chestxdet10(similarities: np.ndarray, label_file_path: str) -> Dict[str, float]:
    """ChestXDet10 (ref inference.py:371-418): syms lists -> multilabel."""
    with open(label_file_path, "r") as f:
        data = json.load(f)
    label = _multilabel_binarize([d["syms"] for d in data], CHESTXDET10_CLASSES)
    predict = np.asarray(similarities)

    pre = np.zeros_like(predict)
    pre[np.arange(len(predict)), predict.argmax(1)] = 1
    eval_f1(pre, label)  # reference computes & prints F1 here too

    total_auc = eval_auc(predict, label)[0]
    micro_prc, macro_prc = calculate_micro_macro_auprc(label, predict)
    return {"Total AUC": total_auc, "Micro AUPRC": micro_prc, "Macro AUPRC": macro_prc}


def merge_chexpert5x200(similarities: np.ndarray, label_file_path: str) -> Dict[str, float]:
    """CheXpert-5x200 single-label accuracy (ref inference.py:421-435):
    softmax over the 5 class prompts, argmax accuracy + per-class accuracy."""
    label = read_csv(label_file_path).values(CHEXPERT5_CLASSES)
    predict = softmax(np.asarray(similarities), axis=1)
    result = {"Accuracy": float(accuracy_score(label.argmax(1), predict.argmax(1)))}
    for i, disease in enumerate(CHEXPERT5_CLASSES):
        result[f"{disease} Accuracy"] = float(
            accuracy_score(label[:, i], predict[:, i].round())
        )
    return result


MERGERS = {
    "OpenI": ("OpenI/custom.csv", merge_openi),
    "PadChest": ("PadChest/manual_image.json", merge_padchest),
    "ChestXray14": ("ChestXray14/test_list.txt", merge_chestxray14),
    "Chexpert": ("Chexpert/test_labels.csv", merge_chexpert5),
    "ChestXDet10": ("ChestXDet10/test.json", merge_chestxdet10),
    "Chexpert_5x200": ("Chexpert_5x200/chexpert_5x200_newpath.csv", merge_chexpert5x200),
}
