"""Zero-shot classification evaluation: the port's copy of
radzero_tpu/eval/classification.py (ref inference/utils.py:42-318).

Per dataset: prompt JSON -> positive prompts (+ 'There is no' negatives,
kept for API parity though the radzero logits path scores positives),
batched similarity over the image list on the scorer's device, CSV dump of
the raw similarities, then the dataset-specific metric merger.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from radzero_torch.data.dicom import load_eval_image, minmax_normalize_uint8
from radzero_torch.eval._table import read_csv, write_matrix_csv
from radzero_torch.eval.mergers import MERGERS
from radzero_torch.eval.scorer import ZeroShotScorer
from radzero_torch.utils.logging import logger


def process_class_prompts(text_prompt: dict) -> Dict[str, List[str]]:
    """Prompt JSON {'0': ['There is X'], ...} -> pos + neg prompt lists
    (ref inference/utils.py:42-67)."""
    pos, neg = [], []
    for i in range(len(text_prompt)):
        p = text_prompt[str(i)][0]
        pos.append(p)
        neg.append(p.replace("There is", "There is no"))
    return {"pos": pos, "neg": neg}


def _image_loader(data_root_dir: str):
    def load(path: str):
        img = load_eval_image(os.path.join(data_root_dir, path))
        return minmax_normalize_uint8(img)  # the 'PadChest fix' (dataset.py:36-43)

    return load


def calculate_similarities(
    scorer: ZeroShotScorer,
    image_paths: List[str],
    prompts: List[str],
    data_root_dir: str,
) -> np.ndarray:
    logits, _ = scorer.score(image_paths, _image_loader(data_root_dir), prompts)
    return logits


def eval_classification(
    scorer: ZeroShotScorer,
    sel_datasets: List[str],
    image_paths: List[str],
    text_paths: List[str],
    data_root_dir: str,
    save_root_dir: str,
    compute_metric: bool = True,
) -> Dict[str, Dict[str, float]]:
    """Run the classification suite (ref eval_classification,
    inference/utils.py:181-220 + cal_performance :223-318).
    ``compute_metric=False`` dumps raw similarity CSVs only (the
    reference's --compute_metric flag, run.py:49)."""
    performances: Dict[str, Dict[str, float]] = {}
    for image_path, text_path, name in zip(image_paths, text_paths, sel_datasets):
        image_set = read_csv(image_path)["Path"].tolist()
        with open(text_path, "r") as f:
            text_prompt = json.load(f)
        prompts = process_class_prompts(text_prompt)["pos"]

        similarities = calculate_similarities(scorer, image_set, prompts, data_root_dir)
        write_matrix_csv(os.path.join(save_root_dir, name) + ".csv", similarities)

        if compute_metric and name in MERGERS:
            label_rel, merger = MERGERS[name]
            label_path = os.path.join(data_root_dir, label_rel)
            perf = merger(similarities, label_path)
            performances[name] = perf
            logger.info(f"{name}: {perf}")
    return performances
