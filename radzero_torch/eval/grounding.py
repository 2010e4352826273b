"""Zero-shot grounding evaluation: the port's copy of
radzero_tpu/eval/grounding.py (ref inference/grounding_utils.py).

- ChestXDet10: per-image per-finding similarity maps -> argmax point in
  original coordinates -> pointing-game score per class + mean
  (grounding_utils.py:69-163).
- MS-CXR referring expressions: one sentence per sample -> point-in-bbox
  accuracy (grounding_utils.py:283-326). Unlike the reference's batch-1
  loop, samples are scored through the batched scorer.

The maps are upsampled on the scorer's device.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List

import numpy as np

from radzero_torch.data.dicom import load_eval_image
from radzero_torch.eval._table import read_csv
from radzero_torch.eval.classification import _image_loader, process_class_prompts
from radzero_torch.eval.geometry import grounding_point, is_point_in_bbox
from radzero_torch.eval.scorer import ZeroShotScorer
from radzero_torch.utils.json_io import load_json
from radzero_torch.utils.logging import logger

# ChestXDet10 prompt-text -> annotation class (grounding_utils.py:85-96)
FINDING_MAPPING = {
    "Atelectasis": "Atelectasis",
    "Tissue Calcification": "Calcification",
    "Pulmonary Consolidation": "Consolidation",
    "Pleural Effusion": "Effusion",
    "Pulmonary Emphysema": "Emphysema",
    "Fibrosis": "Fibrosis",
    "Bone Fracture": "Fracture",
    "Pulmonary Mass": "Mass",
    "Lung Nodule": "Nodule",
    "Pneumothorax": "Pneumothorax",
}


def chestxdet10_eval_grounding(
    scorer: ZeroShotScorer,
    image_path: str,
    text_path: str,
    test_path: str,
    data_root_dir: str,
) -> Dict[str, float]:
    text_prompt = load_json(text_path)

    finding_classes = [
        FINDING_MAPPING[t[0].replace("There is ", "")] for t in text_prompt.values()
    ]
    finding_indices = {c: i for i, c in enumerate(finding_classes)}

    image_list: List[str] = read_csv(image_path)["Path"].tolist()
    prompts = process_class_prompts(text_prompt)["pos"]

    _, similarity_scores = scorer.score(
        image_list, _image_loader(data_root_dir), prompts, need_scores=True
    )

    image_sizes = []
    for p in image_list:
        with load_eval_image(os.path.join(data_root_dir, p)) as im:
            w, h = im.size
        image_sizes.append((h, w))

    bbox_labels = load_json(test_path)
    geometry = scorer.image_processor.geometry

    results = defaultdict(list)
    for bbox_label, sim, size in zip(bbox_labels, similarity_scores, image_sizes):
        per_finding_boxes = defaultdict(list)
        for sym, box in zip(bbox_label["syms"], bbox_label["boxes"]):
            per_finding_boxes[sym].append(box)
        for finding, boxes in per_finding_boxes.items():
            if finding not in finding_indices:
                continue
            point = grounding_point(sim[finding_indices[finding]], size, geometry,
                                    device=scorer.device)
            results[finding].append(is_point_in_bbox(boxes, point))

    out = {k: float(np.mean(v)) for k, v in results.items()}
    out["mean_pointing_score"] = float(np.mean(list(out.values())))
    for k, v in out.items():
        logger.info(f"{k}: {v:.4f}")
    return out


def eval_refer_grounding(
    scorer: ZeroShotScorer, data: List[dict], data_root_dir: str
) -> float:
    """MS-CXR phrase grounding accuracy (grounding_utils.py:283-326).

    The reference processes one (image, sentence) pair per forward with
    the raw PIL image (no min-max, :294-302); here pairs are batched via
    ``score_paired`` so the vision tower runs at full batch.
    """
    geometry = scorer.image_processor.geometry

    sizes, texts, labels = [], [], []
    for d in data:
        with load_eval_image(os.path.join(data_root_dir, d["image"])) as im:
            w, h = im.size
        sizes.append((h, w))
        texts.append(d["det"][0]["name"])
        labels.append(d["det"][0]["label"][0])

    def load(d):
        return load_eval_image(os.path.join(data_root_dir, d["image"]))

    _, scores = scorer.score_paired(data, load, texts, need_scores=True)

    correct = []
    for sim, size, label in zip(scores, sizes, labels):
        point = grounding_point(sim, size, geometry, device=scorer.device)
        correct.append(is_point_in_bbox([label], point))

    accuracy = float(sum(correct) / len(correct))
    logger.info(f"Accuracy of MS-CXR: {accuracy}")
    return accuracy
