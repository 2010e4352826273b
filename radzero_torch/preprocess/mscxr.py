"""MS-CXR stage: MedRPG-style grounding split (copy of radzero_tpu/preprocess/mscxr.py).

Rebuild of preprocess/ms_cxr/medrpg_split.py:17-73: convert MS-CXR
phrase-grounding annotations into the multi-task detection JSON the
eval harness reads:
    {"image": ..., "det": [{"name": phrase, "label": [[x1,y1,x2,y2]]}]}

The reference loads MedRPG's .pth split files; this accepts either a
list of raw annotation dicts or such a .pth (read via torch in the
offline tool).
"""

from __future__ import annotations

import os
from typing import Dict, List

from radzero_torch.utils.json_io import save_json


def multi_task_format(raw_items: List[dict]) -> List[dict]:
    """MedRPG annotation entries -> our grounding JSON rows.

    Each raw item carries an image path, a referring phrase, and one box
    [x1, y1, x2, y2].
    """
    out = []
    for item in raw_items:
        image = item.get("image") or item.get("image_path") or item.get("img_path")
        phrase = item.get("phrase") or item.get("text") or item.get("name")
        box = item.get("bbox") or item.get("box") or item.get("label")
        if box and isinstance(box[0], (int, float)):
            box = [box]
        out.append({"image": image, "det": [{"name": phrase, "label": box}]})
    return out


def load_medrpg_pth(path: str) -> List[dict]:
    """Read a MedRPG .pth split (list of [img_path, ..., bbox, phrase] rows).

    The file must be trusted input: MedRPG's split files hold tuples, so it
    is read with ``weights_only=False``, which unpickles arbitrary objects
    and can run code."""
    import torch

    data = torch.load(path, map_location="cpu", weights_only=False)
    items = []
    for row in data:
        if isinstance(row, dict):
            items.append(row)
        else:  # MedRPG tuple rows: (img_path, _, bbox, phrase, ...)
            img_path, bbox, phrase = row[0], row[2], row[3]
            items.append({"image": img_path, "bbox": list(bbox), "phrase": phrase})
    return items


def write_split_jsons(
    splits: Dict[str, List[dict]], output_dir: str
) -> None:
    os.makedirs(output_dir, exist_ok=True)
    for name, items in splits.items():
        save_json(multi_task_format(items), os.path.join(output_dir, f"{name}.json"))
