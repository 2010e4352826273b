"""MIMIC-CXR training dataset loading (copy of radzero_tpu/data/mimic.py).

Rebuilds exp/cxr_pt/dataset.py:18-110: JSON -> list of
{image, key_phrases, train} entries with the frontal-view filter and
the MS-CXR test-leak removal, plus the union-of-keys list loader that
replaces ``WithMissingValueDataset`` (common/dataset.py:11-46).

Plain Python lists — the heavy lifting (decode/resize/tokenize/pack)
lives in radzero_torch.data.pipeline.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

from radzero_torch.utils.json_io import load_json
from radzero_torch.utils.logging import logger


def from_list_with_missing(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Union-of-keys normalisation: missing fields -> None
    (ref common/dataset.py:11-46)."""
    keys = set()
    for r in records:
        keys.update(r.keys())
    return [{k: r.get(k) for k in keys} for r in records]


def input_json_file_load(
    json_path: str,
    data_root: str,
    train_flag: bool,
    **kwargs,
) -> List[Dict[str, Any]]:
    """Load one MIMIC-CXR split JSON (ref dataset.py:18-74)."""
    logger.info(f"load dataset: {json_path}")
    input_json = load_json(os.path.join(data_root, json_path))

    use_frontal_view_only = kwargs.get("use_frontal_view_only", False)
    dataset_name = json_path.split("/")[0]

    data_list = []
    for data in input_json:
        if dataset_name != "MIMIC-CXR":
            continue
        view_position = data.get("view_position", "")
        view_position = (
            str(view_position).lower()
            if isinstance(view_position, str) and view_position.strip()
            else ""
        )
        if use_frontal_view_only and view_position not in ("pa", "ap", ""):
            continue

        key_phrases = [p for p in (data.get("key_phrases") or []) if p.strip()]
        if not key_phrases:
            continue

        data_list.append(
            {
                "image": os.path.join(data_root, "MIMIC-CXR", "images", data["dicom_id"]),
                "key_phrases": key_phrases,
                "train": train_flag,
            }
        )

    # MS-CXR de-leak (ref dataset.py:56-69)
    if kwargs.get("rm_mscxr") and train_flag and kwargs.get("MS_CXR_test"):
        ms_cxr = load_json(os.path.join(data_root, kwargs["MS_CXR_test"]))
        leaked = {os.path.basename(e["image"]) for e in ms_cxr}
        before = len(data_list)
        data_list = [e for e in data_list if os.path.basename(e["image"]) not in leaked]
        logger.info(
            f"number of instances and MS CXR removed from the training dataset: {before - len(data_list)}"
        )

    logger.info(f"dataset name: {dataset_name}, number of instances: {len(data_list)}")
    return data_list


def load_datasets(cfg: dict, train: bool = True, inference: bool = False) -> dict:
    """Build {train, eval[, test]} record lists (ref dataset.py:77-110)."""
    data_root = cfg["data_root"]
    kwargs = {k: v for k, v in cfg.items() if k != "data_root"}
    out = {}
    if train:
        train_records: list = []
        for name in cfg["train"]:
            train_records += input_json_file_load(cfg[name], data_root, True, **kwargs)
        eval_records: list = []
        for name in cfg["eval"]:
            eval_records += input_json_file_load(cfg[name], data_root, False, **kwargs)
        out["train"] = from_list_with_missing(train_records)
        out["eval"] = from_list_with_missing(eval_records)
    if inference and cfg.get("test"):
        test_records: list = []
        for name in cfg["test"]:
            test_records += input_json_file_load(cfg[name], data_root, False, **kwargs)
        out["test"] = from_list_with_missing(test_records)
    return out
