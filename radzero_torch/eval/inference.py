"""Inference facade, the three zero-shot task families: the port's copy of
radzero_tpu/eval/inference.py (ref exp/cxr_pt/inference/inference.py:19-170).

Each task is wrapped in error containment (the reference's per-task
try/except: the error and its traceback are logged and the task returns
None) and dumps its metrics to ``result.json`` in the task's save
directory. Everything runs on the scorer's device.
"""

from __future__ import annotations

import os
import traceback
from typing import List, Optional

from radzero_torch.eval._table import read_csv
from radzero_torch.eval.classification import eval_classification
from radzero_torch.eval.grounding import chestxdet10_eval_grounding, eval_refer_grounding
from radzero_torch.eval.registry import get_infer_dirs
from radzero_torch.eval.scorer import ZeroShotScorer
from radzero_torch.eval.segmentation import (
    eval_segmentation_rsna_medklip,
    eval_segmentation_siim,
)
from radzero_torch.utils.json_io import load_json, save_json
from radzero_torch.utils.logging import logger


class Inference:
    def __init__(
        self,
        cls_dataset: List[str],
        det_dataset: List[str],
        seg_dataset: List[str],
        data_root_dir: str,
        batch_size: int = 64,
        num_workers: int = 8,
        write_result_json: bool = True,
    ):
        self.cls_dataset = cls_dataset
        self.det_dataset = det_dataset
        self.seg_dataset = seg_dataset
        self.data_root_dir = data_root_dir
        self.batch_size = batch_size
        self.num_workers = num_workers
        # the distributed eval turns this off and merges the ranks' parts
        self.write_result_json = write_result_json

    # ------------------------------------------------------------------
    def classification(
        self, scorer: ZeroShotScorer, save_root_dir: str, compute_metric: bool = True
    ) -> Optional[dict]:
        try:
            os.makedirs(save_root_dir, exist_ok=True)
            dirs = get_infer_dirs(self.data_root_dir)
            image_paths = [dirs[d]["image_path"] for d in self.cls_dataset]
            text_paths = [dirs[d]["text_path"] for d in self.cls_dataset]
            performances = eval_classification(
                scorer, self.cls_dataset, image_paths, text_paths,
                self.data_root_dir, save_root_dir, compute_metric=compute_metric,
            )
            if self.write_result_json:
                save_json(performances, os.path.join(save_root_dir, "result.json"))
            return performances
        except Exception as e:
            logger.error(f"Error in zero shot classification: {e}\n{traceback.format_exc()}")
            return None

    # ------------------------------------------------------------------
    def grounding(self, scorer: ZeroShotScorer, save_root_dir: str) -> Optional[dict]:
        try:
            os.makedirs(save_root_dir, exist_ok=True)
            dirs = get_infer_dirs(self.data_root_dir)
            result = {}
            for det_d in self.det_dataset:
                if det_d == "ChestXDet10":
                    result["ChestXDet10"] = chestxdet10_eval_grounding(
                        scorer,
                        dirs[det_d]["image_path"],
                        dirs[det_d]["text_path"],
                        os.path.join(self.data_root_dir, "ChestXDet10/test.json"),
                        self.data_root_dir,
                    )
                elif det_d == "MS-CXR":
                    data = load_json(dirs[det_d]["data_path"])
                    result["MS-CXR"] = eval_refer_grounding(
                        scorer, data, self.data_root_dir
                    )
            if self.write_result_json:
                save_json(result, os.path.join(save_root_dir, "result.json"))
            return result
        except Exception as e:
            logger.error(f"Error in zero shot grounding: {e}\n{traceback.format_exc()}")
            return None

    # ------------------------------------------------------------------
    def segmentation(
        self,
        scorer: ZeroShotScorer,
        save_root_dir: str,
        compute_pixel_level_auroc: bool = False,
    ) -> Optional[dict]:
        try:
            os.makedirs(save_root_dir, exist_ok=True)
            dirs = get_infer_dirs(self.data_root_dir)
            result = {}
            for seg_d in self.seg_dataset:
                if seg_d == "SIIM":
                    data = read_csv(dirs[seg_d]["data_path"])
                    result["SIIM"] = eval_segmentation_siim(
                        scorer, data, "There is Pneumothorax",
                        self.data_root_dir, compute_pixel_level_auroc,
                    )
                elif seg_d == "RSNA":
                    data = read_csv(dirs[seg_d]["data_path"])
                    result["RSNA"] = eval_segmentation_rsna_medklip(
                        scorer, data, "There is Pneumonia",
                        self.data_root_dir, compute_pixel_level_auroc,
                    )
            if self.write_result_json:
                save_json(result, os.path.join(save_root_dir, "result.json"))
            return result
        except Exception as e:
            logger.error(f"Error in zero shot segmentation: {e}\n{traceback.format_exc()}")
            return None
