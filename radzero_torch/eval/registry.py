"""Zero-shot benchmark dataset path registry: the port's copy of
radzero_tpu/eval/registry.py (ref inference/utils.py:109-178)."""

from __future__ import annotations

import os


def get_infer_dirs(data_root_dir: str) -> dict:
    j = os.path.join
    return {
        "OpenI": {
            "image_path": j(data_root_dir, "OpenI/openi_multi_label_image.csv"),
            "text_path": j(data_root_dir, "OpenI/openi_multi_label_text.json"),
        },
        "PadChest": {
            "image_path": j(data_root_dir, "PadChest/padchest_multi_label_image.csv"),
            "text_path": j(data_root_dir, "PadChest/padchest_multi_label_text.json"),
        },
        "ChestXray14": {
            "image_path": j(data_root_dir, "ChestXray14/chestxray14_test_image.csv"),
            "text_path": j(data_root_dir, "ChestXray14/chestxray14_test_text.json"),
        },
        "Chexpert": {
            "image_path": j(data_root_dir, "Chexpert/chexpert5_test_image.csv"),
            "text_path": j(data_root_dir, "Chexpert/chexpert5_test_text.json"),
        },
        "ChestXDet10": {
            "image_path": j(data_root_dir, "ChestXDet10/chestXDet10_test_image.csv"),
            "text_path": j(data_root_dir, "ChestXDet10/chestXDet10_test_text.json"),
        },
        "MS-CXR": {"data_path": j(data_root_dir, "MS-CXR/test.json")},
        "SIIM": {"data_path": j(data_root_dir, "SIIM/test.csv")},
        "RSNA": {"data_path": j(data_root_dir, "RSNA/test.csv")},
    }
