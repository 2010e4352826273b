"""MIMIC-CXR stage 4: DICOM id -> JPEG path mapping (copy of
radzero_tpu/preprocess/dicom_map.py).

Rebuild of preprocess/mimic_cxr/dicom_preprocess.py:30-42: resolve each
record's dicom_id to its MIMIC-CXR-JPG file path
(files/pXX/pSUBJECT/sSTUDY/DICOM.jpg) and optionally verify existence.
"""

from __future__ import annotations

import os
from typing import List, Optional


def jpg_path_for(subject_id: str, study_id: str, dicom_id: str) -> str:
    sid = str(subject_id)
    st = str(study_id)
    stem = dicom_id[:-4] if dicom_id.endswith(".jpg") else dicom_id
    return os.path.join("files", f"p{sid[:2]}", f"p{sid}", f"s{st}", f"{stem}.jpg")


def map_records_to_jpgs(
    records: List[dict], images_root: Optional[str] = None, verify: bool = False
) -> List[dict]:
    """Attach ``image`` (relative jpg path) to each record; drop missing
    files when ``verify`` and an ``images_root`` are given."""
    out = []
    for rec in records:
        rel = jpg_path_for(rec["subject_id"], rec["study_id"], rec["dicom_id"])
        if verify and images_root and not os.path.exists(os.path.join(images_root, rel)):
            continue
        out.append({**rec, "image": rel})
    return out
