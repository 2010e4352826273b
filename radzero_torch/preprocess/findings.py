"""MIMIC-CXR stage 2: join report sections with splits + DICOM metadata
(port of radzero_tpu/preprocess/findings.py, without pandas).

Rebuild of preprocess/mimic_cxr/findings_impression.py:32-125: for every
DICOM in the official split CSVs, attach the study's FINDINGS and
IMPRESSION sections and the view position from the metadata CSV,
producing the per-DICOM JSON record list that feeds key-phrase
extraction (stage 3) and training (exp/cxr_pt/dataset.py expects
``dicom_id`` / ``view_position`` / later ``key_phrases``).

The CSVs are read by :mod:`radzero_torch.eval._table`, which gives
``pd.read_csv``'s column types, and each cell is taken as the Python
scalar pandas' ``itertuples`` yields, so the records are the JAX
package's: an integer ``study_id`` becomes ``"100"`` and one read as a
float (a column with an empty cell) ``"100.0"``; an empty ``ViewPosition``
cell is NaN, which ``save_json`` writes as ``NaN``; a metadata CSV with no
``ViewPosition`` column gives every record an empty view, as
``dict(zip(ids, ""))`` does there.
"""

from __future__ import annotations

import os
from typing import Dict, List

from radzero_torch.eval._table import read_csv
from radzero_torch.preprocess.sections import full_report_sections
from radzero_torch.utils.logging import logger


def parse_reports(
    reports_root: str, study_paths: Dict[str, str]
) -> Dict[str, Dict[str, str]]:
    """{study_id: {findings, impression}} from raw report .txt files."""
    out = {}
    for study_id, rel in study_paths.items():
        path = os.path.join(reports_root, rel)
        if not os.path.exists(path):
            continue
        with open(path, "r", errors="ignore") as f:
            sections = full_report_sections(f.read())
        out[study_id] = {
            "findings": sections.get("findings", ""),
            "impression": sections.get("impression", ""),
        }
    return out


def build_records(
    split_csv: str,
    metadata_csv: str,
    sections_by_study: Dict[str, Dict[str, str]],
    split_name: str = "train",
    image_suffix: str = ".jpg",
) -> List[dict]:
    """Per-DICOM records for one split.

    split CSV columns:   dicom_id, study_id, subject_id, split
    metadata columns:    dicom_id, ViewPosition (MIMIC-CXR-JPG metadata)
    """
    split = read_csv(split_csv)
    meta = read_csv(metadata_csv)
    views = meta["ViewPosition"].tolist() if "ViewPosition" in meta.columns else []
    view_by_dicom = dict(zip(meta["dicom_id"].tolist(), views))

    cols = {c: split[c].tolist() for c in ("dicom_id", "study_id", "subject_id")}
    splits = split["split"].tolist() if "split" in split.columns else [split_name] * len(split)
    records = []
    missing = 0
    for dicom_id, study_id, subject_id, row_split in zip(
        cols["dicom_id"], cols["study_id"], cols["subject_id"], splits
    ):
        if row_split != split_name:
            continue
        study_key = str(study_id)
        sec = sections_by_study.get(study_key) or sections_by_study.get(f"s{study_key}")
        if sec is None or not (sec["findings"] or sec["impression"]):
            missing += 1
            continue
        records.append(
            {
                "dicom_id": f"{dicom_id}{image_suffix}",
                "study_id": study_key,
                "subject_id": str(subject_id),
                "view_position": view_by_dicom.get(dicom_id, ""),
                "findings": sec["findings"],
                "impression": sec["impression"],
            }
        )
    logger.info(
        f"{split_name}: {len(records)} records ({missing} studies without findings/impression)"
    )
    return records
