"""MIMIC-CXR offline preprocessing CLI (port of radzero_tpu/cli/preprocess.py).

Rebuild of the reference's 4-stage pipeline entry points
(preprocess/mimic_cxr/*: create_section_files -> findings_impression ->
prompt_alignment -> dicom_preprocess) as one CLI:

    python -m radzero_torch.cli.preprocess \
        --reports_root /data/mimic-cxr-reports \
        --split_csv /data/mimic-cxr-2.0.0-split.csv \
        --metadata_csv /data/mimic-cxr-2.0.0-metadata.csv \
        --output_dir /data/MIMIC-CXR \
        [--extractor rule|llm --llm_endpoint http://...:8000/v1] [--device cuda|cpu]

Produces ``train.json`` / ``validate.json`` with the
{dicom_id, view_position, key_phrases} records the training pipeline
consumes (exp/cxr_pt/dataset.py contract), byte for byte the JAX CLI's.

The flags are the JAX CLI's, plus ``--device``, which every entry point of
the port takes (default ``cuda``: it raises without a card; the tests pass
``cpu``). The work itself is host code and launches no kernel.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

from radzero_torch.cli import resolve_device
from radzero_torch.preprocess.findings import build_records, parse_reports
from radzero_torch.preprocess.keyphrases import (
    LLMKeyPhraseExtractor,
    RuleBasedKeyPhraseExtractor,
    extract_key_phrases,
)
from radzero_torch.utils.json_io import save_json
from radzero_torch.utils.logging import load_logger


def discover_reports(reports_root: str) -> dict:
    """{study_id: relative txt path} from the MIMIC-CXR reports tree
    (files/pXX/pSUBJ/sSTUDY.txt)."""
    out = {}
    for path in glob.iglob(os.path.join(reports_root, "**", "s*.txt"), recursive=True):
        study = os.path.splitext(os.path.basename(path))[0].lstrip("s")
        out[study] = os.path.relpath(path, reports_root)
    return out


def make_llm_extractor(endpoint: str, model: str):
    """OpenAI-compatible chat endpoint (e.g. a vLLM server, the
    reference's backend, prompt_alignment.py:121-128)."""
    import json as _json
    import urllib.request

    def complete(system_prompt: str, user_text: str) -> str:
        payload = _json.dumps(
            {
                "model": model,
                "messages": [
                    {"role": "system", "content": system_prompt},
                    {"role": "user", "content": user_text},
                ],
                "temperature": 0.0,
            }
        ).encode()
        req = urllib.request.Request(
            endpoint.rstrip("/") + "/chat/completions",
            data=payload,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=300) as r:
            data = _json.loads(r.read())
        return data["choices"][0]["message"]["content"]

    return LLMKeyPhraseExtractor(complete=complete)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--reports_root", required=True)
    p.add_argument("--split_csv", required=True)
    p.add_argument("--metadata_csv", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--splits", nargs="*", default=["train", "validate"])
    p.add_argument("--extractor", choices=["rule", "llm"], default="rule")
    p.add_argument("--llm_endpoint", default=None)
    p.add_argument("--llm_model", default="meta-llama/Llama-3.3-70B-Instruct")
    p.add_argument("--batch_size", type=int, default=1000)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)
    resolve_device(args.device)

    logger = load_logger()
    os.makedirs(args.output_dir, exist_ok=True)

    logger.info("stage 1-2: parsing report sections")
    study_paths = discover_reports(args.reports_root)
    sections = parse_reports(args.reports_root, study_paths)
    logger.info(f"parsed {len(sections)} studies")

    if args.extractor == "llm":
        if not args.llm_endpoint:
            p.error("--llm_endpoint required for the llm extractor")
        extractor = make_llm_extractor(args.llm_endpoint, args.llm_model)
    else:
        extractor = RuleBasedKeyPhraseExtractor()

    for split in args.splits:
        logger.info(f"stage 3-4: split {split}")
        records = build_records(args.split_csv, args.metadata_csv, sections, split)
        batch_dir = os.path.join(args.output_dir, f"keyphrase_batches_{split}")
        records = extract_key_phrases(records, extractor, batch_dir, args.batch_size)
        records = [r for r in records if r.get("key_phrases")]
        save_json(records, os.path.join(args.output_dir, f"{split}.json"))
        logger.info(f"{split}: wrote {len(records)} records")


if __name__ == "__main__":
    main()
