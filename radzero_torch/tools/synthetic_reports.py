"""A seeded synthetic MIMIC-CXR reports tree, and a mock OpenAI-compatible
chat server, for driving ``python -m radzero_torch.cli.preprocess`` (and the
JAX package's CLI) without the dataset or a language model.

``build_reports_tree(root, n_studies, seed)`` writes what the CLI reads:

- ``reports/files/pXX/pSUBJECT/sSTUDY.txt``: reports with the MIMIC section
  headers (FINAL REPORT, EXAMINATION, INDICATION, COMPARISON, FINDINGS,
  IMPRESSION), some with only one of FINDINGS / IMPRESSION and some with
  neither (the CLI drops those studies);
- ``split.csv`` (dicom_id, study_id, subject_id, split: train / validate /
  test), 1-3 DICOMs a study;
- ``meta.csv`` (dicom_id, ViewPosition), some cells empty (pandas reads NaN).

``MockChat`` answers ``POST /v1/chat/completions`` on 127.0.0.1 with a JSON
list of "There is ..." phrases made from the report's words. Its first
reply is malformed (the extractor retries), and it never answers a report
that holds ``UNREADABLE`` with a list (the extractor quarantines it in
``failed.json``).
"""

from __future__ import annotations

import json
import os
import random
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Sequence

UNREADABLE = "UNREADABLE"
FINDINGS_POOL = [
    "There is a right lower lobe opacity concerning for pneumonia.",
    "Heart size is normal.",
    "The cardiomediastinal silhouette is within normal limits.",
    "No pleural effusion or pneumothorax is seen.",
    "There is mild pulmonary vascular congestion.",
    "Small left pleural effusion is present.",
    "Bibasilar atelectasis is noted.",
    "Moderate cardiomegaly is unchanged.",
    "A nasogastric tube terminates in the stomach.",
    "Multifocal consolidation is seen in both lungs.",
    "There is a 1.5 cm nodule in the left upper lobe.",
    "No acute osseous abnormality.",
]
IMPRESSION_POOL = [
    "No acute cardiopulmonary process.",
    "Right lower lobe pneumonia.",
    "Mild pulmonary edema.",
    "Small left pleural effusion with adjacent atelectasis.",
    "Stable cardiomegaly without edema.",
    "Left upper lobe nodule, recommend CT for further evaluation.",
]
INDICATIONS = ["Cough and fever.", "Shortness of breath.", "Chest pain.",
               "Evaluate for pneumonia.", "Line placement."]
VIEWS = ["PA", "AP", "LATERAL", "LL", "AP AXIAL", ""]


class _Draws:
    """Seeded draws from ``random.Random.random()`` alone, whose sequence
    Python keeps from version to version, so a seed gives the same tree on
    every host."""

    def __init__(self, seed: int):
        self._r = random.Random(seed)

    def below(self, n: int) -> int:
        return min(int(self._r.random() * n), n - 1)

    def weighted(self, p: Sequence[float]) -> int:
        u, acc = self._r.random(), 0.0
        for i, w in enumerate(p):
            acc += w
            if u < acc:
                return i
        return len(p) - 1

    def sample(self, n: int, k: int) -> List[int]:
        pool = list(range(n))
        return [pool.pop(self.below(len(pool))) for _ in range(k)]


def _report(draw: _Draws, kind: int) -> str:
    """kind 0: findings and impression; 1: impression only; 2: findings only;
    3: neither; 4: findings and impression, the findings unreadable."""
    parts = ["FINAL REPORT",
             "EXAMINATION:  CHEST (PA AND LAT)",
             f"INDICATION:  {INDICATIONS[draw.below(len(INDICATIONS))]}",
             "COMPARISON:  None."]
    findings = " ".join(FINDINGS_POOL[i] for i in
                        draw.sample(len(FINDINGS_POOL), 1 + draw.below(4)))
    impression = IMPRESSION_POOL[draw.below(len(IMPRESSION_POOL))]
    if kind == 4:
        findings = f"The film is {UNREADABLE} due to motion. " + findings
    if kind in (0, 2, 4):
        parts.append(f"FINDINGS:\n {findings}")
    if kind in (0, 1, 4):
        parts.append(f"IMPRESSION:\n {impression}")
    return "\n \n".join(parts) + "\n"


def build_reports_tree(root: str, n_studies: int = 120, seed: int = 0) -> Dict[str, str]:
    """-> {"reports_root", "split_csv", "metadata_csv"} under ``root``."""
    draw = _Draws(seed)
    reports = os.path.join(root, "reports")
    split_rows: List[str] = ["dicom_id,study_id,subject_id,split"]
    meta_rows: List[str] = ["dicom_id,ViewPosition"]
    for s in range(n_studies):
        subject, study = 10000032 + 7 * (s // 3), 50000000 + 13 * s
        kind = draw.weighted([0.7, 0.12, 0.08, 0.05, 0.05])
        d = os.path.join(reports, "files", f"p{str(subject)[:2]}", f"p{subject}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"s{study}.txt"), "w") as f:
            f.write(_report(draw, kind))
        split = ("train", "validate", "test")[draw.weighted([0.8, 0.1, 0.1])]
        for _ in range(1 + draw.below(3)):
            dicom = "-".join(f"{draw.below(2**32):08x}" for _ in range(5))
            split_rows.append(f"{dicom},{study},{subject},{split}")
            meta_rows.append(f"{dicom},{VIEWS[draw.below(len(VIEWS))]}")
    paths = {"reports_root": reports, "split_csv": os.path.join(root, "split.csv"),
             "metadata_csv": os.path.join(root, "meta.csv")}
    for key, rows in (("split_csv", split_rows), ("metadata_csv", meta_rows)):
        with open(paths[key], "w") as f:
            f.write("\n".join(rows) + "\n")
    return paths


def mock_phrases(user_text: str) -> List[str]:
    """The mock's answer: "There is <word>" for the report's distinct words of
    eight letters or more but the section names, in order of first
    appearance, at most four."""
    words = dict.fromkeys(w for w in re.findall(r"[a-z]{8,}", user_text.lower())
                          if w not in ("findings", "impression"))
    return [f"There is {w}" for w in list(words)[:4]]


class _Handler(BaseHTTPRequestHandler):
    def do_POST(self):  # noqa: N802
        chat = self.server.chat
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        user = body["messages"][1]["content"]
        with chat.lock:
            chat.requests.append(user)
            first = len(chat.requests) == 1
        if first or UNREADABLE in user:
            content = "I am sorry, I cannot turn this report into a list."
        else:
            content = json.dumps(mock_phrases(user))
        data = json.dumps({"choices": [{"message": {"role": "assistant",
                                                    "content": content}}]}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


class MockChat:
    """``with MockChat() as chat:`` serves on ``chat.url`` (127.0.0.1, a free
    port) from a thread; ``chat.requests`` holds every user message."""

    def __init__(self):
        self.requests: List[str] = []
        self.lock = threading.Lock()
        self._server = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
        self._server.chat = self
        self.url = f"http://127.0.0.1:{self._server.server_port}/v1"
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)

    def __enter__(self) -> "MockChat":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)

