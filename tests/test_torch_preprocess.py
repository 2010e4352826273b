"""The port's preprocessing (radzero_torch.preprocess, utils.multiproc,
cli.preprocess) against the JAX package, on the CPU.

Everything here is host code on both sides, so the records, the JSON files
and the batch files must be the same bytes (tolerance: none). The cases of
tests/test_preprocess.py, test_preprocess_cli.py and test_llm_client.py are
mirrored on the port; the LLM client talks to an in-process mock
OpenAI-compatible server on 127.0.0.1.
"""

import json
import os
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from radzero_torch.preprocess import dicom_map, findings, keyphrases, mscxr, sections
from radzero_torch.preprocess.keyphrases import (
    LLMKeyPhraseExtractor,
    RuleBasedKeyPhraseExtractor,
    extract_key_phrases,
)
from radzero_torch.preprocess.llm_client import OpenAIChatClient
from radzero_torch.utils import multiproc
from radzero_torch.utils.json_io import save_json
from radzero_tpu.preprocess import dicom_map as jdicom_map
from radzero_tpu.preprocess import findings as jfindings
from radzero_tpu.preprocess import keyphrases as jkeyphrases
from radzero_tpu.preprocess import mscxr as jmscxr
from radzero_tpu.preprocess import sections as jsections
from radzero_tpu.utils import multiproc as jmultiproc
from radzero_tpu.utils.json_io import save_json as jsave_json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REPORT = """FINAL REPORT:
EXAMINATION: Chest radiograph PA and lateral.

INDICATION: Cough and fever.

COMPARISON: None.

FINDINGS: There is a right lower lobe opacity concerning for pneumonia.
Heart size is normal. No pleural effusion.

IMPRESSION: Right lower lobe pneumonia.
"""


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", HF_HUB_OFFLINE="1",
               TRANSFORMERS_OFFLINE="1")
    return env


# ---------------------------------------------------------------------------
# mirrors of tests/test_preprocess.py
# ---------------------------------------------------------------------------

def test_section_parser():
    secs, order = sections.section_text(REPORT)
    assert "findings" in secs and "impression" in secs
    assert "pneumonia" in secs["findings"].lower()
    assert secs["impression"].startswith("Right lower lobe pneumonia")
    assert order.index("findings") < order.index("impression")
    assert (secs, order) == jsections.section_text(REPORT)


def test_section_parser_no_headers():
    secs, order = sections.section_text("just some text without headers")
    assert order == ["full_report"]
    assert secs == {"full_report": "just some text without headers"}


def test_build_records(tmp_path):
    split = tmp_path / "split.csv"
    pd.DataFrame(
        {
            "dicom_id": ["d1", "d2", "d3"],
            "study_id": [100, 100, 200],
            "subject_id": [1, 1, 2],
            "split": ["train", "train", "validate"],
        }
    ).to_csv(split, index=False)
    meta = tmp_path / "meta.csv"
    pd.DataFrame({"dicom_id": ["d1", "d2", "d3"], "ViewPosition": ["PA", "LATERAL", "AP"]}).to_csv(
        meta, index=False
    )
    secs = {"100": {"findings": "F", "impression": "I"}}
    recs = findings.build_records(str(split), str(meta), secs, "train")
    assert len(recs) == 2
    assert recs[0]["dicom_id"] == "d1.jpg"
    assert recs[0]["view_position"] == "PA"
    assert recs == jfindings.build_records(str(split), str(meta), secs, "train")
    assert findings.build_records(str(split), str(meta), secs, "validate") == []


def test_rule_based_extractor():
    ex = RuleBasedKeyPhraseExtractor()
    args = ("There is a right lower lobe opacity. Heart size is normal. No pleural effusion.",
            "Right lower lobe pneumonia is present.")
    phrases = ex(*args)
    assert any(p.lower().startswith("there is") for p in phrases)
    assert any("no" in p.lower() for p in phrases)  # negation normalised
    assert len(phrases) >= 3
    assert phrases == jkeyphrases.RuleBasedKeyPhraseExtractor()(*args)


def test_llm_extractor_retry_and_quarantine():
    calls = {"n": 0}

    def flaky(system, user):
        calls["n"] += 1
        if calls["n"] < 3:
            return "not json"
        return 'Here you go: ["There is pneumonia of the right lower lobe"]'

    ex = LLMKeyPhraseExtractor(complete=flaky, max_retries=5)
    assert ex("findings", "impression") == ["There is pneumonia of the right lower lobe"]
    assert calls["n"] == 3

    ex2 = LLMKeyPhraseExtractor(complete=lambda s, u: "never json", max_retries=2)
    assert ex2("f", "i") == []
    assert ex2.failed == [{"findings": "f", "impression": "i"}]
    assert keyphrases.DEFAULT_SYSTEM_PROMPT == jkeyphrases.DEFAULT_SYSTEM_PROMPT


def test_extract_key_phrases_resumable(tmp_path):
    recs = [{"dicom_id": f"d{i}", "findings": f"Finding number {i} is present.",
             "impression": ""} for i in range(5)]
    ex = RuleBasedKeyPhraseExtractor()
    out1 = extract_key_phrases(recs, ex, str(tmp_path / "port"), batch_size=2)
    assert len(out1) == 5 and all("key_phrases" in r for r in out1)
    jkeyphrases.extract_key_phrases(recs, jkeyphrases.RuleBasedKeyPhraseExtractor(),
                                    str(tmp_path / "jax"), batch_size=2)
    for b in range(3):
        name = f"batch_{b}.json"
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()

    # resume: pre-existing batch files are reused, not recomputed
    marker = json.loads((tmp_path / "port" / "batch_0.json").read_text())
    marker[0]["key_phrases"] = ["SENTINEL"]
    (tmp_path / "port" / "batch_0.json").write_text(json.dumps(marker))
    out2 = extract_key_phrases(recs, ex, str(tmp_path / "port"), batch_size=2)
    assert out2[0]["key_phrases"] == ["SENTINEL"]


def test_mscxr_multi_task_format():
    raw = [{"image": "a.jpg", "phrase": "left basilar opacity", "bbox": [1, 2, 30, 40]}]
    out = mscxr.multi_task_format(raw)
    assert out == [
        {"image": "a.jpg", "det": [{"name": "left basilar opacity", "label": [[1, 2, 30, 40]]}]}
    ]


# ---------------------------------------------------------------------------
# byte-for-byte against the JAX package
# ---------------------------------------------------------------------------

def _write(path, header, rows):
    path.write_text("\n".join([",".join(header)] + [",".join(r) for r in rows]) + "\n")


SPLIT_ROWS = [["d1", "100", "1", "train"], ["d2", "100", "1", "train"],
              ["d3", "200", "2", "validate"], ["d4", "300", "3", "train"],
              ["d5", "400", "4", "train"]]
META_ROWS = [["d1", "PA"], ["d2", "LATERAL"], ["d3", "AP"], ["d4", "PA"], ["d5", "AP"]]
SECTIONS = {"100": {"findings": "Heart size is normal.", "impression": "No acute process."},
            "200": {"findings": "Small left effusion.", "impression": ""},
            "s300": {"findings": "", "impression": "Right lower lobe pneumonia."},
            "400": {"findings": "", "impression": ""}}


@pytest.mark.parametrize("case", ["plain", "empty_view", "no_view_column", "study_id_gap",
                                  "no_split_column", "quoted_and_na"])
def test_build_records_json_is_the_jax_bytes(case, tmp_path):
    """The records and the JSON save_json writes, byte for byte: an empty
    ViewPosition cell is NaN (written NaN), a metadata CSV without the column
    gives every view "", a study_id column with an empty cell reads as float
    ("300.0"), a split CSV without the split column takes every row."""
    split_header, split_rows = ["dicom_id", "study_id", "subject_id", "split"], SPLIT_ROWS
    meta_header, meta_rows = ["dicom_id", "ViewPosition"], META_ROWS
    if case == "empty_view":
        meta_rows = [["d1", ""], ["d2", "LATERAL"], ["d3", ""], ["d4", "PA"], ["d5", ""]]
    elif case == "no_view_column":
        meta_header, meta_rows = ["dicom_id", "Rows"], [[r[0], "3056"] for r in META_ROWS]
    elif case == "study_id_gap":
        split_rows = SPLIT_ROWS + [["d6", "", "6", "train"]]
    elif case == "no_split_column":
        split_header, split_rows = split_header[:3], [r[:3] for r in SPLIT_ROWS]
    elif case == "quoted_and_na":
        meta_rows = [["d1", '"PA"'], ["d2", "NA"], ["d3", "AP"], ["d4", "N/A"], ["d5", "null"]]
    _write(tmp_path / "split.csv", split_header, split_rows)
    _write(tmp_path / "meta.csv", meta_header, meta_rows)
    secs = SECTIONS
    if case == "study_id_gap":  # the column reads as float: "100.0", and "nan" for the gap
        secs = {f"{k}.0": v for k, v in SECTIONS.items()}
        secs["nan"] = {"findings": "F", "impression": ""}
    for split in ("train", "validate"):
        args = (str(tmp_path / "split.csv"), str(tmp_path / "meta.csv"), secs, split)
        ours, theirs = findings.build_records(*args), jfindings.build_records(*args)
        save_json(ours, str(tmp_path / f"port_{split}.json"))
        jsave_json(theirs, str(tmp_path / f"jax_{split}.json"))
        a = (tmp_path / f"port_{split}.json").read_bytes()
        assert a == (tmp_path / f"jax_{split}.json").read_bytes(), a.decode()
    train = (tmp_path / "port_train.json").read_text()
    if case == "empty_view":
        assert '"view_position": NaN' in train
    if case == "no_view_column":
        assert '"view_position": ""' in train and "PA" not in train
    if case == "study_id_gap":
        assert '"study_id": "300.0"' in train
    if case == "no_split_column":
        assert '"dicom_id": "d3.jpg"' in (tmp_path / "port_validate.json").read_text()


def test_parse_reports_and_dicom_map_match_jax(tmp_path):
    root = tmp_path / "reports"
    (root / "files" / "p10" / "p1000").mkdir(parents=True)
    (root / "files" / "p10" / "p1000" / "s500.txt").write_text(REPORT)
    (root / "files" / "p10" / "p1000" / "s501.txt").write_text("no headers at all")
    paths = {"500": "files/p10/p1000/s500.txt", "501": "files/p10/p1000/s501.txt",
             "502": "files/p10/p1000/s502.txt"}
    ours = findings.parse_reports(str(root), paths)
    assert ours == jfindings.parse_reports(str(root), paths)
    assert sorted(ours) == ["500", "501"] and ours["501"] == {"findings": "", "impression": ""}

    recs = [{"subject_id": "10002", "study_id": "500", "dicom_id": "abc"},
            {"subject_id": 12, "study_id": 7, "dicom_id": "def.jpg"}]
    img = tmp_path / "img" / "files" / "p10" / "p10002" / "s500"
    img.mkdir(parents=True)
    (img / "abc.jpg").write_bytes(b"x")
    for verify in (False, True):
        out = dicom_map.map_records_to_jpgs(recs, str(tmp_path / "img"), verify=verify)
        assert out == jdicom_map.map_records_to_jpgs(recs, str(tmp_path / "img"), verify=verify)
        assert len(out) == (1 if verify else 2)
    assert dicom_map.jpg_path_for("10002", "500", "abc") == "files/p10/p10002/s500/abc.jpg"


def test_mscxr_pth_and_split_jsons_match_jax(tmp_path):
    rows = [("imgs/a.jpg", None, (1, 2, 30, 40), "left basilar opacity"),
            {"image_path": "imgs/b.jpg", "text": "right effusion", "box": [[5, 6, 7, 8]]}]
    torch.save(rows, tmp_path / "split.pth")
    ours = mscxr.load_medrpg_pth(str(tmp_path / "split.pth"))
    assert ours == jmscxr.load_medrpg_pth(str(tmp_path / "split.pth"))
    mscxr.write_split_jsons({"test": ours, "val": ours[:1]}, str(tmp_path / "port"))
    jmscxr.write_split_jsons({"test": ours, "val": ours[:1]}, str(tmp_path / "jax"))
    for name in ("test.json", "val.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_multiproc_matches_jax(tmp_path):
    paths = []
    for i in range(3):
        p = tmp_path / f"{i}.png"
        Image.fromarray(np.full((4, 5), 40 * i, np.uint8)).save(p)
        paths.append(str(p))
    (tmp_path / "broken.png").write_bytes(b"not a png")
    paths.append(str(tmp_path / "broken.png"))
    ours = multiproc.func_with_multiprocessing(multiproc.check_image_integrity, paths,
                                               num_workers=2, desc="check")
    assert ours == paths[:3] + [None]
    assert ours == [jmultiproc.check_image_integrity(p) for p in paths]


# ---------------------------------------------------------------------------
# mirrors of tests/test_llm_client.py
# ---------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    fail_first = 0  # transport failures before succeeding
    fail_code = 500
    malformed = 0   # replies that are not a JSON list before good ones
    requests_seen = []

    def do_POST(self):  # noqa: N802
        cls = type(self)
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        cls.requests_seen.append(body)
        if cls.fail_first > 0:
            cls.fail_first -= 1
            self.send_response(cls.fail_code)
            self.end_headers()
            return
        user = body["messages"][1]["content"]
        phrases = ["There is consolidation of the left lower lobe"]
        if "normal" in user:
            phrases = ["There is no acute cardiopulmonary process"]
        content = json.dumps(phrases)
        if cls.malformed > 0:
            cls.malformed -= 1
            content = "Sorry, I cannot parse this report."
        resp = {"choices": [{"message": {"role": "assistant", "content": content}}]}
        data = json.dumps(resp).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):  # silence
        pass


@pytest.fixture
def mock_server():
    _Handler.fail_first = 0
    _Handler.fail_code = 500
    _Handler.malformed = 0
    _Handler.requests_seen = []
    srv = HTTPServer(("127.0.0.1", 0), _Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}/v1"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


def test_chat_client_roundtrip(mock_server):
    client = OpenAIChatClient(mock_server, model="test-model", max_tokens=64)
    raw = client("sys prompt", "Report: consolidation.")
    assert json.loads(raw) == ["There is consolidation of the left lower lobe"]
    sent = _Handler.requests_seen[-1]
    assert sent["model"] == "test-model" and sent["max_tokens"] == 64
    assert sent["messages"][0] == {"role": "system", "content": "sys prompt"}


def test_chat_client_transport_retry(mock_server):
    _Handler.fail_first = 2
    client = OpenAIChatClient(mock_server, transport_retries=3, backoff_s=0.01)
    assert "consolidation" in client("s", "u")
    assert len(_Handler.requests_seen) == 3


def test_chat_client_4xx_fails_fast(mock_server):
    """Non-429 client errors fail at once instead of burning backoff."""
    _Handler.fail_first = 5
    _Handler.fail_code = 401
    client = OpenAIChatClient(mock_server, transport_retries=5, backoff_s=10.0)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="non-retryable"):
        client("s", "u")
    assert time.perf_counter() - t0 < 5.0  # no 10 s backoff sleeps
    assert _Handler.fail_first == 4  # exactly one request sent


def test_chat_client_no_sleep_after_final_attempt(mock_server):
    _Handler.fail_first = 10  # always 500
    client = OpenAIChatClient(mock_server, transport_retries=2, backoff_s=0.2)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="failed after"):
        client("s", "u")
    # one sleep (0.2 s) between the two attempts, none after the last
    assert time.perf_counter() - t0 < 2.0
    assert len(_Handler.requests_seen) == 2


def test_end_to_end_extraction_with_http_client(mock_server, tmp_path):
    """LLMKeyPhraseExtractor over the HTTP client, resumable batches,
    concurrent requests; a malformed reply is retried, and the batch files
    are the JAX extractor's bytes."""
    _Handler.malformed = 1
    extractor = LLMKeyPhraseExtractor(complete=OpenAIChatClient(mock_server))
    records = [
        {"dicom_id": "a", "findings": "consolidation", "impression": ""},
        {"dicom_id": "b", "findings": "normal study", "impression": "normal"},
    ] * 3
    out = extract_key_phrases(records, extractor, str(tmp_path / "port"), batch_size=4,
                              concurrency=4)
    assert len(out) == 6 and len(_Handler.requests_seen) == 7
    assert out[0]["key_phrases"] == ["There is consolidation of the left lower lobe"]
    assert out[1]["key_phrases"] == ["There is no acute cardiopulmonary process"]
    assert extractor.failed == []
    # resumability: a rerun reads the batch files and sends no request
    seen = len(_Handler.requests_seen)
    out2 = extract_key_phrases(records, extractor, str(tmp_path / "port"), batch_size=4)
    assert [r["key_phrases"] for r in out2] == [r["key_phrases"] for r in out]
    assert len(_Handler.requests_seen) == seen
    jextractor = jkeyphrases.LLMKeyPhraseExtractor(
        complete=__import__("radzero_tpu.preprocess.llm_client", fromlist=["x"])
        .OpenAIChatClient(mock_server))
    jkeyphrases.extract_key_phrases(records, jextractor, str(tmp_path / "jax"), batch_size=4)
    for b in range(2):
        name = f"batch_{b}.json"
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_llm_quarantine_file(mock_server, tmp_path):
    """A record whose replies never parse lands in failed.json, as in JAX."""
    _Handler.malformed = 100
    extractor = LLMKeyPhraseExtractor(complete=OpenAIChatClient(mock_server), max_retries=2)
    out = extract_key_phrases([{"dicom_id": "a", "findings": "x", "impression": "y"}],
                              extractor, str(tmp_path))
    assert out[0]["key_phrases"] == []
    assert json.loads((tmp_path / "failed.json").read_text()) == [
        {"findings": "x", "impression": "y"}]


# ---------------------------------------------------------------------------
# both CLIs, in subprocesses
# ---------------------------------------------------------------------------

CLI_REPORT = """FINDINGS: There is a left lower lobe opacity. No pleural effusion.

IMPRESSION: Left lower lobe pneumonia.
"""


def _mimic_tree(tmp_path):
    reports = tmp_path / "reports" / "files" / "p10" / "p1000"
    reports.mkdir(parents=True)
    for sid in (500, 501):
        (reports / f"s{sid}.txt").write_text(CLI_REPORT)
    (reports / "s502.txt").write_text("INDICATION: none.\n")
    _write(tmp_path / "split.csv", ["dicom_id", "study_id", "subject_id", "split"],
           [["d1", "500", "1000", "train"], ["d2", "501", "1000", "train"],
            ["d3", "500", "1000", "validate"], ["d4", "502", "1000", "train"]])
    _write(tmp_path / "meta.csv", ["dicom_id", "ViewPosition"],
           [["d1", "PA"], ["d2", ""], ["d3", "PA"], ["d4", "AP"]])


def _cli(module, tmp_path, out, *extra):
    return subprocess.run(
        [sys.executable, "-m", module,
         "--reports_root", str(tmp_path / "reports"),
         "--split_csv", str(tmp_path / "split.csv"),
         "--metadata_csv", str(tmp_path / "meta.csv"),
         "--output_dir", str(out), *extra],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300,
    )


def test_preprocess_cli(tmp_path):
    """The mirror of tests/test_preprocess_cli.py, and the JAX CLI's files
    byte for byte (records, {split}.json, the batch files)."""
    _mimic_tree(tmp_path)
    res = _cli("radzero_torch.cli.preprocess", tmp_path, tmp_path / "port", "--device", "cpu")
    assert res.returncode == 0, res.stderr[-2000:]
    jres = _cli("radzero_tpu.cli.preprocess", tmp_path, tmp_path / "jax")
    assert jres.returncode == 0, jres.stderr[-2000:]

    out = tmp_path / "port"
    train = json.load(open(out / "train.json"))
    val = json.load(open(out / "validate.json"))
    assert len(train) == 2 and len(val) == 1
    rec = train[0]
    assert rec["dicom_id"].endswith(".jpg")
    assert rec["view_position"] == "PA" and "NaN" in (out / "train.json").read_text()
    assert any("pneumonia" in p.lower() or "opacity" in p.lower() for p in rec["key_phrases"])
    files = sorted(str(p.relative_to(out)) for p in out.rglob("*.json"))
    assert files == sorted(str(p.relative_to(tmp_path / "jax"))
                           for p in (tmp_path / "jax").rglob("*.json"))
    assert "keyphrase_batches_train/batch_0.json" in files
    for f in files:
        assert (out / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_preprocess_cli_device_cuda_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _mimic_tree(tmp_path)
    res = _cli("radzero_torch.cli.preprocess", tmp_path, tmp_path / "out")
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("mode", ["rule", "llm"])
def test_preprocess_clis_write_the_pinned_files(mode, tmp_path):
    """Both CLIs on chip_smoke.py phase 10's synthetic reports tree write the
    files whose sha256 that phase holds the card's host to; the LLM run goes
    through the mock chat server (a malformed first reply, two quarantined
    records) with the pinned number of requests."""
    import chip_smoke
    from radzero_torch.tools.synthetic_reports import MockChat, build_reports_tree

    tree = build_reports_tree(str(tmp_path / "mimic"), chip_smoke.PREPROCESS_N, 0)
    flags = [a for k, v in tree.items() for a in (f"--{k}", v)]
    pinned = chip_smoke.PREPROCESS_SHA256[mode]
    for module, extra in (("radzero_torch.cli.preprocess", ["--device", "cpu"]),
                          ("radzero_tpu.cli.preprocess", [])):
        out = tmp_path / module
        with MockChat() as chat:
            llm = ["--extractor", "llm", "--llm_endpoint", chat.url] if mode == "llm" else []
            res = subprocess.run([sys.executable, "-m", module, *flags, "--output_dir", str(out),
                                  *llm, *extra], capture_output=True, text=True, env=_env(),
                                 cwd=REPO, timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
        assert chip_smoke.sha256_of(out, pinned) == pinned, module
        if mode == "llm":
            assert len(chat.requests) == chip_smoke.PREPROCESS_LLM_REQUESTS
            assert len(json.loads((out / "keyphrase_batches_train" / "failed.json")
                                  .read_text())) == 2
