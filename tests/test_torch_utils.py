"""The port's copies of the framework-free helpers: radzero_torch.utils.json_io
against radzero_tpu.utils.json_io (same file, byte for byte), and the
logger's process gate, which reads RANK / LOCAL_RANK where the JAX copy
asks jax.process_index()."""

import logging

import numpy as np
import pytest

from radzero_torch.utils import json_io
from radzero_torch.utils import logging as tlog

from radzero_tpu.utils import json_io as jax_json_io


def test_json_io_matches_the_jax_copy(tmp_path):
    data = {"a": np.int64(3), "b": np.float32(0.25), "c": np.arange(4, dtype=np.int32),
            "d": [1, "x", None], "e": {"f": np.float64(1e-3)}}
    ours, ref = tmp_path / "ours.json", tmp_path / "ref.json"
    json_io.save_json(data, str(ours))
    jax_json_io.save_json(data, str(ref))
    assert ours.read_bytes() == ref.read_bytes()
    assert json_io.load_json(str(ours)) == jax_json_io.load_json(str(ref))
    with pytest.raises(TypeError):
        json_io.save_json({"x": object()}, str(tmp_path / "bad.json"))


@pytest.mark.parametrize("env,main", [({}, True), ({"RANK": "0"}, True), ({"RANK": "3"}, False),
                                      ({"LOCAL_RANK": "1"}, False),
                                      ({"RANK": "0", "LOCAL_RANK": "1"}, True)])
def test_logger_emits_on_the_main_process_only(monkeypatch, capsys, env, main):
    for var in ("RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    name = "radzero_torch_test_" + "_".join(f"{k}{v}" for k, v in sorted(env.items()))
    log = tlog.load_logger(name)  # a logger of its own: its handler holds this test's stdout
    assert log is tlog.load_logger(name)  # configured once
    log.info("hello there")
    out = capsys.readouterr().out
    if main:
        assert out.rstrip().endswith("INFO] hello there")
    else:
        assert out == ""


def test_logger_mirrors_to_a_file(tmp_path, monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    log = tlog.load_logger("radzero_torch_test_file")
    path = tmp_path / "exp" / "output.log"
    tlog.set_logger_file(str(path), log)
    log.warning("to the file")
    for h in log.handlers:
        h.flush()
    assert "WARNING] to the file" in path.read_text()
    assert log.level == logging.INFO and not log.propagate
