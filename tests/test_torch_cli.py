"""The port's training entry point, ``python -m radzero_torch.cli.run``, on the CPU.

- end to end in a subprocess with ``--device cpu`` on the tiny workspace of
  tests/test_cli_end_to_end.py, with its assertions (4 optimizer steps
  under ``echo: 2``, Chexpert in the classification result.json), plus the
  run's snapshot files;
- a tiny run with ``gradient_checkpointing: true``, in process: the same
  log_history losses, bit for bit, as the same run without it;
- in process and without training: what the CLI builds from the radzero
  preset (model config, loss heads, weights' shapes, image processor,
  tokenizer, PackSpec, the loaders' arguments, TrainerArgs) against what
  the JAX CLI builds, field by field, with the datasets, loaders and
  trainer of both CLIs replaced by recorders. The JAX CLI itself is not run
  again here (tests/test_cli_end_to_end.py runs it);
- ``--device cuda`` without a card raises, and a mesh over several devices
  raises.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

import radzero_tpu.cli.run as jcli
import radzero_torch.cli.run as tcli
from radzero_torch.models.from_jax import params_from_jax, params_to_numpy

from test_cli_end_to_end import workspace  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _steps_and_losses(out_dir):
    rows = [json.loads(line) for line in open(out_dir / "log_history.jsonl")]
    return [(r["step"], r["loss"]) for r in rows if "step" in r and "loss" in r]


def test_cli_train_and_eval_on_cpu(workspace):  # noqa: F811
    root, cfg_path = workspace
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-m", "radzero_torch.cli.run", "--cfg_path", str(cfg_path),
         "--train", "true", "--inference", "true", "--no_report", "--device", "cpu",
         "--name", "torch_smoke"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    out_dir = root / "out" / "pt" / "debug" / "torch_smoke"
    assert (out_dir / "output.log").exists()
    for name in ("git_diff.patch", "last_commit.json", "config.yaml"):
        assert (out_dir / "snapshot" / name).exists(), name
    assert [d for d in os.listdir(out_dir) if d.startswith("checkpoint-")], os.listdir(out_dir)
    result = out_dir / "inference" / "classification" / "result.json"
    assert result.exists(), res.stdout[-2000:]
    assert "Chexpert" in json.load(open(result))
    # train.echo=2: 2 decoded batches (16 records / batch 8) x echo 2 = 4 steps
    steps = [s for s, _ in _steps_and_losses(out_dir)]
    assert max(steps) == 4, steps


def test_cli_gradient_checkpointing_gives_the_same_losses(workspace, tmp_path):  # noqa: F811
    root, cfg_path = workspace
    cfg = yaml.safe_load(open(cfg_path))
    cfg["experiment"]["output_root_dir"] = str(tmp_path)
    runs = {}
    for remat in (False, True):
        cfg["train"]["gradient_checkpointing"] = remat
        path = tmp_path / f"remat_{remat}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        name = f"remat_{remat}"
        assert tcli.main(["--cfg_path", str(path), "--inference", "false", "--no_report",
                          "--device", "cpu", "--name", name]) == 0
        runs[remat] = _steps_and_losses(tmp_path / "pt" / "debug" / name)
    assert len(runs[True]) == 4
    assert runs[True] == runs[False]


class _Recorder:
    """Stands in for TrainLoader / RadZeroTrainer: records its arguments."""

    def __init__(self, log, name):
        self.log, self.name = log, name

    def __call__(self, *args, **kwargs):
        self.log.setdefault(self.name, []).append((args, kwargs))
        return self

    def train(self, resume_from_checkpoint=None):
        self.log["resume"] = resume_from_checkpoint

    def __len__(self):
        return 1

    @property
    def params(self):
        return self.log["trainer"][0][1]["params"]


def _record(monkeypatch, cli, records):
    log = {}
    monkeypatch.setattr(cli, "load_datasets", lambda cfg, train=True: {
        "train": records, "eval": records[:4]})
    monkeypatch.setattr(cli, "TrainLoader", _Recorder(log, "loader"))
    monkeypatch.setattr(cli, "RadZeroTrainer", _Recorder(log, "trainer"))
    return log


def test_cli_builds_what_the_jax_cli_builds(tmp_path, monkeypatch):
    """The radzero preset with an overlay of paths, the JAX mesh over one
    device (the port's one card), no hub tokenizer (the hash tokenizer on both sides;
    nothing reaches for the network) and one layer a tower (the widths stay
    the preset's)."""
    overlay = {
        "experiment": {"output_root_dir": str(tmp_path / "out"), "report_to": "none"},
        "dataset": {"data_root": str(tmp_path)},
        "train": {"echo": 2},
        "model": {"model_config": {
            "vision_config": {"num_hidden_layers": 1},
            "text_config": {"num_hidden_layers": 1, "pretrained_tokenizer_name_or_path": None},
            "align_transformer_config": {"num_hidden_layers": 1}}},
    }
    path = tmp_path / "overlay.yaml"
    path.write_text(yaml.safe_dump(overlay))
    records = [{"image": f"{i}.png", "key_phrases": ["a"]} for i in range(8)]
    monkeypatch.setattr(jcli, "enable_compilation_cache", lambda: None)
    create_mesh = jcli.create_mesh
    monkeypatch.setattr(jcli, "create_mesh",
                        lambda axes: create_mesh(axes, devices=jax.devices()[:1]))
    jlog, tlog = _record(monkeypatch, jcli, records), _record(monkeypatch, tcli, records)
    argv = ["--add_cfg_list", "radzero", str(path), "--inference", "false", "--no_report"]
    monkeypatch.setattr(sys, "argv", ["run"] + argv + ["--name", "jax"])
    jcli.main()
    assert tcli.main(argv + ["--name", "torch", "--device", "cpu"]) == 0

    (jargs, jkw), = jlog["trainer"]
    (targs, tkw), = tlog["trainer"]
    # model config, TrainerArgs: every field (the dataclasses have the same fields)
    assert dataclasses.asdict(targs[0]) == dataclasses.asdict(jargs[0])
    j_ta, t_ta = dataclasses.asdict(jargs[1]), dataclasses.asdict(targs[1])
    assert t_ta["gradient_checkpointing"] is True
    assert j_ta.pop("output_dir").endswith("/jax") and t_ta.pop("output_dir").endswith("/torch")
    assert t_ta == j_ta
    # the weights: the same tree, leaf for leaf in shape
    jtree = params_to_numpy(params_from_jax(jax_tree_to_numpy(jkw["params"])))
    ttree = params_to_numpy(tkw["params"])
    assert _shapes(ttree) == _shapes(jtree)
    assert jkw.get("tower_cache") is None and tkw.get("tower_cache") is None
    # the loaders: records, batch sizes, PackSpec and keywords
    for (ja, jk), (ta, tk) in zip(jlog["loader"], tlog["loader"]):
        assert ta[0] == ja[0] and ta[3] == ja[3]
        assert dataclasses.asdict(ta[4]) == dataclasses.asdict(ja[4])
        assert type(ta[2]).__name__ == type(ja[2]).__name__  # the tokenizer
        assert tk == jk
    assert tlog["loader"][0][0][3] == 64 and tlog["loader"][0][1]["echo"] == 2
    assert tlog["resume"] == jlog["resume"]
    # build_everything: processor, loss heads
    jb = jcli.build_everything(jcli.Config(_ns(argv)).config)
    tb = tcli.build_everything(tcli.Config(_ns(argv, device="cpu")).config, device="cpu")
    assert type(tb[2]).__name__ == type(jb[2]).__name__
    assert vars(tb[2]) == vars(jb[2])
    assert tb[4:] == jb[4:]


def jax_tree_to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        return {k: _shapes(v, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tree.shape


def _ns(argv, **extra):
    ns = tcli.parse_args(argv)
    for k, v in extra.items():
        setattr(ns, k, v)
    return ns


def test_cli_refuses_a_missing_card_and_a_mesh(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--inference", "false", "--train", "false"])
    with pytest.raises(NotImplementedError, match="item 6"):
        tcli.check_mesh({"data": 4})
    tcli.check_mesh({"data": -1})
    tcli.check_mesh({"data": 1})
