"""The port's distributed eval driver (radzero_torch/eval/distributed.py) on
the CPU: the seven cases of tests/test_distributed_eval.py against the
port, the part and result files against the JAX functions' bytes, and a
two-rank run of ``python -m radzero_torch.cli.run`` under torchrun whose
merged ``result.json`` files equal a serial eval of the same weights.

As in the JAX suite, two "processes" of the driver run in one interpreter
for the driver's own cases (rank 1 publishes, then rank 0 merges): the code
path is the one two hosts run over shared storage. The CLI case runs two
real gloo ranks.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from radzero_torch.data.processing import BlipStyleImageProcessor
from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
from radzero_torch.eval import distributed as tdist
from radzero_torch.eval.distributed import (
    DistributedInference,
    merge_partial_results,
    partition_datasets,
    write_partial_result,
)
from radzero_torch.eval.inference import Inference
from radzero_torch.eval.scorer import ZeroShotScorer
from radzero_torch.models import configuration as tconf
from radzero_torch.models.from_jax import params_from_jax
from radzero_torch.tools import synthetic_eval_data as tsd
from radzero_tpu.eval import distributed as jdist
from radzero_tpu.models import configuration as jconf
from radzero_tpu.models.radzero import init_radzero as jax_init_radzero

from test_cli_end_to_end import workspace  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 32


def _cfg(m):
    return m.RadZeroConfig(
        vision=m.ViTConfig(hidden_size=D, num_hidden_layers=1, num_attention_heads=2,
                           mlp_ratio=2.0, patch_size=14, pretrain_img_size=28, img_size=28),
        text=m.TextConfig(hidden_size=D, num_hidden_layers=1, num_attention_heads=2,
                          intermediate_size=64, vocab_size=5003, max_position_embeddings=40),
        align=m.AlignConfig(hidden_size=D, num_hidden_layers=1, num_attention_heads=2,
                            mlp_ratio=2.0),
        loss=m.LossConfig(hidden_dim=D),
    )


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("evaldata"))
    tsd.build_images(root, n=8)
    tsd.build_chexpert(root, n=8)
    tsd.build_chestxdet10(root, n=8)
    tsd.build_mscxr(root, n=4)
    tsd.build_siim(root, n=8)
    tsd.build_rsna(root, n=8)
    return root


@pytest.fixture(scope="module")
def scorer():
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_init_radzero(jax.random.PRNGKey(0), _cfg(jconf))))
    return ZeroShotScorer(params, _cfg(tconf), BlipStyleImageProcessor(size=28),
                          WhitespaceHashTokenizer(vocab_size=5003, max_length=12),
                          batch_size=4, device="cpu")


def _bytes_of(d):
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))}


def test_partition_is_disjoint_exhaustive_deterministic():
    names = ["A", "B", "C", "D", "E"]
    parts = [partition_datasets(names, k, 3) for k in range(3)]
    assert parts == [["A", "D"], ["B", "E"], ["C"]]
    flat = [n for p in parts for n in p]
    assert sorted(flat) == sorted(names)
    with pytest.raises(ValueError):
        partition_datasets(names, 3, 3)
    for p in (1, 2, 3, 7):
        for k in range(p):
            assert partition_datasets(names, k, p) == jdist.partition_datasets(names, k, p)


def test_merge_waits_and_unions(tmp_path):
    for mod, d in ((tdist, tmp_path / "port"), (jdist, tmp_path / "jax")):
        mod.write_partial_result(str(d / "task"), 0, {"A": {"auc": 0.5}})
        mod.write_partial_result(str(d / "task"), 1, {"B": {"auc": 0.7}})
        merged = mod.merge_partial_results(str(d / "task"), 2, timeout_s=5)
        assert merged == {"A": {"auc": 0.5}, "B": {"auc": 0.7}}
    assert _bytes_of(tmp_path / "port" / "task") == _bytes_of(tmp_path / "jax" / "task")
    d = str(tmp_path / "port" / "task")
    assert json.load(open(os.path.join(d, "result.json"))) == merged

    with pytest.raises(TimeoutError, match="missing"):
        merge_partial_results(str(tmp_path / "other"), 1, timeout_s=0.2, poll_s=0.05)

    # a dataset on two ranks is an error, not an overwrite
    d2 = str(tmp_path / "dup")
    write_partial_result(d2, 0, {"A": {"auc": 0.5}})
    write_partial_result(d2, 1, {"A": {"auc": 0.6}})
    with pytest.raises(ValueError, match="multiple ranks"):
        merge_partial_results(d2, 2, timeout_s=5)


def test_merge_ignores_stale_parts_from_previous_run(tmp_path):
    d = str(tmp_path / "task")
    write_partial_result(d, 0, {"A": {"auc": 0.1}}, run_id="old")
    write_partial_result(d, 1, {"B": {"auc": 0.2}}, run_id="old")
    write_partial_result(d, 0, {"A": {"auc": 0.9}}, run_id="new")
    with pytest.raises(TimeoutError, match="stale"):
        merge_partial_results(d, 2, timeout_s=0.3, poll_s=0.05, run_id="new")
    write_partial_result(d, 1, {"B": {"auc": 0.8}}, run_id="new", error="boom")
    merged = merge_partial_results(d, 2, timeout_s=5, run_id="new")
    assert merged == {"A": {"auc": 0.9}, "B": {"auc": 0.8}}
    j = str(tmp_path / "jax")
    jdist.write_partial_result(j, 0, {"A": {"auc": 0.9}}, run_id="new")
    jdist.write_partial_result(j, 1, {"B": {"auc": 0.8}}, run_id="new", error="boom")
    jdist.merge_partial_results(j, 2, timeout_s=5, run_id="new")
    assert _bytes_of(d) == _bytes_of(j)

    d2 = str(tmp_path / "legacy")
    os.makedirs(d2)
    with open(os.path.join(d2, "result.part0.json"), "w") as f:
        json.dump({"A": {"auc": 0.1}}, f)  # the layout before run tokens
    with pytest.raises(TimeoutError):
        merge_partial_results(d2, 1, timeout_s=0.3, poll_s=0.05, run_id="new")


def _dist(data_root, k, n, **kw):
    return DistributedInference(
        ["Chexpert"], ["ChestXDet10", "MS-CXR"], ["SIIM", "RSNA"], data_root,
        batch_size=4, process_index=k, process_count=n, merge_timeout_s=30, **kw)


def test_two_process_eval_matches_serial(data_root, scorer, tmp_path):
    serial = Inference(["Chexpert"], ["ChestXDet10", "MS-CXR"], ["SIIM", "RSNA"], data_root,
                       batch_size=4)
    s_dir, d_dir = tmp_path / "serial", tmp_path / "dist"
    tasks = {"cls": "classification", "det": "grounding", "seg": "segmentation"}
    want = {sub: getattr(serial, task)(scorer, str(s_dir / sub)) for sub, task in tasks.items()}
    r1 = _dist(data_root, 1, 2)
    for sub, task in tasks.items():  # rank 1 publishes first (no merge), then rank 0 merges
        assert getattr(r1, task)(scorer, str(d_dir / sub)) is None
    r0 = _dist(data_root, 0, 2)
    for sub, task in tasks.items():
        got = getattr(r0, task)(scorer, str(d_dir / sub))
        assert got == want[sub]
        assert (d_dir / sub / "result.json").read_bytes() == (
            s_dir / sub / "result.json").read_bytes()
        parts = [json.load(open(d_dir / sub / f"result.part{k}.json")) for k in range(2)]
        assert all(sorted(p) == ["error", "metrics", "run_id"] for p in parts)
        assert parts[0]["run_id"] == parts[1]["run_id"] and not any(p["error"] for p in parts)
    assert sorted(json.load(open(d_dir / "det" / "result.part1.json"))["metrics"]) == ["MS-CXR"]


def test_failed_rank_publishes_error_part_and_merge_proceeds(data_root, scorer, tmp_path,
                                                             monkeypatch):
    d = tmp_path / "det"

    def boom(self, scorer, save_dir, **kw):
        raise RuntimeError("synthetic task failure")

    monkeypatch.setattr(Inference, "grounding", boom)
    assert _dist(data_root, 1, 2).grounding(scorer, str(d)) is None  # an error part
    monkeypatch.undo()
    merged = _dist(data_root, 0, 2).grounding(scorer, str(d))  # no TimeoutError
    assert sorted(merged) == ["ChestXDet10"]
    assert json.load(open(d / "result.json")) == json.loads(json.dumps(merged))
    assert "synthetic task failure" in json.load(open(d / "result.part1.json"))["error"]


def test_params_digest_distinguishes_model_states(scorer):
    from radzero_torch.train.optim import tree_leaves

    d1 = tdist._params_digest(scorer)
    assert d1 == tdist._params_digest(scorer)  # deterministic

    def bumped(tree, done):
        if isinstance(tree, dict):
            return {k: bumped(tree[k], done) for k in sorted(tree)}
        if isinstance(tree, list):
            return [bumped(v, done) for v in tree]
        if tree.is_floating_point() and not done:
            done.append(1)
            return tree + 1.0  # one training step's worth of drift
        return tree

    class S:
        params = bumped(scorer.params, [])

    assert len(tree_leaves(S.params)) == len(tree_leaves(scorer.params))
    assert tdist._params_digest(S()) != d1

    class B:
        params = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                  for k, v in {"w": torch.ones(3), "i": torch.arange(3)}.items()}

    assert len(tdist._params_digest(B())) == 16  # 16-bit leaves digest too

    class N:
        params = None

    assert tdist._params_digest(N()) == "no-params"


def test_fallback_run_id_ignores_parts_from_other_model_state(data_root, scorer, tmp_path,
                                                              monkeypatch):
    d = tmp_path / "cls"
    monkeypatch.setattr(tdist, "_params_digest", lambda s: "ckpt-old")
    assert _dist(data_root, 1, 2).classification(scorer, str(d)) is None
    monkeypatch.setattr(tdist, "_params_digest", lambda s: "ckpt-new")
    r0 = DistributedInference(["Chexpert"], [], [], data_root, batch_size=4,
                              process_index=0, process_count=2, merge_timeout_s=1.0)
    with pytest.raises(TimeoutError, match="stale"):
        r0.classification(scorer, str(d))


def test_auto_mode_reads_the_process_group_and_refuses_half_a_rank(data_root):
    assert not torch.distributed.is_initialized()
    auto = DistributedInference(["Chexpert"], [], [], data_root)
    assert (auto.process_index, auto.process_count, auto.run_id) == (0, 1, "serial")
    with pytest.raises(ValueError, match="BOTH"):
        DistributedInference(["Chexpert"], [], [], data_root, process_index=0)


def test_two_rank_cli_result_matches_serial_eval(workspace, tmp_path):  # noqa: F811
    """torchrun, 2 gloo ranks: train (each rank its shard, rank 0 writing the
    run's files), then the zero-shot suite through DistributedInference;
    every merged result.json equals a serial Inference of the run's final
    weights, byte for byte."""
    from radzero_torch.cli import run as tcli
    from radzero_torch.config.config import Config
    from radzero_torch.train.checkpoint import get_last_checkpoint, load_trainer_state
    from radzero_torch.train.optim import merge_params, partition_params

    ws_root, ws_cfg = workspace
    root = tmp_path / "data"
    shutil.copytree(ws_root / "data" / "MIMIC-CXR", root / "MIMIC-CXR")
    shutil.copytree(ws_root / "data" / "MS-CXR", root / "MS-CXR")
    tsd.build_images(str(root), n=8)
    tsd.build_chexpert(str(root), n=8)
    tsd.build_chestxdet10(str(root), n=8)
    tsd.build_mscxr(str(root), n=4)
    cfg = yaml.safe_load(open(ws_cfg))
    cfg["dataset"]["data_root"] = str(root)
    cfg["experiment"]["output_root_dir"] = str(tmp_path / "out")
    cfg["train"].update(per_device_train_batch_size=4, per_device_eval_batch_size=4,
                        mesh={"data": 2}, echo=1)
    cfg["inference"].update(batch_size=4, cls_dataset=["Chexpert"],
                            det_dataset=["ChestXDet10", "MS-CXR"])
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    argv = ["--cfg_path", str(cfg_path), "--train", "true", "--inference", "true",
            "--no_report", "--device", "cpu", "--name", "ddp"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "radzero_torch.cli.run", *argv],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-6000:]
    out = tmp_path / "out" / "pt" / "debug" / "ddp"
    for name in ("output.log", "snapshot/config.yaml", "log_history.jsonl"):
        assert (out / name).exists(), name
    rows = [json.loads(line) for line in open(out / "log_history.jsonl")]
    # 16 records, 2 ranks x 4 a step: 2 step records and an epoch record, written once
    assert [r["step"] for r in rows if "lr" in r] == [1, 2] and len(rows) == 3
    assert "eval_loss" in rows[-1]

    # the serial eval of the run's final weights (its best checkpoint), one thread as the ranks
    ns = tcli.parse_args(argv)
    run_cfg = Config(ns).config
    model_cfg, params, processor, tokenizer, _, _ = tcli.build_everything(
        run_cfg, seed=run_cfg["train"]["seed"], device="cpu")
    best = load_trainer_state(get_last_checkpoint(str(out)))["best_checkpoint"]
    trainable = torch.load(os.path.join(best, "state.pt"), weights_only=False)["trainable"]
    params = merge_params(trainable, partition_params(params, list(trainable))[1])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scorer = ZeroShotScorer(params, model_cfg, processor, tokenizer, device="cpu",
                                batch_size=4, dtype=torch.float32)
        inf = Inference(["Chexpert"], ["ChestXDet10", "MS-CXR"], [], str(root), batch_size=4)
        serial = tmp_path / "serial"
        inf.classification(scorer, str(serial / "classification"))
        inf.grounding(scorer, str(serial / "grounding"))
    finally:
        torch.set_num_threads(threads)
    for task in ("classification", "grounding"):
        got = out / "inference" / task
        assert (got / "result.json").read_bytes() == (serial / task / "result.json").read_bytes()
        assert (got / "result.part1.json").exists()
    part1 = json.load(open(out / "inference" / "grounding" / "result.part1.json"))
    assert sorted(part1["metrics"]) == ["MS-CXR"]  # rank 1 evaluated its share
