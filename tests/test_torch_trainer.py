"""The port's training runtime on the CPU: RadZeroTrainer, checkpoints and
the profiling helpers.

The cases of tests/test_trainer.py and tests/test_predict_and_profiling.py
and test_review_fixes_r3.py::test_trainer_rejects_tower_cache_without_
stable_sharding against radzero_torch (``device="cpu"``, D = 32, 28 px,
one layer each), then:

- a parity test: the JAX RadZeroTrainer and the port's over 3 epochs from
  the same weights (bridged with params_from_jax) on the same records, in
  fp32: every per-step record and every eval loss at the trajectory
  test's rtol 1e-4 / atol 1e-6 (test_torch_train.py), the same best
  checkpoint, surviving checkpoints and trainer_state.json counters;
- resume: a run stopped at the first step record of epoch 3 and resumed by
  a fresh trainer gives an uninterrupted run's losses and final weights
  bit for bit;
- checkpoints: the state round-trips bit for bit, a mismatched target
  raises, and a save interrupted before its rename leaves the previous
  checkpoint the last;
- ``gradient_checkpointing=True`` gives the same losses and weights bit for
  bit over 2 epochs.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from radzero_torch.data import pipeline as tpipe
from radzero_torch.data.pipeline import PackSpec, TrainLoader
from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
from radzero_torch.models import configuration as tconf
from radzero_torch.train import checkpoint as ckpt
from radzero_torch.train.checkpoint import (
    checkpoint_dir,
    get_last_checkpoint,
    list_checkpoints,
    load_trainer_state,
    restore_checkpoint,
    save_checkpoint,
)
from radzero_torch.train.optim import build_optimizer, tree_leaves
from radzero_torch.train.trainer import RadZeroTrainer, TrainerArgs
from radzero_torch.utils.profiling import StepTimer, debug_flags, speed_metrics, trace

D = 32


def _cfg(m):
    return m.RadZeroConfig(
        vision=m.ViTConfig(
            hidden_size=D, num_hidden_layers=1, num_attention_heads=2, mlp_ratio=2.0,
            patch_size=14, pretrain_img_size=28, img_size=28,
        ),
        text=m.TextConfig(
            hidden_size=D, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
            vocab_size=5003, max_position_embeddings=40,
        ),
        align=m.AlignConfig(hidden_size=D, num_hidden_layers=1, num_attention_heads=2,
                            mlp_ratio=2.0),
        loss=m.LossConfig(hidden_dim=D),
    )


CFG = _cfg(tconf)


def _records(n=16):
    rng = np.random.default_rng(0)
    recs, images = [], {}
    for i in range(n):
        recs.append({"key_phrases": [f"finding alpha {i}", f"observation beta {i}"], "image": i})
        images[i] = rng.standard_normal((28, 28, 3)).astype(np.float32) * 0.5 + 0.2 * i / n
    return recs, (lambda rec: images[rec["image"]])


def _loaders(n=16, batch=8, pipeline=tpipe, tokenizer=WhitespaceHashTokenizer):
    recs, image_loader = _records(n)
    tok = tokenizer(vocab_size=5003, max_length=10)
    spec = pipeline.PackSpec(max_sentences_per_image=2, max_text_tokens=10)
    train = pipeline.TrainLoader(recs, image_loader, tok, batch, spec, seed=0, num_threads=2)
    evalset = pipeline.TrainLoader(recs[:8], image_loader, tok, batch, spec, seed=0,
                                   shuffle=False, num_threads=2)
    return train, evalset


def _trainer(args, train=None, evalset=None, **kw):
    if train is None:
        train, evalset = _loaders()
    return RadZeroTrainer(CFG, args, train, evalset, device="cpu", **kw)


# ---------------------------------------------------------------------------
# tests/test_trainer.py
# ---------------------------------------------------------------------------

def test_trainer_trains_checkpoints_and_selects_best(tmp_path):
    args = TrainerArgs(output_dir=str(tmp_path), num_train_epochs=3, warmup_steps=1,
                       logging_steps=1, bf16=False, learning_rate=3e-4,
                       early_stopping_patience=5)
    trainer = _trainer(args)
    state = trainer.train()
    assert state.step == 3 * len(trainer.train_loader)
    assert state.best_checkpoint is not None
    assert len(list_checkpoints(str(tmp_path))) == 3
    assert [r for r in state.log_history if "t2i_loss" in r], "per-step sub-losses missing"
    eval_logs = [r for r in state.log_history if "eval_loss" in r]
    assert len(eval_logs) == 3
    assert eval_logs[-1]["eval_loss"] < eval_logs[0]["eval_loss"] + 0.5
    assert all(p.device.type == "cpu" for p in tree_leaves(trainer.trainable))


def test_trainer_resume(tmp_path):
    train, evalset = _loaders()
    args = TrainerArgs(output_dir=str(tmp_path), num_train_epochs=1, warmup_steps=1,
                       logging_steps=100, bf16=False)
    t1 = _trainer(args, train, evalset)
    t1.train()
    assert get_last_checkpoint(str(tmp_path)) is not None
    t2 = _trainer(dataclasses.replace(args, num_train_epochs=2), train, evalset)
    t2.maybe_resume(True)
    assert t2.state.step == t1.state.step
    assert t2.state.epoch == 1
    assert train.epoch == 1  # the loader's data order continues from epoch 1
    assert t2.train(resume_from_checkpoint=False).epoch == 2


def test_fresh_train_does_not_auto_resume(tmp_path):
    args = TrainerArgs(output_dir=str(tmp_path), num_train_epochs=1, warmup_steps=1,
                       logging_steps=100, bf16=False)
    _trainer(args).train()
    assert get_last_checkpoint(str(tmp_path)) is not None
    t2 = _trainer(args)
    t2.maybe_resume(None)
    assert t2.state.step == 0 and t2.state.epoch == 0
    assert t2.train().epoch == 1


def test_early_stopping(tmp_path):
    args = TrainerArgs(output_dir=str(tmp_path), num_train_epochs=10, warmup_steps=1000000,
                       logging_steps=100, bf16=False, early_stopping_patience=1,
                       learning_rate=0.0)
    state = _trainer(args).train()
    assert state.epoch < 10


def test_save_total_limit_keeps_best(tmp_path):
    args = TrainerArgs(output_dir=str(tmp_path), num_train_epochs=4, warmup_steps=1,
                       logging_steps=100, bf16=False, save_total_limit=1,
                       early_stopping_patience=10)
    state = _trainer(args).train()
    kept = list_checkpoints(str(tmp_path))
    assert 1 <= len(kept) <= 2
    assert state.best_checkpoint in kept


def test_metrics_callback_enrichment_is_durable(tmp_path):
    args = TrainerArgs(output_dir=str(tmp_path), num_train_epochs=1, warmup_steps=1,
                       logging_steps=1, bf16=False, early_stopping_patience=5)

    def enrich(rec):
        if "loss" in rec:
            rec["enriched_field"] = 123.0

    _trainer(args, metrics_callback=enrich).train()
    with open(os.path.join(str(tmp_path), "log_history.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    step_recs = [r for r in recs if "loss" in r and "step" in r]
    assert step_recs
    assert all(r.get("enriched_field") == 123.0 for r in step_recs)


def test_metrics_callback_raise_still_persists_record(tmp_path):
    args = TrainerArgs(output_dir=str(tmp_path), num_train_epochs=1, warmup_steps=1,
                       logging_steps=1, bf16=False)

    def guard(rec):
        if "loss" in rec:
            rec["guard_saw"] = True
            raise AssertionError("synthetic NaN guard")

    with pytest.raises(AssertionError, match="synthetic NaN guard"):
        _trainer(args, metrics_callback=guard).train()
    with open(os.path.join(str(tmp_path), "log_history.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    step_recs = [r for r in recs if "loss" in r]
    assert len(step_recs) == 1
    assert step_recs[0]["guard_saw"] is True


def test_echo_reports_decoded_sample_rate(tmp_path):
    rng = np.random.default_rng(0)
    recs, images = [], {}
    for i in range(8):
        recs.append({"key_phrases": [f"finding alpha {i}"], "image": i})
        images[i] = rng.standard_normal((28, 28, 3)).astype(np.float32)
    tok = WhitespaceHashTokenizer(vocab_size=5003, max_length=10)
    spec = PackSpec(max_sentences_per_image=1, max_text_tokens=10)
    train = TrainLoader(recs, lambda r: images[r["image"]], tok, 8, spec, seed=0,
                        num_threads=2, echo=3)
    evalset = TrainLoader(recs, lambda r: images[r["image"]], tok, 8, spec, seed=0,
                          shuffle=False, num_threads=2)
    args = TrainerArgs(output_dir=str(tmp_path), num_train_epochs=1, warmup_steps=1,
                       logging_steps=10, bf16=False)
    state = _trainer(args, train, evalset).train()
    epoch_recs = [r for r in state.log_history if "train_samples_per_second" in r]
    assert len(epoch_recs) == 1
    rec = epoch_recs[0]
    assert rec["train_decoded_samples_per_second"] == pytest.approx(
        rec["train_samples_per_second"] / 3)


def test_pruning_improving_epochs_keep_newest_rollback(tmp_path):
    out = str(tmp_path)
    state = {"w": torch.zeros(2)}

    def names():
        return sorted(os.path.basename(p) for p in list_checkpoints(out))

    for step in (1, 2, 3):
        save_checkpoint(out, step, state, {}, save_total_limit=2,
                        best_path=checkpoint_dir(out, step))
    assert names() == ["checkpoint-2", "checkpoint-3"]
    best = checkpoint_dir(out, 3)
    save_checkpoint(out, 4, state, {}, save_total_limit=2, best_path=best)
    assert names() == ["checkpoint-3", "checkpoint-4"]
    save_checkpoint(out, 5, state, {}, save_total_limit=2, best_path=best)
    assert names() == ["checkpoint-3", "checkpoint-5"]


def test_checkpoint_meta_carries_current_best(tmp_path):
    args = TrainerArgs(output_dir=str(tmp_path), num_train_epochs=1, warmup_steps=1,
                       logging_steps=100, bf16=False)
    state = _trainer(args).train()
    last = get_last_checkpoint(str(tmp_path))
    meta = load_trainer_state(last)
    assert meta["best_checkpoint"] == state.best_checkpoint
    assert os.path.abspath(meta["best_checkpoint"]) == os.path.abspath(last)
    assert meta["best_metric"] == state.best_metric


# ---------------------------------------------------------------------------
# tests/test_predict_and_profiling.py
# ---------------------------------------------------------------------------

def test_speed_metrics():
    t0 = time.perf_counter() - 2.0
    m = speed_metrics("train", t0, num_samples=100, num_steps=10)
    assert m["train_samples_per_second"] > 0
    assert m["train_steps_per_second"] > 0


def test_step_timer():
    t = StepTimer()
    with t:
        time.sleep(0.01)
    with t:
        time.sleep(0.01)
    assert t.count == 2 and t.mean >= 0.009


def test_trace_noop_and_chrome_trace(tmp_path):
    with trace(None):
        pass
    with trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_debug_flags_set_torch_modes():
    before = (torch.is_anomaly_enabled(), torch.are_deterministic_algorithms_enabled(),
              torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        debug_flags(nans=True, deterministic=True)
        assert torch.is_anomaly_enabled()
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.autograd.set_detect_anomaly(before[0])
        torch.use_deterministic_algorithms(before[1])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before[2:]


def test_trainer_predict_loop(tmp_path):
    from radzero_torch.models.radzero import compute_logits, forward_vision

    cfg = dataclasses.replace(CFG, text=dataclasses.replace(CFG.text, vocab_size=101))
    recs = [{"key_phrases": [f"finding {i}"], "image": i} for i in range(16)]
    tok = WhitespaceHashTokenizer(vocab_size=101, max_length=8)
    loader = TrainLoader(recs, lambda r: np.full((28, 28, 3), 0.01 * r["image"], np.float32),
                         tok, 8, PackSpec(1, 8), shuffle=False, num_threads=1)
    trainer = RadZeroTrainer(cfg, TrainerArgs(output_dir=str(tmp_path), bf16=False), loader,
                             None, device="cpu")

    def inference_step(params, batch):
        v = forward_vision(params, cfg, batch["pixel_values"], dtype=torch.float32)
        return {"image_features": v["image_features"]}

    out = trainer.predict(loader, inference_step)
    assert out["image_features"].shape == (16, 2 * D)
    # a compute_logits step gives compute_logits on the same batch, bit for bit
    step = lambda p, b: compute_logits(p, cfg, b["pixel_values"], b["input_ids"],  # noqa: E731
                                       b["attention_mask"])
    got = trainer.predict(loader, step)
    batch = next(iter(loader))
    with torch.no_grad():
        ref = step(trainer.params, trainer._put_batch(batch))
    np.testing.assert_array_equal(got["logits"][:8], ref["logits"].numpy())
    np.testing.assert_array_equal(got["similarity_scores"][:8],
                                  ref["similarity_scores"].numpy())


# ---------------------------------------------------------------------------
# port-only behaviour
# ---------------------------------------------------------------------------

def test_trainer_rejects_tower_cache_without_stable_sharding():
    from radzero_torch.train.tower_cache import TowerCache

    class FakeLoader:
        process_count = 2
        stable_sharding = False

        def __len__(self):
            return 1

    args = TrainerArgs(num_train_epochs=1)
    with pytest.raises(ValueError, match="stable_sharding"):
        RadZeroTrainer(CFG, args, FakeLoader(), tower_cache=TowerCache("ram"), device="cpu")


def test_trainer_gradient_checkpointing_gives_the_same_losses(tmp_path):
    """gradient_checkpointing=True (the step's remat) trains: over 2 epochs
    every step and eval record's losses and the final weights equal, bit
    for bit, those of the same run without it."""
    runs = []
    for remat in (False, True):
        args = TrainerArgs(output_dir=str(tmp_path / str(remat)), num_train_epochs=2,
                           warmup_steps=1, logging_steps=1, bf16=False, learning_rate=3e-4,
                           gradient_checkpointing=remat)
        t = _trainer(args)
        t.train()
        losses = [{k: v for k, v in r.items() if "loss" in k or k == "grad_norm"}
                  for r in t.state.log_history]
        runs.append((losses, tree_leaves(t.trainable)))
    (l0, w0), (l1, w1) = runs
    assert sum("loss" in r for r in l1) >= 4
    assert l1 == l0
    assert all(torch.equal(a, b) for a, b in zip(w0, w1))


def test_trainer_weights_from_seed_and_given_params_not_mutated(tmp_path):
    """params=None builds the weights from args.seed (the same seed, the
    same weights); given params are copied, so training leaves them as they
    were."""
    args = TrainerArgs(output_dir=str(tmp_path), num_train_epochs=1, warmup_steps=1,
                       logging_steps=100, bf16=False, learning_rate=1e-3, seed=3)
    a, b = _trainer(args), _trainer(args)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
    before = [t.clone() for t in tree_leaves(a.trainable)]
    given = a.trainable
    c = _trainer(args, params={**a.params})
    c.train()
    assert all(torch.equal(x, y) for x, y in zip(before, tree_leaves(given)))
    assert not all(torch.equal(x, y) for x, y in zip(before, tree_leaves(c.trainable)))


# ---------------------------------------------------------------------------
# parity with the JAX trainer
# ---------------------------------------------------------------------------

def test_trainer_matches_jax_trainer(tmp_path):
    """3 epochs, fp32, save_total_limit=2, logging_steps=1, from the JAX
    init (seed 42) bridged with params_from_jax. Per-step records (every
    sub-loss, grad_norm, lr, step, epoch) and eval losses at rtol 1e-4 /
    atol 1e-6; the same best checkpoint, surviving checkpoints and
    trainer_state.json step / epoch / patience_left."""
    import jax

    from radzero_torch.models.from_jax import params_from_jax
    from radzero_tpu.data import pipeline as jpipe
    from radzero_tpu.data.tokenizer import WhitespaceHashTokenizer as JaxTok
    from radzero_tpu.models import configuration as jconf
    from radzero_tpu.models.radzero import init_radzero as jax_init
    from radzero_tpu.parallel.mesh import create_mesh
    from radzero_tpu.train.checkpoint import list_checkpoints as jax_list
    from radzero_tpu.train.trainer import RadZeroTrainer as JaxTrainer
    from radzero_tpu.train.trainer import TrainerArgs as JaxArgs

    kw = dict(num_train_epochs=3, warmup_steps=1, logging_steps=1, bf16=False,
              learning_rate=3e-4, save_total_limit=2, early_stopping_patience=2)
    jcfg = _cfg(jconf)
    weights = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(42), jcfg))
    jtrain, jeval = _loaders(pipeline=jpipe, tokenizer=JaxTok)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    mesh = create_mesh({"data": 1}, devices=jax.devices()[:1])
    jt = JaxTrainer(jcfg, JaxArgs(output_dir=jdir, **kw), jtrain, jeval, params=weights,
                    mesh=mesh)
    jstate = jt.train()
    ttrain, teval = _loaders()
    tt = RadZeroTrainer(CFG, TrainerArgs(output_dir=tdir, **kw), ttrain, teval,
                        params=params_from_jax(weights), device="cpu")
    tstate = tt.train()

    skip = {"train_samples_per_second"}
    assert len(tstate.log_history) == len(jstate.log_history) == 9
    for want, got in zip(jstate.log_history, tstate.log_history):
        assert sorted(got) == sorted(want)
        for k in want:
            if k in skip:
                continue
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    names = lambda ps: [os.path.basename(p) for p in ps]  # noqa: E731
    assert names(list_checkpoints(tdir)) == names(jax_list(jdir))
    assert os.path.basename(tstate.best_checkpoint) == os.path.basename(jstate.best_checkpoint)
    for path in list_checkpoints(tdir):
        got = load_trainer_state(path)
        want = load_trainer_state(os.path.join(jdir, os.path.basename(path)))
        for k in ("step", "epoch", "patience_left"):
            assert got[k] == want[k], k
        assert os.path.basename(got["best_checkpoint"]) == os.path.basename(
            want["best_checkpoint"])


# ---------------------------------------------------------------------------
# resume, bit for bit
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


def test_resumed_run_equals_uninterrupted_run_bit_for_bit(tmp_path):
    """Run B is stopped by its callback at the first step record of epoch 3
    (after checkpoint-4); a fresh trainer resumes from the last checkpoint.
    Its step records and final weights equal run A's exactly, and run B's
    records before the stop equal A's too (two runs give the same bits).
    The sizes keep MPNet's embedding gradient (an accumulating index put)
    on torch's serial CPU path: from 32768 elements on, the CPU adds the
    duplicate rows in thread order and its bits vary from run to run."""
    kw = dict(num_train_epochs=3, warmup_steps=1, logging_steps=1, bf16=False,
              learning_rate=3e-4, save_total_limit=2, load_best_model_at_end=False)
    a = _trainer(TrainerArgs(output_dir=str(tmp_path / "a"), **kw))
    a.train()

    def stop(rec):
        if "loss" in rec and rec["epoch"] == 2:
            raise _Stop

    bdir = str(tmp_path / "b")
    with pytest.raises(_Stop):
        _trainer(TrainerArgs(output_dir=bdir, **kw), metrics_callback=stop).train()
    assert os.path.basename(get_last_checkpoint(bdir)) == "checkpoint-4"
    with open(os.path.join(bdir, "log_history.jsonl")) as f:
        b_recs = [json.loads(line) for line in f]
    c = _trainer(TrainerArgs(output_dir=bdir, **kw))
    state = c.train(resume_from_checkpoint=True)
    assert state.step == 6 and state.epoch == 3

    steps = lambda h: [r for r in h if "loss" in r]  # noqa: E731
    a_steps = steps(a.state.log_history)
    assert steps(b_recs) == a_steps[:5]       # up to and including the stopping record
    assert steps(c.state.log_history) == a_steps[4:]
    assert [r["eval_loss"] for r in c.state.log_history if "eval_loss" in r] == [
        r["eval_loss"] for r in a.state.log_history if "eval_loss" in r][2:]
    for x, y in zip(tree_leaves(a.trainable), tree_leaves(c.trainable)):
        assert torch.equal(x, y)
    assert a.opt_state["count"] == c.opt_state["count"] == 6
    for x, y in zip(a.opt_state["mu"] + a.opt_state["nu"], c.opt_state["mu"] + c.opt_state["nu"]):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state(bf16_moments, accum, seed=0):
    g = torch.Generator().manual_seed(seed)
    trainable = {"a": {"kernel": torch.randn(4, 6, generator=g), "bias": torch.randn(6, generator=g)},
                 "layers": [{"w": torch.randn(3, generator=g)} for _ in range(2)]}
    opt, _ = build_optimizer(warmup_steps=1, total_steps=10, bf16_moments=bf16_moments,
                             gradient_accumulation_steps=accum)
    state = opt.init(trainable)
    for _ in range(3):
        grads = [torch.randn(p.shape, generator=g) for p in tree_leaves(trainable)]
        state = opt.update(grads, state, trainable)
    return {"trainable": trainable, "opt_state": state}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree) if isinstance(tree, torch.Tensor) else 0


@pytest.mark.parametrize("bf16_moments", [False, True])
@pytest.mark.parametrize("accum", [1, 2])
def test_checkpoint_round_trip_bit_for_bit(tmp_path, bf16_moments, accum):
    state = _state(bf16_moments, accum)
    assert ("acc_grads" in state["opt_state"]) == (accum > 1)
    path = save_checkpoint(str(tmp_path), 3, state, {"step": 3})
    assert os.path.basename(path) == "checkpoint-3"
    assert sorted(os.listdir(path)) == ["state.pt", "trainer_state.json"]
    got = restore_checkpoint(path, _zeros_like(state))
    want_leaves, got_leaves = tree_leaves(state), tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    for x, y in zip(want_leaves, got_leaves):
        if isinstance(x, torch.Tensor):
            assert y.dtype == x.dtype and y.device.type == "cpu" and torch.equal(x, y)
        else:
            assert x == y
    if bf16_moments:
        assert got["opt_state"]["mu"][0].dtype == torch.bfloat16


def test_restore_raises_on_mismatch_and_missing_checkpoint(tmp_path):
    state = _state(False, 1)
    path = save_checkpoint(str(tmp_path), 1, state, {})
    wrong_shape = _zeros_like(state)
    wrong_shape["trainable"]["a"]["kernel"] = torch.zeros(6, 4)
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(path, wrong_shape)
    wrong_tree = _zeros_like(state)
    wrong_tree["trainable"]["extra"] = torch.zeros(1)
    with pytest.raises(ValueError, match="differs"):
        restore_checkpoint(path, wrong_tree)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "checkpoint-9"), _zeros_like(state))


def test_save_interrupted_before_rename_keeps_previous_checkpoint(tmp_path, monkeypatch):
    out = str(tmp_path)
    state = _state(False, 1)
    save_checkpoint(out, 1, state, {"step": 1})

    def killed(src, dst):
        raise _Stop

    monkeypatch.setattr(ckpt.os, "rename", killed)
    with pytest.raises(_Stop):
        save_checkpoint(out, 2, state, {"step": 2})
    assert os.path.isdir(os.path.join(out, "checkpoint-2.tmp"))  # the half checkpoint
    assert os.path.basename(get_last_checkpoint(out)) == "checkpoint-1"
    monkeypatch.undo()
    save_checkpoint(out, 2, state, {"step": 2})
    assert sorted(os.listdir(out)) == ["checkpoint-1", "checkpoint-2"]
    assert load_trainer_state(get_last_checkpoint(out)) == {"step": 2}
