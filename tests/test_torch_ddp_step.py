"""The port's data-parallel training step and trainer on the CPU: two gloo
ranks against the JAX global-view step on a 2-device CPU mesh.

Each rank takes half of a global batch (2 of 4 images, 4 of 8 sentences,
``group_map`` in global indices as the loader writes it) and runs
``make_train_step(..., group=)`` for 3 AdamW steps (fp32, D = 64, eager
layers, the loss on the K10-K12 twins). The JAX side runs
``make_train_step(mesh=...)`` on the concatenated batch
(``tests/test_parallel_train.py``), whose VL-CABS goes through
``shard_map``. Gates, every step: the losses at rtol 1e-5 against the JAX
step's; the averaged gradient tree against ``jax.value_and_grad`` of the
JAX forward over the mesh at the rank's own parameters, per leaf |port -
JAX| <= 2e-4 of the leaf's largest |gradient| + 1e-7 (chip_smoke.py's
phase 6 gate); the two ranks' parameters bit-equal. Cases: the plain
layout, ``dedup_slots`` (each rank's unique block, ``row_gather`` offset
by ``rank * dedup_slots``) and the CLIP loss beside MP-NCE. A factor-of-P
mistake in the gathers or the average moves every gradient by 2x.

The trainer over 2 ranks, each with its loader shard: rank 0 alone writes
``log_history.jsonl`` and the checkpoints; a run stopped at epoch 2 and
resumed from its checkpoint ends with the uninterrupted run's weights, bit
for bit, on both ranks.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radzero_torch.models import configuration as tconf
from radzero_torch.train import optim as toptim
from radzero_torch.train.step import make_train_step

from test_torch_parallel import WORLD, rank_main, run_ranks

D = 64
STEPS = 3
LR = 1e-4
B_RANK, S_PER, T_LEN, U_RANK = 2, 2, 10, 3  # images, sentences each, tokens, unique sentences
TRAINABLE = ("align_transformer", "text_model", "loss_fns")
CASES = ("plain", "dedup", "clip")
LOSSES = {"clip": ("RadZeroLoss", "OpenClipLoss")}
# test_torch_modules.py's sizes (not imported: it imports jax, which the ranks do not)
VIT = dict(hidden_size=D, num_hidden_layers=2, num_attention_heads=4, mlp_ratio=2.0,
           patch_size=14, pretrain_img_size=42, img_size=56)
TEXT = dict(hidden_size=D, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
            vocab_size=211, max_position_embeddings=66)


def _cfg(m, case):
    cfg = m.RadZeroConfig(
        vision=m.ViTConfig(**VIT, attn_impl="xla"),
        text=m.TextConfig(**TEXT, fuse_post=False, use_text_projection=case == "clip"),
        align=m.AlignConfig(hidden_size=D, num_hidden_layers=2, num_attention_heads=4,
                            mlp_ratio=2.0, attn_impl="xla"),
        loss=m.LossConfig(hidden_dim=D),
    )
    return cfg


def _rank_batch(r, case):
    """Rank r's share of the global batch, in the loader's layout."""
    rng = np.random.default_rng(20 + r)
    s = B_RANK * S_PER
    u = U_RANK if case == "dedup" else s
    ids = np.full((u, T_LEN), 1, np.int32)
    mask = np.zeros((u, T_LEN), np.int32)
    for i in range(u):
        k = int(rng.integers(4, T_LEN + 1))
        ids[i, :k] = rng.integers(3, 211, k)
        ids[i, 0], ids[i, k - 1] = 0, 2
        mask[i, :k] = 1
    row_mask = np.ones(s, np.float32)
    row_mask[-1] = float(r == 0)  # rank 1's last row is padding
    batch = {
        "pixel_values": rng.standard_normal((B_RANK, 56, 56, 3)).astype(np.float32),
        "input_ids": ids, "attention_mask": mask,
        "group_map": (np.repeat(np.arange(B_RANK), S_PER) + r * B_RANK).astype(np.int32),
        "row_mask": row_mask,
    }
    if case == "dedup":  # a duplicated sentence: its gradients add up in the gather
        batch["row_gather"] = (np.array([0, 1, 2, 1]) + r * U_RANK).astype(np.int32)
    if case == "clip":
        batch["random_input_ids"] = ids[::S_PER].copy()
        batch["random_attention_mask"] = mask[::S_PER].copy()
    return batch


def _global_batch(case):
    parts = [_rank_batch(r, case) for r in range(WORLD)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _optimizer():
    return toptim.build_optimizer(learning_rate=LR, weight_decay=0.05, max_grad_norm=1.0,
                                  warmup_steps=1, total_steps=STEPS)


class _Recording:
    """An optimizer that keeps a copy of the gradients it is handed."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def update(self, grads, state, trainable):
        self.grads.append([g.detach().clone() for g in grads])
        return self.opt.update(grads, state, trainable)


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def _steps_rank(group, out):
    from radzero_torch.parallel.dist import rank

    r = rank(group)
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    res = {}
    for case in CASES:
        trainable, frozen = toptim.partition_params(inputs[case], TRAINABLE)
        opt, _ = _optimizer()
        rec = _Recording(opt)
        state = opt.init(trainable)
        step = make_train_step(_cfg(tconf, case), rec, dtype=torch.float32, device="cpu",
                               group=group)
        batch = _to_torch(_rank_batch(r, case))
        before, after, losses = [], [], []
        for _ in range(STEPS):
            before.append([p.clone() for p in toptim.tree_leaves(trainable)])
            trainable, state, ls = step(trainable, frozen, state, batch)
            losses.append({k: v.item() for k, v in ls.items()})
            after.append([p.clone() for p in toptim.tree_leaves(trainable)])
        res[case] = {"before": before, "after": after, "losses": losses, "grads": rec.grads}
    torch.save(res, os.path.join(out, f"rank{r}.pt"))


class _Stop(Exception):
    pass


def _trainer_rank(group, out):
    """Run A (3 epochs), then run B stopped at epoch 2's first step record and
    resumed by a fresh trainer; both ranks alike."""
    from radzero_torch.data.pipeline import PackSpec, TrainLoader
    from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
    from radzero_torch.parallel.dist import rank, world
    from radzero_torch.train import trainer as ttrainer
    from test_torch_trainer import CFG, _records

    r = rank(group)
    recs, image_loader = _records(16)
    tok = WhitespaceHashTokenizer(vocab_size=5003, max_length=10)
    spec = PackSpec(max_sentences_per_image=2, max_text_tokens=10)
    shard = dict(process_index=r, process_count=world(group), num_threads=2)
    saves = []
    save = ttrainer.save_checkpoint
    ttrainer.save_checkpoint = lambda *a, **k: (saves.append(a[1]), save(*a, **k))[1]

    def trainer(name, callback=None):
        args = ttrainer.TrainerArgs(output_dir=os.path.join(out, name), learning_rate=1e-3,
                                    num_train_epochs=3, warmup_steps=1, logging_steps=1,
                                    save_total_limit=2, bf16=False, seed=0)
        return ttrainer.RadZeroTrainer(
            CFG, args, TrainLoader(recs, image_loader, tok, 4, spec, seed=0, **shard),
            TrainLoader(recs[:8], image_loader, tok, 4, spec, seed=0, shuffle=False, **shard),
            device="cpu", metrics_callback=callback, group=group)

    def stop(record):
        if record.get("epoch") == 1 and "train_samples_per_second" not in record:
            raise _Stop

    res = {}
    a = trainer("A")
    a.train()
    res["A"] = {"leaves": [p.clone() for p in toptim.tree_leaves(a.trainable)],
                "history": a.state.log_history, "saves": list(saves)}
    try:
        trainer("B", stop).train()
        raise AssertionError("run B was not stopped")
    except _Stop:
        pass
    b = trainer("B")
    b.train(resume_from_checkpoint=True)
    res["B"] = {"leaves": [p.clone() for p in toptim.tree_leaves(b.trainable)],
                "history": b.state.log_history}
    torch.save(res, os.path.join(out, f"rank{r}.pt"))


MODES = {"steps": _steps_rank, "trainer": _trainer_rank}

# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _stack(layers):
    if isinstance(layers[0], dict):
        return {k: _stack([layer[k] for layer in layers]) for k in layers[0]}
    return np.stack(layers)


def _split_qkv(p):
    qkv = p["attn"]["qkv"]
    d = qkv["kernel"].shape[1] // 3
    attn = {n: {"kernel": qkv["kernel"][:, i * d:(i + 1) * d],
                "bias": qkv["bias"][i * d:(i + 1) * d]} for i, n in enumerate("qkv")}
    return {**p, "attn": {**attn, "o": p["attn"]["o"]}}


def _to_jax(tree):
    """The inverse of params_from_jax on numpy trees: stacked layers, q / k / v apart."""
    out = {}
    for key, sub in tree.items():
        if key in ("vision_model", "align_transformer") and "layers" in sub:
            sub = {**sub, "layers": _stack([_split_qkv(p) for p in sub["layers"]])}
        elif key == "text_model":
            sub = {**sub, "layers": _stack(sub["layers"])}
        out[key] = sub
    return out


def _unflatten(leaves, like):
    """A flat list in tree_leaves order -> the tree of ``like``."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return next(it)

    return walk(like)


@pytest.fixture(scope="module")
def weights():
    from radzero_tpu.models import configuration as jconf
    from radzero_tpu.models.radzero import init_radzero as jax_init_radzero
    from test_torch_modules import perturbed

    out = {}
    for case in CASES:
        tree = jax_init_radzero(jax.random.PRNGKey(3), _cfg(jconf, case),
                                loss_apply=LOSSES.get(case, ("RadZeroLoss",)))
        out[case] = perturbed(tree, np.random.default_rng(3))
    return out


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    from radzero_torch.models.from_jax import params_from_jax

    tmp = tmp_path_factory.mktemp("ddp")
    (tmp / "steps").mkdir()
    torch.save({case: params_from_jax(w) for case, w in weights.items()},
               tmp / "steps" / "inputs.pt")
    out = run_ranks(tmp, __file__, "steps")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def test_inverse_bridge_round_trips(weights):
    from radzero_torch.models.from_jax import params_from_jax, params_to_numpy

    w = weights["clip"]
    back = _to_jax(params_to_numpy(params_from_jax(w)))
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = jax.tree_util.tree_leaves_with_path(w)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", CASES)
def test_two_rank_steps_match_jax_global_step(weights, ranks, case):
    from radzero_torch.models.from_jax import params_from_jax, params_to_numpy
    from radzero_tpu.models import configuration as jconf
    from radzero_tpu.models.radzero import forward_train as jax_forward_train
    from radzero_tpu.parallel.mesh import batch_sharding, create_mesh, replicated_sharding
    from radzero_tpu.train import optim as joptim
    from radzero_tpu.train.step import make_train_step as jax_make_train_step

    mesh = create_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])
    jcfg = _cfg(jconf, case)
    rep, bs = replicated_sharding(mesh), batch_sharding(mesh)
    jtrain = {k: v for k, v in weights[case].items() if k in TRAINABLE}
    jfrozen = jax.device_put({k: v for k, v in weights[case].items() if k not in TRAINABLE},
                             rep)
    batch = {k: jax.device_put(v, bs) for k, v in _global_batch(case).items()}
    tx, _ = joptim.build_optimizer(jtrain, learning_rate=LR, weight_decay=0.05,
                                   max_grad_norm=1.0, warmup_steps=1, total_steps=STEPS)
    jstep = jax_make_train_step(jcfg, tx, dtype=jnp.float32, donate=False, mesh=mesh)
    jtrain = jax.device_put(jax.tree_util.tree_map(jnp.asarray, jtrain), rep)
    jstate = jax.device_put(tx.init(jtrain), rep)

    def loss_fn(trainable):
        out = jax_forward_train({**trainable, **jfrozen}, jcfg, batch, dtype=jnp.float32,
                                stop_vision_gradient=True, mesh=mesh)
        return out["losses"]["loss"], out["losses"]

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    like = toptim.partition_params(params_from_jax(weights[case]), TRAINABLE)[0]
    paths = [p for p, _ in _torch_paths(like)]
    r0, r1 = ranks[0][case], ranks[1][case]
    for i in range(STEPS):
        jtrain, jstate, jl = jstep(jtrain, jfrozen, jstate, batch)
        got = r0["losses"][i]
        assert got == r1["losses"][i]  # every rank computes the same global loss
        assert sorted(got) == sorted(jl)
        for name in jl:
            tol = 1e-4 if name == "grad_norm" else 1e-5
            np.testing.assert_allclose(got[name], np.asarray(jl[name]), rtol=tol, atol=1e-6,
                                       err_msg=f"step {i} {name}")
        # the gradients at the rank's own parameters before this step
        at = _to_jax(params_to_numpy(_unflatten(r0["before"][i], like)))
        _, ref = grad_fn(jax.device_put(jax.tree_util.tree_map(jnp.asarray, at), rep))
        ref = dict(_torch_paths(params_to_numpy(params_from_jax(
            jax.tree_util.tree_map(np.asarray, ref)))))
        assert sorted(ref) == sorted(paths)
        for path, g0, g1 in zip(paths, r0["grads"][i], r1["grads"][i]):
            assert torch.equal(g0, g1), f"step {i} {path}: the ranks' averaged gradients differ"
            b = ref[path]
            bound = 2e-4 * np.abs(b).max() + 1e-7
            assert np.abs(g0.numpy() - b).max() <= bound, (
                f"{case} step {i} {path}: |port - JAX| {np.abs(g0.numpy() - b).max():.3e} > "
                f"{bound:.3e}")
        for a, b in zip(r0["after"][i], r1["after"][i]):
            assert torch.equal(a, b), f"step {i}: the ranks' parameters differ"
    assert r0["losses"][-1]["loss"] < r0["losses"][0]["loss"]


def test_two_rank_trainer_files_and_resume(tmp_path):
    out = run_ranks(tmp_path, __file__, "trainer")
    r0, r1 = (torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD))
    # 16 records, 2 ranks x 4 a step: 2 steps an epoch, 3 epochs
    assert r0["A"]["saves"] == [2, 4, 6] and r1["A"]["saves"] == []
    for run in ("A", "B"):  # save_total_limit 2, the eval loss falling: the last two
        assert sorted(os.listdir(out / run)) == ["checkpoint-4", "checkpoint-6",
                                                 "log_history.jsonl"]
    lines = (out / "A" / "log_history.jsonl").read_text().splitlines()
    assert len(lines) == len(r0["A"]["history"]) == 9  # 6 step records, 3 epoch records
    evals = [[h["eval_loss"] for h in res["A"]["history"] if "eval_loss" in h]
             for res in (r0, r1)]
    assert len(evals[0]) == 3 and evals[0] == evals[1]  # the global eval loss on each rank
    for a, b in zip(r0["A"]["leaves"], r1["A"]["leaves"]):
        assert torch.equal(a, b)
    for res in (r0, r1):
        for a, b in zip(res["A"]["leaves"], res["B"]["leaves"]):
            assert torch.equal(a, b), "the resumed run ends with other weights"
    steps_a = [(h["step"], h["loss"]) for h in r0["A"]["history"] if "lr" in h]
    steps_b = [(h["step"], h["loss"]) for h in r0["B"]["history"] if "lr" in h]
    assert steps_b == steps_a[len(steps_a) - len(steps_b):]


def _torch_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _torch_paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _torch_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


if __name__ == "__main__":
    rank_main(MODES)
