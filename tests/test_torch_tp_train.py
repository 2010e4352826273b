"""Training over the port's model axis on the CPU, fp32, against the JAX
package on its (data x model) mesh and against the port's own unsplit path.

- The backward chains split at their all-reduces
  (``radzero_torch/ops/fused_layer.py``): ``fused_preattn_bwd_tp`` (K6),
  ``fused_postattn_bwd_tp`` (K8) and ``fused_mpnet_post_bwd_tp`` (K9) on
  two shards whose partials two threads sum, the shares put back together,
  against the unsplit ``*_bwd_plain`` twins and against ``jax.vjp`` of the
  JAX ``*_vjp`` functions on the whole operands, at 2e-4 of each output's
  largest value (the fused-layer gradient gate of tests/test_fused_layer.py):
  K8 / K9's wrappers with the forward's kept sums, and their ``*_bwd_tp_plain``
  twins with no ``kept`` (the forward's sums summed again).
- gloo ranks on ``{data: 1, model: 2}`` and ``{data: 2, model: 2}``
  (``run_ranks`` of tests/test_torch_parallel.py; the ranks import no JAX),
  at tests/test_torch_tensor_parallel.py's widths (D, H, F = 64, 4, 128) and
  a vocabulary of 212 that splits the word table: ``forward_train``'s
  gradient tree, averaged over the data group and put back together with
  ``unshard_params``, on the fused route (K1-K4 and K6-K9 twins, K3 / K4
  row-parallel) and the eager one, against ``jax.grad`` of the JAX loss on
  ``create_mesh({"data": 4, "model": 2})`` with the JAX ``shard_params`` at
  2e-4 of each leaf's largest value, and against the port's ``tp=None`` at
  chip_smoke.py's ``tp_grad_gate`` (its derivation is there). The JAX mesh
  differentiates its own fused route (``fused_vjp``, ``fuse_post``, the
  fused VL-CABS training kernels, all in interpret mode) and its xla route.
- remat under the model axis: ``save_attn`` on the fused align layers and
  the None policy (the fused and the eager layers, MPNet's checkpoint) give
  the gradients without remat bit for bit, on every rank.
- ``global_norm`` over the model group equals the norm of the whole tree;
  an AdamW update clipped (``max_grad_norm`` below the norm) leaves every
  replicated leaf bit-equal across the model group.
- Four ``make_train_step`` steps over both grids against the JAX
  ``make_train_step`` on the mesh with sharded ``trainable``, in the way of
  ``dryrun_multichip`` (the first update runs at lr 0): losses and
  ``grad_norm`` at rtol 5e-4 / atol 1e-6, the dryrun's tolerance; the
  replicated leaves stay bit-equal across the model group.
- ``RadZeroTrainer(group=, tp=)`` on ``{data: 1, model: 2}`` over tiny
  records for two epochs: the checkpoints hold the whole tree, at the loss
  trajectory's gate of a one-process trainer's; a run stopped in its
  second epoch and resumed into shares ends bit-equal to the uninterrupted
  run; ``train_samples_per_second`` counts data ranks. ``python -m
  radzero_torch.cli.run`` under torchrun with ``train.mesh: {data: 1, model:
  2}`` trains and writes the whole tree.
"""

import importlib.util
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from radzero_torch.models import configuration as tconf
from radzero_torch.ops import fused_layer as fl
from radzero_torch.parallel import tensor_parallel as tpar
from radzero_torch.train import optim as toptim
from radzero_torch.utils.tree import tree_leaves, tree_unflatten

from test_torch_parallel import REPO, rank_main, run_ranks
from test_torch_tensor_parallel import (
    D, F, MODEL, _batch, _cfg, _data_share, _jax_mesh, _jax_tree, _ThreadSum, _to_torch,
)

VOCAB = 212  # the word table splits over two ranks
GRIDS = ("1x2", "2x2")
ROUTES = ("fused", "eager")
TRAINABLE = ("align_transformer", "text_model", "loss_fns")
STEPS, LR = 4, 1e-4
TRAINER_EPOCHS = 2


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _optimizer(max_grad_norm=1.0):
    return toptim.build_optimizer(learning_rate=LR, weight_decay=0.05, max_grad_norm=max_grad_norm,
                                  warmup_steps=1, total_steps=STEPS)[0]


def _clone(tree):
    return tpar._map(lambda _, t: t.clone(), tree)


def _grads(params, cfg, batch, *, dgroup=None, tp=None, remat=False):
    """forward_train's loss and the gradient tree of the trainable leaves
    (averaged over the data group), as make_train_step takes them."""
    from radzero_torch.models.radzero import forward_train
    from radzero_torch.parallel.collectives import average_gradients

    trainable, frozen = toptim.partition_params(_clone(params), TRAINABLE)
    leaves = tree_leaves(trainable)
    for p in leaves:
        p.requires_grad_(True)
    out = forward_train(toptim.merge_params(trainable, frozen), cfg, batch, group=dgroup, tp=tp,
                        remat=remat, stop_vision_gradient=True)
    grads = torch.autograd.grad(out["losses"]["loss"], leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    if dgroup is not None:
        grads = average_gradients(grads, dgroup)
    return out["losses"]["loss"].detach(), tree_unflatten(grads, trainable)


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def _grid_rank(group, out, inputs_path):
    """One rank of the grid its mode names: gradients, remat, the norm and
    the clip, four steps, and on {data: 1, model: 2} the trainer; results to
    out/rank{r}.pt."""
    import dataclasses

    from radzero_torch.parallel.dist import mesh_groups
    from radzero_torch.train.step import make_train_step

    data, model = (int(v) for v in os.path.basename(out).split("x"))
    inputs = torch.load(inputs_path, weights_only=False)
    r = torch.distributed.get_rank()
    d, m = divmod(r, model)
    dgroup, tp = mesh_groups(data, model)
    share = tpar.shard_params(inputs["params"], m, model)
    specs = tpar.param_specs(inputs["params"], model)
    split = tpar.split_leaves({k: specs[k] for k in TRAINABLE})
    batch = _to_torch(_data_share(inputs["batch"], d, data))
    res = {}
    for route in ROUTES:
        cfg = _cfg(tconf, VOCAB, route)
        res[f"loss_{route}"], res[f"grads_{route}"] = _grads(share, cfg, batch, dgroup=dgroup,
                                                             tp=tp)
        policies = {"save_attn": cfg} if route == "eager" else {
            "save_attn": cfg,
            "none": dataclasses.replace(cfg, align=dataclasses.replace(cfg.align,
                                                                       remat_policy=None))}
        for name, c in policies.items():
            _, got = _grads(share, c, batch, dgroup=dgroup, tp=tp, remat=True)
            res[f"remat_{route}_{name}"] = all(
                torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                  tree_leaves(res[f"grads_{route}"])))
    grads = tree_leaves(res["grads_fused"])
    res["norm"] = toptim.global_norm(grads, tp, split)
    # a clipped update: max_grad_norm below the norm, a learning rate from the first update
    opt = toptim.AdamW(lambda count: 1e-3, weight_decay=0.05, max_grad_norm=1e-3, b1=0.9,
                       b2=0.999, eps=1e-8, gradient_accumulation_steps=1, bf16_moments=False)
    trainable = toptim.partition_params(_clone(share), TRAINABLE)[0]
    opt.update(grads, opt.init(trainable), trainable, tp=tp, split=split)
    res["clipped"] = trainable

    trainable, frozen = toptim.partition_params(_clone(share), TRAINABLE)
    opt = _optimizer()
    state = opt.init(trainable)
    step = make_train_step(_cfg(tconf, VOCAB), opt, dtype=torch.float32, device="cpu",
                           group=dgroup, tp=tp, specs=specs)
    res["steps"] = []
    for _ in range(STEPS):
        trainable, state, losses = step(trainable, frozen, state, batch)
        res["steps"].append({k: v.item() for k, v in losses.items()})
    res["stepped"] = trainable
    if data == 1:
        res["trainer"] = _trainer_runs(out, dgroup, tp)
    torch.save(res, os.path.join(out, f"rank{r}.pt"))


class _Stop(Exception):
    pass


class _Clock:
    """perf_counter for the trainer: one second a call."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


def _trainer(out, name, group=None, tp=None, callback=None):
    from radzero_torch.data.pipeline import PackSpec, TrainLoader
    from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
    from radzero_torch.train import trainer as ttrainer
    from test_torch_trainer import CFG, _records

    recs, image_loader = _records(16)
    tok = WhitespaceHashTokenizer(vocab_size=5003, max_length=10)
    spec = PackSpec(max_sentences_per_image=2, max_text_tokens=10)
    args = ttrainer.TrainerArgs(output_dir=os.path.join(out, name), learning_rate=1e-3,
                                num_train_epochs=TRAINER_EPOCHS, warmup_steps=1, logging_steps=1,
                                bf16=False, seed=0)
    return ttrainer.RadZeroTrainer(
        CFG, args, TrainLoader(recs, image_loader, tok, 4, spec, seed=0, num_threads=2),
        TrainLoader(recs[:8], image_loader, tok, 4, spec, seed=0, shuffle=False, num_threads=2),
        device="cpu", metrics_callback=callback, group=group, tp=tp)


def _trainer_runs(out, group, tp):
    """Run A (two epochs, a clock of one second a call), then run B stopped at
    epoch 2's first step record and resumed by a fresh trainer."""
    from radzero_torch.train import trainer as ttrainer

    clock, real = _Clock(), ttrainer.time
    ttrainer.time = clock
    try:
        a = _trainer(out, "A", group, tp)
        a.train()
    finally:
        ttrainer.time = real
    res = {"A": {"leaves": [p.clone() for p in tree_leaves(a.trainable)],
                 "history": a.state.log_history, "whole": a.whole_params()}}

    def stop(record):
        if record.get("epoch") == 1 and "train_samples_per_second" not in record:
            raise _Stop

    try:
        _trainer(out, "B", group, tp, stop).train()
        raise AssertionError("run B was not stopped")
    except _Stop:
        pass
    b = _trainer(out, "B", group, tp)
    b.train(resume_from_checkpoint=True)
    res["B"] = {"leaves": [p.clone() for p in tree_leaves(b.trainable)],
                "history": b.state.log_history}
    return res


MODES = {"1x2": _grid_rank, "2x2": _grid_rank}


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """The JAX tree (numpy), the port's whole tree, each grid's rank results and the
    references: the ranks of both grids run while this process computes the JAX mesh's
    gradients and steps and the port's one-process gradients."""
    from radzero_torch.models.from_jax import params_from_jax

    tree = _jax_tree(VOCAB)
    inputs = {"params": params_from_jax(tree), "batch": _batch(VOCAB)}
    out = {"tree": tree, "inputs": inputs, "ranks": {}}
    runs, errors = {}, []

    def run(grid, tmp):
        data, model = (int(v) for v in grid.split("x"))
        try:
            runs[grid] = run_ranks(tmp, __file__, grid, world=data * model,
                                   args=(tmp / "inputs.pt",))
        except BaseException as e:  # noqa: BLE001 - raised again below, in this thread
            errors.append(e)

    threads = []
    for grid in GRIDS:
        tmp = tmp_path_factory.mktemp(f"tptrain{grid}")
        torch.save(inputs, tmp / "inputs.pt")
        threads.append(threading.Thread(target=run, args=(grid, tmp)))
        threads[-1].start()
    try:
        batch = _to_torch(inputs["batch"])
        out["refs"] = {}
        for route in ROUTES:
            loss, grads = _grads(inputs["params"], _cfg(tconf, VOCAB, route), batch)
            out["refs"][route] = {"jax": _jax_grads(tree, route), "one": grads, "loss": loss}
        out["jax_steps"] = _jax_steps(tree)
    finally:
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    for grid in GRIDS:
        data, model = (int(v) for v in grid.split("x"))
        out["ranks"][grid] = [torch.load(runs[grid] / f"rank{r}.pt", weights_only=False)
                              for r in range(data * model)]
        out[f"dir_{grid}"] = runs[grid]
    return out


def _trainable_specs(params):
    specs = tpar.param_specs(params, MODEL)
    return {k: specs[k] for k in TRAINABLE}


def _whole(ranks, key, params):
    """The whole tree from the model group of data rank 0's ``key`` shares."""
    return tpar.unshard_params([ranks[m][key] for m in range(MODEL)], _trainable_specs(params))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _jax_grads(tree, route):
    """jax.grad of the JAX loss over the trainable leaves on the {data: 4,
    model: 2} mesh, parameters sharded by the JAX rules, in the port's layout."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from radzero_torch.models.from_jax import params_from_jax
    from radzero_tpu.models import configuration as jconf
    from radzero_tpu.models.radzero import forward_train as jax_forward_train
    from radzero_tpu.parallel.sharding_rules import shard_params as jax_shard_params

    mesh = _jax_mesh()
    cfg = _cfg(jconf, VOCAB, route)
    sharded = jax_shard_params(jax.tree_util.tree_map(jnp.asarray, tree), mesh)
    trainable = {k: v for k, v in sharded.items() if k in TRAINABLE}
    frozen = {k: v for k, v in sharded.items() if k not in TRAINABLE}
    batch = {k: jax.device_put(v, NamedSharding(mesh, P("data"))) for k, v in _batch(VOCAB).items()}

    def loss(t):
        return jax_forward_train({**t, **frozen}, cfg, batch, dtype=jnp.float32,
                                 stop_vision_gradient=True)["losses"]["loss"]

    grads = jax.jit(jax.grad(loss))(trainable)
    return params_from_jax(jax.tree_util.tree_map(np.asarray, grads))


def _leaf_gate(got, ref, share, label, floor=1e-7):
    """|got - ref| <= share * max |ref| + floor over every entry of every leaf:
    the floor (chip_smoke.py phase 6's, tests/test_torch_ddp_step.py's) for
    the leaves whose gradient is zero in exact arithmetic and rounding noise
    here (the attention key biases)."""
    got, ref = dict(_paths(got)), dict(_paths(ref))
    assert sorted(got) == sorted(ref)
    for path in ref:
        g, r = np.asarray(got[path], np.float64), np.asarray(ref[path], np.float64)
        assert g.shape == r.shape, (label, path, g.shape, r.shape)
        bound = share * np.abs(r).max() + floor
        miss = np.abs(g - r).max()
        assert miss <= bound, f"{label} {path}: |got - ref| {miss:.3e} > {bound:.3e}"


# the backward chains split at their all-reduces, on two shards

def _rand(rng, *shape, std=1.0, mean=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * std + mean).astype(np.float32))


def _k6_ops(rng, n=37):
    return (_rand(rng, n, D), _rand(rng, D, std=0.1, mean=1.0), _rand(rng, D, std=0.1),
            _rand(rng, D, 3 * D, std=0.1), _rand(rng, 3 * D, std=0.1))


def _k3_ops(rng, n=37):
    return (_rand(rng, n, D), _rand(rng, n, D), _rand(rng, D, D, std=0.1), _rand(rng, D, std=0.1),
            _rand(rng, D, std=0.1, mean=0.7), _rand(rng, D, std=0.1, mean=1.0),
            _rand(rng, D, std=0.1), _rand(rng, D, F, std=0.1), _rand(rng, F, std=0.1),
            _rand(rng, F, D, std=0.1), _rand(rng, D, std=0.1), _rand(rng, D, std=0.1, mean=1.3))


def _k4_ops(rng, n=37):
    return (_rand(rng, n, D), _rand(rng, n, D), _rand(rng, D, D, std=0.1), _rand(rng, D, std=0.1),
            _rand(rng, D, std=0.1, mean=1.0), _rand(rng, D, std=0.1), _rand(rng, D, F, std=0.1),
            _rand(rng, F, std=0.1), _rand(rng, F, D, std=0.1), _rand(rng, D, std=0.1),
            _rand(rng, D, std=0.1, mean=1.3), _rand(rng, D, std=0.1))


def _thirds(t, dim, r, size):
    """Rank r's [q_r | k_r | v_r] of a packed dimension."""
    w = t.shape[dim] // 3 // size
    return torch.cat([t.narrow(dim, i * t.shape[dim] // 3 + r * w, w) for i in range(3)], dim)


def _join_thirds(parts, dim):
    w = parts[0].shape[dim] // 3
    return torch.cat([p.narrow(dim, i * w, w) for i in range(3) for p in parts], dim)


# per chain: (operands, cotangent width, the rank's operands, the gradients split by
# rank with the dimension of each, the tp backward, the unsplit twin, the JAX vjp, eps)
def _k6_split(ops, g, r):
    x, s, b, w, bq = ops
    return (x, s, b, _thirds(w, 1, r, MODEL).contiguous(), _thirds(bq, 0, r, MODEL)), \
        _thirds(g, 1, r, MODEL).contiguous()


def _row_split(ops, g, r, i):
    """K3 / K4 operands: attn_out and wo by the heads, w1 / b1 by columns, w2 by rows."""
    ops = list(ops)
    dl, fl_ = D // MODEL, F // MODEL
    ops[1] = ops[1][:, r * dl:(r + 1) * dl].contiguous()
    ops[2] = ops[2][r * dl:(r + 1) * dl].contiguous()
    ops[i] = ops[i][:, r * fl_:(r + 1) * fl_].contiguous()
    ops[i + 1] = ops[i + 1][r * fl_:(r + 1) * fl_].contiguous()
    ops[i + 2] = ops[i + 2][r * fl_:(r + 1) * fl_].contiguous()
    return tuple(ops), g


CHAINS = {
    "K6": (_k6_ops, 3 * D, _k6_split, {3: "thirds1", 4: "thirds0"}, fl.fused_preattn_bwd_tp,
           fl.fused_preattn_bwd_plain, None, "fused_preattn_vjp", 1e-6),
    "K8": (_k3_ops, D, lambda o, g, r: _row_split(o, g, r, 7), {1: 1, 2: 0, 7: 1, 8: 0, 9: 0},
           fl.fused_postattn_bwd_tp, fl.fused_postattn_bwd_plain, fl.postattn_tp_chain,
           "fused_postattn_vjp", 1e-6),
    "K9": (_k4_ops, D, lambda o, g, r: _row_split(o, g, r, 6), {1: 1, 2: 0, 6: 1, 7: 0, 8: 0},
           fl.fused_mpnet_post_bwd_tp, fl.fused_mpnet_post_bwd_plain, fl.mpnet_post_tp_chain,
           "fused_mpnet_post_vjp", 1e-12),
}


TP_TWINS = {"K8": fl.fused_postattn_bwd_tp_plain, "K9": fl.fused_mpnet_post_bwd_tp_plain}


def _split_backward(k, ops, g, keep):
    """The tp backward over MODEL threads summing their partials; ``keep`` hands
    K8 / K9's wrapper the forward chain's kept sums, else their twin
    (``*_bwd_tp_plain``) runs with no ``kept`` and sums them again (the twin's
    form that the unsplit twins run with the identity sum)."""
    make, _, split, _, bwd, _, chain, _, eps = CHAINS[k]
    if k in TP_TWINS and not keep:
        bwd = TP_TWINS[k]
    total = _ThreadSum(MODEL)
    outs = [None] * MODEL

    def run(r):
        red = total.reduce(r)
        ops_r, g_r = split(ops, g, r)
        kw = {}
        if keep:
            kw["kept"] = chain(*ops_r, reduce=red, eps=eps, keep=True)[1]
        outs[r] = bwd(*ops_r, g_r, reduce=red, eps=eps, **kw)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(MODEL)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outs


def _join(k, outs):
    """The whole gradients from the ranks' shares; the rest equal on every rank."""
    dims = CHAINS[k][3]
    whole = []
    for i in range(len(outs[0])):
        parts = [o[i] for o in outs]
        if i not in dims:
            for p in parts[1:]:
                assert torch.equal(p, parts[0]), f"{k} output {i} differs across ranks"
            whole.append(parts[0])
        elif isinstance(dims[i], str):
            whole.append(_join_thirds(parts, int(dims[i][-1])))
        else:
            whole.append(torch.cat(parts, dims[i]))
    return whole


@pytest.mark.parametrize("k, keep", [("K6", False), ("K8", False), ("K8", True), ("K9", False),
                                     ("K9", True)],
                         ids=["K6", "K8-sums_again", "K8-kept_sums", "K9-sums_again",
                              "K9-kept_sums"])
def test_split_backward_matches_unsplit_twin_and_jax_vjp(k, keep):
    """Two shards of K6 / K8 / K9's operands, their partials summed between two
    threads: the gradients of x and the replicated operands are bit-equal on
    both, and the shares put together match the unsplit twin and jax.vjp of
    the JAX kernel on the whole operands at 2e-4 of each output's largest
    value. K6's chain keeps nothing (its backward reads the operands alone)."""
    import jax
    import jax.numpy as jnp

    from radzero_tpu.ops import fused_layer as jfl

    make, width, _, _, _, plain, _, jname, eps = CHAINS[k]
    rng = np.random.default_rng({"K6": 31, "K8": 32, "K9": 33}[k])
    ops = make(rng)
    g = _rand(rng, ops[0].shape[0], width)
    got = _join(k, _split_backward(k, ops, g, keep))
    ref = plain(*ops, g, eps=eps)
    _, vjp = jax.vjp(lambda *a: getattr(jfl, jname)(*a, eps), *(jnp.asarray(t.numpy()) for t in ops))
    jref = vjp(jnp.asarray(g.numpy()))
    for i, (a, b, c) in enumerate(zip(got, ref, jref)):
        assert a.shape == b.shape, (k, i, a.shape, b.shape)
        bound = 2e-4 * b.abs().max().item()
        assert (a - b).abs().max().item() <= bound, (k, i, (a - b).abs().max().item(), bound)
        c = np.asarray(c)
        assert np.abs(a.numpy() - c).max() <= 2e-4 * np.abs(c).max(), (k, i, "jax")


def test_split_backward_on_one_rank_is_the_unsplit_twin():
    """One rank whose share is the whole, the sum the identity: K9's split twin
    is its unsplit twin within the fp32 order of x + (a wo + bo) against
    x + a wo + bo (K6's and K8's unsplit twins are their split twins called
    with the identity, so only K9's twin has a form of its own to hold)."""
    rng = np.random.default_rng(34)
    make, width, *_, plain, _, _, eps = CHAINS["K9"]
    ops = make(rng)
    g = _rand(rng, ops[0].shape[0], width)
    got = fl.fused_mpnet_post_bwd_tp_plain(*ops, g, reduce=lambda t: t, eps=eps)
    for a, b in zip(got, plain(*ops, g, eps=eps)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5 * b.abs().max().item())


def test_row_kernel_twin_backward_forms():
    """The row kernel's twin in the backward's places: v = acc + bias kept, no
    bias (K9's dv + the summed partial), no output in the operand type."""
    rng = np.random.default_rng(35)
    x, acc, b, ls = (_rand(rng, *sh) for sh in ((5, D), (5, D), (D,), (D,)))
    out, u, y, v = fl.tp_rows(x, acc, b, ls=ls, dtype=torch.float32, keep_u=True, keep_v=True)
    assert torch.equal(v, acc + b) and torch.equal(u, x + ls * (acc + b)) and y is None
    assert torch.equal(out, u)
    out, u, _, v = fl.tp_rows(x, acc, None, dtype=torch.bfloat16, keep_u=True, want_out=False)
    assert out is None and v is None and torch.equal(u, x + acc)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("route", ROUTES)
def test_gradient_tree_matches_jax_mesh_and_one_process(grids, grid, route):
    """forward_train's gradients over the grid, put back together, against
    jax.grad on the JAX mesh at 2e-4 of each leaf's largest value and against
    the port's tp=None within tp_grad_gate; every rank of a model group
    holds the same bits of each replicated leaf's gradient, and every data
    rank the same averaged gradients."""
    params = grids["inputs"]["params"]
    ranks = grids["ranks"][grid]
    key = f"grads_{route}"
    got = _whole(ranks, key, params)
    _leaf_gate(got, grids["refs"][route]["jax"], 2e-4, f"{grid} {route} against JAX")
    gate = _chip_smoke().tp_grad_gate(_cfg(tconf, VOCAB, route))
    _leaf_gate(got, grids["refs"][route]["one"], gate, f"{grid} {route} against tp=None")
    split = tpar.split_leaves(_trainable_specs(params))
    for d in range(len(ranks) // MODEL):
        for m in range(MODEL):
            row = ranks[d * MODEL + m]
            assert torch.equal(row[f"loss_{route}"], ranks[0][f"loss_{route}"])
            for s, a, b in zip(split, tree_leaves(row[key]),
                               tree_leaves(ranks[d * MODEL][key])):
                if not s:
                    assert torch.equal(a, b), "a replicated leaf's gradient differs in a group"
            for a, b in zip(tree_leaves(row[key]), tree_leaves(ranks[m][key])):
                assert torch.equal(a, b), "the data ranks' averaged gradients differ"


@pytest.mark.parametrize("grid", GRIDS)
def test_remat_over_the_model_axis_is_bit_equal(grids, grid):
    for res in grids["ranks"][grid]:
        for name in ("remat_fused_save_attn", "remat_fused_none", "remat_eager_save_attn"):
            assert res[name], name


@pytest.mark.parametrize("grid", GRIDS)
def test_global_norm_and_clip_over_the_model_axis(grids, grid):
    params = grids["inputs"]["params"]
    ranks = grids["ranks"][grid]
    whole = _whole(ranks, "grads_fused", params)
    ref = toptim.global_norm(whole)
    split = tpar.split_leaves(_trainable_specs(params))
    for res in ranks:
        np.testing.assert_allclose(res["norm"].item(), ref.item(), rtol=1e-6)
        assert torch.equal(res["norm"], ranks[0]["norm"])
    assert ref.item() > 1e-3  # the clip below scaled the gradients
    for d in range(len(ranks) // MODEL):
        group = ranks[d * MODEL:(d + 1) * MODEL]
        for res in group[1:]:
            for s, a, b in zip(split, tree_leaves(res["clipped"]),
                               tree_leaves(group[0]["clipped"])):
                if not s:
                    assert torch.equal(a, b), "a replicated leaf moved apart under the clip"


def _jax_steps(tree):
    """Four JAX make_train_step steps on the mesh, trainable sharded by the
    JAX rules, the batch on the data axis (dryrun_multichip's way)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from radzero_tpu.models import configuration as jconf
    from radzero_tpu.parallel.sharding_rules import shard_params as jax_shard_params
    from radzero_tpu.train import optim as joptim
    from radzero_tpu.train.step import make_train_step as jax_make_train_step

    mesh = _jax_mesh()
    tree = jax_shard_params(jax.tree_util.tree_map(jnp.asarray, tree), mesh)
    trainable = {k: v for k, v in tree.items() if k in TRAINABLE}
    frozen = {k: v for k, v in tree.items() if k not in TRAINABLE}
    tx, _ = joptim.build_optimizer(trainable, learning_rate=LR, weight_decay=0.05,
                                   max_grad_norm=1.0, warmup_steps=1, total_steps=STEPS)
    step = jax_make_train_step(_cfg(jconf, VOCAB), tx, dtype=jnp.float32, donate=False)
    state = tx.init(trainable)
    batch = {k: jax.device_put(v, NamedSharding(mesh, P("data"))) for k, v in _batch(VOCAB).items()}
    out = []
    for _ in range(STEPS):
        trainable, state, losses = step(trainable, frozen, state, batch)
        out.append({k: float(v) for k, v in losses.items()})
    return out


@pytest.mark.parametrize("grid", GRIDS)
def test_train_steps_match_jax_sharded_steps(grids, grid):
    """Four make_train_step steps over the grid: every sub-loss and grad_norm
    at rtol 5e-4 / atol 1e-6 of the JAX step's, the same on every rank; the
    replicated leaves bit-equal across each model group; the loss falls."""
    params = grids["inputs"]["params"]
    ranks = grids["ranks"][grid]
    split = tpar.split_leaves(_trainable_specs(params))
    for i, ref in enumerate(grids["jax_steps"]):
        got = ranks[0]["steps"][i]
        assert sorted(got) == sorted(ref)
        for name in ref:
            np.testing.assert_allclose(got[name], ref[name], rtol=5e-4, atol=1e-6,
                                       err_msg=f"step {i} {name}")
        for res in ranks[1:]:
            assert res["steps"][i] == got
    for d in range(len(ranks) // MODEL):
        for res in ranks[d * MODEL + 1:(d + 1) * MODEL]:
            for s, a, b in zip(split, tree_leaves(res["stepped"]),
                               tree_leaves(ranks[d * MODEL]["stepped"])):
                if not s:
                    assert torch.equal(a, b)
    assert ranks[0]["steps"][-1]["loss"] < ranks[0]["steps"][0]["loss"]


@pytest.fixture(scope="module")
def one_process_trainer(tmp_path_factory):
    out = tmp_path_factory.mktemp("tptrainer_one")
    t = _trainer(str(out), "one")
    t.train()
    return out / "one", t


def test_trainer_checkpoints_the_whole_tree_and_resumes_bit_equal(grids, one_process_trainer):
    """RadZeroTrainer over {data: 1, model: 2}: global rank 0 alone writes;
    each checkpoint's state holds the whole tree in a one-process run's
    layout, at the step gate (rtol 5e-4 / atol 1e-6) of a one-process
    trainer's, leaf by leaf as a share of its largest value, and so are the
    losses of every step; the
    run stopped in epoch 2 and resumed into shares ends bit-equal to run A
    on both ranks; the epoch's samples/s counts the one data rank."""
    one_dir, one = one_process_trainer
    ranks = grids["ranks"]["1x2"]
    run_dir = grids["dir_1x2"] / "A"
    names = sorted(n for n in os.listdir(one_dir) if n.startswith("checkpoint-"))
    assert names == sorted(n for n in os.listdir(run_dir) if n.startswith("checkpoint-"))
    assert len(names) == TRAINER_EPOCHS
    for name in names:
        got = torch.load(run_dir / name / "state.pt", weights_only=True)
        ref = torch.load(one_dir / name / "state.pt", weights_only=True)
        assert got["opt_state"]["count"] == ref["opt_state"]["count"]
        assert len(got["opt_state"]["mu"]) == len(ref["opt_state"]["mu"])
        for a, b in zip(got["opt_state"]["mu"], ref["opt_state"]["mu"]):
            assert a.shape == b.shape
        # the step gate, rtol 5e-4 / atol 1e-6 of each leaf (the atol for the leaves whose
        # gradient is rounding noise, the attention key biases, which Adam scales up)
        _leaf_gate(got["trainable"], ref["trainable"], 5e-4, name, floor=1e-6)
    ha = [h for h in ranks[0]["trainer"]["A"]["history"] if "lr" in h]
    hone = [h for h in one.state.log_history if "lr" in h]
    assert len(ha) == len(hone) == 4 * TRAINER_EPOCHS
    for a, b in zip(ha, hone):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=5e-4, atol=1e-6)
    epochs = [h for h in ranks[0]["trainer"]["A"]["history"] if "train_samples_per_second" in h]
    assert [h["train_samples_per_second"] for h in epochs] == [16.0] * TRAINER_EPOCHS
    for res in ranks:
        for a, b in zip(res["trainer"]["A"]["leaves"], res["trainer"]["B"]["leaves"]):
            assert torch.equal(a, b), "the resumed run ends with other weights"
    whole = ranks[0]["trainer"]["A"]["whole"]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(whole),
                                                  tree_leaves(ranks[1]["trainer"]["A"][
                                                      "whole"])))
    final = torch.load(run_dir / names[-1] / "state.pt", weights_only=True)["trainable"]
    for path, leaf in _paths(final):
        assert torch.equal(leaf, dict(_paths({k: whole[k] for k in final}))[path]), path


def test_cli_trains_over_a_model_axis(tmp_path):
    """torchrun, two gloo ranks, train.mesh {data: 1, model: 2}: the run trains,
    rank 0 alone writes log_history.jsonl, and the checkpoint holds the whole
    tree of a one-process run's shapes."""
    import yaml

    from test_cli_end_to_end import workspace as make_workspace

    root, cfg_path = make_workspace.__wrapped__(_Factory(tmp_path))
    cfg = yaml.safe_load(open(cfg_path))
    cfg["experiment"]["output_root_dir"] = str(tmp_path / "out")
    cfg["train"].update(mesh={"data": 1, "model": 2}, per_device_train_batch_size=4,
                        per_device_eval_batch_size=4, echo=1)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "radzero_torch.cli.run", "--cfg_path", str(path), "--train", "true",
         "--inference", "false", "--no_report", "--device", "cpu", "--name", "tp"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-6000:]
    out = tmp_path / "out" / "pt" / "debug" / "tp"
    rows = [json.loads(line) for line in open(out / "log_history.jsonl")]
    # 16 records, a batch of 4 x 2 images on the one data rank: 2 steps, one epoch record
    assert [r["step"] for r in rows if "lr" in r] == [1, 2] and len(rows) == 3
    assert rows[-1]["train_samples_per_second"] > 0 and "eval_loss" in rows[-1]
    from radzero_torch.cli import run as tcli
    from radzero_torch.config.config import Config

    ns = tcli.parse_args(["--cfg_path", str(path), "--device", "cpu"])
    _, params, *_ = tcli.build_everything(Config(ns).config, seed=0, device="cpu")
    (ckpt,) = [n for n in os.listdir(out) if n.startswith("checkpoint-")]
    state = torch.load(out / ckpt / "state.pt", weights_only=True)
    whole = {k: params[k] for k in state["trainable"]}
    assert [(p, t.shape) for p, t in _paths(state["trainable"])] == [
        (p, t.shape) for p, t in _paths(whole)]


class _Factory:
    """tmp_path_factory's mktemp for a fixture function called directly."""

    def __init__(self, base):
        self.base = base

    def mktemp(self, name):
        path = self.base / name
        path.mkdir()
        return path


if __name__ == "__main__":
    rank_main(MODES)
