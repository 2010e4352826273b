"""The port's model axis (radzero_torch/parallel/tensor_parallel.py, ``tp=``)
on the CPU, fp32, against the JAX package's tensor-parallel rules and mesh.

- ``param_specs`` against the JAX ``param_shardings`` specs on the same tree
  (the packed ``attn.qkv`` mapped back to q / k / v), at a vocabulary the
  model axis divides and one it does not (the word table then stays whole);
- ``shard_params`` / ``unshard_params`` round trip, and a rank's packed qkv
  is ``[q_r | k_r | v_r]``;
- the row-parallel twins of K3 and K4: two shards, their partial products
  summed by two threads, against the unsplit twins at 2e-5;
- gloo ranks on a (data x model) grid, global rank ``d * model + m``:
  ``forward_train``'s loss over ``{data: 1, model: 2}`` and ``{data: 2,
  model: 2}`` against the JAX loss on ``create_mesh({"data": 4, "model":
  2})`` with ``shard_params`` at rtol 3e-5 (``tests/test_tensor_parallel.py``);
  ``compute_logits`` over ``tp=2`` against the JAX one on that mesh at the
  suite's gate (logits rtol 1e-3 / atol 2e-4, map MAE < 1e-3); both against
  the port's own ``tp=None`` at the fp32 gate of chip_smoke.py's ``tp_fp32_gate``
  (a share of each output's largest value, from the order of the fp32 sums
  that the split leaves to the all-reduce); each on the fused layer route
  (K1-K4 twins, K3 / K4 row-parallel) and the eager one; the ``mlp`` adapter
  and the token filter over ``tp=2``;
- ``forward_train(remat=True)`` with grad mode on over both grids, at the
  gates of the no_grad call;
- what a model group of two once refused now runs: remat's ``save_attn``
  on the packed and flash align layers under gradients (their losses at the
  loss gates above), a CLIP vision tower and a BERT text tower (their
  outputs within the fp32 gate of the port's one process; training over the
  axis is tests/test_torch_tp_train.py's and tests/test_torch_tp_paths.py's);
  the CLIP text tower still raises, as without a group; a model group of one
  gives the bits of no group.

The ranks are fresh interpreters running this file (``run_ranks`` of
``tests/test_torch_parallel.py``); they import no JAX.
"""

import contextlib
import dataclasses
import importlib.util
import os
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from radzero_torch.models import configuration as tconf
from radzero_torch.ops import fused_layer as fl
from radzero_torch.parallel import tensor_parallel as tpar
from radzero_torch.utils.tree import tree_leaves

from test_torch_parallel import rank_main, run_ranks

D, H, F = 64, 4, 128
MODEL = 2
B, S, T_LEN = 8, 16, 10  # images, sentences (two an image), tokens: the JAX test's batch layout
N_PROMPTS = 3
VOCABS = {"1x2": 211, "2x2": 212}  # the word table stays whole at 211 and splits at 212
ROUTES = ("fused", "eager")
VIT = dict(hidden_size=D, num_hidden_layers=2, num_attention_heads=H, mlp_ratio=2.0,
           patch_size=14, pretrain_img_size=42, img_size=56)


def _cfg(m, vocab, route="fused", branch=None):
    """The model at ``vocab``; ``route`` "eager" runs the eager align layers, the
    eager MPNet chain and the eager VL-CABS loss."""
    eager = route == "eager"
    cfg = m.RadZeroConfig(
        vision=m.ViTConfig(**VIT),
        text=m.TextConfig(hidden_size=D, num_hidden_layers=2, num_attention_heads=H,
                          intermediate_size=F, vocab_size=vocab, max_position_embeddings=66,
                          fuse_post=not eager),
        align=m.AlignConfig(hidden_size=D, num_hidden_layers=2, num_attention_heads=H,
                            mlp_ratio=2.0, attn_impl="xla" if eager else "fused_vjp"),
        loss=m.LossConfig(hidden_dim=D, train_impl="xla" if eager else "fused"),
    )
    if branch == "mlp":
        cfg = dataclasses.replace(cfg, align=m.AlignConfig(hidden_size=D, model_type="mlp"))
    if branch == "token_filter":
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
            cfg.vision, token_filter_ratio=0.5, token_filter_layer=1))
    return cfg


def _batch(vocab):
    rng = np.random.default_rng(5)
    ids = np.full((S, T_LEN), 1, np.int32)
    mask = np.zeros((S, T_LEN), np.int32)
    for i in range(S):
        k = int(rng.integers(4, T_LEN + 1))
        ids[i, :k] = rng.integers(3, vocab, k)
        ids[i, 0], ids[i, k - 1] = 0, 2
        mask[i, :k] = 1
    row_mask = np.ones(S, np.float32)
    row_mask[-1] = 0.0
    return {"pixel_values": rng.standard_normal((B, 56, 56, 3)).astype(np.float32),
            "input_ids": ids, "attention_mask": mask,
            "group_map": np.repeat(np.arange(B), S // B).astype(np.int32), "row_mask": row_mask}


def _prompts(vocab):
    b = _batch(vocab)
    return b["pixel_values"][:2], b["input_ids"][:N_PROMPTS], b["attention_mask"][:N_PROMPTS]


def _to_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _data_share(batch, d, data):
    """Data rank d's rows of the global batch (group_map stays global)."""
    return {k: v[d * (len(v) // data):(d + 1) * (len(v) // data)] for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def _grid_rank(group, out, inputs_path):
    """One rank of the grid its mode names: the losses, the logits and the
    refusals over its model group, results to out/rank{r}.pt."""
    from radzero_torch.models.radzero import (
        compute_logits, forward_text, forward_train, forward_vision,
    )
    from radzero_torch.parallel.dist import mesh_groups

    grid = os.path.basename(out)
    data, model = (int(v) for v in grid.split("x"))
    vocab = VOCABS[grid]
    inputs = torch.load(inputs_path, weights_only=False)
    r = torch.distributed.get_rank()
    d, m = divmod(r, model)
    dgroup, tp = mesh_groups(data, model)
    assert tpar.tp_size(tp) == model and tpar.tp_rank(tp) == m
    res = {}
    batch = _to_torch(_data_share(inputs["batch"], d, data))
    pv, ids, mask = (torch.from_numpy(a) for a in _prompts(vocab))
    with torch.no_grad():
        for route in ROUTES:
            cfg = _cfg(tconf, vocab, route)
            share = tpar.shard_params(inputs["params"], m, model)
            res[f"loss_{route}"] = forward_train(share, cfg, batch, group=dgroup,
                                                 tp=tp)["losses"]["loss"]
            if data == 1:
                res[f"logits_{route}"] = compute_logits(share, cfg, pv, ids.long(), mask.long(),
                                                        eager=route == "eager", tp=tp)
    for route in ROUTES:  # grad mode on, no leaf requiring gradients: remat is asked for
        share = tpar.shard_params(inputs["params"], m, model)
        res[f"loss_remat_{route}"] = forward_train(share, _cfg(tconf, vocab, route), batch,
                                                   group=dgroup, tp=tp,
                                                   remat=True)["losses"]["loss"].detach()
        if data == 1:
            for branch in ("mlp", "token_filter"):
                share = tpar.shard_params(inputs[branch], m, model)
                res[f"logits_{branch}"] = compute_logits(share, _cfg(tconf, vocab, branch=branch),
                                                         pv, ids.long(), mask.long(), tp=tp)
    if data == 1:
        cfg = _cfg(tconf, vocab)
        share = tpar.shard_params(inputs["params"], m, model)
        clip, bert = _alt_cfgs(cfg)
        clip_share, bert_share = (tpar.shard_params(_alt_params(c), m, model)
                                  for c in (clip, bert))
        packed, flash = (dataclasses.replace(cfg, align=dataclasses.replace(cfg.align, attn_impl=a))
                         for a in ("packed", "flash"))
        for name, fn in (
            ("save_attn_packed", lambda: forward_train(_require(share), packed, batch,
                                                       group=dgroup, tp=tp,
                                                       remat=True)["losses"]["loss"].detach()),
            ("save_attn_flash", lambda: forward_train(_require(share), flash, batch,
                                                      group=dgroup, tp=tp,
                                                      remat=True)["losses"]["loss"].detach()),
            ("alt_vision", lambda: forward_vision(clip_share, clip, batch["pixel_values"],
                                                  tp=tp)["vision_tokens"]),
            ("alt_text", lambda: forward_text(bert_share, bert, ids, mask,
                                              tp=tp)["text_features"]),
            ("clip_text", lambda: forward_text(bert_share, _clip_text(bert), ids, mask, tp=tp)),
        ):
            try:
                with torch.no_grad() if name.startswith("alt") else contextlib.nullcontext():
                    res[name] = fn()
                res[f"refused_{name}"] = None
            except NotImplementedError as e:
                res[f"refused_{name}"] = str(e)
        # a model group of one: the (2, 1) grid over the same two ranks
        _, tp1 = mesh_groups(2, 1)
        with torch.no_grad():
            cfg = _cfg(tconf, vocab)
            a = compute_logits(inputs["params"], cfg, pv, ids.long(), mask.long(), tp=tp1)
            b = compute_logits(inputs["params"], cfg, pv, ids.long(), mask.long())
        res["size1_equal"] = all(torch.equal(a[k], b[k]) for k in a)
        res["size1_diff"] = {k: (a[k] - b[k]).abs().max().item() for k in a}
    torch.save(res, os.path.join(out, f"rank{r}.pt"))


def _require(tree):
    """A copy of ``tree`` whose leaves require gradients."""
    return tpar._map(lambda _, t: t.clone().requires_grad_(True), tree)


def _alt_cfgs(cfg):
    """``cfg`` with a CLIP vision tower, and with a BERT text tower, at its widths."""
    from radzero_torch.models.clip_vit import ClipViTConfig

    clip = dataclasses.replace(cfg, vision=ClipViTConfig(
        hidden_size=D, num_hidden_layers=2, num_attention_heads=H, intermediate_size=F,
        patch_size=14, pretrain_img_size=42, img_size=56))
    bert = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, model_type="bert"))
    return clip, bert


def _alt_params(cfg):
    """The port's weights for ``cfg`` from a seed (the same on every rank)."""
    from radzero_torch.models.radzero import init_radzero

    return init_radzero(torch.Generator().manual_seed(3), cfg)


def _clip_text(cfg):
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, model_type="clip_text"))


MODES = {"1x2": _grid_rank, "2x2": _grid_rank}


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

def _jax_tree(vocab, branch=None, seed=0):
    import jax

    from radzero_tpu.models import configuration as jconf
    from radzero_tpu.models.radzero import init_radzero as jax_init_radzero
    from test_torch_modules import perturbed

    tree = jax_init_radzero(jax.random.PRNGKey(seed), _cfg(jconf, vocab, branch=branch))
    return perturbed(tree, np.random.default_rng(seed))


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """Each grid's JAX tree (numpy) and its ranks' results."""
    from radzero_torch.models.from_jax import params_from_jax

    out = {}
    for grid, vocab in VOCABS.items():
        tmp = tmp_path_factory.mktemp(f"tp{grid}")
        tree = _jax_tree(vocab)
        inputs = {"params": params_from_jax(tree), "batch": _batch(vocab)}
        branches = {b: _jax_tree(vocab, b, seed=4) for b in ("mlp", "token_filter")}
        inputs.update({b: params_from_jax(t) for b, t in branches.items()})
        torch.save(inputs, tmp / "inputs.pt")
        data, model = (int(v) for v in grid.split("x"))
        res = run_ranks(tmp, __file__, grid, world=data * model, args=(tmp / "inputs.pt",))
        out[grid] = (tree, inputs, branches,
                     [torch.load(res / f"rank{r}.pt", weights_only=False)
                      for r in range(data * model)])
    return out


def _jax_mesh():
    import jax

    from radzero_tpu.parallel.mesh import create_mesh

    return create_mesh({"data": 4, "model": MODEL}, devices=jax.devices()[:4 * MODEL])


def _jax_loss(tree, vocab):
    """The JAX loss as tests/test_tensor_parallel.py holds it: the default
    (Pallas) routes, parameters sharded by the JAX rules, the batch on data."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from radzero_tpu.models import configuration as jconf
    from radzero_tpu.models.radzero import forward_train as jax_forward_train
    from radzero_tpu.parallel.sharding_rules import shard_params as jax_shard_params

    mesh = _jax_mesh()
    cfg = _cfg(jconf, vocab)
    sb = {k: jax.device_put(v, NamedSharding(mesh, P("data"))) for k, v in _batch(vocab).items()}
    fn = jax.jit(lambda p, b: jax_forward_train(p, cfg, b)["losses"]["loss"])
    return float(fn(jax_shard_params(tree, mesh), sb))


def _jax_logits(tree, vocab, branch=None):
    """The JAX compute_logits on the same mesh, parameters sharded, on its xla path."""
    import jax
    import jax.numpy as jnp

    from radzero_tpu.models import configuration as jconf
    from radzero_tpu.models.radzero import compute_logits as jax_compute_logits
    from radzero_tpu.parallel.sharding_rules import shard_params as jax_shard_params

    cfg = _cfg(jconf, vocab, branch=branch)
    cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, attn_impl="xla"),
        align=dataclasses.replace(cfg.align, attn_impl="xla"))
    pv, ids, mask = _prompts(vocab)
    fn = jax.jit(lambda p, a, b, c: jax_compute_logits(p, cfg, a, b, c))
    out = fn(jax_shard_params(tree, _jax_mesh()), jnp.asarray(pv), jnp.asarray(ids),
             jnp.asarray(mask))
    return {k: np.asarray(v) for k, v in out.items()}


def _one_process(params, cfg, vocab, route, what):
    from radzero_torch.models.radzero import compute_logits, forward_train

    with torch.no_grad():
        if what == "loss":
            return forward_train(params, cfg, _to_torch(_batch(vocab)))["losses"]["loss"]
        pv, ids, mask = (torch.from_numpy(a) for a in _prompts(vocab))
        return compute_logits(params, cfg, pv, ids.long(), mask.long(), eager=route == "eager")


def _fp32_gate(cfg):
    """chip_smoke.py's gate for a forward over a model axis in fp32 against one
    process (``tp_fp32_gate``: 4 L sqrt(F) 2^-24 of an output's largest value,
    from the order of the fp32 sums that the split leaves to the all-reduce)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.tp_fp32_gate(cfg)


def _within_gate(got, ref, gate, label=""):
    """|got - ref| <= gate * max |ref| over every entry."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    miss = np.abs(got - ref).max()
    assert miss <= gate * np.abs(ref).max(), (
        f"{label}: max |got - ref| {miss:.3e} above the gate {gate:.3e} x max |ref| "
        f"{np.abs(ref).max():.3e} = {gate * np.abs(ref).max():.3e}")


def _max_diff(a, b) -> str:
    """The largest |a - b| of two results, as words (bit-equality's miss)."""
    a, b = (np.asarray(t.detach().float() if torch.is_tensor(t) else t, np.float64)
            for t in (a, b))
    if a.shape != b.shape:
        return f"shapes {a.shape} and {b.shape}"
    return f"max |a - b| {np.abs(a - b).max():.3e}"


def _map_mae(got, ref, label):
    mae = np.abs(got - ref).mean()
    assert mae < 1e-3, f"{label}: map MAE {mae:.3e} against the JAX mesh (gate 1e-3)"


@pytest.mark.parametrize("vocab", sorted(VOCABS.values()))
def test_param_specs_match_jax(vocab):
    import jax

    from radzero_torch.models.from_jax import params_from_jax
    from radzero_tpu.parallel.sharding_rules import param_shardings

    tree = _jax_tree(vocab)
    specs = tpar.param_specs(params_from_jax(tree), MODEL)
    jax_specs = param_shardings(tree, _jax_mesh())
    seen = 0
    for path, sharding in jax.tree_util.tree_leaves_with_path(jax_specs):
        names = [getattr(k, "key", k) for k in path]
        want = tuple(sharding.spec)
        if len(names) > 2 and names[1] == "layers":  # stacked: one spec a layer, layer dim off
            rest = names[2:]
            if names[0] != "text_model" and rest[0] == "attn" and rest[1] in ("q", "k", "v"):
                rest = ["attn", "qkv", rest[2]]
            want = want[1:]
            for layer in range(len(tree[names[0]]["layers"]["ln1" if names[0] != "text_model"
                                                            else "ln_attn"]["scale"])):
                got = tpar._at(specs, [names[0], "layers", layer, *rest])
                assert got == want, (names, got, want)
                seen += 1
        else:
            assert tpar._at(specs, names) == want, (names, want)
            seen += 1
    word = specs["text_model"]["embeddings"]["word"]
    assert word == (() if vocab % MODEL else ("model", None))
    assert specs["text_model"]["embeddings"]["position"] == ("model", None)
    assert specs["vision_model"]["layers"][0]["attn"]["qkv"]["kernel"] == (None, "model")
    assert seen > 50


@pytest.mark.parametrize("size", [2, 4])
def test_shard_unshard_round_trip(size):
    from radzero_torch.models.from_jax import params_from_jax

    tree = _jax_tree(VOCABS["2x2"])
    params = params_from_jax(tree)
    shards = [tpar.shard_params(params, r, size) for r in range(size)]
    back = tpar.unshard_params(shards, tpar.param_specs(params, size))
    flat_a, flat_b = [], []
    tpar._map(lambda p, t: flat_a.append((p, t)), back)
    tpar._map(lambda p, t: flat_b.append((p, t)), params)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert torch.equal(a, b)
    w = D // size
    for r, share in enumerate(shards):
        qkv = share["vision_model"]["layers"][1]["attn"]["qkv"]
        jattn = tree["vision_model"]["layers"]["attn"]
        want = np.concatenate([jattn[n]["kernel"][1][:, r * w:(r + 1) * w] for n in "qkv"], 1)
        np.testing.assert_array_equal(qkv["kernel"].numpy(), want)
        assert share["vision_model"]["layers"][1]["attn"]["o"]["kernel"].shape == (w, D)
        assert share["text_model"]["layers"][0]["mlp"]["fc2"]["kernel"].shape == (F // size, D)
        assert share["vision_model"]["layers"][0]["ls1"] is params["vision_model"]["layers"][0][
            "ls1"]


class _ThreadSum:
    """The all-reduce of P threads: each hands its partial, every one gets the
    sum in thread order."""

    def __init__(self, p):
        self.parts, self.wait = [None] * p, threading.Barrier(p)

    def reduce(self, r):
        def fn(t):
            self.parts[r] = t
            self.wait.wait()
            total = sum(self.parts[1:], self.parts[0])
            self.wait.wait()
            return total
        return fn


def _layer_ops(k, rng, n=37):
    def rn(*shape, std=1.0, mean=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * std + mean).astype(np.float32))

    if k == "K3":  # x, a, wo, bo, ls1, ln2 s / b, w1, b1, w2, b2, ls2
        return (rn(n, D), rn(n, D), rn(D, D, std=0.1), rn(D, std=0.1), rn(D, std=0.1, mean=1.0),
                rn(D, std=0.1, mean=1.0), rn(D, std=0.1), rn(D, F, std=0.1), rn(F, std=0.1),
                rn(F, D, std=0.1), rn(D, std=0.1), rn(D, std=0.1, mean=1.0))
    return (rn(n, D), rn(n, D), rn(D, D, std=0.1), rn(D, std=0.1), rn(D, std=0.1, mean=1.0),
            rn(D, std=0.1), rn(D, F, std=0.1), rn(F, std=0.1), rn(F, D, std=0.1),
            rn(D, std=0.1), rn(D, std=0.1, mean=1.0), rn(D, std=0.1))


def _split_ops(k, ops, r, size):
    """Rank r's operands of K3 / K4 (``k``) under the JAX rules: attn_out and wo
    by the heads, w1 / b1 by columns, w2 by rows; the rest whole."""
    ops = list(ops)
    i = 7 if k == "K3" else 6  # w1's place; b1 and w2 follow it
    dl, fl = D // size, F // size
    ops[1] = ops[1][:, r * dl:(r + 1) * dl].contiguous()
    ops[2] = ops[2][r * dl:(r + 1) * dl]
    ops[i] = ops[i][:, r * fl:(r + 1) * fl].contiguous()
    ops[i + 1] = ops[i + 1][r * fl:(r + 1) * fl]
    ops[i + 2] = ops[i + 2][r * fl:(r + 1) * fl]
    return ops


@pytest.mark.parametrize("k", ["K3", "K4"])
def test_row_parallel_twins_match_unsplit(k):
    """Two shards, their partials summed between the threads, against the
    unsplit twin at 2e-5 (the JAX suite's fused-layer tolerance); one rank's
    share alone (the identity for the sum) is the unsplit twin bit for bit."""
    ops = _layer_ops(k, np.random.default_rng(11 if k == "K3" else 12))
    chain, plain = ((fl.postattn_tp_chain, fl.fused_postattn_plain) if k == "K3"
                    else (fl.mpnet_post_tp_chain, fl.fused_mpnet_post_plain))
    ref = plain(*ops)
    total = _ThreadSum(MODEL)
    outs = [None] * MODEL

    def run(r):
        outs[r] = chain(*_split_ops(k, ops, r, MODEL), reduce=total.reduce(r))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(MODEL)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for out in outs:
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)
    assert torch.equal(outs[0], outs[1])
    one = chain(*ops, reduce=lambda t: t)
    if k == "K3":
        assert torch.equal(one, ref)
    else:  # K4's twin adds x + (a wo + bo), the unsplit x + a wo + bo
        np.testing.assert_allclose(one.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)


def test_row_kernel_twin_forms():
    """The row kernel's twin in its four places, in fp32 against the formulas."""
    rng = np.random.default_rng(13)
    x, acc, b, ls, s, c = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
                           for sh in ((5, D), (5, D), (D,), (D,), (D,), (D,)))

    def ln(u):
        return torch.nn.functional.layer_norm(u, (D,), s, c, eps=1e-6)

    out, u, y, _ = fl.tp_rows(x, acc, b, ls=ls, ln=(s, c), dtype=torch.float32, keep_u=True)
    np.testing.assert_allclose(u.numpy(), (x + ls * (acc + b)).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), ln(u).numpy(), rtol=1e-5, atol=1e-5)
    assert y is None
    out, u, y, _ = fl.tp_rows(x, acc, b, ln=(s, c), dtype=torch.bfloat16, keep_ln32=True)
    np.testing.assert_allclose(y.numpy(), ln(x + (acc + b)).numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(out, y.to(torch.bfloat16)) and u is None
    out = fl.tp_rows(x, acc, b, ls=ls, dtype=torch.bfloat16)[0]
    assert torch.equal(out, (x + ls * (acc + b)).to(torch.bfloat16))


@pytest.mark.parametrize("grid", sorted(VOCABS))
@pytest.mark.parametrize("route", ROUTES)
def test_loss_matches_jax_mesh_and_one_process(grids, grid, route):
    """forward_train's loss on every rank of the grid: at rtol 3e-5 against
    the JAX loss on the {data: 4, model: 2} mesh, within the fp32 gate of
    the port's one-process loss, the same bits on every rank."""
    tree, inputs, _, ranks = grids[grid]
    vocab = VOCABS[grid]
    ref = _jax_loss(tree, vocab)
    one = _one_process(inputs["params"], _cfg(tconf, vocab, route), vocab, route, "loss")
    gate = _fp32_gate(_cfg(tconf, vocab, route))
    for res in ranks:
        got = res[f"loss_{route}"]
        np.testing.assert_allclose(got.item(), ref, rtol=3e-5)
        _within_gate(got.item(), one.item(), gate)
        assert torch.equal(got, ranks[0][f"loss_{route}"])


@pytest.mark.parametrize("grid", sorted(VOCABS))
@pytest.mark.parametrize("route", ROUTES)
def test_loss_with_remat_and_grad_mode_on(grids, grid, route):
    """forward_train(remat=True) over the grid outside no_grad, the parameters
    requiring no gradient: MPNet's checkpointed layers run over the model
    group too (no rank's partial left unsummed), held to the no_grad call's
    gates."""
    tree, inputs, _, ranks = grids[grid]
    vocab = VOCABS[grid]
    ref = _jax_loss(tree, vocab)
    one = _one_process(inputs["params"], _cfg(tconf, vocab, route), vocab, route, "loss")
    gate = _fp32_gate(_cfg(tconf, vocab, route))
    for res in ranks:
        got = res[f"loss_remat_{route}"]
        np.testing.assert_allclose(got.item(), ref, rtol=3e-5)
        _within_gate(got.item(), one.item(), gate)
        assert torch.equal(got, ranks[0][f"loss_remat_{route}"])


@pytest.mark.parametrize("route", ROUTES)
def test_compute_logits_matches_jax_and_one_process(grids, route):
    """compute_logits over tp=2 against the JAX one on the mesh (logits rtol
    1e-3 / atol 2e-4, map MAE < 1e-3: tests/test_radzero_model.py's gate) and
    within the fp32 gate of the port's tp=None, on both ranks."""
    tree, inputs, _, ranks = grids["1x2"]
    vocab = VOCABS["1x2"]
    ref = _jax_logits(tree, vocab)
    one = _one_process(inputs["params"], _cfg(tconf, vocab, route), vocab, route, "logits")
    gate = _fp32_gate(_cfg(tconf, vocab, route))
    for r, res in enumerate(ranks):
        key = f"logits_{route}"
        got = {k: v.numpy() for k, v in res[key].items()}
        assert got["logits"].shape == (2, N_PROMPTS) and got["similarity_scores"].shape == (
            2, N_PROMPTS, 16), (f"rank {r} {key}", {k: v.shape for k, v in got.items()})
        np.testing.assert_allclose(got["logits"], ref["logits"], rtol=1e-3, atol=2e-4,
                                   err_msg=f"rank {r} {key}['logits'] vs the JAX mesh")
        _map_mae(got["similarity_scores"], ref["similarity_scores"],
                 f"rank {r} {key}['similarity_scores']")
        for k in got:
            _within_gate(got[k], one[k].numpy(), gate, f"rank {r} {key}[{k!r}] vs one process")


@pytest.mark.parametrize("branch", ["mlp", "token_filter"])
def test_branch_logits_over_the_model_axis(grids, branch):
    """The mlp adapter (fc1 split on columns, fc2 on rows) and the token
    filter (the heads' CLS scores all-reduced) over tp=2: against the JAX
    mesh at the suite's gate and the port's tp=None at the fp32 gate; the
    filter keeps the same rows on both ranks."""
    _, inputs, branches, ranks = grids["1x2"]
    vocab = VOCABS["1x2"]
    ref = _jax_logits(branches[branch], vocab, branch)
    one = _one_process(inputs[branch], _cfg(tconf, vocab, branch=branch), vocab, "fused",
                       "logits")
    gate = _fp32_gate(_cfg(tconf, vocab, branch=branch))
    for r, res in enumerate(ranks):
        key = f"logits_{branch}"
        got = {k: v.numpy() for k, v in res[key].items()}
        np.testing.assert_allclose(got["logits"], ref["logits"], rtol=1e-3, atol=2e-4,
                                   err_msg=f"rank {r} {key}['logits'] vs the JAX mesh")
        _map_mae(got["similarity_scores"], ref["similarity_scores"],
                 f"rank {r} {key}['similarity_scores']")
        for k in got:
            _within_gate(got[k], one[k].numpy(), gate, f"rank {r} {key}[{k!r}] vs one process")
            first = ranks[0][key][k].numpy()
            assert np.array_equal(got[k], first), (
                f"rank {r} {key}[{k!r}] vs rank 0: {_max_diff(got[k], first)}")


def test_gradients_and_alternate_towers_refuse(grids):
    """What a model group of two once refused now returns: under gradients,
    remat's save_attn on the packed and flash align layers (the loss at rtol
    3e-5 of the JAX loss on the mesh and within the fp32 gate of the port's
    one process), a CLIP vision tower's tokens and a BERT text tower's
    features (within the fp32 gate of the port's one process), the same bits
    on both ranks; the CLIP text tower still raises, as it does without a
    group (and in the JAX composite)."""
    from radzero_torch.models.radzero import forward_text, forward_vision

    tree, inputs, _, ranks = grids["1x2"]
    vocab = VOCABS["1x2"]
    cfg = _cfg(tconf, vocab)
    ref = _jax_loss(tree, vocab)
    one = _one_process(inputs["params"], cfg, vocab, "fused", "loss")
    clip, bert = _alt_cfgs(cfg)
    pv, ids, mask = (torch.from_numpy(a) for a in _prompts(vocab))
    batch = _to_torch(inputs["batch"])
    with torch.no_grad():
        one_vision = forward_vision(_alt_params(clip), clip, batch["pixel_values"])
        one_text = forward_text(_alt_params(bert), bert, ids.long(), mask.long())
    for r, res in enumerate(ranks):
        for name in ("save_attn_packed", "save_attn_flash", "alt_vision", "alt_text"):
            assert res[f"refused_{name}"] is None, (f"rank {r} refused_{name}",
                                                    res[f"refused_{name}"])
            assert torch.equal(res[name], ranks[0][name]), (
                f"rank {r} {name} vs rank 0: {_max_diff(res[name], ranks[0][name])}")
        for name in ("save_attn_packed", "save_attn_flash"):
            np.testing.assert_allclose(res[name].item(), ref, rtol=3e-5,
                                       err_msg=f"rank {r} {name} vs the JAX mesh")
            _within_gate(res[name].item(), one.item(), _fp32_gate(cfg),
                         f"rank {r} {name} vs one process")
        _within_gate(res["alt_vision"].numpy(), one_vision["vision_tokens"].numpy(),
                     _fp32_gate(clip), f"rank {r} alt_vision vs one process")
        _within_gate(res["alt_text"].numpy(), one_text["text_features"].numpy(),
                     _fp32_gate(bert), f"rank {r} alt_text vs one process")
        assert "in composite model" in res["refused_clip_text"], (
            f"rank {r} refused_clip_text", res["refused_clip_text"])
    with pytest.raises(NotImplementedError, match="in composite model"):
        forward_text(_alt_params(bert), _clip_text(bert), ids.long(), mask.long())


def test_model_group_of_one_is_no_group(grids):
    """compute_logits over a model group of one (the (2, 1) grid over the two
    ranks) gives the bits of no group, on each rank: each key's largest
    difference is named."""
    for r, res in enumerate(grids["1x2"][3]):
        worst = max(res["size1_diff"], key=res["size1_diff"].get)
        assert res["size1_equal"], (
            f"rank {r}: compute_logits(tp=group of one) vs no group, per key max |a - b| "
            f"{res['size1_diff']}; the largest at {worst!r}")


def test_refusals_without_ranks(tmp_path):
    """save_attn on the packed layer under gradients, handed a model group (a
    gloo group of this one process here), now runs: its output and its
    gradients are the same layer's without a group, bit for bit; check_mesh
    and mesh_shape take a model axis."""
    from radzero_torch.models import vit as tvit
    from radzero_torch.parallel.dist import check_mesh, init_distributed, mesh_shape

    cfg = tconf.ViTConfig(**VIT)
    rng = np.random.default_rng(1)
    p = tvit.init_vit_layers(torch.Generator().manual_seed(0), cfg)[0]
    x0 = torch.from_numpy(rng.standard_normal((2, 5, D)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 5, D)).astype(np.float32))

    def run(tp):
        x, w = x0.clone().requires_grad_(True), _require(p)
        out = tvit._SAVE_ATTN["packed"](x, w, cfg, tp)
        return [out.detach()] + list(torch.autograd.grad(out, [x] + tree_leaves(w), g))

    group = init_distributed(backend="gloo", init_method=f"file://{tmp_path}/store", rank=0,
                             world_size=1, timeout_s=60)
    try:
        got = run(group)
    finally:
        torch.distributed.destroy_process_group()
    want = run(None)
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    assert check_mesh({"data": 1, "model": 2}, 2) == 1
    assert check_mesh({"data": -1, "model": 2}, 4) == 2
    with pytest.raises(NotImplementedError, match="data and model"):
        check_mesh({"data": 1, "pipe": 2}, 2)
    assert mesh_shape({"data": -1, "model": 2}, 4) == (2, 2)
    assert mesh_shape({"data": 2, "model": 2}, 4) == (2, 2)
    with pytest.raises(ValueError, match="divide"):
        mesh_shape({"model": 3}, 4)
    with pytest.raises(ValueError, match="world"):
        mesh_shape({"data": 3, "model": 2}, 4)


if __name__ == "__main__":
    rank_main(MODES)
