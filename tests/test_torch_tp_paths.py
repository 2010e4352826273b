"""The model axis's last paths on the CPU, fp32: the alternate towers split by
the JAX rules, remat's ``save_attn`` on the packed and flash align layers,
LoRA and the tower cache over a model group, the flagship-width dry run's
core at small widths, and three paths held over two data ranks.

gloo ranks (``run_ranks`` of tests/test_torch_parallel.py, global rank ``d *
model + m``; the ranks import no JAX) on ``{data: 1, model: 2}`` and
``{data: 2, model: 2}``, each grid spawned once, while this process runs the
JAX package on ``create_mesh({"data": 4, "model": 2})`` with the JAX
``shard_params``:

- ``param_specs`` equals the JAX ``param_shardings`` on each alternate
  tower's tree (SAM, CLIP, SigLIP, BiomedCLIP, MAE, BERT at a vocabulary the
  axis divides);
- ``compute_logits`` (a data rank scores its images) with each alternate
  vision tower and a BERT-family text tower, against the JAX composite on
  the mesh (logits rtol 1e-3 / atol 2e-4, map MAE < 1e-3:
  tests/test_radzero_model.py's gate) and within chip_smoke.py's
  ``tp_fp32_gate`` of the port's one process; ``forward_train``'s loss at
  rtol 3e-5 (tests/test_tensor_parallel.py's gate) and the same gate;
- ``forward_train``'s gradient tree with BERT trainable, put back together
  with ``unshard_params``, against ``jax.grad`` on the mesh at 2e-4 of each
  leaf's largest value (+ 1e-7) and against the port's ``tp=None`` within
  ``tp_grad_gate``; the replicated leaves' gradients bit-equal across the
  model group;
- ``save_attn`` on the ``packed`` and ``flash`` align layers under the
  group: the loss and every gradient leaf bit-equal to the same ranks
  without remat, and against ``jax.grad`` on the mesh on the JAX "xla"
  route (eager attention, which the JAX mesh differentiates on the CPU; the
  same function as the packed and flash kernels);
- LoRA on ``attn/q``, ``attn/v``, ``mlp/fc1`` and the replicated
  ``patch_embed``, the vision tower trainable through its adapters: the
  merged forward at init bit-equal to the base; the adapters' gradients
  against ``jax.grad`` of the JAX ``merge_lora`` on the sharded tree at 2e-4
  (+ 1e-7); the adapters bit-equal across the ranks after two AdamW steps;
- ``RadZeroTrainer`` on ``{data: 1, model: 2}`` with the tower cache
  (``ram``, and ``memmap`` through ``cli/run.py``'s ``tower_cache_from``):
  two epochs bit-equal to the uncached run on each rank, the same hits and
  misses on both ranks, one memmap directory a rank;
- ``radzero_torch.tools.flagship_width_dryrun``'s core on ``{data: 2, model:
  2}``: the losses within 5e-4 of the control's (the dry run's rtol), the
  eval logits' MAE <= 2e-4.

Over ``{data: 2, model: 1}`` (ROADMAP item 6), each against one process
with the whole batch at tests/test_torch_ddp_step.py's step gate (losses
rtol 1e-5, grad_norm 1e-4; gradients 2e-4 of the leaf's largest value +
1e-7; the ranks' parameters bit-equal): gradient accumulation at
``every_k = 2`` (the losses, and the first moment after the update, which
holds the mean of the two micro-steps' gradients), LoRA's adapter
gradients, and a step from the tower cache's tokens; the trainer with the
cache over the two data ranks (``stable_sharding=True``) bit-equal to the
uncached run. ``python -m radzero_torch.cli.run`` under torchrun with
``train.mesh: {data: 1, model: 2}`` and ``train.tower_cache: memmap`` trains
two epochs, each rank in its own cache directory.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from radzero_torch.models import configuration as tconf
from radzero_torch.parallel import tensor_parallel as tpar
from radzero_torch.utils.tree import tree_leaves, tree_unflatten

from test_torch_parallel import REPO, rank_main, run_ranks
from test_torch_tensor_parallel import (
    MODEL, _batch, _cfg, _data_share, _fp32_gate, _jax_mesh, _to_torch, _within_gate,
)
from test_torch_tp_train import _chip_smoke, _Factory, _leaf_gate

D = 32
VOCAB = 102          # the alternate composites: BERT's word table splits over two ranks
TP_VOCAB = 212       # the DINOv2 composite of tests/test_torch_tensor_parallel.py
B, S_PER, T = 4, 2, 8
N_PROMPTS = 3
TRAINABLE = ("align_transformer", "text_model", "loss_fns")
LORA_TARGETS = ["attn/q", "attn/v", "mlp/fc1", "patch_embed"]
VISION = {  # tests/test_torch_alt_composite.py's widths, and a CLIP tower
    "sam": ("sam_vit", "SamViTConfig",
            dict(hidden_size=D, num_hidden_layers=2, num_attention_heads=2, mlp_dim=64,
                 patch_size=8, image_size=32, img_size=32, window_size=2,
                 global_attn_indexes=(1,), output_channels=16)),
    "clip": ("clip_vit", "ClipViTConfig",
             dict(model_type="clip", hidden_size=D, num_hidden_layers=2, num_attention_heads=2,
                  intermediate_size=64, patch_size=8, pretrain_img_size=32, img_size=32)),
    "siglip": ("clip_vit", "ClipViTConfig",
               dict(model_type="siglip", hidden_size=D, num_hidden_layers=1,
                    num_attention_heads=2, intermediate_size=64, patch_size=8,
                    pretrain_img_size=32, img_size=32, hidden_act="gelu_pytorch_tanh",
                    use_class_token=False, final_layernorm=True)),
    "biomedclip": ("clip_vit", "ClipViTConfig",
                   dict(model_type="biomedclip", hidden_size=D, num_hidden_layers=1,
                        num_attention_heads=2, intermediate_size=64, patch_size=8,
                        pretrain_img_size=32, img_size=32, hidden_act="gelu",
                        final_layernorm=True)),
    "mae": ("mae_vit", "MAEViTConfig",
            dict(hidden_size=D, num_hidden_layers=1, num_attention_heads=2, patch_size=8,
                 img_size=32)),
}
# (vision, text, projection): every alternate vision tower, BERT-family text towers
PAIRS = (("sam", "mpnet", False), ("clip", "bert", False), ("siglip", "bert", False),
         ("biomedclip", "biomedclip", True), ("mae", "bioclinicalmpbert", False))
GRAD_PAIR = ("clip", "bert", False)
GRIDS = ("1x2", "2x2")
IMPLS = ("packed", "flash")
ACC_STEPS = 4
CACHE_EPOCHS = 2


def _name(pair):
    return "-".join(str(v) for v in pair)


def _alt_cfg(pkg, pair):
    """The composite with ``pair``'s towers from package ``pkg`` ("radzero_torch"
    or "radzero_tpu"): the port's align layers and MPNet on the kernels'
    plain twins, the JAX side's on its eager ops."""
    vision, text, projection = pair
    m = importlib.import_module(f"{pkg}.models.configuration")
    mod, cls, kw = VISION[vision]
    vcfg = getattr(importlib.import_module(f"{pkg}.models.{mod}"), cls)(**kw)
    port = pkg == "radzero_torch"
    return m.RadZeroConfig(
        vision=vcfg,
        text=m.TextConfig(model_type=text, hidden_size=D, num_hidden_layers=1,
                          num_attention_heads=2, intermediate_size=64, vocab_size=VOCAB,
                          max_position_embeddings=40, fuse_post=port,
                          use_text_projection=projection),
        align=m.AlignConfig(hidden_size=D, num_hidden_layers=1, num_attention_heads=2,
                            mlp_ratio=2.0, attn_impl="fused_vjp" if port else "xla"),
        loss=m.LossConfig(hidden_dim=D),
    )


def _alt_batch():
    rng = np.random.default_rng(21)
    s = B * S_PER
    ids = rng.integers(3, VOCAB, (s, T)).astype(np.int64)
    mask = np.ones((s, T), np.int64)
    mask[1, 5:] = mask[-2, 3:] = 0
    row_mask = np.ones(s, np.float32)
    row_mask[-1] = 0.0
    prompts = rng.integers(3, VOCAB, (N_PROMPTS, T)).astype(np.int64)
    pmask = np.ones((N_PROMPTS, T), np.int64)
    pmask[-1, 4:] = 0
    return {"pixel_values": rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
            "input_ids": ids, "attention_mask": mask,
            "group_map": np.repeat(np.arange(B), S_PER).astype(np.int64),
            "row_mask": row_mask}, prompts, pmask


def _clone(tree):
    return tpar._map(lambda _, t: t.clone(), tree)


def _grads(params, cfg, batch, *, dgroup=None, tp=None, remat=False):
    """forward_train's loss and the gradient tree of the trainable leaves (the
    tower frozen), averaged over the data group."""
    from radzero_torch.models.radzero import forward_train
    from radzero_torch.parallel.collectives import average_gradients
    from radzero_torch.train.optim import merge_params, partition_params

    trainable, frozen = partition_params(_clone(params), TRAINABLE)
    leaves = tree_leaves(trainable)
    for p in leaves:
        p.requires_grad_(True)
    out = forward_train(merge_params(trainable, frozen), cfg, batch, group=dgroup, tp=tp,
                        remat=remat, stop_vision_gradient=True)
    grads = torch.autograd.grad(out["losses"]["loss"], leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    if dgroup is not None:
        grads = average_gradients(grads, dgroup)
    return out["losses"]["loss"].detach(), tree_unflatten(grads, trainable)


def _lora_grads(params, lora, cfg, batch, *, dgroup=None, tp=None, specs=None):
    """The loss through ``merge_lora`` and the adapters' gradients (the
    vision tower trained through its adapters), averaged over the data group."""
    from radzero_torch.models.radzero import forward_train
    from radzero_torch.parallel.collectives import average_gradients
    from radzero_torch.train.lora import lora_trainable, merge_lora, with_trainable

    tr = _clone(lora_trainable(lora))
    leaves = tree_leaves(tr)
    for p in leaves:
        p.requires_grad_(True)
    merged = merge_lora(params, with_trainable(lora, tr), tp=tp, specs=specs)
    loss = forward_train(merged, cfg, batch, group=dgroup, tp=tp)["losses"]["loss"]
    grads = list(torch.autograd.grad(loss, leaves))
    if dgroup is not None:
        grads = average_gradients(grads, dgroup)
    return loss.detach(), grads


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def _grid_rank(group, out, inputs_path):
    """One rank of {data: D, model: M} (its mode): the alternate composites,
    BERT's gradients, save_attn, LoRA, on {1, 2} the trainer with the cache,
    on {2, 2} the dry run's core; results to out/rank{r}.pt."""
    from radzero_torch.models.radzero import compute_logits, forward_text, forward_train
    from radzero_torch.parallel.dist import mesh_groups
    from radzero_torch.train.lora import merge_lora
    from radzero_torch.train.optim import build_optimizer

    data, model = (int(v) for v in os.path.basename(out).split("x"))
    inputs = torch.load(inputs_path, weights_only=False)
    r = torch.distributed.get_rank()
    d, m = divmod(r, model)
    dgroup, tp = mesh_groups(data, model)
    res = {}
    batch = _to_torch(_data_share(inputs["alt_batch"], d, data))
    pv = torch.from_numpy(inputs["alt_batch"]["pixel_values"])
    pv = pv[d * (B // data):(d + 1) * (B // data)]
    ids, mask = (torch.from_numpy(a) for a in inputs["prompts"])
    for pair in PAIRS:
        cfg = _alt_cfg("radzero_torch", pair)
        share = tpar.shard_params(inputs["alt"][_name(pair)], m, model)
        with torch.no_grad():
            o = compute_logits(share, cfg, pv, ids, mask, tp=tp)
            loss = forward_train(share, cfg, batch, group=dgroup, tp=tp)["losses"]["loss"]
        res[_name(pair)] = {"logits": o["logits"], "maps": o["similarity_scores"], "loss": loss}
    cfg = _alt_cfg("radzero_torch", GRAD_PAIR)
    share = tpar.shard_params(inputs["alt"][_name(GRAD_PAIR)], m, model)
    res["bert_loss"], res["bert_grads"] = _grads(share, cfg, batch, dgroup=dgroup, tp=tp)
    clip_text = _alt_cfg("radzero_torch", ("clip", "clip_text", False))
    try:
        forward_text(share, clip_text, ids, mask, tp=tp)
        res["clip_text_raised"] = None
    except NotImplementedError as e:
        res["clip_text_raised"] = str(e)

    tp_batch = _to_torch(_data_share(inputs["tp_batch"], d, data))
    share = tpar.shard_params(inputs["params"], m, model)
    for impl in IMPLS:
        base = _cfg(tconf, TP_VOCAB)
        c = dataclasses.replace(base, align=dataclasses.replace(base.align, attn_impl=impl))
        plain = _grads(share, c, tp_batch, dgroup=dgroup, tp=tp)
        kept = _grads(share, c, tp_batch, dgroup=dgroup, tp=tp, remat=True)
        res[f"save_attn_{impl}_same"] = torch.equal(plain[0], kept[0]) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(plain[1]), tree_leaves(kept[1])))
        res[f"save_attn_{impl}_grads"] = kept[1]

    specs = tpar.param_specs(inputs["params"], model)
    cfg = _cfg(tconf, TP_VOCAB)
    with torch.no_grad():
        a = forward_train(share, cfg, tp_batch, group=dgroup, tp=tp)["losses"]["loss"]
        b = forward_train(merge_lora(share, inputs["lora0"], tp=tp, specs=specs), cfg, tp_batch,
                          group=dgroup, tp=tp)["losses"]["loss"]
    res["lora_identity"] = torch.equal(a, b)
    res["lora_loss"], res["lora_grads"] = _lora_grads(share, inputs["lora"], cfg, tp_batch,
                                                      dgroup=dgroup, tp=tp, specs=specs)
    lora = {**inputs["lora"], "adapters": _clone(inputs["lora"]["adapters"])}
    opt, _ = build_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=4)
    state = opt.init(lora["adapters"])
    for _ in range(2):
        _, grads = _lora_grads(share, lora, cfg, tp_batch, dgroup=dgroup, tp=tp, specs=specs)
        opt.update(grads, state, lora["adapters"])
    res["lora_stepped"] = tree_leaves(lora["adapters"])

    if data == 1:
        res["trainer"] = _cache_runs(out, dgroup, tp)
    else:
        from radzero_torch.tools.flagship_width_dryrun import dryrun

        res["dryrun"] = dryrun(_cfg(tconf, TP_VOCAB), steps=2, images=4, data=data,
                               model=model, dgroup=dgroup, tp=tp, device="cpu",
                               sentences_per_image=2, text_len=10)
    torch.save(res, os.path.join(out, f"rank{r}.pt"))


def _cache_trainer(out, name, cache=None, group=None, tp=None, process=(0, 1)):
    """A trainer over test_torch_trainer's 16 records, batch 4 a data rank,
    CACHE_EPOCHS epochs, the loader emitting record indices."""
    from radzero_torch.data.pipeline import PackSpec, TrainLoader
    from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
    from radzero_torch.train import trainer as ttrainer
    from test_torch_trainer import CFG, _records

    recs, image_loader = _records(16)
    tok = WhitespaceHashTokenizer(vocab_size=5003, max_length=10)
    spec = PackSpec(max_sentences_per_image=2, max_text_tokens=10)
    shard = dict(process_index=process[0], process_count=process[1],
                 stable_sharding=process[1] > 1)
    args = ttrainer.TrainerArgs(output_dir=os.path.join(out, name), learning_rate=1e-3,
                                num_train_epochs=CACHE_EPOCHS, warmup_steps=1,
                                logging_steps=1, bf16=False, seed=0, save_total_limit=1)
    return ttrainer.RadZeroTrainer(
        CFG, args, TrainLoader(recs, image_loader, tok, 4, spec, seed=0, num_threads=2,
                               with_indices=True, **shard),
        TrainLoader(recs[:8], image_loader, tok, 4, spec, seed=0, shuffle=False,
                    num_threads=2, **shard),
        device="cpu", tower_cache=cache, group=group, tp=tp)


def _cache_runs(out, group, tp, process=(0, 1)):
    """The trainer without the cache, with a ram cache and with a memmap cache
    from cli/run.py's tower_cache_from: each run's step losses, final leaves
    and cache statistics."""
    from radzero_torch.cli.run import tower_cache_from
    from radzero_torch.parallel.dist import rank, world
    from radzero_torch.train.tower_cache import TowerCache

    glob, size = rank(torch.distributed.group.WORLD), world(torch.distributed.group.WORLD)
    caches = {"none": None, "ram": TowerCache("ram"),
              "memmap": tower_cache_from({"train": {"tower_cache": "memmap"}},
                                         os.path.join(out, "mm"), 16, glob, size)}
    runs = {}
    for name, cache in caches.items():
        t = _cache_trainer(out, f"cache_{name}", cache, group, tp, process)
        t.train()
        runs[name] = {"losses": [h["loss"] for h in t.state.log_history if "lr" in h],
                      "leaves": [p.clone() for p in tree_leaves(t.trainable)],
                      "stats": None if cache is None else cache.stats(),
                      "path": getattr(cache, "path", None)}
    return runs


def _data_rank(group, out, inputs_path):
    """One rank of {data: 2, model: 1}: accumulation, LoRA, the tower cache's
    step and trainer; results to out/rank{r}.pt."""
    from radzero_torch.parallel.dist import mesh_groups
    from radzero_torch.train.tower_cache import make_tower_fn

    inputs = torch.load(inputs_path, weights_only=False)
    r = torch.distributed.get_rank()
    dgroup, tp = mesh_groups(2, 1)
    cfg = _cfg(tconf, TP_VOCAB)
    res = {}
    res["acc"] = _accumulate(inputs["params"], cfg, [_to_torch(_data_share(b, r, 2))
                                                     for b in _acc_batches()], dgroup)
    tp_batch = _to_torch(_data_share(inputs["tp_batch"], r, 2))
    res["lora_loss"], res["lora_grads"] = _lora_grads(inputs["params"], inputs["lora"], cfg,
                                                      tp_batch, dgroup=dgroup)
    # a step from the cache's tokens of this rank's images
    tokens = make_tower_fn(cfg, dtype=torch.float32)(inputs["params"]["vision_model"],
                                                     tp_batch["pixel_values"])
    cached = {k: v for k, v in tp_batch.items() if k != "pixel_values"} | {"tower_tokens": tokens}
    res["cache_loss"], res["cache_grads"] = _grads(inputs["params"], cfg, cached, dgroup=dgroup)
    res["trainer"] = _cache_runs(out, dgroup, None, process=(r, 2))
    torch.save(res, os.path.join(out, f"rank{r}.pt"))


def _acc_batches():
    """Two batches a pair of micro-steps: the second with the images reversed."""
    a = _batch(TP_VOCAB)
    b = dict(a, pixel_values=a["pixel_values"][::-1].copy())
    return [a, b] * (ACC_STEPS // 2)


def _accumulate(params, cfg, batches, dgroup=None):
    """ACC_STEPS make_train_step steps at gradient_accumulation_steps 2: each
    step's losses, the first moment after each update, the final leaves."""
    from radzero_torch.train.optim import build_optimizer, partition_params
    from radzero_torch.train.step import make_train_step

    trainable, frozen = partition_params(_clone(params), TRAINABLE)
    opt, _ = build_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=ACC_STEPS,
                             gradient_accumulation_steps=2)
    state = opt.init(trainable)
    step = make_train_step(cfg, opt, dtype=torch.float32, device="cpu", group=dgroup)
    out = {"losses": [], "mu": []}
    for i, batch in enumerate(batches):
        trainable, state, losses = step(trainable, frozen, state, batch)
        out["losses"].append({k: v.item() for k, v in losses.items()})
        if i % 2:
            out["mu"].append([t.clone() for t in state["mu"]])
    out["leaves"] = tree_leaves(trainable)
    return out


MODES = {"1x2": _grid_rank, "2x2": _grid_rank, "2x1": _data_rank}


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

def _jax_alt_tree(pair, seed):
    import jax

    from radzero_tpu.models.radzero import init_radzero as jax_init_radzero
    from test_torch_sam import perturbed

    tree = jax_init_radzero(jax.random.PRNGKey(seed), _alt_cfg("radzero_tpu", pair))
    return perturbed(tree, np.random.default_rng(seed))


def _jax_lora(tree, seed=3):
    """JAX init_lora with every b moved off zero, so a's gradient is not 0."""
    import jax

    from radzero_tpu.train import lora as jlora

    lora = jlora.init_lora(jax.random.PRNGKey(seed), tree, LORA_TARGETS, r=4, alpha=8)
    rng = np.random.default_rng(seed)
    adapters = {k: {"a": np.asarray(ab["a"]),
                    "b": (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
                for k, ab in lora["adapters"].items()}
    return {**lora, "adapters": adapters}


def _jax_on_mesh(tree, jcfg, batch, prompts=None, grad_of=None, lora=None):
    """The JAX package on the {data: 4, model: 2} mesh, parameters sharded by
    the JAX rules, the batch on data: compute_logits and forward_train's loss;
    or jax.grad of the loss over the ``grad_of`` modules (the tower frozen);
    or over ``lora``'s adapters, merged into the sharded tree (``merge_lora``
    then the JAX rules' shardings)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from radzero_tpu.models.radzero import compute_logits as jax_compute_logits
    from radzero_tpu.models.radzero import forward_train as jax_forward_train
    from radzero_tpu.parallel.sharding_rules import param_shardings
    from radzero_tpu.parallel.sharding_rules import shard_params as jax_shard_params
    from radzero_tpu.train import lora as jlora

    mesh = _jax_mesh()
    tree = jax.tree_util.tree_map(jnp.asarray, tree)
    sharded = jax_shard_params(tree, mesh)
    sb = {k: jax.device_put(v, NamedSharding(mesh, P("data"))) for k, v in batch.items()}
    if lora is not None:
        shardings = param_shardings(tree, mesh)

        def lora_loss(tr):
            merged = jlora.merge_lora(sharded, jlora.with_trainable(lora, tr))
            merged = jax.lax.with_sharding_constraint(merged, shardings)
            return jax_forward_train(merged, jcfg, sb, dtype=jnp.float32)["losses"]["loss"]

        tr = jax.tree_util.tree_map(jnp.asarray, jlora.lora_trainable(lora))
        return jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(lora_loss))(tr))
    if grad_of is not None:
        trainable = {k: v for k, v in sharded.items() if k in grad_of}
        frozen = {k: v for k, v in sharded.items() if k not in grad_of}

        def loss(t):
            return jax_forward_train({**t, **frozen}, jcfg, sb, dtype=jnp.float32,
                                     stop_vision_gradient=True)["losses"]["loss"]

        return jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(trainable))
    fn = jax.jit(lambda p, a, b, c: jax_compute_logits(p, jcfg, a, b, c))
    out = fn(sharded, jnp.asarray(batch["pixel_values"]), jnp.asarray(prompts[0]),
             jnp.asarray(prompts[1]))
    loss = jax.jit(lambda p, b: jax_forward_train(p, jcfg, b)["losses"]["loss"])(sharded, sb)
    return {"logits": np.asarray(out["logits"]), "maps": np.asarray(out["similarity_scores"]),
            "loss": float(loss)}


def _xla_cfg(jcfg):
    """The JAX composite on its xla routes (eager attention, no Pallas)."""
    return dataclasses.replace(
        jcfg, vision=dataclasses.replace(jcfg.vision, attn_impl="xla"),
        align=dataclasses.replace(jcfg.align, attn_impl="xla"),
        text=dataclasses.replace(jcfg.text, fuse_post=False),
        loss=dataclasses.replace(jcfg.loss, train_impl="xla"))


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """The inputs, each grid's rank results and the references: the ranks of
    the three grids run while this process computes the JAX mesh's and the
    port's one-process references."""
    from radzero_torch.models.from_jax import lora_from_jax, params_from_jax
    from radzero_tpu.models import configuration as jconf
    from test_torch_tensor_parallel import _jax_tree

    alt_batch, prompts, pmask = _alt_batch()
    alt_trees = {_name(p): _jax_alt_tree(p, i + 1) for i, p in enumerate(PAIRS)}
    tree = _jax_tree(TP_VOCAB)
    jlora = _jax_lora(tree)
    lora = lora_from_jax(jlora)
    lora0 = {**lora, "adapters": {k: {"a": ab["a"], "b": torch.zeros_like(ab["b"])}
                                  for k, ab in lora["adapters"].items()}}
    inputs = {"alt": {k: params_from_jax(t) for k, t in alt_trees.items()},
              "alt_batch": alt_batch, "prompts": (prompts, pmask),
              "params": params_from_jax(tree), "tp_batch": _batch(TP_VOCAB),
              "lora": lora, "lora0": lora0}
    out = {"inputs": inputs, "ranks": {}, "dirs": {}}
    runs, errors = {}, []

    def run(grid, tmp):
        data, model = (int(v) for v in grid.split("x"))
        try:
            runs[grid] = run_ranks(tmp, __file__, grid, world=data * model, timeout_s=600,
                                   args=(tmp / "inputs.pt",))
        except BaseException as e:  # noqa: BLE001 - raised again below, in this thread
            errors.append(e)

    threads = []
    for grid in GRIDS + ("2x1",):
        tmp = tmp_path_factory.mktemp(f"tppaths{grid}")
        torch.save(inputs, tmp / "inputs.pt")
        threads.append(threading.Thread(target=run, args=(grid, tmp)))
        threads[-1].start()
    try:
        out["jax"] = {k: _jax_on_mesh(alt_trees[k], _alt_cfg("radzero_tpu", p), alt_batch,
                                      (prompts, pmask)) for k, p in zip(alt_trees, PAIRS)}
        jcfg = _alt_cfg("radzero_tpu", GRAD_PAIR)
        out["jax_bert_grads"] = params_from_jax(_jax_on_mesh(
            alt_trees[_name(GRAD_PAIR)], jcfg, alt_batch, grad_of=TRAINABLE))
        tcfg = _xla_cfg(_cfg(jconf, TP_VOCAB))
        out["jax_grads"] = params_from_jax(_jax_on_mesh(tree, tcfg, _batch(TP_VOCAB),
                                                        grad_of=TRAINABLE))
        out["jax_lora_grads"] = lora_from_jax({**jlora, "adapters": _jax_on_mesh(
            tree, tcfg, _batch(TP_VOCAB), lora=jlora)["adapters"]})["adapters"]
        out["one"] = _one_process(inputs)
    finally:
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    for grid, res in runs.items():
        data, model = (int(v) for v in grid.split("x"))
        out["ranks"][grid] = [torch.load(res / f"rank{r}.pt", weights_only=False)
                              for r in range(data * model)]
        out["dirs"][grid] = res
    return out


def _one_process(inputs):
    """The port's tp=None references on the whole batches."""
    from radzero_torch.models.radzero import compute_logits, forward_train

    alt = _to_torch(inputs["alt_batch"])
    ids, mask = (torch.from_numpy(a) for a in inputs["prompts"])
    one = {}
    for pair in PAIRS:
        cfg = _alt_cfg("radzero_torch", pair)
        params = inputs["alt"][_name(pair)]
        with torch.no_grad():
            o = compute_logits(params, cfg, alt["pixel_values"], ids, mask)
            loss = forward_train(params, cfg, alt)["losses"]["loss"]
        one[_name(pair)] = {"logits": o["logits"], "maps": o["similarity_scores"], "loss": loss}
    cfg = _alt_cfg("radzero_torch", GRAD_PAIR)
    one["bert_grads"] = _grads(inputs["alt"][_name(GRAD_PAIR)], cfg, alt)[1]
    cfg = _cfg(tconf, TP_VOCAB)
    whole = _to_torch(inputs["tp_batch"])
    one["acc"] = _accumulate(inputs["params"], cfg, [_to_torch(b) for b in _acc_batches()])
    one["lora_loss"], one["lora_grads"] = _lora_grads(inputs["params"], inputs["lora"], cfg,
                                                      whole)
    one["grads"] = _grads(inputs["params"], cfg, whole)
    return one


def _trainable_specs(params):
    specs = tpar.param_specs(params, MODEL)
    return {k: specs[k] for k in TRAINABLE}


def _whole(ranks, key, params):
    """The whole tree from data rank 0's model group of ``key`` shares."""
    return tpar.unshard_params([ranks[m][key] for m in range(MODEL)], _trainable_specs(params))


def _tp_grad_gate(cfg):
    return _chip_smoke().tp_grad_gate(cfg)


# ---------------------------------------------------------------------------
# param_specs against the JAX rules
# ---------------------------------------------------------------------------

def _jax_specs_match(tree, port_tree, label):
    """Every JAX leaf's spec against the port's spec of the same leaf (a
    stacked JAX leaf against each layer's, the layer dimension off)."""
    import jax

    from radzero_tpu.parallel.sharding_rules import param_shardings

    specs = tpar.param_specs(port_tree, MODEL)
    split = 0
    for path, sharding in jax.tree_util.tree_leaves_with_path(param_shardings(tree,
                                                                             _jax_mesh())):
        names = [getattr(k, "key", getattr(k, "idx", k)) for k in path]
        want = tuple(sharding.spec)
        node = tpar._at(tree, names[:2]) if len(names) > 2 else None
        if names[1:2] == ["layers"] and isinstance(node, dict):  # stacked: one spec a layer
            layers = port_tree[names[0]]["layers"]
            rest = names[2:]
            if rest[0] == "attn" and rest[1] in ("q", "k", "v") and "qkv" in layers[0]["attn"]:
                rest = ["attn", "qkv", rest[2]]  # the port's packed [q | k | v]
            for layer in range(len(layers)):
                got = tpar._at(specs, [names[0], "layers", layer, *rest])
                assert got == want[1:], (label, names, got, want)
                split += bool(got)
        else:
            got = tpar._at(specs, names)
            assert got == want, (label, names, got, want)
            split += bool(got)
    assert split > 0, label
    return specs


@pytest.mark.parametrize("vision", sorted(VISION))
def test_param_specs_match_jax_on_alternate_towers(vision):
    """param_specs equals the JAX param_shardings on each alternate vision
    tower's tree, and BERT's beside it (its word and position rows split,
    token_type whole); SAM's packed qkv and proj stay whole, its MLP splits."""
    from radzero_torch.models.from_jax import params_from_jax

    text = "bert" if vision != "sam" else "mpnet"
    tree = _jax_alt_tree((vision, text, False), 0)
    specs = _jax_specs_match(tree, params_from_jax(tree), vision)
    layer = specs["vision_model"]["layers"][0]
    assert layer["mlp"]["fc1"]["kernel"] == (None, "model")
    assert layer["mlp"]["fc2"]["kernel"] == ("model", None)
    if vision == "sam":
        assert layer["qkv"]["kernel"] == () and layer["proj"]["kernel"] == ()
    else:
        assert layer["attn"]["q"]["kernel"] == (None, "model")
        assert layer["attn"]["o"]["kernel"] == ("model", None)
        emb = specs["text_model"]["embeddings"]
        assert emb["word"] == emb["position"] == ("model", None) and emb["token_type"] == ()


@pytest.mark.parametrize("packed", [False, True])
def test_share_of_takes_a_rank_share_by_spec(packed):
    """share_of by a column, row and packed spec against shard_params of the
    same leaf; a replicated spec gives the tensor itself."""
    t = torch.arange(4 * 12, dtype=torch.float32).reshape(4, 12)
    path = ("layers", 0, "attn", "qkv" if packed else "q", "kernel")
    spec = tpar.spec_for(path, t, 2)
    assert spec == (None, "model")
    tree = {"layers": [{"attn": {path[3]: {"kernel": t}}}]}
    for r in range(2):
        want = tpar.shard_params(tree, r, 2)["layers"][0]["attn"][path[3]]["kernel"]
        assert torch.equal(tpar.share_of(t, spec, r, 2, packed), want)
    assert tpar.share_of(t.T, ("model", None), 1, 2).shape == (6, 4)
    assert tpar.share_of(t, (), 1, 2) is t


# ---------------------------------------------------------------------------
# the alternate towers over the grids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("pair", PAIRS, ids=_name)
def test_alternate_towers_match_jax_mesh_and_one_process(grids, grid, pair):
    """compute_logits (the data ranks' images in order) and forward_train's
    loss over the grid against the JAX composite on the mesh and within
    tp_fp32_gate of the port's one process; every rank of a model group the
    same bits."""
    ranks = grids["ranks"][grid]
    data, model = (int(v) for v in grid.split("x"))
    name = _name(pair)
    ref, one = grids["jax"][name], grids["one"][name]
    gate = _fp32_gate(_alt_cfg("radzero_torch", pair))
    for d in range(data):
        group = ranks[d * model:(d + 1) * model]
        for res in group[1:]:
            for k in ("logits", "maps", "loss"):
                assert torch.equal(res[name][k], group[0][name][k]), (d, k)
    logits = torch.cat([ranks[d * model][name]["logits"] for d in range(data)]).numpy()
    maps = torch.cat([ranks[d * model][name]["maps"] for d in range(data)]).numpy()
    assert logits.shape == ref["logits"].shape and maps.shape == ref["maps"].shape
    np.testing.assert_allclose(logits, ref["logits"], rtol=1e-3, atol=2e-4)
    assert np.abs(maps - ref["maps"]).mean() < 1e-3
    _within_gate(logits, one["logits"].numpy(), gate)
    _within_gate(maps, one["maps"].numpy(), gate)
    for res in ranks:
        np.testing.assert_allclose(res[name]["loss"].item(), ref["loss"], rtol=3e-5)
        _within_gate(res[name]["loss"].item(), one["loss"].item(), gate)
        assert torch.equal(res[name]["loss"], ranks[0][name]["loss"])


@pytest.mark.parametrize("grid", GRIDS)
def test_bert_gradient_tree_matches_jax_mesh_and_one_process(grids, grid):
    """BERT trainable (its split word and position rows through embed_rows'
    identity backward): the gradient tree put back together against jax.grad
    on the mesh at 2e-4 of each leaf's largest value and against the port's
    tp=None within tp_grad_gate; the replicated leaves' gradients bit-equal
    across the model group; the CLIP text tower still raises under the group,
    as without it."""
    ranks = grids["ranks"][grid]
    params = grids["inputs"]["alt"][_name(GRAD_PAIR)]
    whole = _whole(ranks, "bert_grads", params)
    _leaf_gate(whole, grids["jax_bert_grads"], 2e-4, f"{grid} vs JAX")
    cfg = _alt_cfg("radzero_torch", GRAD_PAIR)
    _leaf_gate(whole, grids["one"]["bert_grads"], _tp_grad_gate(cfg), f"{grid} vs one")
    split = tpar.split_leaves(_trainable_specs(params))
    for res in ranks[1:MODEL]:
        for s, a, b in zip(split, tree_leaves(res["bert_grads"]),
                           tree_leaves(ranks[0]["bert_grads"])):
            assert s or torch.equal(a, b)
    assert any(split)
    for res in ranks:
        assert "in composite model" in res["clip_text_raised"]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("impl", IMPLS)
def test_save_attn_on_packed_and_flash_over_the_model_axis(grids, grid, impl):
    """remat's save_attn on the packed / flash align layers over the group:
    the loss and every gradient leaf bit-equal to the same ranks without
    remat; the tree against jax.grad on the mesh (the JAX xla route) at 2e-4
    of each leaf's largest value."""
    ranks = grids["ranks"][grid]
    for res in ranks:
        assert res[f"save_attn_{impl}_same"]
    whole = _whole(ranks, f"save_attn_{impl}_grads", grids["inputs"]["params"])
    _leaf_gate(whole, grids["jax_grads"], 2e-4, f"{grid} {impl} vs JAX")


@pytest.mark.parametrize("grid", GRIDS + ("2x1",))
def test_lora_over_the_grid(grids, grid):
    """LoRA over the grid: at init the merged forward is the base bit for bit
    (model grids); the adapters' gradients (each rank's whole, bit-equal on
    every rank) against jax.grad of the JAX merge_lora on the sharded tree
    at 2e-4 (+ 1e-7); after two AdamW steps the adapters bit-equal on every
    rank; over {data: 2, model: 1} against one process with the whole batch
    at the step gate."""
    ranks = grids["ranks"][grid]
    keys = sorted(grids["inputs"]["lora"]["adapters"])
    ref = grids["jax_lora_grads"]
    one = tree_leaves(grids["one"]["lora_grads"])
    for res in ranks:
        grads = tree_unflatten(res["lora_grads"], grids["inputs"]["lora"]["adapters"])
        assert sorted(grads) == keys
        _leaf_gate(grads, ref, 2e-4, f"{grid} LoRA vs JAX")
        for a, b in zip(res["lora_grads"], ranks[0]["lora_grads"]):
            assert torch.equal(a, b)
        if grid == "2x1":
            np.testing.assert_allclose(res["lora_loss"].item(),
                                       grids["one"]["lora_loss"].item(), rtol=1e-5)
            for a, b in zip(res["lora_grads"], one):
                assert np.abs((a - b).numpy()).max() <= 2e-4 * np.abs(b.numpy()).max() + 1e-7
        else:
            _within_gate(res["lora_loss"].item(), grids["one"]["lora_loss"].item(),
                         _fp32_gate(_cfg(tconf, TP_VOCAB)))
            assert res["lora_identity"]
            for a, b in zip(res["lora_stepped"], ranks[0]["lora_stepped"]):
                assert torch.equal(a, b)


def _same_runs(runs, label):
    """The cached runs' losses and final leaves equal the uncached run's."""
    for name in ("ram", "memmap"):
        assert runs[name]["losses"] == runs["none"]["losses"], (label, name)
        assert all(torch.equal(a, b) for a, b in zip(runs[name]["leaves"],
                                                     runs["none"]["leaves"])), (label, name)
        stats = runs[name]["stats"]
        assert stats["misses"] > 0 and stats["hits"] > 0 and stats["cached_records"] > 0


@pytest.mark.parametrize("grid", ("1x2", "2x1"))
def test_trainer_tower_cache_over_the_grid(grids, grid):
    """RadZeroTrainer with the tower cache over a model group (1x2) and over
    two data ranks with stable_sharding (2x1): the ram and memmap runs'
    losses and weights bit-equal to the uncached run on each rank; over the
    model group the same hits and misses on both ranks; each rank's memmap
    cache in its own rank{r} directory with its own files."""
    ranks = grids["ranks"][grid]
    for r, res in enumerate(ranks):
        _same_runs(res["trainer"], f"{grid} rank {r}")
    paths = [res["trainer"]["memmap"]["path"] for res in ranks]
    assert len(set(paths)) == len(paths)
    for r, path in enumerate(paths):
        assert os.path.basename(path) == f"rank{r}"
        assert os.path.exists(os.path.join(path, "tokens.dat"))
    if grid == "1x2":
        for name in ("ram", "memmap"):
            assert ranks[0]["trainer"][name]["stats"] == ranks[1]["trainer"][name]["stats"]
            assert ranks[0]["trainer"][name]["losses"] == ranks[1]["trainer"][name]["losses"]


def test_cached_step_over_data_ranks_matches_one_process(grids):
    """A step from the tower cache's tokens on each of two data ranks against
    one process's step on the whole batch's pixels: the loss at rtol 1e-5 and
    the averaged gradients at 2e-4 of each leaf's largest value (+ 1e-7),
    the same on both ranks."""
    ranks = grids["ranks"]["2x1"]
    loss, grads = grids["one"]["grads"]
    for res in ranks:
        np.testing.assert_allclose(res["cache_loss"].item(), loss.item(), rtol=1e-5)
        _leaf_gate(res["cache_grads"], grads, 2e-4, "cached step vs one process")
        for a, b in zip(tree_leaves(res["cache_grads"]), tree_leaves(ranks[0]["cache_grads"])):
            assert torch.equal(a, b)


def test_gradient_accumulation_over_data_ranks(grids):
    """make_train_step at gradient_accumulation_steps 2 over two data ranks
    against one process with the whole batch: every step's losses (rtol
    1e-5, grad_norm 1e-4), the first moment after each update (the clipped
    mean of the two micro-steps' gradients, scaled by 1 - b1) at 2e-4 of each
    leaf's largest value + 1e-7, the ranks' parameters bit-equal."""
    ranks = grids["ranks"]["2x1"]
    one = grids["one"]["acc"]
    a, b = ranks[0]["acc"], ranks[1]["acc"]
    assert len(a["losses"]) == ACC_STEPS and len(a["mu"]) == ACC_STEPS // 2
    for i, (got, ref) in enumerate(zip(a["losses"], one["losses"])):
        assert got == b["losses"][i]
        for k in ref:
            tol = 1e-4 if k == "grad_norm" else 1e-5
            np.testing.assert_allclose(got[k], ref[k], rtol=tol, atol=1e-6, err_msg=f"{i} {k}")
    for got, ref in zip(a["mu"], one["mu"]):
        for x, y in zip(got, ref):
            assert np.abs((x - y).numpy()).max() <= 2e-4 * np.abs(y.numpy()).max() + 1e-7
    for x, y in zip(a["leaves"], b["leaves"]):
        assert torch.equal(x, y)
    assert all(bool(m.abs().max() > 0) for m in a["mu"][-1])


def test_dryrun_core_holds_its_gates(grids):
    """flagship_width_dryrun's core on {data: 2, model: 2} at small widths:
    rank 0's record holds the JAX tool's keys, the sharded losses within 5e-4
    of the control's and the eval logits' MAE <= 2e-4; the other ranks
    return None."""
    from radzero_torch.tools.flagship_width_dryrun import check

    ranks = grids["ranks"]["2x2"]
    rec = ranks[0]["dryrun"]
    assert all(res["dryrun"] is None for res in ranks[1:])
    for key in ("mesh", "widths", "params_m", "tp_sharded_leaves", "losses_sharded",
                "losses_control", "max_loss_drift", "sharded_eval_logits_mae"):
        assert key in rec, key
    assert rec["mesh"] == {"data": 2, "model": 2} and len(rec["losses_sharded"]) == 2
    assert rec["tp_sharded_leaves"] > 20
    assert rec["max_loss_drift"] <= 5e-4 * max(abs(v) for v in rec["losses_control"])
    assert rec["sharded_eval_logits_mae"] <= 2e-4
    check(rec)
    json.dumps(rec)


def test_dryrun_counts_split_leaves_as_the_jax_tool():
    """At the flagship's widths over a model axis of two, the split leaves
    counted as the JAX tool counts its stacked ones (a path once for all its
    layers, a packed qkv as q, k and v): FLAGSHIP_WIDTH_r05.json's 31. The
    count reads widths, not depth, so each tower keeps one layer here."""
    from radzero_torch.models.radzero import init_radzero
    from radzero_torch.tools.flagship_width_dryrun import flagship_config, stacked_split_count

    cfg = flagship_config()
    cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, num_hidden_layers=1),
        align=dataclasses.replace(cfg.align, num_hidden_layers=1),
        text=dataclasses.replace(cfg.text, num_hidden_layers=1))
    params = init_radzero(torch.Generator().manual_seed(0), cfg)
    assert stacked_split_count(tpar.param_specs(params, 2)) == 31


def test_cli_trains_over_a_model_axis_with_the_memmap_cache(tmp_path):
    """torchrun, two gloo ranks, train.mesh {data: 1, model: 2} and
    train.tower_cache memmap over two epochs: the run trains, and each rank
    holds its own cache directory, rank{r} under output_dir/tower_cache."""
    import yaml

    from test_cli_end_to_end import workspace as make_workspace

    root, cfg_path = make_workspace.__wrapped__(_Factory(tmp_path))
    cfg = yaml.safe_load(open(cfg_path))
    cfg["experiment"]["output_root_dir"] = str(tmp_path / "out")
    cfg["train"].update(mesh={"data": 1, "model": 2}, per_device_train_batch_size=4,
                        per_device_eval_batch_size=4, echo=1, num_train_epochs=2,
                        tower_cache="memmap")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "radzero_torch.cli.run", "--cfg_path", str(path), "--train", "true",
         "--inference", "false", "--no_report", "--device", "cpu", "--name", "tpcache"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-6000:]
    out = tmp_path / "out" / "pt" / "debug" / "tpcache"
    rows = [json.loads(line) for line in open(out / "log_history.jsonl")]
    assert [r["step"] for r in rows if "lr" in r] == [1, 2, 3, 4]
    for r in range(2):
        cache = out / "tower_cache" / f"rank{r}"
        meta = json.loads((cache / "meta.json").read_text())
        assert meta["shape"][0] == 16
        assert np.fromfile(cache / "present.dat", np.uint8).all()


if __name__ == "__main__":
    rank_main(MODES)
