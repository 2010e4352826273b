"""Flagship-width sharded dry run over a (data x model) grid (counterpart of
tools/flagship_width_dryrun.py).

The real widths (ViT-B/14 at 518 px: 768 wide, 12 heads, 1370 tokens; the
2-layer align adapter; MPNet-base) through:

1. ``--steps`` sharded ``make_train_step(group=, tp=)`` steps on ``{data: D,
   model: M}``: the JAX package's Megatron rules at the real head counts
   (q / k / v 768 -> 768 / M columns, 12 / M heads a rank; the MLP 3072 ->
   3072 / M), the contrastive gathers over the data group, the AdamW update,
   against a one-process control on the same weights and batches;
2. one sharded ``compute_logits`` batch (the images over the data ranks, the
   weights over each model group) against the one-process logits.

Every rank builds the same weights from ``--seed`` and takes its share
(``parallel/tensor_parallel.py``); global rank 0 runs the control in its
own process and writes the record, with the keys of the JAX tool's
(``mesh``, ``widths``, ``params_m``, ``tp_sharded_leaves``,
``losses_sharded``, ``losses_control``, ``max_loss_drift``,
``sharded_eval_logits_mae``). ``tp_sharded_leaves`` counts the split leaves
as the JAX tool counts its stacked ones: a path once for all its layers, a
packed qkv as q, k and v (31 at the flagship over two ranks). The run
fails when the losses drift from the control's by more than 5e-4 of them
(the JAX tool's rtol) or the logits by a mean of more than 2e-4.

The layers run their default routes: on the card the hand kernels (K1-K4,
K6-K12, over the model group K3 / K4 row-parallel and K6 / K8 / K9 split at
their all-reduces), on the CPU their plain twins. The run is fp32.

Run (the process group from torchrun's environment, NCCL on the cards, one
card a rank):

    python -m torch.distributed.run --nproc_per_node 4 \\
        -m radzero_torch.tools.flagship_width_dryrun --data 2 --model 2 --json OUT

or without a launcher, which starts D x M gloo ranks itself (on one card
they share it; ``--device cpu`` runs them on the CPU):

    python -m radzero_torch.tools.flagship_width_dryrun [--data 2] [--model 2]
        [--steps 2] [--batch 8] [--seed 0] [--json OUT] [--device cuda|cpu]

:func:`dryrun` is the core; it takes the configuration, so a test can run
it at small widths.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

TRAINABLE = ("align_transformer", "text_model", "loss_fns")
PROMPTS = ("There is pneumothorax", "There is no pneumothorax", "There is pleural effusion")
LOSS_RTOL, EVAL_MAE = 5e-4, 2e-4


def flagship_config():
    """The flagship RadZero at its published widths, the default routes."""
    from radzero_torch.models.configuration import (
        AlignConfig, LossConfig, RadZeroConfig, TextConfig, ViTConfig,
    )

    return RadZeroConfig(vision=ViTConfig(), text=TextConfig(), align=AlignConfig(),
                         loss=LossConfig())


def batches(cfg, steps: int, images: int, sentences_per_image: int = 4, text_len: int = 32,
            seed: int = 0):
    """``steps`` global batches from ``seed``: pixels at the tower's size,
    ``sentences_per_image`` sentences of ``text_len`` ids an image."""
    rng = np.random.default_rng(seed)
    size, s = cfg.vision.img_size, images * sentences_per_image
    top = min(30000, cfg.text.vocab_size)
    out = []
    for _ in range(steps):
        out.append({
            "pixel_values": torch.from_numpy(
                rng.standard_normal((images, size, size, 3)).astype(np.float32)),
            "input_ids": torch.from_numpy(rng.integers(3, top, (s, text_len))),
            "attention_mask": torch.ones((s, text_len), dtype=torch.int64),
            "group_map": torch.from_numpy(np.repeat(np.arange(images), sentences_per_image)),
            "row_mask": torch.ones(s),
        })
    return out


def _rows(batch: Dict[str, torch.Tensor], d: int, data: int) -> dict:
    """Data rank d's rows of a global batch (``group_map`` stays global)."""
    return {k: v[d * (len(v) // data):(d + 1) * (len(v) // data)] for k, v in batch.items()}


def stacked_split_count(specs) -> int:
    """Split leaves of a spec tree as the JAX tool counts them: a path once for
    all its layers (the JAX package stacks a tower's layers in one leaf), a
    packed ``qkv`` leaf as three (the JAX tree keeps q, k and v apart)."""
    paths = set()

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif isinstance(tree, list):
            for v in tree:
                walk(v, path + ("*",))
        elif tree:
            names = ("q", "k", "v") if path[-2:-1] == ("qkv",) else (path[-2],)
            paths.update(path[:-2] + (n, path[-1]) for n in names)

    walk(specs, ())
    return len(paths)


def _steps(cfg, params, data_batches, device, **kw):
    """The losses of one make_train_step per batch from ``params``."""
    from radzero_torch.train.optim import build_optimizer, partition_params
    from radzero_torch.train.step import make_train_step

    trainable, frozen = partition_params(params, TRAINABLE)
    trainable = {k: _clone(v) for k, v in trainable.items()}
    opt, _ = build_optimizer(total_steps=1000)
    state = opt.init(trainable)
    step = make_train_step(cfg, opt, dtype=torch.float32, device=device, **kw)
    losses = []
    for batch in data_batches:
        trainable, state, out = step(trainable, frozen, state, batch)
        losses.append(out["loss"].item())
    return losses


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def dryrun(cfg, *, steps: int, images: int, data: int, model: int, dgroup=None, tp=None,
           device="cuda", seed: int = 0, sentences_per_image: int = 4,
           text_len: int = 32) -> Optional[dict]:
    """The sharded steps and eval batch on this rank of a (``data`` x
    ``model``) grid whose data group is ``dgroup`` and model group ``tp``
    (:func:`radzero_torch.parallel.dist.mesh_groups`; both None for a world of
    one), ``images`` images a global batch. Every rank of the grid calls it.
    -> the record on global rank 0 (its control run in this process), None
    on the others."""
    from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
    from radzero_torch.models.radzero import compute_logits, init_radzero
    from radzero_torch.parallel.collectives import gather_rows
    from radzero_torch.parallel.tensor_parallel import param_specs, shard_params, tp_rank

    device = torch.device(device)
    me = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
    d, m = divmod(me, model)
    if tp is not None:
        assert tp_rank(tp) == m
    params = init_radzero(torch.Generator(device=device).manual_seed(seed), cfg)
    specs = param_specs(params, model)
    share = shard_params(params, m, model)
    data_batches = batches(cfg, steps, images, sentences_per_image, text_len, seed)
    t0 = time.perf_counter()
    sharded = _steps(cfg, share, [_rows(b, d, data) for b in data_batches], device,
                     group=dgroup, tp=tp, specs=specs)
    step_s = time.perf_counter() - t0

    tok = WhitespaceHashTokenizer(vocab_size=cfg.text.vocab_size, max_length=16)
    ids, mask = (torch.as_tensor(a).long().to(device) for a in tok(list(PROMPTS)))
    rng = np.random.default_rng(seed + 1)
    size = cfg.vision.img_size
    pv = torch.from_numpy(rng.standard_normal((2 * data, size, size, 3)).astype(np.float32))
    with torch.no_grad():
        mine = compute_logits(share, cfg, pv[2 * d:2 * d + 2].to(device), ids, mask,
                              tp=tp)["logits"]
        logits = mine if dgroup is None else gather_rows(mine, dgroup)
    if me != 0:
        return None
    control = _steps(cfg, params, data_batches, device)
    with torch.no_grad():
        single = compute_logits(params, cfg, pv.to(device), ids, mask)["logits"]
    drift = max(abs(a - c) for a, c in zip(sharded, control))
    n_params = sum(t.numel() for t in _leaves(params))
    return {
        "metric": "flagship_width_sharded_dryrun",
        "mesh": {"data": data, "model": model},
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "widths": {"vision_d": cfg.vision.hidden_size, "heads": cfg.vision.num_attention_heads,
                   "tokens": (size // cfg.vision.patch_size) ** 2 + 1,
                   "align_layers": cfg.align.num_hidden_layers,
                   "text_d": cfg.text.hidden_size, "batch": images,
                   "sentence_rows": images * sentences_per_image},
        "params_m": round(n_params / 1e6, 1),
        "tp_sharded_leaves": stacked_split_count(specs),
        "steps": steps,
        "losses_sharded": sharded,
        "losses_control": control,
        "max_loss_drift": drift,
        "max_loss_drift_rel": max(abs(a - c) / abs(c) for a, c in zip(sharded, control)),
        "sharded_eval_logits_mae": (logits - single).abs().mean().item(),
        "sharded_step_s": step_s,
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def check(record: dict) -> None:
    """Raise when the record misses the dry run's gates (see the module
    docstring)."""
    if not all(np.isfinite(record["losses_sharded"])):
        raise AssertionError(f"sharded losses not finite: {record['losses_sharded']}")
    if record["max_loss_drift_rel"] > LOSS_RTOL:
        raise AssertionError(f"the sharded losses {record['losses_sharded']} drift from the "
                             f"control's {record['losses_control']} by more than {LOSS_RTOL}")
    if not record["sharded_eval_logits_mae"] <= EVAL_MAE:
        raise AssertionError(f"sharded eval logits MAE {record['sharded_eval_logits_mae']} > "
                             f"{EVAL_MAE}")


def _rank(args, rank: int, world: int, init: Optional[str]) -> Optional[dict]:
    """Join the grid as ``rank`` of ``world`` (torchrun's environment when
    ``init`` is None) and run the dry run."""
    from radzero_torch.parallel.dist import init_distributed, local_rank, mesh_groups

    cuda = args.device == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        index = local_rank() if init is None else rank % torch.cuda.device_count()
        torch.cuda.set_device(index)
        device = torch.device("cuda", index)
    else:
        device = torch.device("cpu")
    group = None
    if world > 1:
        backend = "nccl" if cuda and init is None else "gloo"
        kw = {} if init is None else {"init_method": init, "rank": rank, "world_size": world}
        group = init_distributed(backend=backend, **kw)
    try:
        dgroup, tp = (None, None) if group is None else mesh_groups(args.data, args.model)
        return dryrun(flagship_config(), steps=args.steps, images=args.batch, data=args.data,
                      model=args.model, dgroup=dgroup, tp=tp, device=device, seed=args.seed)
    finally:
        if group is not None:
            torch.distributed.destroy_process_group()


def _spawn(args, argv) -> int:
    """Start the grid's gloo ranks as child processes of this module and wait
    for them; a rank that fails stops the others."""
    world = args.data * args.model
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, "-m", __spec__.name, *argv, "--rank",
                                   str(r), "--init", f"file://{tmp}/store"])
                 for r in range(world)]
        try:
            while True:
                codes = [p.poll() for p in procs]
                if None not in codes or any(c not in (None, 0) for c in codes):
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return max(abs(p.returncode) for p in procs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8, help="images a global batch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, help="write the record here too")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu to run on the CPU)")
    world = args.data * args.model
    if "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != world:
            raise SystemExit(f"a {args.data} x {args.model} grid needs {world} ranks, torchrun "
                             f"started {os.environ['WORLD_SIZE']}")
        record = _rank(args, int(os.environ["RANK"]), world, None)
    elif args.rank is not None:
        record = _rank(args, args.rank, world, args.init)
    elif world > 1:
        return _spawn(args, argv)
    else:
        record = _rank(args, 0, 1, None)
    if record is None:
        return 0
    print(json.dumps(record))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=2)
    check(record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
