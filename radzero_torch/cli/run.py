"""Training + zero-shot evaluation entry point (port of radzero_tpu/cli/run.py).

Rebuild of exp/cxr_pt/run.py:18-169: config (base + ordered overlays +
CLI), output-dir/snapshot setup, model + data wiring, training with
early stopping, then the zero-shot suite from the best checkpoint.

Usage:
    python -m radzero_torch.cli.run --add_cfg_list radzero paths \
        [--train true] [--inference true] [--compute_metric true]
        [--no_report] [--user U] [--name N] [--device cuda|cpu]

The flags are the JAX CLI's, plus ``--device`` (default ``cuda``; the
tests pass ``cpu``). Without a CUDA device, ``--device cuda`` raises: the
run never falls back to the CPU. The port runs one card: ``train.mesh``
must be ``{data: -1}`` or ``{data: 1}``, and the JAX CLI's multi-process
``DistributedInference`` has no counterpart yet (ROADMAP.md, modules still
to port, item 6). The JAX compilation cache has no counterpart either; the
kernels are built once per checkout (``ops/_build.py``).

``model.pretrained_ckpt`` names a directory that
``python -m radzero_torch.tools.convert_checkpoint`` wrote (its
``state.pt``), read onto the tree the config initialises, as the JAX CLI
reads the JAX converter's output.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import torch

from radzero_torch.config.config import Config, str2bool
from radzero_torch.data.mimic import load_datasets
from radzero_torch.data.pipeline import PackSpec, TrainLoader, pil_image_loader
from radzero_torch.data.processing import build_image_processor
from radzero_torch.data.tokenizer import load_tokenizer
from radzero_torch.eval.inference import Inference
from radzero_torch.eval.scorer import ZeroShotScorer
from radzero_torch.models.configuration import radzero_config_from_dict
from radzero_torch.models.radzero import init_radzero
from radzero_torch.train.trainer import RadZeroTrainer, TrainerArgs
from radzero_torch.utils.experiment import code_snapshot, output_directory_setting
from radzero_torch.utils.logging import load_logger
from radzero_torch.utils.profiling import debug_flags


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="RadZero (PyTorch port) train/eval entry")
    default_cfg = os.path.join(os.path.dirname(__file__), "..", "config", "defaults.yaml")
    p.add_argument("--cfg_path", default=os.path.abspath(default_cfg))
    p.add_argument("--add_cfg_list", nargs="*", default=[])
    p.add_argument("--train", type=str2bool, default=True)
    p.add_argument("--inference", type=str2bool, default=True)
    p.add_argument("--compute_metric", type=str2bool, default=True)
    p.add_argument("--no_report", action="store_true")
    p.add_argument("--user", default=None)
    p.add_argument("--name", default=None)
    p.add_argument("--resume_from_checkpoint", type=str2bool, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu to "
                           "run on the CPU)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    return device


def check_mesh(mesh: dict) -> None:
    """The port runs one card: every mesh axis must be -1 (all devices) or 1."""
    bad = {k: v for k, v in (mesh or {}).items() if v not in (-1, 1)}
    if bad:
        raise NotImplementedError(
            f"train.mesh {mesh}: the port runs one card (data -1 or 1); data parallelism "
            "over several cards is ROADMAP.md, modules still to port, item 6")


def build_everything(cfg: dict, seed: int = 42, device="cuda"):
    """Wire model config, params, processor, tokenizer from the config dict
    (ref load_model, exp/cxr_pt/model/__init__.py:14-55). The weights come
    from ``torch.Generator(device).manual_seed(seed)``, as the trainer's
    ``params=None`` builds them, or from ``model.pretrained_ckpt``."""
    model_block = cfg["model"]
    model_cfg = radzero_config_from_dict(model_block["model_config"])

    loss_block = model_block["model_config"].get("loss") or {}
    loss_apply = tuple(loss_block.get("apply", ["RadZeroLoss"]))
    loss_ratio = dict(zip(loss_apply, loss_block.get("ratio", [1.0] * len(loss_apply))))

    g = torch.Generator(device=device).manual_seed(seed)
    params = init_radzero(g, model_cfg, loss_apply=loss_apply)
    pretrained = model_block.get("pretrained_ckpt")
    if pretrained:
        from radzero_torch.train.checkpoint import restore_checkpoint

        params = restore_checkpoint(pretrained, params)

    image_processor = build_image_processor(model_block["model_config"]["vision_config"])
    tokenizer = load_tokenizer(
        model_block["model_config"]["text_config"].get("pretrained_tokenizer_name_or_path"),
        max_length=cfg["train"].get("max_text_tokens", 64),
    )
    return model_cfg, params, image_processor, tokenizer, loss_apply, loss_ratio


def pack_spec(cfg: dict, loss_apply) -> PackSpec:
    train = cfg["train"]
    return PackSpec(
        max_sentences_per_image=train.get("max_sentences_per_image", 8),
        max_text_tokens=train.get("max_text_tokens", 64),
        text_length_buckets=tuple(train.get("text_length_buckets", ())),
        # opt-in sentence dedup (PackSpec.dedup_slots): encode only the
        # unique sentences of a batch
        dedup_slots=int(train.get("dedup_slots", 0)),
        # CLIP / SigLIP aux losses consume one random positive per image
        # (ref dataset.py:164-170 encoded_random_key_phrases)
        with_random_positive=any(n in ("OpenClipLoss", "OpenSigLipLoss") for n in loss_apply),
    )


def trainer_args(cfg: dict, output_dir: str, loss_ratio: dict) -> TrainerArgs:
    train, exp = cfg["train"], cfg["experiment"]
    return TrainerArgs(
        output_dir=output_dir,
        learning_rate=float(train["learning_rate"]),
        num_train_epochs=train["num_train_epochs"],
        weight_decay=train.get("weight_decay", 0.05),
        max_grad_norm=train.get("max_grad_norm", 1.0),
        warmup_steps=train.get("warmup_steps", 50),
        logging_steps=train.get("logging_steps", 10),
        save_total_limit=train.get("save_total_limit"),
        early_stopping_patience=exp.get("early_stopping_patience"),
        bf16=train.get("bf16", True),
        gradient_checkpointing=train.get("gradient_checkpointing", False),
        gradient_accumulation_steps=train.get("gradient_accumulation_steps", 1),
        seed=train.get("seed", 42),
        module_to_update=tuple(
            cfg["model"].get("module_to_update", ["align_transformer", "text_model", "loss_fns"])
        ),
        loss_ratio=loss_ratio,
        report_to=exp.get("report_to", "none"),
    )


def tower_cache_from(cfg: dict, output_dir: str, n_records: int):
    """``train.tower_cache``: "ram" | "memmap" | "device", or a dict with
    ``backing`` (and ``path`` for memmap); None when unset."""
    tc_cfg = cfg["train"].get("tower_cache")
    if not tc_cfg:
        return None
    from radzero_torch.train.tower_cache import TowerCache

    if isinstance(tc_cfg, str):
        tc_cfg = {"backing": tc_cfg}
    backing = tc_cfg.get("backing", "ram")
    if backing == "memmap":
        return TowerCache("memmap", path=tc_cfg.get("path") or os.path.join(
            output_dir, "tower_cache"), n_records=n_records)
    if backing == "device":
        return TowerCache("device", n_records=n_records)
    # TowerCache validates the string: a YAML typo raises here
    return TowerCache(backing)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config(args).config
    check_mesh(cfg["train"].get("mesh", {"data": -1}))
    logger = load_logger()
    output_dir = output_directory_setting(cfg, logger)
    code_snapshot(cfg, output_dir)
    debug_flags(nans=bool(cfg["train"].get("debug_nans", False)),
                deterministic=bool(cfg["train"].get("full_determinism", False)))

    seed = cfg["train"].get("seed", 42)
    model_cfg, params, image_processor, tokenizer, loss_apply, loss_ratio = build_everything(
        cfg, seed=seed, device=device)
    spec = pack_spec(cfg, loss_apply)

    if cfg["args"]["train"]:
        datasets = load_datasets(cfg["dataset"], train=True)
        loader = pil_image_loader(image_processor)
        tower_cache = tower_cache_from(cfg, output_dir, len(datasets["train"]))
        train_loader = TrainLoader(
            datasets["train"], loader, tokenizer, cfg["train"]["per_device_train_batch_size"],
            spec, seed=seed, with_indices=tower_cache is not None,
            # train.echo: data echoing, each decoded batch yields `echo`
            # optimizer steps (TrainLoader docstring)
            echo=int(cfg["train"].get("echo", 1)),
        )
        eval_loader = TrainLoader(
            datasets["eval"], loader, tokenizer, cfg["train"]["per_device_eval_batch_size"],
            spec, shuffle=False,
        )
        trainer = RadZeroTrainer(
            model_cfg, trainer_args(cfg, output_dir, loss_ratio), train_loader, eval_loader,
            params=params, device=device, tower_cache=tower_cache,
        )
        resume = cfg["args"].get("resume_from_checkpoint")
        if resume is None:
            resume = cfg["experiment"].get("resume_from_checkpoint", False)
        trainer.train(resume_from_checkpoint=resume or None)
        params = trainer.params

    # post-train zero-shot suite from the best model, fp32 (ref run.py:123-169)
    if cfg["args"]["inference"]:
        inf = cfg["inference"]
        scorer = ZeroShotScorer(params, model_cfg, image_processor, tokenizer, device=device,
                                batch_size=inf["batch_size"], dtype=torch.float32)
        inference = Inference(inf["cls_dataset"], inf["det_dataset"], inf["seg_dataset"],
                              cfg["dataset"]["data_root"], batch_size=inf["batch_size"])
        save_dir = os.path.join(output_dir, "inference")
        inference.classification(scorer, os.path.join(save_dir, "classification"),
                                 compute_metric=cfg["args"].get("compute_metric", True))
        inference.grounding(scorer, os.path.join(save_dir, "grounding"))
        inference.segmentation(scorer, os.path.join(save_dir, "segmentation"),
                               inf.get("compute_pixel_level_auroc", False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
