"""Visualization CLI (port of radzero_tpu/cli/visualize.py).

Rebuild of the reference's visualization entry
(exp/cxr_pt/inference/visualize.py + the per-file __main__ study
scripts — the working paths, since the top-level entry there calls a
nonexistent method, SURVEY.md §2 C22 note). Runs the requested studies
from a trained checkpoint over one image or dataset samples.

Usage:
    python -m radzero_torch.cli.visualize --ckpt CKPT_DIR --image x.jpg \
        --studies open_vocab positional pos_neg --save_dir out/
    python -m radzero_torch.cli.visualize --ckpt CKPT_DIR \
        --dataset ChestXDet10 --data_root /data --save_dir out/

The flags are the JAX CLI's, plus ``--device`` (default ``cuda``: it
raises without a card; the tests pass ``cpu``) and ``--config``. The model
is ``RadZeroConfig()`` (the flagship: 518 px, 1370 tokens) with weights
from ``torch.Generator(device).manual_seed(0)``, or the dims of a
``--config`` JSON (the YAML ``model.model_config`` block), as
``radzero_torch.eval.server`` reads it. ``--ckpt`` is a
``checkpoint-<step>/`` directory whose ``state.pt`` holds that whole
parameter tree, written by ``radzero_torch.train.checkpoint.save_checkpoint``:
the JAX CLI restores the same tree (``restore_checkpoint(ckpt, params)``),
not the trainer's ``{trainable, opt_state}`` state, which this CLI refuses
with the tree's difference. ``--tokenizer`` is a ``vocab.txt`` or a
directory holding one; without it the hash tokenizer runs (the JAX default,
a hub name, would reach for the network). bf16 by default, ``--fp32`` for
the parity protocol.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import torch

from radzero_torch.cli import resolve_device
from radzero_torch.data.processing import build_image_processor
from radzero_torch.data.tokenizer import load_tokenizer
from radzero_torch.eval.scorer import ZeroShotScorer
from radzero_torch.models.configuration import RadZeroConfig, radzero_config_from_dict
from radzero_torch.models.radzero import init_radzero
from radzero_torch.utils.logging import load_logger

STUDIES = ["open_vocab", "positional", "pos_neg", "anatomy", "disease", "disease_map",
           "open_vocab_seg"]


def build_scorer(args, device: torch.device) -> ZeroShotScorer:
    logger = load_logger()
    cfg = RadZeroConfig()
    if args.config:
        with open(args.config) as f:
            cfg = radzero_config_from_dict(json.load(f))
    params = init_radzero(torch.Generator(device).manual_seed(0), cfg)
    if args.ckpt:
        from radzero_torch.train.checkpoint import restore_checkpoint

        params = restore_checkpoint(args.ckpt, params)
        logger.info(f"loaded checkpoint {args.ckpt}")
    processor = build_image_processor({"model_type": "dinov2", "img_size": cfg.vision.img_size})
    tokenizer = load_tokenizer(args.tokenizer)
    return ZeroShotScorer(params, cfg, processor, tokenizer, device=device,
                          batch_size=args.batch_size,
                          dtype=torch.float32 if args.fp32 else torch.bfloat16)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default=None)
    p.add_argument("--tokenizer", default=None,
                   help="vocab.txt or a directory holding one (default: the hash tokenizer)")
    p.add_argument("--config", default=None,
                   help="model_config JSON for other dims than RadZeroConfig()'s")
    p.add_argument("--image", default=None)
    p.add_argument("--dataset", default=None,
                   choices=[None, "ChestXDet10", "SIIM", "RSNA"])
    p.add_argument("--data_root", default=None)
    p.add_argument("--save_dir", default="viz_out")
    p.add_argument("--studies", nargs="*", default=["open_vocab"], choices=STUDIES)
    p.add_argument("--top_k_percent", type=float, default=None,
                   help="open_vocab_seg: keep only the top-k%% of each map")
    p.add_argument("--prompts", nargs="*", default=None)
    p.add_argument("--num_samples", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)
    if args.dataset and not args.data_root:
        p.error("--data_root required with --dataset")
    return args


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    scorer = build_scorer(args, resolve_device(args.device))
    os.makedirs(args.save_dir, exist_ok=True)

    if args.image:
        from radzero_torch.viz.segmap import anatomy_segmentation, disease_segmentation
        from radzero_torch.viz.studies import (
            open_vocab_study,
            pos_neg_prompt_study,
            positional_prompt_study,
        )

        for study in args.studies:
            if study == "open_vocab":
                open_vocab_study(scorer, args.image, args.save_dir, args.prompts)
            elif study == "positional":
                positional_prompt_study(scorer, args.image, args.save_dir)
            elif study == "pos_neg":
                findings = args.prompts or ["Pneumothorax", "Pleural Effusion", "Cardiomegaly"]
                pos_neg_prompt_study(scorer, args.image, args.save_dir, findings)
            elif study == "anatomy":
                anatomy_segmentation(scorer, args.image, args.save_dir)
            elif study == "disease":
                disease_segmentation(scorer, args.image, args.save_dir)
            elif study == "disease_map":
                from radzero_torch.viz.qualitative import process_and_visualize_map

                texts = args.prompts or ["There is Pneumothorax"]
                process_and_visualize_map(scorer, args.image, texts, args.save_dir)
            elif study == "open_vocab_seg":
                from radzero_torch.viz.qualitative import (
                    process_and_visualize_segmentation,
                )

                texts = args.prompts or [
                    "There is Pneumothorax", "There is Cardiomegaly",
                ]
                process_and_visualize_segmentation(
                    scorer, args.image, texts, args.save_dir, k=args.top_k_percent
                )

    if args.dataset:
        from radzero_torch.viz.studies import (
            visualize_chestxdet10_samples,
            visualize_rsna_samples,
            visualize_siim_samples,
        )

        fn = {
            "ChestXDet10": visualize_chestxdet10_samples,
            "SIIM": visualize_siim_samples,
            "RSNA": visualize_rsna_samples,
        }[args.dataset]
        fn(scorer, args.data_root, args.save_dir, args.num_samples)


if __name__ == "__main__":
    main()
