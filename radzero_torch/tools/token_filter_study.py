#!/usr/bin/env python
"""Attention-aware token filtering: measured accuracy/throughput trade
(counterpart of tools/token_filter_study.py).

The flag-gated mechanism (``ViTConfig.token_filter_ratio``, PAPERS.md
arXiv 2506.01519; ``radzero_torch/models/vit.py`` ``token_filter_indices``)
needs numbers, not just a switch. Two measurements in one run:

1. Accuracy: train the sanity-harness quadrant-localisation task once
   (``radzero_torch/tools/sanity_train.py``: its D = 64 model, the tower
   frozen, fp32; this tool's own sentences), then evaluate retrieval and
   pointing accuracy with the filter off and at each ratio before tower
   layer 1. The filter is a serving-time knob, so train-once / eval-many is
   the real deployment shape.
2. Throughput (on the card only): the flagship 12-layer tower
   (``vit_forward(impl="fused")``: K1-K3 a layer) in bf16 on 64 images of
   518 px at each ratio, the filter before layer 6; images/s from CUDA
   events around 5 calls after a synchronize, the best of 2 runs.

``--heads`` is the sanity harness's (4, the JAX value, by default; the
card's kernels need 1, see sanity_train.py).

Run:  python -m radzero_torch.tools.token_filter_study [--steps 150] [--batch 32]
          [--ratios 0 0.25 0.5] [--skip_flagship] [--heads 1] [--device cuda|cpu]
Prints one JSON object with the JAX tool's table (``ratio_<r>``:
retrieval and pointing accuracy, ``flagship_tower_imgs_per_sec`` on the
card) and the device it ran on.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from radzero_torch.tools import device_name
from radzero_torch.tools import sanity_train as sanity

QUADRANTS = ["left upper", "right upper", "left lower", "right lower"]


def make_example(rng, img=56):
    q = int(rng.integers(4))
    x = rng.standard_normal((img, img, 3)).astype(np.float32) * 0.1
    half = img // 2
    oy = 0 if q < 2 else half
    ox = 0 if q % 2 == 0 else half
    cy = oy + int(rng.integers(6, half - 6))
    cx = ox + int(rng.integers(6, half - 6))
    x[cy - 5 : cy + 5, cx - 5 : cx + 5] += 2.0
    text = f"There is opacity in the {QUADRANTS[q]} lung"
    return x, text, q


def filtered(cfg, ratio: float, layer: int):
    """``cfg`` (a RadZeroConfig) with the tower's filter at ``ratio`` before ``layer``."""
    return dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, token_filter_ratio=ratio, token_filter_layer=layer))


def accuracy_table(params, cfg, ratios, device, *, steps, batch, on_step=None):
    """Train the sanity task once from ``params``, then score it at each ratio
    (filter before layer 1) -> ({"ratio_<r>": {retrieval, pointing}},
    {ratio: (logits, maps)}, the trained weights)."""
    tok = sanity.tokenizer()
    rng = np.random.default_rng(0)
    trainable, frozen, _ = sanity.train(cfg, params, rng, tok, steps=steps, batch=batch,
                                        lr=3e-4, device=device, make=make_example,
                                        on_step=on_step)
    params = {**trainable, **frozen}
    imgs, labels = sanity.eval_set(rng, make=make_example)
    table, outputs = {}, {}
    for ratio in ratios:
        retrieval, pointing, logits, maps = sanity.score(
            params, filtered(cfg, ratio, 1), imgs, labels, tok, device, QUADRANTS)
        table[f"ratio_{ratio}"] = {"retrieval_accuracy": retrieval,
                                   "pointing_accuracy": pointing}
        outputs[ratio] = (logits, maps)
        print(f"eval ratio {ratio}: {table[f'ratio_{ratio}']}", file=sys.stderr, flush=True)
    return table, outputs, params


def flagship_tower(device, images=64, size=518, seed=0):
    """The flagship tower's bf16 weights (``attn_impl="fused"``) from ``seed`` and
    ``images`` bf16 pixel arrays of ``size`` px on ``device``."""
    from radzero_torch.eval.serving import cast_params
    from radzero_torch.models.configuration import ViTConfig
    from radzero_torch.models.vit import init_vit

    cfg = ViTConfig(attn_impl="fused", img_size=size)
    g = torch.Generator(device=device).manual_seed(seed)
    params = cast_params(init_vit(g, cfg), torch.bfloat16, device)
    pv = torch.randn((images, size, size, 3), generator=g, device=device).to(torch.bfloat16)
    return cfg, params, pv


def tower_at(cfg, params, pv, ratio: float, layer: int = 6):
    """One bf16 fused-route tower call with the filter at ``ratio`` before ``layer``."""
    from radzero_torch.models.vit import vit_forward

    c = dataclasses.replace(cfg, token_filter_ratio=ratio, token_filter_layer=layer)
    with torch.no_grad():
        return vit_forward(params, c, pv, dtype=torch.bfloat16, impl="fused")


def imgs_per_sec(cfg, params, pv, ratio: float, *, runs=2, calls=5) -> float:
    """Images/s of the tower at ``ratio``: CUDA events around ``calls`` calls
    after a warm call and a synchronize, the best of ``runs``."""
    tower_at(cfg, params, pv, ratio)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(runs):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(calls):
            tower_at(cfg, params, pv, ratio)
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / 1e3 / calls)
    return pv.shape[0] / best


def run(steps=150, batch=32, ratios=(0.0, 0.25, 0.5), skip_flagship=False, heads=4,
        device="cuda") -> dict:
    """The JAX tool's ``main`` as a function -> its table, with the device."""
    cfg = sanity.sanity_config(heads)

    def log(i, losses):
        if i % 25 == 0:
            print(f"train step {i}: loss={float(losses['loss']):.4f}", file=sys.stderr,
                  flush=True)

    table, _, _ = accuracy_table(sanity.init_params(cfg, device), cfg, ratios, device,
                              steps=steps, batch=batch, on_step=log)
    if not skip_flagship and torch.device(device).type == "cuda":
        fcfg, fparams, pv = flagship_tower(device)
        for ratio in ratios:
            table[f"ratio_{ratio}"]["flagship_tower_imgs_per_sec"] = round(
                imgs_per_sec(fcfg, fparams, pv, ratio), 1)
    table["device"] = device_name(device)
    return table


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--ratios", type=float, nargs="*", default=[0.0, 0.25, 0.5])
    p.add_argument("--skip_flagship", action="store_true")
    p.add_argument("--heads", type=int, default=4,
                   help="heads in each tower of the sanity model (the card's kernels need 1)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu to run on the CPU)")
    print(json.dumps(run(args.steps, args.batch, args.ratios, args.skip_flagship, args.heads,
                         args.device), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
