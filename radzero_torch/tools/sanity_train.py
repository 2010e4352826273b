#!/usr/bin/env python
"""End-to-end learning sanity: the core RadZero claim in miniature
(counterpart of tools/sanity_train.py).

Synthetic task: each image contains a bright blob in one of four
quadrants; its paired "finding sentence" names the quadrant. Training
with MP-NCE over VL-CABS must (a) drive retrieval accuracy above
chance, and (b) make the *pre-softmax similarity map* localise the blob:
zero-shot grounding emerging without any box supervision, which is
exactly the paper's central claim (arXiv:2504.07416). The vision tower is
frozen (the reference finetune policy, radzero.yaml:50); only the align,
text and loss trees train.

The model is D = 64 with 2 tower, 2 align and 2 text layers, trained for
``--steps`` AdamW steps at batch ``--batch`` in fp32, then scored on 64
held-out examples: retrieval reads the logits, pointing the 4 x 4 map of
the true prompt.

Heads: the JAX tool runs 4 heads of 16 (``--heads 4``, the default). The
port's kernels take a head width of 64 only (``ops/flash_attention.py``,
``ops/fused_layer.py``), and ``forward_train`` always runs the tower on
K1-K3, so on the card the tool runs ``--heads 1``: D = 64, head width 64,
F = 128, which the kernels take. There a step launches K1-K3 in the tower
and the align layers, K6-K8 in the align layers, K4 / K9 in MPNet
(``fuse_post``) and K10-K12 once; the eval's ``compute_logits`` K1-K4 and
K5. On the CPU (``--device cpu``) the wrappers run their plain twins, at
any head count.

Run:  python -m radzero_torch.tools.sanity_train [--steps 150] [--batch 32]
          [--lr 3e-4] [--heads 1] [--device cuda|cpu]
Prints one JSON line with the JAX tool's keys (first and last loss,
retrieval and pointing accuracy, chance) and the device it ran on.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from radzero_torch.tools import device_name

QUADRANTS = ["upper left", "upper right", "lower left", "lower right"]
TRAINABLE = ("align_transformer", "text_model", "loss_fns")
D, TEXT_LEN, N_EVAL = 64, 12, 64


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


def sanity_config(heads: int = 4):
    """The JAX tool's D = 64 configuration with ``heads`` heads in each tower."""
    from radzero_torch.models.configuration import (
        AlignConfig, LossConfig, RadZeroConfig, TextConfig, ViTConfig,
    )

    return RadZeroConfig(
        vision=ViTConfig(hidden_size=D, num_hidden_layers=2, num_attention_heads=heads,
                         mlp_ratio=2.0, patch_size=14, pretrain_img_size=56, img_size=56),
        text=TextConfig(hidden_size=D, num_hidden_layers=2, num_attention_heads=heads,
                        intermediate_size=128, vocab_size=30527, max_position_embeddings=40),
        align=AlignConfig(hidden_size=D, num_hidden_layers=2, num_attention_heads=heads,
                          mlp_ratio=2.0),
        loss=LossConfig(hidden_dim=D),
    )


def tokenizer():
    from radzero_torch.data.tokenizer import WhitespaceHashTokenizer

    return WhitespaceHashTokenizer(max_length=TEXT_LEN)


def batch_of(rng, tok, n, make=make_example):
    """``n`` examples drawn from ``rng`` as a training batch (numpy)."""
    imgs, texts = [], []
    for _ in range(n):
        x, t, _ = make(rng)
        imgs.append(x)
        texts.append(t)
    ids, mask = tok(texts, TEXT_LEN)
    return {
        "pixel_values": np.stack(imgs),
        "input_ids": ids,
        "attention_mask": mask,
        "group_map": np.arange(n, dtype=np.int32),
        "row_mask": np.ones(n, np.float32),
    }


def init_params(cfg, device, seed: int = 0):
    """The port's weights from ``seed`` (the tool's run: 0), drawn on the CPU's
    generator and moved to ``device``: a run on the card and one on the CPU start
    from the same weights, as the JAX tool's key draws the same on every backend."""
    from radzero_torch.models.radzero import init_radzero
    from radzero_torch.utils.tree import tree_leaves, tree_unflatten

    params = init_radzero(torch.Generator().manual_seed(seed), cfg)
    return tree_unflatten([leaf.to(device) for leaf in tree_leaves(params)], params)


def train(cfg, params, rng, tok, *, steps, batch, lr, device, make=make_example,
          on_step=None):
    """``steps`` fp32 AdamW steps over fresh batches from ``rng`` with the tower
    frozen -> (trainable, frozen, losses a step). ``on_step(i, losses)`` sees
    each step's loss tensors."""
    from radzero_torch.data.pipeline import to_device
    from radzero_torch.train.optim import build_optimizer, partition_params
    from radzero_torch.train.step import make_train_step

    trainable, frozen = partition_params(params, TRAINABLE)
    opt, _ = build_optimizer(learning_rate=lr, warmup_steps=10, total_steps=steps)
    opt_state = opt.init(trainable)
    step = make_train_step(cfg, opt, dtype=torch.float32, device=device)
    history = []
    for i in range(steps):
        trainable, opt_state, losses = step(trainable, frozen, opt_state,
                                            to_device(batch_of(rng, tok, batch, make), device))
        history.append(float(losses["loss"]))
        if on_step is not None:
            on_step(i, losses)
    return trainable, frozen, history


def eval_set(rng, n=N_EVAL, make=make_example):
    """``n`` held-out examples: (images (n, 56, 56, 3), quadrant labels)."""
    imgs, labels = [], []
    for _ in range(n):
        x, _, q = make(rng)
        imgs.append(x)
        labels.append(q)
    return np.stack(imgs), labels


def score(params, cfg, imgs, labels, tok, device, quadrants=QUADRANTS):
    """Retrieval and pointing accuracy of ``compute_logits`` (fp32) over the
    four quadrant prompts -> (retrieval, pointing, logits, maps)."""
    from radzero_torch.models.radzero import compute_logits

    prompts = [f"There is opacity in the {q} lung" for q in quadrants]
    ids, mask = tok(prompts, TEXT_LEN)
    with torch.no_grad():
        out = compute_logits(params, cfg, torch.from_numpy(imgs).to(device),
                             torch.from_numpy(ids).long().to(device),
                             torch.from_numpy(mask).long().to(device), dtype=torch.float32)
    logits = out["logits"].cpu().numpy()              # (n, 4)
    maps = out["similarity_scores"].cpu().numpy()     # (n, 4, 16)
    correct = pointed = 0
    for i, q in enumerate(labels):
        if logits[i].argmax() == q:
            correct += 1
        grid = maps[i, q].reshape(4, 4)
        gy, gx = np.unravel_index(grid.argmax(), (4, 4))
        if (gy < 2) == (q < 2) and (gx < 2) == (q % 2 == 0):
            pointed += 1
    n = len(labels)
    return correct / n, pointed / n, logits, maps


def run(steps=150, batch=32, lr=3e-4, heads=4, device="cuda", params=None) -> dict:
    """The JAX tool's ``main`` as a function: -> its record, with the device.
    ``params``: the weights to start from (default: :func:`init_params`)."""
    cfg = sanity_config(heads)
    tok = tokenizer()
    if params is None:
        params = init_params(cfg, device)
    rng = np.random.default_rng(0)
    trainable, frozen, history = train(cfg, params, rng, tok, steps=steps, batch=batch, lr=lr,
                                       device=device)
    imgs, labels = eval_set(rng)
    retrieval, pointing, _, _ = score({**trainable, **frozen}, cfg, imgs, labels, tok, device)
    return {
        "first_loss": round(history[0], 4),
        "last_loss": round(history[-1], 4),
        "retrieval_accuracy": retrieval,
        "pointing_accuracy": pointing,
        "chance": 0.25,
        "device": device_name(device),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--heads", type=int, default=4,
                   help="heads in each tower (the card's kernels need 1: head width 64)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu to run on the CPU)")
    print(json.dumps(run(args.steps, args.batch, args.lr, args.heads, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
