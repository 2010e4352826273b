"""Train and eval steps (port of radzero_tpu/train/step.py).

One step is forward + backward + clip + AdamW update over the trainable
subtree. The trainable leaves are the fp32 master weights; the forward
casts them to the compute ``dtype`` where it uses them, and autograd
carries the gradient back through the cast into fp32. Every sub-loss is
returned per step, with ``grad_norm``, the global norm before clipping.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from radzero_torch.models.configuration import RadZeroConfig
from radzero_torch.models.radzero import forward_train
from radzero_torch.train.optim import (
    AdamW,
    global_norm,
    merge_params,
    tree_leaves,
)


def make_train_step(
    cfg: RadZeroConfig,
    optimizer: AdamW,
    *,
    loss_ratio: Optional[Dict[str, float]] = None,
    dtype=torch.bfloat16,
    stop_vision_gradient: Optional[bool] = None,
    device="cuda",
) -> Callable:
    """Build ``train_step(trainable, frozen, opt_state, batch) ->
    (trainable, opt_state, losses)``. ``trainable`` is updated in place
    and returned. The step runs on ``device`` (the card unless the caller
    asks for the CPU): the batch is moved there, and parameters that lie
    elsewhere raise.

    ``stop_vision_gradient=None`` resolves at call time: when the vision
    tower sits in the frozen subtree it runs without a tape."""

    dev = torch.device(device)

    def train_step(trainable, frozen, opt_state, batch):
        stop = stop_vision_gradient
        if stop is None:
            stop = "vision_model" not in trainable
        leaves = tree_leaves(trainable)
        _check_device(leaves + tree_leaves(frozen), dev)
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                out = forward_train(merge_params(trainable, frozen), cfg, batch,
                                    loss_ratio=loss_ratio, dtype=dtype,
                                    stop_vision_gradient=stop)
                losses = out["losses"]
                grads = torch.autograd.grad(losses["loss"], leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        # a flat list in the order of tree_leaves is a gradient tree too
        opt_state = optimizer.update(grads, opt_state, trainable)
        losses = {k: v.detach() for k, v in losses.items()}
        losses["grad_norm"] = global_norm(grads)
        return trainable, opt_state, losses

    return train_step


def make_eval_step(
    cfg: RadZeroConfig,
    *,
    loss_ratio: Optional[Dict[str, float]] = None,
    dtype=torch.bfloat16,
    device="cuda",
) -> Callable:
    """Build ``eval_step(params, batch) -> losses``: the training forward
    without a tape, on ``device``."""
    dev = torch.device(device)

    @torch.no_grad()
    def eval_step(params, batch):
        _check_device(tree_leaves(params), dev)
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        out = forward_train(params, cfg, batch, loss_ratio=loss_ratio, dtype=dtype)
        return out["losses"]

    return eval_step


def _check_device(leaves, dev: torch.device) -> None:
    for p in leaves:
        if p.device.type != dev.type or (dev.index is not None and p.device.index != dev.index):
            raise ValueError(f"a parameter lies on {p.device}, the step runs on {dev}")
