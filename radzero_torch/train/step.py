"""Train and eval steps (port of radzero_tpu/train/step.py).

One step is forward + backward + clip + AdamW update over the trainable
subtree. The trainable leaves are the fp32 master weights; the forward
casts them to the compute ``dtype`` where it uses them, and autograd
carries the gradient back through the cast into fp32. Every sub-loss is
returned per step, with ``grad_norm``, the global norm before clipping.

With ``group`` (a process group) the step is data-parallel, the
counterpart of the JAX step over a data mesh: each rank runs the forward
and backward on its share of the batch, the loss meets the global batch
through its gathers, and the gradients are averaged over the ranks
(:func:`radzero_torch.parallel.collectives.average_gradients`) before the
clip and the update, so every rank holds the same parameters bit for bit.
The factor: every rank computes the same global loss, and each gather's
backward sums over the ranks, so a rank's own contribution to a gradient
arrives P times; the average over P ranks of these is the one-process
gradient of the global batch.

With ``tp`` (a model group) as well, the step runs on a (data x model)
grid: ``trainable`` and ``frozen`` are this rank's shares
(:func:`radzero_torch.parallel.tensor_parallel.shard_params`), the ranks of
a model group take the same batch, and the forward and backward split at
the model axis's all-reduces (``models/radzero.py``). A split leaf's
gradient is the rank's share and a replicated leaf's is whole and bit-equal
on every rank of the group, so the average runs over the data group only,
and the clip and the reported ``grad_norm`` read the whole tree's norm
(:func:`radzero_torch.train.optim.global_norm` over ``tp``), which keeps
the replicated leaves bit-equal across the group after every update.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from radzero_torch.models.configuration import RadZeroConfig
from radzero_torch.models.radzero import forward_train
from radzero_torch.parallel.collectives import average_gradients
from radzero_torch.parallel.tensor_parallel import active, split_leaves
from radzero_torch.train.optim import AdamW, global_norm, merge_params
from radzero_torch.utils.tree import tree_leaves


def make_train_step(
    cfg: RadZeroConfig,
    optimizer: AdamW,
    *,
    loss_ratio: Optional[Dict[str, float]] = None,
    dtype=torch.bfloat16,
    remat: bool = False,
    stop_vision_gradient: Optional[bool] = None,
    device="cuda",
    group=None,
    tp=None,
    specs=None,
) -> Callable:
    """Build ``train_step(trainable, frozen, opt_state, batch) ->
    (trainable, opt_state, losses)``. ``trainable`` is updated in place
    and returned. The step runs on ``device`` (the card unless the caller
    asks for the CPU): the batch is moved there, and parameters that lie
    elsewhere raise.

    ``stop_vision_gradient=None`` resolves at call time: when the vision
    tower sits in the frozen subtree it runs without a tape. ``remat``
    (``TrainerArgs.gradient_checkpointing``) goes to ``forward_train``: the
    backward reruns parts of the forward (``models/vit.py``,
    ``models/mpnet.py``) and gives the same gradients bit for bit.
    ``group``: ``batch`` is this rank's share (see the module docstring).
    ``tp``: the model group, with ``specs`` the
    :func:`radzero_torch.parallel.tensor_parallel.param_specs` of the whole
    parameter tree (or of its trainable subtree) over it, which tell the
    split leaves from the replicated ones; a group of one is no group."""

    dev = torch.device(device)
    tp = active(tp)
    if tp is not None and specs is None:
        raise ValueError("make_train_step(tp=...) needs specs=param_specs(whole tree, model size)")

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
                                    loss_ratio=loss_ratio, dtype=dtype, remat=remat,
                                    stop_vision_gradient=stop, group=group, tp=tp)
                losses = out["losses"]
                grads = torch.autograd.grad(losses["loss"], leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        if group is not None:  # the data group: a model group's ranks hold other shares
            grads = average_gradients(grads, group)
        axis = {}
        if tp is not None:
            axis = {"tp": tp, "split": split_leaves({k: specs[k] for k in trainable})}
        # a flat list in the order of tree_leaves is a gradient tree too
        opt_state = optimizer.update(grads, opt_state, trainable, **axis)
        losses = {k: v.detach() for k, v in losses.items()}
        losses["grad_norm"] = global_norm(grads, **axis)
        return trainable, opt_state, losses

    return train_step


def make_eval_step(
    cfg: RadZeroConfig,
    *,
    loss_ratio: Optional[Dict[str, float]] = None,
    dtype=torch.bfloat16,
    device="cuda",
    group=None,
    tp=None,
) -> Callable:
    """Build ``eval_step(params, batch) -> losses``: the training forward
    without a tape, on ``device``. With ``group`` it gathers as the train
    step does, so every rank returns the same global losses (model
    selection and early stopping then agree on every rank); with ``tp``
    ``params`` is this rank's share over the model group."""
    dev = torch.device(device)

    @torch.no_grad()
    def eval_step(params, batch):
        _check_device(tree_leaves(params), dev)
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        out = forward_train(params, cfg, batch, loss_ratio=loss_ratio, dtype=dtype,
                            group=group, tp=tp)
        return out["losses"]

    return eval_step


def _check_device(leaves, dev: torch.device) -> None:
    for p in leaves:
        if p.device.type != dev.type or (dev.index is not None and p.device.index != dev.index):
            raise ValueError(f"a parameter lies on {p.device}, the step runs on {dev}")
