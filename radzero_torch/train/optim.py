"""Optimizer and finetune policy (port of radzero_tpu/train/optim.py).

AdamW (b1 0.9, b2 0.999, eps 1e-8) with a linear-warmup cosine schedule,
global-norm gradient clipping and no weight decay on biases and LayerNorm
parameters, over the port's trees of tensors (nested dicts and lists).
The arithmetic is that of the optax chain the JAX package builds
(``clip_by_global_norm`` -> ``adamw`` -> ``MultiSteps``), written out,
because ``torch.optim.AdamW`` with ``clip_grad_norm_`` differs from it:

- the clip scales by ``max_norm / norm`` only when ``norm >= max_norm``
  (``clip_grad_norm_`` adds 1e-6 to the norm);
- the schedule is read at the count of updates made so far, which starts
  at 0, so the first update runs at lr 0; the cosine restarts its own
  count at ``warmup_steps``;
- the update is ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, decay
  on the masked leaves only;
- ``bf16_moments`` stores only the first moment in bfloat16. optax forms
  ``b1 * mu`` in the stored dtype (b1 itself rounded to bfloat16, 0.8984
  for 0.9) before it adds the fp32 gradient term; so does this;
- accumulation keeps the running mean of the micro-step gradients and
  updates once every ``gradient_accumulation_steps`` calls.

The finetune policy ``module_to_update`` partitions the parameter tree at
the top level into (trainable, frozen); only the trainable leaves are
handed to autograd.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import torch

_LN_KEYS = {"ln", "ln1", "ln2", "ln_attn", "ln_out", "layer_norm", "final_ln"}


def partition_params(params: dict, module_to_update: Sequence[str]) -> Tuple[dict, dict]:
    """Split the top-level parameter tree into (trainable, frozen)."""
    keep = set(module_to_update)
    trainable = {k: v for k, v in params.items() if k in keep}
    frozen = {k: v for k, v in params.items() if k not in keep}
    return trainable, frozen


def merge_params(trainable: dict, frozen: dict) -> dict:
    return {**trainable, **frozen}


def decay_mask(params):
    """HF Trainer semantics: decay everything except biases and LayerNorms.
    Same tree as ``params`` with a bool at every leaf."""

    def walk(tree, in_ln=False, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, in_ln or k in _LN_KEYS, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, in_ln, key) for v in tree]
        return not (in_ln or key == "bias")

    return walk(params)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict / list tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def warmup_cosine_schedule(learning_rate: float, warmup_steps: int,
                           total_steps: int) -> Callable[[int], float]:
    """Linear warmup from 0 over ``warmup_steps`` updates, then cosine decay
    to 0 over the rest; ``schedule(count)`` with count from 0."""
    warmup_steps = max(warmup_steps, 1)
    decay_steps = max(total_steps - warmup_steps, 1)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return learning_rate * count / warmup_steps
        c = min(count - warmup_steps, decay_steps)
        return learning_rate * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))

    return schedule


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, fp32."""
    leaves = tree_leaves(grads)
    return torch.sqrt(sum(g.float().square().sum() for g in leaves))


class AdamW:
    """``init(trainable) -> state`` and ``update(grads, state, trainable) ->
    state`` (``grads``: a tree like ``trainable``, or its leaves as a flat
    list in the order of :func:`tree_leaves`), which moves ``trainable`` in place (its leaves are the fp32
    master weights) when an update is due. All state lives in ``state``;
    the object holds hyper-parameters only."""

    def __init__(self, schedule: Callable[[int], float], *, weight_decay: float,
                 max_grad_norm: float, b1: float, b2: float, eps: float,
                 gradient_accumulation_steps: int, bf16_moments: bool):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.every_k = max(int(gradient_accumulation_steps), 1)
        self.mu_dtype = torch.bfloat16 if bf16_moments else None

    def init(self, trainable) -> dict:
        leaves = tree_leaves(trainable)
        state = {
            "count": 0,  # updates made
            "mu": [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for p in leaves],
            "nu": [torch.zeros_like(p) for p in leaves],
        }
        if self.every_k > 1:
            state["mini_step"] = 0
            state["acc_grads"] = [torch.zeros_like(p) for p in leaves]
        return state

    @torch.no_grad()
    def update(self, grads, state: dict, trainable) -> dict:
        params = tree_leaves(trainable)
        g_leaves: List[torch.Tensor] = tree_leaves(grads)
        decay = tree_leaves(decay_mask(trainable))
        if self.every_k > 1:
            n = state["mini_step"]
            for acc, g in zip(state["acc_grads"], g_leaves):
                acc.add_((g - acc) / (n + 1))          # running mean of the micro-steps
            state["mini_step"] = (n + 1) % self.every_k
            if state["mini_step"] != 0:
                return state
            g_leaves = [acc.clone() for acc in state["acc_grads"]]
            for acc in state["acc_grads"]:
                acc.zero_()

        norm = global_norm(g_leaves)
        below = norm < self.max_grad_norm  # stays on the device: no host read
        g_leaves = [torch.where(below, g, (g / norm.to(g.dtype)) * self.max_grad_norm)
                    for g in g_leaves]

        lr = self.schedule(state["count"])
        count = state["count"] + 1
        c1, c2 = 1.0 - self.b1**count, 1.0 - self.b2**count
        for i, (p, g, wd) in enumerate(zip(params, g_leaves, decay)):
            old_mu = state["mu"][i]  # b1 * mu in the stored dtype, as optax does
            mu = (1.0 - self.b1) * g + (old_mu * old_mu.new_tensor(self.b1)).to(g.dtype)
            nu = (1.0 - self.b2) * g.square() + self.b2 * state["nu"][i]
            step = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if wd:
                step = step + self.weight_decay * p
            p.add_(step, alpha=-lr)
            state["mu"][i] = mu.to(state["mu"][i].dtype)
            state["nu"][i] = nu
        state["count"] = count
        return state


def build_optimizer(
    learning_rate: float = 1e-4,
    weight_decay: float = 0.05,
    max_grad_norm: float = 1.0,
    warmup_steps: int = 50,
    total_steps: int = 10000,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    gradient_accumulation_steps: int = 1,
    bf16_moments: bool = False,
) -> Tuple[AdamW, Callable[[int], float]]:
    """-> (optimizer, schedule), the JAX package's defaults."""
    schedule = warmup_cosine_schedule(learning_rate, warmup_steps, total_steps)
    opt = AdamW(schedule, weight_decay=weight_decay, max_grad_norm=max_grad_norm, b1=b1,
                b2=b2, eps=eps, gradient_accumulation_steps=gradient_accumulation_steps,
                bf16_moments=bf16_moments)
    return opt, schedule
