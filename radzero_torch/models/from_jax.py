"""Parameter bridge: the JAX parameter tree -> the port's parameters.

Input: the tree of ``radzero_tpu.models.radzero.init_radzero`` (or a
converted checkpoint), as nested dicts of numpy arrays (any array type
``np.asarray`` accepts). Output: the dict layout that
:func:`radzero_torch.models.radzero.init_radzero` produces, so both
packages compute the same thing from the same weights.

Layouts:
- dense kernels stay (d_in, d_out): the port computes ``x @ kernel``;
- the patch embedding keeps its (ph, pw, c)-flattened rows;
- stacked layers (leading layer axis) become a list of per-layer dicts;
- ViT and align layers get their q/k/v kernels packed once, here, into
  ``attn.qkv`` = [q | k | v] (D, 3D), the operand of kernel K1;
- MPNet ``rel_bias`` stays (buckets, heads); the loss head keeps
  ``log_loss_temperature`` and the shared LN.

:func:`lora_from_jax` brings over the JAX ``init_lora`` output as it is: the
port's adapters keep the JAX keys and stacked shapes
(``radzero_torch/train/lora.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def _unstack(stacked: dict) -> list:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return [_index(stacked, i) for i in range(len(leaf))]


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _vit_layer(p: dict) -> dict:
    a = p["attn"]
    qkv = {
        "kernel": np.concatenate([np.asarray(a[n]["kernel"]) for n in "qkv"], axis=1),
        "bias": np.concatenate([np.asarray(a[n]["bias"]) for n in "qkv"]),
    }
    return {**p, "attn": {"qkv": qkv, "o": a["o"]}}


def params_from_jax(tree: dict) -> dict:
    """Convert the JAX tree to CPU tensors of the same dtypes (the serving
    engine casts and moves them once)."""
    out = {}
    for key, sub in tree.items():
        if key == "vision_model":
            sub = {**sub, "layers": [_vit_layer(p) for p in _unstack(sub["layers"])]}
        elif key == "align_transformer" and "layers" in sub:
            sub = {**sub, "layers": [_vit_layer(p) for p in _unstack(sub["layers"])]}
        elif key == "text_model":
            sub = {**sub, "layers": _unstack(sub["layers"])}
        out[key] = sub
    return _convert(out)


def lora_from_jax(tree: dict) -> dict:
    """The JAX ``init_lora`` tree ``{"adapters": {path: {"a", "b"}}, "r",
    "alpha"}`` (arrays as numpy) -> the port's, as CPU tensors."""
    return {"adapters": _convert(tree["adapters"]), "r": int(tree["r"]),
            "alpha": int(tree["alpha"])}


def _convert(tree):
    if isinstance(tree, list):
        return [_convert(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _convert(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def params_to_numpy(tree):
    """The port's tree (or any subtree) as nested dicts / lists of numpy
    arrays, fp32 for floating leaves: what the tests compare with the JAX
    trees after :func:`params_from_jax` of those."""
    if isinstance(tree, list):
        return [params_to_numpy(v) for v in tree]
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()
