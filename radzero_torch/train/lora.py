"""LoRA adapters for the port's parameter tree (port of
radzero_tpu/train/lora.py; the reference's peft path,
exp/cxr_pt/model/__init__.py:82-114, adapter save / load at :42-45,100-107):

    effective_kernel = kernel + (alpha / r) * A @ B

The adapters are a dict keyed by the JAX package's kernel paths
("vision_model/layers/attn/q/kernel", "text_model/layers/mlp/fc1/kernel",
...), each ``{"a": (n_layers, d_in, r), "b": (n_layers, r, d_out)}`` for a
layer stack and ``(d_in, r)`` / ``(r, d_out)`` for a plain kernel: the JAX
keys and shapes, so an adapter tree and :func:`radzero_torch.models.
from_jax.lora_from_jax` correspond one to one. A ~ N(0, 1) / r and B = 0,
so training starts at the base model exactly, as peft's init does.

The port keeps a DINOv2 layer's q, k and v as one packed ``attn.qkv``
kernel (D, 3D) (``models/from_jax.py``): :func:`merge_lora` adds a ``q`` /
``k`` / ``v`` adapter's delta into columns [0:D], [D:2D] or [2D:3D] of each
layer's packed kernel. MPNet keeps q, k and v apart. Merging runs before
the forward under autograd, so differentiating through it trains only the
adapters; no model code changes. peft's adapter dropout is not replicated
(merging folds the adapter into the kernel), as in the JAX package.

Like the JAX module this is a library: neither the trainer nor the CLI
wires it in.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Tuple

import torch

from radzero_torch.train.checkpoint import _onto
from radzero_torch.utils.json_io import load_json, save_json

ADAPTERS_FILE = "adapters.pt"
_PACKED = {"q": 0, "k": 1, "v": 2}


def _iter_kernels(tree: dict, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...],
                                                                          tuple]]:
    """(JAX path, JAX shape) of every kernel, in the tree's order; a list of
    layers is one stacked kernel a path, and a packed qkv is q, k and v."""
    for k, v in tree.items():
        if isinstance(v, list):
            for sub, shape in _iter_kernels(v[0], ()):
                yield path + (k,) + sub, (len(v),) + shape
        elif isinstance(v, dict):
            yield from _iter_kernels(v, path + (k,))
        elif k == "kernel":
            if path[-1:] == ("qkv",):
                d_in, d3 = v.shape
                for name in _PACKED:
                    yield path[:-1] + (name, k), (d_in, d3 // 3)
            else:
                yield path + (k,), tuple(v.shape)


def _match(path: Tuple[str, ...], targets: List[str]) -> bool:
    joined = "/".join(path[:-1])  # drop the trailing 'kernel'
    return any(t in joined for t in targets)


def init_lora(g: torch.Generator, params: dict, target_modules: List[str], r: int = 8,
              alpha: int = 32) -> dict:
    """Adapter tree ``{"adapters": {path: {"a", "b"}}, "r", "alpha"}`` for each
    kernel whose path (without "/kernel") contains one of ``target_modules``,
    on ``g.device``, drawn from ``g`` in the tree's order."""
    adapters: Dict[str, dict] = {}
    for path, shape in _iter_kernels(params):
        if not _match(path, target_modules) or len(shape) not in (2, 3):
            continue
        *lead, d_in, d_out = shape
        a = torch.randn((*lead, d_in, r), generator=g, device=g.device) / r
        b = torch.zeros((*lead, r, d_out), device=g.device)
        adapters["/".join(path)] = {"a": a, "b": b}
    return {"adapters": adapters, "r": r, "alpha": alpha}


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return tree


def _add_columns(kernel: torch.Tensor, delta: torch.Tensor, third: int) -> torch.Tensor:
    d = delta.shape[-1]
    lo, hi = third * d, (third + 1) * d
    return torch.cat([kernel[:, :lo], kernel[:, lo:hi] + delta.to(kernel.dtype),
                      kernel[:, hi:]], dim=1)


def _merge_into(node: dict, rest: List[str], delta: torch.Tensor) -> None:
    """Add ``delta`` to the kernel at ``rest`` under ``node`` (a dict the
    merge owns), packed thirds included."""
    if isinstance(node.get(rest[0]), list):
        for i, layer in enumerate(node[rest[0]]):
            _merge_into(layer, rest[1:], delta[i])
        return
    if len(rest) == 3 and rest[1] in _PACKED and "qkv" in node.get(rest[0], {}):
        qkv = node[rest[0]]["qkv"]
        qkv["kernel"] = _add_columns(qkv["kernel"], delta, _PACKED[rest[1]])
        return
    if len(rest) == 1:
        node[rest[0]] = node[rest[0]] + delta.to(node[rest[0]].dtype)
        return
    _merge_into(node[rest[0]], rest[1:], delta)


def merge_lora(params: dict, lora: dict) -> dict:
    """``params`` with each targeted kernel replaced by kernel + (alpha / r)
    A @ B (a new tree; ``params`` and its tensors are left as they are)."""
    scaling = lora["alpha"] / lora["r"]
    out = _copy_tree(params)
    for joined, ab in lora["adapters"].items():
        delta = torch.einsum("...ir,...ro->...io", ab["a"], ab["b"]) * scaling
        _merge_into(out, joined.split("/"), delta)
    return out


def lora_trainable(lora: dict) -> dict:
    """The differentiable subtree (drop the static r / alpha)."""
    return {"adapters": lora["adapters"]}


def with_trainable(lora: dict, trainable: dict) -> dict:
    return {**lora, "adapters": trainable["adapters"]}


def save_adapter(lora: dict, path: str) -> None:
    """Write only the adapters (``adapters.pt``, ``torch.save``) and their
    hyper-parameters (``lora_config.json``, the JAX file) into ``path``."""
    os.makedirs(path, exist_ok=True)
    torch.save(lora["adapters"], os.path.join(path, ADAPTERS_FILE))
    save_json({"r": lora["r"], "alpha": lora["alpha"]}, os.path.join(path, "lora_config.json"))


def load_adapter(path: str, target_lora: dict) -> dict:
    """Adapters shaped like ``target_lora`` (from :func:`init_lora`), each on
    its target's device and in its dtype; a missing key or another shape
    raises."""
    loaded = torch.load(os.path.join(path, ADAPTERS_FILE), map_location="cpu",
                        weights_only=True)
    conf = load_json(os.path.join(path, "lora_config.json"))
    return {"adapters": _onto(loaded, target_lora["adapters"], "adapters"), "r": conf["r"],
            "alpha": conf["alpha"]}
