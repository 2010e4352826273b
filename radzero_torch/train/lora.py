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

The walk over the kernels is the JAX package's: a tower's layers, one
stacked dict in the JAX tree and a list of layers here, are one stacked
kernel a path; SAM's layers, which the JAX tree keeps as a list (a tower
with a ``neck``), the JAX walk never enters (it walks dicts only), so they
get no adapter here either. The port keeps a DINOv2-style layer's (one with
``ls1``: the tower and the align layers) q, k and v as one packed
``attn.qkv`` kernel (D, 3D) (``models/from_jax.py``): :func:`merge_lora`
adds a ``q`` / ``k`` / ``v`` adapter's delta into columns [0:D], [D:2D] or
[2D:3D] of each layer's packed kernel. A ``qkv`` the JAX tree packs itself
(SAM's) is never split. MPNet and the alternate towers keep q, k and v
apart. Merging runs before
the forward under autograd, so differentiating through it trains only the
adapters; no model code changes. peft's adapter dropout is not replicated
(merging folds the adapter into the kernel), as in the JAX package.

Over a model group (``merge_lora(share, lora, tp=, specs=)``, the JAX
package's ``merge_lora`` then ``shard_params``) every rank computes each
adapter's whole delta, the adapters being replicated, and adds the rank's
share of it to its kernel share by the kernel's spec
(:func:`radzero_torch.parallel.tensor_parallel.share_of`: columns for q / k
/ v and fc1, ``[q_r | k_r | v_r]`` thirds for DINOv2's packed qkv, rows for
o and fc2). A delta that goes into a split kernel passes through
``copy_to_model`` first: each rank's gradient of the whole delta is nonzero
only on its share, and the summed backward makes it whole, so A's and B's
gradients are whole and bit-equal on every rank and the replicated adapters
stay equal after each update. A delta into a replicated kernel goes in
whole, its gradient already whole on every rank.

Like the JAX module this is a library: neither the trainer nor the CLI
wires it in.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Tuple

import torch

from radzero_torch.parallel.collectives import copy_to_model
from radzero_torch.parallel.tensor_parallel import active, share_of, tp_rank, tp_size
from radzero_torch.train.checkpoint import _onto
from radzero_torch.utils.json_io import load_json, save_json

ADAPTERS_FILE = "adapters.pt"
_PACKED = {"q": 0, "k": 1, "v": 2}


def _jax_list(tree: dict, key: str) -> bool:
    """Whether ``tree[key]``, a list of layers here, is a list in the JAX tree
    too: SAM's layers (their relative tables differ in shape), in the tower
    that holds a ``neck``. Every other list is one stacked JAX dict."""
    return key == "layers" and "neck" in tree


def _iter_kernels(tree: dict, path: Tuple[str, ...] = (), packed: bool = False
                  ) -> Iterator[Tuple[Tuple[str, ...], tuple]]:
    """(JAX path, JAX shape) of every kernel the JAX ``init_lora`` walks, in the
    tree's order: a list of layers is one stacked kernel a path, SAM's list is
    not walked, and in a layer the port packed (``packed``: one with ``ls1``)
    ``attn/qkv`` is q, k and v."""
    for k, v in tree.items():
        if isinstance(v, list):
            if _jax_list(tree, k):
                continue
            for sub, shape in _iter_kernels(v[0], (), "ls1" in v[0]):
                yield path + (k,) + sub, (len(v),) + shape
        elif isinstance(v, dict):
            yield from _iter_kernels(v, path + (k,), packed)
        elif k == "kernel":
            if packed and path[-2:] == ("attn", "qkv"):
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


def _share(delta: torch.Tensor, spec, tp) -> torch.Tensor:
    """This rank's part of the whole ``delta`` of a kernel whose spec is
    ``spec`` over the model group ``tp`` (``delta`` itself without one, or
    for a replicated kernel)."""
    if tp is None or not spec:
        return delta
    return share_of(copy_to_model(delta, tp), spec, tp_rank(tp), tp_size(tp))


def _merge_into(node: dict, rest: List[str], delta: torch.Tensor, specs, tp) -> None:
    """Add ``delta`` (or this rank's share of it over ``tp``, by the spec tree
    ``specs`` that mirrors ``node``) to the kernel at ``rest`` under ``node``
    (a dict the merge owns), packed thirds included."""
    sub = None if specs is None else specs[rest[0]]
    if isinstance(node.get(rest[0]), list):
        if _jax_list(node, rest[0]):
            raise KeyError(f"{rest[0]}: a list in the JAX tree too (SAM's layers), which "
                           "init_lora leaves without adapters")
        for i, layer in enumerate(node[rest[0]]):
            _merge_into(layer, rest[1:], delta[i], None if sub is None else sub[i], tp)
        return
    if (len(rest) == 3 and rest[:1] == ["attn"] and rest[1] in _PACKED and "ls1" in node
            and "qkv" in node["attn"]):
        qkv = node[rest[0]]["qkv"]
        spec = None if sub is None else sub["qkv"]["kernel"]
        qkv["kernel"] = _add_columns(qkv["kernel"], _share(delta, spec, tp), _PACKED[rest[1]])
        return
    if len(rest) == 1:
        node[rest[0]] = node[rest[0]] + _share(delta, sub, tp).to(node[rest[0]].dtype)
        return
    _merge_into(node[rest[0]], rest[1:], delta, sub, tp)


def merge_lora(params: dict, lora: dict, tp=None, specs=None) -> dict:
    """``params`` with each targeted kernel replaced by kernel + (alpha / r)
    A @ B (a new tree; ``params`` and its tensors are left as they are).
    ``tp``: a model group, ``params`` this rank's share and ``specs`` the
    :func:`radzero_torch.parallel.tensor_parallel.param_specs` of the whole
    tree over it (see the module docstring)."""
    tp = active(tp)
    if tp is not None and specs is None:
        raise ValueError("merge_lora(tp=...) needs specs=param_specs(whole tree, model size)")
    scaling = lora["alpha"] / lora["r"]
    out = _copy_tree(params)
    for joined, ab in lora["adapters"].items():
        delta = torch.einsum("...ir,...ro->...io", ab["a"], ab["b"]) * scaling
        _merge_into(out, joined.split("/"), delta, specs if tp is not None else None, tp)
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
