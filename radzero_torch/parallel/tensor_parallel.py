"""Tensor parallelism over a ``model`` axis: which parameters split, and each
rank's share of them (counterpart of radzero_tpu/parallel/sharding_rules.py).

The rules are the JAX package's Megatron column / row splits, on the port's
names. A spec is a tuple with one entry a dimension of the leaf, ``"model"``
on the dimension that splits and None elsewhere; ``()`` is replicated (the
JAX ``PartitionSpec()``):

- q / k / v and fc1 kernels and their biases: the output dimension
  (column-parallel; a rank holds its heads, or its slice of the MLP);
- o and fc2 kernels: the input dimension (row-parallel; a rank's product is
  a partial sum that an all-reduce completes, and their biases stay whole);
- the word and position embeddings of MPNet and BERT: the rows (a rank
  looks up the ids it holds and an all-reduce adds the rows);
- a dimension the axis does not divide: replicated, as the JAX rules fall
  back (at the flagship width and ``model = 2`` the word table's 30527 rows
  stay whole and the position table's 514 split);
- everything else (LayerNorms, LayerScale, the patch embedding, MPNet's
  relative bias, the loss head): replicated.

The rules read paths, not towers, so they split the alternate towers as the
JAX rules do: the CLIP / SigLIP / BiomedCLIP and MAE layers' ``attn/{q, k,
v, o}`` and ``mlp/{fc1, fc2}``; BERT's the same and its word and position
rows (``token_type`` stays whole); SAM's ``mlp/{fc1, fc2}`` alone, since its
packed ``qkv`` and ``proj`` sit at ``layers/i/qkv`` with no ``attn/`` in the
path and stay whole.

The DINOv2 tower and the align layers keep q / k / v packed in one
``attn.qkv`` of shape (D, 3D) (``models/from_jax.py``). Its spec is the
columns', and a rank's share is ``[q_r | k_r | v_r]``: its heads' columns
from each third, not one contiguous third of the columns.

Every rank of a model group runs the same layers on the same rows with its
share (:func:`shard_params`); ``models/vit.py`` and ``models/mpnet.py`` read
the group as ``tp=`` and run the row-parallel K3 and K4 of
``ops/fused_layer.py``, and under gradients their backwards K6, K8 and K9
split at their all-reduces. :func:`unshard_params` puts the shares back
together, :func:`gather_whole` does so across the ranks,
:func:`share_of` takes a rank's share of any whole tensor by a leaf's spec
(LoRA's merged deltas, ``train/lora.py``), and :func:`split_leaves` tells
which leaves of a tree are split (their gradients are shares; a replicated
leaf's gradient is whole on every rank).
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch
import torch.distributed as dist

from radzero_torch.parallel.collectives import gather_rows
from radzero_torch.utils.tree import tree_leaves

MODEL = "model"
_COLUMN, _ROW = (None, MODEL), (MODEL, None)
# what the model axis has not run yet, and where its work is queued: no path of
# the JAX package is refused over a model group
NOT_SPLIT = ("every path of the JAX package runs over a model group; NCCL over four cards "
             "has not run yet (ROADMAP.md item 11)")


def _rule(joined: str):
    """The trailing spec the JAX rules give the leaf at ``joined``, or None."""
    if joined.endswith("kernel"):
        if any(f"attn/{k}/kernel" in joined for k in ("q", "k", "v", "qkv")):
            return _COLUMN
        if "attn/o/kernel" in joined:
            return _ROW
        if "fc1/kernel" in joined:
            return _COLUMN
        if "fc2/kernel" in joined:
            return _ROW
    if joined.endswith("bias"):
        if any(f"attn/{k}/bias" in joined for k in ("q", "k", "v", "qkv")) or "fc1/bias" in joined:
            return (MODEL,)
    if joined.endswith("embeddings/word") or joined.endswith("embeddings/position"):
        return _ROW
    return None


def _packed(path: Sequence) -> bool:
    return len(path) >= 2 and path[-2] == "qkv"


def spec_for(path: Sequence, leaf: torch.Tensor, size: int) -> Tuple:
    """The spec of ``leaf`` at ``path`` (the keys and list indices from the
    root) over a model axis of ``size`` ranks: ``()`` when it is replicated,
    else one entry a dimension with ``"model"`` on the split one."""
    tail = _rule("/".join(str(k) for k in path))
    if tail is None or size == 1:
        return ()
    spec = (None,) * (leaf.ndim - len(tail)) + tail
    dim = spec.index(MODEL)
    width = leaf.shape[dim] // 3 if _packed(path) else leaf.shape[dim]  # a third: q, k or v
    if width % size:
        return ()
    return spec


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_specs(params: dict, size: int) -> dict:
    """The tree of :func:`spec_for` over ``params`` (dicts and lists of
    tensors)."""
    return _map(lambda path, leaf: spec_for(path, leaf, size), params)


def share_of(t: torch.Tensor, spec: Tuple, rank: int, size: int,
             packed: bool = False) -> torch.Tensor:
    """Rank ``rank``'s share of the whole tensor ``t`` over ``size`` ranks by
    the spec ``spec`` (:func:`spec_for`): ``t`` itself when the spec is
    replicated; else the rank's slice of the split dimension, and for a
    ``packed`` [q | k | v] leaf its heads' columns from each third,
    ``[q_r | k_r | v_r]``. Differentiable (slices and a concatenation); a
    contiguous copy."""
    if not spec:
        return t
    dim = spec.index(MODEL)
    if packed:
        d = t.shape[dim] // 3
        w = d // size
        parts = [t.narrow(dim, i * d + rank * w, w) for i in range(3)]
        return torch.cat(parts, dim=dim).contiguous()
    w = t.shape[dim] // size
    return t.narrow(dim, rank * w, w).contiguous()


def _share(path, leaf, rank, size):
    return share_of(leaf, spec_for(path, leaf, size), rank, size, _packed(path))


def shard_params(params: dict, rank: int, size: int) -> dict:
    """Rank ``rank``'s tree of a model axis of ``size``: each split leaf's
    share (contiguous copies), each replicated leaf as it is."""
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} is not in a model axis of {size}")
    return _map(lambda path, leaf: _share(path, leaf, rank, size), params)


def unshard_params(shards: List[dict], specs: dict) -> dict:
    """The whole tree from every rank's :func:`shard_params` share, in rank
    order, under the specs of the whole tree (:func:`param_specs`)."""
    def join(path, spec):
        leaves = [_at(s, path) for s in shards]
        if not spec:
            return leaves[0]
        dim = spec.index(MODEL)
        if _packed(path):
            w = leaves[0].shape[dim] // 3
            return torch.cat([t.narrow(dim, i * w, w) for i in range(3) for t in leaves], dim=dim)
        return torch.cat(leaves, dim=dim)

    return _map(join, specs)


def split_leaves(specs) -> List[bool]:
    """Whether each leaf of a :func:`param_specs` tree is split, in the order
    of :func:`radzero_torch.utils.tree.tree_leaves` (dict keys sorted)."""
    return [bool(spec) for spec in tree_leaves(specs)]


def gather_whole(share: dict, specs: dict, tp) -> dict:
    """The whole tree from this rank's ``share`` and the other ranks' of the
    model group ``tp``: each split leaf's shares gathered in rank order and
    joined (:func:`unshard_params`), each replicated leaf as it is. Every
    rank of the group must call it; every rank gets the whole tree."""
    size = tp_size(tp)
    if size == 1:
        return share

    def gather(path, spec):
        leaf = _at(share, path)
        if not spec:
            return [leaf] * size
        return list(gather_rows(leaf.reshape(1, -1), tp).reshape((size,) + tuple(leaf.shape)))

    parts = _map(gather, specs)
    shards = [_map(lambda path, _: _at(parts, path)[r], specs) for r in range(size)]
    return unshard_params(shards, specs)


def _at(tree: Any, path: Sequence):
    for k in path:
        tree = tree[k]
    return tree


def active(tp):
    """The model group ``tp`` when it holds more than one rank, else None: a
    group of one runs the unsplit layers, with the bits of no group."""
    return tp if tp is not None and tp_size(tp) > 1 else None


def tp_size(tp) -> int:
    """Ranks in the model group ``tp``; 1 without one."""
    return 1 if tp is None else dist.get_world_size(tp)


def tp_rank(tp) -> int:
    """This process's rank in the model group ``tp``; 0 without one."""
    return 0 if tp is None else dist.get_rank(tp)


def local_heads(n_heads: int, size: int) -> int:
    """Heads a rank holds of ``n_heads`` over ``size`` ranks; raises when the
    axis does not divide them (a rank's share of q / k / v must be whole
    heads)."""
    if n_heads % size:
        raise ValueError(f"{n_heads} attention heads do not split over a model axis of {size}")
    return n_heads // size
