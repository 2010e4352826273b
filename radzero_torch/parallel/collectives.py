"""The collectives of data- and tensor-parallel runs: a differentiable row gather,
a plain one, and the gradient average.

- :func:`all_gather_rows` concatenates every rank's rows in rank order
  under autograd. Its backward sums the upstream gradient over the ranks
  and keeps this rank's rows: the full-gradient semantics of the
  reference's ``dist.nn.all_gather`` (losses.py:87-88) and of the ``psum``
  that the JAX ``shard_map`` transpose runs (radzero_tpu/ops/vlcabs.py:77-88).
  Written here because ``torch.distributed.nn.all_gather`` is deprecated.
- :func:`gather_rows` is the same gather without a tape, for index and
  mask tensors (``group_map``, ``row_mask``, ``row_gather``).
- :func:`average_gradients` averages the trainable gradients over the
  ranks with one all-reduce over a flat fp32 buffer, in the order of the
  list it is given (``tree_leaves``), not one call a leaf.
- :func:`all_reduce_sum` is the sum over a model group that completes a
  row-parallel product (the o-proj and fc2 partials of K3 and K4 under
  ``tp=``, MPNet's split embedding lookups). Under autograd its backward is
  the identity on each rank's share: what follows the sum is replicated, so
  every rank's cotangent of the sum is the same, and it is the cotangent of
  each rank's partial.
- :func:`copy_to_model` is its transpose, at the input of a column-parallel
  region outside a fused chain (the eager layers' q / k / v and fc1, MPNet's
  q / k / v, the ``mlp`` adapter's fc1, a replicated leaf that each rank
  reads only in part): the identity forward, and the sum over the model
  group of the ranks' gradients backward.

Every rank passes tensors of the same shape and dtype. 16-bit floats are
summed in fp32 and rounded once. The backend decides the route, and nothing
switches it on failure: NCCL runs ``all_gather_into_tensor`` /
``reduce_scatter_tensor`` / ``all_reduce`` on the card; gloo, which has no
reduce-scatter, sums with an all-reduce and keeps this rank's slice, and
runs on host tensors: a CUDA tensor is copied to the host and back around
each gloo call, as gloo's own CUDA collectives would.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

_WIDEN = (torch.float16, torch.bfloat16)


def _host(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` where ``group``'s backend takes it: the host for gloo."""
    return x.cpu() if dist.get_backend(group) == "gloo" else x


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (n, ...) concatenated in rank order -> (P n, ...),
    on ``x``'s device; no autograd."""
    p = dist.get_world_size(group)
    src = _host(x.detach().contiguous(), group)
    if dist.get_backend(group) == "nccl":
        out = torch.empty((p * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, src, group=group)
        return out
    parts = [torch.empty_like(src) for _ in range(p)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


def _sum_rows(g: torch.Tensor, n: int, group) -> torch.Tensor:
    """Sum ``g`` (P n, ...) over the ranks and keep this rank's n rows."""
    dtype = g.dtype
    acc = _host(g.to(torch.float32) if dtype in _WIDEN else g, group).contiguous()
    if dist.get_backend(group) == "nccl":
        out = torch.empty((n,) + tuple(acc.shape[1:]), dtype=acc.dtype, device=acc.device)
        dist.reduce_scatter_tensor(out, acc, op=dist.ReduceOp.SUM, group=group)
    else:
        if acc is g:  # all_reduce works in place: never on the caller's tensor
            acc = acc.clone()
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
        r = dist.get_rank(group)
        out = acc[r * n:(r + 1) * n]
    return out.to(device=g.device, dtype=dtype)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        return gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum_rows(g, ctx.n, ctx.group), None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable :func:`gather_rows`: the gradient of this rank's rows is
    the sum over the ranks of the gradient of the gathered tensor's rows
    that hold them."""
    return _AllGatherRows.apply(x, group)


def average_gradients(grads: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The mean over the ranks of each gradient, by one all-reduce of one flat
    fp32 buffer (the leaves in the order given). Each rank gets the same
    bits; the results are views into that buffer, in each leaf's dtype."""
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    buf = _host(flat, group)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    flat = buf.to(flat.device).div_(dist.get_world_size(group))
    out = []
    for part, g in zip(torch.split(flat, [g.numel() for g in grads]), grads):
        out.append(part.view(g.shape).to(g.dtype))
    return out


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of each rank's ``x`` as a new tensor in ``x``'s
    dtype on its device (16-bit floats summed in fp32, rounded once)."""
    acc = x.detach().to(torch.float32) if x.dtype in _WIDEN else x.detach()
    buf = _host(acc, group).contiguous()
    if buf.data_ptr() == x.data_ptr():  # all_reduce works in place: never on the caller's tensor
        buf = buf.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(device=x.device, dtype=x.dtype)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks of ``group`` of each rank's ``x`` (the same
    shape and dtype on every rank), as a new tensor on ``x``'s device in
    ``x``'s dtype; 16-bit floats are summed in fp32 and rounded once. Every
    rank gets the same bits. None is the identity. Differentiable: the
    gradient of each rank's ``x`` is the gradient of the sum, unchanged
    (the computation after the sum runs alike on every rank)."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceSum.apply(x, group)
    return _reduce(x, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, replicated over the model group ``group``, as the input
    of a computation each rank runs on its share of the weights: the
    backward sums the ranks' gradients of ``x`` (fp32 for 16-bit floats,
    rounded once), so every rank gets the whole gradient, bit for bit the
    same. None, or ``x`` that needs no gradient, is ``x``."""
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, group)
