"""Process groups for data-parallel training and eval (counterpart of
radzero_tpu/parallel/mesh.py and radzero_tpu/parallel/multihost.py).

The JAX package trains over one global view: a ``Mesh`` with a ``data``
axis, batch arrays sharded on it, and XLA deriving the collectives. The
port follows PyTorch's idiom instead, one process per card under
``torch.distributed`` (NCCL on the card, gloo on the CPU): each rank keeps
its own share of the batch and meets the global batch inside the loss,
through the gathers of :mod:`radzero_torch.parallel.collectives`.

- :func:`init_distributed` joins the process group. With explicit
  arguments, or under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` /
  ``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT`` set), a failure to
  rendezvous raises: a run that fell back to one process would train on
  1/P of the data with the wrong contrastive negatives
  (``multihost.py:45-56``). With nothing set it is a world of one with no
  group, and returns None.
- :func:`world`, :func:`rank`, :func:`process_offset` (the global image
  offset of this rank's share, ``multihost.py:70-72``), :func:`sync` (a
  barrier), :func:`mesh_shape` and :func:`check_mesh` (``train.mesh``
  against the world, ``mesh.py:28-46``: a data and a model axis).
- :func:`mesh_groups` lays the ranks out on a (data, model) grid in
  row-major order, as ``create_mesh`` lays out devices: global rank
  ``d * model + m``. It returns this rank's data group (the ranks that hold
  the same parameters and different rows: ``group=``) and its model group
  (the ranks that share one copy of the parameters and the same rows:
  ``tp=``, with :mod:`radzero_torch.parallel.tensor_parallel`).

Every function that takes ``group=`` treats None as "not distributed":
no collective runs. A world of one with a real group runs every
collective, each of which is then the identity on the bits.

Not ported: ``local_batch_to_global``, which has no counterpart: nothing
assembles a global batch, the loss gathers what it needs.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     timeout_s: float = 600.0):
    """Join the default process group and return it, or None for a world of
    one with no group.

    ``backend`` None picks ``nccl`` where CUDA is available, else ``gloo``;
    a caller that runs on the CPU of a machine with a card names ``gloo``.
    ``init_method`` (``tcp://host:port``, ``file:///path``) with ``rank``
    and ``world_size``, or torchrun's environment (``env://``). A failed
    rendezvous raises after ``timeout_s``; nothing degrades to one process."""
    explicit = init_method is not None or rank is not None or world_size is not None
    if not explicit:
        if "WORLD_SIZE" not in os.environ:
            return None
        missing = [v for v in _TORCHRUN_VARS if v not in os.environ]
        if missing:
            raise RuntimeError(f"WORLD_SIZE is set but {missing} are not: a launcher's "
                               "environment is incomplete")
        init_method = "env://"
    elif init_method is None or rank is None or world_size is None:
        raise ValueError("pass init_method, rank and world_size together (got "
                         f"init_method={init_method!r}, rank={rank}, world_size={world_size})")
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialised")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {} if init_method == "env://" else {"rank": rank, "world_size": world_size}
    dist.init_process_group(backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dist.group.WORLD


def world(group=None) -> int:
    """Ranks in ``group``; 1 without one."""
    return 1 if group is None else dist.get_world_size(group)


def rank(group=None) -> int:
    """This process's rank in ``group``; 0 without one."""
    return 0 if group is None else dist.get_rank(group)


def local_rank() -> int:
    """The card index a launcher gave this process (``LOCAL_RANK``, else 0)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def process_offset(per_process_batch: int, group=None) -> int:
    """Global image-index offset of this rank's share (the reference's
    ``rank * B_local``, losses.py:149-151)."""
    return rank(group) * per_process_batch


def sync(name: str = "barrier", group=None) -> None:
    """A barrier over ``group`` (the reference's ``dist.barrier``,
    common/trainer.py:892-893); nothing without one. ``name`` labels the
    call site in a stack trace of a rank that waits."""
    if group is not None and world(group) > 1:
        if dist.get_backend(group) == "nccl":  # on this rank's card, not a guessed one
            dist.barrier(group, device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group)


def mesh_shape(mesh: Optional[Dict[str, int]], world_size: int) -> Tuple[int, int]:
    """``train.mesh`` against the ranks -> (data, model): ``model`` (default
    1) must divide the world, ``data`` -1 absorbs the rest and otherwise
    must make data x model the world. Another axis raises."""
    axes = dict(mesh or {"data": -1})
    other = sorted(k for k, v in axes.items() if k not in ("data", "model") and v != 1)
    if other:
        raise NotImplementedError(f"train.mesh {axes}: the axes are data and model; {other} "
                                  "must be 1")
    model, data = axes.get("model", 1), axes.get("data", 1)
    if model < 1 or world_size % model:
        raise ValueError(f"train.mesh {axes}: model {model} does not divide the world of "
                         f"{world_size} processes (one a card)")
    if data == -1:
        data = world_size // model
    if data * model != world_size:
        raise ValueError(f"train.mesh {axes}: data {data} x model {model} != the world of "
                         f"{world_size} processes (one a card)")
    return data, model


def check_mesh(mesh: Optional[Dict[str, int]], world_size: int) -> int:
    """``train.mesh`` as the trainer and ``cli/run.py`` take it: ``{data:
    -1}`` absorbs the world, ``{data: N}`` must equal it, and a ``model``
    axis must divide it (:func:`mesh_shape`, whose (data, model) the CLI
    reads); returns the data-parallel size. Any other axis above 1
    raises."""
    return mesh_shape(mesh, world_size)[0]


def mesh_groups(data: int, model: int):
    """This rank's (data group, model group) of the (data, model) grid over
    the default group's ranks, row-major: global rank ``d * model + m``,
    data group ``{d' * model + m}``, model group ``{d * model + m'}``. Every
    rank must call it, in the same order as its other ``new_group`` calls."""
    size, me = dist.get_world_size(), dist.get_rank()
    if data * model != size:
        raise ValueError(f"a {data} x {model} grid needs {data * model} ranks, not {size}")
    d, m = divmod(me, model)
    data_group = model_group = None
    for mm in range(model):
        g = dist.new_group([dd * model + mm for dd in range(data)])
        if mm == m:
            data_group = g
    for dd in range(data):
        g = dist.new_group([dd * model + mm for mm in range(model)])
        if dd == d:
            model_group = g
    return data_group, model_group
