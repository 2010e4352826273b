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
  barrier) and :func:`check_mesh` (``train.mesh`` against the world,
  ``mesh.py:28-46``).

Every function that takes ``group=`` treats None as "not distributed":
no collective runs. A world of one with a real group runs every
collective, each of which is then the identity on the bits.

Not ported: ``sharding_rules.py`` (tensor sharding of parameters; the port
replicates them on every rank, ROADMAP.md item 10) and
``local_batch_to_global``, which has no counterpart: nothing assembles a
global batch, the loss gathers what it needs.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

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


def check_mesh(mesh: Optional[Dict[str, int]], world_size: int) -> int:
    """``train.mesh`` against the ranks: ``{data: -1}`` absorbs the world,
    ``{data: N}`` must equal it; returns the data-parallel size. Another
    axis larger than 1 raises: parameters are replicated on every rank
    (no tensor sharding, ROADMAP.md item 10)."""
    axes = dict(mesh or {"data": -1})
    other = sorted(k for k, v in axes.items() if k != "data" and v != 1)
    if other:
        raise NotImplementedError(f"train.mesh {axes}: only the data axis is sharded; "
                                  f"{other} must be 1")
    data = axes.get("data", 1)
    if data == -1:
        return world_size
    if data != world_size:
        raise ValueError(f"train.mesh {axes}: data {data} != the world of {world_size} "
                         "processes (one a card)")
    return data
