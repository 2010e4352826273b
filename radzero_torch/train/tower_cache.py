"""Frozen-tower activation cache: skip the vision tower after epoch 1 (port
of radzero_tpu/train/tower_cache.py).

Under the reference finetune policy the vision tower is FROZEN and
training augmentation is disabled (ref configs/radzero.yaml:50,
model/processing.py:170-174), so the tower's output tokens for a given
image are identical in every epoch. This cache stores them per *record
index* after their first computation and feeds them back on later
epochs, replacing ``pixel_values`` with ``tower_tokens`` in the batch
(``models/radzero.py`` ``forward_train`` dispatches on the key): the
step then runs no tower (no K1-K3 launches in it).

Tokens are (1370, 768) per image at the flagship shape: the port's
``forward_vision`` takes ``tower_tokens`` only at the real length, where
the JAX package stores its lane-padded 1408. In bf16 that is 2.10 MB a
record (2,104,320 bytes), so a 240k-image MIMIC-CXR epoch is ~505 GB:
``memmap`` on local disk, not ``ram``; ``device`` needs n_records x 2.10
MB of device memory beside the step's, so it suits small or medium sets
and per-process shards.

Numerics: :func:`make_tower_fn` runs the tower ``forward_vision`` runs
inside the step (K1-K3 under ``no_grad``) at the step's dtype, and every
backing stores the tokens bit for bit (bf16 through an int16 view on
disk, since numpy has no bfloat16), so cached epochs compute what
uncached ones do.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

# the memmap's element type for each token dtype: numpy has no bfloat16, so
# 16-bit floats are stored through an int16 view of their bits
_STORAGE = {torch.float32: np.float32, torch.bfloat16: np.int16, torch.float16: np.int16}


class TowerCache:
    """Store of frozen-tower tokens keyed by record index.

    ``backing="ram"``: a dict of per-record CPU tensors — any dataset size
    the host's memory allows, zero configuration.
    ``backing="memmap"``: preallocated ``tokens.dat`` + ``present.dat``
    under ``path`` (requires ``n_records``) — for datasets larger than
    host RAM. Both files persist, so a SECOND run pointed at the same
    ``path`` reuses epoch-1 work: ``meta.json`` records (n_records,
    token shape, torch dtype) and existing files are reopened in place
    when it matches, recreated from scratch when it doesn't. The meta does
    NOT capture the (checkpoint, processor) pair that produced the
    tokens — point ``path`` at a run-scoped directory unless you know
    the tower inputs are unchanged.
    ``backing="device"``: the store is one (n_records, L, D) tensor on the
    device the tokens come from (requires ``n_records``), filled by
    ``index_copy_`` and read by ``index_select``, so cached epochs move no
    token bytes between host and device. The device must hold the store
    beside the cached train step.

    ``get`` returns a tensor (on the host for ``ram`` / ``memmap``, on the
    store's device for ``device``) or None; a store error raises.
    """

    def __init__(
        self,
        backing: str = "ram",
        *,
        path: Optional[str] = None,
        n_records: Optional[int] = None,
    ):
        if backing not in ("ram", "memmap", "device"):
            raise ValueError(
                f"backing must be 'ram', 'memmap' or 'device', got {backing!r}"
            )
        if backing == "memmap" and (path is None or n_records is None):
            raise ValueError("memmap backing requires path= and n_records=")
        if backing == "device" and n_records is None:
            raise ValueError("device backing requires n_records=")
        self.backing = backing
        self.path = path
        self.n_records = n_records
        self._ram: Dict[int, torch.Tensor] = {}
        self._mm: Optional[np.memmap] = None
        self._dtype: Optional[torch.dtype] = None  # memmap: the tokens' torch dtype
        self._present: Optional[np.ndarray] = None
        self._store: Optional[torch.Tensor] = None  # device backing: (n_records, L, D)
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------------
    def _meta(self, token_shape, dtype: torch.dtype) -> dict:
        return {
            "shape": [int(self.n_records), *map(int, token_shape)],
            "dtype": str(dtype),
        }

    def _ensure_memmap(self, token_shape, dtype: torch.dtype) -> None:
        if self._mm is not None:
            return
        if dtype not in _STORAGE:
            raise ValueError(f"memmap backing stores {sorted(map(str, _STORAGE))}, not {dtype}")
        os.makedirs(self.path, exist_ok=True)
        fn = os.path.join(self.path, "tokens.dat")
        pn = os.path.join(self.path, "present.dat")
        mn = os.path.join(self.path, "meta.json")
        meta = self._meta(token_shape, dtype)
        reuse = False
        if os.path.exists(mn) and os.path.exists(fn) and os.path.exists(pn):
            try:
                with open(mn) as f:
                    reuse = json.load(f) == meta
            except (OSError, ValueError):
                reuse = False
        # 'r+' reopens a matching cache in place (cross-run reuse of
        # epoch-1 work); any mismatch recreates from scratch — it is a
        # cache, never the source of truth
        mode = "r+" if reuse else "w+"
        self._mm = np.memmap(
            fn, dtype=_STORAGE[dtype], mode=mode, shape=tuple(meta["shape"])
        )
        self._present = np.memmap(pn, dtype=np.uint8, mode=mode,
                                  shape=(self.n_records,))
        self._dtype = dtype
        if not reuse:
            with open(mn, "w") as f:
                json.dump(meta, f)

    def put(self, indices, tokens: torch.Tensor) -> None:
        """Store ``tokens[i]`` under record index ``indices[i]``. Host
        backings copy a device tensor to the host; the device backing
        copies it into its store on the device (no readback)."""
        indices = np.asarray(indices)
        tokens = torch.as_tensor(tokens).detach()
        if self.backing == "device":
            if self._store is None:
                self._store = torch.zeros((self.n_records, *tokens.shape[1:]),
                                          dtype=tokens.dtype, device=tokens.device)
                self._present = np.zeros((self.n_records,), np.uint8)
            idx = torch.as_tensor(indices, dtype=torch.long, device=self._store.device)
            self._store.index_copy_(0, idx, tokens)
            self._present[indices] = 1
            return
        tokens = tokens.cpu()
        if self.backing == "ram":
            for i, idx in enumerate(indices):
                self._ram[int(idx)] = tokens[i].clone()
            return
        self._ensure_memmap(tokens.shape[1:], tokens.dtype)
        if tokens.dtype != self._dtype:
            raise ValueError(f"memmap cache holds {self._dtype}, got {tokens.dtype}")
        bits = tokens.contiguous()
        if self._dtype != torch.float32:
            bits = bits.view(torch.int16)
        self._mm[indices] = bits.numpy()
        self._present[indices] = 1

    def _open_existing(self) -> bool:
        """Reopen a persisted cache before the first put() (fresh run
        over a warm directory): shape/dtype come from meta.json."""
        mn = os.path.join(self.path, "meta.json")
        if not os.path.exists(mn):
            return False
        try:
            with open(mn) as f:
                meta = json.load(f)
            if meta["shape"][0] != self.n_records:
                return False
            dtype = getattr(torch, meta["dtype"].removeprefix("torch."))
        except (OSError, ValueError, KeyError, AttributeError):
            return False
        self._ensure_memmap(meta["shape"][1:], dtype)
        return True

    def get(self, indices) -> Optional[torch.Tensor]:
        """The stacked tokens for ``indices``, or None unless ALL are
        present (a partial batch would still need the tower, so the caller
        recomputes the whole batch and re-puts)."""
        indices = np.asarray(indices)
        if self.backing == "device":
            if self._present is None or not self._present[indices].all():
                self.misses += 1
                return None
            self.hits += 1
            idx = torch.as_tensor(indices, dtype=torch.long, device=self._store.device)
            return self._store.index_select(0, idx)
        if self.backing == "ram":
            if any(int(i) not in self._ram for i in indices):
                self.misses += 1
                return None
            self.hits += 1
            return torch.stack([self._ram[int(i)] for i in indices])
        if self._present is None and not self._open_existing():
            self.misses += 1
            return None
        if not self._present[indices].all():
            self.misses += 1
            return None
        self.hits += 1
        out = torch.from_numpy(np.asarray(self._mm[indices]))
        return out.view(self._dtype) if self._dtype != torch.float32 else out

    # ------------------------------------------------------------------
    @property
    def n_cached(self) -> int:
        if self.backing == "ram":
            return len(self._ram)
        return 0 if self._present is None else int(self._present.sum())

    @property
    def nbytes(self) -> int:
        if self.backing == "ram":
            return sum(t.numel() * t.element_size() for t in self._ram.values())
        if self.backing == "device":
            return 0 if self._store is None else self._store.numel() * self._store.element_size()
        return 0 if self._mm is None else self._mm.nbytes

    def stats(self) -> Dict[str, int]:
        return {
            "cached_records": self.n_cached,
            "bytes": self.nbytes,
            "hits": self.hits,
            "misses": self.misses,
        }


def make_tower_fn(cfg, *, dtype) -> Callable:
    """``tower(vision_params, pixel_values) -> tokens`` (B, 1370, D) at the
    real length: the tower ``forward_vision`` runs inside the train step
    (``models/radzero.py``: the fused K1-K3 layer, final LN, at the step's
    ``dtype``), under ``torch.no_grad()``, so cached tokens are drop-in
    replacements for the in-step tower's."""
    if getattr(cfg.vision, "model_type", "dinov2") not in ("dinov2", "raddino"):
        raise NotImplementedError(f"vision model_type {cfg.vision.model_type!r}")
    from radzero_torch.models.vit import vit_forward

    @torch.no_grad()
    def tower(vision_params, pixel_values):
        return vit_forward(vision_params, cfg.vision, pixel_values, dtype=dtype, impl="fused")

    return tower
