"""Checkpointing: save / resume / best-model selection (port of
radzero_tpu/train/checkpoint.py).

The layout is the JAX package's: ``output_dir/checkpoint-<step>/`` with
``trainer_state.json`` beside the state, the same ``list_checkpoints`` /
``get_last_checkpoint`` and the same ``save_total_limit`` rule. The state
(the trainable tree and the optimizer's state: ``count``, ``mu``, ``nu``,
and ``mini_step`` / ``acc_grads`` under accumulation) is one ``torch.save``
file, ``state.pt``, where the JAX package writes an Orbax ``state``
directory.

A checkpoint is written under a temporary name (``checkpoint-<step>.tmp``,
which ``list_checkpoints`` does not match) and renamed once complete, as
Orbax finalizes its directory: a process killed during a save leaves the
previous checkpoint the last one. (The rename guards against a killed
process, not a lost machine: nothing is fsynced.)
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional

import torch

from radzero_torch.utils.json_io import load_json, save_json
from radzero_torch.utils.logging import logger

_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")
STATE_FILE = "state.pt"


def checkpoint_dir(output_dir: str, step: int) -> str:
    return os.path.join(output_dir, f"checkpoint-{step}")


def list_checkpoints(output_dir: str) -> List[str]:
    if not os.path.isdir(output_dir):
        return []
    out = []
    for name in os.listdir(output_dir):
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(output_dir, name)))
    return [p for _, p in sorted(out)]


def get_last_checkpoint(output_dir: str) -> Optional[str]:
    """Latest checkpoint dir (ref exp/cxr_pt/trainer.py:105 semantics)."""
    ckpts = list_checkpoints(output_dir)
    return ckpts[-1] if ckpts else None


def save_checkpoint(
    output_dir: str,
    step: int,
    state: Dict[str, Any],
    metadata: Dict[str, Any],
    save_total_limit: Optional[int] = None,
    best_path: Optional[str] = None,
) -> str:
    """Save the state tree + metadata JSON; prune old ckpts keeping the best."""
    path = checkpoint_dir(output_dir, step)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, STATE_FILE))
    save_json(metadata, os.path.join(tmp, "trainer_state.json"))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)

    if save_total_limit:
        # Reference (HF) semantics: the best checkpoint counts WITHIN
        # the limit — ``limit`` total survive (best + the most recent
        # ones), not ``limit`` recent PLUS the best. One documented HF
        # corner kept: the just-saved checkpoint is never pruned, so
        # ``save_total_limit=1`` with a distinct older best retains two
        # (ref common/trainer.py:925-936).
        ckpts = list_checkpoints(output_dir)
        by_abs = {os.path.abspath(p): p for p in ckpts}
        keep = [path]
        if best_path and os.path.abspath(best_path) in by_abs:
            best = by_abs[os.path.abspath(best_path)]
            if best not in keep:
                keep.append(best)
        for p in reversed(ckpts):  # newest first
            if len(keep) >= save_total_limit:
                break
            if p not in keep:
                keep.append(p)
        for p in ckpts:
            if p not in keep:
                logger.info(f"pruning checkpoint {p}")
                shutil.rmtree(p, ignore_errors=True)
    return path


def restore_checkpoint(path: str, target_state: Dict[str, Any]) -> Dict[str, Any]:
    """Restore a state tree shaped like ``target_state``: every tensor on
    its target's device and in its target's dtype. Loads with
    ``weights_only=True``; raises on a missing checkpoint and on any
    difference of tree structure or shape (it never reshapes)."""
    file = os.path.join(path, STATE_FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(f"no checkpoint state at {file}")
    loaded = torch.load(file, map_location="cpu", weights_only=True, mmap=True)
    return _onto(loaded, target_state, "state")


def _onto(loaded, target, where: str):
    if isinstance(target, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(target):
            raise ValueError(f"checkpoint tree differs at {where}: keys "
                             f"{sorted(loaded) if isinstance(loaded, dict) else type(loaded)} "
                             f"vs {sorted(target)}")
        return {k: _onto(loaded[k], target[k], f"{where}/{k}") for k in target}
    if isinstance(target, list):
        if not isinstance(loaded, list) or len(loaded) != len(target):
            raise ValueError(f"checkpoint tree differs at {where}: a list of "
                             f"{len(target)} expected")
        return [_onto(a, b, f"{where}/{i}") for i, (a, b) in enumerate(zip(loaded, target))]
    if isinstance(target, torch.Tensor):
        if not isinstance(loaded, torch.Tensor) or loaded.shape != target.shape:
            raise ValueError(f"checkpoint leaf {where}: shape "
                             f"{getattr(loaded, 'shape', type(loaded))} vs {tuple(target.shape)}")
        return loaded.to(device=target.device, dtype=target.dtype, copy=True)
    if type(loaded) is not type(target):
        raise ValueError(f"checkpoint leaf {where}: {type(loaded)} vs {type(target)}")
    return loaded


def load_trainer_state(path: str) -> Dict[str, Any]:
    return load_json(os.path.join(path, "trainer_state.json"))
