"""Distributed zero-shot eval driver: the port's copy of
radzero_tpu/eval/distributed.py, which shards DATASETS across processes.

The reference runs the whole suite serially on rank 0
(exp/cxr_pt/run.py:123-169, the quirk SURVEY.md §7 flags). Here each
process evaluates a disjoint, deterministic slice of every task's dataset
registry on its own card, writes its metrics as ``result.part{k}.json``,
and process 0 polls the shared filesystem for all parts and unions them
into the same ``result.json`` the serial run writes. The files, their
layout and the error containment are the JAX driver's.

Filesystem rendezvous (rather than a collective) is deliberate: eval runs
in fp32 on loaded checkpoints, and on several hosts the output directory
is shared storage, which is also the medium of the merged artifact.
Metrics are per dataset, so the union reproduces the serial result.

Parts are tagged with a per-run token (rank 0's random draw broadcast with
``torch.distributed.broadcast`` in a real multi-process run, a fingerprint
of the task, the registry, the world size and the model state otherwise),
so re-evaluating into the same output directory never merges a previous
run's leftover parts.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List, Optional, Sequence

from radzero_torch.eval.inference import Inference
from radzero_torch.utils.json_io import save_json
from radzero_torch.utils.logging import logger

_PART_FMT = "result.part{k}.json"


def agree_run_id(process_index: int, process_count: int) -> Optional[str]:
    """A token shared by every process of THIS eval run. Rank 0 draws a
    random 63-bit value and broadcasts it over the default process group
    (a CUDA tensor under NCCL, which takes no host tensor). Returns
    "serial" for one process and None when the broadcast is unavailable
    (no initialised group), as the JAX driver does."""
    if process_count <= 1:
        return "serial"
    try:
        import secrets

        import torch
        import torch.distributed as dist

        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
        token = torch.tensor([secrets.randbits(63) if process_index == 0 else 0],
                             dtype=torch.int64, device=device)
        dist.broadcast(token, src=0)
        return f"{int(token.item()):016x}"
    except Exception:
        return None


def _params_digest(scorer) -> str:
    """Deterministic fingerprint of the scorer's model state: per leaf its
    shape and dtype and the bytes of its leading 64 elements (sliced on the
    device, so only a few KB reach the host). Used by the fallback run token
    so that re-evaluating into the same directory after further training
    can never merge a stale part from a DIFFERENT model state."""
    params = getattr(scorer, "params", None)
    if params is None:
        return "no-params"
    import torch

    from radzero_torch.train.optim import tree_leaves

    h = hashlib.sha1()
    for leaf in tree_leaves(params):
        try:
            head = leaf.detach().reshape(-1)[:64].contiguous().cpu()
            h.update(str(tuple(leaf.shape)).encode())
            h.update(str(leaf.dtype).encode())
            h.update(head.view(torch.uint8).numpy().tobytes())  # any dtype, bf16 too
        except Exception:
            h.update(repr(leaf).encode())
    return h.hexdigest()[:16]


def partition_datasets(names: Sequence[str], process_index: int,
                       process_count: int) -> List[str]:
    """Deterministic strided slice of a dataset list: process k takes names
    k, k+P, k+2P, ... (order-preserving, disjoint, exhaustive)."""
    if not (0 <= process_index < process_count):
        raise ValueError(f"process_index {process_index} not in [0, {process_count})")
    return list(names[process_index::process_count])


def write_partial_result(save_dir: str, process_index: int, payload: Dict,
                         run_id: Optional[str] = None,
                         error: Optional[str] = None) -> str:
    """Atomically publish one process's metrics slice, tagged with the run
    token. ``error`` marks a contained task failure on this rank: the part
    still publishes (so the merge never waits for a crashed rank) with
    whatever metrics the rank completed."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, _PART_FMT.format(k=process_index))
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"run_id": run_id, "metrics": payload, "error": error}, f, indent=2)
    os.replace(tmp, path)  # atomic on POSIX: readers never see partials
    return path


def _read_part(path: str, run_id: Optional[str]) -> Optional[Dict]:
    """The part dict ({"metrics", "error"}) if it belongs to this run, else
    None (a stale file from a previous eval into the same directory, which
    the owning rank will overwrite: treated as not yet present)."""
    try:
        with open(path) as f:
            part = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(part, dict) or "metrics" not in part:
        return None  # pre-run_id layout: cannot be attributed, treated as stale
    if part.get("run_id") != run_id:
        return None
    return {"metrics": part["metrics"], "error": part.get("error")}


def merge_partial_results(save_dir: str, process_count: int,
                          timeout_s: float = 3600.0,
                          poll_s: float = 1.0,
                          run_id: Optional[str] = None) -> Dict:
    """Process 0's side: wait for every rank's part FROM THIS RUN (matching
    ``run_id``), union the per-dataset dicts, write ``result.json``. A part
    carrying an ``error`` is merged for whatever metrics it completed and
    the error is logged (the serial driver's contract: a failed task is a
    logged error, not a crash)."""
    paths = [os.path.join(save_dir, _PART_FMT.format(k=k)) for k in range(process_count)]
    deadline = time.monotonic() + timeout_s
    while True:
        parts = [_read_part(p, run_id) for p in paths]
        missing = [p for p, part in zip(paths, parts) if part is None]
        if not missing:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"distributed eval merge timed out after {timeout_s:.0f}s; "
                f"missing or stale (run_id != {run_id!r}): {missing}"
            )
        time.sleep(poll_s)
    merged: Dict = {}
    for k, part in enumerate(parts):
        if part["error"]:
            logger.error(
                f"[distributed eval] rank {k} reported a contained "
                f"failure: {part['error']} — merging its completed "
                "metrics; its remaining datasets are absent from result.json"
            )
        overlap = set(merged) & set(part["metrics"])
        if overlap:
            raise ValueError(f"dataset(s) {sorted(overlap)} reported by multiple ranks")
        merged.update(part["metrics"])
    save_json(merged, os.path.join(save_dir, "result.json"))
    return merged


class DistributedInference:
    """Inference facade that shards each task family's dataset list across
    processes and merges the metrics on process 0. Every process evaluates
    ONLY its slice into the shared save directory, publishes
    ``result.part{k}.json``, and process 0 merges. With one process it is
    the serial driver's result."""

    def __init__(
        self,
        cls_dataset: List[str],
        det_dataset: List[str],
        seg_dataset: List[str],
        data_root_dir: str,
        batch_size: int = 64,
        num_workers: int = 8,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        merge_timeout_s: float = 3600.0,
        run_id: Optional[str] = None,
    ):
        if (process_index is None) != (process_count is None):
            # auto-filling the other half would discard an explicit rank and
            # evaluate the wrong dataset slice
            raise ValueError(
                "pass BOTH process_index and process_count (manual "
                "launcher) or NEITHER (read from the initialised "
                f"torch.distributed group); got process_index={process_index} "
                f"process_count={process_count}"
            )
        auto = process_index is None
        if auto:
            import torch.distributed as dist

            group = dist.group.WORLD if dist.is_initialized() else None
            from radzero_torch.parallel.dist import rank, world

            process_index, process_count = rank(group), world(group)
        if run_id is None and auto:
            # a real multi-process run: agree on a fresh token through the
            # process group, so re-evals into the same directory never
            # merge a previous run's parts
            run_id = agree_run_id(process_index, process_count)
        self.run_id = run_id
        self.process_index = process_index
        self.process_count = process_count
        self.merge_timeout_s = merge_timeout_s
        self.data_root_dir = data_root_dir
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.cls_dataset = cls_dataset
        self.det_dataset = det_dataset
        self.seg_dataset = seg_dataset

    # ------------------------------------------------------------------
    def _run_task(self, task: str, full_list: List[str], scorer,
                  save_dir: str, **kwargs) -> Optional[Dict]:
        run_id = self.run_id
        if run_id is None:
            # ranks constructed explicitly with no caller token (tests, manual
            # launchers): a fingerprint of (task, registry, world size, MODEL
            # STATE) that every rank of the same launch computes alike; a
            # leftover part can only match if an identical model state wrote it
            run_id = hashlib.sha1(
                f"{task}|{','.join(full_list)}|{self.process_count}|"
                f"{_params_digest(scorer)}".encode()
            ).hexdigest()[:16]
        mine = partition_datasets(full_list, self.process_index, self.process_count)
        lists = {"classification": [], "grounding": [], "segmentation": []}
        lists[task] = mine
        inf = Inference(
            lists["classification"], lists["grounding"], lists["segmentation"],
            self.data_root_dir, self.batch_size, self.num_workers,
            write_result_json=False,
        )
        logger.info(
            f"[distributed eval] process {self.process_index}/{self.process_count} "
            f"{task}: {mine or '(no slice)'}"
        )
        # containment: ALWAYS publish this rank's part, or rank 0 would wait
        # in merge_partial_results for the whole merge timeout
        error = None
        try:
            part = getattr(inf, task)(scorer, save_dir, **kwargs) if mine else {}
            if part is None:  # the task raised inside its containment wrapper
                part, error = {}, f"{task} failed on process {self.process_index}; see log"
        except Exception as e:
            part, error = {}, (
                f"{task} crashed on process {self.process_index}: {e!r}"
            )
        if error:
            logger.error(f"[distributed eval] {error}")
        write_partial_result(
            save_dir, self.process_index, part, run_id=run_id, error=error
        )
        if self.process_index == 0:
            return merge_partial_results(
                save_dir, self.process_count, self.merge_timeout_s,
                run_id=run_id,
            )
        return None

    def classification(self, scorer, save_root_dir: str,
                       compute_metric: bool = True) -> Optional[Dict]:
        return self._run_task(
            "classification", self.cls_dataset, scorer, save_root_dir,
            compute_metric=compute_metric,
        )

    def grounding(self, scorer, save_root_dir: str) -> Optional[Dict]:
        return self._run_task("grounding", self.det_dataset, scorer, save_root_dir)

    def segmentation(self, scorer, save_root_dir: str,
                     compute_pixel_level_auroc: bool = False) -> Optional[Dict]:
        return self._run_task(
            "segmentation", self.seg_dataset, scorer, save_root_dir,
            compute_pixel_level_auroc=compute_pixel_level_auroc,
        )
