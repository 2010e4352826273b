"""Sharded record files for multi-host training data (copy of
radzero_tpu/data/shards.py).

The reference loads one monolithic ``train.json`` per split on every
rank (exp/cxr_pt/dataset.py:18-74). At pod scale that means every host
parses the full corpus; sharded record files let each host read only
what it will train on, while keeping a deterministic global order:

- :func:`write_record_shards` — split a record list into ``n_shards``
  JSON files (round-robin, so every shard is a uniform sample) plus an
  ``index.json`` with counts and the assignment rule.
- :func:`load_record_shards` — read back either everything or only the
  shards a given ``(process_index, process_count)`` needs. Shards are
  assigned to processes round-robin; within a training run the
  TrainLoader's own strided sharding is then applied over the loaded
  subset with ``process_count=1`` (the file-level sharding already
  partitioned the corpus) — or load everything and let TrainLoader
  shard (small corpora).
"""

from __future__ import annotations

import os
from typing import List, Tuple

from radzero_torch.utils.json_io import load_json, save_json


def write_record_shards(records: List[dict], out_dir: str, n_shards: int) -> str:
    """Round-robin split -> shard_{i:05d}.json + index.json."""
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    os.makedirs(out_dir, exist_ok=True)
    shards: List[List[dict]] = [[] for _ in range(n_shards)]
    for i, rec in enumerate(records):
        shards[i % n_shards].append(rec)
    names = []
    for i, shard in enumerate(shards):
        name = f"shard_{i:05d}.json"
        save_json(shard, os.path.join(out_dir, name))
        names.append(name)
    save_json(
        {
            "n_shards": n_shards,
            "n_records": len(records),
            "assignment": "round_robin",
            "shards": [
                {"file": n, "count": len(s)} for n, s in zip(names, shards)
            ],
        },
        os.path.join(out_dir, "index.json"),
    )
    return out_dir


def load_record_shards(
    shard_dir: str,
    process_index: int = 0,
    process_count: int = 1,
) -> Tuple[List[dict], dict]:
    """-> (records, index meta). With ``process_count > 1`` only the
    shards assigned to this process (round-robin over shard ids) are
    read; records interleave back in their within-assignment global
    order."""
    index = load_json(os.path.join(shard_dir, "index.json"))
    if not (0 <= process_index < process_count):
        raise ValueError(f"process_index {process_index} not in [0, {process_count})")
    picked = [
        s["file"]
        for i, s in enumerate(index["shards"])
        if i % process_count == process_index
    ]
    records: List[dict] = []
    for name in picked:
        records.extend(load_json(os.path.join(shard_dir, name)))
    return records, index
