#!/usr/bin/env python
"""Measure the device-backed tower cache's capacity limit on this card
(counterpart of tools/probe_tower_cache_capacity.py).

``TowerCache(backing="device")`` keeps the frozen-tower token store on the
card as one (n_records, L, D) bf16 tensor: 2.10 MB a record at the
flagship 1370 x 768 shape (the port stores the real length; the JAX
package its lane-padded 1408), beside the cached train step's own working
set (parameters, Adam state, batch-64 activations). Past some dataset
size the store must fall back to the ``ram`` / ``memmap`` backings and pay
the per-batch upload instead.

This probe bisects, to 64 records, the largest n_records whose store
coexists with one full cached train step (batch 64 x 8 sentences x 32
tokens, bf16 + remat, the align layers without remat: the trainer's cached
configuration) without running out of device memory, and prints one JSON
line with the JAX tool's keys. Each trial runs in a fresh process
(``--one N``), since a failed allocation can leave the caching allocator in
a state a later trial would inherit; it fills the store, runs the step on
the card's kernels and synchronizes, so an out-of-memory error shows. The
bounds: 64 records, and a store that alone exceeds the memory the first
trial's process found free (the JAX tool's 8192 assumed a 16 GB part).

Run:  python -m radzero_torch.tools.probe_tower_cache_capacity [--grain 64]
      python -m radzero_torch.tools.probe_tower_cache_capacity --one N [--device cpu]
The search needs the card; ``--one`` runs on the CPU too.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from radzero_torch.tools import device_name, launch_counts

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TOKENS, WIDTH = 1370, 768
RECORD_BYTES = TOKENS * WIDTH * 2  # bf16 flagship tokens
B, SPI, L = 64, 8, 32


def run_one(n_records: int, device="cuda", cfg=None, images: int = B,
            sentences: int = SPI, text_len: int = L) -> dict:
    """One trial in this process: fill a device TowerCache of ``n_records``,
    run one cached step, synchronize -> a record of the trial (an
    out-of-memory error raises)."""
    from radzero_torch.models.configuration import RadZeroConfig
    from radzero_torch.models.radzero import init_radzero
    from radzero_torch.train.optim import build_optimizer, partition_params
    from radzero_torch.train.step import make_train_step
    from radzero_torch.train.tower_cache import TowerCache, make_tower_fn

    device = torch.device(device)
    cuda = device.type == "cuda"
    free = torch.cuda.mem_get_info(device)[0] if cuda else None
    cfg = cfg if cfg is not None else RadZeroConfig()
    # the cached configuration: align no-remat (the trainer's cached-mode default)
    cfg = dataclasses.replace(cfg, align=dataclasses.replace(cfg.align, remat=False))
    params = init_radzero(torch.Generator(device=device).manual_seed(0), cfg)
    trainable, frozen = partition_params(params, ["align_transformer", "text_model", "loss_fns"])
    opt, _ = build_optimizer(total_steps=10000)
    opt_state = opt.init(trainable)
    step = make_train_step(cfg, opt, dtype=torch.bfloat16, remat=True, device=device)
    tower_fn = make_tower_fn(cfg, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    b, s, size = images, images * sentences, cfg.vision.img_size

    cache = TowerCache(backing="device", n_records=n_records)
    pixels = torch.as_tensor(rng.standard_normal((b, size, size, 3)), dtype=torch.float32,
                             device=device)
    tokens = tower_fn(frozen["vision_model"], pixels)
    idx = np.arange(b)
    cache.put(idx, tokens)          # allocates the whole store
    got = cache.get(idx)
    assert got is not None
    del pixels, tokens

    batch = {
        "tower_tokens": got,
        "input_ids": torch.as_tensor(rng.integers(3, 30000, (s, text_len)), device=device),
        "attention_mask": torch.ones((s, text_len), dtype=torch.long, device=device),
        "group_map": torch.as_tensor(np.repeat(np.arange(b), sentences), device=device),
        "row_mask": torch.ones((s,), device=device),
    }
    _, _, losses = step(trainable, frozen, opt_state, batch)
    loss = float(losses["loss"])  # a read after the step: an OOM surfaces here at the latest
    if cuda:
        torch.cuda.synchronize(device)
    return {"ok": True, "n_records": n_records, "loss": loss, "store_bytes": cache.nbytes,
            "free_bytes_at_start": free,
            "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
            "device": device_name(device),
            "launches": {k: v for k, v in launch_counts().items() if v}}


def trial_command(n_records: int) -> list:
    """The command line of one ``--one`` trial (run from the repo's root)."""
    return [sys.executable, "-m", "radzero_torch.tools.probe_tower_cache_capacity", "--one",
            str(n_records)]


def trial_record(stdout: str, returncode: int, n_records: int) -> dict:
    """A trial's record from its standard output and exit code, or {"ok": False}."""
    for line in stdout.splitlines():
        if returncode == 0 and line.startswith("{"):
            return json.loads(line)
    return {"ok": False, "n_records": n_records, "rc": returncode}


def trial(n_records: int, log_path: str, timeout=None) -> dict:
    """One ``--one`` trial in a child process -> its record, or {"ok": False}."""
    with open(log_path, "w") as log:
        r = subprocess.run(trial_command(n_records), cwd=REPO, stdout=subprocess.PIPE,
                           stderr=log, text=True, timeout=timeout)
    return trial_record(r.stdout, r.returncode, n_records)


def search(ok, lo: int, hi: int, grain: int = 64):
    """Bisect for the largest count ``ok`` accepts between ``lo``, which it has
    accepted, and ``hi`` -> (largest accepted, smallest refused, or None when
    ``hi`` passed), the two at most ``grain`` apart."""
    if ok(hi):
        return hi, None
    while hi - lo > grain:
        mid = (lo + hi) // 2
        if ok(mid):
            lo = mid
        else:
            hi = mid
    return lo, hi


def probe(grain: int = 64, log_dir=None) -> dict:
    """The capacity search on the card -> the JAX tool's record, with the card.
    This process never touches the card, so each trial finds it as a user's
    process would."""
    log_dir = log_dir or tempfile.gettempdir()
    t0 = time.perf_counter()
    trials = []

    def ok(n):
        rec = trial(n, os.path.join(log_dir, "towercap_trial.log"))
        trials.append(rec)
        print(f"trial {n}: {'ok' if rec['ok'] else 'failed'}", file=sys.stderr, flush=True)
        return rec["ok"]

    lo = 64
    if not ok(lo):
        raise RuntimeError(f"even the floor of {lo} records fails: something else is wrong")
    # a store that alone exceeds what the first trial found free: a sure fail
    hi = trials[0]["free_bytes_at_start"] // RECORD_BYTES + 1
    best, first_fail = search(ok, lo, hi, grain)
    record_mb = RECORD_BYTES / 1e6
    out = {
        "metric": "tower_cache_device_capacity",
        "max_records": best,
        "first_failing_records": first_fail,
        "store_gb_at_max": round(best * record_mb / 1e3, 2),
        "record_mb": round(record_mb, 2),
        "step": "cached train step, batch 64, L32, bf16+remat, align no-remat",
        "wall_s": round(time.perf_counter() - t0, 1),
        "free_bytes_at_start": trials[0]["free_bytes_at_start"],
        "trials": len(trials),
        "device": trials[0]["device"],
    }
    if first_fail is None:
        out["note"] = "ceiling never ran out of memory"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--one", type=int, default=None, help="run one trial of N records here")
    ap.add_argument("--grain", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="--one's device (the search needs the card)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --one N --device cpu to run a trial on the CPU)")
    if args.one is not None:
        rec = run_one(args.one, args.device)
        print(f"ok n_records={args.one}", file=sys.stderr)
        print(json.dumps(rec))
        return 0
    if args.device != "cuda":
        raise SystemExit("the capacity search runs on the card")
    print(json.dumps(probe(args.grain)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
