"""Offline multiprocessing helper (port of radzero_tpu/utils/multiproc.py; ref
common/multi_processing.py:1-67).

Pool.imap with progress reporting for host-side preprocessing jobs,
plus the image-integrity check used when screening datasets. The pool's
workers are spawned, not forked (the JAX package forks): a process that
has imported torch runs threads, and a forked child inherits their locks.
So ``func`` must be importable by name, as any pickled function must.
"""

from __future__ import annotations

import multiprocessing
from typing import Callable, Iterable, List, Optional

from radzero_torch.utils.logging import logger


def func_with_multiprocessing(
    func: Callable,
    items: Iterable,
    num_workers: int = 8,
    chunksize: int = 1,
    desc: str = "",
) -> List:
    """Map ``func`` over ``items`` with a process pool, logging progress."""
    items = list(items)
    results = []
    with multiprocessing.get_context("spawn").Pool(num_workers) as pool:
        for i, res in enumerate(pool.imap(func, items, chunksize=chunksize)):
            results.append(res)
            if (i + 1) % max(len(items) // 10, 1) == 0:
                logger.info(f"{desc} {i + 1}/{len(items)}")
    return results


def check_image_integrity(path: str) -> Optional[str]:
    """Return path when the image decodes, None otherwise
    (ref common/multi_processing.py:33-37)."""
    try:
        from PIL import Image

        with Image.open(path) as im:
            im.convert("RGB")
        return path
    except Exception:
        return None
