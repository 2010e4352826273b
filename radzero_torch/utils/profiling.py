"""Tracing / profiling / debugging hooks (port of radzero_tpu/utils/profiling.py).

The reference's observability row (SURVEY.md §5): HF speed_metrics ->
:func:`speed_metrics`; a trace of the device -> :func:`trace`
(torch.profiler where the JAX package opens jax.profiler);
``full_determinism`` + DebugUnderflowOverflow -> :func:`debug_flags`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional


def speed_metrics(prefix: str, start_time: float, num_samples: int, num_steps: int) -> Dict[str, float]:
    """samples/sec + steps/sec (HF Trainer speed_metrics semantics,
    common/trainer.py:903-909)."""
    runtime = time.perf_counter() - start_time
    out = {f"{prefix}_runtime": round(runtime, 4)}
    if runtime > 0:
        out[f"{prefix}_samples_per_second"] = round(num_samples / runtime, 3)
        out[f"{prefix}_steps_per_second"] = round(num_steps / runtime, 3)
    return out


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """A torch.profiler session over the scope (the host, and the CUDA
    device when there is one) that writes a Chrome trace,
    ``logdir/trace.json`` (open it in chrome://tracing or Perfetto); no
    session when ``logdir`` is empty."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def debug_flags(nans: bool = False, deterministic: bool = False) -> None:
    """NaN checking + deterministic-ops mode.

    ``nans`` -> ``torch.autograd.set_detect_anomaly(True)``: a backward
    that produces NaN raises and names the forward op it came from, the
    counterpart of the JAX package's ``jax_debug_nans`` (and of the
    reference's DebugUnderflowOverflow option). ``deterministic`` ->
    ``torch.use_deterministic_algorithms(True)`` (library ops without a
    deterministic implementation raise) and TF32 off for matmuls and
    convolutions, so fp32 products run at full precision: the counterpart
    of the JAX package's ``jax_default_matmul_precision='highest'``, the
    reference's ``full_determinism`` (config.yaml:26). The port's own
    kernels reduce in a fixed order either way.
    """
    import torch

    if nans:
        torch.autograd.set_detect_anomaly(True)
    if deterministic:
        torch.use_deterministic_algorithms(True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


class StepTimer:
    """Lightweight per-step wall-clock accumulator for the train loop."""

    def __init__(self):
        self.t0 = None
        self.total = 0.0
        self.count = 0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.total += time.perf_counter() - self.t0
        self.count += 1
        return False

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)
