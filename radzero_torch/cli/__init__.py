"""Command-line entry points of the port: ``run`` (train and evaluate),
``preprocess`` (MIMIC-CXR reports to training records) and ``visualize``
(similarity-map studies)."""

from __future__ import annotations


def resolve_device(name: str):
    """``--device`` of every entry point: ``cuda`` (the default) raises
    without a card, and nothing falls back to the CPU unless asked."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu to "
                           "run on the CPU)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    return device
