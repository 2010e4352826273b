"""AOT model export for serving (port of radzero_tpu/eval/export.py).

Serialises the zero-shot function with its parameters through
``torch.export``, so a serving process starts without building the model
from Python code (the reference's quickstart re-instantiates torch modules
per process):

    bundle_dir = export_zero_shot(params, cfg, out_dir,
                                  batch_size=16, n_prompts=20, max_tokens=32)
    runner, meta = load_zero_shot(bundle_dir)
    logits, maps = runner(pixel_values, input_ids, attention_mask)

The program holds the parameters as buffers (cast to ``dtype``, the
position embedding resampled to the model's grid once, as the
ServingEngine holds them); shapes are fixed at export time (one bundle per
serving bucket). The bundle is ``zero_shot.pt2`` (``torch.export.save``)
beside ``bundle.json``: the JAX bundle's keys plus ``device``, ``torch``
and what the engine needs to cold-start from it (``vocab_size``,
``image_mean``, ``image_std``, ``fused_tower``).

What differs from the JAX bundle: that one is self-contained StableHLO.
Here the serving kernels K1-K5, K13 and K15 stay whole in the graph as the
``radzero::`` ops of :mod:`radzero_torch.ops.registry` (the wrappers cannot
be traced), so loading needs ``radzero_torch`` importable for those ops to
resolve, and the kernels are built from its sources at first use. An op
carries the kernel and its plain twin, so ``fused_tower=None`` resolves to
True on every device; the buffers live on the exporting device, and
:func:`load_zero_shot` refuses another.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Tuple

import torch

from radzero_torch.eval.serving import CLIP_MEAN, CLIP_STD, serving_params
from radzero_torch.models.configuration import RadZeroConfig
from radzero_torch.models.mpnet import bucket_ids
from radzero_torch.models.radzero import compute_logits
from radzero_torch.ops.layers import _pixel_affine

PROGRAM = "zero_shot.pt2"
META = "bundle.json"
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _index(tree, leaves: list):
    """``tree`` with each tensor replaced by its index in ``leaves``, where
    it is appended."""
    if isinstance(tree, dict):
        return {k: _index(v, leaves) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_index(v, leaves) for v in tree]
    leaves.append(tree)
    return len(leaves) - 1


def _fill(structure, leaves):
    if isinstance(structure, dict):
        return {k: _fill(v, leaves) for k, v in structure.items()}
    if isinstance(structure, list):
        return [_fill(v, leaves) for v in structure]
    return leaves[structure]


class ZeroShotProgram(torch.nn.Module):
    """compute_logits over parameters held as buffers; with ``from_uint8``
    it first broadcasts a grey channel to RGB and normalises on the device,
    as :class:`radzero_torch.eval.serving.ServingEngine` does."""

    def __init__(self, params: dict, cfg: RadZeroConfig, *, dtype, device, fused_tower: bool,
                 from_uint8: bool, image_mean, image_std):
        super().__init__()
        self.cfg, self.dtype, self.fused_tower = cfg, dtype, fused_tower
        self.from_uint8 = from_uint8
        leaves: list = []
        self._structure = _index(
            serving_params(params, cfg, dtype, device, cfg.vision.img_size), leaves)
        self._n = len(leaves)
        for i, t in enumerate(leaves):
            self.register_buffer(f"p{i}", t)
        if from_uint8:
            # the engine's normalize_pixels: x.to(dtype) * scale + bias with the
            # same per-channel scale and bias
            scale, bias = _pixel_affine(tuple(image_mean), tuple(image_std), dtype,
                                        torch.device(device))
            self.register_buffer("pixel_scale", scale.clone())
            self.register_buffer("pixel_bias", bias.clone())

    def forward(self, pixel_values, input_ids, attention_mask):
        params = _fill(self._structure, [getattr(self, f"p{i}") for i in range(self._n)])
        if self.from_uint8:
            if pixel_values.shape[-1] == 1:
                pixel_values = pixel_values.expand(*pixel_values.shape[:-1], 3)
            pixel_values = pixel_values.to(self.dtype) * self.pixel_scale + self.pixel_bias
        out = compute_logits(params, self.cfg, pixel_values, input_ids, attention_mask,
                             dtype=self.dtype, fused_towers=self.fused_tower)
        return out["logits"], out["similarity_scores"]


def export_zero_shot(
    params: dict,
    cfg: RadZeroConfig,
    out_dir: str,
    *,
    batch_size: int = 16,
    n_prompts: int = 20,
    max_tokens: int = 32,
    dtype: torch.dtype = torch.bfloat16,
    from_uint8: bool = False,
    channels: int = 3,
    image_mean=None,
    image_std=None,
    fused_tower: Optional[bool] = None,
    device="cuda",
) -> str:
    """Export compute_logits at fixed shapes into ``out_dir``; returns it.

    ``from_uint8``: bake the ServingEngine's split pipeline into the
    bundle — inputs are resized uint8 (B, img, img, channels) and the
    rescale+normalise (and channel broadcast for channels=1 grayscale
    sources) happen inside the exported program. ``image_mean/std``
    default to the CLIP statistics the flagship Blip processor uses.
    ``fused_tower=None`` (default) resolves to True: the towers run the
    fused K1-K3 layer (False: the layers ``cfg`` names). Inputs: pixels
    (B, img, img, C), ids and mask (n_prompts, max_tokens) int64. An op
    that cannot be registered, or a function that export cannot trace,
    raises."""
    from radzero_torch.ops import registry  # noqa: F401  the ops the graph holds

    if fused_tower is None:
        fused_tower = True
    if channels not in (1, 3):
        raise ValueError("channels must be 1 or 3")
    if channels == 1 and not from_uint8:
        raise ValueError("channels=1 requires from_uint8")
    device = torch.device(device)
    image_mean = tuple(image_mean) if image_mean is not None else CLIP_MEAN
    image_std = tuple(image_std) if image_std is not None else CLIP_STD
    os.makedirs(out_dir, exist_ok=True)
    program = ZeroShotProgram(params, cfg, dtype=dtype, device=device, fused_tower=fused_tower,
                              from_uint8=from_uint8, image_mean=image_mean,
                              image_std=image_std)
    img = cfg.vision.img_size
    args = (
        torch.zeros((batch_size, img, img, channels if from_uint8 else 3),
                    dtype=torch.uint8 if from_uint8 else dtype, device=device),
        torch.ones((n_prompts, max_tokens), dtype=torch.long, device=device),
        torch.ones((n_prompts, max_tokens), dtype=torch.long, device=device),
    )
    # MPNet's relative-position buckets uploaded before the trace (on the ids'
    # device, the cache's key), so the program holds them on the device: traced,
    # the upload from host memory would run on every call
    bucket_ids(max_tokens, cfg.text.relative_attention_num_buckets, args[1].device)
    with torch.no_grad():
        exported = torch.export.export(program, args)
    torch.export.save(exported, os.path.join(out_dir, PROGRAM))
    meta = {
        "batch_size": batch_size,
        "n_prompts": n_prompts,
        "max_tokens": max_tokens,
        "vocab_size": cfg.text.vocab_size,
        "img_size": img,
        "dtype": _DTYPE_NAMES[dtype],
        "from_uint8": from_uint8,
        "channels": channels if from_uint8 else 3,
        "image_mean": list(image_mean),
        "image_std": list(image_std),
        "fused_tower": fused_tower,
        "device": device.type,
        "torch": torch.__version__,
    }
    with open(os.path.join(out_dir, META), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


def own_stack_chunk(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` with its generated ``forward`` given a frame larger than
    CPython's first data-stack chunk (16 KiB), so that every call of it
    starts a chunk of its own.

    CPython 3.11+ keeps Python frames in per-thread chunks and frees a chunk
    as soon as its first frame returns. A program's forward is one frame of
    ~1850 locals at full depth that makes ~1400 Python calls; where it lands
    close to the end of a chunk, each of those calls maps a new chunk and
    unmaps it on return, which took 110-350 ms of host time a run at 8 x 14
    against 12-22 ms (one H100 host, torch 2.11; PERF.md), depending only on
    how deep the caller's stack was. A frame that starts its own chunk has
    1000 words or more after it for its calls. The extra depth of the value
    stack is never used."""
    fn = type(module).forward
    fn.__code__ = fn.__code__.replace(co_stacksize=fn.__code__.co_stacksize + 2048)
    return module


def load_zero_shot(bundle_dir: str, device=None) -> Tuple[Callable, dict]:
    """-> (runner(pixel_values, input_ids, attention_mask) -> (logits,
    similarity_scores), bundle meta). ``device`` defaults to the exporting
    one; another raises (the buffers and the traced devices are fixed). The
    runner runs the program on the calling thread, on its current stream."""
    from radzero_torch.ops import registry  # noqa: F401  resolves the radzero:: ops

    with open(os.path.join(bundle_dir, META)) as f:
        meta = json.load(f)
    want = torch.device(device if device is not None else meta["device"]).type
    if want != meta["device"]:
        raise ValueError(f"bundle was exported on {meta['device']}, asked to run on {want}")
    module = own_stack_chunk(torch.export.load(os.path.join(bundle_dir, PROGRAM)).module())

    def runner(pixel_values, input_ids, attention_mask):
        with torch.inference_mode():
            return module(pixel_values, input_ids, attention_mask)

    return runner, meta
