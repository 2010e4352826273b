"""Batched zero-shot scorer (port of radzero_tpu/eval/scorer.py): the
device-side engine of the eval harness.

Wraps :func:`radzero_torch.models.radzero.compute_logits` in a threaded
host pipeline: host threads decode and resize chunk i+1 while the card runs
chunk i, and results are fetched one step behind through pinned buffers.
Eager PyTorch has no shape to compile for, so there is no jit cache and the
last partial batch is not padded. ``mesh`` has no counterpart yet (one
card).

fp32 is the reference-parity eval protocol and runs with TF32 off (the
counterpart of ``jax.default_matmul_precision("highest")``), set and
restored by the scorer; bf16 is the throughput path.

``fused_tower=True`` (the default) runs the tower and the align layers on
the fused K1-K3 layer; False runs the layers the config names:
``ViTConfig.attn_impl="flash"``, the dataclass default, is K13, and
``AlignConfig.attn_impl`` picks the align layers' (the default
``"fused_vjp"`` is K1-K3 again). The text tower reads
``TextConfig.attn_impl`` ("flash": K15) and ``fuse_post`` (K4) either way.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from radzero_torch.eval.serving import cast_params
from radzero_torch.models.configuration import RadZeroConfig
from radzero_torch.models.radzero import compute_logits
from radzero_torch.ops.layers import normalize_pixels


@contextlib.contextmanager
def _tf32_off():
    """Full fp32 products and convolutions inside, the caller's settings after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class ZeroShotScorer:
    def __init__(
        self,
        params: dict,
        cfg: RadZeroConfig,
        image_processor,
        tokenizer,
        *,
        device="cuda",
        batch_size: int = 64,
        dtype: torch.dtype = torch.float32,
        num_threads: int = 8,
        device_normalize: bool = False,
        fused_tower: bool = True,
    ):
        """``params``: the port's parameter dict (``init_radzero`` or
        ``params_from_jax``), cast once to ``dtype`` on ``device``.

        ``device_normalize``: upload resized uint8 and normalise on the
        device (4x less host-to-device traffic; bit-identical for
        Blip-geometry processors, whose host pipeline also round-trips
        through uint8 after the resize). Default off: the fp32 host path is
        the reference-parity eval protocol."""
        self.device = torch.device(device)
        self.cfg = cfg
        self.image_processor = image_processor
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.dtype = dtype
        self.num_threads = num_threads
        self.fused_tower = fused_tower
        self.device_normalize = bool(
            device_normalize
            and hasattr(image_processor, "resize_u8")
            and hasattr(image_processor, "mean")
        )
        self.params = cast_params(params, dtype, self.device)

    # ------------------------------------------------------------------
    def _upload(self, array: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            # pinned + non_blocking: a pageable upload would wait for the stream
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _run(self, imgs: np.ndarray, ids, mask, need_scores: bool):
        """Enqueue one batch; -> (host tensors, event that marks them filled)."""
        pv = self._upload(imgs)
        with torch.inference_mode():
            if pv.dtype == torch.uint8:
                pv = normalize_pixels(pv, self.image_processor.mean, self.image_processor.std,
                                      dtype=self.dtype)
            out = compute_logits(self.params, self.cfg, pv.to(self.dtype), ids, mask,
                                 dtype=self.dtype, fused_towers=self.fused_tower)
            outs = [out["logits"].float()]
            if need_scores:
                outs.append(out["similarity_scores"].float())
            if self.device.type != "cuda":
                return outs, None
            host = [torch.empty(t.shape, dtype=torch.float32, pin_memory=True) for t in outs]
            for h, t in zip(host, outs):
                h.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return host, done

    @staticmethod
    def _fetch(pending) -> List[np.ndarray]:
        host, done = pending
        if done is not None:
            done.synchronize()
        return [h.numpy().copy() for h in host]

    # ------------------------------------------------------------------
    def encode_prompts(self, prompts: List[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        ids, mask = self.tokenizer(prompts)
        return (torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device),
                torch.as_tensor(np.asarray(mask), dtype=torch.long, device=self.device))

    def _process_image(self, loader: Callable, item) -> np.ndarray:
        if self.device_normalize:
            return self.image_processor.resize_u8(loader(item))
        return self.image_processor(loader(item))["pixel_values"][0]

    def _precision(self):
        return _tf32_off() if self.dtype == torch.float32 else contextlib.nullcontext()

    # ------------------------------------------------------------------
    def score(
        self,
        items: List,
        load_image: Callable,
        prompts: List[str],
        *,
        need_scores: bool = False,
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Score every item x prompt.

        Returns logits (n_items, n_prompts) and, when requested,
        similarity maps (n_items, n_prompts, n_patches).
        """
        ids, mask = self.encode_prompts(prompts)
        parts: List[List[np.ndarray]] = []
        with self._precision(), cf.ThreadPoolExecutor(self.num_threads) as pool:
            # software pipeline: dispatch chunk i, then prepare chunk i+1 on
            # host threads while the card runs; results are fetched one step
            # behind
            pending = None
            for start in range(0, len(items), self.batch_size):
                chunk = items[start : start + self.batch_size]
                imgs = np.stack(
                    list(pool.map(lambda it: self._process_image(load_image, it), chunk)))
                out = self._run(imgs, ids, mask, need_scores)
                if pending is not None:
                    parts.append(self._fetch(pending))
                pending = out
            if pending is not None:
                parts.append(self._fetch(pending))
        logits = np.concatenate([p[0] for p in parts], axis=0)
        scores = np.concatenate([p[1] for p in parts], axis=0) if need_scores else None
        return logits, scores

    # ------------------------------------------------------------------
    def score_paired(
        self,
        items: List,
        load_image: Callable,
        texts: List[str],
        *,
        need_scores: bool = False,
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Each item scored against ITS OWN sentence (referring-expression
        protocol). Batches B images x B prompts and takes the diagonal, so
        the vision tower (the hot path) runs batched.

        Returns logits (n,) and optionally maps (n, n_patches).
        """
        bs = self.batch_size
        logits_parts, score_parts = [], []
        with self._precision(), cf.ThreadPoolExecutor(self.num_threads) as pool:
            for start in range(0, len(items), bs):
                chunk = items[start : start + bs]
                imgs = np.stack(
                    list(pool.map(lambda it: self._process_image(load_image, it), chunk)))
                ids, mask = self.encode_prompts(texts[start : start + bs])
                out = self._fetch(self._run(imgs, ids, mask, need_scores))
                diag = np.arange(len(chunk))
                logits_parts.append(out[0][diag, diag])  # of (n, n)
                if need_scores:
                    score_parts.append(out[1][diag, diag])  # of (n, n, L)
        logits = np.concatenate(logits_parts, axis=0)
        scores = np.concatenate(score_parts, axis=0) if need_scores else None
        return logits, scores
