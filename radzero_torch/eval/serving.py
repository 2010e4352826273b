"""Micro-batched zero-shot serving (port of radzero_tpu/eval/serving.py).

Requests (image, prompt-set name) queue up and are flushed as
micro-batches of up to ``max_batch``: a greedy drain takes whatever is
already queued, then ``max_delay_ms`` bounds the wait for more. Three
stages overlap: a decode thread assembles batches and prepares uint8
images, a dispatch thread uploads them and launches the model (the
launches return before the card finishes), and a thread pool resolves
each batch as soon as its results are back, filling the futures.

Images travel as uint8 at model size and are normalised on the device
(``channels=1`` uploads the grey plane and broadcasts it to RGB there).
Eager PyTorch does not recompile per shape, so a short batch runs at its
own size, and no upload or readback blocks the dispatch thread: pixels
go up from pinned memory, results come back into pinned buffers behind
each batch's own kernels, and a resolve waits on that batch's event. A
request that already is a (size, size[, C]) uint8 array needs no host
decoder. JPEG bytes are decoded and resized by the native C++ library
(libjpeg, fused decode -> resize; native/preproc.cpp through
:mod:`radzero_torch.data.native`) where it is built, as the JAX engine
does; otherwise, and for an array of another size, PIL is imported and
resizes as the JAX engine's Blip-style processor does (bicubic).

:meth:`ServingEngine.from_bundle` cold-starts from an exported program
(eval/export.py) instead of live parameters: an exported program has one
shape, so a short batch is padded to the bundle's batch there and cut
after readback.

Each :meth:`ServingEngine.submit` returns a Future resolving to
``{"probs": (N,), "similarity_maps": (N, g, g) | (N, H, W) | None}``.
"""

from __future__ import annotations

import concurrent.futures as cf
import io
import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from radzero_torch.eval.geometry import upsample_similarity_map
from radzero_torch.models.configuration import RadZeroConfig
from radzero_torch.models.radzero import compute_logits
from radzero_torch.models.vit import interpolate_pos_embed
from radzero_torch.ops.layers import normalize_pixels

# BlipImageProcessor defaults (OpenAI CLIP statistics), as radzero_tpu.data.processing
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class ImageSpec:
    """The preprocessing the engine applies: model input size, per-channel
    mean/std (applied on the device) and the inverse-geometry tag."""

    size: int = 518
    mean: Sequence[float] = CLIP_MEAN
    std: Sequence[float] = CLIP_STD
    geometry: str = "resize"


@dataclass
class _Request:
    image: Union[np.ndarray, bytes]
    origin_hw: Optional[Tuple[int, int]]
    prompt_set: str
    want_maps: str              # "none" | "patch" | "full"
    future: cf.Future


def cast_params(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: cast_params(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_params(v, dtype, device) for v in tree]
    if tree.is_floating_point():
        return tree.to(device=device, dtype=dtype).contiguous()
    return tree.to(device)


def serving_params(params: dict, cfg: RadZeroConfig, dtype, device, size: int) -> dict:
    """``params`` cast to ``dtype`` on ``device``, with the position
    embeddings resampled to the grid of ``size`` px once (the same fp32
    bicubic on the cast weights that every forward would run; the tower
    passes an embedding already at its grid through). The engine and an
    exported program (eval/export.py) hold the same tree."""
    params = cast_params(params, dtype, device)
    vm = params["vision_model"]
    grid = size // cfg.vision.patch_size
    vm["pos_embed"] = interpolate_pos_embed(vm["pos_embed"], (grid, grid))
    return params


class ServingEngine:
    @classmethod
    def from_bundle(cls, bundle_dir: str, tokenizer, **kw):
        """Cold-start from an AOT bundle (eval/export.py): no model code is
        traced, the saved program runs its graph (the kernels are built at
        first use as always). The bundle pins max_batch, channels, dtype,
        the device and the image statistics; a short batch is padded to the
        bundle's batch."""
        from radzero_torch.eval.export import load_zero_shot

        runner, meta = load_zero_shot(bundle_dir, device=kw.get("device"))
        kw.setdefault("device", meta["device"])
        kw.setdefault("max_batch", meta["batch_size"])
        kw.setdefault("channels", meta["channels"])
        if kw["max_batch"] != meta["batch_size"]:
            raise ValueError(
                f"bundle was exported at batch {meta['batch_size']}, "
                f"got max_batch={kw['max_batch']}"
            )
        kw["dtype"] = getattr(torch, meta["dtype"])
        kw.setdefault("image_spec", ImageSpec(size=meta["img_size"], mean=tuple(meta["image_mean"]),
                                              std=tuple(meta["image_std"])))
        kw["aot_runner"] = (runner, meta)
        return cls(None, None, tokenizer, **kw)

    def __init__(
        self,
        params: Optional[dict],
        cfg: Optional[RadZeroConfig],
        tokenizer,
        *,
        device="cuda",
        max_batch: int = 16,
        max_delay_ms: float = 5.0,
        dtype: torch.dtype = torch.bfloat16,
        preprocess_threads: int = 8,
        channels: int = 3,
        image_spec: Optional[ImageSpec] = None,
        host_backend: str = "auto",   # "auto" | "native" | "pil"
        fast_scale: bool = False,
        aot_runner=None,
    ):
        """``params``: the port's parameter dict (``init_radzero`` or
        ``params_from_jax``), cast once to ``dtype`` on ``device``.
        ``tokenizer``: texts -> (ids, mask) int arrays.
        ``host_backend``: "native" decodes/resizes JPEG bytes in C++
        (torch-bicubic resize semantics — the throughput path) and raises
        when the library cannot be built; "pil" keeps PIL end to end
        (reference bit-parity); "auto" uses native when the library is
        built.
        ``channels=1``: grayscale upload for single-channel sources
        (CXRs) — 3x fewer host->device bytes; the luma plane is
        broadcast to RGB on device before normalisation. Exact for
        grayscale JPEGs (the Y plane IS the pixel data).
        ``fast_scale``: opt-in libjpeg DCT-domain scaled decode (1/2..1/8)
        for JPEG-bytes requests whose source is much larger than the
        model size — cuts host decode cost up to ~8x but box-filters the
        downscale, so maps/pointing shift slightly; suitable for
        classification-style serving, keep OFF when similarity maps are
        consumed (same trade as the training loader's default-on flag,
        data/native.py:native_jpeg_loader). Native path only.
        ``aot_runner``: ``(runner, meta)`` of :func:`radzero_torch.eval.
        export.load_zero_shot`, in place of ``params`` and ``cfg`` (use
        :meth:`from_bundle`); every batch is padded to the bundle's."""
        if channels not in (1, 3):
            raise ValueError("channels must be 1 or 3")
        if host_backend not in ("auto", "native", "pil"):
            raise ValueError(f"host_backend must be auto|native|pil, got {host_backend!r}")
        self.device = torch.device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1e3
        self.dtype = dtype
        self.channels = channels
        self.fast_scale = bool(fast_scale)
        self._native = None
        if host_backend in ("auto", "native"):
            from radzero_torch.data import native

            if native.available():
                self._native = native
            elif host_backend == "native":
                raise RuntimeError("native preprocessing library unavailable: "
                                   f"{native.build_log.strip()[-400:]}")
        self.host_backend = "native" if self._native is not None else "pil"
        self._aot = aot_runner
        if aot_runner is not None:
            meta = aot_runner[1]
            self.image_spec = image_spec or ImageSpec(size=meta["img_size"])
            self.params = None
        else:
            self.image_spec = image_spec or ImageSpec(size=cfg.vision.img_size)
            self.params = serving_params(params, cfg, dtype, self.device, self.image_spec.size)
        self._prompt_sets: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.batch_sizes: List[int] = []  # size of every dispatched batch, in order
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        # one-slot hold for a request whose prompt set differs from the
        # batch being assembled: it becomes the next batch's first (a
        # re-enqueue at the tail could starve it). Read-and-clear happens
        # in the decode thread and in _fail_queued (submit/close threads),
        # so the slot is guarded by a lock.
        self._held: Optional[_Request] = None
        self._held_lock = threading.Lock()
        self._pool = cf.ThreadPoolExecutor(preprocess_threads)
        self._stop = threading.Event()
        self._ready: "queue.Queue" = queue.Queue(maxsize=2)
        self._worker = threading.Thread(target=self._run_decode, daemon=True)
        self._dispatcher = threading.Thread(target=self._run_dispatch, daemon=True)
        self._worker.start()
        self._dispatcher.start()

    # ------------------------------------------------------------------
    def _fn(self, pixel_values: torch.Tensor, input_ids, attention_mask):
        if self._aot is not None:
            runner, meta = self._aot
            if not meta["from_uint8"]:
                pixel_values = normalize_pixels(
                    pixel_values.expand(*pixel_values.shape[:-1], 3), self.image_spec.mean,
                    self.image_spec.std, dtype=self.dtype)
            return runner(pixel_values, input_ids, attention_mask)
        if pixel_values.shape[-1] == 1:
            pixel_values = pixel_values.expand(*pixel_values.shape[:-1], 3)
        pixel_values = normalize_pixels(
            pixel_values, self.image_spec.mean, self.image_spec.std, dtype=self.dtype
        )
        out = compute_logits(self.params, self.cfg, pixel_values, input_ids,
                             attention_mask, dtype=self.dtype)
        return out["logits"], out["similarity_scores"]

    def register_prompt_set(self, name: str, prompts: List[str]) -> None:
        ids, mask = self.tokenizer(prompts)
        if self._aot is not None:
            meta = self._aot[1]
            want = (meta["n_prompts"], meta["max_tokens"])
            if np.shape(ids) != want:
                raise ValueError(f"bundle was exported for {want} prompt ids, the prompt set "
                                 f"{name!r} gives {np.shape(ids)}")
        self._prompt_sets[name] = (
            torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device),
            torch.as_tensor(np.asarray(mask), dtype=torch.long, device=self.device),
        )

    def warmup(self) -> None:
        """Run one full batch per prompt set through the serving path, on
        the dispatch thread: it builds the kernels on the first CUDA call
        and fills what is per thread (the cuBLAS handle) and the device and
        pinned-host allocators' caches."""
        if self._stop.is_set():
            raise RuntimeError("engine is closed")
        done: cf.Future = cf.Future()
        self._ready.put(done)
        done.result()

    def _warm(self, done: cf.Future) -> None:
        try:
            s = self.image_spec.size
            imgs = np.zeros((self.max_batch, s, s, self.channels), np.uint8)
            for name in self._prompt_sets:
                ready = self._dispatch(name, imgs)[2]
                if ready is not None:
                    ready.synchronize()
            done.set_result(None)
        except Exception as e:
            done.set_exception(e)

    # ------------------------------------------------------------------
    def submit(self, image: Union[np.ndarray, bytes], prompt_set: str,
               want_maps=False) -> cf.Future:
        """``image``: HWC (or HW) array, or encoded bytes. ``want_maps``:
        False/"none", True/"patch" (sigmoid maps on the patch grid) or
        "full" (projected to the original resolution)."""
        if prompt_set not in self._prompt_sets:
            raise KeyError(f"unknown prompt set {prompt_set!r}")
        if want_maps is True:
            want_maps = "patch"
        elif want_maps is False or want_maps is None:
            want_maps = "none"
        origin_hw = None if isinstance(image, (bytes, bytearray)) else tuple(image.shape[:2])
        if self._stop.is_set():
            raise RuntimeError("engine is closed")
        fut: cf.Future = cf.Future()
        self._queue.put(_Request(image, origin_hw, prompt_set, want_maps, fut))
        if self._stop.is_set():
            # close() may have drained between the check and the put
            self._fail_queued()
        return fut

    # ------------------------------------------------------------------
    def _take_held(self) -> Optional[_Request]:
        with self._held_lock:
            held, self._held = self._held, None
        return held

    def _hold(self, req: _Request) -> None:
        with self._held_lock:
            self._held = req

    def _collect(self) -> List[_Request]:
        first = self._take_held()
        if first is None:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                return []
        batch = [first]
        # greedy backlog drain: what is already queued joins at once;
        # max_delay only bounds the wait for requests not yet arrived
        while len(batch) < self.max_batch:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req.prompt_set != first.prompt_set:
                self._hold(req)
                return batch
            batch.append(req)
        t0 = time.perf_counter()
        while len(batch) < self.max_batch:
            remaining = self.max_delay - (time.perf_counter() - t0)
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if req.prompt_set != first.prompt_set:
                self._hold(req)
                break
            batch.append(req)
        return batch

    def _run_decode(self) -> None:
        """Stage 1: micro-batch assembly + host preparation of the images."""
        try:
            while not self._stop.is_set():
                batch = self._collect()
                if not batch:
                    continue
                try:
                    imgs = np.stack(list(self._pool.map(self._preprocess, batch)))
                except Exception as e:  # fault containment: fail this batch only
                    for r in batch:
                        if not r.future.done():
                            r.future.set_exception(e)
                    continue
                self._ready.put((batch, imgs))
        finally:
            self._ready.put(None)  # shutdown sentinel, always sent

    def _run_dispatch(self) -> None:
        """Stage 2: upload + launch, then hand the batch to stage 3 on the
        pool at once (its resolve waits on the batch's own readback event,
        so this thread goes on launching). Exits only on the decode
        stage's sentinel."""
        while True:
            item = self._ready.get()
            if item is None:
                break
            if isinstance(item, cf.Future):  # from warmup()
                self._warm(item)
                continue
            batch, imgs = item
            self.batch_sizes.append(len(batch))
            try:
                dispatched = self._dispatch(batch[0].prompt_set, imgs)
            except Exception as e:  # fault containment: fail this batch only
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)
                continue
            self._pool.submit(self._resolve, batch, dispatched)

    def _preprocess(self, req: _Request) -> np.ndarray:
        """-> (size, size, channels) uint8."""
        img, size = req.image, self.image_spec.size
        if isinstance(img, np.ndarray) and img.dtype == np.uint8 and img.shape[:2] == (size, size):
            if img.ndim == 2:
                img = img[..., None]
            if img.shape[2] == self.channels:
                return img
            if img.shape[2] == 1:
                return np.repeat(img, 3, axis=2)
            # RGB -> grey needs PIL's luma conversion: fall through
        if isinstance(img, (bytes, bytearray)) and self._native is not None:
            data = bytes(img)
            if req.origin_hw is None and req.want_maps == "full":
                req.origin_hw = self._native.jpeg_dims(data)  # header only
            decode = (self._native.decode_resize_gray_u8 if self.channels == 1
                      else self._native.decode_resize_u8)
            return decode(data, size, size, fast_scale=self.fast_scale)
        return self._pil_resize_u8(req)

    def _pil_resize_u8(self, req: _Request) -> np.ndarray:
        from PIL import Image  # only requests that need decoding or resizing

        img = req.image
        if isinstance(img, (bytes, bytearray)):
            img = Image.open(io.BytesIO(img))
            if req.origin_hw is None:
                req.origin_hw = (img.height, img.width)
        elif isinstance(img, np.ndarray):
            img = Image.fromarray(img)
        size = self.image_spec.size
        mode = "L" if self.channels == 1 else "RGB"
        out = np.asarray(img.convert(mode).resize((size, size), Image.Resampling.BICUBIC),
                         np.uint8)
        return out[..., None] if self.channels == 1 else out

    def _dispatch(self, prompt_set: str, imgs: np.ndarray):
        """Upload, launch and queue the readback; -> (logits, scores, ready
        event or None), host tensors that are valid once ``ready`` is."""
        ids, mask = self._prompt_sets[prompt_set]
        n = len(imgs)
        if self._aot is not None and n < self.max_batch:
            # an exported program has one shape: pad with the last image;
            # _resolve reads only the first n rows
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], self.max_batch - n, axis=0)])
        pv = torch.from_numpy(imgs)
        if self.device.type == "cuda":
            # pinned + non_blocking: a pageable upload would wait for the
            # previous batch's kernels and stall this thread's launches
            pv = pv.pin_memory().to(self.device, non_blocking=True)
        with torch.inference_mode():
            logits, scores = (t.float() for t in self._fn(pv, ids, mask))
            if self.device.type != "cuda":
                return logits, scores, None
            # queue the readback right behind this batch's own kernels: a
            # blocking .cpu() in _resolve would wait for the next batch too
            host = [torch.empty(t.shape, pin_memory=True) for t in (logits, scores)]
            for h, t in zip(host, (logits, scores)):
                h.copy_(t, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        return host[0], host[1], ready

    def _resolve(self, batch: List[_Request], dispatched) -> None:
        try:
            logits, scores, ready = dispatched
            if ready is not None:
                ready.synchronize()
            logits, scores = logits.numpy(), scores.numpy()
            for i, req in enumerate(batch):
                probs = 1.0 / (1.0 + np.exp(-logits[i]))
                maps = None
                if req.want_maps == "patch":
                    g = int(round(scores.shape[-1] ** 0.5))
                    maps = 1.0 / (1.0 + np.exp(-scores[i].reshape(-1, g, g)))
                elif req.want_maps == "full":
                    maps = upsample_similarity_map(scores[i], req.origin_hw,
                                                   self.image_spec.geometry)
                    maps = 1.0 / (1.0 + np.exp(-maps))
                req.future.set_result({"probs": probs, "similarity_maps": maps})
        except Exception as e:  # fault containment: fail this batch only
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)

    # ------------------------------------------------------------------
    def close(self) -> None:
        self._stop.set()
        self._worker.join(timeout=5)
        try:  # second sentinel; if the queue is full the dispatcher
            self._ready.put_nowait(None)  # is draining toward the first
        except queue.Full:
            pass
        self._dispatcher.join(timeout=15)
        self._pool.shutdown(wait=True)
        self._fail_queued()

    def _fail_queued(self) -> None:
        held = self._take_held()
        if held is not None and not held.future.done():
            held.future.set_exception(RuntimeError("engine shutting down"))
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if not req.future.done():
                req.future.set_exception(RuntimeError("engine shutting down"))

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
        return False
