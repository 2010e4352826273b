"""Training data pipeline: decode -> process -> pack -> upload (port of
radzero_tpu/data/pipeline.py).

``PackSpec``, ``pack_batch`` and ``TrainLoader`` are the JAX package's
host numpy, copied so that they give the same arrays, byte for byte, for
the same records, image loader, tokenizer and seed:

- every batch is (B images, S = B * max_sentences_per_image sentence
  slots): each image contributes up to ``max_sentences_per_image``
  finding sentences (random subsample when it has more, as a form of
  sentence dropout; the reference feeds all sentences ragged), padded
  slots carry ``row_mask = 0`` and are inert in the loss;
- ``group_map`` holds *global* image indices (process offset applied),
  mirroring the rank offset of losses.py:149-151;
- image decode/resize runs on a thread pool; batches are assembled on
  the host in a bounded queue.

What differs is the last stage: :func:`to_device` and
:func:`device_prefetch` move a packed batch onto one explicit torch
device (from pinned host memory with ``non_blocking=True`` on a CUDA
device) where the JAX package ``device_put``s it over a mesh.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
from dataclasses import dataclass
from queue import Queue
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch


@dataclass
class PackSpec:
    max_sentences_per_image: int = 8
    max_text_tokens: int = 64
    with_random_positive: bool = False  # for CLIP/SigLIP aux losses
    # Length buckets: per batch, the text block is trimmed to the
    # smallest bucket covering its longest real sentence (plus
    # max_text_tokens as the final bucket). MIMIC finding sentences
    # average ~20 tokens, so a {16, 32} bucket set cuts the text-tower
    # FLOPs 2-4x vs always padding to the static 64 slot; the train step
    # re-jits once per distinct bucket (len(buckets)+1 executables max).
    text_length_buckets: tuple = ()
    # Sentence dedup (opt-in): LLM-extracted finding sentences repeat
    # heavily across a batch's images ("There is no pleural effusion."
    # appears under most normal studies), yet the reference encodes
    # every row (exp/cxr_pt/model/losses.py:135-147 runs the text tower
    # per image, duplicates included). With ``dedup_slots = U > 0`` the
    # packed batch carries only the UNIQUE (input_ids, attention_mask)
    # rows (padded to the static U) plus a ``row_gather`` (S,) map; the
    # text tower runs on U rows and features gather back to S — the
    # gather's VJP scatter-adds duplicate-row gradients, so the loss and
    # its gradients are exactly the non-dedup computation.
    #
    # Batches with more than U unique rows are handled by
    # ``dedup_overflow`` (a pack_batch argument, set by TrainLoader):
    # - "fallback" (single-process default): emit the plain (S,) layout
    #   for that batch — one extra executable, like a length bucket;
    #   always exact.
    # - "drop" (multi-process): ALWAYS emit the dedup layout; overflow
    #   rows (sentences beyond the first U uniques in first-occurrence
    #   order) are masked out of the loss (row_mask=0). Rank-consistent
    #   by construction — one executable, no batch-content-dependent
    #   shape divergence across processes — and exact whenever a shard's
    #   unique count fits its slots (the calibrated operating point;
    #   TrainLoader counts dropped sentences in ``dedup_dropped``).
    dedup_slots: int = 0


def pack_batch(
    records: List[dict],
    images: np.ndarray,          # (B, H, W, 3) processed pixel values
    tokenizer,
    spec: PackSpec,
    rng: Optional[np.random.Generator] = None,
    global_offset: int = 0,
    text_offset: int = 0,
    dedup_overflow: str = "fallback",
    stats: Optional[dict] = None,
) -> Dict[str, np.ndarray]:
    """Pack B records into the static flattened-batch layout.

    ``text_offset``: added to ``row_gather`` so multi-process local
    batches concatenate into a correct global batch — each rank's
    gather indices point into ITS slice of the globally concatenated
    unique text block (``process_index * dedup_slots``), mirroring the
    ``global_offset`` rank offset on ``group_map``.
    ``dedup_overflow``: see PackSpec.dedup_slots. ``stats``: mutable
    dict; ``stats["dedup_dropped"]`` accumulates sentences masked out
    by the "drop" policy.
    """
    rng = rng or np.random.default_rng(0)
    B = len(records)
    S = B * spec.max_sentences_per_image

    texts: List[str] = []
    group: List[int] = []
    for i, rec in enumerate(records):
        phrases = rec["key_phrases"]
        if len(phrases) > spec.max_sentences_per_image:
            idx = rng.choice(len(phrases), spec.max_sentences_per_image, replace=False)
            phrases = [phrases[j] for j in idx]
        texts.extend(phrases)
        group.extend([global_offset + i] * len(phrases))

    n_real = len(texts)
    texts = texts + [""] * (S - n_real)
    ids, mask = tokenizer(texts, spec.max_text_tokens)

    row_gather = None
    dropped = None
    if spec.dedup_slots:
        if dedup_overflow not in ("fallback", "drop"):
            raise ValueError(f"unknown dedup_overflow policy {dedup_overflow!r}")
        U = spec.dedup_slots
        l_tok = ids.shape[1]
        uniq, first_idx, inverse = np.unique(
            np.concatenate([ids, mask], axis=1), axis=0,
            return_index=True, return_inverse=True,
        )
        # reorder uniques by first occurrence: makes the "drop" policy's
        # overflow rule (drop uniques seen latest) stable wrt row order
        order = np.argsort(first_idx, kind="stable")
        rank_of = np.empty(len(order), np.int64)
        rank_of[order] = np.arange(len(order))
        uniq = uniq[order]
        inverse = rank_of[inverse]
        if len(uniq) > U and dedup_overflow == "drop":
            dropped = inverse >= U
            if stats is not None:
                stats["dedup_dropped"] = stats.get("dedup_dropped", 0) + int(
                    np.count_nonzero(dropped[:n_real])
                )
            uniq = uniq[:U]
            inverse = np.where(dropped, 0, inverse)
        if len(uniq) <= U:
            pad = np.broadcast_to(uniq[:1], (U - len(uniq), uniq.shape[1]))
            uniq = np.concatenate([uniq, pad], axis=0)
            ids = np.ascontiguousarray(uniq[:, :l_tok])
            mask = np.ascontiguousarray(uniq[:, l_tok:])
            row_gather = (inverse + text_offset).astype(np.int32)
        # else ("fallback"): plain (S,) layout for this batch

    if spec.text_length_buckets:
        longest = int(mask.sum(axis=1).max()) if n_real else 1
        for b in sorted(spec.text_length_buckets):
            if longest <= b < spec.max_text_tokens:
                ids, mask = ids[:, :b], mask[:, :b]
                break

    group_map = np.zeros((S,), np.int32)
    group_map[:n_real] = np.asarray(group, np.int32)
    row_mask = np.zeros((S,), np.float32)
    row_mask[:n_real] = 1.0
    if dropped is not None and row_gather is not None:
        # overflow rows leave the loss entirely (provably inert at
        # row_mask=0, tests/test_vlcabs_and_mpnce.py)
        row_mask[dropped] = 0.0
        group_map[dropped] = 0

    batch = {
        "pixel_values": images.astype(np.float32),
        "input_ids": ids,
        "attention_mask": mask,
        "group_map": group_map,
        "row_mask": row_mask,
    }
    if row_gather is not None:
        batch["row_gather"] = row_gather

    if spec.with_random_positive:
        rand_texts = [rec["key_phrases"][rng.integers(len(rec["key_phrases"]))] for rec in records]
        rids, rmask = tokenizer(rand_texts, spec.max_text_tokens)
        batch["random_input_ids"] = rids
        batch["random_attention_mask"] = rmask
    return batch


class TrainLoader:
    """Epoch iterator: shuffle -> threaded decode -> pack -> prefetch queue.

    ``image_loader(record) -> np.ndarray (H, W, 3) processed`` lets the
    caller choose decode backend (PIL file read, in-memory test arrays,
    or the native C++ preprocessing extension).
    """

    def __init__(
        self,
        records: List[dict],
        image_loader: Callable[[dict], np.ndarray],
        tokenizer,
        batch_size: int,
        spec: PackSpec,
        *,
        seed: int = 42,
        shuffle: bool = True,
        num_threads: int = 8,
        prefetch: int = 2,
        drop_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        echo: int = 1,
        with_indices: bool = False,
        stable_sharding: bool = False,
    ):
        """Multi-host sharding (``process_count > 1``): every process
        draws the SAME deterministic global shuffle (seed + epoch), then
        takes its strided slice — disjoint records, equal batch counts,
        no coordination traffic. ``group_map`` carries global image
        indices offset by ``process_index * batch_size`` within each
        global step, mirroring the reference's ``rank * B_local`` offset
        (losses.py:149-151).

        ``echo > 1``: data echoing for host-bound phases — each decoded
        batch is yielded ``echo`` times back-to-back (the device takes
        extra optimizer steps on data the host already paid to decode;
        Choi et al. 2019). Counts toward __len__ and the LR schedule.

        ``with_indices``: add ``record_indices`` (B,) int64 — each
        batch row's index into ``records`` — to every packed batch.
        HOST-ONLY metadata (the trainer pops it before device upload);
        keys the frozen-tower activation cache (train/tower_cache.py).

        ``stable_sharding``: pin each process to a FIXED record shard
        (seed-only assignment) and reshuffle only WITHIN the shard per
        epoch, instead of re-drawing the global shuffle and restriding.
        Required by per-process record caches (the tower cache): under
        the default global reshuffle a process sees a mostly-different
        1/P of the records every epoch, so a cache keyed by record
        index essentially never hits and grows toward a full per-host
        copy. No effect when ``process_count == 1``."""
        self.records = records
        self.image_loader = image_loader
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.spec = spec
        self.seed = seed
        self.shuffle = shuffle
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.drop_last = drop_last
        if not (0 <= process_index < process_count):
            raise ValueError(f"process_index {process_index} not in [0, {process_count})")
        self.process_index = process_index
        self.process_count = process_count
        if process_count > 1:
            # Multi-host SPMD requires every process to jit the same
            # shapes at the same global step. Per-batch length bucketing
            # picks the bucket from the process-LOCAL longest sentence,
            # so two processes could trim the text block differently —
            # mismatched executables, hang or crash. Force the static
            # max_text_tokens slot instead (process-independent).
            if spec.text_length_buckets:
                import dataclasses
                import logging

                logging.getLogger("radzero").warning(
                    "text_length_buckets disabled: bucket choice is batch-"
                    "content-dependent and process-local, which desyncs "
                    "shapes across %d processes", process_count,
                )
                spec = dataclasses.replace(spec, text_length_buckets=())
                self.spec = spec
            # Dedup's exact unique-count FALLBACK is batch-content-
            # dependent the same way (one rank over dedup_slots, another
            # under -> mismatched text shapes in the global step), so
            # multi-process loaders use the rank-consistent "drop"
            # policy instead: the dedup layout is emitted UNCONDITIONALLY
            # (one executable, no shape divergence) and the rare rows
            # beyond a shard's slots are masked out of the loss
            # (counted in ``self.stats["dedup_dropped"]``). Exact
            # whenever each shard's unique count fits its slots — size
            # dedup_slots to the measured duplication rate (BASELINE.md
            # dedup calibration).
            # drop_last=False can give processes unequal batch counts
            # (e.g. 9 records, 2 procs, bs 4 -> 2 vs 1 batches), desyncing
            # collectives at the epoch tail.
            if not drop_last:
                raise ValueError(
                    "process_count > 1 requires drop_last=True: unequal "
                    "per-process batch counts desync collectives"
                )
        if echo < 1:
            raise ValueError("echo must be >= 1")
        self.echo = echo
        self.with_indices = with_indices
        self.stable_sharding = bool(stable_sharding)
        self.epoch = 0
        self.dedup_overflow = "drop" if process_count > 1 else "fallback"
        self.stats: Dict[str, int] = {"dedup_dropped": 0}

    def _global_usable(self) -> int:
        """Records usable per epoch across all processes (truncated so
        every process sees the same number of full batches)."""
        per_step = self.batch_size * self.process_count
        if self.drop_last:
            return (len(self.records) // per_step) * per_step
        return len(self.records)

    def __len__(self) -> int:
        if self.drop_last:
            n = self._global_usable() // (self.batch_size * self.process_count)
        else:
            mine = len(range(self.process_index, len(self.records), self.process_count))
            n = mine // self.batch_size
            if mine % self.batch_size:
                n += 1
        return n * self.echo

    def _batches(self, order: np.ndarray) -> Iterator[tuple]:
        for start in range(0, len(order), self.batch_size):
            chunk = order[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk, [self.records[i] for i in chunk]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # eval loaders (shuffle=False) keep a fixed rng so sentence
        # subsampling is identical across epochs -> comparable eval losses
        rng = np.random.default_rng(self.seed + (self.epoch if self.shuffle else 0))
        if self.process_count > 1 and self.stable_sharding:
            # fixed per-process shard (seed-only global permutation,
            # identical every epoch), reshuffled locally per epoch —
            # disjoint and equal-sized by the same truncation as below
            base = np.random.default_rng(self.seed).permutation(len(self.records))
            base = base[: self._global_usable()] if self.drop_last else base
            order = base[self.process_index :: self.process_count]
            if self.shuffle:
                rng.shuffle(order)
        else:
            order = np.arange(len(self.records))
            if self.shuffle:
                rng.shuffle(order)
            if self.process_count > 1:
                order = order[: self._global_usable()] if self.drop_last else order
                order = order[self.process_index :: self.process_count]
        self.epoch += 1

        q: Queue = Queue(maxsize=self.prefetch)
        sentinel = object()

        offset = self.process_index * self.batch_size

        text_offset = self.process_index * self.spec.dedup_slots

        def producer():
            with cf.ThreadPoolExecutor(self.num_threads) as pool:
                for chunk, recs in self._batches(order):
                    imgs = np.stack(list(pool.map(self.image_loader, recs)))
                    packed = pack_batch(
                        recs, imgs, self.tokenizer, self.spec, rng,
                        global_offset=offset, text_offset=text_offset,
                        dedup_overflow=self.dedup_overflow, stats=self.stats,
                    )
                    if self.with_indices:
                        packed["record_indices"] = np.asarray(chunk, np.int64)
                    for i in range(self.echo):
                        # echoed repeats are shallow copies: a consumer
                        # that mutates a batch in place (dict pops) must
                        # not corrupt the next yield of the same batch.
                        # Copies go out FIRST and the original LAST — a
                        # copy taken after an earlier yield was exposed
                        # could snapshot a consumer's in-place mutation
                        # (q.put releases the GIL)
                        q.put(dict(packed) if i < self.echo - 1 else packed)
            q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()


def to_device(batch: Dict[str, np.ndarray], device="cuda", stream=None) -> dict:
    """A packed batch as torch tensors on ``device``; integer arrays become
    int64, torch's index dtype. Values may be numpy arrays or tensors (a
    tensor already on ``device`` is used as it is). ``record_indices``
    (host-only metadata, the tower cache's key) stays behind.

    On a CUDA device each array is first copied into pinned host memory
    (``pin_memory``: one host memcpy of the batch, ~206 MB of fp32 pixels
    at 64 x 518 x 518 x 3), then uploaded with ``non_blocking=True``; a
    copy from pageable memory would block the host until it lands. With
    ``stream`` the upload is issued there and the caller's current stream
    waits for it, so the copy can run beside work enqueued before. On the
    CPU the arrays are plain copies."""
    dev = torch.device(device)
    out, done = _upload(batch, dev, stream)
    if done is not None:
        torch.cuda.current_stream(dev).wait_event(done)
    return out


def _upload(batch, dev: torch.device, stream):
    """-> (tensors on ``dev``, the CUDA event that marks their upload on
    ``stream``, or None where the current stream did the copy)."""
    host = {k: _tensor(v) for k, v in batch.items() if k != "record_indices"}
    if dev.type != "cuda":
        return {k: v.to(dev, copy=True) for k, v in host.items()}, None
    current = torch.cuda.current_stream(dev)
    side = stream is not None and stream != current
    with torch.cuda.stream(stream if side else current):
        out = {k: v if _on(v, dev) else v.pin_memory().to(dev, non_blocking=True)
               for k, v in host.items()}
    if not side:
        return out, None
    for k, v in out.items():
        if host[k] is not v:
            v.record_stream(current)  # freed only once the consumer's work on it is done
    done = torch.cuda.Event()
    done.record(stream)
    return out, done


def _tensor(v) -> torch.Tensor:
    """A numpy array or tensor as a tensor; integers as int64."""
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
    return t if t.is_floating_point() or t.dtype in (torch.bool, torch.int64) else t.long()


def _on(t: torch.Tensor, dev: torch.device) -> bool:
    return t.device.type == dev.type and dev.index in (None, t.device.index)


def device_prefetch(host_iter, device="cuda", size: int = 2) -> Iterator[dict]:
    """Overlap host batch assembly and upload with device compute: keep
    ``size`` batches uploaded ahead of the consumer (on a CUDA device on a
    copy stream of its own; the consumer's current stream waits for a
    batch's copy only when that batch is yielded). Yields dicts of tensors
    on ``device``, as :func:`to_device` makes them."""
    dev = torch.device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    buf: List[tuple] = []
    it = iter(host_iter)
    for b in it:
        buf.append(_upload(b, dev, stream))
        if len(buf) == size:
            break
    while buf:
        out, done = buf.pop(0)
        for b in it:
            buf.append(_upload(b, dev, stream))
            break
        if done is not None:
            torch.cuda.current_stream(dev).wait_event(done)
        yield out


def pil_image_loader(processor) -> Callable[[dict], np.ndarray]:
    """Default image_loader: open record['image'] with PIL, run processor."""
    from PIL import Image

    def load(record: dict) -> np.ndarray:
        with Image.open(record["image"]) as im:
            return processor(im)["pixel_values"][0]

    return load
