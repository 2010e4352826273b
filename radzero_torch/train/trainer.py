"""RadZeroTrainer — the explicit training loop (port of
radzero_tpu/train/trainer.py).

A small host orchestrator around ``train/step.py``'s train and eval
steps, with the reference HF-Trainer fork's real customisations
(SURVEY.md §7):

- multi-loss telemetry: each sub-loss logged separately per
  ``logging_steps`` (common/trainer.py:361-364,952-995);
- per-epoch evaluation with ``eval_loss`` model selection and early
  stopping (config.yaml:13-19, run.py:109-113);
- epoch-wise checkpointing with ``save_total_limit`` pruning, resume
  (step/epoch restore), and best-model-at-end
  (common/trainer.py:561-632,888-936);
- samples/sec speed metrics (common/trainer.py:903-909).

Where it departs from the JAX trainer:

- ``device=`` (the card unless the caller asks for the CPU) takes the
  place of ``mesh=``: one device, no sharding. Every impl the config
  names runs on every device, so there is no ``resolve_backend_impls``
  downgrade, and the frozen tower always runs on the fused K1-K3 layer
  (``forward_train``), so there is no flash-to-fused substitution.
- Batches are uploaded by ``data/pipeline.py``'s ``to_device``: each host
  array is copied into pinned memory on the host thread (a memcpy of the
  batch, chiefly its 206 MB of fp32 pixels at batch 64; its time on the
  host of the H100 is in PERF.md §5, beside the step's) and then sent with
  ``non_blocking=True`` on a copy stream of the trainer's own. The upload of batch i+1 thus
  runs while step i computes, as the JAX loop's deferred loss read
  intends; from pageable memory the copy would block the host.
  ``record_indices`` stays on the host, as in the JAX ``_put_batch``.
- ``gradient_checkpointing=True`` is the step's ``remat``
  (``train/step.py``), as in the JAX trainer; a step with it gives the
  same losses and gradients bit for bit.
- ``log_history.jsonl`` write errors raise; the JAX trainer ignores
  them. The one swallowed exception is the JAX package's own guard
  around ``report_to="wandb"``.
- ``predict`` runs ``inference_step`` eagerly under ``torch.no_grad()``
  (no jit) and returns numpy arrays, 16-bit floats widened to fp32
  (numpy has no bfloat16; the widening is exact).
- ``params=None`` builds the weights with the port's ``init_radzero``
  from ``torch.Generator(device).manual_seed(args.seed)``; given
  ``params`` are copied onto the device (the trainable leaves always,
  since the step updates them in place).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from radzero_torch.data.pipeline import to_device
from radzero_torch.models.configuration import RadZeroConfig
from radzero_torch.models.radzero import init_radzero
from radzero_torch.train.checkpoint import (
    checkpoint_dir,
    get_last_checkpoint,
    load_trainer_state,
    restore_checkpoint,
    save_checkpoint,
)
from radzero_torch.train.optim import build_optimizer, merge_params, partition_params
from radzero_torch.train.step import make_eval_step, make_train_step
from radzero_torch.utils.logging import logger


@dataclass
class TrainerArgs:
    """Subset of HF TrainingArguments the recipe uses (config.yaml:1-27)."""

    output_dir: str = os.path.join(tempfile.gettempdir(), "radzero_run")
    learning_rate: float = 1e-4
    num_train_epochs: int = 10
    weight_decay: float = 0.05
    max_grad_norm: float = 1.0
    warmup_steps: int = 50
    logging_steps: int = 10
    save_total_limit: Optional[int] = None
    metric_for_best_model: str = "eval_loss"
    greater_is_better: bool = False
    load_best_model_at_end: bool = True
    early_stopping_patience: Optional[int] = None
    bf16: bool = True
    bf16_optimizer_moments: bool = False  # Adam mu in bf16 (optim.py)
    gradient_checkpointing: bool = False
    gradient_accumulation_steps: int = 1
    seed: int = 42
    module_to_update: tuple = ("align_transformer", "text_model", "loss_fns")
    loss_ratio: Optional[Dict[str, float]] = None
    report_to: str = "none"


@dataclass
class TrainerState:
    step: int = 0
    epoch: int = 0
    best_metric: Optional[float] = None
    best_checkpoint: Optional[str] = None
    patience_left: Optional[int] = None
    log_history: List[Dict[str, Any]] = field(default_factory=list)


def _to(tree, device: torch.device, copy: bool):
    if isinstance(tree, dict):
        return {k: _to(v, device, copy) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device, copy) for v in tree]
    return tree.to(device, copy=copy)


class RadZeroTrainer:
    def __init__(
        self,
        model_cfg: RadZeroConfig,
        args: TrainerArgs,
        train_loader,                      # iterable of packed host batches
        eval_loader=None,
        params: Optional[dict] = None,
        device="cuda",
        metrics_callback: Optional[Callable[[Dict[str, Any]], None]] = None,
        tower_cache=None,
    ):
        """``tower_cache``: an optional ``train.tower_cache.TowerCache``.
        The frozen vision tower's output tokens are computed once per
        record (first epoch), stored keyed by the loader's
        ``record_indices``, and fed back as ``tower_tokens`` on later
        epochs — the train step then never runs the tower. Requires the
        tower frozen (it is, under the reference policy) and the train
        loader constructed ``with_indices=True``."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.cfg = model_cfg
        self.args = args
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        self.metrics_callback = metrics_callback

        if params is None:
            g = torch.Generator(device=self.device).manual_seed(args.seed)
            params = init_radzero(g, model_cfg)
        trainable, frozen = partition_params(params, args.module_to_update)
        self.trainable = _to(trainable, self.device, copy=True)
        self.frozen = _to(frozen, self.device, copy=False)

        self.tower_cache = tower_cache
        self._tower_fn = None
        if tower_cache is not None:
            if "vision_model" in args.module_to_update:
                raise ValueError(
                    "tower_cache requires a frozen vision tower: cached "
                    "activations would go stale the moment the tower "
                    "updates (remove 'vision_model' from module_to_update)"
                )
            if getattr(train_loader, "process_count", 1) > 1 and not getattr(
                train_loader, "stable_sharding", False
            ):
                # under the default global per-epoch reshuffle each
                # process sees a mostly-different 1/P of the records
                # every epoch: a per-process cache keyed by record index
                # essentially never hits (get() needs ALL batch rows
                # present) while its store grows toward a full per-host
                # copy of the dataset
                raise ValueError(
                    "tower_cache with process_count > 1 requires "
                    "TrainLoader(..., stable_sharding=True): each process "
                    "must own a fixed record shard across epochs for its "
                    "cache to ever hit"
                )
            # the JAX trainer's default with the cache on: the tower never
            # enters the step, so the align layers need no remat (only the
            # None default is overridden; an explicit AlignConfig.remat wins)
            if model_cfg.align.remat is None:
                model_cfg = dataclasses.replace(
                    model_cfg, align=dataclasses.replace(model_cfg.align, remat=False)
                )
                self.cfg = model_cfg

            from radzero_torch.train.tower_cache import make_tower_fn

            self._tower_fn = make_tower_fn(
                model_cfg, dtype=torch.bfloat16 if args.bf16 else torch.float32
            )

        steps_per_epoch = max(len(train_loader), 1)
        total_steps = steps_per_epoch * args.num_train_epochs
        self.optimizer, self.schedule = build_optimizer(
            learning_rate=args.learning_rate,
            weight_decay=args.weight_decay,
            max_grad_norm=args.max_grad_norm,
            warmup_steps=args.warmup_steps,
            total_steps=total_steps,
            gradient_accumulation_steps=args.gradient_accumulation_steps,
            bf16_moments=args.bf16_optimizer_moments,
        )
        self.opt_state = self.optimizer.init(self.trainable)

        dtype = torch.bfloat16 if args.bf16 else torch.float32
        self.train_step = make_train_step(
            model_cfg, self.optimizer, loss_ratio=args.loss_ratio, dtype=dtype,
            remat=args.gradient_checkpointing, device=self.device,
        )
        self.eval_step = make_eval_step(model_cfg, loss_ratio=args.loss_ratio, dtype=dtype,
                                        device=self.device)
        self.state = TrainerState(
            patience_left=args.early_stopping_patience,
        )
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)

    # ------------------------------------------------------------------
    @property
    def params(self) -> dict:
        return merge_params(self.trainable, self.frozen)

    def _ckpt_state(self) -> dict:
        return {"trainable": self.trainable, "opt_state": self.opt_state}

    def _put_batch(self, batch: Dict[str, Any]) -> dict:
        return to_device(batch, self.device, self._copy_stream)

    def _resolve_tower(self, batch: Dict[str, Any]) -> dict:
        """Swap ``pixel_values`` for cached/freshly-computed
        ``tower_tokens`` when the activation cache is enabled."""
        if self.tower_cache is None:
            return batch
        idx = batch.get("record_indices")
        if idx is None:
            raise ValueError(
                "tower_cache requires the train loader to emit "
                "record_indices (TrainLoader(..., with_indices=True))"
            )
        batch = dict(batch)
        pixels = batch.pop("pixel_values")
        tokens = self.tower_cache.get(idx)
        if tokens is None:
            tokens = self._tower_fn(
                self.frozen["vision_model"],
                self._put_batch({"pixel_values": pixels})["pixel_values"],
            )
            # host backings copy to host inside put; the device backing
            # copies into its store on the device with no readback
            self.tower_cache.put(idx, tokens)
        batch["tower_tokens"] = tokens
        return batch

    # ------------------------------------------------------------------
    def maybe_resume(self, resume_from_checkpoint=None) -> None:
        """Restore params/opt-state/counters (HF resume semantics)."""
        path = resume_from_checkpoint
        if path is None or path is False:
            # HF Trainer semantics (ref common/trainer.py:561-570): a plain
            # train() never auto-resumes; only an explicit truthy flag does.
            return
        if path is True:
            path = get_last_checkpoint(self.args.output_dir)
        if not path:
            return
        logger.info(f"resuming from checkpoint {path}")
        restored = restore_checkpoint(path, self._ckpt_state())
        self.trainable = restored["trainable"]
        self.opt_state = restored["opt_state"]
        meta = load_trainer_state(path)
        self.state.step = meta.get("step", 0)
        self.state.epoch = meta.get("epoch", 0)
        # restore the data-order position so shuffling continues from the
        # right epoch (HF resume restores dataloader state similarly)
        if hasattr(self.train_loader, "epoch"):
            self.train_loader.epoch = self.state.epoch
        self.state.best_metric = meta.get("best_metric")
        self.state.best_checkpoint = meta.get("best_checkpoint")
        self.state.patience_left = meta.get(
            "patience_left", self.args.early_stopping_patience
        )

    # ------------------------------------------------------------------
    def _log(self, record: Dict[str, Any]) -> None:
        # The callback runs FIRST and may enrich the record in place;
        # everything it adds is then durable in log_history.jsonl rather
        # than living only in memory. A RAISING callback (NaN-guard
        # asserts) must still not lose the record — the one that matters
        # most for diagnosing the failure — so persistence runs in the
        # finally and the exception propagates after it.
        try:
            if self.metrics_callback:
                self.metrics_callback(record)
        finally:
            self._persist_log(record)

    def _persist_log(self, record: Dict[str, Any]) -> None:
        self.state.log_history.append(record)
        logger.info(
            " ".join(
                f"{k}={v:.6g}" if isinstance(v, (int, float)) else f"{k}={v}"
                for k, v in record.items()
            )
        )
        # durable metrics stream (the wandb-independent record of every
        # sub-loss, the trainer fork's telemetry contract)
        os.makedirs(self.args.output_dir, exist_ok=True)
        with open(os.path.join(self.args.output_dir, "log_history.jsonl"), "a") as f:
            f.write(json.dumps(record, default=float) + "\n")
        if self.args.report_to == "wandb":
            try:
                import wandb

                if wandb.run is not None:
                    wandb.log(record, step=record.get("step"))
            except Exception:
                pass

    # ------------------------------------------------------------------
    def evaluate(self) -> Dict[str, float]:
        """Mean of the per-loss dicts over the eval set
        (ref evaluation_loop multi-loss carry, common/trainer.py:1017-1494)."""
        if self.eval_loader is None:
            return {}
        sums: Dict[str, float] = {}
        n = 0
        for batch in self.eval_loader:
            losses = self.eval_step(self.params, self._put_batch(batch))
            for k, v in zip(losses, _read(losses)):
                sums[k] = sums.get(k, 0.0) + v
            n += 1
        if n == 0:
            return {}
        return {f"eval_{k}": v / n for k, v in sums.items()}

    # ------------------------------------------------------------------
    def predict(self, loader, inference_step: Callable) -> Dict[str, np.ndarray]:
        """Prediction-only loop (the trainer fork's third loop kind,
        common/trainer.py:1496-1855): run ``inference_step(params, batch)
        -> {name: tensor}`` over a dataset under ``torch.no_grad()``,
        gather per-batch outputs to host and concatenate. The reference's
        -100-padded cross-process gather collapses to plain concatenation
        on one device."""
        collected: Dict[str, list] = {}
        with torch.no_grad():
            for batch in loader:
                out = inference_step(self.params, self._put_batch(batch))
                for k, v in out.items():
                    v = v.detach()
                    if v.dtype in (torch.bfloat16, torch.float16):
                        v = v.float()
                    collected.setdefault(k, []).append(v.cpu().numpy())
        return {k: np.concatenate(v, axis=0) for k, v in collected.items()}

    # ------------------------------------------------------------------
    def _is_better(self, metric: float) -> bool:
        if self.state.best_metric is None:
            return True
        if self.args.greater_is_better:
            return metric > self.state.best_metric
        return metric < self.state.best_metric

    def train(self, resume_from_checkpoint=None) -> TrainerState:
        self.maybe_resume(resume_from_checkpoint)
        args = self.args

        for epoch in range(self.state.epoch, args.num_train_epochs):
            epoch_t0 = time.perf_counter()
            n_samples = 0
            running: Dict[str, float] = {}
            running_n = 0

            # Upload/compute overlap: the step is enqueued asynchronously,
            # but reading a loss blocks until the step completes — so the
            # previous step's loss read is DEFERRED until after the next
            # batch's upload has been issued. The copy then runs on the
            # copy stream while the previous step computes.
            pending = None  # (step, epoch, losses) awaiting host readout

            def consume(p):
                nonlocal running, running_n
                step_no, ep, losses = p
                for k, v in zip(losses, _read(losses)):
                    running[k] = running.get(k, 0.0) + v
                running_n += 1
                if step_no % args.logging_steps == 0:
                    rec = {k: v / running_n for k, v in running.items()}
                    rec.update(step=step_no, epoch=ep, lr=float(self.schedule(step_no)))
                    self._log(rec)
                    running, running_n = {}, 0

            for batch in self.train_loader:
                n_samples += len(batch.get("pixel_values", batch.get("tower_tokens", ())))
                batch = self._resolve_tower(batch)
                dev_batch = self._put_batch(batch)
                if pending is not None:
                    consume(pending)
                self.trainable, self.opt_state, losses = self.train_step(
                    self.trainable, self.frozen, self.opt_state, dev_batch
                )
                self.state.step += 1
                pending = (self.state.step, epoch, losses)
            if pending is not None:
                consume(pending)

            self.state.epoch = epoch + 1
            dt = time.perf_counter() - epoch_t0
            epoch_metrics: Dict[str, Any] = {
                "step": self.state.step,
                "epoch": epoch + 1,
                "train_samples_per_second": n_samples / max(dt, 1e-9),
            }
            # With data echoing each decoded batch is consumed ``echo``
            # times, so samples/s above is the DEVICE rate (inflated by
            # the echo factor vs non-echo baselines). Also report the
            # decoded-sample rate.
            echo = getattr(self.train_loader, "echo", 1)
            if echo > 1:
                epoch_metrics["train_decoded_samples_per_second"] = (
                    n_samples / echo / max(dt, 1e-9)
                )

            eval_metrics = self.evaluate()
            epoch_metrics.update(eval_metrics)
            self._log(epoch_metrics)

            # best selection BEFORE the save: pruning must see the
            # up-to-date best (the to-be-saved path is deterministic),
            # or an improving epoch protects the obsolete old best and
            # deletes the newest rollback point instead — HF rotates
            # after updating best_model_checkpoint (ref
            # common/trainer.py:888-936), and the persisted metadata
            # should carry the current best, not last epoch's.
            prospective = checkpoint_dir(args.output_dir, self.state.step)
            stop_early = False
            metric_key = args.metric_for_best_model
            if metric_key in eval_metrics:
                metric = eval_metrics[metric_key]
                if self._is_better(metric):
                    self.state.best_metric = metric
                    self.state.best_checkpoint = prospective
                    self.state.patience_left = args.early_stopping_patience
                elif self.state.patience_left is not None:
                    self.state.patience_left -= 1
                    if self.state.patience_left <= 0:
                        logger.info(
                            f"early stopping at epoch {epoch + 1} "
                            f"(best {metric_key}={self.state.best_metric:.6g})"
                        )
                        stop_early = True

            meta = {
                "step": self.state.step,
                "epoch": self.state.epoch,
                "best_metric": self.state.best_metric,
                "best_checkpoint": self.state.best_checkpoint,
                "patience_left": self.state.patience_left,
                "metrics": epoch_metrics,
            }
            save_checkpoint(
                args.output_dir,
                self.state.step,
                self._ckpt_state(),
                meta,
                save_total_limit=args.save_total_limit,
                best_path=self.state.best_checkpoint,
            )
            if stop_early:
                break

        if args.load_best_model_at_end and self.state.best_checkpoint:
            logger.info(f"loading best model from {self.state.best_checkpoint}")
            restored = restore_checkpoint(self.state.best_checkpoint, self._ckpt_state())
            self.trainable = restored["trainable"]
        return self.state


def _read(losses: Dict[str, torch.Tensor]) -> List[float]:
    """The scalar losses as Python floats, in one device-to-host read."""
    return torch.stack([v.detach().float().reshape(()) for v in losses.values()]).tolist()
