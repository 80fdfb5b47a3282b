"""Training orchestrator — the HF-Trainer-equivalent top of the stack.

Reproduces the reference's Trainer surface and behavior
(/root/reference/ViT-Training.py:92-149; pyc L438-L492): ``train()`` with
steps- or epoch-cadenced eval/save/log, best-model tracking and
end-of-training restore, ``evaluate()`` with avg_auroc/f1_micro,
``predict()`` + classification report, ``save_model()`` — but as a single
process driving a device mesh, with exact resume (params + opt state + data
cursor) instead of the reference's per-rank checkpoint dirs.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, Iterator, Optional, Tuple

import jax
import numpy as np

from chestxray_vit_tpu.config import Config
from chestxray_vit_tpu.data import pipeline as pipe
from chestxray_vit_tpu.data.storage import Store
from chestxray_vit_tpu.eval import metrics as M
from chestxray_vit_tpu.models import import_hf, vit
from chestxray_vit_tpu.parallel import distributed as dist
from chestxray_vit_tpu.parallel import mesh as mesh_lib
from chestxray_vit_tpu.train import checkpoint as ckpt
from chestxray_vit_tpu.train import steps as S
from chestxray_vit_tpu.utils.logging import MetricLogger, ThroughputMeter
from chestxray_vit_tpu.utils.profiling import StepProfiler


def merged_floor_hint(history, step, total_steps, tome_r, warmup_steps,
                      *, after_frac=0.6, min_progress=0.02):
    """Measured-guidance check for merged training's bad init mode
    (the quality A/B in BENCH_QUALITY_AB.jsonl, README "Quality"): the
    failure signature is visible MID-RUN — the eval metric is still at
    its starting floor past ~60% of the schedule, while healthy runs
    have taken off by then. Returns a one-line hint when that signature
    is present, else None. Pure function (the trainer emits it at most
    once per run); ``history`` is [(step, avg_auroc), ...] in order.
    Inapplicable (returns None) when training is dense, a dense warmup
    is already configured (the measured rescue), or fewer than two
    evals have landed."""
    if not tome_r or warmup_steps or len(history) < 2:
        return None
    if step < after_frac * max(total_steps, 1):
        return None
    first = history[0][1]
    best = max(v for _, v in history)
    if best - first >= min_progress:
        return None
    return (f"[trainer] merged training is still at its starting metric "
            f"floor past {int(100 * after_frac)}% of the schedule (best "
            f"avg_auroc {best:.3f} vs first eval {first:.3f}) — the "
            f"measured init-sensitivity bad mode (README 'Quality'). "
            f"Restart with train.tome_warmup "
            f"(e.g. 0.375 = 37.5% of total steps) to train dense through "
            f"the takeoff window, then merge.")


class Trainer:
    def __init__(self, cfg: Config, store: Optional[Store] = None,
                 pretrained: bool = True, datasets=None):
        """``datasets`` optionally injects (train, val, test, classes)
        loader adapters directly (any objects satisfying the
        ``iterate_batches`` protocol) — used by the hf_dataset backend and
        tests."""
        self.cfg = cfg
        if datasets is None and cfg.data.backend == "hf_dataset":
            from chestxray_vit_tpu.data.hf_datasets import load_hf_dataset
            datasets = load_hf_dataset(cfg.data.hf_dataset_name,
                                       img_size=cfg.model.img_size,
                                       augment_train=cfg.data.augment)
        if datasets is not None:
            train, val, test, classes = datasets
            self.bundle = pipe.DatasetBundle(
                train=train, val=val, test=test, classes=list(classes),
                blob_map={}, store=store)
            self._adapters = True
        else:
            self.bundle = pipe.build_datasets(cfg.data, store=store)
            self._adapters = False
        # NUM_CLASSES is data-derived, like the reference (pyc L174)
        cfg.model.num_classes = len(self.bundle.classes)

        # the reference's bf16 switch (TrainingArguments bf16=True, pyc
        # L444): off downgrades the compute dtype to f32
        if not cfg.train.bf16 and cfg.model.dtype == "bfloat16":
            cfg.model.dtype = "float32"

        # persistent XLA executable cache: restarts skip first-compile
        from chestxray_vit_tpu.utils.compilation_cache import (
            enable_compilation_cache)
        enable_compilation_cache(cfg.train.compilation_cache_dir)

        self.mesh = mesh_lib.build_mesh(cfg.mesh)
        params = None
        if pretrained:
            params = import_hf.load_pretrained(
                cfg.model.model_name, cfg.model, seed=cfg.train.seed)
        if params is None:
            params = vit.init_params(
                jax.random.key(cfg.train.seed), cfg.model)
        else:
            # @512-style fine-tunes reuse @384 checkpoints: resample the
            # position embeddings to the configured grid (vit.py docstring)
            params = vit.adapt_params_to_img_size(params, cfg.model)
        self.state = S.place_state(
            S.TrainState.create(params, cfg.train.seed), self.mesh)

        # loader batch = micro-batch x accumulation steps (one optimizer
        # update consumes the whole thing inside a single jitted step)
        self.global_batch = (mesh_lib.local_batch_to_global(
            cfg.train.batch_size_per_core, self.mesh)
            * max(cfg.train.gradient_accumulation_steps, 1))
        self.eval_batch = (cfg.train.eval_batch_size
                          * mesh_lib.dp_size(self.mesh))

        self.steps_per_epoch = max(
            len(self.bundle.train) // self.global_batch, 1)
        self.total_steps = (cfg.train.max_steps
                            or int(math.ceil(self.steps_per_epoch
                                             * cfg.train.num_epochs)))

        self._build_steps()

        out_dir = os.path.expanduser(cfg.train.output_dir)
        # multi-host: one logical log — non-primary processes keep their own
        # jsonl (debug) but skip TensorBoard/results (the reference's
        # per-rank output dirs are a known pathology, SURVEY §5)
        self.logger = MetricLogger(
            out_dir,
            cfg.train.report_to if dist.is_primary() else "none",
            jsonl_name=("metrics.jsonl" if dist.is_primary() else
                        f"metrics.rank{jax.process_index()}.jsonl"))
        self.profiler = StepProfiler(out_dir, cfg.train.profile_steps)
        self.ckpt = ckpt.CheckpointManager(
            os.path.join(out_dir, "checkpoints"),
            save_total_limit=cfg.train.save_total_limit,
            metric_for_best=(cfg.train.metric_for_best_model
                             if cfg.train.load_best_model_at_end else None),
            greater_is_better=cfg.train.greater_is_better)
        self._meter = ThroughputMeter()
        # live MFU accounting (utils/flops): useful-math FLOPs per image vs
        # the local device's bf16 peak; None (MFU not logged) on devices
        # the peak table does not know, such as the CPU. Subclasses with
        # different step economics (PackedTrainer) override the first two
        # fields after init.
        from chestxray_vit_tpu.utils import flops as F
        self._images_per_step = self.global_batch
        self._flops_per_image = F.model_flops_per_image(cfg.model)
        self._chip_peak = F.PEAK_BF16_FLOPS.get(jax.devices()[0].device_kind)
        self._n_chips = max(len(jax.devices()), 1)
        self._last_eval_metrics: Dict[str, float] = {}
        self._last_eval_step: int = -1

    def _has_full_batch(self) -> bool:
        """Whether the train split can produce at least one full batch
        (subclass hook — packed batching counts sequences, not samples)."""
        return len(self.bundle.train) >= self.global_batch

    def _build_steps(self) -> None:
        """Compile the train/eval step functions (subclass hook)."""
        self._train_step = S.jit_train_step(
            self._make_step_fn(self.cfg), self.mesh, self.state)
        self._eval_step = S.jit_eval_step(
            S.make_eval_step(self.cfg), self.mesh, self.state.params)
        if self.cfg.train.eval_quantize not in (None, "static", "dynamic"):
            raise ValueError(
                f"train.eval_quantize must be None|'static'|'dynamic', got "
                f"{self.cfg.train.eval_quantize!r}")
        if self.cfg.train.eval_tome_r < 0:
            raise ValueError(
                f"train.eval_tome_r must be >= 0, got "
                f"{self.cfg.train.eval_tome_r}")
        mr = getattr(self.cfg.model, "tome_r", 0)
        if mr and self.cfg.train.eval_tome_r not in (0, mr):
            # a token-merging model's eval already runs the merged forward
            # (vit.apply dispatches on model.tome_r); an accelerated eval
            # at a DIFFERENT r would silently score a different function
            raise ValueError(
                f"train.eval_tome_r={self.cfg.train.eval_tome_r} "
                f"conflicts with model.tome_r={mr} — the model trains "
                f"AND evaluates with its own r; leave eval_tome_r unset "
                f"(or equal) and use eval_quantize to accelerate")
        self._warmup_step = self._build_tome_warmup_step()
        # mid-run floor check (merged_floor_hint): eval-metric history
        # and the emitted-once latch
        self._auroc_history: list = []
        self._floor_hint_done = False

    def _maybe_floor_hint(self, step: int) -> None:
        """Track eval avg_auroc and emit merged_floor_hint's measured
        guidance at most once per run (primary process only — the hint
        is operator guidance, not a per-rank event)."""
        v = (self._last_eval_metrics or {}).get("avg_auroc")
        if v is None or not math.isfinite(float(v)):
            return
        self._auroc_history.append((step, float(v)))
        if self._floor_hint_done or not dist.is_primary():
            return
        hint = merged_floor_hint(
            self._auroc_history, step, self.total_steps,
            getattr(self.cfg.model, "tome_r", 0), self._tome_warmup_steps)
        if hint:
            self._floor_hint_done = True
            print(hint)

    def _build_tome_warmup_step(self):
        """Dense-warmup step for token-merged training (train.tome_warmup):
        the same train step with model.tome_r=0 — steps 1..tome_warmup run
        it, later steps run the merged step. Params/optimizer/LR are
        continuous across the switch (merging is parameter-free; the LR
        schedule is built over the shared total_steps). Measured rescue of
        merged training's init-sensitivity (README "Quality"; bad-mode
        init 0.821 -> 0.977 avg_auroc).

        Resolves ``self._tome_warmup_steps``: values >= 1 are absolute
        steps; a fraction in (0, 1) means that fraction of total_steps
        (so presets can ship the recipe without knowing the schedule
        length)."""
        tw = self.cfg.train.tome_warmup
        if tw < 0:
            raise ValueError(f"train.tome_warmup must be >= 0, got {tw}")
        if tw >= 1 and tw != int(tw):
            raise ValueError(
                f"train.tome_warmup must be an integer step count (>= 1) "
                f"or a fraction of total steps in (0, 1), got {tw}")
        self._tome_warmup_steps = (max(1, int(round(tw * self.total_steps)))
                                   if 0 < tw < 1 else int(tw))
        if not tw:
            return None
        if not getattr(self.cfg.model, "tome_r", 0):
            raise ValueError(
                "train.tome_warmup requires model.tome_r > 0 — it is the "
                "dense-warmup phase OF token-merged training (unset one)")
        import dataclasses
        dense_cfg = dataclasses.replace(
            self.cfg,
            model=dataclasses.replace(self.cfg.model, tome_r=0))
        return S.jit_train_step(
            self._make_step_fn(dense_cfg), self.mesh, self.state)

    def _make_step_fn(self, cfg):
        """Unjitted train-step factory (subclass hook — PackedTrainer
        builds the packed step so tome_warmup composes there too)."""
        return S.make_train_step(cfg, self.total_steps)

    def _inference_eval(self, placed):
        """Lazily build the accelerated eval path from the CURRENT params
        (beyond the reference): int8 (`eval_quantize`) and/or token merging
        (`eval_tome_r`). For 'static', per-site activation scales are
        calibrated ONCE per params version (keyed on state.step) on the
        first batch offered — repeated evaluate()/predict() calls at the
        same step reuse the same scales AND the same int8 tree, so
        quantized eval metrics (incl. best-model selection) cannot drift
        with eval-batch ordering; a new optimizer step
        invalidates the cache so mid-training evals track live params."""
        from chestxray_vit_tpu.models.quantized import (
            calibrate_vit_scales,
            quantize_vit_params,
        )
        from chestxray_vit_tpu.ops.preprocess import prepare_pixel_values

        quantize = self.cfg.train.eval_quantize
        # a token-merging model (model.tome_r) evals MERGED: the
        # accelerated step inherits its r, so eval_quantize scores the
        # same function the model trains (mismatched r rejected at build)
        eval_r = (self.cfg.train.eval_tome_r
                  or getattr(self.cfg.model, "tome_r", 0))
        key = (bool(quantize), eval_r)
        if getattr(self, "_inference_eval_key", None) != key:
            # built ONCE per knob setting: the jitted programs don't
            # depend on the per-call scales (they ride inside qparams /
            # as traced args), so rebuilding closures per evaluate()
            # would only defeat jit's identity cache and re-trace every
            # cadence eval
            cfg = self.cfg
            self._inference_eval_key = key
            self._inference_eval_fns = {
                "prepare": jax.jit(lambda b: prepare_pixel_values(
                    b, out_size=cfg.model.img_size,
                    mean=cfg.data.image_mean, std=cfg.data.image_std)),
                "quantize": jax.jit(
                    quantize_vit_params,
                    out_shardings=S.replicated(self.mesh)),
                "step": S.jit_quantized_eval_step(
                    S.make_inference_eval_step(
                        cfg, quantized=bool(quantize),
                        tome_r=eval_r), self.mesh),
            }
        fns = self._inference_eval_fns
        if not quantize:
            return self.state.params, fns["step"]
        ck = (int(self.state.step), quantize, eval_r)
        cached = getattr(self, "_qeval_cache", None)
        if cached is not None and cached[0] == ck:
            return cached[1], fns["step"]
        scales = None
        if quantize == "static":
            scales = calibrate_vit_scales(
                self.state.params, fns["prepare"](placed), self.cfg.model)
        qparams = fns["quantize"](self.state.params, scales)
        self._qeval_cache = (ck, qparams)
        return qparams, fns["step"]

    # ------------------------------------------------------------------
    # data plumbing
    # ------------------------------------------------------------------

    def _loader(self, index, augment: bool):
        if self._adapters:
            return index          # adapter already implements the protocol
        return pipe.SampleLoader(
            index, self.bundle.blob_map, self.bundle.store,
            img_size=self.cfg.model.img_size,
            placement=self.cfg.data.preprocess_placement,
            canvas_size=self.cfg.data.decode_canvas,
            augment=augment and self.cfg.data.augment,
            prefer_native_decode=True)

    def _train_batches(self, epoch: int, skip: int = 0
                       ) -> Iterator[Dict[str, jax.Array]]:
        it = pipe.iterate_batches(
            self._loader(self.bundle.train, augment=True),
            self.global_batch, epoch=epoch, shuffle=True,
            seed=self.cfg.data.shuffle_buffer_seed,
            num_workers=self.cfg.data.num_workers,
            prefetch_batches=self.cfg.data.prefetch_depth,
            drop_last=True,
            skip_batches=skip,   # resume skips before any fetch/decode
            # multi-host: this process decodes only its shard of each
            # global batch; form_global_batch assembles the global array
            host_range=dist.host_batch_slice(self.global_batch))
        for batch in it:
            yield dist.form_global_batch(self.mesh, batch)

    # ------------------------------------------------------------------
    # train
    # ------------------------------------------------------------------

    def request_stop(self) -> None:
        """Ask the train loop to checkpoint and exit after the current step
        (called by the SIGTERM/SIGINT handler on preemption; safe to call
        from any thread)."""
        self._stop_requested = True

    def _install_preemption_handler(self):
        """SIGTERM/SIGINT → one final checkpoint, clean exit (only from the
        main thread; returns a restore callback)."""
        import signal
        import threading
        if (not self.cfg.train.save_on_preemption
                or threading.current_thread() is not threading.main_thread()):
            return lambda: None
        previous = {}

        def on_signal(signum, frame):
            print(f"[trainer] signal {signum}: checkpointing before exit")
            self.request_stop()

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, on_signal)
            except (ValueError, OSError):              # non-main ctx, etc.
                pass

        def restore():
            for sig, handler in previous.items():
                signal.signal(sig, handler)

        return restore

    def train(self) -> Dict[str, float]:
        cfg = self.cfg.train
        self._stop_requested = False
        restore_handlers = self._install_preemption_handler()
        try:
            return self._train_inner(cfg)
        finally:
            # restore on ALL exits — a crashed run must not leave SIGINT/
            # SIGTERM pointing at a dead trainer's stop flag for the rest
            # of the process
            restore_handlers()

    def _train_inner(self, cfg) -> Dict[str, float]:
        cursor = ckpt.DataCursor()
        if cfg.resume_from_checkpoint:
            step = (None if cfg.resume_from_checkpoint == "auto"
                    else int(cfg.resume_from_checkpoint))
            self.state, cursor, _ = self.ckpt.restore(step, self.state)
            # subclasses with richer cursors (packed multi-host stores
            # per-process image counts) read the full object from here
            self._restored_cursor = cursor
            print(f"[trainer] resumed at step {int(self.state.step)} "
                  f"(epoch {cursor.epoch}, batch {cursor.batch_in_epoch})")

        if not self._has_full_batch():
            raise ValueError(
                f"train split ({len(self.bundle.train)} samples) yields zero "
                f"full batches at global batch {self.global_batch}; shrink "
                f"the batch size or mesh, or raise use_subset_data")

        t_start = time.perf_counter()
        step = int(self.state.step)
        start_step = step            # for this-run throughput accounting
        epoch = cursor.epoch
        done = False
        while not done and step < self.total_steps:
            skip = cursor.batch_in_epoch if epoch == cursor.epoch else 0
            prefetch = pipe.DevicePrefetcher(
                self._train_batches(epoch, skip), place_fn=lambda b: b,
                depth=self.cfg.data.prefetch_depth)
            batch_idx = skip
            step_at_epoch_start = step
            # Shallow async pipelining: let up to 16 steps be in flight,
            # then sync on a scalar fetch — unbounded queues hide errors
            # (the NaN guard reads the loss at these syncs).
            sync_every = max(1, min(16, cfg.logging_steps or 16))
            unmetered_steps = 0
            epoch_exhausted = True
            # try/finally: EVERY exit from the batch loop — normal epoch
            # end, break (max_steps/preemption), or a raising train step
            # (OOM, NaN guard) — must release the producer thread and its
            # queued device batches, or in-process reuse (tests,
            # serve-after-train, notebooks) leaks a thread blocked in put()
            try:
                for batch in prefetch:
                    self.profiler.maybe_start(step)
                    # dense-warmup dispatch (train.tome_warmup): absolute
                    # step index (fractions were resolved against
                    # total_steps at construction), so checkpoint resume
                    # lands in the right phase automatically
                    step_fn = (self._warmup_step
                               if self._warmup_step is not None
                               and step < self._tome_warmup_steps
                               else self._train_step)
                    self.state, metrics = step_fn(self.state, batch)
                    step += 1
                    batch_idx += 1
                    unmetered_steps += 1
                    if (step % sync_every == 0
                            or self.profiler.in_window(step)):
                        # scalar fetch = device completion barrier; always
                        # per-step while profiling so stop_trace sees work
                        loss_val = float(metrics["loss"])
                        if (cfg.nan_guard == "raise"
                                and not math.isfinite(loss_val)):
                            # divergence guard: fail at the sync point it
                            # becomes visible, not epochs later — the last
                            # good checkpoint is the recovery path
                            raise FloatingPointError(
                                f"non-finite loss ({loss_val}) at step "
                                f"{step}; training diverged — resume from "
                                f"the last checkpoint with a lower lr or "
                                f"stronger clipping "
                                f"(set train.nan_guard=off to disable)")
                        self._meter.step(
                            self._images_per_step * unmetered_steps)
                        unmetered_steps = 0
                    self.profiler.maybe_stop(step)

                    if cfg.logging_steps and step % cfg.logging_steps == 0:
                        ips = self._meter.images_per_sec
                        record = {
                            "loss": float(metrics["loss"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "lr": float(metrics["lr"]),
                            "epoch": epoch + self._epoch_progress(batch_idx),
                            "images_per_sec": ips,
                        }
                        if self._chip_peak is not None:
                            record["mfu"] = (ips / self._n_chips
                                             * self._flops_per_image
                                             / self._chip_peak)
                        self.logger.log(step, record,
                                        progress=self._progress_text(step,
                                                                     ips))
                    if (cfg.eval_strategy == "steps" and cfg.eval_steps
                            and step % cfg.eval_steps == 0):
                        self._last_eval_metrics = self.evaluate()
                        self._last_eval_step = step
                        self.logger.log(step, self._last_eval_metrics,
                                        "eval")
                        self._maybe_floor_hint(step)
                        # don't bill the eval pause to the next window
                        self._meter.reset()
                    if (cfg.save_strategy == "steps" and cfg.save_steps
                            and step % cfg.save_steps == 0):
                        self._save(step, epoch, batch_idx)
                    if step >= self.total_steps:
                        done = True
                        epoch_exhausted = False
                        break
                    # multi-host: saves are collective, so the stop
                    # decision must be agreed — a signal lands on hosts at
                    # different steps; vote on the sync cadence (bounded
                    # ≤sync_every steps of preemption latency) so every
                    # process checkpoints at the SAME step
                    stop = self._stop_requested
                    if jax.process_count() > 1:
                        stop = (step % sync_every == 0
                                and dist.agree_flag(self._stop_requested))
                    if stop:
                        # preemption: persist the exact cursor so
                        # resume_from_checkpoint=auto continues mid-epoch
                        self._save(step, epoch, batch_idx)
                        print(f"[trainer] stop requested: checkpointed at "
                              f"step {step} (epoch {epoch}, "
                              f"batch {batch_idx})")
                        done = True
                        epoch_exhausted = False
                        break
            finally:
                prefetch.close()
            if epoch_exhausted:
                if step == step_at_epoch_start and skip == 0:
                    raise ValueError(
                        "an epoch produced zero training batches — batch "
                        "configuration cannot be satisfied by the dataset")
                epoch += 1
                if cfg.eval_strategy == "epoch":
                    self._last_eval_metrics = self.evaluate()
                    self._last_eval_step = step
                    self.logger.log(step, self._last_eval_metrics, "eval")
                    self._maybe_floor_hint(step)
                    self._meter.reset()
                if cfg.save_strategy == "epoch":
                    self._save(step, epoch, 0)
                if epoch >= cfg.num_epochs and cfg.max_steps is None:
                    done = True

        self.profiler.stop_if_active()
        self.ckpt.wait()

        if cfg.load_best_model_at_end and self.ckpt.all_steps():
            best = self.ckpt.best_step() or self.ckpt.latest_step()
            self.state, _, _ = self.ckpt.restore(best, self.state)
            print(f"[trainer] loaded best checkpoint (step {best})")

        elapsed = time.perf_counter() - t_start
        train_metrics = {
            "train_runtime": elapsed,
            "train_steps": step,
            # rate over the steps THIS run trained — after a resume, the
            # absolute step count includes work a previous run paid for
            "train_samples_per_second":
                (step - start_step) * self._images_per_step
                / max(elapsed, 1e-9),
        }
        self.logger.save_results("train", train_metrics)
        return train_metrics

    def _progress_text(self, step: int, images_per_sec: float) -> str:
        """``step/total (pct%, eta)`` — the tqdm-style progress the
        reference gets from HF Trainer (pyc L44), on the logging cadence."""
        pct = 100.0 * step / max(self.total_steps, 1)
        remaining = max(self.total_steps - step, 0)
        if images_per_sec > 0:
            secs = remaining * self._images_per_step / images_per_sec
            eta = (f"{secs / 3600:.1f}h" if secs >= 3600 else
                   f"{secs / 60:.1f}m" if secs >= 60 else f"{secs:.0f}s")
        else:
            eta = "?"
        return f"{step}/{self.total_steps} ({pct:.1f}%, eta {eta})"

    def _epoch_progress(self, batch_idx: int) -> float:
        """Fraction of the current epoch consumed (subclass hook — the
        packed path's batch_idx mixes an image-count resume offset)."""
        return batch_idx / self.steps_per_epoch

    def _save(self, step: int, epoch: int, batch_idx: int) -> None:
        # only attach eval metrics measured at THIS step — best-checkpoint
        # selection must not rank weights by another step's metric
        metrics = (self._last_eval_metrics
                   if getattr(self, "_last_eval_step", -1) == step else None)
        self.ckpt.save(step, self.state,
                       cursor=ckpt.DataCursor(epoch, batch_idx),
                       metrics=metrics)

    # ------------------------------------------------------------------
    # eval / predict
    # ------------------------------------------------------------------

    def _forward_all(self, index) -> Tuple[np.ndarray, np.ndarray, float]:
        """Run the eval loop over a DatasetIndex; returns (logits, labels,
        mean BCE loss) with padding sliced off — the Trainer's logit
        gather (SURVEY §3.4)."""
        loader = self._loader(index, augment=False)
        if len(index) == 0:
            # degenerate subsets (e.g. use_subset_data < 5 → val N//5 == 0):
            # empty predictions, metrics fall out as 0.0 / NaN-free
            c = self.cfg.model.num_classes
            print("[trainer] warning: evaluating an empty dataset")
            return (np.zeros((0, c), np.float32),
                    np.zeros((0, c), np.float32), 0.0)
        logits_all, labels_all = [], []
        total_elem_loss, total_n = 0.0, 0
        qparams = qstep = None
        for batch in pipe.iterate_batches(
                loader, self.eval_batch,
                num_workers=self.cfg.data.num_workers,
                prefetch_batches=self.cfg.data.prefetch_depth,
                pad_last=True,
                host_range=dist.host_batch_slice(self.eval_batch)):
            n_valid = int(batch.pop("num_valid"))     # global valid count
            placed = dist.form_global_batch(self.mesh, batch)
            if qstep is None and (self.cfg.train.eval_quantize
                                  or self.cfg.train.eval_tome_r):
                qparams, qstep = self._inference_eval(placed)
            # ONE compiled program per batch: logits + per-row BCE element
            # sums ride the same dispatch (not a second jitted call over
            # re-staged host logits)
            logits_dev, row_loss_dev = (
                qstep(qparams, placed) if qstep is not None
                else self._eval_step(self.state.params, placed))
            logits = dist.gather_global_rows(self.mesh, logits_dev)[:n_valid]
            row_loss = dist.gather_global_rows(
                self.mesh, row_loss_dev)[:n_valid]
            labels = dist.allgather_host_rows(batch["labels"])[:n_valid]
            total_elem_loss += float(np.sum(row_loss))
            total_n += n_valid
            logits_all.append(logits)
            labels_all.append(labels)
        c = max(self.cfg.model.num_classes, 1)
        return (np.concatenate(logits_all), np.concatenate(labels_all),
                total_elem_loss / max(total_n * c, 1))

    def evaluate(self, index=None) -> Dict[str, float]:
        """avg_auroc (+ per-class) and f1_micro over the val set — the union
        of both reference compute_metrics surfaces (pyc L320-L355;
        ViT-Training.py:112-118)."""
        index = index if index is not None else self.bundle.val
        logits, labels, loss = self._forward_all(index)
        out = M.compute_metrics(logits, labels, self.bundle.classes)
        out["eval_loss"] = loss
        return out

    def predict(self, index=None, report_path: Optional[str] = None,
                calibrate: bool = False
                ) -> Tuple[np.ndarray, np.ndarray, Dict[str, float]]:
        """Version A's final test pass (ViT-Training.py:135-149): predict on
        test, optional classification report written to disk.

        ``calibrate=True`` fits per-class decision thresholds on the
        VALIDATION split (max per-class F1) and applies them to the test
        report — beyond the reference's fixed 0.5, which is usually far
        from optimal on imbalanced multi-label targets. Calibration never
        touches the test labels."""
        index = index if index is not None else self.bundle.test
        logits, labels, loss = self._forward_all(index)
        metrics = M.compute_metrics(logits, labels, self.bundle.classes)
        metrics["test_loss"] = loss
        threshold: "float | np.ndarray" = 0.5
        if calibrate:
            val_logits, val_labels, _ = self._forward_all(self.bundle.val)
            threshold = M.calibrate_thresholds(val_logits, val_labels)
            metrics["f1_micro_calibrated"] = M.f1_micro_at(
                logits, labels, threshold)
        if report_path:
            text = M.write_classification_report(
                os.path.expanduser(report_path), logits,
                labels.astype(np.int64), self.bundle.classes, threshold)
            print(text)
        return logits, labels, metrics

    # ------------------------------------------------------------------

    def save_model(self, directory: Optional[str] = None) -> None:
        directory = directory or os.path.join(
            os.path.expanduser(self.cfg.train.output_dir), "model")
        ckpt.save_model(directory, self.state.params, self.cfg.to_json(),
                        self.bundle.classes)
        # reference parity: Trainer(tokenizer=processor).save_model() also
        # writes preprocessor_config.json (pyc L465-L472), so the output
        # dir is HF-loadable including preprocessing
        from chestxray_vit_tpu.models.export_hf import (
            write_preprocessor_config)
        write_preprocessor_config(directory, self.cfg.model.img_size,
                                  self.cfg.data.image_mean,
                                  self.cfg.data.image_std)
        print(f"[trainer] model saved to {directory}")

    def save_state(self, path: Optional[str] = None) -> str:
        """``trainer.save_state()`` parity (pyc L485): write
        ``trainer_state.json`` — global step, epoch, best metric/step, and
        the log history replayed from metrics.jsonl — in HF's shape, so
        downstream tooling that reads Trainer state keeps working.

        Primary-rank only on multi-host runs (HF writes one state file):
        non-primary ranks log to metrics.rank{N}.jsonl, and concurrent
        writes to the shared trainer_state.json could interleave."""
        import json
        out_dir = os.path.expanduser(self.cfg.train.output_dir)
        path = path or os.path.join(out_dir, "trainer_state.json")
        if not dist.is_primary():
            return path
        history = []
        jsonl = os.path.join(self.logger.output_dir, "metrics.jsonl")
        if os.path.exists(jsonl):
            with open(jsonl) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    prefix = rec.pop("prefix", "train")
                    step = rec.pop("step", 0)
                    if prefix == "eval":
                        rec = {f"eval_{k}" if not k.startswith("eval_")
                               else k: v for k, v in rec.items()}
                    history.append({"step": step, **rec})
        best_step = self.ckpt.best_step()
        # eval records carry HF-style eval_ prefixes in the history
        keys = (f"eval_{self.cfg.train.metric_for_best_model}",
                self.cfg.train.metric_for_best_model)
        best_metric = None
        if best_step is not None:
            for rec in reversed(history):
                if rec["step"] != best_step:
                    continue
                for k in keys:
                    if k in rec:
                        best_metric = rec[k]
                        break
                if best_metric is not None:
                    break
        state = {
            "global_step": int(self.state.step),
            "max_steps": self.total_steps,
            "num_train_epochs": self.cfg.train.num_epochs,
            "logging_steps": self.cfg.train.logging_steps,
            "eval_steps": self.cfg.train.eval_steps,
            "save_steps": self.cfg.train.save_steps,
            "best_metric": best_metric,
            "best_model_checkpoint": (
                os.path.join(self.ckpt.directory, str(best_step))
                if best_step is not None else None),
            "log_history": history,
        }
        with open(path, "w") as f:
            json.dump(state, f, indent=2)
        return path

    def close(self) -> None:
        self.ckpt.close()
        self.logger.close()
