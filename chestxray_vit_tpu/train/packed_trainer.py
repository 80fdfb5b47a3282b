"""Packed variable-resolution trainer.

Subclasses :class:`Trainer` to train over NaViT-style packed sequences:
several variable-resolution images share each ``seq_len``-token sequence,
isolated by segment-masked flash attention; evaluation packs too (a
packed-trained model has no trained CLS token — per-image masked mean
pooling is its readout in both phases).

Notes:
- mid-epoch resume is EXACT and skips before I/O: emitted packed batches
  always cover a prefix of the epoch order, so the checkpoint cursor stores
  the cumulative image count and resume re-packs the remaining stream
  bit-identically without re-fetching/re-decoding trained images.
- steps/epoch comes from a sampled token census driven through the real
  next-fit packer (exact for uniform-resolution data like NIH 1024²), not
  a heuristic bound — the lr schedule and epoch cadence use true steps.
- the global batch is ``batch_seqs × gradient_accumulation_steps``
  sequences per optimizer step (HF TrainingArguments semantics: accum
  multiplies the effective batch), sharded on the data axis; ``batch_seqs``
  must be divisible by the data-parallel world size and by the host count.
- multi-host: each process deterministically shards the epoch image stream
  BEFORE packing (``order[rank::num_hosts]``), packs its shard into
  ``batch_seqs / num_hosts`` sequences per micro-batch, and contributes its
  slice of the global batch (``form_global_batch``). Epochs are capped at
  the census-agreed ``steps_per_epoch`` on every host so collectives never
  diverge; the checkpoint cursor stores per-host consumed-image counts
  (pack boundaries are content-dependent, so hosts consume unequal image
  counts per step) and each process resumes from its own entry.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import jax
import numpy as np

from chestxray_vit_tpu.config import Config
from chestxray_vit_tpu.data import packing as pk
from chestxray_vit_tpu.models import packed as packed_model
from chestxray_vit_tpu.parallel import distributed as dist
from chestxray_vit_tpu.parallel import mesh as mesh_lib
from chestxray_vit_tpu.train import checkpoint as ckpt
from chestxray_vit_tpu.train import steps as S
from chestxray_vit_tpu.train.trainer import Trainer


class PackedTrainer(Trainer):
    def __init__(self, cfg: Config, *, seq_len: int = 1152,
                 grids: Tuple[int, ...] = (16, 24, 32),
                 batch_seqs: int = 8, census_sample: int = 128, **kw):
        self.seq_len = seq_len
        self.grids = tuple(grids)
        self.batch_seqs = batch_seqs
        self._images_cum = [0]     # cumulative images after k consumed batches
        self._resume_skip = 0
        self._local_skip = 0
        super().__init__(cfg, **kw)
        self._hosts = jax.process_count()
        if batch_seqs % max(self._hosts, 1):
            raise ValueError(f"batch_seqs={batch_seqs} not divisible by "
                             f"host count {self._hosts}")
        dp = mesh_lib.dp_size(self.mesh)
        if batch_seqs % dp:
            raise ValueError(f"batch_seqs={batch_seqs} not divisible by "
                             f"data-parallel world size {dp}")
        self._accum = max(cfg.train.gradient_accumulation_steps, 1)
        # sequences one process loads per optimizer step (micro × accum)
        self._local_step_seqs = (batch_seqs // self._hosts) * self._accum
        # measured epoch accounting: sampled token census through the real
        # next-fit packer (replaces the old min_tokens*4 guess)
        cap = self.seq_len // min(g * g for g in self.grids)
        counts = pk.sample_token_counts(
            self.bundle.train, self.bundle.blob_map, self.bundle.store,
            patch=cfg.model.patch_size, grids=self.grids,
            sample=census_sample, num_workers=cfg.data.num_workers)
        # the SMALLEST host shard bounds the agreed epoch length (strided
        # shards differ by at most one image)
        n_local_min = len(self.bundle.train) // max(self._hosts, 1)
        total_seqs_local = pk.estimate_sequences_per_epoch(
            counts, n_local_min, self.seq_len, cap)
        # tail batch is dropped in training (static shapes, drop_last parity)
        self.steps_per_epoch = max(
            total_seqs_local // self._local_step_seqs, 1)
        # the base __init__ derived total_steps (the lr-schedule horizon)
        # from dense sample counting; re-derive from true packed steps and
        # re-jit so the schedule decays over real steps
        import math
        new_total = (cfg.train.max_steps
                     or int(math.ceil(self.steps_per_epoch
                                      * cfg.train.num_epochs)))
        if new_total != self.total_steps:
            self.total_steps = new_total
            self._build_steps()
        # throughput/MFU accounting in packed units: a step consumes
        # ~len(train)/steps_per_epoch images (not the dense global batch)
        # and costs batch_seqs × accum sequences of seq_len tokens
        from chestxray_vit_tpu.utils import flops as F
        self._images_per_step = max(
            len(self.bundle.train) // self.steps_per_epoch, 1)
        self._flops_per_image = (
            F.packed_flops_per_sequence(cfg.model, self.seq_len)
            * self.batch_seqs * self._accum / self._images_per_step)

    def _has_full_batch(self) -> bool:
        return len(self.bundle.train) > 0

    def _build_steps(self) -> None:
        # fail fast, not silently half-honor (the round-2 accum lesson):
        # the accelerated eval knobs run through make_inference_eval_step
        # (a DENSE CLS-readout forward) — a packed-trained model evaluates
        # through the packed masked-mean pipeline, which has no int8/ToMe
        # variant. Rejecting at construction beats an eval that quietly
        # reports bf16 dense numbers for config the user thinks is active.
        if self.cfg.train.eval_quantize or self.cfg.train.eval_tome_r:
            raise ValueError(
                "train.eval_quantize / train.eval_tome_r do not compose "
                "with PackedTrainer (its eval packs sequences and reads "
                "out a masked mean, not the dense CLS forward those knobs "
                "accelerate) — unset them or use the dense Trainer")
        self._train_step = S.jit_train_step(
            self._make_step_fn(self.cfg), self.mesh, self.state)
        self._eval_step = None  # packed eval path below
        # dense-warmup (train.tome_warmup) composes: the base helper
        # builds the same packed step with tome_r=0 via _make_step_fn
        self._warmup_step = self._build_tome_warmup_step()

    def _make_step_fn(self, cfg):
        return S.make_packed_train_step(cfg, self.total_steps, self.grids)

    # ------------------------------------------------------------------

    def _packed_iter(self, index, epoch: int, *, batch_seqs: int,
                     skip_images: int = 0, host_shard=None, shuffle=True
                     ) -> Iterator[Dict[str, np.ndarray]]:
        return pk.iterate_packed_batches(
            index, self.bundle.blob_map, self.bundle.store,
            batch_seqs=batch_seqs,
            patch=self.cfg.model.patch_size,
            seq_len=self.seq_len, grids=self.grids,
            epoch=epoch, shuffle=shuffle,
            seed=self.cfg.data.shuffle_buffer_seed,
            num_workers=self.cfg.data.num_workers,
            skip_images=skip_images,
            host_shard=host_shard)

    def _train_batches(self, epoch: int, skip: int = 0):
        """``skip`` counts IMAGES (not batches): emitted packed batches
        cover a prefix of the epoch order, so skipping the prefix before
        any fetch/decode and re-packing the remainder reproduces the
        uninterrupted run's batches exactly (see iterate_packed_batches).
        Multi-host, ``skip`` is the GLOBAL image count from the cursor and
        this process skips its own ``per_host`` entry of the local shard."""
        hosts, rank = self._hosts, jax.process_index()
        if hosts > 1:
            local_skip = 0
            if skip:
                rc = getattr(self, "_restored_cursor", None)
                if rc is None or rc.per_host is None:
                    raise ValueError(
                        "multi-host packed resume needs a cursor with "
                        "per-host image counts; this checkpoint carries "
                        "none (was it written by a single-host run?)")
                if len(rc.per_host) != hosts:
                    # a different host count reshapes every shard
                    # (order[rank::H]); silently reusing counts would
                    # train some images twice and skip others
                    raise ValueError(
                        f"checkpoint cursor was written by "
                        f"{len(rc.per_host)} hosts but this run has "
                        f"{hosts}; mid-epoch packed resume cannot change "
                        f"the host count (resume from an epoch boundary "
                        f"or restore the original topology)")
                local_skip = int(rc.per_host[rank])
        else:
            rc = getattr(self, "_restored_cursor", None)
            if (skip and rc is not None and rc.per_host is not None
                    and len(rc.per_host) != 1):
                # a multi-host packed checkpoint consumed interleaved
                # shards (order[rank::H]); a single-host resume's prefix
                # skip of the UNSHARDED order would train some images
                # twice and never see others — same guard as the
                # hosts>1 topology check above
                raise ValueError(
                    f"checkpoint cursor was written by "
                    f"{len(rc.per_host)} hosts but this run has 1; "
                    f"mid-epoch packed resume cannot change the host "
                    f"count (resume from an epoch boundary or restore "
                    f"the original topology)")
            local_skip = skip
        # cumulative image counts are appended at PRODUCE time (this
        # generator runs inside DevicePrefetcher's background thread, up to
        # depth batches ahead of training) but indexed at CONSUME time in
        # _save via the train loop's batch_idx — a checkpoint cursor must
        # count images actually trained, not images sitting in the prefetch
        # queue, or resume would silently skip never-trained data
        self._resume_skip = skip       # what the base loop's batch_idx seeds
        self._local_skip = local_skip
        self._images_cum = cum = [local_skip]
        # multi-host epochs are capped at the census-agreed length so every
        # process issues the same number of collective steps; with exactly
        # steps_per_epoch batches per epoch, the batches already consumed
        # this epoch fall out of the global step counter
        remaining = None
        if hosts > 1:
            done = max(int(self.state.step) - epoch * self.steps_per_epoch,
                       0)
            remaining = self.steps_per_epoch - done
            if remaining <= 0:
                return
        emitted = 0
        for batch in self._packed_iter(
                self.bundle.train, epoch,
                batch_seqs=self._local_step_seqs,
                skip_images=local_skip,
                host_shard=(rank, hosts) if hosts > 1 else None):
            n_seqs = int(batch.pop("n_seqs"))
            n_images = int(batch.pop("n_images"))
            if n_seqs < self._local_step_seqs:
                continue   # drop the zero-padded tail batch (drop_last)
            cum.append(cum[-1] + n_images)
            yield dist.form_global_batch(self.mesh, batch)
            emitted += 1
            if remaining is not None and emitted >= remaining:
                return
        if remaining is not None and emitted < remaining:
            # fewer batches than the agreed epoch length would leave other
            # hosts blocked in a collective — fail loudly on this one
            raise RuntimeError(
                f"host {rank} packed only {emitted}/{remaining} batches "
                f"this epoch; the token census over-estimated "
                f"steps_per_epoch for this shard (raise census_sample or "
                f"lower batch_seqs)")

    def _epoch_progress(self, batch_idx: int) -> float:
        """Images this host consumed / images in its shard (the base hook
        divides batch_idx by steps_per_epoch, but packed batch_idx carries
        an image-count resume offset — mixing the units made resumed runs
        log epoch fractions in the tens)."""
        consumed = batch_idx - self._resume_skip
        if not 0 <= consumed < len(self._images_cum):
            return 0.0
        shard = max(len(self.bundle.train) // max(self._hosts, 1), 1)
        return self._images_cum[consumed] / shard

    def _save(self, step: int, epoch: int, batch_idx: int) -> None:
        # the packed cursor stores images consumed, not batch count; the
        # base loop's batch_idx = resume skip (an IMAGE count here) + the
        # number of batches consumed so far this epoch
        metrics = (self._last_eval_metrics
                   if getattr(self, "_last_eval_step", -1) == step else None)
        consumed = batch_idx - self._resume_skip
        if batch_idx == 0:
            # epoch-boundary save: a NEW epoch starts from image 0 — the
            # resume offset belongs to the epoch that just finished and
            # must not leak into the fresh cursor (it would make a later
            # resume skip never-trained data)
            images = 0
        elif consumed <= 0:
            images = self._local_skip       # resumed, nothing consumed yet
        else:
            images = self._images_cum[consumed]
        if self._hosts > 1:
            vec = dist.allgather_host_rows(
                np.asarray([images], np.int64)).reshape(-1)
            cursor = ckpt.DataCursor(epoch, int(vec.sum()),
                                     per_host=[int(v) for v in vec])
        else:
            cursor = ckpt.DataCursor(epoch, images)
        self.ckpt.save(step, self.state, cursor=cursor, metrics=metrics)

    # ------------------------------------------------------------------

    def _eval_params(self):
        """Params for the host-local packed eval jit. Single-process: the
        live global tree. Multi-host: global arrays can't feed a host-local
        jit, so take each leaf's addressable replica — valid only when
        params are fully replicated (pure data parallelism, the packed
        trainer's supported layout); fsdp/tensor-sharded params would need
        a cross-host gather and fail loudly here instead of crashing
        inside jax with an opaque non-addressable error."""
        if self._hosts == 1:
            return self.state.params

        # cache per training step: cadence evals call evaluate() then
        # predict() (or eval both splits) on the SAME params — without
        # this, every call re-round-trips the full tree host↔device
        step = int(self.state.step)
        cached = getattr(self, "_eval_params_cache", None)
        if cached is not None and cached[0] == step:
            return cached[1]

        def local(x):
            if getattr(x, "is_fully_replicated", True):
                return jax.device_put(np.asarray(x.addressable_data(0)),
                                      jax.local_devices()[0])
            raise NotImplementedError(
                "multi-host packed eval needs fully-replicated params "
                "(data-parallel mesh); fsdp/tensor-sharded packed eval "
                "is not supported")
        tree = jax.tree.map(local, self.state.params)
        self._eval_params_cache = (step, tree)
        return tree

    def _forward_all(self, index):
        """Packed eval: logits per image via masked mean pooling. Every
        process evaluates the full index (host-local jit on its local
        replica of the params, no collectives — duplicated work
        multi-host, but identical results everywhere, so metric-driven
        decisions never diverge)."""
        if len(index) == 0:
            c = self.cfg.model.num_classes
            return (np.zeros((0, c), np.float32),
                    np.zeros((0, c), np.float32), 0.0)

        if not hasattr(self, "_packed_fwd"):
            # model.tome_r merges at eval too (the dense Trainer's
            # contract: the knob changes the model's forward, train AND
            # eval, so best-model tracking sees the numbers the deployed
            # merged forward will produce)
            fwd_fn = (packed_model.apply_packed_tome
                      if self.cfg.model.tome_r > 0
                      else packed_model.apply_packed)
            self._packed_fwd = jax.jit(
                lambda params, t, s, p, w: fwd_fn(
                    params, t, s, p, w, self.cfg.model, self.grids))
        fwd = self._packed_fwd
        eval_params = self._eval_params()

        logits_all, labels_all = [], []
        total_loss, total_n = 0.0, 0
        for batch in self._packed_iter(index, 0,
                                       batch_seqs=self.batch_seqs,
                                       shuffle=False):
            # batches are always batch_seqs sequences (the generator
            # zero-pads the tail; padded seqs carry image_mask=False, so
            # they drop out of logits/labels/loss below)
            batch.pop("n_seqs")
            batch.pop("n_images")
            logits = np.asarray(fwd(
                eval_params,
                jax.numpy.asarray(batch["tokens"]),
                jax.numpy.asarray(batch["segment_ids"]),
                jax.numpy.asarray(batch["pos_indices"]),
                jax.numpy.asarray(batch["pool_weights"])))
            mask = batch["image_mask"]
            got = logits[mask]
            labs = batch["labels"][mask]
            loss = float(packed_model.packed_bce_loss(
                jax.numpy.asarray(logits),
                jax.numpy.asarray(batch["labels"]),
                jax.numpy.asarray(mask)))
            total_loss += loss * got.shape[0]
            total_n += got.shape[0]
            logits_all.append(got)
            labels_all.append(labs)
        return (np.concatenate(logits_all), np.concatenate(labels_all),
                total_loss / max(total_n, 1))
