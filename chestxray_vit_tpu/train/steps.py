"""Jitted train / eval step functions + TrainState.

The reference's hot loop lives inside HF ``Trainer.train()``
(/root/reference/ViT-Training.py:132; pyc L478): DataLoader → collate →
forward (ViT, 577 tokens, bf16) → BCEWithLogitsLoss → backward →
``xm.optimizer_step(AdamW)`` with a torch_xla gradient all-reduce across 8
cores. Rebuilt as one ``jit``-compiled function per step over a
``Mesh`` — sharded batch in, replicated params in, XLA inserts the gradient
all-reduce from the shardings. No lazy-tensor graphs, no per-step retrace.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from chestxray_vit_tpu.config import Config
from chestxray_vit_tpu.models import vit
from chestxray_vit_tpu.ops.preprocess import prepare_pixel_values
from chestxray_vit_tpu.parallel.mesh import batch_sharding, param_sharding, replicated
from chestxray_vit_tpu.train import optimizer as opt

Params = Any


# ---------------------------------------------------------------------------
# Loss: multi-label BCE-with-logits (sigmoid folded in, SURVEY §7 step 5)
# ---------------------------------------------------------------------------

def bce_elements(logits: jax.Array, labels: jax.Array) -> jax.Array:
    """Element-wise numerically-stable BCEWithLogits — the ONE copy of the
    max(x,0) − x·z + log1p(exp(−|x|)) formula (the mean/sum reductions and
    the packed mask differ per call site, the element math must not)."""
    x = logits.astype(jnp.float32)
    z = labels.astype(jnp.float32)
    return jnp.maximum(x, 0.0) - x * z + jnp.log1p(jnp.exp(-jnp.abs(x)))


def bce_with_logits(logits: jax.Array, labels: jax.Array) -> jax.Array:
    """Numerically-stable BCEWithLogits, mean over all elements — identical
    reduction to torch.nn.BCEWithLogitsLoss, which HF picks for multi-label
    heads (ViT-Training.py:89 sets problem_type explicitly; Version B gets it
    inferred from float multi-hot labels, SURVEY §2.2 loss subtlety)."""
    return jnp.mean(bce_elements(logits, labels))


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclass
class TrainState:
    step: jax.Array            # i32 scalar, completed optimizer steps
    params: Params             # f32 master weights
    opt_state: Dict[str, Any]  # AdamW moments (f32)
    rng: jax.Array             # dropout/augmentation key, split per step

    @staticmethod
    def create(params: Params, seed: int) -> "TrainState":
        return TrainState(
            step=jnp.zeros((), jnp.int32),
            params=params,
            opt_state=opt.init_opt_state(params),
            rng=jax.random.key(seed),
        )


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

def make_train_step(cfg: Config, total_steps: int, int8_scales=None
                    ) -> Callable[[TrainState, Dict[str, jax.Array]],
                                  Tuple[TrainState, Dict[str, jax.Array]]]:
    """Build the (unjitted) train step. Callers jit it with shardings via
    :func:`jit_train_step`.

    ``int8_scales`` (a ``calibrate_vit_scales`` tree) switches the
    forward to the int8 straight-through path
    (``models/int8_train.py``) — exploratory train-speed lever; the
    backward and optimizer stay bf16/f32."""
    schedule = opt.SCHEDULES[cfg.train.lr_schedule](
        cfg.train.learning_rate, total_steps, cfg.train.warmup_steps)
    adamw_cfg = opt.AdamWConfig(
        b1=cfg.train.adam_b1, b2=cfg.train.adam_b2, eps=cfg.train.adam_eps,
        weight_decay=cfg.train.weight_decay,
        max_grad_norm=cfg.train.max_grad_norm)

    mixup_alpha = getattr(cfg.data, "mixup_alpha", 0.0)

    def loss_fn(params: Params, batch: Dict[str, jax.Array],
                rng: jax.Array) -> Tuple[jax.Array, jax.Array]:
        images = prepare_pixel_values(
            batch, out_size=cfg.model.img_size,
            mean=cfg.data.image_mean, std=cfg.data.image_std)
        labels = batch["labels"]
        if mixup_alpha > 0.0:
            # device-side mixup: λ_i ~ Beta(α, α) PER SAMPLE (Zhang et
            # al.'s formulation — a per-batch scalar λ is the known
            # weaker-regularization variant); partner is the
            # batch rolled by one — a neighbor ppermute under data-axis
            # sharding, where a random permutation would be an
            # all-to-all gather. Soft multi-hot labels feed BCE directly.
            lam = jax.random.beta(jax.random.fold_in(rng, 7),
                                  mixup_alpha, mixup_alpha,
                                  (images.shape[0], 1, 1, 1))
            images = lam * images + (1.0 - lam) * jnp.roll(images, 1, 0)
            lam_l = lam[:, :, 0, 0]
            labels = (lam_l * labels.astype(jnp.float32)
                      + (1.0 - lam_l) * jnp.roll(labels, 1, 0)
                      .astype(jnp.float32))
        if int8_scales is not None and getattr(cfg.model, "tome_r", 0):
            # both train accelerators requested: the composed int8-STE ×
            # token-merging forward (previously this combination silently
            # dropped tome_r and trained un-merged)
            from chestxray_vit_tpu.models.tome_forward import (
                apply_tome_train)
            logits = apply_tome_train(
                params, images, cfg.model, cfg.model.tome_r, train=True,
                rng=rng,
                schedule=getattr(cfg.model, "tome_schedule", "constant"),
                int8_scales=int8_scales)
        elif int8_scales is not None:
            from chestxray_vit_tpu.models.int8_train import apply_int8_train
            logits = apply_int8_train(params, images, cfg.model,
                                      int8_scales, train=True, rng=rng)
        else:
            logits = vit.apply(params, images, cfg.model, train=True,
                               rng=rng)
        return bce_with_logits(logits, labels), logits

    accum = max(cfg.train.gradient_accumulation_steps, 1)

    def grads_of(params, batch, step_rng):
        """Loss+grads, micro-batched when gradient accumulation is on:
        k sequential fwd+bwd passes inside the jit (lax.scan), averaged —
        same numbers as one big batch (equal micro sizes, mean loss), at
        micro-batch activation memory."""
        if accum == 1:
            (loss, _), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, batch, step_rng)
            return loss, grads

        # strided micro split: micro-batch i takes rows i, i+accum, ... so
        # every device's contiguous data-axis shard contributes equally to
        # each micro-batch and the split needs no cross-device resharding
        # (a contiguous split would concentrate each micro-batch on
        # dp/accum devices and force an all-to-all per scan iteration)
        micro = jax.tree.map(
            lambda x: x.reshape(x.shape[0] // accum, accum,
                                *x.shape[1:]).swapaxes(0, 1),
            batch)
        rngs = jax.random.split(step_rng, accum)

        def body(carry, mb_rng):
            loss_sum, grad_sum = carry
            mb, r = mb_rng
            (loss, _), g = jax.value_and_grad(
                loss_fn, has_aux=True)(params, mb, r)
            return (loss_sum + loss,
                    jax.tree.map(jnp.add, grad_sum, g)), None

        zero = (jnp.zeros((), jnp.float32),
                jax.tree.map(jnp.zeros_like, params))
        (loss_sum, grad_sum), _ = jax.lax.scan(body, zero, (micro, rngs))
        inv = 1.0 / accum
        return loss_sum * inv, jax.tree.map(lambda g: g * inv, grad_sum)

    def train_step(state: TrainState, batch: Dict[str, jax.Array]):
        rng, step_rng = jax.random.split(state.rng)
        loss, grads = grads_of(state.params, batch, step_rng)
        grads, grad_norm = opt.clip_by_global_norm(
            grads, adamw_cfg.max_grad_norm)
        lr = schedule(state.step)
        decay_mask = opt.default_decay_mask(state.params)
        new_params, new_opt = opt.adamw_update(
            grads, state.opt_state, state.params, state.step, lr,
            adamw_cfg, decay_mask)
        new_state = TrainState(step=state.step + 1, params=new_params,
                               opt_state=new_opt, rng=rng)
        metrics = {"loss": loss, "grad_norm": grad_norm, "lr": lr}
        return new_state, metrics

    return train_step


def make_eval_step(cfg: Config) -> Callable[[Params, Dict[str, jax.Array]],
                                            Tuple[jax.Array, jax.Array]]:
    """Forward-only step returning (f32 logits, per-row BCE element sums).

    Logits are gathered to host by the eval loop, like the Trainer's logit
    all-gather (SURVEY §3.4). The per-row loss sums ride the SAME compiled
    program so the eval loop pays one dispatch per batch, not two (instead
    of re-staging gathered host logits through a separate jitted bce
    call). The host slices off padded rows (pad_last) and divides
    by n_valid·C for the mean."""

    def eval_step(params: Params, batch: Dict[str, jax.Array]
                  ) -> Tuple[jax.Array, jax.Array]:
        images = prepare_pixel_values(
            batch, out_size=cfg.model.img_size,
            mean=cfg.data.image_mean, std=cfg.data.image_std)
        logits = vit.apply(params, images, cfg.model, train=False)
        return logits, jnp.sum(bce_elements(logits, batch["labels"]),
                               axis=-1)

    return eval_step


def make_packed_train_step(cfg: Config, total_steps: int,
                           grids=(16, 24, 32)):
    """Train step over NaViT-style packed batches:
    same optimizer stack, segment-masked flash attention, per-image masked
    BCE. Batch dict: tokens / segment_ids / pos_indices / pool_weights /
    labels / image_mask (see data/packing.py)."""
    from chestxray_vit_tpu.models import packed as packed_model

    schedule = opt.SCHEDULES[cfg.train.lr_schedule](
        cfg.train.learning_rate, total_steps, cfg.train.warmup_steps)
    adamw_cfg = opt.AdamWConfig(
        b1=cfg.train.adam_b1, b2=cfg.train.adam_b2, eps=cfg.train.adam_eps,
        weight_decay=cfg.train.weight_decay,
        max_grad_norm=cfg.train.max_grad_norm)

    def loss_parts(params, batch, step_rng):
        """(BCE element-sum over real images, real-image×class count) —
        accumulation-exact split, see packed_bce_parts. ``model.tome_r``
        dispatches to the within-segment merging forward (same contract
        as the dense step's tome dispatch)."""
        fwd = (packed_model.apply_packed_tome if cfg.model.tome_r > 0
               else packed_model.apply_packed)
        logits = fwd(
            params, batch["tokens"], batch["segment_ids"],
            batch["pos_indices"], batch["pool_weights"], cfg.model, grids,
            train=True, rng=step_rng)
        num, den = packed_model.packed_bce_parts(
            logits, batch["labels"], batch["image_mask"])
        return num, den

    accum = max(cfg.train.gradient_accumulation_steps, 1)

    def grads_of(params, batch, step_rng):
        """Loss+grads; with gradient accumulation the batch carries
        accum × batch_seqs sequences, split strided into accum micro
        batches scanned sequentially (same trick as the dense path:
        strided rows keep every device's data-axis shard contributing
        equally to each micro batch — no cross-device resharding).
        Numerator gradients and denominators accumulate separately, so the
        result is bit-exact vs one big batch even when micro batches pack
        unequal real-image counts."""
        if accum == 1:
            (num, den), grads = jax.value_and_grad(
                loss_parts, has_aux=True)(params, batch, step_rng)
            d = jnp.maximum(den, 1.0)
            return num / d, jax.tree.map(lambda g: g / d, grads)

        micro = jax.tree.map(
            lambda x: x.reshape(x.shape[0] // accum, accum,
                                *x.shape[1:]).swapaxes(0, 1),
            batch)
        rngs = jax.random.split(step_rng, accum)

        def body(carry, mb_rng):
            num_sum, den_sum, grad_sum = carry
            mb, r = mb_rng
            (num, den), g = jax.value_and_grad(
                loss_parts, has_aux=True)(params, mb, r)
            return (num_sum + num, den_sum + den,
                    jax.tree.map(jnp.add, grad_sum, g)), None

        zero = (jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32),
                jax.tree.map(jnp.zeros_like, params))
        (num_sum, den_sum, grad_sum), _ = jax.lax.scan(
            body, zero, (micro, rngs))
        d = jnp.maximum(den_sum, 1.0)
        return num_sum / d, jax.tree.map(lambda g: g / d, grad_sum)

    def train_step(state: TrainState, batch):
        rng, step_rng = jax.random.split(state.rng)
        loss, grads = grads_of(state.params, batch, step_rng)
        grads, grad_norm = opt.clip_by_global_norm(
            grads, adamw_cfg.max_grad_norm)
        lr = schedule(state.step)
        decay_mask = opt.default_decay_mask(state.params)
        new_params, new_opt = opt.adamw_update(
            grads, state.opt_state, state.params, state.step, lr,
            adamw_cfg, decay_mask)
        new_state = TrainState(step=state.step + 1, params=new_params,
                               opt_state=new_opt, rng=rng)
        return new_state, {"loss": loss, "grad_norm": grad_norm, "lr": lr}

    return train_step


# ---------------------------------------------------------------------------
# Sharded jit wrappers
# ---------------------------------------------------------------------------

def _state_shardings(mesh: Mesh, state: TrainState) -> TrainState:
    ps = param_sharding(mesh, state.params)
    rep = replicated(mesh)
    return TrainState(
        step=rep,
        params=ps,
        opt_state={"mu": param_sharding(mesh, state.opt_state["mu"]),
                   "nu": param_sharding(mesh, state.opt_state["nu"])},
        rng=rep,
    )


def jit_train_step(train_step, mesh: Mesh, state: TrainState):
    """jit with explicit shardings: batch split on the data axis, state
    replicated (or fsdp-sharded). XLA derives the gradient all-reduce."""
    st_sh = _state_shardings(mesh, state)
    bt_sh = batch_sharding(mesh)
    met_sh = replicated(mesh)
    # bt_sh / met_sh are pytree-prefix shardings: every batch leaf is split
    # on the data axis, every metric is replicated.
    return jax.jit(
        train_step,
        in_shardings=(st_sh, bt_sh),
        out_shardings=(st_sh, met_sh),
        # donating the batch too was measured a no-op (no aliasable output
        # shape) — state donation is what matters
        donate_argnums=(0,),
    )


def make_inference_eval_step(cfg: Config, quantized: bool = False,
                             tome_r: int = 0
                             ) -> Callable[[Params, Dict[str, jax.Array]],
                                           Tuple[jax.Array, jax.Array]]:
    """`make_eval_step` on the serving-accelerated forwards (beyond the
    reference): int8 (`models/quantized.py`) and/or token merging
    (`models/tome_forward.py`). Same (logits, per-row BCE element sums)
    contract; ``params`` is the quantized tree when ``quantized``."""
    from chestxray_vit_tpu.models.quantized import apply_quantized

    def eval_step(params: Params, batch: Dict[str, jax.Array]
                  ) -> Tuple[jax.Array, jax.Array]:
        images = prepare_pixel_values(
            batch, out_size=cfg.model.img_size,
            mean=cfg.data.image_mean, std=cfg.data.image_std)
        if tome_r:
            from chestxray_vit_tpu.models.tome_forward import apply_tome
            logits = apply_tome(params, images, cfg.model, tome_r,
                                quantized=quantized,
                                schedule=getattr(cfg.model, "tome_schedule",
                                                 "constant"))
        elif quantized:
            logits = apply_quantized(params, images, cfg.model)
        else:
            logits = vit.apply(params, images, cfg.model, train=False)
        return logits, jnp.sum(bce_elements(logits, batch["labels"]),
                               axis=-1)

    return eval_step


def make_quantized_eval_step(cfg: Config):
    """Back-compat alias: the int8 eval step."""
    return make_inference_eval_step(cfg, quantized=True)


def jit_quantized_eval_step(eval_step, mesh: Mesh):
    """Like :func:`jit_eval_step` but the quantized tree is replicated:
    int8 weights are 4× smaller than the f32 masters, so replication is
    cheap and keeps the step correct on any mesh shape."""
    return jax.jit(
        eval_step,
        in_shardings=(replicated(mesh), batch_sharding(mesh)),
        out_shardings=batch_sharding(mesh),
    )


def jit_eval_step(eval_step, mesh: Mesh, params: Params):
    p_sh = param_sharding(mesh, params)
    bt_sh = batch_sharding(mesh)
    # outputs (logits [B, C], row-loss [B]) both stay batch-sharded; the
    # prefix sharding covers the whole output tuple
    return jax.jit(
        eval_step,
        in_shardings=(p_sh, bt_sh),
        out_shardings=batch_sharding(mesh),
    )


def place_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Place host-initialized train state onto the mesh.

    Single-process: plain device_put. Multi-host: device_put cannot target
    non-addressable devices, so each leaf becomes a global array via
    ``make_array_from_callback`` (every process holds the full value — init
    is seed-deterministic — and each addressable device reads its slice).
    PRNG key leaves are unwrapped to uint32 key data and re-wrapped, since
    extended dtypes can't cross the numpy boundary.
    """
    sh = _state_shardings(mesh, state)
    if jax.process_count() == 1:
        return jax.tree.map(jax.device_put, state, sh)

    def put(x, s):
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
            impl = jax.random.key_impl(x)
            data = np.asarray(jax.random.key_data(x))
            arr = jax.make_array_from_callback(
                data.shape, jax.sharding.NamedSharding(mesh, P()),
                lambda idx: data[idx])
            return jax.random.wrap_key_data(arr, impl=impl)
        xh = np.asarray(x)
        return jax.make_array_from_callback(xh.shape, s,
                                            lambda idx: xh[idx])

    return jax.tree.map(put, state, sh)
