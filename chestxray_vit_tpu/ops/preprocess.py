"""Device-side fused preprocessing.

The reference's per-sample hot path (SURVEY §3.3) is PIL on the host:
grayscale decode → (bbox crop | pad-to-square) → Resize(384, bilinear) →
RGB → HF processor rescale+normalize (pyc L265-L305). Rebuilt as ONE fused
device computation: the crop, centered square padding, PIL-parity
antialiased bilinear resize, grayscale→RGB broadcast, and processor
normalization all happen on-device from the raw u8 canvas.

Design: the separable resize is expressed as two small matmuls
(out = Wy · img · Wxᵀ) so the resample rides the MXU instead of a gather
engine, with the per-image filter weights built on the VPU. Everything is
static-shaped: canvases are fixed [B, C, C] u8, crop windows arrive as a
[B, 4] scalar tensor, and validity masks handle image extents — no dynamic
shapes, no host round-trips, fuses into the surrounding jit (e.g. the train
step), and is fully differentiable-through if ever needed.

A lighter ``normalize_u8`` covers the host-resized input path (u8 384² in,
bf16 normalized RGB out) — the right trade when host→device bandwidth is the
bottleneck.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from chestxray_vit_tpu.config import PROCESSOR_MEAN, PROCESSOR_STD


def _resize_weights(out_size: int, src_extent: jax.Array, max_in: int
                    ) -> jax.Array:
    """[out_size, max_in] PIL-BILINEAR weights for resizing a 1-D signal of
    (dynamic) length ``src_extent`` living in slots [0, src_extent) of a
    static ``max_in`` buffer.

    PIL semantics: scale = in/out; filter support = max(scale, 1) (triangle
    filter stretched for antialiased downscale); out pixel i samples around
    center (i+0.5)*scale; weights are clipped to the image extent and
    renormalized over in-bounds taps.
    """
    src = src_extent.astype(jnp.float32)
    scale = src / out_size
    fscale = jnp.maximum(scale, 1.0)
    centers = (jnp.arange(out_size, dtype=jnp.float32) + 0.5) * scale  # [O]
    taps = jnp.arange(max_in, dtype=jnp.float32) + 0.5                 # [I]
    dist = jnp.abs(centers[:, None] - taps[None, :]) / fscale
    w = jnp.maximum(0.0, 1.0 - dist)
    w = jnp.where(taps[None, :] < src, w, 0.0)   # clip to image extent
    norm = jnp.sum(w, axis=1, keepdims=True)
    return w / jnp.maximum(norm, 1e-12)


def _gather_axis(canvas: jax.Array, start: jax.Array, offset: jax.Array,
                 extent: jax.Array, axis: int) -> jax.Array:
    """Map square-space positions to canvas positions along one axis:
    square slot y holds canvas[start + y - offset] when
    offset ≤ y < offset+extent, else 0 (the centered black padding)."""
    n = canvas.shape[axis]
    idx = jnp.arange(n) - offset + start
    valid = (jnp.arange(n) >= offset) & (jnp.arange(n) < offset + extent)
    # a box reaching past the canvas must yield black padding like the PIL
    # reference, not edge-replicated rows from the take()'s index clamp
    valid &= (idx >= 0) & (idx < n)
    idx = jnp.clip(idx, 0, n - 1)
    out = jnp.take(canvas, idx, axis=axis)
    shape = [1, 1]
    shape[axis] = n
    return out * valid.reshape(shape)


def _preprocess_one(canvas: jax.Array, box: jax.Array, out_size: int,
                    stretch: jax.Array, flip: jax.Array) -> jax.Array:
    """One image: u8 [C, C] canvas + crop box (left, top, w, h) →
    f32 [out, out] in [0, 1]. ``stretch`` is a traced per-sample bool so
    pad-to-square (Version B ROI) and stretch (RandomResizedCrop) samples
    can share one compiled batch."""
    cmax = canvas.shape[0]
    left, top, w, h = box[0], box[1], box[2], box[3]
    w32, h32 = w.astype(jnp.int32), h.astype(jnp.int32)
    left32, top32 = left.astype(jnp.int32), top.astype(jnp.int32)

    side = jnp.maximum(w32, h32)
    side_y = jnp.where(stretch, h32, side)
    side_x = jnp.where(stretch, w32, side)
    # centered pad offsets (pyc L184-L196 integer semantics); zero when
    # stretching each axis independently
    zero = jnp.zeros((), jnp.int32)
    off_y = jnp.where(stretch, zero,
                      jnp.where(w32 > h32, (w32 - h32) // 2, 0))
    off_x = jnp.where(stretch, zero,
                      jnp.where(h32 > w32, (h32 - w32) // 2, 0))

    img = canvas.astype(jnp.float32)
    sq = _gather_axis(img, top32, off_y, h32, axis=0)
    sq = _gather_axis(sq, left32, off_x, w32, axis=1)

    wy = _resize_weights(out_size, side_y, cmax)        # [O, C]
    wx = _resize_weights(out_size, side_x, cmax)        # [O, C]
    out = wy @ sq @ wx.T                                # MXU×2
    out = jnp.where(flip, out[:, ::-1], out)
    return out / 255.0


@functools.partial(jax.jit, static_argnames=("out_size", "stretch", "dtype"))
def fused_preprocess(
    canvases: jax.Array,                 # u8 [B, C, C] grayscale
    boxes: jax.Array,                    # i32/f32 [B, 4] (left, top, w, h)
    out_size: int = 384,
    stretch: bool = False,               # False: pad-to-square (Version B)
    flips: Optional[jax.Array] = None,   # bool [B] horizontal flip
    mean: Tuple[float, ...] = PROCESSOR_MEAN,
    std: Tuple[float, ...] = PROCESSOR_STD,
    dtype: jnp.dtype = jnp.float32,
    stretches: Optional[jax.Array] = None,   # bool [B] per-sample override
) -> jax.Array:
    """Fused crop/pad/resize/normalize: [B, C, C] u8 → [B, out, out, 3].

    ``stretch=False`` reproduces Version B's bbox-ROI chain (crop →
    pad-to-square → resize); ``stretch=True`` resizes each axis
    independently — the RandomResizedCrop path (Version A train transform).
    ``stretches`` selects per sample instead (training batches can mix).
    """
    b = canvases.shape[0]
    if flips is None:
        flips = jnp.zeros((b,), jnp.bool_)
    if stretches is None:
        stretches = jnp.full((b,), stretch, jnp.bool_)
    gray = jax.vmap(
        lambda c, b_, st, f: _preprocess_one(c, b_, out_size, st, f)
    )(canvases, boxes, stretches, flips)                 # [B, O, O] in [0,1]
    mean_a = jnp.asarray(mean, jnp.float32)
    std_a = jnp.asarray(std, jnp.float32)
    rgb = (gray[..., None] - mean_a) / std_a             # [B, O, O, 3]
    return rgb.astype(dtype)


@functools.partial(jax.jit, static_argnames=("dtype",))
def normalize_u8(
    images_u8: jax.Array,                # u8 [B, H, W] grayscale (resized)
    mean: Tuple[float, ...] = PROCESSOR_MEAN,
    std: Tuple[float, ...] = PROCESSOR_STD,
    dtype: jnp.dtype = jnp.float32,
) -> jax.Array:
    """Host-resized path: u8 grayscale → normalized RGB (rescale 1/255,
    processor mean/std — the ViTImageProcessor tail, pyc L300)."""
    x = images_u8.astype(jnp.float32) / 255.0
    mean_a = jnp.asarray(mean, jnp.float32)
    std_a = jnp.asarray(std, jnp.float32)
    return ((x[..., None] - mean_a) / std_a).astype(dtype)


def prepare_pixel_values(batch: dict, dtype: jnp.dtype = jnp.float32, *,
                         out_size: int = 384,
                         mean: Tuple[float, ...] = PROCESSOR_MEAN,
                         std: Tuple[float, ...] = PROCESSOR_STD) -> jax.Array:
    """Resolve a batch dict to normalized [B, H, W, 3] pixel values.

    Accepts any of the three pipeline placements:
    - ``pixel_values``: pre-normalized f32 NHWC (adapters, tests);
    - ``pixel_values_u8``: host-resized [B, H, W] grayscale, normalized
      on-device inside the surrounding jit (placement='host');
    - ``canvas_u8`` + ``boxes`` (+ ``flips``/``stretches``): raw decode
      canvases, crop/pad/resize/normalize fused on the MXU inside the train
      step's jit (placement='device', SURVEY §3.3).
    """
    if "pixel_values" in batch:
        return batch["pixel_values"]
    if "canvas_u8" in batch:
        return fused_preprocess(
            batch["canvas_u8"], batch["boxes"], out_size,
            flips=batch.get("flips"), mean=mean, std=std, dtype=dtype,
            stretches=batch.get("stretches"))
    return normalize_u8(batch["pixel_values_u8"], mean=mean, std=std,
                        dtype=dtype)
