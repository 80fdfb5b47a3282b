"""Symmetric int8 quantization primitives for the serving forward.

XLA lowers ``lax.dot_general(int8, int8, preferred_element_type=int32)``
to the accelerator's int8 matrix path (on the H100 the tensor cores'
int8 rate is twice the bf16 one). The reference has no quantization
story at all (its serving is
unshipped, README TODO `README.md:90`); this module is the beyond-parity
inference speed path:

- weights: symmetric per-output-channel int8 (scale = max|W[:, o]| / 127),
  computed ONCE at load time (`quantize_weight`);
- activations: either symmetric per-row (per-token) dynamic int8
  (`int8_matmul` — the row scale factors out of the contraction, so it
  rides the cheap f32 epilogue) or a static calibrated scalar scale
  (`int8_matmul_static` — fully fusable);
- matmul: int8 dot with int32 accumulation, rescaled in one fused
  elementwise epilogue.

Accuracy is oracle-tested (tests/test_quant.py): quantization math against
a numpy reference, and end-to-end logits against the f32 model within a
tolerance that keeps rankings (AUROC on synthetic data) intact.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class QuantizedWeight(NamedTuple):
    """Per-output-channel symmetric int8 weight."""
    q: jax.Array        # int8 [in, out]
    scale: jax.Array    # f32 [out] — w ≈ q * scale


def quantize_weight(w: jax.Array) -> QuantizedWeight:
    """f32/bf16 [in, out] → per-output-channel symmetric int8."""
    w = w.astype(jnp.float32)
    amax = jnp.max(jnp.abs(w), axis=0)                    # [out]
    scale = jnp.maximum(amax, 1e-8) / 127.0
    q = jnp.clip(jnp.round(w / scale), -127, 127).astype(jnp.int8)
    return QuantizedWeight(q=q, scale=scale)


def quantize_rows(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """[..., in] → (int8 [..., in], f32 row scales [..., 1]) — symmetric
    per-row (per-token) dynamic quantization."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    scale = jnp.maximum(amax, 1e-8) / 127.0
    q = jnp.clip(jnp.round(xf / scale), -127, 127).astype(jnp.int8)
    return q, scale


def int8_matmul(x: jax.Array, qw: QuantizedWeight,
                bias: jax.Array | None = None,
                out_dtype=jnp.bfloat16) -> jax.Array:
    """y = x @ (qw.q * qw.scale) + bias via one int8 MXU contraction.

    x: [..., in] float. The int32 accumulator is rescaled by
    row_scale ⊗ channel_scale in a single fused epilogue."""
    xq, xs = quantize_rows(x)
    acc = jax.lax.dot_general(
        xq, qw.q,
        (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)                 # [..., out] i32
    y = acc.astype(jnp.float32) * (xs * qw.scale)
    if bias is not None:
        y = y + bias.astype(jnp.float32)
    return y.astype(out_dtype)


def int8_matmul_static(x: jax.Array, qw: QuantizedWeight,
                       x_scale: jax.Array,
                       bias: jax.Array | None = None,
                       out_dtype=jnp.bfloat16) -> jax.Array:
    """``int8_matmul`` with a precomputed (calibration) activation scale.

    The dynamic path's per-row amax is a *reduction* over the activation,
    which XLA cannot fuse into the producer — it costs one extra
    full-tensor HBM pass per matmul. With a static scalar scale the
    quantize step is pure elementwise: it fuses into the producing op's
    epilogue and the activation crosses HBM once (as int8).
    Values beyond the calibration range saturate at ±127 by design.

    x_scale: f32 scalar (from :func:`models.quantized.calibrate_vit_scales`).
    """
    xf = x.astype(jnp.float32)
    q = jnp.clip(jnp.round(xf / x_scale), -127.0, 127.0).astype(jnp.int8)
    acc = jax.lax.dot_general(
        q, qw.q,
        (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)                 # [..., out] i32
    y = acc.astype(jnp.float32) * (x_scale * qw.scale)
    if bias is not None:
        y = y + bias.astype(jnp.float32)
    return y.astype(out_dtype)


def dequantize(qw: QuantizedWeight) -> jax.Array:
    """f32 reconstruction (tests/inspection)."""
    return qw.q.astype(jnp.float32) * qw.scale
