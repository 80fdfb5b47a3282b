"""Memory-lean LayerNorm with a custom VJP.

Plain autodiff through an f32-upcast LayerNorm makes XLA save f32
normalized intermediates per call — for ViT-B @384 that is six
f32[L, B, 577, 768] residual tensors (~7.6 GB at batch 64). The custom VJP
saves only the original-dtype input plus scale and recomputes mean/var/x̂
in the backward.

Forward math is identical to the naive version (f32 statistics, HF eps
1e-12) — the parity suite pins it against torch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def layer_norm(x: jax.Array, scale: jax.Array, bias: jax.Array,
               eps: float) -> jax.Array:
    """LayerNorm over the last axis in f32, output in x.dtype."""
    return _forward_xla(x, scale, bias, eps)


def _forward_xla(x, scale, bias, eps):
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.var(x32, axis=-1, keepdims=True)
    xhat = (x32 - mean) * jax.lax.rsqrt(var + eps)
    y = xhat * scale.astype(jnp.float32) + bias.astype(jnp.float32)
    return y.astype(x.dtype)


def _bwd_xla(eps, x, scale, dy):
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.var(x32, axis=-1, keepdims=True)
    inv = jax.lax.rsqrt(var + eps)
    xhat = (x32 - mean) * inv

    dy32 = dy.astype(jnp.float32)
    reduce_axes = tuple(range(dy32.ndim - 1))
    dscale = jnp.sum(dy32 * xhat, axis=reduce_axes)
    dbias = jnp.sum(dy32, axis=reduce_axes)

    g = dy32 * scale.astype(jnp.float32)
    dx = (g - jnp.mean(g, axis=-1, keepdims=True)
          - xhat * jnp.mean(g * xhat, axis=-1, keepdims=True)) * inv
    return (dx.astype(x.dtype), dscale.astype(scale.dtype),
            dbias.astype(scale.dtype))


def _fwd(x, scale, bias, eps):
    return _forward_xla(x, scale, bias, eps), (x, scale)


def _bwd(eps, res, dy):
    x, scale = res
    return _bwd_xla(eps, x, scale, dy)


layer_norm.defvjp(_fwd, _bwd)
