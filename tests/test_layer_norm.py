"""Custom-VJP LayerNorm: forward + gradients vs naive autodiff and torch."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chestxray_vit_tpu.ops.layer_norm import layer_norm


def naive_ln(x, scale, bias, eps):
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.var(x32, axis=-1, keepdims=True)
    y = (x32 - mean) * jax.lax.rsqrt(var + eps)
    return (y * scale + bias).astype(x.dtype)


def test_forward_matches_naive(rng):
    x = jnp.asarray(rng.standard_normal((4, 7, 16)), jnp.float32)
    s = jnp.asarray(rng.standard_normal(16), jnp.float32)
    b = jnp.asarray(rng.standard_normal(16), jnp.float32)
    np.testing.assert_allclose(np.asarray(layer_norm(x, s, b, 1e-12)),
                               np.asarray(naive_ln(x, s, b, 1e-12)),
                               atol=1e-6)


def test_grads_match_naive_autodiff(rng):
    x = jnp.asarray(rng.standard_normal((3, 5, 8)), jnp.float32)
    s = jnp.asarray(rng.standard_normal(8), jnp.float32)
    b = jnp.asarray(rng.standard_normal(8), jnp.float32)
    g = jnp.asarray(rng.standard_normal((3, 5, 8)), jnp.float32)

    def loss_ours(x, s, b):
        return jnp.sum(layer_norm(x, s, b, 1e-12) * g)

    def loss_naive(x, s, b):
        return jnp.sum(naive_ln(x, s, b, 1e-12) * g)

    ours = jax.grad(loss_ours, argnums=(0, 1, 2))(x, s, b)
    ref = jax.grad(loss_naive, argnums=(0, 1, 2))(x, s, b)
    for a, r in zip(ours, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r),
                                   atol=1e-5, rtol=1e-5)


def test_grads_match_torch(rng):
    torch = pytest.importorskip("torch")
    x = rng.standard_normal((2, 6, 8)).astype(np.float32)
    s = rng.standard_normal(8).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    g = rng.standard_normal((2, 6, 8)).astype(np.float32)

    tx = torch.tensor(x, requires_grad=True)
    ts = torch.tensor(s, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    ty = torch.nn.functional.layer_norm(tx, (8,), ts, tb, eps=1e-12)
    ty.backward(torch.tensor(g))

    ours = jax.grad(
        lambda x, s, b: jnp.sum(layer_norm(x, s, b, 1e-12) * g),
        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(ours[0]), tx.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(ours[1]), ts.grad.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(ours[2]), tb.grad.numpy(), atol=1e-4)


def test_bf16_input_keeps_dtype(rng):
    x = jnp.asarray(rng.standard_normal((2, 4, 8)), jnp.bfloat16)
    s = jnp.ones(8, jnp.float32)
    b = jnp.zeros(8, jnp.float32)
    y = layer_norm(x, s, b, 1e-12)
    assert y.dtype == jnp.bfloat16
