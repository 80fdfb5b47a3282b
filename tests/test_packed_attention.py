"""Segment-masked (packed) attention vs the XLA oracle, for the XLA path and
for the cuDNN wrapper (run through XLA's implementation of the same API on
the CPU: odd lengths padded with a key row of its own segment)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chestxray_vit_tpu.ops.attention import (
    attention,
    attention_fused,
    attention_xla,
)

PATHS = {
    "xla": lambda q, k, v, seg: attention(q, k, v, impl="xla",
                                          segment_ids=seg),
    "fused": lambda q, k, v, seg: attention_fused(q, k, v, seg,
                                                  implementation="xla"),
}
pytestmark = pytest.mark.parametrize("path", sorted(PATHS))


def _inputs(rng, b=2, h=2, s=96, d=64):
    q, k, v = (jnp.asarray(rng.standard_normal((b, h, s, d)), jnp.float32)
               for _ in range(3))
    # two packed images per row: first 40 tokens seg 0, next 35 seg 1, pad -1
    seg = np.full((b, s), -1, np.int32)
    seg[:, :40] = 0
    seg[:, 40:75] = 1
    return q, k, v, jnp.asarray(seg)


def test_forward_matches_oracle(rng, path):
    q, k, v, seg = _inputs(rng, s=97)
    out = PATHS[path](q, k, v, seg)
    ref = attention_xla(q, k, v, seg)
    np.testing.assert_allclose(np.asarray(out)[:, :, :75],
                               np.asarray(ref)[:, :, :75],
                               atol=1e-5, rtol=1e-5)


def test_segments_are_isolated(rng, path):
    """Perturbing tokens of segment 1 must not change segment-0 outputs."""
    q, k, v, seg = _inputs(rng)
    out1 = np.asarray(PATHS[path](q, k, v, seg))
    k2 = k.at[:, :, 40:75].add(1.0)
    v2 = v.at[:, :, 40:75].add(-2.0)
    out2 = np.asarray(PATHS[path](q, k2, v2, seg))
    np.testing.assert_allclose(out1[:, :, :40], out2[:, :, :40], atol=1e-6)
    assert np.abs(out1[:, :, 40:75] - out2[:, :, 40:75]).max() > 0.01


def test_matches_unpacked_per_segment(rng, path):
    """A packed row must equal running each segment alone."""
    q, k, v, seg = _inputs(rng, b=1, s=95)
    packed = np.asarray(PATHS[path](q, k, v, seg))
    alone0 = np.asarray(attention_xla(q[:, :, :40], k[:, :, :40],
                                      v[:, :, :40]))
    alone1 = np.asarray(attention_xla(q[:, :, 40:75], k[:, :, 40:75],
                                      v[:, :, 40:75]))
    np.testing.assert_allclose(packed[:, :, :40], alone0, atol=1e-5)
    np.testing.assert_allclose(packed[:, :, 40:75], alone1, atol=1e-5)


def test_backward_matches_oracle(rng, path):
    q, k, v, seg = _inputs(rng, s=81)
    g = jnp.asarray(rng.standard_normal(q.shape), jnp.float32)
    # zero the padded-region cotangent: pad outputs are don't-care
    g = g.at[:, :, 75:].set(0.0)

    def loss_path(q, k, v):
        return jnp.sum(PATHS[path](q, k, v, seg) * g)

    def loss_ref(q, k, v):
        return jnp.sum(attention_xla(q, k, v, seg) * g)

    ours = jax.grad(loss_path, argnums=(0, 1, 2))(q, k, v)
    ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for a, r in zip(ours, ref):
        np.testing.assert_allclose(np.asarray(a)[:, :, :75],
                                   np.asarray(r)[:, :, :75],
                                   atol=1e-4, rtol=1e-4)


def test_jit_compatible(rng, path):
    q, k, v, seg = _inputs(rng, s=64)

    @jax.jit
    def f(q, k, v, seg):
        return PATHS[path](q, k, v, seg).sum()

    assert np.isfinite(float(f(q, k, v, seg)))
