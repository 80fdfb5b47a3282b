"""Fused-QKV projection: a pure perf variant that must be numerically
invisible."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chestxray_vit_tpu.config import ModelConfig
from chestxray_vit_tpu.models import vit


def _cfg(**kw):
    return ModelConfig(img_size=32, patch_size=16, hidden_size=32,
                       num_layers=2, num_heads=2, mlp_dim=64, num_classes=4,
                       dtype="float32", attention_impl="xla", **kw)


def test_fused_qkv_matches_split_projections():
    cfg0, cfg1 = _cfg(), _cfg(fused_qkv=True)
    params = vit.init_params(jax.random.key(0), cfg0)
    images = jax.random.normal(jax.random.key(1), (3, 32, 32, 3))
    a = vit.apply(params, images, cfg0)
    b = vit.apply(params, images, cfg1)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               atol=1e-5, rtol=1e-5)

    def loss(p, cfg):
        return jnp.sum(vit.apply(p, images, cfg) ** 2)

    g0 = jax.grad(loss)(params, cfg0)
    g1 = jax.grad(loss)(params, cfg1)
    for x, y in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("policy", ["full", "mlp", "attn", "attn_mlp",
                                    "dots"])
def test_remat_policies_leave_gradients_unchanged(policy):
    """Every remat policy (the checkpoint names it saves or drops:
    'attn_heads', 'mlp_hidden') recomputes the same function."""
    cfg0, cfg1 = _cfg(), _cfg(remat=True, remat_policy=policy)
    params = vit.init_params(jax.random.key(0), cfg0)
    images = jax.random.normal(jax.random.key(1), (2, 32, 32, 3))

    def loss(p, cfg):
        return jnp.sum(vit.apply(p, images, cfg) ** 2)

    g0 = jax.grad(loss)(params, cfg0)
    g1 = jax.grad(loss)(params, cfg1)
    for x, y in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   atol=1e-5, rtol=1e-4)
