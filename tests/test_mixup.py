"""Device-side mixup inside the jitted train step (data.mixup_alpha)."""

import jax
import jax.numpy as jnp
import numpy as np

from chestxray_vit_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from chestxray_vit_tpu.train import steps as S
from chestxray_vit_tpu.models import vit


def _cfg(alpha):
    return Config(
        data=DataConfig(mixup_alpha=alpha),
        model=ModelConfig(img_size=32, patch_size=16, hidden_size=32,
                          num_layers=1, num_heads=2, mlp_dim=64,
                          num_classes=4, dtype="float32",
                          attention_impl="xla"),
        train=TrainConfig(learning_rate=1e-3))


def _batch(rng, n=8):
    return {"pixel_values": jnp.asarray(
                rng.standard_normal((n, 32, 32, 3)), jnp.float32),
            "labels": jnp.asarray((rng.random((n, 4)) < 0.4), jnp.float32)}


def test_mixup_off_is_identity(rng):
    batch = _batch(rng)
    params = vit.init_params(jax.random.key(0), _cfg(0.0).model)
    s0 = S.TrainState.create(params, 0)
    s1 = S.TrainState.create(params, 0)
    step_off = jax.jit(S.make_train_step(_cfg(0.0), 100))
    # alpha=0 must be the exact unmixed step (static branch, no RNG use)
    ref = jax.jit(S.make_train_step(Config(
        data=DataConfig(), model=_cfg(0.0).model,
        train=TrainConfig(learning_rate=1e-3)), 100))
    s0, m0 = step_off(s0, batch)
    s1, m1 = ref(s1, batch)
    np.testing.assert_array_equal(np.asarray(m0["loss"]),
                                  np.asarray(m1["loss"]))


def test_mixup_trains_and_differs_from_unmixed(rng):
    batch = _batch(rng)
    params = vit.init_params(jax.random.key(1), _cfg(0.2).model)
    sa = S.TrainState.create(params, 0)
    sb = S.TrainState.create(params, 0)
    mixed = jax.jit(S.make_train_step(_cfg(0.2), 100))
    plain = jax.jit(S.make_train_step(_cfg(0.0), 100))
    sa, ma = mixed(sa, batch)
    sb, mb = plain(sb, batch)
    assert np.isfinite(float(ma["loss"]))
    assert float(ma["loss"]) != float(mb["loss"])
    # several steps stay finite and the loss decreases on a fixed batch
    losses = []
    for _ in range(8):
        sa, ma = mixed(sa, batch)
        losses.append(float(ma["loss"]))
    assert np.isfinite(losses).all()


def test_mixup_label_convexity(rng):
    """Mixed labels are per-sample λ_i-convex combinations of the batch
    and its roll-by-one partner (Zhang et al.'s per-sample formulation,
    checked through the loss: identical images force the loss
    to depend only on mixed labels). BCE is affine in the labels, so each
    row's loss must lie between its two λ∈{0,1} endpoints — the batch
    loss between the means of the row-wise minima and maxima."""
    cfg = _cfg(0.4)
    n = 8
    # constant images: mixing changes nothing on pixels, only labels mix
    batch = {"pixel_values": jnp.ones((n, 32, 32, 3), jnp.float32),
             "labels": jnp.asarray((np.arange(n * 4).reshape(n, 4) % 3
                                    == 0), jnp.float32)}
    params = vit.init_params(jax.random.key(2), cfg.model)
    logits = vit.apply(params, batch["pixel_values"], cfg.model)
    state = S.TrainState.create(params, 0)
    step = jax.jit(S.make_train_step(cfg, 100))
    _, metrics = step(state, batch)
    loss = float(metrics["loss"])
    labels = np.asarray(batch["labels"])
    row = lambda z: np.mean(np.asarray(
        S.bce_elements(logits, jnp.asarray(z))), axis=-1)
    l1 = row(labels)                          # λ_i = 1 endpoint
    l0 = row(np.roll(labels, 1, 0))           # λ_i = 0 endpoint
    lo = float(np.minimum(l0, l1).mean())
    hi = float(np.maximum(l0, l1).mean())
    assert lo - 1e-4 <= loss <= hi + 1e-4
