"""High-res @512 and ViT-L configs: pos-embed interpolation and the remat
training step (attention at 1025 tokens: tests/test_attention.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chestxray_vit_tpu.config import Config, ModelConfig, TrainConfig, vit_large_config
from chestxray_vit_tpu.models import vit


def test_interpolate_pos_embed_shapes(rng):
    pe = jnp.asarray(rng.standard_normal((1, 577, 64)), jnp.float32)
    out = vit.interpolate_pos_embed(pe, 1025)       # 24²+1 → 32²+1
    assert out.shape == (1, 1025, 64)
    # CLS slot untouched
    np.testing.assert_array_equal(np.asarray(out[:, 0]), np.asarray(pe[:, 0]))
    # identity when grid matches
    same = vit.interpolate_pos_embed(pe, 577)
    np.testing.assert_array_equal(np.asarray(same), np.asarray(pe))
    with pytest.raises(ValueError):
        vit.interpolate_pos_embed(pe, 578)


def test_interpolate_preserves_smooth_fields():
    """A linear-in-position embedding must be reproduced (bicubic is exact
    on linear ramps away from boundaries)."""
    g = 8
    ys, xs = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    grid = np.stack([ys / (g - 1), xs / (g - 1)], -1).reshape(1, g * g, 2)
    pe = jnp.asarray(np.concatenate(
        [np.zeros((1, 1, 2)), grid], axis=1), jnp.float32)
    out = np.asarray(vit.interpolate_pos_embed(pe, 17 * 17 + 1))[0, 1:]
    out = out.reshape(17, 17, 2)
    interior = out[4:-4, 4:-4, 0]
    expect = np.linspace(0, 1, 17)[4:-4]
    assert np.abs(interior - expect[:, None]).max() < 0.05


@pytest.mark.parametrize("g_old,g_new", [(24, 32), (24, 16), (8, 17)])
def test_interpolate_matches_torch_bicubic(rng, g_old, g_new):
    """HF interpolate_pos_encoding resamples with
    torch.nn.functional.interpolate(mode='bicubic', align_corners=False);
    our separable a=-0.75 kernel must match it to float tolerance."""
    torch = pytest.importorskip("torch")
    d = 32
    grid = rng.standard_normal((1, g_old * g_old, d)).astype(np.float32)
    pe = jnp.asarray(np.concatenate(
        [rng.standard_normal((1, 1, d)).astype(np.float32), grid], axis=1))
    ours = np.asarray(vit.interpolate_pos_embed(pe, g_new * g_new + 1))[0, 1:]
    t = torch.from_numpy(grid.reshape(g_old, g_old, d)) \
        .permute(2, 0, 1).unsqueeze(0)
    ref = torch.nn.functional.interpolate(
        t, size=(g_new, g_new), mode="bicubic", align_corners=False)
    ref = ref.squeeze(0).permute(1, 2, 0).reshape(g_new * g_new, d).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


def test_adapt_params_to_512(rng):
    cfg384 = ModelConfig(img_size=384, hidden_size=64, num_layers=1,
                         num_heads=4, mlp_dim=64, num_classes=3,
                         dtype="float32")
    params = vit.init_params(jax.random.key(0), cfg384)
    cfg512 = ModelConfig(img_size=512, hidden_size=64, num_layers=1,
                         num_heads=4, mlp_dim=64, num_classes=3,
                         dtype="float32", attention_impl="xla")
    adapted = vit.adapt_params_to_img_size(params, cfg512)
    assert adapted["pos_embed"].shape == (1, 1025, 64)
    x = jnp.asarray(rng.standard_normal((1, 512, 512, 3)), jnp.float32)
    logits = vit.apply(adapted, x, cfg512)
    assert logits.shape == (1, 3) and bool(jnp.isfinite(logits).all())


def test_vit_large_config_remat_train_step(rng):
    """ViT-L-shaped (scaled-down dims, 24 layers, remat on) train step runs
    and decreases loss — configs[2]'s gradient-checkpointing path."""
    from chestxray_vit_tpu.train import steps as S
    cfg = Config(
        model=ModelConfig(img_size=32, patch_size=16, hidden_size=64,
                          num_layers=24, num_heads=4, mlp_dim=128,
                          num_classes=5, dtype="float32",
                          attention_impl="xla", remat=True),
        train=TrainConfig(learning_rate=1e-3))
    params = vit.init_params(jax.random.key(0), cfg.model)
    state = S.TrainState.create(params, 0)
    step = jax.jit(S.make_train_step(cfg, 50))
    batch = {
        "pixel_values": jnp.asarray(rng.standard_normal((4, 32, 32, 3)),
                                    jnp.float32),
        "labels": jnp.asarray((rng.random((4, 5)) < 0.4), jnp.float32),
    }
    losses = []
    for _ in range(10):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_vit_large_preset():
    cfg = vit_large_config()
    assert cfg.num_layers == 24 and cfg.hidden_size == 1024
    assert cfg.remat is True
