"""int8 forward inside the train step (models/int8_train.py — exploratory
lever).

Pins the two claims the lever rests on: (1) the forward IS the proven
static-int8 serving forward (same quantization math, same scales), and
(2) the straight-through backward produces gradients that match the
dense step's direction (exact vs a dense-linear oracle at the op level;
cosine-close at the model level, where the forward's quantization error
perturbs the loss point the gradient is taken at).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chestxray_vit_tpu.config import ModelConfig
from chestxray_vit_tpu.models import vit
from chestxray_vit_tpu.models.int8_train import (
    apply_int8_train,
    int8_linear_ste,
)
from chestxray_vit_tpu.models.quantized import (
    apply_quantized,
    calibrate_vit_scales,
    quantize_vit_params,
)
from chestxray_vit_tpu.ops.quant import int8_matmul_static, quantize_weight


def _cfg(**kw) -> ModelConfig:
    base = dict(img_size=64, patch_size=16, hidden_size=64, num_layers=3,
                num_heads=4, mlp_dim=128, num_classes=5, dtype="float32",
                attention_impl="xla")
    base.update(kw)
    return ModelConfig(**base)


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    params = vit.init_params(jax.random.key(0), cfg)
    rng = np.random.default_rng(0)
    imgs = jnp.asarray(rng.standard_normal((4, 64, 64, 3)) * 0.5,
                       jnp.float32)
    scales = calibrate_vit_scales(params, imgs, cfg)
    return cfg, params, imgs, scales


def test_ste_op_forward_matches_static_serving_matmul():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((6, 32)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((32, 16)), jnp.float32)
    b = jnp.asarray(rng.standard_normal((16,)), jnp.float32)
    xs = jnp.float32(float(np.abs(np.asarray(x)).max()) / 127.0)
    got = int8_linear_ste(x, w, b, xs, out_dtype=jnp.float32)
    want = int8_matmul_static(x, quantize_weight(w), xs, b,
                              out_dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_ste_op_backward_is_dense_linear():
    """The custom VJP returns exactly the dense linear's gradients
    (straight-through), for all three operands, including batched x."""
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 7, 32)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((32, 16)), jnp.float32)
    b = jnp.asarray(rng.standard_normal((16,)), jnp.float32)
    g = jnp.asarray(rng.standard_normal((2, 7, 16)), jnp.float32)
    xs = jnp.float32(0.02)

    def loss_ste(x, w, b):
        return jnp.sum(int8_linear_ste(x, w, b, xs,
                                       out_dtype=jnp.float32) * g)

    def loss_dense(x, w, b):
        return jnp.sum((x @ w + b) * g)

    gs = jax.grad(loss_ste, argnums=(0, 1, 2))(x, w, b)
    gd = jax.grad(loss_dense, argnums=(0, 1, 2))(x, w, b)
    for a, c in zip(gs, gd):
        np.testing.assert_allclose(np.asarray(a), np.asarray(c),
                                   rtol=1e-5, atol=1e-5)


def test_forward_matches_static_int8_serving(setup):
    """apply_int8_train's forward equals the PROVEN serving forward
    (apply_quantized on a static-calibrated tree built from the same
    params + scales)."""
    cfg, params, imgs, scales = setup
    got = apply_int8_train(params, imgs, cfg, scales, train=False)
    want = apply_quantized(quantize_vit_params(params, scales), imgs, cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-5)


def test_model_grad_cosine_vs_dense(setup):
    """Straight-through model gradients track the dense step's direction:
    per-leaf cosine similarity > 0.95 (the forward quantization error
    moves the evaluation point, so exact equality is not expected)."""
    cfg, params, imgs, scales = setup
    labels = jnp.asarray(
        np.random.default_rng(3).random((4, 5)) < 0.3, jnp.float32)

    def bce(logits):
        x, z = logits.astype(jnp.float32), labels
        return jnp.mean(jnp.maximum(x, 0) - x * z
                        + jnp.log1p(jnp.exp(-jnp.abs(x))))

    g_q = jax.grad(lambda p: bce(apply_int8_train(
        p, imgs, cfg, scales, train=True, rng=jax.random.key(1))))(params)
    g_d = jax.grad(lambda p: bce(vit.apply(
        p, imgs, cfg, train=True, rng=jax.random.key(1))))(params)
    flat_q = jax.tree_util.tree_flatten_with_path(g_q)[0]
    flat_d = jax.tree_util.tree_flatten_with_path(g_d)[0]
    for (path, a), (_, b) in zip(flat_q, flat_d):
        a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if nb < 1e-8 and na < 1e-8:
            # analytically-zero gradients (the key bias cancels in
            # softmax) — cosine of numerical noise is meaningless
            continue
        assert nb > 0, path
        cos = float(a @ b / (max(na, 1e-12) * nb))
        assert cos > 0.95, (jax.tree_util.keystr(path), cos)


def test_remat_grads_exact(setup):
    cfg, params, imgs, scales = setup
    cfg_r = _cfg(remat=True)
    labels_sum = lambda lg: jnp.sum(lg ** 2)

    g0 = jax.grad(lambda p: labels_sum(apply_int8_train(
        p, imgs, cfg, scales, train=True, rng=jax.random.key(2))))(params)
    g1 = jax.grad(lambda p: labels_sum(apply_int8_train(
        p, imgs, cfg_r, scales, train=True,
        rng=jax.random.key(2))))(params)
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_step_with_int8_scales(setup):
    """make_train_step(int8_scales=...) runs the full optimizer loop on
    the int8-STE forward: loss finite and decreasing on a fixed batch."""
    from chestxray_vit_tpu.config import Config, TrainConfig
    from chestxray_vit_tpu.parallel import mesh as mesh_lib
    from chestxray_vit_tpu.train import steps as S

    cfg_m, params, imgs, scales = setup
    # fresh leaves: device_put can alias same-device buffers, so feeding
    # the module fixture's tree to a DONATING jitted step would delete it
    # for every test that runs later (the round-4 bench.py bug, CLAUDE.md)
    params = jax.tree.map(jnp.array, params)
    cfg = Config(model=cfg_m, train=TrainConfig(learning_rate=2e-3))
    mesh = mesh_lib.build_mesh()
    step = S.jit_train_step(
        S.make_train_step(cfg, total_steps=100, int8_scales=scales),
        mesh, S.TrainState.create(params, seed=0))
    state = S.place_state(S.TrainState.create(params, seed=0), mesh)
    labels = jnp.asarray(
        np.random.default_rng(5).random((8, 5)) < 0.3, jnp.float32)
    batch = mesh_lib.shard_batch(mesh, {
        "pixel_values": jnp.concatenate([imgs, imgs]),
        "labels": labels})
    losses = []
    for _ in range(6):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_tome_int8_composed_forward_matches_serving(setup):
    """The composed int8+tome train forward (eval mode) equals the PROVEN
    int8+tome SERVING forward (apply_tome on a static-calibrated tree) —
    the same-quantization-math guarantee the plain int8-STE path pins in
    test_forward_matches_static_int8_serving."""
    from chestxray_vit_tpu.models.tome_forward import (
        apply_tome,
        apply_tome_train,
    )

    cfg, params, imgs, scales = setup
    got = apply_tome_train(params, imgs, cfg, 2, train=False,
                           schedule="decreasing", int8_scales=scales)
    want = apply_tome(quantize_vit_params(params, scales), imgs, cfg, 2,
                      quantized=True, schedule="decreasing")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-5)


def test_tome_int8_grad_cosine_vs_dense_tome(setup):
    """Composed-path gradients track the DENSE tome forward's direction
    (the merge routing is shared; only the projections are quantized)."""
    from chestxray_vit_tpu.models.tome_forward import apply_tome_train

    cfg, params, imgs, scales = setup
    labels = jnp.asarray(
        np.random.default_rng(7).random((4, 5)) < 0.3, jnp.float32)

    def bce(logits):
        x, z = logits.astype(jnp.float32), labels
        return jnp.mean(jnp.maximum(x, 0) - x * z
                        + jnp.log1p(jnp.exp(-jnp.abs(x))))

    g_q = jax.grad(lambda p: bce(apply_tome_train(
        p, imgs, cfg, 2, train=True, rng=jax.random.key(1),
        int8_scales=scales)))(params)
    g_d = jax.grad(lambda p: bce(apply_tome_train(
        p, imgs, cfg, 2, train=True, rng=jax.random.key(1))))(params)
    flat_q = jax.tree_util.tree_flatten_with_path(g_q)[0]
    flat_d = jax.tree_util.tree_flatten_with_path(g_d)[0]
    for (path, a), (_, b) in zip(flat_q, flat_d):
        a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if nb < 1e-8 and na < 1e-8:
            continue
        assert nb > 0, path
        cos = float(a @ b / (max(na, 1e-12) * nb))
        assert cos > 0.95, (jax.tree_util.keystr(path), cos)


def test_train_step_int8_scales_respects_tome_r(setup):
    """make_train_step(int8_scales=...) with model.tome_r set runs the
    COMPOSED forward — the combination used to silently drop tome_r and
    train un-merged. Pinned by logit equality against
    apply_tome_train(int8_scales=...) plus a training-progress check."""
    from chestxray_vit_tpu.config import Config, TrainConfig
    from chestxray_vit_tpu.models.tome_forward import apply_tome_train
    from chestxray_vit_tpu.parallel import mesh as mesh_lib
    from chestxray_vit_tpu.train import steps as S

    _, params, imgs, scales = setup
    # fresh leaves — the donating step must not eat the module fixture
    params = jax.tree.map(jnp.array, params)
    cfg_m = _cfg(tome_r=2, tome_schedule="decreasing")
    cfg = Config(model=cfg_m, train=TrainConfig(learning_rate=2e-3))
    mesh = mesh_lib.build_mesh()
    step = S.jit_train_step(
        S.make_train_step(cfg, total_steps=100, int8_scales=scales),
        mesh, S.TrainState.create(params, seed=0))
    state = S.place_state(S.TrainState.create(params, seed=0), mesh)
    labels = jnp.asarray(
        np.random.default_rng(5).random((8, 5)) < 0.3, jnp.float32)
    batch = mesh_lib.shard_batch(mesh, {
        "pixel_values": jnp.concatenate([imgs, imgs]),
        "labels": labels})

    # the step's first loss must be the COMPOSED forward's loss, not the
    # un-merged int8 forward's (both computed at the same params/rng)
    state0_rng = jax.random.key(0)  # TrainState.create(seed=0)
    _, step_rng = jax.random.split(state0_rng)

    def bce(logits):
        x, z = logits.astype(jnp.float32), labels
        return jnp.mean(jnp.maximum(x, 0) - x * z
                        + jnp.log1p(jnp.exp(-jnp.abs(x))))

    want_composed = float(bce(apply_tome_train(
        params, jnp.concatenate([imgs, imgs]), cfg_m, 2, train=True,
        rng=step_rng, schedule="decreasing", int8_scales=scales)))
    from chestxray_vit_tpu.models.int8_train import apply_int8_train
    want_unmerged = float(bce(apply_int8_train(
        params, jnp.concatenate([imgs, imgs]), cfg_m, scales, train=True,
        rng=step_rng)))

    losses = []
    for _ in range(6):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses[0], want_composed, rtol=1e-5)
    assert abs(losses[0] - want_unmerged) > 1e-7, \
        "step loss equals the un-merged forward — tome_r dropped again"
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
