"""Token merging during TRAINING (model.tome_r).

The serving merge math is oracle-pinned in tests/test_tome.py; here we
pin the training story: gradient correctness of the routing-matmul merge
against the independent gather/scatter formulation, remat exactness,
dispatch consistency (vit.apply delegates so the whole Trainer stack
composes), end-to-end Trainer training, and the fail-fast composition
rules with the packed trainer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chestxray_vit_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from chestxray_vit_tpu.models import vit
from chestxray_vit_tpu.models.tome_forward import apply_tome, apply_tome_train
from chestxray_vit_tpu.ops.tome import (
    bipartite_soft_matching,
    merge_tokens,
    tome_merge,
)


def _model_cfg(**kw) -> ModelConfig:
    base = dict(img_size=64, patch_size=16, hidden_size=64, num_layers=3,
                num_heads=4, mlp_dim=128, num_classes=5, dtype="float32",
                attention_impl="xla")
    base.update(kw)
    return ModelConfig(**base)


@pytest.fixture(scope="module")
def tiny():
    cfg = _model_cfg(tome_r=4)
    params = vit.init_params(jax.random.key(0), cfg)
    rng = np.random.default_rng(0)
    imgs = jnp.asarray(rng.standard_normal((4, 64, 64, 3)), jnp.float32)
    return cfg, params, imgs


def test_merge_grad_oracle():
    """Gradients through the fused routing-matmul merge equal gradients
    through the independent gather/scatter composition (two different
    computational graphs for the same function) — the differentiability
    claim behind training with ToMe, checked not assumed."""
    rng = np.random.default_rng(1)
    b, s, d, r = 2, 17, 8, 5
    x = jnp.asarray(rng.standard_normal((b, s, d)), jnp.float32)
    metric = jnp.asarray(rng.standard_normal((b, s, d)), jnp.float32)
    sizes = jnp.asarray(rng.integers(1, 4, (b, s)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((b, s - r, d)), jnp.float32)

    def loss_fused(x):
        out, _ = tome_merge(x, metric, sizes, r)
        return jnp.sum(out * w)

    def loss_ref(x):
        out, _ = merge_tokens(x, sizes,
                              *bipartite_soft_matching(metric, r))
        return jnp.sum(out * w)

    np.testing.assert_allclose(np.asarray(loss_fused(x)),
                               np.asarray(loss_ref(x)), rtol=1e-5)
    g_fused = jax.grad(loss_fused)(x)
    g_ref = jax.grad(loss_ref)(x)
    np.testing.assert_allclose(np.asarray(g_fused), np.asarray(g_ref),
                               atol=1e-5)
    # grads also flow through the metric-weighted path when x IS the
    # metric (the train forward merges x on the keys' matching)
    g_joint = jax.grad(lambda y: jnp.sum(tome_merge(y, y, sizes, r)[0] * w))(x)
    assert bool(jnp.isfinite(g_joint).all())


def test_apply_dispatch_and_eval_consistency(tiny):
    """vit.apply with cfg.tome_r delegates: train=False equals the dense
    serving tome forward (the model evaluated IS the model trained)."""
    cfg, params, imgs = tiny
    got = vit.apply(params, imgs, cfg, train=False)
    want = apply_tome(params, imgs, cfg, r=cfg.tome_r, quantized=False)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-6)
    # r=0 config keeps the plain scan forward (bit-path unchanged)
    cfg0 = _model_cfg(tome_r=0)
    plain = vit.apply(params, imgs, cfg0, train=False)
    assert plain.shape == got.shape
    assert float(jnp.abs(plain - got).max()) > 1e-4  # merging does merge


def test_remat_grads_exact(tiny):
    """Per-block jax.checkpoint on the unrolled tome forward recomputes
    the identical graph: grads bit-equal to the no-remat forward."""
    cfg, params, imgs = tiny
    cfg_r = _model_cfg(tome_r=4, remat=True)

    def loss(p, c):
        lg = vit.apply(p, imgs, c, train=True, rng=jax.random.key(3))
        return jnp.sum(lg ** 2)

    g0 = jax.grad(lambda p: loss(p, cfg))(params)
    g1 = jax.grad(lambda p: loss(p, cfg_r))(params)
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_grads_flow_to_every_leaf(tiny):
    cfg, params, imgs = tiny

    def loss(p):
        lg = vit.apply(p, imgs, cfg, train=True, rng=jax.random.key(1))
        return jnp.sum(lg ** 2)

    g = jax.grad(loss)(params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
        assert bool(jnp.isfinite(leaf).all()), path
        assert float(jnp.abs(leaf).max()) > 0.0, (
            f"zero gradient at {jax.tree_util.keystr(path)} — the merge "
            f"broke the chain")


def test_fused_qkv_rejected(tiny):
    cfg, params, imgs = tiny
    bad = _model_cfg(tome_r=4, fused_qkv=True)
    with pytest.raises(ValueError, match="fused_qkv"):
        apply_tome_train(params, imgs, bad, 4)


def test_trainer_trains_with_tome(tmp_path):
    """End-to-end: Trainer with model.tome_r trains (finite, moving
    loss), evaluates and predicts through the merged forward."""
    from chestxray_vit_tpu.data.testing import build_fake_nih
    from chestxray_vit_tpu.train.trainer import Trainer

    cfg = Config(
        data=DataConfig(backend="memory"),
        model=_model_cfg(num_classes=15, num_layers=2, tome_r=3),
        train=TrainConfig(batch_size_per_core=2, learning_rate=2e-3,
                          max_steps=4, eval_strategy="no",
                          save_strategy="no", logging_steps=1,
                          load_best_model_at_end=False,
                          output_dir=str(tmp_path / "out"),
                          report_to="none", seed=0),
    )
    fake = build_fake_nih(num_images=48, image_size=64, seed=11)
    tr = Trainer(cfg, store=fake.store, pretrained=False)
    metrics = tr.train()
    assert metrics["train_steps"] == 4
    ev = tr.evaluate()
    assert np.isfinite(ev["eval_loss"]) and 0.0 <= ev["avg_auroc"] <= 1.0
    logits, labels, test_metrics = tr.predict()
    assert logits.shape[1] == 15 and np.isfinite(test_metrics["test_loss"])
    tr.close()


def test_tome_warmup_dispatch(tmp_path):
    """train.tome_warmup (the measured init-sensitivity rescue — README
    "Quality"): steps below the warmup boundary run the DENSE
    step function bit-for-bit, later steps run the merged one. Proven by
    trajectory identity: a merged config with warmup >= max_steps ends at
    exactly the dense run's params; warmup=0 ends elsewhere; a partial
    warmup ends at a third point (and still trains finite)."""
    from chestxray_vit_tpu.data.testing import build_fake_nih
    from chestxray_vit_tpu.train.trainer import Trainer

    fake = build_fake_nih(num_images=48, image_size=64, seed=11)

    def run(tome_r, warmup):
        cfg = Config(
            data=DataConfig(backend="memory"),
            model=_model_cfg(num_classes=15, num_layers=2, tome_r=tome_r),
            train=TrainConfig(batch_size_per_core=2, learning_rate=2e-3,
                              max_steps=3, eval_strategy="no",
                              save_strategy="no", logging_steps=1,
                              load_best_model_at_end=False,
                              tome_warmup=warmup,
                              output_dir=str(tmp_path / f"o{tome_r}.{warmup}"),
                              report_to="none", seed=0),
        )
        tr = Trainer(cfg, store=fake.store, pretrained=False)
        tr.train()
        flat = np.concatenate([np.asarray(x).ravel()
                               for x in jax.tree.leaves(tr.state.params)])
        tr.close()
        return flat

    dense = run(0, 0)
    full_warm = run(3, 3)          # every step inside the warmup window
    merged = run(3, 0)
    partial = run(3, 1)
    np.testing.assert_array_equal(dense, full_warm)
    assert not np.allclose(dense, merged)
    assert not np.allclose(partial, merged)
    assert not np.allclose(partial, dense)
    assert np.isfinite(partial).all()
    # a fraction in (0, 1) resolves against total_steps at construction:
    # 1/3 of max_steps=3 is the same boundary as warmup=1, bit-for-bit
    frac = run(3, 1 / 3)
    np.testing.assert_array_equal(partial, frac)


def test_tome_warmup_validation(tmp_path):
    """tome_warmup fail-fasts: negative, or set without model.tome_r
    (the silent-knob-no-op pattern is banned)."""
    from chestxray_vit_tpu.data.testing import build_fake_nih
    from chestxray_vit_tpu.train.trainer import Trainer

    fake = build_fake_nih(num_images=16, image_size=64, seed=3)

    def cfg(tome_r, warmup):
        return Config(
            data=DataConfig(backend="memory"),
            model=_model_cfg(num_classes=15, num_layers=2, tome_r=tome_r),
            train=TrainConfig(batch_size_per_core=2, max_steps=1,
                              eval_strategy="no", save_strategy="no",
                              load_best_model_at_end=False,
                              tome_warmup=warmup,
                              output_dir=str(tmp_path / "out"),
                              report_to="none", seed=0),
        )

    with pytest.raises(ValueError, match="tome_warmup"):
        Trainer(cfg(0, 5), store=fake.store, pretrained=False)
    with pytest.raises(ValueError, match="tome_warmup"):
        Trainer(cfg(3, -1), store=fake.store, pretrained=False)
    # >= 1 must be an integral step count (1.5 steps is meaningless;
    # fractions of total_steps live in (0, 1))
    with pytest.raises(ValueError, match="tome_warmup"):
        Trainer(cfg(3, 1.5), store=fake.store, pretrained=False)


def test_merged_floor_hint():
    """The mid-run floor check productizes the measured bad-mode
    signature (README "Quality", the quality A/B: the failed inits are
    still at their starting avg_auroc floor past ~60% of the schedule).
    Pure-function behavior: fires only for merged, warmup-free training
    that shows no metric progress past the threshold fraction."""
    from chestxray_vit_tpu.train.trainer import merged_floor_hint

    flat = [(300, 0.745), (600, 0.728), (900, 0.742), (1500, 0.751)]
    takeoff = [(300, 0.745), (600, 0.748), (900, 0.861), (1500, 0.942)]

    # the bad-mode signature: merged, no warmup, flat past 60%
    hint = merged_floor_hint(flat, 1500, 2400, tome_r=32, warmup_steps=0)
    assert hint and "tome_warmup" in hint
    # healthy takeoff: no hint
    assert merged_floor_hint(takeoff, 1500, 2400, 32, 0) is None
    # dense training: inapplicable
    assert merged_floor_hint(flat, 1500, 2400, 0, 0) is None
    # warmup already configured (the rescue): inapplicable
    assert merged_floor_hint(flat, 1500, 2400, 32, 900) is None
    # too early in the schedule to judge
    assert merged_floor_hint(flat, 900, 2400, 32, 0) is None
    # not enough evals to compare
    assert merged_floor_hint(flat[:1], 1500, 2400, 32, 0) is None


def test_packed_trainer_rejects_tome_and_accel_eval(tmp_path):
    """Fail-fast composition rules: the packed
    trainer rejects the accelerated-eval knobs at construction instead
    of silently ignoring them. (model.tome_r composes since round 5 —
    see tests/test_packed_tome.py::test_packed_trainer_composes_with_tome.)"""
    from chestxray_vit_tpu.data.testing import build_fake_nih
    from chestxray_vit_tpu.train.packed_trainer import PackedTrainer

    fake = build_fake_nih(num_images=16, image_size=64, seed=3)

    def cfg(**kw):
        model = dict(img_size=64, patch_size=16, hidden_size=64,
                     num_layers=2, num_heads=4, mlp_dim=128,
                     dtype="float32", attention_impl="xla")
        train = dict(learning_rate=1e-3, max_steps=2, eval_strategy="no",
                     save_strategy="no", logging_steps=1,
                     load_best_model_at_end=False,
                     output_dir=str(tmp_path / "out"), report_to="none")
        model.update(kw.get("model", {}))
        train.update(kw.get("train", {}))
        return Config(data=DataConfig(backend="memory"),
                      model=ModelConfig(**model),
                      train=TrainConfig(**train))

    with pytest.raises(ValueError, match="eval_quantize"):
        PackedTrainer(cfg(train={"eval_quantize": "static"}), seq_len=48,
                      grids=(4,), batch_seqs=8, store=fake.store,
                      pretrained=False)
    with pytest.raises(ValueError, match="eval_tome_r"):
        PackedTrainer(cfg(train={"eval_tome_r": 4}), seq_len=48,
                      grids=(4,), batch_seqs=8, store=fake.store,
                      pretrained=False)


def test_tome_model_eval_consistency_rules(tmp_path):
    """model.tome_r composes with eval_quantize (the accelerated eval
    inherits the model's r, scoring the SAME merged function) and rejects
    a conflicting eval_tome_r."""
    from chestxray_vit_tpu.data.testing import build_fake_nih
    from chestxray_vit_tpu.train.trainer import Trainer

    fake = build_fake_nih(num_images=48, image_size=64, seed=11)

    def cfg(**train_kw):
        train = dict(batch_size_per_core=2, learning_rate=2e-3,
                     max_steps=2, eval_strategy="no", save_strategy="no",
                     logging_steps=1, load_best_model_at_end=False,
                     output_dir=str(tmp_path / "out"), report_to="none",
                     seed=0)
        train.update(train_kw)
        return Config(data=DataConfig(backend="memory"),
                      model=_model_cfg(num_classes=15, num_layers=2,
                                       tome_r=3),
                      train=TrainConfig(**train))

    with pytest.raises(ValueError, match="conflicts with model.tome_r"):
        Trainer(cfg(eval_tome_r=5), store=fake.store, pretrained=False)

    # eval_quantize inherits r=3: int8 merged eval tracks the bf16 merged
    # eval on the same trained params
    tr = Trainer(cfg(), store=fake.store, pretrained=False)
    tr.train()
    base_logits, _, _ = tr._forward_all(tr.bundle.val)
    tr.cfg.train.eval_quantize = "static"
    q_logits, _, _ = tr._forward_all(tr.bundle.val)
    tr.cfg.train.eval_quantize = None
    corr = np.corrcoef(base_logits.ravel(), q_logits.ravel())[0, 1]
    assert corr > 0.999, corr
    tr.close()


def test_decreasing_schedule_forwards(tiny):
    """tome_schedule='decreasing' (ops/tome.r_schedule): both forwards
    run with the front-loaded per-layer budget, produce finite logits
    distinct from the constant schedule's, end at the same token
    bottom-line (same r·L total merged), and gradients stay finite."""
    cfg, params, imgs = tiny

    const = apply_tome(params, imgs, cfg, r=4)
    decr = apply_tome(params, imgs, cfg, r=4, schedule="decreasing")
    assert np.isfinite(np.asarray(decr)).all()
    assert not np.allclose(np.asarray(const), np.asarray(decr))

    # training dispatch honors model.tome_schedule through vit.apply
    cfg_d = _model_cfg(tome_r=4, tome_schedule="decreasing")
    via_apply = vit.apply(params, imgs, cfg_d, train=False)
    direct = apply_tome_train(params, imgs, cfg_d, 4, train=False,
                              schedule="decreasing")
    np.testing.assert_allclose(np.asarray(via_apply), np.asarray(direct),
                               atol=1e-5)

    def loss(p):
        return jnp.sum(vit.apply(p, imgs, cfg_d, train=False) ** 2)

    grads = jax.grad(loss)(params)
    flat = jax.tree.leaves(grads)
    assert all(np.isfinite(np.asarray(g)).all() for g in flat)
    assert any(float(jnp.abs(g).sum()) > 0 for g in flat)


def test_bad_schedule_rejected():
    with pytest.raises(ValueError, match="tome_schedule"):
        _model_cfg(tome_r=4, tome_schedule="linear")
