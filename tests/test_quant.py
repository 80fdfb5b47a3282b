"""int8 serving path: quantization math oracles + end-to-end fidelity of
the quantized ViT forward vs the f32 model (models/quantized.py,
ops/quant.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chestxray_vit_tpu.config import ModelConfig
from chestxray_vit_tpu.models import vit
from chestxray_vit_tpu.models.quantized import (
    apply_quantized,
    calibrate_vit_scales,
    quantize_vit_params,
)
from chestxray_vit_tpu.ops import quant as Q


def test_quantize_weight_matches_numpy_oracle():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    qw = Q.quantize_weight(jnp.asarray(w))
    scale = np.maximum(np.abs(w).max(axis=0), 1e-8) / 127.0
    np.testing.assert_allclose(np.asarray(qw.scale), scale, rtol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(qw.q),
        np.clip(np.round(w / scale), -127, 127).astype(np.int8))
    # reconstruction error bounded by half a quantization step per entry
    err = np.abs(np.asarray(Q.dequantize(qw)) - w)
    assert (err <= scale[None, :] * 0.5 + 1e-7).all()


def test_int8_matmul_close_to_f32():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((8, 96, 64)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((64, 48)), jnp.float32)
    b = jnp.asarray(rng.standard_normal((48,)), jnp.float32)
    got = np.asarray(Q.int8_matmul(x, Q.quantize_weight(w), b,
                                   out_dtype=jnp.float32))
    want = np.asarray(x @ w + b)
    # int8 × int8 with per-token/per-channel scales on gaussian data:
    # quantization noise accumulates over the 64-dim contraction — judge
    # by normalized RMS (≈1%) and correlation, not per-element worst case
    rms = np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2))
    assert rms < 0.02, rms
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


def _cfg():
    return ModelConfig(img_size=64, patch_size=16, hidden_size=64,
                       num_layers=4, num_heads=4, mlp_dim=256,
                       num_classes=15, dtype="float32",
                       attention_impl="xla")


def test_quantized_forward_tracks_f32_model():
    cfg = _cfg()
    params = vit.init_params(jax.random.key(0), cfg)
    images = jax.random.normal(jax.random.key(1), (8, 64, 64, 3))
    f32 = np.asarray(vit.apply(params, images, cfg))
    q8 = np.asarray(apply_quantized(quantize_vit_params(params), images,
                                    cfg))
    assert q8.shape == f32.shape
    # logits track closely and rankings survive quantization
    assert np.corrcoef(q8.ravel(), f32.ravel())[0, 1] > 0.995
    top_f32 = f32.argmax(axis=1)
    top_q8 = q8.argmax(axis=1)
    assert (top_f32 == top_q8).mean() >= 0.75
    # probabilities within a few points
    p32 = 1.0 / (1.0 + np.exp(-f32))
    p8 = 1.0 / (1.0 + np.exp(-q8))
    assert np.abs(p32 - p8).max() < 0.1


def test_int8_matmul_static_matches_numpy_oracle():
    rng = np.random.default_rng(7)
    x = np.asarray(rng.standard_normal((5, 32, 24)), np.float32)
    w = np.asarray(rng.standard_normal((24, 16)), np.float32)
    b = np.asarray(rng.standard_normal((16,)), np.float32)
    xs = np.float32(np.abs(x).max() / 127.0)
    qw = Q.quantize_weight(jnp.asarray(w))
    got = np.asarray(Q.int8_matmul_static(
        jnp.asarray(x), qw, jnp.float32(xs), jnp.asarray(b),
        out_dtype=jnp.float32))
    xq = np.clip(np.round(x / xs), -127, 127).astype(np.int32)
    want = (xq @ np.asarray(qw.q, np.int32)).astype(np.float32)
    want = want * (xs * np.asarray(qw.scale)) + b
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_int8_matmul_static_saturates_beyond_calibration():
    # values past the calibration range clip at ±127 — by design
    x = jnp.asarray([[1.0, -1000.0]], jnp.float32)
    w = jnp.asarray(np.eye(2), jnp.float32)
    qw = Q.quantize_weight(w)
    y = np.asarray(Q.int8_matmul_static(x, qw, jnp.float32(1.0 / 127.0),
                                        out_dtype=jnp.float32))
    np.testing.assert_allclose(y[0, 0], 1.0, atol=0.01)
    np.testing.assert_allclose(y[0, 1], -1.0, atol=0.01)  # saturated


def test_static_quantized_forward_tracks_f32_model():
    cfg = _cfg()
    params = vit.init_params(jax.random.key(0), cfg)
    images = jax.random.normal(jax.random.key(1), (8, 64, 64, 3))
    f32 = np.asarray(vit.apply(params, images, cfg))
    # calibrate on a DIFFERENT batch than the one evaluated
    calib = jax.random.normal(jax.random.key(9), (8, 64, 64, 3))
    scales = calibrate_vit_scales(params, calib, cfg)
    # shape contract: one scalar per site per layer
    for site in ("attn_in", "attn_out", "mlp_in", "mlp_mid"):
        assert scales["blocks"][site].shape == (cfg.num_layers,)
    q8 = np.asarray(apply_quantized(quantize_vit_params(params, scales),
                                    images, cfg))
    assert np.corrcoef(q8.ravel(), f32.ravel())[0, 1] > 0.995
    p32 = 1.0 / (1.0 + np.exp(-f32))
    p8 = 1.0 / (1.0 + np.exp(-q8))
    assert np.abs(p32 - p8).max() < 0.1


def test_predictor_quantize_static(tmp_path):
    from chestxray_vit_tpu.serve.inference import Predictor
    cfg = _cfg()
    params = vit.init_params(jax.random.key(2), cfg)
    rng = np.random.default_rng(3)
    grays = [rng.integers(0, 255, (96, 80), np.uint8) for _ in range(3)]

    base = Predictor(params, cfg, batch_size=4)
    # synthetic-calibration fallback (no calibration images passed)
    quant = Predictor(params, cfg, batch_size=4, quantize="static")
    assert quant.quantize_mode == "static"
    a = base.predict_arrays(grays)
    b = quant.predict_arrays(grays)
    assert np.abs(a.probs - b.probs).max() < 0.1
    # explicit calibration images route through the same preprocessing
    quant2 = Predictor(params, cfg, batch_size=4, quantize="static",
                       calibration=grays)
    c = quant2.predict_arrays(grays)
    assert np.abs(a.probs - c.probs).max() < 0.1


def test_predictor_quantize_mode_validation():
    import pytest
    from chestxray_vit_tpu.serve.inference import Predictor
    cfg = _cfg()
    params = vit.init_params(jax.random.key(2), cfg)
    with pytest.raises(ValueError, match="quantize"):
        Predictor(params, cfg, quantize="int4")


def test_predictor_quantize_flag(tmp_path):
    from chestxray_vit_tpu.serve.inference import Predictor
    cfg = _cfg()
    params = vit.init_params(jax.random.key(2), cfg)
    rng = np.random.default_rng(3)
    grays = [rng.integers(0, 255, (96, 80), np.uint8) for _ in range(3)]

    base = Predictor(params, cfg, batch_size=4)
    quant = Predictor(params, cfg, batch_size=4, quantize=True)
    a = base.predict_arrays(grays)
    b = quant.predict_arrays(grays)
    assert b.probs.shape == a.probs.shape
    assert np.abs(a.probs - b.probs).max() < 0.1


@pytest.mark.gpu
def test_static_int8_forward_on_gpu(gpu):
    """XLA's int8 dot_general on the card at ViT-B/16 @384 widths: the
    static-int8 forward tracks the f32 forward (matmuls at "highest"), and
    the compiled program really contracts int8 operands."""
    cfg = ModelConfig(num_classes=15)
    params = vit.init_params(jax.random.key(0), cfg)
    images = jax.random.normal(jax.random.key(1), (4, 384, 384, 3))
    calib = jax.random.normal(jax.random.key(9), (4, 384, 384, 3))
    qp = quantize_vit_params(params, calibrate_vit_scales(params, calib,
                                                          cfg))
    fwd = jax.jit(lambda p, x: apply_quantized(p, x, cfg))
    assert "xi8>" in fwd.lower(qp, images).as_text()
    q8 = np.asarray(fwd(qp, images))
    f32_cfg = ModelConfig(num_classes=15, dtype="float32",
                          attention_impl="xla")
    with jax.default_matmul_precision("highest"):
        f32 = np.asarray(jax.jit(lambda p, x: vit.apply(p, x, f32_cfg))(
            params, images))
    assert np.isfinite(q8).all()
    assert np.corrcoef(q8.ravel(), f32.ravel())[0, 1] > 0.99
    p32 = 1.0 / (1.0 + np.exp(-f32))
    p8 = 1.0 / (1.0 + np.exp(-q8))
    assert np.abs(p32 - p8).max() < 0.1
