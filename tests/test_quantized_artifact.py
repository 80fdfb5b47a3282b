"""int8 artifact: save_quantized/load_quantized round-trip, Predictor
auto-load in from_model_dir, and the `cli quantize` subcommand.

Beyond the reference (its serving story is an unshipped README TODO):
quantize once, serve many — cold starts skip the quantize pass and the
static calibration forward, and the artifact is ~4× smaller than f32.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chestxray_vit_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from chestxray_vit_tpu.models import vit
from chestxray_vit_tpu.models.quantized import (
    apply_quantized,
    calibrate_vit_scales,
    load_quantized,
    quantize_vit_params,
    save_quantized,
)


def _small_cfg():
    return ModelConfig(img_size=32, patch_size=8, hidden_size=64,
                       num_heads=4, num_layers=2, mlp_dim=128,
                       num_classes=5, remat=False, attention_impl="xla",
                       dtype="float32")


@pytest.mark.parametrize("static", [False, True])
def test_roundtrip_exact(tmp_path, static):
    cfg = _small_cfg()
    params = vit.init_params(jax.random.key(1), cfg)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 32, 32, 3)), jnp.float32)
    scales = calibrate_vit_scales(params, x, cfg) if static else None
    qp = quantize_vit_params(params, scales)
    d = save_quantized(str(tmp_path / "q"), qp)
    meta = json.load(open(os.path.join(d, "quantized.json")))
    assert meta["mode"] == ("static" if static else "dynamic")
    qp2 = load_quantized(d, cfg)
    np.testing.assert_array_equal(
        np.asarray(apply_quantized(qp, x, cfg)),
        np.asarray(apply_quantized(qp2, x, cfg)))


def test_geometry_mismatch_raises(tmp_path):
    cfg = _small_cfg()
    qp = quantize_vit_params(vit.init_params(jax.random.key(0), cfg))
    d = save_quantized(str(tmp_path / "q"), qp)
    bad = _small_cfg()
    bad.hidden_size, bad.mlp_dim = 32, 64
    with pytest.raises(ValueError, match="shape"):
        load_quantized(d, bad)


def _saved_model(tmp_path):
    """A real Trainer save_model() directory on the fake bucket."""
    from chestxray_vit_tpu.data.testing import build_fake_nih
    from chestxray_vit_tpu.train.trainer import Trainer
    cfg = Config(
        data=DataConfig(backend="memory", use_subset_data=24),
        model=ModelConfig(img_size=64, patch_size=16, hidden_size=64,
                          num_layers=2, num_heads=4, mlp_dim=128,
                          dtype="float32", attention_impl="xla"),
        train=TrainConfig(batch_size_per_core=2, num_epochs=1,
                          eval_strategy="no", save_strategy="no",
                          output_dir=str(tmp_path / "out"),
                          report_to="none", seed=0))
    fake = build_fake_nih(num_images=32, image_size=64, seed=3)
    tr = Trainer(cfg, store=fake.store, pretrained=False)
    tr.train()
    tr.save_model()
    tr.close()
    return os.path.join(str(tmp_path / "out"), "model")


def test_cli_quantize_and_predictor_autoload(tmp_path):
    from chestxray_vit_tpu.cli import main as cli_main
    from chestxray_vit_tpu.serve.inference import Predictor

    model_dir = _saved_model(tmp_path)
    assert cli_main(["quantize", "--model-dir", model_dir,
                     "--mode", "static"]) == 0
    qdir = os.path.join(model_dir, "quantized")
    assert os.path.exists(os.path.join(qdir, "qparams.npz"))

    # from_model_dir must LOAD the artifact, not re-quantize: poison the
    # artifact's head bias and check the prediction reflects it
    data = dict(np.load(os.path.join(qdir, "qparams.npz")))
    key = [k for k in data if "head" in k and "bias" in k][0]
    data[key] = data[key] + 7.0
    np.savez(os.path.join(qdir, "qparams.npz"), **data)

    pred = Predictor.from_model_dir(model_dir, batch_size=2,
                                    quantize="static")
    png = _png_bytes()
    probs = pred.predict_bytes([png]).probs[0]
    assert np.all(probs > 0.9)            # logits shifted by +7 → ~1.0

    # requesting dynamic with a static artifact quantizes on the fly
    # (no poisoned weights)
    pred2 = Predictor.from_model_dir(model_dir, batch_size=2,
                                     quantize="dynamic")
    probs2 = pred2.predict_bytes([png]).probs[0]
    assert not np.all(probs2 > 0.9)

    # a retrain invalidates the artifact: break the stored fingerprint
    # and the (poisoned) artifact must be IGNORED — fresh re-quantize
    meta_path = os.path.join(qdir, "quantized.json")
    meta = json.load(open(meta_path))
    assert meta.get("fingerprint")            # cli quantize stored one
    meta["fingerprint"] = "0" * 32
    json.dump(meta, open(meta_path, "w"))
    pred3 = Predictor.from_model_dir(model_dir, batch_size=2,
                                     quantize="static")
    probs3 = pred3.predict_bytes([png]).probs[0]
    assert not np.all(probs3 > 0.9)


def test_prebuilt_mode_mismatch_raises():
    from chestxray_vit_tpu.serve.inference import Predictor
    cfg = _small_cfg()
    params = vit.init_params(jax.random.key(0), cfg)
    qp = quantize_vit_params(params)      # dynamic tree
    with pytest.raises(ValueError, match="dynamic"):
        Predictor(params, cfg, quantize="static", qparams=qp)


def _png_bytes(size=96):
    import io

    from PIL import Image
    rng = np.random.default_rng(5)
    img = Image.fromarray(rng.integers(0, 255, (size, size),
                                       np.uint8), "L")
    buf = io.BytesIO()
    img.save(buf, "PNG")
    return buf.getvalue()


def test_fingerprint_covers_every_leaf():
    """model_fingerprint samples EVERY leaf: a
    fine-tune that touches ONLY an encoder block — frozen-head
    linear-probe schedules, partial updates — must invalidate the
    artifact, as must tiny perturbations anywhere else."""
    from chestxray_vit_tpu.models.quantized import model_fingerprint

    cfg = _small_cfg()
    params = vit.init_params(jax.random.key(2), cfg)
    base = model_fingerprint(params)
    assert base == model_fingerprint(params)        # deterministic

    def mutated(path_keys, bump):
        p = jax.tree.map(lambda a: a, params)       # shallow-ish copy
        node = p
        for k in path_keys[:-1]:
            node[k] = dict(node[k])
            node = node[k]
        node[path_keys[-1]] = node[path_keys[-1]] + bump
        return p

    # encoder-block-only change (the old 4-leaf hash's blind spot)
    enc = mutated(("blocks", "mlp_out", "kernel"), 1e-3)
    assert model_fingerprint(enc) != base
    # a single-element change in a large leaf still registers via the
    # strided sample's dense head
    p2 = jax.tree.map(lambda a: a, params)
    p2["blocks"] = dict(p2["blocks"])
    p2["blocks"]["wq"] = dict(p2["blocks"]["wq"])
    k = np.asarray(p2["blocks"]["wq"]["kernel"]).copy()
    k[0, 0, 0] += 1.0
    p2["blocks"]["wq"]["kernel"] = jnp.asarray(k)
    assert model_fingerprint(p2) != base
    # every other top-level leaf class too
    for path in (("head", "kernel"), ("pos_embed",), ("cls_token",),
                 ("final_ln", "scale"), ("patch_embed", "kernel")):
        assert model_fingerprint(mutated(path, 1e-3)) != base, path
