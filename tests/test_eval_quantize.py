"""train.eval_quantize: evaluate()/predict() on the int8 serving forward.

Beyond the reference (its serving/eval speed story is an unshipped README
TODO); the knob reuses models/quantized.py, whose fidelity is oracle-pinned
in tests/test_quant.py — here we assert the Trainer plumbing: quantized
eval runs over the mesh, produces metrics that agree with the bf16 eval,
and recalibrates lazily per call from the live params.
"""

import numpy as np
import pytest

from chestxray_vit_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from chestxray_vit_tpu.data.testing import build_fake_nih
from chestxray_vit_tpu.train.trainer import Trainer


def _cfg(tmp_path, **train_kw) -> Config:
    train = dict(batch_size_per_core=2, learning_rate=2e-3, num_epochs=1,
                 eval_strategy="no", save_strategy="no",
                 logging_steps=50, output_dir=str(tmp_path / "out"),
                 report_to="none", seed=0)
    train.update(train_kw)
    return Config(
        data=DataConfig(backend="memory"),
        model=ModelConfig(img_size=64, patch_size=16, hidden_size=64,
                          num_layers=2, num_heads=4, mlp_dim=128,
                          dtype="float32", attention_impl="xla"),
        train=TrainConfig(**train),
    )


@pytest.fixture(scope="module")
def fake():
    return build_fake_nih(num_images=64, image_size=64, seed=7)


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_quantized_eval_matches_bf16_eval(tmp_path, fake, mode):
    cfg = _cfg(tmp_path)
    tr = Trainer(cfg, store=fake.store, pretrained=False)
    tr.train()
    base_logits, _, base_loss = tr._forward_all(tr.bundle.val)

    cfg.train.eval_quantize = mode
    q_logits, _, q_loss = tr._forward_all(tr.bundle.val)
    # int8 logits agree tightly with the bf16 eval forward (AUROC itself
    # is too rank-unstable on a 12-image val split to compare directly)
    corr = np.corrcoef(base_logits.ravel(), q_logits.ravel())[0, 1]
    assert corr > 0.999
    assert np.max(np.abs(base_logits - q_logits)) < 0.05
    assert np.isfinite(q_loss) and abs(q_loss - base_loss) < 0.05

    # evaluate()/predict() take the same path end-to-end
    ev = tr.evaluate()
    assert np.isfinite(ev["eval_loss"]) and 0.0 <= ev["avg_auroc"] <= 1.0
    logits, labels, test_metrics = tr.predict()
    assert logits.shape[0] == len(tr.bundle.test)
    assert np.isfinite(test_metrics["test_loss"])
    cfg.train.eval_quantize = None


def test_bad_mode_rejected(tmp_path, fake):
    cfg = _cfg(tmp_path, eval_quantize="int4")
    with pytest.raises(ValueError, match="eval_quantize"):
        Trainer(cfg, store=fake.store, pretrained=False)
    cfg2 = _cfg(tmp_path, eval_tome_r=-1)
    with pytest.raises(ValueError, match="eval_tome_r"):
        Trainer(cfg2, store=fake.store, pretrained=False)


@pytest.mark.parametrize("quantize", [None, "static"])
def test_eval_tome_tracks_full_eval(tmp_path, fake, quantize):
    """eval_tome_r runs evaluate()/predict() on the merged-token forward
    (optionally int8): logits track the full bf16 eval at small r."""
    cfg = _cfg(tmp_path)
    tr = Trainer(cfg, store=fake.store, pretrained=False)
    tr.train()
    base_logits, _, base_loss = tr._forward_all(tr.bundle.val)

    cfg.train.eval_quantize = quantize
    cfg.train.eval_tome_r = 1
    t_logits, _, t_loss = tr._forward_all(tr.bundle.val)
    assert t_logits.shape == base_logits.shape
    corr = np.corrcoef(base_logits.ravel(), t_logits.ravel())[0, 1]
    assert corr > 0.95, corr
    assert np.isfinite(t_loss)
    ev = tr.evaluate()
    assert np.isfinite(ev["eval_loss"]) and 0.0 <= ev["avg_auroc"] <= 1.0
    cfg.train.eval_quantize = None
    cfg.train.eval_tome_r = 0


def test_static_calibration_cached_per_params_version(tmp_path, fake):
    """Static scales are calibrated ONCE per params version:
    repeated eval calls at the same step reuse the identical int8 tree
    regardless of which batch is offered first, so quantized eval metrics
    cannot drift with eval-batch ordering; a new step recalibrates."""
    import jax.numpy as jnp

    cfg = _cfg(tmp_path, eval_quantize="static", max_steps=2,
               eval_batch_size_per_core=1)   # val split spans ≥2 batches
    tr = Trainer(cfg, store=fake.store, pretrained=False)
    tr.train()

    from chestxray_vit_tpu.data import pipeline as pipe
    from chestxray_vit_tpu.parallel import distributed as dist

    loader = tr._loader(tr.bundle.val, augment=False)
    placed = []
    for batch in pipe.iterate_batches(loader, tr.eval_batch, pad_last=True):
        batch.pop("num_valid", None)
        placed.append(dist.form_global_batch(tr.mesh, batch))
        # a second, differently-ordered batch (what a different eval-batch
        # ordering would offer the calibrator first)
        rolled = {k: np.roll(np.asarray(v), 3, axis=0)
                  for k, v in batch.items()}
        placed.append(dist.form_global_batch(tr.mesh, rolled))
        break

    q1, _ = tr._inference_eval(placed[0])
    q2, _ = tr._inference_eval(placed[1])   # different batch, same step
    assert q1 is q2

    # different params version → fresh calibration
    from chestxray_vit_tpu.train.steps import TrainState
    tr.state = TrainState(step=tr.state.step + 1, params=tr.state.params,
                          opt_state=tr.state.opt_state, rng=tr.state.rng)
    q3, _ = tr._inference_eval(placed[1])
    assert q3 is not q1
    tr.close()
