"""The minimum end-to-end slice (SURVEY §7):
synthetic-NIH fine-tune on the 8-device CPU mesh with eval, checkpointing,
best-restore, resume, and prediction report."""

import os

import numpy as np
import pytest

from chestxray_vit_tpu.config import Config, DataConfig, MeshConfig, ModelConfig, TrainConfig
from chestxray_vit_tpu.data.testing import build_fake_nih
from chestxray_vit_tpu.train.trainer import Trainer


def _cfg(tmp_path, **train_kw) -> Config:
    train = dict(batch_size_per_core=2, learning_rate=2e-3, num_epochs=3,
                 eval_strategy="epoch", save_strategy="epoch",
                 logging_steps=5, output_dir=str(tmp_path / "out"),
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
    return build_fake_nih(num_images=80, image_size=64, seed=11)


def test_full_train_eval_predict_cycle(tmp_path, fake):
    cfg = _cfg(tmp_path)
    tr = Trainer(cfg, store=fake.store, pretrained=False)
    assert cfg.model.num_classes == 15       # data-derived
    train_metrics = tr.train()
    assert train_metrics["train_steps"] == tr.total_steps
    ev = tr.evaluate()
    assert 0.0 <= ev["avg_auroc"] <= 1.0 and np.isfinite(ev["eval_loss"])
    # the synthetic data is learnable: better than chance
    assert ev["avg_auroc"] > 0.5

    logits, labels, test_metrics = tr.predict(
        report_path=str(tmp_path / "report.txt"))
    assert logits.shape[0] == len(tr.bundle.test) == labels.shape[0]
    assert os.path.exists(tmp_path / "report.txt")

    tr.save_model()
    assert os.path.exists(tmp_path / "out" / "model" / "classes.json")
    # results files (log_metrics/save_metrics parity)
    tr.logger.save_results("eval", ev)
    assert os.path.exists(tmp_path / "out" / "eval_results.json")

    # trainer_state.json parity (reference calls save_state, pyc L485)
    import json
    path = tr.save_state()
    state = json.load(open(path))
    # total_steps is the lr-schedule horizon (an estimate of steps/epoch);
    # global_step is the truth of what actually ran
    assert state["global_step"] == int(tr.state.step)
    assert state["max_steps"] == tr.total_steps
    assert len(state["log_history"]) > 0
    assert any("loss" in rec for rec in state["log_history"])
    assert any(k.startswith("eval_") for rec in state["log_history"]
               for k in rec)
    # best checkpoint recorded with its metric value
    assert state["best_model_checkpoint"] is not None
    assert state["best_metric"] is not None
    tr.close()


def test_checkpoint_resume_continues_exactly(tmp_path, fake):
    # run 1: stop after 4 steps (max_steps), saving every 2
    cfg = _cfg(tmp_path, max_steps=4, save_strategy="steps", save_steps=2,
               eval_strategy="no", load_best_model_at_end=False)
    tr1 = Trainer(cfg, store=fake.store, pretrained=False)
    tr1.train()
    assert int(tr1.state.step) == 4
    tr1.ckpt.wait()
    assert tr1.ckpt.latest_step() == 4
    tr1.close()

    # run 2: resume to 8 steps
    cfg2 = _cfg(tmp_path, max_steps=8, save_strategy="steps", save_steps=2,
                eval_strategy="no", load_best_model_at_end=False,
                resume_from_checkpoint="auto")
    tr2 = Trainer(cfg2, store=fake.store, pretrained=False)
    tr2.train()
    assert int(tr2.state.step) == 8
    tr2.close()


def test_trainer_on_8dev_mesh(tmp_path, fake):
    import jax
    assert len(jax.devices()) == 8
    cfg = _cfg(tmp_path, max_steps=3, eval_strategy="no",
               save_strategy="steps", save_steps=100,
               load_best_model_at_end=False)
    cfg.mesh = MeshConfig()          # data=-1 → all 8 devices
    tr = Trainer(cfg, store=fake.store, pretrained=False)
    assert tr.mesh.shape["data"] == 8
    assert tr.global_batch == 16     # 2 per core × 8
    tr.train()
    assert int(tr.state.step) == 3
    tr.close()


def test_best_model_restored_at_end(tmp_path, fake):
    cfg = _cfg(tmp_path, num_epochs=2, eval_strategy="epoch",
               save_strategy="epoch", load_best_model_at_end=True)
    tr = Trainer(cfg, store=fake.store, pretrained=False)
    tr.train()
    # after train() the loaded state is the best checkpoint's step
    best = tr.ckpt.best_step()
    assert best is not None
    assert int(tr.state.step) == best
    tr.close()


def test_mid_epoch_cursor_skip(tmp_path, fake):
    """_train_batches(skip=k) resumes mid-epoch: yields exactly the batches
    after the cursor, same content as an unskipped epoch's tail."""
    cfg = _cfg(tmp_path)
    tr = Trainer(cfg, store=fake.store, pretrained=False)
    full = [b["labels"] for b in tr._train_batches(epoch=0, skip=0)]
    tail = [b["labels"] for b in tr._train_batches(epoch=0, skip=2)]
    assert len(tail) == len(full) - 2
    for a, b in zip(full[2:], tail):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tr.close()


def test_learns_synthetic_signal_to_high_auroc(tmp_path):
    """Longer fine-tune on the synthetic class-coded images: avg_auroc must
    clear 0.75 — exercises the full loop's learning quality, not just
    mechanics (the 14-label AUC parity goal, scaled down)."""
    strong = build_fake_nih(num_images=240, image_size=64, seed=5,
                            bbox_fraction=0.0)   # keep signal geometry fixed
    cfg = _cfg(tmp_path, num_epochs=60, learning_rate=1e-3,
               weight_decay=0.0, warmup_steps=20,
               batch_size_per_core=2, eval_strategy="no",
               save_strategy="steps", save_steps=10_000,
               load_best_model_at_end=False, logging_steps=200)
    cfg.model.num_layers = 2
    cfg.model.hidden_size = 128
    cfg.model.mlp_dim = 256
    cfg.data.use_bbox_roi = False      # identity geometry for this check
    tr = Trainer(cfg, store=strong.store, pretrained=False)
    tr.train()
    ev = tr.evaluate(tr.bundle.test)   # largest split → stable AUC
    tr.close()
    assert ev["avg_auroc"] > 0.7, ev


def test_zero_batch_config_raises(tmp_path, fake):
    """Global batch larger than the train split must fail loudly, not spin."""
    cfg = _cfg(tmp_path, batch_size_per_core=1000, max_steps=10)
    tr = Trainer(cfg, store=fake.store, pretrained=False)
    with pytest.raises(ValueError, match="zero"):
        tr.train()
    tr.close()


def test_empty_eval_is_graceful(tmp_path, fake):
    cfg = _cfg(tmp_path)
    cfg.data.use_subset_data = 4          # val = 4 // 5 = 0 samples
    tr = Trainer(cfg, store=fake.store, pretrained=False)
    ev = tr.evaluate()
    assert ev["avg_auroc"] == 0.0 and ev["f1_micro"] == 0.0
    tr.close()


def test_prefetcher_surfaces_producer_errors(fake):
    from chestxray_vit_tpu.data.pipeline import DevicePrefetcher

    def boom():
        yield {"x": np.zeros(1)}
        raise RuntimeError("producer died")

    it = DevicePrefetcher(boom(), place_fn=lambda b: b, depth=2)
    assert next(it)["x"].shape == (1,)
    with pytest.raises(RuntimeError, match="producer died"):
        next(it)


def test_compilation_cache_populated(tmp_path, fake, persistent_cache):
    """compilation_cache_dir persists compiled executables across runs."""
    cache = tmp_path / "xla_cache"
    cfg = _cfg(tmp_path, max_steps=1, eval_strategy="no", save_strategy="no",
               load_best_model_at_end=False,
               compilation_cache_dir=str(cache))
    tr = Trainer(cfg, store=fake.store, pretrained=False)
    tr.train()
    tr.close()
    entries = os.listdir(cache)
    assert entries, "compilation cache directory is empty after training"
    # the big train-step executable must be among the cached entries
    assert any("train_step" in e for e in entries), entries


def test_trainer_logs_no_mfu_without_a_known_peak(tmp_path, fake):
    """On a device the peak table does not know (the CPU here) the live log
    carries images/s but no MFU: a guessed peak would be a made-up number."""
    import json
    cfg = _cfg(tmp_path, max_steps=2, logging_steps=1, eval_strategy="no",
               save_strategy="no", load_best_model_at_end=False)
    tr = Trainer(cfg, store=fake.store, pretrained=False)
    assert tr._chip_peak is None
    tr.train()
    tr.close()
    with open(os.path.join(cfg.train.output_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if r["prefix"] == "train"]
    assert len(train) == 2
    assert all("images_per_sec" in r and "mfu" not in r for r in train)
    # saving off: no checkpoint directory was ever opened
    assert not os.path.exists(os.path.join(cfg.train.output_dir,
                                           "checkpoints"))
