"""Fixed-seed golden-run regression.

The oracle tests pin individual components; this pins the COMPOSITION: a
20-step deterministic fine-tune on the synthetic NIH bucket through the
full Trainer stack (metadata → split → decode → augment → sharded train
step → AdamW → eval metrics), f32 on the 8-device CPU mesh. Any silent
numerics drift — optimizer math, label engine ordering, augmentation RNG
discipline, sharding — moves the trajectory and fails here even when every
unit oracle still passes.

Golden values recorded 2026-08-17 (jax 0.9.0, CPU f32, seed 0). A small
tolerance absorbs reduction-order noise across XLA versions; a real drift
is orders of magnitude larger.
"""

import json

import numpy as np

from chestxray_vit_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from chestxray_vit_tpu.data.testing import build_fake_nih
from chestxray_vit_tpu.train.trainer import Trainer

GOLDEN = {}

try:
    import os
    with open(os.path.join(os.path.dirname(__file__),
                           "golden_run.json")) as f:
        GOLDEN = json.load(f)
except FileNotFoundError:
    pass


def _run(tmp_path, tome_r: int = 0, tome_schedule: str = "constant",
         keep_trainer: bool = False, num_layers: int = 4):
    cfg = Config(
        data=DataConfig(backend="memory", augment=True),
        model=ModelConfig(img_size=64, patch_size=16, hidden_size=64,
                          num_layers=num_layers, num_heads=4, mlp_dim=256,
                          dtype="float32", attention_impl="xla",
                          tome_r=tome_r, tome_schedule=tome_schedule),
        train=TrainConfig(batch_size_per_core=2, learning_rate=1e-3,
                          max_steps=20, eval_strategy="no",
                          save_strategy="steps", save_steps=10_000,
                          load_best_model_at_end=False, logging_steps=1,
                          output_dir=str(tmp_path / "golden"),
                          report_to="none", seed=0),
    )
    fake = build_fake_nih(num_images=120, image_size=64, seed=17)
    tr = Trainer(cfg, store=fake.store, pretrained=False)
    tr.train()
    ev = tr.evaluate()
    losses = []
    with open(tmp_path / "golden" / "metrics.jsonl") as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("prefix") == "train":
                losses.append(rec["loss"])
    if keep_trainer:
        return losses, ev, tr
    tr.close()
    return losses, ev


def _agreement_stats(tr):
    """Pinned logit-agreement of the accelerated eval paths vs the dense
    eval on the SAME trained params (drift in eval_quantize/eval_tome
    must fail CI, not just stay 'above 0.999')."""
    base, _, _ = tr._forward_all(tr.bundle.val)

    tr.cfg.train.eval_quantize = "static"
    quant, _, _ = tr._forward_all(tr.bundle.val)
    tr.cfg.train.eval_quantize = None

    tr.cfg.train.eval_tome_r = 2
    tome, _, _ = tr._forward_all(tr.bundle.val)
    tr.cfg.train.eval_tome_r = 0

    def stats(other):
        return {
            "corr": float(np.corrcoef(base.ravel(), other.ravel())[0, 1]),
            "mean_abs": float(np.mean(np.abs(base - other))),
        }

    return {"quant": stats(quant), "tome": stats(tome)}


def test_golden_trajectory(tmp_path):
    assert GOLDEN, "tests/golden_run.json missing — regenerate with " \
                   "tools/make_golden.py"
    losses, ev = _run(tmp_path)
    assert len(losses) == 20
    np.testing.assert_allclose(losses, GOLDEN["losses"], rtol=5e-4,
                               err_msg="loss trajectory drifted from the "
                               "golden run — a numerics change landed "
                               "somewhere in the training stack")
    np.testing.assert_allclose(ev["avg_auroc"], GOLDEN["avg_auroc"],
                               atol=5e-3)
    np.testing.assert_allclose(ev["eval_loss"], GOLDEN["eval_loss"],
                               rtol=5e-4)


def test_golden_tome_trajectory(tmp_path):
    """The token-merging TRAIN step (model.tome_r) has its own pinned
    trajectory — the fidelity gate for training with merging on: the
    merged model must keep learning on the
    same data at a pinned loss path, and any silent numerics drift in
    the differentiable merge fails here."""
    assert GOLDEN.get("tome_losses"), \
        "tests/golden_run.json lacks tome pins — tools/make_golden.py"
    losses, ev = _run(tmp_path, tome_r=2)
    assert len(losses) == 20
    np.testing.assert_allclose(losses, GOLDEN["tome_losses"], rtol=5e-4,
                               err_msg="tome train trajectory drifted")
    np.testing.assert_allclose(ev["avg_auroc"], GOLDEN["tome_avg_auroc"],
                               atol=5e-3)
    np.testing.assert_allclose(ev["eval_loss"], GOLDEN["tome_eval_loss"],
                               rtol=5e-4)
    # the merged model genuinely trains: final loss well below initial
    assert losses[-1] < 0.75 * losses[0]


def test_golden_tome_decreasing_trajectory(tmp_path):
    """The decreasing schedule (the measured-best train recipe —
    README "Quality") gets its own pinned
    trajectory: schedule-math or routing drift fails here even when the
    constant-schedule pin stays green."""
    assert GOLDEN.get("tome_dec_losses"), \
        "tests/golden_run.json lacks tome_dec pins — tools/make_golden.py"
    losses, ev = _run(tmp_path, tome_r=2, tome_schedule="decreasing")
    assert len(losses) == 20
    np.testing.assert_allclose(losses, GOLDEN["tome_dec_losses"], rtol=5e-4,
                               err_msg="decreasing-schedule trajectory "
                                       "drifted")
    np.testing.assert_allclose(ev["avg_auroc"], GOLDEN["tome_dec_avg_auroc"],
                               atol=5e-3)
    np.testing.assert_allclose(ev["eval_loss"], GOLDEN["tome_dec_eval_loss"],
                               rtol=5e-4)
    assert losses[-1] < 0.75 * losses[0]
    # and it genuinely differs from the constant schedule's pinned path
    assert not np.allclose(losses, GOLDEN["tome_losses"], rtol=1e-6)


def test_golden_deep_stack_trajectory(tmp_path):
    """32-layer (ViT-H-depth) fidelity anchor under a CLAMPED decreasing
    schedule (depth-scaling claims need quality evidence at depth, not
    just throughput).
    tome_r=1 over 32 layers budgets 32 merges against only 16 mergeable
    tokens (img 64/16 -> 17 tokens), so the per-layer feasibility clamp
    binds mid-stack — exactly the regime of the ViT-H r=8 and ViT-L r=32
    rows. The pin asserts a deep stack under the binding clamp still
    trains on a fixed trajectory."""
    assert GOLDEN.get("deep_losses"), \
        "tests/golden_run.json lacks deep-stack pins — tools/make_golden.py"
    losses, ev = _run(tmp_path, tome_r=1, tome_schedule="decreasing",
                      num_layers=32)
    assert len(losses) == 20
    np.testing.assert_allclose(losses, GOLDEN["deep_losses"], rtol=5e-4,
                               err_msg="deep-stack clamped-schedule "
                                       "trajectory drifted")
    np.testing.assert_allclose(ev["avg_auroc"], GOLDEN["deep_avg_auroc"],
                               atol=5e-3)
    np.testing.assert_allclose(ev["eval_loss"], GOLDEN["deep_eval_loss"],
                               rtol=5e-4)
    assert losses[-1] < 0.75 * losses[0]


def test_golden_accelerated_eval_agreement(tmp_path):
    """eval_quantize=static and eval_tome_r logit agreement vs the dense
    eval, pinned (not just thresholded) on the golden-trained params."""
    assert GOLDEN.get("agreement"), \
        "tests/golden_run.json lacks agreement pins — tools/make_golden.py"
    _, _, tr = _run(tmp_path, keep_trainer=True)
    got = _agreement_stats(tr)
    tr.close()
    for path, want in GOLDEN["agreement"].items():
        np.testing.assert_allclose(
            got[path]["corr"], want["corr"], atol=2e-3,
            err_msg=f"{path} eval corr drifted")
        np.testing.assert_allclose(
            got[path]["mean_abs"], want["mean_abs"], rtol=0.25,
            err_msg=f"{path} eval mean|Δlogit| drifted")
