"""chip_smoke.py on the CPU: it refuses to report without a GPU, and its
phases run end to end at tiny widths (the card runs them at ViT-B/16)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from chestxray_vit_tpu.config import ModelConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(**kw):
    return ModelConfig(img_size=32, patch_size=16, hidden_size=32,
                       num_layers=2, num_heads=2, mlp_dim=64,
                       num_classes=15, **kw)


def _run(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_a_gpu():
    r = _run(REPO, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "no GPU" in r.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(tmp_path, "chip_smoke.py")
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_array_split_speaks_the_loader_protocol():
    tr, va, te, classes = cs.synthetic_splits(6, 3, 32, seed=0)
    assert len(tr) == 6 and len(va) == 3 and te is va and len(classes) == 15
    assert tr.index is tr and tr.augment is False
    row = tr.load(4)
    assert row["pixel_values_u8"].shape == (32, 32)
    assert row["pixel_values_u8"].dtype == np.uint8
    assert row["labels"].shape == (15,) and row["labels"].sum() >= 1
    again, _, _, _ = cs.synthetic_splits(6, 3, 32, seed=0)
    np.testing.assert_array_equal(again.images, tr.images)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("smoke"))
    model = _tiny()
    splits = cs.synthetic_splits(40, 16, 32, seed=0)
    cfg = cs.smoke_config(model, steps=2, batch=2, out_dir=out)
    return model, splits, cs.phase_train(cfg, splits, timed_steps=2)


def test_phase_train_and_hlo(trained):
    model, _, tr = trained
    assert int(tr["trainer"].state.step) == 2 + 2 + 2  # train, warm, timed
    assert len(tr["losses"]) == 2 and np.isfinite(tr["losses"]).all()
    assert {"avg_auroc", "f1_micro", "eval_loss"} <= set(tr["eval"])
    assert tr["step_s"] > 0 and tr["compile_s"] > 0
    assert cs.phase_hlo(tr["hlo"], "xla") == "xla"
    with pytest.raises(AssertionError, match="cuDNN"):
        cs.phase_hlo(tr["hlo"], "cudnn")


def test_phase_reference_within_tolerances(trained):
    model, splits, tr = trained
    from chestxray_vit_tpu.ops.preprocess import normalize_u8
    out = cs.phase_reference(model, normalize_u8(splits[1].images[:4]))
    assert set(out) == {"attn_fwd", "attn_grad", "logits"}
    assert all(0 <= v <= 5e-2 for v in out.values())


def test_phase_serve_bf16_and_int8(trained):
    model, splits, tr = trained
    out = cs.phase_serve(tr["trainer"].state.params, model, splits[3],
                         list(splits[1].images[:5]))
    assert 0 <= out["int8_vs_bf16_prob"] <= cs.INT8_PROB_TOL


def test_phase_four_cards_matches_one_device():
    out = cs.phase_four_cards(_tiny(), per_device_batch=2)
    assert set(out) == {"single_device", "data", "data_fsdp"}
    for name in ("data", "data_fsdp"):
        assert out[name]["max_delta"] <= cs.SHARDED_LOSS_TOL
    json.dumps(out)                     # printed as one JSON object
