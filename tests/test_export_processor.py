"""preprocessor_config.json parity: the reference
passes tokenizer=processor to Trainer (pyc L465-L472), so its save_model()
output dir loads end-to-end in HF INCLUDING preprocessing. Our export and
save_model must match: ViTImageProcessor.from_pretrained(dir) works and
produces the same pixels as our owned ImageProcessor."""

import json
import os

import numpy as np
import pytest

import jax

from chestxray_vit_tpu.config import ModelConfig
from chestxray_vit_tpu.models import vit
from chestxray_vit_tpu.models.export_hf import (
    export_hf_folder,
    write_preprocessor_config,
)


def _tiny_cfg():
    return ModelConfig(img_size=32, patch_size=16, hidden_size=16,
                       num_layers=1, num_heads=2, mlp_dim=32, num_classes=3)


def test_export_writes_processor_config(tmp_path):
    cfg = _tiny_cfg()
    params = vit.init_params(jax.random.key(0), cfg)
    export_hf_folder(str(tmp_path), params, cfg, ["a", "b", "c"])
    path = tmp_path / "preprocessor_config.json"
    assert path.exists()
    pc = json.loads(path.read_text())
    assert pc["image_processor_type"] == "ViTImageProcessor"
    assert pc["size"] == {"height": 32, "width": 32}
    assert pc["image_mean"] == [0.5, 0.5, 0.5]


def test_hf_processor_loads_and_matches_ours(tmp_path):
    transformers = pytest.importorskip("transformers")
    write_preprocessor_config(str(tmp_path), 384)
    proc = transformers.ViTImageProcessor.from_pretrained(str(tmp_path))

    from chestxray_vit_tpu.data.processor import ImageProcessor
    ours = ImageProcessor()

    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (500, 430, 3), np.uint8)
    theirs = proc(images=[img], return_tensors="np")["pixel_values"]
    got = ours(images=[img])["pixel_values"]
    np.testing.assert_allclose(got, theirs, atol=1e-5)


def test_trainer_save_model_emits_processor_config(tmp_path):
    from chestxray_vit_tpu.config import Config, DataConfig, TrainConfig
    from chestxray_vit_tpu.data.testing import build_fake_nih
    from chestxray_vit_tpu.train.trainer import Trainer

    cfg = Config(
        data=DataConfig(backend="memory"),
        model=ModelConfig(img_size=64, patch_size=16, hidden_size=32,
                          num_layers=1, num_heads=2, mlp_dim=64,
                          dtype="float32", attention_impl="xla"),
        train=TrainConfig(output_dir=str(tmp_path / "out"),
                          report_to="none"))
    fake = build_fake_nih(num_images=30, image_size=64, seed=1)
    tr = Trainer(cfg, store=fake.store, pretrained=False)
    tr.save_model()
    tr.close()
    pc_path = os.path.join(str(tmp_path / "out"), "model",
                           "preprocessor_config.json")
    assert os.path.exists(pc_path)
    pc = json.load(open(pc_path))
    assert pc["size"] == {"height": 64, "width": 64}
