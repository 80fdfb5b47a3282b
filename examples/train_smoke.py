"""Smallest end-to-end example: synthetic NIH bucket → fine-tune → eval →
predictions with attention maps. Runs anywhere (CPU or GPU), no data needed.

    python examples/train_smoke.py
"""

import numpy as np

from chestxray_vit_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from chestxray_vit_tpu.data.testing import build_fake_nih
from chestxray_vit_tpu.serve.inference import Predictor
from chestxray_vit_tpu.train.trainer import Trainer


def main() -> None:
    fake = build_fake_nih(num_images=96, image_size=64)
    cfg = Config(
        data=DataConfig(backend="memory"),
        model=ModelConfig(img_size=64, patch_size=16, hidden_size=64,
                          num_layers=2, num_heads=4, mlp_dim=128),
        train=TrainConfig(batch_size_per_core=4, learning_rate=1e-3,
                          num_epochs=3, eval_strategy="epoch",
                          save_strategy="epoch", logging_steps=5,
                          output_dir="./smoke_outputs", report_to="none"),
    )
    trainer = Trainer(cfg, store=fake.store, pretrained=False)
    trainer.train()
    print("eval:", {k: round(v, 3) for k, v in trainer.evaluate().items()
                    if not k.startswith("auroc_")})
    trainer.save_model()
    trainer.close()

    pred = Predictor.from_model_dir("./smoke_outputs/model", batch_size=4)
    blob = fake.store.get("images_001/images/" + fake.image_names[0])
    out = pred.predict_bytes([blob], with_maps=True)
    print("top findings:", pred.top_findings(out.probs[0], k=3))
    print("attention map grid:", out.maps.shape)


if __name__ == "__main__":
    main()
