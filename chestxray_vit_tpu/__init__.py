"""chestxray_vit_tpu — a JAX framework for multi-label chest X-ray
classification with Vision Transformers, run on NVIDIA GPUs.

Built from scratch with the capabilities of the reference pipeline
(Sam1rShaban1/Chest-X-Ray-ViT: a torch_xla / HF-Trainer fine-tuning script for
google/vit-base-patch16-384 on NIH ChestX-ray14):

- single-process SPMD data parallelism over a ``jax.sharding.Mesh`` (the
  reference forks 8 processes via ``xmp.spawn``, ViT-Training.py:170),
- a from-scratch ViT whose attention runs as cuDNN fused attention on a
  GPU (the reference delegates to HF ``ViTForImageClassification``,
  ViT-Training.py:83),
- a host-overlap prefetching input pipeline with device-side fused
  preprocessing (the reference decodes per-sample with PIL inside
  ``Dataset.__getitem__`` and creates a fresh GCS client per item),
- on-device metrics (per-class AUROC, micro-F1) matching the reference's
  sklearn semantics,
- async Orbax checkpointing with retention and best-model tracking
  (the reference delegates to HF Trainer ``save_steps=500``).
"""

__version__ = "0.1.0"

from chestxray_vit_tpu.config import (  # noqa: F401
    Config,
    DataConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
    version_a_config,
    version_b_config,
)

_LAZY = {
    "Trainer": ("chestxray_vit_tpu.train.trainer", "Trainer"),
    "PackedTrainer": ("chestxray_vit_tpu.train.packed_trainer",
                      "PackedTrainer"),
    "Predictor": ("chestxray_vit_tpu.serve.inference", "Predictor"),
    "MicroBatcher": ("chestxray_vit_tpu.serve.batcher", "MicroBatcher"),
    "TrainState": ("chestxray_vit_tpu.train.steps", "TrainState"),
    "build_mesh": ("chestxray_vit_tpu.parallel.mesh", "build_mesh"),
    "build_datasets": ("chestxray_vit_tpu.data.pipeline", "build_datasets"),
    "attention": ("chestxray_vit_tpu.ops.attention", "attention"),
}


def __getattr__(name):
    """Lazy top-level API (keeps `import chestxray_vit_tpu` light — no jax
    device init until a component is actually used)."""
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
