"""Headline benchmark: ViT-B/16 @384 fine-tune throughput (images/sec/chip).

Runs the full jitted train step (forward + backward + AdamW, bf16
activations, cuDNN fused attention) on the GPUs JAX finds and prints ONE
JSON line: the dense step and two token-merging steps, each as images/s
per chip with MFU against the card's dense bf16 peak (utils/flops). The
line names the card, its power limit and the peak used. Without a GPU the
benchmark exits non-zero and prints no result.

    python bench.py [batch_per_chip]      # default 36
"""

import json
import sys
import time

import numpy as np


def main() -> None:
    import jax
    import jax.numpy as jnp

    from chestxray_vit_tpu.config import Config, ModelConfig, TrainConfig
    from chestxray_vit_tpu.models import vit
    from chestxray_vit_tpu.parallel import mesh as mesh_lib
    from chestxray_vit_tpu.train import steps as S
    from chestxray_vit_tpu.utils import device as D
    from chestxray_vit_tpu.utils import flops as F
    from chestxray_vit_tpu.utils.compilation_cache import (
        enable_compilation_cache)

    dev = D.require_gpu()
    card = D.card_line()
    enable_compilation_cache()
    facts = D.run_facts()
    peak = F.chip_peak_flops(dev["kind"])

    n_chips = len(jax.devices())
    batch_per_chip = int(sys.argv[1]) if len(sys.argv) > 1 else 36
    # batch 36 with full remat above 32 was sized for a 16 GB accelerator;
    # re-sweeping it for 80 GB is ROADMAP Speed item 5
    remat = batch_per_chip > 32

    mesh = mesh_lib.build_mesh()
    rng = np.random.default_rng(0)
    b = batch_per_chip * n_chips
    batch = mesh_lib.shard_batch(mesh, {
        "pixel_values": jnp.asarray(
            rng.standard_normal((b, 384, 384, 3)), jnp.float32),
        "labels": jnp.asarray((rng.random((b, 15)) < 0.2), jnp.float32),
    })

    def time_step(model_cfg: ModelConfig, iters: int = 20) -> float:
        """img/s/chip over ``iters`` steps after 3 warm-up steps.

        Fresh params per config: the jitted step donates its state, so a
        reused tree raises "Array has been deleted" on the card."""
        cfg = Config(model=model_cfg, train=TrainConfig())
        params = vit.init_params(jax.random.key(0), cfg.model)
        state = S.place_state(S.TrainState.create(params, seed=42), mesh)
        step = S.jit_train_step(
            S.make_train_step(cfg, total_steps=10_000), mesh, state)
        for _ in range(3):
            state, m = step(state, batch)
        jax.block_until_ready((state, m))
        t0 = time.perf_counter()
        for _ in range(iters):
            state, m = step(state, batch)
        jax.block_until_ready((state, m))
        dt = (time.perf_counter() - t0) / iters
        if not np.isfinite(float(m["loss"])):
            raise FloatingPointError(f"non-finite loss {float(m['loss'])}")
        return b / dt / n_chips

    dense_cfg = ModelConfig(num_classes=15, remat=remat)
    dense = time_step(dense_cfg)
    tome16 = time_step(ModelConfig(num_classes=15, remat=remat, tome_r=16))
    tome32d = time_step(ModelConfig(num_classes=15, remat=remat, tome_r=32,
                                    tome_schedule="decreasing"))
    flops_img = F.model_flops_per_image(dense_cfg)
    print(json.dumps({
        "metric": "images/sec/chip (ViT-B/16 @384 fine-tune step, bf16)",
        "value": round(dense, 2),
        "unit": "images/sec/chip",
        "mfu": round(dense * flops_img / peak, 4),
        "flops_per_image": round(flops_img / 1e9, 1),
        "batch_per_chip": batch_per_chip,
        "chip_peak_tflops": round(peak / 1e12, 1),
        "card": card,
        "device": dev,
        "jax": facts["jax"],
        "xla_flags": facts["xla_flags"],
        # token-merging train steps: same metric, fewer tokens per layer
        # (MFU is not reported for them: their FLOPs per image differ)
        "tome16_value": round(tome16, 2),
        "tome32dec_value": round(tome32d, 2),
    }))


if __name__ == "__main__":
    main()
