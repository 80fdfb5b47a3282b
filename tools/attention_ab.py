"""Attention A/B on the card: cuDNN fused attention against XLA attention.

Times each candidate inside the whole jitted program, at ViT-B/16 @384
widths, in turns (cudnn, xla, xla, cudnn) within one process:

- the dense train step at the smoke's batch (version_b: 8 per card);
- the serving forward (bf16 ``vit.apply``) at the Predictor's batch (8);
- the packed train step (2 x 576-token images per 1152-token row).

Each timing is the mean of ``ITERS`` calls after 3 warm-up calls, ended
with ``block_until_ready``. Prints one JSON line per measurement and a
summary line labelled with the card. Needs a GPU.

    python tools/attention_ab.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(call, carry, iters):
    """Mean seconds per ``carry = call(carry)`` after 3 warm-up calls."""
    import jax

    for _ in range(3):
        carry = call(carry)
    jax.block_until_ready(carry)
    t0 = time.perf_counter()
    for _ in range(iters):
        carry = call(carry)
    jax.block_until_ready(carry)
    return (time.perf_counter() - t0) / iters


ITERS = 20
PACKED_ROWS = 8


def main() -> None:
    import jax
    import jax.numpy as jnp

    from chestxray_vit_tpu.config import Config, ModelConfig, TrainConfig
    from chestxray_vit_tpu.data import packing as pk
    from chestxray_vit_tpu.models import vit
    from chestxray_vit_tpu.parallel import mesh as mesh_lib
    from chestxray_vit_tpu.train import steps as S
    from chestxray_vit_tpu.utils import device as D
    from chestxray_vit_tpu.utils.compilation_cache import (
        enable_compilation_cache)

    dev = D.require_gpu()
    card = D.card_line()
    enable_compilation_cache()
    rng = np.random.default_rng(0)
    mesh = mesh_lib.build_mesh()
    b = 8
    dense_batch = mesh_lib.shard_batch(mesh, {
        "pixel_values_u8": rng.integers(0, 256, (b, 384, 384), np.uint8),
        "labels": (rng.random((b, 15)) < 0.2).astype(np.float32)})
    images = jnp.asarray(rng.standard_normal((b, 384, 384, 3)), jnp.bfloat16)
    n_img = 2 * PACKED_ROWS
    pb = pk.pack_images(
        [rng.integers(0, 255, (384, 384), np.uint8) for _ in range(n_img)],
        [(rng.random(15) < 0.2).astype(np.float32) for _ in range(n_img)],
        patch=16, seq_len=1152, max_imgs_per_seq=2)
    packed_batch = {k: jnp.asarray(getattr(pb, k)) for k in (
        "tokens", "segment_ids", "pos_indices", "pool_weights", "labels",
        "image_mask")}

    def model(impl):
        return ModelConfig(num_classes=15, attention_impl=impl)

    def train_step(impl):
        cfg = Config(model=model(impl), train=TrainConfig())
        state = S.place_state(S.TrainState.create(
            vit.init_params(jax.random.key(0), cfg.model), 0), mesh)
        step = S.jit_train_step(S.make_train_step(cfg, 10_000), mesh, state)
        return timed(lambda s: step(s, dense_batch)[0], state, ITERS)

    def serve_forward(impl):
        cfg = model(impl)
        params = vit.init_params(jax.random.key(0), cfg)
        fwd = jax.jit(lambda p, x: vit.apply(p, x, cfg))
        return timed(lambda _: fwd(params, images), None, ITERS)

    def packed_step(impl):
        cfg = Config(model=model(impl), train=TrainConfig())
        state = S.TrainState.create(
            vit.init_params(jax.random.key(0), cfg.model), 0)
        step = jax.jit(S.make_packed_train_step(cfg, 10_000),
                       donate_argnums=(0,))
        return timed(lambda s: step(s, packed_batch)[0], state, ITERS)

    cells = {"train_b8": (train_step, b), "serve_b8": (serve_forward, b),
             f"packed_train_{PACKED_ROWS}x1152": (packed_step, n_img)}
    results = {}
    for cell, (fn, n) in cells.items():
        for impl in ("cudnn", "xla", "xla", "cudnn"):
            try:
                dt = fn(impl)
            except Exception as e:                       # noqa: BLE001
                print(json.dumps({"cell": cell, "impl": impl,
                                  "error": f"{type(e).__name__}: "
                                           f"{str(e)[:300]}"}), flush=True)
                continue
            results.setdefault(cell, {}).setdefault(impl, []).append(dt)
            print(json.dumps({"cell": cell, "impl": impl,
                              "ms": dt * 1e3, "images_per_s": n / dt}),
                  flush=True)
    print(json.dumps({"card": card, "device": dev, "jax": jax.__version__,
                      "ms": {c: {i: [round(t * 1e3, 3) for t in ts]
                                 for i, ts in r.items()}
                             for c, r in results.items()}}))


if __name__ == "__main__":
    main()
