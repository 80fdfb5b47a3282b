"""Chip smoke test: the ViT-B/16 @384 train and serve path on one GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded train step
                                       # against one device, nothing else

One card, in one JAX process:

1. identify the card (``nvidia-smi`` name and power limit, JAX's device);
   no GPU -> exit non-zero, no result;
2. train: ``Trainer`` at full ViT-B/16 @384 width on seeded synthetic
   images for a few steps, then ``evaluate()``; steady-state step time
   (``block_until_ready``), compile time, images/s, MFU, peak memory;
3. the attention implementation found in the compiled train step's HLO;
4. the card against the plain float32 reference run at
   ``default_matmul_precision("highest")``: attention alone (forward and
   ``jax.grad``) and full-model logits, bf16 against f32;
5. serve: ``Predictor`` bf16 and static-int8 forwards on seeded images;
6. the tests marked ``gpu``, in this process.

The last line of standard output is the JSON result
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
any failed phase exits non-zero before it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Agreement bounds, each a max |card - reference| over max |reference|
# (PERF.md "Tolerances"). bf16 keeps 8 significant bits (2^-8 = 3.9e-3
# relative per rounding); a float32 matmul on the card would run in TF32
# unless a precision is named, so the reference names "highest".
# - attention forward: q, k, v, the probabilities and the output are each
#   rounded to bf16 once;
ATTN_FWD_TOL = 2e-2
# - attention gradients: two more bf16 products in the backward;
ATTN_GRAD_TOL = 5e-2
# - full-model logits: roundings compound over 12 residual blocks (XLA's
#   CPU bf16 forward sits at 7.9e-3 at these widths);
LOGITS_TOL = 5e-2
# - int8 serving: absolute probability difference, the bound the CPU tests
#   hold the int8 path to (tests/test_quant.py): per-channel int8 weights
#   and per-site static activation scales, ~1% per matmul over 72 matmuls.
INT8_PROB_TOL = 0.1
# - sharded train step: |loss| difference against one device, before and
#   after one update. Sharding reorders bf16 reductions and changes the
#   per-device batch XLA picks matmul algorithms for.
SHARDED_LOSS_TOL = 2e-3

STEPS = 5                      # Trainer steps of the train phase


class ArraySplit:
    """One split of seeded u8 images and multi-hot labels in the Trainer's
    ``datasets=`` loader protocol (``.index``, ``.augment``, ``.load``)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        self.images, self.labels = images, labels
        self.index = self
        self.augment = False

    def __len__(self) -> int:
        return len(self.images)

    def load(self, i: int, rng=None):
        return {"pixel_values_u8": self.images[i], "labels": self.labels[i]}


def synthetic_splits(n_train: int, n_val: int, img_size: int, seed: int):
    """(train, val, test, classes) adapters over the hard synthetic NIH
    task (``data.testing.render_array_dataset``)."""
    from chestxray_vit_tpu.config import NIH_CLASSES
    from chestxray_vit_tpu.data.testing import render_array_dataset

    tr = ArraySplit(*render_array_dataset(n_train, img_size, seed))
    va = ArraySplit(*render_array_dataset(n_val, img_size, seed + 1))
    return tr, va, va, list(NIH_CLASSES)


def smoke_config(model, steps: int, batch: int, out_dir: str):
    """version_b's training surface with saving and cadence evals off."""
    from chestxray_vit_tpu.config import version_b_config

    cfg = version_b_config()
    cfg.model = model
    t = cfg.train
    t.batch_size_per_core = batch
    t.max_steps = steps
    t.save_strategy = "no"
    t.eval_strategy = "no"
    t.load_best_model_at_end = False
    t.logging_steps = 1
    t.report_to = "none"
    t.output_dir = out_dir
    cfg.data.num_workers = 4
    return cfg


def rel_err(got, ref) -> float:
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-12))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_train(cfg, splits, timed_steps: int = 10) -> dict:
    """Train ``cfg.train.max_steps`` steps through ``Trainer.train()``,
    evaluate, then time the jitted step alone on one placed batch."""
    import jax

    from chestxray_vit_tpu.parallel import distributed as dist
    from chestxray_vit_tpu.train.trainer import Trainer

    trainer = Trainer(cfg, datasets=splits, pretrained=False)
    host = splits[0]
    rows = [host.load(i) for i in range(trainer.global_batch)]
    batch = dist.form_global_batch(trainer.mesh, {
        k: np.stack([r[k] for r in rows]) for k in rows[0]})

    t0 = time.perf_counter()
    compiled = trainer._train_step.lower(trainer.state, batch).compile()
    compile_s = time.perf_counter() - t0

    out = trainer.train()
    steps = int(trainer.state.step)
    check(steps == cfg.train.max_steps and out["train_steps"] == steps,
          f"trained {steps} steps, expected {cfg.train.max_steps}")
    with open(os.path.join(trainer.logger.output_dir, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f
                  if '"loss"' in line]
    losses = losses[-steps:]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"losses not finite: {losses}")
    ev = trainer.evaluate()
    check("avg_auroc" in ev and "f1_micro" in ev, f"eval keys {sorted(ev)}")
    check(np.isfinite(ev["eval_loss"]), f"eval_loss {ev['eval_loss']}")

    state = trainer.state
    for _ in range(2):
        state, m = trainer._train_step(state, batch)
    jax.block_until_ready((state, m))
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        state, m = trainer._train_step(state, batch)
    jax.block_until_ready((state, m))
    step_s = (time.perf_counter() - t0) / timed_steps
    trainer.state = state
    trainer.close()
    return {"trainer": trainer, "batch": batch, "hlo": compiled.as_text(),
            "compile_s": compile_s, "losses": losses, "eval": ev,
            "step_s": step_s,
            "images_per_s": trainer.global_batch / step_s}


def phase_hlo(hlo: str, impl: str) -> str:
    """The compiled train step's HLO must hold the attention ``impl``
    ('cudnn' or 'xla', as ``resolve_impl`` chose it) and no Pallas call
    (the custom-call targets of Pallas through Triton or Mosaic GPU)."""
    fused = "__cudnn$fmha" in hlo
    pallas = [k for k in ("__gpu$xla.gpu.triton", "mosaic_gpu") if k in hlo]
    check(not pallas, f"Pallas calls in the compiled step: {pallas}")
    if impl == "cudnn":
        check(fused, "cuDNN attention chosen but no __cudnn$fmha call "
                     "in the compiled step")
    else:
        check(not fused, "XLA attention chosen but the step calls cuDNN")
    return "cudnn (__cudnn$fmha custom calls)" if fused else "xla"


def phase_reference(model_cfg, images, seed: int = 0) -> dict:
    """bf16 on the configured attention against the float32 reference
    (XLA attention, matmuls at "highest"), at the widths of ``model_cfg``."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from chestxray_vit_tpu.models import vit
    from chestxray_vit_tpu.ops.attention import attention, attention_xla

    b = images.shape[0]
    h, s, d = model_cfg.num_heads, model_cfg.seq_len, model_cfg.head_dim
    q, k, v = (jax.random.normal(key, (b, h, s, d), jnp.float32)
               for key in jax.random.split(jax.random.key(seed), 3))
    impl = model_cfg.attention_impl

    def loss(fn):
        return lambda q, k, v: jnp.sum(
            fn(q, k, v).astype(jnp.float32) ** 2)

    fast = lambda q, k, v: attention(q, k, v, impl=impl)
    bf = [x.astype(jnp.bfloat16) for x in (q, k, v)]
    o = jax.jit(fast)(*bf)
    g = jax.jit(jax.grad(loss(fast), argnums=(0, 1, 2)))(*bf)
    with jax.default_matmul_precision("highest"):
        o_ref = jax.jit(attention_xla)(q, k, v)
        g_ref = jax.jit(jax.grad(loss(attention_xla),
                                 argnums=(0, 1, 2)))(q, k, v)
    out = {"attn_fwd": rel_err(o, o_ref),
           "attn_grad": max(rel_err(a, r) for a, r in zip(g, g_ref))}

    params = vit.init_params(jax.random.key(seed), model_cfg)
    ref_cfg = dataclasses.replace(model_cfg, dtype="float32",
                                  attention_impl="xla")
    logits = jax.jit(lambda p, x: vit.apply(p, x, model_cfg))(params, images)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p, x: vit.apply(p, x, ref_cfg))(params, images)
    out["logits"] = rel_err(logits, ref)
    check(np.isfinite(np.asarray(logits)).all(), "non-finite logits")
    check(out["attn_fwd"] <= ATTN_FWD_TOL, f"attention fwd {out}")
    check(out["attn_grad"] <= ATTN_GRAD_TOL, f"attention grad {out}")
    check(out["logits"] <= LOGITS_TOL, f"logits {out}")
    return out


def phase_serve(params, model_cfg, classes, grays) -> dict:
    """bf16 and static-int8 ``Predictor`` forwards on u8 grayscale images."""
    from chestxray_vit_tpu.serve.inference import Predictor

    bf16 = Predictor(params, model_cfg, classes, batch_size=8)
    int8 = Predictor(params, model_cfg, classes, batch_size=8,
                     quantize="static", calibration="synthetic")
    a = bf16.predict_arrays(grays)
    b = int8.predict_arrays(grays)
    n, c = len(grays), len(classes)
    for name, p in (("bf16", a.probs), ("int8", b.probs)):
        check(p.shape == (n, c) and np.isfinite(p).all(),
              f"{name} probabilities {p.shape}, finite "
              f"{np.isfinite(p).all()}")
    diff = float(np.max(np.abs(a.probs - b.probs)))
    check(diff <= INT8_PROB_TOL, f"int8 vs bf16 probabilities differ {diff}")
    return {"int8_vs_bf16_prob": diff}


def phase_gpu_tests() -> int:
    """The tests marked ``gpu``, run in this process (the card stays one
    process's)."""
    import pytest

    os.environ["CXR_TESTS_ON_DEVICE"] = "1"      # tests/conftest.py
    files = [os.path.join(REPO, "tests", f)
             for f in ("test_attention.py", "test_quant.py")]
    return int(pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                            "--rootdir", REPO, *files]))


def phase_four_cards(model_cfg, per_device_batch: int, n_devices: int = 4,
                     seed: int = 0) -> dict:
    """The sharded train step on ``data=n`` and ``data=n/2 x fsdp=2``
    against the same step on one device: loss before and after one update."""
    import jax
    import jax.numpy as jnp

    from chestxray_vit_tpu.config import Config, MeshConfig, TrainConfig
    from chestxray_vit_tpu.models import vit
    from chestxray_vit_tpu.parallel import mesh as mesh_lib
    from chestxray_vit_tpu.train import steps as S

    devices = jax.devices()[:n_devices]
    check(len(devices) == n_devices,
          f"{n_devices} devices needed, {len(jax.devices())} found")
    cfg = Config(model=model_cfg,
                 train=TrainConfig(batch_size_per_core=per_device_batch))
    b = per_device_batch * n_devices
    rng = np.random.default_rng(seed)
    img = model_cfg.img_size
    host = {"pixel_values_u8": rng.integers(0, 256, (b, img, img), np.uint8),
            "labels": (rng.random((b, model_cfg.num_classes)) < 0.2
                       ).astype(np.float32)}

    def two_steps(mesh):
        params = vit.init_params(jax.random.key(seed), model_cfg)
        state = S.TrainState.create(params, seed=seed)
        step = S.jit_train_step(S.make_train_step(cfg, total_steps=10),
                                mesh, state)
        state = S.place_state(state, mesh)
        batch = mesh_lib.shard_batch(mesh, host)
        state, m1 = step(state, batch)
        state, m2 = step(state, batch)
        return float(m1["loss"]), float(m2["loss"])

    one = mesh_lib.build_mesh(MeshConfig(data=1), devices=devices[:1])
    ref = two_steps(one)
    out = {"single_device": ref}
    for name, mcfg in (
            ("data", MeshConfig(data=n_devices)),
            ("data_fsdp", MeshConfig(data=n_devices // 2, fsdp=2))):
        got = two_steps(mesh_lib.build_mesh(mcfg, devices=devices))
        delta = max(abs(g - r) for g, r in zip(got, ref))
        check(all(np.isfinite(got)) and delta <= SHARDED_LOSS_TOL,
              f"{name}: losses {got} vs one device {ref}")
        out[name] = {"losses": got, "max_delta": delta}
    return out


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded train step on four cards")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the synthetic data")
    args = ap.parse_args(argv)

    from chestxray_vit_tpu.config import ModelConfig, version_b_config
    from chestxray_vit_tpu.utils import device as D
    from chestxray_vit_tpu.utils import flops as F
    from chestxray_vit_tpu.utils.compilation_cache import (
        enable_compilation_cache)

    dev = D.require_gpu()
    card = D.card_line()
    cache = enable_compilation_cache()
    facts = D.run_facts()
    print(f"card: {card}")
    print(f"jax {facts['jax']} platform={dev['platform']} "
          f"kind={dev['kind']!r} count={dev['count']} "
          f"XLA_FLAGS={facts['xla_flags']!r} compile cache={cache}",
          flush=True)
    batch = version_b_config().train.batch_size_per_core
    model = ModelConfig(num_classes=15)           # ViT-B/16 @384, bf16

    if args.four_cards:
        four = phase_four_cards(model, batch, seed=args.seed)
        print(f"four cards [{card}]: {json.dumps(four)}", flush=True)
        print(json.dumps({"ok": True, "device": dev}))
        return 0

    out_dir = os.path.join(REPO, "outputs", "chip_smoke")
    splits = synthetic_splits(max(6 * batch, 40), 4 * batch, model.img_size,
                              args.seed)
    cfg = smoke_config(model, STEPS, batch, out_dir)
    tr = phase_train(cfg, splits)
    ips = tr["images_per_s"]
    mem = tr["trainer"].mesh.devices.flat[0].memory_stats() or {}
    print(f"train [{card}]: {STEPS} steps at batch {batch}, losses "
          f"{[round(x, 4) for x in tr['losses']]}; eval avg_auroc="
          f"{tr['eval']['avg_auroc']:.4f} f1_micro="
          f"{tr['eval']['f1_micro']:.4f} eval_loss="
          f"{tr['eval']['eval_loss']:.4f}", flush=True)
    print(f"train step [{card}]: compile {tr['compile_s']:.1f} s, steady "
          f"{tr['step_s'] * 1e3:.2f} ms/step, {ips:.1f} images/s, MFU "
          f"{F.mfu(ips / dev['count'], model, dev['kind']):.4f} of "
          f"{F.chip_peak_flops(dev['kind']) / 1e12:.0f} TFLOP/s bf16, "
          f"peak_bytes_in_use {mem.get('peak_bytes_in_use')}", flush=True)

    from chestxray_vit_tpu.ops.attention import resolve_impl
    impl = resolve_impl(model.attention_impl, model.dtype)
    found = phase_hlo(tr["hlo"], impl)
    print(f"attention in compiled train step: {found}", flush=True)

    images = np.asarray(tr["batch"]["pixel_values_u8"])
    from chestxray_vit_tpu.ops.preprocess import normalize_u8
    ref = phase_reference(model, normalize_u8(images), seed=args.seed)
    print(f"reference [{card}]: max err / max |ref|: attention fwd "
          f"{ref['attn_fwd']:.3g} (<= {ATTN_FWD_TOL}), grad "
          f"{ref['attn_grad']:.3g} (<= {ATTN_GRAD_TOL}), logits "
          f"{ref['logits']:.3g} (<= {LOGITS_TOL})", flush=True)

    grays = list(splits[1].images[:batch])
    serve = phase_serve(tr["trainer"].state.params, model, splits[3], grays)
    print(f"serve [{card}]: bf16 and static-int8 Predictor, max |p_int8 - "
          f"p_bf16| {serve['int8_vs_bf16_prob']:.4f} (<= {INT8_PROB_TOL})",
          flush=True)

    rc = phase_gpu_tests()
    check(rc == 0, f"gpu-marked tests exit code {rc}")
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
