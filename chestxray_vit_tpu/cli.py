"""Command-line entry points.

The reference has no CLI — knobs are module constants (pyc L64-L91) and a
literal dict (ViT-Training.py:155-166). Here: typed config + subcommands.

    python -m chestxray_vit_tpu.cli train --preset version_b \
        --set data.use_subset_data=1000 --set train.output_dir=./outputs
    python -m chestxray_vit_tpu.cli eval --preset version_b \
        --set train.resume_from_checkpoint=auto
    python -m chestxray_vit_tpu.cli predict ...   # + classification report
    python -m chestxray_vit_tpu.cli smoke         # synthetic end-to-end run
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

from chestxray_vit_tpu.config import Config, parse_cli


def _build_trainer(cfg: Config, pretrained: bool = True):
    from chestxray_vit_tpu.train.trainer import Trainer
    store = None
    if cfg.data.backend == "memory":
        from chestxray_vit_tpu.data.testing import build_fake_nih
        store = build_fake_nih(num_images=max(
            64, (cfg.data.use_subset_data or 0) + 32)).store
    return Trainer(cfg, store=store, pretrained=pretrained)


def cmd_train(cfg: Config) -> int:
    trainer = _build_trainer(cfg)
    metrics = trainer.train()
    trainer.save_model()
    eval_metrics = trainer.evaluate()
    trainer.logger.log(int(trainer.state.step), eval_metrics, "eval")
    trainer.logger.save_results("eval", eval_metrics)
    trainer.save_state()       # trainer_state.json (pyc L485 parity)
    trainer.close()
    print({**metrics, **eval_metrics})
    return 0


def cmd_eval(cfg: Config) -> int:
    trainer = _build_trainer(cfg)
    if cfg.train.resume_from_checkpoint:
        step = (None if cfg.train.resume_from_checkpoint == "auto"
                else int(cfg.train.resume_from_checkpoint))
        trainer.state, _, _ = trainer.ckpt.restore(step, trainer.state)
    metrics = trainer.evaluate()
    trainer.logger.save_results("eval", metrics)
    trainer.close()
    print(metrics)
    return 0


def cmd_predict(cfg: Config) -> int:
    trainer = _build_trainer(cfg)
    if cfg.train.resume_from_checkpoint:
        step = (None if cfg.train.resume_from_checkpoint == "auto"
                else int(cfg.train.resume_from_checkpoint))
        trainer.state, _, _ = trainer.ckpt.restore(step, trainer.state)
    report = os.path.join(os.path.expanduser(cfg.train.output_dir),
                          "final_classification_report.txt")
    # --set train.calibrate_thresholds=1 fits per-class thresholds on val
    _, _, metrics = trainer.predict(
        report_path=report,
        calibrate=cfg.train.calibrate_thresholds)
    trainer.close()
    print(metrics)
    return 0


def cmd_smoke(cfg: Config) -> int:
    """Synthetic-bucket end-to-end sanity fine-tune (the reference's
    USE_SUBSET_DATA fast-test path, README.md:82, done properly)."""
    cfg.data.backend = "memory"
    cfg.data.use_subset_data = cfg.data.use_subset_data or 48
    cfg.model.img_size = min(cfg.model.img_size, 64)
    cfg.model.num_layers = min(cfg.model.num_layers, 2)
    cfg.model.hidden_size = min(cfg.model.hidden_size, 64)
    cfg.model.num_heads = 4
    cfg.model.mlp_dim = min(cfg.model.mlp_dim, 128)
    cfg.model.attention_impl = "auto"
    cfg.train.num_epochs = min(cfg.train.num_epochs, 3)
    cfg.train.eval_strategy = "epoch"
    cfg.train.save_strategy = "epoch"
    cfg.train.logging_steps = 1
    trainer = _build_trainer(cfg, pretrained=False)
    trainer.train()
    metrics = trainer.evaluate()
    trainer.close()
    print({"smoke": "ok", **{k: round(v, 4) for k, v in metrics.items()
                             if not k.startswith("auroc_")}})
    return 0


def cmd_maps(argv: List[str]) -> int:
    """Attention-rollout overlays for saved models (the reference's README
    TODO 'attention map visualization', one-shot CLI form; the HTTP server
    exposes the same maps via /predict?maps=1)."""
    import argparse
    ap = argparse.ArgumentParser(prog="chestxray_vit_tpu maps")
    ap.add_argument("images", nargs="+", help="PNG/JPEG files")
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--alpha", type=float, default=0.45)
    ap.add_argument("--method", choices=("rollout", "gradcam"),
                    default="rollout",
                    help="rollout: attention flow from CLS; gradcam: "
                         "class-discriminative (top predicted class)")
    ns = ap.parse_args(argv)

    import numpy as np
    from PIL import Image

    from chestxray_vit_tpu.data import decode as dec
    from chestxray_vit_tpu.serve import attention_maps as am
    from chestxray_vit_tpu.serve.inference import Predictor

    pred = Predictor.from_model_dir(ns.model_dir)
    blobs = [open(p, "rb").read() for p in ns.images]
    if ns.method == "gradcam":
        import jax.numpy as jnp

        from chestxray_vit_tpu.data import geometry as geo
        from chestxray_vit_tpu.data.pipeline import host_resize
        from chestxray_vit_tpu.ops.preprocess import normalize_u8

        plain = pred.predict_bytes(blobs)
        cfg = pred.cfg
        u8 = np.stack([
            host_resize(g, geo.full_image_box(g.shape[1], g.shape[0]),
                        cfg.img_size)
            for g in (dec.safe_decode_gray(b) for b in blobs)])
        images = normalize_u8(jnp.asarray(u8), dtype=jnp.dtype(cfg.dtype))
        cls = jnp.asarray(np.argmax(plain.probs, axis=1))
        _, cams = am.grad_cam(pred.params, images, cfg, cls)
        maps_np, probs_np = np.asarray(cams), plain.probs
    else:
        out = pred.predict_bytes(blobs, with_maps=True)
        maps_np, probs_np = out.maps, out.probs
    os.makedirs(os.path.expanduser(ns.out_dir), exist_ok=True)
    for path, blob, m, probs in zip(ns.images, blobs, maps_np, probs_np):
        gray = dec.safe_decode_gray(blob)
        overlay = am.render_overlay(gray, np.asarray(m), ns.alpha)
        stem = os.path.splitext(os.path.basename(path))[0]
        dest = os.path.join(os.path.expanduser(ns.out_dir),
                            f"{stem}_attn.png")
        Image.fromarray(overlay, "RGB").save(dest)
        top = pred.top_findings(probs, k=3)
        print(f"{path} -> {dest}  top: " + ", ".join(
            f"{f['label']}={f['probability']:.3f}" for f in top))
    return 0


def cmd_export(argv: List[str]) -> int:
    """Export a saved model dir to an HF ViTForImageClassification folder
    (torch `from_pretrained`-loadable) — the interop surface reference
    users expect when moving weights back to the HF stack."""
    import argparse
    ap = argparse.ArgumentParser(prog="chestxray_vit_tpu export")
    ap.add_argument("--model-dir", required=True,
                    help="a Trainer save_model() directory")
    ap.add_argument("--out", required=True, help="HF folder to write")
    ns = ap.parse_args(argv)

    import jax

    from chestxray_vit_tpu.models import vit
    from chestxray_vit_tpu.models.export_hf import export_hf_folder
    from chestxray_vit_tpu.train.checkpoint import load_model

    with open(os.path.join(os.path.expanduser(ns.model_dir),
                           "config.json")) as f:
        cfg = Config.from_json(f.read())
    template = vit.init_params(jax.random.key(0), cfg.model)
    params, classes = load_model(ns.model_dir, template)
    export_hf_folder(ns.out, params, cfg.model, classes,
                     image_mean=cfg.data.image_mean,
                     image_std=cfg.data.image_std)
    print(f"HF export written to {ns.out}")
    return 0


def cmd_quantize(argv: List[str]) -> int:
    """Quantize a saved model once and persist the int8 artifact
    (``<model-dir>/quantized/``): ~4× smaller weights; serving cold
    starts (`serve --quantize`, `Predictor.from_model_dir`) then skip
    the quantize pass and, for static mode, the calibration forward.
    Beyond the reference (its serving story is a README TODO)."""
    import argparse
    ap = argparse.ArgumentParser(prog="chestxray_vit_tpu quantize")
    ap.add_argument("--model-dir", required=True,
                    help="a Trainer save_model() directory")
    ap.add_argument("--mode", choices=("static", "dynamic"),
                    default="static")
    ap.add_argument("--calibration", nargs="*", default=None,
                    help="PNG/JPEG files for static calibration "
                         "(synthetic-noise fallback when omitted — pass "
                         "real images for production)")
    ap.add_argument("--out", default=None,
                    help="artifact directory (default "
                         "<model-dir>/quantized)")
    ap.add_argument("--compilation-cache", default=None,
                    help="persistent XLA compile cache dir (default: "
                         "$JAX_COMPILATION_CACHE_DIR, else "
                         "<checkout>/.xla_cache)")
    ns = ap.parse_args(argv)
    from chestxray_vit_tpu.utils.compilation_cache import (
        enable_compilation_cache)
    enable_compilation_cache(ns.compilation_cache)

    import jax

    from chestxray_vit_tpu.models import vit
    from chestxray_vit_tpu.serve.inference import Predictor
    from chestxray_vit_tpu.train.checkpoint import load_model

    calibration = None
    if ns.calibration is not None:
        if not ns.calibration:
            # an explicitly-passed-but-empty list (e.g. a shell glob that
            # matched nothing) must not silently fall back to synthetic
            # noise — the user asked for real-image calibration
            raise SystemExit("--calibration was given but matched no "
                             "files; pass image paths or omit the flag "
                             "for the synthetic fallback")
        calibration = [open(p, "rb").read() for p in ns.calibration]
    # build fresh (never via from_model_dir, which would auto-load and
    # re-save an existing artifact instead of re-quantizing)
    with open(os.path.join(os.path.expanduser(ns.model_dir),
                           "config.json")) as f:
        cfg = Config.from_json(f.read())
    template = vit.init_params(jax.random.key(0), cfg.model)
    params, classes = load_model(ns.model_dir, template)
    pred = Predictor(params, cfg.model, classes, quantize=ns.mode,
                     calibration=calibration)
    out = ns.out or os.path.join(os.path.expanduser(ns.model_dir),
                                 "quantized")
    pred.save_quantized(out)
    print(f"int8 artifact ({ns.mode}) written to {out}")
    return 0


COMMANDS = {
    "train": cmd_train,
    "eval": cmd_eval,
    "predict": cmd_predict,
    "smoke": cmd_smoke,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("commands:", ", ".join(sorted(COMMANDS)))
        return 0
    cmd = argv.pop(0)
    if cmd == "serve":
        # HTTP inference server (own flag surface: --model-dir/--port/...)
        from chestxray_vit_tpu.serve.server import main as serve_main
        return serve_main(argv)
    if cmd == "maps":
        return cmd_maps(argv)
    if cmd == "export":
        return cmd_export(argv)
    if cmd == "quantize":
        return cmd_quantize(argv)
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; one of "
              f"{sorted([*COMMANDS, 'export', 'maps', 'quantize', 'serve'])}")
        return 2
    cfg = parse_cli(argv)
    return COMMANDS[cmd](cfg)


if __name__ == "__main__":
    raise SystemExit(main())
