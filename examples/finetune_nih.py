"""Real-data NIH ChestX-ray14 fine-tune runbook script.

The reference pipeline this reproduces: fine-tune google/vit-base-patch16-384
on NIH ChestX-ray14 with BCEWithLogits over 15 classes, 8-way data parallel
(/root/reference/ViT-Training.py; recovered Version B pyc). See
examples/finetune_nih.md for the full runbook: data layout, expected AUC
band, and troubleshooting.

Usage (after staging data + weights as described in the .md):

    python examples/finetune_nih.py \
        --data-root /data/nih \
        --weights /data/weights/vit-base-patch16-384 \
        --preset version_b [--subset 1000] [--dry-run]

--dry-run runs the identical code path against the in-memory synthetic
bucket (no real data needed) — the pre-flight check that the full run is
one flag away.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", default=None,
                    help="directory with Data_Entry_2017.csv, "
                         "BBox_List_2017.csv, train_val_list.txt, "
                         "test_list.txt, images_001/..images_012/")
    ap.add_argument("--gcs-bucket", default=None,
                    help="stream from a GCS bucket with the same layout "
                         "instead of a local directory")
    ap.add_argument("--weights", default=None,
                    help="dir containing model.safetensors of "
                         "google/vit-base-patch16-384 (or an HF model id "
                         "when the hub is reachable)")
    ap.add_argument("--preset", default="version_b",
                    choices=["version_a", "version_b", "fast_finetune"],
                    help="fast_finetune = the token-merging recipe "
                         "(b36, remat, tome r=16 decreasing); "
                         "validate merged runs per init (README "
                         "'Accelerated training') or set "
                         "train.tome_warmup")
    ap.add_argument("--subset", type=int, default=None,
                    help="USE_SUBSET_DATA: train on the first N samples "
                         "(val N//5) for a fast sanity run")
    ap.add_argument("--output-dir", default="./nih_finetune")
    ap.add_argument("--dry-run", action="store_true",
                    help="run the identical path on the synthetic "
                         "in-memory bucket (no data/weights required)")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE", help="config overrides")
    ap.add_argument("--expect-band", action="store_true",
                    help="exit nonzero when the full-run mean AUC lands "
                         "outside the published 0.77-0.83 band")
    ap.add_argument("--expect-quant-band", type=float, default=None,
                    metavar="DELTA",
                    help="after the fine-tune, re-evaluate with "
                         "train.eval_quantize=static and exit nonzero "
                         "when |AUC_int8 - AUC_bf16| > DELTA (real-data "
                         "fidelity gate for the int8 eval path; try 0.005)")
    ap.add_argument("--expect-tome-band", type=str, default=None,
                    metavar="R:DELTA",
                    help="after the fine-tune, re-evaluate with "
                         "train.eval_tome_r=R (format 'R:DELTA', e.g. "
                         "'16:0.01') and exit nonzero when "
                         "|AUC_tome - AUC_bf16| > DELTA")
    ns = ap.parse_args()

    from chestxray_vit_tpu.config import _PRESETS, _set_by_path
    from chestxray_vit_tpu.train.trainer import Trainer

    cfg = _PRESETS[ns.preset]()
    cfg.train.output_dir = ns.output_dir
    store = None
    if ns.dry_run:
        from chestxray_vit_tpu.data.testing import build_fake_nih
        cfg.data.backend = "memory"
        fake = build_fake_nih(num_images=200, image_size=256, seed=0)
        store = fake.store
        cfg.train.max_steps = 20
        cfg.train.eval_steps = 10
        cfg.train.save_steps = 10
        cfg.train.logging_steps = 5
    elif ns.gcs_bucket:
        cfg.data.backend = "gcs"
        cfg.data.gcs_bucket_name = ns.gcs_bucket
    elif ns.data_root:
        cfg.data.backend = "local"
        cfg.data.local_root = ns.data_root
    else:
        ap.error("one of --data-root / --gcs-bucket / --dry-run is required")

    if ns.subset:
        cfg.data.use_subset_data = ns.subset
    if ns.weights:
        cfg.model.model_name = ns.weights
    for kv in ns.set:
        key, _, value = kv.partition("=")
        _set_by_path(cfg, key.strip(), value.strip())

    pretrained = not ns.dry_run
    if pretrained and ns.weights and os.path.isdir(ns.weights):
        st = os.path.join(ns.weights, "model.safetensors")
        if not os.path.exists(st):
            print(f"ERROR: {st} not found — stage the checkpoint first "
                  "(see examples/finetune_nih.md §2)")
            return 2

    tr = Trainer(cfg, store=store, pretrained=pretrained)
    if pretrained:
        # ingestion check: pretrained weights must load, not fall back
        import numpy as np
        from chestxray_vit_tpu.models import vit as V
        pe = np.asarray(tr.state.params["patch_embed"]["kernel"])
        if abs(float(pe.std()) - 0.02) < 0.002:
            print("ERROR: params look like random init (std≈0.02) — the "
                  "pretrained load failed; check --weights")
            return 2
        print(f"[finetune] pretrained weights loaded "
              f"({V.num_params(tr.state.params) / 1e6:.1f}M params)")

    train_metrics = tr.train()
    eval_metrics = tr.evaluate()
    print(f"[finetune] train: {train_metrics}")
    print(f"[finetune] eval:  {eval_metrics}")

    # accelerated-eval fidelity gates: the int8 /
    # token-merging eval paths re-score the SAME validation split on the
    # just-trained params; the AUC deltas are the real-data numbers the
    # synthetic-weight oracle tests structurally cannot produce.
    accel_fail = 0
    auc0 = eval_metrics.get("avg_auroc", 0.0)
    if ns.expect_quant_band is not None:
        tr.cfg.train.eval_quantize = "static"
        q_auc = tr.evaluate().get("avg_auroc", 0.0)
        tr.cfg.train.eval_quantize = None
        d = abs(q_auc - auc0)
        ok = d <= ns.expect_quant_band
        print(f"[finetune] int8-static eval AUC {q_auc:.4f} "
              f"(Δ {d:.4f} vs bf16; bound {ns.expect_quant_band}) — "
              f"{'OK' if ok else 'FAIL'}")
        accel_fail |= not ok
    if ns.expect_tome_band is not None:
        r_s, _, d_s = ns.expect_tome_band.partition(":")
        r, bound = int(r_s), float(d_s or 0.01)
        tr.cfg.train.eval_tome_r = r
        t_auc = tr.evaluate().get("avg_auroc", 0.0)
        tr.cfg.train.eval_tome_r = 0
        d = abs(t_auc - auc0)
        ok = d <= bound
        print(f"[finetune] tome r={r} eval AUC {t_auc:.4f} "
              f"(Δ {d:.4f} vs bf16; bound {bound}) — "
              f"{'OK' if ok else 'FAIL'}")
        accel_fail |= not ok
    # reference parity artifacts (pyc L482-L491): train_results.json is
    # written by train(); eval_results.json here; report + saved model next
    tr.logger.save_results("eval", {
        k: v for k, v in eval_metrics.items()
        if isinstance(v, (int, float)) and v == v})
    tr.save_model()
    tr.predict(report_path=os.path.join(
        os.path.expanduser(cfg.train.output_dir),
        "final_classification_report.txt"))
    tr.close()

    auc = eval_metrics.get("avg_auroc", 0.0)
    if not ns.dry_run and not ns.subset:
        band = (0.77, 0.83)
        within = band[0] <= auc <= band[1] + 0.02
        print(f"[finetune] mean AUC {auc:.4f} — "
              f"{'WITHIN' if within else 'OUTSIDE'} the published "
              f"ViT/ChestX-ray14 band {band}")
        if ns.expect_band and not within:
            print("[finetune] --expect-band: failing the run")
            return 3
    if accel_fail:
        print("[finetune] accelerated-eval fidelity gate failed")
        return 4
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
