"""Convergence-level quality A/B for token-merging training.

The 6.93x train headline (tome_r=32 decreasing) needs an eval-quality
bound, not just the 20-step r=2 golden pin: the reference's whole point
is the AUC its fine-tune reaches (/root/reference/ViT-Training.py:132,
pyc L320-L355). This tool trains ONE cell to convergence on the owned
HARD synthetic NIH task (data/testing.render_array_dataset — small
low-contrast jittered lesions so fidelity loss is measurable) at the
REAL token geometry (577 tokens @384/16, 12 layers) with reduced width,
and reports the avg_auroc plateau. Run the sweep cell-by-cell (each
invocation is one process — resumable, compile-cache friendly):

    python tools/tome_quality_ab.py dense
    python tools/tome_quality_ab.py r8_const    # tome_r=8,  constant
    python tools/tome_quality_ab.py r32_dec     # tome_r=32, decreasing
    ...

Optional kv args: steps=1500 batch=64 eval_every=150 img=384 lr=1e-3
hidden=192 layers=12 out=BENCH_QUALITY_AB.jsonl seed=0 dtype=bfloat16.
Appends one JSON line per cell to ``out`` (repo root) and prints it.

The eval forward is the SAME merged model (vit.apply dispatches on
cfg.tome_r), so the reported avg_auroc is the merged model's — exactly
what a user of `--set model.tome_r=N` gets from the Trainer's eval.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def parse_cell(cell: str):
    if cell == "dense":
        return 0, "constant"
    # r{R}_{const|dec}
    r_part, _, s_part = cell.partition("_")
    r = int(r_part[1:])
    sched = {"const": "constant", "dec": "decreasing"}[s_part]
    return r, sched


def main() -> None:
    import jax
    import jax.numpy as jnp

    from chestxray_vit_tpu.config import Config, ModelConfig, TrainConfig
    from chestxray_vit_tpu.data.testing import render_array_dataset
    from chestxray_vit_tpu.eval.metrics import avg_auroc
    from chestxray_vit_tpu.models import vit
    from chestxray_vit_tpu.parallel import mesh as mesh_lib
    from chestxray_vit_tpu.train import steps as S
    from chestxray_vit_tpu.utils.compilation_cache import (
        enable_compilation_cache)

    kv = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    pos = [a for a in sys.argv[1:] if "=" not in a]
    cell = pos[0] if pos else "dense"
    r, sched = parse_cell(cell)

    steps = int(kv.get("steps", 1500))
    batch = int(kv.get("batch", 64))
    eval_every = int(kv.get("eval_every", 150))
    img = int(kv.get("img", 384))
    lr = float(kv.get("lr", 1e-3))
    hidden = int(kv.get("hidden", 192))
    layers = int(kv.get("layers", 12))
    seed = int(kv.get("seed", 0))
    # init_seed varies init/shuffle while the DATASET stays fixed — a
    # same-task re-run of dense bounds the experiment's noise floor
    init_seed = int(kv.get("init_seed", seed))
    dtype = kv.get("dtype", "bfloat16")
    n_train = int(kv.get("n_train", 4096))
    n_val = int(kv.get("n_val", 1024))
    remat = bool(int(kv.get("remat", 1)))   # headline configs train rematerialized
    contrast = int(kv.get("contrast", 40))
    jitter = int(kv.get("jitter", 24))
    # Dense-warmup hypothesis (round-5 init-sensitivity follow-up): the
    # quality A/B showed every merged cell is a DELAYED takeoff and the
    # slow-climb inits never break the easy-class floor — i.e. merging
    # impedes early feature learning, not the converged computation. If
    # so, training DENSE through the takeoff window and only then
    # switching merging on should recover dense-mode takeoff at most of
    # the merged throughput. tome_warmup=W trains steps 1..W with the
    # dense step function, W+1.. with the merged one (same params tree —
    # merging is parameter-free; same cosine schedule — total_steps is
    # shared, so LR is continuous across the switch).
    tome_warmup = float(kv.get("tome_warmup", 0))
    if tome_warmup and not r:
        raise SystemExit("tome_warmup requires a merged cell (r>0)")
    if 0 < tome_warmup < 1:   # fraction of total steps, like the Trainer
        tome_warmup = max(1, int(round(tome_warmup * steps)))
    tome_warmup = int(tome_warmup)
    out_path = os.path.join(ROOT, kv.get("out", "BENCH_QUALITY_AB.jsonl"))

    enable_compilation_cache(os.path.join(ROOT, ".xla_cache"))

    mcfg = ModelConfig(
        img_size=img, patch_size=16, hidden_size=hidden,
        num_layers=layers, num_heads=max(hidden // 64, 1),
        mlp_dim=hidden * 4, num_classes=15, dtype=dtype, remat=remat,
        attention_impl="auto", tome_r=r, tome_schedule=sched)
    cfg = Config(model=mcfg,
                 train=TrainConfig(batch_size_per_core=batch,
                                   learning_rate=lr,
                                   warmup_steps=int(kv.get("warmup", 200)),
                                   lr_schedule=kv.get("sched_lr", "cosine")))

    # deterministic datasets shared by every cell (same seed)
    t0 = time.perf_counter()
    tr_x, tr_y = render_array_dataset(n_train, image_size=img, seed=seed,
                                      contrast=contrast, jitter=jitter)
    va_x, va_y = render_array_dataset(n_val, image_size=img,
                                      seed=seed + 1_000_003,
                                      contrast=contrast, jitter=jitter)
    data_s = time.perf_counter() - t0

    mesh = mesh_lib.build_mesh()
    n_dev = len(jax.devices())
    b = batch  # per-chip batch == global batch on the 1-chip box
    if b % max(n_dev, 1):
        raise SystemExit(f"batch {b} not divisible by {n_dev} devices")

    params = vit.init_params(jax.random.key(init_seed), mcfg)
    state = S.TrainState.create(params, seed=init_seed)
    step = S.jit_train_step(S.make_train_step(cfg, total_steps=steps),
                            mesh, state)
    warm_step = None
    if tome_warmup:
        import dataclasses as _dc
        cfg_warm = Config(model=_dc.replace(mcfg, tome_r=0),
                          train=cfg.train)
        warm_step = S.jit_train_step(
            S.make_train_step(cfg_warm, total_steps=steps), mesh, state)
    state = S.place_state(state, mesh)
    ev = S.make_eval_step(cfg)
    jev = S.jit_eval_step(ev, mesh, params)
    # dense-eval track: the SAME trained params evaluated without merging
    # decomposes "merging degrades inference" from "merging degrades
    # learning" — if dense eval recovers, the recipe is train-merged /
    # serve-dense (the paper's §4.2 observation, measured here)
    jev_dense = jev
    if r:
        import dataclasses as _dc
        cfg_dense = Config(model=_dc.replace(mcfg, tome_r=0),
                           train=cfg.train)
        jev_dense = S.jit_eval_step(S.make_eval_step(cfg_dense), mesh,
                                    params)

    shuffle = np.random.default_rng(init_seed + 7)
    order = shuffle.permutation(n_train)
    cursor = 0

    def next_batch():
        nonlocal cursor, order
        if cursor + b > n_train:
            order = shuffle.permutation(n_train)
            cursor = 0
        idx = order[cursor:cursor + b]
        cursor += b
        return mesh_lib.shard_batch(mesh, {
            "pixel_values_u8": jnp.asarray(tr_x[idx]),
            "labels": jnp.asarray(tr_y[idx]),
        })

    def evaluate(eval_params, fn=None):
        fn = fn or jev
        chunks = []
        for lo in range(0, n_val - n_val % b, b):
            logits, _ = fn(eval_params, mesh_lib.shard_batch(mesh, {
                "pixel_values_u8": jnp.asarray(va_x[lo:lo + b]),
                "labels": jnp.asarray(va_y[lo:lo + b]),
            }))
            chunks.append(np.asarray(logits))
        logits = np.concatenate(chunks)
        n = logits.shape[0]
        return float(avg_auroc(jnp.asarray(logits), jnp.asarray(va_y[:n])))

    evals = []
    dense_evals = []
    loss = float("nan")
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        state, m = (warm_step if i <= tome_warmup else step)(
            state, next_batch())
        if i % 16 == 0:          # bounded async queue
            loss = float(m["loss"])
        if i % eval_every == 0 or i == steps:
            loss = float(m["loss"])
            auroc = evaluate(state.params)
            evals.append([i, round(auroc, 5)])
            extra = ""
            if r:
                d_auroc = evaluate(state.params, jev_dense)
                dense_evals.append([i, round(d_auroc, 5)])
                extra = f" dense_eval {d_auroc:.4f}"
            print(f"[{cell}] step {i}: loss {loss:.4f} "
                  f"avg_auroc {auroc:.4f}{extra}", flush=True)
    wall_s = time.perf_counter() - t0

    aurocs = [a for _, a in evals]
    rec = {
        "cell": cell, "tome_r": r, "schedule": sched,
        **({"tome_warmup": tome_warmup} if tome_warmup else {}),
        "steps": steps, "batch": batch, "img": img, "hidden": hidden,
        "layers": layers, "lr": lr, "dtype": dtype, "seed": seed,
        "init_seed": init_seed, "contrast": contrast, "jitter": jitter,
        "n_train": n_train, "n_val": n_val,
        "best_auroc": max(aurocs),
        "final_auroc": round(float(np.mean(aurocs[-3:])), 5),
        "final_loss": round(loss, 5),
        "evals": evals,
        **({"dense_evals": dense_evals,
            "best_dense_auroc": max(a for _, a in dense_evals),
            "final_dense_auroc": round(float(np.mean(
                [a for _, a in dense_evals[-3:]])), 5)}
           if dense_evals else {}),
        "train_wall_s": round(wall_s, 1), "data_s": round(data_s, 1),
        "backend": jax.devices()[0].platform,
    }
    line = json.dumps(rec)
    with open(out_path, "a") as f:
        f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
