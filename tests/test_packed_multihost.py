"""REAL multi-process PACKED trainer test: two
jax.distributed processes drive PackedTrainer.train() through host-sharded
packing streams and must reproduce, per step, the losses of an in-process
simulation that packs the SAME two host shards and assembles the same
global batches — the multi-host mechanics (global batch formation, psum'd
grads, census-agreed epoch caps, per-host cursors) are an implementation
detail that must not change the numbers."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chestxray_vit_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from chestxray_vit_tpu.data import packing as pk
from chestxray_vit_tpu.data.pipeline import build_datasets
from chestxray_vit_tpu.data.testing import build_fake_nih
from chestxray_vit_tpu.models import vit
from chestxray_vit_tpu.train import steps as S

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "_packed_multihost_worker.py")

GRIDS = (2, 3, 4)
SEQ_LEN = 48
BATCH_SEQS = 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def packed_multihost_results(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("pmh"))
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(pid), str(port), outdir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in (0, 1)]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, text in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{text[-3000:]}"
    results = []
    for pid in (0, 1):
        with open(os.path.join(outdir, f"result_rank{pid}.json")) as f:
            results.append(json.load(f))
    return results


def test_two_process_packed_agrees_across_ranks(packed_multihost_results):
    r0, r1 = packed_multihost_results
    assert r0["process_count"] == 2 and r1["process_count"] == 2
    assert len(r0["losses"]) == 3
    np.testing.assert_allclose(r0["losses"], r1["losses"], rtol=1e-6)


def test_cursor_carries_per_host_image_counts(packed_multihost_results):
    r0, _ = packed_multihost_results
    cur = r0["cursor"]
    assert cur["per_host"] is not None and len(cur["per_host"]) == 2
    assert cur["batch_in_epoch"] == sum(cur["per_host"])
    assert all(v > 0 for v in cur["per_host"])


def test_multihost_packed_eval_runs_and_agrees(packed_multihost_results):
    """Eval on the 2-process cluster (host-local jit over local param
    replicas): runs without touching non-addressable global arrays and
    produces identical metrics on both ranks."""
    r0, r1 = packed_multihost_results
    np.testing.assert_allclose(r0["eval"]["avg_auroc"],
                               r1["eval"]["avg_auroc"], rtol=1e-6)
    np.testing.assert_allclose(r0["eval"]["eval_loss"],
                               r1["eval"]["eval_loss"], rtol=1e-6)
    assert np.isfinite(r0["eval"]["eval_loss"])


def test_two_process_packed_matches_in_process_simulation(
        packed_multihost_results):
    """Rebuild each host's packed stream (order[rank::2], 4 seqs/step),
    concatenate into the global batches the cluster formed, and run the
    identical jitted packed step on the local 8-device mesh: per-step
    losses must match the 2-process run."""
    fake = build_fake_nih(num_images=96, image_size=64, seed=13)
    bundle = build_datasets(DataConfig(backend="memory"), store=fake.store)
    cfg = Config(
        model=ModelConfig(img_size=64, patch_size=16, hidden_size=32,
                          num_layers=1, num_heads=2, mlp_dim=64,
                          num_classes=len(bundle.classes),
                          dtype="float32", attention_impl="xla"),
        train=TrainConfig(learning_rate=2e-3, seed=0))

    r0 = packed_multihost_results[0]
    spe = r0["steps_per_epoch"]     # census-agreed epoch cap in the worker

    def epoch_pairs(epoch):
        streams = [list(pk.iterate_packed_batches(
            bundle.train, bundle.blob_map, fake.store,
            batch_seqs=4, patch=16, seq_len=SEQ_LEN, grids=GRIDS,
            epoch=epoch, shuffle=True, seed=42, num_workers=2,
            host_shard=(r, 2))) for r in (0, 1)]
        full = [[b for b in st if int(b["n_seqs"]) == 4] for st in streams]
        # the worker caps every multi-host epoch at steps_per_epoch
        return list(zip(full[0], full[1]))[:spe]

    pairs = []
    epoch = 0
    while len(pairs) < 3:           # worker ran max_steps=3, rolling epochs
        pairs.extend(epoch_pairs(epoch))
        epoch += 1

    params = vit.init_params(jax.random.key(cfg.train.seed), cfg.model)
    state = S.TrainState.create(params, cfg.train.seed)
    # the worker ran with max_steps=3 -> its lr schedule horizon is 3
    step = jax.jit(S.make_packed_train_step(cfg, 3, GRIDS))

    losses = []
    for b0, b1 in pairs[:3]:
        glob = {}
        for k in ("tokens", "segment_ids", "pos_indices", "pool_weights",
                  "labels", "image_mask"):
            glob[k] = jnp.asarray(np.concatenate([b0[k], b1[k]], axis=0))
        state, m = step(state, glob)
        losses.append(float(m["loss"]))

    np.testing.assert_allclose(r0["losses"], losses, rtol=2e-5, atol=1e-6)
