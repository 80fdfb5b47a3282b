"""Within-segment token merging on the packed path:
``ops.tome.tome_merge_packed`` + ``models.packed.apply_packed_tome`` +
the ``model.tome_r`` dispatch in the packed train step / PackedTrainer.

The load-bearing invariants, each tested directly:
- merges NEVER cross segments (per-segment size mass is conserved);
- the per-image pooling weights ride the routing matrix (per-image mass
  conserved exactly; the masked-mean readout contract survives);
- padding tokens (identical zeroed embeddings, segment −1) merge FIRST,
  so a pad-budget merge leaves the real images' logits untouched;
- the merged forward is differentiable and trains (step loss decreases,
  full PackedTrainer composes).
"""

import dataclasses
import io

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chestxray_vit_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from chestxray_vit_tpu.data import packing as pk
from chestxray_vit_tpu.models import packed as pm
from chestxray_vit_tpu.models import vit
from chestxray_vit_tpu.ops.tome import tome_merge_packed

CFG = ModelConfig(img_size=64, patch_size=16, hidden_size=64, num_layers=2,
                  num_heads=4, mlp_dim=128, num_classes=5, dtype="float32",
                  attention_impl="xla")
GRIDS = (2, 3, 4)   # 32 / 48 / 64 px at patch 16


def _images(rng, sizes):
    return [rng.integers(0, 255, (s, s), np.uint8) for s in sizes]


def _labels(rng, n, c=5):
    return [(rng.random(c) < 0.4).astype(np.float32) for _ in range(n)]


def _batch(rng, sizes, seq_len=48):
    return pk.pack_images(_images(rng, sizes), _labels(rng, len(sizes)),
                          patch=16, seq_len=seq_len, grids=GRIDS)


def _args(b):
    return (jnp.asarray(b.tokens), jnp.asarray(b.segment_ids),
            jnp.asarray(b.pos_indices), jnp.asarray(b.pool_weights))


# ---------------------------------------------------------------------------
# the op


def test_merge_conserves_mass_within_segments(rng):
    """Per-segment token mass (sizes) and per-image pool-weight mass are
    conserved exactly — the property that fails if any merge crossed a
    segment boundary (the source's mass would land in another segment)."""
    b, s, d = 2, 24, 8
    x = jnp.asarray(rng.normal(size=(b, s, d)), jnp.float32)
    metric = jnp.asarray(rng.normal(size=(b, s, d)), jnp.float32)
    sizes = jnp.ones((b, s), jnp.float32)
    # three segments + pad tail, contiguous like the packer emits
    seg = np.full((b, s), -1, np.int32)
    seg[:, 0:9], seg[:, 9:16], seg[:, 16:20] = 0, 1, 2
    pw = np.zeros((b, 3, s), np.float32)
    for m, (lo, hi) in enumerate([(0, 9), (9, 16), (16, 20)]):
        pw[:, m, lo:hi] = 1.0 / (hi - lo)
    r = 5
    x2, sz2, seg2, pw2 = tome_merge_packed(
        x, metric, sizes, jnp.asarray(seg), jnp.asarray(pw), r)
    assert x2.shape == (b, s - r, d)
    seg2, sz2, pw2 = np.asarray(seg2), np.asarray(sz2), np.asarray(pw2)
    assert (seg2 >= -1).all()           # the −2 scatter init never survives
    for bi in range(b):
        for sid, n_tok in [(0, 9), (1, 7), (2, 4), (-1, 4)]:
            assert sz2[bi][seg2[bi] == sid].sum() == pytest.approx(n_tok), \
                (bi, sid)
    # per-image pooling mass exact
    np.testing.assert_allclose(pw2.sum(-1), np.asarray(pw).sum(-1),
                               rtol=1e-6)
    # weighted content conserved: Σ sz·x == Σ den·x'
    want = np.einsum("bs,bsd->bd", np.asarray(sizes), np.asarray(x))
    got = np.einsum("bs,bsd->bd", sz2, np.asarray(x2))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_pads_merge_first_regardless_of_keys(rng):
    """Pad–pad pairs are FORCED above any cosine (score 2.0), so the
    budget compacts padding before touching content even when pad keys
    are adversarial (e.g. the zero vectors zero-init biases produce)."""
    b, s, d = 1, 16, 8
    x = jnp.asarray(rng.normal(size=(b, s, d)), jnp.float32)
    metric = np.asarray(rng.normal(size=(b, s, d)), np.float32)
    seg = np.full((b, s), -1, np.int32)
    seg[:, :8] = 0
    metric[:, 8:] = 0.0                  # pads: zero keys (worst case)
    pw = np.zeros((b, 1, s), np.float32)
    pw[:, 0, :8] = 1.0 / 8
    sizes = jnp.ones((b, s), jnp.float32)
    r = 3
    _, sz2, seg2, pw2 = tome_merge_packed(
        x, jnp.asarray(metric), sizes, jnp.asarray(seg), jnp.asarray(pw), r)
    seg2, sz2 = np.asarray(seg2), np.asarray(sz2)
    # all of segment 0 survives untouched (every real token still size 1)
    assert sz2[0][seg2[0] == 0].sum() == pytest.approx(8.0)
    assert (sz2[0][seg2[0] == 0] == 1.0).all()
    assert sz2[0][seg2[0] == -1].sum() == pytest.approx(8.0)


# ---------------------------------------------------------------------------
# the forward


def test_pad_budget_merge_preserves_logits(rng):
    """apply_packed_tome with a budget the padding can absorb reproduces
    the un-merged packed logits for every real image: the end-to-end
    proof that merging is within-segment and the routed pool weights
    keep the masked-mean readout exact."""
    b = _batch(rng, [32, 48], seq_len=48)      # 4+9 real, 35 pad tokens
    params = vit.init_params(jax.random.key(0), CFG)
    base = np.asarray(pm.apply_packed(params, *_args(b), CFG, GRIDS))
    tcfg = dataclasses.replace(CFG, tome_r=4)  # 8 merges < ~17 pad pairs
    merged = np.asarray(pm.apply_packed_tome(params, *_args(b), tcfg, GRIDS))
    mask = np.asarray(b.image_mask)
    np.testing.assert_allclose(merged[mask], base[mask], atol=2e-4,
                               err_msg="pad-only merging moved real "
                                       "images' logits")


def test_packed_tome_grad_flows(rng):
    b = _batch(rng, [48, 32, 64])
    tcfg = dataclasses.replace(CFG, tome_r=2, tome_schedule="decreasing")
    params = vit.init_params(jax.random.key(3), CFG)

    def loss_fn(params):
        logits = pm.apply_packed_tome(params, *_args(b), tcfg, GRIDS,
                                      train=True, rng=jax.random.key(1))
        return pm.packed_bce_loss(logits, jnp.asarray(b.labels),
                                  jnp.asarray(b.image_mask))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    assert np.isfinite(float(loss))
    gnorm = sum(float(jnp.sum(jnp.square(g)))
                for g in jax.tree.leaves(grads))
    assert np.isfinite(gnorm) and gnorm > 0


def test_packed_tome_remat_matches(rng):
    """cfg.remat wraps each unrolled block in jax.checkpoint — same
    numbers as the un-rematted forward."""
    b = _batch(rng, [48, 32])
    params = vit.init_params(jax.random.key(4), CFG)
    tcfg = dataclasses.replace(CFG, tome_r=2)
    rcfg = dataclasses.replace(tcfg, remat=True)
    out = np.asarray(pm.apply_packed_tome(params, *_args(b), tcfg, GRIDS))
    rout = np.asarray(pm.apply_packed_tome(params, *_args(b), rcfg, GRIDS))
    np.testing.assert_allclose(out, rout, atol=1e-6)


# ---------------------------------------------------------------------------
# the train step / trainer


def test_packed_tome_train_step_loss_decreases(rng):
    from chestxray_vit_tpu.train import steps as S
    b = _batch(rng, [64, 48, 32, 48, 64, 32], seq_len=32)
    tcfg = dataclasses.replace(CFG, tome_r=2, tome_schedule="decreasing")
    cfg = Config(model=tcfg, train=TrainConfig(learning_rate=2e-3))
    params = vit.init_params(jax.random.key(5), tcfg)
    state = S.TrainState.create(params, 0)
    step = jax.jit(S.make_packed_train_step(cfg, 100, GRIDS))
    batch = {"tokens": jnp.asarray(b.tokens),
             "segment_ids": jnp.asarray(b.segment_ids),
             "pos_indices": jnp.asarray(b.pos_indices),
             "pool_weights": jnp.asarray(b.pool_weights),
             "labels": jnp.asarray(b.labels),
             "image_mask": jnp.asarray(b.image_mask)}
    losses = []
    for _ in range(12):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_packed_tome_golden_trajectory():
    """Pinned 10-step loss path of the packed tome train step (CPU f32,
    fixed seeds) — the packed counterpart of the dense golden tome pins:
    numerics drift anywhere in the segment-masked merge, routing, or the
    packed step math fails here. Golden recorded 2026-08-19."""
    from chestxray_vit_tpu.train import steps as S
    golden = [0.69683367, 0.60803425, 0.53642815, 0.47607034, 0.43201065,
              0.39969572, 0.37361142, 0.35013288, 0.32860592, 0.30870613]
    r = np.random.default_rng(11)
    imgs = [r.integers(0, 255, (s, s), np.uint8)
            for s in [64, 48, 32, 48, 64, 32]]
    labs = [(r.random(5) < 0.4).astype(np.float32) for _ in range(6)]
    b = pk.pack_images(imgs, labs, patch=16, seq_len=32, grids=GRIDS)
    tcfg = dataclasses.replace(CFG, tome_r=2, tome_schedule="decreasing")
    cfg = Config(model=tcfg, train=TrainConfig(learning_rate=2e-3))
    params = vit.init_params(jax.random.key(7), tcfg)
    state = S.TrainState.create(params, 0)
    step = jax.jit(S.make_packed_train_step(cfg, 100, GRIDS))
    batch = {k: jnp.asarray(getattr(b, k)) for k in
             ["tokens", "segment_ids", "pos_indices", "pool_weights",
              "labels", "image_mask"]}
    losses = []
    for _ in range(10):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, golden, rtol=5e-4,
                               err_msg="packed tome trajectory drifted")


@pytest.fixture()
def fake_varres():
    from PIL import Image

    from chestxray_vit_tpu.data.testing import build_fake_nih
    fake = build_fake_nih(num_images=60, image_size=64, seed=21)
    nprng = np.random.default_rng(0)
    for i, name in enumerate(fake.image_names):
        if i % 3 == 0:
            size = int(nprng.choice([32, 48]))
            arr = nprng.integers(0, 255, (size, size), np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr, "L").save(buf, format="PNG")
            folder = (i % 12) + 1
            fake.store.put(f"images_{folder:03d}/images/{name}",
                           buf.getvalue())
    return fake


def test_packed_trainer_composes_with_tome(tmp_path, fake_varres):
    """PackedTrainer no longer rejects model.tome_r: it trains and
    evaluates through the within-segment merging forward end-to-end."""
    from chestxray_vit_tpu.train.packed_trainer import PackedTrainer
    cfg = Config(
        data=DataConfig(backend="memory"),
        model=ModelConfig(img_size=64, patch_size=16, hidden_size=64,
                          num_layers=2, num_heads=4, mlp_dim=128,
                          dtype="float32", attention_impl="xla",
                          tome_r=2, tome_schedule="decreasing"),
        train=TrainConfig(learning_rate=1e-3, max_steps=4,
                          eval_strategy="no", save_strategy="steps",
                          save_steps=1000, logging_steps=2,
                          load_best_model_at_end=False,
                          output_dir=str(tmp_path / "out"),
                          report_to="none"))
    tr = PackedTrainer(cfg, seq_len=48, grids=GRIDS, batch_seqs=8,
                       store=fake_varres.store, pretrained=False)
    try:
        metrics = tr.train()
        assert int(tr.state.step) == 4
        assert metrics["train_steps"] == 4
        ev = tr.evaluate()
        assert 0.0 <= ev["avg_auroc"] <= 1.0
        assert np.isfinite(ev["eval_loss"])
    finally:
        tr.close()


def test_packed_trainer_tome_warmup(tmp_path, fake_varres):
    """train.tome_warmup composes with PackedTrainer: the warmup phase
    runs the DENSE packed step (trajectory identical to a tome_r=0 run
    while inside the window), then switches to the merged one."""
    from chestxray_vit_tpu.train.packed_trainer import PackedTrainer

    def run(tome_r, warmup):
        cfg = Config(
            data=DataConfig(backend="memory"),
            model=ModelConfig(img_size=64, patch_size=16, hidden_size=64,
                              num_layers=2, num_heads=4, mlp_dim=128,
                              dtype="float32", attention_impl="xla",
                              tome_r=tome_r, tome_schedule="decreasing"),
            train=TrainConfig(learning_rate=1e-3, max_steps=2,
                              eval_strategy="no", save_strategy="no",
                              logging_steps=1, tome_warmup=warmup,
                              load_best_model_at_end=False,
                              output_dir=str(tmp_path / f"o{tome_r}.{warmup}"),
                              report_to="none"))
        tr = PackedTrainer(cfg, seq_len=48, grids=GRIDS, batch_seqs=8,
                           store=fake_varres.store, pretrained=False)
        try:
            tr.train()
            return np.concatenate(
                [np.asarray(x).ravel()
                 for x in jax.tree.leaves(tr.state.params)])
        finally:
            tr.close()

    dense = run(0, 0)
    full_warm = run(2, 2)
    merged = run(2, 0)
    np.testing.assert_array_equal(dense, full_warm)
    assert not np.allclose(dense, merged)
