"""PackedTrainer end-to-end on the synthetic bucket: variable-resolution
NIH images packed into shared sequences, trained and evaluated packed."""

import io

import numpy as np
import pytest
from PIL import Image

from chestxray_vit_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from chestxray_vit_tpu.data.storage import MemoryStore
from chestxray_vit_tpu.data.testing import build_fake_nih
from chestxray_vit_tpu.train.packed_trainer import PackedTrainer

GRIDS = (2, 3, 4)   # 32/48/64 px at patch 16


@pytest.fixture(scope="module")
def fake_varres():
    """Fake bucket with VARIABLE resolutions (the packed use case)."""
    fake = build_fake_nih(num_images=60, image_size=64, seed=21)
    rng = np.random.default_rng(0)
    # rewrite a third of the images at smaller resolutions
    for i, name in enumerate(fake.image_names):
        if i % 3 == 0:
            size = int(rng.choice([32, 48]))
            arr = rng.integers(0, 255, (size, size), np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr, "L").save(buf, format="PNG")
            folder = (i % 12) + 1
            fake.store.put(f"images_{folder:03d}/images/{name}",
                           buf.getvalue())
    return fake


def _cfg(tmp_path):
    return Config(
        data=DataConfig(backend="memory"),
        model=ModelConfig(img_size=64, patch_size=16, hidden_size=64,
                          num_layers=2, num_heads=4, mlp_dim=128,
                          dtype="float32", attention_impl="xla"),
        train=TrainConfig(learning_rate=1e-3, max_steps=6,
                          eval_strategy="no", save_strategy="steps",
                          save_steps=1000, logging_steps=2,
                          load_best_model_at_end=False,
                          output_dir=str(tmp_path / "out"),
                          report_to="none"))


def test_packed_trainer_trains_and_evaluates(tmp_path, fake_varres):
    tr = PackedTrainer(_cfg(tmp_path), seq_len=48, grids=GRIDS,
                       batch_seqs=8, store=fake_varres.store,
                       pretrained=False)
    metrics = tr.train()
    assert int(tr.state.step) == 6
    assert metrics["train_steps"] == 6
    ev = tr.evaluate()
    assert 0.0 <= ev["avg_auroc"] <= 1.0
    assert np.isfinite(ev["eval_loss"])
    # packed predict over the test split: one logit row per image
    logits, labels, test_metrics = tr.predict()
    assert logits.shape[0] == len(tr.bundle.test)
    assert labels.shape == logits.shape
    tr.close()


def test_packed_trainer_rejects_bad_dp(tmp_path, fake_varres):
    with pytest.raises(ValueError, match="divisible"):
        PackedTrainer(_cfg(tmp_path), seq_len=48, grids=GRIDS,
                      batch_seqs=3, store=fake_varres.store,
                      pretrained=False)


class CountingStore:
    """Store wrapper counting get() calls (I/O accounting for resume)."""

    def __init__(self, inner):
        self.inner = inner
        self.gets = 0

    def get(self, key):
        self.gets += 1
        return self.inner.get(key)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_packed_resume_skips_io_and_matches_prefix(tmp_path, fake_varres):
    """skip_images resumes BEFORE any fetch/decode: exactly the remaining
    images are fetched, and the re-packed batches are bit-identical to the
    uninterrupted run's tail."""
    from chestxray_vit_tpu.data import packing as pk
    from chestxray_vit_tpu.data.pipeline import build_datasets
    from chestxray_vit_tpu.config import DataConfig

    bundle = build_datasets(DataConfig(backend="memory"),
                            store=fake_varres.store)
    kw = dict(batch_seqs=2, patch=16, seq_len=48, grids=GRIDS,
              epoch=0, shuffle=True, seed=42, num_workers=2)

    full = list(pk.iterate_packed_batches(
        bundle.train, bundle.blob_map, fake_varres.store, **kw))
    # find the image-prefix cursor after the first two emitted batches
    skip = int(full[0]["n_images"]) + int(full[1]["n_images"])

    counting = CountingStore(fake_varres.store)
    tail = list(pk.iterate_packed_batches(
        bundle.train, bundle.blob_map, counting, **kw))
    assert counting.gets == len(bundle.train)          # baseline: all fetched

    counting2 = CountingStore(fake_varres.store)
    resumed = list(pk.iterate_packed_batches(
        bundle.train, bundle.blob_map, counting2, skip_images=skip, **kw))
    # no re-fetch of the skipped prefix
    assert counting2.gets == len(bundle.train) - skip
    # re-packed stream identical to the uninterrupted run's tail
    assert len(resumed) == len(tail) - 2
    for a, b in zip(resumed, tail[2:]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_packed_trainer_checkpoint_resume(tmp_path):
    """End-to-end mid-epoch packed resume through the checkpoint cursor."""
    big = build_fake_nih(num_images=240, image_size=64, seed=3)
    cfg = _cfg(tmp_path)
    cfg.train.max_steps = 2
    cfg.train.save_steps = 2
    tr1 = PackedTrainer(cfg, seq_len=48, grids=GRIDS, batch_seqs=8,
                        store=big.store, pretrained=False)
    tr1.train()
    tr1.ckpt.wait()
    assert tr1.ckpt.latest_step() == 2
    # the persisted cursor must count images in the 2 CONSUMED batches only
    # — not batches the prefetch thread produced ahead (regression: the old
    # produce-side counter over-counted by up to prefetch_depth+1 batches,
    # making resume skip never-trained data)
    from chestxray_vit_tpu.data import packing as pk
    expected = 0
    n_full = 0
    for b in pk.iterate_packed_batches(
            tr1.bundle.train, tr1.bundle.blob_map, big.store,
            batch_seqs=8, patch=16, seq_len=48, grids=GRIDS,
            epoch=0, shuffle=True, seed=cfg.data.shuffle_buffer_seed,
            num_workers=2):
        if int(b["n_seqs"]) < 8:
            continue
        expected += int(b["n_images"])
        n_full += 1
        if n_full == 2:
            break
    _, cursor, _ = tr1.ckpt.restore(2, tr1.state)
    assert cursor.epoch == 0
    assert cursor.batch_in_epoch == expected
    imgs_at_save = cursor.batch_in_epoch
    assert imgs_at_save > 0
    tr1.close()

    cfg2 = _cfg(tmp_path)
    cfg2.train.max_steps = 4
    cfg2.train.save_steps = 2
    cfg2.train.resume_from_checkpoint = "auto"
    counting = CountingStore(big.store)
    tr2 = PackedTrainer(cfg2, seq_len=48, grids=GRIDS, batch_seqs=8,
                        store=counting, pretrained=False,
                        census_sample=4)
    gets_before = counting.gets          # census + metadata reads
    tr2.train()
    assert int(tr2.state.step) == 4
    # resumed training fetched at most the unskipped remainder (epoch may
    # roll over; never the full epoch PLUS the skipped prefix again)
    fetched = counting.gets - gets_before
    assert fetched <= 2 * len(tr2.bundle.train) - imgs_at_save
    tr2.close()


def test_packed_steps_per_epoch_is_measured(tmp_path):
    """The census-driven steps/epoch matches the real batch count (exact
    here: the simulation and packer see the same next-fit rule)."""
    uniform = build_fake_nih(num_images=240, image_size=64, seed=3)
    tr = PackedTrainer(_cfg(tmp_path), seq_len=48, grids=GRIDS,
                       batch_seqs=8, store=uniform.store,
                       pretrained=False, census_sample=16)
    real = sum(1 for _ in tr._train_batches(epoch=0))
    # uniform resolutions -> the census simulation is exact
    assert tr.steps_per_epoch == real
    tr.close()


def test_streaming_packer_rejects_oversized_image(fake_varres):
    """iterate_packed_batches must fail fast (like pack_images) when one
    image needs more tokens than seq_len — not emit an empty pack and
    crash assemble with a broadcast error."""
    from chestxray_vit_tpu.data import packing as pk
    from chestxray_vit_tpu.data.pipeline import build_datasets
    from chestxray_vit_tpu.config import DataConfig
    bundle = build_datasets(DataConfig(backend="memory"),
                            store=fake_varres.store)
    with pytest.raises(ValueError, match="tokens > seq_len"):
        list(pk.iterate_packed_batches(
            bundle.train, bundle.blob_map, fake_varres.store,
            batch_seqs=2, patch=16, seq_len=8, grids=GRIDS,
            epoch=0, shuffle=False, num_workers=2))


def test_epoch_boundary_save_after_resume_writes_zero_cursor(tmp_path):
    """Regression (round-3 review): an epoch-boundary _save (batch_idx=0)
    issued AFTER a mid-epoch resume must write image count 0 for the new
    epoch — not leak the previous epoch's resume offset, which would make
    a later resume skip never-trained data."""
    fake = build_fake_nih(num_images=60, image_size=64, seed=9)
    cfg = _cfg(tmp_path)
    tr = PackedTrainer(cfg, seq_len=48, grids=GRIDS, batch_seqs=8,
                       store=fake.store, pretrained=False, census_sample=4)
    # simulate the state after resuming mid-epoch with 30 images consumed
    tr._resume_skip = 30
    tr._local_skip = 30
    tr._images_cum = [30]
    tr._save(step=5, epoch=1, batch_idx=0)   # new-epoch boundary save
    tr.ckpt.wait()
    _, cursor, _ = tr.ckpt.restore(5, tr.state)
    assert cursor.epoch == 1
    assert cursor.batch_in_epoch == 0
    tr.close()


def test_single_host_resume_of_multihost_cursor_rejected(tmp_path,
                                                         fake_varres):
    """A multi-host packed checkpoint consumed interleaved shards; a
    single-host prefix skip of the unsharded order would train some
    images twice and never see others — must raise, mirroring the
    hosts>1 topology guard."""
    from chestxray_vit_tpu.train.checkpoint import DataCursor
    tr = PackedTrainer(_cfg(tmp_path), seq_len=48, grids=GRIDS,
                       batch_seqs=8, store=fake_varres.store,
                       pretrained=False)
    tr._restored_cursor = DataCursor(epoch=0, batch_in_epoch=5, per_host=[3, 2])
    with pytest.raises(ValueError, match="host count"):
        next(tr._train_batches(0, skip=5))
    # a 1-host cursor (or none) resumes normally
    tr._restored_cursor = DataCursor(epoch=0, batch_in_epoch=5, per_host=[5])
    next(tr._train_batches(0, skip=5))
