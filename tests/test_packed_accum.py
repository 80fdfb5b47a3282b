"""Packed gradient accumulation: accum=k over k
strided micro-batches must reproduce the one-big-batch numerics EXACTLY —
including when micro-batches carry unequal real-image counts (the
numerator/denominator split in packed_bce_parts is what makes that hold)."""

import jax
import jax.numpy as jnp
import numpy as np

from chestxray_vit_tpu.config import Config, ModelConfig, TrainConfig
from chestxray_vit_tpu.data import packing as pk
from chestxray_vit_tpu.models import vit
from chestxray_vit_tpu.train import steps as S

GRIDS = (2, 3, 4)
CFG = ModelConfig(img_size=64, patch_size=16, hidden_size=64, num_layers=2,
                  num_heads=4, mlp_dim=128, num_classes=5, dtype="float32",
                  attention_impl="xla")


def _batch(rng, n_seqs=8, seq_len=32):
    """Packed batch with deliberately unequal images-per-sequence."""
    sizes = [int(rng.choice([32, 48, 64])) for _ in range(n_seqs * 2)]
    imgs = [rng.integers(0, 255, (s, s), np.uint8) for s in sizes]
    labs = [(rng.random(5) < 0.4).astype(np.float32) for _ in sizes]
    b = pk.pack_images(imgs, labs, patch=16, seq_len=seq_len, grids=GRIDS)
    # pad/crop the pack to exactly n_seqs sequences
    def fit(x):
        out = np.zeros((n_seqs,) + x.shape[1:], x.dtype)
        m = min(n_seqs, x.shape[0])
        out[:m] = x[:m]
        return out
    seg = fit(b.segment_ids)
    seg[b.segment_ids.shape[0]:] = pk.PAD_SEGMENT
    return {"tokens": jnp.asarray(fit(b.tokens)),
            "segment_ids": jnp.asarray(seg),
            "pos_indices": jnp.asarray(fit(b.pos_indices)),
            "pool_weights": jnp.asarray(fit(b.pool_weights)),
            "labels": jnp.asarray(fit(b.labels)),
            "image_mask": jnp.asarray(fit(b.image_mask))}


def _train_cfg(accum):
    return Config(model=CFG,
                  train=TrainConfig(learning_rate=2e-3,
                                    gradient_accumulation_steps=accum))


def test_packed_accum_matches_big_batch(rng):
    batch = _batch(rng)
    # force UNEQUAL real-image counts across the strided micro-batches
    # (the case where naive loss-averaging would be wrong): mask off one
    # image of an even-indexed sequence if the counts happen to be equal
    mask = np.asarray(batch["image_mask"]).copy()
    if mask[0::2].sum() == mask[1::2].sum():
        s = next(i for i in range(0, mask.shape[0], 2) if mask[i].any())
        slot = int(np.nonzero(mask[s])[0][-1])
        mask[s, slot] = False
        batch = dict(batch)
        batch["image_mask"] = jnp.asarray(mask)
    per_seq = mask.sum(axis=1)
    micro_imgs = [per_seq[i::2].sum() for i in range(2)]
    assert micro_imgs[0] != micro_imgs[1]

    params = vit.init_params(jax.random.key(0), CFG)
    state_a = S.TrainState.create(params, 0)
    state_b = S.TrainState.create(params, 0)
    step_big = jax.jit(S.make_packed_train_step(_train_cfg(1), 100, GRIDS))
    step_acc = jax.jit(S.make_packed_train_step(_train_cfg(2), 100, GRIDS))

    for _ in range(3):
        state_a, ma = step_big(state_a, batch)
        state_b, mb = step_acc(state_b, batch)
    np.testing.assert_allclose(float(ma["loss"]), float(mb["loss"]),
                               rtol=1e-6)
    # exact up to f32 addition reassociation (grad sums accumulate in a
    # different order under the scan)
    for a, b in zip(jax.tree.leaves(state_a.params),
                    jax.tree.leaves(state_b.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-5, rtol=2e-4)


def test_packed_trainer_accum_consumes_accum_x_batch_seqs(tmp_path):
    from chestxray_vit_tpu.data.testing import build_fake_nih
    from chestxray_vit_tpu.train.packed_trainer import PackedTrainer

    fake = build_fake_nih(num_images=120, image_size=64, seed=5)
    cfg = Config(
        data=__import__("chestxray_vit_tpu.config",
                        fromlist=["DataConfig"]).DataConfig(backend="memory"),
        model=ModelConfig(img_size=64, patch_size=16, hidden_size=64,
                          num_layers=2, num_heads=4, mlp_dim=128,
                          dtype="float32", attention_impl="xla"),
        train=TrainConfig(learning_rate=1e-3, max_steps=2,
                          gradient_accumulation_steps=2,
                          eval_strategy="no", save_strategy="steps",
                          save_steps=1000, logging_steps=1,
                          load_best_model_at_end=False,
                          output_dir=str(tmp_path / "out"),
                          report_to="none"))
    tr = PackedTrainer(cfg, seq_len=48, grids=GRIDS, batch_seqs=8,
                       store=fake.store, pretrained=False, census_sample=8)
    assert tr._local_step_seqs == 16          # 8 seqs × accum 2
    batches = list(tr._train_batches(epoch=0))
    assert all(b["tokens"].shape[0] == 16 for b in batches)
    tr.train()
    assert int(tr.state.step) == 2
    tr.close()
