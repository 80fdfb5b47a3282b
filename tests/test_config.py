"""Config knob surface tests (SURVEY.md §2.2)."""

from chestxray_vit_tpu.config import (
    NIH_CLASSES,
    Config,
    parse_cli,
    version_a_config,
    version_b_config,
    vit_large_config,
)


def test_version_b_knobs_match_reference():
    # pyc L76-L91, L438-L456
    cfg = version_b_config()
    assert cfg.model.model_name == "google/vit-base-patch16-384"
    assert cfg.model.img_size == 384
    assert cfg.model.num_classes == 15
    assert cfg.train.batch_size_per_core == 8
    assert cfg.train.learning_rate == 1e-4
    assert cfg.train.weight_decay == 0.01
    assert cfg.train.num_epochs == 4
    assert cfg.train.eval_steps == 500
    assert cfg.train.save_steps == 500
    assert cfg.train.logging_steps == 50
    assert cfg.train.save_total_limit == 2
    assert cfg.train.metric_for_best_model == "avg_auroc"
    assert cfg.train.bf16
    assert cfg.data.split_scheme == "official_lists"
    assert cfg.data.val_fraction == 0.15
    assert cfg.data.split_seed == 42


def test_version_a_knobs_match_reference():
    # ViT-Training.py:92-132, 155-166
    cfg = version_a_config()
    assert cfg.train.batch_size_per_core == 32
    assert cfg.train.eval_batch_size == 64
    assert cfg.train.learning_rate == 2e-5
    assert cfg.train.num_epochs == 5
    assert cfg.train.eval_strategy == "epoch"
    assert cfg.train.metric_for_best_model == "f1_micro"
    assert cfg.data.augment


def test_model_derived_shapes():
    cfg = Config()
    assert cfg.model.num_patches == 576   # (384/16)^2
    assert cfg.model.seq_len == 577       # + CLS (SURVEY §2.4)
    assert cfg.model.head_dim == 64
    large = vit_large_config()
    assert large.num_layers == 24 and large.seq_len == 577


def test_nih_vocabulary():
    assert len(NIH_CLASSES) == 15
    assert "No Finding" in NIH_CLASSES
    assert list(NIH_CLASSES) == sorted(NIH_CLASSES)


def test_cli_roundtrip_and_overrides():
    cfg = parse_cli(["--preset", "version_b",
                     "--set", "train.learning_rate=3e-4",
                     "--set", "data.use_subset_data=1000",
                     "--set", "model.remat=true"])
    assert cfg.train.learning_rate == 3e-4
    assert cfg.data.use_subset_data == 1000
    assert cfg.model.remat is True
    rt = Config.from_json(cfg.to_json())
    assert rt.train.learning_rate == 3e-4
    assert rt.data.use_subset_data == 1000


def test_use_subset_none_via_cli():
    cfg = parse_cli(["--set", "data.use_subset_data=none"])
    assert cfg.data.use_subset_data is None


def test_cli_tuple_field():
    cfg = parse_cli(["--set", "train.profile_steps=[100, 200]"])
    assert cfg.train.profile_steps == (100, 200)


def test_vit_variants_table():
    """The standard ViT family: dims are internally consistent and each
    variant builds a forwardable config."""
    from chestxray_vit_tpu.config import VIT_VARIANTS, vit_variant_config
    import pytest as _pytest
    for name, spec in VIT_VARIANTS.items():
        patch = spec[4]
        m = vit_variant_config(name, img_size=patch * 4, num_classes=5)
        assert m.hidden_size % m.num_heads == 0, name
        assert m.mlp_dim == 4 * m.hidden_size, name
    assert vit_variant_config("vit_l16").remat
    assert not vit_variant_config("vit_b16").remat
    assert (vit_variant_config("vit_b16").model_name
            == "google/vit-base-patch16-384")
    with _pytest.raises(KeyError, match="unknown variant"):
        vit_variant_config("vit_g14")


def test_cli_model_variant_flag():
    from chestxray_vit_tpu.config import parse_cli
    cfg = parse_cli(["--model", "vit_s16", "--set", "model.img_size=224"])
    assert cfg.model.hidden_size == 384
    assert cfg.model.num_layers == 12
    assert cfg.model.num_heads == 6
    assert cfg.model.img_size == 224          # --set applies after --model
    assert cfg.model.num_classes == 15        # preserved from preset


def test_variant_forward_tiny():
    """A non-default family member actually trains a step (Ti at 32px)."""
    import jax
    import numpy as np
    import jax.numpy as jnp
    import dataclasses
    from chestxray_vit_tpu.config import (Config, TrainConfig,
                                          vit_variant_config)
    from chestxray_vit_tpu.models import vit
    from chestxray_vit_tpu.train import steps as S
    m = dataclasses.replace(
        vit_variant_config("vit_ti16", img_size=32, num_classes=5),
        dtype="float32", attention_impl="xla", num_layers=2)
    cfg = Config(model=m, train=TrainConfig(batch_size_per_core=2))
    params = vit.init_params(jax.random.key(0), m)
    state = S.TrainState.create(params, seed=0)
    step = jax.jit(S.make_train_step(cfg, total_steps=10))
    rng = np.random.default_rng(0)
    batch = {
        "pixel_values": jnp.asarray(
            rng.standard_normal((4, 32, 32, 3)), jnp.float32),
        "labels": jnp.asarray((rng.random((4, 5)) < 0.3), jnp.float32),
    }
    state, met = step(state, batch)
    assert np.isfinite(float(met["loss"]))


def test_model_config_validates_tiling():
    """img_size must tile by patch_size at construction (the --model
    vit_h14 @384 case used to crash deep inside jit tracing instead)."""
    import pytest as _pytest
    from chestxray_vit_tpu.config import ModelConfig, vit_variant_config
    with _pytest.raises(ValueError, match="multiple of patch_size"):
        ModelConfig(img_size=384, patch_size=14)
    with _pytest.raises(ValueError, match="multiple of patch_size"):
        vit_variant_config("vit_h14")          # default img_size=384
    m = vit_variant_config("vit_h14", img_size=392)
    assert m.num_patches == 28 * 28
    with _pytest.raises(ValueError, match="num_heads"):
        ModelConfig(hidden_size=100, num_heads=12)


def test_fast_finetune_preset_pins_measured_best_recipe():
    """--preset fast_finetune is the measured-best train recipe as one
    flag: version_b's optimization surface + the
    chip-measured throughput levers, value-pinned like version_a/b."""
    from chestxray_vit_tpu.config import fast_finetune_config, parse_cli

    cfg = fast_finetune_config()
    b = version_b_config()
    # the throughput levers
    assert cfg.model.tome_r == 16
    assert cfg.model.tome_schedule == "decreasing"
    assert cfg.model.remat is True
    assert cfg.train.batch_size_per_core == 36
    # the measured init-sensitivity rescue ships with the preset
    # (README "Quality": r16 bad init 0.8174 -> 0.9919
    # with a 37.5% dense warmup); fraction of total steps
    assert cfg.train.tome_warmup == 0.375
    # the optimization surface stays version_b's (pyc L438-L456)
    assert cfg.train.learning_rate == b.train.learning_rate
    assert cfg.train.weight_decay == b.train.weight_decay
    assert cfg.train.num_epochs == b.train.num_epochs
    assert cfg.train.metric_for_best_model == "avg_auroc"
    assert cfg.model.img_size == 384 and cfg.model.num_classes == 15

    # reachable from the CLI, and --set still overrides on top
    cli = parse_cli(["--preset", "fast_finetune",
                     "--set", "model.tome_r=32"])
    assert cli.model.tome_r == 32 and cli.model.tome_schedule == "decreasing"
