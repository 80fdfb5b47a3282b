"""Typed configuration for the whole framework.

The reference exposes its knobs as module-level constants (recovered pyc
source L64-L91 of /root/reference/__pycache__/ViT-Training.cpython-310.pyc)
and as a literal ``config`` dict (/root/reference/ViT-Training.py:155-166),
with no CLI. This module exposes the union of both knob surfaces as typed
dataclasses with the same names, plus a CLI built on argparse.

Two presets reproduce the two reference variants:

- :func:`version_b_config` — the GCS-streaming production pipeline
  (pyc L64-L91: IMG_SIZE=384, BATCH_SIZE_PER_CORE=8, LR=1e-4, WD=0.01,
  4 epochs, eval/save every 500 steps, best-by-avg_auroc).
- :func:`version_a_config` — the checked-in HF-datasets variant
  (ViT-Training.py:155-166: batch 32 train / 64 eval, LR=2e-5, 5 epochs,
  per-epoch eval/save, best-by-f1_micro).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple

# Normalization constants — a parity subtlety worth spelling out:
# the reference DEFINES ImageNet constants (pyc L78-L79: VIT_MEAN/VIT_STD)
# but never uses them — both variants normalize through HF
# ViTImageProcessor (pyc L300; ViT-Training.py:57-63 reads
# processor.image_mean/std), whose google/vit values are 0.5/0.5. So the
# reference's EFFECTIVE normalization is mean=std=0.5; its ImageNet
# constants are dead code. We default to the effective behavior and keep
# both sets available (DataConfig.image_mean/image_std to switch).
PROCESSOR_MEAN: Tuple[float, float, float] = (0.5, 0.5, 0.5)
PROCESSOR_STD: Tuple[float, float, float] = (0.5, 0.5, 0.5)
# the reference's (unused) ImageNet constants, kept for parity/compat
VIT_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
VIT_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)

# ModelConfig.attention_impl values (ops/attention.py): 'auto' takes cuDNN
# fused attention on a GPU and XLA elsewhere; 'cudnn' and 'xla' force one.
ATTENTION_IMPLS: Tuple[str, ...] = ("auto", "cudnn", "xla")

# The canonical NIH ChestX-ray14 class vocabulary produced by the reference's
# label engine (pyc L152-L157): 14 pathologies + 'No Finding', sorted.
NIH_CLASSES: Tuple[str, ...] = (
    "Atelectasis",
    "Cardiomegaly",
    "Consolidation",
    "Edema",
    "Effusion",
    "Emphysema",
    "Fibrosis",
    "Hernia",
    "Infiltration",
    "Mass",
    "No Finding",
    "Nodule",
    "Pleural_Thickening",
    "Pneumonia",
    "Pneumothorax",
)


@dataclass
class DataConfig:
    """Input-pipeline and dataset-layout knobs.

    Mirrors the reference's GCS layout constants (pyc L64-L70) and its
    subsetting knob USE_SUBSET_DATA (pyc L89, README.md:29,82).
    """

    # Storage backend: 'gcs' streams from a bucket like the reference;
    # 'local' reads the same layout from a directory; 'memory' is the
    # in-process fake store used by tests; 'hf_dataset' loads a prepackaged
    # HF dataset (the Version A path, ViT-Training.py:38).
    backend: str = "local"
    hf_dataset_name: str = "kerem/nih-chest-xray-14"   # ViT-Training.py:159
    gcp_project_id: str = ""
    gcs_bucket_name: str = ""
    gcs_image_base_prefix: str = ""
    local_root: str = ""

    # Metadata files, relative to the bucket/base prefix (pyc L66-L69).
    bbox_csv: str = "BBox_List_2017.csv"
    data_entry_csv: str = "Data_Entry_2017.csv"
    train_val_list: str = "train_val_list.txt"
    test_list: str = "test_list.txt"

    # Image folders images_001/images/ .. images_012/images/ (pyc L222).
    num_image_folders: int = 12
    image_folder_template: str = "images_{:03d}/images/"

    # USE_SUBSET_DATA: when an int N, train uses the first N samples and val
    # the first N // 5 (pyc L254-L255, L431).
    use_subset_data: Optional[int] = None

    # Split scheme. 'official_lists' = Version B: official train_val/test
    # list files, then train/val via train_test_split(test_size=0.15,
    # random_state=42) (pyc L407-L415). 'random_80_10_10' = Version A:
    # 80/10/10 with seed 42 (ViT-Training.py:39-46).
    split_scheme: str = "official_lists"
    val_fraction: float = 0.15
    split_seed: int = 42

    # Whether to crop to the first bbox when one exists for the image
    # (pyc L289-L291), else pad-to-square.
    use_bbox_roi: bool = True

    # Normalization. Defaults = the reference's EFFECTIVE values (HF
    # ViTImageProcessor's 0.5/0.5, see PROCESSOR_MEAN note above); set to
    # VIT_MEAN/VIT_STD for ImageNet-style normalization.
    image_mean: Tuple[float, float, float] = PROCESSOR_MEAN
    image_std: Tuple[float, float, float] = PROCESSOR_STD

    # Augmentation for the Version-A parity path (ViT-Training.py:62-63):
    # RandomResizedCrop(img_size) + RandomHorizontalFlip on train.
    augment: bool = False
    # Mixup (beyond the reference; Zhang et al. 2018 adapted to
    # multi-label BCE): λ ~ Beta(α, α) per step, partners are the
    # batch rolled by one (a cheap neighbor ppermute under data-axis
    # sharding — no all-to-all gather), images AND multi-hot labels mixed
    # inside the jitted train step. 0.0 disables.
    mixup_alpha: float = 0.0

    # Where the crop/pad/resize/normalize chain runs (SURVEY §3.3):
    # 'host' resizes on the CPU and ships u8 384² grayscale (fewest
    # host→device bytes); 'device' ships the raw decode canvas + crop box
    # and runs the fused matmul preprocess inside the train step's jit (fewest
    # host CPU cycles — the right trade when decode threads are the
    # bottleneck).
    preprocess_placement: str = "host"      # 'host' | 'device'

    # Host pipeline shape.
    num_workers: int = 8            # decode thread count (A: num_workers=8)
    prefetch_depth: int = 4         # batches buffered ahead of the device
    decode_canvas: int = 1024       # fixed host canvas (NIH natives are 1024²)
    shuffle_buffer_seed: int = 42


@dataclass
class ModelConfig:
    """ViT architecture knobs. Defaults = google/vit-base-patch16-384
    (ViT-Training.py:158, pyc L76), the reference's only model."""

    model_name: str = "google/vit-base-patch16-384"
    img_size: int = 384             # IMG_SIZE (pyc L77)
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    num_classes: int = 15           # NUM_CLASSES (pyc L174): 14 + No Finding
    layernorm_eps: float = 1e-12    # HF ViTConfig default
    # HF ViT uses EXACT erf GELU; the tanh approximation trades ~1e-3
    # activation error for a cheaper polynomial — opt-in for from-scratch
    # training, OFF for parity.
    gelu_approximate: bool = False
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    # Representation/activations dtype under training (XLA_USE_BF16=1 in the
    # reference, pyc L7); master params stay float32.
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # Gradient checkpointing.
    remat: bool = False
    # 'full' recomputes the whole block in backward; 'mlp' saves everything
    # except the 4×-wide MLP hidden activations (cheapest recompute, biggest
    # single memory term); 'dots' saves matmul outputs only.
    remat_policy: str = "full"
    # One of ATTENTION_IMPLS: 'auto' runs cuDNN fused attention on a GPU
    # and the XLA reference implementation elsewhere (ops/attention.py).
    attention_impl: str = "auto"
    # Fuse the three [D, D] Q/K/V projections into one [D, 3D] matmul
    # (weights stacked once per step outside the scan; numerics identical).
    # Opt-in pending measurement.
    fused_qkv: bool = False
    # Token merging DURING training (and in the matching train-time eval):
    # merge the r most-similar token pairs after every layer's attention
    # (ToMe, arXiv:2210.09461 — a training accelerator in the paper, §4.2).
    # The routing-matmul merge (ops/tome.py) is differentiable by
    # construction, so gradients flow through the size-weighted means;
    # the bipartite matching itself is piecewise-constant (no gradient),
    # exactly like the paper's formulation. 0 = off (the reference's
    # semantics). Quality/speed tradeoff knob — see README "Quality".
    tome_r: int = 0
    # Per-layer distribution of the merge budget: 'constant' (r pairs in
    # every layer, the paper's default) or 'decreasing' (linearly decaying
    # counts with the same r·L total — front-loads merging where tokens
    # are plentiful and avoids the deep-layer clamp floor on long stacks;
    # ops/tome.r_schedule). Only read when tome_r > 0.
    tome_schedule: str = "constant"

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def __post_init__(self):
        # fail at construction, not deep inside jit tracing: e.g. --model
        # vit_h14 with a 384-px preset (384 % 14 != 0) used to crash in
        # patchify's reshape with an opaque size-mismatch error
        if self.img_size % self.patch_size:
            raise ValueError(
                f"img_size {self.img_size} is not a multiple of patch_size "
                f"{self.patch_size} — patchify cannot tile the image (e.g. "
                f"patch 14 needs img_size 224/392/448; set model.img_size)")
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"hidden_size {self.hidden_size} is not divisible by "
                f"num_heads {self.num_heads}")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"model.attention_impl must be one of {ATTENTION_IMPLS}, got "
                f"{self.attention_impl!r}")
        if self.tome_schedule not in ("constant", "decreasing"):
            raise ValueError(
                f"model.tome_schedule must be 'constant' or 'decreasing', "
                f"got {self.tome_schedule!r}")


# The standard ViT family (An Image is Worth 16x16 Words, Table 1, plus the
# Ti/S additions from the DeiT/AugReg line): name → (hidden, layers, heads,
# mlp, patch, HF checkpoint when an official @384 one exists). The reference
# uses only B/16 (pyc L76); the rest widen the same from-scratch model.
VIT_VARIANTS = {
    "vit_ti16": (192, 12, 3, 768, 16, None),
    "vit_s16": (384, 12, 6, 1536, 16, None),
    "vit_b16": (768, 12, 12, 3072, 16, "google/vit-base-patch16-384"),
    "vit_b32": (768, 12, 12, 3072, 32, "google/vit-base-patch32-384"),
    "vit_l16": (1024, 24, 16, 4096, 16, "google/vit-large-patch16-384"),
    "vit_h14": (1280, 32, 16, 5120, 14, "google/vit-huge-patch14-224-in21k"),
}


def vit_variant_config(variant: str, img_size: int = 384,
                       num_classes: int = 15) -> ModelConfig:
    """ModelConfig for a named ViT variant (``VIT_VARIANTS`` keys); L/H
    default to remat (gradient checkpointing)."""
    if variant not in VIT_VARIANTS:
        raise KeyError(f"unknown variant {variant!r}; "
                       f"one of {sorted(VIT_VARIANTS)}")
    hidden, layers, heads, mlp, patch, hf_name = VIT_VARIANTS[variant]
    return ModelConfig(
        model_name=hf_name or f"scratch/{variant}",
        img_size=img_size,
        patch_size=patch,
        hidden_size=hidden,
        num_layers=layers,
        num_heads=heads,
        mlp_dim=mlp,
        num_classes=num_classes,
        remat=hidden >= 1024,
    )


def vit_large_config(img_size: int = 384, num_classes: int = 15) -> ModelConfig:
    """ViT-L/16."""
    return vit_variant_config("vit_l16", img_size, num_classes)


@dataclass
class TrainConfig:
    """Optimization & orchestration knobs.

    Union of the reference's TrainingArguments surfaces:
    Version B (pyc L438-L456) and Version A (ViT-Training.py:92-132).
    """

    batch_size_per_core: int = 8            # BATCH_SIZE_PER_CORE (pyc L83)
    eval_batch_size_per_core: Optional[int] = None  # A uses 64 (.py:162)
    # HF TrainingArguments surface (default 1 in both reference variants):
    # k micro-batches run sequentially inside one jitted step (lax.scan),
    # gradients averaged, ONE optimizer update — effective batch = k x
    # batch_size_per_core x data-parallel world, with micro-batch memory.
    gradient_accumulation_steps: int = 1
    learning_rate: float = 1e-4             # LEARNING_RATE (pyc L84)
    weight_decay: float = 0.01              # WEIGHT_DECAY (pyc L85)
    num_epochs: float = 4                   # NUM_EPOCHS (pyc L86)
    max_steps: Optional[int] = None         # overrides epochs when set
    lr_schedule: str = "linear"             # HF Trainer default: linear decay
    warmup_steps: int = 0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0              # HF Trainer default clipping

    # Cadence. Version B: steps-based eval/save 500, log 50 (pyc L442-L447).
    # Version A: per-epoch ('epoch') eval/save, log 100 (.py:98-101).
    eval_strategy: str = "steps"            # 'steps' | 'epoch' | 'no'
    eval_steps: int = 500
    save_strategy: str = "steps"
    save_steps: int = 500
    logging_steps: int = 50
    save_total_limit: int = 2               # (pyc L450)
    load_best_model_at_end: bool = True
    metric_for_best_model: str = "avg_auroc"  # B (pyc L455); A: 'f1_micro'
    greater_is_better: bool = True

    bf16: bool = True                       # (pyc L444; .py:105)
    # Persistent XLA compilation cache directory (beyond the reference,
    # whose torch_xla recompiles lazily every run): compiled executables
    # are cached on disk so restarts/resumes skip the first compile of the
    # train/eval steps. JAX_COMPILATION_CACHE_DIR, when set, wins; None
    # means <checkout>/.xla_cache (utils/compilation_cache.py). Works with
    # gs:// paths too.
    compilation_cache_dir: Optional[str] = None
    # Preemption safety (beyond the reference, whose dead worker kills the
    # job, SURVEY §5): SIGTERM/SIGINT triggers one final checkpoint before
    # a clean exit, so `resume_from_checkpoint=auto` continues exactly.
    save_on_preemption: bool = True
    # Divergence guard (beyond the reference): a non-finite loss observed
    # at a sync point raises immediately with the step number instead of
    # silently training on garbage for the rest of the run. 'off' disables.
    nan_guard: str = "raise"                # 'raise' | 'off'
    # predict CLI: fit per-class decision thresholds on the validation
    # split (max per-class F1) instead of the reference's fixed 0.5
    # before writing the test classification report.
    calibrate_thresholds: bool = False
    # Run eval/predict forwards on the int8 matmul path (beyond the
    # reference; speed on the H100 not measured yet). 'static' calibrates
    # per-site activation scales on the first
    # batch of each evaluated split; 'dynamic' uses per-token scales
    # (accuracy-safest, slower). Training STEPS always stay bf16; every
    # evaluate()/predict() forward — including mid-training cadence evals,
    # and therefore best-model selection — uses the quantized logits, so
    # set it for post-training `cli eval`/`predict` runs unless you want
    # that. AUROC agrees with the bf16 eval to ~1e-3 (tested).
    eval_quantize: Optional[str] = None     # None | 'static' | 'dynamic'
    # Token merging for eval/predict forwards (beyond the reference;
    # `models/tome_forward.py`): merge the r most-similar token pairs
    # per layer. Same tradeoff as serving's `tome_r` — throughput is
    # ~linear in merged tokens, fidelity is yours to validate (the eval
    # metrics ARE the merged model's). Composes with eval_quantize.
    eval_tome_r: int = 0
    # Dense warmup for token-merged training (beyond the reference;
    # requires model.tome_r > 0): train the first `tome_warmup` steps
    # with the DENSE step function, then switch merging on — params and
    # LR schedule are continuous across the switch (merging is
    # parameter-free). Motivation (README "Quality", BENCH_QUALITY_AB.jsonl):
    # merged training's measured init-sensitivity is an early-training
    # artifact — on the bad-mode init, a warmup through the dense
    # takeoff window recovered 0.821 -> 0.977 avg_auroc, within ~1.5 pts
    # of dense, while keeping most of the merge throughput (a fixed
    # warmup amortizes toward the full merged rate on longer runs).
    # Rule of thumb: set it to the step where a dense run's metric
    # leaves its floor (~30-40% of a short fine-tune's schedule).
    # Values >= 1 are absolute steps; a fraction in (0, 1) means that
    # fraction of the run's total steps (resolved once at trainer
    # construction), so presets can carry the recipe without knowing
    # the schedule length.
    tome_warmup: float = 0
    seed: int = 42
    output_dir: str = "./outputs"
    report_to: str = "tensorboard"          # B (pyc L453); A: 'none'
    resume_from_checkpoint: Optional[str] = None
    profile_steps: Optional[Tuple[int, int]] = None  # (start, stop) profiler

    @property
    def eval_batch_size(self) -> int:
        return self.eval_batch_size_per_core or self.batch_size_per_core


@dataclass
class MeshConfig:
    """Device-mesh layout. The reference is pure data-parallel over 8
    cores (xmp.spawn, pyc L515); here DP rides a named mesh axis so the same
    step function scales to multi-host and to fsdp/tensor axes later."""

    # -1 = use all available devices on the data axis.
    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    axis_names: Tuple[str, ...] = ("data", "fsdp", "tensor")
    # number of device groups joined by the slower data-center network
    # (e.g. hosts). > 1 adds a leading 'dcn' mesh axis carrying pure data
    # parallelism across groups: the only cross-group collective is the
    # per-step gradient all-reduce (fsdp/tensor stay within a group, on the
    # fast interconnect). 1 = one group, no extra axis.
    dcn_data: int = 1


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_json(text: str) -> "Config":
        raw = json.loads(text)
        return Config(
            data=DataConfig(**raw.get("data", {})),
            model=ModelConfig(**raw.get("model", {})),
            train=TrainConfig(**raw.get("train", {})),
            mesh=MeshConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in raw.get("mesh", {}).items()}),
        )


def version_b_config() -> Config:
    """The production (GCS streaming) pipeline, pyc L64-L91 + L438-L456."""
    return Config(
        data=DataConfig(
            backend="gcs",
            gcs_bucket_name="chest-xray-samir",
            split_scheme="official_lists",
            use_bbox_roi=True,
            augment=False,
        ),
        model=ModelConfig(num_classes=15),
        train=TrainConfig(
            batch_size_per_core=8,
            learning_rate=1e-4,
            weight_decay=0.01,
            num_epochs=4,
            eval_strategy="steps",
            eval_steps=500,
            save_steps=500,
            logging_steps=50,
            metric_for_best_model="avg_auroc",
            report_to="tensorboard",
            output_dir=os.path.expanduser("~/vit_finetune_results"),
        ),
    )


def version_a_config() -> Config:
    """The checked-in HF-datasets variant, ViT-Training.py:92-132,155-166."""
    return Config(
        data=DataConfig(
            backend="local",
            split_scheme="random_80_10_10",
            use_bbox_roi=False,
            augment=True,
        ),
        model=ModelConfig(num_classes=15),
        train=TrainConfig(
            batch_size_per_core=32,
            eval_batch_size_per_core=64,
            learning_rate=2e-5,
            weight_decay=0.0,
            num_epochs=5,
            eval_strategy="epoch",
            save_strategy="epoch",
            logging_steps=100,
            metric_for_best_model="f1_micro",
            report_to="none",
            output_dir="./nih-xray-vit-programmatic-finetuned",
        ),
    )


def fast_finetune_config() -> Config:
    """The token-merging TRAIN recipe as one flag: version_b's
    optimization surface plus batch 36/chip, full gradient checkpointing,
    and differentiable token merging with the decreasing schedule. The
    batch and remat choice were sized for a 16 GB accelerator and have not
    been re-swept on the H100's 80 GB (ROADMAP Speed item 5).

    Ships with tome_r=16 decreasing AND a 37.5% dense warmup
    (train.tome_warmup=0.375 — fraction of total steps). Why the warmup
    is part of the recipe (convergence data in BENCH_QUALITY_AB.jsonl,
    gated in tests/test_quality_band.py): merged training without it is
    INIT-SENSITIVE at every measured budget (bad-mode inits flatten at
    the ~0.82 easy-class floor vs dense 0.99 on the hard synthetic
    task); training dense through the takeoff window rescues every
    measured (budget, init) cell to within ~1.8 pts of dense — at the
    preset budget, r16 on the bad init went 0.8174 -> 0.9919. The
    warmup is a fixed fraction, so longer fine-tunes amortize it toward
    the full merged rate. r=16 over r=32: equal measured floors, but the
    smaller budget discards strictly less information. Validation on
    real data: `examples/finetune_nih.py --expect-tome-band`."""
    cfg = version_b_config()
    cfg.model.remat = True
    cfg.model.tome_r = 16
    cfg.model.tome_schedule = "decreasing"
    cfg.train.batch_size_per_core = 36
    cfg.train.tome_warmup = 0.375
    return cfg


_PRESETS = {
    "version_a": version_a_config,
    "version_b": version_b_config,
    "fast_finetune": fast_finetune_config,
    "default": Config,
}


def _set_by_path(cfg: Config, dotted: str, value: str) -> None:
    """Set cfg.<section>.<field> from a CLI string, coercing to field type."""
    parts = dotted.split(".")
    obj: Any = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    name = parts[-1]
    if not hasattr(obj, name):
        raise KeyError(f"unknown config key: {dotted}")
    current = getattr(obj, name)
    fields = {f.name: f for f in dataclasses.fields(obj)}
    ftype = fields[name].type if name in fields else type(current)
    text = str(ftype)
    if value.lower() in ("none", "null"):
        coerced: Any = None
    elif "Tuple" in text or "tuple" in text:
        # must precede the int/float checks: 'Tuple[int, int]' contains 'int'
        coerced = tuple(json.loads(value))
    elif "bool" in text:
        coerced = value.lower() in ("1", "true", "yes", "on")
    elif "int" in text:
        coerced = int(value)
    elif "float" in text:
        coerced = float(value)
    else:
        coerced = value
    setattr(obj, name, coerced)


def parse_cli(argv: Optional[Sequence[str]] = None) -> Config:
    """CLI: ``--preset version_b --set train.learning_rate=3e-4 ...``"""
    ap = argparse.ArgumentParser(prog="chestxray_vit_tpu")
    ap.add_argument("--preset", default="default", choices=sorted(_PRESETS))
    ap.add_argument("--model", default=None, choices=sorted(VIT_VARIANTS),
                    help="swap the model family variant (keeps img_size "
                         "and num_classes from the preset)")
    ap.add_argument("--config", default=None, help="path to a JSON config")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override, e.g. --set train.learning_rate=1e-4")
    ns = ap.parse_args(argv)
    if ns.config:
        with open(ns.config) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = _PRESETS[ns.preset]()
    overrides = []
    for kv in ns.set:
        key, _, value = kv.partition("=")
        overrides.append((key.strip(), value.strip()))
    if ns.model:
        # --set model.img_size/num_classes must reach vit_variant_config
        # BEFORE construction: e.g. vit_h14 (patch 14) cannot be built at a
        # preset's img_size 384 (384 % 14 != 0) — the variant has to be
        # constructed with the overridden geometry, not patched afterwards
        pre = dict(overrides)
        img_size = int(pre.get("model.img_size", cfg.model.img_size))
        num_classes = int(pre.get("model.num_classes",
                                  cfg.model.num_classes))
        cfg.model = vit_variant_config(ns.model, img_size, num_classes)
    for key, value in overrides:
        _set_by_path(cfg, key, value)
    return cfg
