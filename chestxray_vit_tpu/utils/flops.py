"""Analytic FLOPs accounting and MFU.

The reference has no performance accounting at all (SURVEY §6: no published
numbers). This module makes model FLOPs and MFU first-class: bench.py and
the Trainer's throughput logging share one analytic model instead of a
hard-coded constant, so MFU claims hold for any ModelConfig (ViT-L, @512,
custom head counts), not just the flagship.
"""

from __future__ import annotations

from typing import Optional

from chestxray_vit_tpu.config import ModelConfig

# Dense bf16 tensor-core peak FLOP/s, keyed by the exact
# ``jax.Device.device_kind`` string. Source: NVIDIA H100 Tensor Core GPU
# data sheet, SXM5 part, 989.4 TFLOP/s bf16 without sparsity, at the
# card's full 700 W power limit. A kind that is not listed has no peak:
# MFU against a guessed peak would be a made-up number.
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def chip_peak_flops(device_kind: Optional[str] = None) -> float:
    """Peak dense bf16 FLOP/s of ``device_kind`` (default: the first local
    device). Raises KeyError for a device kind the table does not know."""
    if device_kind is None:
        import jax
        device_kind = jax.devices()[0].device_kind
    try:
        return PEAK_BF16_FLOPS[device_kind]
    except KeyError:
        raise KeyError(
            f"no bf16 peak known for device kind {device_kind!r}; add it to "
            f"utils/flops.PEAK_BF16_FLOPS with its source") from None


def model_flops_per_image(cfg: ModelConfig, fwd_only: bool = False) -> float:
    """Analytic matmul FLOPs for one image (MACs ×2; elementwise is noise).

    ``fwd_only=False`` returns the fine-tune step cost (fwd + bwd = 3× fwd).
    Remat recompute is deliberately NOT counted: MFU measures useful math
    (the standard convention), so full-remat configs pay their recompute as
    lost MFU.
    """
    s = cfg.seq_len
    d, m = cfg.hidden_size, cfg.mlp_dim
    macs = cfg.num_patches * (cfg.patch_size ** 2 * 3) * d   # patch embed
    per_layer = (4 * s * d * d                               # qkv + proj
                 + 2 * s * s * d                             # QKᵀ + attn·V
                 + 2 * s * d * m)                            # mlp in + out
    macs += cfg.num_layers * per_layer
    macs += d * cfg.num_classes                              # head
    fwd = 2.0 * macs
    return fwd if fwd_only else 3.0 * fwd


def packed_flops_per_sequence(cfg: ModelConfig, seq_len: int,
                              fwd_only: bool = False) -> float:
    """Analytic matmul FLOPs for ONE packed sequence of ``seq_len`` tokens
    (train/packed_trainer.py throughput accounting). Counts the full
    seq_len² attention area the segment-masked attention executes —
    cross-segment products are computed then masked — so packed MFU is
    executed-math utilization, an upper bound on useful-math MFU."""
    s = seq_len
    d, m = cfg.hidden_size, cfg.mlp_dim
    macs = s * (cfg.patch_size ** 2 * 3) * d                 # token embed
    per_layer = (4 * s * d * d + 2 * s * s * d + 2 * s * d * m)
    macs += cfg.num_layers * per_layer
    macs += d * cfg.num_classes
    fwd = 2.0 * macs
    return fwd if fwd_only else 3.0 * fwd


def mfu(images_per_sec_per_chip: float, cfg: ModelConfig,
        device_kind: Optional[str] = None) -> float:
    """Model FLOPs utilization of a measured training throughput."""
    return (images_per_sec_per_chip * model_flops_per_image(cfg)
            / chip_peak_flops(device_kind))
