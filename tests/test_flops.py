"""Peak table and FLOPs accounting (utils/flops.py): one entry per exact
device kind, and no guessed peak for a kind the table does not know."""

import pytest

from chestxray_vit_tpu.config import ModelConfig
from chestxray_vit_tpu.utils import flops as F


def test_h100_peak_is_the_data_sheet_bf16_rate():
    assert F.chip_peak_flops("NVIDIA H100 80GB HBM3") == 989e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100"])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(KeyError, match="no bf16 peak"):
        F.chip_peak_flops(kind)


def test_mfu_against_the_h100_peak():
    cfg = ModelConfig(num_classes=15)
    per_image = F.model_flops_per_image(cfg)
    assert F.model_flops_per_image(cfg, fwd_only=True) * 3 == per_image
    ips = 989e12 / per_image                 # exactly the peak rate
    assert F.mfu(ips, cfg, "NVIDIA H100 80GB HBM3") == pytest.approx(1.0)
