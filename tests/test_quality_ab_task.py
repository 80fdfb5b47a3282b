"""The HARD synthetic task behind the token-merging quality A/B
(data/testing.render_array_dataset): the fixture must
be deterministic, correctly labelled, and carry a real (but subtle)
per-class signal — the properties the measured quality table rests on."""

import numpy as np

from chestxray_vit_tpu.config import NIH_CLASSES
from chestxray_vit_tpu.data.testing import PATHOLOGIES, render_array_dataset


def test_shapes_dtype_and_determinism():
    x1, y1 = render_array_dataset(48, image_size=64, seed=3)
    x2, y2 = render_array_dataset(48, image_size=64, seed=3)
    assert x1.shape == (48, 64, 64) and x1.dtype == np.uint8
    assert y1.shape == (48, len(NIH_CLASSES)) and y1.dtype == np.float32
    np.testing.assert_array_equal(x1, x2)
    np.testing.assert_array_equal(y1, y2)
    x3, _ = render_array_dataset(48, image_size=64, seed=4)
    assert not np.array_equal(x1, x3)


def test_labels_every_pathology_occurs_and_no_finding_is_exclusive():
    x, y = render_array_dataset(200, image_size=64, seed=0)
    nf = NIH_CLASSES.index("No Finding")
    # the first len(PATHOLOGIES) rows guarantee full vocabulary coverage
    assert (y.sum(axis=0) > 0).all()
    # 'No Finding' rows carry no pathology label, and vice versa
    nf_rows = y[:, nf] == 1.0
    assert nf_rows.any()
    assert y[nf_rows].sum() == nf_rows.sum()     # only the NF column set
    assert (y[~nf_rows][:, nf] == 0).all()
    # every row has at least one label; pathology rows have 1..2
    assert (y.sum(axis=1) >= 1).all()
    assert (y[~nf_rows].sum(axis=1) <= 2).all()


def test_signal_present_but_subtle():
    """Labelled images are brighter than No-Finding images (the block
    exists) but the contrast stays in the 'hard' band — max pixel well
    below the easy fixture's 220."""
    x, y = render_array_dataset(200, image_size=64, seed=1)
    nf = NIH_CLASSES.index("No Finding")
    nf_rows = y[:, nf] == 1.0
    # background-only images peak at the noise ceiling (59)
    assert x[nf_rows].max() <= 60
    # pathology images carry the +contrast block (bounded, not saturated)
    assert x[~nf_rows].max(axis=(1, 2)).min() > 60
    # bounded: at most two (possibly overlapping) +contrast blocks,
    # nowhere near the easy fixture's 220 saturation
    assert x.max() <= 60 + 2 * 40
