"""Owned tfevents writer: round-trip, CRC integrity, and torch-free
operation of the tensorboard logging path."""

import builtins
import glob
import os

import pytest

from chestxray_vit_tpu.utils import tfevents as tfe
from chestxray_vit_tpu.utils.logging import MetricLogger


def _event_files(d):
    return sorted(glob.glob(os.path.join(d, "events.out.tfevents.*")))


def test_scalar_round_trip(tmp_path):
    w = tfe.EventWriter(str(tmp_path))
    w.add_scalar("train/loss", 0.75, 1)
    w.add_scalar("train/loss", 0.5, 2)
    w.add_scalar("eval/avg_auroc", 0.91, 2)
    w.close()
    (path,) = _event_files(str(tmp_path))
    got = tfe.read_scalars(path)
    assert (1, "train/loss") == got[0][:2]
    assert got[0][2] == pytest.approx(0.75)
    assert (2, "train/loss") == got[1][:2]
    assert got[1][2] == pytest.approx(0.5)
    assert (2, "eval/avg_auroc") == got[2][:2]
    assert got[2][2] == pytest.approx(0.91)


def test_file_version_header_and_crcs(tmp_path):
    w = tfe.EventWriter(str(tmp_path))
    w.add_scalar("a", 1.0, 7)
    w.close()
    (path,) = _event_files(str(tmp_path))
    records = list(tfe.read_records(path))   # raises on any CRC mismatch
    assert len(records) == 2
    assert b"brain.Event:2" in records[0]


def test_corruption_detected(tmp_path):
    w = tfe.EventWriter(str(tmp_path))
    w.add_scalar("a", 1.0, 7)
    w.close()
    (path,) = _event_files(str(tmp_path))
    data = bytearray(open(path, "rb").read())
    data[-6] ^= 0xFF                         # flip a payload byte
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError):
        list(tfe.read_records(path))


def test_tensorboard_reader_cross_check(tmp_path):
    """TensorBoard's own event reader parses our files (skipped when the
    tensorboard package isn't installed)."""
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_file_loader import (
        EventFileLoader)

    w = tfe.EventWriter(str(tmp_path))
    w.add_scalar("train/loss", 0.25, 3)
    w.close()
    (path,) = _event_files(str(tmp_path))
    events = list(EventFileLoader(path).Load())
    # the loader migrates simple_value scalars to tensor form — read both
    scalars = [(e.step, v.tag,
                v.tensor.float_val[0] if v.tensor.float_val
                else v.simple_value)
               for e in events for v in e.summary.value]
    assert scalars == [(3, "train/loss", pytest.approx(0.25))]


def test_metric_logger_without_torch(tmp_path, monkeypatch):
    """report_to='tensorboard' works with torch imports blocked — the
    logging path owns its writer instead of borrowing torch's."""
    real_import = builtins.__import__

    def block_torch(name, *a, **kw):
        if name == "torch" or name.startswith("torch."):
            raise ImportError("torch blocked for this test")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", block_torch)
    lg = MetricLogger(str(tmp_path), report_to="tensorboard")
    lg.log(5, {"loss": 1.25})
    lg.close()
    (path,) = _event_files(os.path.join(str(tmp_path), "tb"))
    assert (5, "train/loss", pytest.approx(1.25)) == tfe.read_scalars(path)[0]
