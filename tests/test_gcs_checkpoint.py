"""gs:// checkpointing proved against the owned GCS JSON-API emulator
(the '://' special case in train/checkpoint.py and the PARITY claim
'checkpointing to GCS' need test evidence).

Wiring: Orbax touches GCS through two stacks — etils epath for directory
ops and JSON metadata (forced onto the gcsfs/fsspec backend via
EPATH_USE_TF=0, which honors STORAGE_EMULATOR_HOST), and tensorstore for
array storage (honors TENSORSTORE_GCS_HTTP_URL). Both point at the same
in-memory emulator, so save/restore/retention run the REAL gs:// code
paths with zero egress.
"""

import os

import numpy as np
import pytest

import jax

from tests.gcs_emulator import start_emulator

BUCKET = "fake-ckpt-bucket"


@pytest.fixture(scope="module")
def gcs_env():
    em = start_emulator({BUCKET: {}})
    old = {k: os.environ.get(k)
           for k in ("STORAGE_EMULATOR_HOST", "TENSORSTORE_GCS_HTTP_URL",
                     "EPATH_USE_TF", "GOOGLE_AUTH_TOKEN_FOR_TESTING")}
    os.environ["STORAGE_EMULATOR_HOST"] = em.url
    os.environ["TENSORSTORE_GCS_HTTP_URL"] = em.url
    os.environ["EPATH_USE_TF"] = "0"          # epath -> gcsfs backend
    # tensorstore's auth provider otherwise stalls requests hunting for
    # application-default credentials / GCE metadata on this no-egress box
    os.environ["GOOGLE_AUTH_TOKEN_FOR_TESTING"] = "emulator-token"
    # belt-and-suspenders vs import-order races: etils freezes its gs://
    # backend at import, so force the fsspec one explicitly too (conftest
    # sets EPATH_USE_TF=0 early, but a preloaded etils would have cached
    # the tf-gfile backend whose GCS endpoint cannot be overridden)
    try:
        from etils.epath import backend as _bk
        from etils.epath import gpath as _gp
        _gp._PREFIX_TO_BACKEND["gs"] = _bk.fsspec_backend
    except Exception:                                    # noqa: BLE001
        pass
    # gcsfs instances are cached per-parameter; clear so the emulator env
    # is picked up even if another test created a GCSFileSystem earlier
    try:
        import gcsfs
        gcsfs.GCSFileSystem.clear_instance_cache()
    except Exception:                                    # noqa: BLE001
        pass
    yield em
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        import gcsfs
        gcsfs.GCSFileSystem.clear_instance_cache()
    except Exception:                                    # noqa: BLE001
        pass
    em.stop()


def _tiny_state(seed=0):
    from chestxray_vit_tpu.config import ModelConfig
    from chestxray_vit_tpu.models import vit
    from chestxray_vit_tpu.train.steps import TrainState
    cfg = ModelConfig(img_size=32, patch_size=16, hidden_size=16,
                      num_layers=2, num_heads=2, mlp_dim=32, num_classes=3)
    params = vit.init_params(jax.random.key(seed), cfg)
    return TrainState.create(params, seed=seed)


def test_gcs_save_restore_round_trip(gcs_env):
    from chestxray_vit_tpu.train import checkpoint as ckpt
    mgr = ckpt.CheckpointManager(
        f"gs://{BUCKET}/run1/checkpoints", save_total_limit=2,
        metric_for_best=None)
    state = _tiny_state()
    state = state.__class__(step=state.step + 5, params=state.params,
                            opt_state=state.opt_state, rng=state.rng)
    mgr.save(5, state, cursor=ckpt.DataCursor(epoch=1, batch_in_epoch=3))
    mgr.wait()
    # blobs actually landed in the (emulated) bucket
    names = list(gcs_env.bucket(BUCKET))
    assert any("run1/checkpoints/5" in n for n in names), names

    template = _tiny_state(seed=99)   # different values, same structure
    restored, cursor, _ = mgr.restore(5, template)
    assert int(restored.step) == 5
    assert cursor.epoch == 1 and cursor.batch_in_epoch == 3
    for a, b in zip(jax.tree.leaves(restored.params),
                    jax.tree.leaves(state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    mgr.close()


def test_gcs_retention_deletes_old_steps(gcs_env):
    from chestxray_vit_tpu.train import checkpoint as ckpt
    mgr = ckpt.CheckpointManager(
        f"gs://{BUCKET}/run2/checkpoints", save_total_limit=2,
        metric_for_best=None)
    state = _tiny_state()
    for step in (1, 2, 3):
        mgr.save(step, state, cursor=ckpt.DataCursor(0, step))
        mgr.wait()
    steps = sorted(mgr.all_steps())
    assert steps == [2, 3], steps
    # step-1 blobs are gone from the bucket
    names = list(gcs_env.bucket(BUCKET))
    assert not any("run2/checkpoints/1/" in n for n in names), names
    mgr.close()
