"""Async checkpoint save/restore with retention and best-model tracking.

The reference delegates checkpointing to HF Trainer: save every 500 steps,
keep 2, ``load_best_model_at_end`` on ``avg_auroc``, final ``save_model()`` +
``save_state()`` on rank 0 (pyc L445-L456, L482-L485). Its per-rank output
dirs make cross-rank resume incoherent — a caveat SURVEY §5 says NOT to
replicate. Here there is a single logical checkpoint (Orbax
CheckpointManager, async, works against local paths and gs:// URIs alike)
whose train-state is params + optimizer moments + step + RNG + data cursor,
so resume is exact.

Orbax is imported on first use (a save, a restore, or a query of a
directory that holds checkpoints), so training with saving off and serving
from in-memory params run without it installed.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

import jax
import numpy as np

from chestxray_vit_tpu.train.steps import TrainState


@dataclass
class DataCursor:
    """Where the input pipeline stands; part of the checkpoint so resume
    continues mid-epoch instead of replaying data (SURVEY §5 checkpoint).

    ``per_host``: multi-host packed training stores each process's own
    consumed-image count (pack boundaries are content-dependent, so hosts
    consume unequal image counts per step); ``batch_in_epoch`` then carries
    the global sum and each process resumes from ``per_host[rank]``.
    None for dense training (the count is a batch index, identical
    everywhere)."""
    epoch: int = 0
    batch_in_epoch: int = 0
    per_host: Optional[list] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if self.per_host is None:
            del d["per_host"]
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "DataCursor":
        return DataCursor(**d)


class CheckpointManager:
    """Thin wrapper over Orbax: async save, retention, best-metric tracking.

    ``metric_for_best`` + ``greater_is_better`` reproduce HF's
    ``load_best_model_at_end`` semantics: retention keeps the
    ``save_total_limit`` best checkpoints (plus the latest), and
    :meth:`best_step` answers which to restore at the end.
    """

    def __init__(self, directory: str, save_total_limit: int = 2,
                 metric_for_best: Optional[str] = "avg_auroc",
                 greater_is_better: bool = True):
        self.directory = os.path.abspath(os.path.expanduser(directory)) \
            if "://" not in directory else directory
        self.metric_for_best = metric_for_best
        self._save_total_limit = save_total_limit
        self._greater_is_better = greater_is_better
        self._mgr_obj = None

    @property
    def _mgr(self):
        """The Orbax manager, built (and Orbax imported) on first use."""
        if self._mgr_obj is None:
            self._mgr_obj = self._build_manager()
        return self._mgr_obj

    def _started(self) -> bool:
        """Whether there can be checkpoints to query: a manager exists, or
        the directory does (a remote URI always counts)."""
        return (self._mgr_obj is not None or "://" in self.directory
                or os.path.isdir(self.directory))

    def _build_manager(self):
        import orbax.checkpoint as ocp

        metric_for_best = self.metric_for_best
        greater_is_better = self._greater_is_better
        save_total_limit = self._save_total_limit
        if metric_for_best:
            # a save's metrics dict can legitimately lack the key (eval not
            # run at that step, or the value was NaN and got cleaned) — the
            # ranking fn must degrade to worst-possible, never KeyError
            # inside Orbax's async retention sweep
            sentinel = float("-inf") if greater_is_better else float("inf")
            best_fn = lambda m: float(m.get(metric_for_best, sentinel))
            # Orbax's DEFAULT policy when best_fn is set is BestN alone:
            # the latest checkpoint is NOT preserved (a freshly written
            # non-best save is deleted immediately, so a crash rolls
            # resume back to an older best), and with
            # keep_checkpoints_without_metrics=True every metrics-less
            # save is kept forever (unbounded when the save cadence is not
            # aligned with eval). Explicit policy: always the latest, plus
            # the save_total_limit best among metric-bearing saves.
            from orbax.checkpoint.checkpoint_managers import (
                preservation_policy as _pp)
            options = ocp.CheckpointManagerOptions(
                best_fn=best_fn,
                best_mode="max" if greater_is_better else "min",
                preservation_policy=_pp.AnyPreservationPolicy([
                    _pp.LatestN(n=1),
                    _pp.BestN(get_metric_fn=best_fn,
                              reverse=not greater_is_better,
                              n=save_total_limit,
                              keep_checkpoints_without_metrics=False),
                ]),
                enable_async_checkpointing=True,
                create=True,
            )
        else:
            options = ocp.CheckpointManagerOptions(
                max_to_keep=save_total_limit,
                enable_async_checkpointing=True,
                create=True,
            )
        return ocp.CheckpointManager(self.directory, options=options)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: TrainState,
             cursor: Optional[DataCursor] = None,
             metrics: Optional[Dict[str, float]] = None,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Async save; returns immediately, serialization overlaps training
        (the write barrier is :meth:`wait`)."""
        import orbax.checkpoint as ocp

        meta = {"cursor": (cursor or DataCursor()).to_dict(),
                "extra": extra or {}}
        clean_metrics = {k: float(v) for k, v in (metrics or {}).items()
                         if np.isfinite(float(v))}
        self._mgr.save(
            step,
            args=ocp.args.Composite(
                state=ocp.args.StandardSave(_to_savable(state)),
                meta=ocp.args.JsonSave(meta),
            ),
            metrics=clean_metrics or None,
        )

    def wait(self) -> None:
        if self._mgr_obj is not None:
            self._mgr_obj.wait_until_finished()

    # -- restore ------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        return self._mgr.latest_step() if self._started() else None

    def best_step(self) -> Optional[int]:
        return self._mgr.best_step() if self._started() else None

    def all_steps(self):
        return self._mgr.all_steps() if self._started() else []

    def restore(self, step: Optional[int], template: TrainState
                ) -> tuple[TrainState, DataCursor, Dict[str, Any]]:
        """Restore into the template's structure/shardings. ``step=None`` →
        latest."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        import orbax.checkpoint as ocp

        restored = self._mgr.restore(
            step,
            args=ocp.args.Composite(
                state=ocp.args.StandardRestore(_to_savable(template)),
                meta=ocp.args.JsonRestore(),
            ),
        )
        state = _from_savable(restored["state"], template)
        meta = restored["meta"] or {}
        cursor = DataCursor.from_dict(meta.get("cursor", {}))
        return state, cursor, meta.get("extra", {})

    def close(self) -> None:
        if self._mgr_obj is not None:
            self._mgr_obj.wait_until_finished()
            self._mgr_obj.close()


def _to_savable(state: TrainState) -> Dict[str, Any]:
    """TrainState → plain pytree (PRNG keys serialize as uint32 key data)."""
    return {
        "step": state.step,
        "params": state.params,
        "opt_state": state.opt_state,
        "rng": jax.random.key_data(state.rng),
    }


def _from_savable(tree: Dict[str, Any], template: TrainState) -> TrainState:
    return TrainState(
        step=tree["step"],
        params=tree["params"],
        opt_state=tree["opt_state"],
        rng=jax.random.wrap_key_data(jax.numpy.asarray(tree["rng"])),
    )


# ---------------------------------------------------------------------------
# Final model export (trainer.save_model parity, pyc L482)
# ---------------------------------------------------------------------------

def save_model(directory: str, params: Any, config_json: str,
               classes: Optional[list] = None) -> None:
    """Write final inference weights (params-only, msgpack-free Orbax tree)
    plus config + class vocabulary, the analogue of HF ``save_model()``."""
    import orbax.checkpoint as ocp

    directory = os.path.abspath(os.path.expanduser(directory))
    os.makedirs(directory, exist_ok=True)
    ckptr = ocp.StandardCheckpointer()
    path = os.path.join(directory, "params")
    ckptr.save(path, params, force=True)
    ckptr.wait_until_finished()
    with open(os.path.join(directory, "config.json"), "w") as f:
        f.write(config_json)
    if classes is not None:
        with open(os.path.join(directory, "classes.json"), "w") as f:
            json.dump(list(classes), f)


def load_model(directory: str, params_template: Any):
    import orbax.checkpoint as ocp

    directory = os.path.abspath(os.path.expanduser(directory))
    ckptr = ocp.StandardCheckpointer()
    params = ckptr.restore(os.path.join(directory, "params"),
                           params_template)
    classes = None
    cpath = os.path.join(directory, "classes.json")
    if os.path.exists(cpath):
        with open(cpath) as f:
            classes = json.load(f)
    return params, classes
