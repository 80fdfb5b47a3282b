"""Multi-host SPMD utilities.

The reference is strictly single-host (one ``xmp.spawn`` over 8 local cores,
pyc L515); its only cross-process synchronization is the
``xm.rendezvous('download_only_once')`` barrier pair
(/root/reference/ViT-Training.py:35-49). Scaling here instead runs one
process per host over a global mesh: ``jax.distributed.initialize`` wires the
hosts, shardings place the global batch, and barriers come from
``multihost_utils`` (SURVEY §5 'Distributed communication backend').

Everything here degrades to a no-op on a single host, so the same trainer
code runs everywhere.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize multi-host JAX. No-ops when already initialized or when
    the env provides no cluster (single-host dev boxes, CI).

    MUST be the first JAX interaction in the process: even an innocent
    ``jax.process_count()`` initializes the XLA backend, after which
    ``jax.distributed.initialize`` unconditionally raises — so this
    function must not probe JAX state before calling it, and callers must
    invoke it before building meshes/arrays.

    Joins a cluster only when one is explicitly configured (arguments,
    ``JAX_COORDINATOR_ADDRESS``, or ``CXR_MULTIHOST=1`` to opt into JAX's
    cluster auto-detection, e.g. under SLURM) — unconditional
    auto-detection can BLOCK forever waiting for a coordinator on boxes
    whose environment half-describes a cluster."""
    import os
    explicit = bool(coordinator_address
                    or os.environ.get("JAX_COORDINATOR_ADDRESS")
                    or os.environ.get("CXR_MULTIHOST"))
    if not explicit:
        return
    # idempotency probe: the distributed client object exists iff
    # initialize already ran; reading it does NOT initialize the XLA
    # backend (unlike jax.process_count()), so this is safe to check
    # first — and precise, unlike matching exception text, which would
    # swallow genuine failures whose message happens to contain
    # 'once'/'already'
    try:
        from jax._src.distributed import global_state
        if global_state.client is not None:
            return
    except (ImportError, AttributeError):
        pass       # private layout moved/renamed: rely on the raise below
    try:
        kwargs = {}
        if coordinator_address:
            kwargs = dict(coordinator_address=coordinator_address,
                          num_processes=num_processes,
                          process_id=process_id)
        jax.distributed.initialize(**kwargs)
    except Exception as e:                              # noqa: BLE001
        # single-host fallback (the reference's default world too); an
        # explicitly-requested cluster that fails must fail loudly
        if coordinator_address:
            raise
        print(f"[distributed] single-host mode ({e})")


def is_primary() -> bool:
    """The 'rank 0 only' gate (pyc L481: save/log on master ordinal)."""
    return jax.process_index() == 0


def barrier(name: str = "barrier") -> None:
    """xm.rendezvous equivalent; no-op on one process."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(name)


def agree_flag(flag: bool) -> bool:
    """Logical OR of a per-process flag across all processes (identity on
    one process). Used to agree on preemption stops: checkpoint saves are
    COLLECTIVE multi-process operations, so every process must decide to
    stop at the SAME step — a signal landing on one host at step N and on
    another at N+1 would pair the save collectives across different steps
    (deadlock or corrupt cursor)."""
    if jax.process_count() == 1:
        return flag
    from jax.experimental import multihost_utils
    votes = multihost_utils.process_allgather(
        np.asarray([1 if flag else 0], np.int32))
    return bool(np.asarray(votes).any())


def host_shard_range(n: int) -> range:
    """Which global sample indices this host loads: contiguous shard of the
    global batch. Each host decodes only its slice; the global array is
    assembled from per-host shards without any cross-host copy."""
    per = n // jax.process_count()
    start = jax.process_index() * per
    return range(start, start + per)


def form_global_batch(mesh: Mesh, host_batch: Dict[str, np.ndarray]
                      ) -> Dict[str, jax.Array]:
    """Per-host local batch shards → one global sharded batch.

    On a single process this is a plain device_put; multi-host it uses
    ``host_local_array_to_global_array`` so each host contributes its local
    slice of the data axis.
    """
    from chestxray_vit_tpu.parallel.mesh import dp_axes
    spec = P(dp_axes(mesh))
    if jax.process_count() == 1:
        sh = NamedSharding(mesh, spec)
        return {k: jax.device_put(v, sh) for k, v in host_batch.items()}
    from jax.experimental import multihost_utils
    to_global = functools.partial(
        multihost_utils.host_local_array_to_global_array,
        global_mesh=mesh, pspecs=spec)
    return {k: to_global(v) for k, v in host_batch.items()}


def process_allgather(x):
    """Gather a host-local array across processes (eval logit collection on
    multi-host; identity on one process)."""
    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x))


def host_batch_slice(global_batch: int) -> Optional[tuple]:
    """(start, stop) of the global batch this host loads, or None on a
    single process (load everything). Feed to
    ``pipeline.iterate_batches(host_range=...)`` so each host decodes only
    its shard — I/O scales out with hosts, no duplicated decode."""
    if jax.process_count() == 1:
        return None
    r = host_shard_range(global_batch)
    return (r.start, r.stop)


def gather_global_rows(mesh: Mesh, x) -> np.ndarray:
    """Batch-sharded global jax.Array → full host ndarray on every process
    (the eval-loop logit gather, SURVEY §3.4). Identity single-process."""
    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils
    from chestxray_vit_tpu.parallel.mesh import dp_axes
    local = multihost_utils.global_array_to_host_local_array(
        x, mesh, P(dp_axes(mesh)))  # positional pspecs arg
    return np.asarray(multihost_utils.process_allgather(local, tiled=True))


def allgather_host_rows(x) -> np.ndarray:
    """Concatenate per-host row shards across processes (labels assembled on
    the host side). Identity single-process."""
    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(
        np.asarray(x), tiled=True))
