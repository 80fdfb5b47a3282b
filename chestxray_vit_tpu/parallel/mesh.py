"""Device mesh and sharding layout.

The reference scales with one forked process per accelerator core
(``xmp.spawn``, /root/reference/ViT-Training.py:170; pyc L515) and lets
torch_xla all-reduce gradients. Here: a single process with one
``jax.sharding.Mesh`` whose ``data`` axis carries the global batch; under
``jit``, XLA inserts the gradient all-reduce (NCCL over NVLink on GPUs)
automatically from the shardings. ``fsdp`` and ``tensor`` axes are first-class so larger models can
shard parameters/activations without touching the step functions.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from chestxray_vit_tpu.config import MeshConfig


def build_mesh(cfg: Optional[MeshConfig] = None,
               devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Construct the (data, fsdp, tensor) mesh — with a leading ``dcn``
    axis when ``cfg.dcn_data > 1`` (data parallelism across device groups
    joined by a slower network).

    ``data = -1`` consumes all remaining devices. On a single card this
    degenerates to a 1×1×1 mesh and the same step functions still compile —
    the single-device path and the multi-device path are one code path.

    Devices are laid out in ``jax.devices()`` order (the cards of one host
    are joined all to all, so the order carries no topology). With
    ``dcn > 1`` each consecutive block of devices owns one index of the
    ``dcn`` axis and the ``data``/``fsdp``/``tensor`` axes lie within it;
    the batch is additionally split over ``dcn``, so the only collective
    crossing groups is the per-step gradient all-reduce.
    """
    cfg = cfg or MeshConfig()
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    dcn = max(cfg.dcn_data, 1)
    fixed = cfg.fsdp * cfg.tensor
    data = cfg.data if cfg.data != -1 else n // (fixed * dcn)
    if dcn * data * fixed != n:
        raise ValueError(
            f"mesh {'%dx' % dcn if dcn > 1 else ''}{data}x{cfg.fsdp}"
            f"x{cfg.tensor} != {n} devices")
    if dcn == 1:
        arr = np.asarray(devices).reshape(data, cfg.fsdp, cfg.tensor)
        return Mesh(arr, cfg.axis_names)
    arr = np.asarray(devices).reshape(dcn, data, cfg.fsdp, cfg.tensor)
    return Mesh(arr, ("dcn",) + tuple(cfg.axis_names))


def dp_axes(mesh: Mesh) -> tuple:
    """Mesh axes the global batch is split over (in mesh order)."""
    return tuple(a for a in ("dcn", "data", "fsdp")
                 if a in mesh.axis_names)


def dp_size(mesh: Mesh) -> int:
    """Data-parallel world size: product of the batch-carrying axes."""
    out = 1
    for a in dp_axes(mesh):
        out *= mesh.shape[a]
    return out


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Global batch split along the dcn (when present), data, and fsdp
    axes."""
    return NamedSharding(mesh, P(dp_axes(mesh)))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def param_sharding(mesh: Mesh, params) -> "jax.tree_util.PyTreeDef":
    """Sharding tree for parameters.

    Data-parallel parity keeps params replicated. Two optional axes widen it
    without touching the step functions (XLA derives the collectives):

    - ``fsdp`` > 1: the largest matrices (scanned encoder kernels,
      [L, in, out]) are sharded on their widest trailing axis; XLA
      all-gathers them per layer at use and reduce-scatters grads — ZeRO-3
      expressed purely through shardings.
    - ``tensor`` > 1: Megatron-style intra-layer split — qkv and mlp_in
      kernels column-parallel (output dim), wo and mlp_out row-parallel
      (input dim); the residual-stream all-reduce appears after wo/mlp_out.
    """
    fsdp = mesh.shape.get("fsdp", 1)
    tensor = mesh.shape.get("tensor", 1)

    # Megatron placement: name → (sharded axis index within [in, out])
    TP_COL = {"wq", "wk", "wv", "mlp_in"}    # split output dim
    TP_ROW = {"wo", "mlp_out"}               # split input dim

    def rule_with_path(path, leaf):
        names = [getattr(p, "key", None) for p in path]
        dims = [None] * leaf.ndim
        if tensor > 1 and leaf.ndim == 3 and "kernel" in names:
            # scanned block kernels are [L, in, out]
            owner = next((n for n in names if n in TP_COL | TP_ROW), None)
            if owner in TP_COL and leaf.shape[2] % tensor == 0:
                dims[2] = "tensor"
            elif owner in TP_ROW and leaf.shape[1] % tensor == 0:
                dims[1] = "tensor"
        if tensor > 1 and leaf.ndim == 2 and "bias" in names:
            owner = next((n for n in names if n in TP_COL), None)
            if owner is not None and leaf.shape[1] % tensor == 0:
                dims[1] = "tensor"
        if fsdp > 1 and leaf.ndim >= 2:
            order = sorted(range(1, leaf.ndim),
                           key=lambda i: leaf.shape[i], reverse=True)
            for i in order:
                if dims[i] is None and leaf.shape[i] % fsdp == 0:
                    dims[i] = "fsdp"
                    break
        return NamedSharding(mesh, P(*dims))

    return jax.tree_util.tree_map_with_path(rule_with_path, params)


def shard_batch(mesh: Mesh, batch):
    """Place a host batch dict onto the mesh, split along the data axis."""
    sh = batch_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh), batch)


def local_batch_to_global(batch_size_per_core: int, mesh: Mesh) -> int:
    """BATCH_SIZE_PER_CORE × data-parallel world size, matching the
    reference's effective global batch (8 cores × 8 = 64, SURVEY §6)."""
    return batch_size_per_core * dp_size(mesh)
