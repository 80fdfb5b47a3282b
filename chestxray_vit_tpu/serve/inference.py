"""Batched inference / serving path.

The reference has no serving path (training script only); this module adds
one: a jit-compiled predictor with fused on-device preprocessing (raw u8
canvases + crop boxes in, per-class probabilities out), static-shape
micro-batching with tail padding, and optional attention-rollout /
Grad-CAM maps per request.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from chestxray_vit_tpu.config import Config, ModelConfig
from chestxray_vit_tpu.data import decode as dec
from chestxray_vit_tpu.data import geometry as geo
from chestxray_vit_tpu.models import vit
from chestxray_vit_tpu.ops.preprocess import fused_preprocess
from chestxray_vit_tpu.serve import attention_maps as am
from chestxray_vit_tpu.train.checkpoint import load_model


@dataclass
class PredictOutput:
    probs: np.ndarray                       # [N, C]
    logits: np.ndarray                      # [N, C]
    classes: Optional[List[str]] = None
    maps: Optional[np.ndarray] = None       # [N, g, g] when requested


class Predictor:
    """Serving wrapper around a trained model.

    ``from_model_dir`` loads a Trainer ``save_model()`` export; inputs are
    raw image bytes (PNG/JPEG) — decode happens on host threads, everything
    from the u8 canvas onward (crop/pad/resize/normalize/ViT) is one
    compiled device program per micro-batch shape.
    """

    def __init__(self, params, cfg: ModelConfig,
                 classes: Optional[Sequence[str]] = None,
                 batch_size: int = 8, canvas_size: int = 1024,
                 placement: str = "host", quantize=False,
                 calibration: Optional[Sequence[np.ndarray]] = None,
                 data_parallel=False, qparams=None, tome_r: int = 0,
                 tome_schedule: str = "constant"):
        """``placement`` picks where crop/pad/resize runs:

        - 'host' (default): decode + native C++ crop/pad/resize on host,
          ship u8 img² grayscale (~147 KB/image at 384) — the right trade
          when host→device bandwidth dominates request latency;
        - 'device': ship raw u8 canvases + crop boxes (~1 MB/image) and run
          the fused matmul preprocess on device — the right trade when host CPU
          is the bottleneck.

        ``quantize`` serves the int8 forward (per-channel int8
        weights prepared here once; ``models/quantized.py``):

        - ``True`` / ``'dynamic'``: per-token dynamic activation scales —
          accuracy-safest, 4× smaller weights, bf16-comparable speed;
        - ``'static'``: per-site scales calibrated once on
          ``calibration`` (u8 grayscale arrays; a seeded synthetic batch
          when omitted — ViT activation ranges are LayerNorm-dominated,
          so synthetic calibration tracks real data; pass real images
          for production) — the fully fusable path.

        Probability deltas vs f32 are oracle-tested for both modes;
        rollout maps always use the f32 path.

        ``data_parallel`` shards each micro-batch over the ``data`` axis
        of a device mesh (``True`` = all visible devices, an int = the
        first N) with replicated params — multi-chip serving throughput
        through the same API; micro-batch buckets round up to a multiple
        of the mesh size. Composes with ``quantize``.

        ``qparams`` injects a prebuilt quantized tree
        (``models.quantized.load_quantized`` — the `cli quantize`
        artifact), skipping the per-startup quantize pass and, for
        static mode, the calibration forward.

        ``tome_r`` merges the r most-similar token pairs per layer
        (token merging, ``models/tome_forward.py``) — an opt-in
        speed/quality tradeoff (throughput is ~linear in merged tokens;
        fidelity must be validated on your data). Composes with
        ``quantize``; rollout maps always run the full-token model.
        """
        self.params = params
        self.cfg = cfg
        self.classes = list(classes) if classes else None
        self.batch_size = batch_size
        self.canvas_size = canvas_size
        if placement not in ("host", "device"):
            raise ValueError(f"unknown placement {placement!r}")
        self.placement = placement

        self.mesh = None
        self._min_bucket = 1
        if data_parallel:
            from jax.sharding import Mesh
            n = (len(jax.devices()) if data_parallel is True
                 else int(data_parallel))
            if n < 1:
                raise ValueError(
                    f"data_parallel={n} must be >= 1 (or True for all "
                    f"devices)")
            if n > len(jax.devices()):
                raise ValueError(
                    f"data_parallel={n} > {len(jax.devices())} devices")
            if batch_size % n:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by "
                    f"data_parallel {n}")
            if n > 1:
                self.mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
                self._min_bucket = n
        if quantize in (False, None):
            qmode = None
        elif quantize in (True, "dynamic"):
            qmode = "dynamic"
        elif quantize == "static":
            qmode = "static"
        else:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.quantize = qmode is not None
        self.quantize_mode = qmode

        def images_of(staged):
            from chestxray_vit_tpu.ops.preprocess import normalize_u8
            if self.placement == "device":
                canvases, boxes = staged
                return fused_preprocess(canvases, boxes,
                                        out_size=cfg.img_size,
                                        dtype=jnp.dtype(cfg.dtype))
            return normalize_u8(staged[0], dtype=jnp.dtype(cfg.dtype))

        quantize = self.quantize
        if quantize:
            from chestxray_vit_tpu.models.quantized import (
                apply_quantized,
                calibrate_vit_scales,
                quantize_vit_params,
            )
            if qparams is not None:
                # prebuilt artifact (save_quantized/load_quantized): must
                # carry static scales iff static mode was requested
                saved_mode = ("static" if "act" in qparams["blocks"]
                              else "dynamic")
                if saved_mode != qmode:
                    raise ValueError(
                        f"prebuilt qparams are {saved_mode!r} but "
                        f"quantize={qmode!r} was requested")
                self._qparams = qparams
            else:
                scales = None
                if qmode == "static":
                    if calibration is None or calibration == "synthetic":
                        if calibration is None:
                            # loud by design: static scales calibrated on
                            # noise can silently ship in production;
                            # pass real images, or opt in
                            # explicitly with calibration='synthetic'
                            print(
                                "[predictor] WARNING: quantize='static' "
                                "with no calibration images — activation "
                                "scales will be calibrated on seeded "
                                "synthetic noise. Pass calibration= real "
                                "images (or calibration='synthetic' to "
                                "silence), or persist real-data scales "
                                "once with `cli quantize --calibration`.",
                                file=sys.stderr)
                        rng = np.random.default_rng(0)
                        calibration = [rng.integers(0, 256,
                                                    (cfg.img_size,
                                                     cfg.img_size),
                                                    np.uint8)
                                       for _ in range(8)]
                    elif not len(calibration):
                        raise ValueError(
                            "quantize='static' got an EMPTY calibration "
                            "set — pass real images, or "
                            "calibration='synthetic' explicitly")
                    staged = tuple(jnp.asarray(a)
                                   for a in self._stage(list(calibration),
                                                        0))
                    scales = jax.tree.map(
                        np.asarray,
                        calibrate_vit_scales(self.params,
                                             images_of(staged), cfg))
                self._qparams = quantize_vit_params(params, scales)

        self.tome_r = int(tome_r or 0)
        self.tome_schedule = tome_schedule
        if (self.quantize or self.tome_r) and batch_size < 16:
            # small batches are dispatch-dominated: the accelerators were
            # slower than plain bf16 below b16 on the previous accelerator
            # (not re-measured on the H100 yet — ROADMAP Speed item 6)
            print(f"[predictor] NOTE: quantize/tome_r with batch_size="
                  f"{batch_size} < 16: small batches are dispatch-"
                  f"dominated and the accelerators may not pay; prefer "
                  f"batch_size>=32 for them.", file=sys.stderr)
        # the compiled forwards return LOGITS only; probabilities are a
        # [N, C] sigmoid the host does in ~µs: ONE device→host pull per
        # micro-batch.
        if self.tome_r:
            # opt-in speed/quality knob: merge r token pairs per layer
            # (models/tome_forward.py); composes with quantize.
            # tome_schedule distributes the budget over layers
            # ('decreasing' front-loads merging — ops/tome.r_schedule)
            from chestxray_vit_tpu.models.tome_forward import apply_tome

            def forward(p, *staged):
                return apply_tome(p, images_of(staged), cfg,
                                  self.tome_r, quantized=bool(quantize),
                                  schedule=self.tome_schedule)
        elif quantize:
            def forward(qparams, *staged):
                return apply_quantized(qparams, images_of(staged), cfg)
        else:
            def forward(params, *staged):
                return vit.apply(params, images_of(staged), cfg)

        def forward_rollout(params, *staged):
            logits, maps = am.compute_rollout(params, images_of(staged), cfg)
            return logits, maps

        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            rep = NamedSharding(self.mesh, P())
            bsh = NamedSharding(self.mesh, P("data"))
            n_staged = 2 if self.placement == "device" else 1
            self._forward = jax.jit(forward,
                                    in_shardings=(rep,) + (bsh,) * n_staged,
                                    out_shardings=bsh)
            self._forward_rollout = jax.jit(
                forward_rollout,
                in_shardings=(rep,) + (bsh,) * n_staged,
                out_shardings=bsh)
        else:
            self._forward = jax.jit(forward)
            self._forward_rollout = jax.jit(forward_rollout)
        # the plain forward consumes the (possibly quantized) weights; the
        # rollout path always runs the f32 model (probabilities-as-product)
        self._fwd_params = self._qparams if quantize else self.params

    @classmethod
    def from_model_dir(cls, directory: str, batch_size: int = 8,
                       placement: str = "host", quantize=False,
                       data_parallel=False, tome_r: int = 0,
                       tome_schedule: str = "constant",
                       calibration=None) -> "Predictor":
        """Load a ``Trainer.save_model()`` directory. With ``quantize``
        set, a matching ``quantized/`` artifact in the directory (written
        by ``cli quantize`` / :meth:`save_quantized`) is loaded instead
        of re-quantizing — cold starts skip the quantize pass and the
        static calibration forward."""
        directory = os.path.expanduser(directory)
        with open(os.path.join(directory, "config.json")) as f:
            cfg = Config.from_json(f.read())
        template = vit.init_params(jax.random.key(0), cfg.model)
        params, classes = load_model(directory, template)
        qparams = None
        qdir = os.path.join(directory, "quantized")
        if quantize and os.path.exists(os.path.join(qdir,
                                                    "quantized.json")):
            import json as _json

            from chestxray_vit_tpu.models.quantized import (
                load_quantized,
                model_fingerprint,
            )
            with open(os.path.join(qdir, "quantized.json")) as f:
                meta = _json.load(f)
            saved_mode = meta.get("mode")
            want = "dynamic" if quantize is True else quantize
            if saved_mode != want:
                print(f"[predictor] quantized/ artifact is "
                      f"{saved_mode!r} but {want!r} was requested — "
                      f"re-quantizing from the f32 weights (run "
                      f"`cli quantize --mode {want}` to persist)")
            elif (meta.get("fingerprint")
                  and meta["fingerprint"] != model_fingerprint(params)):
                print("[predictor] quantized/ artifact was built from "
                      "DIFFERENT weights (model retrained since "
                      "`cli quantize`?) — re-quantizing from the "
                      "current f32 weights")
            else:
                qparams = load_quantized(qdir, cfg.model)
                print(f"[predictor] loaded int8 artifact ({saved_mode}) "
                      f"from {qdir}")
        return cls(params, cfg.model, classes, batch_size,
                   placement=placement, quantize=quantize,
                   data_parallel=data_parallel, qparams=qparams,
                   tome_r=tome_r, tome_schedule=tome_schedule,
                   calibration=calibration)

    def save_quantized(self, directory: str) -> str:
        """Persist this Predictor's quantized tree (int8 weights + static
        scales when calibrated) as a ``quantized/`` artifact —
        ``from_model_dir`` auto-loads it on the next start."""
        if not self.quantize:
            raise ValueError("Predictor was built without quantize=")
        from chestxray_vit_tpu.models.quantized import (
            model_fingerprint,
            save_quantized,
        )
        return save_quantized(directory, self._qparams,
                              fingerprint=model_fingerprint(self.params))

    # ------------------------------------------------------------------

    def _stage(self, images_bytes: Sequence[bytes], n_pad: int):
        """bytes → staged device operands (zero rows for tail padding).

        'device': (canvases u8 [n, C, C], boxes i32 [n, 4]);
        'host':   (pixels u8 [n, img, img],) — decoded + C++ crop/pad/resize
        on host, so only ~img² bytes per image cross the host→device link.
        """
        from concurrent.futures import ThreadPoolExecutor

        c = self.canvas_size
        n = len(images_bytes) + n_pad
        if self.placement == "host":
            s = self.cfg.img_size
            pixels = np.zeros((n, s, s), np.uint8)

            def stage_one(i_data):
                # decode + crop/pad/resize both run in the C++ stage outside
                # the GIL, so request staging parallelizes across cores
                i, data = i_data
                gray = (data if isinstance(data, np.ndarray)
                        else dec.safe_decode_gray(data, dummy_size=(c, c)))
                h, w = gray.shape
                from chestxray_vit_tpu.data.pipeline import host_resize
                pixels[i] = host_resize(gray, geo.full_image_box(w, h), s)

            with ThreadPoolExecutor(min(8, max(len(images_bytes), 1))) as ex:
                list(ex.map(stage_one, enumerate(images_bytes)))
            return (pixels,)
        canvases = np.zeros((n, c, c), np.uint8)
        boxes = np.zeros((n, 4), np.int32)
        boxes[:, 2:] = 1                 # degenerate-but-valid pad boxes

        def stage_canvas(i_data):
            i, data = i_data
            gray = (data if isinstance(data, np.ndarray)
                    else dec.safe_decode_gray(data, dummy_size=(c, c)))
            h, w = min(gray.shape[0], c), min(gray.shape[1], c)
            canvases[i, :h, :w] = gray[:h, :w]
            box = geo.full_image_box(w, h)
            boxes[i] = (box.left, box.top, box.width, box.height)

        with ThreadPoolExecutor(min(8, max(len(images_bytes), 1))) as ex:
            list(ex.map(stage_canvas, enumerate(images_bytes)))
        return canvases, boxes

    def warmup(self, with_maps: bool = False) -> None:
        """Pre-compile every bucket size so first requests don't pay
        compile latency (zero-filled staged operands; no decode needed)."""
        b = 1
        candidates = []
        while b < self.batch_size:
            candidates.append(b)
            b <<= 1
        candidates.append(self.batch_size)
        # under data-parallel serving several candidates collapse onto the
        # same (mesh-multiple) bucket — compile each program once
        sizes = sorted({self._bucket(c, self.batch_size)
                        for c in candidates})
        for b in sizes:
            if self.placement == "host":
                s = self.cfg.img_size
                staged = (jnp.zeros((b, s, s), jnp.uint8),)
            else:
                boxes = np.zeros((b, 4), np.int32)
                boxes[:, 2:] = 1
                c = self.canvas_size
                staged = (jnp.zeros((b, c, c), jnp.uint8),
                          jnp.asarray(boxes))
            if with_maps:
                np.asarray(self._forward_rollout(self.params, *staged)[0])
            else:
                # single-pull forward returns the logits array itself
                np.asarray(self._forward(self._fwd_params, *staged))

    def _bucket(self, valid: int, bs: int) -> int:
        """Smallest power-of-two batch ≥ valid (clamped to bs): partial
        chunks run a right-sized compiled program instead of paying the
        full-batch forward — one cached executable per bucket, log2(bs)+1
        buckets total. Under data-parallel serving buckets additionally
        round up to a multiple of the mesh size so every device gets
        equal rows."""
        b = 1
        while b < valid:
            b <<= 1
        n = self._min_bucket
        if b % n:
            b = ((b + n - 1) // n) * n
        return min(max(b, n), bs)

    def stage_chunk(self, chunk: Sequence[bytes]):
        """Host half of one micro-batch: decode + crop/pad/resize (C++/PIL
        threads), pad to the power-of-two bucket, and BEGIN the async
        host→device transfer. Returns the staged device operands — hand
        them to :meth:`forward_staged`. Splitting the two halves lets a
        caller (serve.batcher.MicroBatcher) overlap host staging of batch
        N+1 with the device forward of batch N — on a host-decode-bound
        box that turns throughput from stage+fwd into max(stage, fwd)."""
        valid = len(chunk)
        if not 0 < valid <= self.batch_size:
            raise ValueError(f"chunk of {valid} images; expected 1.."
                             f"{self.batch_size}")
        # static-shape tail padding: zero rows, no redundant decode;
        # padded up to the nearest power-of-two bucket, not full batch
        return tuple(jnp.asarray(a)
                     for a in self._stage(
                         list(chunk),
                         self._bucket(valid, self.batch_size) - valid))

    def forward_staged(self, staged, valid: int,
                       with_maps: bool = False) -> PredictOutput:
        """Device half of one micro-batch: run the compiled forward on
        operands from :meth:`stage_chunk` and pull the first ``valid``
        rows to host (the pull is the synchronization point). The
        sigmoid runs on host — the forward pulls ONE array."""
        if with_maps:
            logits, maps = self._forward_rollout(self.params, *staged)
            maps_np = np.asarray(maps)[:valid]
        else:
            logits = self._forward(self._fwd_params, *staged)
            maps_np = None
        logits_np = np.asarray(logits)[:valid]
        # overflow-free sigmoid: exp of a non-positive argument only
        z = np.exp(-np.abs(logits_np))
        return PredictOutput(
            probs=np.where(logits_np >= 0, 1.0 / (1.0 + z), z / (1.0 + z)),
            logits=logits_np,
            classes=self.classes,
            maps=maps_np,
        )

    def predict_bytes(self, images_bytes: Sequence[bytes],
                      with_maps: bool = False) -> PredictOutput:
        """Micro-batched inference over raw encoded images."""
        n = len(images_bytes)
        bs = self.batch_size
        logits_out, probs_out, maps_out = [], [], []
        for lo in range(0, n, bs):
            chunk = list(images_bytes[lo:lo + bs])
            out = self.forward_staged(self.stage_chunk(chunk), len(chunk),
                                      with_maps=with_maps)
            logits_out.append(out.logits)
            probs_out.append(out.probs)
            if out.maps is not None:
                maps_out.append(out.maps)
        return PredictOutput(
            probs=np.concatenate(probs_out),
            logits=np.concatenate(logits_out),
            classes=self.classes,
            maps=np.concatenate(maps_out) if maps_out else None,
        )

    def predict_arrays(self, grays: Sequence[np.ndarray],
                       with_maps: bool = False) -> PredictOutput:
        """Inference over already-decoded u8 grayscale arrays — same
        staging/bucketing as ``predict_bytes``, skipping the decode."""
        return self.predict_bytes([np.asarray(g, np.uint8) for g in grays],
                                  with_maps=with_maps)

    def top_findings(self, probs_row: np.ndarray, k: int = 5
                     ) -> List[Dict[str, float]]:
        order = np.argsort(probs_row)[::-1][:k]
        return [{"label": (self.classes[i] if self.classes else str(i)),
                 "probability": float(probs_row[i])} for i in order]
