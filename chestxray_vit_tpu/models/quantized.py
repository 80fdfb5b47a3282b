"""int8-quantized ViT forward for serving (beyond-parity inference path).

Mirrors :func:`vit.apply`'s architecture exactly (pre-LN blocks, fused
attention, erf GELU, CLS head — reference model per ViT-Training.py:83 /
pyc L381) but runs every large matmul as an int8 ``dot_general``:
per-output-channel int8 weights prepared once at load
(:func:`quantize_vit_params`), int32 accumulation (``ops/quant.py``).
Attention stays bf16 (``ops/attention.py``); LayerNorm, softmax and the
classifier head stay f32. Its speed on the H100 is not measured yet.

Two activation-scale modes (weights are per-channel int8 either way):

- *dynamic* (default): per-token amax scales computed on the fly —
  accuracy-safest, but the amax reduction costs one extra full-tensor
  pass over device memory per matmul.
- *static*: per-site scalar scales observed once on a calibration batch
  (:func:`calibrate_vit_scales`); the quantize step becomes pure
  elementwise and fuses into the producer.

Forward-only by design — training remains bf16/f32 master-weight.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from chestxray_vit_tpu.config import ModelConfig
from chestxray_vit_tpu.models import vit
from chestxray_vit_tpu.ops.attention import attention
from chestxray_vit_tpu.ops.gelu import gelu as _gelu
from chestxray_vit_tpu.ops.quant import (
    int8_matmul,
    int8_matmul_static,
    quantize_weight,
)

Params = Dict[str, Any]

_QUANT_BLOCK_KEYS = ("wq", "wk", "wv", "wo", "mlp_in", "mlp_out")
# calibration site feeding each projection (wq/wk/wv share one input)
_SITE_OF = {"wq": "attn_in", "wk": "attn_in", "wv": "attn_in",
            "wo": "attn_out", "mlp_in": "mlp_in", "mlp_out": "mlp_mid"}


def _encoder_scan(x: jax.Array, blocks: Params, cfg: ModelConfig, proj,
                  collect_amax: bool = False):
    """ONE copy of the pre-LN block math (LN → QKV → attention →
    WO+residual → LN → GELU MLP + residual) shared by the quantized
    forward and by static calibration, so the ranges calibration observes
    are by construction those of the forward it calibrates.

    ``proj(y, bp, key)`` supplies the projection for block entry ``key``
    (dense weights during calibration, int8 matmuls when serving).
    ``collect_amax`` additionally stacks per-layer max|x| at the four
    quantized-matmul input sites. Returns ``(x, sites-or-None)``.
    """
    h, hd = cfg.num_heads, cfg.head_dim

    def heads(y):                        # [B, S, D] → [B, H, S, hd]
        bsz, s, _ = y.shape
        return y.reshape(bsz, s, h, hd).transpose(0, 2, 1, 3)

    def amax(y):
        return jnp.max(jnp.abs(y.astype(jnp.float32)))

    def body(x, bp):
        a_in = vit.layer_norm(x, bp["ln1"]["scale"], bp["ln1"]["bias"],
                              cfg.layernorm_eps)
        q = heads(proj(a_in, bp, "wq"))
        k = heads(proj(a_in, bp, "wk"))
        v = heads(proj(a_in, bp, "wv"))
        o = attention(q, k, v, impl=cfg.attention_impl)
        bsz, _, s, _ = o.shape
        merged = o.transpose(0, 2, 1, 3).reshape(bsz, s, h * hd)
        x = x + proj(merged, bp, "wo")
        m_in = vit.layer_norm(x, bp["ln2"]["scale"], bp["ln2"]["bias"],
                              cfg.layernorm_eps)
        mid = _gelu(proj(m_in, bp, "mlp_in"),
                    approximate=cfg.gelu_approximate)
        x = x + proj(mid, bp, "mlp_out")
        ys = ((amax(a_in), amax(merged), amax(m_in), amax(mid))
              if collect_amax else None)
        return x, ys

    return jax.lax.scan(body, x, blocks)


def embed_tokens(params: Params, images: jax.Array, cfg: ModelConfig,
                 quantized: bool) -> jax.Array:
    """Patchify → (dense | int8) patch embed → CLS concat → pos embed:
    the shared entry stage of the quantized and token-merging forwards
    (one copy of the math, like :func:`_encoder_scan` for the blocks)."""
    compute_dtype = jnp.dtype(cfg.dtype)
    patches = vit.patchify(images.astype(jnp.float32), cfg.patch_size)
    pe = params["patch_embed"]
    if quantized:
        if "xs" in pe:
            x = int8_matmul_static(patches, pe["qw"], pe["xs"], pe["bias"],
                                   out_dtype=compute_dtype)
        else:
            x = int8_matmul(patches, pe["qw"], pe["bias"],
                            out_dtype=compute_dtype)
    else:
        x = (patches.astype(compute_dtype)
             @ pe["kernel"].astype(compute_dtype)
             + pe["bias"].astype(compute_dtype))
    b = x.shape[0]
    cls = jnp.broadcast_to(params["cls_token"].astype(compute_dtype),
                           (b, 1, cfg.hidden_size))
    x = jnp.concatenate([cls, x], axis=1)
    return (x + params["pos_embed"].astype(compute_dtype)
            ).astype(compute_dtype)


def calibrate_vit_scales(params: Params, images: jax.Array,
                         cfg: ModelConfig, margin: float = 1.0) -> Params:
    """Observe activation amax at every quantized matmul input.

    Runs the dense forward once over ``images`` (the calibration batch)
    in the serving compute dtype and records max|x| at each site; returns
    ``{"patch": f32 scalar, "blocks": {site: f32 [L]}}`` scales
    (= amax·margin/127) for :func:`quantize_vit_params`. Calibration is
    cheap (one forward) and input-robust for ViT: every site except the
    patch pixels and the GELU output is a LayerNorm/attention output
    whose range is set by learned gains more than by the batch.
    """
    compute_dtype = jnp.dtype(cfg.dtype)
    h, hd = cfg.num_heads, cfg.head_dim

    # one traced program per distinct model geometry: rebuilding the jit
    # closure every call would re-trace/lower the calibration forward on
    # every cadence eval (train.eval_quantize='static')
    cache_key = (cfg.dtype, cfg.patch_size, cfg.hidden_size, h, hd,
                 cfg.layernorm_eps, cfg.attention_impl,
                 cfg.gelu_approximate, float(margin))
    cached = _CALIBRATE_CACHE.get(cache_key)
    if cached is not None:
        s_patch, sites = cached(params, images)
        return _scales_tree(s_patch, sites, margin)

    @jax.jit
    def run(params, images):
        patches = vit.patchify(images.astype(jnp.float32), cfg.patch_size)
        s_patch = jnp.max(jnp.abs(patches))
        pe = params["patch_embed"]
        x = (patches.astype(compute_dtype)
             @ pe["kernel"].astype(compute_dtype)
             + pe["bias"].astype(compute_dtype))
        b = x.shape[0]
        cls = jnp.broadcast_to(params["cls_token"].astype(compute_dtype),
                               (b, 1, cfg.hidden_size))
        x = jnp.concatenate([cls, x], axis=1)
        x = x + params["pos_embed"].astype(compute_dtype)

        def dense_proj(y, bp, key):
            e = bp[key]
            return (y.astype(compute_dtype)
                    @ e["kernel"].astype(compute_dtype)
                    + e["bias"].astype(compute_dtype))

        _, sites = _encoder_scan(x, params["blocks"], cfg, dense_proj,
                                 collect_amax=True)
        return s_patch, sites

    _CALIBRATE_CACHE[cache_key] = run
    s_patch, sites = run(params, images)
    return _scales_tree(s_patch, sites, margin)


_CALIBRATE_CACHE: Dict[tuple, Any] = {}


def _scales_tree(s_patch, sites, margin: float) -> Params:
    def to_scale(a):
        return jnp.maximum(a.astype(jnp.float32) * margin, 1e-6) / 127.0

    names = ("attn_in", "attn_out", "mlp_in", "mlp_mid")
    return {"patch": to_scale(s_patch),
            "blocks": {n: to_scale(s) for n, s in zip(names, sites)}}


def quantize_vit_params(params: Params,
                        act_scales: Optional[Params] = None) -> Params:
    """f32 training params → serving tree with int8 kernels.

    Block kernels are scan-stacked [L, in, out]; quantization vmaps over
    the layer axis so the quantized forward keeps the same single-trace
    ``lax.scan`` structure. With ``act_scales`` (from
    :func:`calibrate_vit_scales`) the tree additionally carries static
    per-site activation scales and the forward takes the fused static
    path."""
    blocks = params["blocks"]
    qblocks: Dict[str, Any] = {
        "ln1": blocks["ln1"], "ln2": blocks["ln2"],
    }
    for key in _QUANT_BLOCK_KEYS:
        qblocks[key] = {
            "qw": jax.vmap(quantize_weight)(
                blocks[key]["kernel"].astype(jnp.float32)),
            "bias": blocks[key]["bias"],
        }
    pe: Dict[str, Any] = {
        "qw": quantize_weight(
            params["patch_embed"]["kernel"].astype(jnp.float32)),
        "bias": params["patch_embed"]["bias"],
    }
    if act_scales is not None:
        pe["xs"] = jnp.asarray(act_scales["patch"], jnp.float32)
        qblocks["act"] = {k: jnp.asarray(v, jnp.float32)
                          for k, v in act_scales["blocks"].items()}
    return {
        "patch_embed": pe,
        "cls_token": params["cls_token"],
        "pos_embed": params["pos_embed"],
        "blocks": qblocks,
        "final_ln": params["final_ln"],
        "head": params["head"],
    }


def apply_quantized(qparams: Params, images: jax.Array,
                    cfg: ModelConfig) -> jax.Array:
    """int8 forward: NHWC images → f32 logits [B, num_classes]."""
    compute_dtype = jnp.dtype(cfg.dtype)
    x = embed_tokens(qparams, images, cfg, quantized=True)

    def int8_proj(y, bp, key):
        act = bp.get("act")
        if act is not None:
            return int8_matmul_static(y, bp[key]["qw"],
                                      act[_SITE_OF[key]], bp[key]["bias"],
                                      out_dtype=compute_dtype)
        return int8_matmul(y, bp[key]["qw"], bp[key]["bias"],
                           out_dtype=compute_dtype)

    x, _ = _encoder_scan(x, qparams["blocks"], cfg, int8_proj)
    return vit.head_logits(qparams, x, cfg)


# ---------------------------------------------------------------------------
# int8 artifact: save the quantized tree once, serve without recalibrating
# ---------------------------------------------------------------------------

def model_fingerprint(params: Params) -> str:
    """Cheap content fingerprint of a trained tree, stored with the int8
    artifact so ``from_model_dir`` detects a retrain into the same
    directory. Hashes a deterministic strided sample of EVERY leaf
    (≤1152 elements per leaf + its path and shape), so a fine-tune that
    touches ONLY encoder blocks — linear-probe-then-unfreeze schedules,
    partial/LoRA-style updates — still invalidates the artifact
    (the old head/final-LN/patch-embed subset had blind spots). The
    samples are gathered on device and pulled in ONE host transfer (a few
    hundred KB) instead of the full 344 MB tree, keeping the cold start
    cheap.
    """
    import hashlib

    import numpy as _np

    import jax.numpy as _jnp

    h = hashlib.blake2b(digest_size=16)
    samples = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        arr = _jnp.asarray(leaf).reshape(-1)
        stride = max(1, arr.size // 1024)
        # strided body + dense head/tail: catches both broad updates and
        # edits concentrated at either end of the buffer
        samples.append(_jnp.concatenate([
            arr[:64], arr[::stride][:1024], arr[-64:]
        ]).astype(_jnp.float32))
        h.update(jax.tree_util.keystr(path).encode())
        h.update(str(_np.shape(leaf)).encode())
    flat = _np.asarray(jax.device_get(_jnp.concatenate(samples)))
    h.update(flat.tobytes())
    return h.hexdigest()


def save_quantized(directory: str, qparams: Params,
                   fingerprint: Optional[str] = None) -> str:
    """Persist a ``quantize_vit_params`` tree as an npz artifact.

    ~4× smaller than the f32 weights and, for the static mode, carries
    the calibrated activation scales — so serving cold-starts skip both
    the quantize pass and the calibration forward. Written next to the
    saved model by ``cli quantize`` / ``Predictor.save_quantized``;
    ``Predictor.from_model_dir(quantize=...)`` auto-loads it when the
    ``fingerprint`` (see :func:`model_fingerprint`) still matches the
    f32 weights.
    """
    import json as _json
    import os as _os

    directory = _os.path.abspath(_os.path.expanduser(directory))
    _os.makedirs(directory, exist_ok=True)
    import numpy as _np

    flat = jax.tree_util.tree_flatten_with_path(qparams)[0]
    arrays = {jax.tree_util.keystr(path): _np.asarray(leaf)
              for path, leaf in flat}
    _np.savez(_os.path.join(directory, "qparams.npz"), **arrays)
    mode = "static" if "act" in qparams["blocks"] else "dynamic"
    meta = {"format": 1, "mode": mode}
    if fingerprint:
        meta["fingerprint"] = fingerprint
    with open(_os.path.join(directory, "quantized.json"), "w") as f:
        _json.dump(meta, f)
    return directory


def load_quantized(directory: str, cfg: ModelConfig) -> Params:
    """Load a :func:`save_quantized` artifact back into the exact tree
    structure ``apply_quantized`` expects (template-unflattened, so a
    model-geometry mismatch fails loudly on shape/key instead of
    producing garbage)."""
    import json as _json
    import os as _os

    import numpy as _np

    directory = _os.path.abspath(_os.path.expanduser(directory))
    with open(_os.path.join(directory, "quantized.json")) as f:
        meta = _json.load(f)
    if meta.get("format") != 1:
        raise ValueError(f"unknown quantized artifact format {meta!r}")
    data = _np.load(_os.path.join(directory, "qparams.npz"))

    # template with the right STRUCTURE only — eval_shape gives shapes/
    # dtypes with zero array compute (materializing + quantizing a random
    # ViT here would waste the cold-start time the artifact saves);
    # static trees additionally carry the act-scale leaves
    template = jax.eval_shape(
        lambda: quantize_vit_params(
            vit.init_params(jax.random.key(0), cfg),
            _dummy_scales(cfg) if meta["mode"] == "static" else None))
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for path, tmpl in flat:
        key = jax.tree_util.keystr(path)
        if key not in data:
            raise ValueError(f"quantized artifact missing leaf {key}")
        arr = data[key]
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"quantized artifact leaf {key} has shape {arr.shape}, "
                f"model config expects {tuple(tmpl.shape)}")
        leaves.append(jnp.asarray(arr))
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template), leaves)


def _dummy_scales(cfg: ModelConfig) -> Params:
    ones = jnp.ones((cfg.num_layers,), jnp.float32)
    return {"patch": jnp.float32(1.0),
            "blocks": {n: ones for n in ("attn_in", "attn_out",
                                         "mlp_in", "mlp_mid")}}
