"""int8 forward INSIDE the train step (exploratory).

Static-scale int8 is the serving path's quantized forward
(``models/quantized.py``). This module points that lever at the hot loop
the reference actually runs (ViT-Training.py:132): the forward half of the
train step computes every large projection as an int8 matmul while the
backward stays bf16 via
a straight-through estimator — the standard quantization-aware-training
gradient (Bengio et al. 2013; round-trip quantization is
piecewise-constant, so its "gradient" is taken as identity):

- weights are re-quantized per optimizer step from the live f32 masters
  (per-output-channel amax — an elementwise pass over the [L, D, D]
  kernels, negligible next to the [B, S, D] activation work);
- activations use per-site static scalar scales calibrated ONCE on the
  first batch (``models.quantized.calibrate_vit_scales``) so the
  quantize fuses into each producer's epilogue — the same property that
  made static int8 the serving win. Range drift during training
  saturates at ±127 by design; re-calibrate at eval cadence if needed;
- backward: d x = g Wᵀ, d W = xᵀ g in bf16 — gradients flow to the f32
  masters exactly as in the dense step (grad-cosine pinned in
  tests/test_int8_train.py).

Under full remat the backward RECOMPUTES this int8 forward, so an int8
rate advantage applies to half of all matmul passes. The Trainer does not
wire it; whether it pays on the H100 is not measured.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from chestxray_vit_tpu.config import ModelConfig
from chestxray_vit_tpu.models import vit
from chestxray_vit_tpu.ops.attention import attention
from chestxray_vit_tpu.ops.gelu import gelu as _gelu
from chestxray_vit_tpu.ops.quant import int8_matmul_static, quantize_weight

Params = Dict[str, Any]


def int8_linear_ste(x: jax.Array, kernel: jax.Array, bias: jax.Array,
                    x_scale: jax.Array, out_dtype=jnp.bfloat16) -> jax.Array:
    """y = int8(x/sx) · int8(W/sw) rescaled + b, with dense bf16 backward.

    Forward: per-output-channel weight quantize (from the live master) +
    static-scale activation quantize + one int8 contraction
    (``ops.quant.int8_matmul_static``). Backward: the straight-through
    estimator — gradients of the DENSE linear y = xW + b, computed in
    ``out_dtype`` like the plain training step. ``x_scale`` is a
    calibration constant (no gradient)."""

    @jax.custom_vjp
    def f(x, kernel, bias, x_scale):
        qw = quantize_weight(kernel)
        return int8_matmul_static(x, qw, x_scale, bias, out_dtype=out_dtype)

    def fwd(x, kernel, bias, x_scale):
        return f(x, kernel, bias, x_scale), (x, kernel, x_scale)

    def bwd(res, g):
        # x_scale is a traced operand (it rides the lax.scan over layers),
        # so it must be a real custom_vjp argument with an explicit zero
        # cotangent — closing over it leaks a tracer out of the scan scope
        x, kernel, x_scale = res
        gc = g.astype(out_dtype)
        dx = jnp.einsum("...o,io->...i", gc, kernel.astype(out_dtype))
        dk = jnp.einsum("...i,...o->io", x.astype(out_dtype), gc)
        db = jnp.sum(g.astype(jnp.float32),
                     axis=tuple(range(g.ndim - 1)))
        return (dx.astype(x.dtype), dk.astype(kernel.dtype),
                db.astype(bias.dtype), jnp.zeros_like(x_scale))

    f.defvjp(fwd, bwd)
    return f(x, kernel, bias, jnp.asarray(x_scale, jnp.float32))


def apply_int8_train(params: Params, images: jax.Array, cfg: ModelConfig,
                     scales: Params, *, train: bool = True,
                     rng: Optional[jax.Array] = None) -> jax.Array:
    """``vit.apply`` with every projection on the int8-STE path.

    ``scales``: the :func:`models.quantized.calibrate_vit_scales` tree
    ({"patch": scalar, "blocks": {site: [L]}}), calibrated on a real
    batch. Same scan/remat structure as the dense forward; attention,
    LayerNorm, softmax and the classifier head stay bf16/f32 (attention
    is VPU-bound at ViT head_dim — int8 buys nothing there)."""
    compute_dtype = jnp.dtype(cfg.dtype)
    h, hd = cfg.num_heads, cfg.head_dim

    # patch embed on the int8 path too (one [B·N, p²·3]×[p²·3, D] matmul)
    patches = vit.patchify(images.astype(jnp.float32), cfg.patch_size)
    pe = params["patch_embed"]
    x = int8_linear_ste(patches, pe["kernel"].astype(jnp.float32),
                        pe["bias"], scales["patch"],
                        out_dtype=compute_dtype)
    b = x.shape[0]
    cls = jnp.broadcast_to(params["cls_token"].astype(compute_dtype),
                           (b, 1, cfg.hidden_size))
    x = jnp.concatenate([cls, x], axis=1)
    x = (x + params["pos_embed"].astype(compute_dtype)).astype(compute_dtype)

    cast = lambda p: jax.tree.map(lambda a: a.astype(compute_dtype), p)
    blocks = cast(params["blocks"])
    # ride the per-layer activation scales through the scan as extra
    # scanned leaves (each body step sees its layer's scalars)
    blocks = dict(blocks)
    blocks["act8"] = {k: jnp.asarray(v, jnp.float32)
                      for k, v in scales["blocks"].items()}

    def heads(y):                        # [B, S, D] → [B, H, S, hd]
        bsz, s, _ = y.shape
        return y.reshape(bsz, s, h, hd).transpose(0, 2, 1, 3)

    def proj(y, bp, key, site):
        return int8_linear_ste(y, bp[key]["kernel"], bp[key]["bias"],
                               bp["act8"][site], out_dtype=compute_dtype)

    def scan_body(carry, bp):
        x, key = carry
        key, sub = (jax.random.split(key) if key is not None
                    else (None, None))
        a_in = vit.layer_norm(x, bp["ln1"]["scale"], bp["ln1"]["bias"],
                              cfg.layernorm_eps)
        q = heads(proj(a_in, bp, "wq", "attn_in"))
        k = heads(proj(a_in, bp, "wk", "attn_in"))
        v = heads(proj(a_in, bp, "wv", "attn_in"))
        o = attention(q, k, v, impl=cfg.attention_impl,
                      **vit.attention_dropout_args(cfg, sub, train))
        bsz, _, s, _ = o.shape
        merged = o.transpose(0, 2, 1, 3).reshape(bsz, s, h * hd)
        attn_out = proj(merged, bp, "wo", "attn_out")
        attn_out = vit._dropout(attn_out, cfg.hidden_dropout, sub,
                                train, 0)
        x = x + attn_out
        m_in = vit.layer_norm(x, bp["ln2"]["scale"], bp["ln2"]["bias"],
                              cfg.layernorm_eps)
        mid = _gelu(proj(m_in, bp, "mlp_in", "mlp_in"),
                    approximate=cfg.gelu_approximate)
        mid = jax.ad_checkpoint.checkpoint_name(mid, "mlp_hidden")
        mlp_out = proj(mid, bp, "mlp_out", "mlp_mid")
        mlp_out = vit._dropout(mlp_out, cfg.hidden_dropout, sub, train, 1)
        return (x + mlp_out, key), None

    body = scan_body
    if cfg.remat:
        body = jax.checkpoint(scan_body, policy=vit.remat_policy(cfg),
                              prevent_cse=False)
    (x, _), _ = jax.lax.scan(body, (x, rng), blocks)

    return vit.head_logits(params, x, cfg)
