"""Token-merging ViT forward for serving (opt-in speed/quality knob).

``apply_tome`` is the unrolled-layer counterpart of ``vit.apply`` /
``quantized.apply_quantized``: after every attention block the r most
similar token pairs merge (``ops/tome.py``; metric = attention keys,
mean over heads — arXiv:2210.09461 reimplemented), so layer l processes
S - l·r tokens. Token counts shrink per layer → shapes differ per layer
→ a python-unrolled loop instead of the scan (12 compiled block
instances; forward-only, so no remat pressure). Composes with the int8
static/dynamic projections or the dense bf16 weights.

Accuracy framing (honest): merging is lossy by design — the knob trades
~linear throughput in merged tokens against fidelity. The exact
matching/merge math is oracle-tested (tests/test_tome.py); end-to-end
fidelity on a trained model must be validated on real data by the user
(the paper reports ≤0.4-pt ImageNet top-1 cost at r=16 for ViT-B/16
off-the-shelf; this box has no NIH data to verify AUC against).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.ad_checkpoint
import jax.numpy as jnp

from chestxray_vit_tpu.config import ModelConfig
from chestxray_vit_tpu.models import vit
from chestxray_vit_tpu.models.quantized import _SITE_OF, embed_tokens
from chestxray_vit_tpu.ops.attention import attention
from chestxray_vit_tpu.ops.gelu import gelu as _gelu
from chestxray_vit_tpu.ops.quant import int8_matmul, int8_matmul_static
from chestxray_vit_tpu.ops.tome import r_schedule, tome_merge

Params = Dict[str, Any]


def apply_tome_train(params: Params, images: jax.Array, cfg: ModelConfig,
                     r: int, *, train: bool = True,
                     rng: Optional[jax.Array] = None,
                     schedule: str = "constant",
                     int8_scales: Optional[Params] = None) -> jax.Array:
    """Differentiable token-merging forward for TRAINING (model.tome_r).

    The train-step counterpart of :func:`apply_tome`: dense bf16 weights,
    dropout, and gradient checkpointing — dispatched from ``vit.apply``
    when ``cfg.tome_r > 0`` so the whole Trainer stack (accumulation,
    mixup, eval, golden runs) composes unchanged. Gradients flow through
    the size-weighted merge means (the routing matmul + scatter-add in
    ``ops/tome.py`` are plain differentiable XLA ops); the bipartite
    matching (top_k/argmax) is piecewise-constant with zero gradient,
    exactly the ToMe paper's training formulation (arXiv:2210.09461 §4.2
    trains with merging on).

    Token counts shrink per layer → per-layer shapes → a python-unrolled
    loop with per-block ``jax.checkpoint`` instead of the scan (same remat
    policies as ``vit.apply``; 12 compiled block instances).

    ``int8_scales`` (a ``calibrate_vit_scales`` tree) composes the two
    train accelerators: every projection runs the int8 straight-through
    path (``models/int8_train.int8_linear_ste`` — int8 forward, dense
    bf16 backward) INSIDE the merged-token forward. Dispatched from
    ``train.steps.make_train_step(int8_scales=...)`` when ``cfg.tome_r``
    is also set — previously that combination silently trained un-merged.
    """
    if r <= 0:
        raise ValueError(f"tome r={r} must be positive")
    if cfg.fused_qkv:
        raise ValueError("model.fused_qkv does not compose with tome_r")
    compute_dtype = jnp.dtype(cfg.dtype)
    if int8_scales is None:
        x = vit.embed(params, images, cfg, compute_dtype)
        proj = None
    else:
        from chestxray_vit_tpu.models.int8_train import int8_linear_ste

        # int8-STE patch embed, mirroring apply_int8_train (one
        # [B·N, p²·3]×[p²·3, D] int8 matmul)
        patches = vit.patchify(images.astype(jnp.float32), cfg.patch_size)
        pe = params["patch_embed"]
        x = int8_linear_ste(patches, pe["kernel"].astype(jnp.float32),
                            pe["bias"], int8_scales["patch"],
                            out_dtype=compute_dtype)
        cls = jnp.broadcast_to(params["cls_token"].astype(compute_dtype),
                               (x.shape[0], 1, cfg.hidden_size))
        x = jnp.concatenate([cls, x], axis=1)
        x = (x + params["pos_embed"].astype(compute_dtype)
             ).astype(compute_dtype)

        def proj(y, bp, key, li):
            return int8_linear_ste(
                y, bp[key]["kernel"], bp[key]["bias"],
                int8_scales["blocks"][_SITE_OF[key]][li],
                out_dtype=compute_dtype)

    sizes = jnp.ones(x.shape[:2], jnp.float32)
    key = rng
    rs = r_schedule(r, cfg.num_layers, schedule)
    h, hd = cfg.num_heads, cfg.head_dim

    def make_block(r_i, li):
        def block(x, sizes, bp, sub):
            a_in = vit.layer_norm(x, bp["ln1"]["scale"], bp["ln1"]["bias"],
                                  cfg.layernorm_eps)
            if proj is None:
                attn_out, _, kmean = vit._mha(
                    a_in, bp, cfg, cfg.attention_impl, dropout_rng=sub,
                    train=train, return_key_mean=True)
            else:
                bsz, s, _ = a_in.shape
                hsplit = lambda y: (y.reshape(bsz, s, h, hd)
                                    .transpose(0, 2, 1, 3))
                q = hsplit(proj(a_in, bp, "wq", li))
                k = hsplit(proj(a_in, bp, "wk", li))
                v = hsplit(proj(a_in, bp, "wv", li))
                o = _tome_int8_attention(q, k, v, cfg, sub, train)
                kmean = k.mean(axis=1)
                merged = o.transpose(0, 2, 1, 3).reshape(bsz, s, h * hd)
                attn_out = proj(merged, bp, "wo", li)
            attn_out = vit._dropout(attn_out, cfg.hidden_dropout, sub,
                                    train, 0)
            x = x + attn_out
            # merge between attention and MLP (paper placement); r clamps
            # per layer so deep layers with few tokens left merge less
            r_l = min(r_i, (x.shape[1] + 1) // 2 - 1)
            if r_l > 0:
                x, sizes = tome_merge(x, kmean, sizes, r_l)
            m_in = vit.layer_norm(x, bp["ln2"]["scale"], bp["ln2"]["bias"],
                                  cfg.layernorm_eps)
            if proj is None:
                hmid = _gelu(m_in @ bp["mlp_in"]["kernel"]
                             + bp["mlp_in"]["bias"],
                             approximate=cfg.gelu_approximate)
            else:
                hmid = _gelu(proj(m_in, bp, "mlp_in", li),
                             approximate=cfg.gelu_approximate)
            hmid = jax.ad_checkpoint.checkpoint_name(hmid, "mlp_hidden")
            if proj is None:
                mlp_out = (hmid @ bp["mlp_out"]["kernel"]
                           + bp["mlp_out"]["bias"])
            else:
                mlp_out = proj(hmid, bp, "mlp_out", li)
            mlp_out = vit._dropout(mlp_out, cfg.hidden_dropout, sub,
                                   train, 1)
            return x + mlp_out, sizes

        if cfg.remat:
            return jax.checkpoint(block, policy=vit.remat_policy(cfg),
                                  prevent_cse=False)
        return block

    blocks = vit.unstack_blocks(params, cfg, compute_dtype)
    for li, (bp, r_i) in enumerate(zip(blocks, rs)):
        key, sub = (jax.random.split(key) if key is not None
                    else (None, None))
        x, sizes = make_block(r_i, li)(x, sizes, bp, sub)

    return vit.head_logits(params, x, cfg)


def _tome_int8_attention(q, k, v, cfg: ModelConfig, sub, train: bool):
    """Attention for the int8+tome composed block (same dispatch as
    ``vit._mha``: materialised only under attention dropout)."""
    return attention(q, k, v, impl=cfg.attention_impl,
                     **vit.attention_dropout_args(cfg, sub, train))


def apply_tome(params: Params, images: jax.Array, cfg: ModelConfig,
               r: int, quantized: bool = False,
               schedule: str = "constant") -> jax.Array:
    """NHWC images → f32 logits, merging ``r`` token pairs per layer.

    ``params``: the plain trained tree, or a ``quantize_vit_params`` tree
    with ``quantized=True`` (static or dynamic). ``r`` clamps per layer
    to ceil(S_l/2) - 1, so deep layers with few tokens left merge less
    instead of erroring. ``schedule`` distributes the r·L budget across
    layers ('constant' | 'decreasing' — ``ops/tome.r_schedule``).
    """
    if r <= 0:
        raise ValueError(f"tome r={r} must be positive (use the plain "
                         f"forward for r=0)")
    compute_dtype = jnp.dtype(cfg.dtype)
    h, hd = cfg.num_heads, cfg.head_dim

    def proj(y, bp, key):
        if not quantized:
            e = bp[key]
            return (y.astype(compute_dtype)
                    @ e["kernel"].astype(compute_dtype)
                    + e["bias"].astype(compute_dtype))
        act = bp.get("act")
        if act is not None:
            return int8_matmul_static(y, bp[key]["qw"], act[_SITE_OF[key]],
                                      bp[key]["bias"],
                                      out_dtype=compute_dtype)
        return int8_matmul(y, bp[key]["qw"], bp[key]["bias"],
                           out_dtype=compute_dtype)

    x = embed_tokens(params, images, cfg, quantized=quantized)

    sizes = jnp.ones(x.shape[:2], jnp.float32)
    blocks = params["blocks"]
    rs = r_schedule(r, cfg.num_layers, schedule)

    def heads(y):
        bsz, s, _ = y.shape
        return y.reshape(bsz, s, h, hd).transpose(0, 2, 1, 3)

    for layer in range(cfg.num_layers):
        bp = jax.tree.map(lambda a: a[layer], blocks)
        a_in = vit.layer_norm(x, bp["ln1"]["scale"], bp["ln1"]["bias"],
                              cfg.layernorm_eps)
        q = heads(proj(a_in, bp, "wq"))
        k = heads(proj(a_in, bp, "wk"))
        v = heads(proj(a_in, bp, "wv"))
        o = attention(q, k, v, impl=cfg.attention_impl)
        bsz, _, s, _ = o.shape
        merged = o.transpose(0, 2, 1, 3).reshape(bsz, s, h * hd)
        x = x + proj(merged, bp, "wo")
        # ToMe sits between attention and MLP; the metric is this
        # layer's keys (mean over heads), aligned with x pre-merge.
        # r clamps per layer: deep layers with few tokens left merge
        # less instead of erroring out
        r_l = min(rs[layer], (x.shape[1] + 1) // 2 - 1)
        if r_l > 0:
            x, sizes = tome_merge(x, k.mean(axis=1), sizes, r_l)
        m_in = vit.layer_norm(x, bp["ln2"]["scale"], bp["ln2"]["bias"],
                              cfg.layernorm_eps)
        mid = _gelu(proj(m_in, bp, "mlp_in"),
                    approximate=cfg.gelu_approximate)
        x = x + proj(mid, bp, "mlp_out")

    return vit.head_logits(params, x, cfg)
