"""Packed variable-resolution ViT forward.

Runs the standard ViT encoder weights over NaViT-style packed sequences
(``data/packing.py``): several images per sequence, isolated by
segment-masked attention; per-image masked mean pooling replaces the
CLS token (padding and neighbor images contribute nothing — tested). The
position table concatenates bicubic re-interpolations of the pretrained
[1, S, D] embedding for every allowed grid, so @384-pretrained weights serve
256/384/512-px images in one batch.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.ad_checkpoint
import jax.numpy as jnp

from chestxray_vit_tpu.config import ModelConfig
from chestxray_vit_tpu.models import vit
from chestxray_vit_tpu.ops.attention import attention
from chestxray_vit_tpu.ops.gelu import gelu as _gelu


def build_pos_table(params, cfg: ModelConfig,
                    grids: Sequence[int]) -> jax.Array:
    """Concatenated patch-position table [sum(g²), D] over allowed grids,
    each block a bicubic re-interpolation of the pretrained embedding."""
    blocks = []
    for g in grids:
        pe = vit.interpolate_pos_embed(params["pos_embed"], g * g + 1)
        blocks.append(pe[0, 1:])              # drop CLS slot
    return jnp.concatenate(blocks, axis=0)


def _packed_mha(x, bp, cfg: ModelConfig, seg_ids, dropout_rng=None,
                train: bool = False, return_key_mean: bool = False):
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim

    def heads(p):
        # head split folded into the matmul epilogue (same trick as the
        # dense path's vit._mha — no [B, S, H, hd] intermediate)
        return (jnp.einsum("bsd,dhk->bhsk", x, p["kernel"].reshape(d, h, hd))
                + p["bias"].reshape(h, 1, hd))

    q, k, v = heads(bp["wq"]), heads(bp["wk"]), heads(bp["wv"])
    o = attention(q, k, v, impl=cfg.attention_impl, segment_ids=seg_ids,
                  **vit.attention_dropout_args(cfg, dropout_rng, train))
    # heads-merge folded into the output projection
    out = (jnp.einsum("bhsk,hkd->bsd", o, bp["wo"]["kernel"].reshape(h, hd, d))
           + bp["wo"]["bias"])
    if return_key_mean:
        return out, k.mean(axis=1)      # [B, S, hd] ToMe metric
    return out


def apply_packed(params, tokens: jax.Array, segment_ids: jax.Array,
                 pos_indices: jax.Array, pool_weights: jax.Array,
                 cfg: ModelConfig, grids: Sequence[int] = (16, 24, 32),
                 *, train: bool = False, rng=None) -> jax.Array:
    """Packed forward: [B, S, patch_dim] tokens → [B, max_imgs, C] logits.

    Shares all weights with :func:`vit.apply` except the CLS token (pooled
    instead). Encoder runs under ``lax.scan`` like the dense path;
    ``train`` + ``rng`` enable hidden/attention dropout with the dense
    path's per-layer key-splitting discipline.
    """
    compute_dtype = jnp.dtype(cfg.dtype)
    pe = params["patch_embed"]
    x = jnp.dot(tokens.astype(compute_dtype),
                pe["kernel"].astype(compute_dtype)) \
        + pe["bias"].astype(compute_dtype)

    table = build_pos_table(params, cfg, grids).astype(compute_dtype)
    pos = jnp.take(table, pos_indices, axis=0)         # [B, S, D]
    valid = (segment_ids >= 0)[..., None].astype(compute_dtype)
    x = (x + pos) * valid

    blocks = jax.tree.map(lambda a: a.astype(compute_dtype),
                          params["blocks"])

    def body(carry, bp):
        x, key = carry
        key, sub = (jax.random.split(key) if key is not None
                    else (None, None))
        a_in = vit.layer_norm(x, bp["ln1"]["scale"], bp["ln1"]["bias"],
                              cfg.layernorm_eps)
        attn_out = _packed_mha(a_in, bp, cfg, segment_ids, sub, train)
        attn_out = vit._dropout(attn_out, cfg.hidden_dropout, sub, train, 0)
        x = x + attn_out
        m_in = vit.layer_norm(x, bp["ln2"]["scale"], bp["ln2"]["bias"],
                              cfg.layernorm_eps)
        mid = _gelu(jnp.dot(m_in, bp["mlp_in"]["kernel"])
                    + bp["mlp_in"]["bias"],
                    approximate=cfg.gelu_approximate)
        mlp_out = (jnp.dot(mid, bp["mlp_out"]["kernel"])
                   + bp["mlp_out"]["bias"])
        mlp_out = vit._dropout(mlp_out, cfg.hidden_dropout, sub, train, 1)
        return (x + mlp_out, key), None

    fn = jax.checkpoint(body, prevent_cse=False) if cfg.remat else body
    (x, _), _ = jax.lax.scan(fn, (x, rng if train else None), blocks)

    fl = params["final_ln"]
    x = vit.layer_norm(x, fl["scale"], fl["bias"], cfg.layernorm_eps)
    pooled = jnp.einsum("bms,bsd->bmd", pool_weights.astype(jnp.float32),
                        x.astype(jnp.float32))          # [B, M, D]
    head = params["head"]
    return (jnp.dot(pooled, head["kernel"].astype(jnp.float32))
            + head["bias"].astype(jnp.float32))         # [B, M, C]


def apply_packed_tome(params, tokens: jax.Array, segment_ids: jax.Array,
                      pos_indices: jax.Array, pool_weights: jax.Array,
                      cfg: ModelConfig, grids: Sequence[int] = (16, 24, 32),
                      *, train: bool = False, rng=None) -> jax.Array:
    """Packed forward with WITHIN-SEGMENT token merging (``model.tome_r``
    on the packed path — extends the token-merging train lever to
    variable-resolution training).

    The packed counterpart of ``tome_forward.apply_tome_train``: after
    every attention block, ``ops.tome.tome_merge_packed`` merges the r_l
    most similar same-segment token pairs, routing the segment ids and
    per-image pooling weights through the same one-hot matmul so the
    segment-masked attention of later layers and the final masked-mean
    readout stay exact. Padding tokens (identical zeroed embeddings,
    segment −1) have pairwise similarity 1.0 and are merged first —
    sequences with much padding shed it before any real content merges.

    Token counts shrink per layer → per-layer shapes → a python-unrolled
    loop with per-block ``jax.checkpoint`` (same remat policies as
    ``vit.apply``) instead of the scan. Differentiable: gradients flow
    through the size-weighted merge means; the matching is
    piecewise-constant, exactly the dense train formulation.
    """
    r = cfg.tome_r
    if r <= 0:
        raise ValueError(f"tome r={r} must be positive (use apply_packed "
                         f"for the un-merged path)")
    if cfg.fused_qkv:
        raise ValueError("model.fused_qkv does not compose with tome_r")
    compute_dtype = jnp.dtype(cfg.dtype)
    pe = params["patch_embed"]
    x = jnp.dot(tokens.astype(compute_dtype),
                pe["kernel"].astype(compute_dtype)) \
        + pe["bias"].astype(compute_dtype)
    table = build_pos_table(params, cfg, grids).astype(compute_dtype)
    pos = jnp.take(table, pos_indices, axis=0)
    valid = (segment_ids >= 0)[..., None].astype(compute_dtype)
    x = (x + pos) * valid

    from chestxray_vit_tpu.ops.tome import r_schedule, tome_merge_packed

    sizes = jnp.ones(x.shape[:2], jnp.float32)
    seg = segment_ids
    pw = pool_weights.astype(jnp.float32)
    rs = r_schedule(r, cfg.num_layers, cfg.tome_schedule)
    key = rng

    def make_block(r_i):
        def block(x, sizes, seg, pw, bp, sub):
            a_in = vit.layer_norm(x, bp["ln1"]["scale"], bp["ln1"]["bias"],
                                  cfg.layernorm_eps)
            attn_out, kmean = _packed_mha(a_in, bp, cfg, seg, sub, train,
                                          return_key_mean=True)
            attn_out = vit._dropout(attn_out, cfg.hidden_dropout, sub,
                                    train, 0)
            x = x + attn_out
            # merge between attention and MLP (the dense paths' placement);
            # clamp to the global feasible maximum like the dense forward
            r_l = min(r_i, (x.shape[1] + 1) // 2 - 1)
            if r_l > 0:
                x, sizes, seg, pw = tome_merge_packed(
                    x, kmean, sizes, seg, pw, r_l)
            m_in = vit.layer_norm(x, bp["ln2"]["scale"], bp["ln2"]["bias"],
                                  cfg.layernorm_eps)
            mid = _gelu(jnp.dot(m_in, bp["mlp_in"]["kernel"])
                        + bp["mlp_in"]["bias"],
                        approximate=cfg.gelu_approximate)
            mid = jax.ad_checkpoint.checkpoint_name(mid, "mlp_hidden")
            mlp_out = (jnp.dot(mid, bp["mlp_out"]["kernel"])
                       + bp["mlp_out"]["bias"])
            mlp_out = vit._dropout(mlp_out, cfg.hidden_dropout, sub,
                                   train, 1)
            return x + mlp_out, sizes, seg, pw

        if cfg.remat:
            return jax.checkpoint(block, policy=vit.remat_policy(cfg),
                                  prevent_cse=False)
        return block

    blocks = vit.unstack_blocks(params, cfg, compute_dtype)
    for bp, r_i in zip(blocks, rs):
        key, sub = (jax.random.split(key) if (train and key is not None)
                    else (None, None))
        x, sizes, seg, pw = make_block(r_i)(x, sizes, seg, pw, bp, sub)

    fl = params["final_ln"]
    x = vit.layer_norm(x, fl["scale"], fl["bias"], cfg.layernorm_eps)
    pooled = jnp.einsum("bms,bsd->bmd", pw, x.astype(jnp.float32))
    head = params["head"]
    return (jnp.dot(pooled, head["kernel"].astype(jnp.float32))
            + head["bias"].astype(jnp.float32))


def packed_bce_parts(logits: jax.Array, labels: jax.Array,
                     image_mask: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """(numerator, denominator) of the masked mean BCE: element-sum over
    real images, and real-image × class count. Kept separate so gradient
    accumulation over micro-batches with UNEQUAL real-image counts stays
    exact: loss = Σnum_i / Σden_i, grads = Σ∇num_i / Σden_i — averaging
    per-micro ratios would weight micro-batches by 1/images_i instead of
    uniformly per image."""
    from chestxray_vit_tpu.train.steps import bce_elements
    per = bce_elements(logits, labels)
    m = image_mask[..., None].astype(jnp.float32)       # [B, M, 1]
    return jnp.sum(per * m), jnp.sum(m) * logits.shape[-1]


def packed_bce_loss(logits: jax.Array, labels: jax.Array,
                    image_mask: jax.Array) -> jax.Array:
    """Mean BCE over real images only (pad slots masked out) — mean over
    (real images × classes), matching BCEWithLogits' mean."""
    num, den = packed_bce_parts(logits, labels, image_mask)
    return num / jnp.maximum(den, 1.0)
