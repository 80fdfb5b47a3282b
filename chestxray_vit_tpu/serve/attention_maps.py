"""Attention-map extraction: attention rollout and Grad-CAM.

The reference lists attention maps as an unshipped TODO
(/root/reference/README.md:90 "Add attention map visualization"); the rebuild
ships it. Two standard ViT explanation methods:

- **attention rollout** (Abnar & Zuidema 2020): fuse heads per layer, add the
  residual identity, row-normalize, and chain-multiply across layers; the
  CLS row over patch tokens becomes a [grid × grid] saliency map.
- **Grad-CAM** adapted to ViT: gradients of a class logit w.r.t. the token
  activations entering the last encoder block; channel-weighted ReLU'd sum
  over patch tokens.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from chestxray_vit_tpu.config import ModelConfig
from chestxray_vit_tpu.models import vit


def attention_rollout(attn_probs: jax.Array, head_fuse: str = "mean",
                      residual_alpha: float = 0.5) -> jax.Array:
    """[L, B, H, S, S] attention probabilities → [B, g, g] CLS saliency.

    Per layer: fuse heads (mean/max/min), blend with the identity for the
    residual stream (A ← α·A + (1-α)·I, re-normalized), then multiply the
    chain bottom-up. The CLS row over patch tokens, normalized to [0, 1],
    reshaped to the patch grid.
    """
    if head_fuse == "mean":
        fused = attn_probs.mean(axis=2)
    elif head_fuse == "max":
        fused = attn_probs.max(axis=2)
    elif head_fuse == "min":
        fused = attn_probs.min(axis=2)
    else:
        raise ValueError(f"unknown head_fuse {head_fuse!r}")
    fused = fused.astype(jnp.float32)                  # [L, B, S, S]

    l, b, s, _ = fused.shape
    eye = jnp.eye(s, dtype=jnp.float32)
    blended = residual_alpha * fused + (1.0 - residual_alpha) * eye
    blended = blended / blended.sum(axis=-1, keepdims=True)

    def chain(carry, a):
        return a @ carry, None

    rollout, _ = jax.lax.scan(chain, jnp.broadcast_to(eye, (b, s, s)),
                              blended)
    cls_to_patches = rollout[:, 0, 1:]                 # [B, S-1]
    g = int((s - 1) ** 0.5)
    maps = cls_to_patches.reshape(b, g, g)
    mn = maps.min(axis=(1, 2), keepdims=True)
    mx = maps.max(axis=(1, 2), keepdims=True)
    return (maps - mn) / jnp.maximum(mx - mn, 1e-12)


def compute_rollout(params, images: jax.Array, cfg: ModelConfig,
                    head_fuse: str = "mean"
                    ) -> Tuple[jax.Array, jax.Array]:
    """Forward + rollout in one call: (logits, [B, g, g] maps)."""
    logits, probs = vit.apply_with_attention(params, images, cfg)
    return logits, attention_rollout(probs, head_fuse=head_fuse)


def grad_cam(params, images: jax.Array, cfg: ModelConfig,
             class_idx: jax.Array | int,
             layer: Optional[int] = None) -> Tuple[jax.Array, jax.Array]:
    """ViT Grad-CAM: (logits, [B, g, g] maps) for ``class_idx``.

    ``layer`` selects which block's *input* tokens act as the feature map
    (default: the last block — gradients still flow to patch tokens through
    its attention, unlike the CLS-only classifier head).
    """
    compute_dtype = jnp.dtype(cfg.dtype)
    layer = cfg.num_layers - 1 if layer is None else layer
    blocks = vit.unstack_blocks(params, cfg, compute_dtype)

    x = vit.embed(params, images, cfg, compute_dtype)
    for bp in blocks[:layer]:
        x, _ = vit.run_block(x, bp, cfg)
    feats = x                                            # [B, S, D]

    def tail_logits(feats):
        y = feats
        for bp in blocks[layer:]:
            y, _ = vit.run_block(y, bp, cfg)
        return vit.head_logits(params, y, cfg)           # [B, C]

    def score(feats):
        logits = tail_logits(feats)
        idx = jnp.broadcast_to(jnp.asarray(class_idx), (logits.shape[0],))
        return jnp.take_along_axis(logits, idx[:, None], axis=1).sum(), logits

    grads, logits = jax.grad(score, has_aux=True)(feats)
    grads = grads.astype(jnp.float32)
    feats32 = feats.astype(jnp.float32)
    # channel weights: mean gradient over tokens (GAP in CNN Grad-CAM)
    weights = grads.mean(axis=1, keepdims=True)          # [B, 1, D]
    cam_tokens = jnp.maximum((weights * feats32).sum(-1), 0.0)  # [B, S]
    cam = cam_tokens[:, 1:]                              # drop CLS
    g = int(cam.shape[1] ** 0.5)
    maps = cam.reshape(-1, g, g)
    mn = maps.min(axis=(1, 2), keepdims=True)
    mx = maps.max(axis=(1, 2), keepdims=True)
    return logits, (maps - mn) / jnp.maximum(mx - mn, 1e-12)


def upsample_map(maps: jax.Array, out_size: int) -> jax.Array:
    """[B, g, g] → [B, out, out] bilinear upsample for overlay rendering."""
    return jax.image.resize(
        maps, (maps.shape[0], out_size, out_size), method="bilinear")


def render_overlay(gray, map01, alpha: float = 0.45):
    """u8 [H, W] radiograph + [g, g] normalized attention map → RGB u8
    overlay (red-yellow heat blended over the image) — the host-side
    rendering for the ``maps`` CLI and notebook use. Pure numpy/PIL."""
    import numpy as np
    from PIL import Image

    h, w = gray.shape
    m = np.asarray(
        Image.fromarray((np.clip(np.asarray(map01, np.float32), 0, 1)
                         * 255).astype(np.uint8), "L")
        .resize((w, h), Image.BILINEAR), np.float32) / 255.0
    base = (1.0 - alpha) * gray.astype(np.float32)
    out = np.stack([
        base + alpha * 255.0 * m,              # red ∝ attention
        base + alpha * 255.0 * 0.6 * m * m,    # yellow tint at the peak
        base,
    ], axis=-1)
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)
