"""From-scratch Vision Transformer in functional JAX.

The reference delegates its entire model to HF
``ViTForImageClassification.from_pretrained('google/vit-base-patch16-384')``
(/root/reference/ViT-Training.py:83-90; pyc L381-L386). This module rebuilds
that architecture in functional JAX:

- the 16×16 conv patch-embed becomes a single patch-extract reshape + matmul
  (conv-as-matmul, no im2col materialization),
- the encoder stack runs under ``lax.scan`` over stacked per-layer params
  (one compiled block trace instead of 12/24, with optional
  ``jax.checkpoint`` rematerialization for ViT-L),
- attention goes through ``ops/attention.attention`` (cuDNN fused
  attention on a GPU, XLA elsewhere),
- bf16 activations with f32 LayerNorm/softmax; master params stay f32.

Numerics match HF exactly in f32: erf GELU, LayerNorm eps 1e-12, pre-LN
residual blocks, CLS-token classification head (SURVEY.md §7 hard part 1).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.ad_checkpoint
import jax.numpy as jnp

from chestxray_vit_tpu.config import ModelConfig
from chestxray_vit_tpu.ops.attention import attention, attention_probs
from chestxray_vit_tpu.ops.gelu import gelu as _gelu
from chestxray_vit_tpu.ops.layer_norm import layer_norm as _layer_norm_op

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Initialization (HF ViT init: trunc-normal(0.02) weights, zero biases)
# ---------------------------------------------------------------------------

def init_params(rng: jax.Array, cfg: ModelConfig) -> Params:
    d, l = cfg.hidden_size, cfg.num_layers
    patch_dim = cfg.patch_size * cfg.patch_size * 3
    keys = iter(jax.random.split(rng, 16))
    trunc = jax.nn.initializers.truncated_normal(stddev=0.02)
    pdt = jnp.dtype(cfg.param_dtype)

    def tn(key, shape):
        return trunc(key, shape, pdt)

    def block_keys(key, n):
        return jax.random.split(key, n)

    bk = block_keys(next(keys), 6)
    blocks = {
        "ln1": {"scale": jnp.ones((l, d), pdt), "bias": jnp.zeros((l, d), pdt)},
        "ln2": {"scale": jnp.ones((l, d), pdt), "bias": jnp.zeros((l, d), pdt)},
        "wq": {"kernel": tn(bk[0], (l, d, d)), "bias": jnp.zeros((l, d), pdt)},
        "wk": {"kernel": tn(bk[1], (l, d, d)), "bias": jnp.zeros((l, d), pdt)},
        "wv": {"kernel": tn(bk[2], (l, d, d)), "bias": jnp.zeros((l, d), pdt)},
        "wo": {"kernel": tn(bk[3], (l, d, d)), "bias": jnp.zeros((l, d), pdt)},
        "mlp_in": {"kernel": tn(bk[4], (l, d, cfg.mlp_dim)),
                   "bias": jnp.zeros((l, cfg.mlp_dim), pdt)},
        "mlp_out": {"kernel": tn(bk[5], (l, cfg.mlp_dim, d)),
                    "bias": jnp.zeros((l, d), pdt)},
    }
    return {
        "patch_embed": {"kernel": tn(next(keys), (patch_dim, d)),
                        "bias": jnp.zeros((d,), pdt)},
        "cls_token": tn(next(keys), (1, 1, d)),
        "pos_embed": tn(next(keys), (1, cfg.seq_len, d)),
        "blocks": blocks,
        "final_ln": {"scale": jnp.ones((d,), pdt), "bias": jnp.zeros((d,), pdt)},
        "head": {"kernel": tn(next(keys), (d, cfg.num_classes)),
                 "bias": jnp.zeros((cfg.num_classes,), pdt)},
    }


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

# Memory-lean custom-VJP LayerNorm (f32 stats, HF eps 1e-12; saves only the
# bf16 input instead of f32 intermediates — see ops/layer_norm.py).
layer_norm = _layer_norm_op


def _linear(x, p):
    return jnp.dot(x, p["kernel"]) + p["bias"]


def patchify(images: jax.Array, patch: int) -> jax.Array:
    """NHWC [B, H, W, 3] → [B, N, patch*patch*3].

    Per-patch flatten order is (row-in-patch, col-in-patch, channel),
    matching the conv-kernel permutation used by the HF weight importer.
    """
    b, h, w, c = images.shape
    nh, nw = h // patch, w // patch
    x = images.reshape(b, nh, patch, nw, patch, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)              # [B, nh, nw, p, p, c]
    return x.reshape(b, nh * nw, patch * patch * c)


def embed(params: Params, images: jax.Array, cfg: ModelConfig,
          compute_dtype: jnp.dtype) -> jax.Array:
    """Patch-embed + CLS + learned position embeddings (HF ViTEmbeddings)."""
    patches = patchify(images.astype(compute_dtype), cfg.patch_size)
    pe = params["patch_embed"]
    x = jnp.dot(patches, pe["kernel"].astype(compute_dtype))
    x = x + pe["bias"].astype(compute_dtype)
    b = x.shape[0]
    cls = jnp.broadcast_to(params["cls_token"].astype(compute_dtype),
                           (b, 1, cfg.hidden_size))
    x = jnp.concatenate([cls, x], axis=1)
    return x + params["pos_embed"].astype(compute_dtype)


def _mha(x: jax.Array, bp: Params, cfg: ModelConfig,
         attn_impl: str, return_probs: bool = False,
         dropout_rng: Optional[jax.Array] = None, train: bool = False,
         return_key_mean: bool = False):
    """Multi-head attention, pre-LN input already applied.

    ``attention_dropout`` (HF ViTSelfAttention semantics: dropout on the
    softmax probabilities) runs on the materialised XLA path with
    ``jax.random`` masks (``ops/attention.py``); ``return_probs`` also
    materialises, since the probabilities are the product.

    ``return_key_mean`` additionally returns the head-mean of the keys
    [B, S, head_dim] — the token-merging similarity metric (ToMe §3:
    "the keys already summarize the information in each token")."""
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim

    def heads(p):
        # single einsum landing directly in [B, H, S, hd]: XLA folds the
        # head split + transpose into the matmul epilogue instead of
        # materializing a [B, S, H, hd] intermediate (measured ~3% fwd win)
        return (jnp.einsum("bsd,dhk->bhsk", x, p["kernel"].reshape(d, h, hd))
                + p["bias"].reshape(h, 1, hd))

    name = jax.ad_checkpoint.checkpoint_name
    if "wqkv" in bp:
        # fused projection: one [D, 3D] matmul instead of three [D, D]
        # (x is read from HBM once, not three times); head split still
        # folded into the epilogue, landing [3, B, H, S, hd]
        w = bp["wqkv"]["kernel"].reshape(d, 3, h, hd)
        bias = bp["wqkv"]["bias"].reshape(3, 1, h, 1, hd)
        qkv = jnp.einsum("bsd,dthk->tbhsk", x, w) + bias
        q = name(qkv[0], "attn_heads")
        k = name(qkv[1], "attn_heads")
        v = name(qkv[2], "attn_heads")
    else:
        q = name(heads(bp["wq"]), "attn_heads")
        k = name(heads(bp["wk"]), "attn_heads")
        v = name(heads(bp["wv"]), "attn_heads")
    probs = None
    if return_probs:
        probs = attention_probs(q, k)
        o = jnp.einsum("bhqk,bhkd->bhqd", probs.astype(v.dtype), v)
    else:
        o = attention(q, k, v, impl=attn_impl,
                      **attention_dropout_args(cfg, dropout_rng, train))
    # fold the heads-merge transpose into the output projection
    out = (jnp.einsum("bhsk,hkd->bsd", o,
                      bp["wo"]["kernel"].reshape(h, hd, d))
           + bp["wo"]["bias"])
    if return_key_mean:
        return out, probs, k.mean(axis=1)
    return out, probs


def _block(x: jax.Array, bp: Params, cfg: ModelConfig, attn_impl: str,
           dropout_rng: Optional[jax.Array], train: bool):
    """One pre-LN encoder block (HF ViTLayer):
    x += MHA(LN1(x)); x += MLP(LN2(x)) with erf GELU."""
    eps = cfg.layernorm_eps
    a_in = layer_norm(x, bp["ln1"]["scale"], bp["ln1"]["bias"], eps)
    attn_out, _ = _mha(a_in, bp, cfg, attn_impl,
                       dropout_rng=dropout_rng, train=train)
    attn_out = _dropout(attn_out, cfg.hidden_dropout, dropout_rng, train, 0)
    x = x + attn_out
    m_in = layer_norm(x, bp["ln2"]["scale"], bp["ln2"]["bias"], eps)
    hmid = _gelu(_linear(m_in, bp["mlp_in"]),
                 approximate=cfg.gelu_approximate)
    # named for the selective 'mlp' remat policy (see apply())
    hmid = jax.ad_checkpoint.checkpoint_name(hmid, "mlp_hidden")
    mlp_out = _linear(hmid, bp["mlp_out"])
    mlp_out = _dropout(mlp_out, cfg.hidden_dropout, dropout_rng, train, 1)
    return x + mlp_out


def attention_dropout_args(cfg: ModelConfig, rng: Optional[jax.Array],
                           train: bool) -> Dict[str, Any]:
    """:func:`attention` keyword arguments for ``cfg.attention_dropout``
    (salt 2 of the block's key; none outside training)."""
    if not train or cfg.attention_dropout == 0.0 or rng is None:
        return {}
    return {"dropout_rate": cfg.attention_dropout,
            "dropout_rng": jax.random.fold_in(rng, 2)}


def _dropout(x, rate, rng, train, salt):
    if not train or rate == 0.0 or rng is None:
        return x
    key = jax.random.fold_in(rng, salt)
    keep = jax.random.bernoulli(key, 1.0 - rate, x.shape)
    return jnp.where(keep, x / (1.0 - rate), 0.0).astype(x.dtype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def remat_policy(cfg: ModelConfig):
    """jax.checkpoint policy for ``cfg.remat_policy`` (None = full remat)."""
    if cfg.remat_policy == "mlp":
        return jax.checkpoint_policies.save_anything_except_these_names(
            "mlp_hidden")
    if cfg.remat_policy == "attn":
        # recompute only the per-head Q/K/V projections
        return jax.checkpoint_policies.save_anything_except_these_names(
            "attn_heads")
    if cfg.remat_policy == "attn_mlp":
        # also recompute the 4×-wide GELU hidden — the two biggest
        # residual classes dropped, everything else saved
        return jax.checkpoint_policies.save_anything_except_these_names(
            "attn_heads", "mlp_hidden")
    if cfg.remat_policy == "dots":
        return jax.checkpoint_policies.checkpoint_dots
    return None


def apply(params: Params, images: jax.Array, cfg: ModelConfig, *,
          train: bool = False, rng: Optional[jax.Array] = None,
          return_features: bool = False) -> jax.Array:
    """Forward pass.

    Args:
      images: NHWC f32/bf16 [B, img, img, 3] (use :func:`nchw_to_nhwc` for
        torch-layout inputs).
      train: enables dropout (reference fine-tune runs with 0.0 rates).
      return_features: also return the final-LN CLS features.

    Returns logits f32 [B, num_classes] (and features if requested).
    """
    if getattr(cfg, "tome_r", 0) and not return_features:
        # token-merging model (model.tome_r > 0): train AND eval run the
        # merged forward so best-model selection/eval metrics describe the
        # model actually being trained (ToMe trains + infers with the same
        # r, arXiv:2210.09461 §4.2). Unrolled per-layer shapes → separate
        # module (lazy import: tome_forward imports this module).
        from chestxray_vit_tpu.models.tome_forward import apply_tome_train
        return apply_tome_train(params, images, cfg, cfg.tome_r,
                                train=train, rng=rng,
                                schedule=getattr(cfg, "tome_schedule",
                                                 "constant"))
    compute_dtype = jnp.dtype(cfg.dtype)
    cast = lambda p: jax.tree.map(lambda a: a.astype(compute_dtype), p)

    x = embed(params, images, cfg, compute_dtype)

    blocks = cast(params["blocks"])
    if cfg.fused_qkv:
        # stack per-layer Q/K/V kernels once per step OUTSIDE the scan:
        # [L, D, 3, D] + [L, 3, D]; the scan body sees a fused 'wqkv' entry
        blocks = dict(blocks)
        blocks["wqkv"] = {
            "kernel": jnp.stack([blocks["wq"]["kernel"],
                                 blocks["wk"]["kernel"],
                                 blocks["wv"]["kernel"]], axis=2),
            "bias": jnp.stack([blocks["wq"]["bias"],
                               blocks["wk"]["bias"],
                               blocks["wv"]["bias"]], axis=1),
        }
        for k in ("wq", "wk", "wv"):
            del blocks[k]

    def scan_body(carry, layer_params):
        x, key = carry
        key, sub = (jax.random.split(key) if key is not None else (None, None))
        y = _block(x, layer_params, cfg, cfg.attention_impl, sub, train)
        return (y, key), None

    body = scan_body
    if cfg.remat:
        body = jax.checkpoint(scan_body, policy=remat_policy(cfg),
                              prevent_cse=False)
    (x, _), _ = jax.lax.scan(body, (x, rng), blocks)

    fl = params["final_ln"]
    x = layer_norm(x, fl["scale"], fl["bias"], cfg.layernorm_eps)
    cls_features = x[:, 0, :]
    head = params["head"]
    logits = (jnp.dot(cls_features.astype(jnp.float32),
                      head["kernel"].astype(jnp.float32))
              + head["bias"].astype(jnp.float32))
    if return_features:
        return logits, cls_features
    return logits


def unstack_blocks(params: Params, cfg: ModelConfig,
                   compute_dtype: Optional[jnp.dtype] = None) -> list:
    """Per-layer parameter views of the stacked scan tree."""
    dt = compute_dtype or jnp.dtype(cfg.dtype)
    return [jax.tree.map(lambda a, i=i: a[i].astype(dt), params["blocks"])
            for i in range(cfg.num_layers)]


def run_block(x: jax.Array, bp: Params, cfg: ModelConfig,
              return_probs: bool = False):
    """One encoder block, unrolled form (introspection paths)."""
    a_in = layer_norm(x, bp["ln1"]["scale"], bp["ln1"]["bias"],
                      cfg.layernorm_eps)
    attn_out, probs = _mha(a_in, bp, cfg, "xla", return_probs=return_probs)
    x = x + attn_out
    m_in = layer_norm(x, bp["ln2"]["scale"], bp["ln2"]["bias"],
                      cfg.layernorm_eps)
    x = x + _linear(_gelu(_linear(m_in, bp["mlp_in"]),
                          approximate=cfg.gelu_approximate),
                    bp["mlp_out"])
    return x, probs


def head_logits(params: Params, tokens: jax.Array,
                cfg: ModelConfig) -> jax.Array:
    """Final LN + CLS classifier head on encoder output tokens."""
    fl = params["final_ln"]
    x = layer_norm(tokens, fl["scale"], fl["bias"], cfg.layernorm_eps)
    head = params["head"]
    return (jnp.dot(x[:, 0, :].astype(jnp.float32),
                    head["kernel"].astype(jnp.float32))
            + head["bias"].astype(jnp.float32))


def apply_with_attention(params: Params, images: jax.Array,
                         cfg: ModelConfig) -> Tuple[jax.Array, jax.Array]:
    """Forward pass that also returns per-layer attention probabilities
    [L, B, H, S, S] for attention-rollout map extraction (serving path).
    Uses the unfused XLA attention since the probabilities themselves are
    the product."""
    compute_dtype = jnp.dtype(cfg.dtype)
    x = embed(params, images, cfg, compute_dtype)
    all_probs = []
    for bp in unstack_blocks(params, cfg, compute_dtype):
        x, probs = run_block(x, bp, cfg, return_probs=True)
        all_probs.append(probs)
    return head_logits(params, x, cfg), jnp.stack(all_probs)


def _torch_bicubic_weights(out_size: int, in_size: int) -> jnp.ndarray:
    """[out, in] 1-D resampling matrix matching
    ``torch.nn.functional.interpolate(mode='bicubic',
    align_corners=False)`` exactly: cubic-convolution kernel with a=-0.75
    (torch/PIL convention; jax.image.resize uses the Keys kernel a=-0.5,
    which differs numerically), source coord (i+0.5)*scale-0.5, and
    replicate-edge tap clamping (clamped taps accumulate their weight)."""
    import numpy as np

    a = -0.75
    scale = in_size / out_size

    def cubic(x):
        x = abs(x)
        if x <= 1.0:
            return (a + 2.0) * x**3 - (a + 3.0) * x**2 + 1.0
        if x < 2.0:
            return a * x**3 - 5.0 * a * x**2 + 8.0 * a * x - 4.0 * a
        return 0.0

    w = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        i0 = int(np.floor(src))
        t = src - i0
        for k in range(-1, 3):
            idx = min(max(i0 + k, 0), in_size - 1)
            w[i, idx] += cubic(k - t)
    return jnp.asarray(w, jnp.float32)


def interpolate_pos_embed(pos_embed: jax.Array, new_seq_len: int
                          ) -> jax.Array:
    """Resize learned position embeddings to a new patch grid.

    [1, S_old, D] → [1, S_new, D]: the CLS slot is kept, the patch grid is
    bicubic-resampled with torch/HF `interpolate_pos_encoding` numerics
    (separable a=-0.75 cubic convolution as two matmuls, oracle-tested
    against torch.nn.functional.interpolate) — how the high-res @512
    configs reuse @384 pretrained weights (1025 = 32² + 1 tokens from
    577 = 24² + 1)."""
    cls_tok, grid = pos_embed[:, :1], pos_embed[:, 1:]
    g_old = int(grid.shape[1] ** 0.5)
    g_new = int((new_seq_len - 1) ** 0.5)
    if g_new * g_new != new_seq_len - 1:
        raise ValueError(f"seq_len {new_seq_len} is not grid² + 1")
    if g_new == g_old:
        return pos_embed
    d = grid.shape[-1]
    w = _torch_bicubic_weights(g_new, g_old)             # [g_new, g_old]
    g = grid.reshape(g_old, g_old, d).astype(jnp.float32)
    # rows: [g_new, g_old, d]; then cols: [g_new, g_new, d]
    g = jnp.einsum("oi,ijd->ojd", w, g)
    g = jnp.einsum("oj,njd->nod", w, g)
    resized = g.reshape(1, g_new * g_new, d).astype(pos_embed.dtype)
    return jnp.concatenate([cls_tok, resized], axis=1)


def adapt_params_to_img_size(params: Params, cfg: ModelConfig) -> Params:
    """Return params with position embeddings matched to cfg.img_size
    (no-op when they already match)."""
    target = cfg.seq_len
    if params["pos_embed"].shape[1] == target:
        return params
    out = dict(params)
    out["pos_embed"] = interpolate_pos_embed(params["pos_embed"], target)
    return out


def nchw_to_nhwc(x: jax.Array) -> jax.Array:
    return jnp.transpose(x, (0, 2, 3, 1))


def num_params(params: Params) -> int:
    return sum(int(a.size) for a in jax.tree.leaves(params))
