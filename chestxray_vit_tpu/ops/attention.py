"""Multi-head attention: the one entry point every model path calls.

The reference delegates attention to HF ``ViTForImageClassification``'s
torch SDPA (/root/reference/ViT-Training.py:83; pyc L381). Here the dense,
packed, token-merging, int8 and serving forwards all call
:func:`attention` on ``[batch, heads, seq, head_dim]`` operands, and
``ModelConfig.attention_impl`` picks the implementation:

- ``'cudnn'``: ``jax.nn.dot_product_attention(implementation="cudnn")``,
  cuDNN's fused flash attention (forward and backward). The
  ``[B, H, S, S]`` scores never reach device memory. GPU only, bf16/fp16
  operands only.
- ``'xla'``: :func:`attention_xla`, einsums around an f32 softmax. It
  materialises the scores, runs on every backend, and is the numerical
  oracle the tests and ``chip_smoke.py`` compare against.
- ``'auto'``: ``'cudnn'`` on a GPU for bf16/fp16 operands (the faster of
  the two in the train step and the serving forward on the H100, see
  PERF.md "Attention"), ``'xla'`` everywhere else.

Two cases always take the materialised path, whatever the setting:
attention dropout (HF ViTSelfAttention semantics, dropout on the softmax
probabilities, drawn with ``jax.random``) and ``return_probs`` callers
such as attention rollout, which need the probabilities themselves.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from chestxray_vit_tpu.config import ATTENTION_IMPLS

_FUSED_DTYPES = (jnp.bfloat16, jnp.float16)


def resolve_impl(impl: str, dtype, platform: Optional[str] = None) -> str:
    """The implementation ``impl`` stands for on ``platform`` (default: JAX's
    default backend) for operands of ``dtype``: ``'cudnn'`` or ``'xla'``.

    Raises for a name outside ``ATTENTION_IMPLS`` (the removed ``'pallas'``
    included) and for ``'cudnn'`` where cuDNN cannot run it, rather than
    quietly running something else."""
    if impl not in ATTENTION_IMPLS:
        raise ValueError(
            f"attention_impl must be one of {ATTENTION_IMPLS}, got {impl!r}"
            + (" (the Pallas kernels were removed; 'auto' picks cuDNN "
               "fused attention on a GPU)" if impl == "pallas" else ""))
    platform = platform or jax.default_backend()
    fusable = jnp.dtype(dtype) in _FUSED_DTYPES
    if impl == "auto":
        return "cudnn" if platform == "gpu" and fusable else "xla"
    if impl == "cudnn" and (platform != "gpu" or not fusable):
        raise ValueError(
            f"attention_impl='cudnn' needs a GPU and bf16/fp16 operands; "
            f"got platform {platform!r}, dtype {jnp.dtype(dtype).name}")
    return impl


def segment_mask(segment_ids: jax.Array) -> jax.Array:
    """[B, S] segment ids -> [B, 1, S, S] bool mask, True within a segment
    (block-diagonal attention for NaViT-style packed rows)."""
    return segment_ids[:, None, :, None] == segment_ids[:, None, None, :]


def attention_probs(q: jax.Array, k: jax.Array,
                    segment_ids: Optional[jax.Array] = None) -> jax.Array:
    """softmax(QKᵀ/√d) in f32, [B, H, S, S] (masked across segments)."""
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                        preferred_element_type=jnp.float32)
    scores = scores / (q.shape[-1] ** 0.5)
    if segment_ids is not None:
        scores = jnp.where(segment_mask(segment_ids), scores, -1e30)
    return jax.nn.softmax(scores, axis=-1)


def attention_xla(q: jax.Array, k: jax.Array, v: jax.Array,
                  segment_ids: Optional[jax.Array] = None,
                  dropout_rate: float = 0.0,
                  dropout_rng: Optional[jax.Array] = None) -> jax.Array:
    """Plain XLA attention with an f32 softmax: the oracle and the
    materialised path. With ``dropout_rate > 0`` and a key, each
    probability is kept with chance ``1 - rate`` and rescaled."""
    p = attention_probs(q, k, segment_ids)
    if dropout_rate > 0.0 and dropout_rng is not None:
        keep = jax.random.bernoulli(dropout_rng, 1.0 - dropout_rate, p.shape)
        p = jnp.where(keep, p / (1.0 - dropout_rate), 0.0)
    return jnp.einsum("bhqk,bhkd->bhqd", p.astype(v.dtype), v,
                      preferred_element_type=jnp.float32).astype(q.dtype)


# segment id of the pad row added for cuDNN: unlike every real id (>= 0)
# and the packer's pad id (-1), so the pad row is nobody's key
_PAD_SEGMENT = jnp.iinfo(jnp.int32).min


def attention_fused(q: jax.Array, k: jax.Array, v: jax.Array,
                    segment_ids: Optional[jax.Array] = None,
                    implementation: str = "cudnn") -> jax.Array:
    """``jax.nn.dot_product_attention`` on [B, H, S, D] operands.

    cuDNN's fused backward takes even sequence lengths only, and ViT
    lengths (grid² + 1: 577, 1025) are odd. An odd sequence gets one pad
    row, masked out as a key by ``key_value_seq_lengths`` (cuDNN's padding
    mask, nothing materialised) or, with ``segment_ids``, by a segment id
    of its own; the pad row's output is sliced off. ``implementation``
    'xla' runs the same wrapper on any backend (the CPU tests)."""
    b, _, s, _ = q.shape
    pad = s % 2

    def to_bshd(x):                     # the layout the API takes
        return jnp.pad(jnp.swapaxes(x, 1, 2),
                       ((0, 0), (0, pad), (0, 0), (0, 0)))

    kwargs = {}
    if segment_ids is not None:
        seg = jnp.pad(segment_ids, ((0, 0), (0, pad)),
                      constant_values=_PAD_SEGMENT)
        kwargs["mask"] = segment_mask(seg)
    elif pad:
        kwargs["key_value_seq_lengths"] = jnp.full((b,), s, jnp.int32)
    o = jax.nn.dot_product_attention(to_bshd(q), to_bshd(k), to_bshd(v),
                                     implementation=implementation,
                                     **kwargs)
    return jnp.swapaxes(o[:, :s], 1, 2)


def attention(q: jax.Array, k: jax.Array, v: jax.Array, impl: str = "auto",
              segment_ids: Optional[jax.Array] = None,
              dropout_rate: float = 0.0,
              dropout_rng: Optional[jax.Array] = None) -> jax.Array:
    """softmax(QKᵀ/√d)·V over [batch, heads, seq, head_dim] operands, in
    q's dtype. ``segment_ids`` [batch, seq] restricts attention to equal
    ids (packed rows). Dropout (rate > 0 with a key) runs materialised."""
    if dropout_rate > 0.0 and dropout_rng is not None:
        resolve_impl(impl, q.dtype)             # still reject bad names
        return attention_xla(q, k, v, segment_ids, dropout_rate,
                             dropout_rng)
    if resolve_impl(impl, q.dtype) == "cudnn":
        return attention_fused(q, k, v, segment_ids)
    return attention_xla(q, k, v, segment_ids)
