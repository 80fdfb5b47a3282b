"""Token merging (ToMe-style) for inference: bipartite soft matching.

Beyond the reference (speed/quality-tradeoff serving accelerator, opt-in
via ``Predictor(tome_r=...)``): each transformer layer merges the ``r``
most similar token pairs, so later layers process fewer tokens (step
time on the H100 not measured yet).

Algorithm (reimplemented from Bolya et al., "Token Merging: Your ViT But
Faster", arXiv:2210.09461 — no code copied): tokens split into
alternating sets A/B; each A-token proposes its most-similar B-token
under cosine similarity of the attention KEYS (mean over heads); the r
highest-scoring proposals merge source→destination with a size-weighted
mean; sizes accumulate so repeated merges stay means over the original
tokens. The CLS token is protected (never a source) and stays at
position 0. All output shapes are static (r is a compile-time constant);
only gather/scatter indices are data-dependent — jit-friendly.

Deliberate deviation, documented: no proportional attention (the paper's
optional log-size attention bias; ~0.1-0.2 pt effect off-the-shelf) —
it would need a per-key bias operand in the flash kernel and is not
worth the kernel surgery for classification serving.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

_NEG_INF = -1e30


def r_schedule(r: int, num_layers: int, schedule: str = "constant"
               ) -> Tuple[int, ...]:
    """Per-layer merge counts for a nominal rate ``r``.

    - 'constant': r pairs every layer (the paper's default).
    - 'decreasing': linearly decaying counts with the SAME nominal total
      (r·L), weighted ∝ (L−l) — most merging in early layers where
      tokens are redundant and plentiful, tapering toward zero at depth.
      The paper's decreasing schedule (arXiv:2210.09461 §4.1) front-loads
      the token reduction where the most compute remains downstream, so
      more of the budget is feasible before the per-layer clamp binds
      than under constant-r on deep models.

    The forwards still clamp each layer to the feasible maximum
    (ceil(S_l/2) − 1), so an infeasible count degrades gracefully instead
    of erroring. NOTE the clamp means the r·L total is realized only when
    every per-layer count stays feasible: when the budget exceeds the
    mergeable-token supply (e.g. ViT-L at r=32: 24·32 = 768 > the 576
    patch tokens), BOTH schedules clamp — decreasing just realizes more
    of the budget, earlier.
    """
    if r < 0:
        raise ValueError(f"r={r} must be >= 0")
    if num_layers < 1:
        raise ValueError(f"num_layers={num_layers} must be >= 1")
    if schedule == "constant":
        return (r,) * num_layers
    if schedule != "decreasing":
        raise ValueError(f"unknown tome schedule {schedule!r} "
                         "(expected 'constant' or 'decreasing')")
    total = r * num_layers
    weights = range(num_layers, 0, -1)
    sw = num_layers * (num_layers + 1) // 2
    rs = [total * w // sw for w in weights]
    for i in range(total - sum(rs)):   # exact total: remainder to the front
        rs[i] += 1
    return tuple(rs)


def bipartite_soft_matching(metric: jax.Array, r: int
                            ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Pick the r most-mergeable (source, destination) token pairs.

    metric: [B, S, d] similarity features (attention keys, mean over
    heads). Token 0 (CLS) is protected. Returns ``(unm_idx, src_idx,
    dst_idx)``: A-set indices kept / merged, and for each merged source
    its B-set destination. A = even positions, B = odd; with S tokens,
    |A| = ceil(S/2), |B| = floor(S/2); requires 0 < r < |A|.
    """
    b, s, _ = metric.shape
    na = (s + 1) // 2
    if not 0 < r < na:
        raise ValueError(f"r={r} must be in (0, {na}) for S={s}")
    m = metric.astype(jnp.float32)
    m = m / jnp.maximum(jnp.linalg.norm(m, axis=-1, keepdims=True), 1e-6)
    a, bm = m[:, 0::2], m[:, 1::2]
    scores = jnp.einsum("bad,bcd->bac", a, bm)        # [B, |A|, |B|]
    scores = scores.at[:, 0, :].set(_NEG_INF)         # protect CLS
    node_max = jnp.max(scores, axis=-1)               # [B, |A|]
    node_idx = jnp.argmax(scores, axis=-1)            # [B, |A|]
    edge_order = jnp.argsort(-node_max, axis=-1)      # best-first
    src_idx = edge_order[:, :r]
    # ascending kept-order preserves CLS at global position 0
    unm_idx = jnp.sort(edge_order[:, r:], axis=-1)
    dst_idx = jnp.take_along_axis(node_idx, src_idx, axis=-1)
    return unm_idx, src_idx, dst_idx


def merge_tokens(x: jax.Array, sizes: jax.Array, unm_idx: jax.Array,
                 src_idx: jax.Array, dst_idx: jax.Array
                 ) -> Tuple[jax.Array, jax.Array]:
    """Apply a matching: size-weighted mean of each source into its
    destination. x: [B, S, D]; sizes: [B, S] (token multiplicities,
    ones initially). Returns ``(x', sizes')`` with S' = S - r tokens,
    ordered [kept-A..., B...].

    Formulation: the whole merge (keep-gather + source→destination
    scatter-add + reorder) is ONE one-hot routing matmul instead of a
    dynamic gather/scatter on [B, S, D] (chosen on the previous
    accelerator, where gather/scatter serialized; ROADMAP Speed item 8
    re-measures it on the H100). Only tiny int32 [B, S/2] scatters remain
    (slot indices).
    """
    b, s, _ = x.shape
    na = (s + 1) // 2
    r = src_idx.shape[1]
    bidx = jnp.arange(b)[:, None]

    # output slot for every A token: kept → its rank among kept
    # (unm_idx is sorted, so CLS keeps slot 0); source → its
    # destination's B slot
    apos = jnp.zeros((b, na), jnp.int32)
    apos = apos.at[bidx, unm_idx].set(
        jnp.broadcast_to(jnp.arange(na - r, dtype=jnp.int32), (b, na - r)))
    apos = apos.at[bidx, src_idx].set(na - r + dst_idx.astype(jnp.int32))
    return _route_merge(x, sizes, apos, r)


def tome_merge(x: jax.Array, metric: jax.Array, sizes: jax.Array, r: int
               ) -> Tuple[jax.Array, jax.Array]:
    """One ToMe step: match on ``metric``, merge ``x``. Returns
    ``(x', sizes')`` with r fewer tokens.

    Fused fast path (equivalent to ``merge_tokens(x, sizes,
    *bipartite_soft_matching(metric, r))`` — pinned by
    tests/test_tome.py): ``lax.top_k`` instead of a full argsort, kept-A
    slots from a mask cumsum instead of index sorting/gathers, and ONE
    bf16 routing matrix shared by the token and size reductions; this
    path's overhead is the routing matmul plus two tiny int32 scatters.
    """
    b, s, _ = x.shape
    na = (s + 1) // 2
    if not 0 < r < na:
        raise ValueError(f"r={r} must be in (0, {na}) for S={s}")
    m = metric.astype(jnp.float32)
    m = m / jnp.maximum(jnp.linalg.norm(m, axis=-1, keepdims=True), 1e-6)
    scores = jnp.einsum("bad,bcd->bac", m[:, 0::2], m[:, 1::2])
    scores = scores.at[:, 0, :].set(_NEG_INF)         # protect CLS
    node_max = jnp.max(scores, axis=-1)               # [B, |A|]
    node_idx = jnp.argmax(scores, axis=-1)
    _, src_idx = jax.lax.top_k(node_max, r)           # [B, r]
    dst_idx = jnp.take_along_axis(node_idx, src_idx, axis=-1)

    bidx = jnp.arange(b)[:, None]
    kept = jnp.ones((b, na), jnp.int32).at[bidx, src_idx].set(0)
    # ascending kept order ≡ sorted unm_idx: CLS stays at slot 0
    kept_rank = jnp.cumsum(kept, axis=1) - 1
    apos = jnp.where(kept.astype(bool), kept_rank, 0)
    apos = apos.at[bidx, src_idx].set(na - r + dst_idx.astype(jnp.int32))
    return _route_merge(x, sizes, apos, r)


def _out_slots(apos: jax.Array, b: int, s: int, r: int) -> jax.Array:
    """Per-token output slots [B, S] from per-A-token slots: B tokens keep
    their order after the kept-A block; A tokens go to their kept rank or
    their destination's B slot."""
    na, nb = (s + 1) // 2, s // 2
    bpos = jnp.broadcast_to(na - r + jnp.arange(nb, dtype=jnp.int32),
                            (b, nb))
    out_slot = jnp.zeros((b, s), jnp.int32)
    out_slot = out_slot.at[:, 0::2].set(apos)
    out_slot = out_slot.at[:, 1::2].set(bpos)
    return out_slot


def _route_merge(x: jax.Array, sizes: jax.Array, apos: jax.Array, r: int
                 ) -> Tuple[jax.Array, jax.Array]:
    """Merge via one one-hot routing matmul given per-A-token output
    slots (kept rank, or na-r+dst for sources)."""
    b, s, _ = x.shape
    so = s - r
    out_slot = _out_slots(apos, b, s, r)
    route = out_slot[..., None] == jnp.arange(so, dtype=jnp.int32)
    mm_dtype = x.dtype if x.dtype == jnp.bfloat16 else jnp.float32
    route = route.astype(mm_dtype)
    sz = sizes.astype(jnp.float32)
    xw = (x.astype(jnp.float32) * sz[..., None]).astype(mm_dtype)
    num = jnp.einsum("bjs,bjd->bsd", route, xw,
                     preferred_element_type=jnp.float32)
    # sizes stay exact f32: a [B, S]→[B, S'] scatter-add is tiny (no D
    # axis), and bf16 would round integer counts above 256 — skewing
    # the weighted means and breaking exact size conservation
    bidx = jnp.arange(b)[:, None]
    den = jnp.zeros((b, so), jnp.float32).at[bidx, out_slot].add(sz)
    out = (num / den[..., None]).astype(x.dtype)
    return out, den


def tome_merge_packed(x: jax.Array, metric: jax.Array, sizes: jax.Array,
                      seg_ids: jax.Array, pool_weights: jax.Array, r: int
                      ) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """One WITHIN-SEGMENT ToMe step for NaViT-style packed sequences.

    Same matching/merge math as :func:`tome_merge` with two packed-specific
    rules (beyond the reference; extends the train lever to the packed
    variable-resolution path):

    - cross-segment similarities are masked to −inf, so merges never mix
      different images' tokens (the reason PackedTrainer used to reject
      ``model.tome_r`` outright);
    - the per-image pooling weights ride the SAME routing matrix, which
      preserves the masked-mean readout exactly: pooled_m = Σ_j pw[m,j]·x_j
      over original tokens becomes Σ_{s'} (Σ_{j∈group(s')} pw[m,j])·x'_{s'}
      under the merge approximation x_j ≈ x'_{s'}.

    There is no CLS to protect (packed readout is pooled). Padding pairs
    (both tokens in segment −1) are FORCED to score 2.0 — above any
    cosine — so the matcher always compacts padding before touching real
    content: merging pads loses zero information (their pool weights are
    zero and the segment mask isolates them), so a budget the padding can
    absorb is free sequence shrinkage (tested: pad-budget merges leave
    real images' logits bit-comparable). seg_ids' is the (segment-pure)
    group's id.

    Feasibility caveat (documented, not checkable at trace time): r must
    not exceed the number of same-segment (A, B) pairs in the batch; with
    the packer's ≥256-token images and the per-layer clamp this holds with
    a wide margin, but a pathological batch of length-1 segments could
    force a cross-segment merge rather than erroring. Returns
    ``(x', sizes', seg_ids', pool_weights')`` with S' = S − r.
    """
    b, s, _ = x.shape
    na = (s + 1) // 2
    if not 0 < r < na:
        raise ValueError(f"r={r} must be in (0, {na}) for S={s}")
    m = metric.astype(jnp.float32)
    m = m / jnp.maximum(jnp.linalg.norm(m, axis=-1, keepdims=True), 1e-6)
    scores = jnp.einsum("bad,bcd->bac", m[:, 0::2], m[:, 1::2])
    seg_a, seg_b = seg_ids[:, 0::2], seg_ids[:, 1::2]
    same_seg = seg_a[:, :, None] == seg_b[:, None, :]
    scores = jnp.where(same_seg, scores, _NEG_INF)
    # pad–pad pairs outrank any cosine: compact padding before content
    pad_pair = (seg_a < 0)[:, :, None] & (seg_b < 0)[:, None, :]
    scores = jnp.where(pad_pair, 2.0, scores)
    node_max = jnp.max(scores, axis=-1)               # [B, |A|]
    node_idx = jnp.argmax(scores, axis=-1)
    _, src_idx = jax.lax.top_k(node_max, r)           # [B, r]
    dst_idx = jnp.take_along_axis(node_idx, src_idx, axis=-1)

    bidx = jnp.arange(b)[:, None]
    kept = jnp.ones((b, na), jnp.int32).at[bidx, src_idx].set(0)
    kept_rank = jnp.cumsum(kept, axis=1) - 1
    apos = jnp.where(kept.astype(bool), kept_rank, 0)
    apos = apos.at[bidx, src_idx].set(na - r + dst_idx.astype(jnp.int32))

    so = s - r
    out_slot = _out_slots(apos, b, s, r)
    route = out_slot[..., None] == jnp.arange(so, dtype=jnp.int32)
    mm_dtype = x.dtype if x.dtype == jnp.bfloat16 else jnp.float32
    routef = route.astype(mm_dtype)
    sz = sizes.astype(jnp.float32)
    xw = (x.astype(jnp.float32) * sz[..., None]).astype(mm_dtype)
    num = jnp.einsum("bjs,bjd->bsd", routef, xw,
                     preferred_element_type=jnp.float32)
    den = jnp.zeros((b, so), jnp.float32).at[bidx, out_slot].add(sz)
    out = (num / den[..., None]).astype(x.dtype)
    # groups are segment-pure (the mask above), so a scatter-max recovers
    # each output slot's segment; every slot is non-empty (B tokens keep
    # their slot, kept-A slots hold their token), so the −2 init never
    # survives
    seg_out = jnp.full((b, so), -2, seg_ids.dtype
                       ).at[bidx, out_slot].max(seg_ids)
    # pool weights carry sizes already (w[m, j] = size_j / N_m), so the
    # plain 0/1 routing — not the size-weighted mean — preserves each
    # image's total mass exactly
    pw = jnp.einsum("bmj,bjs->bms", pool_weights.astype(jnp.float32),
                    route.astype(jnp.float32),
                    preferred_element_type=jnp.float32)
    return out, den, seg_out, pw
