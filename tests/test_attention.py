"""The attention entry point (ops/attention.py) against a float64 numpy
oracle, the cuDNN wrapper's padding and masking (run through XLA's
implementation of the same API on the CPU), the choice of implementation,
and materialised dropout. ViT lengths are odd (grid² + 1: 577 @384, 1025
@512), which the fused wrapper pads to even."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chestxray_vit_tpu.config import ModelConfig
from chestxray_vit_tpu.ops.attention import (
    attention,
    attention_fused,
    attention_probs,
    attention_xla,
    resolve_impl,
)

LENGTHS = [64, 128, 137, 256, 577, 1025]


def _qkv(rng, b=1, h=2, s=137, d=64, dtype=jnp.float32):
    return tuple(jnp.asarray(rng.standard_normal((b, h, s, d)), dtype)
                 for _ in range(3))


def np_attention(q, k, v):
    q, k, v = (np.asarray(x, np.float64) for x in (q, k, v))
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v)


def fused_xla(q, k, v, seg=None):
    return attention_fused(q, k, v, seg, implementation="xla")


@pytest.mark.parametrize("s", LENGTHS)
def test_attention_matches_numpy_oracle(rng, s):
    q, k, v = _qkv(rng, h=1 if s > 600 else 2, s=s)
    out = attention(q, k, v, impl="auto")
    assert out.shape == q.shape and out.dtype == q.dtype
    np.testing.assert_allclose(np.asarray(out), np_attention(q, k, v),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s", LENGTHS)
def test_fused_wrapper_matches_oracle_fwd_and_grad(rng, s):
    """The cuDNN wrapper (odd lengths padded by one masked key row) through
    XLA's implementation of the same API: forward and all three grads."""
    q, k, v = _qkv(rng, h=1 if s > 600 else 2, s=s)
    g = jnp.asarray(rng.standard_normal(q.shape), jnp.float32)
    np.testing.assert_allclose(np.asarray(fused_xla(q, k, v)),
                               np.asarray(attention_xla(q, k, v)),
                               atol=1e-5, rtol=1e-5)
    ours = jax.grad(lambda *a: jnp.sum(fused_xla(*a) * g),
                    argnums=(0, 1, 2))(q, k, v)
    ref = jax.grad(lambda *a: jnp.sum(attention_xla(*a) * g),
                   argnums=(0, 1, 2))(q, k, v)
    for a, r in zip(ours, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("fn", [attention, fused_xla], ids=["auto", "fused"])
def test_bf16_inputs_keep_dtype_and_track_f32(rng, fn):
    q, k, v = _qkv(rng, s=96, dtype=jnp.bfloat16)
    out = fn(q, k, v)
    assert out.dtype == jnp.bfloat16
    ref = np_attention(*(np.asarray(x, np.float32) for x in (q, k, v)))
    np.testing.assert_allclose(np.asarray(out, np.float32), ref,
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("fn", [attention, fused_xla], ids=["auto", "fused"])
def test_jit_and_grad_under_jit(rng, fn):
    q, k, v = _qkv(rng, s=101)

    @jax.jit
    def f(q, k, v):
        return jax.grad(lambda q: jnp.sum(fn(q, k, v)))(q)

    out = f(q, k, v)
    assert out.shape == q.shape and bool(jnp.isfinite(out).all())


@pytest.mark.parametrize("fn", [attention, fused_xla], ids=["auto", "fused"])
def test_strongly_negative_scores(rng, fn):
    """Every valid score in a row strongly negative: the padded key row of
    the fused wrapper must not win the softmax (its score would be 0)."""
    s, d = 131, 8
    q = jnp.full((1, 1, s, d), 10.0, jnp.float32)
    q = q + jnp.asarray(rng.standard_normal(q.shape) * 0.1, jnp.float32)
    k = jnp.full((1, 1, s, d), -10.0, jnp.float32)
    v = jnp.asarray(rng.standard_normal((1, 1, s, d)), jnp.float32)
    out = fn(q, k, v)
    assert np.isfinite(np.asarray(out)).all()
    np.testing.assert_allclose(np.asarray(out), np_attention(q, k, v),
                               atol=1e-5, rtol=1e-5)
    ours = jax.grad(lambda *a: (fn(*a) ** 2).sum(), argnums=(0, 1, 2))(q, k, v)
    ref = jax.grad(lambda *a: (attention_xla(*a) ** 2).sum(),
                   argnums=(0, 1, 2))(q, k, v)
    for a, r in zip(ours, ref):
        assert np.isfinite(np.asarray(a)).all()
        np.testing.assert_allclose(np.asarray(a), np.asarray(r),
                                   atol=1e-5, rtol=1e-4)


BF16, F32 = jnp.bfloat16, jnp.float32


@pytest.mark.parametrize("impl,platform,dtype,want", [
    ("auto", "gpu", BF16, "cudnn"),
    ("auto", "gpu", jnp.float16, "cudnn"),
    ("auto", "gpu", F32, "xla"),
    ("auto", "cpu", BF16, "xla"),
    ("xla", "gpu", BF16, "xla"),
    ("cudnn", "gpu", BF16, "cudnn"),
])
def test_resolve_impl(impl, platform, dtype, want):
    assert resolve_impl(impl, dtype, platform) == want


@pytest.mark.parametrize("impl,platform,dtype,match", [
    ("pallas", "gpu", BF16, "Pallas"),
    ("pallas", "cpu", F32, "Pallas"),
    ("flash", "gpu", BF16, "one of"),
    ("cudnn", "cpu", BF16, "needs a GPU"),
    ("cudnn", "gpu", F32, "bf16"),
])
def test_resolve_impl_rejects(impl, platform, dtype, match):
    with pytest.raises(ValueError, match=match):
        resolve_impl(impl, dtype, platform)


def test_default_platform_is_jax_backend_and_cudnn_raises_here(rng):
    q, k, v = _qkv(rng, s=16, dtype=BF16)
    assert resolve_impl("auto", BF16) == "xla"       # tests run on the CPU
    with pytest.raises(ValueError, match="needs a GPU"):
        attention(q, k, v, impl="cudnn")


def test_model_config_rejects_removed_impl():
    with pytest.raises(ValueError, match="attention_impl"):
        ModelConfig(attention_impl="pallas")


# --- materialised dropout ---------------------------------------------------

RATE = 0.3


def _keep_mask(seed, b=2, h=3, s=64):
    """Recover the dropout mask exactly: q = k = 0 makes every probability
    1/S, and v = I turns each output row into keep / (S (1 - rate))."""
    q = jnp.zeros((b, h, s, s), jnp.float32)
    v = jnp.broadcast_to(jnp.eye(s, dtype=jnp.float32), (b, h, s, s))
    out = attention_xla(q, q, v, dropout_rate=RATE,
                        dropout_rng=jax.random.key(seed))
    return np.asarray(out) * s * (1.0 - RATE)


def test_dropout_keep_rate_statistics():
    keep = _keep_mask(0)
    np.testing.assert_allclose(keep[(keep > 1e-3)], 1.0, atol=1e-5)
    assert abs((keep > 0.5).mean() - (1.0 - RATE)) < 0.01


def test_dropout_mask_follows_the_key():
    a, a2, b = _keep_mask(1), _keep_mask(1), _keep_mask(2)
    np.testing.assert_array_equal(a, a2)
    assert (a != b).mean() > 0.2


@pytest.mark.parametrize("rate,key", [(0.0, 1), (RATE, None)])
def test_dropout_off_is_plain_attention(rng, rate, key):
    q, k, v = _qkv(rng, s=40)
    out = attention(q, k, v, dropout_rate=rate,
                    dropout_rng=None if key is None else jax.random.key(key))
    np.testing.assert_array_equal(np.asarray(out),
                                  np.asarray(attention_xla(q, k, v)))


def test_vit_train_forward_with_attention_dropout():
    """A nonzero attention_dropout trains through the materialised path:
    finite loss, gradients flow, deterministic given the rng."""
    from chestxray_vit_tpu.models import vit

    cfg = ModelConfig(img_size=32, patch_size=16, hidden_size=32,
                      num_layers=2, num_heads=2, mlp_dim=64, num_classes=4,
                      attention_dropout=0.2, dtype="float32")
    params = vit.init_params(jax.random.key(0), cfg)
    images = jax.random.normal(jax.random.key(1), (2, 32, 32, 3))

    def loss(p):
        return jnp.sum(vit.apply(p, images, cfg, train=True,
                                 rng=jax.random.key(2)) ** 2)

    val, grads = jax.value_and_grad(loss)(params)
    assert np.isfinite(float(val))
    norms = [float(jnp.linalg.norm(g)) for g in jax.tree.leaves(grads)]
    assert all(np.isfinite(n) for n in norms) and any(n > 0 for n in norms)
    assert float(val) == float(jax.value_and_grad(loss)(params)[0])
    plain = jnp.sum(vit.apply(params, images, cfg) ** 2)
    assert float(val) != float(plain)


def test_attention_probs_rows_sum_to_one(rng):
    q, k, _ = _qkv(rng, s=33)
    p = np.asarray(attention_probs(q, k))
    np.testing.assert_allclose(p.sum(-1), 1.0, atol=1e-5)


# --- on the card -------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("s", [577, 1025])
def test_cudnn_matches_oracle_on_gpu(gpu, s):
    """cuDNN fused attention at ViT-B widths (12 heads x 64) against the
    f32 oracle at "highest" precision: forward and gradients, with the
    bounds chip_smoke.py states."""
    import chip_smoke as cs

    ks = jax.random.split(jax.random.key(s), 3)
    q, k, v = (jax.random.normal(x, (4, 12, s, 64), F32) for x in ks)
    bf = [x.astype(BF16) for x in (q, k, v)]

    def loss(fn):
        return lambda *a: jnp.sum(fn(*a).astype(F32) ** 2)

    fast = lambda *a: attention(*a, impl="cudnn")
    o = jax.jit(fast)(*bf)
    g = jax.jit(jax.grad(loss(fast), argnums=(0, 1, 2)))(*bf)
    with jax.default_matmul_precision("highest"):
        o_ref = jax.jit(attention_xla)(q, k, v)
        g_ref = jax.jit(jax.grad(loss(attention_xla), argnums=(0, 1, 2)))(
            q, k, v)
    assert cs.rel_err(o, o_ref) <= cs.ATTN_FWD_TOL
    for a, r in zip(g, g_ref):
        assert cs.rel_err(a, r) <= cs.ATTN_GRAD_TOL
