"""Fast exact-erf GELU.

HF ViT uses exact erf GELU (not the tanh approximation). XLA's ``lax.erf``
lowers to a long f32 rational. This implementation uses the
Abramowitz–Stegun 7.1.26 polynomial (|ε| ≤ 1.5e-7 vs true erf; measured
≤ 2.7e-6 vs ``lax.erf`` in f32) with the exponential on the hardware
``exp2`` path: ~10 fused elementwise ops, at accuracy three orders of
magnitude below the 1e-4 HF logit-parity gate (pinned against torch in
tests/test_vit_parity.py and tests/test_gelu.py). Whether it beats
``lax.erf`` on the H100 is not measured yet (ROADMAP Speed item 8).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_LOG2E = 1.4426950408889634
_INV_SQRT2 = 0.7071067811865476


def erf_fast(x: jax.Array) -> jax.Array:
    """Abramowitz–Stegun 7.1.26 erf, f32 math, sign-folded."""
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741,
                          -1.453152027, 1.061405429)
    p = 0.3275911
    ax = jnp.abs(x)
    t = 1.0 / (1.0 + p * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    y = 1.0 - poly * jnp.exp2(-(ax * ax) * _LOG2E)
    return jnp.sign(x) * y


def gelu(x: jax.Array, approximate: bool = False) -> jax.Array:
    """GELU with HF semantics: exact erf by default (via :func:`erf_fast`),
    tanh when ``approximate=True``. f32 internal math, output in x.dtype."""
    if approximate:
        return jax.nn.gelu(x, approximate=True)
    xf = x.astype(jnp.float32)
    return (xf * 0.5 * (1.0 + erf_fast(xf * _INV_SQRT2))).astype(x.dtype)
