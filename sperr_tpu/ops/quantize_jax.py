"""Quantization + q-estimation on device (JAX), batched over chunks.

Device counterpart of ops/quantize.py.  Arithmetic runs at the device
compute dtype (f32); streams remain format-valid SPERR, with quality bounded
by that precision rather than bit-identical to the f64 host engine.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

UINT32_MAX = 4294967295.0
DBL_BIG_ODD = float.fromhex("0x1.fffffffffffffp52")


def estimate_q_psnr_batched(coeffs, data_range, psnr_target: float):
    """Per-chunk q for a PSNR target; coeffs shaped (B, n) at device precision.

    Mirrors the reference's shrink-until-met search (SPECK_FLT.cpp:268-279)
    with all chunks iterated together under one while_loop.
    """
    dt = coeffs.dtype
    t_mse = (data_range * data_range) * dt.type(10.0 ** (-psnr_target / 10.0))
    q0 = 2.0 * jnp.sqrt(t_mse * 3.0)
    shrink = dt.type(1.0 / (2.0 ** 0.25))

    def mse(q):
        r = jnp.rint(coeffs * (1.0 / q)[:, None])
        d = coeffs - q[:, None] * r
        return jnp.mean(d * d, axis=1)

    def cond(state):
        q, _ = state
        return jnp.any(mse(q) > t_mse)

    def body(state):
        q, it = state
        q = jnp.where(mse(q) > t_mse, q * shrink, q)
        return q, it + 1

    q, _ = jax.lax.while_loop(cond, body, (q0, 0))
    return q


# In f32 device mode, quantized magnitudes must stay exactly representable in
# f32, so the rate-mode q targets 2^20-1 instead of the host engine's 2^32-1.
RATE_MAX_MAG_DEVICE = float(2**20 - 1)


def midtread_quantize_batched(coeffs, q) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """coeffs (B, n), q (B,) -> (magnitudes i32, signs bool, max magnitude i32)."""
    ll = jnp.rint(coeffs * (1.0 / q)[:, None])
    signs = ll >= 0
    mags = jnp.abs(ll).astype(jnp.int32)
    return mags, signs, jnp.max(mags, axis=1)


def midtread_inv_quantize_batched(mags, signs, q):
    sgn = jnp.where(signs, 1.0, -1.0).astype(q.dtype)
    return (q[:, None] * mags.astype(q.dtype)) * sgn
