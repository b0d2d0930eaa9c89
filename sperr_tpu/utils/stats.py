"""Quality metrics (RMSE, L-infinity, PSNR, mean/var) — host and device.

Parity targets: sperr_helper.cpp:429-523 (calc_stats) and :594-643
(calc_mean_var).  The host versions are plain numpy; the device versions are
jittable and batched for use inside the device pipeline (e.g. on-device PWE
verification without fetching the volume).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def calc_stats(a: np.ndarray, b: np.ndarray) -> Tuple[float, float, float, float, float]:
    """(rmse, linfty, psnr, min(a), max(a)); psnr uses the range of `a`."""
    amin, amax = float(a.min()), float(a.max())
    if np.array_equal(a, b):
        return 0.0, 0.0, float("inf"), amin, amax
    d = np.abs(np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64))
    linfty = float(d.max())
    mse = float(np.mean(d * d))
    rng = amax - amin
    return math.sqrt(mse), linfty, 10.0 * math.log10(rng * rng / mse), amin, amax


def calc_mean_var(a: np.ndarray) -> Tuple[float, float]:
    a = np.asarray(a, dtype=np.float64)
    m = float(a.mean())
    return m, float(np.mean((a - m) ** 2))


def accuracy_gain(orig: np.ndarray, recon: np.ndarray, stream_bytes: int) -> float:
    """The reference's "Accuracy Gain" metric: log2(sigma/rmse) - bpp
    (utilities/sperr3d.cpp:380-382)."""
    rmse = calc_stats(orig, recon)[0]
    sigma = math.sqrt(calc_mean_var(orig)[1])
    bpp = stream_bytes * 8.0 / orig.size
    return float("inf") if rmse == 0 else math.log2(sigma / rmse) - bpp


def calc_stats_device(a, b):
    """Jittable device-side stats: (rmse, linfty, psnr, min, max)."""
    import jax.numpy as jnp

    d = jnp.abs(a - b)
    mse = jnp.mean(d * d)
    amin, amax = jnp.min(a), jnp.max(a)
    rng = amax - amin
    psnr = 10.0 * jnp.log10(rng * rng / mse)
    return jnp.sqrt(mse), jnp.max(d), psnr, amin, amax
