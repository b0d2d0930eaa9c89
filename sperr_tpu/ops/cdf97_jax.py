"""CDF 9/7 wavelet transform — JAX device engine.

Same lifting structure as the exact host engine (cdf97_np.py), expressed as
strided slices + concats *along the transform axis* — no transposes, so each
level lowers to a short chain of fusable elementwise ops and XLA keeps the
whole level HBM-bound.  Works on any float dtype; the device pipeline
computes in f32, and XLA may contract multiply-adds into FMAs, so results
agree with the exact host engine to ~1 ulp per lifting step — the host engine remains the bit-exact parity path.

All entry points operate on the trailing axes and broadcast over leading
batch axes: a batch of equal chunks is one fused program, and sharding the
batch axis over a `jax.sharding.Mesh` distributes chunks across devices.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..utils.dims import calc_approx_detail_len, can_use_dyadic, num_of_xforms
from .cdf97_np import ALPHA, BETA, DELTA, EPSILON, GAMMA, INV_EPSILON


def _sl(x, axis: int, start, stop, step=None):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, stop, step)
    return x[tuple(idx)]


def _cat(parts, axis: int):
    return jnp.concatenate(parts, axis=axis)


def _lift_neighbors(even, odd, el: int, ol: int, axis: int):
    """Boundary-clamped neighbor sums used by every lifting step."""
    if el == ol:  # even length
        e_r = _cat([_sl(even, axis, 1, ol), _sl(even, axis, el - 1, el)], axis)
        o_l = _cat([_sl(odd, axis, 0, 1), _sl(odd, axis, 0, el - 1)], axis)
        o_r = odd
    else:  # odd length: el == ol + 1
        e_r = _sl(even, axis, 1, ol + 1)
        o_l = _cat([_sl(odd, axis, 0, 1), odd], axis)
        o_r = _cat([odd, _sl(odd, axis, ol - 1, ol)], axis)
    return e_r, o_l, o_r


def analysis(x, axis: int):
    """One forward lifting level along `axis` of deinterleaved [even|odd] data."""
    n = x.shape[axis]
    el, ol = n - n // 2, n // 2
    even, odd = _sl(x, axis, 0, el), _sl(x, axis, el, None)
    dt = x.dtype
    ev_lo = lambda e: _sl(e, axis, 0, ol)

    e_r, _, _ = _lift_neighbors(even, odd, el, ol, axis)
    odd = odd + dt.type(ALPHA) * (ev_lo(even) + e_r)
    _, o_l, o_r = _lift_neighbors(even, odd, el, ol, axis)
    even = even + dt.type(BETA) * (o_l + o_r)
    e_r, _, _ = _lift_neighbors(even, odd, el, ol, axis)
    odd = odd + dt.type(GAMMA) * (ev_lo(even) + e_r)
    _, o_l, o_r = _lift_neighbors(even, odd, el, ol, axis)
    even = dt.type(EPSILON) * (even + dt.type(DELTA) * (o_l + o_r))
    odd = odd * dt.type(-INV_EPSILON)
    return _cat([even, odd], axis)


def synthesis(x, axis: int):
    n = x.shape[axis]
    el, ol = n - n // 2, n // 2
    even, odd = _sl(x, axis, 0, el), _sl(x, axis, el, None)
    dt = x.dtype
    ev_lo = lambda e: _sl(e, axis, 0, ol)

    odd = odd * dt.type(-EPSILON)
    _, o_l, o_r = _lift_neighbors(even, odd, el, ol, axis)
    even = even * dt.type(INV_EPSILON) - dt.type(DELTA) * (o_l + o_r)
    e_r, _, _ = _lift_neighbors(even, odd, el, ol, axis)
    odd = odd - dt.type(GAMMA) * (ev_lo(even) + e_r)
    _, o_l, o_r = _lift_neighbors(even, odd, el, ol, axis)
    even = even - dt.type(BETA) * (o_l + o_r)
    e_r, _, _ = _lift_neighbors(even, odd, el, ol, axis)
    odd = odd - dt.type(ALPHA) * (ev_lo(even) + e_r)
    return _cat([even, odd], axis)


def gather(x, axis: int):
    """Deinterleave evens/odds along `axis` to front/back."""
    return _cat([_sl(x, axis, 0, None, 2), _sl(x, axis, 1, None, 2)], axis)


def scatter(x, axis: int):
    """Interleave [approx | detail] along `axis` back to even/odd positions."""
    n = x.shape[axis]
    el = n - n // 2
    even, odd = _sl(x, axis, 0, el), _sl(x, axis, el, None)
    if n % 2 == 0:
        inter = jnp.stack([even, odd], axis=axis + 1 if axis >= 0 else x.ndim + axis + 1)
    else:
        a = axis if axis >= 0 else x.ndim + axis
        inter = jnp.stack([_sl(even, a, 0, el - 1), odd], axis=a + 1)
        shape = list(x.shape)
        shape[a] = n - 1
        inter = inter.reshape(shape)
        return _cat([inter, _sl(even, a, el - 1, el)], a)
    a = axis if axis >= 0 else x.ndim + axis
    shape = list(x.shape)
    shape[a] = n
    return inter.reshape(shape)


def _dwt_axis(x, length: int, axis: int):
    """One forward level over the first `length` entries along `axis`."""
    if length == x.shape[axis]:
        return analysis(gather(x, axis), axis)
    seg = _sl(x, axis, 0, length)
    out = analysis(gather(seg, axis), axis)
    return _cat([out, _sl(x, axis, length, None)], axis)


def _idwt_axis(x, length: int, axis: int):
    if length == x.shape[axis]:
        return scatter(synthesis(x, axis), axis)
    seg = _sl(x, axis, 0, length)
    out = scatter(synthesis(seg, axis), axis)
    return _cat([out, _sl(x, axis, length, None)], axis)


# ---------------------------------------------------------------------------
# Multi-level drivers.  Trailing axes = (nz, ny, nx); x is axis -1, y is -2,
# z is -3; leading axes are batch.
# ---------------------------------------------------------------------------
@partial(jax.jit, static_argnames=("levels",))
def dwt1d(x, levels: int | None = None):
    n = x.shape[-1]
    levels = num_of_xforms(n) if levels is None else levels
    length = n
    for _ in range(levels):
        x = _dwt_axis(x, length, -1)
        length -= length // 2
    return x


@partial(jax.jit, static_argnames=("levels",))
def idwt1d(x, levels: int | None = None):
    n = x.shape[-1]
    levels = num_of_xforms(n) if levels is None else levels
    for lev in range(levels, 0, -1):
        length, _ = calc_approx_detail_len(n, lev - 1)
        x = _idwt_axis(x, length, -1)
    return x


@partial(jax.jit, static_argnames=("levels",))
def dwt2d(x, levels: int | None = None):
    ny, nx = x.shape[-2], x.shape[-1]
    levels = num_of_xforms(min(nx, ny)) if levels is None else levels
    for lev in range(levels):
        lx, _ = calc_approx_detail_len(nx, lev)
        ly, _ = calc_approx_detail_len(ny, lev)
        x = _dwt2d_level(x, lx, ly)
    return x


@partial(jax.jit, static_argnames=("levels",))
def idwt2d(x, levels: int | None = None):
    ny, nx = x.shape[-2], x.shape[-1]
    levels = num_of_xforms(min(nx, ny)) if levels is None else levels
    for lev in range(levels, 0, -1):
        lx, _ = calc_approx_detail_len(nx, lev - 1)
        ly, _ = calc_approx_detail_len(ny, lev - 1)
        x = _idwt2d_level(x, lx, ly)
    return x


def _set_corner2(x, sub, lx: int, ly: int):
    ny, nx = x.shape[-2], x.shape[-1]
    if (lx, ly) == (nx, ny):
        return sub
    # dynamic_update_slice instead of slice+concat: XLA performs the
    # corner write in place when the operand buffer is otherwise dead,
    # where the concat form re-materialized the FULL array once per level
    # (about one extra 256^3 volume of pure copy per level)
    import jax as _jax

    return _jax.lax.dynamic_update_slice(x, sub, (0,) * x.ndim)


def _dwt2d_level(x, lx: int, ly: int):
    sub = _sl(_sl(x, -2, 0, ly), -1, 0, lx)
    sub = _dwt_axis(sub, lx, -1)  # rows (X) first
    sub = _dwt_axis(sub, ly, -2)  # then columns (Y)
    return _set_corner2(x, sub, lx, ly)


def _idwt2d_level(x, lx: int, ly: int):
    sub = _sl(_sl(x, -2, 0, ly), -1, 0, lx)
    sub = _idwt_axis(sub, ly, -2)  # columns (Y) first
    sub = _idwt_axis(sub, lx, -1)  # then rows (X)
    return _set_corner2(x, sub, lx, ly)


def _set_corner3(x, sub, lx: int, ly: int, lz: int):
    if (lx, ly, lz) == (x.shape[-1], x.shape[-2], x.shape[-3]):
        return sub
    import jax as _jax

    return _jax.lax.dynamic_update_slice(x, sub, (0,) * x.ndim)


def _dwt3d_level(x, lx: int, ly: int, lz: int):
    sub = _sl(_sl(_sl(x, -3, 0, lz), -2, 0, ly), -1, 0, lx)
    sub = _dwt_axis(sub, lx, -1)
    sub = _dwt_axis(sub, ly, -2)
    sub = _dwt_axis(sub, lz, -3)
    return _set_corner3(x, sub, lx, ly, lz)


def _idwt3d_level(x, lx: int, ly: int, lz: int):
    sub = _sl(_sl(_sl(x, -3, 0, lz), -2, 0, ly), -1, 0, lx)
    sub = _idwt_axis(sub, lz, -3)
    sub = _idwt_axis(sub, ly, -2)
    sub = _idwt_axis(sub, lx, -1)
    return _set_corner3(x, sub, lx, ly, lz)


@jax.jit
def dwt3d(x):
    """Full 3D forward transform; x shaped (..., nz, ny, nx)."""
    nz, ny, nx = x.shape[-3], x.shape[-2], x.shape[-1]
    dims = (nx, ny, nz)
    dyadic = can_use_dyadic(dims)
    if dyadic is not None:
        for lev in range(dyadic):
            lx, _ = calc_approx_detail_len(nx, lev)
            ly, _ = calc_approx_detail_len(ny, lev)
            lz, _ = calc_approx_detail_len(nz, lev)
            x = _dwt3d_level(x, lx, ly, lz)
        return x
    # Wavelet packet: full 1D transform along Z, then full 2D per XY slice.
    length = nz
    for _ in range(num_of_xforms(nz)):
        x = _dwt_axis(x, length, -3)
        length -= length // 2
    for lev in range(num_of_xforms(min(nx, ny))):
        lx, _ = calc_approx_detail_len(nx, lev)
        ly, _ = calc_approx_detail_len(ny, lev)
        x = _dwt2d_level(x, lx, ly)
    return x


@jax.jit
def idwt2d_multi_res(x):
    """Inverse 2D transform capturing each coarse resolution (device form of
    cdf97_np.idwt2d_multi_res; CDF97.cpp:114-138).  Returns
    (full, tuple(coarse...)) with hierarchy ordered coarsest-first, matching
    utils.dims.coarsened_resolutions."""
    ny, nx = x.shape[-2], x.shape[-1]
    levels = num_of_xforms(min(nx, ny))
    hier = []
    for lev in range(levels, 0, -1):
        lx, _ = calc_approx_detail_len(nx, lev)
        ly, _ = calc_approx_detail_len(ny, lev)
        hier.append(_sl(_sl(x, -2, 0, ly), -1, 0, lx))
        lxd, _ = calc_approx_detail_len(nx, lev - 1)
        lyd, _ = calc_approx_detail_len(ny, lev - 1)
        x = _idwt2d_level(x, lxd, lyd)
    return x, tuple(hier)


@jax.jit
def idwt3d_multi_res(x):
    """Inverse 3D dyadic transform capturing each coarse resolution (device
    form of cdf97_np.idwt3d_multi_res; CDF97.cpp:140-168).  Non-dyadic dims
    invert as wavelet-packet with an empty hierarchy, like the reference."""
    nz, ny, nx = x.shape[-3], x.shape[-2], x.shape[-1]
    dyadic = can_use_dyadic((nx, ny, nz))
    if dyadic is None:
        return idwt3d(x), ()
    hier = []
    for lev in range(dyadic, 0, -1):
        lx, _ = calc_approx_detail_len(nx, lev)
        ly, _ = calc_approx_detail_len(ny, lev)
        lz, _ = calc_approx_detail_len(nz, lev)
        hier.append(_sl(_sl(_sl(x, -3, 0, lz), -2, 0, ly), -1, 0, lx))
        lxd, _ = calc_approx_detail_len(nx, lev - 1)
        lyd, _ = calc_approx_detail_len(ny, lev - 1)
        lzd, _ = calc_approx_detail_len(nz, lev - 1)
        x = _idwt3d_level(x, lxd, lyd, lzd)
    return x, tuple(hier)


@jax.jit
def idwt3d(x):
    nz, ny, nx = x.shape[-3], x.shape[-2], x.shape[-1]
    dims = (nx, ny, nz)
    dyadic = can_use_dyadic(dims)
    if dyadic is not None:
        for lev in range(dyadic, 0, -1):
            lx, _ = calc_approx_detail_len(nx, lev - 1)
            ly, _ = calc_approx_detail_len(ny, lev - 1)
            lz, _ = calc_approx_detail_len(nz, lev - 1)
            x = _idwt3d_level(x, lx, ly, lz)
        return x
    for lev in range(num_of_xforms(min(nx, ny)), 0, -1):
        lx, _ = calc_approx_detail_len(nx, lev - 1)
        ly, _ = calc_approx_detail_len(ny, lev - 1)
        x = _idwt2d_level(x, lx, ly)
    zlev = num_of_xforms(nz)
    for lev in range(zlev, 0, -1):
        length, _ = calc_approx_detail_len(nz, lev - 1)
        x = _idwt_axis(x, length, -3)
    return x
