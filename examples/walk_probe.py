"""Device cumulative probe of the virtual-forest walk at 256^3 tier-0.

All chains derive node_s/s/signs from the loop-perturbed input so nothing
is hoistable or constant-folded.  Run on the accelerator from the
repository root: python examples/walk_probe.py
"""
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from sperr_tpu.runtime.device_bench import time_stage, _smooth_field  # noqa: E402
from sperr_tpu.ops import cdf97_jax as cdfj  # noqa: E402
from sperr_tpu.ops import speck_jax as sj  # noqa: E402
from sperr_tpu.ops import speck_lis_jax as sl  # noqa: E402
from sperr_tpu.ops import speck_virtual as sv  # noqa: E402
from sperr_tpu.parallel.batched import wave_tiers_for  # noqa: E402

n = 256
vf = sv.virtual_lis_index((n, n, n))
nn = vf.nn
_NEVER = 0x7FFF
nf = wave_tiers_for(n ** 3)[0][0]
C = max(2048, min(nn, int(nn * nf)))
MC = 8
vol = _smooth_field(n)[0]
x = jnp.asarray(vol)
q = np.float32(1.5e-2)


def sched(y):
    cond = y - jnp.mean(y)
    ll = jnp.rint(cdfj.dwt3d(cond).reshape(-1) * (1.0 / q)).astype(jnp.int32)
    mags = jnp.abs(ll).astype(jnp.uint32)
    sgn = ll >= 0
    pm = sj.msbp1_device(mags)
    num_bp = jnp.max(pm)
    s, e, nm = sv.pixel_schedule_virtual(mags, vf, num_bp)
    node_s = jnp.where(nm > 0, num_bp - nm, _NEVER).astype(jnp.int32)
    return mags, sgn, s, e, node_s, num_bp


def c_sched(y):
    return sched(y)


def c_sig(y):
    mags, sgn, s, e, node_s, num_bp = sched(y)
    sig_key = jnp.where(node_s < _NEVER, jnp.arange(nn, dtype=jnp.int32), nn)
    (sid_s,) = jax.lax.sort((sig_key,), num_keys=1, is_stable=False)
    return sid_s[:C], mags


def c_children(y):
    mags, sgn, s, e, node_s, num_bp = sched(y)
    sig_key = jnp.where(node_s < _NEVER, jnp.arange(nn, dtype=jnp.int32), nn)
    (sid_s,) = jax.lax.sort((sig_key,), num_keys=1, is_stable=False)
    sid = sid_s[:C]
    svalid = sid < nn
    qd = jnp.minimum(sid, nn - 1)
    slot = jnp.arange(MC, dtype=jnp.int32)
    vtab = vf.build_vtab(
        s | (sgn.astype(jnp.int32) << 15), node_s
    )
    cnt, rvalid, ispx, isnd, vidx, v = vf.children_rows(qd, svalid, slot, vtab)
    return cnt, v, vidx, mags


def c_anchors(y):
    out = c_children(y)
    mags, sgn, s, e, node_s, num_bp = sched(y)
    J, R = sv.dense_anchor_ranks(node_s, vf)
    return out[0], out[1], J, R


def c_walk(y):
    mags, sgn, s, e, node_s, num_bp = sched(y)
    pay_s, n_sig = sl.lis_segments_device(
        node_s, s, sgn, num_bp, vf, 14, C, 0, 0, return_events="items"
    )
    return pay_s, n_sig


prev = 0.0
for name, fn in [
    ("schedule", c_sched),
    ("(+)sig sort", c_sig),
    ("(+)vtab+children", c_children),
    ("(+)anchor ranks", c_anchors),
    ("FULL walk", c_walk),
]:
    t = time_stage(fn, x, iters=4)
    print(name, "cum", round(t * 1e3, 2), "ms; delta", round((t - prev) * 1e3, 2))
    prev = t
