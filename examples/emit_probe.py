"""Device probe of the wave-emission internals at 256^3 tier-0 shapes.

Each candidate consumes the loop-perturbed input so nothing hoists
(runtime/device_bench.py synchronization rules).  Run on the accelerator
from the repository root:
    python examples/emit_probe.py
"""
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from sperr_tpu.runtime.device_bench import time_stage  # noqa: E402
from sperr_tpu.ops import packemit as pe  # noqa: E402

N = 256
Nh = N // 2
n = N ** 3
npad = 1048576
Tp = 2447488
take_b = npad // 8
rng = np.random.default_rng(0)
x32 = jnp.asarray(rng.integers(0, 2 ** 31, n, dtype=np.int32))


def box_major(x):
    return (
        x.reshape(Nh, 2, Nh, 2, Nh, 2)
        .transpose(0, 2, 4, 1, 3, 5)
        .reshape(-1)
    )


def p_box_major(y):
    return box_major(y)


def p_ecell_slice(y):
    return jax.lax.slice(
        y.reshape(N, N, N), (0, 0, 0), (N, N, N), (2, 2, 2)
    ).reshape(-1)


def p_ecell_reduce(y):
    return y.reshape(Nh, 2, Nh, 2, Nh, 2).max(axis=(1, 3, 5)).reshape(-1)


def p_box_compact(y):
    e_cell = p_ecell_reduce(y)
    idx, cnt = pe.compact_flags_rows((e_cell < 2 ** 30)[None], take_b)
    return idx, cnt


def p_rowgather(y):
    bm = box_major(y)
    bc = jnp.arange(take_b, dtype=jnp.int32) * 3 % (n // 8)
    return bm.reshape(-1, 8)[bc]


def p_exp_sort(y):
    key = y[: 8 * take_b]
    pay = y[1 : 8 * take_b + 1]
    mag = y[2 : 8 * take_b + 2]
    return jax.lax.sort((key, pay, mag), num_keys=1, is_stable=False)


def p_lis_masks(y):
    pay = y[:Tp]
    is_ent = (pay & 1) == 1
    lo = (pay >> 1) & 63
    s6 = (pay >> 7) & 63
    U0 = jnp.uint32(0)
    U1 = jnp.uint32(0xFFFFFFFF)
    mvA = jnp.where(is_ent, pe.ones_span32(lo, s6), pe.bit_at32(lo))
    mbA = jnp.where(is_ent, pe.bit_at32(s6), U1)
    mvB = jnp.where(is_ent, U0, pe.bit_at32(lo))
    mbB = jnp.where((pay >> 13) & 1 == 1, U1, U0)
    v = pe.transpose_bits32_pair(mvA, mvB)[:14]
    b = pe.transpose_bits32_pair(mbA, mbB)[:14]
    return v, b


def p_outlier_compact(y):
    flags = (y > 2 ** 30).reshape(1, n)
    idx, cnt = pe.compact_flags_rows(flags, 16384)
    return idx, cnt


for name, fn in [
    ("box_major relayout", p_box_major),
    ("e_cell strided slice", p_ecell_slice),
    ("e_cell reduce", p_ecell_reduce),
    ("box compact (2-level)", p_box_compact),
    ("row gather [131K,8]", p_rowgather),
    ("exposure re-sort 3op@1M", p_exp_sort),
    ("lis masks+pair transpose", p_lis_masks),
    ("outlier compact @16.7M", p_outlier_compact),
]:
    t = time_stage(fn, x32, iters=4)
    print(name, round(t * 1e3, 3), "ms")
