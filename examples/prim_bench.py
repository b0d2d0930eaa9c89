"""Primitive-cost measurements behind the entropy-stage design.

Measures, on the accelerator, the building blocks of the prefix-sum /
blocked-compaction entropy stage:

  * flat sort vs BATCHED small sorts (does XLA amortize log^2(K)?)
  * within-block cumsum along the minor axis
  * popcount + PEXT-style bit compaction (pure elementwise u32)
  * output-scale gather (the final assembly movement)
  * small scatter-max + cummax (block->output forward fill)
  * one-hot select matmul (blocked compaction by matmul)

Run from the repository root: python examples/prim_bench.py [n_log2]
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from sperr_tpu.runtime.device_bench import time_stage  # noqa: E402


def main():
    n = 1 << int(sys.argv[1] if len(sys.argv) > 1 else 24)  # 16.7M default
    rng = np.random.default_rng(0)
    x_i32 = jnp.asarray(rng.integers(0, 2**30, n, dtype=np.int32))
    x_u32 = jnp.asarray(rng.integers(0, 2**32, n, dtype=np.uint32).astype(np.uint32))
    res = {"n": n}

    def t(name, fn, x, iters=4):
        s = time_stage(fn, x, iters=iters)
        res[name] = round(s * 1e3, 3)
        print(name, res[name], "ms", flush=True)

    # 1. flat sort baseline
    t("sort_flat_1op", lambda v: jax.lax.sort((v,), num_keys=1, is_stable=False)[0], x_i32)

    # 2. batched small sorts along minor axis
    for K in (256, 1024, 4096):
        xb = x_i32.reshape(n // K, K)
        t(f"sort_batched_{K}", lambda v: jax.lax.sort((v,), dimension=1, num_keys=1, is_stable=False)[0], xb)

    # 2b. batched 2-operand (key+payload) small sort
    K = 1024
    xb = x_i32.reshape(n // K, K)
    t("sort_batched2_1024", lambda v: jax.lax.sort((v, v + 1), dimension=1, num_keys=1, is_stable=False)[1], xb)

    # 3. cumsum: flat vs along minor axis of blocks
    t("cumsum_flat", lambda v: jnp.cumsum(v, axis=0), x_i32)
    for K in (256, 1024):
        xb = x_i32.reshape(n // K, K)
        t(f"cumsum_minor_{K}", lambda v: jnp.cumsum(v, axis=1), xb)

    # 4. popcount + PEXT-ish elementwise chain on u32
    def pext_chain(v):
        # representative cost of a 5-step sheep-and-goats extract:
        # per step ~6 integer ops
        m = v
        out = v ^ jnp.uint32(0x55555555)
        for sh in (1, 2, 4, 8, 16):
            mk = m & jnp.uint32(0x33333333)
            mv = (out >> sh) & mk
            out = (out & ~mk) | mv | (out << sh)
            m = m ^ (m >> sh)
        return out

    xw = x_u32[: n // 32 * 32][: n // 32]
    t("pext_chain_u32", pext_chain, xw)
    t("popcount_u32", lambda v: jax.lax.population_count(v), xw)

    # 5. gather at output scale (1M indices from 16M table)
    for gi in (1 << 20, 1 << 22):
        idx = jnp.asarray(rng.integers(0, n, gi, dtype=np.int32))
        tbl = x_i32

        def gath(i):
            return tbl[i]

        t(f"gather_{gi>>20}M_random", gath, idx)
        idx_s = jnp.sort(idx)
        t(f"gather_{gi>>20}M_sorted", gath, idx_s)
        # monotone local gather (offsets near identity): idx = iota + small jitter
        base = jnp.arange(gi, dtype=jnp.int32) * (n // gi)
        jit_idx = base + jnp.asarray(rng.integers(0, 64, gi, dtype=np.int32))
        t(f"gather_{gi>>20}M_local", gath, jnp.minimum(jit_idx, n - 1))

    # 6. scatter-max small -> 1M grid, then cummax over 1M
    BN = 1 << 16
    grid = 1 << 20
    pos = jnp.sort(jnp.asarray(rng.integers(0, grid, BN, dtype=np.int32)))

    def scat(p):
        return jnp.zeros(grid, jnp.int32).at[p].max(jnp.arange(BN, dtype=jnp.int32))

    t("scattermax_64K_to_1M", scat, pos)
    y1m = x_i32[:grid]
    t("cummax_1M", lambda v: jax.lax.cummax(v, axis=0), y1m)
    t("cummax_16M", lambda v: jax.lax.cummax(v, axis=0), x_i32)

    # 7. one-hot select matmul: [B, K] @ per-block one-hot [B, K, K]
    K = 256
    B = n // K // 8  # keep the 3D tensor at n/8*K*2 bytes
    vb = x_i32[: B * K].reshape(B, K)

    def onehot_select(v):
        valid = (v & 1) == 1
        rank = jnp.cumsum(valid.astype(jnp.int32), axis=1) - valid
        sel = (rank[:, :, None] == jnp.arange(K, dtype=jnp.int32)[None, None, :])
        sel = jnp.where(valid[:, :, None], sel, False).astype(jnp.bfloat16)
        out = jax.lax.dot_general(
            (v & 0xFF).astype(jnp.bfloat16)[:, None, :], sel,
            (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )
        return out[:, 0, :]

    t("onehot_select_B%d_K256" % B, onehot_select, vb)

    # 8. threshold-compare one-hot matmul packbits style at [34, n] scale
    s34 = x_i32 % 34

    def thresh_all(v):
        th = jnp.arange(34, dtype=jnp.int32)
        m = (v[None, :] < th[:, None]).astype(jnp.uint8)
        return jnp.sum(m, axis=1)

    t("thresh_34xn_u8_reduce", thresh_all, s34, iters=2)

    print(json.dumps(res))


if __name__ == "__main__":
    main()
