"""Device-side SPECK bitplane kernels (ops/speck_jax.py): parity tests.

Runs on the forced-CPU JAX backend (tests/conftest.py); the kernels are pure
jitted array programs, so CPU parity implies identical device semantics."""

import jax.numpy as jnp
import numpy as np
import pytest

from sperr_tpu.codec import speck_wave as sw
from sperr_tpu.ops import speck_jax as sj
from sperr_tpu.runtime.engine import default_engine


pytestmark = pytest.mark.slow  # JAX-compile-heavy (see pytest.ini)

ENG = default_engine()


def _case(rng, n, density=0.1, hi=100000):
    mags = np.zeros(n, dtype=np.uint64)
    idx = rng.choice(n, max(1, int(n * density)), replace=False)
    mags[idx] = rng.integers(1, hi, size=idx.size)
    signs = rng.random(n) > 0.5
    return mags, signs


def test_msbp1_device_matches_host():
    rng = np.random.default_rng(0)
    m = rng.integers(0, 1 << 31, size=4096).astype(np.uint32)
    got = np.asarray(sj.msbp1_device(jnp.asarray(m)))
    want = sw.msbp1(m.astype(np.uint64))
    np.testing.assert_array_equal(got, want.astype(np.int32))


@pytest.mark.parametrize("dims", [(8, 8, 8), (7, 5, 3), (16, 16, 16)])
def test_node_max_matches_host(dims):
    rng = np.random.default_rng(1)
    n = int(np.prod(dims))
    mags, _ = _case(rng, n)
    tree = sw.build_tree(dims)
    pm = sw.msbp1(mags)
    want = sw.compute_node_max(tree, pm)
    ti = sj.tree_index(dims)
    got = np.asarray(sj.node_max(jnp.asarray(pm.astype(np.int32)), ti))
    np.testing.assert_array_equal(got, want.astype(np.int32))


@pytest.mark.parametrize("dims", [(8, 8, 8), (16, 16, 16), (7, 5, 3), (64, 64, 21)])
def test_device_encode_byte_parity(dims):
    rng = np.random.default_rng(2)
    n = int(np.prod(dims))
    for density in (0.05, 0.4):
        mags, signs = _case(rng, n, density)
        ref = bytes(ENG.encode(3, mags, signs, dims, 64, 0))
        got = bytes(sj.encode_3d_device(mags, signs, dims, 0))
        assert got == ref


def test_device_encode_budget_parity():
    dims = (16, 16, 16)
    rng = np.random.default_rng(3)
    n = int(np.prod(dims))
    mags, signs = _case(rng, n, 0.5)
    for budget in (64, n, 3 * n):
        assert bytes(sj.encode_3d_device(mags, signs, dims, budget)) == bytes(
            ENG.encode(3, mags, signs, dims, 64, budget)
        )


def test_device_encode_zero_field():
    dims = (8, 8, 8)
    z = np.zeros(512, dtype=np.uint64)
    s = np.ones(512, dtype=bool)
    assert bytes(sj.encode_3d_device(z, s, dims, 0)) == bytes(
        ENG.encode(3, z, s, dims, 64, 0)
    )


@pytest.mark.parametrize("dims", [(8, 8), (16, 16), (33, 17), (64, 21)])
def test_device_encode_2d_byte_parity(dims):
    rng = np.random.default_rng(6)
    n = int(np.prod(dims))
    mags, signs = _case(rng, n, 0.1)
    ref = bytes(ENG.encode(2, mags, signs, (dims[0], dims[1], 1), 64, 0))
    assert bytes(sj.encode_2d_device(mags, signs, dims, 0)) == ref


def test_pass_segments_counts_are_stream_sized():
    """Device->host traffic after count slicing equals the pixel-bit portion
    of the stream: counts sum to (total bits - LIS set bits)."""
    dims = (16, 16, 16)
    rng = np.random.default_rng(4)
    n = int(np.prod(dims))
    mags, signs = _case(rng, n, 0.1)
    ti = sj.tree_index(dims)
    pm = sj.msbp1_device(jnp.asarray(mags.astype(np.uint32)))
    num_bp = int(jnp.max(pm))
    s, e, _ = sj.pixel_schedule(jnp.asarray(mags.astype(np.uint32)), ti, num_bp)
    lip_b, lip_c, ref_b, ref_c = sj.pass_segments(
        jnp.asarray(mags.astype(np.uint32)), jnp.asarray(signs), s, e,
        jnp.int32(num_bp), num_bp,
    )
    total_pixel_bits = int(np.sum(np.asarray(lip_c))) + int(np.sum(np.asarray(ref_c)))
    stream = bytes(ENG.encode(3, mags, signs, dims, 64, 0))
    total_bits = int.from_bytes(stream[1:9], "little")
    assert 0 < total_pixel_bits < total_bits


def test_packbits_device_parity():
    """Matmul packbits == np.packbits(bitorder='little') at assorted
    lengths (the (-1, 8) reshape it replaces OOM'd at 256^3: 16x minor-dim
    tiling inflation)."""
    from sperr_tpu.ops.speck_jax import _packbits_device

    rng = np.random.default_rng(2)
    for nbits in (8, 64, 1024, 1032, 4096, 100_000 * 8):
        bits = rng.integers(0, 2, nbits).astype(np.uint8)
        got = np.asarray(_packbits_device(jnp.asarray(bits)))
        want = np.packbits(bits, bitorder="little")
        np.testing.assert_array_equal(got, want)
