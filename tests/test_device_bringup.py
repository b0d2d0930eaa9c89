"""The plain-XLA device forms that replaced the hand kernels, the decoder's
backend default, chunk-mesh sub-batching, and the compile-cache location."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sperr_tpu.ops import cdf97_jax as cdfj
from sperr_tpu.ops import cdf97_np as cdf
from sperr_tpu.ops import quantize as qz
from sperr_tpu.ops import quantize_jax as qzj
from sperr_tpu.parallel import batched
from sperr_tpu.utils import compile_cache


@pytest.mark.parametrize(
    "batch,length,scale",
    [(4, 4096, 100.0), (3, 1000, 7.0), (2, 127 * 129, 3000.0)],
)
def test_xla_quantizer_matches_host(batch, length, scale):
    """midtread_quantize_batched (f32) equals the host quantizer on the same
    f32 coefficients, except where f32 and f64 round c/q to different sides
    of a half-integer; lengths include non-multiples of 128."""
    rng = np.random.default_rng(length)
    coeffs = rng.normal(scale=scale, size=(batch, length)).astype(np.float32)
    q = (np.abs(rng.normal(scale=0.5, size=batch)) + 0.01).astype(np.float32)
    mags, signs, maxmag = qzj.midtread_quantize_batched(
        jnp.asarray(coeffs), jnp.asarray(q)
    )
    mags, signs, maxmag = (np.asarray(a) for a in (mags, signs, maxmag))
    for b in range(batch):
        hm, hs, _ = qz.midtread_quantize(
            coeffs[b].astype(np.float64), float(q[b])
        )
        bad = np.flatnonzero((mags[b] != hm.astype(np.int64)) | (signs[b] != hs))
        v = np.abs(coeffs[b, bad].astype(np.float64) / float(q[b]))
        ulp = np.spacing(v.astype(np.float32)).astype(np.float64)
        assert np.all(np.abs(v - np.floor(v) - 0.5) <= 4 * ulp)
        assert maxmag[b] == mags[b].max()
    assert mags.dtype == np.int32 and signs.dtype == np.bool_


@pytest.mark.parametrize("shape", [(3, 64, 64), (2, 48, 80), (1, 127, 127)])
def test_xla_dwt2d_matches_host(shape):
    """The XLA lifting chain (the production 2D transform) agrees with the
    exact f64 engine to f32 roundoff, forward and inverse."""
    x = np.random.default_rng(shape[1]).normal(size=shape).astype(np.float32)
    out = np.asarray(jax.jit(cdfj.dwt2d)(jnp.asarray(x)))
    ref = np.stack([cdf.dwt2d(p.astype(np.float64)) for p in x])
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    back = np.asarray(jax.jit(cdfj.idwt2d)(jnp.asarray(out)))
    np.testing.assert_allclose(back, x, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("backend,expected", [("gpu", True), ("cpu", False)])
def test_hybrid_decode_default_by_backend(monkeypatch, backend, expected):
    """Auto mode splits the SPECK decode (control parse on the host,
    magnitudes on the device) on an accelerator, and runs the full host
    parse on the CPU backend; an explicit choice always wins."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert batched.TpuDecompressor3D()._hybrid_enabled() is expected
    assert batched.TpuDecompressor3D(hybrid=True)._hybrid_enabled() is True
    assert batched.TpuDecompressor3D(hybrid=False)._hybrid_enabled() is False


@pytest.mark.parametrize(
    "nchunks,ndev,budget,sizes",
    [
        (8, 1, 4096, [1] * 8),  # one chunk per call, no mesh
        (8, 4, 4096, [4, 4]),  # per-device budget: a chunk on each device
        (10, 4, 2 * 4096, [8, 2]),  # two per device, uneven remainder
        (3, 4, 1 << 30, [3]),  # everything in one call
    ],
)
def test_sub_batches_budget_is_per_device(nchunks, ndev, budget, sizes):
    mesh = None if ndev == 1 else batched.make_chunk_mesh(jax.devices()[:ndev])
    groups = {(16, 16, 16): list(range(nchunks))}
    parts = batched._sub_batches(groups, budget, mesh)
    assert [len(idx) for _, idx in parts] == sizes
    assert sum((idx for _, idx in parts), []) == list(range(nchunks))


def test_mesh_sub_batches_span_all_devices():
    """At the wave budget's one-chunk-per-device regime, every meshed
    sub-batch is placed across all 4 devices, and the container is
    byte-identical to the one-device mesh's."""
    import chip_smoke

    res = chip_smoke.phase_four_cards(
        (32, 32, 32), (16, 16, 16), 1e-2, wave_elem_budget=16 ** 3
    )
    assert res["batch_devices"] == [4, 4]


def test_place_shards_even_batches_only():
    mesh = batched.make_chunk_mesh(jax.devices()[:4])
    even = batched._place(np.zeros((8, 2), np.float32), mesh)
    assert len(even.sharding.device_set) == 4
    assert {s.data.shape for s in even.addressable_shards} == {(2, 2)}
    odd = batched._place(np.zeros((3, 2), np.float32), mesh)
    assert len(odd.sharding.device_set) == 1


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    """$JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is a
    fixed directory inside the checkout."""
    root = tmp_path / "repo"
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
        assert compile_cache.cache_dir(str(root)) == str(tmp_path / "c")
        assert compile_cache.cache_dir(str(root), "cpu-x") == str(tmp_path / "c")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert compile_cache.cache_dir(str(root)) == str(root / ".jax_cache")
        assert compile_cache.cache_dir(str(root), "cpu-x") == str(
            root / ".jax_cache" / "cpu-x"
        )
    old = jax.config.jax_compilation_cache_dir
    try:
        d = compile_cache.enable(str(root), "cpu-x")
        assert jax.config.jax_compilation_cache_dir == d
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
