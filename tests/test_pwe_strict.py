"""Strict PWE on the f32 device path.

With ``pwe_strict=True`` (default) the PWE bound is *dual-certified*: the
outlier set bounds the error of both the exact f64 reconstruction (ours and
the reference's decoders; SPECK_FLT.cpp:461-486 semantics via the native
st_residual_outliers scan) and the f32 reconstruction the shipped
TpuDecompressor3D computes (decoder-exact on-device scan + per-point
certificates, parallel/batched._certify_dual).  ``pwe_strict="f64"`` keeps
the reference's exact-f64-only contract; ``pwe_strict=False`` keeps the
all-device scan (fast mode, f32-roundoff-bounded contract)."""

import numpy as np
import pytest

import oracle
from sperr_tpu.parallel.batched import TpuCompressor3D, TpuDecompressor3D



pytestmark = pytest.mark.slow  # JAX-compile-heavy (see pytest.ini)

def _field(nx, ny, nz, seed=11):
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:nz, 0:ny, 0:nx]
    f = np.sin(x * 0.21) * np.cos(y * 0.13) * np.sin(z * 0.17 + 0.5)
    return (f + 0.02 * rng.normal(size=f.shape)).astype(np.float64)


# tolerances near/below f32 certification ability for O(1)-range data
@pytest.mark.parametrize("entropy", ["host", "wave"])
@pytest.mark.parametrize("tol", [1e-3, 1e-5, 1e-6])
def test_strict_pwe_bound_f64_decode(entropy, tol):
    from sperr_tpu.parallel.chunked3d import Sperr3DDecompressor

    dims = (40, 40, 24)
    vol = _field(*dims)
    comp = TpuCompressor3D(dims, (24, 24, 24), entropy=entropy)
    assert comp.pwe_strict
    s = bytes(comp.compress(vol, "pwe", tol))
    out, _ = Sperr3DDecompressor().decompress(s)
    err = np.abs(np.asarray(out).reshape(vol.shape) - vol).max()
    assert err <= tol


@pytest.mark.parametrize("tol", [1e-2, 1e-4])
def test_device_decode_strict_bound_harsh_data(tol):
    """The dryrun regime: full-range random data at 16^3 chunks, decoded by
    the shipped f32 device decoder — the strict bound must hold exactly
    (dual certification)."""
    rng = np.random.default_rng(0)
    dims = (16, 16, 48)  # nx, ny, nz -> three 16^3 chunks
    nx, ny, nz = dims
    vol = rng.normal(size=(nz, ny, nx)).astype(np.float32)
    comp = TpuCompressor3D(dims, (16, 16, 16))
    s = bytes(comp.compress(vol, "pwe", tol))
    assert comp.last_uncertified_chunks == 0
    out, _ = TpuDecompressor3D().decompress(s)
    err = np.abs(
        np.asarray(out).astype(np.float64) - vol.astype(np.float64)
    ).max()
    assert err <= tol

    # the same stream must also honor the bound under the exact f64 decoder
    from sperr_tpu.parallel.chunked3d import Sperr3DDecompressor

    out64, _ = Sperr3DDecompressor().decompress(s)
    err64 = np.abs(
        np.asarray(out64).reshape(vol.shape) - vol.astype(np.float64)
    ).max()
    assert err64 <= tol


@pytest.mark.parametrize("tol", [1e-3, 1e-5])
def test_device_decode_strict_bound_smooth(tol):
    dims = (40, 40, 24)
    vol = _field(*dims)
    comp = TpuCompressor3D(dims, (24, 24, 24))
    s = bytes(comp.compress(vol, "pwe", tol))
    assert comp.last_uncertified_chunks == 0
    out, _ = TpuDecompressor3D().decompress(s)
    err = np.abs(np.asarray(out).reshape(vol.shape) - vol).max()
    assert err <= tol


def test_uncertifiable_tolerance_is_flagged():
    """A tolerance within a few ulps of the f32 data scale cannot be
    certified for the f32 decoder; the compressor must say so (and the f64
    bound must still hold)."""
    from sperr_tpu.parallel.chunked3d import Sperr3DDecompressor

    dims = (24, 24, 24)
    vol = _field(*dims, seed=9)
    tol = 1e-7  # O(eps32) of the O(1) data scale
    comp = TpuCompressor3D(dims, dims)
    s = bytes(comp.compress(vol, "pwe", tol))
    assert comp.last_uncertified_chunks == 1
    out, _ = Sperr3DDecompressor().decompress(s)
    err = np.abs(np.asarray(out).reshape(vol.shape) - vol).max()
    assert err <= tol


@pytest.mark.skipif(oracle.get_lib() is None, reason="oracle unavailable")
def test_strict_pwe_bound_reference_decode():
    """The bound must hold when the stream is decoded by the reference
    implementation itself."""
    dims = (33, 27, 18)
    vol = _field(*dims, seed=3)
    s = bytes(TpuCompressor3D(dims, dims).compress(vol, "pwe", 1e-5))
    out, _ = oracle.decomp_3d(s)
    err = np.abs(np.asarray(out).ravel() - vol.ravel()).max()
    assert err <= 1e-5


def test_strict_q_matches_reference_formula():
    """Strict PWE stores q = 1.5*tol in f64 (SPECK_FLT.cpp:281), not the
    device-f32 rounding of it."""
    import struct

    dims = (24, 24, 24)
    vol = _field(*dims, seed=5)
    tol = 1.3e-4
    s = bytes(TpuCompressor3D(dims, dims).compress(vol, "pwe", tol))
    # container header (14 or 20+4n bytes) then condi header: flags u8,
    # mean f64, q f64
    from sperr_tpu.stream import tools

    hdr_len = tools.get_header_len(s[:20])
    q = struct.unpack_from("<d", s, hdr_len + 1 + 8)[0]
    assert q == 1.5 * tol


@pytest.mark.parametrize("tol", [1e-2, 1e-4, 1e-6])
def test_margin_mode_bound_f64_decode(tol):
    """pwe_strict="device": the all-device scan detects at tol - eta; the f64
    decode bound must hold at every tolerance — loose ones certified on
    device, tight ones via the automatic host-residual fallback."""
    from sperr_tpu.parallel.chunked3d import Sperr3DDecompressor

    dims = (40, 40, 24)
    vol = _field(*dims)
    comp = TpuCompressor3D(dims, (24, 24, 24), pwe_strict="device")
    s = bytes(comp.compress(vol, "pwe", tol))
    out, _ = Sperr3DDecompressor().decompress(s)
    err = np.abs(np.asarray(out).reshape(vol.shape) - vol).max()
    assert err <= tol


def test_margin_flag_scales_with_tolerance():
    """The device flags chunks whose eta exceeds tol/4: loose tolerances
    certify on device, tight ones demand the host fallback."""
    import jax
    import jax.numpy as jnp

    from sperr_tpu.parallel.batched import _dense_encode_sparse

    vol = _field(24, 24, 24).astype(np.float32)[None]
    dev = jnp.asarray(vol)
    loose = _dense_encode_sparse(dev, "pwe", 1e-2, 4096, 512, "margin")
    tight = _dense_encode_sparse(dev, "pwe", 1e-7, 4096, 512, "margin")
    assert not bool(np.asarray(jax.device_get(loose["margin_bad"]))[0])
    assert bool(np.asarray(jax.device_get(tight["margin_bad"]))[0])


def test_fast_mode_still_roundtrips():
    dims = (32, 32, 32)
    vol = _field(*dims, seed=7)
    comp = TpuCompressor3D(dims, (16, 16, 16), pwe_strict=False)
    s = bytes(comp.compress(vol, "pwe", 1e-2))
    out, _ = TpuDecompressor3D().decompress(s)
    err = np.abs(np.asarray(out).reshape(vol.shape) - vol).max()
    assert err <= 1e-2  # loose tol: f32 scan certifies it comfortably


def test_residual_outliers_matches_numpy_reference():
    """Native st_residual_outliers == the pure-NumPy f64 residual."""
    from sperr_tpu.ops import cdf97_np
    from sperr_tpu.runtime import native

    dims3 = (18, 14, 10)  # (lx, ly, lz)
    lx, ly, lz = dims3
    n = lx * ly * lz
    rng = np.random.default_rng(17)
    ll = np.zeros(n, dtype=np.int32)
    pick = rng.choice(n, n // 5, replace=False)
    ll[pick] = rng.integers(-2000, 2000, size=pick.size)
    orig = rng.normal(size=n)
    q, mean, tol = 3.7e-4, 0.125, 2e-1
    pos, err = native.residual_outliers(ll, dims3, q, mean, orig, tol)
    rec = cdf97_np.idwt3d((q * ll.astype(np.float64)).reshape(lz, ly, lx)).ravel()
    diff = (orig - mean) - rec
    want = np.flatnonzero(np.abs(diff) > tol)
    np.testing.assert_array_equal(pos.astype(np.int64), want)
    np.testing.assert_array_equal(err, diff[want])


def test_uncertifiable_tolerance_surfaces_chunks():
    """A PWE tolerance within ~1e2 ulps of the data scale cannot be
    certified for the shipped f32 device decoder; the compressor must say
    WHICH chunks carry the weaker (f64-only) contract — the reference's
    per-chunk error surface (SPERR3D_OMP_C.cpp:132-135) extended to the
    certification state."""
    from sperr_tpu.parallel.batched import TpuCompressor3D

    rng = np.random.default_rng(3)
    n = 16
    vol = (np.ones((n, n, n)) + 0.1 * rng.normal(size=(n, n, n))).astype(
        np.float32
    )
    tol = 1e-7  # ~1 ulp of the O(1) data scale: eta > tol/8 by construction
    comp = TpuCompressor3D((n, n, n), (n, n, n))
    stream = comp.compress(vol, "pwe", tol)
    assert comp.last_uncertified_chunks == 1
    assert comp.last_uncertified_ids == [0]

    # the exact-f64 decoder contract still holds for the flagged chunk
    from sperr_tpu.parallel.chunked3d import Sperr3DDecompressor

    out, _ = Sperr3DDecompressor(precision=64).decompress(bytes(stream))
    assert np.abs(out.astype(np.float64) - vol.astype(np.float64)).max() <= tol


def test_certified_run_has_no_flagged_chunks():
    from sperr_tpu.parallel.batched import TpuCompressor3D

    rng = np.random.default_rng(5)
    n = 16
    vol = (np.ones((n, n, n)) + 0.1 * rng.normal(size=(n, n, n))).astype(
        np.float32
    )
    comp = TpuCompressor3D((n, n, n), (n, n, n))
    comp.compress(vol, "pwe", 1e-2)
    assert comp.last_uncertified_chunks == 0
    assert comp.last_uncertified_ids == []


def test_cli_surfaces_certification(tmp_path, capsys):
    from sperr_tpu.cli import sperr3d

    rng = np.random.default_rng(9)
    n = 16
    vol = (np.ones((n, n, n)) + 0.1 * rng.normal(size=(n, n, n))).astype(
        np.float32
    )
    inp = tmp_path / "in.f32"
    vol.ravel().tofile(inp)
    rc = sperr3d.run(
        ["-c", str(inp), "--ftype", "32", "--dims", str(n), str(n), str(n),
         "--exec", "tpu", "--pwe", "1e-7", "--print_stats",
         "--bitstream", str(tmp_path / "o.stream")]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "NOT certified" in out and "ids [0]" in out

    rc = sperr3d.run(
        ["-c", str(inp), "--ftype", "32", "--dims", str(n), str(n), str(n),
         "--exec", "tpu", "--pwe", "1e-2", "--print_stats",
         "--bitstream", str(tmp_path / "o2.stream")]
    )
    assert rc == 0
    assert "certified for both" in capsys.readouterr().out
