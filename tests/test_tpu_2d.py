"""Device-batched 2D pipeline (TpuCompressor2D / TpuDecompressor2D)."""

import numpy as np
import pytest

import oracle
from sperr_tpu.parallel.batched2d import TpuCompressor2D, TpuDecompressor2D



pytestmark = pytest.mark.slow  # JAX-compile-heavy (see pytest.ini)

def _field(nx, ny, seed=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:ny, 0:nx]
    f = np.sin(x * 0.11) * np.cos(y * 0.07)
    return (f + 0.02 * rng.normal(size=f.shape)).astype(np.float32)


def _lena():
    return np.fromfile(
        "/root/reference/test_data/lena512.float", dtype=np.float32
    ).reshape(512, 512)


@pytest.mark.parametrize("mode,quality", [("pwe", 1e-3), ("psnr", 60.0), ("rate", 2.0)])
def test_roundtrip_modes(mode, quality):
    nx, ny = 96, 64
    f = _field(nx, ny)
    comp = TpuCompressor2D((nx, ny))
    s = comp.compress(f, mode, quality)
    out = TpuDecompressor2D((nx, ny)).decompress(s)
    err = np.abs(out.astype(np.float64) - f.astype(np.float64)).max()
    if mode == "pwe":
        assert err <= quality
        assert comp.last_uncertified_chunks == 0
    else:
        assert err < 0.2


def test_batch_equals_single():
    nx, ny = 64, 48
    fields = np.stack([_field(nx, ny, seed=i) for i in range(5)])
    comp = TpuCompressor2D((nx, ny))
    batch_streams = comp.compress_batch(fields, "pwe", 1e-3)
    for i in range(5):
        assert batch_streams[i] == comp.compress(fields[i], "pwe", 1e-3)


def test_wave_entropy_matches_host_entropy():
    nx, ny = 64, 48
    f = _field(nx, ny, seed=9)
    s_host = TpuCompressor2D((nx, ny), entropy="host").compress(f, "pwe", 1e-3)
    s_wave = TpuCompressor2D((nx, ny), entropy="wave").compress(f, "pwe", 1e-3)
    assert bytes(s_host) == bytes(s_wave)


def test_stream_decodable_by_host_codec():
    """Device 2D streams are format-valid SPECK2D_FLT payloads."""
    from sperr_tpu.codec.speck_flt import SpeckFloatCodec

    nx, ny = 96, 64
    f = _field(nx, ny, seed=5)
    tol = 1e-3
    s = TpuCompressor2D((nx, ny)).compress(f, "pwe", tol)
    out, _ = SpeckFloatCodec(2, (nx, ny, 1)).decompress(bytes(s))
    err = np.abs(out.reshape(ny, nx) - f.astype(np.float64)).max()
    assert err <= tol  # dual-certified: exact for the f64 decoder


@pytest.mark.skipif(oracle.get_lib() is None, reason="oracle unavailable")
def test_stream_decodable_by_reference():
    """lena512 through the DEVICE 2D path decodes with the reference
    binary within the PWE bound."""
    f = _lena()
    tol = 1e-2
    comp = TpuCompressor2D((512, 512), entropy="wave")
    s = comp.compress(f, "pwe", tol)
    out = oracle.decomp_2d(bytes(s), (512, 512))
    err = np.abs(np.asarray(out).reshape(512, 512) - f.astype(np.float64)).max()
    assert err <= tol


def test_with_header_roundtrip():
    nx, ny = 48, 32
    f = _field(nx, ny, seed=11)
    comp = TpuCompressor2D((nx, ny), with_header=True)
    s = comp.compress(f, "psnr", 70.0)
    from sperr_tpu.stream import tools

    (hx, hy), is_float = tools.parse_2d_header(s)
    assert (hx, hy) == (nx, ny) and is_float
    out = TpuDecompressor2D((nx, ny)).decompress(s, with_header=True)
    assert np.abs(out - f).max() < 0.05


def test_multires_decode():
    nx = ny = 64
    f = _field(nx, ny, seed=13)
    s = TpuCompressor2D((nx, ny)).compress(f, "psnr", 75.0)
    dec = TpuDecompressor2D((nx, ny))
    out = dec.decompress(s, multi_res=True)
    from sperr_tpu.utils.dims import coarsened_resolutions

    res = coarsened_resolutions((nx, ny, 1))
    hier = dec.hierarchy[0]
    assert len(hier) == len(res) > 0
    for arr, r in zip(hier, res):
        assert arr.shape == (r[1], r[0])
    assert np.isfinite(out).all()


def test_constant_field():
    nx, ny = 32, 32
    f = np.full((ny, nx), 4.25, dtype=np.float32)
    comp = TpuCompressor2D((nx, ny))
    s = comp.compress(f, "pwe", 1e-3)
    assert len(s) == 17
    out = TpuDecompressor2D((nx, ny)).decompress(s)
    np.testing.assert_array_equal(out, f)


def test_native_residual_matches_2d_transform():
    """The dual certificate's host scan treats 2D as (nx, ny, 1): the
    wavelet-packet 3D transform with nz=1 must equal the 2D transform."""
    from sperr_tpu.ops import cdf97_np
    from sperr_tpu.runtime import native

    nx, ny = 24, 18
    n = nx * ny
    rng = np.random.default_rng(4)
    ll = np.zeros(n, dtype=np.int32)
    pick = rng.choice(n, n // 4, replace=False)
    ll[pick] = rng.integers(-500, 500, size=pick.size)
    orig = rng.normal(size=n)
    q, mean, tol = 2.1e-3, 0.5, 1e-1
    pos, err = native.residual_outliers(ll, (nx, ny, 1), q, mean, orig, tol)
    rec = cdf97_np.idwt2d((q * ll.astype(np.float64)).reshape(ny, nx)).ravel()
    diff = (orig - mean) - rec
    want = np.flatnonzero(np.abs(diff) > tol)
    np.testing.assert_array_equal(pos.astype(np.int64), want)
    np.testing.assert_allclose(err, diff[want], rtol=0, atol=0)


def test_wave_retry_ladder_covers_noise_2d():
    """Noise fields overflow the first event-cap tier; the retry ladder
    keeps them on the device path, byte-identical to host entropy."""
    rng = np.random.default_rng(5)
    imgs = rng.normal(size=(2, 64, 64)).astype(np.float64)
    tol = 1e-2
    cw = TpuCompressor2D((64, 64), entropy="wave")
    bw = cw.compress_batch(imgs, "pwe", tol)
    assert cw.last_wave_chunks == 2
    bh = TpuCompressor2D((64, 64), entropy="host").compress_batch(
        imgs, "pwe", tol
    )
    assert all(bytes(a) == bytes(b) for a, b in zip(bw, bh))
