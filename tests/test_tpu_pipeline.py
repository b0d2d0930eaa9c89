"""Device-batched chunk pipeline: mesh sharding, roundtrip, cross-decode."""

import jax
import numpy as np
import pytest

from sperr_tpu.parallel import batched
from sperr_tpu.parallel.chunked3d import Sperr3DDecompressor

import oracle



pytestmark = pytest.mark.slow  # JAX-compile-heavy (see pytest.ini)

def _vol(nx, ny, nz, seed=21):
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:nz, 0:ny, 0:nx]
    f = np.sin(x * 0.2) * np.cos(y * 0.15) * np.sin(z * 0.1 + 1.0)
    return (f + 0.02 * rng.normal(size=f.shape)).astype(np.float32)


def test_mesh_has_virtual_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("mode,quality", [("pwe", 1e-3), ("psnr", 60.0), ("rate", 2.0)])
def test_roundtrip_modes(mode, quality):
    vol = _vol(32, 32, 64)
    comp = batched.TpuCompressor3D((32, 32, 64), (32, 32, 32))
    stream = comp.compress(vol, mode, quality)
    dec = batched.TpuDecompressor3D()
    out, dims = dec.decompress(stream)
    assert dims == (32, 32, 64)
    err = np.abs(out.astype(np.float64) - vol.astype(np.float64)).max()
    if mode == "pwe":
        assert err <= quality
    else:
        assert err < 0.1  # sane reconstruction


def test_mesh_sharded_compress():
    mesh = batched.make_chunk_mesh()
    vol = _vol(32, 32, 256)  # 8 equal chunks of 32^3 -> one per device
    comp = batched.TpuCompressor3D((32, 32, 256), (32, 32, 32), mesh=mesh)
    stream = comp.compress(vol, "pwe", 1e-3)

    dec = batched.TpuDecompressor3D(mesh=mesh)
    out, _ = dec.decompress(stream)
    assert np.abs(out.astype(np.float64) - vol.astype(np.float64)).max() <= 1e-3


@pytest.mark.parametrize(
    "mode,quality,kw",
    [
        ("pwe", 1e-3, {"pwe_strict": "f64"}),
        ("psnr", 60.0, {}),
    ],
)
def test_mesh_sharding_byte_invariant(mode, quality, kw):
    """Sharded and unsharded runs must emit identical containers on the
    tiers whose streams are a function of host-side arithmetic given the
    quantized coefficients (pwe_strict="f64", psnr/rate).  The dual tier's
    outlier set consults the device's own f32 residual, whose ulp-level
    boundary decisions may legitimately differ between SPMD partitionings —
    there the contract is the certified bound, not byte equality (covered
    by test_mesh_sharded_compress)."""
    mesh = batched.make_chunk_mesh()
    vol = _vol(32, 32, 256)
    stream = batched.TpuCompressor3D(
        (32, 32, 256), (32, 32, 32), mesh=mesh, **kw
    ).compress(vol, mode, quality)
    stream_ref = batched.TpuCompressor3D(
        (32, 32, 256), (32, 32, 32), **kw
    ).compress(vol, mode, quality)
    assert stream == stream_ref


def test_stream_decodable_by_host_engine():
    """Device-mode streams are format-valid: the exact host decoder reads them."""
    vol = _vol(24, 24, 48)
    stream = batched.TpuCompressor3D((24, 24, 48), (24, 24, 24)).compress(
        vol, "pwe", 5e-4
    )
    out, dims = Sperr3DDecompressor().decompress(bytes(stream))
    assert dims == (24, 24, 48)
    # dual certification: the exact f64 decode honors the bound strictly
    err = np.abs(out.reshape(vol.shape) - vol.astype(np.float64)).max()
    assert err <= 5e-4


@pytest.mark.skipif(oracle.get_lib() is None, reason="oracle unavailable")
def test_stream_decodable_by_reference():
    """The reference binary itself decodes device-mode streams."""
    vol = _vol(24, 24, 48)
    stream = batched.TpuCompressor3D((24, 24, 48), (24, 24, 24)).compress(
        vol, "pwe", 5e-4
    )
    ref_out, ref_dims = oracle.decomp_3d(bytes(stream))
    assert ref_dims == (24, 24, 48)
    err = np.abs(ref_out.reshape(vol.shape) - vol.astype(np.float64)).max()
    assert err <= 5e-4

    # And it must agree with our host decoder bit-for-bit.
    host_out, _ = Sperr3DDecompressor().decompress(bytes(stream))
    np.testing.assert_array_equal(host_out.ravel(), ref_out)


def test_constant_chunks():
    vol = np.full((32, 32, 32), 2.5, dtype=np.float32)
    stream = batched.TpuCompressor3D((32, 32, 32), (32, 32, 32)).compress(
        vol, "psnr", 80.0
    )
    out, _ = batched.TpuDecompressor3D().decompress(stream)
    np.testing.assert_array_equal(out, vol)
    # 17-byte conditioner stream + container header
    from sperr_tpu.stream import tools

    h = tools.parse_header(stream)
    assert h.chunk_offsets[1] == 17


@pytest.mark.parametrize("bpp", [0.5, 2.0, 4.0])
def test_rate_mode_device_quality_matches_host(bpp):
    """Device rate mode targets q = max|coeff| / (2^20 - 1) instead of the
    host engine's 2^32 - 1 (quantize_jax.RATE_MAX_MAG_DEVICE: magnitudes
    must stay exactly representable in f32).  The rate-distortion cost of
    the narrower ladder must be negligible at production rates: PSNR within
    0.1 dB of the host engine at the same bpp (reference formula
    SPECK_FLT.cpp:283-301)."""
    from sperr_tpu.parallel.chunked3d import Sperr3DCompressor

    vol = np.fromfile(
        "/root/reference/test_data/vorticity.128_128_41", dtype=np.float32
    ).reshape(41, 128, 128)

    def psnr(orig, rec):
        mse = np.mean((rec.astype(np.float64) - orig.astype(np.float64)) ** 2)
        rng = float(orig.max() - orig.min())
        return 10 * np.log10(rng * rng / mse)

    hs = bytes(
        Sperr3DCompressor((128, 128, 41), (128, 128, 41)).compress(
            vol, "rate", bpp
        )
    )
    ho, _ = Sperr3DDecompressor().decompress(hs)
    ts = bytes(
        batched.TpuCompressor3D((128, 128, 41), (128, 128, 41)).compress(
            vol, "rate", bpp
        )
    )
    to, _ = batched.TpuDecompressor3D().decompress(ts)
    assert len(ts) == len(hs)  # the bit budget is exact on both engines
    p_host = psnr(vol, ho.reshape(vol.shape))
    p_dev = psnr(vol, np.asarray(to).reshape(vol.shape))
    assert abs(p_host - p_dev) <= 0.1, (p_host, p_dev)


@pytest.mark.parametrize("mode,quality", [("pwe", 1e-3), ("psnr", 60.0)])
def test_dense_transfer_mode_identical_streams(mode, quality):
    """transfer="dense" (ship dense quantized arrays, host compacts — the
    PCIe-class configuration; on-device compaction costs a large-array
    scatter ~20x the dense math, runtime/device_bench measurements) must
    produce byte-identical containers to the sparse-transfer mode."""
    vol = _vol(32, 32, 64)
    s_sparse = batched.TpuCompressor3D((32, 32, 64), (32, 32, 32)).compress(
        vol, mode, quality
    )
    s_dense = batched.TpuCompressor3D(
        (32, 32, 64), (32, 32, 32), transfer="dense"
    ).compress(vol, mode, quality)
    assert bytes(s_sparse) == bytes(s_dense)


@pytest.mark.parametrize("entropy", ["host", "wave"])
def test_sub_batched_groups_identical_streams(entropy):
    """Memory-bounded sub-batching (wave/dense_elem_budget): splitting a
    shape group across several jit calls must be invisible in the
    container — byte-identical to the one-shot batch, wave coverage
    retained, and the decoder (which sub-batches independently) exact."""
    vol = _vol(16, 16, 64, seed=21)  # four 16^3 chunks in one shape group
    dims, cd = (16, 16, 64), (16, 16, 16)

    one = batched.TpuCompressor3D(dims, cd, entropy=entropy)
    s_one = bytes(one.compress(vol, "pwe", 1e-3))

    sub = batched.TpuCompressor3D(dims, cd, entropy=entropy)
    sub.wave_elem_budget = 16 * 16 * 16  # 1 chunk per jit call
    sub.dense_elem_budget = 16 * 16 * 16
    s_sub = bytes(sub.compress(vol, "pwe", 1e-3))
    assert s_sub == s_one
    assert sub.last_wave_chunks == one.last_wave_chunks

    out, dims_out = batched.TpuDecompressor3D().decompress(s_sub)
    assert dims_out == dims
    assert np.abs(out.astype(np.float64) - vol.astype(np.float64)).max() <= 1e-3
