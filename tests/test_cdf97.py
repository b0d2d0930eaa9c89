"""Wavelet transform tests (mirrors dwt_unit_test.cpp) + JAX engine equality."""

import numpy as np
import pytest

from sperr_tpu.ops import cdf97_np as cdf


def _rand(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(np.float64)


@pytest.mark.parametrize("n", [9, 16, 17, 63, 64, 127, 128, 999])
def test_dwt1d_roundtrip_f32_exact(n):
    x = _rand((n,))
    rec = cdf.idwt1d(cdf.dwt1d(x))
    np.testing.assert_array_equal(x.astype(np.float32), rec.astype(np.float32))


@pytest.mark.parametrize("shape", [(15, 15), (16, 16), (63, 64), (127, 127), (90, 90)])
def test_dwt2d_roundtrip_f32_exact(shape):
    x = _rand(shape)
    rec = cdf.idwt2d(cdf.dwt2d(x))
    np.testing.assert_array_equal(x.astype(np.float32), rec.astype(np.float32))


@pytest.mark.parametrize(
    "shape", [(16, 16, 16), (17, 16, 15), (41, 33, 29), (9, 36, 36)]
)
def test_dwt3d_roundtrip_f32_exact(shape):
    x = _rand(shape)
    rec = cdf.idwt3d(cdf.dwt3d(x))
    np.testing.assert_array_equal(x.astype(np.float32), rec.astype(np.float32))


def test_multi_res_shapes():
    from sperr_tpu.utils.dims import coarsened_resolutions

    x = _rand((64, 64, 64))
    coeffs = cdf.dwt3d(x)
    rec, hier = cdf.idwt3d_multi_res(coeffs)
    res = coarsened_resolutions((64, 64, 64))
    assert len(hier) == len(res)
    for h, r in zip(hier, res):
        assert h.shape == (r[2], r[1], r[0])
    np.testing.assert_allclose(rec, x, atol=1e-9)


class TestJaxEngine:
    """Device-path transform engine.

    XLA contracts multiply-adds into FMAs, so the JAX engine agrees with the
    exact host engine only to ~1 ulp per lifting step (and the device path has no f64 at
    all); the host engine remains the bit-exact parity path.  Here we require
    (a) near-equality with the host engine in f64 on CPU, and (b) exact f32
    roundtrips — the same contract the reference's dwt tests use.
    """

    @pytest.fixture(autouse=True)
    def _imports(self, enable_x64):
        # the f64-vs-host comparison needs x64 jax semantics (host-side CPU
        # check only; the production device path is f32 and tested elsewhere)
        from sperr_tpu.ops import cdf97_jax as cdfj

        self.cdfj = cdfj

    @pytest.mark.parametrize("n", [9, 1000])
    def test_1d(self, n):
        x = _rand((n,), seed=n)
        out = np.asarray(self.cdfj.dwt1d(x))
        np.testing.assert_allclose(cdf.dwt1d(x), out, rtol=1e-12, atol=1e-12)
        back = np.asarray(self.cdfj.idwt1d(out))
        np.testing.assert_array_equal(x.astype(np.float32), back.astype(np.float32))

    @pytest.mark.parametrize("shape", [(15, 15), (64, 48)])
    def test_2d(self, shape):
        x = _rand(shape, seed=shape[0])
        out = np.asarray(self.cdfj.dwt2d(x))
        np.testing.assert_allclose(cdf.dwt2d(x), out, rtol=1e-11, atol=1e-11)
        back = np.asarray(self.cdfj.idwt2d(out))
        np.testing.assert_array_equal(x.astype(np.float32), back.astype(np.float32))

    @pytest.mark.parametrize("shape", [(41, 33, 29), (9, 36, 36)])
    def test_3d(self, shape):
        x = _rand(shape, seed=shape[0])
        out = np.asarray(self.cdfj.dwt3d(x))
        np.testing.assert_allclose(cdf.dwt3d(x), out, rtol=1e-11, atol=1e-11)
        back = np.asarray(self.cdfj.idwt3d(out))
        np.testing.assert_array_equal(x.astype(np.float32), back.astype(np.float32))

    def test_batched_equals_loop(self):
        xs = _rand((4, 16, 16, 16), seed=77)
        batched = np.asarray(self.cdfj.dwt3d(xs))
        for i in range(4):
            np.testing.assert_array_equal(
                batched[i], np.asarray(self.cdfj.dwt3d(xs[i]))
            )
