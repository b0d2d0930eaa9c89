"""chip_smoke.py: its phases at small sizes on the CPU, and its refusal to
report a result without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np

import chip_smoke as cs
from sperr_tpu.utils.testdata import smooth_field

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-2


def _run_script(path, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, path], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def _no_ok_line(stdout):
    return not any('"ok"' in ln for ln in stdout.splitlines())


def test_main_refuses_cpu_backend():
    r = _run_script(os.path.join(_REPO, "chip_smoke.py"), _REPO)
    assert r.returncode != 0
    assert _no_ok_line(r.stdout)
    assert "no GPU" in r.stderr


def test_script_alone_fails(tmp_path):
    """Outside a checkout (the script and nothing else) it cannot pass."""
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    r = _run_script(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert r.returncode != 0
    assert _no_ok_line(r.stdout)


def test_encode_and_decode_phases():
    vol = smooth_field((32, 32, 32))
    enc = cs.phase_encode(vol, (16, 16, 16), TOL)
    assert enc["wave_chunks"] == enc["chunks"] == 8
    dec = cs.phase_decode(enc.pop("stream"), vol, (16, 16, 16), TOL)
    assert dec["hybrid"]["hybrid_chunks"] == 8
    assert dec["host_parse"]["hybrid_chunks"] == 0


def test_dense_phase():
    res = cs.phase_dense(16, TOL)
    assert res["bpp"] > 2.0 and res["max_err"] <= TOL


def test_2d_phase():
    res = cs.phase_2d(64, 48, 2, TOL)
    assert res["wave_fields"] == 2


def test_cli_phase(tmp_path):
    vol = smooth_field((24, 20, 16))
    res = cs.phase_cli(vol, (16, 16, 16), TOL, str(tmp_path / "work"))
    assert res["stream_bytes"] > 0
    assert not (tmp_path / "work").exists()


def test_kernel_phase():
    res = cs.phase_kernels(32, 2, TOL)
    assert res["dwt_err_rel_coeff"] <= cs.DWT_REL_TOL
    assert res["idwt_err_rel_x"] <= cs.DWT_REL_TOL
    assert np.isfinite(res["quantize_s"])
