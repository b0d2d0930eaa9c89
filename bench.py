"""Benchmark: 512^3 f32 PWE-bounded encode + decode, host engine and device.

Two execution engines are measured on the same volume:

  * host-native: the C++ per-chunk pipeline (CDF 9/7 + quantize + SPECK) on
    a thread pool over 256^3 chunks — byte-identical streams to the
    reference, scales with host cores.
  * device: the device-batched pipeline (parallel/batched.py) — dense
    stages and, with entropy="wave", the SPECK bit work on the accelerator;
    plus per-stage device timings (runtime/device_bench.py).

The run needs an accelerator: on a CPU-only JAX backend it exits non-zero
without printing a result.  Headline = the device 512^3 (8 x 256^3 chunks)
encode + full container decode, stage-timed.  Baseline: the reference
encodes 512^3 f32 at ~0.04 GB/s on one CPU core (BASELINE.md,
May_11/512_cube.result).

Prints a DETAIL line, then one JSON line as the last line:
{"metric", "value", "unit", "vs_baseline", "headline_source", "device"}.
"""

import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-2

# SDRBench configurations from BASELINE.json: loaded from $SDRBENCH_DIR
# when the datasets are present, synthetic stand-ins at the exact dims
# otherwise (so the configs are always runnable).
SDR_CONFIGS = {
    # name: (dims (nx, ny, nz) x-fastest, candidate file names)
    "miranda": ((384, 384, 256), ("density.f32", "miranda_density.f32")),
    "nyx": ((512, 512, 512), ("temperature.f32", "nyx_temperature.f32")),
}


def make_volume(n=512, dims=None):
    """Synthetic smooth field, f32, range ~[-2, 2], shaped (nz, ny, nx): a
    superposition of random low-frequency separable modes (no tiling
    artifacts), plus noise well below the PWE tolerance — the operating
    regime of error-bounded compression of simulation output.  `dims`
    (nx, ny, nz) overrides the n^3 cube."""
    from sperr_tpu.utils.testdata import smooth_field

    return smooth_field(dims if dims is not None else (n, n, n))


def load_config(name):
    """(volume zyx-shaped f32, source tag) for a named SDRBench config."""
    dims, candidates = SDR_CONFIGS[name]
    nx, ny, nz = dims
    d = os.environ.get("SDRBENCH_DIR", "")
    for fn in candidates if d else ():
        p = os.path.join(d, fn)
        if os.path.exists(p):
            data = np.fromfile(p, dtype=np.float32)
            if data.size == nx * ny * nz:
                return data.reshape(nz, ny, nx), f"sdrbench:{p}"
    return make_volume(dims=dims), "synthetic stand-in"


def run_host(vol):
    """Host-native fast mode (f32 pipeline): the per-chip throughput path for
    f32 inputs; the f64 parity mode is the interchange path."""
    from sperr_tpu.parallel.chunked3d import Sperr3DCompressor, Sperr3DDecompressor

    nz, ny, nx = vol.shape
    comp = Sperr3DCompressor((nx, ny, nz), (256, 256, 256), precision=32)
    dec = Sperr3DDecompressor(precision=32)
    stream = comp.compress(vol, "pwe", TOL)  # warm (builds native lib)
    # Preallocated warm output: a fresh allocation per call would add the
    # OS page-fault cost to the decode measurement.
    out = np.empty((nz, ny, nx), dtype=np.float32)
    dec.decompress(bytes(stream), out=out)

    enc_t, dec_t = [], []
    sbytes = bytes(stream)
    for _ in range(3):
        t0 = time.perf_counter()
        stream = comp.compress(vol, "pwe", TOL)
        t1 = time.perf_counter()
        out, _ = dec.decompress(sbytes, out=out)
        t2 = time.perf_counter()
        enc_t.append(t1 - t0)
        dec_t.append(t2 - t1)
    err = float(np.abs(out.astype(np.float64) - vol.astype(np.float64)).max())
    assert err <= TOL, f"PWE bound violated (host): {err}"
    return min(enc_t), min(dec_t), len(stream), err


def run_device(vol, entropy="wave"):
    """Served device path: numpy volume in, stream out, and back to
    device-resident blocks; wall clock ends in block_until_ready."""
    import jax

    from sperr_tpu.parallel.batched import TpuCompressor3D, TpuDecompressor3D

    nz, ny, nx = vol.shape
    comp = TpuCompressor3D((nx, ny, nz), (256, 256, 256), entropy=entropy)
    dec = TpuDecompressor3D()

    def decode_device():
        blocks, _ = dec.decompress(stream, to_host=False)
        jax.block_until_ready(list(blocks.values()))
        return blocks

    stream = comp.compress(vol, "pwe", TOL)  # warm (compiles)
    decode_device()

    t0 = time.perf_counter()
    stream = comp.compress(vol, "pwe", TOL)
    t1 = time.perf_counter()
    blocks = decode_device()
    t2 = time.perf_counter()

    err = 0.0
    for (z0, y0, x0, lz, ly, lx), b in blocks.items():
        orig = vol[z0 : z0 + lz, y0 : y0 + ly, x0 : x0 + lx]
        err = max(err, float(np.abs(np.asarray(b, np.float64) - orig).max()))
    assert err <= TOL, f"PWE bound violated (device): {err}"
    return t1 - t0, t2 - t1, len(stream), err, comp.last_wave_chunks


def run_device_stages(n=256, chunks=8):
    """Per-stage device timings (dispatch excluded); see
    sperr_tpu/runtime/device_bench.py."""
    from sperr_tpu.runtime.device_bench import (
        container_decode_stages, pipeline_stages, wave2d_stage,
        wave_entropy_stage,
    )

    out = pipeline_stages(n=n, batch=1, tol=TOL, iters=4)
    cd = container_decode_stages(n=n, tol=TOL, chunks=chunks)
    out["container_decode"] = cd
    out["decode_total_s"] = cd["decode_total_s"]
    # the 512^3 flagship (scan over 8 chunks) first, then the single-chunk
    # and regime rows: ~2 bpp (noise at 2.5x tol, the reference baselines'
    # rate band) and white noise (every cap saturated)
    out["wave_entropy_512"] = wave_entropy_stage(n=n, batch=chunks, tol=TOL)
    out["wave_entropy_256"] = wave_entropy_stage(n=n, batch=1, tol=TOL)
    out["wave_entropy_256_dense"] = wave_entropy_stage(
        n=n, batch=1, tol=TOL, regime="dense"
    )
    out["wave_entropy_noisy"] = wave_entropy_stage(
        n=n, batch=1, tol=TOL, regime="noisy"
    )
    out["wave_2d_1024"] = wave2d_stage(tol=TOL)
    # the device pipeline number: dense-transfer encode core + decode core
    tot = out["encode_core_dense_s"] + out["decode_core_s"]
    out["device_pipeline_gbps"] = round(2 * out["bytes"] / tot / 1e9, 3)
    return out


def main():
    from sperr_tpu.utils import compile_cache

    compile_cache.enable(_REPO)
    import jax

    d0 = jax.devices()[0]
    if d0.platform == "cpu":
        print("bench.py: no accelerator (JAX backend is cpu)", file=sys.stderr)
        return 1
    device = {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(jax.devices()),
    }

    cfg = os.environ.get("BENCH_CONFIG", "")
    if "--config" in sys.argv:
        cfg = sys.argv[sys.argv.index("--config") + 1]
    if cfg:
        vol, source = load_config(cfg)
        metric_name = f"{cfg} {'x'.join(map(str, vol.shape[::-1]))}"
    else:
        n = int(os.environ.get("BENCH_N", "512"))
        vol = make_volume(n)
        source = "synthetic smooth field"
        metric_name = f"{n}^3"
    nbytes = vol.nbytes

    enc_s, dec_s, stream_len, err = run_host(vol)
    host = {
        "encode_gbps": round(nbytes / enc_s / 1e9, 4),
        "decode_gbps": round(nbytes / dec_s / 1e9, 4),
        "total_gbps": round(2 * nbytes / (enc_s + dec_s) / 1e9, 4),
        "max_err": err,
        "host_cores": os.cpu_count(),
    }

    te, td, _, terr, wchunks = run_device(vol)
    e2e = {
        "entropy": "wave",
        "wave_chunks_on_device": wchunks,
        "encode_gbps": round(nbytes / te / 1e9, 4),
        "decode_gbps": round(nbytes / td / 1e9, 4),
        "max_err": terr,
    }
    stages = run_device_stages()

    # Headline: the 512^3 flagship (8 x 256^3 chunks) device encode + full
    # container decode, stage-timed; both halves cover the same chunks.
    w = stages["wave_entropy_512"]
    cd = stages["container_decode"]
    assert w["fits"], "flagship wave encode overflowed its tier caps"
    nb = float(w["n"]) ** 3 * 4 * int(w["batch"])
    total_gbps = round(
        2 * nb / (w["wave_total_s"] + cd["decode_total_s"]) / 1e9, 4
    )
    stages["device_wave_pipeline_gbps"] = total_gbps
    side = round((int(w["batch"]) ** (1 / 3)) * w["n"])
    metric = (
        f"{side}^3 ({w['batch']} x {w['n']}^3 chunks) device encode + full "
        f"container decode, stage-timed, PWE({TOL})"
    )
    headline_source = (
        "device: encode = full device SPECK wave pipeline (scan over "
        "chunks); decode = host control parse + device refinement "
        "distribution + invquant + IDWT — every stream byte consumed"
    )

    baseline = 0.04  # GB/s, reference single-core 512^3 encode (BASELINE.md)
    detail = {
        "input": f"{metric_name} {source}",
        "device": device,
        "host_native": host,
        "device_e2e": e2e,
        "device_stages": stages,
        "compressed_bytes": stream_len,
        "bpp": round(stream_len * 8 / vol.size, 3),
    }
    headline = {
        "metric": metric,
        "value": total_gbps,
        "unit": "GB/s/chip",
        "vs_baseline": round(total_gbps / baseline, 2),
        "headline_source": headline_source,
        "device": device,
    }
    sys.stdout.write("DETAIL " + json.dumps(detail) + "\n")
    sys.stdout.write(json.dumps(headline) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
