#!/usr/bin/env python3
"""Run the device codec's main path once on a GPU and check every output.

    python chip_smoke.py               # one card: the 512^3 NYX-dims volume
    python chip_smoke.py --four-cards  # only the chunk mesh over four cards

One process drives the public entry points (a second JAX process would find
the card's memory already reserved):

  A  device check: a GPU backend, the card's name and power limit
  B  3D encode, device entropy: every chunk on the device path, the stream
     byte-equal to the host-entropy stream, PWE bound under the exact f64
     host decoder
  C  3D decode on the device: hybrid and full-host-parse decoders agree
     and both hold the bound on every chunk
  D  one dense (~2 bpp) 256^3 chunk: the deeper tiers and retry ladder
  E  2D batch: 4 x 1024^2 fields, wave == host streams, bound held
  F  the sperr3d CLI (--exec tpu), called in-process
  G  device kernels against the plain references at 256^3: DWT/IDWT,
     the quantizer, the bf16 bit-pack matrix products
  H  timings (compile reported as set-up) and peak device memory

The data is the synthetic stand-in for SDRBench NYX (512x512x512 f32),
seeded.  Every phase raises on failure; the last line
{"ok": true, "device": {...}} is printed only when all of them passed.
The phase bodies are importable and take their sizes as arguments, so the
test suite runs them at small sizes on the CPU; `main` refuses the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.abspath(__file__))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from sperr_tpu.ops import cdf97_jax as cdfj  # noqa: E402
from sperr_tpu.ops import cdf97_np  # noqa: E402
from sperr_tpu.ops import packemit as pe  # noqa: E402
from sperr_tpu.ops import quantize as qz  # noqa: E402
from sperr_tpu.ops import quantize_jax as qzj  # noqa: E402
from sperr_tpu.ops import speck_jax as sj  # noqa: E402
from sperr_tpu.parallel.batched import (  # noqa: E402
    TpuCompressor3D, TpuDecompressor3D, make_chunk_mesh,
)
from sperr_tpu.parallel.batched2d import (  # noqa: E402
    TpuCompressor2D, TpuDecompressor2D,
)
from sperr_tpu.parallel.chunked3d import Sperr3DDecompressor  # noqa: E402
from sperr_tpu.runtime.device_bench import (  # noqa: E402
    _smooth_field, smooth_fields_2d,
)
from sperr_tpu.utils import compile_cache  # noqa: E402
from sperr_tpu.utils.dims import chunk_volume  # noqa: E402
from sperr_tpu.utils.testdata import smooth_field  # noqa: E402

TOL = 1e-2
NYX_DIMS = (512, 512, 512)  # SDRBench NYX, BASELINE.json config 5
FOUR_CARD_DIMS = (1024, 1024, 512)  # 32 x 256^3 chunks, 8 per card
CHUNK = (256, 256, 256)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
# f32 roundoff scale of a lifting-transform output, relative to the largest
# magnitude of that output (the bound the f32 transform tests use)
DWT_REL_TOL = 2e-5
NO_CARD = "card not queried"


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _max_err(a, b) -> float:
    return float(
        np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)))
    )


def _dims_of(vol):
    nz, ny, nx = vol.shape
    return (nx, ny, nz)


# ---------------------------------------------------------------------------
# A. Device check
# ---------------------------------------------------------------------------
def phase_device(ncards: int = 1) -> dict:
    devs = jax.devices()
    d0 = devs[0]
    check(
        d0.platform == "gpu",
        f"no GPU: JAX's first device is on platform {d0.platform!r}",
    )
    check(len(devs) >= ncards, f"need {ncards} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
    log(f"card: {card}")
    for i, line in enumerate(smi[1:], 1):
        log(f"card {i}: {line.strip()}")
    log(f"jax: platform={d0.platform} device_kind={d0.device_kind} "
        f"count={len(devs)}")
    return {
        "platform": d0.platform, "kind": d0.device_kind, "count": len(devs),
        "card": card,
    }


# ---------------------------------------------------------------------------
# B. 3D encode with device entropy
# ---------------------------------------------------------------------------
def phase_encode(vol, chunk, tol) -> dict:
    dims = _dims_of(vol)
    nchunks = len(chunk_volume(dims, chunk))
    wave = TpuCompressor3D(dims, chunk, entropy="wave")
    _, first_s = _timed(lambda: wave.compress(vol, "pwe", tol))
    sw, enc_s = _timed(lambda: wave.compress(vol, "pwe", tol))
    check(
        wave.last_wave_chunks == nchunks,
        f"device entropy covered {wave.last_wave_chunks}/{nchunks} chunks",
    )
    sh = TpuCompressor3D(dims, chunk, entropy="host").compress(vol, "pwe", tol)
    check(sw == sh, "wave and host-entropy streams differ")
    rec, _ = Sperr3DDecompressor(precision=64).decompress(sw)
    err = _max_err(rec.reshape(vol.shape), vol)
    check(err <= tol, f"f64 host decode max|err| {err} > {tol}")
    res = {
        "chunks": nchunks, "stream_bytes": len(sw),
        "bpp": len(sw) * 8 / vol.size, "wave_chunks": wave.last_wave_chunks,
        "uncertified_chunks": wave.last_uncertified_chunks,
        "encode_first_call_s": first_s, "encode_s": enc_s,
        "f64_max_err": err,
    }
    log(f"B encode: {nchunks} chunks, last_wave_chunks={nchunks}, "
        f"wave == host stream ({len(sw)} B, {res['bpp']:.4f} bpp), "
        f"f64 decode max|err|={err:.6g} <= {tol}, "
        f"last_uncertified_chunks={wave.last_uncertified_chunks}")
    res["stream"] = sw
    return res


# ---------------------------------------------------------------------------
# C. 3D decode on the device
# ---------------------------------------------------------------------------
def phase_decode(stream, vol, chunk, tol) -> dict:
    dims = _dims_of(vol)
    chunks = chunk_volume(dims, chunk)
    res, outs = {}, {}
    for hybrid in (True, False):
        dec = TpuDecompressor3D(hybrid=hybrid)
        _, first_s = _timed(lambda: dec.decompress(stream))
        (out, _), dec_s = _timed(lambda: dec.decompress(stream))
        worst = 0.0
        for x0, lx, y0, ly, z0, lz in chunks:
            sl = np.s_[z0 : z0 + lz, y0 : y0 + ly, x0 : x0 + lx]
            err = _max_err(out[sl], vol[sl])
            check(err <= tol, f"hybrid={hybrid}: chunk max|err| {err} > {tol}")
            worst = max(worst, err)
        key = "hybrid" if hybrid else "host_parse"
        outs[key] = out
        res[key] = {
            "decode_first_call_s": first_s, "decode_s": dec_s,
            "max_err": worst, "hybrid_chunks": dec.last_hybrid_chunks,
        }
        log(f"C decode {key}: max|err|={worst:.6g} <= {tol} on all "
            f"{len(chunks)} chunks, hybrid chunks={dec.last_hybrid_chunks}")
    check(
        np.array_equal(outs["hybrid"], outs["host_parse"]),
        "hybrid and full-host-parse decodes differ",
    )
    log("C decode: hybrid output == full-host-parse output")
    return res


# ---------------------------------------------------------------------------
# D. Dense regime: one chunk at ~2 bpp
# ---------------------------------------------------------------------------
def phase_dense(n, tol) -> dict:
    vol = _smooth_field(n, noise=2.5 * tol)[0]
    dims = (n, n, n)
    wave = TpuCompressor3D(dims, dims, entropy="wave")
    sw = wave.compress(vol, "pwe", tol)
    sh = TpuCompressor3D(dims, dims, entropy="host").compress(vol, "pwe", tol)
    check(sw == sh, "dense chunk: wave and host-entropy streams differ")
    rec, _ = Sperr3DDecompressor(precision=64).decompress(sw)
    err = _max_err(rec.reshape(vol.shape), vol)
    check(err <= tol, f"dense chunk: f64 decode max|err| {err} > {tol}")
    res = {
        "bpp": len(sw) * 8 / vol.size, "wave_chunks": wave.last_wave_chunks,
        "max_err": err,
    }
    log(f"D dense {n}^3: {res['bpp']:.4f} bpp, wave == host stream, "
        f"device-entropy chunks={wave.last_wave_chunks}/1, "
        f"f64 decode max|err|={err:.6g} <= {tol}")
    return res


# ---------------------------------------------------------------------------
# E. 2D batch
# ---------------------------------------------------------------------------
def phase_2d(nx, ny, batch, tol) -> dict:
    fields = smooth_fields_2d(nx, ny, batch)
    wave = TpuCompressor2D((nx, ny), entropy="wave")
    sw = wave.compress_batch(fields, "pwe", tol)
    sh = TpuCompressor2D((nx, ny), entropy="host").compress_batch(
        fields, "pwe", tol
    )
    check(
        [bytes(s) for s in sw] == [bytes(s) for s in sh],
        "2D: wave and host-entropy streams differ",
    )
    outs = TpuDecompressor2D((nx, ny)).decompress_batch(sw)
    err = max(_max_err(o, f) for o, f in zip(outs, fields))
    check(err <= tol, f"2D: device decode max|err| {err} > {tol}")
    res = {
        "bpp": sum(len(s) for s in sw) * 8 / fields.size,
        "wave_fields": wave.last_wave_chunks, "max_err": err,
    }
    log(f"E 2D {batch} x {nx}x{ny}: wave == host streams, device-entropy "
        f"fields={wave.last_wave_chunks}/{batch}, device decode "
        f"max|err|={err:.6g} <= {tol}")
    return res


# ---------------------------------------------------------------------------
# F. CLI, in-process
# ---------------------------------------------------------------------------
def phase_cli(vol, chunk, tol, workdir) -> dict:
    from sperr_tpu.cli import sperr3d

    nx, ny, nz = _dims_of(vol)
    os.makedirs(workdir, exist_ok=True)
    raw = os.path.join(workdir, "vol.f32")
    bits = os.path.join(workdir, "vol.sperr")
    back = os.path.join(workdir, "vol.out.f32")
    try:
        vol.astype(np.float32).tofile(raw)
        rc = sperr3d.run([
            raw, "-c", "--ftype", "32", "--dims", str(nx), str(ny), str(nz),
            "--chunks", *map(str, chunk), "--exec", "tpu", "--pwe", repr(tol),
            "--bitstream", bits,
        ])
        check(rc == 0, f"sperr3d -c returned {rc}")
        rc = sperr3d.run([bits, "-d", "--exec", "tpu", "--decomp_f", back])
        check(rc == 0, f"sperr3d -d returned {rc}")
        out = np.fromfile(back, dtype=np.float32).reshape(vol.shape)
        size = os.path.getsize(bits)
    finally:
        shutil.rmtree(workdir)
    err = _max_err(out, vol)
    check(err <= tol, f"CLI roundtrip max|err| {err} > {tol}")
    log(f"F CLI sperr3d --exec tpu: {size} B stream, roundtrip "
        f"max|err|={err:.6g} <= {tol}")
    return {"stream_bytes": size, "max_err": err}


# ---------------------------------------------------------------------------
# G. Device kernels against the plain references
# ---------------------------------------------------------------------------
def _block_time(fn, *args, reps: int = 5) -> float:
    """Best wall seconds of a jitted call, ending in block_until_ready."""
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def phase_kernels(n, batch, tol, card=NO_CARD) -> dict:
    """`card` (nvidia-smi's name and power limit) labels the timings."""
    res = {}
    x = _smooth_field(n)[0]
    x64 = x.astype(np.float64)
    mx = float(np.abs(x64).max())

    # DWT / IDWT (f32 XLA lifting chain) vs the exact f64 reference
    c64 = cdf97_np.dwt3d(x64)
    dwt = jax.jit(cdfj.dwt3d)
    idwt = jax.jit(cdfj.idwt3d)
    c32 = np.asarray(dwt(jnp.asarray(x)[None]))[0]
    mc = float(np.abs(c64).max())
    fwd = _max_err(c32, c64)
    r32 = np.asarray(idwt(jnp.asarray(c64.astype(np.float32))[None]))[0]
    inv = _max_err(r32, x64)
    log(f"G dwt3d {n}^3: max|dev - f64| = {fwd:.4g} = {fwd / mc:.3g} x "
        f"max|coeff| ({fwd / mx:.3g} x max|x|; coefficients reach "
        f"{mc / mx:.1f} x max|x|)")
    log(f"G idwt3d {n}^3: max|dev - f64| = {inv:.4g} = {inv / mx:.3g} x "
        f"max|x|")
    check(fwd <= DWT_REL_TOL * mc, "dwt3d exceeds the f32 roundoff bound")
    check(inv <= DWT_REL_TOL * mx, "idwt3d exceeds the f32 roundoff bound")
    res.update(dwt_err_rel_coeff=fwd / mc, dwt_err_rel_x=fwd / mx,
               idwt_err_rel_x=inv / mx)

    # quantizer vs the host reference on the same f32 coefficients
    q = 1.5 * tol
    mags, signs, maxmag = jax.jit(qzj.midtread_quantize_batched)(
        jnp.asarray(c32.reshape(1, -1)), jnp.full((1,), q, jnp.float32)
    )
    mags = np.asarray(mags)[0].astype(np.int64)
    signs = np.asarray(signs)[0]
    hm, hs, _ = qz.midtread_quantize(c32.reshape(-1).astype(np.float64), q)
    hm = hm.astype(np.int64)
    bad = np.flatnonzero((mags != hm) | (signs != hs))
    # f32 computes c * f32(1/q) rounded to f32; the host computes it in f64.
    # They can only disagree where the f64 quotient lies within a couple of
    # f32 ulps of a rounding boundary (a half-integer).
    v = np.abs(c32.reshape(-1)[bad].astype(np.float64) / q)
    near_half = np.abs(v - np.floor(v) - 0.5) <= 4 * np.spacing(
        v.astype(np.float32)
    ).astype(np.float64)
    check(bool(near_half.all()), "quantizer differs away from a .5 boundary")
    check(
        np.abs(mags[bad] - hm[bad]).max(initial=0) <= 1,
        "quantizer differs by more than one step",
    )
    check(int(maxmag[0]) == int(mags.max()), "quantizer max mismatch")
    log(f"G quantize {n}^3: {bad.size} of {mags.size} magnitudes differ from "
        f"the f64 host quantizer, all within 4 f32 ulps of a .5 boundary "
        f"(f32 vs f64 rounding of c/q)")
    res["quantize_f32_f64_boundary_diffs"] = int(bad.size)

    # the bf16 x bf16 -> f32 bit-pack matrix products must be exact
    rng = np.random.default_rng(0)
    cells = rng.integers(0, 2, x.size, dtype=np.uint8)
    got = np.asarray(jax.jit(sj._packbits_device)(jnp.asarray(cells)))
    check(
        np.array_equal(got, np.packbits(cells, bitorder="little")),
        "_packbits_device is not exact",
    )
    words = np.asarray(jax.jit(pe.pack_cells_flat)(jnp.asarray(cells)))
    ref = np.packbits(cells, bitorder="little").view("<u4")
    check(np.array_equal(words, ref), "pack_cells_flat is not exact")
    a, b = cells[::2].copy(), cells[1::2].copy()
    inter = np.asarray(jax.jit(pe.pack_cells_interleaved)(
        jnp.asarray(a), jnp.asarray(b)
    ))
    check(np.array_equal(inter, ref), "pack_cells_interleaved is not exact")
    log(f"G bit-pack matmuls ({cells.size} cells): packbits, flat and "
        f"interleaved word packs exact")

    # achieved bandwidth of the XLA quantizer over `batch` chunks, and the
    # plain XLA 3D/2D transforms (the forms that replaced hand kernels)
    cb = jnp.asarray(np.broadcast_to(c32.reshape(1, -1), (batch, c32.size)))
    qb = jnp.full((batch,), q, jnp.float32)
    t_q = _block_time(jax.jit(qzj.midtread_quantize_batched), cb, qb)
    qbytes = cb.size * (4 + 4 + 1)  # read f32, write i32 mags + bool signs
    res["quantize_s"] = t_q
    res["quantize_bytes_per_s"] = qbytes / t_q
    res["quantize_hbm_share"] = qbytes / t_q / HBM_BYTES_PER_S
    # what a plain elementwise copy of the same array reaches on this card
    t_c = _block_time(jax.jit(lambda v: v + 1.0), cb)
    res["copy_bytes_per_s"] = cb.size * 8 / t_c
    xb = jnp.asarray(np.broadcast_to(x, (batch,) + x.shape))
    res["dwt3d_s"] = _block_time(dwt, xb)
    p2 = jnp.asarray(smooth_fields_2d(1024, 1024, 4))
    res["dwt2d_4x1024sq_s"] = _block_time(jax.jit(cdfj.dwt2d), p2)
    log(f"G [{card}] timing: quantize {batch} x {n}^3 {t_q * 1e3:.4f} ms = "
        f"{res['quantize_bytes_per_s'] / 1e9:.1f} GB/s "
        f"({100 * res['quantize_hbm_share']:.1f}% of 3.35 TB/s, "
        f"{100 * res['quantize_bytes_per_s'] / res['copy_bytes_per_s']:.1f}% "
        f"of a same-size copy's {res['copy_bytes_per_s'] / 1e9:.1f} GB/s); "
        f"dwt3d {batch} x {n}^3 {res['dwt3d_s'] * 1e3:.3f} ms; "
        f"dwt2d 4 x 1024^2 {res['dwt2d_4x1024sq_s'] * 1e3:.3f} ms")
    return res


# ---------------------------------------------------------------------------
# Four cards: the chunk mesh
# ---------------------------------------------------------------------------
def phase_four_cards(dims, chunk, tol, ncards: int = 4,
                     wave_elem_budget=None, card=NO_CARD) -> dict:
    """`wave_elem_budget` (elements per device per call) overrides the
    compressors' default, so small test volumes sub-batch like 256^3;
    `card` labels the timings."""
    devs = jax.devices()[:ncards]
    check(len(devs) == ncards, f"need {ncards} devices, have {len(devs)}")
    nx, ny, nz = dims
    vol = smooth_field(dims)
    nchunks = len(chunk_volume(dims, chunk))
    multi = TpuCompressor3D(
        dims, chunk, mesh=make_chunk_mesh(devs), entropy="wave"
    )
    single = TpuCompressor3D(
        dims, chunk, mesh=make_chunk_mesh(devs[:1]), entropy="wave"
    )
    if wave_elem_budget:
        multi.wave_elem_budget = single.wave_elem_budget = wave_elem_budget
    _, first_s = _timed(lambda: multi.compress(vol, "pwe", tol))
    s_multi, multi_s = _timed(lambda: multi.compress(vol, "pwe", tol))
    spans = multi.last_batch_devices
    check(
        len(spans) > 0 and all(d == ncards for d in spans),
        f"sub-batches not spread over {ncards} devices: {spans}",
    )
    check(multi.last_wave_chunks == nchunks,
          f"device entropy covered {multi.last_wave_chunks}/{nchunks}")
    log(f"4 cards: {len(spans)} sub-batches of {nchunks // len(spans)} "
        f"chunks, devices holding a shard of each: {spans}")
    s_single, single_s = _timed(lambda: single.compress(vol, "pwe", tol))
    check(s_multi == s_single, "four-card stream differs from one-device")
    rec, _ = Sperr3DDecompressor(precision=64).decompress(s_multi)
    err = _max_err(rec.reshape(vol.shape), vol)
    check(err <= tol, f"four-card stream: f64 decode max|err| {err} > {tol}")
    log(f"4 cards: {nx}x{ny}x{nz} ({nchunks} chunks) stream == one-device "
        f"stream ({len(s_multi)} B), f64 decode max|err|={err:.6g} <= {tol}")
    log(f"4 cards [{card}] timing: encode first call {first_s:.3f} s, warm "
        f"{multi_s:.3f} s; one-device mesh first call {single_s:.3f} s")
    return {"encode_s": multi_s, "one_device_first_call_s": single_s,
            "batch_devices": spans, "max_err": err}


def _peak_bytes():
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the four-card chunk-mesh path and its one-device "
        "comparison",
    )
    args = ap.parse_args(argv)
    compile_cache.enable(REPO)
    dev = phase_device(4 if args.four_cards else 1)
    card = dev.pop("card")

    if args.four_cards:
        phase_four_cards(FOUR_CARD_DIMS, CHUNK, TOL, card=card)
    else:
        from bench import load_config

        vol, source = load_config("nyx")
        check(vol.shape == NYX_DIMS[::-1], f"nyx volume shape {vol.shape}")
        log(f"input: nyx {'x'.join(map(str, NYX_DIMS))} f32 ({source}), "
            f"PWE {TOL}")
        enc = phase_encode(vol, CHUNK, TOL)
        dec = phase_decode(enc.pop("stream"), vol, CHUNK, TOL)
        phase_dense(CHUNK[0], TOL)
        phase_2d(1024, 1024, 4, TOL)
        phase_cli(vol, CHUNK, TOL, os.path.join(REPO, ".smoke_tmp"))
        phase_kernels(CHUNK[0], 8, TOL, card=card)
        gb = vol.nbytes / 1e9
        h, f = dec["hybrid"], dec["host_parse"]
        log(f"H [{card}] encode 512^3 wave: {enc['encode_s']:.3f} s "
            f"({gb / enc['encode_s']:.3f} GB/s), first call "
            f"{enc['encode_first_call_s']:.3f} s (compile ~"
            f"{enc['encode_first_call_s'] - enc['encode_s']:.3f} s set-up)")
        log(f"H [{card}] decode 512^3 to host: hybrid {h['decode_s']:.3f} s "
            f"({gb / h['decode_s']:.3f} GB/s, first call "
            f"{h['decode_first_call_s']:.3f} s); full host parse "
            f"{f['decode_s']:.3f} s ({gb / f['decode_s']:.3f} GB/s, first "
            f"call {f['decode_first_call_s']:.3f} s)")
        log(f"H [{card}] peak device memory: {_peak_bytes()} bytes")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
