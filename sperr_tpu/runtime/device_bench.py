"""On-device stage timing with dispatch and transfer excluded.

Every timing here wraps the stage in a jitted `lax.fori_loop` that
re-applies it K times with a data dependency (a numerically-negligible
scalar folded back into the input so XLA cannot hoist the loop body), keeps
all operands device-resident, synchronizes by fetching the loop's scalar
result, and divides out K.  Dispatch/transfer constants cancel via
(t_K - t_1)/(K-1).  Replacing this ladder with `block_until_ready` timing
plus a profiler-trace reduction is on the ROADMAP.

The reference's analog of this measurement is its per-stage timing tables
(reference evaluations/May_11/512_cube.result: XForm vs SPECK seconds at
512^3); here the stages are the device halves of the pipeline.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import jax
import jax.numpy as jnp
import numpy as np


def _dep_scalar(y):
    """A scalar data-dependent on EVERY element of every leaf of y.

    Must be a position-weighted full reduction: consuming only y[0] lets
    XLA's simplifier rewrite the stage itself (slice(sort) -> reduce-min,
    slice-mover through elementwise chains), and a plain sum can be
    simplified through permutations — both silently turn the measured
    stage into a sliver of itself (observed: 16.7M-element sorts "timing"
    at 0 ms)."""
    leaves = jax.tree_util.tree_leaves(y)
    acc = None
    for leaf in leaves:
        flat = jnp.ravel(leaf)
        w = (jnp.arange(flat.shape[0], dtype=jnp.int32) & 7).astype(jnp.float32)
        v = jnp.sum(flat.astype(jnp.float32) * w)
        acc = v if acc is None else acc + v
    return acc


def _loop_fn(fn: Callable, iters: int):
    @jax.jit
    def run(x):
        def body(_, carry):
            x, acc = carry
            y = fn(x)
            s = _dep_scalar(y)
            # fold the dependency back in so the loop body can't be hoisted
            # as loop-invariant: floats get a tiny (above-denormal-flush)
            # additive term; integers get a 0/1 perturbation — a cast of
            # 1e-30 to an int dtype is exactly 0, which WOULD hoist
            if jnp.issubdtype(x.dtype, jnp.floating):
                pert = (s * jnp.float32(1e-30)).astype(x.dtype)
            else:
                pert = (jnp.abs(s).astype(jnp.int32) & 1).astype(x.dtype)
            return x + pert, acc + s.astype(jnp.float32)

        _, acc = jax.lax.fori_loop(
            0, iters, body, (x, jnp.float32(0.0))
        )
        # scalar output: the caller synchronizes by fetching it
        return acc

    return run


def time_stage(fn: Callable, x, iters: int = 8, reps: int = 2,
               max_iters: int = 128) -> float:
    """Seconds per application of `fn` on device, dispatch excluded.

    Synchronizes by fetching the loop's scalar accumulator (see _loop_fn).
    Adaptive: the per-iteration cost is the marginal (t_K - t_1)/(K - 1);
    for sub-ms stages dispatch jitter can swamp that difference, so K grows
    until the K-iteration run is decisively longer than the 1-iteration run
    (or max_iters is reached)."""
    x = jax.device_put(x)
    run_1 = _loop_fn(fn, 1)
    float(run_1(x))  # compile + warm
    t1 = min(_timed(lambda: float(run_1(x))) for _ in range(reps))
    k = max(2, iters)
    while True:
        run_k = _loop_fn(fn, k)
        float(run_k(x))
        tk = min(_timed(lambda: float(run_k(x))) for _ in range(reps))
        # signal must dominate the constant's jitter (~25% of t1 + 2ms).
        # Every k is a fresh compile (static fori_loop length), so the
        # ladder stays short; at max_iters the result is an upper bound on
        # a stage that is already negligibly small.
        if tk - t1 > max(0.25 * t1, 2e-3) or k >= max_iters:
            return max((tk - t1) / (k - 1), 1e-9)
        k *= 4


def _timed(thunk) -> float:
    t0 = time.perf_counter()
    thunk()
    return time.perf_counter() - t0


def time_stage_coarse(fn: Callable, x, reps: int = 3) -> float:
    """Wall seconds per application for MULTI-SECOND stages: one jitted
    (fn + dep-scalar) program, no fori ladder (a loop-wrapped 8-chunk scan
    program is the heaviest compile in the codec).  The dispatch+fetch
    constant is measured with a trivial program and subtracted; for a
    >~1 s stage it is a few percent."""
    x = jax.device_put(x)

    @jax.jit
    def run(v):
        return _dep_scalar(fn(v))

    @jax.jit
    def nop(v):
        return jnp.float32(1.0) + v.reshape(-1)[0].astype(jnp.float32)

    float(run(x))  # compile + warm
    float(nop(x))
    const = min(_timed(lambda: float(nop(x))) for _ in range(reps))
    t = min(_timed(lambda: float(run(x))) for _ in range(reps))
    return max(t - const, 1e-9)


def pipeline_stages(n: int = 256, batch: int = 1, tol: float = 1e-2,
                    iters: int = 8) -> Dict[str, float]:
    """Per-stage device seconds for one (batch, n^3) f32 chunk batch.

    Stages: fwd DWT, midtread quantize, inverse DWT, the dense encode core
    (condition -> DWT -> quantize -> compaction -> PWE residual scan), and
    the decode core (invquant -> IDWT -> +mean).  Returns seconds per stage
    plus derived GB/s over the batch bytes.
    """
    from ..ops import cdf97_jax as cdfj
    from ..ops import quantize_jax as qzj
    from ..parallel.batched import _encode_core

    rng = np.random.default_rng(3)
    vol = rng.normal(size=(batch, n, n, n)).astype(np.float32)
    x = jnp.asarray(vol)
    nbytes = vol.nbytes
    nelems = batch * n * n * n
    cap = max(1024, nelems // batch // 4)
    out_cap = max(256, (n * n * n) // 64)

    q = jnp.full((batch,), 1.5 * tol, dtype=jnp.float32)

    def quant(y):
        flat = y.reshape(batch, -1)
        return qzj.midtread_quantize_batched(flat, q)

    def enc_dense(y):
        # the transfer="dense" encode: condition -> DWT -> quantize ->
        # decoder-exact dual residual — pure math, no device compaction
        from ..parallel.batched import _dense_encode

        return _dense_encode(y, "pwe", float(tol), "dual")

    def enc_sparse(y):
        # the transfer="sparse" encode: + on-device nonzero/outlier
        # compaction (stream-sized transfers at the cost of large-array
        # sorts on the device)
        out, _ = _encode_core(y, "pwe", float(tol), cap, out_cap, "dual")
        return out

    def dec_core(y):
        flat = y.reshape(batch, -1)
        ll = jnp.rint(flat * (1.0 / q)[:, None]).astype(jnp.int32)
        mags, signs = jnp.abs(ll), ll >= 0
        rec = qzj.midtread_inv_quantize_batched(mags, signs, q)
        rec = cdfj.idwt3d(rec.reshape(y.shape))
        return rec + jnp.float32(0.125)

    stages = {
        "dwt3d": lambda y: cdfj.dwt3d(y),
        "idwt3d": lambda y: cdfj.idwt3d(y),
        "quantize": quant,
        "encode_core_dense": enc_dense,
        "encode_core_sparse": enc_sparse,
        "decode_core": dec_core,
    }
    out: Dict[str, float] = {"n": n, "batch": batch, "bytes": nbytes}
    for name, fn in stages.items():
        secs = time_stage(fn, x, iters=iters)
        out[name + "_s"] = round(secs, 5)
        out[name + "_gbps"] = round(nbytes / secs / 1e9, 3)
    out["device_encode_gbps"] = out["encode_core_dense_gbps"]
    out["device_decode_gbps"] = out["decode_core_gbps"]
    return out


def container_decode_stages(n: int = 256, tol: float = 1e-2,
                            iters: int = 4, chunks: int = 1) -> Dict[str, float]:
    """Honest full-container decode cost for ``chunks`` distinct n^3
    chunks: host SPECK parse (wall clock, this host's cores, summed over
    chunks) + device reconstruction (invquant -> IDWT -> +mean,
    stage-timed, batched over the chunks — the production decoder's
    shape).  chunks=8 at n=256 is the 512^3 flagship container.

    Every stream byte is consumed.  The hybrid sub-result measures the
    split TpuDecompressor3D ships: control-only host parse + device
    refinement distribution/magnitude reconstruction."""
    import time as _time

    from ..ops import cdf97_jax as cdfj
    from ..ops import cdf97_np
    from ..ops import quantize_jax as qzj
    from .engine import default_engine

    B = chunks
    vols = _smooth_field(n, B).astype(np.float64)
    eng = default_engine()
    q = 1.5 * tol
    bodies = []
    lls = np.empty((B, n * n * n), np.int32)
    means = np.empty(B)
    width = 8
    for b in range(B):
        v = vols[b]
        means[b] = v.mean()
        coeffs = cdf97_np.dwt3d(v - means[b])
        ll = np.rint(coeffs / q)
        mags = np.abs(ll).astype(np.int64)
        mm = int(mags.max())
        width = max(width, 8 if mm < 256 else 16 if mm < 65536 else 32)
        lls[b] = ll.ravel().astype(np.int32)
    for b in range(B):
        mags = np.abs(lls[b]).astype(np.int64)
        bodies.append(
            eng.encode(3, mags, lls[b] >= 0, (n, n, n), width, 0)
        )

    def _best_wall(fn, reps=3):
        ts = []
        for _ in range(reps):
            t0 = _time.perf_counter()
            fn()
            ts.append(_time.perf_counter() - t0)
        return min(ts)

    parse_s = _best_wall(
        lambda: [eng.decode(3, bo, (n, n, n), width) for bo in bodies]
    )

    x = jnp.asarray(lls)
    qf = jnp.full((B,), q, np.float32)
    mean_dev = jnp.asarray(means.astype(np.float32))

    def dec(v):
        m = jnp.abs(v)
        g = v >= 0
        rec = qzj.midtread_inv_quantize_batched(m, g, qf)
        rec = cdfj.idwt3d(rec.reshape(B, n, n, n))
        return rec + mean_dev[:, None, None, None]

    core_s = time_stage(dec, x, iters=iters)
    nbytes = B * n * n * n * 4
    total = parse_s + core_s
    out = {
        "n": n,
        "chunks": B,
        "stream_bytes": sum(len(bo) for bo in bodies),
        "parse_s": round(parse_s, 5),
        "decode_core_s": round(core_s, 5),
        "decode_total_s": round(total, 5),
        "decode_total_gbps": round(nbytes / total / 1e9, 3),
        "host_cores_for_parse": 1,
    }

    # Hybrid split (TpuDecompressor3D's default on accelerators): host parses
    # ONLY the LIP/LIS control bits (refinement segments skipped — lengths
    # are the LSP population), the device distributes refinement bits
    # (PDEP) and reconstructs magnitudes + invquant + IDWT, batched over
    # the chunks exactly like the production decoder.  Exact-equality with
    # the full parse is asserted in tests/test_wave_unpack.py.
    if hasattr(eng, "decode3d_control"):
        from ..parallel.batched import _hybrid_mags_batched

        ctrl_s = _best_wall(
            lambda: [
                eng.decode3d_control(bo, (n, n, n), width)
                for bo in bodies
            ]
        )
        ctrls = [
            eng.decode3d_control(bo, (n, n, n), width) for bo in bodies
        ]
        nbp_max = max(c[4] for c in ctrls)
        if nbp_max > 32:
            raise RuntimeError("hybrid decode covers <= 32 bitplanes")
        p_cap = 16 if nbp_max <= 16 else 32
        nelems = n * n * n
        evw_cap = max(1 << 16, nelems // 64)
        Wmax = max((len(bo) - 9 + 11) // 4 for bo in bodies)
        spb = np.stack([c[0] for c in ctrls])
        sgb = np.stack([c[1] for c in ctrls])
        rof = np.zeros((B, 32), np.int32)
        rav = np.zeros((B, 32), np.int32)
        nbps = np.zeros(B, np.int32)
        wmat = np.zeros((B, Wmax), np.uint32)
        for b, (c, bo) in enumerate(zip(ctrls, bodies)):
            nbps[b] = c[4]
            rof[b, : c[4]] = c[2].astype(np.int64)
            rav[b, : c[4]] = c[3].astype(np.int64)
            wrd = np.frombuffer(
                bytes(bo[9:]) + b"\0" * ((-(len(bo) - 9)) % 4 + 8),
                dtype="<u4",
            )
            wmat[b, : wrd.size] = wrd
        dev = dict(
            words=jax.device_put(jnp.asarray(wmat)),
            roff=jax.device_put(jnp.asarray(rof)),
            ravail=jax.device_put(jnp.asarray(rav)),
            nbps=jax.device_put(jnp.asarray(nbps)),
            sgn=jax.device_put(jnp.asarray(sgb)),
        )

        def dec_hybrid(sp):
            m, _ovf = _hybrid_mags_batched(
                sp, dev["words"], dev["roff"], dev["ravail"],
                dev["nbps"], p_cap, evw_cap,
            )
            rec = qzj.midtread_inv_quantize_batched(m, dev["sgn"], qf)
            rec = cdfj.idwt3d(rec.reshape(B, n, n, n))
            return rec + mean_dev[:, None, None, None], _ovf

        # the hybrid number may substitute into the headline decode
        # total below, so an active-word overflow (which would make the
        # reconstruction silently wrong) must block, not pass: verify
        # the cap holds before timing
        _, ovf0 = jax.jit(dec_hybrid)(jnp.asarray(spb.astype(np.int32)))
        if bool(np.asarray(jax.device_get(ovf0)).any()):
            raise RuntimeError(
                "hybrid decode active-word cap overflow (evw_cap "
                f"{evw_cap}) — refusing to report a wrong-answer timing"
            )

        hyb_core = time_stage(
            dec_hybrid, jnp.asarray(spb.astype(np.int32)), iters=iters
        )
        hyb_total = ctrl_s + hyb_core
        out["hybrid"] = {
            "control_parse_s": round(ctrl_s, 5),
            "device_s": round(hyb_core, 5),
            "decode_total_s": round(hyb_total, 5),
            "decode_total_gbps": round(nbytes / hyb_total / 1e9, 3),
        }
        if hyb_total < total:
            out["decode_total_s"] = round(hyb_total, 5)
            out["decode_total_gbps"] = round(nbytes / hyb_total / 1e9, 3)
    return out


def wave2d_stage(nx: int = 1024, ny: int = 1024, batch: int = 4,
                 tol: float = 1e-2, iters: int = 4) -> Dict[str, float]:
    """2D device pipeline: B Turbulence1024-like fields encoded as one
    jitted program — dense core (condition -> 2D DWT -> quantize -> PWE
    dual residual) and the full device entropy stage
    (parallel/batched2d._dense_encode2_wave).  The reference's 2D rows
    (BASELINE.md Turbulence1024: 241-881 ms/field at 0.25-4 bpp on one
    core) are the comparison."""
    from ..parallel.batched2d import _dense_encode2, _dense_encode2_wave
    from ..ops import speck_jax as sj
    from ..ops import speck_lis2_jax as sl2
    from ..codec.speck_wave import build_tree2

    out_f = smooth_fields_2d(nx, ny, batch)
    x = jnp.asarray(out_f)
    n = nx * ny
    cap = max(1024, n // 2)
    out_cap = max(256, n // 64)
    # prebuild static indexes outside the trace
    sj.tree_index((nx, ny))
    sl2.lis2_index((nx, ny))
    build_tree2((nx, ny))
    node_cap = max(4096, n // 8)
    ev_cap = 4 * n
    wave_cap = n // 2

    def dense(y):
        return _dense_encode2(y, "pwe", float(tol), cap, out_cap, "dual")

    def wave(y):
        return _dense_encode2_wave(
            y, "pwe", float(tol), cap, out_cap, 16, (nx, ny), "dual",
            node_cap, ev_cap, wave_cap,
        )

    td = time_stage(dense, x, iters=iters)
    tw = time_stage(wave, x, iters=iters)
    return {
        "nx": nx, "ny": ny, "batch": batch,
        "dense_core_s": round(td, 5),
        "wave_total_s": round(tw, 5),
        "per_field_ms": round(tw / batch * 1e3, 3),
        "wave_encode_gbps": round(out_f.nbytes / tw / 1e9, 3),
    }


def smooth_fields_2d(nx: int, ny: int, batch: int,
                     seed: int = 5) -> np.ndarray:
    """B distinct Turbulence1024-like smooth 2D fields, f32 (B, ny, nx):
    superposed separable modes plus sub-tolerance noise."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, max(nx, ny), dtype=np.float32)
    out_f = np.empty((batch, ny, nx), dtype=np.float32)
    for b in range(batch):
        f = np.zeros((ny, nx), np.float32)
        for _ in range(24):
            fx, fy = rng.uniform(0.5, 8.0, 2)
            px, py = rng.uniform(0, 2 * np.pi, 2)
            a = np.float32(rng.normal(scale=0.4))
            f += a * (
                np.sin(2 * np.pi * fy * t[:ny] + py)[:, None]
                * np.sin(2 * np.pi * fx * t[:nx] + px)[None, :]
            )
        f += rng.normal(scale=0.001, size=f.shape).astype(np.float32)
        out_f[b] = f
    return out_f


def _smooth_field(n: int, batch: int = 1, seed: int = 7,
                  noise: float = 0.001) -> np.ndarray:
    """Superposed low-frequency separable modes + sub-tolerance noise: the
    operating regime of error-bounded compression (mirrors bench.py's
    make_volume).  Batch elements are DISTINCT fields (different random
    modes), so a batched measurement does real per-chunk work.  ``noise``
    above the tolerance moves the regime dense (bpp scales with
    noise/tol)."""
    from ..utils.testdata import smooth_field

    rng = np.random.default_rng(seed)
    out = np.empty((batch, n, n, n), dtype=np.float32)
    for b in range(batch):
        out[b] = smooth_field((n, n, n), noise=noise, rng=rng)
    return out


def wave_entropy_stage(n: int = 64, batch: int = 1, tol: float = 1e-2,
                       iters: int = 4, noisy: bool = False,
                       regime: str = None) -> Dict[str, float]:
    """Device seconds for the wave-entropy encode (full SPECK bit work on
    device) vs the dense core alone; the difference is the entropy stage.

    ``regime``:
      "smooth" (default) — the production tier-0 capacities on a smooth
        field: the configuration and regime the driver actually runs for
        the headline workload;
      "dense"  — smooth field + noise at ~2.5x the tolerance (~2 bpp,
        the reference baselines' rate band), at the tier the retry
        ladder would land on;
      "noisy"  — white noise (every cap saturated), at its landing tier.
    The landing tier is picked the way the driver picks it: the first
    tier whose caps fit (verified on device, reported as ``fits``)."""
    from ..parallel.batched import (
        _dense_encode_wave, _encode_core_wave, wave_tiers_for,
    )

    if regime is None:
        regime = "noisy" if noisy else "smooth"
    if regime == "noisy":
        rng = np.random.default_rng(11)
        vol = rng.normal(size=(batch, n, n, n)).astype(np.float32)
    elif regime == "dense":
        vol = _smooth_field(n, batch, noise=2.5 * tol)
    else:
        vol = _smooth_field(n, batch)
    x = jnp.asarray(vol)
    nelems = n * n * n
    out_cap = max(1024, nelems // 1024)
    num_bp_cap = 34
    tiers = wave_tiers_for(nelems)
    tier_idx = None  # land on the first fitting tier, like the driver
    # pre-build the walk index outside any jit trace (tracer safety)
    from ..ops import speck_jax as sj
    from ..ops import speck_lis_jax as sl
    from ..ops import speck_virtual as svirt

    if svirt._is_pow2_cube((n, n, n)):
        svirt.virtual_lis_index((n, n, n))
    else:
        try:
            sj.pyramid_index((n, n, n))
        except ValueError:
            sj.tree_index((n, n, n))
        sl.lis_index((n, n, n))

    def core(y):
        # the wave program's own dense front (condition -> DWT -> quantize
        # -> PWE dual residual + two-level outlier compaction): the honest
        # baseline for the entropy-stage delta
        out, ll = _encode_core_wave(y, "pwe", float(tol), out_cap, "dual")
        out["ll"] = ll
        return out

    def wave_at(tier):
        def wave(y):
            return _dense_encode_wave(
                y, "pwe", float(tol), out_cap, num_bp_cap, (n, n, n),
                "dual", *tier, sparse_view=False,
            )
        return wave

    # landing tier: the first tier whose caps fit (the driver's retry
    # ladder), verified on device before the timed run
    if tier_idx is None:
        for ti_ in range(len(tiers)):
            w = _dense_encode_wave(
                x, "pwe", float(tol), out_cap, num_bp_cap, (n, n, n),
                "dual", *tiers[ti_], sparse_view=False,
            )["wave"]
            if bool(np.asarray(jax.device_get(w["fits"])).all()):
                tier_idx = ti_
                break
        else:
            tier_idx = len(tiers) - 1
    wave = wave_at(tiers[tier_idx])
    fits = bool(
        np.asarray(
            jax.device_get(wave(x)["wave"]["fits"])
        ).all()
    )

    if batch >= 4:
        # multi-second program: coarse wall timing (no fori ladder — its
        # doubly-nested compile is the heaviest in the codec)
        ts = time_stage_coarse(jax.jit(core), x)
        tw = time_stage_coarse(wave, x)
    else:
        ts = time_stage(jax.jit(core), x, iters=iters)
        tw = time_stage(wave, x, iters=iters)
    return {
        "n": n, "batch": batch,
        "regime": f"{regime}(tier {tier_idx})",
        "transfer": "dense (coefficient-view outputs skipped)",
        "fits": fits,
        "dense_core_s": round(ts, 5),
        "wave_total_s": round(tw, 5),
        "entropy_stage_s": round(max(tw - ts, 0.0), 5),
        "entropy_per_chunk_ms": round(max(tw - ts, 0.0) / batch * 1e3, 3),
        "wave_encode_gbps": round(vol.nbytes / tw / 1e9, 3),
    }
