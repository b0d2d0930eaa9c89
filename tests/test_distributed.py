"""Multi-host gather logic: single-process equivalence + assembly unit tests."""

import jax
import pytest
import numpy as np

from sperr_tpu.parallel import distributed as dist
from sperr_tpu.parallel.chunked3d import Sperr3DCompressor
from sperr_tpu.utils.dims import chunk_volume



pytestmark = pytest.mark.slow  # JAX-compile-heavy (see pytest.ini)

def _vol(nx, ny, nz, seed=31):
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:nz, 0:ny, 0:nx]
    return (np.sin(x * 0.2) * np.cos(y * 0.11) * np.sin(z * 0.21)
            + 0.02 * rng.normal(size=(nz, ny, nx))).astype(np.float32)


def test_single_process_equals_host_driver():
    nx, ny, nz = 40, 30, 50
    vol = _vol(nx, ny, nz)

    def loader(c):
        x0, lx, y0, ly, z0, lz = c
        return vol[z0 : z0 + lz, y0 : y0 + ly, x0 : x0 + lx]

    stream = dist.compress_distributed(
        loader, (nx, ny, nz), (16, 16, 16), "psnr", 65.0, is_float=True,
        pid=0, nprocs=1,
    )
    ref = Sperr3DCompressor((nx, ny, nz), (16, 16, 16)).compress(vol, "psnr", 65.0)
    assert stream == bytes(ref)


def test_multiprocess_assembly_simulated():
    """Simulate N processes locally: each compresses its round-robin chunks;
    the assembled container must equal the single-host stream."""
    nx, ny, nz = 33, 33, 33
    vol = _vol(nx, ny, nz, seed=8)
    chunk_dims = (16, 16, 16)
    chunks = chunk_volume((nx, ny, nz), chunk_dims)
    nprocs = 3

    def loader(c):
        x0, lx, y0, ly, z0, lz = c
        return vol[z0 : z0 + lz, y0 : y0 + ly, x0 : x0 + lx]

    # Per-process local work (what each host would compute).
    from sperr_tpu.codec.speck_flt import SpeckFloatCodec

    payloads, lens = [], np.zeros((nprocs, len(chunks)), dtype=np.int64)
    for p in range(nprocs):
        mine = dist.local_chunk_ids(len(chunks), p, nprocs)
        streams = []
        for i in mine:
            c = chunks[i]
            codec = SpeckFloatCodec(3, (c[1], c[3], c[5]))
            s = codec.compress(
                np.asarray(loader(c), dtype=np.float64).reshape(-1), "psnr", 70.0
            )
            streams.append(s)
            lens[p, i] = len(s)
        payloads.append(b"".join(streams))

    # Assembly (what process 0 does after the DCN gathers).
    all_lens = lens.sum(axis=0)
    ordered = [b""] * len(chunks)
    for p in range(nprocs):
        mine = dist.local_chunk_ids(len(chunks), p, nprocs)
        parts = dist.split_concat(payloads[p], [int(all_lens[i]) for i in mine])
        for k, i in enumerate(mine):
            ordered[i] = parts[k]
    from sperr_tpu.stream import tools

    stream = tools.generate_header(
        (nx, ny, nz), chunk_dims, [len(s) for s in ordered], True
    ) + b"".join(ordered)

    ref = Sperr3DCompressor((nx, ny, nz), chunk_dims).compress(vol, "psnr", 70.0)
    assert stream == bytes(ref)


def test_socket_gather_transport_skewed_sizes():
    """Ordered TCP gather-to-0 with strongly skewed payload sizes: only
    actual bytes travel (no max-padding), order preserved by rank."""
    import threading

    from sperr_tpu.parallel.transport import SocketGatherTransport

    rng = np.random.default_rng(5)
    payloads = [
        bytes(rng.integers(0, 256, size=sz, dtype=np.uint8))
        for sz in (3, 700_001, 0, 64, 1_234_567)
    ]
    nprocs = len(payloads)
    tr = SocketGatherTransport("127.0.0.1:47123", timeout=30.0)
    result = {}

    def run(pid):
        result[pid] = tr.gather_bytes(payloads[pid], pid, nprocs)

    threads = [threading.Thread(target=run, args=(p,)) for p in range(nprocs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert result[0] == payloads
    for p in range(1, nprocs):
        assert result[p] is None


def test_compress_distributed_socket_gather_end_to_end():
    """Full multi-rank compress over the socket transport (each rank on a
    thread): rank 0's container must equal the single-host stream."""
    import threading

    from sperr_tpu.parallel.transport import SocketGatherTransport

    nx, ny, nz = 33, 33, 33
    vol = _vol(nx, ny, nz, seed=8)
    chunk_dims = (16, 16, 16)
    nprocs = 3

    def loader(c):
        x0, lx, y0, ly, z0, lz = c
        return vol[z0 : z0 + lz, y0 : y0 + ly, x0 : x0 + lx]

    out = {}

    def run(pid):
        tr = SocketGatherTransport("127.0.0.1:47124", timeout=60.0)
        out[pid] = dist.compress_distributed(
            loader, (nx, ny, nz), chunk_dims, "psnr", 70.0, is_float=True,
            pid=pid, nprocs=nprocs, transport=tr,
        )

    threads = [threading.Thread(target=run, args=(p,)) for p in range(nprocs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)

    ref = Sperr3DCompressor((nx, ny, nz), chunk_dims).compress(vol, "psnr", 70.0)
    assert out[0] == bytes(ref)
    assert out[1] is None and out[2] is None


class _SimTransport:
    """Sequential-simulation transport: non-root ranks deposit blobs first,
    rank 0 gathers last (test harness for in-process multi-rank runs)."""

    def __init__(self, nprocs):
        self.store = [None] * nprocs

    def gather_bytes(self, payload, pid, nprocs):
        self.store[pid] = payload
        if pid != 0:
            return None
        assert all(b is not None for b in self.store), "rank 0 must run last"
        return list(self.store)


def test_device_engine_composes_with_distributed():
    """N simulated processes, each batching its owned chunks through the
    device pipeline (TpuCompressor3D over the virtual mesh): the assembled
    container must byte-match the single-host device run, and the
    distributed decode must bit-match the single-host decode
    (SPERR3D_OMP_C.cpp:94-130 / SPERR3D_OMP_D.cpp:101-127 across hosts)."""
    from sperr_tpu.parallel import batched

    nx = ny = nz = 32
    vol = _vol(nx, ny, nz, seed=12)
    chunk_dims = (16, 16, 16)
    nprocs = 2

    def loader(c):
        x0, lx, y0, ly, z0, lz = c
        return vol[z0 : z0 + lz, y0 : y0 + ly, x0 : x0 + lx]

    # a 4-device mesh: each rank's 4 chunks shard one per device
    mesh = batched.make_chunk_mesh(jax.devices()[:4])
    factory = dist.device_compressor_factory(chunk_dims, mesh=mesh)
    tr = _SimTransport(nprocs)
    out = {}
    for pid in range(nprocs - 1, -1, -1):  # rank 0 last (sim transport)
        out[pid] = dist.compress_distributed(
            loader, (nx, ny, nz), chunk_dims, "pwe", 1e-3, is_float=True,
            compressor_factory=factory, pid=pid, nprocs=nprocs, transport=tr,
        )
    assert out[1] is None
    # Pin the single-host run to the SAME per-call batch shape the ranks
    # used (4 chunks, one per device; the budget is per device): XLA
    # codegen varies with batch shape by final ulps, so byte-equality is
    # only a sound assertion between runs whose jit calls saw identical
    # shapes.
    single_comp = batched.TpuCompressor3D((nx, ny, nz), chunk_dims, mesh=mesh)
    single_comp.dense_elem_budget = 16 * 16 * 16
    single = single_comp.compress(vol, "pwe", 1e-3)
    assert out[0] == single

    # distributed decode: every rank decodes its chunks, rank 0 assembles
    tr2 = _SimTransport(nprocs)
    dout = {}
    for pid in range(nprocs - 1, -1, -1):
        dout[pid] = dist.decompress_distributed(
            out[0], pid=pid, nprocs=nprocs, transport=tr2
        )
    assert dout[1] is None
    got, dims = dout[0]
    ref, _ = batched.TpuDecompressor3D(mesh=mesh).decompress(out[0])
    assert dims == (nx, ny, nz)
    # The container bytes are the normative invariant (asserted above);
    # the f32 reconstruction may differ by final-ulp across batch
    # partitionings (XLA codegen varies with batch shape), so decode
    # equality is asserted to 1 ulp of the data scale plus the PWE bound.
    assert np.abs(got - ref).max() <= 1e-6
    assert np.abs(got.astype(np.float64) - vol).max() <= 1e-3


def test_decompress_distributed_device_blocks():
    """to_host=False: each rank keeps only its owned chunks device-resident."""
    from sperr_tpu.parallel import batched

    nx = ny = nz = 32
    vol = _vol(nx, ny, nz, seed=4)
    chunk_dims = (16, 16, 16)
    stream = batched.TpuCompressor3D((nx, ny, nz), chunk_dims).compress(
        vol, "psnr", 70.0
    )
    chunks = chunk_volume((nx, ny, nz), chunk_dims)
    nprocs = 2
    seen = set()
    for pid in range(nprocs):
        blocks, dims = dist.decompress_distributed(
            stream, pid=pid, nprocs=nprocs, to_host=False
        )
        mine = dist.local_chunk_ids(len(chunks), pid, nprocs)
        assert set(blocks.keys()) == {dist._key(chunks[i]) for i in mine}
        seen |= set(blocks.keys())
    assert len(seen) == len(chunks)


def test_device_engine_distributed_8rank_production_chunks():
    """Eight simulated ranks at non-toy dims: a 128^3
    volume in 64^3 chunks — the BASELINE NYX configuration's chunk dims —
    one chunk per rank through the device pipeline, byte-identical to the
    single-host container (same per-call batch shapes), plus `only=`
    subsetted decode per rank matching the full reconstruction
    (SPERR3D_OMP_C.cpp:94-130 / SPERR3D_OMP_D.cpp:101-127 across hosts)."""
    from sperr_tpu.parallel import batched

    nx = ny = nz = 128
    vol = _vol(nx, ny, nz, seed=77)
    chunk_dims = (64, 64, 64)
    chunks = chunk_volume((nx, ny, nz), chunk_dims)
    nprocs = 8
    assert len(chunks) == nprocs
    tol = 1e-2

    def loader(c):
        x0, lx, y0, ly, z0, lz = c
        return vol[z0 : z0 + lz, y0 : y0 + ly, x0 : x0 + lx]

    # a one-device mesh, so the single-host run below can be pinned to
    # the ranks' B=1 calls (sub-batch budgets are per device)
    mesh = batched.make_chunk_mesh(jax.devices()[:1])
    factory = dist.device_compressor_factory(chunk_dims, mesh=mesh)
    tr = _SimTransport(nprocs)
    out = {}
    for pid in range(nprocs - 1, -1, -1):  # rank 0 gathers last
        out[pid] = dist.compress_distributed(
            loader, (nx, ny, nz), chunk_dims, "pwe", tol, is_float=True,
            compressor_factory=factory, pid=pid, nprocs=nprocs, transport=tr,
        )
    for pid in range(1, nprocs):
        assert out[pid] is None

    # single host pinned to B=1 sub-batches (each rank ran B=1)
    single_comp = batched.TpuCompressor3D((nx, ny, nz), chunk_dims, mesh=mesh)
    single_comp.dense_elem_budget = 64 * 64 * 64
    single = single_comp.compress(vol, "pwe", tol)
    assert out[0] == single

    # per-rank `only=` subsetted decode: each rank's device-resident blocks
    # must reproduce exactly its owned regions of the full reconstruction
    full, dims = batched.TpuDecompressor3D().decompress(out[0])
    assert dims == (nx, ny, nz)
    assert np.abs(full.astype(np.float64) - vol).max() <= tol
    for pid in range(nprocs):
        blocks, _ = dist.decompress_distributed(
            out[0], pid=pid, nprocs=nprocs, transport=_SimTransport(nprocs),
            to_host=False,
        )
        mine = dist.local_chunk_ids(len(chunks), pid, nprocs)
        assert set(blocks.keys()) == {dist._key(chunks[i]) for i in mine}
        for i in mine:
            c = chunks[i]
            got = np.asarray(blocks[dist._key(c)])
            ref = full[
                c[4] : c[4] + c[5], c[2] : c[2] + c[3], c[0] : c[0] + c[1]
            ]
            # only=-subsetted decode batches fewer chunks than the full
            # decode; XLA codegen varies with batch shape by final ulps, so equality holds to a few ulps of the IDWT
            # accumulation scale and both reconstructions honor the bound
            assert np.abs(got - ref).max() <= 4e-6
            orig = vol[
                c[4] : c[4] + c[5], c[2] : c[2] + c[3], c[0] : c[0] + c[1]
            ]
            assert np.abs(got.astype(np.float64) - orig).max() <= tol
