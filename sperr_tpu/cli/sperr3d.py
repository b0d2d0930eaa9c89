"""sperr3d: compress / decompress a 3D volume (CLI parity with the reference).

Produces/consumes the SPERR3D container stream (header + per-chunk streams;
utilities/sperr3d.cpp).  `--exec tpu` runs the dense stages device-batched
(parallel/batched.py); `--exec host` uses the exact f64 host engine whose
streams are byte-identical to the reference.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..stream import tools
from .common import die, print_stats, read_floats, write_array


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sperr3d", description=__doc__)
    p.add_argument("filename")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("-c", action="store_true", help="compress")
    g.add_argument("-d", action="store_true", help="decompress")
    p.add_argument("--ftype", type=int, default=32, choices=(32, 64))
    p.add_argument("--dims", type=int, nargs=3, metavar=("NX", "NY", "NZ"))
    p.add_argument("--chunks", type=int, nargs=3, default=(256, 256, 256))
    p.add_argument("--omp", type=int, default=0, help="host threads (0 = all)")
    p.add_argument("--exec", dest="exec_mode", default="host", choices=("host", "tpu"))
    p.add_argument(
        "--precision", type=int, default=64, choices=(32, 64),
        help="host pipeline precision: 64 = reference-bit-exact, 32 = fast",
    )
    p.add_argument("--bitstream", default="")
    p.add_argument("--decomp_f", default="")
    p.add_argument("--decomp_d", default="")
    p.add_argument("--decomp_lowres_f", default="")
    p.add_argument("--decomp_lowres_d", default="")
    p.add_argument("--print_stats", action="store_true")
    q = p.add_mutually_exclusive_group()
    q.add_argument("--pwe", type=float, default=0.0)
    q.add_argument("--psnr", type=float, default=0.0)
    q.add_argument("--bpp", type=float, default=0.0)
    q.add_argument(
        "--dq", type=float, default=0.0,
        help="experimental: provide the quantization step q directly "
        "(reference's EXPERIMENTING --dq, utilities/sperr3d.cpp:196-203)",
    )
    return p


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.c:
        if not args.dims:
            die("--dims required for compression")
        nx, ny, nz = args.dims
        data = read_floats(args.filename, args.ftype)
        if data.size != nx * ny * nz:
            die("Input file size wrong!")
        if args.pwe:
            mode, quality = "pwe", args.pwe
        elif args.psnr:
            mode, quality = "psnr", args.psnr
        elif args.bpp:
            mode, quality = "rate", args.bpp
        elif args.dq:
            mode, quality = "directq", args.dq
        else:
            die("one of --pwe/--psnr/--bpp/--dq is required")

        vol = data.reshape(nz, ny, nx)
        if args.exec_mode == "tpu":
            from ..parallel.batched import TpuCompressor3D

            comp = TpuCompressor3D((nx, ny, nz), tuple(args.chunks))
            stream = comp.compress(vol, mode, quality)
        else:
            from ..parallel.chunked3d import Sperr3DCompressor

            comp = Sperr3DCompressor(
                (nx, ny, nz), tuple(args.chunks), num_threads=args.omp,
                precision=args.precision,
            )
            stream = comp.compress(vol, mode, quality)

        if args.bitstream:
            with open(args.bitstream, "wb") as f:
                f.write(stream)
        if args.print_stats and args.exec_mode == "tpu":
            # PWE certification surface (parallel/batched.py pwe_strict=True
            # dual mode): chunks listed here carry the f64-decoder bound
            # only — the shipped f32 device decoder is not certified for
            # them (mirrors the reference's per-chunk error surface,
            # SPERR3D_OMP_C.cpp:132-135).
            wav = getattr(comp, "last_wave_chunks", 0)
            unc = getattr(comp, "last_uncertified_ids", [])
            print(f"Device engine: device-entropy chunks = {wav}")
            if mode == "pwe":
                if unc:
                    print(
                        f"PWE f32-decoder certification: {len(unc)} chunk(s) "
                        f"NOT certified (f64 bound still holds): ids {unc}"
                    )
                else:
                    print(
                        "PWE bound certified for both f64 and f32 device "
                        "decoders (all chunks)"
                    )
        if args.print_stats or args.decomp_f or args.decomp_d:
            recon = _decompress(bytes(stream), args)[0].reshape(-1)
            if args.decomp_f:
                write_array(args.decomp_f, recon, np.float32)
            if args.decomp_d:
                write_array(args.decomp_d, recon, np.float64)
            if args.print_stats:
                if args.ftype == 32:
                    print_stats(data, recon.astype(np.float32), len(stream))
                else:
                    print_stats(data, recon, len(stream))
        return 0

    with open(args.filename, "rb") as f:
        stream = f.read()
    recon, dims, hierarchy = _decompress_full(stream, args)
    if args.decomp_f:
        write_array(args.decomp_f, recon, np.float32)
    if args.decomp_d:
        write_array(args.decomp_d, recon, np.float64)
    if hierarchy:
        from ..utils.dims import coarsened_resolutions_chunked

        h = tools.parse_header(stream)
        for arr, res in zip(
            hierarchy, coarsened_resolutions_chunked(h.vol_dims, h.chunk_dims)
        ):
            tag = f"{res[0]}x{res[1]}x{res[2]}"
            if args.decomp_lowres_f:
                write_array(f"{args.decomp_lowres_f}.{tag}", arr, np.float32)
            if args.decomp_lowres_d:
                write_array(f"{args.decomp_lowres_d}.{tag}", arr, np.float64)
    return 0


def _decompress(stream: bytes, args):
    if args.exec_mode == "tpu":
        from ..parallel.batched import TpuDecompressor3D

        return TpuDecompressor3D().decompress(stream)
    from ..parallel.chunked3d import Sperr3DDecompressor

    return Sperr3DDecompressor(
        num_threads=args.omp, precision=args.precision
    ).decompress(stream)


def _decompress_full(stream: bytes, args):
    multi = bool(args.decomp_lowres_f or args.decomp_lowres_d)
    if args.exec_mode == "tpu" and not multi:
        from ..parallel.batched import TpuDecompressor3D

        out, dims = TpuDecompressor3D().decompress(stream)
        return out, dims, []
    from ..parallel.chunked3d import Sperr3DDecompressor

    dec = Sperr3DDecompressor(num_threads=args.omp, precision=args.precision)
    out, dims = dec.decompress(stream, multi_res=multi)
    return out, dims, dec.hierarchy


if __name__ == "__main__":
    raise SystemExit(run())
