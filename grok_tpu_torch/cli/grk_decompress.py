"""grk_decompress — JPEG 2000 decoder CLI.

Parity: src/bin/jp2/GrkDecompress.cpp (SURVEY.md §2.2): -i -o -r -l -d -t
-p -f (force RGB) -u (upsample) -s (split PNM) -c (TIFF compression) -y -a
-O -H -e -v.

The decode runs on the card (`--device cuda`, the default, with
`--backend device`); without a CUDA device that exits with an error, and
`--device cpu` runs the kernels' plain PyTorch versions instead.
"""

from __future__ import annotations

import argparse
import logging
import sys

from .. import codec
from ..device import resolve_device
from ..errors import GrkError, ParamError
from ..io import formats
from ..params import DecompressParams
from . import common

log = logging.getLogger("grok_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="grk_decompress",
        description="JPEG 2000 decoder on an NVIDIA GPU (grok_tpu_torch)")
    p.add_argument("-i", "--in-file")
    p.add_argument("-o", "--out-file")
    p.add_argument("-y", "--batch-src", help="input directory (batch mode)")
    p.add_argument("-a", "--out-dir", help="output directory (batch mode)")
    p.add_argument("-O", "--out-fmt", default="png")
    p.add_argument("-r", "--reduce", type=int, default=0,
                   help="discard this many highest resolution levels")
    p.add_argument("-l", "--layers", type=int, default=0,
                   help="decode at most this many quality layers")
    p.add_argument("-d", "--decode-window", type=common.parse_window,
                   default=None, help="decode region x0,y0,x1,y1")
    p.add_argument("-t", "--tile", type=int, default=None,
                   help="decode a single tile")
    p.add_argument("-p", "--precision",
                   help="force output precision per component, e.g. 8,8,8")
    p.add_argument("-f", "--force-rgb", action="store_true")
    p.add_argument("-u", "--upsample", action="store_true")
    p.add_argument("-s", "--split-pnm", action="store_true")
    p.add_argument("-c", "--compression", default=None,
                   help="TIFF output compression (e.g. tiff_lzw)")
    p.add_argument("-I", "--apply-icc", action="store_true",
                   help="apply embedded ICC profile (convert to sRGB)")
    p.add_argument("--strict", action="store_true",
                   help="fail on malformed streams instead of tolerating")
    p.add_argument("-H", "--num-threads", type=int, default=0)
    p.add_argument("-e", "--repetitions", type=int, default=1)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace to DIR: the "
                   "card's kernels and copies beside the codec's grk/ phase "
                   "spans (grk/encode, grk/decode and their phases, "
                   "grk/gc/gen<N> for collector pauses)")
    p.add_argument("-j", "--duration", type=float, default=None,
                   help="repeat for at least this many seconds (benchmark)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-W", "--logfile", default=None)
    p.add_argument("--backend", default="device",
                   choices=["auto", "native", "python", "device"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where --backend device runs: the card, or the "
                        "kernels' plain PyTorch versions on the CPU")
    p.add_argument("--max-pixels", type=int, default=0,
                   help="refuse decodes whose output exceeds this many "
                        "pixels (resource limit for untrusted streams)")
    p.add_argument("--num-hosts", type=int, default=0,
                   help="multi-host batch: total hosts (0 = use "
                        "torch.distributed when initialized)")
    p.add_argument("--host-id", type=int, default=0,
                   help="multi-host batch: this host's index")
    return p


def params_from_args(args) -> DecompressParams:
    dp = DecompressParams()
    dp.reduce = args.reduce
    dp.max_layers = args.layers
    dp.window = args.decode_window
    dp.tile_index = args.tile
    dp.strict = args.strict
    dp.force_rgb = args.force_rgb
    dp.upsample = args.upsample
    dp.split_pnm = args.split_pnm
    dp.apply_icc = args.apply_icc
    dp.num_threads = args.num_threads
    dp.backend = args.backend
    dp.max_pixels = args.max_pixels
    if args.precision:
        dp.precision = [int(x) for x in args.precision.split(",")]
    return dp


def _try_stream_strips(data: bytes, out_path: str, args, dp) -> bool:
    """Strip-streamed decode -> async PNM writer (FileUringIO/StripCache
    parity): file I/O overlaps decode.  Returns False when the request
    needs the whole-image path (post-ops, other formats, benchmarking)."""
    import os

    if os.path.splitext(out_path)[1].lower() not in (".pgm", ".ppm", ".pnm"):
        return False
    if (args.repetitions != 1 or args.duration or args.profile
            or args.split_pnm or args.force_rgb or args.upsample
            or args.apply_icc or args.precision
            or args.tile is not None or args.decode_window is not None):
        return False
    hi = codec.read_header(data, strict=dp.strict)
    comps = hi.image.comps
    if len(comps) not in (1, 3) or hi.image.meta.palette is not None:
        return False
    # The strip path bypasses codec._postprocess: any color conversion
    # (sYCC/eYCC/CIELab) or cdef channel reordering it would apply must
    # force the whole-image path, else raw planes leak into the PNM.
    from ..image import ColorSpace
    if hi.image.color_space not in (ColorSpace.SRGB, ColorSpace.GRAY,
                                    ColorSpace.UNKNOWN):
        return False
    if hi.image.meta.channel_definitions:
        return False
    if any(c.sgnd or c.prec > 16 or c.dx != 1 or c.dy != 1 for c in comps):
        return False
    if len({c.prec for c in comps}) != 1:
        return False  # mixed precisions need the whole-image scaler
    import time

    from ..io.stripio import AsyncStripWriter

    t0 = time.perf_counter()
    w, h, _ = hi.reduced_dims(dp.reduce)
    with AsyncStripWriter(out_path, w, h, len(comps),
                          comps[0].prec) as wr:
        for _, strip in codec.decompress_strips(data, dp, header=hi,
                                                device=args.device):
            wr.write_strip(strip)
    log.info("%s (strip-streamed): %.2f MP/s",
             out_path, w * h * len(comps) / 1e6 / (time.perf_counter() - t0))
    return True


def decompress_one(in_path: str, out_path: str, args) -> None:
    dp = params_from_args(args)
    import mmap

    # map rather than slurp: on the strip-streaming path only the pages
    # actually read fault in, keeping gigapixel decodes O(strip)
    with open(in_path, "rb") as f:
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            data = memoryview(mm)
        except (ValueError, OSError):  # empty file / no mmap support
            data = f.read()

    strip_failed = False
    try:
        if _try_stream_strips(data, out_path, args, dp):
            return
    except (GrkError, ValueError, IOError) as e:
        strip_failed = True  # a partial output file may exist
        log.warning("strip streaming unavailable (%s); whole-image path", e)

    def do():
        return codec.decompress(data, dp, device=args.device)

    try:
        img, times = common.run_repeated(do, args.repetitions,
                                         args.duration,
                                         profile_dir=args.profile)
    except GrkError:
        if strip_failed:
            # don't leave a plausible-looking truncated image from the
            # aborted strip fast path when the decode failed outright
            import os

            try:
                os.unlink(out_path)
            except OSError:
                pass
        raise
    formats.save_image(img, out_path, split_pnm=args.split_pnm,
                       tiff_compression=args.compression)
    mp = sum(c.data.size for c in img.comps) / 1e6
    log.info("%s -> %s: %.2f MP/s (best of %d)",
             in_path, out_path, mp / min(times), len(times))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    common.setup_logging(args.verbose, args.logfile)
    try:
        if args.backend == "device":
            resolve_device(args.device)  # no card: an error, not the CPU
    except RuntimeError as e:
        print(f"grk_decompress: error: {e}", file=sys.stderr)
        return 1
    try:
        if args.batch_src:
            if not args.out_dir:
                raise ParamError("batch mode requires -a out_dir")
            exts = {".j2k", ".j2c", ".jp2", ".jpc", ".jph", ".jhc"}
            pairs = list(common.batch_inputs(
                args.batch_src, args.out_dir, args.out_fmt, exts))
            pairs = common.shard_pairs(pairs, args.num_hosts, args.host_id)
            failures = 0
            for src, dst in pairs:
                try:
                    decompress_one(src, dst, args)
                except (GrkError, OSError, ValueError) as e:
                    # one bad file must not abort the batch (reference
                    # batch mode logs and continues)
                    log.error("%s: %s", src, e)
                    failures += 1
            return 1 if failures else 0
        if not args.in_file or not args.out_file:
            raise ParamError("need -i and -o (or -y/-a batch mode)")
        decompress_one(args.in_file, args.out_file, args)
    except (GrkError, OSError, ValueError) as e:
        # ValueError: malformed numeric option values (e.g. -p 8,foo)
        # must print a clean CLI error, not a traceback
        print(f"grk_decompress: error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
