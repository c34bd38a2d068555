"""grk_compress — JPEG 2000 encoder CLI.

Parity: src/bin/jp2/GrkCompress.cpp (SURVEY.md §2.2): flag letters follow
the reference where they exist (-i -o -r -q -n -b -c -t -p -P -s -M -I -F
-m -R -S -E -u -w -x -U -z -y -a -O -d -T -C -G -H -e -v).

The encode runs on the card (`--device cuda`, the default, with
`--backend device`); without a CUDA device that exits with an error, and
`--device cpu` runs the kernels' plain PyTorch versions instead.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from .. import codec
from ..device import resolve_device
from ..errors import GrkError, ParamError
from ..io import formats
from ..params import (
    CblkStyle,
    CompressParams,
    Profile,
    Progression,
    ProgressionChange,
)
from . import common

log = logging.getLogger("grok_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="grk_compress",
        description="JPEG 2000 encoder on an NVIDIA GPU (grok_tpu_torch)")
    p.add_argument("-i", "--in-file", help="input image file")
    p.add_argument("-o", "--out-file", help="output .j2k/.jp2 file")
    p.add_argument("-y", "--batch-src", help="input directory (batch mode)")
    p.add_argument("-a", "--out-dir", help="output directory (batch mode)")
    p.add_argument("-O", "--out-fmt", default="jp2",
                   help="batch output format (j2k|jp2)")
    p.add_argument("-r", "--compression-ratios",
                   help="layer compression ratios, e.g. 20,10,1")
    p.add_argument("-q", "--quality", help="layer PSNR targets in dB")
    p.add_argument("-n", "--resolutions", type=int, default=6)
    p.add_argument("-b", "--code-block-dims", default="64,64",
                   help="codeblock WxH, e.g. 64,64")
    p.add_argument("-c", "--precinct-dims",
                   help="precinct dims per res, e.g. [256,256],[128,128]")
    p.add_argument("-t", "--tile-dims", help="tile WxH, e.g. 512,512")
    p.add_argument("-T", "--tile-offset", default="0,0")
    p.add_argument("-d", "--image-offset", default="0,0")
    p.add_argument("-p", "--progression-order", default="LRCP",
                   choices=[p_.name for p_ in Progression])
    p.add_argument("-P", "--poc", help="progression changes, "
                   "e.g. T1=0,0,1,5,3,CPRL/T1=0,0,1,5,3,LRCP")
    p.add_argument("-s", "--subsampling-factor", help="dx,dy")
    p.add_argument("-M", "--mode", type=int, default=None,
                   help="codeblock style bitmask (1=lazy 2=reset 4=termall "
                        "8=vsc 16=pterm 32=segsym); default 1 (lazy/bypass"
                        " for throughput), pass 0 for all-MQ coding")
    p.add_argument("-I", "--irreversible", action="store_true")
    p.add_argument("-F", "--raw", help="raw input descriptor "
                   "w,h,ncomp,bitdepth,[s|u]@dx1xdy1:...")
    p.add_argument("--stream-strips", action="store_true",
                   help="stream a binary PGM/PPM input one tile row at a "
                        "time (O(tile row) memory; gigapixel inputs)")
    p.add_argument("-m", "--mct-file",
                   help="custom MCT matrix file (numpy .npy or text)")
    p.add_argument("-Y", "--mct-mode", type=int, choices=[0, 1, 2],
                   help="0=none 1=RCT/ICT 2=custom matrix")
    p.add_argument("-R", "--roi", help="ROI c=comp,U=shift")
    p.add_argument("-S", "--sop", action="store_true", help="SOP markers")
    p.add_argument("-E", "--eph", action="store_true", help="EPH markers")
    p.add_argument("-u", "--tile-parts", choices=["R", "L", "C"],
                   help="generate tile-parts by resolution/layer/component")
    p.add_argument("-w", "--cinema2k", type=int, choices=[24, 48],
                   help="Cinema 2K profile at fps")
    p.add_argument("-x", "--cinema4k", action="store_true",
                   help="Cinema 4K profile (24 fps)")
    p.add_argument("-U", "--broadcast",
                   help="Broadcast profile: SINGLE|MULTI|MULTI_R"
                        "[,mainlevel=X] (e.g. SINGLE,mainlevel=5)")
    p.add_argument("-z", "--imf",
                   help="IMF profile: 2K|4K|8K|2K_R|4K_R|8K_R"
                        "[,mainlevel=X][,sublevel=Y]")
    p.add_argument("-A", "--tlm", action="store_true", help="write TLM")
    p.add_argument("-L", "--plt", action="store_true", help="write PLT")
    p.add_argument("--plm", action="store_true",
                   help="write PLM (main-header packet-length index)")
    p.add_argument("--ppm", action="store_true",
                   help="packed packet headers in the main header")
    p.add_argument("--max-cs-size", type=int, default=0,
                   help="total codestream byte cap (reference -W)")
    p.add_argument("--ppt", action="store_true",
                   help="pack packet headers into PPT marker segments")
    p.add_argument("--ht", action="store_true",
                   help="HTJ2K (Part 15) block coder")
    p.add_argument("--ht-mixed", action="store_true",
                   help="Part-15 MIXED set: per-codeblock MQ/HT choice "
                        "(MQ for LL blocks, HT elsewhere); implies --ht")
    p.add_argument("-V", "--transfer-exif", action="store_true",
                   help="copy EXIF metadata from the input into the JP2 "
                        "(uuid box)")
    p.add_argument("-C", "--comment", default=None)
    p.add_argument("-G", "--guard-bits", type=int, default=None)
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
    p.add_argument("--num-hosts", type=int, default=0,
                   help="multi-host batch: total hosts (0 = use "
                        "torch.distributed when initialized)")
    p.add_argument("--host-id", type=int, default=0,
                   help="multi-host batch: this host's index")
    p.add_argument("--backend", default="device",
                   choices=["auto", "native", "python", "device"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where --backend device runs: the card, or the "
                        "kernels' plain PyTorch versions on the CPU")
    return p


def params_from_args(args) -> CompressParams:
    cp = CompressParams()
    cp.numresolution = args.resolutions
    bw, bh = common.parse_int_pair(args.code_block_dims)
    cp.cblk_width, cp.cblk_height = bw, bh
    if args.tile_dims:
        cp.tile_size = common.parse_int_pair(args.tile_dims)
    cp.tile_offset = common.parse_int_pair(args.tile_offset)
    cp.image_offset = common.parse_int_pair(args.image_offset)
    cp.prog_order = Progression[args.progression_order]
    if args.compression_ratios:
        cp.layer_rates = [float(x) for x in
                          args.compression_ratios.split(",")]
    if args.quality:
        cp.layer_psnr = [float(x) for x in args.quality.split(",")]
    cp.irreversible = args.irreversible
    if args.mode is not None:
        cp.cblk_style = CblkStyle(args.mode)
    cp.sop = args.sop
    cp.eph = args.eph
    cp.tlm = args.tlm
    cp.plt = args.plt
    cp.plm = args.plm
    cp.ppm = args.ppm
    cp.ppt = args.ppt
    cp.max_cs_size = args.max_cs_size
    cp.ht = args.ht or args.ht_mixed
    cp.ht_mixed = args.ht_mixed
    cp.num_guard_bits = args.guard_bits
    cp.num_threads = args.num_threads
    cp.backend = args.backend
    cp.new_tile_part_progression = args.tile_parts
    if args.comment is not None:
        cp.comment = args.comment
    if args.precinct_dims:
        dims = []
        for part in args.precinct_dims.replace("[", "").split("]"):
            part = part.strip(",")
            if part:
                dims.append(common.parse_int_pair(part))
        cp.precincts = dims
    if args.poc:
        changes = []
        tile_changes: dict[int, list] = {}
        for seg in args.poc.split("/"):
            tile = None
            if "=" in seg:
                tsel, seg = seg.split("=", 1)
                tsel = tsel.strip().upper()
                if not tsel.startswith("T"):
                    raise ParamError(f"-P tile selector {tsel!r} must "
                                     "be T<index>")
                tile = int(tsel[1:])
            rs, cs, le, re_, ce, prog = seg.split(",")
            chg = ProgressionChange(
                int(rs), int(cs), int(le), int(re_), int(ce),
                Progression[prog])
            if tile is None:
                changes.append(chg)
            else:
                # T<idx>= scopes the change to one tile (tile-header POC)
                tile_changes.setdefault(tile, []).append(chg)
        cp.progression_changes = changes
        cp.tile_progression_changes = tile_changes
    if args.roi:
        fields = dict(f.split("=") for f in args.roi.split(","))
        cp.roi_comp = int(fields.get("c", 0))
        cp.roi_shift = int(fields.get("U", 0))
    if args.mct_file:
        if args.mct_file.endswith(".npy"):
            cp.custom_mct = np.load(args.mct_file)
        else:
            cp.custom_mct = np.loadtxt(args.mct_file, delimiter=",")
    if args.mct_mode is not None:
        cp.mct = args.mct_mode
    if args.cinema2k:
        cp.profile = Profile.CINEMA_2K
        cp.framerate = args.cinema2k
        cp.irreversible = True
    elif args.cinema4k:
        cp.profile = Profile.CINEMA_4K
        cp.framerate = 24
        cp.irreversible = True
    elif args.broadcast is not None:
        fields = args.broadcast.split(",")
        variants = {"SINGLE": Profile.BC_SINGLE, "MULTI": Profile.BC_MULTI,
                    "MULTI_R": Profile.BC_MULTI_R}
        name = fields[0].upper()
        if name not in variants:
            raise ParamError(f"unknown Broadcast profile {fields[0]!r} "
                             "(SINGLE|MULTI|MULTI_R)")
        cp.profile = variants[name]
        for f in fields[1:]:
            k, _, v = f.partition("=")
            if k == "mainlevel":
                cp.profile_level = int(v)
            elif k == "framerate":
                cp.framerate = int(v)
            else:
                raise ParamError(f"unknown Broadcast option {f!r}")
    elif args.imf is not None:
        fields = args.imf.split(",")
        variants = {"2K": Profile.IMF_2K, "4K": Profile.IMF_4K,
                    "8K": Profile.IMF_8K, "2K_R": Profile.IMF_2K_R,
                    "4K_R": Profile.IMF_4K_R, "8K_R": Profile.IMF_8K_R}
        name = fields[0].upper()
        if name not in variants:
            raise ParamError(f"unknown IMF profile {fields[0]!r} "
                             "(2K|4K|8K|2K_R|4K_R|8K_R)")
        cp.profile = variants[name]
        for f in fields[1:]:
            k, _, v = f.partition("=")
            if k == "mainlevel":
                cp.profile_level = int(v)
            elif k == "sublevel":
                cp.profile_sublevel = int(v)
            elif k == "framerate":
                cp.framerate = int(v)
            else:
                raise ParamError(f"unknown IMF option {f!r}")
    return cp


def compress_one(in_path: str, out_path: str, args) -> None:
    cp = params_from_args(args)
    cp.cod_format = "jp2" if out_path.lower().endswith(
        (".jp2", ".jph")) else "j2k"
    if args.stream_strips:
        if args.raw or args.subsampling_factor or \
                common.parse_int_pair(args.image_offset) != (0, 0):
            raise ParamError("--stream-strips is incompatible with "
                             "-F/-s/--image-offset")
        meta, reader = formats.open_pnm_strips(in_path)
        try:
            # file sink: tile-parts stream to disk, TLM seek-back
            # patched — neither canvas nor codestream memory-resident
            nbytes, times = common.run_repeated(
                lambda: codec.compress_strips_file(
                    meta, reader, out_path, cp, device=args.device),
                args.repetitions, args.duration, profile_dir=args.profile)
        finally:
            reader.close()
        mp = (meta.x1 - meta.x0) * (meta.y1 - meta.y0) / 1e6
        log.info("%s -> %s: %d bytes, %.2f MP/s (streamed, best of %d)",
                 in_path, out_path, nbytes, mp / min(times), len(times))
        return
    img = formats.load_image(in_path, raw_desc=args.raw)
    if not args.transfer_exif:
        img.meta.exif = None  # EXIF transfer is opt-in (-V)
    if args.image_offset != "0,0":
        # applied BEFORE -s: subsampled components keep only the canvas
        # positions divisible by dx/dy, so the offset determines WHICH
        # input samples survive subsampling (encoding then slicing lost
        # a row/column of a nominally lossless encode)
        ox, oy = common.parse_int_pair(args.image_offset)
        img.x0 += ox
        img.y0 += oy
        img.x1 += ox
        img.y1 += oy
        for c in img.comps:
            c.x0 = -(-img.x0 // c.dx)
            c.y0 = -(-img.y0 // c.dy)
    if args.subsampling_factor:
        # -s dx,dy: subsample every component on input (reference
        # parity); the slice phase keeps the samples whose (possibly
        # offset) canvas coordinates are multiples of the new dx/dy
        dx, dy = common.parse_int_pair(args.subsampling_factor)
        for c in img.comps:
            c.dx *= dx
            c.dy *= dy
            c.x0 = -(-img.x0 // c.dx)
            c.y0 = -(-img.y0 // c.dy)
            sy = c.y0 * c.dy - img.y0
            sx = c.x0 * c.dx - img.x0
            c.data = c.data[sy::dy, sx::dx]
            c.h, c.w = c.data.shape

    def do():
        return codec.compress(img, cp, device=args.device)

    data, times = common.run_repeated(do, args.repetitions, args.duration,
                                      profile_dir=args.profile)
    with open(out_path, "wb") as f:
        f.write(data)
    mp = (img.x1 - img.x0) * (img.y1 - img.y0) / 1e6
    best = min(times)
    log.info("%s -> %s: %d bytes, %.2f MP/s (best of %d)",
             in_path, out_path, len(data), mp / best, len(times))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    common.setup_logging(args.verbose, args.logfile)
    try:
        if args.backend == "device":
            resolve_device(args.device)  # no card: an error, not the CPU
    except RuntimeError as e:
        print(f"grk_compress: error: {e}", file=sys.stderr)
        return 1
    try:
        if args.batch_src:
            if not args.out_dir:
                raise ParamError("batch mode requires -a out_dir")
            exts = formats.PIL_FORMATS | {".pgx", ".raw", ".rawl"}
            pairs = list(common.batch_inputs(
                args.batch_src, args.out_dir, args.out_fmt, exts))
            pairs = common.shard_pairs(pairs, args.num_hosts, args.host_id)
            failures = 0
            for src, dst in pairs:
                try:
                    compress_one(src, dst, args)
                except (GrkError, OSError, ValueError) as e:
                    # one bad file must not abort the batch (reference
                    # batch mode logs and continues)
                    log.error("%s: %s", src, e)
                    failures += 1
            return 1 if failures else 0
        if not args.in_file or not args.out_file:
            raise ParamError("need -i and -o (or -y/-a batch mode)")
        compress_one(args.in_file, args.out_file, args)
    except (GrkError, OSError, ValueError) as e:
        # ValueError: malformed numeric option values (e.g. -r 20,abc)
        # must print a clean CLI error, not a traceback
        print(f"grk_compress: error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
