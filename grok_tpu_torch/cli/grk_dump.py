"""grk_dump — codestream / container structure dump.

Parity: src/bin/jp2/GrkDump.cpp (SURVEY.md §2.2, §3.5): parses headers only
(no Tier-1/DWT), prints image info, coding parameters, marker positions and
tile-part layout as stable text — the format the dump-diff test family
compares against (SURVEY.md §4 family 3).
"""

from __future__ import annotations

import argparse
import sys

from .. import codec
from ..errors import GrkError
from ..params import QuantStyle
from . import common


def _dump_jp2_boxes(data: bytes, out) -> None:
    """Walk the JP2 box tree (superboxes descended one level)."""
    import struct

    w = out.write
    w("[jp2 boxes]\n")

    def walk(buf, base, indent):
        pos = 0
        while pos + 8 <= len(buf):
            ln = struct.unpack(">I", buf[pos:pos + 4])[0]
            btype = bytes(buf[pos + 4:pos + 8])
            hdr = 8
            if ln == 1 and pos + 16 <= len(buf):
                ln = struct.unpack(">Q", buf[pos + 8:pos + 16])[0]
                hdr = 16
            elif ln == 0:
                ln = len(buf) - pos
            if ln < hdr or pos + ln > len(buf):
                w(f"{indent}(malformed box at {base + pos})\n")
                return
            name = btype.decode("latin1")
            extra = ""
            payload = buf[pos + hdr:pos + ln]
            if btype == b"uuid" and len(payload) >= 16:
                uid = bytes(payload[:16])
                extra = (f" id={uid.decode('latin1')!r}"
                         if all(32 <= c < 127 for c in uid)
                         else f" id={uid.hex()}")
            elif btype == b"ihdr" and len(payload) >= 10:
                hh, ww, nc = struct.unpack(">IIH", payload[:10])
                extra = f" {ww}x{hh} nc={nc}"
            w(f"{indent}{base + pos:08d} {name} len={ln}{extra}\n")
            if btype in (b"jp2h", b"res "):
                walk(payload, base + pos + hdr, indent + "  ")
            pos += ln

    walk(data, 0, "  ")


def dump(data: bytes, out) -> None:
    if data[:4] == b"\x00\x00\x00\x0c":
        _dump_jp2_boxes(data, out)
    hi = codec.read_header(data, lazy=False)
    siz = hi.siz
    w = out.write
    w("[codestream header]\n")
    w(f"  image: x0={siz.xosiz} y0={siz.yosiz} x1={siz.xsiz} y1={siz.ysiz}\n")
    w(f"  tiles: grid={hi.cp.t_grid_w}x{hi.cp.t_grid_h} "
      f"size={siz.xtsiz}x{siz.ytsiz} offset=({siz.xtosiz},{siz.ytosiz})\n")
    w(f"  rsiz: 0x{siz.rsiz:04X}\n")
    w(f"  components: {len(siz.comps)}\n")
    for i, (prec, sgnd, dx, dy) in enumerate(siz.comps):
        w(f"    comp[{i}]: prec={prec} sgnd={int(sgnd)} dx={dx} dy={dy}\n")
    tcp = hi.cp.tcps[0]
    w("[coding parameters]\n")
    w(f"  progression={tcp.prog_order.name} layers={tcp.numlayers} "
      f"mct={tcp.mct} sop={int(hi.sop)} eph={int(hi.eph)}\n")
    for i, tccp in enumerate(tcp.tccps):
        w(f"  comp[{i}]: resolutions={tccp.numresolutions} "
          f"cblk={1 << tccp.cblkw}x{1 << tccp.cblkh} "
          f"style=0x{int(tccp.cblk_style):02X} "
          f"transform={'5/3' if tccp.qmfbid else '9/7'}"
          f"{' HT' if tccp.ht else ''}\n")
        prcs = ",".join(f"{1 << a}x{1 << b}"
                        for a, b in zip(tccp.prcw, tccp.prch))
        w(f"    precincts: {prcs}\n")
        w(f"    quant: style={QuantStyle(tccp.qnt_style).name} "
          f"guard={tccp.num_guard_bits}\n")
        ss = " ".join(f"({s.expn},{s.mant})" for s in tccp.stepsizes)
        w(f"    stepsizes: {ss}\n")
    if hi.cap:
        w(f"[cap] pcap=0x{hi.cap['pcap']:08X} ccap={hi.cap['ccap']}\n")
    if hi.main_poc:
        w("[poc]\n")
        for c in hi.main_poc:
            w(f"  {c.res_s},{c.comp_s} -> {c.res_e},{c.comp_e} "
              f"layers<{c.lay_e} {c.prog.name}\n")
    if hi.crg:
        w("[crg] " + " ".join(f"({x},{y})" for (x, y) in hi.crg) + "\n")
    for cstr in hi.comments:
        w(f"[comment] {cstr}\n")
    from ..codestream.profiles import validate_decoded_profile

    issues = validate_decoded_profile(siz.rsiz, hi)
    if issues:
        w("[profile violations]\n")
        for issue in issues:
            w(f"  {issue}\n")
    w("[markers]\n")
    for (name, pos, length) in hi.marker_log:
        w(f"  {pos:08d} {name} len={length}\n")
    img = hi.image
    if img.meta.icc_profile:
        w(f"[jp2] icc profile: {len(img.meta.icc_profile)} bytes\n")
    if img.meta.capture_resolution:
        w(f"[jp2] capture resolution: {img.meta.capture_resolution}\n")
    if img.meta.palette:
        pal = img.meta.palette
        n = 0 if pal.lut is None else pal.lut.shape[0]
        w(f"[jp2] palette: {n} entries, "
          f"{len(pal.component_mapping)} mappings\n")
    if img.meta.channel_definitions:
        w(f"[jp2] cdef: {img.meta.channel_definitions}\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="grk_dump",
        description="dump JPEG 2000 codestream/container structure")
    p.add_argument("-i", "--in-file", required=True)
    p.add_argument("-o", "--out-file", default=None)
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)
    common.setup_logging(args.verbose)
    try:
        with open(args.in_file, "rb") as f:
            data = f.read()
        if args.out_file:
            with open(args.out_file, "w") as out:
                dump(data, out)
        else:
            dump(data, sys.stdout)
    except (GrkError, OSError) as e:
        print(f"grk_dump: error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
