"""JP2 container (ISO/IEC 15444-1 Annex I) box parser/writer.

Parity: FileFormat/FileFormatCompress/FileFormatDecompress (SURVEY.md §2.1
"JP2 container", src/lib/core/codestream/FileFormat*.cpp [P]): jP/ftyp/jp2h
(ihdr, bpcc, colr incl. ICC, pclr, cmap, cdef, res) + xml/uuid boxes; brand
and compatibility checks.  Wire format verified against oracle output
(SURVEY.md Appendix A.3).
"""

from __future__ import annotations

import logging
import struct

import numpy as np

from ..errors import CodestreamError
from ..image import ColorSpace, GrkImage, ImageMeta, PaletteEntry

log = logging.getLogger("grok_tpu_torch")

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
XMP_UUID = bytes.fromhex("be7acfcb97a942e89c71999491e3afac")
# EXIF-in-JP2 convention: the 16 ASCII bytes "JpgTiffExif->JP2"
EXIF_UUID = b"JpgTiffExif->JP2"


def _box(btype: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload) + 8) + btype + payload


def wrap_jp2(codestream: bytes, image: GrkImage, ht: bool = False) -> bytes:
    """Wrap a raw codestream in a JP2 container (brand 'jph ' for HTJ2K
    codestreams per ITU-T T.814)."""
    return jp2_prefix(image, ht, len(codestream)) + codestream


def jp2_prefix(image: GrkImage, ht: bool = False,
               cs_len: int | None = None) -> bytes:
    """Container bytes up to and including the jp2c box header.  With
    cs_len=None the jp2c LBox is 0 ("to end of file", ISO 15444-1 I.5.1)
    so the codestream can be streamed to a file after this prefix
    (compress_strips_file)."""
    out = bytearray()
    out += JP2_SIGNATURE
    if ht:
        out += _box(b"ftyp", b"jph " + struct.pack(">I", 0) + b"jp2 jph ")
    else:
        out += _box(b"ftyp", b"jp2 " + struct.pack(">I", 0) + b"jp2 ")

    # jp2h superbox
    jp2h = bytearray()
    nc = image.numcomps
    precs = [c.prec for c in image.comps]
    sgnds = [c.sgnd for c in image.comps]
    same = len(set(precs)) == 1 and len(set(sgnds)) == 1
    bpc = (precs[0] - 1) | (0x80 if sgnds[0] else 0) if same else 0xFF
    jp2h += _box(b"ihdr", struct.pack(
        ">IIHBBBB", image.height, image.width, nc, bpc, 7, 0, 0))
    if not same:
        jp2h += _box(b"bpcc", bytes(
            (p - 1) | (0x80 if s else 0) for p, s in zip(precs, sgnds)))
    meta = image.meta
    if meta.icc_profile:
        jp2h += _box(b"colr", struct.pack(">BBB", 2, 0, 0) + meta.icc_profile)
    else:
        enum = image.color_space.value if image.color_space in (
            ColorSpace.SRGB, ColorSpace.GRAY, ColorSpace.SYCC,
            ColorSpace.EYCC, ColorSpace.CMYK, ColorSpace.CIELAB) else (
            16 if nc >= 3 else 17)
        jp2h += _box(b"colr", struct.pack(">BBBI", 1, 0, 0, enum))
    if meta.palette is not None:
        jp2h += _palette_boxes(meta.palette)
    if meta.channel_definitions:
        p = struct.pack(">H", len(meta.channel_definitions))
        for (cn, typ, asoc) in meta.channel_definitions:
            p += struct.pack(">HHH", cn, typ, asoc)
        jp2h += _box(b"cdef", p)
    if meta.capture_resolution or meta.display_resolution:
        res = bytearray()
        if meta.capture_resolution:
            res += _res_sub(b"resc", meta.capture_resolution)
        if meta.display_resolution:
            res += _res_sub(b"resd", meta.display_resolution)
        jp2h += _box(b"res ", bytes(res))
    out += _box(b"jp2h", bytes(jp2h))

    for xml in meta.xml:
        out += _box(b"xml ", xml)
    if meta.xmp:
        out += _box(b"uuid", XMP_UUID + meta.xmp)
    if meta.exif:
        out += _box(b"uuid", EXIF_UUID + meta.exif)
    if cs_len is None:
        out += struct.pack(">I", 0) + b"jp2c"
    else:
        out += struct.pack(">I", cs_len + 8) + b"jp2c"
    return bytes(out)


def _res_sub(btype: bytes, vh: tuple[float, float]) -> bytes:
    def rational(v: float):
        # v = num / den * 10^exp (pixels per metre)
        exp = 0
        while v < 32767 and v != int(v) and exp > -10:
            v *= 10
            exp -= 1
        num = int(round(v))
        den = 1
        while num > 0xFFFF:
            num //= 10
            exp += 1
        return num, den, exp

    vn, vd, ve = rational(vh[0])
    hn, hd, he = rational(vh[1])
    return _box(btype, struct.pack(">HHHHbb", vn, vd, hn, hd, ve, he))


def _palette_boxes(pal: PaletteEntry) -> bytes:
    ne, nc = pal.lut.shape
    p = struct.pack(">HB", ne, nc)
    for prec, sgnd in zip(pal.channel_prec, pal.channel_sgnd):
        p += bytes([(prec - 1) | (0x80 if sgnd else 0)])
    for e in range(ne):
        for c in range(nc):
            prec = pal.channel_prec[c]
            nbytes = (prec + 7) // 8
            p += int(pal.lut[e, c]).to_bytes(nbytes, "big", signed=False)
    out = _box(b"pclr", p)
    cm = b""
    for (cmp, typ, col) in pal.component_mapping:
        cm += struct.pack(">HBB", cmp, typ, col)
    out += _box(b"cmap", cm)
    return out


# ---------------------------------------------------------------------------


def is_jp2(data: bytes) -> bool:
    return data[:12] == JP2_SIGNATURE


def unwrap_jp2(data: bytes) -> tuple[bytes, ImageMeta, ColorSpace | None]:
    """Extract the codestream + container metadata from a JP2 file."""
    meta = ImageMeta()
    cs: ColorSpace | None = None
    codestream = None
    pos = 0
    n = len(data)
    while pos + 8 <= n:
        length = struct.unpack(">I", data[pos:pos + 4])[0]
        btype = data[pos + 4:pos + 8]
        payload_off = pos + 8
        if length == 1:
            length = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            payload_off = pos + 16
        if length == 0:
            length = n - pos
        payload = data[payload_off:pos + length]
        if btype == b"jp2c":
            codestream = payload
        elif btype == b"jp2h":
            cs = _parse_jp2h(payload, meta)
        elif btype == b"xml ":
            # bytes(), not a slice: metadata outlives the (possibly
            # mmap-backed memoryview) stream and flows into PIL, which
            # requires real bytes (e.g. Exif.load startswith)
            meta.xml.append(bytes(payload))
        elif btype == b"uuid" and payload[:16] == EXIF_UUID:
            meta.exif = bytes(payload[16:])
        elif btype == b"uuid" and payload[:16] == XMP_UUID:
            meta.xmp = bytes(payload[16:])
        pos += length
    if codestream is None:
        raise CodestreamError("JP2 file has no jp2c box")
    return codestream, meta, cs


def _h(fn, btype):
    """Run a box parser, converting slicing/unpack errors on truncated
    boxes (fuzz-found) into CodestreamError."""
    try:
        fn()
    except (struct.error, IndexError) as e:
        raise CodestreamError(f"malformed {btype.decode(errors='replace')} "
                              f"box: {e}") from None


def _parse_jp2h(data: bytes, meta: ImageMeta) -> ColorSpace | None:
    cs = None
    pos = 0
    n = len(data)
    while pos + 8 <= n:
        length = struct.unpack(">I", data[pos:pos + 4])[0]
        btype = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + length]
        if btype == b"colr":
            # truncated colr boxes (fuzz-found) must fail as a malformed
            # stream, not an IndexError/struct.error from slicing
            if len(payload) < 3:
                raise CodestreamError("truncated colr box")
            meth = payload[0]
            if meth == 1:
                if len(payload) < 7:
                    raise CodestreamError("truncated colr box (EnumCS)")
                enum = struct.unpack(">I", payload[3:7])[0]
                try:
                    cs = ColorSpace(enum)
                except ValueError:
                    cs = ColorSpace.UNKNOWN
            elif meth == 2:
                meta.icc_profile = payload[3:]
                if cs is None and len(meta.icc_profile) >= 20:
                    # a restricted-ICC colr box carries no EnumCS: take
                    # the device space from the profile header so
                    # consumers that skip ICC application (force_rgb's
                    # naive CMYK formula, raw-plane writers) still know
                    # the component layout
                    space = meta.icc_profile[16:20]
                    cs = {b"CMYK": ColorSpace.CMYK,
                          b"GRAY": ColorSpace.GRAY}.get(space)
        elif btype == b"pclr":
            _h(lambda: setattr(meta, "palette",
                               _parse_pclr(payload, meta.palette)), btype)
        elif btype == b"cmap":
            def _cmap():
                pal = meta.palette or PaletteEntry()
                for off in range(0, len(payload) - 3, 4):
                    cmp_, typ, col = struct.unpack(
                        ">HBB", payload[off:off + 4])
                    pal.component_mapping.append((cmp_, typ, col))
                meta.palette = pal
            _h(_cmap, btype)
        elif btype == b"cdef":
            def _cdef():
                cnt = struct.unpack(">H", payload[:2])[0]
                defs = []
                for i in range(cnt):
                    cn, typ, asoc = struct.unpack(
                        ">HHH", payload[2 + 6 * i:8 + 6 * i])
                    defs.append((cn, typ, asoc))
                meta.channel_definitions = defs
            _h(_cdef, btype)
        elif btype == b"res ":
            _h(lambda: _parse_res(payload, meta), btype)
        if length <= 0:
            break
        pos += length
    return cs


def _parse_pclr(payload: bytes, existing) -> PaletteEntry:
    pal = existing or PaletteEntry()
    ne, nc = struct.unpack(">HB", payload[:3])
    pal.channel_prec = []
    pal.channel_sgnd = []
    off = 3
    for _ in range(nc):
        b = payload[off]
        pal.channel_prec.append((b & 0x7F) + 1)
        pal.channel_sgnd.append(bool(b & 0x80))
        off += 1
    lut = np.zeros((ne, nc), dtype=np.int32)
    for e in range(ne):
        for c in range(nc):
            nbytes = (pal.channel_prec[c] + 7) // 8
            lut[e, c] = int.from_bytes(payload[off:off + nbytes], "big")
            off += nbytes
    pal.lut = lut
    return pal


def _parse_res(payload: bytes, meta: ImageMeta) -> None:
    pos = 0
    while pos + 8 <= len(payload):
        length = struct.unpack(">I", payload[pos:pos + 4])[0]
        btype = payload[pos + 4:pos + 8]
        body = payload[pos + 8:pos + length]
        if len(body) >= 10:
            vn, vd, hn, hd, ve, he = struct.unpack(">HHHHbb", body[:10])
            vres = vn / max(vd, 1) * (10.0 ** ve)
            hres = hn / max(hd, 1) * (10.0 ** he)
            if btype == b"resc":
                meta.capture_resolution = (vres, hres)
            elif btype == b"resd":
                meta.display_resolution = (vres, hres)
        if length <= 0:
            break
        pos += length
