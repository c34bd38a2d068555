"""Codestream marker segment readers/writers.

Parity: one unit per marker segment (SURVEY.md §2.1 "Marker
readers/writers", src/lib/core/codestream/markers/ [P]); wire format
verified against real oracle streams (SURVEY.md Appendix A.1/A.2).

Markers implemented: SOC SIZ CAP COD COC QCD QCC POC COM CRG TLM PLM PLT
PPM PPT SOT SOD RGN MCT MCC MCO CPF EOC (+ SOP/EPH inside packet streams).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..params import (
    CblkStyle,
    Progression,
    ProgressionChange,
    QuantStyle,
    StepSize,
    TileCodingParams,
    TileComponentCodingParams,
)

# marker codes
SOC = 0xFF4F
CAP = 0xFF50
SIZ = 0xFF51
COD = 0xFF52
COC = 0xFF53
TLM = 0xFF55
PRF = 0xFF56
PLM = 0xFF57
PLT = 0xFF58
CPF = 0xFF59
QCD = 0xFF5C
QCC = 0xFF5D
RGN = 0xFF5E
POC = 0xFF5F
PPM = 0xFF60
PPT = 0xFF61
CRG = 0xFF63
COM = 0xFF64
MCT = 0xFF74
MCC = 0xFF75
MCO = 0xFF77
SOT = 0xFF90
SOP = 0xFF91
EPH = 0xFF92
SOD = 0xFF93
EOC = 0xFFD9

MARKER_NAMES = {
    SOC: "SOC", CAP: "CAP", SIZ: "SIZ", COD: "COD", COC: "COC", TLM: "TLM",
    PRF: "PRF", PLM: "PLM", PLT: "PLT", CPF: "CPF", QCD: "QCD", QCC: "QCC",
    RGN: "RGN", POC: "POC", PPM: "PPM", PPT: "PPT", CRG: "CRG", COM: "COM",
    MCT: "MCT", MCC: "MCC", MCO: "MCO", SOT: "SOT", SOP: "SOP", EPH: "EPH",
    SOD: "SOD", EOC: "EOC",
}


def u8(v: int) -> bytes:
    return struct.pack(">B", v)


def u16(v: int) -> bytes:
    return struct.pack(">H", v)


def u32(v: int) -> bytes:
    return struct.pack(">I", v)


def marker_segment(code: int, payload: bytes) -> bytes:
    return u16(code) + u16(len(payload) + 2) + payload


@dataclass
class SizInfo:
    rsiz: int = 0
    xsiz: int = 0
    ysiz: int = 0
    xosiz: int = 0
    yosiz: int = 0
    xtsiz: int = 0
    ytsiz: int = 0
    xtosiz: int = 0
    ytosiz: int = 0
    # per component: (prec, sgnd, dx, dy)
    comps: list[tuple[int, bool, int, int]] = field(default_factory=list)


def write_siz(si: SizInfo) -> bytes:
    p = bytearray()
    p += u16(si.rsiz)
    p += u32(si.xsiz) + u32(si.ysiz) + u32(si.xosiz) + u32(si.yosiz)
    p += u32(si.xtsiz) + u32(si.ytsiz) + u32(si.xtosiz) + u32(si.ytosiz)
    p += u16(len(si.comps))
    for (prec, sgnd, dx, dy) in si.comps:
        p += u8((prec - 1) | (0x80 if sgnd else 0)) + u8(dx) + u8(dy)
    return marker_segment(SIZ, bytes(p))


def read_siz(p: bytes) -> SizInfo:
    si = SizInfo()
    (si.rsiz, si.xsiz, si.ysiz, si.xosiz, si.yosiz, si.xtsiz, si.ytsiz,
     si.xtosiz, si.ytosiz, csiz) = struct.unpack(">H8IH", p[:36])
    off = 36
    for _ in range(csiz):
        ssiz, dx, dy = struct.unpack(">BBB", p[off:off + 3])
        off += 3
        si.comps.append(((ssiz & 0x7F) + 1, bool(ssiz & 0x80), dx, dy))
    return si


def _write_cod_sp(tccp: TileComponentCodingParams, has_precincts: bool) -> bytes:
    p = bytearray()
    p += u8(tccp.numresolutions - 1)
    p += u8(tccp.cblkw - 2)
    p += u8(tccp.cblkh - 2)
    # SPcod style bit 6 signals the HT block coder (ITU-T T.814)
    p += u8(int(tccp.cblk_style) | (0x40 if tccp.ht else 0))
    p += u8(0 if tccp.qmfbid == 0 else 1)
    if has_precincts:
        for r in range(tccp.numresolutions):
            p += u8(tccp.prcw[r] | (tccp.prch[r] << 4))
    return bytes(p)


def _read_cod_sp(p: bytes, off: int, tccp: TileComponentCodingParams,
                 has_precincts: bool) -> int:
    numres = p[off] + 1
    if numres > 33:
        raise ValueError(f"numresolutions {numres} exceeds the spec limit")
    cblkw = (p[off + 1] & 0x0F) + 2
    cblkh = (p[off + 2] & 0x0F) + 2
    if cblkw + cblkh > 12:
        raise ValueError("code-block area exceeds 4096 samples")
    tccp.numresolutions = numres
    tccp.cblkw = cblkw
    tccp.cblkh = cblkh
    tccp.cblk_style = CblkStyle(p[off + 3] & 0x7F)
    tccp.ht = bool(p[off + 3] & 0x40)
    tccp.qmfbid = 1 if p[off + 4] == 1 else 0
    off += 5
    if has_precincts:
        tccp.prcw = []
        tccp.prch = []
        for _ in range(tccp.numresolutions):
            b = p[off]
            tccp.prcw.append(b & 0x0F)
            tccp.prch.append(b >> 4)
            off += 1
    else:
        tccp.prcw = [15] * tccp.numresolutions
        tccp.prch = [15] * tccp.numresolutions
    return off


def write_cod(tcp: TileCodingParams, has_precincts: bool,
              sop: bool = False, eph: bool = False) -> bytes:
    tccp = tcp.tccps[0]
    scod = (1 if has_precincts else 0) | (2 if sop else 0) | (4 if eph else 0)
    p = bytearray()
    p += u8(scod)
    p += u8(int(tcp.prog_order))
    p += u16(tcp.numlayers)
    p += u8(tcp.mct)
    p += _write_cod_sp(tccp, has_precincts)
    return marker_segment(COD, bytes(p))


def read_cod(p: bytes, tcp: TileCodingParams) -> tuple[bool, bool]:
    scod = p[0]
    has_precincts = bool(scod & 1)
    sop = bool(scod & 2)
    eph = bool(scod & 4)
    tcp.prog_order = Progression(p[1])
    tcp.numlayers = struct.unpack(">H", p[2:4])[0]
    tcp.mct = p[4]
    tccp = tcp.tccps[0]
    _read_cod_sp(p, 5, tccp, has_precincts)
    # COD applies to all components until COC overrides
    for other in tcp.tccps[1:]:
        other.numresolutions = tccp.numresolutions
        other.cblkw = tccp.cblkw
        other.cblkh = tccp.cblkh
        other.cblk_style = tccp.cblk_style
        other.ht = tccp.ht
        other.qmfbid = tccp.qmfbid
        other.prcw = list(tccp.prcw)
        other.prch = list(tccp.prch)
    return sop, eph


def write_coc(compno: int, numcomps: int, tccp: TileComponentCodingParams,
              has_precincts: bool) -> bytes:
    p = bytearray()
    if numcomps <= 256:
        p += u8(compno)
    else:
        p += u16(compno)
    p += u8(1 if has_precincts else 0)
    p += _write_cod_sp(tccp, has_precincts)
    return marker_segment(COC, bytes(p))


def read_coc(p: bytes, tcp: TileCodingParams, numcomps: int) -> None:
    off = 0
    if numcomps <= 256:
        compno = p[0]
        off = 1
    else:
        compno = struct.unpack(">H", p[:2])[0]
        off = 2
    has_precincts = bool(p[off] & 1)
    off += 1
    _read_cod_sp(p, off, tcp.tccps[compno], has_precincts)


def _quant_payload(tccp: TileComponentCodingParams) -> bytes:
    p = bytearray()
    sq = (int(tccp.qnt_style) & 0x1F) | (tccp.num_guard_bits << 5)
    p += u8(sq)
    if tccp.qnt_style == QuantStyle.NONE:
        for ss in tccp.stepsizes:
            p += u8(ss.expn << 3)
    elif tccp.qnt_style == QuantStyle.SCALAR_DERIVED:
        ss = tccp.stepsizes[0]
        p += u16((ss.expn << 11) | ss.mant)
    else:
        for ss in tccp.stepsizes:
            p += u16((ss.expn << 11) | ss.mant)
    return bytes(p)


def _read_quant(p: bytes, off: int, length: int,
                tccp: TileComponentCodingParams) -> None:
    sq = p[off]
    tccp.qnt_style = QuantStyle(sq & 0x1F)
    tccp.num_guard_bits = sq >> 5
    off += 1
    end = off + length - 1
    tccp.stepsizes = []
    if tccp.qnt_style == QuantStyle.NONE:
        while off < end:
            tccp.stepsizes.append(StepSize(p[off] >> 3, 0))
            off += 1
    elif tccp.qnt_style == QuantStyle.SCALAR_DERIVED:
        v = struct.unpack(">H", p[off:off + 2])[0]
        tccp.stepsizes.append(StepSize(v >> 11, v & 0x7FF))
    else:
        while off + 1 < end + 1 and off + 2 <= end:
            v = struct.unpack(">H", p[off:off + 2])[0]
            tccp.stepsizes.append(StepSize(v >> 11, v & 0x7FF))
            off += 2


def write_qcd(tccp: TileComponentCodingParams) -> bytes:
    return marker_segment(QCD, _quant_payload(tccp))


def read_qcd(p: bytes, tcp: TileCodingParams) -> None:
    _read_quant(p, 0, len(p), tcp.tccps[0])
    t0 = tcp.tccps[0]
    for other in tcp.tccps[1:]:
        other.qnt_style = t0.qnt_style
        other.num_guard_bits = t0.num_guard_bits
        other.stepsizes = list(t0.stepsizes)


def write_qcc(compno: int, numcomps: int,
              tccp: TileComponentCodingParams) -> bytes:
    head = u8(compno) if numcomps <= 256 else u16(compno)
    return marker_segment(QCC, head + _quant_payload(tccp))


def read_qcc(p: bytes, tcp: TileCodingParams, numcomps: int) -> None:
    if numcomps <= 256:
        compno = p[0]
        off = 1
    else:
        compno = struct.unpack(">H", p[:2])[0]
        off = 2
    _read_quant(p, off, len(p) - off, tcp.tccps[compno])


def write_com(text: str) -> bytes:
    return marker_segment(COM, u16(1) + text.encode("latin-1"))


def read_com(p: bytes) -> str:
    rcom = struct.unpack(">H", p[:2])[0]
    body = bytes(p[2:])
    if rcom == 1:
        try:
            return body.decode("latin-1")
        except UnicodeDecodeError:
            return repr(body)
    return body.hex()


def write_poc(changes: list[ProgressionChange], numcomps: int) -> bytes:
    p = bytearray()
    big = numcomps > 256
    for c in changes:
        p += u8(c.res_s)
        p += (u16(c.comp_s) if big else u8(c.comp_s))
        p += u16(c.lay_e)
        p += u8(c.res_e)
        p += (u16(c.comp_e) if big else u8(c.comp_e))
        p += u8(int(c.prog))
    return marker_segment(POC, bytes(p))


def read_poc(p: bytes, numcomps: int) -> list[ProgressionChange]:
    big = numcomps > 256
    sz = 1 + (2 if big else 1) + 2 + 1 + (2 if big else 1) + 1
    out = []
    off = 0
    while off + sz <= len(p):
        rs = p[off]; off += 1
        if big:
            cs = struct.unpack(">H", p[off:off + 2])[0]; off += 2
        else:
            cs = p[off]; off += 1
        le = struct.unpack(">H", p[off:off + 2])[0]; off += 2
        re = p[off]; off += 1
        if big:
            ce = struct.unpack(">H", p[off:off + 2])[0]; off += 2
        else:
            ce = p[off]; off += 1
        pr = Progression(p[off]); off += 1
        out.append(ProgressionChange(rs, cs, le, re, ce, pr))
    return out


def write_sot(tile_index: int, psot: int, tpsot: int, tnsot: int) -> bytes:
    return marker_segment(
        SOT, u16(tile_index) + u32(psot) + u8(tpsot) + u8(tnsot))


def read_sot(p: bytes) -> tuple[int, int, int, int]:
    isot, psot = struct.unpack(">HI", p[:6])
    tpsot, tnsot = p[6], p[7]
    return isot, psot, tpsot, tnsot


def write_cap(ccap15: int = 0) -> bytes:
    """CAP with Pcap bit 15 set (Part 15 / HT capability)."""
    pcap = 1 << (32 - 15)
    return marker_segment(CAP, u32(pcap) + u16(ccap15))


def read_cap(p: bytes) -> dict:
    """Ccap entries appear in Pcap bit order, one per set bit; `parts`
    maps the ISO part number (Pcap bit n, MSB-first = part n) to its
    Ccap value so consumers don't misattribute entries when several
    capability bits are set."""
    pcap = struct.unpack(">I", p[:4])[0]
    out = {"pcap": pcap, "ccap": [], "parts": {}}
    off = 4
    for bit in range(32):
        if pcap & (1 << (31 - bit)):
            val = struct.unpack(">H", p[off:off + 2])[0]
            out["ccap"].append(val)
            out["parts"][bit + 1] = val
            off += 2
    return out


def write_cpf(pcpf: list[int]) -> bytes:
    p = b"".join(u16(v) for v in pcpf)
    return marker_segment(CPF, p)


def write_rgn(compno: int, numcomps: int, roishift: int) -> bytes:
    head = u8(compno) if numcomps <= 256 else u16(compno)
    return marker_segment(RGN, head + u8(0) + u8(roishift))


def read_rgn(p: bytes, numcomps: int) -> tuple[int, int]:
    if numcomps <= 256:
        compno, off = p[0], 1
    else:
        compno, off = struct.unpack(">H", p[:2])[0], 2
    # p[off] = Srgn (0 = implicit max-shift)
    return compno, p[off + 1]


# Marker-segment length is a u16 that includes itself; cap payloads the
# same way the PPT/PPM writers do (65528 data bytes) and split oversized
# TLM/PLT/PLM indexes across segments with incrementing Z indices.
_SEG_DATA_MAX = 65528


def write_tlm(ztlm: int, entries: list[tuple[int, int]]) -> bytes:
    """entries: (tile_index, tile_part_length). Uses ST=1 (8-bit Ttlm) when
    possible, SP=1 (32-bit lengths).  Splits across multiple TLM marker
    segments (Ztlm incrementing) when an index exceeds the 64KB marker
    length limit."""
    st = 1 if all(t < 256 for t, _ in entries) else 2
    stlm = (st << 4) | (1 << 6)
    per = (_SEG_DATA_MAX - 1) // (st + 4)
    out = bytearray()
    z = ztlm
    for i in range(0, max(1, len(entries)), per):
        p = bytearray([z & 0xFF, stlm])
        for t, ln in entries[i:i + per]:
            p += u8(t) if st == 1 else u16(t)
            p += u32(ln)
        out += marker_segment(TLM, bytes(p))
        z += 1
    return bytes(out)


def read_tlm(p: bytes) -> tuple[int, list[tuple[int | None, int]]]:
    """Returns (Ztlm, entries); callers accumulate entries across the
    (possibly several) TLM segments in Ztlm order."""
    ztlm = p[0]
    stlm = p[1]
    st = (stlm >> 4) & 3
    sp = (stlm >> 6) & 1
    lsz = 4 if sp else 2
    out = []
    off = 2
    while off < len(p):
        if st == 0:
            t = None
        elif st == 1:
            t = p[off]; off += 1
        else:
            t = struct.unpack(">H", p[off:off + 2])[0]; off += 2
        if off + lsz > len(p):
            break
        if lsz == 4:
            ln = struct.unpack(">I", p[off:off + 4])[0]
        else:
            ln = struct.unpack(">H", p[off:off + 2])[0]
        off += lsz
        out.append((t, ln))
    return ztlm, out


def _varint(v: int) -> bytes:
    """7-bit big-endian varint with continuation high bit (PLT/PLM format,
    verified SURVEY.md Appendix A.2)."""
    out = bytearray()
    chunks = []
    while True:
        chunks.append(v & 0x7F)
        v >>= 7
        if not v:
            break
    for c in reversed(chunks[1:]):
        out.append(0x80 | c)
    out.append(chunks[0])
    return bytes(out)


def write_plt(zplt: int, lengths: list[int],
              return_next: bool = False) -> bytes | tuple[bytes, int]:
    """Splits across multiple PLT segments at varint boundaries when the
    packet list exceeds the 64KB marker length limit.  With return_next,
    also returns the Zplt index the NEXT tile-part's PLT must start at
    (segment indexes are sequential per tile, not per tile-part)."""
    out = bytearray()
    z = zplt
    seg = bytearray()
    for ln in lengths:
        v = _varint(ln)
        if 1 + len(seg) + len(v) > _SEG_DATA_MAX:
            out += marker_segment(PLT, bytes([z & 0xFF]) + bytes(seg))
            z += 1
            seg = bytearray()
        seg += v
    out += marker_segment(PLT, bytes([z & 0xFF]) + bytes(seg))
    if return_next:
        return bytes(out), z + 1
    return bytes(out)


def read_plt(p: bytes) -> list[int]:
    out = []
    v = 0
    for b in p[1:]:
        v = (v << 7) | (b & 0x7F)
        if not (b & 0x80):
            out.append(v)
            v = 0
    return out


def write_plm(zplm: int, tile_part_lengths: list[list[int]]) -> bytes:
    """PLM: packet lengths in the main header; per tile-part a 1-byte
    Nplm (byte count of its varints) then the varint lengths.  Splits
    across multiple PLM segments (Zplm incrementing) at Nplm-chunk
    boundaries when the index exceeds the 64KB marker length limit."""
    out = bytearray()
    z = zplm
    seg = bytearray()
    for lengths in tile_part_lengths:
        body = bytearray()
        for ln in lengths:
            body += _varint(ln)
        # Nplm is one byte; split oversized tile-parts across entries
        for off in range(0, len(body), 255):
            chunk = body[off:off + 255]
            if 1 + len(seg) + 1 + len(chunk) > _SEG_DATA_MAX:
                out += marker_segment(PLM, bytes([z & 0xFF]) + bytes(seg))
                z += 1
                seg = bytearray()
            seg += u8(len(chunk)) + chunk
    out += marker_segment(PLM, bytes([z & 0xFF]) + bytes(seg))
    return bytes(out)


def write_ppt(zppt: int, data: bytes) -> bytes:
    return marker_segment(PPT, u8(zppt) + data)


def write_ppm(zppm: int, data: bytes) -> bytes:
    return marker_segment(PPM, u8(zppm) + data)


def read_crg(p: bytes) -> list[tuple[int, int]]:
    """CRG: per-component registration offsets (Xcrg, Ycrg) in 1/65536
    of the sample spacing."""
    return [struct.unpack(">HH", p[i:i + 4]) for i in range(0, len(p) - 3, 4)]


def write_crg(offsets: list[tuple[int, int]]) -> bytes:
    p = bytearray()
    for (xcrg, ycrg) in offsets:
        p += u16(xcrg) + u16(ycrg)
    return marker_segment(CRG, bytes(p))


# ------------------------------------------------- MCT / MCC / MCO (Part 2)
# Full marker triplet for arbitrary decorrelation transforms
# (SURVEY.md §2.1 "Marker readers/writers": MCT/MCC/MCO).  Wire convention
# (the layout Part-2 encoders emit): the MCT decorrelation array holds the
# DECODING matrix (inverse of the forward transform) and the MCT offset
# array holds the per-component DC offsets added after inverse transform.
# No external oracle exists in this environment — the bundled OpenJPEG
# build rejects COD SGcod MCT=2 outright (custom-MCT decode disabled
# upstream), so like HTJ2K this is gated on self round-trip tests.

MCT_ARRAY_DEPENDENCY = 0
MCT_ARRAY_DECORRELATION = 1
MCT_ARRAY_OFFSET = 2
MCT_ELEM_INT16 = 0
MCT_ELEM_INT32 = 1
MCT_ELEM_FLOAT32 = 2
MCT_ELEM_FLOAT64 = 3
_MCT_ELEM_DTYPES = {0: ">i2", 1: ">i4", 2: ">f4", 3: ">f8"}


def write_mct_record(index: int, array_type: int, elem_type: int,
                     data) -> bytes:
    """One MCT marker segment: Zmct=0 | Imct(index, array & element type
    bit-fields) | Ymct=0 | packed array."""
    import numpy as np

    arr = np.asarray(data).astype(_MCT_ELEM_DTYPES[elem_type])
    imct = (index & 0xFF) | ((array_type & 3) << 8) | ((elem_type & 3) << 10)
    return marker_segment(MCT, u16(0) + u16(imct) + u16(0) + arr.tobytes())


def read_mct(p: bytes):
    """Parse an MCT segment -> (index, array_type, elem_type, float64 flat
    array)."""
    import numpy as np

    imct = int.from_bytes(p[2:4], "big")
    index = imct & 0xFF
    array_type = (imct >> 8) & 3
    elem_type = (imct >> 10) & 3
    arr = np.frombuffer(p[6:], dtype=_MCT_ELEM_DTYPES[elem_type])
    return index, array_type, elem_type, arr.astype(np.float64)


def write_mcc(index: int, nb_comps: int, deco_index: int = 0,
              offset_index: int = 0, irreversible: bool = True) -> bytes:
    """MCC: one array-based decorrelation collection over components
    0..nb_comps-1, referencing the MCT decorrelation/offset arrays by
    index.  Tmcci packs (reversible flag << 16 | offset_idx << 8 |
    deco_idx), big-endian in 3 bytes."""
    p = bytearray()
    p += u16(0)                       # Zmcc (single segment)
    p += u8(index)                    # Imcc
    p += u16(0)                       # Ymcc
    p += u16(1)                       # Qmcc: one collection
    p += u8(1)                        # Xmcci: array-based decorrelation
    mask = 0x8000 if nb_comps > 255 else 0
    p += u16(nb_comps | mask)         # Nmcci (inputs)
    for i in range(nb_comps):
        p += u16(i) if mask else u8(i)
    p += u16(nb_comps | mask)         # Mmcci (outputs)
    for i in range(nb_comps):
        p += u16(i) if mask else u8(i)
    t = ((deco_index & 0xFF) | ((offset_index & 0xFF) << 8)
         | ((0 if irreversible else 1) << 16))
    p += bytes([(t >> 16) & 0xFF, (t >> 8) & 0xFF, t & 0xFF])
    return marker_segment(MCC, bytes(p))


def read_mcc(p: bytes):
    """Parse MCC -> (index, inputs, outputs, deco_index, offset_index,
    irreversible) for the first collection."""
    pos = 2                            # skip Zmcc
    index = p[pos]; pos += 1
    pos += 2                           # Ymcc
    qmcc = int.from_bytes(p[pos:pos + 2], "big"); pos += 2
    if qmcc < 1:
        return index, [], [], 0, 0, True
    pos += 1                           # Xmcci
    n = int.from_bytes(p[pos:pos + 2], "big"); pos += 2
    wide, n = bool(n & 0x8000), n & 0x7FFF
    step = 2 if wide else 1
    inputs = [int.from_bytes(p[pos + i * step:pos + (i + 1) * step], "big")
              for i in range(n)]
    pos += n * step
    m = int.from_bytes(p[pos:pos + 2], "big"); pos += 2
    wide, m = bool(m & 0x8000), m & 0x7FFF
    step = 2 if wide else 1
    outputs = [int.from_bytes(p[pos + i * step:pos + (i + 1) * step], "big")
               for i in range(m)]
    pos += m * step
    t = int.from_bytes(p[pos:pos + 3], "big")
    return (index, inputs, outputs, t & 0xFF, (t >> 8) & 0xFF,
            not bool((t >> 16) & 1))


def write_mco(indices: list[int]) -> bytes:
    """MCO: ordered list of MCC collection indices applied at decode."""
    return marker_segment(MCO, u8(len(indices))
                          + b"".join(u8(i) for i in indices))


def read_mco(p: bytes) -> list[int]:
    n = p[0]
    return list(p[1:1 + n])
