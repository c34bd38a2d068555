"""A plain JPEG 2000 Part 1 / Part 15 codestream reader: main header, tile
parts and Tier-2 packet headers, down to each code-block's coded bytes.

Written for the benchmark's judge from ISO/IEC 15444-1 Annex A (markers)
and Annex B (tiles, bands, code-blocks, packets, tag trees).  It reads what
the benchmark's configurations produce: any number of tiles, tile-parts and
layers, the five progression orders with one precinct a resolution (no
precinct sizes, no POC), SOP and EPH markers, MQ code-blocks of any style
and HT code-blocks with their cleanup pass only.  Anything else raises
NotImplementedError, so a configuration it cannot judge fails loudly.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

SOC, SOT, SOD = 0xFF4F, 0xFF90, 0xFF93
SIZ, COD, COC, QCD, QCC, POC, RGN, PPM, PPT = (
    0xFF51, 0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5F, 0xFF5E, 0xFF60, 0xFF61)
SOP_BYTES, EPH_BYTES = b"\xff\x91", b"\xff\x92"

LL, HL, LH, HH = 0, 1, 2, 3
BAND_GAIN = {LL: 0, HL: 1, LH: 1, HH: 2}
# (x, y) offsets of a band in its resolution (Annex B.5)
BAND_OFFSET = {LL: (0, 0), HL: (1, 0), LH: (0, 1), HH: (1, 1)}

STYLE_LAZY, STYLE_RESET, STYLE_TERMALL = 0x01, 0x02, 0x04
STYLE_VSC, STYLE_SEGSYM, STYLE_HT = 0x08, 0x20, 0x40


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass
class Header:
    width: int
    height: int
    x0: int
    y0: int
    tile_w: int
    tile_h: int
    tile_x0: int
    tile_y0: int
    precs: list[int]
    sgnds: list[bool]
    progression: int
    layers: int
    mct: int
    numres: int
    xcb: int
    ycb: int
    style: int
    reversible: bool
    sop: bool
    eph: bool
    guard_bits: int
    quant_style: int
    steps: list[tuple[int, int]]  # (exponent, mantissa) per band, LL first

    @property
    def ht(self) -> bool:
        return bool(self.style & STYLE_HT)

    @property
    def numcomps(self) -> int:
        return len(self.precs)

    def step(self, resno: int, orient: int) -> tuple[int, int]:
        """(exponent, mantissa) of a band, by the quantization style."""
        if self.quant_style == 1:  # scalar derived from the LL value
            e, m = self.steps[0]
            nb = self.numres - (1 if resno == 0 else resno)
            return e - (self.numres - 1) + nb, m
        return self.steps[0 if resno == 0 else 3 * (resno - 1) + orient]

    def delta(self, compno: int, resno: int, orient: int) -> float:
        """The quantizer step of a band (Annex E.1)."""
        e, m = self.step(resno, orient)
        rb = self.precs[compno] + BAND_GAIN[orient]
        return (1.0 + m / 2048.0) * 2.0 ** (rb - e)

    def mb(self, resno: int, orient: int) -> int:
        """Most bit-planes of a band's coefficients: guard + exponent - 1."""
        return max(0, self.guard_bits + self.step(resno, orient)[0] - 1)


@dataclass
class Block:
    compno: int
    resno: int
    orient: int
    x0: int  # in band coordinates
    y0: int
    x1: int
    y1: int
    included: bool = False
    zero_bitplanes: int = 0
    numbps: int = 0
    lblock: int = 3
    passes: int = 0
    chunks: list = field(default_factory=list)  # (npasses, bytes)

    @property
    def h(self) -> int:
        return self.y1 - self.y0

    @property
    def w(self) -> int:
        return self.x1 - self.x0

    @property
    def data(self) -> bytes:
        return b"".join(c for _, c in self.chunks)


@dataclass
class Band:
    compno: int
    resno: int
    orient: int
    x0: int
    y0: int
    x1: int
    y1: int
    nbx: int = 0
    nby: int = 0
    blocks: list[Block] = field(default_factory=list)
    incl: "TagTree | None" = None
    zbp: "TagTree | None" = None


@dataclass
class Tile:
    index: int
    x0: int
    y0: int
    x1: int
    y1: int
    bands: dict = field(default_factory=dict)  # (compno, resno, orient)
    body: bytes = b""


def _u16(b, o):
    return struct.unpack_from(">H", b, o)[0]


def _u32(b, o):
    return struct.unpack_from(">I", b, o)[0]


def read_header(cs: bytes) -> tuple[Header, int]:
    """The main header, and the offset of the first SOT."""
    if _u16(cs, 0) != SOC:
        raise ValueError("no SOC marker")
    pos, seg = 2, {}
    while True:
        code = _u16(cs, pos)
        if code == SOT:
            break
        length = _u16(cs, pos + 2)
        body = cs[pos + 4:pos + 2 + length]
        if code in (COC, QCC, POC, RGN, PPM, PPT):
            raise NotImplementedError(f"marker {code:#06x} is not judged")
        seg.setdefault(code, body)
        pos += 2 + length
    s = seg[SIZ]
    x1, y1, x0, y0, tw, th, tx0, ty0 = struct.unpack_from(">8I", s, 2)
    nc = _u16(s, 34)
    precs, sgnds = [], []
    for c in range(nc):
        ssiz, dx, dy = s[36 + 3 * c:39 + 3 * c]
        if dx != 1 or dy != 1:
            raise NotImplementedError("subsampled components are not judged")
        precs.append((ssiz & 0x7F) + 1)
        sgnds.append(bool(ssiz & 0x80))
    c = seg[COD]
    if c[0] & 1:
        raise NotImplementedError("precinct sizes are not judged")
    q = seg[QCD]
    qstyle = q[0] & 0x1F
    if qstyle == 0:
        steps = [(b >> 3, 0) for b in q[1:]]
    else:
        steps = [(v >> 11, v & 0x7FF) for v in
                 struct.unpack_from(f">{(len(q) - 1) // 2}H", q, 1)]
    hdr = Header(width=x1 - x0, height=y1 - y0, x0=x0, y0=y0, tile_w=tw,
                 tile_h=th, tile_x0=tx0, tile_y0=ty0, precs=precs,
                 sgnds=sgnds, progression=c[1], layers=_u16(c, 2), mct=c[4],
                 numres=c[5] + 1, xcb=(c[6] & 0xF) + 2, ycb=(c[7] & 0xF) + 2,
                 style=c[8], reversible=c[9] == 1, sop=bool(c[0] & 2),
                 eph=bool(c[0] & 4), guard_bits=q[0] >> 5, quant_style=qstyle,
                 steps=steps)
    return hdr, pos


# ------------------------------------------------------------- geometry

def band_rect(tx0, ty0, tx1, ty1, numres, resno, orient):
    """A band's rectangle in band coordinates (Annex B.5, equation B-15)."""
    nb = numres - 1 if resno == 0 else numres - resno
    if nb == 0:
        return tx0, ty0, tx1, ty1
    xo, yo = BAND_OFFSET[orient]
    h = 1 << (nb - 1)
    return (cdiv(tx0 - h * xo, 1 << nb), cdiv(ty0 - h * yo, 1 << nb),
            cdiv(tx1 - h * xo, 1 << nb), cdiv(ty1 - h * yo, 1 << nb))


def build_tile(hdr: Header, index: int) -> Tile:
    ntx = cdiv(hdr.x0 + hdr.width - hdr.tile_x0, hdr.tile_w)
    p, q = index % ntx, index // ntx
    x0 = max(hdr.tile_x0 + p * hdr.tile_w, hdr.x0)
    y0 = max(hdr.tile_y0 + q * hdr.tile_h, hdr.y0)
    x1 = min(hdr.tile_x0 + (p + 1) * hdr.tile_w, hdr.x0 + hdr.width)
    y1 = min(hdr.tile_y0 + (q + 1) * hdr.tile_h, hdr.y0 + hdr.height)
    tile = Tile(index, x0, y0, x1, y1)
    cw, ch = 1 << hdr.xcb, 1 << hdr.ycb
    for c in range(hdr.numcomps):
        for r in range(hdr.numres):
            for o in ((LL,) if r == 0 else (HL, LH, HH)):
                bx0, by0, bx1, by1 = band_rect(x0, y0, x1, y1, hdr.numres,
                                               r, o)
                band = Band(c, r, o, bx0, by0, bx1, by1)
                if bx1 > bx0 and by1 > by0:
                    gx0, gy0 = bx0 // cw, by0 // ch
                    band.nbx = cdiv(bx1, cw) - gx0
                    band.nby = cdiv(by1, ch) - gy0
                    for j in range(band.nby):
                        for i in range(band.nbx):
                            band.blocks.append(Block(
                                c, r, o,
                                max(bx0, (gx0 + i) * cw),
                                max(by0, (gy0 + j) * ch),
                                min(bx1, (gx0 + i + 1) * cw),
                                min(by1, (gy0 + j + 1) * ch)))
                    band.incl = TagTree(band.nbx, band.nby)
                    band.zbp = TagTree(band.nbx, band.nby)
                tile.bands[(c, r, o)] = band
    return tile


# ------------------------------------------------------------- tier-2 bits

class BitReader:
    """Packet-header bits: after a 0xFF byte the next carries 7 bits."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos
        self.acc = self.avail = 0
        self.prev_ff = False

    def bit(self) -> int:
        if self.avail == 0:
            b = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.acc = b
            self.avail = 7 if self.prev_ff else 8
            self.prev_ff = b == 0xFF
        self.avail -= 1
        return (self.acc >> self.avail) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> int:
        """End of a header: the byte after a final 0xFF is its stuffing."""
        if self.prev_ff:
            self.pos += 1
        return self.pos


class TagTree:
    """A tag tree's decoder (Annex B.10.2)."""

    def __init__(self, w: int, h: int):
        self.levels = []  # finest first: (w, h, value, low)
        while True:
            n = w * h
            self.levels.append([w, h, [1 << 30] * n, [0] * n])
            if w == 1 and h == 1:
                break
            w, h = (w + 1) // 2, (h + 1) // 2

    def decode(self, br: BitReader, i: int, j: int, threshold: int) -> bool:
        """Learn leaf (i, j) up to `threshold`; True when it is below."""
        path = []
        for w, _, value, low in self.levels:
            path.append((value, low, j * w + i))
            i, j = i // 2, j // 2
        lo = 0
        for value, low, k in reversed(path):
            lo = max(lo, low[k])
            while lo < threshold and lo < value[k]:
                if br.bit():
                    value[k] = lo
                else:
                    lo += 1
            low[k] = lo
        value, _, k = path[0]
        return value[k] < threshold

    def value(self, i: int, j: int) -> int:
        w = self.levels[0][0]
        return self.levels[0][2][j * w + i]


def num_passes(br: BitReader) -> int:
    """The number-of-passes code (Table B.4)."""
    if not br.bit():
        return 1
    if not br.bit():
        return 2
    v = br.bits(2)
    if v < 3:
        return 3 + v
    v = br.bits(5)
    if v < 31:
        return 6 + v
    return 37 + br.bits(7)


def segment_ends(style: int, numbps: int) -> list[int]:
    """The pass index that ends each codeword segment of an MQ code-block
    (Annex D.4: with LAZY, the raw SPP/MRP passes from the fifth plane on
    form segments of their own; TERMALL ends one at every pass)."""
    total = 3 * numbps - 2
    ends = []
    for p in range(total):
        plane = numbps - 1 - (p + 2) // 3  # pass 0 is the first cleanup
        kind = 2 if p == 0 else (p - 1) % 3  # 0 SPP, 1 MRP, 2 CUP
        last = p == total - 1
        if last or style & STYLE_TERMALL:
            ends.append(p)
        elif style & STYLE_LAZY and (
                (kind == 2 and plane <= numbps - 4)
                or (kind == 1 and plane <= numbps - 5)):
            ends.append(p)
    return ends


def _contribution(blk: Block, style: int, first: int, n: int) -> list[int]:
    """Split passes [first, first + n) into codeword-segment runs."""
    if style & STYLE_HT:
        if first + n > 1:
            raise NotImplementedError("HT refinement passes are not judged")
        return [n]
    ends = segment_ends(style, blk.numbps)
    runs, p = [], first
    while p < first + n:
        end = next((e for e in ends if e >= p), first + n - 1)
        take = min(end, first + n - 1) - p + 1
        runs.append(take)
        p += take
    return runs


def read_packet(cs: bytes, pos: int, bands: list[Band], layer: int,
                hdr: Header) -> int:
    """One packet (Annex B.10): header bits, then the bodies."""
    if hdr.sop and cs[pos:pos + 2] == SOP_BYTES:
        pos += 6
    br = BitReader(cs, pos)
    todo = []
    if br.bit():
        for band in bands:
            mb = hdr.mb(band.resno, band.orient)
            for k, blk in enumerate(band.blocks):
                i, j = k % band.nbx, k // band.nbx
                if not blk.included:
                    if not band.incl.decode(br, i, j, layer + 1):
                        continue
                    zb = 1
                    while not band.zbp.decode(br, i, j, zb):
                        zb += 1
                    blk.zero_bitplanes = zb - 1
                    blk.numbps = mb - blk.zero_bitplanes
                    blk.included = True
                elif not br.bit():
                    continue
                n = num_passes(br)
                runs = _contribution(blk, hdr.style, blk.passes, n)
                while br.bit():
                    blk.lblock += 1
                lens = [br.bits(blk.lblock + r.bit_length() - 1)
                        for r in runs]
                blk.passes += n
                todo.append((blk, runs, lens))
    pos = br.align()
    if hdr.eph and cs[pos:pos + 2] == EPH_BYTES:
        pos += 2
    for blk, runs, lens in todo:
        for r, ln in zip(runs, lens):
            blk.chunks.append((r, cs[pos:pos + ln]))
            pos += ln
    return pos


def packet_order(hdr: Header):
    """(layer, resno, compno) in the progression's order, one precinct a
    resolution."""
    L, R, C = range(hdr.layers), range(hdr.numres), range(hdr.numcomps)
    prog = hdr.progression
    if prog == 0:  # LRCP
        return [(l, r, c) for l in L for r in R for c in C]
    if prog == 1:  # RLCP
        return [(l, r, c) for r in R for l in L for c in C]
    if prog == 2:  # RPCL
        return [(l, r, c) for r in R for c in C for l in L]
    return [(l, r, c) for c in C for r in R for l in L]  # PCRL, CPRL


def read_codestream(cs: bytes) -> tuple[Header, list[Tile]]:
    """Every tile, with every code-block's coded bytes attached."""
    hdr, pos = read_header(cs)
    tiles: dict[int, Tile] = {}
    while pos + 2 <= len(cs) and _u16(cs, pos) == SOT:
        isot, psot = _u16(cs, pos + 4), _u32(cs, pos + 6)
        end = pos + psot if psot else len(cs) - 2
        pos += 12
        while _u16(cs, pos) != SOD:
            if _u16(cs, pos) in (COD, COC, QCD, QCC, POC, RGN, PPT):
                raise NotImplementedError("tile-part header markers are "
                                          "not judged")
            pos += 2 + _u16(cs, pos + 2)
        tile = tiles.setdefault(isot, Tile(isot, 0, 0, 0, 0))
        tile.body += cs[pos + 2:end]
        pos = end
    out = []
    for index in sorted(tiles):
        tile = build_tile(hdr, index)
        body, p = tiles[index].body, 0
        for layer, r, c in packet_order(hdr):
            orients = (LL,) if r == 0 else (HL, LH, HH)
            bands = [tile.bands[(c, r, o)] for o in orients
                     if tile.bands[(c, r, o)].blocks]
            if not bands:
                continue
            p = read_packet(body, p, bands, layer, hdr)
        tile.body = body
        out.append(tile)
    return hdr, out


def packet_bytes(cs: bytes) -> int:
    """The bytes of every tile-part less its SOT..SOD header: the packets
    that rate control budgets."""
    _, pos = read_header(cs)
    total = 0
    while pos + 2 <= len(cs) and _u16(cs, pos) == SOT:
        start, psot = pos, _u32(cs, pos + 6)
        pos += 12
        while _u16(cs, pos) != SOD:
            pos += 2 + _u16(cs, pos + 2)
        total += psot - (pos + 2 - start)
        pos = start + psot
    return total
