"""Tier-2: packet iteration and packet header/body coding.

Parity: T2Compress/T2Decompress, PacketIter, PacketManager (SURVEY.md §2.1
"Tier-2", src/lib/core/t2/ [P]; ISO/IEC 15444-1 B.9-B.12):

- all five progression orders (LRCP RLCP RPCL PCRL CPRL) with POC
  progression changes (SURVEY.md B.7)
- inclusion + zero-bitplane tag trees per precinct/band
- pass-count coding, Lblock length signaling, codeword-segment splitting
  (TERMALL/LAZY aware)
- SOP resync markers and EPH header-end markers

The packet body layout and header bit semantics are verified against oracle
streams (tests/test_oracle_interop.py).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..params import CblkStyle, Progression, TileCodingParams
from ..tile.geometry import Codeblock, PrecinctBand, Resolution, Tile
from ..t1.coder import segment_layout
from .bitio import BitReader, BitWriter
from .tagtree import TagTree

SOP_MARKER = b"\xff\x91"
EPH_MARKER = b"\xff\x92"

# Native Tier-2 header coder (native/t2.cc); the pure-Python functions
# below remain the correctness oracle and write the same bytes.  Where the
# native library does not build, backend="python" runs on them, and the
# native backends raise with g++'s output (t1/backend.py resolve).
try:
    from . import native as _native
except (OSError, RuntimeError):
    _native = None


def reset_precinct(prc) -> None:
    """Reset all Tier-2 state of a precinct (native side; callers reset the
    Python-side tag trees / codeblock counters themselves)."""
    if _native is not None:
        _native.reset_precinct(prc)


# ---------------------------------------------------------------------------
# Packet iteration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PacketCoord:
    compno: int
    resno: int
    layno: int
    precno: int


def _precinct_anchors(tile: Tile, comp_info) -> dict:
    """For each (compno, resno): map canvas anchor position -> precno.

    comp_info[c] = (dx, dy, numres).  The anchor of precinct (pi, pj) is its
    unclipped canvas start, clamped to the tile edge for the first row/col
    (ISO 15444-1 B.12.1.3 position-iteration conditions)."""
    anchors: dict[tuple[int, int], dict[tuple[int, int], int]] = {}
    t = tile.rect
    for c, tc in enumerate(tile.comps):
        dx, dy, numres = comp_info[c]
        nl = numres - 1
        for r, res in enumerate(tc.resolutions):
            amap: dict[tuple[int, int], int] = {}
            s = nl - r
            rr = res.rect
            if res.pw and res.ph:
                for pj in range(res.ph):
                    for pi in range(res.pw):
                        rx = ((rr.x0 >> res.ppx) + pi) << res.ppx
                        ry = ((rr.y0 >> res.ppy) + pj) << res.ppy
                        ax = dx * (rx << s)
                        ay = dy * (ry << s)
                        ax = max(ax, t.x0)
                        ay = max(ay, t.y0)
                        amap[(ax, ay)] = pj * res.pw + pi
            anchors[(c, r)] = amap
    return anchors


def packet_order(
    tile: Tile,
    tcp: TileCodingParams,
    comp_info,
    max_res_override: int | None = None,
    max_packets: int | None = None,
) -> list[PacketCoord]:
    """Enumerate every packet of a tile in codestream order, honoring the
    COD progression and any POC progression changes.

    max_packets bounds the enumeration for DECODERS: a corrupt COD can
    legally signal 65535 layers, making the full order list millions of
    entries for a tiny tile-part (fuzz-found slowdown); every real
    packet costs stream bytes, so callers cap by the data size."""
    numcomps = len(tile.comps)
    numlayers = tcp.numlayers
    maxres = max(ci[2] for ci in comp_info)
    if max_res_override is not None:
        maxres = min(maxres, max_res_override)

    anchors = _precinct_anchors(tile, comp_info)
    xs = sorted({a[0] for amap in anchors.values() for a in amap})
    ys = sorted({a[1] for amap in anchors.values() for a in amap})

    def volume(prog: Progression, lay_s, lay_e, res_s, res_e, comp_s, comp_e):
        """Yield coords of one progression volume in `prog` order."""
        comp_e = min(comp_e, numcomps)
        res_e_all = min(res_e, maxres)

        def precincts(c, r):
            if r >= comp_info[c][2]:
                return 0
            res = tile.comps[c].resolutions[r]
            return res.pw * res.ph

        if prog == Progression.LRCP:
            for l in range(lay_s, lay_e):
                for r in range(res_s, res_e_all):
                    for c in range(comp_s, comp_e):
                        for p in range(precincts(c, r)):
                            yield PacketCoord(c, r, l, p)
        elif prog == Progression.RLCP:
            for r in range(res_s, res_e_all):
                for l in range(lay_s, lay_e):
                    for c in range(comp_s, comp_e):
                        for p in range(precincts(c, r)):
                            yield PacketCoord(c, r, l, p)
        elif prog == Progression.RPCL:
            for r in range(res_s, res_e_all):
                for y in ys:
                    for x in xs:
                        for c in range(comp_s, comp_e):
                            if r >= comp_info[c][2]:
                                continue
                            p = anchors[(c, r)].get((x, y))
                            if p is None:
                                continue
                            for l in range(lay_s, lay_e):
                                yield PacketCoord(c, r, l, p)
        elif prog == Progression.PCRL:
            for y in ys:
                for x in xs:
                    for c in range(comp_s, comp_e):
                        for r in range(res_s, min(res_e, comp_info[c][2])):
                            p = anchors[(c, r)].get((x, y))
                            if p is None:
                                continue
                            for l in range(lay_s, lay_e):
                                yield PacketCoord(c, r, l, p)
        elif prog == Progression.CPRL:
            for c in range(comp_s, comp_e):
                for y in ys:
                    for x in xs:
                        for r in range(res_s, min(res_e, comp_info[c][2])):
                            p = anchors[(c, r)].get((x, y))
                            if p is None:
                                continue
                            for l in range(lay_s, lay_e):
                                yield PacketCoord(c, r, l, p)
        else:  # pragma: no cover
            raise ValueError(prog)

    cap = max_packets if max_packets is not None else float("inf")
    out: list[PacketCoord] = []
    if tcp.progression_changes:
        seen: set[PacketCoord] = set()
        for ch in tcp.progression_changes:
            for pc in volume(ch.prog, 0, min(ch.lay_e, numlayers),
                             ch.res_s, ch.res_e, ch.comp_s, ch.comp_e):
                if pc not in seen:
                    seen.add(pc)
                    out.append(pc)
                    if len(out) >= cap:
                        return out
        # remaining packets, if any, follow the COD progression
        for pc in volume(tcp.prog_order, 0, numlayers, 0, maxres, 0, numcomps):
            if pc not in seen:
                seen.add(pc)
                out.append(pc)
                if len(out) >= cap:
                    return out
    else:
        for pc in volume(tcp.prog_order, 0, numlayers, 0, maxres, 0, numcomps):
            out.append(pc)
            if len(out) >= cap:
                return out
    return out


# ---------------------------------------------------------------------------
# Precinct Tier-2 state
# ---------------------------------------------------------------------------

def _ensure_trees(pband: PrecinctBand, for_encoder: bool = False) -> None:
    if pband.incl_tree is None:
        pband.incl_tree = TagTree(pband.cblk_w, pband.cblk_h)
        pband.imsb_tree = TagTree(pband.cblk_w, pband.cblk_h)
        if for_encoder:
            # leaf values must be set before the first (possibly empty)
            # packet of this precinct is encoded
            for i, cblk in enumerate(pband.cblks):
                first = next(
                    (ln for ln, np_ in enumerate(cblk.num_passes_by_layer)
                     if np_ > 0), len(cblk.num_passes_by_layer))
                pband.incl_tree.set_value(i, first)
                pband.imsb_tree.set_value(i, cblk.zero_bitplanes)


def _floorlog2(x: int) -> int:
    return x.bit_length() - 1


# pass-count code (SURVEY.md B.6)
def _write_numpasses(bio: BitWriter, n: int) -> None:
    if n == 1:
        bio.write_bit(0)
    elif n == 2:
        bio.write_bits(0b10, 2)
    elif n <= 5:
        bio.write_bits(0b11, 2)
        bio.write_bits(n - 3, 2)
    elif n <= 36:
        bio.write_bits(0b1111, 4)
        bio.write_bits(n - 6, 5)
    else:
        bio.write_bits(0b111111111, 9)
        bio.write_bits(n - 37, 7)


def _read_numpasses(bio: BitReader) -> int:
    if not bio.read_bit():
        return 1
    if not bio.read_bit():
        return 2
    v = bio.read_bits(2)
    if v < 3:
        return 3 + v
    v = bio.read_bits(5)
    if v < 31:
        return 6 + v
    return 37 + bio.read_bits(7)


def _contribution_runs(cblk: Codeblock, style: CblkStyle, numbps: int,
                       first_pass: int, num_new: int):
    """Split passes [first_pass, first_pass+num_new) into codeword-segment
    runs: list of (start, npasses, is_terminal_chunk)."""
    segs = segment_layout(style, numbps)
    bounds = []
    for plist, _ in segs:
        bounds.append((plist[0], plist[-1]))
    runs = []
    p = first_pass
    end = first_pass + num_new
    while p < end:
        for (s0, s1) in bounds:
            if s0 <= p <= s1:
                take = min(end - 1, s1) - p + 1
                runs.append((p, take))
                p += take
                break
        else:
            # beyond known layout (shouldn't happen) — single run
            runs.append((p, end - p))
            break
    return runs


# ---------------------------------------------------------------------------
# Packet encoding
# ---------------------------------------------------------------------------

def encode_packet(
    res: Resolution,
    precno: int,
    layno: int,
    style: CblkStyle,
    sop: bool = False,
    eph: bool = False,
    sop_index: int = 0,
    split_header: bool = False,
    mixed: bool = False,
) -> bytes | tuple[bytes, bytes]:
    """Encode one packet, routing the header coding through the native
    Tier-2 coder when available (byte-identical to encode_packet_py)."""
    if _native is None:
        return encode_packet_py(res, precno, layno, style, sop, eph,
                                sop_index, split_header, mixed)
    prc = res.precincts[precno]
    h = _native.get_handle(prc)
    hdr, ranges = h.encode(layno, style, mixed)
    body = bytearray()
    for i, cblk in enumerate(h.cblks):
        s = ranges[2 * i]
        if s >= 0:
            body += cblk.data[s:ranges[2 * i + 1]]
    hdr = hdr + (EPH_MARKER if eph else b"")
    if split_header:
        return hdr, bytes(body)
    out = bytearray()
    if sop:
        out += SOP_MARKER + b"\x00\x04" + bytes([(sop_index >> 8) & 0xFF,
                                                 sop_index & 0xFF])
    out += hdr
    out += body
    return bytes(out)


def packet_size(res, precno: int, layno: int, style: CblkStyle,
                mixed: bool = False) -> int:
    """Size in bytes of one packet (header + body) without materializing
    it — the Tier-2 dry-run primitive for rate control."""
    if _native is None:
        return len(encode_packet_py(res, precno, layno, style,
                                    mixed=mixed))
    h = _native.get_handle(res.precincts[precno])
    return h.size(layno, style, mixed)


def encode_packet_py(
    res: Resolution,
    precno: int,
    layno: int,
    style: CblkStyle,
    sop: bool = False,
    eph: bool = False,
    sop_index: int = 0,
    split_header: bool = False,
    mixed: bool = False,
) -> bytes | tuple[bytes, bytes]:
    """Encode one packet (header + body).  Codeblock layer assignments
    (num_passes_by_layer) must already be set by rate control.

    With split_header=True the (header, body) pair is returned separately
    for PPT/PPM packed-header emission (SOP is not applicable then).

    With mixed=True (Part-15 MIXED set) one extra bit follows the
    zero-bitplane coding at first inclusion: 1 = HT codeblock, 0 = MQ.
    No normative T.814 text is available in this environment, so like the
    CxtVLC tables (t1/ht.py) this per-block signal uses a documented
    self-consistent convention gated on self round-trip tests."""
    prc = res.precincts[precno]
    bio = BitWriter()
    body = bytearray()

    any_contrib = False
    for pband in prc.pbands:
        for cblk in pband.cblks:
            if layno < len(cblk.num_passes_by_layer) and \
                    cblk.num_passes_by_layer[layno] > 0:
                any_contrib = True
                break
        if any_contrib:
            break

    out = bytearray()
    if sop and not split_header:
        out += SOP_MARKER + b"\x00\x04" + bytes([(sop_index >> 8) & 0xFF,
                                                 sop_index & 0xFF])
    if not any_contrib:
        bio.write_bit(0)
        bio.flush()
        hdr = bio.getvalue() + (EPH_MARKER if eph else b"")
        if split_header:
            return hdr, b""
        return bytes(out) + hdr

    bio.write_bit(1)
    for pband in prc.pbands:
        if not pband.cblks:
            continue
        _ensure_trees(pband, for_encoder=True)
        for i, cblk in enumerate(pband.cblks):
            npasses_layer = (cblk.num_passes_by_layer[layno]
                             if layno < len(cblk.num_passes_by_layer) else 0)
            already = cblk.included_in_layer >= 0
            if not already:
                pband.incl_tree.encode(bio, i, layno + 1)
            else:
                bio.write_bit(1 if npasses_layer else 0)
            if not npasses_layer:
                continue
            if not already:
                # newly included: communicate zero bitplanes fully
                pband.imsb_tree.encode(bio, i, cblk.zero_bitplanes + 1)
                if mixed:
                    bio.write_bit(1 if getattr(cblk, "is_ht", False) else 0)
                cblk.included_in_layer = layno
                cblk.lblock = 3
                cblk.total_passes = 0
            _write_numpasses(bio, npasses_layer)
            # codeword-segment runs in this contribution
            runs = _contribution_runs(cblk, style, cblk.numbps,
                                      cblk.total_passes, npasses_layer)
            chunks = []
            for (p0, np_) in runs:
                start = cblk.pass_rates[p0 - 1] if p0 > 0 else 0
                endb = cblk.pass_rates[p0 + np_ - 1]
                chunks.append((endb - start, np_))
            # Lblock update: one comma code fitting all runs
            needed = 0
            for (ln, np_) in chunks:
                bits = max(1, ln.bit_length()) - _floorlog2(np_)
                needed = max(needed, bits)
            if needed > cblk.lblock:
                for _ in range(needed - cblk.lblock):
                    bio.write_bit(1)
                cblk.lblock = needed
            bio.write_bit(0)
            for (ln, np_) in chunks:
                bio.write_bits(ln, cblk.lblock + _floorlog2(np_))
            # body bytes
            start = (cblk.pass_rates[cblk.total_passes - 1]
                     if cblk.total_passes > 0 else 0)
            endb = cblk.pass_rates[cblk.total_passes + npasses_layer - 1]
            body += cblk.data[start:endb]
            cblk.total_passes += npasses_layer
    bio.flush()
    hdr = bio.getvalue() + (EPH_MARKER if eph else b"")
    if split_header:
        return hdr, bytes(body)
    out += hdr
    out += body
    return bytes(out)


# ---------------------------------------------------------------------------
# Packet decoding
# ---------------------------------------------------------------------------

def _check_nsop(data, pos: int, sop_index: int) -> None:
    """Validate an SOP marker segment at data[pos:] against the expected
    packet counter (T.800 A.8.1: Lsop == 4, Nsop == counter mod 65536).
    A mismatch means the stream lost sync — raise so the tolerant caller
    can scan for a consistent SOP instead of mis-attaching bodies."""
    if sop_index < 0:
        return
    if data[pos + 2:pos + 4] != b"\x00\x04":
        raise ValueError(f"bad SOP Lsop at offset {pos}")
    nsop = (data[pos + 4] << 8) | data[pos + 5]
    if nsop != (sop_index & 0xFFFF):
        raise ValueError(
            f"SOP Nsop {nsop} at offset {pos} does not match expected "
            f"packet {sop_index & 0xFFFF}")


def find_sop_resync(data, start: int, cur_index: int,
                    num_packets: int) -> tuple[int, int] | None:
    """Mid-tile SOP resynchronization (SURVEY.md §5 error resilience):
    scan data[start:] for the next SOP marker whose Nsop is CONSISTENT —
    a well-formed Lsop and an Nsop that maps (mod 65536) to a packet
    index in (cur_index, num_packets).  Returns (marker offset, resume
    packet index), or None when no consistent marker remains.  A stray
    0xFF91 inside a packet body fails the consistency test and the scan
    continues past it."""
    d = bytes(data) if not isinstance(data, (bytes, bytearray)) else data
    scan = start
    while True:
        nxt = d.find(SOP_MARKER, scan)
        if nxt < 0 or nxt + 6 > len(d):
            return None
        scan = nxt + 2
        if d[nxt + 2:nxt + 4] != b"\x00\x04":
            continue
        nsop = (d[nxt + 4] << 8) | d[nxt + 5]
        # packet counters wrap at 65536: resume at the smallest index
        # beyond the failed packet congruent to Nsop
        k = cur_index + 1 + ((nsop - (cur_index + 1)) % 0x10000)
        if k < num_packets:
            return nxt, k


def decode_packet(
    data: bytes,
    pos: int,
    res: Resolution,
    precno: int,
    layno: int,
    style: CblkStyle,
    band_numbps: dict[int, int],
    sop: bool = False,
    eph: bool = False,
    hdr_data: bytes | None = None,
    hdr_pos: int = 0,
    discard: bool = False,
    mixed: bool = False,
    sop_index: int = -1,
) -> tuple[int, int]:
    """Decode one packet, routing the header parse through the native
    Tier-2 coder when available (state mirrored onto the codeblocks so
    downstream Tier-1 sees exactly what decode_packet_py maintains).
    `sop_index` >= 0 is the expected Nsop (packet counter mod 65536); a
    present SOP whose Nsop disagrees raises so the tolerant caller can
    resynchronize on a consistent marker."""
    if _native is None:
        return decode_packet_py(data, pos, res, precno, layno, style,
                                band_numbps, sop, eph, hdr_data, hdr_pos,
                                discard, mixed, sop_index)
    prc = res.precincts[precno]
    in_ppt = hdr_data is not None
    if data[pos:pos + 2] == SOP_MARKER:
        _check_nsop(data, pos, sop_index)
        pos += 6
    elif sop and not in_ppt:
        raise ValueError(f"expected SOP marker at offset {pos}")
    # chunk capacity: one codeword segment per packet contribution unless
    # TERMALL/LAZY split segments (then up to one per pass)
    maxch = _native.MAX_CHUNKS if int(style) & 0x05 else 2
    h = _native.get_handle(prc, maxch)
    mb = [band_numbps[pb.band_orient] for pb in prc.pbands]
    if in_ppt:
        hdr_pos = h.decode(layno, style, mixed, hdr_data, hdr_pos, mb)
        if eph and hdr_data[hdr_pos:hdr_pos + 2] == EPH_MARKER:
            hdr_pos += 2
    else:
        pos = h.decode(layno, style, mixed, data, pos, mb)
        if eph and data[pos:pos + 2] == EPH_MARKER:
            pos += 2
    incl = h.out_incl
    newly = h.out_newly
    nchunks = h.out_nchunks
    chunks = h.out_chunks
    maxch = h.maxch
    for i, cblk in enumerate(h.cblks):
        if not incl[i]:
            continue
        if newly[i]:
            cblk.zero_bitplanes = int(h.out_zb[i])
            cblk.numbps = mb[h.cblk_band[i]] - cblk.zero_bitplanes
            if mixed:
                cblk.is_ht = bool(h.out_isht[i])
            cblk.included_in_layer = layno
            cblk.lblock = 3
            cblk.total_passes = 0
        if discard and not hasattr(cblk, "decode_pass_cap"):
            cblk.decode_pass_cap = cblk.total_passes
        base = i * maxch * 2
        for k in range(int(nchunks[i])):
            np_ = int(chunks[base + 2 * k])
            ln = int(chunks[base + 2 * k + 1])
            cblk.seg_data.append(data[pos:pos + ln])
            cblk.seg_passes.append(np_)
            cblk.total_passes += np_
            pos += ln
    return pos, hdr_pos


def decode_packet_py(
    data: bytes,
    pos: int,
    res: Resolution,
    precno: int,
    layno: int,
    style: CblkStyle,
    band_numbps: dict[int, int],
    sop: bool = False,
    eph: bool = False,
    hdr_data: bytes | None = None,
    hdr_pos: int = 0,
    discard: bool = False,
    mixed: bool = False,
    sop_index: int = -1,
) -> tuple[int, int]:
    """Decode one packet header, attach body byte ranges to codeblocks, and
    return (new body position, new header position).  When `hdr_data` is
    given, headers come from the PPM/PPT packed-header stream (SURVEY.md
    §2.1 "Codestream decompress": PPM/PPT packed headers) and only bodies
    live at data[pos:].  `band_numbps` maps band orientation -> M_b."""
    prc = res.precincts[precno]
    in_ppt = hdr_data is not None
    if data[pos:pos + 2] == SOP_MARKER:
        _check_nsop(data, pos, sop_index)
        pos += 6
    elif sop and not in_ppt:
        # SOP signaled but missing where a packet should start: the stream
        # is corrupt here — let the caller resync on the next SOP marker
        raise ValueError(f"expected SOP marker at offset {pos}")
    if in_ppt:
        bio = BitReader(hdr_data, hdr_pos)
    else:
        bio = BitReader(data, pos)

    def finish_header():
        nonlocal pos, hdr_pos
        bio.align()
        if in_ppt:
            hdr_pos = bio.pos
            if eph and hdr_data[hdr_pos:hdr_pos + 2] == EPH_MARKER:
                hdr_pos += 2
        else:
            pos = bio.pos
            if eph and data[pos:pos + 2] == EPH_MARKER:
                pos += 2

    if not bio.read_bit():
        finish_header()
        return pos, hdr_pos

    to_read: list[tuple[Codeblock, list[tuple[int, int]]]] = []
    for pband in prc.pbands:
        if not pband.cblks:
            continue
        _ensure_trees(pband)
        mb = band_numbps[pband.band_orient]
        for i, cblk in enumerate(pband.cblks):
            already = cblk.included_in_layer >= 0
            if not already:
                included = pband.incl_tree.decode(bio, i, layno + 1)
            else:
                included = bool(bio.read_bit())
            if not included:
                continue
            if not already:
                k = 1
                while not pband.imsb_tree.decode(bio, i, k):
                    k += 1
                cblk.zero_bitplanes = k - 1
                cblk.numbps = mb - cblk.zero_bitplanes
                if mixed:
                    # MIXED set: per-block coder bit (see encode_packet)
                    cblk.is_ht = bool(bio.read_bit())
                cblk.included_in_layer = layno
                cblk.lblock = 3
                cblk.total_passes = 0
            npasses_layer = _read_numpasses(bio)
            runs = _contribution_runs(cblk, style, cblk.numbps,
                                      cblk.total_passes, npasses_layer)
            # comma code
            while bio.read_bit():
                cblk.lblock += 1
            chunks = []
            for (p0, np_) in runs:
                ln = bio.read_bits(cblk.lblock + _floorlog2(np_))
                chunks.append((np_, ln))
            to_read.append((cblk, chunks))
    finish_header()
    # body.  With discard (-l max_layers), parsing still advances all
    # codeblock state so later headers stay in sync, but a decode cap is
    # recorded so Tier-1 stops at the layer boundary.
    for cblk, chunks in to_read:
        if discard and not hasattr(cblk, "decode_pass_cap"):
            cblk.decode_pass_cap = cblk.total_passes
        for (np_, ln) in chunks:
            cblk.seg_data.append(data[pos:pos + ln])
            cblk.seg_passes.append(np_)
            cblk.total_passes += np_
            pos += ln
    return pos, hdr_pos


def collect_seg_lengths(cblk: Codeblock, style: CblkStyle):
    """Convert the decoder's received chunks into (data, seg_lengths, total
    passes) for t1.decode_cblk: chunk boundaries inside one segment merge."""
    npasses = min(cblk.total_passes,
                  getattr(cblk, "decode_pass_cap", cblk.total_passes))
    if len(cblk.seg_data) == 1:
        # single received chunk: every pass starts in segment 0, so the
        # general path below reduces to one length — skip the layout walk
        # and the bytes join (the common single-layer case)
        data = cblk.seg_data[0]
        return data, [len(data)], npasses
    segs = segment_layout(style, cblk.numbps)
    seg_of_pass = {}
    for si, (plist, _) in enumerate(segs):
        for p in plist:
            seg_of_pass[p] = si
    data = b"".join(cblk.seg_data)
    seg_lens: dict[int, int] = {}
    p = 0
    for chunk, np_ in zip(cblk.seg_data, cblk.seg_passes):
        si = seg_of_pass.get(p, 0)
        seg_lens[si] = seg_lens.get(si, 0) + len(chunk)
        p += np_
    ordered = [seg_lens[k] for k in sorted(seg_lens)]
    return data, ordered, npasses
