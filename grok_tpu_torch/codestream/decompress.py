"""Codestream decompression driver.

Parity: CodeStreamDecompress (SURVEY.md §2.1 "Codestream decompress",
src/lib/core/codestream/CodeStreamDecompress*.cpp [P]): marker-driven main
header parse into CodingParams, SOT/SOD tile-part scan, per-tile header
overrides (COD/COC/QCD/QCC/POC/RGN), PPM/PPT packed headers, tolerant
"non-strict" mode for truncated/corrupt streams, TLM-based tile seeking.

With a `device`, each tile's HT codeblocks decode there (one launch of the
device HT decoder a tile) and the synthesis of eligible tiles runs there
(the port's tile processor), with several uniform tiles in one batched
call.  The strip decode keeps one tile's synthesis in flight on the card
(DeferredPlanes) while the next tile's Tier-2 and Tier-1 are issued.  A
full decode given a mesh (parallel/mesh.py) shards the batched synthesis
over its devices, on the host route too; strip decodes take no mesh.
"""

from __future__ import annotations

import copy
import logging
import struct
from dataclasses import dataclass, field

import numpy as np
import torch

from ..errors import CodestreamError
from ..image import ColorSpace, GrkImage, ImageComponent
from ..params import CodingParams, DecompressParams, TileCodingParams, \
    TileComponentCodingParams
from ..parallel import mesh as pmesh
from ..tile.geometry import Rect, tile_rect
from ..tile.processor import (DeferredPlanes, TileDecompressor,
                              acquire_tile, host_backend,
                              reconstruct_device_batched, release_tile)
from ..trace import span
from . import markers as mk

log = logging.getLogger("grok_tpu_torch")


class _PendingTile:
    """In-flight tile decode: device synthesis issued but not yet
    materialized (decode-side pipelining — the next tile's host entropy
    runs while this one's synthesis executes on the card).  The cache, if
    any, receives the host planes once they are read back."""

    __slots__ = ("planes", "rects", "ckey", "cache")

    def __init__(self, planes, rects, ckey, cache):
        self.planes = planes
        self.rects = rects
        self.ckey = ckey
        self.cache = cache

    def finish(self):
        result = (self.planes.materialize(), self.rects)
        if self.ckey is not None:
            self.cache.put(self.ckey, result)
        return result


def _assemble(pieces) -> np.ndarray:
    """grok_tpu's strip assembly: the bounding box of the (rect, plane)
    pieces, each pasted in order, zeros where none landed."""
    ry0 = min(r.y0 for r, _ in pieces)
    ry1 = max(r.y1 for r, _ in pieces)
    rx0 = min(r.x0 for r, _ in pieces)
    rx1 = max(r.x1 for r, _ in pieces)
    strip = np.zeros((ry1 - ry0, rx1 - rx0), dtype=np.int32)
    for r, plane in pieces:
        strip[r.y0 - ry0:r.y1 - ry0, r.x0 - rx0:r.x1 - rx0] = plane
    return strip


class _RowStrips:
    """One tile row's strips, one a component, filled as the row's tiles
    are read: each plane is pasted into its strip at once and dropped, so
    a row holds its strips and little more (on a card the pinned buffer of
    a tile goes back to the pool before the next but one is read).  The
    result is _assemble's: each component's planes normally share the
    row's rows and lie within `extents` (the canvas columns at the decode's
    resolution), and a plane that does not turns what was pasted so far
    into one piece of _assemble."""

    def __init__(self, extents: dict[int, tuple[int, int]]):
        self.extents = extents
        self.boxes: dict[int, tuple[Rect, np.ndarray]] = {}
        self.pieces: dict[int, list] = {}

    def add(self, compno: int, r: Rect, plane: np.ndarray) -> None:
        x0, x1 = self.extents[compno]
        pieces = self.pieces.setdefault(compno, [])
        fits = x0 <= r.x0 and r.x1 <= x1
        if compno not in self.boxes and not pieces and fits:
            self.boxes[compno] = (r, np.zeros((r.h, x1 - x0), np.int32))
        if compno in self.boxes:
            box, strip = self.boxes[compno]
            if fits and (r.y0, r.y1) == (box.y0, box.y1):
                strip[:, r.x0 - x0:r.x1 - x0] = plane
                self.boxes[compno] = (Rect(min(box.x0, r.x0), box.y0,
                                           max(box.x1, r.x1), box.y1), strip)
                return
            del self.boxes[compno]
            pieces.append((box, strip[:, box.x0 - x0:box.x1 - x0]))
        pieces.append((r, plane))

    def strips(self) -> dict[int, np.ndarray]:
        """The row's strips by component; the row keeps no reference."""
        out = {}
        for compno, pieces in self.pieces.items():
            if compno not in self.boxes:
                out[compno] = _assemble(pieces)
                continue
            box, strip = self.boxes[compno]
            x0 = self.extents[compno][0]
            out[compno] = strip if (box.x0, box.x1) == (
                x0, x0 + strip.shape[1]) else np.ascontiguousarray(
                strip[:, box.x0 - x0:box.x1 - x0])
        self.boxes.clear()
        self.pieces.clear()
        return out


@dataclass
class TilePartData:
    tile_index: int
    data: bytes


@dataclass
class HeaderInfo:
    siz: mk.SizInfo = None
    cp: CodingParams = None
    image: GrkImage = None
    comments: list[str] = field(default_factory=list)
    cap: dict | None = None
    marker_log: list[tuple[str, int, int]] = field(default_factory=list)
    sop: bool = False
    eph: bool = False
    main_poc: list = field(default_factory=list)
    roi_shifts: dict = field(default_factory=dict)
    crg: list | None = None  # per-component registration offsets

    def reduced_dims(self, reduce: int = 0) -> tuple[int, int, int]:
        """(width, height, clamped_reduce) of the decoded canvas at a
        resolution reduction — the ONE place that owns both the clamp
        (main-header minimum across components) and the canvas-grid
        halving ceil(x1/2^r) - ceil(x0/2^r), which differs from
        ceil((x1-x0)/2^r) for offset images.  Consumers: decode(), the
        decoded canvas sizing."""
        max_reduce = min(t.numresolutions
                         for t in self.cp.tcps[0].tccps) - 1
        r = min(reduce, max_reduce)
        div = 1 << r
        img = self.image
        w = -(-img.x1 // div) - -(-img.x0 // div)
        h = -(-img.y1 // div) - -(-img.y0 // div)
        return w, h, r


class CodestreamDecoder:
    """Parses a raw .j2k codestream and decodes tiles on demand.  `device`
    is where HT Tier-1 and the synthesis of eligible tiles run when the
    decode asks for backend="device" (None: on the host)."""

    def __init__(self, data: bytes, strict: bool = False,
                 device: torch.device | None = None):
        self.device = device
        self.data = data
        self.strict = strict
        self.hi = HeaderInfo()
        self.tile_parts: dict[int, list[bytes]] = {}
        self.tile_plt: dict[int, bytearray] = {}  # concatenated PLT varints
        self.tile_plt_z: dict[int, int | None] = {}  # next expected Zplt
        self.tile_tcps: dict[int, TileCodingParams] = {}
        self.tile_ppt: dict[int, bytearray] = {}
        self.tile_ppt_segs: dict[int, dict] = {}  # Zppt -> payload bytes
        self.tp_sequence: list[int] = []  # tile index per tile-part, in order
        self._plm_segs: dict[int, bytes] = {}  # Zplm -> payload (main hdr)
        # TLM fast path: tile-part spans discovered from the TLM index so
        # tile-part headers/bodies are only touched when a tile is decoded
        # (SURVEY.md §2.1 "Packet-length / TLM caches": seek directly)
        self._lazy_spans: dict[int, list[tuple[int, int]]] = {}
        self._tlm_segs: dict[int, list] = {}
        # per-tile SOP/EPH overrides from tile-part COD markers
        self._tile_sop_eph: dict[int, tuple[bool, bool]] = {}
        self._parsed = False

    # ------------------------------------------------------------- parsing

    def _stream_id(self):
        """Cheap digest identifying this codestream, so TileCache entries
        from one stream never serve another (the public API invites
        reusing one cache across decompress() calls)."""
        sid = getattr(self, "_sid", None)
        if sid is None:
            import hashlib
            # full-buffer digest: equal-length streams that differ only in
            # interior tile bytes must not collide (one decode dwarfs the
            # cost of hashing the whole buffer once)
            h = hashlib.blake2b(self.data, digest_size=16)
            sid = self._sid = (len(self.data), h.digest())
        return sid

    def _err(self, msg: str):
        if self.strict:
            raise CodestreamError(msg)
        log.warning("codestream: %s", msg)

    def parse(self) -> HeaderInfo:
        d = self.data
        if len(d) < 4 or struct.unpack(">H", d[0:2])[0] != mk.SOC:
            raise CodestreamError("missing SOC marker")
        pos = 2
        hi = self.hi
        cp = None
        tcp_template = None
        while pos + 2 <= len(d):
            code = struct.unpack(">H", d[pos:pos + 2])[0]
            if code == mk.EOC:
                hi.marker_log.append(("EOC", pos, 2))
                pos += 2
                break
            if code == mk.SOT:
                if (not self.tile_parts and not self._lazy_spans
                        and cp is not None and getattr(cp, "tlm", None)
                        and cp.ppm_data is None):
                    end = self._tlm_spans(pos, cp.tlm)
                    if end is not None:
                        pos = end
                        continue
                pos = self._parse_tile_part(pos)
                continue
            if pos + 4 > len(d):
                self._err("truncated marker segment")
                break
            seglen = struct.unpack(">H", d[pos + 2:pos + 4])[0]
            payload = d[pos + 4:pos + 2 + seglen]
            name = mk.MARKER_NAMES.get(code, f"0x{code:04X}")
            hi.marker_log.append((name, pos, seglen + 2))
            try:
                self._dispatch_main_marker(code, payload, cp,
                                           tcp_template, hi)
                if code == mk.SIZ and hi.cp is not None:
                    cp = hi.cp
                    tcp_template = cp.tcps[0]
            except (struct.error, IndexError, ValueError, KeyError) as e:
                self._err(f"malformed {name} marker: {e}")
            pos += 2 + seglen
        self.hi.cp = cp
        if cp is None or hi.siz is None:
            raise CodestreamError("codestream has no valid SIZ marker")
        self.hi.image = self._build_image_template()
        self._parsed = True
        return self.hi

    def _dispatch_main_marker(self, code, payload, cp, tcp_template, hi):
        if code == mk.SIZ:
            hi.siz = mk.read_siz(payload)
            hi.cp = self._init_cp(hi.siz)
            return
        if cp is None:
            self._err("marker before SIZ ignored")
            return
        if code == mk.CAP:
            hi.cap = mk.read_cap(payload)
            # Ccap15 set bits: 3 = MIXED (per-codeblock MQ/HT choice).
            # Only Part 15's own Ccap entry counts — other capability
            # bits' values must not enable the per-block coder bit.
            c15 = hi.cap.get("parts", {}).get(15)
            if c15 is not None and (c15 >> 14) == 3:
                cp.ht_mixed = True
        elif code == mk.COD:
            sop, eph = mk.read_cod(payload, tcp_template)
            hi.sop, hi.eph = sop, eph
            self._sync_tcps(cp, tcp_template)
        elif code == mk.COC:
            mk.read_coc(payload, tcp_template, len(hi.siz.comps))
            self._sync_tcps(cp, tcp_template)
        elif code == mk.QCD:
            mk.read_qcd(payload, tcp_template)
            self._sync_tcps(cp, tcp_template)
        elif code == mk.QCC:
            mk.read_qcc(payload, tcp_template, len(hi.siz.comps))
            self._sync_tcps(cp, tcp_template)
        elif code == mk.POC:
            pocs = mk.read_poc(payload, len(hi.siz.comps))
            hi.main_poc = pocs
            for t in cp.tcps:
                t.progression_changes = list(pocs)
        elif code == mk.RGN:
            compno, shift = mk.read_rgn(payload, len(hi.siz.comps))
            if compno >= len(hi.siz.comps):
                raise ValueError(f"RGN component {compno} out of range")
            hi.roi_shifts[compno] = shift
            for t in cp.tcps:
                t.tccps[compno].roi_shift = shift
        elif code == mk.COM:
            hi.comments.append(mk.read_com(payload))
        elif code == mk.TLM:
            # accumulate across multi-segment TLM indexes in Ztlm order
            ztlm, entries = mk.read_tlm(payload)
            self._tlm_segs[ztlm] = self._tlm_segs.get(ztlm, []) + entries
            cp.tlm = [e for z in sorted(self._tlm_segs)
                      for e in self._tlm_segs[z]]
        elif code == mk.PPM:
            # spec orders packed-header content by Zppm, not marker
            # position (mirror of the TLM handling above)
            segs = getattr(self, "_ppm_segs", None)
            if segs is None:
                segs = self._ppm_segs = {}
            zppm = payload[0]
            segs[zppm] = segs.get(zppm, b"") + payload[1:]
            cp.ppm_data = b"".join(segs[z] for z in sorted(segs))
        elif code == mk.MCT:
            idx, at, et, arr = mk.read_mct(payload)
            for t in cp.tcps:
                t.mct_records[idx] = (at, et, arr)
            self._resolve_mct(cp)
        elif code == mk.MCC:
            rec = mk.read_mcc(payload)
            for t in cp.tcps:
                t.mcc_records[rec[0]] = rec
            self._resolve_mct(cp)
        elif code == mk.MCO:
            order = mk.read_mco(payload)
            for t in cp.tcps:
                t.mco_order = order
            self._resolve_mct(cp)
        elif code == mk.PLM:
            # main-header packet-length index: feeds the same O(region)
            # packet-skip machinery PLT does when a tile has no PLT
            self._plm_segs[payload[0]] = payload[1:]
        elif code == mk.CRG:
            hi.crg = mk.read_crg(payload)
        elif code in (mk.PRF, mk.CPF):
            pass  # informative markers
        else:
            self._err(f"unknown marker 0x{code:04X} in main header")

    def _resolve_mct(self, cp: CodingParams):
        """Combine parsed MCT/MCC/MCO into the tile's decoding matrix and
        DC offsets once all three pieces are present (Part-2 custom MCT)."""
        import numpy as np

        for t in cp.tcps:
            if not t.mco_order or not t.mcc_records:
                continue
            mcc = t.mcc_records.get(t.mco_order[0])
            if mcc is None:
                continue
            _, inputs, _, deco_idx, off_idx, _ = mcc
            deco = t.mct_records.get(deco_idx)
            if deco is None or deco[0] != mk.MCT_ARRAY_DECORRELATION:
                continue
            n = len(inputs) or int(round(len(deco[2]) ** 0.5))
            t.mct_dec_matrix = deco[2][:n * n].reshape(n, n)
            off = t.mct_records.get(off_idx)
            if off is not None and off[0] == mk.MCT_ARRAY_OFFSET:
                t.mct_offsets = np.round(off[2][:n]).astype(np.int64)

    MAX_DECODE_PIXELS = 1 << 32  # 4 Gpx canvas sanity cap: fuzzed SIZ
    # values must fail with a codec error, not an attempted TiB allocation

    def _init_cp(self, siz: mk.SizInfo) -> CodingParams:
        if not siz.comps or siz.xtsiz <= 0 or siz.ytsiz <= 0 \
                or siz.xsiz <= siz.xosiz or siz.ysiz <= siz.yosiz:
            raise ValueError("invalid SIZ geometry")
        if (siz.xsiz - siz.xosiz) * (siz.ysiz - siz.yosiz) \
                > self.MAX_DECODE_PIXELS:
            raise ValueError(
                f"SIZ canvas {siz.xsiz - siz.xosiz}x{siz.ysiz - siz.yosiz} "
                f"exceeds the decoder sanity cap")
        for (prec, _, dx, dy) in siz.comps:
            # Part 1 allows Ssiz precision 1..38; spec subsampling 1..255
            if not 1 <= prec <= 38 or not 1 <= dx <= 255 \
                    or not 1 <= dy <= 255:
                raise ValueError(
                    f"invalid SIZ component (prec={prec} dx={dx} dy={dy})")
            if prec > 31:
                # legal to SIGNAL (Ssiz <= 38) but outside our int32
                # sample pipeline: fail cleanly instead of overflowing
                # the DC-unshift bounds downstream (fuzz-found)
                raise ValueError(
                    f"unsupported component precision {prec} (> 31)")
        cp = CodingParams()
        cp.rsiz = siz.rsiz
        cp.tx0, cp.ty0 = siz.xtosiz, siz.ytosiz
        cp.t_width, cp.t_height = siz.xtsiz, siz.ytsiz
        cp.t_grid_w = -(-(siz.xsiz - siz.xtosiz) // siz.xtsiz)
        cp.t_grid_h = -(-(siz.ysiz - siz.ytosiz) // siz.ytsiz)
        # ISO 15444-1 A.5.1: at most 65535 tiles.  A corrupt SIZ with a
        # tiny tile size would otherwise make every per-tile loop O(10^8)
        # (fuzz-found hang), so this is a hard error even in tolerant mode.
        if cp.t_grid_w * cp.t_grid_h > 65535:
            raise ValueError(
                f"SIZ signals {cp.t_grid_w}x{cp.t_grid_h} tiles "
                f"(> 65535, ISO A.5.1)")
        tcp = TileCodingParams()
        for _ in siz.comps:
            tcp.tccps.append(TileComponentCodingParams())
        cp.tcps = [tcp]
        return cp

    def _sync_tcps(self, cp: CodingParams, template: TileCodingParams):
        cp.tcps = [template]

    def _tlm_spans(self, start: int, tlm) -> int | None:
        """Validate the TLM index against the stream and record per-tile
        tile-part spans WITHOUT scanning their headers or copying bodies.
        Returns the position after the last tile-part, or None when the
        index is inconsistent (caller falls back to the sequential walk).
        Not used when PPM is present (PPM distribution needs the full
        tile-part sequence)."""
        d = self.data
        pos = start
        spans: dict[int, list[tuple[int, int]]] = {}
        for (t, ln) in tlm:
            if ln < 14 or pos + 12 > len(d) or pos + ln > len(d):
                return None
            if struct.unpack(">H", bytes(d[pos:pos + 2]))[0] != mk.SOT:
                return None
            isot = struct.unpack(">H", bytes(d[pos + 4:pos + 6]))[0]
            if t is not None and isot != t:
                return None
            spans.setdefault(isot, []).append((pos, pos + ln))
            pos += ln
        self._lazy_spans = spans
        return pos

    def _tile_pkt_lens(self, tidx: int) -> list[int] | None:
        """Per-packet byte lengths from the tile's PLT index (None when no
        PLT was signaled).  Lets decode_packets skip whole packets outside
        the decode window / reduced resolutions / discarded layers without
        parsing their headers — the O(region) random-access path."""
        buf = self.tile_plt.get(tidx)
        if buf:
            return mk.read_plt(b"\x00" + bytes(buf))
        if self._plm_segs:
            idx = self._plm_index()
            if idx is not None:
                return idx.get(tidx) or None
        return None

    def _plm_index(self):
        """Partition the PLM main-header index into per-tile packet-length
        lists.  PLM is ordered by tile-PART: the flat varint stream is
        split by matching each tile-part's cumulative packet bytes against
        its body length (known once the tile-part headers are parsed —
        cheap; the per-packet header decode is what the index avoids)."""
        cached = getattr(self, "_plm_idx_cache", "unset")
        if cached != "unset":
            return cached
        # materialize every tile-part so tp_sequence/body lengths exist
        for t in list(self._lazy_spans.keys()):
            self._ensure_tile(t)
        all_seg = b"".join(self._plm_segs[z]
                           for z in sorted(self._plm_segs))
        flat = bytearray()
        pos = 0
        while pos < len(all_seg):
            n = all_seg[pos]
            pos += 1
            flat += all_seg[pos:pos + n]
            pos += n
        lengths = mk.read_plt(b"\x00" + bytes(flat))
        per_tile: dict[int, list[int]] = {t: [] for t in self.tile_parts}
        counters = {t: 0 for t in self.tile_parts}
        li = 0
        ok = True
        for t in self.tp_sequence:
            parts = self.tile_parts.get(t) or []
            ci = counters.get(t, 0)
            if ci >= len(parts):
                ok = False
                break
            counters[t] = ci + 1
            budget = len(parts[ci])
            s = 0
            while s < budget and li < len(lengths):
                per_tile[t].append(lengths[li])
                s += lengths[li]
                li += 1
            if s != budget:
                ok = False
                break
        if not ok:
            log.warning("PLM index inconsistent with tile-part bodies; "
                        "falling back to packet-header parsing")
        self._plm_idx_cache = per_tile if ok else None
        return self._plm_idx_cache

    def _ensure_tile(self, tidx: int) -> None:
        """Parse the tile-parts of one tile on first use (TLM fast path)."""
        for (s, _e) in self._lazy_spans.pop(tidx, ()):
            self._parse_tile_part(s)

    def _parse_tile_part(self, pos: int) -> int:
        d = self.data
        if pos + 12 > len(d):
            self._err("truncated SOT marker")
            return len(d)
        seglen = struct.unpack(">H", d[pos + 2:pos + 4])[0]
        if seglen < 10:  # Lsot is exactly 10; a shorter payload cannot
            self._err("malformed SOT marker")  # hold Isot/Psot/TPsot/TNsot
            return len(d)
        isot, psot, tpsot, tnsot = mk.read_sot(d[pos + 4:pos + 2 + seglen])
        self.hi.marker_log.append((f"SOT(t={isot},tp={tpsot})", pos, seglen + 2))
        tp_start = pos
        pos += 2 + seglen
        if psot == 0:
            psot = len(d) - tp_start  # last tile-part extends to EOC
        tp_end = min(tp_start + psot, len(d))
        # scan tile-part header markers until SOD
        if self.hi.cp is None:
            self._err("tile-part before a valid SIZ; skipped")
            return tp_end
        tile_tcp = self.tile_tcps.get(isot)
        if tile_tcp is None:
            tile_tcp = self.hi.cp.tcps[0].clone()
            self.tile_tcps[isot] = tile_tcp
        while pos + 2 <= tp_end:
            code = struct.unpack(">H", d[pos:pos + 2])[0]
            if code == mk.SOD:
                pos += 2
                self.tile_parts.setdefault(isot, []).append(d[pos:tp_end])
                self.tp_sequence.append(isot)
                return tp_end
            if pos + 4 > tp_end:
                self._err("truncated tile-part header")
                return tp_end
            seglen2 = struct.unpack(">H", d[pos + 2:pos + 4])[0]
            payload = d[pos + 4:pos + 2 + seglen2]
            name = mk.MARKER_NAMES.get(code, f"0x{code:04X}")
            self.hi.marker_log.append((name, pos, seglen2 + 2))
            try:
                if code == mk.COD:
                    self._tile_sop_eph[isot] = mk.read_cod(payload, tile_tcp)
                elif code == mk.COC:
                    mk.read_coc(payload, tile_tcp, len(self.hi.siz.comps))
                elif code == mk.QCD:
                    mk.read_qcd(payload, tile_tcp)
                elif code == mk.QCC:
                    mk.read_qcc(payload, tile_tcp, len(self.hi.siz.comps))
                elif code == mk.POC:
                    tile_tcp.progression_changes = mk.read_poc(
                        payload, len(self.hi.siz.comps))
                elif code == mk.RGN:
                    compno, shift = mk.read_rgn(
                        payload, len(self.hi.siz.comps))
                    tile_tcp.tccps[compno].roi_shift = shift
                elif code == mk.PPT:
                    # content is ordered by Zppt, not marker position
                    segs = self.tile_ppt_segs.setdefault(isot, {})
                    zppt = payload[0]
                    segs[zppt] = segs.get(zppt, b"") + payload[1:]
                    buf = self.tile_ppt.setdefault(isot, bytearray())
                    buf.clear()
                    for z in sorted(segs):
                        buf += segs[z]
                elif code == mk.PLT:
                    # packet-length index: drives O(region) packet skipping
                    # (SURVEY.md §3.3 "PLT ... make this O(region)").
                    # Varint bytes are concatenated across segments (a
                    # length may straddle a Zplt boundary in other
                    # encoders' streams), so segment ORDER matters: an
                    # out-of-sequence Zplt poisons the tile's index and we
                    # fall back to full packet-header parsing.
                    zplt = payload[0]
                    expect = self.tile_plt_z.get(isot, 0)
                    if expect is None:
                        pass  # index already dropped for this tile
                    elif zplt != expect:
                        log.warning(
                            "PLT Zplt %d out of sequence (expected %d) in "
                            "tile %d; dropping its packet-length index",
                            zplt, expect, isot)
                        self.tile_plt.pop(isot, None)
                        self.tile_plt_z[isot] = None
                    else:
                        self.tile_plt_z[isot] = expect + 1
                        self.tile_plt.setdefault(isot, bytearray()).extend(
                            payload[1:])
                elif code == mk.COM:
                    pass
                else:
                    self._err(
                        f"unknown marker 0x{code:04X} in tile-part header")
            except (struct.error, IndexError, ValueError, KeyError) as e:
                self._err(f"malformed {name} in tile-part header: {e}")
            pos += 2 + seglen2
        self._err("tile-part without SOD")
        return tp_end

    def _build_image_template(self) -> GrkImage:
        siz = self.hi.siz
        img = GrkImage(x0=siz.xosiz, y0=siz.yosiz, x1=siz.xsiz, y1=siz.ysiz)
        for (prec, sgnd, dx, dy) in siz.comps:
            c = ImageComponent(dx=dx, dy=dy, prec=prec, sgnd=sgnd)
            c.x0 = -(-siz.xosiz // dx)
            c.y0 = -(-siz.yosiz // dy)
            c.w = -(-siz.xsiz // dx) - c.x0
            c.h = -(-siz.ysiz // dy) - c.y0
            img.comps.append(c)
        n = len(siz.comps)
        img.color_space = (ColorSpace.SRGB if n >= 3 else ColorSpace.GRAY)
        return img

    # ------------------------------------------------------------- decoding

    def decode(self, p: DecompressParams, cache=None,
               mesh=None) -> GrkImage:
        """Decode the image; `mesh` (p.mesh resolved by
        parallel.mesh.resolve_mesh, or None) is where the batched
        synthesis of the uniform full-size tiles shards."""
        if not self._parsed:
            self.parse()
        hi = self.hi
        cp = hi.cp
        with span("grk/decode/tiles"):
            img = self._build_image_template()
            _, _, reduce_ = hi.reduced_dims(p.reduce)
            if reduce_ != p.reduce:
                self._err(f"reduce={p.reduce} exceeds available resolutions; "
                          f"clamping to {reduce_}")

            img_rect = Rect(hi.siz.xosiz, hi.siz.yosiz, hi.siz.xsiz, hi.siz.ysiz)
            win = Rect(*p.window) if p.window else None

            # allocate reduced-size component planes; with a decode window the
            # canvas covers only the window (O(window) memory end to end)
            div = 1 << reduce_
            canvas_origin = []  # reduced-grid (ry0, rx0) per component
            shapes = []
            for c in img.comps:
                if win is not None:
                    wx0 = max(-(-win.x0 // c.dx), c.x0)
                    wy0 = max(-(-win.y0 // c.dy), c.y0)
                    wx1 = min(-(-win.x1 // c.dx), c.x0 + c.w)
                    wy1 = min(-(-win.y1 // c.dy), c.y0 + c.h)
                else:
                    wx0, wy0 = c.x0, c.y0
                    wx1, wy1 = c.x0 + c.w, c.y0 + c.h
                rx0 = -(-wx0 // div)
                ry0 = -(-wy0 // div)
                rx1 = -(-wx1 // div)
                ry1 = -(-wy1 // div)
                shapes.append((max(0, ry1 - ry0), max(0, rx1 - rx0)))
                canvas_origin.append((ry0, rx0))
            # refuse BEFORE allocating: output pixels = the largest
            # component plane (so an RGB image counts its dimensions once)
            self._check_pixel_budget(
                max((h0 * w0 for (h0, w0) in shapes), default=0), p)
            try:
                for c, shape in zip(img.comps, shapes):
                    c.data = np.zeros(shape, dtype=np.int32)
            except MemoryError:
                raise CodestreamError(
                    "image too large to allocate for decode") from None

            self._distribute_ppm()
        tiles = range(cp.numtiles)
        if p.tile_index is not None:
            tiles = [p.tile_index]

        batched = {}
        # reduce/window always fail per-tile device eligibility later, so
        # gate here before paying the per-tile Tier-1 work twice; so does
        # an sp mesh that cannot row-shard the default tile height (tiles
        # whose tile-part COD changes the resolutions are checked again
        # in reconstruct_device_batched)
        sp = 1 if mesh is None else pmesh.sp_size(mesh)
        sp_ok = sp == 1 or pmesh.sp_transform_ok(
            mesh, cp.t_height, cp.tcps[0].tccps[0].numresolutions)
        if (p.backend == "device" or mesh is not None) \
                and (cp.numtiles > 1 or sp > 1) and sp_ok \
                and p.tile_index is None and win is None and reduce_ == 0:
            batched = self._decode_tiles_device_batched(
                list(tiles), p, img, reduce_, mesh)

        for tidx in tiles:
            if tidx in batched:
                result = batched[tidx]
            else:
                result = self.decode_tile_planes(tidx, p, img, reduce_,
                                                 win=win, cache=cache)
            if result is None:
                continue
            planes, rects = result
            # paste tile planes into the reduced component canvases,
            # clipped (window-produce rects carry lifting margins)
            with span("grk/decode/paste"):
                for compno, (plane, rr) in enumerate(zip(planes, rects)):
                    comp = img.comps[compno]
                    ry0, rx0 = canvas_origin[compno]
                    ch, cw = comp.data.shape
                    sy0 = max(0, ry0 - rr.y0)
                    sx0 = max(0, rx0 - rr.x0)
                    dy0 = max(0, rr.y0 - ry0)
                    dx0 = max(0, rr.x0 - rx0)
                    hh = min(rr.h - sy0, ch - dy0)
                    ww = min(rr.w - sx0, cw - dx0)
                    if hh > 0 and ww > 0:
                        comp.data[dy0:dy0 + hh, dx0:dx0 + ww] = \
                            plane[sy0:sy0 + hh, sx0:sx0 + ww]
        for compno, c in enumerate(img.comps):
            c.h, c.w = c.data.shape
            c.y0, c.x0 = canvas_origin[compno]
        return img

    def _distribute_ppm(self):
        """PPM packed headers (SURVEY.md §2.1): the main-header stream holds
        one Nppm-framed chunk per tile-part, in tile-part arrival order;
        route each chunk to its tile's packed-header buffer."""
        cp = self.hi.cp
        if not cp.ppm_data:
            return
        data = cp.ppm_data
        off = 0
        for tidx in self.tp_sequence:
            if off + 4 > len(data):
                break
            n = struct.unpack(">I", data[off:off + 4])[0]
            off += 4
            chunk = data[off:off + n]
            off += n
            self.tile_ppt.setdefault(tidx, bytearray()).extend(chunk)
        cp.ppm_data = None  # consumed

    def _check_pixel_budget(self, out_px: int, p) -> None:
        """Refuse decodes whose output exceeds the caller's (or the
        library's) pixel budget — pixels = samples of the largest
        component plane, so multi-component images count their
        dimensions once."""
        budget = p.max_pixels or self.MAX_DECODE_PIXELS
        if out_px > budget:
            raise CodestreamError(
                f"decode output {out_px} px exceeds the "
                f"{'caller' if p.max_pixels else 'library'} pixel "
                f"budget {budget}")

    def _tile_decompressor(self, tidx, tcp, tile, p, img, reduce_, win):
        return TileDecompressor(
            tile, tcp, img, self.hi.cp,
            self.device if p.backend == "device" else None,
            backend=host_backend(p.backend), reduce=reduce_,
            max_layers=p.max_layers, window=win,
            pkt_lens=self._tile_pkt_lens(tidx), num_threads=p.num_threads)

    def _decode_packets(self, td, tidx, data, p):
        """Tier-2 parse of one tile, tolerant unless strict."""
        sop, eph = self._tile_sop_eph.get(tidx, (self.hi.sop, self.hi.eph))
        try:
            td.decode_packets(data, sop=sop, eph=eph,
                              strict=self.strict or p.strict)
        except Exception as e:  # tolerant decode
            if self.strict or p.strict:
                if isinstance(e, CodestreamError):
                    raise
                raise CodestreamError(
                    f"tile {tidx}: packet parse error: {e}") from e
            log.warning("tile %d: packet parse error: %s", tidx, e)

    @staticmethod
    def _plane_rects(tile, tcp, reduce_):
        rects = []
        for compno, tc in enumerate(tile.comps):
            numres_used = max(1, tcp.tccps[compno].numresolutions - reduce_)
            rects.append(tc.resolutions[numres_used - 1].rect)
        return rects

    def _decode_tiles_device_batched(self, tiles, p, img, reduce_,
                                     mesh=None):
        """Batched device synthesis over all uniform full-size tiles,
        sharded over `mesh` when given.  Returns {tidx: (planes, rects)}
        for the tiles it handled."""
        cp = self.hi.cp
        hi = self.hi
        img_rect = Rect(hi.siz.xosiz, hi.siz.yosiz, hi.siz.xsiz, hi.siz.ysiz)
        prepared = []
        for tidx in tiles:
            tq, tp_ = divmod(tidx, cp.t_grid_w)
            trect = tile_rect(tp_, tq, cp.t_width, cp.t_height,
                              cp.tx0, cp.ty0, img_rect)
            if trect.is_empty() or trect.w != cp.t_width \
                    or trect.h != cp.t_height:
                continue
            with span("grk/decode/parse"):
                self._ensure_tile(tidx)
            parts = self.tile_parts.get(tidx)
            if not parts:
                continue
            with span("grk/decode/tiles"):
                tcp = self.tile_tcps.get(tidx) or cp.tcps[0]
                tcp.ppt_data = bytes(self.tile_ppt.get(tidx, b"")) or None
                tile = acquire_tile(tidx, trect, img, tcp)
                td = self._tile_decompressor(tidx, tcp, tile, p, img,
                                             reduce_, None)
            with span("grk/decode/t2"):
                self._decode_packets(td, tidx, b"".join(parts), p)
            td.run_t1()
            prepared.append((tidx, tcp, tile, td))
        if not prepared:
            return {}
        with span("grk/decode/transform"):
            result = reconstruct_device_batched(
                [td for (*_, td) in prepared], mesh=mesh)
        out = {}
        with span("grk/decode/paste"):
            for (tidx, tcp, tile, td) in prepared:
                if result is not None:
                    out[tidx] = (result[id(td)],
                                 self._plane_rects(tile, tcp, reduce_))
                # not eligible after all: the per-tile loop redoes the
                # decode
                release_tile(tile)
        return out

    def decode_tile_planes(self, tidx: int, p: DecompressParams, img,
                           reduce_: int, win: Rect | None = None,
                           cache=None, defer: bool = False):
        """Decode one tile to per-component planes (+ their reduced-grid
        rects).  Returns None for empty / out-of-window / missing tiles.
        An optional TileCache serves repeat requests.  With `defer`, a
        tile synthesised on the card comes back as a _PendingTile whose
        finish() reads its planes."""
        cp = self.hi.cp
        hi = self.hi
        img_rect = Rect(hi.siz.xosiz, hi.siz.yosiz, hi.siz.xsiz, hi.siz.ysiz)
        tq, tp_ = divmod(tidx, cp.t_grid_w)
        trect = tile_rect(tp_, tq, cp.t_width, cp.t_height,
                          cp.tx0, cp.ty0, img_rect)
        if trect.is_empty():
            return None
        if win is not None and trect.intersect(win).is_empty():
            return None
        ckey = None
        if cache is not None and win is None:
            ckey = cache.key(tidx, reduce_, p.max_layers, self._stream_id())
            hit = cache.get(ckey)
            if hit is not None:
                return hit
        with span("grk/decode/parse"):
            self._ensure_tile(tidx)
        parts = self.tile_parts.get(tidx)
        if not parts:
            self._err(f"no data for tile {tidx}")
            return None
        tcp = self.tile_tcps.get(tidx) or cp.tcps[0]
        if reduce_ >= min(t.numresolutions for t in tcp.tccps):
            # a tile-part COD with fewer levels than the main header would
            # produce planes on a coarser grid than the canvas: skip it
            self._err(f"tile {tidx}: reduce {reduce_} exceeds the tile's "
                      f"resolution count; tile skipped")
            return None
        with span("grk/decode/tiles"):
            tcp.ppt_data = bytes(self.tile_ppt.get(tidx, b"")) or None
            tile = acquire_tile(tidx, trect, img, tcp)
            td = self._tile_decompressor(tidx, tcp, tile, p, img, reduce_,
                                         win)
        with span("grk/decode/t2"):
            self._decode_packets(td, tidx, b"".join(parts), p)
        td.run_t1()
        with span("grk/decode/transform"):
            planes = td.reconstruct(defer=defer)
        deferred = isinstance(planes, DeferredPlanes)
        rects = (None if deferred else getattr(td, "_out_rects", None)) \
            or self._plane_rects(tile, tcp, reduce_)
        # O(window) introspection for tests/observability
        self.last_band_bytes = sum(
            a.nbytes for a in getattr(td, "_band_arrays", {}).values())
        # planes/rects are independent of the tree; a deferred synthesis
        # owns its output tensor and runs on the stream its inputs were
        # made on, so the pool may take the tile back now
        with span("grk/decode/paste"):
            release_tile(tile)
        if deferred:
            return _PendingTile(planes, rects, ckey, cache)
        result = (planes, rects)
        if ckey is not None:
            cache.put(ckey, result)
        return result

    def decode_strips(self, p: DecompressParams,
                      strip_height: int | None = None):
        """Strip-streaming decode (StripCache parity, SURVEY.md §2.1):
        yields (y0, {compno: plane_rows}).

        Default granularity is one tile row; with a device, a tile's
        synthesis stays in flight while the next tile's Tier-2 and Tier-1
        are issued.  With `strip_height` (canvas rows), each strip is
        produced through the window-aware decode path instead (host
        synthesis, counted in HOST_PATH_TILES), so memory is O(strip) even
        when tiles are taller than the strip."""
        if not self._parsed:
            self.parse()
        if strip_height is not None and strip_height <= 0:
            raise ValueError("strip_height must be positive")
        # the pixel budget applies to the FULL (reduced) output even
        # though strips bound memory — the CLI strip path would
        # otherwise happily write a multi-gigabyte file for a tiny
        # untrusted stream
        w0, h0, red0 = self.hi.reduced_dims(p.reduce)
        self._check_pixel_budget(w0 * h0, p)
        if strip_height is not None:
            hi = self.hi
            div0 = 1 << red0
            y = hi.siz.yosiz
            while y < hi.siz.ysiz:
                y1 = min(y + strip_height, hi.siz.ysiz)
                sp = copy.copy(p)
                sp.window = (hi.siz.xosiz, y, hi.siz.xsiz, y1)
                img = self.decode(sp)
                yield (-(-y // div0),
                       {ci: c.data for ci, c in enumerate(img.comps)})
                y = y1
            return
        cp = self.hi.cp
        img = self._build_image_template()
        reduce_ = red0
        div = 1 << reduce_
        extents = {ci: (-(-c.x0 // div), -(-(c.x0 + c.w) // div))
                   for ci, c in enumerate(img.comps)}
        defer = p.backend == "device" and self.device is not None
        for tq in range(cp.t_grid_h):
            row = _RowStrips(extents)
            y0_out = None
            # depth-1 software pipeline: tile tp's synthesis is issued on
            # the card and read back only after tile tp+1's Tier-2 and
            # Tier-1 have been issued
            pending = None

            def consume(result, row=row):
                nonlocal y0_out
                if result is None:
                    return
                if isinstance(result, _PendingTile):
                    result = result.finish()
                planes, rects = result
                for compno, (plane, rr) in enumerate(zip(planes, rects)):
                    row.add(compno, rr, plane)
                    if y0_out is None:
                        y0_out = rects[0].y0

            for tp_ in range(cp.t_grid_w):
                tidx = tq * cp.t_grid_w + tp_
                started = self.decode_tile_planes(
                    tidx, p, img, reduce_, defer=defer)
                consume(pending)
                pending = started
            consume(pending)
            strips = row.strips()
            if not strips:
                continue
            yield y0_out, strips
            del strips  # not held while the next row decodes
