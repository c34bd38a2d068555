"""EBCOT Tier-1 bit-plane coder (Part 1, MQ path) — Python reference.

Parity: T1Part1 (SURVEY.md §2.1 "Tier-1 Part 1", src/lib/core/t1/part1/ [P];
algorithm per ISO/IEC 15444-1 Annex D).  This module is the correctness
oracle; the production path is the native C++ backend (native/t1.cc) and,
for context formation, Pallas device kernels (SURVEY.md §7 hard part #1).

Scan pattern: 4-row stripes, columns left-to-right, 4 samples top-to-bottom.
Three passes per bit-plane: significance propagation (SPP), magnitude
refinement (MRP), cleanup (CUP); the first coded pass of a codeblock is a
CUP at bit-plane numbps-1.

Code-block styles supported: LAZY (selective MQ bypass), RESET, TERMALL,
VSC, SEGSYM, PTERM (SURVEY.md B.4).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..params import CblkStyle
from .mq import (
    CTX_MAG,
    CTX_RL,
    CTX_SC,
    CTX_UNI,
    CTX_ZC,
    MQDecoder,
    MQEncoder,
    RawDecoder,
    RawEncoder,
)

# band orientations (match tile.geometry)
LL, HL, LH, HH = 0, 1, 2, 3

# Which orientations use the transposed (V-primary) significance table.
# ISO 15444-1 Table D.1: the "LL and LH subbands" column is H-primary; the
# HL subband interchanges the H and V sums.  Verified against the OpenJPEG
# oracle by tests/test_oracle_interop.py.
_ZC_TRANSPOSED = {HL}


def _zc_context(h: int, v: int, d: int, orient: int) -> int:
    """Significance-coding context 0..8 from neighbor counts (Table D.1)."""
    if orient == HH:
        hv = h + v
        if d >= 3:
            return 8
        if d == 2:
            return 7 if hv >= 1 else 6
        if d == 1:
            if hv >= 2:
                return 5
            return 4 if hv == 1 else 3
        if hv >= 2:
            return 2
        return 1 if hv == 1 else 0
    if orient in _ZC_TRANSPOSED:
        h, v = v, h
    if h == 2:
        return 8
    if h == 1:
        if v >= 1:
            return 7
        return 6 if d >= 1 else 5
    if v == 2:
        return 4
    if v == 1:
        return 3
    if d >= 2:
        return 2
    return 1 if d == 1 else 0


# sign-coding context Table D.2 (SURVEY.md B.4): (H, V) -> (offset, xorbit)
#   H=1: V=1 -> 13/0, V=0 -> 12/0, V=-1 -> 11/0
#   H=0: V=1 -> 10/0, V=0 ->  9/0, V=-1 -> 10/1
#   H=-1: mirrored with xorbit 1
_SC_TABLE = {
    (1, 1): (4, 0), (1, 0): (3, 0), (1, -1): (2, 0),
    (0, 1): (1, 0), (0, 0): (0, 0), (0, -1): (1, 1),
    (-1, 1): (2, 1), (-1, 0): (3, 1), (-1, -1): (4, 1),
}


@dataclass
class PassInfo:
    passtype: int      # 0 = SPP, 1 = MRP, 2 = CUP
    bpno: int
    term: bool         # ends a codeword segment
    rate: int          # cumulative truncation length in bytes
    dist: float        # cumulative distortion decrease (unweighted)


class _State:
    """Per-codeblock coding state shared by encoder and decoder.

    All arrays carry a 1-sample border of permanently-insignificant samples
    so neighbor reads need no bounds checks (interior coords are 1-based).
    """

    def __init__(self, h: int, w: int):
        self.h = h
        self.w = w
        self.sig = np.zeros((h + 2, w + 2), dtype=np.uint8)
        self.sgn = np.zeros((h + 2, w + 2), dtype=np.uint8)  # 1 = negative
        self.visited = np.zeros((h + 2, w + 2), dtype=np.uint8)
        self.refined = np.zeros((h + 2, w + 2), dtype=np.uint8)

    def neighbor_counts(self, y: int, x: int, vsc_row3: bool):
        """(h, v, d) significant-neighbor counts at interior coords."""
        s = self.sig
        hh = int(s[y, x - 1]) + int(s[y, x + 1])
        if vsc_row3:
            vv = int(s[y - 1, x])
            dd = int(s[y - 1, x - 1]) + int(s[y - 1, x + 1])
        else:
            vv = int(s[y - 1, x]) + int(s[y + 1, x])
            dd = (int(s[y - 1, x - 1]) + int(s[y - 1, x + 1])
                  + int(s[y + 1, x - 1]) + int(s[y + 1, x + 1]))
        return hh, vv, dd

    def sc_context(self, y: int, x: int, vsc_row3: bool):
        """Sign-coding (context, xorbit)."""
        s, g = self.sig, self.sgn

        def contrib(yy, xx):
            if not s[yy, xx]:
                return 0
            return -1 if g[yy, xx] else 1

        hc = contrib(y, x - 1) + contrib(y, x + 1)
        if vsc_row3:
            vc = contrib(y - 1, x)
        else:
            vc = contrib(y - 1, x) + contrib(y + 1, x)
        hc = max(-1, min(1, hc))
        vc = max(-1, min(1, vc))
        off, xorbit = _SC_TABLE[(hc, vc)]
        return CTX_SC + off, xorbit


def _is_term_pass(passtype: int, bpno: int, numbps: int, style: CblkStyle,
                  is_last: bool) -> bool:
    if is_last:
        return True
    if style & CblkStyle.TERMALL:
        return True
    if style & CblkStyle.LAZY:
        # terminate at MQ<->raw transitions: the CUP right before a raw SPP,
        # and every raw MRP (next pass is an MQ CUP)
        if passtype == 2 and bpno <= numbps - 4:
            return True
        if passtype == 1 and bpno <= numbps - 5:
            return True
    return False


def _is_raw_pass(passtype: int, bpno: int, numbps: int, style: CblkStyle) -> bool:
    return bool(style & CblkStyle.LAZY) and passtype in (0, 1) and bpno <= numbps - 5


def _first_sig_rec(bpno: int) -> int:
    """Decoder magnitude reconstruction when a sample first turns significant
    at bit-plane bpno: midpoint 1.5 * 2^bpno (just 1 at plane 0)."""
    one = 1 << bpno
    return one | (one >> 1)


def _refined_rec(old: int, bpno: int, bit: int) -> int:
    """Midpoint update for a refinement at plane bpno."""
    if bpno > 0:
        half = 1 << (bpno - 1)
        return old + half if bit else old - half
    return old if bit else old - 1


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

class _Coder:
    """Bundles MQ + raw encoders and the output byte stream."""

    def __init__(self, style: CblkStyle):
        self.mq = MQEncoder()
        self.raw: RawEncoder | None = None
        self.out = bytearray()
        self.style = style

    def ensure_raw(self):
        if self.raw is None:
            self.raw = RawEncoder()

    def terminate(self, is_raw: bool):
        if is_raw:
            self.out += self.raw.flush()
            self.raw = None
        else:
            # PTERM streams also end with the standard optimal flush here
            # (a valid termination; predictable-termination padding is a
            # detectability refinement, not a decode requirement), keeping
            # the Python and native backends bit-identical.
            self.out += self.mq.flush()
            ctxs = self.mq.ctxs
            self.mq = MQEncoder()
            self.mq.ctxs = ctxs

    def pending_rate(self, is_raw: bool) -> int:
        if is_raw:
            return len(self.out) + self.raw.num_bytes() + 1
        # MQ register state flushes in at most ~4 additional bytes
        return len(self.out) + self.mq.num_bytes() + 4


def encode_cblk(
    coeffs: np.ndarray,
    orient: int,
    style: CblkStyle = CblkStyle.NONE,
    rate_cap: int = 0,
):
    """Encode one codeblock of signed integer coefficients.

    Returns (data: bytes, numbps: int, passes: list[PassInfo]).
    PassInfo.dist is the cumulative reduction of sum((m - m_rec)^2) over
    magnitudes, unweighted — the caller scales by stepsize^2 and the band
    synthesis L2 norm^2 for PCRD (SURVEY.md B.8).

    rate_cap > 0 stops after the first pass whose cumulative rate reaches
    it (flushed, so every prefix stays decodable) — the rate-quota PCRD
    fast path; byte-identical to the native coder's early stop."""
    h, w = coeffs.shape
    mags = np.abs(coeffs.astype(np.int64))
    maxmag = int(mags.max()) if mags.size else 0
    numbps = int(maxmag).bit_length()
    if numbps == 0:
        return b"", 0, []

    st = _State(h, w)
    st.sgn[1:h + 1, 1:w + 1] = (coeffs < 0).astype(np.uint8)
    mag = np.zeros((h + 2, w + 2), dtype=np.int64)
    mag[1:h + 1, 1:w + 1] = mags
    rec = np.zeros((h + 2, w + 2), dtype=np.int64)

    cd = _Coder(style)
    passes: list[PassInfo] = []
    vsc = bool(style & CblkStyle.VSC)
    num_passes = 3 * numbps - 2
    dist_acc = [0.0]

    def on_sig(y, x, bpno):
        new = _first_sig_rec(bpno)
        m = int(mag[y, x])
        dist_acc[0] += float(m * m - (m - new) ** 2)
        rec[y, x] = new

    def on_ref(y, x, bpno, bit):
        old = int(rec[y, x])
        new = _refined_rec(old, bpno, bit)
        m = int(mag[y, x])
        dist_acc[0] += float((m - old) ** 2 - (m - new) ** 2)
        rec[y, x] = new

    passno = 0
    for bpno in range(numbps - 1, -1, -1):
        for passtype in ((2,) if bpno == numbps - 1 else (0, 1, 2)):
            is_raw = _is_raw_pass(passtype, bpno, numbps, style)
            if is_raw:
                cd.ensure_raw()
            if passtype == 0:
                _enc_sigpass(st, mag, bpno, orient, vsc, cd, is_raw, on_sig)
            elif passtype == 1:
                _enc_refpass(st, mag, bpno, vsc, cd, is_raw, on_ref)
            else:
                _enc_clnpass(st, mag, bpno, orient, vsc, cd, on_sig,
                             bool(style & CblkStyle.SEGSYM))
                st.visited[:] = 0

            is_last = passno == num_passes - 1
            term = _is_term_pass(passtype, bpno, numbps, style, is_last)
            if term:
                cd.terminate(is_raw)
                rate = len(cd.out)
            else:
                rate = cd.pending_rate(is_raw)
            if style & CblkStyle.RESET:
                cd.mq.reset_contexts()
            passes.append(PassInfo(passtype, bpno, term, rate, dist_acc[0]))
            passno += 1
            if rate_cap and not is_last and rate >= rate_cap:
                if not term:
                    cd.terminate(is_raw)
                    passes[-1].rate = len(cd.out)
                total = len(cd.out)
                for p in passes:
                    p.rate = min(p.rate, total)
                for i in range(len(passes) - 2, -1, -1):
                    passes[i].rate = min(passes[i].rate, passes[i + 1].rate)
                return bytes(cd.out), numbps, passes

    total = len(cd.out)
    for p in passes:
        p.rate = min(p.rate, total)
    for i in range(len(passes) - 2, -1, -1):
        passes[i].rate = min(passes[i].rate, passes[i + 1].rate)
    return bytes(cd.out), numbps, passes


def _enc_sigpass(st, mag, bpno, orient, vsc, cd, is_raw, on_sig):
    one = 1 << bpno
    h, w = st.h, st.w
    for sy in range(0, h, 4):
        rows = min(4, h - sy)
        for x in range(1, w + 1):
            for k in range(rows):
                y = sy + k + 1
                if st.sig[y, x]:
                    continue
                vsc_row3 = vsc and k == 3
                hh, vv, dd = st.neighbor_counts(y, x, vsc_row3)
                if hh + vv + dd == 0:
                    continue
                bit = 1 if (mag[y, x] & one) else 0
                if is_raw:
                    cd.raw.encode(bit)
                else:
                    cd.mq.encode(bit, CTX_ZC + _zc_context(hh, vv, dd, orient))
                if bit:
                    if is_raw:
                        cd.raw.encode(int(st.sgn[y, x]))
                    else:
                        ctx, xorbit = st.sc_context(y, x, vsc_row3)
                        cd.mq.encode(int(st.sgn[y, x]) ^ xorbit, ctx)
                    st.sig[y, x] = 1
                    on_sig(y, x, bpno)
                st.visited[y, x] = 1


def _enc_refpass(st, mag, bpno, vsc, cd, is_raw, on_ref):
    one = 1 << bpno
    h, w = st.h, st.w
    for sy in range(0, h, 4):
        rows = min(4, h - sy)
        for x in range(1, w + 1):
            for k in range(rows):
                y = sy + k + 1
                if not st.sig[y, x] or st.visited[y, x]:
                    continue
                bit = 1 if (mag[y, x] & one) else 0
                if is_raw:
                    cd.raw.encode(bit)
                else:
                    if not st.refined[y, x]:
                        # stripe-causal masking applies to MR contexts too
                        hh, vv, dd = st.neighbor_counts(
                            y, x, vsc and k == 3)
                        ctx = CTX_MAG + (1 if hh + vv + dd > 0 else 0)
                    else:
                        ctx = CTX_MAG + 2
                    cd.mq.encode(bit, ctx)
                st.refined[y, x] = 1
                on_ref(y, x, bpno, bit)


def _enc_clnpass(st, mag, bpno, orient, vsc, cd, on_sig, segsym):
    one = 1 << bpno
    h, w = st.h, st.w
    mq = cd.mq
    for sy in range(0, h, 4):
        rows = min(4, h - sy)
        for x in range(1, w + 1):
            k = 0
            if rows == 4:
                agg = True
                for kk in range(4):
                    y = sy + kk + 1
                    if st.sig[y, x] or st.visited[y, x]:
                        agg = False
                        break
                    vsc_row3 = vsc and kk == 3
                    hh, vv, dd = st.neighbor_counts(y, x, vsc_row3)
                    if hh + vv + dd:
                        agg = False
                        break
                if agg:
                    first = 4
                    for kk in range(4):
                        if mag[sy + kk + 1, x] & one:
                            first = kk
                            break
                    mq.encode(0 if first == 4 else 1, CTX_RL)
                    if first == 4:
                        continue
                    mq.encode((first >> 1) & 1, CTX_UNI)
                    mq.encode(first & 1, CTX_UNI)
                    y = sy + first + 1
                    vsc_row3 = vsc and first == 3
                    ctx, xorbit = st.sc_context(y, x, vsc_row3)
                    mq.encode(int(st.sgn[y, x]) ^ xorbit, ctx)
                    st.sig[y, x] = 1
                    on_sig(y, x, bpno)
                    k = first + 1
            for kk in range(k, rows):
                y = sy + kk + 1
                if st.sig[y, x] or st.visited[y, x]:
                    continue
                vsc_row3 = vsc and kk == 3
                hh, vv, dd = st.neighbor_counts(y, x, vsc_row3)
                bit = 1 if (mag[y, x] & one) else 0
                mq.encode(bit, CTX_ZC + _zc_context(hh, vv, dd, orient))
                if bit:
                    ctx, xorbit = st.sc_context(y, x, vsc_row3)
                    mq.encode(int(st.sgn[y, x]) ^ xorbit, ctx)
                    st.sig[y, x] = 1
                    on_sig(y, x, bpno)
    if segsym:
        for b in (1, 0, 1, 0):
            mq.encode(b, CTX_UNI)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

import functools


@functools.lru_cache(maxsize=512)
def segment_layout(style: CblkStyle, numbps: int):
    """(pass indices per segment, is_raw) tuples — the codeword-segment
    structure implied by the mode switches (SURVEY.md B.6 "Segments").
    Cached: called per codeblock contribution in Tier-2 hot loops."""
    style = CblkStyle(int(style))
    num_passes = 3 * numbps - 2
    segs = []
    cur = []
    cur_raw = False
    passno = 0
    for bpno in range(numbps - 1, -1, -1):
        for passtype in ((2,) if bpno == numbps - 1 else (0, 1, 2)):
            is_raw = _is_raw_pass(passtype, bpno, numbps, style)
            if cur and is_raw != cur_raw:
                segs.append((cur, cur_raw))
                cur = []
            cur_raw = is_raw
            cur.append(passno)
            is_last = passno == num_passes - 1
            if _is_term_pass(passtype, bpno, numbps, style, is_last):
                segs.append((cur, cur_raw))
                cur = []
            passno += 1
    if cur:
        segs.append((cur, cur_raw))
    return segs


def decode_cblk(
    data: bytes,
    seg_lengths: list[int],
    num_passes: int,
    numbps: int,
    h: int,
    w: int,
    orient: int,
    style: CblkStyle = CblkStyle.NONE,
) -> np.ndarray:
    """Decode one codeblock.  `data` is the concatenation of all received
    codeword-segment bytes; `seg_lengths` gives each segment's byte length
    (as accumulated from packet headers).

    Returns signed int32 (h, w) coefficients in the DOUBLED domain: a fully
    decoded quantizer index q comes back as sign * (2q + 1); truncated
    samples carry doubled midpoint reconstructions.  Lossless consumers
    shift right by 1; lossy consumers multiply by 0.5 * Delta."""
    out = np.zeros((h, w), dtype=np.int32)
    if numbps == 0 or num_passes <= 0:
        return out

    st = _State(h, w)
    rec = np.zeros((h + 2, w + 2), dtype=np.int64)
    vsc = bool(style & CblkStyle.VSC)

    segs = segment_layout(style, numbps)
    # map pass index -> (segment index, is_raw)
    pass_seg = {}
    for si, (plist, is_raw) in enumerate(segs):
        for p in plist:
            pass_seg[p] = (si, is_raw)

    # segment byte ranges within `data`
    offsets = []
    off = 0
    for L in seg_lengths:
        offsets.append((off, off + L))
        off += L

    mq: MQDecoder | None = None
    raw: RawDecoder | None = None
    cur_seg = -1
    saved_ctxs = None

    passno = 0
    for bpno in range(numbps - 1, -1, -1):
        for passtype in ((2,) if bpno == numbps - 1 else (0, 1, 2)):
            if passno >= num_passes:
                break
            si, is_raw = pass_seg[passno]
            if si != cur_seg:
                if si >= len(offsets):
                    seg_data = b""
                else:
                    s, e = offsets[si]
                    seg_data = data[s:e]
                if is_raw:
                    raw = RawDecoder(seg_data)
                else:
                    if mq is None:
                        mq = MQDecoder(seg_data)
                    else:
                        mq.init_segment(seg_data)
                cur_seg = si
            # reconstruction runs one plane up (doubled domain): the final
            # magnitudes are 2q+1 for fully decoded samples, so lossless
            # takes >>1 and lossy takes *0.5*Delta = (q+0.5)*Delta midpoints
            if passtype == 0:
                _dec_sigpass(st, rec, bpno + 1, orient, vsc,
                             raw if is_raw else None, mq)
            elif passtype == 1:
                _dec_refpass(st, rec, bpno + 1, vsc,
                             raw if is_raw else None, mq)
            else:
                _dec_clnpass(st, rec, bpno + 1, orient, vsc, mq,
                             bool(style & CblkStyle.SEGSYM))
                st.visited[:] = 0
            if style & CblkStyle.RESET and mq is not None:
                mq.reset_contexts()
            passno += 1
        if passno >= num_passes:
            break

    mags = rec[1:h + 1, 1:w + 1]
    signs = st.sgn[1:h + 1, 1:w + 1]
    out = np.where(signs.astype(bool), -mags, mags).astype(np.int32)
    return out


def _dec_sigpass(st, rec, bpno, orient, vsc, raw, mq):
    h, w = st.h, st.w
    for sy in range(0, h, 4):
        rows = min(4, h - sy)
        for x in range(1, w + 1):
            for k in range(rows):
                y = sy + k + 1
                if st.sig[y, x]:
                    continue
                vsc_row3 = vsc and k == 3
                hh, vv, dd = st.neighbor_counts(y, x, vsc_row3)
                if hh + vv + dd == 0:
                    continue
                if raw is not None:
                    bit = raw.decode()
                else:
                    bit = mq.decode(CTX_ZC + _zc_context(hh, vv, dd, orient))
                if bit:
                    if raw is not None:
                        sgn = raw.decode()
                    else:
                        ctx, xorbit = st.sc_context(y, x, vsc_row3)
                        sgn = mq.decode(ctx) ^ xorbit
                    st.sgn[y, x] = sgn
                    st.sig[y, x] = 1
                    rec[y, x] = _first_sig_rec(bpno)
                st.visited[y, x] = 1


def _dec_refpass(st, rec, bpno, vsc, raw, mq):
    h, w = st.h, st.w
    for sy in range(0, h, 4):
        rows = min(4, h - sy)
        for x in range(1, w + 1):
            for k in range(rows):
                y = sy + k + 1
                if not st.sig[y, x] or st.visited[y, x]:
                    continue
                if raw is not None:
                    bit = raw.decode()
                else:
                    if not st.refined[y, x]:
                        hh, vv, dd = st.neighbor_counts(
                            y, x, vsc and k == 3)
                        ctx = CTX_MAG + (1 if hh + vv + dd > 0 else 0)
                    else:
                        ctx = CTX_MAG + 2
                    bit = mq.decode(ctx)
                st.refined[y, x] = 1
                rec[y, x] = _refined_rec(int(rec[y, x]), bpno, bit)


def _dec_clnpass(st, rec, bpno, orient, vsc, mq, segsym):
    h, w = st.h, st.w
    for sy in range(0, h, 4):
        rows = min(4, h - sy)
        for x in range(1, w + 1):
            k = 0
            if rows == 4:
                agg = True
                for kk in range(4):
                    y = sy + kk + 1
                    if st.sig[y, x] or st.visited[y, x]:
                        agg = False
                        break
                    vsc_row3 = vsc and kk == 3
                    hh, vv, dd = st.neighbor_counts(y, x, vsc_row3)
                    if hh + vv + dd:
                        agg = False
                        break
                if agg:
                    if not mq.decode(CTX_RL):
                        continue
                    first = (mq.decode(CTX_UNI) << 1) | mq.decode(CTX_UNI)
                    y = sy + first + 1
                    vsc_row3 = vsc and first == 3
                    ctx, xorbit = st.sc_context(y, x, vsc_row3)
                    st.sgn[y, x] = mq.decode(ctx) ^ xorbit
                    st.sig[y, x] = 1
                    rec[y, x] = _first_sig_rec(bpno)
                    k = first + 1
            for kk in range(k, rows):
                y = sy + kk + 1
                if st.sig[y, x] or st.visited[y, x]:
                    continue
                vsc_row3 = vsc and kk == 3
                hh, vv, dd = st.neighbor_counts(y, x, vsc_row3)
                bit = mq.decode(CTX_ZC + _zc_context(hh, vv, dd, orient))
                if bit:
                    ctx, xorbit = st.sc_context(y, x, vsc_row3)
                    st.sgn[y, x] = mq.decode(ctx) ^ xorbit
                    st.sig[y, x] = 1
                    rec[y, x] = _first_sig_rec(bpno)
    if segsym:
        for _ in range(4):
            mq.decode(CTX_UNI)
