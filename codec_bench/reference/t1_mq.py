"""A plain EBCOT Tier-1 decoder (ISO/IEC 15444-1 Annex C and D): the MQ
arithmetic decoder, raw (LAZY) segments and the three coding passes.

Samples come back in the doubled domain: a coefficient whose bit-planes
were all decoded is sign * (2|q| + 1); one cut short carries the midpoint of
what is known, so `v >> (p + 1)` is exact for the planes >= p that were
decoded in full.  Flat Python lists with a one-sample border keep it
simple; it is the judge's code, not a fast path.
"""

from __future__ import annotations

import numpy as np

from .codestream import (HL, HH, STYLE_LAZY, STYLE_RESET, STYLE_SEGSYM,
                         STYLE_VSC, segment_ends)

# Table C.2: (Qe, NMPS, NLPS, SWITCH)
QE = [
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0), (0x0AC1, 4, 12, 0),
    (0x0521, 5, 29, 0), (0x0221, 38, 33, 0), (0x5601, 7, 6, 1), (0x5401, 8, 14, 0),
    (0x4801, 9, 14, 0), (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1), (0x5401, 16, 14, 0),
    (0x5101, 17, 15, 0), (0x4801, 18, 16, 0), (0x3801, 19, 17, 0), (0x3401, 20, 18, 0),
    (0x3001, 21, 19, 0), (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0), (0x1401, 28, 25, 0),
    (0x1201, 29, 26, 0), (0x1101, 30, 27, 0), (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0),
    (0x08A1, 33, 30, 0), (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0), (0x0085, 40, 37, 0),
    (0x0049, 41, 38, 0), (0x0025, 42, 39, 0), (0x0015, 43, 40, 0), (0x0009, 44, 41, 0),
    (0x0005, 45, 42, 0), (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
]
CTX_ZC, CTX_SC, CTX_MAG, CTX_RL, CTX_UNI = 0, 9, 14, 17, 18


def _initial_contexts():
    ctxs = [[0, 0] for _ in range(19)]
    ctxs[CTX_ZC][0], ctxs[CTX_RL][0], ctxs[CTX_UNI][0] = 4, 3, 46
    return ctxs


class MQ:
    """The MQ decoder (Annex C.3); a marker, or the end, feeds 1-bits."""

    def __init__(self):
        self.ctxs = _initial_contexts()

    def start(self, data: bytes) -> None:
        self.data, self.bp = data, 0
        self.c = ((data[0] if data else 0xFF) << 16)
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _at(self, i: int) -> int:
        return self.data[i] if i < len(self.data) else 0xFF

    def _bytein(self) -> None:
        if self._at(self.bp) == 0xFF:
            if self._at(self.bp + 1) > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp += 1
                self.c += self._at(self.bp) << 9
                self.ct = 7
        else:
            self.bp += 1
            self.c += self._at(self.bp) << 8
            self.ct = 8
        self.c &= 0xFFFFFFFF

    def decode(self, cx: int) -> int:
        ctx = self.ctxs[cx]
        qe, nmps, nlps, switch = QE[ctx[0]]
        mps = ctx[1]
        self.a -= qe
        if (self.c >> 16) < qe:
            if self.a < qe:
                d, ctx[0] = mps, nmps
            else:
                d = 1 - mps
                if switch:
                    ctx[1] = 1 - mps
                ctx[0] = nlps
            self.a = qe
        else:
            self.c -= qe << 16
            if self.a & 0x8000:
                return mps
            if self.a < qe:
                d = 1 - mps
                if switch:
                    ctx[1] = 1 - mps
                ctx[0] = nlps
            else:
                d, ctx[0] = mps, nmps
        while True:  # renormalise
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                return d


class Raw:
    """A raw (bypass) segment: bits MSB first, 7 after a 0xFF."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0
        self.acc = self.avail = 0
        self.prev_ff = False

    def decode(self, _cx: int = 0) -> int:
        if self.avail == 0:
            b = self.data[self.pos] if self.pos < len(self.data) else 0xFF
            self.pos += 1
            self.acc = b
            self.avail = 7 if self.prev_ff else 8
            self.prev_ff = b == 0xFF
        self.avail -= 1
        return (self.acc >> self.avail) & 1


def _zc(h: int, v: int, d: int, orient: int) -> int:
    """Zero-coding context (Table D.1)."""
    if orient == HH:
        hv = h + v
        if d >= 3:
            return 8
        if d == 2:
            return 7 if hv >= 1 else 6
        if d == 1:
            return 5 if hv >= 2 else (4 if hv == 1 else 3)
        return 2 if hv >= 2 else hv
    if orient == HL:
        h, v = v, h
    if h == 2:
        return 8
    if h == 1:
        return 7 if v >= 1 else (6 if d >= 1 else 5)
    if v == 2:
        return 4
    if v == 1:
        return 3
    return 2 if d >= 2 else d


# Table D.3: (H, V) contributions -> (context offset, xor bit)
_SC = {(1, 1): (4, 0), (1, 0): (3, 0), (1, -1): (2, 0),
       (0, 1): (1, 0), (0, 0): (0, 0), (0, -1): (1, 1),
       (-1, 1): (2, 1), (-1, 0): (3, 1), (-1, -1): (4, 1)}


class _Block:
    """Coding state of one code-block, flat with a one-sample border."""

    def __init__(self, h: int, w: int, orient: int, vsc: bool):
        self.h, self.w, self.orient, self.vsc = h, w, orient, vsc
        self.s = w + 2
        n = (h + 2) * self.s
        self.sig = [0] * n
        self.neg = [0] * n
        self.visited = [0] * n
        self.refined = [0] * n
        self.rec = [0] * n

    def counts(self, i: int, row3: bool):
        s, g = self.s, self.sig
        hh = g[i - 1] + g[i + 1]
        if row3:  # stripe-causal: the row below is not looked at
            return hh, g[i - s], g[i - s - 1] + g[i - s + 1]
        return (hh, g[i - s] + g[i + s],
                g[i - s - 1] + g[i - s + 1] + g[i + s - 1] + g[i + s + 1])

    def sign_ctx(self, i: int, row3: bool):
        s, g, n = self.s, self.sig, self.neg

        def c(j):
            return (-1 if n[j] else 1) if g[j] else 0
        hc = max(-1, min(1, c(i - 1) + c(i + 1)))
        vc = c(i - s) + (0 if row3 else c(i + s))
        vc = max(-1, min(1, vc))
        off, xor = _SC[(hc, vc)]
        return CTX_SC + off, xor

    def scan(self):
        """(flat index, row in stripe) in stripe order."""
        for sy in range(0, self.h, 4):
            rows = min(4, self.h - sy)
            for x in range(1, self.w + 1):
                yield sy, x, rows


def _sigpass(b: _Block, plane: int, coder, raw: bool) -> None:
    s = b.s
    first = (1 << plane) | (1 << plane >> 1)
    for sy, x, rows in b.scan():
        for k in range(rows):
            i = (sy + k + 1) * s + x
            if b.sig[i]:
                continue
            row3 = b.vsc and k == 3
            hh, vv, dd = b.counts(i, row3)
            if hh + vv + dd == 0:
                continue
            if coder.decode(CTX_ZC + _zc(hh, vv, dd, b.orient)):
                if raw:
                    b.neg[i] = coder.decode()
                else:
                    cx, xor = b.sign_ctx(i, row3)
                    b.neg[i] = coder.decode(cx) ^ xor
                b.sig[i] = 1
                b.rec[i] = first
            b.visited[i] = 1


def _refpass(b: _Block, plane: int, coder, raw: bool) -> None:
    s = b.s
    half = (1 << plane) >> 1
    for sy, x, rows in b.scan():
        for k in range(rows):
            i = (sy + k + 1) * s + x
            if not b.sig[i] or b.visited[i]:
                continue
            if raw:
                bit = coder.decode()
            elif b.refined[i]:
                bit = coder.decode(CTX_MAG + 2)
            else:
                hh, vv, dd = b.counts(i, b.vsc and k == 3)
                bit = coder.decode(CTX_MAG + (1 if hh + vv + dd else 0))
            b.refined[i] = 1
            if plane > 0:
                b.rec[i] += half if bit else -half
            elif not bit:
                b.rec[i] -= 1


def _clnpass(b: _Block, plane: int, mq: MQ, segsym: bool) -> None:
    s = b.s
    first = (1 << plane) | (1 << plane >> 1)

    def significant(i, row3):
        cx, xor = b.sign_ctx(i, row3)
        b.neg[i] = mq.decode(cx) ^ xor
        b.sig[i] = 1
        b.rec[i] = first

    for sy, x, rows in b.scan():
        k = 0
        if rows == 4:
            run = True
            for kk in range(4):
                i = (sy + kk + 1) * s + x
                if b.sig[i] or b.visited[i] or \
                        sum(b.counts(i, b.vsc and kk == 3)):
                    run = False
                    break
            if run:
                if not mq.decode(CTX_RL):
                    continue
                k = (mq.decode(CTX_UNI) << 1) | mq.decode(CTX_UNI)
                significant((sy + k + 1) * s + x, b.vsc and k == 3)
                k += 1
        for kk in range(k, rows):
            i = (sy + kk + 1) * s + x
            if b.sig[i] or b.visited[i]:
                continue
            row3 = b.vsc and kk == 3
            hh, vv, dd = b.counts(i, row3)
            if mq.decode(CTX_ZC + _zc(hh, vv, dd, b.orient)):
                significant(i, row3)
    if segsym:
        for _ in range(4):
            mq.decode(CTX_UNI)
    b.visited = [0] * len(b.visited)


def decode_block(chunks, numbps: int, h: int, w: int, orient: int,
                 style: int) -> np.ndarray:
    """A code-block's (h, w) doubled-domain int64 samples from its
    received (npasses, bytes) chunks."""
    total = sum(n for n, _ in chunks)
    out = np.zeros((h, w), dtype=np.int64)
    if numbps <= 0 or total <= 0:
        return out
    ends = segment_ends(style, numbps)
    seg_of = []
    start = 0
    for si, e in enumerate(ends):
        seg_of += [si] * (e - start + 1)
        start = e + 1
    segs = [b""] * len(ends)
    p = 0
    for n, data in chunks:  # a segment split over layers joins up again
        segs[seg_of[p]] += data
        p += n
    b = _Block(h, w, orient, bool(style & STYLE_VSC))
    mq, cur = MQ(), -1
    p = 0
    for plane in range(numbps - 1, -1, -1):
        for kind in ((2,) if plane == numbps - 1 else (0, 1, 2)):
            if p >= total:
                break
            raw = bool(style & STYLE_LAZY) and kind < 2 and \
                plane <= numbps - 5
            if seg_of[p] != cur:
                cur = seg_of[p]
                coder = Raw(segs[cur]) if raw else mq
                if not raw:
                    mq.start(segs[cur])
            # reconstruction runs one plane up: the doubled domain
            if kind == 0:
                _sigpass(b, plane + 1, coder, raw)
            elif kind == 1:
                _refpass(b, plane + 1, coder, raw)
            else:
                _clnpass(b, plane + 1, mq, bool(style & STYLE_SEGSYM))
            if style & STYLE_RESET:
                mq.ctxs = _initial_contexts()
            p += 1
    rec = np.array(b.rec, dtype=np.int64).reshape(h + 2, w + 2)[1:-1, 1:-1]
    neg = np.array(b.neg, dtype=bool).reshape(h + 2, w + 2)[1:-1, 1:-1]
    return np.where(neg, -rec, rec)
