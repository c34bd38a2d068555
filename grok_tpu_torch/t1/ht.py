"""HTJ2K (Part 15) fast block coder — Python reference (the port's copy of
grok_tpu/t1/ht.py).

Parity: the reference's HT Tier-1 (SURVEY.md §2.1 "Tier-1 HT (Part 15)",
src/lib/core/t1/ht/ [P]): the FBCOT cleanup pass built from three
interleaved bitstreams in one codeword segment:

  [ MagSgn (grows forward) | MEL (forward) ... VLC (backward) ]

with the suffix length Scup carried in the final 12 bits of the segment,
the standard 13-state MEL adaptive run-length coder, 2x2 quad scanning,
quad exponent bounds (U_q) with predictive u coding, and raw
magnitude-sign packing for significant samples.

**Conformance status (SURVEY.md B.9):** no HT oracle exists in this
environment and the normative CxtVLC code tables cannot be reproduced from
local sources, so the quad significance-pattern coding below defaults to a
self-consistent stand-in table (identity 4-bit rho code + Elias-style u
prefix) instead of the spec's context-dependent VLC tables.  The tables
live in t1/ht_tables.py and support variable-length prefix codes up to
the T.814 7-bit maximum, so installing the normative tables is a
set_tables() call; the segment layout, MEL coder and MagSgn packing
follow the spec structure.  Interop is gated on self round-trip tests
(tests/test_ht.py) as SURVEY.md §4 prescribes.
"""

from __future__ import annotations

import numpy as np

from . import ht_tables

# 13-state MEL exponent table (ITU-T T.814)
MEL_E = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5]


class _BitWriterMSB:
    """MSB-first bit packing with 0xFF stuffing (7 bits after a 0xFF)."""

    def __init__(self):
        self.bytes = bytearray()
        self.acc = 0
        self.used = 0
        self.cap = 8

    def put(self, bit: int):
        self.acc = (self.acc << 1) | (bit & 1)
        self.used += 1
        if self.used == self.cap:
            self.bytes.append(self.acc)
            self.cap = 7 if self.acc == 0xFF else 8
            self.acc = 0
            self.used = 0

    def put_bits(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.put((v >> i) & 1)

    def flush(self) -> bytes:
        if self.used:
            self.acc <<= self.cap - self.used
            self.bytes.append(self.acc)
            self.acc = 0
            self.used = 0
            self.cap = 8
        if self.bytes and self.bytes[-1] == 0xFF:
            self.bytes.append(0)
        return bytes(self.bytes)


class _BitReaderMSB:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.avail = 0
        self.prev_ff = False
        self.pushed = 0
        self.npushed = 0

    def get(self) -> int:
        if self.npushed:
            self.npushed -= 1
            return (self.pushed >> self.npushed) & 1
        if self.avail == 0:
            b = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.acc = b
            self.avail = 7 if self.prev_ff else 8
            self.prev_ff = b == 0xFF
        self.avail -= 1
        return (self.acc >> self.avail) & 1

    def get_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get()
        return v

    def unget(self, v: int, n: int):
        """Push back the last n bits read (low n bits of v, stream
        order): they are re-served before anything else.  Lets the VLC
        decoder window-read MAX_CWD_LEN bits and return the unconsumed
        tail of a shorter codeword."""
        if n:
            # mask off already-served bits still sitting above npushed
            live = self.pushed & ((1 << self.npushed) - 1)
            self.pushed = ((v & ((1 << n) - 1)) << self.npushed) | live
            self.npushed += n


class MELEncoder:
    def __init__(self):
        self.k = 0
        self.run = 0
        self.bw = _BitWriterMSB()

    def encode(self, event: int):
        t = 1 << MEL_E[self.k]
        if event == 0:
            self.run += 1
            if self.run == t:
                self.bw.put(1)
                self.run = 0
                self.k = min(12, self.k + 1)
        else:
            self.bw.put(0)
            self.bw.put_bits(self.run, MEL_E[self.k])
            self.run = 0
            self.k = max(0, self.k - 1)

    def flush(self) -> bytes:
        if self.run:
            # close the pending run as a full one; the decoder consumes
            # exactly the events it needs, trailing zeros are harmless
            self.bw.put(1)
        return self.bw.flush()


class MELDecoder:
    def __init__(self, data: bytes):
        self.k = 0
        self.br = _BitReaderMSB(data)
        self.pending_zeros = 0
        self.pending_one = False

    def decode(self) -> int:
        if self.pending_zeros > 0:
            self.pending_zeros -= 1
            return 0
        if self.pending_one:
            self.pending_one = False
            return 1
        t = 1 << MEL_E[self.k]
        if self.br.get():
            # a full run of t zeros
            self.k = min(12, self.k + 1)
            self.pending_zeros = t - 1
            return 0
        run = self.br.get_bits(MEL_E[self.k])
        self.k = max(0, self.k - 1)
        if run > 0:
            # `run` zeros followed by the terminating one
            self.pending_zeros = run - 1
            self.pending_one = True
            return 0
        return 1


# u-value prefix code: 0->'0', 1->'10', 2->'110', >=3 -> '111'+7 bits (u-3).
# 7 escape bits cover the zigzagged predictor residual for any int32
# magnitude (|diff| <= 64); 5 bits silently truncated deep-precision data.
def _put_u(bw: _BitWriterMSB, u: int):
    if u == 0:
        bw.put(0)
    elif u == 1:
        bw.put_bits(0b10, 2)
    elif u == 2:
        bw.put_bits(0b110, 3)
    else:
        bw.put_bits(0b111, 3)
        bw.put_bits(u - 3, 7)


def _get_u(br: _BitReaderMSB) -> int:
    if not br.get():
        return 0
    if not br.get():
        return 1
    if not br.get():
        return 2
    return 3 + br.get_bits(7)


def encode_cblk_ht_refined(coeffs: np.ndarray):
    """HT encode with the optional SigProp/MagRef refinement passes
    (ITU-T T.814 pass structure: cleanup at bit-plane p, then raw
    significance-propagation and magnitude-refinement passes at p-1).

    The cleanup codes magnitudes >> 1; SigProp codes the LSB (+sign) of
    samples turning significant next to significant neighbors; MagRef
    codes the LSB of already-significant samples.  As in the spec, samples
    whose magnitude is 1 with no significant neighborhood are not reachable
    by the refinement passes — full reconstruction is near-lossless, which
    is why the codec's lossless path uses the cleanup-only (HTONLY) form.

    Returns (cleanup_seg, refine_seg, numbps)."""
    h, w = coeffs.shape
    mags = np.abs(coeffs.astype(np.int64))
    numbps = int(mags.max()).bit_length() if mags.size else 0
    if numbps <= 1:
        data, nb = encode_cblk_ht(coeffs)
        return data, b"", nb
    hi = (np.sign(coeffs) * (mags >> 1)).astype(np.int32)
    cleanup, _ = encode_cblk_ht(hi)
    # refinement passes on plane 0 (raw bits)
    raw = _BitWriterMSB()
    sig = np.zeros((h + 2, w + 2), dtype=bool)
    sig[1:h + 1, 1:w + 1] = (mags >> 1) > 0
    lsb = (mags & 1).astype(np.uint8)
    sgn = (coeffs < 0).astype(np.uint8)
    # SigProp: stripe scan, dynamic significance updates
    for sy in range(0, h, 4):
        rows = min(4, h - sy)
        for x in range(1, w + 1):
            for k in range(rows):
                y = sy + k + 1
                if sig[y, x]:
                    continue
                nbr = (sig[y - 1, x - 1] | sig[y - 1, x] | sig[y - 1, x + 1]
                       | sig[y, x - 1] | sig[y, x + 1]
                       | sig[y + 1, x - 1] | sig[y + 1, x] | sig[y + 1, x + 1])
                if not nbr:
                    continue
                bit = int(lsb[y - 1, x - 1]) & 1
                raw.put(bit)
                if bit:
                    raw.put(int(sgn[y - 1, x - 1]))
                    sig[y, x] = True
    # MagRef: refine samples significant after cleanup
    base_sig = (mags >> 1) > 0
    for sy in range(0, h, 4):
        rows = min(4, h - sy)
        for x in range(w):
            for k in range(rows):
                y = sy + k
                if base_sig[y, x]:
                    raw.put(int(lsb[y, x] & 1))
    return cleanup, raw.flush(), numbps


def decode_cblk_ht_refined(cleanup: bytes, refine: bytes, h: int, w: int):
    """Decode cleanup + SigProp/MagRef segments.  Returns doubled-domain
    signed values like decode_cblk_ht."""
    base = decode_cblk_ht(cleanup, h, w)  # doubled: sign*(2*m1+1)
    m1 = (np.abs(base) >> 1).astype(np.int64)
    sgn = (base < 0)
    if not refine:
        # magnitudes = 2*m1 (+ midpoint half): keep doubled convention
        m = 2 * m1
        doubled = np.where(m > 0, 2 * m + 1, 0)
        return np.where(sgn, -doubled, doubled).astype(np.int32)
    raw = _BitReaderMSB(refine)
    sig = np.zeros((h + 2, w + 2), dtype=bool)
    sig[1:h + 1, 1:w + 1] = m1 > 0
    lsb = np.zeros((h, w), dtype=np.uint8)
    newsgn = np.zeros((h, w), dtype=bool)
    for sy in range(0, h, 4):
        rows = min(4, h - sy)
        for x in range(1, w + 1):
            for k in range(rows):
                y = sy + k + 1
                if sig[y, x]:
                    continue
                nbr = (sig[y - 1, x - 1] | sig[y - 1, x] | sig[y - 1, x + 1]
                       | sig[y, x - 1] | sig[y, x + 1]
                       | sig[y + 1, x - 1] | sig[y + 1, x] | sig[y + 1, x + 1])
                if not nbr:
                    continue
                if raw.get():
                    newsgn[y - 1, x - 1] = bool(raw.get())
                    lsb[y - 1, x - 1] = 1
                    sig[y, x] = True
    base_sig = m1 > 0
    for sy in range(0, h, 4):
        rows = min(4, h - sy)
        for x in range(w):
            for k in range(rows):
                y = sy + k
                if base_sig[y, x]:
                    lsb[y, x] = raw.get()
    m = 2 * m1 + lsb
    doubled = np.where(m > 0, 2 * m + 1, 0)
    out_sgn = np.where(base_sig, sgn, newsgn)
    return np.where(out_sgn, -doubled, doubled).astype(np.int32)


def encode_cblk_ht(coeffs: np.ndarray):
    """HT cleanup-pass encode of one codeblock (HTONLY set: all magnitude
    information in a single pass).

    Returns (segment bytes, numbps)."""
    h, w = coeffs.shape
    mags = np.abs(coeffs.astype(np.int64))
    signs = (coeffs < 0).astype(np.uint8)
    maxmag = int(mags.max()) if mags.size else 0
    numbps = int(maxmag).bit_length()
    if numbps == 0:
        return b"", 0

    qh = (h + 1) // 2
    qw = (w + 1) // 2
    magsgn = _BitWriterMSB()
    mel = MELEncoder()
    vlc = _BitWriterMSB()

    prev_rho = [0] * qw  # previous quad row's rho (context formation)
    for qy in range(qh):
        u_pred = 1  # predictor resets per quad row
        row_rho = [0] * qw
        left_rho = 0
        for qx in range(qw):
            ys = range(2 * qy, min(2 * qy + 2, h))
            xs = range(2 * qx, min(2 * qx + 2, w))
            samples = [(y, x) for x in xs for y in ys]
            rho = 0
            umax = 0
            for i, (y, x) in enumerate(samples):
                # clamp the (contract-violating) INT32_MIN magnitude so
                # umax stays <= 31 and the stream remains decodable
                m = min(int(mags[y, x]), 0x7FFFFFFF)
                if m:
                    rho |= 1 << i
                    umax = max(umax, m.bit_length())
            mel.encode(1 if rho else 0)
            row_rho[qx] = rho
            ctx = ht_tables.quad_context(
                left_rho, prev_rho[qx], prev_rho[qx - 1] if qx else 0)
            left_rho = rho
            if not rho:
                continue
            # quad significance through the CxtVLC table module (the
            # single swap point, t1/ht_tables.py), selected by the
            # neighbor-significance context; partial edge quads
            # (<4 samples) stay raw — their rho has fewer bits than a
            # table codeword
            ns = len(samples)
            if ns == 4:
                vlc.put_bits(int(ht_tables.ENC_CWD[ctx, rho]),
                             int(ht_tables.ENC_LEN[ctx, rho]))
            else:
                vlc.put_bits(rho, ns)
            diff = umax - u_pred
            zz = (diff << 1) if diff >= 0 else ((-diff << 1) - 1)
            _put_u(vlc, zz)
            u_pred = umax
            for i, (y, x) in enumerate(samples):
                if rho & (1 << i):
                    m = min(int(mags[y, x]), 0x7FFFFFFF)
                    magsgn.put_bits(m - 1, umax)
                    magsgn.put(int(signs[y, x]))
        prev_rho = row_rho

    ms_bytes = magsgn.flush()
    mel_bytes = mel.flush()
    vlc_bytes = vlc.flush()[::-1]  # VLC grows backward from the segment end
    suffix = mel_bytes + vlc_bytes
    scup = len(suffix) + 2
    if scup > 4079:
        raise ValueError("HT suffix overflow")
    seg = bytearray(ms_bytes + suffix)
    # Scup in the trailing 12 bits: last byte = scup >> 4,
    # low nibble of second-to-last byte = scup & 0xF
    seg += bytes([(0x0F & scup), (scup >> 4) & 0xFF])
    return bytes(seg), numbps


def decode_cblk_ht(data: bytes, h: int, w: int):
    """Decode an HT cleanup segment.  Returns doubled-domain signed int32
    (matching the Part-1 T1 decoder convention: sign * (2m + 1) for
    significant samples)."""
    out = np.zeros((h, w), dtype=np.int32)
    if len(data) < 2:
        return out
    scup = ((data[-1] & 0xFF) << 4) | (data[-2] & 0x0F)
    if scup < 2 or scup > len(data):
        return out  # tolerant: malformed segment
    suffix = data[len(data) - scup:len(data) - 2]
    ms = _BitReaderMSB(data[: len(data) - scup])
    mel = MELDecoder(bytes(suffix))
    # Because MEL and VLC share the suffix without an explicit boundary,
    # the decoder interleaves: MEL reads forward, VLC backward.  With byte
    # granularity unknown, we reconstruct the VLC reader over the reversed
    # suffix and rely on the encoder having sized the region exactly.
    vlc = _BitReaderMSB(bytes(suffix[::-1]))

    qh = (h + 1) // 2
    qw = (w + 1) // 2
    prev_rho = [0] * qw
    for qy in range(qh):
        u_pred = 1
        row_rho = [0] * qw
        left_rho = 0
        for qx in range(qw):
            ys = range(2 * qy, min(2 * qy + 2, h))
            xs = range(2 * qx, min(2 * qx + 2, w))
            samples = [(y, x) for x in xs for y in ys]
            ctx = ht_tables.quad_context(
                left_rho, prev_rho[qx], prev_rho[qx - 1] if qx else 0)
            if not mel.decode():
                left_rho = 0
                continue
            ns = len(samples)
            if ns == 4:
                # prefix-code window read through the CxtVLC decode LUT
                # (t1/ht_tables.py): peek MAX_CWD_LEN bits, consume the
                # matched codeword's length
                win = vlc.get_bits(ht_tables.MAX_CWD_LEN)
                rho = int(ht_tables.DEC_LUT_RHO[ctx, win])
                vlc.unget(win, ht_tables.MAX_CWD_LEN
                          - int(ht_tables.DEC_LUT_LEN[ctx, win]))
            else:
                rho = vlc.get_bits(ns)
            row_rho[qx] = rho
            left_rho = rho
            zz = _get_u(vlc)
            diff = (zz >> 1) if (zz & 1) == 0 else -((zz + 1) >> 1)
            umax = u_pred + diff
            u_pred = umax
            if umax < 1 or umax > 31:  # 31 = int32 magnitude limit
                # >30 cannot be represented in the doubled int32 domain
                return out  # tolerant: corrupt segment
            for i, (y, x) in enumerate(samples):
                if rho & (1 << i):
                    m = ms.get_bits(umax) + 1
                    sgn = ms.get()
                    val = 2 * m + 1
                    out[y, x] = -val if sgn else val
        prev_rho = row_rho
    return out
