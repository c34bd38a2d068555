"""The HT cleanup-pass decoder, frozen from the coder the program writes.

The program's HT block coder keeps the structure of ITU-T T.814 (MEL
events read forward from the segment's suffix, VLC codewords read backward
from it, MagSgn bits from its front, u-prediction along each quad row, the
Scup length in the last 12 bits) but codes each quad's significance pattern
with context-free fixed-length-4 codewords in place of the normative
CxtVLC tables.  This copy decodes that coder, with the identity table,
and nothing of the program is imported: a change of the program's tables
makes every block read wrong here, which is the point.  Samples come back
in the doubled domain, sign * (2m + 1).
"""

from __future__ import annotations

import numpy as np

MEL_E = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5]
CWD_LEN = 4


class _Bits:
    """Bits MSB first; after a 0xFF byte the next carries 7; past the end
    zeros."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0
        self.acc = self.avail = 0
        self.prev_ff = False

    def get(self) -> int:
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


class _Mel:
    """The MEL run-length decoder: events, 1 where a quad is significant."""

    def __init__(self, data: bytes):
        self.k = 0
        self.bits = _Bits(data)
        self.zeros = 0
        self.one = False

    def decode(self) -> int:
        if self.zeros:
            self.zeros -= 1
            return 0
        if self.one:
            self.one = False
            return 1
        if self.bits.get():  # a whole run of 2^E zeros
            self.zeros = (1 << MEL_E[self.k]) - 1
            self.k = min(12, self.k + 1)
            return 0
        run = self.bits.get_bits(MEL_E[self.k])
        self.k = max(0, self.k - 1)
        if run:
            self.zeros, self.one = run - 1, True
            return 0
        return 1


def _get_u(vlc: _Bits) -> int:
    """u-residual prefix code: 0, 10, 110, 111 + 7 bits."""
    for n in range(3):
        if not vlc.get():
            return n
    return 3 + vlc.get_bits(7)


def decode_block(data: bytes, h: int, w: int) -> np.ndarray:
    """An HT cleanup segment -> (h, w) doubled-domain int64 samples; a
    segment that cannot be read gives zeros from where it went wrong."""
    out = np.zeros((h, w), dtype=np.int64)
    if len(data) < 2:
        return out
    scup = (data[-1] << 4) | (data[-2] & 0x0F)
    if scup < 2 or scup > len(data):
        return out
    suffix = data[len(data) - scup:len(data) - 2]
    magsgn = _Bits(data[:len(data) - scup])
    mel = _Mel(bytes(suffix))
    vlc = _Bits(bytes(suffix[::-1]))
    for qy in range((h + 1) // 2):
        u_pred = 1
        for qx in range((w + 1) // 2):
            if not mel.decode():
                continue
            ys = range(2 * qy, min(2 * qy + 2, h))
            xs = range(2 * qx, min(2 * qx + 2, w))
            samples = [(y, x) for x in xs for y in ys]
            # a whole quad: one fixed-length codeword; an edge quad: one
            # bit a sample
            rho = vlc.get_bits(CWD_LEN if len(samples) == 4
                               else len(samples))
            zz = _get_u(vlc)
            umax = u_pred + ((zz >> 1) if zz % 2 == 0 else -((zz + 1) >> 1))
            u_pred = umax
            if not 1 <= umax <= 31:
                return out
            for i, (y, x) in enumerate(samples):
                if rho >> i & 1:
                    m = magsgn.get_bits(umax) + 1
                    out[y, x] = -(2 * m + 1) if magsgn.get() else 2 * m + 1
    return out
