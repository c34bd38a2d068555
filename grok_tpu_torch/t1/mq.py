"""MQ arithmetic coder (ISO/IEC 15444-1 Annex C).

Parity: the reference's mqc_* encoder/decoder (SURVEY.md §2.1 "Tier-1 Part 1",
B.5).  This is the Python reference implementation — the correctness oracle
for the native C++ backend (native/t1.cc) which carries production traffic.

State: A (16-bit interval), C (28-bit code register), CT (renorm counter),
per-context (state index, MPS).  BYTEOUT performs 0xFF bit-stuffing: after a
0xFF byte the next byte carries only 7 bits.  The decoder's BYTEIN treats a
marker-range byte pair (0xFF then > 0x8F) as an endless supply of 1-bits so
decoding can safely run past a truncated segment (SURVEY.md §5 tolerant
decode).
"""

from __future__ import annotations

# 47-state probability table: (Qe, NMPS, NLPS, SWITCH) — ISO 15444-1 Table C.2
QE_TABLE = [
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

NUM_CTXS = 19
# context indices (internal numbering; SURVEY.md B.4)
CTX_ZC = 0      # 0..8 zero coding
CTX_SC = 9      # 9..13 sign coding
CTX_MAG = 14    # 14..16 magnitude refinement
CTX_RL = 17     # run-length (aggregation)
CTX_UNI = 18    # uniform

# initial (state, mps) per context: ZC0 -> 4, RL -> 3, UNI -> 46, rest 0
def initial_contexts() -> list[list[int]]:
    ctxs = [[0, 0] for _ in range(NUM_CTXS)]
    ctxs[CTX_ZC][0] = 4
    ctxs[CTX_RL][0] = 3
    ctxs[CTX_UNI][0] = 46
    return ctxs


class MQEncoder:
    def __init__(self) -> None:
        self.ctxs = initial_contexts()
        self.restart()

    def restart(self) -> None:
        """INITENC — start a new codeword segment (contexts preserved)."""
        self.a = 0x8000
        self.c = 0
        self.ct = 12
        self._bytes = bytearray(b"\x00")  # fake leading byte (B register)

    def reset_contexts(self) -> None:
        self.ctxs = initial_contexts()

    def encode(self, d: int, ctx: int) -> None:
        state, mps = self.ctxs[ctx]
        qe, nmps, nlps, switch = QE_TABLE[state]
        if d == mps:
            # CODEMPS
            self.a -= qe
            if (self.a & 0x8000) == 0:
                if self.a < qe:
                    self.a = qe
                else:
                    self.c += qe
                self.ctxs[ctx][0] = nmps
                self._renorm()
            else:
                self.c += qe
        else:
            # CODELPS
            self.a -= qe
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if switch:
                self.ctxs[ctx][1] = 1 - mps
            self.ctxs[ctx][0] = nlps
            self._renorm()

    def _renorm(self) -> None:
        while True:
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def _byteout(self) -> None:
        bs = self._bytes
        if bs[-1] == 0xFF:
            bs.append((self.c >> 20) & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        else:
            if self.c < 0x8000000:
                bs.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8
            else:
                bs[-1] += 1  # carry propagation into previous byte
                if bs[-1] == 0xFF:
                    self.c &= 0x7FFFFFF
                    bs.append((self.c >> 20) & 0xFF)
                    self.c &= 0xFFFFF
                    self.ct = 7
                else:
                    bs.append((self.c >> 19) & 0xFF)
                    self.c &= 0x7FFFF
                    self.ct = 8

    def num_bytes(self) -> int:
        """Bytes emitted so far (excluding the fake leading byte)."""
        return len(self._bytes) - 1

    def flush(self) -> bytes:
        """Standard flush; returns the completed segment's bytes."""
        # SETBITS
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        out = self._bytes[1:]
        if out and out[-1] == 0xFF:
            out = out[:-1]  # a trailing 0xFF is never needed
        return bytes(out)




class MQDecoder:
    def __init__(self, data: bytes) -> None:
        self.ctxs = initial_contexts()
        self.init_segment(data)

    def init_segment(self, data: bytes) -> None:
        """INITDEC on a new codeword segment (contexts preserved)."""
        self.data = data
        self.bp = 0
        b0 = data[0] if data else 0xFF
        self.c = (b0 << 16) & 0xFFFFFFFF
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def reset_contexts(self) -> None:
        self.ctxs = initial_contexts()

    def _byte_at(self, i: int) -> int:
        return self.data[i] if 0 <= i < len(self.data) else 0xFF

    def _bytein(self) -> None:
        if self._byte_at(self.bp) == 0xFF:
            if self._byte_at(self.bp + 1) > 0x8F:
                # marker reached: feed 1-bits forever
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp += 1
                self.c += self._byte_at(self.bp) << 9
                self.ct = 7
        else:
            self.bp += 1
            self.c += self._byte_at(self.bp) << 8
            self.ct = 8
        self.c &= 0xFFFFFFFF

    def decode(self, ctx: int) -> int:
        state, mps = self.ctxs[ctx]
        qe, nmps, nlps, switch = QE_TABLE[state]
        self.a -= qe
        if ((self.c >> 16) & 0xFFFF) < qe:
            # LPS exchange path
            if self.a < qe:
                d = mps
                self.ctxs[ctx][0] = nmps
            else:
                d = 1 - mps
                if switch:
                    self.ctxs[ctx][1] = 1 - mps
                self.ctxs[ctx][0] = nlps
            self.a = qe
            self._renorm()
        else:
            self.c -= qe << 16
            if (self.a & 0x8000) == 0:
                # MPS exchange path
                if self.a < qe:
                    d = 1 - mps
                    if switch:
                        self.ctxs[ctx][1] = 1 - mps
                    self.ctxs[ctx][0] = nlps
                else:
                    d = mps
                    self.ctxs[ctx][0] = nmps
                self._renorm()
            else:
                d = mps
        return d

    def _renorm(self) -> None:
        while True:
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break


class RawEncoder:
    """Raw bit coder for bypass (lazy) passes — D.4: 0xFF stuffing only."""

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._acc = 0
        self._used = 0
        self._cap = 8

    def encode(self, d: int) -> None:
        self._acc = (self._acc << 1) | (d & 1)
        self._used += 1
        if self._used == self._cap:
            self._bytes.append(self._acc)
            self._cap = 7 if self._acc == 0xFF else 8
            self._acc = 0
            self._used = 0

    def flush(self) -> bytes:
        if self._used:
            self._acc <<= self._cap - self._used
            self._bytes.append(self._acc)
            self._acc = 0
            self._used = 0
            self._cap = 8
        out = self._bytes
        if out and out[-1] == 0xFF:
            out = out[:-1]
        return bytes(out)

    def num_bytes(self) -> int:
        return len(self._bytes) + (1 if self._used else 0)


class RawDecoder:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0
        self._acc = 0
        self._avail = 0
        self._prev_ff = False

    def decode(self) -> int:
        if self._avail == 0:
            b = self.data[self.pos] if self.pos < len(self.data) else 0xFF
            self.pos += 1
            if self._prev_ff:
                self._acc = b
                self._avail = 7
            else:
                self._acc = b
                self._avail = 8
            self._prev_ff = b == 0xFF
        self._avail -= 1
        return (self._acc >> self._avail) & 1
