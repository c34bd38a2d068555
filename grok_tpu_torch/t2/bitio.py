"""Packet-header bit I/O with 0xFF stuffing.

Parity: the reference's bit-level packet-header reader/writer (SURVEY.md
§2.1 "Tier-2", Appendix B.6): bits are written MSB-first; after emitting a
0xFF byte the next byte carries only 7 payload bits (MSB forced to 0), so no
two-byte sequence >= 0xFF90 can appear inside a packet header.  `flush` pads
with zero bits; if the final byte is 0xFF a guard byte is emitted (the
reader's `align` symmetrically consumes it).
"""

from __future__ import annotations


class BitWriter:
    def __init__(self) -> None:
        self._bytes = bytearray()
        self._acc = 0     # bits accumulated MSB-first (unbounded int)
        self._used = 0    # bits in _acc
        self._cap = 8     # capacity of current byte (7 right after a 0xFF)

    def _drain(self) -> None:
        while self._used >= self._cap:
            shift = self._used - self._cap
            byte = (self._acc >> shift) & ((1 << self._cap) - 1)
            self._acc &= (1 << shift) - 1
            self._used = shift
            self._bytes.append(byte)
            self._cap = 7 if byte == 0xFF else 8

    def write_bit(self, b: int) -> None:
        self._acc = (self._acc << 1) | (b & 1)
        self._used += 1
        if self._used >= self._cap:
            self._drain()

    def write_bits(self, v: int, n: int) -> None:
        self._acc = (self._acc << n) | (v & ((1 << n) - 1))
        self._used += n
        if self._used >= self._cap:
            self._drain()

    def flush(self) -> None:
        while self._used:
            self.write_bit(0)  # zero-pad through the stuffing-aware drain
        if self._cap == 7:
            # last emitted byte was 0xFF: emit the guard byte
            self._bytes.append(0)
        self._cap = 8
        self._acc = 0
        self._used = 0

    def getvalue(self) -> bytes:
        return bytes(self._bytes)

    def __len__(self) -> int:
        return len(self._bytes)


class BitReader:
    def __init__(self, data: bytes, pos: int = 0) -> None:
        self._data = data
        self._pos = pos
        self._acc = 0
        self._avail = 0
        self._prev_ff = False

    def read_bit(self) -> int:
        if self._avail == 0:
            self._load()
        self._avail -= 1
        return (self._acc >> self._avail) & 1

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def _load(self) -> None:
        if self._pos < len(self._data):
            b = self._data[self._pos]
            self._pos += 1
        else:
            b = 0  # tolerant: past-the-end reads zeros (truncated stream)
        self._acc = b
        self._avail = 7 if self._prev_ff else 8
        self._prev_ff = b == 0xFF

    def align(self) -> None:
        """Byte-align at end of packet header; a trailing 0xFF's stuffed
        7-bit byte belongs to the header and is consumed here."""
        self._avail = 0
        if self._prev_ff:
            if self._pos < len(self._data):
                self._pos += 1
            self._prev_ff = False

    @property
    def pos(self) -> int:
        return self._pos
