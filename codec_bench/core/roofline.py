"""The least time a layer's work could take on the card, from the cell's
shapes and its codestream's sizes: the bytes each pass must move at the
card's peak bandwidth.  Kernels are matched to a layer by the span they
ran in, never by name, so a share reads the same work whatever kernel
does it.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet):
3.35 TB/s of HBM3, 67 Tops/s of 32-bit operations outside the tensor
cores.  Every pass counted here is bound by bytes: a 5/3 or 9/7 level
moves 8 B a sample (a 4-byte read and a 4-byte write) for a few dozen
operations, far under the 160 an operation bound would need.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
SAMPLE_PASS_BYTES = 8  # one 4-byte read and one 4-byte write a sample
COEFF_BYTES = 4


def transform_bytes(h: int, w: int, comps: int, numres: int) -> int:
    """One colour pass (DC shift and RCT or ICT, or the shift alone) and
    one pass a DWT level, each over the samples it covers."""
    total = comps * h * w
    for lev in range(numres - 1):
        total += comps * (-(-h // 2 ** lev)) * (-(-w // 2 ** lev))
    return SAMPLE_PASS_BYTES * total


def t1_bytes(h: int, w: int, comps: int, coded: int, ht_decode: bool) -> int:
    """Each coefficient read or written once (4 B) and the coded bytes
    written (encode) or read (decode); an HT decode also writes and reads
    the destuffed streams, about the coded bytes again."""
    return COEFF_BYTES * comps * h * w + coded * (2 if ht_decode else 1)


def least_ms(nbytes: int) -> float:
    return 1e3 * nbytes / PEAK_BYTES_S
