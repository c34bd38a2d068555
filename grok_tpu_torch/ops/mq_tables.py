"""Tables and limits of the MQ Tier-1 coders: the port of the top of
grok_tpu/ops/mq_encode.py (`_build_luts`, `_INIT_CTX` and the constants).

The tables are built from the port's own Tier-1 definitions
(t1/coder.py `_zc_context` and `_SC_TABLE`, t1/mq.py `QE_TABLE`):
- ZC_LUT[orient, f]: the zero-coding context of an 8-bit neighbour
  significance pattern f, bits NW N NE W E SW S SE from bit 0;
- SC_CN[f], SC_XOR[f]: the sign-coding context and XOR bit of an 8-bit
  pattern, bits W-sig W-neg E-sig E-neg N-sig N-neg S-sig S-neg;
- QE, NMPS, NLPS: the MQ probability table packed by si = state * 2 + mps,
  so one index gives Qe and both successors (NLPS folds in the MPS
  switch);
- INIT_CTX: the si of every context at the start of a codeblock;
- for the kernels (csrc/mq_common.cuh), which keep native/t1.cc's 16-bit
  flag word a sample: SC_WORD[i], the SC context | XOR bit << 7 of the
  8 bits the kernels gather from a flag word (N W E S sig, then W E N S
  neg, from bit 0), and QE_FUSED[si], qe | MPS << 15 | NMPS << 16 |
  NLPS << 24, one entry a context state.

`smem_bytes(h, w)` is the kernels' dynamic shared memory for an h x w
codeblock: the tables and context states, the flag words with their
border, and a 16-bit plane map entry a stripe column; a launch takes its
largest block's (`launch_smem`).

The limits decide which codeblocks the device routers take, so they are
the reference's: NUMBPS_BUCKETS, MAX_NUMBPS_DEVICE (26) and
MAX_NUMBPS_DIST (20, where every distortion partial sum stays an integer
below 2^53).
"""

from __future__ import annotations

import numpy as np

from ..t1.coder import _SC_TABLE, _zc_context
from ..t1.mq import QE_TABLE

CTX_ZC, CTX_SC, CTX_MAG, CTX_RL, CTX_UNI = 0, 9, 14, 17, 18
NUM_CTX = 19
# the reference's numbps buckets (one jit specialisation each there); the
# largest is the device range
NUMBPS_BUCKETS = (8, 14, 22, 26)
MAX_NUMBPS_DEVICE = NUMBPS_BUCKETS[-1]
MAX_NUMBPS_DIST = 20


def _build_luts():
    zc = np.zeros((4, 256), dtype=np.uint8)
    for orient in range(4):
        for f in range(256):
            h = ((f >> 3) & 1) + ((f >> 4) & 1)
            v = ((f >> 1) & 1) + ((f >> 6) & 1)
            d = (f & 1) + ((f >> 2) & 1) + ((f >> 5) & 1) + ((f >> 7) & 1)
            zc[orient, f] = _zc_context(h, v, d, orient)
    sc_cn = np.zeros(256, dtype=np.uint8)
    sc_xor = np.zeros(256, dtype=np.uint8)
    for idx in range(256):
        def contrib(sb, nb):
            if not (idx >> sb) & 1:
                return 0
            return -1 if (idx >> nb) & 1 else 1
        hc = max(-1, min(1, contrib(0, 1) + contrib(2, 3)))
        vc = max(-1, min(1, contrib(4, 5) + contrib(6, 7)))
        off, xr = _SC_TABLE[(hc, vc)]
        sc_cn[idx] = CTX_SC + off
        sc_xor[idx] = xr
    qe = np.zeros(94, dtype=np.uint32)
    nmps = np.zeros(94, dtype=np.uint8)
    nlps = np.zeros(94, dtype=np.uint8)
    for s, (q, nm, nl, sw) in enumerate(QE_TABLE):
        for mps in range(2):
            qe[s * 2 + mps] = q
            nmps[s * 2 + mps] = nm * 2 + mps
            nlps[s * 2 + mps] = nl * 2 + (mps ^ sw)
    return zc, sc_cn, sc_xor, qe, nmps, nlps


ZC_LUT, SC_CN, SC_XOR, QE, NMPS, NLPS = _build_luts()


def _sc_word():
    """SC_WORD from SC_CN and SC_XOR: the kernels' gather order mapped to
    the twins' (a sign bit counts only with its significance bit)."""
    out = np.zeros(256, dtype=np.uint8)
    for i in range(256):
        n, w, e, s = (i & 1, (i >> 1) & 1, (i >> 2) & 1, (i >> 3) & 1)
        wn, en, nn, sn = ((i >> 4) & 1, (i >> 5) & 1, (i >> 6) & 1,
                          (i >> 7) & 1)
        old = (w | (w & wn) << 1 | e << 2 | (e & en) << 3 | n << 4
               | (n & nn) << 5 | s << 6 | (s & sn) << 7)
        out[i] = SC_CN[old] | SC_XOR[old] << 7
    return out


SC_WORD = _sc_word()
QE_FUSED = (QE | (np.arange(94, dtype=np.uint32) & 1) << 15
            | NMPS.astype(np.uint32) << 16
            | NLPS.astype(np.uint32) << 24).astype(np.uint32)

INIT_CTX = np.zeros(NUM_CTX, dtype=np.uint8)
INIT_CTX[CTX_ZC] = 4 * 2
INIT_CTX[CTX_RL] = 3 * 2
INIT_CTX[CTX_UNI] = 46 * 2


def out_capacity(h, w, numbps):
    """Bytes a codeblock's codeword may take: the native coder's bound
    (native/t1.cc), h * w * numbps / 3 + 1024 (ints, or numpy arrays of
    them)."""
    return h * w * np.maximum(numbps, 1) // 3 + 1024


# csrc/mq_common.cuh kSmemFixed: the tables (1,656 B, to 16), the 19
# context states (76 B, to 16) and a sink of the same size ahead of a
# block's flag words
SMEM_FIXED = 1824


def smem_bytes(h: int, w: int) -> int:
    """Dynamic shared memory of the MQ kernels for an h x w codeblock:
    SMEM_FIXED, the 16-bit flag words of ceil(h / 4) + 2 stripes of w + 2
    columns of 4 rows (to 16 bytes), then the plane map, 16 bits a stripe
    column (to 16 bytes)."""
    stripes = (h + 3) // 4
    flags = (stripes + 2) * (w + 2) * 4 * 2
    return (SMEM_FIXED + (flags + 15) // 16 * 16
            + (2 * stripes * w + 15) // 16 * 16)


def launch_smem(shapes) -> int:
    """A launch's dynamic shared memory: its largest block's (shapes: (h,
    w) pairs, or an (n, 2) array)."""
    s = np.asarray(shapes, np.int64).reshape(-1, 2)
    return int(smem_bytes(s[:, 0], s[:, 1]).max())
