"""CxtVLC code tables for the HT cleanup pass — the single swap point.

Parity: the normative HTJ2K quad-significance coder (ITU-T T.814 §7.3.5,
ref: src/lib/core/t1/ht/ [P]) maps, per quad, a CONTEXT (derived from
neighbor-quad significance) and the quad pattern rho (+ EMB bits) to a
variable-length codeword through fixed code tables — one table set for
initial-row quad pairs, one for non-initial rows.

**Construction rules, as far as reconstructible without T.814 text:**
the normative tables are prefix codes over (rho, EMB) pairs optimized per
context, at most 7 bits, generated from the probability model in the
standard's Annex; the context is formed from the significance of the
previous quad in the pair and the two quads above.  None of the actual
codeword assignments can be derived in this environment (no T.814 source
and no HT oracle), so the DEFAULT tables below are a self-consistent
stand-in: context-independent, fixed-length-4, identity (codeword ==
rho).  Everything AROUND the table — MEL automaton, segment layout, Scup
framing, MagSgn packing, u-prediction — follows the spec structure and
is pinned by frozen golden vectors (tests/test_ht_tables.py), so
swapping in the normative tables is a change to THIS module only:

    set_tables(enc_cwd, enc_len) -> all three coder paths (Python
    reference, native C++, the CUDA kernels with their plain twins) pick
    up the new code.

Variable-length prefix codes up to MAX_CWD_LEN (= 7, the T.814 maximum)
bits are supported: every context's 16 (rho -> codeword, length) entries
must form a prefix-free code, and set_tables builds a 2**MAX_CWD_LEN
decode LUT per context that all three decoders consume via a fixed-width
window read (peek MAX_CWD_LEN bits, look up (rho, consumed-length),
advance by the consumed length).  Windows that match no codeword — only
reachable on corrupt streams — decode as (rho=0, MAX_CWD_LEN) in every
path so the implementations stay byte-identical even there.
"""

from __future__ import annotations

import numpy as np

NUM_CTX = 8        # context slots (the stand-in uses only ctx 0)
CWD_LEN = 4        # codeword length of the default stand-in tables
MAX_CWD_LEN = 7    # longest supported codeword (T.814 table maximum)


def _identity_tables():
    enc_cwd = np.tile(np.arange(16, dtype=np.uint8), (NUM_CTX, 1))
    enc_len = np.full((NUM_CTX, 16), CWD_LEN, dtype=np.uint8)
    return enc_cwd, enc_len


def _build_dec_lut(enc_cwd: np.ndarray, enc_len: np.ndarray):
    """Per context: LUT over every MAX_CWD_LEN-bit window -> (rho, bits
    consumed).  Uncovered windows (corrupt streams) -> (0, MAX_CWD_LEN)."""
    size = 1 << MAX_CWD_LEN
    lut_rho = np.zeros((NUM_CTX, size), dtype=np.uint8)
    lut_len = np.full((NUM_CTX, size), MAX_CWD_LEN, dtype=np.uint8)
    for c in range(NUM_CTX):
        for rho in range(16):
            ln = int(enc_len[c, rho])
            base = int(enc_cwd[c, rho]) << (MAX_CWD_LEN - ln)
            span = 1 << (MAX_CWD_LEN - ln)
            lut_rho[c, base:base + span] = rho
            lut_len[c, base:base + span] = ln
    return lut_rho, lut_len


ENC_CWD, ENC_LEN = _identity_tables()
DEC_LUT_RHO, DEC_LUT_LEN = _build_dec_lut(ENC_CWD, ENC_LEN)

# callbacks run on table swap (the native installer)
_listeners: list = []

# modules holding the card's copies of the tables (ops/ht_encode.py and
# ops/ht_decode.py, each a _DEVICE_TABLES dict keyed by torch device)
_DEVICE_TABLE_MODULES = ("grok_tpu_torch.ops.ht_encode",
                         "grok_tpu_torch.ops.ht_decode")


def on_swap(fn) -> None:
    _listeners.append(fn)
    fn()  # apply current tables immediately


def _flush_device_caches() -> None:
    # the kernels take the tables as device tensors, uploaded once per
    # device; drop those copies so the next launch uploads the new set
    import sys

    for name in _DEVICE_TABLE_MODULES:
        mod = sys.modules.get(name)
        if mod is not None:
            mod._DEVICE_TABLES.clear()


def set_tables(enc_cwd, enc_len) -> None:
    """Install a CxtVLC table set (shape (NUM_CTX, 16)): per context a
    prefix-free code over the 16 quad patterns, codeword lengths in
    [1, MAX_CWD_LEN] (see module docstring)."""
    global ENC_CWD, ENC_LEN, DEC_LUT_RHO, DEC_LUT_LEN
    enc_cwd = np.asarray(enc_cwd, dtype=np.uint8)
    enc_len = np.asarray(enc_len, dtype=np.uint8)
    if enc_cwd.shape != (NUM_CTX, 16) or enc_len.shape != (NUM_CTX, 16):
        raise ValueError(f"tables must be ({NUM_CTX}, 16)")
    if (enc_len < 1).any() or (enc_len > MAX_CWD_LEN).any():
        raise ValueError(f"codeword lengths must be 1..{MAX_CWD_LEN}")
    for c in range(NUM_CTX):
        for r in range(16):
            if int(enc_cwd[c, r]) >> int(enc_len[c, r]):
                raise ValueError(
                    f"context {c}: codeword {r} wider than its length")
        # prefix-freeness (implies uniqueness): no codeword may be a
        # prefix of another in the same context
        for a in range(16):
            la, ca = int(enc_len[c, a]), int(enc_cwd[c, a])
            for b in range(a + 1, 16):
                lb, cb = int(enc_len[c, b]), int(enc_cwd[c, b])
                lo, hi = (ca, cb) if la <= lb else (cb, ca)
                if (hi >> abs(lb - la)) == lo:
                    raise ValueError(
                        f"context {c}: codewords {a} and {b} are not "
                        f"prefix-free")
    ENC_CWD, ENC_LEN = enc_cwd, enc_len
    DEC_LUT_RHO, DEC_LUT_LEN = _build_dec_lut(enc_cwd, enc_len)
    _flush_device_caches()
    for fn in _listeners:
        fn()


def reset_tables() -> None:
    """Restore the default stand-in tables."""
    enc_cwd, enc_len = _identity_tables()
    set_tables(enc_cwd, enc_len)


def quad_context(rho_left: int, rho_up: int, rho_upleft: int) -> int:
    """Quad coding context from neighbor significance (T.814-shaped:
    3 significance indicators -> 8 contexts).  The stand-in tables are
    context-independent, so every context selects the same code today;
    the hook keeps the normative interface in place."""
    return ((1 if rho_left else 0)
            | ((1 if rho_up else 0) << 1)
            | ((1 if rho_upleft else 0) << 2))
