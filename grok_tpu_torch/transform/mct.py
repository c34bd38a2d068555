"""Multi-component transforms: RCT, ICT, custom matrices, DC level shift.

Parity: mct (SURVEY.md §2.1 "MCT", src/lib/core/transform/mct.* [P];
ISO/IEC 15444-1 Annex G): reversible RCT (integer, paired with 5/3) and
irreversible ICT (RGB<->YCbCr float, paired with 9/7); Part-2 arbitrary
decorrelation matrices (MCT/MCC/MCO markers); DC level shift.

Device versions live in grok_tpu_torch.ops; this is the numpy reference.
"""

from __future__ import annotations

import numpy as np

# ICT forward / inverse matrices (ISO 15444-1 G.3, SURVEY.md B.2)
ICT_FWD = np.array([
    [0.299, 0.587, 0.114],
    [-0.168736, -0.331264, 0.5],
    [0.5, -0.418688, -0.081312],
], dtype=np.float64)
ICT_INV = np.array([
    [1.0, 0.0, 1.402],
    [1.0, -0.344136, -0.714136],
    [1.0, 1.772, 0.0],
], dtype=np.float64)


def rct_forward(r: np.ndarray, g: np.ndarray, b: np.ndarray):
    r = r.astype(np.int64)
    g = g.astype(np.int64)
    b = b.astype(np.int64)
    y = (r + 2 * g + b) >> 2  # floor division (numpy >> floors)
    cb = b - g
    cr = r - g
    return y.astype(np.int32), cb.astype(np.int32), cr.astype(np.int32)


def rct_inverse(y: np.ndarray, cb: np.ndarray, cr: np.ndarray):
    y = y.astype(np.int64)
    cb = cb.astype(np.int64)
    cr = cr.astype(np.int64)
    g = y - ((cb + cr) >> 2)
    r = cr + g
    b = cb + g
    return r.astype(np.int32), g.astype(np.int32), b.astype(np.int32)


def ict_forward(r: np.ndarray, g: np.ndarray, b: np.ndarray):
    r = r.astype(np.float32)
    g = g.astype(np.float32)
    b = b.astype(np.float32)
    m = ICT_FWD.astype(np.float32)
    y = m[0, 0] * r + m[0, 1] * g + m[0, 2] * b
    cb = m[1, 0] * r + m[1, 1] * g + m[1, 2] * b
    cr = m[2, 0] * r + m[2, 1] * g + m[2, 2] * b
    return y, cb, cr


def ict_inverse(y: np.ndarray, cb: np.ndarray, cr: np.ndarray):
    y = y.astype(np.float32)
    cb = cb.astype(np.float32)
    cr = cr.astype(np.float32)
    m = ICT_INV.astype(np.float32)
    r = y + m[0, 2] * cr
    g = y + m[1, 1] * cb + m[1, 2] * cr
    b = y + m[2, 1] * cb
    return r, g, b


def matrix_forward(planes: list[np.ndarray], m: np.ndarray) -> list[np.ndarray]:
    """Part-2 custom decorrelation: out_i = sum_j m[i,j] * planes[j]."""
    stacked = np.stack([p.astype(np.float32) for p in planes], axis=0)
    out = np.tensordot(m.astype(np.float32), stacked, axes=(1, 0))
    return [out[i] for i in range(out.shape[0])]


def matrix_inverse(planes: list[np.ndarray], m: np.ndarray) -> list[np.ndarray]:
    return matrix_forward(planes, np.linalg.inv(m.astype(np.float64)))


def dc_shift_forward(x: np.ndarray, prec: int, sgnd: bool) -> np.ndarray:
    if sgnd:
        return x.astype(np.int32, copy=False)
    if prec <= 24 and x.dtype == np.int32:
        # int32 headroom is ample below 24-bit precision (mirrors
        # dc_shift_inverse): one subtract, no int64 round-trip copies
        return x - np.int32(1 << (prec - 1))
    return (x.astype(np.int64) - (1 << (prec - 1))).astype(np.int32)


def round_to_int(p: np.ndarray, prec: int) -> np.ndarray:
    """rint -> int32 (int64 above 28 bits) so dc_shift_inverse stays on
    its integer fast path.  Corrupt lossy streams can overflow the
    float32 synthesis domain to inf/NaN; the cast is silenced —
    dc_shift_inverse clips to the precision range either way."""
    if p.dtype == np.int32:
        return p
    with np.errstate(invalid="ignore"):
        return np.rint(p).astype(np.int32 if prec <= 28 else np.int64)


def dc_shift_inverse(x: np.ndarray, prec: int, sgnd: bool) -> np.ndarray:
    if sgnd:
        if prec >= 32 and x.dtype == np.int32:
            # bounds exceed the dtype: clip is a no-op, and numpy 2.x
            # raises OverflowError on out-of-dtype python-int limits
            return x
        lo, hi = -(1 << (prec - 1)), (1 << (prec - 1)) - 1
        return np.clip(x, lo, hi).astype(np.int32, copy=False)
    if prec <= 24 and x.dtype == np.int32:
        # int32 headroom is ample below 24-bit precision: no int64 round-trip
        y = x + np.int32(1 << (prec - 1))
        np.clip(y, 0, (1 << prec) - 1, out=y)
        return y
    y = x.astype(np.int64) + (1 << (prec - 1))
    return np.clip(y, 0, (1 << prec) - 1).astype(np.int32)


# ------------------------------------------------- fused native dispatch
#
# The decode tail (inverse MCT -> rint -> DC unshift -> clip) and the
# encode ingest (DC shift -> forward MCT) are memory-bandwidth-bound
# full-plane passes; native/mct.cc fuses each chain into ONE pass,
# bit-identical to composing the numpy ops above.  Gated to
# prec <= 24 (the int32 fast-path domain of the shift helpers).

_NATIVE_MCT: list = []


def _native():
    if not _NATIVE_MCT:
        try:
            from ..t1 import native as nat
        except (OSError, RuntimeError):  # not built: the numpy composition
            nat = None
        _NATIVE_MCT.append(nat)
    return _NATIVE_MCT[0]


def shift_round_clip(p: np.ndarray, prec: int, sgnd) -> np.ndarray:
    """round_to_int + dc_shift_inverse in one native pass when eligible."""
    nat = _native()
    if nat is not None and prec <= 24:
        if p.dtype == np.float32:
            return nat.f32_shift_i32_native(p, prec, int(bool(sgnd)))
        if p.dtype == np.int32:
            return nat.i32_shift_i32_native(p, prec, int(bool(sgnd)))
    return dc_shift_inverse(round_to_int(p, prec), prec, sgnd)


def ict_inverse_shift(y, cb, cr, precs, sgnds):
    """ict_inverse -> round_to_int -> dc_shift_inverse, fused."""
    nat = _native()
    if nat is not None and all(pr <= 24 for pr in precs) \
            and y.shape == cb.shape == cr.shape:
        return nat.ict_inv_shift_native(
            y, cb, cr, tuple(precs), tuple(int(bool(s)) for s in sgnds))
    r, g, b = ict_inverse(y, cb, cr)
    return [dc_shift_inverse(round_to_int(p, pr), pr, sg)
            for p, pr, sg in zip((r, g, b), precs, sgnds)]


def rct_inverse_shift(y, cb, cr, precs, sgnds):
    """rct_inverse -> dc_shift_inverse, fused (int32 planes only: the
    numpy oracle wraps through int64 before its final astype, which the
    native pass only reproduces for int32 inputs)."""
    nat = _native()
    if nat is not None and all(pr <= 24 for pr in precs) \
            and y.dtype == cb.dtype == cr.dtype == np.int32 \
            and y.shape == cb.shape == cr.shape:
        return nat.rct_inv_shift_native(
            y, cb, cr, tuple(precs), tuple(int(bool(s)) for s in sgnds))
    r, g, b = rct_inverse(y, cb, cr)
    return [dc_shift_inverse(round_to_int(p, pr), pr, sg)
            for p, pr, sg in zip((r, g, b), precs, sgnds)]


def _fwd_dcs(precs, sgnds):
    return tuple(0 if sg else 1 << (pr - 1)
                 for pr, sg in zip(precs, sgnds))


def ict_forward_shift(r, g, b, precs, sgnds):
    """dc_shift_forward -> ict_forward, fused."""
    nat = _native()
    if nat is not None and all(pr <= 24 for pr in precs) \
            and r.dtype == g.dtype == b.dtype == np.int32 \
            and r.shape == g.shape == b.shape:
        return nat.ict_fwd_shift_native(r, g, b, _fwd_dcs(precs, sgnds))
    sh = [dc_shift_forward(p, pr, sg)
          for p, pr, sg in zip((r, g, b), precs, sgnds)]
    return list(ict_forward(*sh))


def rct_forward_shift(r, g, b, precs, sgnds):
    """dc_shift_forward -> rct_forward, fused."""
    nat = _native()
    if nat is not None and all(pr <= 24 for pr in precs) \
            and r.dtype == g.dtype == b.dtype == np.int32 \
            and r.shape == g.shape == b.shape:
        return nat.rct_fwd_shift_native(r, g, b, _fwd_dcs(precs, sgnds))
    sh = [dc_shift_forward(p, pr, sg)
          for p, pr, sg in zip((r, g, b), precs, sgnds)]
    return list(rct_forward(*sh))


def shift_to_float(x: np.ndarray, prec: int, sgnd) -> np.ndarray:
    """dc_shift_forward -> astype(float32) in one native pass (the
    ingest conversion for irreversible components outside an MCT
    triple)."""
    nat = _native()
    if nat is not None and prec <= 24 and x.dtype == np.int32:
        return nat.i32_shift_f32_native(
            x, 0 if sgnd else 1 << (prec - 1))
    return dc_shift_forward(x, prec, sgnd).astype(np.float32)


# ------------------------------------------------------------------- norms

def mct_norms(irreversible: bool) -> np.ndarray:
    """L2 norms of the inverse-transform columns, used to weight per-
    component distortion in PCRD (SURVEY.md B.8).  Computed numerically from
    the inverse matrices rather than hard-coded tables."""
    if irreversible:
        inv = ICT_INV
    else:
        # linearized RCT inverse: G = Y - (Cb+Cr)/4; R = Cr + G; B = Cb + G
        inv = np.array([
            [1.0, -0.25, 0.75],
            [1.0, -0.25, -0.25],
            [1.0, 0.75, -0.25],
        ])
    return np.sqrt((inv ** 2).sum(axis=0))


def custom_mct_norms(m: np.ndarray) -> np.ndarray:
    inv = np.linalg.inv(m.astype(np.float64))
    return np.sqrt((inv ** 2).sum(axis=0))
