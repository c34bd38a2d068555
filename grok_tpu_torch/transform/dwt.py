"""2-D discrete wavelet transform by lifting — numpy reference path.

Parity: WaveletFwd / WaveletReverse (SURVEY.md §2.1 "Wavelet",
src/lib/core/transform/ [P]; ISO/IEC 15444-1 Annex F):

- reversible integer 5/3 and irreversible float 9/7 lifting
- whole-sample symmetric boundary extension
- canvas-parity-aware even/odd phase: low-pass samples sit at even *canvas*
  positions, so tiles/regions with odd origins lift with swapped phase
  (SURVEY.md B.1 "the classic off-by-one trap")
- multi-level Mallat decomposition on the tile-component rect

The device implementation lives in grok_tpu_torch.ops.dwt; this module
is the bit-exactness oracle (5/3) and numerics oracle (9/7).
"""

from __future__ import annotations

import numpy as np

# 9/7 lifting constants (ISO 15444-1 Table F.4)
ALPHA = -1.586134342059924
BETA = -0.052980118572961
GAMMA = 0.882911075530934
DELTA = 0.443506852043971
K = 1.230174104914001


def _extend_ws(x: np.ndarray, left: int, right: int) -> np.ndarray:
    """Whole-sample symmetric extension along the last axis: mirror without
    repeating the edge sample (… x2 x1 | x0 x1 x2 … x_{n-1} | x_{n-2} …)."""
    n = x.shape[-1]
    if n == 1:
        return np.repeat(x, left + 1 + right, axis=-1)
    idx = np.arange(-left, n + right)
    # reflect into [0, n-1] (period 2n-2)
    period = 2 * n - 2
    idx = np.abs(idx) % period
    idx = np.where(idx >= n, period - idx, idx)
    return x[..., idx]


def _ev_right(ev, ne, no):
    """ev[i+1] for i in 0..no-1; x[n] mirrors to x[n-2] = ev[-1] (n even)."""
    if ne > no:
        return ev[..., 1:]
    return np.concatenate([ev[..., 1:], ev[..., -1:]], axis=-1)


def _d_pair(d, ne, no):
    """(d[i-1], d[i]) for i in 0..ne-1 with whole-sample mirrors."""
    d_l = np.concatenate([d[..., :1], d], axis=-1)[..., :ne]
    if no >= ne:
        d_r = d[..., :ne]
    else:
        d_r = np.concatenate([d, d[..., -1:]], axis=-1)
    return d_l, d_r


def _fwd_53_even(x):
    """Fast even-parity forward 5/3 (mirrors ops.dwt.fwd_53_axis).
    int32 arithmetic: 5/3 coefficients of <= 24-bit samples stay far from
    the int32 range (sums bounded by ~4x the coefficient magnitude)."""
    n = x.shape[-1]
    ne, no = (n + 1) // 2, n // 2
    ev = np.ascontiguousarray(x[..., 0::2], dtype=np.int32)
    od = np.ascontiguousarray(x[..., 1::2], dtype=np.int32)
    d = od - ((ev[..., :no] + _ev_right(ev, ne, no)) >> 1)
    d_l, d_r = _d_pair(d, ne, no)
    s = ev + ((d_l + d_r + 2) >> 2)
    return s, d


def _inv_53_even(lo, hi, n):
    ne, no = (n + 1) // 2, n // 2
    s = np.ascontiguousarray(lo, dtype=np.int32)
    d = np.ascontiguousarray(hi, dtype=np.int32)
    d_l, d_r = _d_pair(d, ne, no)
    ev = s - ((d_l + d_r + 2) >> 2)
    od = d + ((ev[..., :no] + _ev_right(ev, ne, no)) >> 1)
    out = np.empty(lo.shape[:-1] + (n,), dtype=np.int32)
    out[..., 0::2] = ev
    out[..., 1::2] = od
    return out


def _fwd_53_even_v(x):
    """Vertical (axis -2) even-parity forward 5/3 without transposing."""
    n = x.shape[-2]
    ne, no = (n + 1) // 2, n // 2
    ev = x[..., 0::2, :].astype(np.int32)
    od = x[..., 1::2, :].astype(np.int32)
    if ne > no:
        ev_r = ev[..., 1:, :]
    else:
        ev_r = np.concatenate([ev[..., 1:, :], ev[..., -1:, :]], axis=-2)
    d = od - ((ev[..., :no, :] + ev_r) >> 1)
    d_l = np.concatenate([d[..., :1, :], d], axis=-2)[..., :ne, :]
    d_r = d[..., :ne, :] if no >= ne else \
        np.concatenate([d, d[..., -1:, :]], axis=-2)
    s = ev + ((d_l + d_r + 2) >> 2)
    return s, d


def _inv_53_even_v(lo, hi, n):
    """Vertical (axis -2) even-parity inverse 5/3 without transposing."""
    ne, no = (n + 1) // 2, n // 2
    s = lo.astype(np.int32, copy=False)
    d = hi.astype(np.int32, copy=False)
    d_l = np.concatenate([d[..., :1, :], d], axis=-2)[..., :ne, :]
    d_r = d[..., :ne, :] if no >= ne else \
        np.concatenate([d, d[..., -1:, :]], axis=-2)
    ev = s - ((d_l + d_r + 2) >> 2)
    if ne > no:
        ev_r = ev[..., 1:, :]
    else:
        ev_r = np.concatenate([ev[..., 1:, :], ev[..., -1:, :]], axis=-2)
    od = d + ((ev[..., :no, :] + ev_r) >> 1)
    out = np.empty(lo.shape[:-2] + (n,) + lo.shape[-1:], dtype=np.int32)
    out[..., 0::2, :] = ev
    out[..., 1::2, :] = od
    return out


def fwd_53_1d(x: np.ndarray, x0: int) -> tuple[np.ndarray, np.ndarray]:
    """Forward reversible 5/3 along the last axis.

    `x0` is the canvas position of the first sample; low-pass samples live at
    even canvas positions.  Returns (low, high) int arrays."""
    n = x.shape[-1]
    x = x.astype(np.int32, copy=False)
    if n == 0:
        return x[..., :0], x[..., :0]
    if n == 1:
        if x0 & 1:
            return x[..., :0], x * 2
        return x, x[..., :0]
    if (x0 & 1) == 0:
        return _fwd_53_even(x)
    # extended signal covering canvas positions [x0-2, x0+n+2)
    ext = _extend_ws(x, 2, 2).astype(np.int64)
    pos0 = x0 - 2
    # odd canvas positions (high): d[p] = x[p] - floor((x[p-1]+x[p+1])/2)
    # first odd position >= x0-1
    o0 = (pos0 + 1) if (pos0 & 1) == 0 else pos0
    o_idx = np.arange(o0 - pos0, n + 4, 2)
    o_idx = o_idx[(o_idx >= 1) & (o_idx < ext.shape[-1] - 1)]
    d = ext[..., o_idx] - ((ext[..., o_idx - 1] + ext[..., o_idx + 1]) >> 1)
    d_pos0 = pos0 + o_idx[0]
    # even canvas positions (low) within [x0, x0+n):
    # s[p] = x[p] + floor((d[p-1]+d[p+1]+2)/4)
    e0 = x0 if (x0 & 1) == 0 else x0 + 1
    e_idx = np.arange(e0 - pos0, n + 2, 2)
    e_idx = e_idx[e_idx < ext.shape[-1]]
    e_canvas = pos0 + e_idx
    e_canvas = e_canvas[(e_canvas >= x0) & (e_canvas < x0 + n)]
    e_idx = e_canvas - pos0
    dl = (e_canvas - 1 - d_pos0) // 2  # index into d of left odd neighbor
    dr = dl + 1
    dl = np.clip(dl, 0, d.shape[-1] - 1)
    dr = np.clip(dr, 0, d.shape[-1] - 1)
    s = ext[..., e_idx] + ((d[..., dl] + d[..., dr] + 2) >> 2)
    # select the highs within [x0, x0+n)
    o_canvas = pos0 + o_idx
    keep = (o_canvas >= x0) & (o_canvas < x0 + n)
    d_in = d[..., keep]
    return s.astype(np.int32), d_in.astype(np.int32)


def inv_53_1d(low: np.ndarray, high: np.ndarray, x0: int, n: int) -> np.ndarray:
    """Inverse reversible 5/3 along the last axis, producing the signal at
    canvas positions [x0, x0+n)."""
    if n == 0:
        return low[..., :0].astype(np.int32)
    if n == 1:
        if x0 & 1:
            return (high // 2).astype(np.int32)
        return low.astype(np.int32)
    if (x0 & 1) == 0:
        return _inv_53_even(low, high, n)
    # interleave into canvas positions [x0, x0+n)
    shape = low.shape[:-1] + (n,)
    y = np.zeros(shape, dtype=np.int64)
    pos = np.arange(x0, x0 + n)
    y[..., (pos & 1) == 0] = low
    y[..., (pos & 1) == 1] = high
    ext = _extend_ws(y, 2, 2)
    pos0 = x0 - 2
    # s'[even p] = y[p] - floor((y[p-1]+y[p+1]+2)/4)
    e0 = pos0 if (pos0 & 1) == 0 else pos0 + 1
    e_idx = np.arange(e0 - pos0, n + 4, 2)
    e_idx = e_idx[(e_idx >= 1) & (e_idx < ext.shape[-1] - 1)]
    s = ext[..., e_idx] - ((ext[..., e_idx - 1] + ext[..., e_idx + 1] + 2) >> 2)
    s_pos0 = pos0 + e_idx[0]
    # x[odd p] = y[p] + floor((s'[p-1]+s'[p+1])/2)
    o0 = x0 if (x0 & 1) else x0 + 1
    o_canvas = np.arange(o0, x0 + n, 2)
    sl = (o_canvas - 1 - s_pos0) // 2
    sr = sl + 1
    sl = np.clip(sl, 0, s.shape[-1] - 1)
    sr = np.clip(sr, 0, s.shape[-1] - 1)
    o_idx = o_canvas - pos0
    xo = ext[..., o_idx] + ((s[..., sl] + s[..., sr]) >> 1)
    out = np.zeros(shape, dtype=np.int64)
    e_canvas = np.arange(x0 if (x0 & 1) == 0 else x0 + 1, x0 + n, 2)
    out[..., e_canvas - x0] = s[..., (e_canvas - s_pos0) // 2]
    out[..., o_canvas - x0] = xo
    return out.astype(np.int32)


def _lift_97(ext: np.ndarray, pos0: int, inverse: bool) -> np.ndarray:
    """Run the four 9/7 lifting steps (+K scaling) in place on an extended
    float array whose first sample sits at canvas position pos0.  Returns the
    lifted array (same shape).  Forward: predict/update with α β γ δ then
    low *= 1/K, high *= K.  Inverse mirrors in reverse order."""
    y = ext.astype(np.float32, copy=True)
    m = y.shape[-1]
    pos = pos0 + np.arange(m)
    odd = (pos & 1) == 1
    even = ~odd

    def step(target_odd: bool, coeff: float):
        tgt = odd if target_odd else even
        idx = np.nonzero(tgt)[0]
        idx = idx[(idx >= 1) & (idx < m - 1)]
        y[..., idx] += coeff * (y[..., idx - 1] + y[..., idx + 1])

    if not inverse:
        step(True, ALPHA)
        step(False, BETA)
        step(True, GAMMA)
        step(False, DELTA)
        y[..., even] *= np.float32(1.0 / K)
        y[..., odd] *= np.float32(K)
    else:
        y[..., even] *= np.float32(K)
        y[..., odd] *= np.float32(1.0 / K)
        step(False, -DELTA)
        step(True, -GAMMA)
        step(False, -BETA)
        step(True, -ALPHA)
    return y


def _fwd_97_even(x):
    """Fast even-parity forward 9/7 (mirrors ops.dwt.fwd_97_axis)."""
    n = x.shape[-1]
    ne, no = (n + 1) // 2, n // 2
    ev = x[..., 0::2].astype(np.float32)
    od = x[..., 1::2].astype(np.float32)
    od = od + np.float32(ALPHA) * (ev[..., :no] + _ev_right(ev, ne, no))
    d_l, d_r = _d_pair(od, ne, no)
    ev = ev + np.float32(BETA) * (d_l + d_r)
    od = od + np.float32(GAMMA) * (ev[..., :no] + _ev_right(ev, ne, no))
    d_l, d_r = _d_pair(od, ne, no)
    ev = ev + np.float32(DELTA) * (d_l + d_r)
    return ev * np.float32(1.0 / K), od * np.float32(K)


def _inv_97_even(lo, hi, n):
    ne, no = (n + 1) // 2, n // 2
    ev = lo.astype(np.float32) * np.float32(K)
    od = hi.astype(np.float32) * np.float32(1.0 / K)
    d_l, d_r = _d_pair(od, ne, no)
    ev = ev - np.float32(DELTA) * (d_l + d_r)
    od = od - np.float32(GAMMA) * (ev[..., :no] + _ev_right(ev, ne, no))
    d_l, d_r = _d_pair(od, ne, no)
    ev = ev - np.float32(BETA) * (d_l + d_r)
    od = od - np.float32(ALPHA) * (ev[..., :no] + _ev_right(ev, ne, no))
    out = np.empty(lo.shape[:-1] + (n,), dtype=np.float32)
    out[..., 0::2] = ev
    out[..., 1::2] = od
    return out


def fwd_97_1d(x: np.ndarray, x0: int) -> tuple[np.ndarray, np.ndarray]:
    n = x.shape[-1]
    x = x.astype(np.float32, copy=False)
    if n == 0:
        return x[..., :0], x[..., :0]
    if n == 1:
        if x0 & 1:
            return x[..., :0], x * np.float32(K)
        return x * np.float32(1.0 / K), x[..., :0]
    if (x0 & 1) == 0:
        return _fwd_97_even(x)
    ext = _extend_ws(x, 4, 4)
    y = _lift_97(ext, x0 - 4, inverse=False)
    core = y[..., 4:4 + n]
    pos = x0 + np.arange(n)
    return core[..., (pos & 1) == 0], core[..., (pos & 1) == 1]


def inv_97_1d(low: np.ndarray, high: np.ndarray, x0: int, n: int) -> np.ndarray:
    if n == 0:
        return low[..., :0].astype(np.float32)
    if n == 1:
        if x0 & 1:
            return high * np.float32(1.0 / K)
        return low * np.float32(K)
    if (x0 & 1) == 0:
        return _inv_97_even(low, high, n)
    shape = low.shape[:-1] + (n,)
    y = np.zeros(shape, dtype=np.float32)
    pos = np.arange(x0, x0 + n)
    y[..., (pos & 1) == 0] = low
    y[..., (pos & 1) == 1] = high
    ext = _extend_ws(y, 4, 4)
    out = _lift_97(ext, x0 - 4, inverse=True)
    return out[..., 4:4 + n]


# ---------------------------------------------------------------------------
# 2-D multi-level transforms on a tile-component
# ---------------------------------------------------------------------------

def _split_2d(a: np.ndarray, rect, reversible: bool):
    """One forward DWT level on array `a` covering canvas rect -> (ll, hl,
    lh, hh) with their sub-rects.  Vertical pass first, then horizontal
    (matches the reference decomposition order; verified via bit-exact
    lossless interop with the oracle)."""
    fwd = fwd_53_1d if reversible else fwd_97_1d
    # vertical pass: transpose-free fast path for even-parity 5/3
    if reversible and (rect.y0 & 1) == 0 and a.shape[-2] > 1:
        lo_v, hi_v = _fwd_53_even_v(a)
    else:
        lo_v, hi_v = fwd(np.ascontiguousarray(a.T), rect.y0)
        lo_v = lo_v.T  # rows at even canvas y
        hi_v = hi_v.T
    # horizontal on both halves
    ll, hl = fwd(lo_v, rect.x0)
    lh, hh = fwd(hi_v, rect.x0)
    return ll, hl, lh, hh


def _merge_2d(ll, hl, lh, hh, rect, reversible: bool):
    """One inverse DWT level producing the array covering canvas rect."""
    inv = inv_53_1d if reversible else inv_97_1d
    h, w = rect.y1 - rect.y0, rect.x1 - rect.x0
    lo_v = inv(ll, hl, rect.x0, w)
    hi_v = inv(lh, hh, rect.x0, w)
    if reversible and (rect.y0 & 1) == 0 and h > 1:
        return _inv_53_even_v(lo_v, hi_v, h)
    out = inv(np.ascontiguousarray(lo_v.T), np.ascontiguousarray(hi_v.T),
              rect.y0, h)
    return np.ascontiguousarray(out.T)


def _native53():
    """The C++ 5/3 level functions, or None (lazy import with fallback)."""
    global _NATIVE53
    if _NATIVE53 is None:
        try:
            from ..t1 import native as nat

            _NATIVE53 = (nat.fwd53_level_native, nat.inv53_level_native)
            _NATIVE97[:] = [nat.fwd97_level_native, nat.inv97_level_native,
                            nat.inv97_level_dq_native]
        except (OSError, RuntimeError):
            _NATIVE53 = ()
    return _NATIVE53 or None


_NATIVE97: list = []


def _native97():
    _native53()
    return _NATIVE97 or None


_NATIVE53 = None


def forward_dwt(data: np.ndarray, tc_rect, numres: int, reversible: bool):
    """Full forward multi-level DWT.

    Returns a dict mapping (resno, orient) -> coefficient array, where
    orient uses tile.geometry codes (LL only at resno 0; HL/LH/HH at
    resno >= 1).  Even-parity reversible levels run through the native
    C++ lifting (bit-identical; differential-tested)."""
    from ..tile.geometry import Rect, res_rect

    nat = _native53() if reversible else _native97()
    bands: dict[tuple[int, int], np.ndarray] = {}
    cur = data
    cur_rect = tc_rect
    nl = numres - 1
    for lev in range(nl):
        resno = nl - lev  # bands produced belong to this resolution
        if nat is not None and (cur_rect.x0 & 1) == 0 \
                and (cur_rect.y0 & 1) == 0 and isinstance(cur, np.ndarray):
            ll, hl, lh, hh = nat[0](cur)
        else:
            ll, hl, lh, hh = _split_2d(cur, cur_rect, reversible)
        bands[(resno, 1)] = hl
        bands[(resno, 2)] = lh
        bands[(resno, 3)] = hh
        cur = ll
        cur_rect = Rect(-(-cur_rect.x0 // 2), -(-cur_rect.y0 // 2),
                        -(-cur_rect.x1 // 2), -(-cur_rect.y1 // 2))
    bands[(0, 0)] = cur
    return bands


def window_produce_rects(tc_rect, numres: int, reversible: bool,
                         win, max_res: int | None = None) -> dict:
    """Per-resolution rects the window-aware inverse must reconstruct
    (SURVEY.md §3.3: 'WaveletReverse lifts only the needed line spans').

    `win` is the decode window in the coordinates of resolution
    ``max_res``.  Walking down the pyramid, each level needs the half-size
    span plus a lifting margin m chosen so the symmetric-extension error a
    cropped merge makes at its edges (<= 2m-1 samples) never reaches the
    span the level above consumes: m=3 for 5/3 (support 2), m=5 for 9/7
    (support 4)."""
    from ..tile.geometry import Rect, res_rect

    if max_res is None:
        max_res = numres - 1
    m = 3 if reversible else 5
    produce = {}
    rr = res_rect(tc_rect, numres, max_res)
    produce[max_res] = Rect(max(win.x0, rr.x0), max(win.y0, rr.y0),
                            min(win.x1, rr.x1), min(win.y1, rr.y1))
    for r in range(max_res, 0, -1):
        p = produce[r]
        rr = res_rect(tc_rect, numres, r - 1)
        produce[r - 1] = Rect(
            max(p.x0 // 2 - m, rr.x0), max(p.y0 // 2 - m, rr.y0),
            min(-(-p.x1 // 2) + m, rr.x1), min(-(-p.y1 // 2) + m, rr.y1))
    return produce


def window_band_rect(produce: dict, resno: int):
    """Band-coordinate window covering everything the cropped merges read
    from the (resno, orient>=1) bands (or the LL band for resno 0)."""
    from ..tile.geometry import Rect

    if resno == 0:
        return produce[0]
    p = produce[resno - 1]
    # high-axis indices are floor-based (one below the low-axis origin)
    return Rect(p.x0 - 1, p.y0 - 1, p.x1, p.y1)


def inverse_dwt_window(bands: dict, band_offsets: dict, tc_rect,
                       numres: int, reversible: bool, produce: dict,
                       max_res: int) -> np.ndarray:
    """Window-aware inverse multi-level DWT over CROPPED band arrays.

    `bands[(resno, orient)]` holds only the window portion of each band;
    `band_offsets[(resno, orient)]` gives the band-coordinate rect each
    crop covers.  Returns the array covering ``produce[max_res]``."""
    from ..tile.geometry import Rect, res_rect

    def crop(key, rect):
        arr = bands[key]
        off = band_offsets[key]
        return arr[rect.y0 - off.y0:rect.y1 - off.y0,
                   rect.x0 - off.x0:rect.x1 - off.x0]

    cur_rect = produce[0]
    cur = crop((0, 0), cur_rect)
    for r in range(1, max_res + 1):
        rr = res_rect(tc_rect, numres, r)
        p = produce[r - 1]
        # reconstructable span: even positions need lows [p.x0, p.x1);
        # odd positions need highs, whose crops follow the floor-based
        # rule (index p.x0 - 1 on the left, see produce_high) — so the
        # span may START one odd position before 2*p.x0.  Clipping that
        # column away breaks tiles whose low resolutions are EMPTY
        # (odd-origin width-1 columns: the only sample is odd and comes
        # entirely from the high band).  Only start odd when the target
        # rect actually needs that column — an odd origin knocks the 5/3
        # inverse off its vectorized even-parity fast path (measured
        # -28% on window decodes when applied unconditionally).
        tgt = produce[r]
        # Start odd ALSO when the produce rect was clipped at the low
        # band's edge of an odd-origin tile: there rr.x0 == 2*p.x0 - 1
        # and the high band really holds index p.x0 - 1, so an even
        # start would mirror-fake a sample that exists and pollute the
        # first `sup` columns — which a zero-margin window (tgt.x0 ==
        # 2*p.x0) then keeps.  Interior starts have >= 2m-1 > sup
        # columns of margin slack, so the condition never fires there
        # and the vectorized even-parity path is kept.
        sup = 2 if reversible else 4
        x0 = 2 * p.x0
        if tgt.x0 < x0 or (rr.x0 < x0 and tgt.x0 < x0 + sup):
            x0 -= 1
        y0 = 2 * p.y0
        if tgt.y0 < y0 or (rr.y0 < y0 and tgt.y0 < y0 + sup):
            y0 -= 1
        o = Rect(max(x0, rr.x0), max(y0, rr.y0),
                 min(2 * p.x1, rr.x1), min(2 * p.y1, rr.y1))
        # even/odd index spans of the output rect in the level-below grids
        ex0, ey0 = -(-o.x0 // 2), -(-o.y0 // 2)
        ox0, oy0 = o.x0 // 2, o.y0 // 2
        ex1, ey1 = -(-o.x1 // 2), -(-o.y1 // 2)
        ox1, oy1 = o.x1 // 2, o.y1 // 2
        ll = cur[ey0 - cur_rect.y0:ey1 - cur_rect.y0,
                 ex0 - cur_rect.x0:ex1 - cur_rect.x0]
        hl = crop((r, 1), Rect(ox0, ey0, ox1, ey1))
        lh = crop((r, 2), Rect(ex0, oy0, ex1, oy1))
        hh = crop((r, 3), Rect(ox0, oy0, ox1, oy1))
        out = _merge_2d(ll, hl, lh, hh, o, reversible)
        if r == max_res:
            p_out = produce[r]
            return out[p_out.y0 - o.y0:p_out.y1 - o.y0,
                       p_out.x0 - o.x0:p_out.x1 - o.x0]
        cur_rect = produce[r]
        cur = out[cur_rect.y0 - o.y0:cur_rect.y1 - o.y0,
                  cur_rect.x0 - o.x0:cur_rect.x1 - o.x0]
    return cur


def _halve_doubled(a: np.ndarray) -> np.ndarray:
    """T1 doubled-domain sign*(2q+1) -> value sign*q (truncate toward 0)."""
    a = a.astype(np.int32, copy=False)
    return (a - (a >> 31)) >> 1


def inverse_dwt(bands: dict, tc_rect, numres: int, reversible: bool,
                max_res: int | None = None,
                doubled: bool = False,
                deltas: dict | None = None) -> np.ndarray:
    """Full inverse multi-level DWT from a band dict.  If max_res is given,
    stop after reconstructing that resolution (resolution-reduced decode).

    With ``doubled=True`` (reversible only) the band arrays are still in
    the T1 doubled domain (sign * (2q+1)); the halving is fused into the
    native band loads (one full-plane pass saved per band) and applied
    lazily on any fallback level.

    With ``deltas`` set (irreversible only; ``{(resno, orient):
    stepsize}``) the band arrays are int32 doubled-domain coefficients
    and dequantization (value = doubled * float32(0.5 * Delta_b),
    transform/quant.py) is fused into the native band loads the same
    way, applied lazily on fallback levels."""
    from ..tile.geometry import Rect, res_rect

    from . import quant as quant_mod

    nl = numres - 1
    if max_res is None:
        max_res = numres - 1
    nat = _native53() if reversible else _native97()
    doubled = doubled and reversible
    dq = deltas is not None and not reversible
    if dq and (nat is None or len(nat) < 3):
        dq = False  # no native dq kernel: dequantize everything upfront
        bands = {k: quant_mod.dequantize(v, deltas[k])
                 for k, v in bands.items()}
    cur = bands[(0, 0)]
    cur_raw = doubled or dq  # cur still needs halving / dequantization
    for resno in range(1, max_res + 1):
        rect = res_rect(tc_rect, numres, resno)
        if nat is not None and (rect.x0 & 1) == 0 and (rect.y0 & 1) == 0 \
                and isinstance(cur, np.ndarray):
            if doubled:
                halve = (1 if cur_raw else 0) | 2
                cur = nat[1](cur, bands[(resno, 1)], bands[(resno, 2)],
                             bands[(resno, 3)], rect.h, rect.w, halve)
            elif dq:
                dll = 0.5 * deltas[(0, 0)] if cur_raw else None
                cur = nat[2](cur, bands[(resno, 1)], bands[(resno, 2)],
                             bands[(resno, 3)], rect.h, rect.w, dll,
                             0.5 * deltas[(resno, 1)],
                             0.5 * deltas[(resno, 2)],
                             0.5 * deltas[(resno, 3)])
            else:
                cur = nat[1](cur, bands[(resno, 1)], bands[(resno, 2)],
                             bands[(resno, 3)], rect.h, rect.w)
        else:
            if cur_raw:
                cur = (_halve_doubled(cur) if doubled else
                       quant_mod.dequantize(cur, deltas[(0, 0)]))
            hl, lh, hh = (bands[(resno, 1)], bands[(resno, 2)],
                          bands[(resno, 3)])
            if doubled:
                hl, lh, hh = map(_halve_doubled, (hl, lh, hh))
            elif dq:
                hl, lh, hh = (quant_mod.dequantize(b, deltas[(resno, o)])
                              for o, b in ((1, hl), (2, lh), (3, hh)))
            cur = _merge_2d(cur, hl, lh, hh, rect, reversible)
        cur_raw = False
    if cur_raw:
        cur = (_halve_doubled(cur) if doubled else
               quant_mod.dequantize(cur, deltas[(0, 0)]))
    return cur
