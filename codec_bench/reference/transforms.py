"""Plain PyTorch sample transforms of JPEG 2000 Part 1 (Annex F and G):
DC shift, RCT and ICT, the reversible 5/3 and irreversible 9/7 wavelets
by lifting, and the dead-zone quantizer.

The 9/7 path and the ICT compute in a dtype the caller gives: float32 is
the precision the configurations state, and the control computes the same
steps in bfloat16.  The 5/3 path and the RCT are integer arithmetic; the
control breaks their reversibility by computing them in float32 with
rounding to nearest.  A level's pass is vertical then horizontal; each
lifting step is (neighbour + neighbour) * constant + target, rounded once
an operation.  Tile-components start at even coordinates at every level;
anything else raises NotImplementedError.
"""

from __future__ import annotations

import torch

ALPHA = -1.586134342059924
BETA = -0.052980118572961
GAMMA = 0.882911075530934
DELTA = 0.443506852043971
K = 1.230174104914001
ICT_FWD = ((0.299, 0.587, 0.114), (-0.168736, -0.331264, 0.5),
           (0.5, -0.418688, -0.081312))
ICT_INV = ((1.402,), (-0.344136, -0.714136), (1.772,))


def _right(ev: torch.Tensor, no: int) -> torch.Tensor:
    """ev[i + 1] for i < no; past the end the mirror ev[-1] (n even)."""
    if ev.shape[-1] > no:
        return ev[..., 1:]
    return torch.cat([ev[..., 1:], ev[..., -1:]], dim=-1)


def _pair(d: torch.Tensor, ne: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(d[i - 1], d[i]) for i < ne with whole-sample mirrors."""
    left = torch.cat([d[..., :1], d], dim=-1)[..., :ne]
    right = d[..., :ne] if d.shape[-1] >= ne else \
        torch.cat([d, d[..., -1:]], dim=-1)
    return left, right


def _c(v: float, dtype) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float64).to(dtype)


def fwd53(x: torch.Tensor, exact: bool = True):
    """One 5/3 analysis along the last axis (integer; with exact False in
    float32 with rounding to nearest, the control)."""
    n = x.shape[-1]
    if n == 1:
        return x, x[..., :0]
    ev, od = x[..., 0::2], x[..., 1::2]
    no, ne = od.shape[-1], ev.shape[-1]
    if exact:
        d = od - torch.div(ev[..., :no] + _right(ev, no), 2,
                           rounding_mode="floor")
        left, right = _pair(d, ne)
        return ev + torch.div(left + right + 2, 4, rounding_mode="floor"), d
    ev, od = ev.to(torch.float32), od.to(torch.float32)
    d = od - torch.round((ev[..., :no] + _right(ev, no)) / 2)
    left, right = _pair(d, ne)
    s = ev + torch.round((left + right) / 4)
    return s.to(torch.int64), d.to(torch.int64)


def fwd97(x: torch.Tensor, dtype=torch.float32):
    """One 9/7 analysis along the last axis, in `dtype`."""
    x = x.to(dtype)
    n = x.shape[-1]
    if n == 1:
        return x * _c(1.0 / K, dtype), x[..., :0]
    ev, od = x[..., 0::2], x[..., 1::2]
    no, ne = od.shape[-1], ev.shape[-1]
    od = od + _c(ALPHA, dtype) * (ev[..., :no] + _right(ev, no))
    left, right = _pair(od, ne)
    ev = ev + _c(BETA, dtype) * (left + right)
    od = od + _c(GAMMA, dtype) * (ev[..., :no] + _right(ev, no))
    left, right = _pair(od, ne)
    ev = ev + _c(DELTA, dtype) * (left + right)
    return ev * _c(1.0 / K, dtype), od * _c(K, dtype)


def inv97(lo: torch.Tensor, hi: torch.Tensor, dtype=torch.float32):
    """One 9/7 synthesis along the last axis, in `dtype`."""
    ne, no = lo.shape[-1], hi.shape[-1]
    if no == 0:
        return lo.to(dtype) * _c(K, dtype)
    ev = lo.to(dtype) * _c(K, dtype)
    od = hi.to(dtype) * _c(1.0 / K, dtype)
    left, right = _pair(od, ne)
    ev = ev - _c(DELTA, dtype) * (left + right)
    od = od - _c(GAMMA, dtype) * (ev[..., :no] + _right(ev, no))
    left, right = _pair(od, ne)
    ev = ev - _c(BETA, dtype) * (left + right)
    od = od - _c(ALPHA, dtype) * (ev[..., :no] + _right(ev, no))
    out = torch.empty(lo.shape[:-1] + (ne + no,), dtype=dtype)
    out[..., 0::2] = ev
    out[..., 1::2] = od
    return out


def _check_even(rect, levels: int) -> None:
    x0, y0 = rect
    for _ in range(levels):
        if x0 % 2 or y0 % 2:
            raise NotImplementedError("odd tile-component origins are not "
                                      "judged")
        x0, y0 = -(-x0 // 2), -(-y0 // 2)


def analysis(plane: torch.Tensor, numres: int, reversible: bool,
             origin=(0, 0), dtype=torch.float32, exact=True) -> dict:
    """Multi-level DWT of one (H, W) tile-component: {(resno, orient):
    band}, LL at (0, 0).  A level: vertical pass, then horizontal."""
    _check_even(origin, numres - 1)
    bands = {}
    cur = plane
    for lev in range(numres - 1):
        resno = numres - 1 - lev
        if reversible:
            lo, hi = fwd53(cur.transpose(-1, -2), exact)
            (ll, hl), (lh, hh) = fwd53(lo.transpose(-1, -2), exact), \
                fwd53(hi.transpose(-1, -2), exact)
        else:
            lo, hi = fwd97(cur.transpose(-1, -2), dtype)
            (ll, hl), (lh, hh) = fwd97(lo.transpose(-1, -2), dtype), \
                fwd97(hi.transpose(-1, -2), dtype)
        bands[(resno, 1)], bands[(resno, 2)], bands[(resno, 3)] = hl, lh, hh
        cur = ll
    bands[(0, 0)] = cur
    return bands


def synthesis97(bands: dict, numres: int, dtype=torch.float32) -> torch.Tensor:
    """Inverse of analysis on the 9/7 path: a level's pass is horizontal,
    then vertical."""
    cur = bands[(0, 0)].to(dtype)
    for resno in range(1, numres):
        lo = inv97(cur, bands[(resno, 1)], dtype)
        hi = inv97(bands[(resno, 2)], bands[(resno, 3)], dtype)
        cur = inv97(lo.transpose(-1, -2), hi.transpose(-1, -2),
                    dtype).transpose(-1, -2)
    return cur


def rct_forward(r, g, b, exact=True):
    if exact:
        return torch.div(r + 2 * g + b, 4, rounding_mode="floor"), b - g, \
            r - g
    y = torch.round((r + 2 * g + b).to(torch.float32) / 4).to(torch.int64)
    return y, b - g, r - g


def ict_forward(r, g, b, dtype=torch.float32):
    r, g, b = r.to(dtype), g.to(dtype), b.to(dtype)
    return tuple(_c(m[0], dtype) * r + _c(m[1], dtype) * g
                 + _c(m[2], dtype) * b for m in ICT_FWD)


def ict_inverse(y, cb, cr, dtype=torch.float32):
    y, cb, cr = y.to(dtype), cb.to(dtype), cr.to(dtype)
    r = y + _c(ICT_INV[0][0], dtype) * cr
    g = y + _c(ICT_INV[1][0], dtype) * cb + _c(ICT_INV[1][1], dtype) * cr
    b = y + _c(ICT_INV[2][0], dtype) * cb
    return r, g, b


def quantize(c: torch.Tensor, delta: float, dtype=torch.float32):
    """sign(c) * floor(|c| / delta), in `dtype`, as int64."""
    q = torch.floor(c.to(dtype).abs() / _c(delta, dtype)).to(torch.int64)
    return torch.where(c < 0, -q, q)


def dequantize(doubled: torch.Tensor, delta: float, dtype=torch.float32):
    """Doubled-domain Tier-1 samples -> coefficients: v * (delta / 2)."""
    return doubled.to(dtype) * _c(0.5 * delta, dtype)


def forward_planes(planes: torch.Tensor, precs, mct: int, numres: int,
                   reversible: bool, origin=(0, 0), dtype=torch.float32,
                   exact=True) -> list[dict]:
    """(C, H, W) int64 unsigned samples of a tile -> per component its
    bands: DC shift, the colour transform on components 0-2 when `mct`,
    the DWT.  Quantization is left to the caller, who knows the steps."""
    x = [planes[c] - (1 << (precs[c] - 1)) for c in range(planes.shape[0])]
    if mct and len(x) >= 3:
        if reversible:
            x[:3] = rct_forward(*x[:3], exact=exact)
        else:
            x[:3] = ict_forward(*x[:3], dtype=dtype)
    elif not reversible:
        x = [p.to(dtype) for p in x]
    return [analysis(p, numres, reversible, origin, dtype, exact) for p in x]
