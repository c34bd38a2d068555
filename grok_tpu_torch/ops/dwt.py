"""Multi-level DWT on batched tiles: the port of grok_tpu/ops/dwt.py.

Operates on even-origin (..., H, W) tiles and keeps the reference's band
layout {(resno, orient): array}: reversible 5/3 on int32, irreversible 9/7
on float32.  Each level lifts vertically, then horizontally (the
host/oracle order); the inverse horizontally, then vertically.  On a CUDA
tensor a level is one launch of csrc/dwt53_level.cu or csrc/dwt97_level.cu,
both passes in shared memory; on a CPU tensor it runs the plain twins
below, built from ops/lifting.py.  Odd H and W and length 1 go through the
kernels as well.

A 9/7 level takes a step for each of its four bands (ll, hl, lh, hh),
0 for none: forward, a band with a step is stored quantized by it
(grok_tpu/ops/mct.py quantize, int32); inverse, a band with a step is a
doubled-domain int32 band, dequantized on load (mct.py dequantize).  The
multi-level drivers take the steps as {(resno, orient): delta} and give
them to the high bands of every level and to LL at the coarsest one.
"""

from __future__ import annotations

import math

import torch

from ..kernels import launch, on_card
from .lifting import (F32_ALPHA, F32_BETA, F32_DELTA, F32_GAMMA, F32_INV_K,
                      F32_K, f32, fwd_53_lift_plain, fwd_97_lift_plain,
                      inv_53_lift_plain, inv_97_lift_plain)
from .mct import dequantize_plain, quantize_plain

_LIFT_CONSTS = (F32_ALPHA, F32_BETA, F32_GAMMA, F32_DELTA, F32_K, F32_INV_K)
_NO_STEPS = (0.0,) * 4


def _band_shapes(lead, h: int, w: int):
    """Shapes of (ll, hl, lh, hh) of one level of an (..., h, w) tile."""
    eh, oh, ew, ow = (h + 1) // 2, h // 2, (w + 1) // 2, w // 2
    return [(*lead, eh, ew), (*lead, eh, ow), (*lead, oh, ew), (*lead, oh, ow)]


def _steps(reversible: bool, steps) -> tuple[float, ...]:
    if reversible:
        if steps is not None:
            raise ValueError("the reversible 5/3 path is not quantized")
        return _NO_STEPS
    steps = _NO_STEPS if steps is None else tuple(float(s) for s in steps)
    if len(steps) != 4 or any(not s >= 0 for s in steps):
        raise ValueError(f"expected four steps >= 0 (ll, hl, lh, hh), got "
                         f"{steps}")
    return steps


def _band_dtype(step: float) -> torch.dtype:
    return torch.int32 if step > 0 else torch.float32


def fwd_level(x: torch.Tensor, reversible: bool = True, steps=None):
    """One forward level on (..., H, W).  Returns (ll, hl, lh, hh); 9/7
    bands with a step come back quantized."""
    steps = _steps(reversible, steps)
    if x.dim() < 2:
        raise ValueError(f"expected a (..., H, W) tensor, got {x.shape}")
    if not on_card(x, dtype=torch.int32 if reversible else torch.float32):
        return fwd_level_plain(x, reversible, None if reversible else steps)
    *lead, h, w = x.shape
    bands = [torch.empty(s, dtype=torch.int32 if reversible else
                         _band_dtype(st), device=x.device)
             for s, st in zip(_band_shapes(lead, h, w), steps)]
    if x.numel():
        if reversible:
            launch("fwd53_level", "grk_fwd53_level", x.device, (x, *bands),
                   (h, w, math.prod(lead)))
        else:
            launch("fwd97_level", "grk_fwd97_level", x.device, (x, *bands),
                   (h, w, math.prod(lead)),
                   _LIFT_CONSTS + tuple(f32(s) for s in steps))
    return tuple(bands)


def inv_level(ll, hl, lh, hh, h: int, w: int, reversible: bool = True,
              steps=None) -> torch.Tensor:
    """One inverse level producing (..., h, w): int32 (5/3) or float32
    (9/7)."""
    steps = _steps(reversible, steps)
    bands = (ll, hl, lh, hh)
    lead = ll.shape[:-2]
    want = _band_shapes(lead, h, w)
    if [tuple(b.shape) for b in bands] != want:
        raise ValueError(f"bands {[tuple(b.shape) for b in bands]}"
                         f" do not make a ({h}, {w}) level")
    for b, s in zip(bands, steps):
        dtype = torch.int32 if reversible else _band_dtype(s)
        if b.dtype != dtype:
            raise TypeError(f"expected a {dtype} band, got {b.dtype}")
    if not on_card(*bands, dtype=None):
        return inv_level_plain(*bands, h, w, reversible,
                               None if reversible else steps)
    out = torch.empty((*lead, h, w), device=ll.device,
                      dtype=torch.int32 if reversible else torch.float32)
    if out.numel():
        if reversible:
            launch("inv53_level", "grk_inv53_level", ll.device,
                   (*bands, out), (h, w, math.prod(lead)))
        else:
            launch("inv97_level", "grk_inv97_level", ll.device,
                   (*bands, out), (h, w, math.prod(lead)),
                   _LIFT_CONSTS + tuple(f32(0.5 * s) if s > 0 else 0.0
                                        for s in steps))
    return out


def fwd_level_plain(x: torch.Tensor, reversible: bool = True, steps=None):
    """Plain PyTorch twin of fwd_level."""
    lift = fwd_53_lift_plain if reversible else fwd_97_lift_plain
    lo_v, hi_v = lift(x, -2)
    ll, hl = lift(lo_v, -1)
    lh, hh = lift(hi_v, -1)
    return tuple(quantize_plain(b, s) if s > 0 else b for b, s in
                 zip((ll, hl, lh, hh), _steps(reversible, steps)))


def inv_level_plain(ll, hl, lh, hh, h: int, w: int, reversible: bool = True,
                    steps=None) -> torch.Tensor:
    """Plain PyTorch twin of inv_level."""
    ll, hl, lh, hh = (dequantize_plain(b, s) if s > 0 else b for b, s in
                      zip((ll, hl, lh, hh), _steps(reversible, steps)))
    lift = inv_53_lift_plain if reversible else inv_97_lift_plain
    lo_v = lift(ll, hl, w, -1)
    hi_v = lift(lh, hh, w, -1)
    return lift(lo_v, hi_v, h, -2)


def _level_steps(deltas, resno: int):
    """The (ll, hl, lh, hh) steps of the level that makes resolution
    `resno`: LL is quantized only at the coarsest level (resno 1)."""
    if deltas is None:
        return None
    return (deltas[(0, 0)] if resno == 1 else 0.0,
            deltas[(resno, 1)], deltas[(resno, 2)], deltas[(resno, 3)])


def forward_dwt_batch(x: torch.Tensor, numres: int, reversible: bool = True,
                      deltas: dict | None = None, fwd=fwd_level) -> dict:
    """numres - 1 forward levels on (..., H, W).  Returns
    {(resno, orient): tensor} in the host band layout; with `deltas`
    (9/7 only, numres >= 2) every band quantized by its step.  `fwd`
    computes one level (fwd_level's signature): parallel/mesh.py passes
    its row-sharded level here."""
    nl = numres - 1
    if deltas is not None and nl < 1:
        raise ValueError("no level to quantize in: with numres 1 the "
                         "quantizer runs in ops.mct.ict_forward_shift")
    bands = {}
    cur = x
    for lev in range(nl):
        resno = nl - lev
        cur, bands[(resno, 1)], bands[(resno, 2)], bands[(resno, 3)] = \
            fwd(cur, reversible, _level_steps(deltas, resno))
    bands[(0, 0)] = cur
    return bands


def inverse_dwt_batch(bands: dict, numres: int, shape: tuple[int, int],
                      reversible: bool = True,
                      deltas: dict | None = None,
                      inv=inv_level) -> torch.Tensor:
    """Multi-level inverse DWT back to (..., H, W); with `deltas` (9/7
    only, numres >= 2) the bands are doubled-domain int32, dequantized by
    their steps.  `inv` computes one level (inv_level's signature), as
    `fwd` of forward_dwt_batch."""
    if deltas is not None and numres < 2:
        raise ValueError("no level to dequantize in: with numres 1 the "
                         "dequantizer runs in ops.mct.ict_inverse_unshift")
    h, w = shape
    dims = [(h, w)]
    for _ in range(numres - 1):
        ph, pw = dims[-1]
        dims.append(((ph + 1) // 2, (pw + 1) // 2))
    cur = bands[(0, 0)]
    for resno in range(1, numres):
        lh_, lw_ = dims[numres - resno - 1]
        cur = inv(cur, bands[(resno, 1)], bands[(resno, 2)],
                  bands[(resno, 3)], lh_, lw_, reversible,
                  _level_steps(deltas, resno))
    return cur
