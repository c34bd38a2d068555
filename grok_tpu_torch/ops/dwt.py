"""Multi-level reversible 5/3 DWT on batched tiles: the port of the 5/3 half of
grok_tpu/ops/dwt.py.

Operates on even-origin (..., H, W) int32 tiles and keeps the reference's
band layout {(resno, orient): array}.  Each level lifts vertically, then
horizontally (the host/oracle order).  On a CUDA tensor a level is one
launch of csrc/dwt53_level.cu, both passes in shared memory; on a CPU
tensor it runs the plain twins below, built from ops/lifting.py.  Odd H
and W and length 1 go through the kernel as well.
"""

from __future__ import annotations

import math

import torch

from ..kernels import launch, on_card
from .lifting import fwd_53_lift_plain, inv_53_lift_plain


def _band_shapes(lead, h: int, w: int):
    """Shapes of (ll, hl, lh, hh) of one level of an (..., h, w) tile."""
    eh, oh, ew, ow = (h + 1) // 2, h // 2, (w + 1) // 2, w // 2
    return [(*lead, eh, ew), (*lead, eh, ow), (*lead, oh, ew), (*lead, oh, ow)]


def fwd_level(x: torch.Tensor):
    """One forward level on (..., H, W).  Returns (ll, hl, lh, hh)."""
    if x.dim() < 2:
        raise ValueError(f"expected a (..., H, W) tensor, got {x.shape}")
    if not on_card(x):
        return fwd_level_plain(x)
    *lead, h, w = x.shape
    bands = [torch.empty(s, dtype=torch.int32, device=x.device)
             for s in _band_shapes(lead, h, w)]
    if x.numel():
        launch("fwd53_level", "grk_fwd53_level", x.device, (x, *bands),
               (h, w, math.prod(lead)))
    return tuple(bands)


def inv_level(ll, hl, lh, hh, h: int, w: int) -> torch.Tensor:
    """One inverse level producing (..., h, w)."""
    lead = ll.shape[:-2]
    want = _band_shapes(lead, h, w)
    if [tuple(b.shape) for b in (ll, hl, lh, hh)] != want:
        raise ValueError(f"bands {[tuple(b.shape) for b in (ll, hl, lh, hh)]}"
                         f" do not make a ({h}, {w}) level")
    if not on_card(ll, hl, lh, hh):
        return inv_level_plain(ll, hl, lh, hh, h, w)
    out = torch.empty((*lead, h, w), dtype=torch.int32, device=ll.device)
    if out.numel():
        launch("inv53_level", "grk_inv53_level", ll.device,
               (ll, hl, lh, hh, out), (h, w, math.prod(lead)))
    return out


def fwd_level_plain(x: torch.Tensor):
    """Plain PyTorch twin of fwd_level."""
    lo_v, hi_v = fwd_53_lift_plain(x, -2)
    ll, hl = fwd_53_lift_plain(lo_v, -1)
    lh, hh = fwd_53_lift_plain(hi_v, -1)
    return ll, hl, lh, hh


def inv_level_plain(ll, hl, lh, hh, h: int, w: int) -> torch.Tensor:
    """Plain PyTorch twin of inv_level."""
    lo_v = inv_53_lift_plain(ll, hl, w, -1)
    hi_v = inv_53_lift_plain(lh, hh, w, -1)
    return inv_53_lift_plain(lo_v, hi_v, h, -2)


def forward_dwt_batch(x: torch.Tensor, numres: int) -> dict:
    """numres - 1 forward levels on (..., H, W).  Returns
    {(resno, orient): tensor} in the host band layout."""
    bands = {}
    nl = numres - 1
    cur = x
    for lev in range(nl):
        resno = nl - lev
        cur, bands[(resno, 1)], bands[(resno, 2)], bands[(resno, 3)] = \
            fwd_level(cur)
    bands[(0, 0)] = cur
    return bands


def inverse_dwt_batch(bands: dict, numres: int,
                      shape: tuple[int, int]) -> torch.Tensor:
    """Multi-level inverse DWT back to (..., H, W)."""
    h, w = shape
    dims = [(h, w)]
    for _ in range(numres - 1):
        ph, pw = dims[-1]
        dims.append(((ph + 1) // 2, (pw + 1) // 2))
    cur = bands[(0, 0)]
    for resno in range(1, numres):
        lh_, lw_ = dims[numres - resno - 1]
        cur = inv_level(cur, bands[(resno, 1)], bands[(resno, 2)],
                        bands[(resno, 3)], lh_, lw_)
    return cur
