"""Reversible 5/3 lifting along one axis, in plain PyTorch.

`fwd_53_lift_plain` / `inv_53_lift_plain` lift a (..., H, W) int32 tensor
along its rows (axis=-2, what grok_tpu/ops/pallas_dwt.py fwd_53_vertical /
inv_53_vertical compute) or along its columns (axis=-1, the horizontal
pass), with the int32 semantics of grok_tpu/ops/dwt.py fwd_53_axis /
inv_53_axis: wrap on overflow, whole-sample symmetric mirroring at the
edges, any length including odd and 1.  They are the building blocks of
ops/dwt.py's level twins, which the level kernel is held against.
"""

from __future__ import annotations

import torch


def _check_axis(x: torch.Tensor, axis: int) -> None:
    if axis not in (-2, -1):
        raise ValueError(f"axis must be -2 (vertical) or -1, got {axis}")
    if x.dim() < 2:
        raise ValueError(f"expected a (..., H, W) tensor, got {x.shape}")


def _fwd_last(x: torch.Tensor):
    """Forward 5/3 along the last axis (grok_tpu/ops/dwt.py fwd_53_axis)."""
    n = x.shape[-1]
    if n == 1:
        return x, x[..., :0]
    ne, no = (n + 1) // 2, n // 2
    ev, od = x[..., 0::2], x[..., 1::2]
    d = od - ((ev[..., :no] + _ev_right(ev, ne, no)) >> 1)
    d_l, d_r = _d_pair(d, ne, no)
    return ev + ((d_l + d_r + 2) >> 2), d


def _inv_last(s: torch.Tensor, d: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse 5/3 along the last axis (grok_tpu/ops/dwt.py inv_53_axis)."""
    if n == 1:
        return s
    ne, no = (n + 1) // 2, n // 2
    d_l, d_r = _d_pair(d, ne, no)
    ev = s - ((d_l + d_r + 2) >> 2)
    od = d + ((ev[..., :no] + _ev_right(ev, ne, no)) >> 1)
    out = torch.empty(s.shape[:-1] + (n,), dtype=s.dtype, device=s.device)
    out[..., 0::2] = ev
    out[..., 1::2] = od
    return out


def _ev_right(ev, ne, no):
    """ev[i+1] for i < no; x[n] mirrors to x[n-2] = ev[-1] when n is even."""
    if ne > no:
        return ev[..., 1:]
    return torch.cat([ev[..., 1:], ev[..., -1:]], dim=-1)


def _d_pair(d, ne, no):
    """(d[i-1], d[i]) for i < ne, with d[-1] = d[0] and, when n is odd,
    d[ne-1] = d[no-1]."""
    d_l = torch.cat([d[..., :1], d], dim=-1)[..., :ne]
    d_r = d if no >= ne else torch.cat([d, d[..., -1:]], dim=-1)
    return d_l, d_r


def fwd_53_lift_plain(x: torch.Tensor, axis: int):
    """Forward reversible 5/3 along `axis`: returns (lo, hi), with
    ceil(n/2) and floor(n/2) samples along it."""
    _check_axis(x, axis)
    if axis == -2:
        lo, hi = _fwd_last(x.transpose(-1, -2))
        lo, hi = lo.transpose(-1, -2), hi.transpose(-1, -2)
    else:
        lo, hi = _fwd_last(x)
    return lo.contiguous(), hi.contiguous()


def inv_53_lift_plain(lo: torch.Tensor, hi: torch.Tensor, n: int,
                      axis: int) -> torch.Tensor:
    """Inverse of fwd_53_lift_plain: the (lo, hi) halves back to `n`
    samples along `axis`."""
    _check_axis(lo, axis)
    if axis == -2:
        out = _inv_last(lo.transpose(-1, -2), hi.transpose(-1, -2), n)
        return out.transpose(-1, -2).contiguous()
    return _inv_last(lo, hi, n).contiguous()
