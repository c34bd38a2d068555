"""Lifting along one axis, in plain PyTorch: reversible 5/3 and irreversible
9/7.

`fwd_53_lift_plain` / `inv_53_lift_plain` lift a (..., H, W) int32 tensor
along its rows (axis=-2, what grok_tpu/ops/pallas_dwt.py fwd_53_vertical /
inv_53_vertical compute) or along its columns (axis=-1, the horizontal
pass), with the int32 semantics of grok_tpu/ops/dwt.py fwd_53_axis /
inv_53_axis: wrap on overflow, whole-sample symmetric mirroring at the
edges, any length including odd and 1.

`fwd_97_lift_plain` / `inv_97_lift_plain` do the same for float32 tensors
with the four lifting steps and the scaling of grok_tpu/ops/dwt.py
fwd_97_axis / inv_97_axis, step for step: each product and sum is a torch
op of its own, so each is rounded to float32 as XLA rounds it (no fused
multiply-add), and every constant is grok_tpu's float64 value rounded to
float32.  A length of 1 is scaled by 1/K forward and by K inverse.

They are the building blocks of ops/dwt.py's level twins, which the level
kernels are held against.
"""

from __future__ import annotations

import numpy as np
import torch

from ..transform.dwt import ALPHA, BETA, DELTA, GAMMA, K


def f32(v: float) -> float:
    """v rounded to float32 (grok_tpu's jnp.float32(v)), as a Python float:
    a product with a float32 tensor is then one float32 multiply."""
    return float(np.float32(v))


F32_ALPHA, F32_BETA, F32_GAMMA, F32_DELTA, F32_K, F32_INV_K = (
    f32(c) for c in (ALPHA, BETA, GAMMA, DELTA, K, 1.0 / K))


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
    return _interleave(ev, od, n)


def _fwd97_last(x: torch.Tensor):
    """Forward 9/7 along the last axis (grok_tpu/ops/dwt.py fwd_97_axis)."""
    n = x.shape[-1]
    if n == 1:
        return x * F32_INV_K, x[..., :0]
    ne, no = (n + 1) // 2, n // 2
    ev, od = x[..., 0::2], x[..., 1::2]
    od = od + F32_ALPHA * (ev[..., :no] + _ev_right(ev, ne, no))
    d_l, d_r = _d_pair(od, ne, no)
    ev = ev + F32_BETA * (d_l + d_r)
    od = od + F32_GAMMA * (ev[..., :no] + _ev_right(ev, ne, no))
    d_l, d_r = _d_pair(od, ne, no)
    ev = ev + F32_DELTA * (d_l + d_r)
    return ev * F32_INV_K, od * F32_K


def _inv97_last(s: torch.Tensor, d: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse 9/7 along the last axis (grok_tpu/ops/dwt.py inv_97_axis)."""
    if n == 1:
        return s * F32_K
    ne, no = (n + 1) // 2, n // 2
    ev = s * F32_K
    od = d * F32_INV_K
    d_l, d_r = _d_pair(od, ne, no)
    ev = ev - F32_DELTA * (d_l + d_r)
    od = od - F32_GAMMA * (ev[..., :no] + _ev_right(ev, ne, no))
    d_l, d_r = _d_pair(od, ne, no)
    ev = ev - F32_BETA * (d_l + d_r)
    od = od - F32_ALPHA * (ev[..., :no] + _ev_right(ev, ne, no))
    return _interleave(ev, od, n)


def _interleave(ev, od, n):
    out = torch.empty(ev.shape[:-1] + (n,), dtype=ev.dtype, device=ev.device)
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


def _fwd(last, x: torch.Tensor, axis: int):
    _check_axis(x, axis)
    if axis == -2:
        lo, hi = last(x.transpose(-1, -2))
        lo, hi = lo.transpose(-1, -2), hi.transpose(-1, -2)
    else:
        lo, hi = last(x)
    return lo.contiguous(), hi.contiguous()


def _inv(last, lo: torch.Tensor, hi: torch.Tensor, n: int,
         axis: int) -> torch.Tensor:
    _check_axis(lo, axis)
    if axis == -2:
        out = last(lo.transpose(-1, -2), hi.transpose(-1, -2), n)
        return out.transpose(-1, -2).contiguous()
    return last(lo, hi, n).contiguous()


def fwd_53_lift_plain(x: torch.Tensor, axis: int):
    """Forward reversible 5/3 along `axis`: returns (lo, hi), with
    ceil(n/2) and floor(n/2) samples along it."""
    return _fwd(_fwd_last, x, axis)


def inv_53_lift_plain(lo: torch.Tensor, hi: torch.Tensor, n: int,
                      axis: int) -> torch.Tensor:
    """Inverse of fwd_53_lift_plain: the (lo, hi) halves back to `n`
    samples along `axis`."""
    return _inv(_inv_last, lo, hi, n, axis)


def fwd_97_lift_plain(x: torch.Tensor, axis: int):
    """Forward irreversible 9/7 of a float32 tensor along `axis`: returns
    (lo, hi), with ceil(n/2) and floor(n/2) samples along it."""
    return _fwd(_fwd97_last, x, axis)


def inv_97_lift_plain(lo: torch.Tensor, hi: torch.Tensor, n: int,
                      axis: int) -> torch.Tensor:
    """Inverse of fwd_97_lift_plain: the (lo, hi) halves back to `n`
    samples along `axis`."""
    return _inv(_inv97_last, lo, hi, n, axis)
