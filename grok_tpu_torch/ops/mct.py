"""DC shift, colour transforms and quantization: the port of
grok_tpu/ops/mct.py.

`dc_shift` / `dc_unshift`, `rct_forward` / `rct_inverse`, `ict_forward` /
`ict_inverse`, `quantize_plain` / `dequantize_plain` are plain PyTorch with
the reference's semantics (int32 wrap; float32 rounding of every product
and sum; the saturating float-to-int32 conversion of XLA).

Two pairs of wrappers fuse a stage's elementwise work into one pass, and
run a CUDA kernel on CUDA tensors and their plain twin on CPU tensors:
- `rct_forward_shift` / `rct_inverse_unshift`: the DC shift with the RCT
  over three int32 planes (csrc/rct.cu, the port of the TPU kernels
  rct_forward_pallas / rct_inverse_pallas);
- `ict_forward_shift` / `ict_inverse_unshift`: the DC shift, the cast to
  float32 and the ICT of a (C, ...) stack on encode; the inverse ICT, the
  rounding, the conversion to int32 and the DC unshift and clip on decode
  (csrc/ict.cu).  With `step` they also quantize the stores or dequantize
  the loads, for the 9/7 path without a DWT level (numres 1).
The custom Part-2 MCT is not ported: its tiles take the host path.
"""

from __future__ import annotations

import torch

from ..kernels import launch, on_card
from ..transform.mct import ICT_FWD, ICT_INV
from .lifting import f32

INT32_MIN, INT32_MAX = -(2 ** 31), 2 ** 31 - 1
# grok_tpu's jnp.asarray(ICT_*, dtype=jnp.float32), as float32-exact floats
ICT_FWD_F32 = [[f32(v) for v in row] for row in ICT_FWD]
ICT_INV_F32 = [[f32(v) for v in row] for row in ICT_INV]


def dc_shift(x: torch.Tensor, prec: int, sgnd: bool) -> torch.Tensor:
    if sgnd:
        return x
    return x - (1 << (prec - 1))


def dc_unshift(x: torch.Tensor, prec: int, sgnd: bool) -> torch.Tensor:
    if sgnd:
        return torch.clamp(x, -(1 << (prec - 1)), (1 << (prec - 1)) - 1)
    return torch.clamp(x + (1 << (prec - 1)), 0, (1 << prec) - 1)


def rct_forward(r, g, b):
    y = (r + 2 * g + b) >> 2
    return y, b - g, r - g


def rct_inverse(y, cb, cr):
    g = y - ((cb + cr) >> 2)
    return cr + g, g, cb + g


def _check(planes: tuple[torch.Tensor, ...], prec: int) -> None:
    if not 1 <= prec <= 31:
        raise ValueError(f"precision {prec} outside 1..31")
    if len({p.shape for p in planes}) != 1:
        raise ValueError("the three planes differ in shape")


def rct_forward_shift(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                      prec: int, sgnd: bool) -> torch.Tensor:
    """DC shift then forward RCT of three int32 planes of one shape;
    returns (Y, Cb, Cr) stacked along a new first axis."""
    _check((r, g, b), prec)
    if not on_card(r, g, b):
        return rct_forward_shift_plain(r, g, b, prec, sgnd)
    out = torch.empty((3,) + r.shape, dtype=torch.int32, device=r.device)
    if r.numel():
        launch("rct_forward_shift", "grk_rct_fwd", r.device,
               (r, g, b, out[0], out[1], out[2]),
               (r.numel(), 0 if sgnd else 1 << (prec - 1)))
    return out


def rct_inverse_unshift(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                        prec: int, sgnd: bool) -> torch.Tensor:
    """Inverse RCT then DC unshift and clip of three int32 planes of one
    shape; returns (R, G, B) stacked along a new first axis."""
    _check((y, cb, cr), prec)
    if not on_card(y, cb, cr):
        return rct_inverse_unshift_plain(y, cb, cr, prec, sgnd)
    out = torch.empty((3,) + y.shape, dtype=torch.int32, device=y.device)
    if y.numel():
        launch("rct_inverse_unshift", "grk_rct_inv", y.device,
               (y, cb, cr, out[0], out[1], out[2]),
               (y.numel(), prec, int(sgnd)))
    return out


def rct_forward_shift_plain(r, g, b, prec: int, sgnd: bool) -> torch.Tensor:
    """Plain PyTorch twin of rct_forward_shift."""
    return torch.stack(rct_forward(dc_shift(r, prec, sgnd),
                                   dc_shift(g, prec, sgnd),
                                   dc_shift(b, prec, sgnd)))


def rct_inverse_unshift_plain(y, cb, cr, prec: int,
                              sgnd: bool) -> torch.Tensor:
    """Plain PyTorch twin of rct_inverse_unshift."""
    return torch.stack([dc_unshift(v, prec, sgnd)
                        for v in rct_inverse(y, cb, cr)])


def ict_forward(r, g, b):
    """grok_tpu/ops/mct.py ict_forward on float32 planes: each output the
    left-to-right sum (m0 r + m1 g) + m2 b."""
    m = ICT_FWD_F32
    y = m[0][0] * r + m[0][1] * g + m[0][2] * b
    cb = m[1][0] * r + m[1][1] * g + m[1][2] * b
    cr = m[2][0] * r + m[2][1] * g + m[2][2] * b
    return y, cb, cr


def ict_inverse(y, cb, cr):
    """grok_tpu/ops/mct.py ict_inverse: the four nonzero off-diagonal
    terms only."""
    m = ICT_INV_F32
    r = y + m[0][2] * cr
    g = y + m[1][1] * cb + m[1][2] * cr
    b = y + m[2][1] * cb
    return r, g, b


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """float32 to int32 as XLA converts: toward zero, saturating at the
    int32 range, NaN to 0 (a plain .to(torch.int32) gives INT32_MIN for
    NaN and out-of-range values on the CPU)."""
    big = x >= 2.0 ** 31
    small = x < -(2.0 ** 31)
    out = torch.where(big | small | torch.isnan(x), 0.0, x).to(torch.int32)
    out = torch.where(big, INT32_MAX, out)
    return torch.where(small, INT32_MIN, out)


def quantize_plain(coeffs: torch.Tensor, delta: float) -> torch.Tensor:
    """grok_tpu/ops/mct.py quantize: sign(c) * floor(|c| / float32(delta))
    as int32, the division elementwise by a tensor of the step (a division
    by a scalar may become a multiply by its reciprocal)."""
    step = torch.full_like(coeffs, f32(delta))
    q = to_int32(torch.floor(torch.abs(coeffs) / step))
    return torch.where(coeffs < 0, -q, q)


def dequantize_plain(doubled: torch.Tensor, delta: float) -> torch.Tensor:
    """grok_tpu/ops/mct.py dequantize: the doubled-domain int32 Tier-1
    output times float32(0.5 * delta)."""
    return doubled.to(torch.float32) * f32(0.5 * delta)


def _check_stack(x: torch.Tensor, dtype: torch.dtype, prec: int) -> None:
    if not 1 <= prec <= 31:
        raise ValueError(f"precision {prec} outside 1..31")
    if x.dim() < 1:
        raise ValueError("expected a (C, ...) component stack")
    if x.dtype != dtype:
        raise TypeError(f"expected a {dtype} stack, got {x.dtype}")


def ict_forward_shift(planes: torch.Tensor, *, mct: int, prec: int,
                      sgnd: bool, step: float = 0.0) -> torch.Tensor:
    """DC shift, cast to float32 and, with mct 1 and three components or
    more, the forward ICT of components 0-2, on a (C, ...) int32 stack;
    returns the float32 stack, or with `step` > 0 the stack quantized by it
    (int32)."""
    _check_stack(planes, torch.int32, prec)
    if not on_card(planes):
        return ict_forward_shift_plain(planes, mct=mct, prec=prec, sgnd=sgnd,
                                       step=step)
    out = torch.empty(planes.shape, device=planes.device,
                      dtype=torch.int32 if step > 0 else torch.float32)
    if planes.numel():
        m = [v for row in ICT_FWD_F32 for v in row]
        launch("ict_forward_shift", "grk_ict_fwd", planes.device,
               (planes, out),
               (planes.shape[0], planes[0].numel(),
                0 if sgnd else 1 << (prec - 1), int(_ict(mct, planes))),
               (*m, f32(step)))
    return out


def ict_inverse_unshift(x: torch.Tensor, *, mct: int, prec: int, sgnd: bool,
                        step: float = 0.0) -> torch.Tensor:
    """On a (C, ...) float32 stack (with `step` > 0: a doubled-domain int32
    stack, dequantized by it first): the inverse ICT of components 0-2 with
    mct 1 and three components or more, rounding half to even, the
    saturating conversion to int32, the DC unshift and the clip; returns
    the int32 samples."""
    _check_stack(x, torch.int32 if step > 0 else torch.float32, prec)
    if not on_card(x, dtype=None):
        return ict_inverse_unshift_plain(x, mct=mct, prec=prec, sgnd=sgnd,
                                         step=step)
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if x.numel():
        m = ICT_INV_F32
        launch("ict_inverse_unshift", "grk_ict_inv", x.device, (x, out),
               (x.shape[0], x[0].numel(), prec, int(sgnd), int(_ict(mct, x))),
               (m[0][2], m[1][1], m[1][2], m[2][1],
                f32(0.5 * step) if step > 0 else 0.0))
    return out


def _ict(mct: int, x: torch.Tensor) -> bool:
    return mct == 1 and x.shape[0] >= 3


def ict_forward_shift_plain(planes, *, mct: int, prec: int, sgnd: bool,
                            step: float = 0.0) -> torch.Tensor:
    """Plain PyTorch twin of ict_forward_shift."""
    x = dc_shift(planes, prec, sgnd).to(torch.float32)
    if _ict(mct, x):
        x = torch.cat([torch.stack(ict_forward(x[0], x[1], x[2])), x[3:]])
    return quantize_plain(x, step) if step > 0 else x


def ict_inverse_unshift_plain(x, *, mct: int, prec: int, sgnd: bool,
                              step: float = 0.0) -> torch.Tensor:
    """Plain PyTorch twin of ict_inverse_unshift."""
    if step > 0:
        x = dequantize_plain(x, step)
    if _ict(mct, x):
        x = torch.cat([torch.stack(ict_inverse(x[0], x[1], x[2])), x[3:]])
    return dc_unshift(to_int32(torch.round(x)), prec, sgnd)
