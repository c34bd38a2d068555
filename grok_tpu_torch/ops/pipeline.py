"""The device half of the tile processor: the port of grok_tpu/ops/pipeline.py,
reversible path only.

- analysis (encode front end): DC shift -> RCT -> multi-level 5/3 DWT;
- synthesis (decode back end): doubled-domain halving -> inverse 5/3 ->
  inverse RCT -> DC unshift and clip.

Both take batched (C, B, H, W) even-origin int32 tiles.  The RCT with its
DC shift and each DWT level run as CUDA kernels on CUDA tensors (ops/mct.py,
ops/dwt.py); the halving and the DC shift of components that skip the
RCT are plain PyTorch, as they are jnp outside Pallas in the reference.
"""

from __future__ import annotations

import torch

from . import dwt
from . import mct as dmct

_IRREVERSIBLE = ("the irreversible 9/7 path (ICT, quantization) is not "
                 "ported yet: ROADMAP A7")


def analysis(planes: torch.Tensor, *, numres: int, reversible: bool,
             mct: int, prec: int, sgnd: bool) -> dict:
    """Encode front end on a (C, B, H, W) int32 tile batch.  Returns
    {(resno, orient): (C, B, h, w) int32} coefficients."""
    if not reversible:
        raise NotImplementedError(_IRREVERSIBLE)
    planes = planes.contiguous()
    if mct == 1 and planes.shape[0] >= 3:
        x = dmct.rct_forward_shift(planes[0], planes[1], planes[2], prec,
                                   sgnd)
        if planes.shape[0] > 3:
            x = torch.cat([x, dmct.dc_shift(planes[3:], prec, sgnd)])
    else:
        x = dmct.dc_shift(planes, prec, sgnd)
    return dwt.forward_dwt_batch(x, numres)


def synthesis(bands: dict, *, numres: int, reversible: bool, mct: int,
              prec: int, sgnd: bool, shape: tuple[int, int]) -> torch.Tensor:
    """Decode back end: Tier-1 doubled-domain bands {(resno, orient):
    (C, B, h, w)} -> (C, B, H, W) int32 samples."""
    if not reversible:
        raise NotImplementedError(_IRREVERSIBLE)
    bands = {k: torch.sign(v) * (torch.abs(v) >> 1) for k, v in bands.items()}
    x = dwt.inverse_dwt_batch(bands, numres, shape)
    if mct == 1 and x.shape[0] >= 3:
        out = dmct.rct_inverse_unshift(x[0], x[1], x[2], prec, sgnd)
        if x.shape[0] > 3:
            out = torch.cat([out, dmct.dc_unshift(x[3:], prec, sgnd)])
        return out
    return dmct.dc_unshift(x, prec, sgnd)

