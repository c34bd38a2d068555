"""The device half of the tile processor: the port of grok_tpu/ops/pipeline.py.

- analysis (encode front end): DC shift -> RCT -> multi-level 5/3 DWT, or
  DC shift -> ICT -> multi-level 9/7 DWT -> per-band quantization;
- synthesis (decode back end): doubled-domain halving -> inverse 5/3 ->
  inverse RCT -> DC unshift and clip, or dequantization -> inverse 9/7 ->
  inverse ICT -> rounding -> DC unshift and clip.

Both take batched (C, B, H, W) even-origin int32 tiles.  On CUDA tensors
every float stage of the 9/7 path runs in a CUDA kernel: the ICT with the
DC shift (ops/mct.py), each DWT level with the quantizer fused into its
stores and the dequantizer into its loads (ops/dwt.py); with numres 1 the
ICT kernels quantize and dequantize themselves.  On the 5/3 path the RCT
with its DC shift and each DWT level run as CUDA kernels; the halving and
the DC shift of components that skip the RCT are plain PyTorch, as they
are jnp outside Pallas in the reference.

`dwt` swaps the transform stage (forward_dwt_batch's or
inverse_dwt_batch's signature) and keeps every other stage:
parallel/mesh.py passes its row-sharded DWT with halo exchange here, so
the sharded path runs this one pipeline.
"""

from __future__ import annotations

import torch

from . import dwt as ddwt
from . import mct as dmct

Deltas = tuple[tuple[int, int, float], ...]


def analysis(planes: torch.Tensor, *, numres: int, reversible: bool,
             mct: int, prec: int, sgnd: bool, deltas: Deltas = (),
             dwt=None) -> dict:
    """Encode front end on a (C, B, H, W) int32 tile batch.  `deltas`: the
    9/7 path's quantization step of every band, ((resno, orient, delta),
    ...).  Returns {(resno, orient): (C, B, h, w) int32} coefficients,
    quantized on the 9/7 path."""
    dwt = dwt or ddwt.forward_dwt_batch
    planes = planes.contiguous()
    if not reversible:
        dmap = {(r, o): d for r, o, d in deltas}
        kw = dict(mct=mct, prec=prec, sgnd=sgnd)
        if numres == 1:
            return {(0, 0): dmct.ict_forward_shift(planes, step=dmap[(0, 0)],
                                                   **kw)}
        return dwt(dmct.ict_forward_shift(planes, **kw), numres,
                   reversible=False, deltas=dmap)
    if mct == 1 and planes.shape[0] >= 3:
        x = dmct.rct_forward_shift(planes[0], planes[1], planes[2], prec,
                                   sgnd)
        if planes.shape[0] > 3:
            x = torch.cat([x, dmct.dc_shift(planes[3:], prec, sgnd)])
    else:
        x = dmct.dc_shift(planes, prec, sgnd)
    return dwt(x, numres)


def synthesis(bands: dict, *, numres: int, reversible: bool, mct: int,
              prec: int, sgnd: bool, shape: tuple[int, int],
              deltas: Deltas = (), dwt=None) -> torch.Tensor:
    """Decode back end: Tier-1 doubled-domain bands {(resno, orient):
    (C, B, h, w) int32} -> (C, B, H, W) int32 samples.  `deltas` and
    `dwt` as for analysis."""
    dwt = dwt or ddwt.inverse_dwt_batch
    if not reversible:
        dmap = {(r, o): d for r, o, d in deltas}
        kw = dict(mct=mct, prec=prec, sgnd=sgnd)
        if numres == 1:
            return dmct.ict_inverse_unshift(bands[(0, 0)].contiguous(),
                                            step=dmap[(0, 0)], **kw)
        x = dwt({k: v.contiguous() for k, v in bands.items()}, numres,
                shape, reversible=False, deltas=dmap)
        return dmct.ict_inverse_unshift(x, **kw)
    bands = {k: torch.sign(v) * (torch.abs(v) >> 1) for k, v in bands.items()}
    x = dwt(bands, numres, shape)
    if mct == 1 and x.shape[0] >= 3:
        out = dmct.rct_inverse_unshift(x[0], x[1], x[2], prec, sgnd)
        if x.shape[0] > 3:
            out = torch.cat([out, dmct.dc_unshift(x[3:], prec, sgnd)])
        return out
    return dmct.dc_unshift(x, prec, sgnd)
