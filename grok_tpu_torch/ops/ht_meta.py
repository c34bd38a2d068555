"""Per-quad HT cleanup metadata: the port of grok_tpu/ops/ht_meta.py.

The HT cleanup pass splits into per-quad metadata (significance pattern
rho, quad exponent bound umax, MagSgn payload bits), which is data-parallel
arithmetic, and the serial stream emission.  `quad_metadata` computes the
first part for a batch of codeblocks in plain PyTorch; the HT encoder's twin
(ops/ht_encode.py) builds on it, and csrc/ht_encode.cu computes the same
values per quad in registers.
"""

from __future__ import annotations

import torch


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap (the int32 arithmetic of
    numpy and XLA), independent of how a cast treats overflow."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bits of each value read as an unsigned 32-bit word (`32 - clz`):
    0 for 0, 32 for a negative int32.  int64 result."""
    u = x.to(torch.int64) & 0xFFFFFFFF
    # frexp is exact for integers below 2^53: u = mant * 2^e, mant in [.5, 1)
    return torch.frexp(u.to(torch.float64)).exponent.to(torch.int64)


def quad_samples(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) with H, W even -> (..., H/2, W/2, 4), each quad's samples
    in the coder's order TL, BL, TR, BR."""
    *lead, h, w = x.shape
    q = x.reshape(*lead, h // 2, 2, w // 2, 2)
    return torch.stack([q[..., :, 0, :, 0], q[..., :, 1, :, 0],
                        q[..., :, 0, :, 1], q[..., :, 1, :, 1]], dim=-1)


def quad_metadata(coeffs: torch.Tensor):
    """Per-quad HT cleanup metadata for a batch of codeblocks.

    coeffs: (..., H, W) int32 with H, W even.  Returns (rho, umax, nbits),
    each (..., H/2, W/2) int32, with grok_tpu's int32 semantics (the
    magnitude of INT32_MIN stays INT32_MIN: not significant, 32 bits):
      rho   — 4-bit significance pattern, sample order TL, BL, TR, BR
      umax  — largest magnitude bit length in the quad
      nbits — MagSgn payload bits of the quad, popcount(rho) * (umax + 1)
    """
    if coeffs.dtype != torch.int32:
        raise TypeError(f"expected int32 coefficients, got {coeffs.dtype}")
    if coeffs.dim() < 2 or coeffs.shape[-2] % 2 or coeffs.shape[-1] % 2:
        raise ValueError(f"expected (..., H, W) with H, W even, got "
                         f"{tuple(coeffs.shape)}")
    mags = wrap_int32(coeffs.to(torch.int64).abs())
    q = quad_samples(mags)
    sig = (q > 0).to(torch.int64)
    rho = sig[..., 0] | (sig[..., 1] << 1) | (sig[..., 2] << 2) \
        | (sig[..., 3] << 3)
    umax = bit_length(q).amax(dim=-1)
    nbits = sig.sum(dim=-1) * (umax + 1)
    return (rho.to(torch.int32), umax.to(torch.int32),
            wrap_int32(nbits))
