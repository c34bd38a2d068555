"""Quantization: dead-zone scalar quantizer + step-size signaling.

Parity: Quantizer / TCCP step-size setup (SURVEY.md §2.1 "Quantization",
B.3):

- reversible path: shift-only, exponent eps_b = R_b + gain_b, M_b = guard +
  eps_b - 1
- irreversible: Delta_b = 2^(R_b - eps_b) * (1 + mu_b / 2^11);
  q = sign(c) * floor(|c| / Delta_b); decoder adds the half-bin midpoint
  (handled inside the T1 doubled-domain reconstruction)
- derived vs expounded signaling; guard bits
- band synthesis L2 norms are computed *numerically* from our own inverse
  DWT impulse responses (not hard-coded tables) — they weight both the
  default step sizes and the PCRD distortion estimates.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from ..params import StepSize
from ..tile.geometry import BAND_GAIN, HH, HL, LH, LL


# deepest decomposition computed by direct impulse synthesis; beyond it
# the per-level gain has converged and norms extrapolate geometrically
# (the impulse canvas is O(4^depth): depth 8 = 1024^2 floats, depth 12
# would be 4+ GB)
_NORM_DEPTH_CAP = 8


@functools.lru_cache(maxsize=None)
def _impulse_norm(numres: int, resno: int, orient: int,
                  reversible: bool) -> float:
    from ..tile.geometry import Rect, band_rect
    from .dwt import inverse_dwt

    n = 1 << (numres + 2)
    rect = Rect(0, 0, n, n)
    bands: dict[tuple[int, int], np.ndarray] = {}
    for r in range(numres):
        orients = [LL] if r == 0 else [HL, LH, HH]
        for o in orients:
            br = band_rect(rect, numres, r, o)
            bands[(r, o)] = np.zeros((br.h, br.w), dtype=np.float32)
    tgt = bands[(resno, orient)]
    # 5/3: scale the impulse so the int lifting is effectively linear
    amp = float(1 << 14) if reversible else 1.0
    tgt[tgt.shape[0] // 2, tgt.shape[1] // 2] = amp
    if reversible:
        bands = {k: v.astype(np.int32) for k, v in bands.items()}
    out = inverse_dwt(bands, rect, numres, reversible=reversible)
    return float(np.sqrt((out.astype(np.float64) ** 2).sum())) / amp


def _band_norm_reduced(numres: int, resno: int, orient: int,
                       reversible: bool) -> float:
    # depth-equivalent reduction: a band at resno >= 1 in an
    # numres-resolution decomposition synthesizes through numres - resno
    # levels, same as band (1, orient) with numres - resno + 1; depths
    # past _NORM_DEPTH_CAP extrapolate along the converged per-level gain
    if resno >= 1:
        eff, r_eff = numres - resno + 1, 1
    else:
        eff, r_eff = numres, 0
    if eff <= _NORM_DEPTH_CAP:
        return _impulse_norm(eff, r_eff, orient, reversible)
    base = _impulse_norm(_NORM_DEPTH_CAP, r_eff, orient, reversible)
    ratio = base / _impulse_norm(_NORM_DEPTH_CAP - 1, r_eff, orient,
                                 reversible)
    return base * ratio ** (eff - _NORM_DEPTH_CAP)


@functools.lru_cache(maxsize=None)
def band_norm(numres: int, resno: int, orient: int) -> float:
    """L2 norm of the synthesis basis function of band (resno, orient) in a
    `numres`-resolution irreversible decomposition, computed by pushing a
    unit impulse through our inverse 9/7 DWT.  The norm depends only on
    the band's synthesis depth, so deep decompositions reduce to an
    equivalent shallow impulse; depths past _NORM_DEPTH_CAP extrapolate
    along the converged per-level gain."""
    return _band_norm_reduced(numres, resno, orient, reversible=False)


@functools.lru_cache(maxsize=None)
def band_norm_53(numres: int, resno: int, orient: int) -> float:
    """Same for the reversible 5/3 path (linearized), used only for PCRD
    distortion weighting of lossless layered streams.  Depth-reduced and
    extrapolated like band_norm."""
    return _band_norm_reduced(numres, resno, orient, reversible=True)


def encode_stepsize(stepsize: float, numbps: int) -> StepSize:
    """Represent `stepsize` (in units of 2^-numbps of the nominal range...)
    as (expn, mant): Delta = 2^(numbps - expn) * (1 + mant/2048)."""
    if stepsize <= 0:
        return StepSize(0, 0)
    p = math.floor(math.log2(stepsize))
    mant = int(round((stepsize / (2.0 ** p) - 1.0) * 2048.0))
    if mant >= 2048:
        mant = 0
        p += 1
    expn = numbps - p
    if expn < 0:
        expn = 0
        mant = 2047
    if expn > 31:
        # below the representable range: the nearest signalable step is
        # (expn=31, mant=0); keeping the stale mantissa would coarsen by
        # up to 2x more than necessary
        expn = 31
        mant = 0
    return StepSize(expn, mant & 0x7FF)


def decode_stepsize(ss: StepSize, numbps: int) -> float:
    return (1.0 + ss.mant / 2048.0) * (2.0 ** (numbps - ss.expn))


def default_stepsizes(
    prec: int,
    numres: int,
    reversible: bool,
    base_step: float = 0.0,
) -> list[StepSize]:
    """Per-band (expn, mant) list in signaling order: LL, then (HL, LH, HH)
    per resolution 1..numres-1.

    Both paths use R_b = prec + gain_b.  Reversible: expn = prec + gain
    (verified against oracle QCD values, SURVEY.md Appendix A.1).
    Irreversible: stepsize_b = 1 / norm_b scaled by base_step — the
    image-domain-uniform default (Delta_b * norm_b == 1 for every band),
    matching the oracle encoder's signaled QCD exponents exactly, with
    mantissas within 0.5% of its truncated norm tables
    (tests/test_oracle_interop.py::test_default_qcd_matches_oracle).
    The earlier 2^gain/norm_b default double-counted the band gain
    (already inside R_b), quantizing HL/LH 2x and HH 4x coarser than the
    ecosystem default and costing 0.3-0.7 dB at matched rates."""
    out: list[StepSize] = []
    for resno in range(numres):
        orients = [LL] if resno == 0 else [HL, LH, HH]
        for o in orients:
            gain = BAND_GAIN[o]
            if reversible:
                if prec + gain > 31:
                    # the QCD/QCC exponent field is 5 bits: deep-precision
                    # reversible bands past it cannot be signaled at all
                    from ..errors import ParamError

                    raise ParamError(
                        f"reversible encoding of {prec}-bit components "
                        f"needs an unsignalable exponent {prec + gain} "
                        "(> 31); reduce precision or use irreversible")
                out.append(StepSize(prec + gain, 0))
            else:
                norm = band_norm(numres, resno, o)
                step = 1.0 / norm
                if base_step > 0:
                    step *= base_step
                out.append(encode_stepsize(step, prec + gain))
    return out


def band_max_bitplanes(ss: StepSize, guard_bits: int) -> int:
    """M_b = guard + eps_b - 1 (SURVEY.md B.3)."""
    return max(0, guard_bits + ss.expn - 1)


def quantize(coeffs: np.ndarray, delta: float) -> np.ndarray:
    """Dead-zone scalar quantization of float coefficients."""
    q = np.floor(np.abs(coeffs) / np.float32(delta)).astype(np.int64)
    return (np.sign(coeffs) * q).astype(np.int32)


def dequantize(doubled: np.ndarray, delta: float) -> np.ndarray:
    """Inverse quantization of T1 doubled-domain signed output: value =
    (doubled / 2) * Delta, which realizes the (q + 0.5) midpoint for fully
    decoded coefficients and truncation midpoints otherwise."""
    return doubled.astype(np.float32) * np.float32(0.5 * delta)
