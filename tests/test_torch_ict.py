"""grok_tpu_torch's ICT, quantizer and lossy pipeline against grok_tpu.

The port's plain twins (what its wrappers run on CPU tensors, and what the
ICT and 9/7 level kernels are held against on the card) are held bit for
bit to grok_tpu's arithmetic as written: its jnp functions run op by op
(jax.disable_jit), its host numpy colour transforms, and its
pipeline.analysis_impl / synthesis_impl run op by op with grok_tpu's host
numpy DWT as the transform stage (the `dwt` argument those functions take),
which tests/test_torch_dwt97.py holds bit for bit to the jnp lifting.
Under jax.jit XLA's CPU backend contracts some multiply-adds into fused
multiply-adds and turns the quantizer's division by a constant step into a
multiply by its reciprocal, so grok_tpu's jitted pipeline differs in the
last bits: against it the twins are held to 1 in a few quantized
coefficients and decoded samples.  Float32 to int32 conversions saturate
and send NaN to 0, as XLA's do.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from grok_tpu.ops import mct as dmct  # noqa: E402
from grok_tpu.ops import pipeline as dpipe  # noqa: E402
from grok_tpu.tile.geometry import Rect  # noqa: E402
from grok_tpu.transform import dwt as hdwt  # noqa: E402
from grok_tpu.transform import mct as hmct  # noqa: E402
from grok_tpu_torch.ops import mct as tmct  # noqa: E402
from grok_tpu_torch.ops import pipeline as tpipe  # noqa: E402

EXTREMES = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 2.5, 3.5, -2.5,
                     -0.5, 0.5, 2147483520.0, -2147483648.0, 1e-40, -1e-40,
                     255.5, 127.49999], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(ours: torch.Tensor, ref) -> bool:
    ref = np.asarray(ref)
    ours = ours.numpy()
    if ours.dtype != ref.dtype or ours.shape != ref.shape:
        return False
    if ref.dtype == np.float32:
        ours, ref = ours.view(np.int32), ref.view(np.int32)
    return np.array_equal(ours, ref)


def test_ict_matches_reference(rng):
    """Forward and inverse ICT, bit for bit against grok_tpu's jnp
    functions op by op and its host numpy ones."""
    rgb = [rng.normal(0, 100, (9, 31)).astype(np.float32) for _ in range(3)]
    ours = tmct.ict_forward(*map(_t, rgb))
    with jax.disable_jit():
        ref = dmct.ict_forward(*map(jnp.asarray, rgb))
        back_ref = dmct.ict_inverse(*map(jnp.asarray, rgb))
    for o, r, h in zip(ours, ref, hmct.ict_forward(*rgb)):
        assert _same(o, r) and _same(o, h)
    for o, r, h in zip(tmct.ict_inverse(*map(_t, rgb)), back_ref,
                       hmct.ict_inverse(*rgb)):
        assert _same(o, r) and _same(o, h)


def test_quantize_and_dequantize_match_reference(rng):
    """quantize divides by float32(delta), bit for bit op by op; jitted,
    XLA multiplies by the reciprocal, which moves a few coefficients by 1;
    dequantize is bit for bit both ways.  Huge, infinite and NaN
    coefficients saturate or go to 0 as XLA converts them."""
    x = rng.normal(0, 2000, 4000).astype(np.float32)
    n = len(EXTREMES)
    with np.errstate(over="ignore"):
        x[:n] = EXTREMES * np.float32(1e30)
    x[n:2 * n] = EXTREMES
    for delta in (0.013, 0.37, 1.2204981129824657, 7.5):
        ours = tmct.quantize_plain(_t(x), delta)
        with jax.disable_jit():
            ref = dmct.quantize(jnp.asarray(x), delta)
        assert _same(ours, ref), delta
        jit = np.asarray(jax.jit(lambda v: dmct.quantize(v, delta))(
            jnp.asarray(x)))
        # (at the extremes one float32 ulp of the quotient exceeds 1)
        assert np.abs(ours.numpy()[2 * n:].astype(np.int64)
                      - jit[2 * n:]).max() <= 1
        d = rng.integers(-(1 << 20), 1 << 20, 500).astype(np.int32)
        d[:2] = (2 ** 31 - 1, -(2 ** 31))
        deq = tmct.dequantize_plain(_t(d), delta)
        assert _same(deq, jax.jit(lambda v: dmct.dequantize(v, delta))(
            jnp.asarray(d)))


def test_int32_conversion_saturates_like_xla():
    """round then convert: XLA saturates (3e9 to INT32_MAX) and sends NaN
    to 0, where a plain .to(torch.int32) gives INT32_MIN for both; the
    unshift after it wraps as int32 and clips."""
    x = np.resize(EXTREMES, (2, 40))
    with jax.disable_jit():
        ref = jnp.round(jnp.asarray(x)).astype(jnp.int32)
        unshift = dmct.dc_unshift(ref, 8, False)
    ours = tmct.to_int32(torch.round(_t(x)))
    assert _same(ours, ref)
    assert np.asarray(ref)[0, 3] == 2 ** 31 - 1 and np.asarray(ref)[0, 0] == 0
    assert _same(tmct.dc_unshift(ours, 8, False), unshift)


def _host_dwt(x, numres, reversible):
    """grok_tpu's host numpy DWT of every (c, b) plane, in the shape of
    grok_tpu/ops/dwt.py forward_dwt_batch."""
    x = np.asarray(x)
    c, b, h, w = x.shape
    per = [[hdwt.forward_dwt(x[i, j], Rect(0, 0, w, h), numres, reversible)
            for j in range(b)] for i in range(c)]
    return {k: jnp.asarray(np.stack([np.stack([p[k] for p in row])
                                     for row in per])) for k in per[0][0]}


def _host_idwt(bands, numres, reversible, shape):
    """The inverse of _host_dwt (grok_tpu/ops/dwt.py inverse_dwt_batch)."""
    bands = {k: np.asarray(v) for k, v in bands.items()}
    c, b = next(iter(bands.values())).shape[:2]
    h, w = shape
    return jnp.asarray(np.stack([np.stack([hdwt.inverse_dwt(
        {k: v[i, j] for k, v in bands.items()}, Rect(0, 0, w, h), numres,
        reversible) for j in range(b)]) for i in range(c)]))


def _deltas(numres, rng):
    return tuple((r, o, float(rng.uniform(0.05, 4.0))) for r in range(numres)
                 for o in ((0,) if r == 0 else (1, 2, 3)))


def _doubled(bands, rng):
    """Doubled-domain bands with random low bits, as Tier-1 hands them
    over."""
    return {k: (2 * np.asarray(v) + np.sign(np.asarray(v))
                * rng.integers(0, 2, np.shape(v))).astype(np.int32)
            for k, v in bands.items()}


@pytest.mark.parametrize("c,mct,prec,sgnd,numres", [
    (3, 1, 8, False, 3), (4, 1, 12, True, 3), (3, 0, 16, False, 3),
    (4, 1, 16, True, 1), (3, 0, 8, True, 1), (3, 1, 12, False, 3)])
def test_lossy_analysis_synthesis_match_reference(c, mct, prec, sgnd, numres,
                                                  rng):
    """The 9/7 pipeline both ways, bit for bit against grok_tpu's
    analysis_impl / synthesis_impl op by op (host DWT stage); with mct 1
    and a fourth component that skips the ICT; numres 1 quantizes in the
    ICT itself."""
    lo = -(1 << (prec - 1)) if sgnd else 0
    x = rng.integers(lo, lo + (1 << prec), size=(c, 2, 24, 20)).astype(
        np.int32)
    kw = dict(numres=numres, reversible=False, mct=mct, prec=prec,
              sgnd=sgnd, deltas=_deltas(numres, rng))
    with jax.disable_jit():
        ref = dpipe.analysis_impl(jnp.asarray(x), dwt=_host_dwt, **kw)
    ours = tpipe.analysis(_t(x), **kw)
    assert set(ours) == set(ref)
    for k in ref:
        assert _same(ours[k], ref[k]), k
    dbl = _doubled(ref, rng)
    with jax.disable_jit():
        back_ref = dpipe.synthesis_impl(
            {k: jnp.asarray(v) for k, v in dbl.items()}, shape=(24, 20),
            dwt=_host_idwt, **kw)
    back = tpipe.synthesis({k: _t(v) for k, v in dbl.items()},
                           shape=(24, 20), **kw)
    assert _same(back, back_ref)


def test_lossy_pipeline_roundtrip_close_to_input(rng):
    """tests/test_device_ops.py test_analysis_synthesis_roundtrip for the
    9/7 path: fine steps bring the samples back within 1."""
    x = rng.integers(0, 256, size=(3, 1, 32, 40)).astype(np.int32)
    kw = dict(numres=3, reversible=False, mct=1, prec=8, sgnd=False,
              deltas=tuple((r, o, 1.0 / 64) for r in range(3)
                           for o in ((0,) if r == 0 else (1, 2, 3))))
    bands = tpipe.analysis(_t(x), **kw)
    back = tpipe.synthesis({k: 2 * v + torch.sign(v)
                            for k, v in bands.items()}, shape=(32, 40), **kw)
    assert np.abs(back.numpy() - x).max() <= 1
