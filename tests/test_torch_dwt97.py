"""grok_tpu_torch's 9/7 lifting and multi-level DWT against grok_tpu.

The same numpy-seeded float32 inputs go through grok_tpu and through the
port's plain PyTorch twins, which the port's wrappers run on CPU tensors and
which the 9/7 level kernel is held against on the card.  Tolerance 0 against
grok_tpu's arithmetic as written: its jnp lifting run op by op
(jax.disable_jit) and its host numpy DWT, bit for bit.  Under jax.jit,
XLA's CPU backend fuses the lifting and contracts some multiply-adds into
fused multiply-adds, choosing them by fusion and shape, so grok_tpu's jitted
results differ from the written arithmetic in the last bits: against them
the twins are held to a few float32 ulps of the band's magnitude.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from grok_tpu.ops import dwt as ddwt  # noqa: E402
from grok_tpu.tile.geometry import Rect  # noqa: E402
from grok_tpu.transform import dwt as hdwt  # noqa: E402
from grok_tpu_torch.ops import dwt as tdwt  # noqa: E402
from grok_tpu_torch.ops.lifting import (fwd_97_lift_plain,  # noqa: E402
                                        inv_97_lift_plain)

SIZES = (1, 2, 3, 5, 8, 37, 64)


def _bits(a) -> np.ndarray:
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    assert a.dtype == np.float32
    return a.view(np.int32)


def _close(ours: torch.Tensor, ref) -> None:
    """Within 64 float32 ulps of the largest magnitude: the room XLA's
    contracted multiply-adds take over a few lifting steps."""
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max(initial=0.0)), 1.0)
    err = np.abs(ours.numpy() - ref).max(initial=0.0)
    assert err <= 64 * scale * 2.0 ** -23


def _swap(a):
    return np.swapaxes(np.asarray(a), -1, -2)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("axis", [-2, -1])
def test_axis_matches_reference(n, axis, rng):
    """fwd_97_axis / inv_97_axis on both axes, bit for bit op by op."""
    shape = (2, n, 7) if axis == -2 else (2, 7, n)
    x = rng.normal(0, 300, shape).astype(np.float32)
    xa = jnp.asarray(_swap(x) if axis == -2 else x)
    with jax.disable_jit():
        rlo, rhi = ddwt.fwd_97_axis(xa)
    if axis == -2:
        rlo, rhi = _swap(rlo), _swap(rhi)
    lo, hi = fwd_97_lift_plain(torch.from_numpy(x), axis)
    assert np.array_equal(_bits(lo), _bits(rlo))
    assert np.array_equal(_bits(hi), _bits(rhi))
    # the inverse from arbitrary halves
    a = rng.normal(0, 300, lo.shape).astype(np.float32)
    b = rng.normal(0, 300, hi.shape).astype(np.float32)
    args = ((_swap(a), _swap(b)) if axis == -2 else (a, b))
    with jax.disable_jit():
        ref = ddwt.inv_97_axis(*map(jnp.asarray, args), n)
    if axis == -2:
        ref = _swap(ref)
    back = inv_97_lift_plain(torch.from_numpy(a), torch.from_numpy(b), n,
                             axis)
    assert np.array_equal(_bits(back), _bits(ref))


@pytest.mark.parametrize("h", SIZES)
def test_level_matches_host(h, rng):
    """One level, every width of SIZES at this height, against grok_tpu's
    host numpy DWT bit for bit, both ways."""
    for w in SIZES:
        x = rng.normal(0, 300, (h, w)).astype(np.float32)
        ref = hdwt.forward_dwt(x, Rect(0, 0, w, h), 2, False)
        bands = tdwt.fwd_level_plain(torch.from_numpy(x), False)
        for key, b in zip(((0, 0), (1, 1), (1, 2), (1, 3)), bands):
            assert np.array_equal(_bits(b), _bits(ref[key])), (h, w, key)
        back = hdwt.inverse_dwt(ref, Rect(0, 0, w, h), 2, False)
        assert np.array_equal(
            _bits(tdwt.inv_level_plain(*bands, h, w, False)), _bits(back))


@pytest.mark.parametrize("h,w", [(37, 64), (64, 37), (5, 8)])
def test_level_matches_jitted(h, w, rng):
    x = rng.normal(0, 300, (2, h, w)).astype(np.float32)
    ref = jax.jit(lambda v: ddwt.fwd_level(v, False))(jnp.asarray(x))
    bands = tdwt.fwd_level(torch.from_numpy(x), False)
    for b, r in zip(bands, ref):
        _close(b, r)
    back = jax.jit(lambda *v: ddwt.inv_level(*v, h, w, False))(
        *(jnp.asarray(b.numpy()) for b in bands))
    _close(tdwt.inv_level(*bands, h, w, False), back)


@pytest.mark.parametrize("numres", [1, 2, 3, 4, 5, 6])
def test_dwt_batch_matches_reference(numres, rng):
    """forward_dwt_batch / inverse_dwt_batch: bit for bit against the host
    numpy DWT of each plane, close to grok_tpu's jitted batch."""
    h, w = 67, 45
    x = rng.normal(0, 300, (2, 1, h, w)).astype(np.float32)
    bands = tdwt.forward_dwt_batch(torch.from_numpy(x), numres, False)
    jref = jax.jit(lambda v: ddwt.forward_dwt_batch(v, numres, False))(
        jnp.asarray(x))
    assert set(bands) == set(jref)
    for c in range(2):
        ref = hdwt.forward_dwt(x[c, 0], Rect(0, 0, w, h), numres, False)
        for k in ref:
            assert np.array_equal(_bits(bands[k][c, 0]), _bits(ref[k])), k
        back = hdwt.inverse_dwt(ref, Rect(0, 0, w, h), numres, False)
        ours = tdwt.inverse_dwt_batch(bands, numres, (h, w), False)
        assert np.array_equal(_bits(ours[c, 0]), _bits(back))
    for k in jref:
        _close(bands[k], jref[k])


def test_levels_quantize_with_steps(rng):
    """Steps quantize the high bands of every level and LL at the coarsest
    (grok_tpu/ops/pipeline.py analysis_impl quantizes every band), as
    grok_tpu's host quantizer does, and the inverse dequantizes
    doubled-domain bands on load as its host dequantizer does."""
    from grok_tpu.transform import quant as hquant

    x = rng.normal(0, 300, (1, 40, 36)).astype(np.float32)
    deltas = {(r, o): 0.3 + 0.1 * r + 0.05 * o for r in range(4)
              for o in ((0,) if r == 0 else (1, 2, 3))}
    q = tdwt.forward_dwt_batch(torch.from_numpy(x), 4, False, deltas)
    f = tdwt.forward_dwt_batch(torch.from_numpy(x), 4, False)
    for k, v in f.items():
        assert q[k].dtype == torch.int32
        assert np.array_equal(q[k].numpy(),
                              hquant.quantize(v.numpy(), deltas[k])), k
    dbl = {k: 2 * v + torch.sign(v) for k, v in q.items()}
    deq = {k: torch.from_numpy(hquant.dequantize(v.numpy(), deltas[k]))
           for k, v in dbl.items()}
    assert np.array_equal(
        _bits(tdwt.inverse_dwt_batch(dbl, 4, (40, 36), False, deltas)),
        _bits(tdwt.inverse_dwt_batch(deq, 4, (40, 36), False)))
    with pytest.raises(ValueError, match="numres 1"):
        tdwt.forward_dwt_batch(torch.from_numpy(x), 1, False, deltas)
    with pytest.raises(ValueError, match="not quantized"):
        tdwt.fwd_level(torch.zeros((4, 4), dtype=torch.int32), True,
                       (1.0,) * 4)
