"""grok_tpu_torch's 5/3 lifting and multi-level DWT against grok_tpu, bit-exact.

The same numpy-seeded int32 inputs go through the JAX reference (the
Pallas kernels in interpret mode, the jnp lifting, the host numpy oracle)
and through the port's plain PyTorch twins, which is what the port's
wrappers run on CPU tensors and what the level kernel is held against on
the card.  Tolerance: 0, every stage is integer.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from grok_tpu.ops import dwt as ddwt  # noqa: E402
from grok_tpu.ops.pallas_dwt import fwd_53_vertical, inv_53_vertical  # noqa: E402
from grok_tpu.tile.geometry import Rect  # noqa: E402
from grok_tpu.transform import dwt as hdwt  # noqa: E402
from grok_tpu_torch.ops import dwt as tdwt  # noqa: E402
from grok_tpu_torch.ops.lifting import (fwd_53_lift_plain,  # noqa: E402
                                        inv_53_lift_plain)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _extreme(rng, shape):
    """Full-range int32 salted with the extremes, so lifting sums wrap."""
    a = rng.integers(-(2 ** 31), 2 ** 31, size=shape,
                     dtype=np.int64).astype(np.int32)
    flat = a.reshape(-1)
    flat[::3] = 2 ** 31 - 1
    flat[1::3] = -(2 ** 31)
    return a


@pytest.mark.parametrize("h,w", [(64, 256), (128, 128), (2, 128), (256, 384)])
def test_vertical_lift_matches_pallas(h, w, rng):
    x = rng.integers(-5000, 5000, (h, w)).astype(np.int32)
    lo, hi = fwd_53_vertical(jnp.asarray(x), interpret=True)
    tlo, thi = fwd_53_lift_plain(_t(x), -2)
    assert np.array_equal(tlo.numpy(), np.asarray(lo))
    assert np.array_equal(thi.numpy(), np.asarray(hi))
    back = inv_53_vertical(lo, hi, h, interpret=True)
    tback = inv_53_lift_plain(tlo, thi, h, -2)
    assert np.array_equal(tback.numpy(), np.asarray(back))
    assert np.array_equal(tback.numpy(), x)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 37, 64])
@pytest.mark.parametrize("axis", [-2, -1])
def test_lift_matches_jnp_axis(n, axis, rng):
    """Odd and short lengths, both axes, against ops/dwt fwd/inv_53_axis
    (the path the Pallas wrappers send odd heights to)."""
    shape = (2, n, 7) if axis == -2 else (2, 7, n)
    x = rng.integers(-5000, 5000, shape).astype(np.int32)
    xa = jnp.asarray(np.swapaxes(x, -1, -2) if axis == -2 else x)
    rlo, rhi = ddwt.fwd_53_axis(xa)
    if axis == -2:
        rlo, rhi = np.swapaxes(rlo, -1, -2), np.swapaxes(rhi, -1, -2)
    lo, hi = fwd_53_lift_plain(_t(x), axis)
    assert np.array_equal(lo.numpy(), np.asarray(rlo))
    assert np.array_equal(hi.numpy(), np.asarray(rhi))
    # inverse from arbitrary halves, against inv_53_axis
    a = rng.integers(-5000, 5000, lo.shape).astype(np.int32)
    b = rng.integers(-5000, 5000, hi.shape).astype(np.int32)
    if axis == -2:
        ref = np.swapaxes(np.asarray(ddwt.inv_53_axis(
            jnp.asarray(np.swapaxes(a, -1, -2)),
            jnp.asarray(np.swapaxes(b, -1, -2)), n)), -1, -2)
    else:
        ref = np.asarray(ddwt.inv_53_axis(jnp.asarray(a), jnp.asarray(b), n))
    assert np.array_equal(inv_53_lift_plain(_t(a), _t(b), n, axis).numpy(),
                          ref)
    assert np.array_equal(inv_53_lift_plain(lo, hi, n, axis).numpy(), x)


@pytest.mark.parametrize("h,w", [(64, 64), (37, 53), (2, 2), (5, 8)])
def test_dwt_batch_matches_reference(h, w, rng):
    """Multi-level forward/inverse against grok_tpu.ops.dwt and the host
    oracle transform/dwt.forward_dwt."""
    x = rng.integers(-2000, 2000, size=(h, w)).astype(np.int32)
    host = hdwt.forward_dwt(x, Rect(0, 0, w, h), 3, True)
    dev = ddwt.forward_dwt_batch(jnp.asarray(x), 3, True)
    ours = tdwt.forward_dwt_batch(_t(x), 3)
    assert set(ours) == set(host)
    for k in host:
        assert np.array_equal(ours[k].numpy(), host[k]), (h, w, k)
        assert np.array_equal(ours[k].numpy(), np.asarray(dev[k])), (h, w, k)
    back = tdwt.inverse_dwt_batch({k: _t(v) for k, v in host.items()}, 3,
                                  (h, w))
    assert np.array_equal(back.numpy(), x)


def test_dwt_batch_leading_dims(rng):
    """(C, B, H, W) batches lift plane by plane."""
    x = rng.integers(-2000, 2000, size=(3, 2, 36, 20)).astype(np.int32)
    dev = ddwt.forward_dwt_batch(jnp.asarray(x), 4, True)
    ours = tdwt.forward_dwt_batch(_t(x), 4)
    for k in dev:
        assert np.array_equal(ours[k].numpy(), np.asarray(dev[k])), k
    back = tdwt.inverse_dwt_batch(ours, 4, (36, 20))
    assert np.array_equal(back.numpy(), x)


@pytest.mark.parametrize("h,w", [(64, 64), (37, 53), (2, 2), (1, 9), (8, 1),
                                 (6, 6)])
def test_lift_wraps_like_int32(h, w, rng):
    """int32 extremes: the port wraps exactly like numpy/JAX int32 (the
    inverse level against the host oracle _merge_2d, as
    tests/test_dwt.py pins the native inverse; the forward against the
    jnp lifting)."""
    from grok_tpu.transform.dwt import _merge_2d

    eh, ew, oh, ow = (h + 1) // 2, (w + 1) // 2, h // 2, w // 2
    ll, hl = _extreme(rng, (eh, ew)), _extreme(rng, (eh, ow))
    lh, hh = _extreme(rng, (oh, ew)), _extreme(rng, (oh, ow))
    with np.errstate(over="ignore"):
        ref = _merge_2d(ll, hl, lh, hh, Rect(0, 0, w, h), True)
    back = tdwt.inv_level(_t(ll), _t(hl), _t(lh), _t(hh), h, w)
    assert np.array_equal(back.numpy(), ref), (h, w)
    x = _extreme(rng, (h, w))
    ref_f = ddwt.fwd_level(jnp.asarray(x), True)
    for ours, theirs in zip(tdwt.fwd_level(_t(x)), ref_f):
        assert np.array_equal(ours.numpy(), np.asarray(theirs)), (h, w)


_LEVEL_SIZES = (1, 2, 3, 4, 37, 64, 135)
# one XLA compilation a shape instead of one a jnp operation
_ref_fwd_level = jax.jit(ddwt.fwd_level, static_argnums=1)
_ref_inv_level = jax.jit(ddwt.inv_level, static_argnums=(4, 5, 6))


@pytest.mark.parametrize("w", _LEVEL_SIZES)
@pytest.mark.parametrize("h", _LEVEL_SIZES)
def test_level_plain_matches_reference(h, w, rng):
    """fwd_level_plain / inv_level_plain, the twins the level kernel is
    held against, against grok_tpu.ops.dwt fwd_level / inv_level: odd,
    even and length-1 shapes, ordinary samples and int32 extremes."""
    for x in (rng.integers(-5000, 5000, (2, h, w)).astype(np.int32),
              _extreme(rng, (2, h, w))):
        ref = _ref_fwd_level(jnp.asarray(x), True)
        ours = tdwt.fwd_level_plain(_t(x))
        for o, r in zip(ours, ref):
            assert np.array_equal(o.numpy(), np.asarray(r)), (h, w)
        # the inverse from arbitrary bands, so its sums overflow too
        bands = [_extreme(rng, o.shape) for o in ours]
        ref_back = _ref_inv_level(*map(jnp.asarray, bands), h, w, True)
        back = tdwt.inv_level_plain(*map(_t, bands), h, w)
        assert np.array_equal(back.numpy(), np.asarray(ref_back)), (h, w)
        assert np.array_equal(tdwt.inv_level_plain(*ours, h, w).numpy(), x)
