"""grok_tpu_torch.ops.pipeline against grok_tpu.ops.pipeline.

analysis / synthesis on (C, B, H, W) int32 tile batches, with and without
the RCT, unsigned and signed; the port runs its plain twins on CPU
tensors.  Tolerance: 0 on the reversible path (integer throughout); the
9/7 path's tolerance against grok_tpu's jitted pipeline is given below.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from grok_tpu.ops import pipeline as dpipe  # noqa: E402
from grok_tpu_torch.ops import pipeline as tpipe  # noqa: E402


@pytest.mark.parametrize("c,mct", [(1, 0), (3, 0), (3, 1), (4, 1)])
@pytest.mark.parametrize("sgnd", [False, True])
def test_analysis_synthesis_match_reference(c, mct, sgnd, rng):
    prec = 10
    lo = -(1 << (prec - 1)) if sgnd else 0
    x = rng.integers(lo, lo + (1 << prec), size=(c, 2, 40, 24)).astype(
        np.int32)
    kw = dict(numres=4, reversible=True, mct=mct, prec=prec, sgnd=sgnd)
    ref = dpipe.analysis(jnp.asarray(x), **kw)
    ours = tpipe.analysis(torch.from_numpy(x), **kw)
    assert set(ours) == set(ref)
    for k in ref:
        assert np.array_equal(ours[k].numpy(), np.asarray(ref[k])), k
    # synthesis from doubled-domain bands with random low bits, as Tier-1
    # hands them over
    doubled = {k: 2 * np.asarray(v) + np.sign(np.asarray(v)) *
               rng.integers(0, 2, v.shape).astype(np.int32)
               for k, v in ref.items()}
    ref_back = dpipe.synthesis({k: jnp.asarray(v) for k, v in doubled.items()},
                               shape=(40, 24), **kw)
    back = tpipe.synthesis({k: torch.from_numpy(v) for k, v in doubled.items()},
                           shape=(40, 24), **kw)
    assert np.array_equal(back.numpy(), np.asarray(ref_back))
    assert np.array_equal(back.numpy(), x)


def test_analysis_synthesis_roundtrip(rng):
    """tests/test_device_ops.py test_analysis_synthesis_roundtrip, on the
    port."""
    x = rng.integers(0, 256, size=(3, 2, 32, 32)).astype(np.int32)
    bands = tpipe.analysis(torch.from_numpy(x), numres=3, reversible=True,
                           mct=1, prec=8, sgnd=False)
    doubled = {k: torch.sign(v) * (2 * torch.abs(v) + 1)
               for k, v in bands.items()}
    back = tpipe.synthesis(doubled, numres=3, reversible=True, mct=1,
                           prec=8, sgnd=False, shape=(32, 32))
    assert np.array_equal(back.numpy(), x)


def test_irreversible_matches_reference(rng):
    """The 9/7 path against grok_tpu's jitted pipeline: the same quantized
    bands but for 1 in a few, the same samples but for 1 in a few.  Under
    jax.jit XLA's CPU backend contracts some multiply-adds of the lifting
    into fused multiply-adds and multiplies by the reciprocal of each
    quantizer step; the port rounds each operation as grok_tpu writes it,
    which tests/test_torch_ict.py holds bit for bit."""
    x = rng.integers(0, 256, size=(3, 2, 64, 48)).astype(np.int32)
    deltas = tuple((r, o, float(rng.uniform(0.05, 4.0))) for r in range(4)
                   for o in ((0,) if r == 0 else (1, 2, 3)))
    kw = dict(numres=4, reversible=False, mct=1, prec=8, sgnd=False,
              deltas=deltas)
    ref = dpipe.analysis(jnp.asarray(x), **kw)
    ours = tpipe.analysis(torch.from_numpy(x), **kw)
    assert set(ours) == set(ref)
    diff = np.concatenate([(ours[k].numpy().astype(np.int64)
                            - np.asarray(ref[k])).ravel() for k in ref])
    assert np.abs(diff).max() <= 1 and np.count_nonzero(diff) <= 8
    doubled = {k: 2 * np.asarray(v) + np.sign(np.asarray(v))
               for k, v in ref.items()}
    back_ref = np.asarray(dpipe.synthesis(
        {k: jnp.asarray(v) for k, v in doubled.items()}, shape=(64, 48),
        **kw))
    back = tpipe.synthesis({k: torch.from_numpy(v) for k, v in
                            doubled.items()}, shape=(64, 48), **kw).numpy()
    assert np.abs(back - back_ref).max() <= 1
    assert np.count_nonzero(back - back_ref) <= 8
