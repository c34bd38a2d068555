"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`: these skip where torch finds no CUDA device.  Run them on a
machine with an NVIDIA Hopper GPU and nvcc with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest`: tests/conftest.py imports jax, which such a machine may
not have.)  Every kernel must equal its twin bit for bit (tolerance 0:
integer arithmetic, int32 wrap included) and count its launches.
"""

import pytest
import torch

from grok_tpu_torch.kernels import LAUNCHES, reset_launches
from grok_tpu_torch.ops import dwt, mct, pipeline

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(12345)


def _rand(gen, shape, lo, hi):
    return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                         dtype=torch.int64).to(torch.int32)


@pytest.mark.parametrize("shape", [(3, 1, 135, 240), (2, 37, 257),
                                   (2, 1, 9), (1, 2, 1), (3, 64, 67),
                                   (2, 9, 1), (1, 1, 1), (3, 2, 512, 512)])
def test_lifting_kernels_match_twins(gen, shape):
    """The level kernels, full-range int32 in, against their twins."""
    reset_launches()
    x = _rand(gen, shape, -(2 ** 31), 2 ** 31)
    bands = dwt.fwd_level(x)
    for b, ref in zip(bands, dwt.fwd_level_plain(x)):
        assert torch.equal(b, ref)
    h, w = shape[-2:]
    back = dwt.inv_level(*bands, h, w)
    assert torch.equal(back, dwt.inv_level_plain(*bands, h, w))
    assert torch.equal(back, x)
    # the inverse from arbitrary bands, so its sums overflow
    arb = [_rand(gen, b.shape, -(2 ** 31), 2 ** 31) for b in bands]
    assert torch.equal(dwt.inv_level(*arb, h, w),
                       dwt.inv_level_plain(*arb, h, w))
    assert LAUNCHES["fwd53_level"] == 1 and LAUNCHES["inv53_level"] == 2


@pytest.mark.parametrize("h", [1, 2, 3, 37, 135, 257])
@pytest.mark.parametrize("w", [1, 2, 3, 37, 135, 257])
def test_level_kernels_odd_and_short(gen, h, w):
    x = _rand(gen, (2, h, w), -5000, 5000)
    bands = dwt.fwd_level(x)
    for b, ref in zip(bands, dwt.fwd_level_plain(x)):
        assert torch.equal(b, ref), (h, w)
    assert torch.equal(dwt.inv_level(*bands, h, w), x)


@pytest.mark.parametrize("prec", [8, 12, 16])
@pytest.mark.parametrize("sgnd", [False, True])
def test_rct_kernels_match_twins(gen, prec, sgnd):
    reset_launches()
    lo = -(1 << (prec - 1)) if sgnd else 0
    rgb = [_rand(gen, (37, 53), lo, lo + (1 << prec)) for _ in range(3)]
    out = mct.rct_forward_shift(*rgb, prec, sgnd)
    assert torch.equal(out, mct.rct_forward_shift_plain(*rgb, prec, sgnd))
    ycc = [_rand(gen, (37, 53), -(1 << (prec + 1)), 1 << (prec + 1))
           for _ in range(3)]
    back = mct.rct_inverse_unshift(*ycc, prec, sgnd)
    assert torch.equal(back, mct.rct_inverse_unshift_plain(*ycc, prec, sgnd))
    assert LAUNCHES["rct_forward_shift"] == 1
    assert LAUNCHES["rct_inverse_unshift"] == 1


def test_pipeline_on_card_matches_cpu(gen):
    x = _rand(gen, (3, 2, 64, 48), 0, 256)
    kw = dict(numres=4, reversible=True, mct=1, prec=8, sgnd=False)
    bands = pipeline.analysis(x, **kw)
    ref = pipeline.analysis(x.cpu(), **kw)
    for k in ref:
        assert torch.equal(bands[k].cpu(), ref[k]), k
    back = pipeline.synthesis({k: 2 * v for k, v in bands.items()},
                              shape=(64, 48), **kw)
    assert torch.equal(back, x)
