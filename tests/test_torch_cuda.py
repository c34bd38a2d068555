"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`: these skip where torch finds no CUDA device.  Run them on a
machine with an NVIDIA Hopper GPU and nvcc with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest`: tests/conftest.py imports jax, which such a machine may
not have.)  Every kernel must equal its twin bit for bit (tolerance 0:
integer arithmetic, int32 wrap included; the HT coders byte for byte) and
count its launches; the 9/7 and ICT kernels equal their twins bit for
bit too, float outputs compared by their bits.
"""

import numpy as np
import pytest
import torch

import torch_ht_cases as cases
import torch_mq_cases as mq_cases
from grok_tpu_torch.kernels import LAUNCHES, reset_launches
from grok_tpu_torch.ops import (dwt, ht_decode, ht_encode, mct, mq_decode,
                                mq_encode, pipeline)
from grok_tpu_torch.t1 import ht_tables

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


# ------------------------------------------------- 9/7 levels and the ICT

STEPS = (0.37, 0.61, 0.59, 1.13)


def _bits(t):
    """A tensor's bits on the CPU: float32 as int32, so that NaN, -0.0 and
    every last bit count."""
    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _normal(gen, shape, scale):
    return torch.randn(shape, generator=gen, device="cuda") * scale


@pytest.mark.parametrize("shape", [(3, 1, 1024, 1024), (3, 1, 128, 128),
                                   (2, 37, 257), (2, 1, 9), (2, 9, 1),
                                   (1, 1, 1), (3, 130, 250),
                                   (4, 1030, 1028), (4, 1030, 1029),
                                   (4, 1030, 1030), (4, 1030, 1031)])
def test_97_level_kernels_match_twins(gen, shape):
    """The 9/7 level kernels, with and without steps, against their twins
    bit for bit; the inverse from quantized (doubled) and float bands.
    (4, 1030, w): widths of each residue mod 4 (the 16-byte and 4-byte
    variants) on planes cut into segments of two chunks, the last
    ragged."""
    reset_launches()
    x = _normal(gen, shape, 600.0)
    h, w = shape[-2:]
    for steps in (None, STEPS):
        bands = dwt.fwd_level(x, False, steps)
        for b, ref in zip(bands, dwt.fwd_level_plain(x.cpu(), False, steps)):
            assert torch.equal(_bits(b), _bits(ref))
        back = dwt.inv_level(*bands, h, w, False, steps)
        ref = dwt.inv_level_plain(*(b.cpu() for b in bands), h, w, False,
                                  steps)
        assert torch.equal(_bits(back), _bits(ref))
    assert LAUNCHES["fwd97_level"] == 2 and LAUNCHES["inv97_level"] == 2


def _misaligned(t):
    """A contiguous copy of t that starts 4 bytes past an allocation."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return out[1:].view(t.shape).copy_(t)


def test_97_level_kernels_misaligned(gen):
    """Tensors 4 bytes off their allocation, width 0 mod 4: the launchers
    take the 4-byte variant."""
    x = _misaligned(_normal(gen, (2, 130, 252), 300.0))
    assert x.data_ptr() % 16
    bands = dwt.fwd_level(x, False, STEPS)
    for b, ref in zip(bands, dwt.fwd_level_plain(x.cpu(), False, STEPS)):
        assert torch.equal(b.cpu(), ref)
    dbl = [_misaligned(2 * b + torch.sign(b)) for b in bands]
    assert torch.equal(
        _bits(dwt.inv_level(*dbl, 130, 252, False, STEPS)),
        _bits(dwt.inv_level_plain(*(b.cpu() for b in dbl), 130, 252, False,
                                  STEPS)))


@pytest.mark.parametrize("h", [1, 2, 3, 5, 37, 135])
@pytest.mark.parametrize("w", [1, 2, 3, 5, 37, 257])
def test_97_level_kernels_odd_and_short(gen, h, w):
    x = _normal(gen, (2, h, w), 300.0)
    bands = dwt.fwd_level(x, False, STEPS)
    want = dwt.fwd_level_plain(x.cpu(), False, STEPS)
    for b, ref in zip(bands, want):
        assert torch.equal(b.cpu(), ref), (h, w)
    dbl = [2 * b + torch.sign(b) for b in bands]
    assert torch.equal(
        _bits(dwt.inv_level(*dbl, h, w, False, STEPS)),
        _bits(dwt.inv_level_plain(*(b.cpu() for b in dbl), h, w, False,
                                  STEPS)))


@pytest.mark.parametrize("prec,sgnd", [(8, False), (12, True), (16, False),
                                       (16, True)])
@pytest.mark.parametrize("c,mct_", [(1, 0), (3, 0), (3, 1), (4, 1)])
def test_ict_kernels_match_twins(gen, prec, sgnd, c, mct_):
    reset_launches()
    lo = -(1 << (prec - 1)) if sgnd else 0
    x = _rand(gen, (c, 2, 37, 53), lo, lo + (1 << prec))
    kw = dict(mct=mct_, prec=prec, sgnd=sgnd)
    for step in (0.0, 0.73):
        assert torch.equal(
            _bits(mct.ict_forward_shift(x, step=step, **kw)),
            _bits(mct.ict_forward_shift_plain(x.cpu(), step=step, **kw)))
    y = _normal(gen, x.shape, float(1 << prec))
    assert torch.equal(mct.ict_inverse_unshift(y, **kw).cpu(),
                       mct.ict_inverse_unshift_plain(y.cpu(), **kw))
    q = _rand(gen, x.shape, -(1 << prec), 1 << prec)
    assert torch.equal(mct.ict_inverse_unshift(q, step=0.73, **kw).cpu(),
                       mct.ict_inverse_unshift_plain(q.cpu(), step=0.73,
                                                     **kw))
    assert LAUNCHES["ict_forward_shift"] == 2
    assert LAUNCHES["ict_inverse_unshift"] == 2


def test_ict_inverse_and_quantizer_extremes(gen):
    """NaN, infinities, huge values and ties convert as the twins (and
    XLA) convert them: saturating, NaN to 0, ties to even."""
    vals = torch.tensor([float("nan"), float("inf"), -float("inf"), 3e9,
                         -3e9, 2.5, 3.5, -2.5, -0.5, 0.5, 2147483520.0,
                         -2147483648.0, 1e-40, -1e-40, 255.5, 127.49999])
    x = vals.repeat(4, 1, 4, 1).contiguous()
    for prec, sgnd in ((8, False), (8, True), (16, False), (31, True)):
        for mct_ in (0, 1):
            kw = dict(mct=mct_, prec=prec, sgnd=sgnd)
            assert torch.equal(mct.ict_inverse_unshift(x.cuda(), **kw).cpu(),
                               mct.ict_inverse_unshift_plain(x, **kw))
    big = vals.reshape(1, 4, 4) * 1e30
    for b, ref in zip(dwt.fwd_level(big.cuda(), False, STEPS),
                      dwt.fwd_level_plain(big, False, STEPS)):
        assert torch.equal(b.cpu(), ref)


@pytest.mark.parametrize("numres,c,mct_", [(5, 3, 1), (3, 4, 1), (1, 3, 1),
                                           (2, 1, 0)])
def test_lossy_pipeline_on_card_matches_cpu(gen, numres, c, mct_):
    x = _rand(gen, (c, 2, 96, 80), 0, 256)
    deltas = tuple((r, o, 0.25 * (1 + r + o)) for r in range(numres)
                   for o in ((0,) if r == 0 else (1, 2, 3)))
    kw = dict(numres=numres, reversible=False, mct=mct_, prec=8,
              sgnd=False, deltas=deltas)
    bands = pipeline.analysis(x, **kw)
    ref = pipeline.analysis(x.cpu(), **kw)
    for k in ref:
        assert torch.equal(bands[k].cpu(), ref[k]), k
    dbl = {k: 2 * v + torch.sign(v) for k, v in bands.items()}
    back = pipeline.synthesis(dbl, shape=(96, 80), **kw)
    assert torch.equal(back.cpu(), pipeline.synthesis(
        {k: v.cpu() for k, v in dbl.items()}, shape=(96, 80), **kw))


# ------------------------------------------------------------ HT Tier-1

def _ht_segments(rng, shapes, n=3):
    """Segments of random blocks coded by the twin, as (data, h, w)."""
    items = []
    for h, w in shapes:
        bl = torch.from_numpy(cases.blocks(rng, h, w, n=n, mag=1 << 15))
        segs, _ = ht_encode.encode_cblks_ht_plain(list(bl))
        items += [(s, h, w) for s, _ in segs]
    return items


def _decode_both(items):
    """The kernel's and the twin's decode of `items`."""
    got = ht_decode.decode_cblks_ht(items, "cuda")
    ref = ht_decode.decode_cblks_ht_plain(items, "cpu")
    return [g.cpu() for g in got], ref


@pytest.mark.parametrize("shape", cases.ENC_SHAPES)
def test_ht_encode_kernel_matches_twin(gen, shape):
    """Byte-identical segments, numbps and sums of squares, at densities
    0.05-0.95 and magnitudes up to 2^25 - 1."""
    rng = np.random.default_rng(100 * shape[0] + shape[1])
    bl = torch.from_numpy(cases.blocks(rng, *shape, n=8))
    reset_launches()
    got = ht_encode.encode_cblks_ht(list(bl.cuda()))
    assert got == ht_encode.encode_cblks_ht_plain(list(bl))
    assert LAUNCHES["ht_encode"] == 1


def test_ht_encode_kernel_views_mixed_and_dense(gen):
    """Blocks read in place from a band tensor (mixed shapes, one launch),
    all-zero blocks and the 0xFF-dense stuffing case."""
    rng = np.random.default_rng(3)
    band = torch.from_numpy(rng.integers(-3000, 3000, (134, 200)).astype(
        np.int32))
    band[70:, 100:] = 0
    views = [band[y:y + 64, x:x + 64] for y in (0, 64) for x in (0, 64, 128)]
    views += [band[128:134, x:x + 8] for x in (0, 8, 192)]
    views += list(torch.from_numpy(cases.dense_ff()))
    dev = band.cuda()
    dviews = [dev[y:y + 64, x:x + 64] for y in (0, 64) for x in (0, 64, 128)]
    dviews += [dev[128:134, x:x + 8] for x in (0, 8, 192)]
    dviews += list(torch.from_numpy(cases.dense_ff()).cuda())
    reset_launches()
    assert ht_encode.encode_cblks_ht(dviews) == \
        ht_encode.encode_cblks_ht_plain(views)
    assert LAUNCHES["ht_encode"] == 1


def test_ht_kernels_on_1000_blocks(gen):
    """A 64x64 batch of 1,000 blocks, both directions, one launch each."""
    rng = np.random.default_rng(4)
    bl = torch.from_numpy(cases.blocks(rng, 64, 64, n=1000, mag=1 << 12))
    reset_launches()
    got = ht_encode.encode_cblks_ht(list(bl.cuda()))
    segs, sumsq = ht_encode.encode_cblks_ht_plain(list(bl))
    assert got == (segs, sumsq)
    items = [(s, 64, 64) for s, _ in segs]
    out, ref = _decode_both(items)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    assert LAUNCHES["ht_encode"] == 1 and LAUNCHES["ht_decode"] == 1
    assert LAUNCHES["ht_destuff"] == 1 and LAUNCHES["ht_magsgn"] == 1


def test_ht_decode_kernel_matches_twin(gen):
    """Mixed shapes in one launch, valid, corrupt and truncated streams,
    written into views of a band tensor."""
    rng = np.random.default_rng(5)
    items = _ht_segments(rng, cases.DEC_SHAPES)
    items += cases.corrupt(rng, items[:6])
    out, ref = _decode_both(items)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    # into views of one device band, in place, the rest untouched
    band = torch.full((64, 96), 7, dtype=torch.int32, device="cuda")
    dests = [band[0:32, 0:32], band[32:64, 0:12], band[0:10, 40:72]]
    reset_launches()
    ht_decode.decode_cblks_ht(items[:1] + items[4:5] + items[6:7], "cuda",
                              dests)
    assert LAUNCHES["ht_decode"] == 1 and LAUNCHES["ht_destuff"] == 1
    assert LAUNCHES["ht_magsgn"] == 1
    assert torch.equal(band[0:32, 0:32].cpu(), ref[0])
    assert torch.equal(band[32:64, 0:12].cpu(), ref[4])
    assert torch.equal(band[0:10, 40:72].cpu(), ref[6])
    assert int((band[:, 72:] != 7).sum()) == 0


@pytest.mark.parametrize("swap", ["fixed", "variable", "context"])
def test_ht_kernels_take_swapped_tables(gen, swap):
    """set_tables reaches the card's copy of the tables: both kernels equal
    their twins under each table set, and the segments round-trip."""
    rng = np.random.default_rng(6)
    bl = torch.from_numpy(cases.blocks(rng, 16, 16, n=6, mag=900))
    try:
        ht_tables.set_tables(*cases.table_swaps()[swap])
        got = ht_encode.encode_cblks_ht(list(bl.cuda()))
        segs, sumsq = ht_encode.encode_cblks_ht_plain(list(bl))
        assert got == (segs, sumsq)
        items = [(s, 16, 16) for s, _ in segs]
        items += cases.corrupt(rng, items[:2], n=6)
        out, ref = _decode_both(items)
        for o, r in zip(out, ref):
            assert torch.equal(o, r)
        for b, o in zip(bl, out):
            exp = torch.where(b != 0, torch.sign(b) * (2 * b.abs() + 1), 0)
            assert torch.equal(o, exp.to(torch.int32))
    finally:
        ht_tables.reset_tables()


def test_ht_encode_kernel_refuses_out_of_range(gen):
    """numbps above 25, INT32_MIN included, raises on both routes."""
    for v in (1 << 25, -(2 ** 31)):
        bl = torch.zeros((1, 8, 8), dtype=torch.int32)
        bl[0, 3, 4] = v
        for blocks in (list(bl), list(bl.cuda())):
            with pytest.raises(ValueError, match="device HT range"):
                ht_encode.encode_cblks_ht(blocks)


def test_ht_kernels_dense_ff_round_trip(gen):
    """The 0xFF-dense blocks: the card's stuffing grows the MagSgn stream
    as the twin's does, and its destuffing reads it back."""
    bl = torch.from_numpy(cases.dense_ff())
    got = ht_encode.encode_cblks_ht(list(bl.cuda()))
    assert got == ht_encode.encode_cblks_ht_plain(list(bl))
    items = [(s, 32, 32) for s, _ in got[0]]
    out, ref = _decode_both(items)
    for o, r, b in zip(out, ref, bl):
        assert torch.equal(o, r)
        exp = torch.where(b != 0, torch.sign(b) * (2 * b.abs() + 1), 0)
        assert torch.equal(o, exp.to(torch.int32))


def test_ht_decode_kernel_bad_scup_and_wrap(gen):
    """Segments with fewer than 2 bytes, a Scup below 2 or above the
    length, and a corrupt block whose MagSgn cursor wraps by the batch's
    padded length: kernel and twin agree alone and beside a long block."""
    rng = np.random.default_rng(8)
    body = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
    items = [(b"", 16, 16), (b"\x07", 16, 16)]
    items += [(body[:-2] + bytes([v & 0xF, v >> 4]), 16, 16)
              for v in (0, 1, 41, 4095)]
    wraps = bytes.fromhex("e92f42458210c0a1b5a298cdc623cb5f965f9826081301")
    big = np.random.default_rng(7).integers(-(1 << 20), 1 << 20, (1, 64, 64))
    long_seg = ht_encode.encode_cblks_ht_plain(
        list(torch.from_numpy(big.astype(np.int32))))[0][0][0]
    for batch in (items + [(wraps, 8, 8)],
                  items + [(wraps, 8, 8), (long_seg, 64, 64)]):
        out, ref = _decode_both(batch)
        for o, r in zip(out, ref):
            assert torch.equal(o, r)


def _decode_stages(items, outs=None):
    """The three decode launches on decode_args' card tensors, one launch
    each, held to the twins stage by stage (torch_ht_cases.check_decode)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    if outs is None:
        outs = [torch.full((h, w), 12345, dtype=torch.int32, device=dev)
                for _, h, w in items]
    args = ht_decode.decode_args(items, dev, outs)
    reset_launches()
    ht_decode.launch_decode(args, dev)
    assert LAUNCHES["ht_destuff"] == 1 and LAUNCHES["ht_decode"] == 1
    assert LAUNCHES["ht_magsgn"] == 1
    cases.check_decode(ht_decode, args, outs, items)


@pytest.mark.parametrize("n", [1, 8, 13, 67])
def test_ht_decode_kernels_partial_ctas(gen, n):
    """Batches that fill no destuffing CTA, one, and more than one with
    the last part-empty (a CTA destuffs several blocks; MagSgn spreads a
    block's chunks over a CTA's warps, some idle on small blocks), with a
    long dense block that runs the destuffing ring around many times."""
    rng = np.random.default_rng(20 + n)
    items = _ht_segments(rng, [(64, 64), (32, 12), (10, 32), (2, 4)], n=n)
    items = [items[i] for i in rng.permutation(len(items))[:n - 1]]
    items += [(ht_encode.encode_cblks_ht_plain(
        list(torch.from_numpy(cases.dense_ff())))[0][0][0], 32, 32)]
    _decode_stages(items)


@pytest.mark.parametrize("aligned", [True, False])
def test_ht_magsgn_store_variants(gen, aligned):
    """Destinations whose rows are 8-byte aligned (a quad row one 8-byte
    store) and ones that are not (4-byte stores), in one band; the rest of
    the band untouched."""
    rng = np.random.default_rng(26)
    items = _ht_segments(rng, [(32, 32), (32, 12), (10, 32)], n=1)
    band = torch.full((64, 98 if aligned else 97), 7, dtype=torch.int32,
                      device="cuda")
    x = 0 if aligned else 1
    regions = [(slice(0, 32), slice(x, x + 32)),
               (slice(32, 64), slice(x, x + 12)),
               (slice(0, 10), slice(x + 40, x + 72))]
    _decode_stages(items, [band[r] for r in regions])
    mask = torch.ones_like(band, dtype=torch.bool)
    for r in regions:
        mask[r] = False
    assert bool((band[mask] == 7).all())


def test_ht_destuff_odd_offsets(gen):
    """Segments at odd byte offsets of the joined buffer (a one-byte and a
    three-byte segment first), so MagSgn starts mid-chunk; bad Scup and the
    wrapping cursor beside them."""
    rng = np.random.default_rng(27)
    items = [(b"\x05", 2, 2), (b"\x00\x22\x00", 4, 4)]
    items += _ht_segments(rng, cases.DEC_SHAPES, n=2)
    items += cases.bad_scup(rng) + [(cases.WRAP_SEG, 8, 8)]
    _decode_stages(items)


def test_ht_encode_kernel_raises_on_suffix_overflow(gen, monkeypatch):
    """A Scup above SCUP_MAX is reported by the kernel and raises (no
    legal block reaches 4079, so the limit is lowered here)."""
    rng = np.random.default_rng(9)
    bl = torch.from_numpy(cases.blocks(rng, 16, 16, n=4, mag=900))
    segs, _ = ht_encode.encode_cblks_ht_plain(list(bl))
    scup = max((s[-1] << 4) | (s[-2] & 0x0F) for s, _ in segs if s)
    monkeypatch.setattr(ht_encode, "SCUP_MAX", scup - 1)
    with pytest.raises(ValueError, match="HT suffix overflow"):
        ht_encode.encode_cblks_ht(list(bl.cuda()))
    monkeypatch.setattr(ht_encode, "SCUP_MAX", scup)
    assert ht_encode.encode_cblks_ht(list(bl.cuda()))[0] == segs


def test_ht_encode_kernel_raises_on_small_pool(gen):
    """A pool too small for the segments raises; it is never truncated."""
    rng = np.random.default_rng(10)
    bl = list(torch.from_numpy(cases.blocks(rng, 32, 32, n=4)).cuda())
    need = sum(len(s) for s, _ in ht_encode.encode_cblks_ht(bl)[0])
    dev = bl[0].device
    for cap in (0, need // 2, need - 1):
        args = ht_encode.encode_args(bl, dev, pool_cap=cap)
        ht_encode.launch_encode(args, dev)
        with pytest.raises(RuntimeError, match="pool is too small"):
            ht_encode.finish_encode(args)
    args = ht_encode.encode_args(bl, dev, pool_cap=need)
    ht_encode.launch_encode(args, dev)
    assert ht_encode.finish_encode(args) == ht_encode.encode_cblks_ht(bl)


def _mq_same(a, b):
    """Two MQEncoded results agree exactly."""
    assert a.data == b.data
    for f in ("numbps", "rates", "terms", "dists", "e0"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("style", mq_cases.STYLES)
@pytest.mark.parametrize("case", mq_cases.ENC_CASES)
def test_mq_encode_kernel_matches_twin(gen, case, style):
    """grok_tpu's MQ encoder shapes (all-zero blocks included), one
    launch, codewords, rates, terminations and sums equal to the twin's."""
    rng = np.random.default_rng(7)
    batch = mq_cases.enc_blocks(rng, *case)
    orients = rng.integers(0, 4, len(batch)).tolist()
    lazy = style == mq_cases.CblkStyle.LAZY
    reset_launches()
    got = mq_encode.encode_cblks_mq(list(torch.from_numpy(batch).cuda()),
                                    orients, lazy)
    assert LAUNCHES["mq_encode"] == 1
    _mq_same(got, mq_encode.encode_cblks_mq_plain(
        list(torch.from_numpy(batch)), orients, lazy))


def test_mq_encode_kernel_mixed_views_and_dist(gen):
    """Mixed shapes, styles and need_dist flags in one launch, read as
    views of a band tensor on the card; distortions exact."""
    rng = np.random.default_rng(8)
    blocks = mq_cases.mixed_blocks(rng) + mq_cases.dist_blocks(rng)
    n = len(blocks)
    orients = rng.integers(0, 4, n).tolist()
    lazy = rng.integers(0, 2, n).tolist()
    dist = [int(np.abs(b).max(initial=0) < (1 << 20)) for b in blocks]
    band = torch.zeros((80, 80 * n), dtype=torch.int32, device="cuda")
    views = []
    for k, b in enumerate(blocks):
        v = band[3:3 + b.shape[0], 80 * k:80 * k + b.shape[1]]
        v.copy_(torch.from_numpy(b))
        views.append(v)
    got = mq_encode.encode_cblks_mq(views, orients, lazy, dist)
    _mq_same(got, mq_encode.encode_cblks_mq_plain(
        [torch.from_numpy(b) for b in blocks], orients, lazy, dist))


def test_mq_decode_kernel_matches_twin(gen):
    """Valid, pass-capped, corrupt and truncated streams, mixed shapes,
    one launch, written into views of a band tensor."""
    rng = np.random.default_rng(9)
    blocks = mq_cases.mixed_blocks(rng)
    styles = [mq_cases.STYLES[k % 2] for k in range(len(blocks))]
    items = mq_cases.dec_items(rng, blocks, styles)
    items = items + mq_cases.corrupt_items(rng, items)
    band = torch.full((70, 70 * len(items)), 7, dtype=torch.int32,
                      device="cuda")
    outs = [band[2:2 + it[4], 70 * k:70 * k + it[5]]
            for k, it in enumerate(items)]
    reset_launches()
    mq_decode.decode_cblks_mq(items, "cuda", outs)
    assert LAUNCHES["mq_decode"] == 1
    ref = mq_decode.decode_cblks_mq_plain(items)
    for o, r in zip(outs, ref):
        assert torch.equal(o.cpu(), r)


def test_mq_round_trip_on_card(gen):
    """The kernels' codewords decode back to the blocks (doubled
    domain)."""
    rng = np.random.default_rng(10)
    blocks = mq_cases.mixed_blocks(rng, 40)
    enc = mq_encode.encode_cblks_mq(
        [torch.from_numpy(b).cuda() for b in blocks], 0, True)
    items = []
    for k, b in enumerate(blocks):
        npass = enc.num_passes(k)
        seg, last = [], 0
        for i in range(npass):
            if enc.terms[k, i] or i == npass - 1:
                seg.append(int(enc.rates[k, i]) - last)
                last = int(enc.rates[k, i])
        items.append((enc.data[k], seg, npass, int(enc.numbps[k]),
                      b.shape[0], b.shape[1], 0, mq_cases.CblkStyle.LAZY))
    outs = mq_decode.decode_cblks_mq(items, "cuda")
    for o, b in zip(outs, blocks):
        exp = np.where(b != 0, np.sign(b) * (2 * np.abs(b) + 1), 0)
        assert np.array_equal(o.cpu().numpy(), exp)


def test_mq_encode_kernel_refuses_out_of_range(gen):
    b = torch.full((4, 4), 1 << 26, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="range"):
        mq_encode.encode_cblks_mq([b], 0, False)
    b = torch.full((4, 4), 1 << 20, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="range"):
        mq_encode.encode_cblks_mq([b], 0, False, True)


@pytest.mark.parametrize("dist", [0, 1])
@pytest.mark.parametrize("style", mq_cases.STYLES)
def test_mq_kernels_extreme_shapes(gen, style, dist):
    """4x1024, 1024x4, 8x512 and 512x8 with 64x64 blocks in one launch
    each way, shared memory sized by the largest: codewords, rates,
    terminations, distortions and samples equal to the twins'."""
    rng = np.random.default_rng(11)
    blocks = mq_cases.extreme_blocks(rng)
    orients = rng.integers(0, 4, len(blocks)).tolist()
    lazy = style == mq_cases.CblkStyle.LAZY
    reset_launches()
    got = mq_encode.encode_cblks_mq([torch.from_numpy(b).cuda()
                                     for b in blocks], orients, lazy, dist)
    assert LAUNCHES["mq_encode"] == 1
    _mq_same(got, mq_encode.encode_cblks_mq_plain(
        [torch.from_numpy(b) for b in blocks], orients, lazy, dist))
    # the kernel's codewords, every third block capped to 2/3 of its passes
    items = []
    for k, b in enumerate(blocks):
        n = got.num_passes(k)
        npd = max(1, 2 * n // 3) if k % 3 == 1 and n else n
        seg, last = [], 0
        for i in range(npd):
            if got.terms[k, i] or i == npd - 1:
                seg.append(int(got.rates[k, i]) - last)
                last = int(got.rates[k, i])
        items.append((got.data[k][:last], seg, npd, int(got.numbps[k]),
                      b.shape[0], b.shape[1], orients[k], style))
    outs = mq_decode.decode_cblks_mq(items, "cuda")
    assert LAUNCHES["mq_decode"] == 1
    for o, r in zip(outs, mq_decode.decode_cblks_mq_plain(items)):
        assert torch.equal(o.cpu(), r)


def test_deferred_strip_decode_on_the_card(gen, monkeypatch):
    """decompress_strips on the card keeps one tile's synthesis in flight:
    every tile's planes are read (DeferredPlanes.materialize, after its
    event) only once the next tile of its row has launched its HT
    decode; the strips equal the whole decode and the input bit for bit,
    and no tile takes the host path."""
    import grok_tpu_torch
    from grok_tpu_torch import CompressParams, DecompressParams, GrkImage
    from grok_tpu_torch.tile import processor

    rng = np.random.default_rng(5)
    arr = rng.integers(0, 256, (96, 128)).astype(np.uint8)
    data = grok_tpu_torch.compress(GrkImage.from_array(arr), CompressParams(
        numresolution=3, tile_size=(32, 32), ht=True))
    whole = grok_tpu_torch.decompress(data).comps[0].data
    assert np.array_equal(whole, arr)
    seen = []
    materialize = processor.DeferredPlanes.materialize

    def spy(self):
        seen.append(LAUNCHES["ht_decode"])
        return materialize(self)

    monkeypatch.setattr(processor.DeferredPlanes, "materialize", spy)
    reset_launches()
    for k in processor.HOST_PATH_TILES:
        processor.HOST_PATH_TILES[k] = 0
    strips = list(grok_tpu_torch.decompress_strips(data,
                                                   DecompressParams()))
    assert [y0 for y0, _ in strips] == [0, 32, 64]
    assert np.array_equal(np.vstack([s[0] for _, s in strips]), whole)
    assert processor.HOST_PATH_TILES["decode"] == 0
    assert LAUNCHES["ht_decode"] == 12 and LAUNCHES["inv53_level"] == 24
    # tile k of a 4-tile row is read after tile k+1's launch; the row's
    # last tile after its own
    assert seen == [k + 2 if k % 4 < 3 else k + 1 for k in range(12)]


# ------------------------------------------------------------- the mesh

def _bits_equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("h,w", [(64, 37), (128, 96), (2160, 257)])
def test_sharded_levels_on_the_card(gen, sp, h, w):
    """Each sharded level (cuda:0 repeated sp times) equals the level
    kernel on the whole tensor bit for bit, one launch a shard; 64 rows
    at sp 8 is the deepest shard sp_transform_ok allows."""
    from grok_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.Mesh([[torch.device("cuda", 0)] * sp])
    x = _rand(gen, (3, 1, h, w), -512, 512)
    xf = _normal(gen, (3, 1, h, w), 600.0)
    for inp, rev, st in ((x, True, None), (xf, False, None),
                         (xf, False, (0.0, 0.61, 0.59, 1.13))):
        fwd = dwt.fwd_level(inp, rev, st)
        inb = [2 * b + torch.sign(b) if s > 0 else b
               for b, s in zip(fwd, st or (0,) * 4)]
        want = dwt.inv_level(*inb, h, w, rev, st)
        reset_launches()
        if rev:
            got = pmesh.sp_sharded_fwd_53_level(mesh, inp)
            back = pmesh.sp_sharded_inv_53_level(mesh, *inb)
        else:
            got = pmesh.sp_sharded_fwd_97_level(mesh, inp, st)
            back = pmesh.sp_sharded_inv_97_level(mesh, *inb, steps=st)
        name = "53" if rev else "97"
        assert LAUNCHES[f"fwd{name}_level"] == sp
        assert LAUNCHES[f"inv{name}_level"] == sp
        assert all(_bits_equal(g, r) for g, r in zip(got, fwd))
        assert _bits_equal(back, want)


def _mesh_codec_case(mesh):
    """Lossless HT in one tile, and lossy MQ in six tiles, through
    `mesh`: the single-device card bytes and decodes, each level kernel
    launched once a shard a level (one tile on a dp-only mesh is not
    sharded)."""
    import grok_tpu_torch
    from grok_tpu_torch import CompressParams, DecompressParams, GrkImage
    from grok_tpu_torch.parallel import mesh as pmesh

    rng = np.random.default_rng(7)
    arr = rng.integers(0, 256, (256, 192, 3)).astype(np.uint8)
    img = GrkImage.from_array(arr)
    sp = pmesh.sp_size(mesh)
    for kw, shards in ((dict(numresolution=4, ht=True),
                        mesh.size if sp > 1 else 1),
                       (dict(numresolution=3, tile_size=(64, 128),
                             irreversible=True, layer_rates=[20]),
                        mesh.size)):
        one = grok_tpu_torch.compress(img, CompressParams(**kw))
        want = grok_tpu_torch.decompress(one).to_array()
        reset_launches()
        many = grok_tpu_torch.compress(img, CompressParams(mesh=mesh, **kw))
        assert many == one
        out = grok_tpu_torch.decompress(many, DecompressParams(mesh=mesh))
        assert np.array_equal(out.to_array(), want)
        level = "fwd53_level" if "ht" in kw else "fwd97_level"
        assert LAUNCHES[level] == shards * (kw["numresolution"] - 1)
    assert np.array_equal(grok_tpu_torch.decompress(
        grok_tpu_torch.compress(img, CompressParams(
            mesh=mesh, numresolution=4, ht=True))).to_array(), arr)


def test_mesh_codec_on_a_repeated_card(gen):
    from grok_tpu_torch.parallel import mesh as pmesh

    card = torch.device("cuda", 0)
    _mesh_codec_case(pmesh.Mesh([[card, card], [card, card]]))


def test_mesh_codec_over_distinct_cards(gen):
    """The same over two distinct cards (the halo rows then move between
    cards); an int mesh is the visible cards, never more."""
    from grok_tpu_torch.parallel import mesh as pmesh

    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="visible"):
        pmesh.resolve_mesh(n + 1, "cuda")
    if n < 2:
        pytest.skip("needs two CUDA devices")
    cards = [torch.device("cuda", i) for i in range(2)]
    _mesh_codec_case(pmesh.Mesh([cards]))
    _mesh_codec_case(pmesh.resolve_mesh(2, "cuda"))
