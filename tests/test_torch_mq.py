"""The port's MQ Tier-1 against grok_tpu's, on the CPU, tolerance 0.

The twins of the two MQ kernels (ops/mq_encode.py, ops/mq_decode.py), their
tables, the device routers of t1/backend.py and the codec under
backend="device" on device="cpu", all fed the same numpy-seeded inputs as
grok_tpu: byte-identical codewords, rates, terminations and distortions,
byte-identical codestreams, bit-exact decodes.  Corrupt and truncated
streams decode as grok_tpu's device MQ decoder decodes them (what its
Python and native decoders do there is tests/mq_reference_probe.py's
question); the port's host route decodes them as grok_tpu's host coders.
"""

import numpy as np
import pytest
import torch

import grok_tpu
import torch_ht_cases as ht_cases
import torch_mq_cases as cases
from grok_tpu.ops import mq_decode as ref_dec
from grok_tpu.ops import mq_encode as ref_enc
from grok_tpu.params import CblkStyle as RefStyle
from grok_tpu.t1 import backend as ref_backend
from grok_tpu.t1 import coder as ref_coder
from grok_tpu.t1 import native as ref_native

import grok_tpu_torch
from grok_tpu_torch import params as port_params
from grok_tpu_torch.kernels import LAUNCHES, reset_launches
from grok_tpu_torch.ops import mq_decode, mq_encode, mq_tables
from grok_tpu_torch.params import CblkStyle
from grok_tpu_torch.t1 import backend as t1_backend
from grok_tpu_torch.t1 import native as port_native


def _t(blocks):
    return [torch.from_numpy(np.ascontiguousarray(b)) for b in blocks]


def _ref_items(items):
    return [(d, list(s), n, nb, h, w, o, RefStyle(int(st)))
            for d, s, n, nb, h, w, o, st in items]


def test_tables_match_reference():
    for name in ("ZC_LUT", "SC_CN", "SC_XOR", "QE", "NMPS", "NLPS"):
        assert np.array_equal(getattr(mq_tables, name),
                              getattr(ref_enc, "_" + name)), name
    assert np.array_equal(mq_tables.INIT_CTX, ref_enc._INIT_CTX)
    assert mq_tables.NUMBPS_BUCKETS == ref_enc.NUMBPS_BUCKETS
    assert mq_tables.MAX_NUMBPS_DEVICE == ref_enc.MAX_NUMBPS_DEVICE
    assert mq_tables.MAX_NUMBPS_DIST == ref_enc.MAX_NUMBPS_DIST
    assert (mq_tables.CTX_ZC, mq_tables.CTX_SC, mq_tables.CTX_MAG,
            mq_tables.CTX_RL, mq_tables.CTX_UNI) == (
        ref_enc._CTX_ZC, ref_enc._CTX_SC, ref_enc._CTX_MAG, ref_enc._CTX_RL,
        ref_enc._CTX_UNI)


def _check_passes(got, k, passes):
    n = got.num_passes(k)
    assert n == len(passes)
    assert got.rates[k, :n].tolist() == [p.rate for p in passes]
    assert got.terms[k, :n].tolist() == [int(p.term) for p in passes]


@pytest.mark.parametrize("style", cases.STYLES)
@pytest.mark.parametrize("case", cases.ENC_CASES)
def test_encode_twin_matches_reference(rng, case, style):
    """grok_tpu's test_device_mq_encoder_bit_exact shapes: the twin equals
    grok_tpu's device encoder and its host coder (codeword, numbps, every
    pass's type, plane, termination and rate)."""
    batch = cases.enc_blocks(rng, *case)
    orients = rng.integers(0, 4, len(batch)).astype(np.int32)
    lazy = style == CblkStyle.LAZY
    got = mq_encode.encode_cblks_mq_plain(_t(batch), orients.tolist(), lazy)
    dev = ref_enc.encode_cblks_mq_device(batch, orients, lazy)
    for k, b in enumerate(batch):
        data, nb, passes = ref_coder.encode_cblk(b, int(orients[k]),
                                                 RefStyle(int(style)))
        assert got.data[k] == data == dev[k][0]
        assert got.numbps[k] == nb == dev[k][1]
        _check_passes(got, k, passes)
        _check_passes(got, k, dev[k][2])
        lp = t1_backend.LazyPasses(got.rates[k, :len(passes)],
                                   got.dists[k, :len(passes)],
                                   got.terms[k, :len(passes)], nb)
        assert [(p.passtype, p.bpno, p.term) for p in lp] == \
            [(p.passtype, p.bpno, p.term) for p in passes]


@pytest.mark.parametrize("style", cases.STYLES)
def test_encode_twin_distortions_match_reference(rng, style):
    """need_dist: every pass's cumulative distortion and e0 equal grok_tpu's
    device encoder's and its native coder's, bit for bit."""
    blocks = cases.dist_blocks(rng)
    lazy = style == CblkStyle.LAZY
    got = mq_encode.encode_cblks_mq_plain(_t(blocks), 0, lazy, True)
    dev = ref_enc.encode_cblks_mq_device(np.stack(blocks),
                                         np.zeros(5, np.int32), lazy,
                                         need_dist=True)
    jobs = [ref_backend.EncodeJob(b, 0, RefStyle(int(style)),
                                  need_dist=True) for b in blocks]
    ref_native.encode_batch_native(jobs)
    for k, ((data, nb, passes, e0), j) in enumerate(zip(dev, jobs)):
        n = len(passes)
        assert got.data[k] == data == j.data
        assert got.rates[k, :n].tolist() == [p.rate for p in j.passes]
        assert got.dists[k, :n].tolist() == [p.dist for p in passes] == \
            [p.dist for p in j.passes]
        assert got.e0[k] == e0 == j.e0_out


def test_encode_twin_mixed_batch_matches_host_coder(rng):
    """Mixed shapes, styles and orients in one call, all-zero blocks and
    magnitudes up to 2^17: equal to grok_tpu's host coder, distortions
    included."""
    blocks = cases.mixed_blocks(rng)
    n = len(blocks)
    orients = rng.integers(0, 4, n).tolist()
    lazy = rng.integers(0, 2, n).tolist()
    got = mq_encode.encode_cblks_mq_plain(_t(blocks), orients, lazy, True)
    for k, b in enumerate(blocks):
        data, nb, passes = ref_coder.encode_cblk(
            b, orients[k], RefStyle.LAZY if lazy[k] else RefStyle.NONE)
        assert got.data[k] == data and got.numbps[k] == nb
        _check_passes(got, k, passes)
        assert got.dists[k, :len(passes)].tolist() == \
            [p.dist for p in passes]
        assert got.e0[k] == float((b.astype(np.int64) ** 2).sum())


def test_encode_refuses_out_of_range():
    with pytest.raises(ValueError, match="range"):
        mq_encode.encode_cblks_mq([torch.full((4, 4), 1 << 26,
                                              dtype=torch.int32)], 0, False)
    with pytest.raises(ValueError, match="range"):
        mq_encode.encode_cblks_mq([torch.full((4, 4), 1 << 20,
                                              dtype=torch.int32)], 0, False,
                                  True)
    with pytest.raises(ValueError, match="no kernel route"):
        mq_encode.encode_cblks_mq([torch.zeros((4, 4), dtype=torch.int32,
                                               device="meta")], 0, False)
    with pytest.raises(ValueError, match="no kernel route"):
        mq_decode.decode_cblks_mq([(b"", [], 0, 0, 4, 4, 0, CblkStyle.NONE)],
                                  "meta")
    with pytest.raises(ValueError, match="styles NONE and LAZY"):
        mq_decode.decode_cblks_mq([(b"", [], 1, 1, 4, 4, 0,
                                    CblkStyle.TERMALL)], "cpu")


@pytest.mark.parametrize("style", cases.STYLES)
def test_decode_twin_matches_reference(rng, style):
    """grok_tpu's test_device_mq_decoder_bit_exact: 16x16 blocks, one
    pass-capped, one all zero; equal to grok_tpu's device decoder and its
    host decoder; written into views of a band tensor, counting no
    launch."""
    batch = rng.integers(-900, 901, size=(9, 16, 16)).astype(np.int32)
    batch[rng.random(batch.shape) > 0.5] = 0
    batch[2] = 0
    items = cases.dec_items(rng, list(batch), [style] * len(batch))
    band = torch.full((20, 20 * len(items)), 5, dtype=torch.int32)
    outs = [band[2:18, 20 * k:20 * k + 16] for k in range(len(items))]
    reset_launches()
    mq_decode.decode_cblks_mq(items, "cpu", outs)
    assert not any(LAUNCHES.values())
    dev = ref_dec.decode_cblks_mq_device(_ref_items(items))
    for o, d, it in zip(outs, dev, _ref_items(items)):
        assert np.array_equal(o.numpy(), np.asarray(d))
        assert np.array_equal(o.numpy(), ref_coder.decode_cblk(*it))


def test_decode_twin_mixed_shapes_match_host_decoder(rng):
    """Mixed shapes and styles in one call, pass-capped decodes: equal to
    grok_tpu's host decoder."""
    blocks = cases.mixed_blocks(rng)
    styles = [cases.STYLES[k % 2] for k in range(len(blocks))]
    items = cases.dec_items(rng, blocks, styles)
    for o, it in zip(mq_decode.decode_cblks_mq_plain(items),
                     _ref_items(items)):
        assert np.array_equal(o.numpy(), ref_coder.decode_cblk(*it))


def _grouped_reference(items):
    """grok_tpu's device decode of items, one call a shape group (as its
    router batches them)."""
    groups: dict = {}
    for k, it in enumerate(items):
        groups.setdefault((it[4], it[5]), []).append(k)
    out = [None] * len(items)
    for idx in groups.values():
        res = ref_dec.decode_cblks_mq_device(_ref_items([items[k]
                                                          for k in idx]))
        for k, o in zip(idx, res):
            out[k] = np.asarray(o)
    return out


def test_decode_twin_corrupt_streams_match_reference_device(rng):
    """Random bytes, truncations, segment lengths past the bytes and
    missing segments decode as grok_tpu's device decoder decodes them."""
    blocks = [b for b in cases.mixed_blocks(rng, 16)
              if b.shape in ((16, 16), (32, 32))]
    styles = [cases.STYLES[k % 2] for k in range(len(blocks))]
    items = cases.dec_items(rng, blocks, styles)
    bad = [it for it in cases.corrupt_items(rng, items, n=16)
           if (it[4], it[5]) in ((16, 16), (32, 32))]
    got = mq_decode.decode_cblks_mq_plain(bad)
    for o, r in zip(got, _grouped_reference(bad)):
        assert np.array_equal(o.numpy(), r)


def test_host_route_decodes_corrupt_streams_as_host_coders(rng):
    """backend="native" (the port's native coder) decodes the same corrupt
    streams as grok_tpu's native and Python decoders."""
    items = [it for it in cases.corrupt_items(rng, [], n=12)]
    jobs = [t1_backend.DecodeJob(*it) for it in items]
    port_native.decode_batch_native(jobs)
    ref_jobs = [ref_backend.DecodeJob(*it) for it in _ref_items(items)]
    ref_native.decode_batch_native(ref_jobs)
    for j, r in zip(jobs, ref_jobs):
        assert np.array_equal(j.out, r.out)


def test_padded_lengths_follow_the_reference():
    """The reference's padded batch length: the next power of two of the
    longest block of a shape, at least 1."""
    items = [(b"x" * n, [n], 1, 1, h, 16, 0, CblkStyle.NONE)
             for n, h in ((0, 16), (3, 16), (5, 8), (0, 4))]
    assert mq_decode.padded_lengths(items).tolist() == [4, 4, 8, 1]


# ---------------------------------------------------------------- routers

@pytest.mark.parametrize("ht", [False, True], ids=["mq", "ht"])
def test_mq_device_eligible_follows_reference(ht):
    """t1_backend.on_card, the one placement rule, takes the blocks
    grok_tpu's device routers take, block by block and as one array call:
    MQ of style NONE or LAZY within numbps 26 (20 with distortions), on
    decode in shape groups of 8 or more; HT with even sides and, on
    encode, numbps within 25."""
    grid = [(style, h, w, nb, dist)
            for style in (CblkStyle.NONE, CblkStyle.LAZY, CblkStyle.TERMALL,
                          CblkStyle.LAZY | CblkStyle.RESET, CblkStyle.VSC)
            for h, w in ((64, 64), (63, 64), (64, 5))
            for nb in (0, 20, 21, 25, 26, 27)
            for dist in (False, True)]
    want = [(h % 2 == 0 and w % 2 == 0 and nb <= 25) if ht else
            (style in (CblkStyle.NONE, CblkStyle.LAZY)
             and nb <= (20 if dist else 26))
            for style, h, w, nb, dist in grid]
    for (style, h, w, nb, dist), ok in zip(grid, want):
        assert t1_backend.on_card(ht, h, w, int(style), nb,
                                  need_dist=dist) == ok
    style, h, w, nb, dist = (np.array([int(v) for v in c])
                             for c in zip(*grid))
    assert t1_backend.on_card(ht, h, w, style, nb,
                              need_dist=dist).tolist() == want
    # decode: the block's own numbps, no distortions; ten 16 x 16 blocks
    # (one at numbps 27, one at -1), eight 8 x 8 (one TERMALL), one odd
    h = np.array([16] * 10 + [8] * 8 + [5])
    style = np.array([int(CblkStyle.LAZY)] * 18 + [0])
    style[10] = int(CblkStyle.TERMALL)
    nb = np.full(19, 3)
    nb[:2] = 27, -1
    got = t1_backend.on_card(ht, h, h, style, nb, decode=True).tolist()
    assert got == ([True] * 18 + [False] if ht else
                   [False] * 2 + [True] * 8 + [False] * 9)


class _Routed:
    """Counts the codeblocks grok_tpu's device MQ routers take."""

    def __init__(self, monkeypatch):
        self.enc = self.dec = 0
        enc, dec = ref_backend._encode_mq_device, \
            ref_dec.decode_cblks_mq_device

        def route(jobs):
            rest = enc(jobs)
            self.enc += len(jobs) - len(rest)
            return rest

        def count(items):
            self.dec += len(items)
            return dec(items)

        monkeypatch.setattr(ref_backend, "_encode_mq_device", route)
        monkeypatch.setattr(ref_dec, "decode_cblks_mq_device", count)


CODEC_CASES = [
    # grok_tpu's test_device_mq_codec_stream_identical, both styles
    ("lazy_96", lambda r: r.integers(0, 256, (96, 96)).astype(np.uint8),
     dict()),
    ("none_96", lambda r: r.integers(0, 256, (96, 96)).astype(np.uint8),
     dict(cblk_style=CblkStyle.NONE)),
    # grok_tpu's test_device_backend_rate_targeted_stream_identical: the
    # need_dist path
    ("layers_128", lambda r: r.integers(0, 256, (128, 128)).astype(np.int32),
     dict(numresolution=3, layer_rates=[10, 1])),
    ("rgb_tiles", lambda r: r.integers(0, 256, (64, 96, 3)).astype(np.uint8),
     dict(numresolution=3, tile_size=(32, 32))),
]


# every case's tiles encode as flat batches (all MQ, no rate quota, ROI
# or -q, aligned to the grid); layers_128 tracks distortions for its two
# layers, and its multi-layer decode keeps the per-codeblock route.  The
# others decode flat too: lazy_96's and none_96's one tile and rgb_tiles'
# six 32 x 32 tiles, one layer each.  The 96 x 96 tiles have no decode
# shape group of 8, so their flat decode batches hold host jobs alone
FLAT_DECODE = {"lazy_96", "none_96", "rgb_tiles"}
DIST = {"layers_128"}


@pytest.mark.parametrize("name,make,kw", CODEC_CASES,
                         ids=[c[0] for c in CODEC_CASES])
def test_codec_matches_reference(rng, monkeypatch, name, make, kw):
    """backend="device" on device="cpu": byte-identical to grok_tpu's
    native and device routes, decodes exactly, and codes on the device
    route exactly the MQ blocks grok_tpu's device routers take (the
    per-shape decode gate of 8 included), as flat tile batches (with
    distortions where rate control reads them) where the gates admit the
    tiles."""
    arr = make(rng)
    img = grok_tpu.GrkImage.from_array(arr)
    ref_kw = dict(kw)
    if "cblk_style" in kw:
        ref_kw["cblk_style"] = RefStyle(int(kw["cblk_style"]))
    ref_nat = grok_tpu.compress(img, grok_tpu.CompressParams(
        backend="native", **ref_kw))
    routed = _Routed(monkeypatch)
    ref_dev = grok_tpu.compress(img, grok_tpu.CompressParams(
        backend="device", **ref_kw))
    grok_tpu.decompress(ref_dev, grok_tpu.DecompressParams(backend="device"))
    counts = t1_backend.DEVICE_CODEBLOCKS
    for k in counts:
        counts[k] = 0
    data = grok_tpu_torch.compress(port_params.from_reference(img),
                                   grok_tpu_torch.CompressParams(**kw),
                                   device="cpu")
    assert data == ref_nat == ref_dev
    out = grok_tpu_torch.decompress(data, device="cpu")
    assert np.array_equal(out.to_array(), arr.astype(np.int32))
    assert counts["mq_encode_device"] == routed.enc > 0
    assert counts["mq_decode_device"] == routed.dec
    assert counts["mq_decode_host"] + counts["mq_decode_device"] == \
        counts["mq_encode_device"] + counts["mq_encode_host"]
    assert counts["encode_device"] == counts["decode_device"] == 0
    assert counts["mq_encode_flat"] == counts["mq_encode_device"] > 0
    assert counts["mq_encode_flat_dist"] == (
        counts["mq_encode_flat"] if name in DIST else 0)
    if name in FLAT_DECODE:
        assert counts["mq_decode_flat"] == counts["mq_decode_device"]
        assert (counts["mq_decode_flat"] > 0) == (name == "rgb_tiles")
    else:
        assert counts["mq_decode_flat"] == 0


# BASELINE config 2's shape, small: RGB, 9/7 + ICT, one layer at 20:1,
# the auto style (LAZY)
PHOTO_KW = dict(numresolution=4, irreversible=True, layer_rates=[20])


def _reset(counts):
    for k in counts:
        counts[k] = 0
    return counts


def test_photo_codec_runs_flat_with_distortions(monkeypatch):
    """A photo-shaped lossy encode on backend="device", device="cpu": its
    one tile codes as a flat MQ batch that tracks distortions and hands
    rate control the hulls of the kernel twin's distortions; the
    codestream equals grok_tpu's native and device routes' byte for byte,
    and the decode equals grok_tpu's native decode and is within 1 of its
    device decode (test_torch_codec.py's lossy tolerance)."""
    img = grok_tpu.GrkImage.from_array(cases.photo(96, 128))
    ref_nat = grok_tpu.compress(img, grok_tpu.CompressParams(
        backend="native", **PHOTO_KW))
    routed = _Routed(monkeypatch)
    assert grok_tpu.compress(img, grok_tpu.CompressParams(
        backend="device", **PHOTO_KW)) == ref_nat
    counts = _reset(t1_backend.DEVICE_CODEBLOCKS)
    data = grok_tpu_torch.compress(port_params.from_reference(img),
                                   grok_tpu_torch.CompressParams(**PHOTO_KW),
                                   device="cpu")
    assert data == ref_nat
    assert counts["mq_encode_flat_dist"] == counts["mq_encode_flat"] == \
        counts["mq_encode_device"] == routed.enc > 0
    assert counts["mq_encode_host"] == 0
    out = grok_tpu_torch.decompress(data, device="cpu").to_array()
    assert np.array_equal(out, grok_tpu.decompress(
        data, grok_tpu.DecompressParams(backend="native")).to_array())
    dev = grok_tpu.decompress(data, grok_tpu.DecompressParams(
        backend="device")).to_array()
    assert np.abs(out - dev).max() <= 1


@pytest.mark.parametrize("layer_rates", [[20], [40, 8]],
                         ids=["one_layer", "two_layers"])
def test_flat_distortions_join_host_and_device_hulls(monkeypatch,
                                                     layer_rates):
    """A flat batch with distortions whose blocks `on_card` sends partly to
    the native coder: the native coder's rates, distortions and e0 join
    the twin's in one feed, and the codestream still equals grok_tpu's
    native route's.  The test codes on a tile pool of its own, dropped
    at teardown, since the placement it forces is cached on the pooled
    tile."""
    from grok_tpu_torch.t1 import tile_batch
    from grok_tpu_torch.tile import processor

    monkeypatch.setattr(processor, "_TILE_POOL", {})
    real = tile_batch.on_card

    def some_on_host(*a, **k):
        card = real(*a, **k)
        return card & (np.arange(card.size) % 3 != 1)

    monkeypatch.setattr(tile_batch, "on_card", some_on_host)
    kw = dict(PHOTO_KW, numresolution=3, layer_rates=layer_rates)
    img = grok_tpu.GrkImage.from_array(cases.photo(72 + 8 * len(layer_rates),
                                                   104))
    counts = _reset(t1_backend.DEVICE_CODEBLOCKS)
    data = grok_tpu_torch.compress(port_params.from_reference(img),
                                   grok_tpu_torch.CompressParams(**kw),
                                   device="cpu")
    assert data == grok_tpu.compress(img, grok_tpu.CompressParams(
        backend="native", **kw))
    assert counts["mq_encode_flat_dist"] == counts["mq_encode_device"] > 0
    assert counts["mq_encode_host"] > 0


def _lazy_depths(rng, h, w):
    """A gray image whose quarters range from 2 to 256 levels, so that its
    LAZY blocks stop at several numbps, some with raw segments."""
    arr = rng.integers(0, 256, (h, w))
    for k, levels in enumerate((2, 16, 64, 256)):
        y, x = divmod(k, 2)
        q = arr[y * h // 2:(y + 1) * h // 2, x * w // 2:(x + 1) * w // 2]
        q //= 256 // levels
    return arr.astype(np.uint8)


@pytest.mark.parametrize("style", cases.STYLES)
def test_flat_tiles_decode_corrupt_streams_as_reference_device(rng,
                                                              style):
    """A multi-tile MQ codestream with bytes flipped in the last packet
    bodies of every tile, and one cut short inside its last tile, decode
    on the port's flat route (one batch a tile: the padded length Lb and
    the gate of 8 a shape are the tile's, as in grok_tpu's router) to what
    grok_tpu's device decode gives."""
    arr = _lazy_depths(rng, 128, 128)
    kw = dict(numresolution=3, tile_size=(64, 64), cblk_width=16,
              cblk_height=16, cblk_style=RefStyle(int(style)))
    data = grok_tpu.compress(grok_tpu.GrkImage.from_array(arr),
                             grok_tpu.CompressParams(**kw))
    parts = ht_cases.tile_parts(data)
    assert len(parts) == 4
    bad = np.frombuffer(data, np.uint8).copy()
    for start, end in parts:
        at = rng.integers(start + (end - start) * 3 // 4, end, 6)
        bad[at] ^= rng.integers(1, 256, 6).astype(np.uint8)
    start, end = parts[-1]
    for stream in (bad.tobytes(), data[:start + (end - start) * 2 // 3]):
        counts = t1_backend.DEVICE_CODEBLOCKS
        for k in counts:
            counts[k] = 0
        out = grok_tpu_torch.decompress(stream, device="cpu").to_array()
        want = grok_tpu.decompress(
            stream, grok_tpu.DecompressParams(backend="device")).to_array()
        assert np.array_equal(out, want)
        assert counts["mq_decode_flat"] == counts["mq_decode_device"] > 0


def test_flat_regrouping_matches_per_codeblock_layout(rng, monkeypatch):
    """The flat batch of a LAZY tile whose blocks stop at several numbps,
    several segments each: every device block's numbps, passes, h, w,
    orient, bytes, Lb, segment bounds and pass map read as `layout` gives
    them over the per-codeblock route's items for the same tile (blocks
    matched by where they land in the tile's device bands)."""
    from grok_tpu_torch.t1 import tile_batch

    arr = _lazy_depths(rng, 64, 64)
    data = grok_tpu_torch.compress(
        grok_tpu_torch.GrkImage.from_array(arr), grok_tpu_torch.CompressParams(
            numresolution=3, cblk_width=16, cblk_height=16,
            cblk_style=CblkStyle.LAZY), device="cpu")
    seen = {}
    flat_twin, item_twin = mq_decode.decode_flat_plain, \
        mq_decode.decode_cblks_mq

    def flat(lay, device, outs):
        seen["flat"] = lay, outs
        return flat_twin(lay, device, outs)

    def per_block(items, device, outs=None):
        seen["items"] = items, outs
        return item_twin(items, device, outs)

    monkeypatch.setattr(mq_decode, "decode_flat_plain", flat)
    monkeypatch.setattr(mq_decode, "decode_cblks_mq", per_block)
    want = grok_tpu_torch.decompress(data, device="cpu").to_array()
    (desc, stream, segs, pmap), outs = seen.pop("flat")
    monkeypatch.setattr(tile_batch, "decode_tile", lambda *a: None)
    got = grok_tpu_torch.decompress(data, device="cpu").to_array()
    assert np.array_equal(got, want) and np.array_equal(got, arr)

    def where(o):
        return o.data_ptr() - o.untyped_storage().data_ptr()

    def fields(desc, joined, segs, pmap, k):
        h, w, orient, nb, npass, off, ln, lb, so, ns, po = \
            desc[k, 2:].tolist()
        npb = 3 * nb - 2 if nb else 0
        return (h, w, orient, nb, npass, lb, joined[off:off + ln].tobytes(),
                segs[so:so + ns].tolist(), pmap[po:po + npb].tolist())

    flat_rows = {where(o): fields(desc, stream, segs, pmap, k)
                 for k, o in enumerate(outs)}
    items, outs = seen["items"]
    ref = mq_decode.layout(items)
    item_rows = {where(o): fields(*ref, k) for k, o in enumerate(outs)}
    assert flat_rows == item_rows
    nbs = {r[3] for r in flat_rows.values()}
    assert len(nbs) >= 4 and max(nbs) >= 6
    assert max(len(r[7]) for r in flat_rows.values()) >= 3
