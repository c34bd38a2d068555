"""The port's HT Tier-1 against grok_tpu's, on the CPU, tolerance 0.

The twins of the two HT kernels (ops/ht_encode.py, ops/ht_decode.py), the
quad metadata, the port's copy of the Python HT coder (t1/ht.py) and the
codec under backend="device" on device="cpu", all fed the same
numpy-seeded inputs as grok_tpu: byte-identical segments and codestreams,
bit-exact decodes, corrupt streams and the three CxtVLC table swaps
included.
"""

import numpy as np
import pytest
import torch

import grok_tpu
import torch_ht_cases as cases
from grok_tpu.ops import ht_decode as ref_dec
from grok_tpu.ops import ht_encode as ref_enc
from grok_tpu.ops import ht_meta as ref_meta
from grok_tpu.t1 import ht as ref_ht
from grok_tpu.t1 import ht_tables as ref_tables

import grok_tpu_torch
from grok_tpu_torch import params as port_params
from grok_tpu_torch.kernels import LAUNCHES, reset_launches
from grok_tpu_torch.ops import ht_decode, ht_encode, ht_meta
from grok_tpu_torch.t1 import backend as t1_backend
from grok_tpu_torch.t1 import ht as port_ht
from grok_tpu_torch.t1 import ht_tables as port_tables


def _t(batch):
    return [torch.from_numpy(np.ascontiguousarray(b)) for b in batch]


def test_quad_metadata_matches_reference(rng):
    x = cases.blocks(rng, 16, 24, n=6)
    x[0, 1, 2] = -(2 ** 31)  # INT32_MIN keeps its int32 semantics
    x[1, 4, 5] = 2 ** 31 - 1
    x = x.reshape(2, 3, 16, 24)
    got = ht_meta.quad_metadata(torch.from_numpy(x))
    ref = ref_meta.quad_metadata(x)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("shape", cases.ENC_SHAPES)
def test_encode_twin_matches_reference(rng, shape):
    """Densities 0.05-0.95, magnitudes up to 2^25 - 1."""
    batch = cases.blocks(rng, *shape)
    segs, sumsq = ht_encode.encode_cblks_ht(_t(batch))
    assert segs == ref_enc.encode_cblks_ht_device(batch)
    assert segs == [ref_ht.encode_cblk_ht(b) for b in batch]
    assert sumsq == [int((b.astype(np.int64) ** 2).sum()) for b in batch]


def test_encode_twin_dense_ff():
    batch = cases.dense_ff()
    segs, _ = ht_encode.encode_cblks_ht_plain(_t(batch))
    assert segs == ref_enc.encode_cblks_ht_device(batch)


def test_encode_twin_reads_views_of_mixed_shapes(rng):
    """Views into one band, mixed shapes and an all-zero block, in one
    call: each equals the Python coder on its own."""
    band = rng.integers(-4000, 4000, (70, 136)).astype(np.int32)
    band[64:, 64:] = 0
    views = [(0, 64, 0, 64), (0, 64, 64, 128), (64, 70, 0, 8),
             (64, 70, 64, 72), (2, 10, 128, 136)]
    tb = torch.from_numpy(band)
    segs, _ = ht_encode.encode_cblks_ht(
        [tb[y0:y1, x0:x1] for y0, y1, x0, x1 in views])
    for (y0, y1, x0, x1), seg in zip(views, segs):
        assert seg == ref_ht.encode_cblk_ht(band[y0:y1, x0:x1])
    assert segs[3] == (b"", 0)


@pytest.mark.parametrize("bad", [1 << 25, -(2 ** 31)])
def test_encode_refuses_out_of_range(bad):
    """numbps above 25 (INT32_MIN included) is out of the device range."""
    block = torch.zeros((8, 8), dtype=torch.int32)
    block[2, 3] = bad
    with pytest.raises(ValueError, match="device HT range"):
        ht_encode.encode_cblks_ht([block])
    with pytest.raises(ValueError):
        ht_encode.encode_cblks_ht([torch.zeros((3, 8), dtype=torch.int32)])


def _decode_items(rng):
    items = []
    for h, w in cases.DEC_SHAPES:
        c = rng.integers(-(1 << 15), 1 << 15, size=(h, w)).astype(np.int32)
        c[rng.random(c.shape) < 0.6] = 0
        items.append((ref_ht.encode_cblk_ht(c)[0], h, w))
    return items


def test_decode_twin_matches_reference(rng):
    """Mixed shapes, then corrupt and truncated streams, each batch in one
    call on both sides (a corrupt stream's decode depends on its batch)."""
    items = _decode_items(rng)
    for batch in (items, items + cases.corrupt(rng, items)):
        got = ht_decode.decode_cblks_ht(batch, "cpu")
        ref = ref_dec.decode_cblks_ht_device(batch)
        for g, r in zip(got, ref):
            assert np.array_equal(g.numpy(), r)
    for (data, h, w), g in zip(items, got):
        assert np.array_equal(g.numpy(), ref_ht.decode_cblk_ht(data, h, w))


def test_decode_twin_writes_views_and_counts_nothing(rng):
    items = _decode_items(rng)[:3]
    band = torch.full((64, 64), 5, dtype=torch.int32)
    dests = [band[0:32, 0:32], band[32:64, 0:12], band[0:10, 32:64]]
    reset_launches()
    ht_decode.decode_cblks_ht(items, "cpu", dests)
    for (data, h, w), d in zip(items, dests):
        assert np.array_equal(d.numpy(), ref_ht.decode_cblk_ht(data, h, w))
    assert int((band[10:32, 32:] != 5).sum()) == 0
    assert LAUNCHES["ht_encode"] == 0 and LAUNCHES["ht_decode"] == 0
    with pytest.raises(ValueError, match="no kernel route"):
        ht_decode.decode_cblks_ht(items, "meta")


@pytest.mark.parametrize("swap", ["fixed", "variable", "context"])
def test_table_swaps_reach_the_twins(rng, swap):
    """The same table set on both packages: twins, both Python coders and
    grok_tpu's device coder agree, corrupt streams included."""
    blocks = [rng.integers(-900, 900, (16, 16)).astype(np.int32)
              for _ in range(3)]
    blocks[1][rng.random((16, 16)) < 0.7] = 0
    try:
        for tables in (port_tables, ref_tables):
            tables.set_tables(*cases.table_swaps()[swap])
        segs, _ = ht_encode.encode_cblks_ht(_t(blocks))
        assert segs == ref_enc.encode_cblks_ht_device(np.stack(blocks))
        assert segs == [port_ht.encode_cblk_ht(b) for b in blocks]
        items = [(s, 16, 16) for s, _ in segs]
        items += cases.corrupt(rng, items, n=6)
        got = ht_decode.decode_cblks_ht(items, "cpu")
        ref = ref_dec.decode_cblks_ht_device(items)
        for g, r in zip(got, ref):
            assert np.array_equal(g.numpy(), r)
        for b, g in zip(blocks, got):
            exp = np.where(b != 0, np.sign(b) * (2 * np.abs(b) + 1), 0)
            assert np.array_equal(g.numpy(), exp)
    finally:
        port_tables.reset_tables()
        ref_tables.reset_tables()


def test_python_ht_coder_matches_reference(rng):
    """t1/ht.py is grok_tpu's: plain and refined, both directions, on an
    odd-sized block too."""
    for shape in ((8, 8), (13, 22), (64, 64)):
        c = rng.integers(-5000, 5000, shape).astype(np.int32)
        c[rng.random(shape) < 0.5] = 0
        seg, nb = port_ht.encode_cblk_ht(c)
        assert (seg, nb) == ref_ht.encode_cblk_ht(c)
        assert np.array_equal(port_ht.decode_cblk_ht(seg, *shape),
                              ref_ht.decode_cblk_ht(seg, *shape))
        ref_r = ref_ht.encode_cblk_ht_refined(c)
        assert port_ht.encode_cblk_ht_refined(c) == ref_r
        assert np.array_equal(
            port_ht.decode_cblk_ht_refined(ref_r[0], ref_r[1], *shape),
            ref_ht.decode_cblk_ht_refined(ref_r[0], ref_r[1], *shape))


def test_e0_above_2_53_is_summed_on_the_host(rng):
    """A block whose sum of squares passes 2^53 takes e0 from its
    coefficients on the host, equal to grok_tpu's numpy sum, and is
    counted; below 2^53 the exact sum is used."""
    big = rng.integers(-(1 << 25) + 1, 1 << 25, (64, 64)).astype(np.int32)
    small = rng.integers(-999, 999, (64, 64)).astype(np.int32)
    jobs = [t1_backend.EncodeJob(b, 0, 0, ht=True, numbps_bound=25)
            for b in (big, small)]
    t1_backend.DEVICE_CODEBLOCKS["e0_host"] = 0
    assert t1_backend._encode_ht_device(jobs, torch.device("cpu")) == []
    for j, b in zip(jobs, (big, small)):
        e0 = float((np.abs(b).astype(np.float64) ** 2).sum())
        assert j.e0_out == e0 and j.passes[0].dist == e0
        assert j.data == ref_ht.encode_cblk_ht(b)[0]
    assert t1_backend.DEVICE_CODEBLOCKS["e0_host"] == 1


def _gray(rng, h, w):
    return rng.integers(0, 256, (h, w)).astype(np.uint8)


# (name, image maker, CompressParams keywords, precision or None)
CODEC_CASES = [
    ("gray96_numres3", lambda r: _gray(r, 96, 96),
     dict(numresolution=3), None),
    ("rgb12_jp2", lambda r: r.integers(0, 4096, (40, 56, 3)).astype(
        np.uint16), dict(cod_format="jp2"), 12),
    ("tiles64", lambda r: _gray(r, 256, 256), dict(tile_size=(64, 64)),
     None),
    # grok_tpu's device path compiles per shape: this one shares the first
    ("layers_e0", lambda r: _gray(r, 96, 96),
     dict(numresolution=3, numlayers=2, layer_rates=[10, 1]), None),
    # -q: the calibration re-decodes truncated blocks through Tier-1
    ("psnr", lambda r: _gray(r, 96, 96),
     dict(numresolution=3, numlayers=2, layer_psnr=[30, 0]), None),
    ("ht_mixed", lambda r: r.integers(0, 256, (64, 64, 3)).astype(np.uint8),
     dict(ht_mixed=True), None),
    ("odd_edge_blocks", lambda r: _gray(r, 135, 70),
     dict(numresolution=2, cblk_width=32, cblk_height=32), None),
    # 22-bit samples: a 64x64 block's sum of squares passes 2^53, so its
    # e0 is summed on the host
    ("deep_e0", lambda r: r.integers(0, 1 << 22, (128, 128)).astype(
        np.int32), dict(numresolution=2, numlayers=2, layer_rates=[20, 1]),
     22),
]


@pytest.mark.parametrize("name,make,kw,prec", CODEC_CASES,
                         ids=[c[0] for c in CODEC_CASES])
def test_codec_matches_reference(rng, name, make, kw, prec):
    """backend="device" on device="cpu": the codestream equals grok_tpu's
    device and native routes byte for byte, and decodes exactly through
    the port's device route; the HT blocks code on the device route, the
    ragged ones on the native coder (counted), and ht_mixed's MQ blocks on
    the device route's MQ coders.  A tile of HT blocks with no tracked
    distortion codes as one flat batch (every device-coded block counted
    in ht_encode_flat); so decodes every tile of HT blocks of one chunk
    each, which cleanup-only HT blocks are in any number of layers, and
    no ht_mixed tile either way."""
    arr = make(rng)
    ref_img = grok_tpu.GrkImage.from_array(arr)
    if prec:
        for c in ref_img.comps:
            c.prec = prec
    kw = dict(ht=True, **kw)
    ref_dev = grok_tpu.compress(ref_img, grok_tpu.CompressParams(
        backend="device", **kw))
    ref_nat = grok_tpu.compress(ref_img, grok_tpu.CompressParams(
        backend="native", **kw))
    counts = t1_backend.DEVICE_CODEBLOCKS
    for k in counts:
        counts[k] = 0
    data = grok_tpu_torch.compress(port_params.from_reference(ref_img),
                                   grok_tpu_torch.CompressParams(**kw),
                                   device="cpu")
    assert data == ref_dev
    assert data == ref_nat
    counts["decode_device"] = counts["decode_host"] = 0  # -q calibration
    out = grok_tpu_torch.decompress(data, device="cpu")
    assert np.array_equal(out.to_array(), arr.astype(np.int32))
    assert counts["encode_device"] > 0
    assert counts["decode_device"] == counts["encode_device"]
    assert counts["decode_host"] == counts["encode_host"]
    if name == "odd_edge_blocks":
        assert counts["encode_host"] > 0
    if name == "ht_mixed":
        assert counts["mq_encode_device"] > 0
    assert (counts["e0_host"] > 0) == (name == "deep_e0")
    flat_encode = name in ("gray96_numres3", "rgb12_jp2", "tiles64",
                           "odd_edge_blocks")
    assert counts["ht_encode_flat"] == (counts["encode_device"]
                                        if flat_encode else 0)
    assert counts["ht_decode_flat"] == (counts["decode_device"]
                                        if name != "ht_mixed" else 0)


def test_python_backend_codes_ht(rng):
    """backend="python" with ht=True runs the port's Python HT coder, as
    grok_tpu's does."""
    arr = _gray(rng, 24, 20)
    img = grok_tpu.GrkImage.from_array(arr)
    kw = dict(ht=True, numresolution=2)
    ref = grok_tpu.compress(img, grok_tpu.CompressParams(backend="python",
                                                         **kw))
    data = grok_tpu_torch.compress(
        port_params.from_reference(img),
        grok_tpu_torch.CompressParams(backend="python", **kw))
    assert data == ref
    out = grok_tpu_torch.decompress(
        data, grok_tpu_torch.DecompressParams(backend="python"))
    assert np.array_equal(out.to_array(), arr.astype(np.int32))


# tiles and decodes off the device synthesis: their HT blocks still code
# on the device route, and the decoded blocks come back to host arrays
HOST_TILE_CASES = [
    ("roi", dict(roi_comp=0, roi_shift=4), {}),
    ("odd_origin", dict(image_offset=(3, 5)), {}),
    ("window", {}, dict(window=(8, 8, 40, 40))),
    ("reduce", {}, dict(reduce=1)),
]


@pytest.mark.parametrize("name,kw,dkw", HOST_TILE_CASES,
                         ids=[c[0] for c in HOST_TILE_CASES])
def test_host_tiles_match_reference(rng, name, kw, dkw):
    arr = _gray(rng, 64, 80)
    img = grok_tpu.GrkImage.from_array(arr)
    kw = dict(ht=True, numresolution=3, **kw)
    ref = grok_tpu.compress(img, grok_tpu.CompressParams(backend="device",
                                                         **kw))
    assert ref == grok_tpu.compress(img, grok_tpu.CompressParams(
        backend="native", **kw))
    counts = t1_backend.DEVICE_CODEBLOCKS
    for k in counts:
        counts[k] = 0
    data = grok_tpu_torch.compress(port_params.from_reference(img),
                                   grok_tpu_torch.CompressParams(**kw),
                                   device="cpu")
    assert data == ref
    out = grok_tpu_torch.decompress(
        data, grok_tpu_torch.DecompressParams(**dkw), device="cpu")
    want = grok_tpu.decompress(ref, grok_tpu.DecompressParams(**dkw))
    assert np.array_equal(out.to_array(), want.to_array())
    assert counts["encode_device"] > 0 and counts["decode_device"] > 0
    # no flat batch for a tile with an ROI or a windowed or reduced
    # decode; the other encodes, and the odd origin's decode, are flat
    assert counts["ht_encode_flat"] == (counts["encode_device"]
                                        if name != "roi" else 0)
    assert counts["ht_decode_flat"] == (counts["decode_device"]
                                        if name == "odd_origin" else 0)


def test_flat_tiles_decode_corrupt_streams_as_reference_device(rng):
    """A multi-tile HT codestream with bytes flipped in the last packet
    bodies of every tile, and one cut short inside its last tile, decode
    on the port's flat route (one batch a tile, as grok_tpu's router
    makes: a corrupt block's decode depends on its batch) to what
    grok_tpu's device decode gives."""
    arr = rng.integers(0, 256, (96, 128)).astype(np.uint8)
    kw = dict(ht=True, numresolution=3, tile_size=(64, 64))
    data = grok_tpu.compress(grok_tpu.GrkImage.from_array(arr),
                             grok_tpu.CompressParams(**kw))
    parts = cases.tile_parts(data)
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
        assert counts["ht_decode_flat"] == counts["decode_device"] > 0


def test_lossy_ht_on_device_route(rng):
    """HT 9/7 runs on the port's device route: the tile's transforms and
    quantizer and its even HT codeblocks on the device route, no tile on
    the host path; the codestream equals grok_tpu's device and native
    routes' byte for byte, and the decode equals grok_tpu's native decode
    (the same 9/7 arithmetic, each operation rounded as written)."""
    from grok_tpu_torch.tile.processor import HOST_PATH_TILES

    img = grok_tpu.GrkImage.from_array(_gray(rng, 64, 80))
    kw = dict(ht=True, numresolution=3, irreversible=True)
    ref = grok_tpu.compress(img, grok_tpu.CompressParams(backend="device",
                                                         **kw))
    assert ref == grok_tpu.compress(img, grok_tpu.CompressParams(
        backend="native", **kw))
    counts = t1_backend.DEVICE_CODEBLOCKS
    for k in counts:
        counts[k] = 0
    for k in HOST_PATH_TILES:
        HOST_PATH_TILES[k] = 0
    data = grok_tpu_torch.compress(port_params.from_reference(img),
                                   grok_tpu_torch.CompressParams(**kw),
                                   device="cpu")
    assert data == ref
    out = grok_tpu_torch.decompress(data, device="cpu")
    want = grok_tpu.decompress(ref, grok_tpu.DecompressParams(
        backend="native"))
    assert np.array_equal(out.to_array(), want.to_array())
    assert counts["encode_device"] > 0 and counts["decode_device"] > 0
    assert HOST_PATH_TILES == {"encode": 0, "decode": 0}
