"""The card's flat PCRD feed: `convex_hulls_flat` (tile/ratecontrol.py), the
hulls of a flat MQ tile batch that tracks distortions, against
grok_tpu's `convex_hull` (the reference) block by block (points, rates
and slopes compared with ==, infinite slopes included) on seeded rows, on
the MQ twin's rows over a quantised 9/7 band, and against the native
whole-tile encoder's own hull arrays on the same tile."""

import numpy as np
import pytest

import grok_tpu_torch
import torch_mq_cases as cases
from grok_tpu_torch import CompressParams, GrkImage
from grok_tpu_torch.ops import mq_encode
from grok_tpu_torch.params import CblkStyle
from grok_tpu_torch.t1 import backend, native, tile_batch
from grok_tpu_torch.tile import processor
from grok_tpu.tile.ratecontrol import convex_hull as reference_hull
from grok_tpu_torch.tile.ratecontrol import convex_hull, convex_hulls_flat


def _flat(rates, dists, npasses):
    """convex_hulls_flat's points as one [(pass, rate, slope), ...] a
    block."""
    hp, hs, hr, hn = convex_hulls_flat(rates, dists, npasses)
    assert hp.shape == hs.shape == hr.shape == np.shape(rates)
    assert (hp.dtype, hs.dtype, hr.dtype, hn.dtype) == (
        np.int32, np.float64, np.int32, np.int32)
    return [list(zip(hp[k, :n].tolist(), hr[k, :n].tolist(),
                     hs[k, :n].tolist())) for k, n in enumerate(hn)]


def _hulls(rates, dists, npasses):
    """The reference convex_hull's points the same way, a block at a time,
    from Python ints and floats as the per-codeblock route hands them over
    (the port's convex_hull, which that route runs, gives the same)."""
    out = []
    for k, n in enumerate(npasses):
        r = np.asarray(rates)[k, :n].tolist()
        d = np.asarray(dists, np.float64)[k, :n].tolist()
        hull = reference_hull(r, d)
        assert convex_hull(r, d) == hull
        out.append([(p, rate, s) for p, rate, _, s in hull])
    return out


def _seeded_rows(seed, n=400, stride=40):
    """Cumulative rows with what the hull must get right: zero and
    negative distortion gains, repeated rates (infinite slopes), runs of
    equal slopes (collinear points), one-pass and empty blocks."""
    rng = np.random.default_rng(seed)
    dr = rng.choice([0, 0, 1, 2, 3, 7, 40], (n, stride))
    dd = rng.choice([0.0, 0.0, -1.0, 0.5, 1.0, 2.0, 3.0, 250.0],
                    (n, stride))
    line = slice(0, n // 4)          # equal slopes: gain 3 a byte
    dr[line] = rng.integers(1, 5, (n // 4, stride))
    dd[line] = 3.0 * dr[line]
    dd[n // 4::5, ::3] *= 1e-9       # slopes a few ulps apart
    rates = np.cumsum(dr, 1).astype(np.int32)
    dists = np.cumsum(dd, 1)
    npasses = rng.integers(0, stride + 1, n)
    npasses[:12] = 1
    npasses[12:20] = 0
    return rates, dists, npasses


@pytest.mark.parametrize("seed", range(4))
def test_flat_hulls_equal_convex_hull_on_seeded_rows(seed):
    rates, dists, npasses = _seeded_rows(seed)
    got = _flat(rates, dists, npasses)
    assert got == _hulls(rates, dists, npasses)
    slopes = [s for h in got for _, _, s in h]
    assert np.isinf(slopes).any() and any(len(h) > 4 for h in got)


def test_flat_hulls_of_no_block_and_no_pass():
    for n, stride in ((0, 76), (5, 76)):
        hp, hs, hr, hn = convex_hulls_flat(
            np.zeros((n, stride), np.int32), np.zeros((n, stride)),
            np.zeros(n, np.int32))
        assert hp.shape == (n, stride) and not hn.any()


def _quantised_bands():
    """The int32 quantised 9/7 bands of a photo-shaped tile, as the card
    route reads them (the twins on the CPU), with the table's blocks."""
    seen = []
    real = tile_batch.encode_tile

    def spy(table, bands, device, need_dist=False):
        seen.append((table, bands))
        return real(table, bands, device, need_dist)

    tile_batch.encode_tile = spy
    try:
        grok_tpu_torch.compress(
            GrkImage.from_array(cases.photo(128, 128)), CompressParams(
                numresolution=3, irreversible=True, layer_rates=[20]),
            device="cpu")
    finally:
        tile_batch.encode_tile = real
    (table, bands), = seen
    return table, bands


@pytest.mark.parametrize("style", cases.STYLES)
def test_flat_hulls_equal_convex_hull_on_twin_rows(style):
    """The MQ twin's exact rows over a quantised 9/7 tile's blocks, with
    distortions tracked, in both styles."""
    table, bands = _quantised_bands()
    blocks = [bands[b][y:y + h, x:x + w]
              for b, y, x, h, w in table.blk[table.coded].tolist()]
    res = mq_encode.encode_cblks_mq_plain(
        blocks, table.orient[table.coded], style == CblkStyle.LAZY, True)
    npasses = np.where(res.numbps > 0, 3 * res.numbps - 2, 0)
    assert npasses.max() >= 10
    assert _flat(res.rates, res.dists, npasses) == _hulls(
        res.rates, res.dists, npasses)


TILES = [
    dict(numresolution=3, irreversible=True, layer_rates=[20]),
    dict(numresolution=3, irreversible=True, layer_rates=[40, 8]),
    dict(numresolution=3, layer_rates=[10, 1]),
]


@pytest.mark.parametrize("kw", TILES, ids=["lossy", "lossy_layers",
                                            "lossless_layers"])
def test_flat_hulls_equal_native_tile_hulls(monkeypatch, kw):
    """On one tile: the native whole-tile encoder's hull arrays
    (_run_t1_tile_native_enc with distortions) equal convex_hulls_flat over
    the native coder's own rates and distortions for the same blocks, and
    each job's own hull arrays."""
    seen = []
    real = processor.TileCompressor._run_t1_tile_native_enc

    def probe(self, need_dist=False):
        ok = real(self, need_dist)
        es = self._enc_seq
        table, _, _ = self._t1enc_statics()
        bands = [self.tile.comps[c].data[(r, o)].copy()
                 for c, r, o in table.band_keys]
        seen.append((ok, need_dist, table, bands, es.npasses.copy(),
                     es.rates.copy(), es.hull_pass.copy(),
                     es.hull_slope.copy(), es.hull_rate.copy(),
                     es.hull_n.copy()))
        return ok

    monkeypatch.setattr(processor.TileCompressor,
                        "_run_t1_tile_native_enc", probe)
    rng = np.random.default_rng(5)
    arr = np.clip(cases.photo(96, 112) + rng.integers(-20, 21, (96, 112, 3)),
                  0, 255)
    grok_tpu_torch.compress(GrkImage.from_array(arr),
                            CompressParams(backend="native", **kw))
    (ok, need_dist, table, bands, npasses, rates, *hull), = seen
    assert ok and need_dist
    coded = np.flatnonzero(table.coded)
    jobs = []
    for b, y, x, h, w, orient, style, mb in table.cols[coded].tolist():
        jobs.append(backend.EncodeJob(
            bands[b][y:y + h, x:x + w], orient, CblkStyle(style),
            numbps_bound=mb, quant_delta=float(table.band_delta[b])))
    native.encode_batch_native(jobs)
    stride = rates.shape[1]   # the tile's rows hold scratch past npasses
    rates = np.where(np.arange(stride) < npasses[:, None], rates, 0)
    jr = np.zeros((len(jobs), stride), np.int32)
    jd = np.zeros((len(jobs), stride))
    for k, j in enumerate(jobs):
        jr[k, :len(j.passes)] = j.passes.rates
        jd[k, :len(j.passes)] = j.passes.dists
    assert np.array_equal(jr, rates[coded])
    assert np.array_equal([len(j.passes) for j in jobs], npasses[coded])
    got = _flat(jr, jd, npasses[coded])
    hp, hs, hr, hn = (h[coded] for h in hull)
    assert got == [list(zip(hp[k, :n].tolist(), hr[k, :n].tolist(),
                            hs[k, :n].tolist())) for k, n in enumerate(hn)]
    assert got == [list(zip(j.hull_pass_arr.tolist(),
                            j.hull_rate_arr.tolist(),
                            j.hull_slope_arr.tolist())) for j in jobs]
    assert got == _hulls(jr, jd, npasses[coded])
    assert sum(map(len, got)) > len(jobs)
