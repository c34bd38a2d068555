"""The port's strip, file and stream codec variants against grok_tpu's.

The port runs with backend="device" on device="cpu" (its kernels' plain
twins, the strip encode's row-batched analysis and the strip decode's
deferred synthesis included); grok_tpu runs its native host path.  Both
get the same image and parameters (grok_tpu's classes, carried over with
grok_tpu_torch.params.from_reference).  Codestreams must be byte-identical
and decodes equal plane for plane: no tolerance, since these paths are
integer or copy the reference's float64 numpy.
"""

import io

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import grok_tpu  # noqa: E402
import grok_tpu_torch  # noqa: E402
from grok_tpu import CompressParams, DecompressParams, GrkImage  # noqa: E402
from grok_tpu.errors import ParamError  # noqa: E402
from grok_tpu.image import ImageComponent  # noqa: E402
from grok_tpu.params import Progression  # noqa: E402
from grok_tpu_torch import errors as port_errors  # noqa: E402
from grok_tpu_torch.codestream import decompress as port_dec  # noqa: E402
from grok_tpu_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from grok_tpu_torch.params import from_reference as port  # noqa: E402
from grok_tpu_torch.tile import processor as port_proc  # noqa: E402


def _content(rng, h, w, ncomp=3):
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    base = 128 + 90 * np.sin(xx / 19) * np.cos(yy / 13)
    arr = base[..., None] + rng.normal(0, 8, (h, w, ncomp))
    return arr.clip(0, 255).astype(np.uint8)


def _meta_of(img: GrkImage) -> GrkImage:
    m = GrkImage(x0=img.x0, y0=img.y0, x1=img.x1, y1=img.y1)
    m.color_space = img.color_space
    for c in img.comps:
        c2 = c.copy()
        c2.data = None
        m.comps.append(c2)
    return m


def _reader_of(img: GrkImage):
    planes = [c.data for c in img.comps]
    calls = []

    def reader(y0, h):
        calls.append((y0, h))
        out = []
        for c, pl in zip(img.comps, planes):
            r0 = -(-y0 // c.dy) - c.y0
            r1 = -(-(y0 + h) // c.dy) - c.y0
            out.append(pl[r0:r1])
        return out

    reader.calls = calls
    return reader


def _ours(**kw):
    return port(CompressParams(backend="device", **kw))


def _theirs(**kw):
    return CompressParams(backend="native", **kw)


def _same_strips(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for (ya, pa), (yb, pb) in zip(a, b):
        assert ya == yb
        assert sorted(pa) == sorted(pb)
        for k in pa:
            assert np.array_equal(pa[k], pb[k]), (ya, k)


# MQ, HT and lossy 9/7, each in a grid of tiles whose last row and column
# are partial, with the options the strip encode treats apart
_CASES = {
    "mq": dict(numresolution=3, tile_size=(32, 24)),
    "mq-layers-plt": dict(numresolution=3, tile_size=(40, 32),
                          layer_rates=[20, 4], plt=True),
    "ht-tlm-plt": dict(numresolution=3, tile_size=(32, 32), ht=True,
                       tlm=True, plt=True),
    "ht-cap": dict(numresolution=3, tile_size=(48, 40), ht=True,
                   max_cs_size=3000, plt=True),
    "lossy-97": dict(numresolution=3, tile_size=(32, 32), irreversible=True),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_compress_strips_matches_reference(rng, name):
    """compress_strips: one reader call a tile row, bytes identical to
    grok_tpu's compress_strips and to the port's own whole-image
    compress."""
    kw = _CASES[name]
    arr = _content(rng, 48, 40)
    img = GrkImage.from_array(arr)
    ref = grok_tpu.compress_strips(_meta_of(img), _reader_of(img),
                                   _theirs(**kw))
    reader = _reader_of(img)
    reset_launches()
    ours = grok_tpu_torch.compress_strips(port(_meta_of(img)), reader,
                                          _ours(**kw), device="cpu")
    assert ours == ref
    assert len(reader.calls) == -(-48 // kw["tile_size"][1])
    assert all(v == 0 for v in LAUNCHES.values())  # twins, not kernels
    assert grok_tpu_torch.compress(port(img), _ours(**kw),
                                   device="cpu") == ref


def test_compress_strips_subsampled_offset_image(rng):
    """A canvas offset and 4:2:0 components: each strip is read at the
    component's own subsampling."""
    w, h = 46, 38
    img = GrkImage(x0=3, y0=5, x1=3 + w, y1=5 + h)
    for dx, dy in [(1, 1), (2, 2), (2, 2)]:
        cw = -(-(3 + w) // dx) - (-(-3 // dx))
        ch = -(-(5 + h) // dy) - (-(-5 // dy))
        c = ImageComponent(dx=dx, dy=dy, prec=8, sgnd=False)
        c.data = rng.integers(0, 256, (ch, cw)).astype(np.int32)
        c.h, c.w = ch, cw
        c.x0 = -(-3 // dx)
        c.y0 = -(-5 // dy)
        img.comps.append(c)
    for kw in [dict(numresolution=3, tile_size=(32, 24), tile_offset=(2, 4)),
               dict(numresolution=3, tile_size=(32, 32), mct=0,
                    irreversible=True, ht=True)]:
        ref = grok_tpu.compress(img, _theirs(**kw))
        ours = grok_tpu_torch.compress_strips(
            port(_meta_of(img)), _reader_of(img), _ours(**kw), device="cpu")
        assert ours == ref, kw
        back = grok_tpu_torch.decompress(
            ours, port(DecompressParams(backend="device")), device="cpu")
        want = grok_tpu.decompress(ref, DecompressParams(backend="native"))
        for a, b in zip(back.comps, want.comps):
            assert np.array_equal(a.data, b.data)


def test_strips_file_tlm_seekback_outer_progression(rng, tmp_path):
    """compress_strips_file under CPRL with -u R: many tile-parts a tile,
    the TLM index patched by seek-back with a COM filler, byte for byte
    grok_tpu's file, and the index names every tile-part up to EOC."""
    from grok_tpu.codestream import markers as mk

    arr = _content(rng, 96, 96, ncomp=1)[..., 0]
    img = GrkImage.from_array(arr)

    def params(make):
        p = make(numresolution=3, tile_size=(32, 32), tlm=True, plt=True,
                 ht=True, new_tile_part_progression="R")
        p.prog_order = port(Progression.CPRL) if make is _ours \
            else Progression.CPRL
        p.precincts = [(8, 8)]
        return p

    theirs, ours = tmp_path / "ref.j2k", tmp_path / "ours.j2k"
    n_ref = grok_tpu.compress_strips_file(_meta_of(img), _reader_of(img),
                                          str(theirs), params(_theirs))
    n = grok_tpu_torch.compress_strips_file(
        port(_meta_of(img)), _reader_of(img), str(ours), params(_ours),
        device="cpu")
    data = ours.read_bytes()
    assert (n, data) == (n_ref, theirs.read_bytes())
    pos, entries = 2, []
    while pos + 4 <= len(data):
        m = int.from_bytes(data[pos:pos + 2], "big")
        ln = int.from_bytes(data[pos + 2:pos + 4], "big")
        if m == mk.TLM:
            entries += mk.read_tlm(data[pos + 4:pos + 2 + ln])[1]
        if m == mk.SOT:
            break
        pos += 2 + ln
    assert len(entries) > 9
    for _, ln in entries:
        assert data[pos:pos + 2] == mk.u16(mk.SOT)
        pos += ln
    assert data[pos:pos + 2] == mk.u16(mk.EOC)
    # the in-memory stream differs only by the filler: same decode
    a = grok_tpu_torch.decompress_file(str(ours), port(DecompressParams(backend="device")),
                                       device="cpu")
    assert np.array_equal(a.comps[0].data, arr)


def test_strips_file_jp2_and_ppm_plm_rejected(rng, tmp_path):
    """A JP2 sink (jp2c box to end of file) equals grok_tpu's file; PPM
    and PLM with a sink are refused by both packages."""
    arr = _content(rng, 40, 48)
    img = GrkImage.from_array(arr)
    kw = dict(numresolution=2, tile_size=(32, 32), tlm=True, ht=True,
              cod_format="jp2")
    grok_tpu.compress_strips_file(_meta_of(img), _reader_of(img),
                                  str(tmp_path / "r.jp2"), _theirs(**kw))
    grok_tpu_torch.compress_strips_file(
        port(_meta_of(img)), _reader_of(img), str(tmp_path / "o.jp2"),
        _ours(**kw), device="cpu")
    assert (tmp_path / "o.jp2").read_bytes() == \
        (tmp_path / "r.jp2").read_bytes()
    for bad in (dict(ppm=True), dict(plm=True)):
        with pytest.raises(ParamError):
            grok_tpu.compress_strips_file(
                _meta_of(img), _reader_of(img), str(tmp_path / "x.j2k"),
                _theirs(tile_size=(32, 32), **bad))
        with pytest.raises(port_errors.ParamError):
            grok_tpu_torch.compress_strips_file(
                port(_meta_of(img)), _reader_of(img),
                str(tmp_path / "y.j2k"), _ours(tile_size=(32, 32), **bad),
                device="cpu")
    # a reader returning the wrong shape, and a compress without data
    with pytest.raises(port_errors.ParamError):
        grok_tpu_torch.compress_strips(
            port(_meta_of(img)),
            lambda y0, h: [np.zeros((1, 1), np.int32)] * 3,
            _ours(tile_size=(32, 32)), device="cpu")
    with pytest.raises(port_errors.ParamError):
        grok_tpu_torch.compress(port(_meta_of(img)), _ours(), device="cpu")


def test_com_filler_matches_reference():
    from grok_tpu.codestream.compress import _com_filler as ref
    from grok_tpu_torch.codestream.compress import _com_filler

    for n in (0, 6, 100, 65537, 65538, 65543, 200000):
        assert _com_filler(n) == ref(n)


@pytest.fixture(scope="module")
def tiled_stream():
    """An HT stream of 3x3 tiles with partial ones, and an MQ one."""
    rng = np.random.default_rng(7)
    arr = _content(rng, 72, 56)
    ht = grok_tpu.compress(GrkImage.from_array(arr), _theirs(
        numresolution=3, tile_size=(32, 32), ht=True, tlm=True, plt=True))
    mq = grok_tpu.compress(GrkImage.from_array(arr[:40, :40]), _theirs(
        numresolution=2, tile_size=(32, 24)))
    return arr, ht, mq


def test_decompress_strips_matches_reference(tiled_stream):
    """Tile-row strips (the port deferring each tile's synthesis; HT and
    MQ) and strip_height strips (window decodes on the host path) equal
    grok_tpu's strip for strip, with and without the header's parsed
    state."""
    arr, data, mq = tiled_stream
    dp = port(DecompressParams(backend="device"))
    _same_strips(grok_tpu_torch.decompress_strips(mq, dp, device="cpu"),
                 grok_tpu.decompress_strips(
                     mq, DecompressParams(backend="native")))
    ref = list(grok_tpu.decompress_strips(
        data, DecompressParams(backend="native")))
    _same_strips(grok_tpu_torch.decompress_strips(data, dp, device="cpu"),
                 ref)
    hi = grok_tpu_torch.read_header(data)
    assert isinstance(hi._decoder, port_dec.CodestreamDecoder)
    _same_strips(grok_tpu_torch.decompress_strips(
        data, dp, header=hi, device="cpu"), ref)
    for k in port_proc.HOST_PATH_TILES:
        port_proc.HOST_PATH_TILES[k] = 0
    _same_strips(grok_tpu_torch.decompress_strips(
        data, dp, strip_height=20, device="cpu"),
        grok_tpu.decompress_strips(data, DecompressParams(backend="native"),
                                   strip_height=20))
    assert port_proc.HOST_PATH_TILES["decode"] > 0  # windows: host path
    with pytest.raises(ValueError):
        next(grok_tpu_torch.decompress_strips(data, dp, strip_height=0,
                                              device="cpu"))


def test_file_and_stream_variants(tiled_stream, tmp_path):
    """decompress_file (a read-only mmap), decompress_stream (a reader
    and a buffer), compress_file and compress_stream against grok_tpu."""
    arr, ht, _ = tiled_stream
    path = tmp_path / "s.j2k"
    path.write_bytes(ht)
    dp = port(DecompressParams(backend="device"))
    want = grok_tpu.decompress_file(str(path),
                                    DecompressParams(backend="native"))
    for got in (grok_tpu_torch.decompress_file(str(path), dp, device="cpu"),
                grok_tpu_torch.decompress_stream(io.BytesIO(ht), dp,
                                                 device="cpu"),
                grok_tpu_torch.decompress_stream(memoryview(ht), dp,
                                                 device="cpu")):
        assert np.array_equal(got.to_array(), want.to_array())
        assert np.array_equal(got.to_array(), arr.astype(np.int32))
    img = GrkImage.from_array(arr)
    kw = dict(numresolution=3, tile_size=(32, 32), ht=True, tlm=True,
              plt=True)
    n = grok_tpu_torch.compress_file(port(img), str(tmp_path / "o.j2k"),
                                     _ours(**kw), device="cpu")
    assert (tmp_path / "o.j2k").read_bytes() == ht and n == len(ht)
    buf = io.BytesIO()
    assert grok_tpu_torch.compress_stream(port(img), buf, _ours(**kw),
                                          device="cpu") == len(ht)
    assert buf.getvalue() == ht


def test_deferred_planes_on_the_cpu(tiled_stream):
    """With device="cpu" a deferred tile is a _PendingTile over a
    DeferredPlanes holding the computed planes; finish() returns what the
    undeferred decode returns, and fills the cache."""
    from grok_tpu_torch.util.caches import TileCache

    arr, ht, _ = tiled_stream
    dec = port_dec.CodestreamDecoder(ht, device=port_proc.torch.device(
        "cpu"))
    dec.parse()
    img = dec._build_image_template()
    p = port(DecompressParams(backend="device"))
    cache = TileCache()
    pend = dec.decode_tile_planes(0, p, img, 0, cache=cache, defer=True)
    assert isinstance(pend, port_dec._PendingTile)
    assert isinstance(pend.planes, port_proc.DeferredPlanes)
    planes, rects = pend.finish()
    again, rects2 = dec.decode_tile_planes(0, p, img, 0)
    assert rects == rects2
    assert all(np.array_equal(a, b) for a, b in zip(planes, again))
    assert np.array_equal(np.stack(planes, -1), arr[:32, :32])
    hit = cache.get(cache.key(0, 0, p.max_layers, dec._stream_id()))
    assert hit is not None and np.array_equal(hit[0][0], planes[0])


def test_variant_names_and_msg_handlers(rng):
    """The port exports grok_tpu's eleven codec names; set_msg_handlers
    routes the port's own log records."""
    import logging

    assert grok_tpu_torch._CODEC_API == grok_tpu._CODEC_API
    for name in grok_tpu._CODEC_API:
        assert callable(getattr(grok_tpu_torch, name))
    got = {"info": [], "warn": [], "error": []}
    grok_tpu_torch.set_msg_handlers(info=got["info"].append,
                                    warn=got["warn"].append,
                                    error=got["error"].append)
    try:
        log = logging.getLogger("grok_tpu_torch")
        log.warning("w1")
        log.error("e1")
        log.info("i1")
        assert got == {"info": ["i1"], "warn": ["w1"], "error": ["e1"]}
        grok_tpu_torch.set_msg_handlers()  # replaces, not stacks
        assert len(log.handlers) == 1
    finally:
        log = logging.getLogger("grok_tpu_torch")
        for h in list(log.handlers):
            log.removeHandler(h)
        log.setLevel(logging.NOTSET)


def test_row_strips_paste_as_grok_tpu_assembles():
    """The strip decode pastes each tile plane into its row strip as it
    is read; the strips equal grok_tpu's assembly (the bounding box of
    the planes present, pasted in order, zeros elsewhere) for full rows,
    rows with missing tiles, planes off the row's rows and planes beyond
    the canvas columns."""
    from grok_tpu_torch.tile.geometry import Rect

    rng = np.random.default_rng(9)

    def plane(r):
        return rng.integers(0, 1 << 16, (r.h, r.w)).astype(np.int32)

    full = [Rect(x, 8, min(x + 16, 50), 24) for x in range(2, 50, 16)]
    rows = [
        full,
        full[1:3],                                 # missing tiles
        full[:1] + full[2:],                       # a gap
        full[:2] + [Rect(34, 10, 50, 20)] + full[3:],  # off the rows
        [Rect(0, 8, 10, 24)] + full,              # beyond the canvas
        full[:2] + [Rect(20, 8, 40, 24)],          # overlapping
    ]
    for rects in rows:
        pieces = [(r, plane(r)) for r in rects]
        row = port_dec._RowStrips({0: (2, 50)})
        for r, pl in pieces:
            row.add(0, r, pl)
        got = row.strips()
        assert list(got) == [0]
        assert np.array_equal(got[0], port_dec._assemble(pieces)), rects
        assert got[0].flags.c_contiguous
        assert row.strips() == {}


def test_strip_decode_of_a_truncated_stream(tiled_stream):
    """A stream cut inside its last tile row: tolerant strip decodes equal
    grok_tpu's strip for strip."""
    _, ht, _ = tiled_stream
    cut = ht[:len(ht) * 4 // 5]
    ref = list(grok_tpu.decompress_strips(
        cut, DecompressParams(backend="native")))
    _same_strips(grok_tpu_torch.decompress_strips(
        cut, port(DecompressParams(backend="device")), device="cpu"), ref)
