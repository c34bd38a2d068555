"""The port's colour post-processing after decode against grok_tpu's.

JP2 files with a palette, channel definitions, sYCC, eYCC, CIELAB, CMYK
(with force_rgb, and with an embedded CMYK profile), 8- and 16-bit ICC
matrix/TRC profiles, upsampling and precision overrides, built as
grok_tpu's own tests build them, decode through grok_tpu_torch.decompress
(backend="device" on device="cpu") to exactly what grok_tpu.decompress
gives: the post-processing is host numpy copied from grok_tpu, so no
tolerance.  The port's ICC evaluators (util/icc.py) are held to
grok_tpu's on seeded planes.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import grok_tpu  # noqa: E402
import grok_tpu_torch  # noqa: E402
from grok_tpu import CompressParams, DecompressParams, GrkImage  # noqa: E402
from grok_tpu.codestream import jp2 as jp2_mod  # noqa: E402
from grok_tpu.image import ColorSpace, ImageComponent, PaletteEntry  # noqa: E402,E501
from grok_tpu_torch.params import from_reference as port  # noqa: E402
from test_parity_gaps import _build_a2b0_profile  # noqa: E402


def _content(rng, h, w, ncomp=1):
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    planes = [128 + 90 * np.sin(xx / (11 + 3 * c)) * np.cos(yy / (7 + 2 * c))
              for c in range(ncomp)]
    arr = np.stack(planes, -1) if ncomp > 1 else planes[0]
    return (arr + rng.normal(0, 3, arr.shape)).clip(0, 255).astype(np.int32)


def _srgb_icc():
    from PIL import ImageCms

    return ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()


def _both(data, **kw):
    """grok_tpu's decode and the port's, with the same parameters."""
    ref = grok_tpu.decompress(data, DecompressParams(backend="native", **kw))
    ours = grok_tpu_torch.decompress(
        data, port(DecompressParams(backend="device", **kw)), device="cpu")
    return ref, ours


def _assert_same(ref, ours):
    assert ours.numcomps == ref.numcomps
    assert ours.color_space.value == ref.color_space.value
    assert (ours.meta.icc_profile is None) == (ref.meta.icc_profile is None)
    for a, b in zip(ours.comps, ref.comps):
        assert (a.prec, a.sgnd, a.dx, a.dy) == (b.prec, b.sgnd, b.dx, b.dy)
        assert a.data.dtype == b.data.dtype
        assert np.array_equal(a.data, b.data)


def _planar(planes, dxy, prec=8, sgnd=(), color_space=ColorSpace.SRGB):
    """An image of the given component planes and subsampling."""
    h = max(p.shape[0] * d[1] for p, d in zip(planes, dxy))
    w = max(p.shape[1] * d[0] for p, d in zip(planes, dxy))
    img = GrkImage(x0=0, y0=0, x1=w, y1=h, color_space=color_space)
    for i, (plane, (dx, dy)) in enumerate(zip(planes, dxy)):
        c = ImageComponent(dx=dx, dy=dy, prec=prec,
                           sgnd=i in sgnd)
        c.data = plane.astype(np.int32)
        c.h, c.w = plane.shape
        img.comps.append(c)
    return img


def _jp2(img, **kw):
    cs = grok_tpu.compress(img, CompressParams(backend="native", **kw))
    return jp2_mod.wrap_jp2(cs, img)


def _palette(rng):
    idx = rng.integers(0, 7, size=(32, 32)).astype(np.int32)
    img = GrkImage.from_array(idx, prec=8)
    cs = grok_tpu.compress(img, CompressParams(numresolution=2))
    lut = np.stack([np.arange(8) * 30, 255 - np.arange(8) * 30,
                    np.arange(8) * 10], axis=1).astype(np.int32)
    img.meta.palette = PaletteEntry(
        channel_prec=[8, 8, 8], channel_sgnd=[False] * 3, lut=lut,
        component_mapping=[(0, 1, 0), (0, 1, 1), (0, 1, 2)])
    return jp2_mod.wrap_jp2(cs, img), {}


def _cdef(rng):
    img = GrkImage.from_array(_content(rng, 32, 32, 3))
    cs = grok_tpu.compress(img, CompressParams(numresolution=2))
    img.meta.channel_definitions = [(0, 0, 3), (1, 0, 2), (2, 0, 1)]
    return jp2_mod.wrap_jp2(cs, img), {}


def _sycc(rng):
    h, w = 48, 64
    y = _content(rng, h, w)
    cb = rng.integers(100, 160, (h // 2, w // 2))
    cr = rng.integers(100, 160, (h // 2, w // 2))
    img = _planar([y, cb, cr], [(1, 1), (2, 2), (2, 2)],
                  color_space=ColorSpace.SYCC)
    return _jp2(img, numresolution=3), {}


def _eycc(rng):
    y = _content(rng, 32, 40)
    cb = rng.integers(-40, 40, (32, 40))
    cr = rng.integers(-40, 40, (32, 40))
    img = _planar([y, cb, cr], [(1, 1)] * 3, sgnd=(1, 2),
                  color_space=ColorSpace.EYCC)
    return _jp2(img, numresolution=2, mct=0), {}


def _cielab(rng):
    lab = rng.integers(16, 240, (32, 32, 3))
    img = GrkImage.from_array(lab.astype(np.int32), prec=8)
    img.color_space = ColorSpace.CIELAB
    return _jp2(img, numresolution=2, mct=0), {}


def _cmyk_force_rgb(rng):
    a = rng.integers(0, 256, (32, 40, 4)).astype(np.int32)
    img = GrkImage.from_array(a, prec=8)
    img.color_space = ColorSpace.CMYK
    return _jp2(img, numresolution=2), dict(force_rgb=True)


def _cmyk_icc_12bit(rng):
    a = rng.integers(0, 4096, (24, 24, 4)).astype(np.int32)
    img = GrkImage.from_array(a, prec=12)
    img.color_space = ColorSpace.CMYK
    img.meta.icc_profile = _build_a2b0_profile(grid=9, space=b"CMYK")
    return _jp2(img, numresolution=2), dict(apply_icc=True)


def _icc_8bit(rng):
    pytest.importorskip("PIL")
    img = GrkImage.from_array(rng.integers(0, 256, (32, 32, 3)).astype(
        np.int32))
    img.meta.icc_profile = _srgb_icc()
    return _jp2(img, numresolution=2), dict(apply_icc=True)


def _icc_16bit(rng):
    pytest.importorskip("PIL")
    img = GrkImage.from_array(rng.integers(0, 65536, (32, 32, 3)).astype(
        np.int32), prec=16)
    img.meta.icc_profile = _srgb_icc()
    return _jp2(img, numresolution=2), dict(apply_icc=True)


def _upsample(rng):
    y = _content(rng, 40, 48)
    u = rng.integers(0, 256, (20, 24))
    v = rng.integers(0, 256, (20, 48))
    img = _planar([y, u, v], [(1, 1), (2, 2), (1, 2)])
    return _jp2(img, numresolution=2, mct=0), dict(upsample=True)


def _precision(rng):
    img = GrkImage.from_array(_content(rng, 32, 32, 3))
    return _jp2(img, numresolution=2), dict(precision=[4, 12, 8])


def _gray_force_rgb(rng):
    img = GrkImage.from_array(_content(rng, 24, 40))
    return _jp2(img, numresolution=2), dict(force_rgb=True)


_FILES = {f.__name__[1:]: f for f in (
    _palette, _cdef, _sycc, _eycc, _cielab, _cmyk_force_rgb,
    _cmyk_icc_12bit, _icc_8bit, _icc_16bit, _upsample, _precision,
    _gray_force_rgb)}


@pytest.mark.parametrize("name", sorted(_FILES))
def test_decode_postprocessing_matches_reference(rng, name):
    data, kw = _FILES[name](rng)
    ref, ours = _both(data, **kw)
    _assert_same(ref, ours)


def test_palette_and_cdef_results(rng):
    """The post-processing did something: the palette expands the index
    plane, cdef reorders BGR to RGB (the values grok_tpu's own tests
    expect)."""
    data, _ = _palette(np.random.default_rng(3))
    _, ours = _both(data)
    assert ours.numcomps == 3 and ours.comps[0].data.max() > 7
    arr = _content(rng, 32, 32, 3)
    img = GrkImage.from_array(arr)
    cs = grok_tpu.compress(img, CompressParams(numresolution=2))
    img.meta.channel_definitions = [(0, 0, 3), (1, 0, 2), (2, 0, 1)]
    _, ours = _both(jp2_mod.wrap_jp2(cs, img))
    assert np.array_equal(ours.comps[0].data, arr[..., 2])


@pytest.mark.parametrize("prec", [8, 12, 16])
def test_icc_evaluators_match_reference(rng, prec):
    """util/icc.py's matrix/TRC and A2B0 LUT (mft1, mft2; XYZ and Lab
    PCS; RGB and CMYK) evaluators on seeded planes, against grok_tpu's."""
    from grok_tpu.util import icc as ref_icc
    from grok_tpu_torch.util import icc as our_icc

    mx = (1 << prec) - 1
    rgb = [rng.integers(0, mx + 1, (16, 20)).astype(np.int32)
           for _ in range(3)]
    cmyk = rgb + [rng.integers(0, mx + 1, (16, 20)).astype(np.int32)]
    profiles = [(_build_a2b0_profile(grid=9, pcs=pcs, kind=kind), rgb)
                for pcs in (b"XYZ ", b"Lab ") for kind in (b"mft1", b"mft2")]
    profiles.append((_build_a2b0_profile(grid=5, space=b"CMYK"), cmyk))
    try:
        profiles.append((_srgb_icc(), rgb))
    except ImportError:
        pass
    for prof, planes in profiles:
        want = ref_icc.profile_to_srgb(planes, prof, prec)
        got = our_icc.profile_to_srgb(planes, prof, prec)
        assert want is not None and got is not None
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
