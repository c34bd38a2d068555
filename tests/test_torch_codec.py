"""grok_tpu_torch.compress / decompress against grok_tpu: byte-identical
codestreams and exact decodes.

The port runs with backend="device" on device="cpu", where its wrappers
take their plain twins; grok_tpu runs its native host path (and, for the
small cases, its own JAX device path).  Both packages get the same image
and parameters: built with grok_tpu's classes, carried to the port's with
grok_tpu_torch.params.from_reference.  Every lossless case decodes
bit-exact; a rate-limited one decodes to grok_tpu's own native decode.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import grok_tpu  # noqa: E402
import grok_tpu_torch  # noqa: E402
from grok_tpu import CompressParams, DecompressParams, GrkImage  # noqa: E402
from grok_tpu.params import Progression, ProgressionChange  # noqa: E402
from grok_tpu_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from grok_tpu_torch.params import from_reference as port  # noqa: E402
from grok_tpu_torch.tile.processor import HOST_PATH_TILES  # noqa: E402


def _port_compress(img, **kw):
    """grok_tpu_torch.compress of grok_tpu's image and parameters, on the
    plain twins."""
    return grok_tpu_torch.compress(
        port(img), port(CompressParams(backend="device", **kw)),
        device="cpu")


def _port_decompress(data):
    return grok_tpu_torch.decompress(
        data, port(DecompressParams(backend="device")), device="cpu")


@pytest.fixture
def host_tiles():
    for k in HOST_PATH_TILES:
        HOST_PATH_TILES[k] = 0
    return HOST_PATH_TILES


def _roundtrip(arr, host_tiles, jax_device=False, lossless=True, **kw):
    """Port encode == grok_tpu native (and JAX device) encode; port decode
    exact (or, for rate-limited streams, equal to grok_tpu's native
    decode).  Returns the codestream."""
    img = GrkImage.from_array(arr)
    ours = _port_compress(img, **kw)
    assert ours == grok_tpu.compress(
        img, CompressParams(backend="native", **kw))
    if jax_device:
        assert ours == grok_tpu.compress(
            img, CompressParams(backend="device", **kw))
    out = _port_decompress(ours)
    if lossless:
        assert np.array_equal(out.to_array(), arr.astype(np.int32))
    else:
        ref = grok_tpu.decompress(ours, DecompressParams(backend="native"))
        assert np.array_equal(out.to_array(), ref.to_array())
    return ours


def _smooth_rgb(rng, h, w):
    """Smooth ramps plus noise: content whose rate targets bite."""
    y, x = np.mgrid[0:h, 0:w]
    planes = [(x * (c + 1) + y * (3 - c)) * 255 // (4 * (h + w))
              for c in range(3)]
    arr = np.stack(planes, -1) + rng.normal(0, 3, (h, w, 3))
    return arr.clip(0, 255).astype(np.int32)


_POC = [ProgressionChange(0, 0, 1, 2, 3, Progression.RLCP),
        ProgressionChange(2, 0, 1, 3, 3, Progression.CPRL)]

# every option branch the port's copy of compress_codestream carries;
# `lossless` False where a rate target truncates the stream
_OPTIONS = {
    "tlm": (dict(tlm=True, tile_size=(32, 32)), True),
    "plm": (dict(plm=True, numlayers=2, layer_rates=[10, 1]), True),
    "plt": (dict(plt=True, tile_size=(32, 32)), True),
    "ppm": (dict(ppm=True, tile_size=(32, 32)), True),
    "ppt": (dict(ppt=True), True),
    "sop_eph": (dict(sop=True, eph=True), True),
    "layer_rates": (dict(numlayers=3, layer_rates=[40, 10, 4]), False),
    "layer_psnr": (dict(numlayers=2, layer_psnr=[30.0, 40.0]), False),
    "tile_parts_R": (dict(new_tile_part_progression="R", tlm=True), True),
    "tile_parts_L": (dict(new_tile_part_progression="L", numlayers=2,
                          layer_rates=[10, 1], plm=True), True),
    "tile_parts_C": (dict(new_tile_part_progression="C", plt=True), True),
    "poc": (dict(progression_changes=_POC), True),
    "tile_poc": (dict(tile_size=(32, 32), progression_changes=_POC,
                      tile_progression_changes={1: _POC[:1]}), True),
    "comments": (dict(comment=["first", "second"]), True),
    "no_comment": (dict(comment=None), True),
    "crg": (dict(comp_registration=[(0, 0), (32768, 0), (0, 32768)]), True),
    "custom_mct": (dict(irreversible=True, custom_mct=np.array(
        [[0.5, 0.3, 0.2], [-0.4, 0.8, -0.4], [0.1, -0.6, 0.5]])), False),
    "cap_quota": (dict(max_cs_size=3000, rate_quota=True, tlm=True,
                       plt=True), False),
    "cap_ppm": (dict(max_cs_size=3000, ppm=True, eph=True,
                     tile_size=(32, 32)), False),
    "cap_sop_plm": (dict(max_cs_size=3000, sop=True, eph=True, plm=True,
                         tile_size=(32, 32)), False),
}


@pytest.mark.parametrize("name", list(_OPTIONS))
def test_codestream_options_match_native(rng, host_tiles, name):
    """Each marker, tile-part, progression and rate option of
    compress_codestream writes grok_tpu's native bytes through the port."""
    kw, lossless = _OPTIONS[name]
    _roundtrip(_smooth_rgb(rng, 64, 64), host_tiles, lossless=lossless,
               numresolution=3, **kw)
    irreversible = kw.get("irreversible", False)
    assert (host_tiles["encode"] > 0) == irreversible


def test_rgb_64_matches_native_and_jax_device(rng, host_tiles):
    """tests/test_device_ops.py test_codec_device_backend_matches_native,
    through the port."""
    arr = rng.integers(0, 256, size=(64, 64, 3)).astype(np.int32)
    _roundtrip(arr, host_tiles, jax_device=True, numresolution=3)
    assert host_tiles == {"encode": 0, "decode": 0}


def test_config1_gray_512(host_tiles):
    """BASELINE config 1: bench.py's 512x512 8-bit gray, 6 resolutions."""
    from bench import make_image

    _roundtrip(make_image(), host_tiles)
    assert host_tiles == {"encode": 0, "decode": 0}


def test_tiled_rgb_batched(rng, host_tiles):
    """16 uniform 64x64 tiles go through the batched drivers; matches the
    JAX device path too."""
    arr = rng.integers(0, 256, size=(256, 256, 3)).astype(np.int32)
    _roundtrip(arr, host_tiles, jax_device=True, numresolution=3,
               tile_size=(64, 64))
    assert host_tiles == {"encode": 0, "decode": 0}


def test_ht_and_jp2(rng, host_tiles):
    arr = rng.integers(0, 4096, size=(48, 80, 3)).astype(np.uint16)
    img = GrkImage.from_array(arr, prec=12)
    kw = dict(numresolution=4, ht=True, cod_format="jp2")
    ours = _port_compress(img, **kw)
    assert ours[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n"
    assert ours == grok_tpu.compress(
        img, CompressParams(backend="native", **kw))
    out = _port_decompress(ours)
    assert np.array_equal(out.to_array(), arr.astype(np.int32))
    assert grok_tpu_torch.read_header(ours).image.numcomps == 3


def test_signed_four_components(rng, host_tiles):
    """Signed samples; a fourth component skips the RCT."""
    arr = rng.integers(-512, 512, size=(40, 36, 4)).astype(np.int32)
    _roundtrip(arr, host_tiles, numresolution=3)
    assert host_tiles == {"encode": 0, "decode": 0}


def test_odd_origin_takes_host_path(rng, host_tiles):
    """Tiles at an odd canvas origin are not device-eligible: they take
    the host path, are counted, and the bytes still match."""
    arr = rng.integers(0, 256, size=(50, 60, 3)).astype(np.uint8)
    img = GrkImage.from_array(arr, offset=(3, 5))
    ours = _port_compress(img, numresolution=3)
    assert ours == grok_tpu.compress(
        img, CompressParams(backend="native", numresolution=3))
    out = _port_decompress(ours)
    assert np.array_equal(out.to_array(), arr.astype(np.int32))
    assert host_tiles["encode"] == 1 and host_tiles["decode"] == 1


def _config2(h, w):
    """bench.py config2's content (BASELINE config 2: RGB, 9/7 + ICT,
    rate-targeted) at h x w."""
    rng2 = np.random.default_rng(1)
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    rgb = np.stack([128 + 90 * np.sin(xx / 23) * np.cos(yy / 17),
                    128 + 80 * np.sin(xx / 15),
                    128 + 80 * np.cos(yy / 19)], -1)
    return (rgb + rng2.normal(0, 3, rgb.shape)).clip(0, 255).astype(np.int32)


@pytest.fixture
def ref_mq_native(monkeypatch):
    """grok_tpu's device route with its MQ Tier-1 on its native coder: its
    device MQ coders, byte-identical to the native coder
    (tests/test_torch_mq.py), compile for tens of seconds under JAX on the
    CPU.  Its device transforms stay."""
    from grok_tpu.t1 import backend as ref_backend

    monkeypatch.setattr(ref_backend, "_encode_mq_device", lambda jobs: jobs)
    monkeypatch.setattr(ref_backend, "_decode_mq_device", lambda jobs: jobs)


# (name, image shape, CompressParams keywords, whether to decode with
# grok_tpu's device route too: once is enough, each decode compiles)
LOSSY_CASES = [
    ("config2_96x80", (80, 96), dict(numresolution=5, layer_rates=[20]),
     True),
    ("layers", (48, 64), dict(numresolution=4, layer_rates=[40, 10, 1]),
     False),
    ("tiles", (128, 128), dict(numresolution=3, tile_size=(64, 64),
                               layer_rates=[20]), False),
]


@pytest.mark.parametrize("name,shape,kw,jax_decode", LOSSY_CASES,
                         ids=[c[0] for c in LOSSY_CASES])
def test_lossy_runs_on_device_route(host_tiles, ref_mq_native, name, shape,
                                    kw, jax_decode):
    """The 9/7 + ICT path runs on the port's device route (its twins on
    the CPU): the codestream equals grok_tpu's device and native routes'
    byte for byte; the decode equals grok_tpu's native decode (the same
    arithmetic, each operation rounded as written) and is within 1 of its
    device decode (XLA contracts some of the jitted 9/7's multiply-adds);
    no tile takes the host path."""
    img = GrkImage.from_array(_config2(*shape))
    kw = dict(irreversible=True, **kw)
    ours = _port_compress(img, **kw)
    assert ours == grok_tpu.compress(img, CompressParams(backend="device",
                                                         **kw))
    assert ours == grok_tpu.compress(img, CompressParams(backend="native",
                                                         **kw))
    out = _port_decompress(ours).to_array()
    assert np.array_equal(out, grok_tpu.decompress(
        ours, DecompressParams(backend="native")).to_array())
    if jax_decode:
        dev = grok_tpu.decompress(ours, DecompressParams(backend="device"))
        assert np.abs(out - dev.to_array()).max() <= 1
    assert host_tiles == {"encode": 0, "decode": 0}


def test_lossy_odd_origin_takes_host_path(host_tiles):
    """A lossy tile at an odd canvas origin is not device-eligible: it takes
    the host path, is counted, and still writes and decodes grok_tpu's
    native bytes."""
    img = GrkImage.from_array(_config2(50, 60), offset=(3, 5))
    kw = dict(numresolution=3, irreversible=True, layer_rates=[20])
    ours = _port_compress(img, **kw)
    assert ours == grok_tpu.compress(img, CompressParams(backend="native",
                                                         **kw))
    assert np.array_equal(_port_decompress(ours).to_array(),
                          grok_tpu.decompress(ours, DecompressParams(
                              backend="native")).to_array())
    assert host_tiles == {"encode": 1, "decode": 1}


def test_host_backend_and_launch_counts(rng, host_tiles):
    """backend="native" needs no device at all; CPU runs launch no
    kernel."""
    reset_launches()
    arr = rng.integers(0, 256, size=(32, 32)).astype(np.uint8)
    _roundtrip(arr, host_tiles, numresolution=3)
    img = GrkImage.from_array(arr)
    assert grok_tpu_torch.compress(
        port(img), port(CompressParams(backend="native", numresolution=3))) \
        == grok_tpu.compress(img, CompressParams(backend="native",
                                                 numresolution=3))
    assert all(v == 0 for v in LAUNCHES.values())
