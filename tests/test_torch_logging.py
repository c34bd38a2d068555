"""The port's tile warnings reach the port's own logger, "grok_tpu_torch",
and not grok_tpu's (ROADMAP C11)."""

import logging

import numpy as np

import grok_tpu_torch
from grok_tpu_torch import CompressParams, DecompressParams, GrkImage


def test_tile_warning_goes_to_the_port_logger(caplog):
    """A packet whose SOP marker is destroyed decodes tolerantly (SOP
    resync) and warns under "grok_tpu_torch"."""
    rng = np.random.default_rng(5)
    y, x = np.mgrid[0:128, 0:128]
    arr = ((x * 2 + y) % 256 + rng.integers(0, 9, (128, 128))).clip(
        0, 255).astype(np.uint8)
    data = grok_tpu_torch.compress(
        GrkImage.from_array(arr),
        CompressParams(numresolution=1, sop=True, eph=True,
                       precincts=[(32, 32)], backend="native"),
        device="cpu")
    sop3 = data.find(b"\xff\x91\x00\x04\x00\x03")
    assert sop3 > 0
    ba = bytearray(data)
    ba[sop3:sop3 + 6] = b"\x00" * 6
    with caplog.at_level(logging.WARNING):
        out = grok_tpu_torch.decompress(bytes(ba),
                                        DecompressParams(backend="native"),
                                        device="cpu")
    # precinct 3 is lost; those before and after it decode
    for y0, x0 in ((0, 0), (32, 0)):
        assert np.array_equal(out.to_array()[y0:y0 + 32, x0:x0 + 32],
                              arr[y0:y0 + 32, x0:x0 + 32])
    names = {r.name for r in caplog.records if "parse error" in r.message}
    assert names == {"grok_tpu_torch"}
    assert not [r for r in caplog.records if r.name == "grok_tpu"]
