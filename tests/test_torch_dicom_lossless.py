"""One-component lossless images deeper than 8 bits through the port's
plain route (device="cpu"), judged by the benchmark's own reference
(codec_bench/reference/judge.py): a 16-bit frame with odd edges under
the DICOM JPEG 2000 lossless configuration (reversible 5/3, MQ, every
pass kept) and a 12-bit CT slice under the HTJ2K lossless one.  Each
decodes exactly, its code-blocks hold the plain forward transform to the
last bit, and the judge's control (the 5/3 in float32, rounded to
nearest) reads above 0, so the comparison is tight enough to catch it."""

import numpy as np
import pytest

import grok_tpu_torch
from codec_bench.core import manifest
from codec_bench.core import traffic as gen
from codec_bench.reference.codestream import read_codestream
from codec_bench.reference.judge import judge_window
from grok_tpu_torch.t1 import backend

# (configuration, traffic mix, height, width)
CASES = [("dicom_j2k_lossless", "ffdm", 203, 137),
         ("htj2k_lossless", "ct512", 128, 128)]


@pytest.mark.parametrize("config, mix_name, h, w", CASES,
                         ids=[c[1] for c in CASES])
def test_lossless_deep_one_component_judged(config, mix_name, h, w):
    mix = dict(manifest.traffic(mix_name), height=h, width=w)
    img = gen.make_image(mix, gen.frame_seed(20261018, 0))
    prec = mix["precision"]
    assert img.ndim == 2 and int(img.max()) >= 1 << (prec - 2)
    params = manifest.config(config)["params"]
    counts = backend.DEVICE_CODEBLOCKS
    before = dict(counts)
    cs = grok_tpu_torch.compress(
        grok_tpu_torch.GrkImage.from_array(img, prec=prec),
        grok_tpu_torch.CompressParams(**params), device="cpu")
    out = grok_tpu_torch.decompress(cs, device="cpu").to_array()
    moved = {k: counts[k] - before[k] for k in counts}
    frames = [(0, cs, out)]
    seq = np.random.SeedSequence([7, 1])
    nums = judge_window(frames, [img], params, seq, 1, 4, 16)
    assert nums == {"repeat_mismatch": 0, "decode_mismatch": 0,
                    "enc_mismatch": 0.0}, nums
    ctl = judge_window(frames, [img], params, seq, 1, 4, 16, control=True)
    assert ctl["enc_mismatch"] > 0, ctl
    hdr, tiles = read_codestream(cs)
    blocks = [b for t in tiles for band in t.bands.values()
              for b in band.blocks]
    assert max(b.numbps for b in blocks) >= prec - 1
    if params.get("ht"):
        assert moved["mq_encode_device"] == moved["mq_encode_passes"] == 0
        assert moved["decode_device"] == moved["encode_device"] > 0
    else:
        # every pass of every block is kept, and every block codes on the
        # device route: the passes it counts are the codestream's
        assert moved["mq_encode_device"] == len(blocks)
        assert moved["mq_encode_passes"] == sum(b.passes for b in blocks)
        # the one tile codes as a flat batch each way
        assert moved["mq_encode_flat"] == moved["mq_encode_device"]
        assert moved["mq_decode_flat"] == moved["mq_decode_device"]
        # decode takes shape groups of 8 or more to the device route
        assert moved["mq_decode_device"] + moved["mq_decode_host"] == \
            len(blocks)
        assert moved["mq_decode_passes"] <= moved["mq_encode_passes"]
        assert (moved["mq_decode_passes"] > 0) == \
            (moved["mq_decode_device"] > 0)
        assert moved["encode_device"] == 0
