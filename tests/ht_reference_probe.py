"""Probes of grok_tpu's HT coders that the port's PERF.md and ROADMAP.md
quote, on the CPU:

1. how often the exact integer sum of squared magnitudes of a dense 64x64
   block, rounded once to float64, differs from numpy's float64 pairwise
   sum (grok_tpu's e0), by magnitude bits;
2. how often grok_tpu's device HT decoder disagrees with its native and
   Python decoders on segments of random bytes with a valid Scup;
3. whether grok_tpu's device and native HT encoders write the same bytes
   for 16-, 20- and 22-bit images, with and without layer rates.

    JAX_PLATFORMS=cpu python tests/ht_reference_probe.py
"""

import os
import sys

import numpy as np

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import torch_ht_cases as cases  # noqa: E402

import grok_tpu  # noqa: E402
from grok_tpu.ops.ht_decode import decode_cblks_ht_device  # noqa: E402
from grok_tpu.t1 import backend as bk  # noqa: E402
from grok_tpu.t1 import native  # noqa: E402
from grok_tpu.t1.ht import decode_cblk_ht  # noqa: E402


def e0_rounding(rng, trials=200):
    for bits in (20, 22, 24, 25):
        over = differ = 0
        for _ in range(trials):
            b = rng.integers(-(1 << bits) + 1, 1 << bits,
                             (64, 64)).astype(np.int32)
            exact = int((b.astype(np.int64) ** 2).sum())
            over += exact > 2 ** 53
            differ += float(exact) != float(
                (np.abs(b).astype(np.float64) ** 2).sum())
        print(f"e0, magnitudes below 2^{bits}: {over} of {trials} blocks "
              f"sum past 2^53, {differ} differ from numpy's sum")


def corrupt_decodes(rng, n=40):
    items = cases.corrupt(rng, [], n=n)
    dev = decode_cblks_ht_device(items)
    py = [decode_cblk_ht(d, h, w) for d, h, w in items]
    jobs = [bk.DecodeJob(d, [len(d)], 1, 20, h, w, 0, 0, ht=True)
            for d, h, w in items]
    native.ht_decode_batch_native(jobs)
    print(f"corrupt segments: device differs from Python on "
          f"{sum(not np.array_equal(a, b) for a, b in zip(dev, py))}, "
          f"from native on "
          f"{sum(not np.array_equal(a, j.out) for a, j in zip(dev, jobs))}"
          f"; Python differs from native on "
          f"{sum(not np.array_equal(b, j.out) for b, j in zip(py, jobs))}"
          f" of {n}")


def deep_encodes(rng):
    for prec in (16, 20, 22):
        arr = rng.integers(0, 1 << prec, (64, 64)).astype(np.int32)
        img = grok_tpu.GrkImage.from_array(arr)
        for c in img.comps:
            c.prec = prec
        for kw in ({}, {"numlayers": 3, "layer_rates": [40, 10, 2]}):
            out = [grok_tpu.compress(img, grok_tpu.CompressParams(
                ht=True, numresolution=2, backend=b, **kw))
                for b in ("device", "native")]
            print(f"{prec}-bit HT {kw or 'one layer'}: device and native "
                  f"bytes {'equal' if out[0] == out[1] else 'DIFFER'}")


if __name__ == "__main__":
    rng = np.random.default_rng(0)
    e0_rounding(rng)
    corrupt_decodes(rng)
    deep_encodes(rng)
