"""Probe of grok_tpu's MQ decoders on corrupt streams, which the port's
ROADMAP.md (C9) and PERF.md quote, on the CPU: how often grok_tpu's device
MQ decoder (ops/mq_decode.py decode_cblks_mq_device) disagrees with its
Python (t1/coder.py decode_cblk) and native decoders on segments of random
bytes, truncated segments, and segment lengths that reach past the block's
bytes (each shape group decoded as the device router batches it).

    JAX_PLATFORMS=cpu python tests/mq_reference_probe.py
"""

import os
import sys

import numpy as np

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import torch_mq_cases as cases  # noqa: E402

from grok_tpu.ops.mq_decode import decode_cblks_mq_device  # noqa: E402
from grok_tpu.params import CblkStyle  # noqa: E402
from grok_tpu.t1 import backend as bk  # noqa: E402
from grok_tpu.t1 import native  # noqa: E402
from grok_tpu.t1.coder import decode_cblk  # noqa: E402


def _ref(it):
    return (it[0], list(it[1]), it[2], it[3], it[4], it[5], it[6],
            CblkStyle(int(it[7])))


def reference_decodes(items):
    """(device, Python, native) decodes of items, the device one a call a
    shape group, as grok_tpu's router makes them."""
    items = [_ref(it) for it in items]
    groups: dict = {}
    for k, it in enumerate(items):
        groups.setdefault((it[4], it[5]), []).append(k)
    dev = [None] * len(items)
    for idx in groups.values():
        for k, o in zip(idx, decode_cblks_mq_device([items[k]
                                                      for k in idx])):
            dev[k] = np.asarray(o)
    py = [decode_cblk(*it) for it in items]
    jobs = [bk.DecodeJob(*it) for it in items]
    native.decode_batch_native(jobs)
    return dev, py, [j.out for j in jobs]


def kinds(rng):
    """The probe's populations: (name, items)."""
    blocks = cases.mixed_blocks(rng, 32)
    styles = [cases.STYLES[k % 2] for k in range(len(blocks))]
    valid = cases.dec_items(rng, blocks, styles)
    bad = cases.corrupt_items(rng, valid, n=48)
    rand = bad[:48]
    rest = bad[48:]
    return [("valid and pass-capped", valid), ("random bytes", rand),
            ("truncated", [it for k, it in enumerate(rest) if k % 5 < 3]),
            ("lengths past the bytes",
             [it for k, it in enumerate(rest) if k % 5 == 3]),
            ("missing segments", [it for k, it in enumerate(rest)
                                  if k % 5 == 4])]


def main():
    rng = np.random.default_rng(20261017)
    for name, items in kinds(rng):
        dev, py, nat = reference_decodes(items)
        n = len(items)
        print(f"{name}: device differs from Python on "
              f"{sum(not np.array_equal(a, b) for a, b in zip(dev, py))}, "
              f"from native on "
              f"{sum(not np.array_equal(a, b) for a, b in zip(dev, nat))}; "
              f"Python differs from native on "
              f"{sum(not np.array_equal(a, b) for a, b in zip(py, nat))} "
              f"of {n}")


if __name__ == "__main__":
    main()
