"""The least time of decode Tier-1 (4 B a coefficient and the coded bytes at
3.35 TB/s) over the device time of the kernels in the Tier-1 spans, in
percent."""

from codec_bench.core.bench import least_ms


def read(trace):
    return trace.roofline_pct("decode", "t1", least_ms("t1", "decode"))
