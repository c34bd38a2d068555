"""The least time of the encode transforms' passes (8 B a sample a colour or
DWT level pass at 3.35 TB/s) over the device time of the kernels in the
transform spans, in percent."""

from codec_bench.core.bench import least_ms


def read(trace):
    return trace.roofline_pct("encode", "transform", least_ms("transform", "encode"))
