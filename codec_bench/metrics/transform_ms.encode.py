"""Mean ms of a encode call in the tile processor's device transforms
(tile/processor.py _analyse and its copies)."""


def read(trace):
    return trace.layer_ms("encode", "transform")
