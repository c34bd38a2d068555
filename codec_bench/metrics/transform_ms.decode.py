"""Mean ms of a decode call in the tile processor's device transforms
(tile/processor.py _synthesise and its copies)."""


def read(trace):
    return trace.layer_ms("decode", "transform")
