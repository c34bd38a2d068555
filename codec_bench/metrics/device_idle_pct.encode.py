"""Share of the encode calls' time in which the card runs no kernel, copy or
set (the union of the profiler's CUDA records), in percent."""


def read(trace):
    return trace.idle_pct("encode")
