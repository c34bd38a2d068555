"""Mean ms of a encode call in the Tier-1 dispatch (t1/backend.py
encode_batch: the routers, their host halves, the kernels)."""


def read(trace):
    return trace.layer_ms("encode", "t1")
