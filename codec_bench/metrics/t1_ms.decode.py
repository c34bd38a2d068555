"""Mean ms of a decode call in the Tier-1 dispatch (t1/backend.py
decode_batch: the routers, their host halves, the kernels)."""


def read(trace):
    return trace.layer_ms("decode", "t1")
