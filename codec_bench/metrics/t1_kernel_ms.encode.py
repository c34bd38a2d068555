"""Mean ms an encode call of device time in the kernels launched inside the
Tier-1 spans (t1/backend.py encode_batch), matched by start time as
`Trace.kernel_us`: the coders' chains on the card.  The raw time beside
`t1_roofline_pct.encode`, whose byte price reads MQ's chain-bound kernels
near 0.1%."""


def read(trace):
    if not trace.calls["encode"] or not trace.layers["encode/t1"]:
        return None
    return trace.kernel_us("encode", "t1") / 1e3 / len(trace.calls["encode"])
