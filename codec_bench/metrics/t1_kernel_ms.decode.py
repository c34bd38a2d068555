"""Mean ms a decode call of device time in the kernels launched inside the
Tier-1 spans (t1/backend.py decode_batch), matched by start time as
`Trace.kernel_us`: the coders' chains on the card.  The raw time beside
`t1_roofline_pct.decode`, whose byte price reads MQ's chain-bound kernels
near 0.1%."""


def read(trace):
    if not trace.calls["decode"] or not trace.layers["decode/t1"]:
        return None
    return trace.kernel_us("decode", "t1") / 1e3 / len(trace.calls["decode"])
