"""Mean ms of a decode call outside its transform and Tier-1 spans: the codec
API, the codestream drivers, Tier-2 and rate control (self time)."""


def read(trace):
    return trace.self_ms("decode")
