"""Seconds from the process's start to the first timed call: loading the
port (building it on a checkout's first run), the pool, the warm round
trips."""


def read(window):
    return window.setup_s
