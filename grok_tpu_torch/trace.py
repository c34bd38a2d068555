"""Named phase spans of the codec, on torch.profiler's clock.

`span(name)` marks one phase of an encode or a decode (Tier-2, rate
control, the Tier-1 job building, ...), and `root(name)` a whole
`compress` or `decompress` call, or `GrkImage.to_array` after one.  While a torch.profiler records (the
CLI's `--profile DIR`, or any `torch.profiler.profile` around the calls),
each is a `torch.profiler.record_function` range, so the exported Chrome
trace shows it as a `user_annotation` beside the card's kernels and
copies, on the profiler's clock.  A root also opens a `grk/gc/gen<N>`
range around every pause of Python's collector that falls inside it, from
a `gc.callbacks` hook that lives only while a root is open.  Spans never
synchronize the card.  When no profiler records, `span` and `root` cost
one check of the profiler's state and return a shared no-op context: no
range is entered and no hook installed.

The names start with `grk/`: `grk/encode`, `grk/decode` and
`grk/to_array` (the interleaving of a decoded image's planes) are the
roots, `grk/<direction>/<phase>` the phases of a direction.  Parentage is containment
on the calling thread.  Spans mark phases only, never a codeblock, a
packet or a sample.
"""

from __future__ import annotations

import contextlib
import gc
import threading

import torch

_recording = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_GC_NAMES = ("grk/gc/gen0", "grk/gc/gen1", "grk/gc/gen2")


class _Span:
    __slots__ = ("range",)

    def __init__(self, name: str):
        self.range = torch.profiler.record_function(name)

    def __enter__(self):
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        return False


class _Root(_Span):
    __slots__ = ()

    def __enter__(self):
        _Collector.open()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _Collector.close()


class _Collector:
    """The `gc.callbacks` hook, installed while any root is open."""

    lock = threading.Lock()
    roots = 0
    pause = None  # the open collector span, if a collection is running

    @classmethod
    def open(cls) -> None:
        with cls.lock:
            cls.roots += 1
            if cls.roots == 1:
                gc.callbacks.append(cls.hook)

    @classmethod
    def close(cls) -> None:
        with cls.lock:
            cls.roots -= 1
            if cls.roots == 0:
                gc.callbacks.remove(cls.hook)
                cls.end()

    @classmethod
    def hook(cls, phase: str, info: dict) -> None:
        cls.end()  # a "stop" that never came (the hook left mid-pause)
        if phase == "start":
            cls.pause = _Span(_GC_NAMES[info["generation"]]).__enter__()

    @classmethod
    def end(cls) -> None:
        pause, cls.pause = cls.pause, None
        if pause is not None:
            pause.__exit__(None, None, None)


def span(name: str):
    """A phase of a call: a profiler range while one records, else a
    no-op."""
    if not _recording():
        return _NULL
    return _Span(name)


def root(name: str):
    """A whole codec call: `span`, and the collector's pauses inside it
    as `grk/gc/gen<N>` spans, while a profiler records."""
    if not _recording():
        return _NULL
    return _Root(name)
