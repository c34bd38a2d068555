"""The traced run: the benchmark's own spans around the port's layers, the
profiler's record of the card, and the arithmetic the per-layer metrics
read from them.

A span wraps a module attribute of the port from outside (the pattern of
`chip_smoke.Timed`): a synchronize, a `torch.profiler.record_function`
range, the call, a synchronize.  Every call of the window is a span of its
own (`encode`, `decode`), and the layers inside it are `<direction>/<layer>`
spans.  The profiler records the CPU ranges and the card's kernels, copies
and sets on one clock; the reading is from its Chrome trace.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
DIRECTIONS = ("encode", "decode")


def span_targets():
    """(direction, layer) -> (module, attribute) of the port's layers."""
    from grok_tpu_torch.t1 import backend
    from grok_tpu_torch.tile import processor
    return {("encode", "transform"): (processor, "_analyse"),
            ("decode", "transform"): (processor, "_synthesise"),
            ("encode", "t1"): (backend, "encode_batch"),
            ("decode", "t1"): (backend, "decode_batch")}


class Spans:
    """Wrap the port's layer entry points while the context is open."""

    def __init__(self, sync, targets=None):
        self.sync = sync
        self.targets = span_targets() if targets is None else targets
        self.saved = {}

    def __enter__(self):
        for (direction, layer), (owner, attr) in self.targets.items():
            fn = getattr(owner, attr)
            self.saved[(owner, attr)] = fn

            def spanned(*a, _fn=fn, _name=f"{direction}/{layer}", **k):
                self.sync()
                with torch.profiler.record_function(_name):
                    try:
                        return _fn(*a, **k)
                    finally:
                        self.sync()
            setattr(owner, attr, spanned)
        return self

    def __exit__(self, *exc):
        for (owner, attr), fn in self.saved.items():
            setattr(owner, attr, fn)


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(merged, s, e) -> float:
    """Length of [s, e) that the merged intervals cover."""
    total = 0.0
    i = max(0, bisect.bisect_right([m[0] for m in merged], s) - 1)
    while i < len(merged) and merged[i][0] < e:
        a, b = max(merged[i][0], s), min(merged[i][1], e)
        if b > a:
            total += b - a
        i += 1
    return total


class Trace:
    """What one traced window recorded.  `spans`: (name, start, end) of the
    benchmark's ranges; `device`: (name, start, end) of the card's kernels
    (`kernels`) and of all its activity, copies and sets included
    (`activity`); `meta`: per direction, per call in order, the shapes and
    sizes the roofline counts.  Times in microseconds."""

    def __init__(self, spans, kernels, activity, meta):
        self.meta = meta
        self.kernels = sorted(kernels, key=lambda k: k[1])
        self.kernel_starts = [k[1] for k in self.kernels]
        self.activity = sorted(activity, key=lambda k: k[1])
        self.busy = union((s, e) for _, s, e in activity)
        self.calls = {d: sorted((s, e) for n, s, e in spans if n == d)
                      for d in DIRECTIONS}
        self.layers = defaultdict(list)
        for n, s, e in spans:
            if "/" in n:
                self.layers[n].append((s, e))

    # ---------------------------------------------------------------- reads
    def n_calls(self, d: str) -> int:
        return len(self.calls[d])

    def window(self) -> tuple[float, float]:
        ends = [c for d in DIRECTIONS for c in self.calls[d]]
        return min(s for s, _ in ends), max(e for _, e in ends)

    def layer_ms(self, d: str, layer: str) -> float | None:
        """Mean milliseconds a call spends in a layer's spans."""
        if not self.calls[d] or not self.layers[f"{d}/{layer}"]:
            return None
        total = sum(e - s for s, e in self.layers[f"{d}/{layer}"])
        return total / 1e3 / len(self.calls[d])

    def self_ms(self, d: str) -> float | None:
        """Mean milliseconds of a call outside its layer spans."""
        if not self.calls[d]:
            return None
        children = union(iv for n, ivs in self.layers.items()
                         if n.startswith(d + "/") for iv in ivs)
        total = sum((e - s) - covered(children, s, e)
                    for s, e in self.calls[d])
        return total / 1e3 / len(self.calls[d])

    def idle_pct(self, d: str) -> float | None:
        """Share of the calls' time in which the card ran nothing."""
        if not self.calls[d]:
            return None
        span = sum(e - s for s, e in self.calls[d])
        busy = sum(covered(self.busy, s, e) for s, e in self.calls[d])
        return 100.0 * (span - busy) / span

    def kernel_us(self, d: str, layer: str) -> float:
        """Device time of the kernels launched inside a layer's spans."""
        total = 0.0
        for s, e in self.layers[f"{d}/{layer}"]:
            i = bisect.bisect_left(self.kernel_starts, s)
            while i < len(self.kernels) and self.kernels[i][1] < e:
                total += self.kernels[i][2] - self.kernels[i][1]
                i += 1
        return total

    def roofline_pct(self, d: str, layer: str, least_ms) -> float | None:
        """The least time of the layer's work over its kernels' time, in
        percent; `least_ms(meta)` prices one call.  None without kernels."""
        us = self.kernel_us(d, layer)
        if us <= 0 or not self.meta.get(d):
            return None
        return 100.0 * sum(least_ms(m) for m in self.meta[d]) * 1e3 / us

    # ------------------------------------------------------------ breakdown
    def breakdown(self, top: int = 10) -> dict:
        s0, e0 = self.window()
        ops = defaultdict(float)
        for name, s, e in self.activity:
            if s0 <= s < e0:
                ops[name] += (e - s) / 1e6
        gaps = defaultdict(float)
        for d in DIRECTIONS:
            mine = {n: union(ivs) for n, ivs in self.layers.items()
                    if n.startswith(d + "/")}
            for s, e in self.calls[d]:
                for a, b in _gaps(self.busy, s, e):
                    for label, part in _split(mine, a, b, d + "/host"):
                        gaps[label] += part / 1e6
        order = lambda kv: -kv[1]  # noqa: E731
        return {"device_ops": [[k, v] for k, v in
                               sorted(ops.items(), key=order)[:top]],
                "idle_gaps": [[k, v] for k, v in
                              sorted(gaps.items(), key=order)[:top]]}

    def busy_s(self) -> float:
        s0, e0 = self.window()
        return covered(self.busy, s0, e0) / 1e6

    def window_s(self) -> float:
        s0, e0 = self.window()
        return (e0 - s0) / 1e6


def _gaps(merged, s, e):
    """The parts of [s, e) that the merged intervals leave uncovered."""
    out, cur = [], s
    for a, b in merged:
        if b <= cur:
            continue
        if a >= e:
            break
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < e:
        out.append((cur, e))
    return out


def _split(layers, a, b, rest):
    """(label, length) of [a, b) by the layer span it lies in."""
    out, left = [], b - a
    for label, ivs in layers.items():
        part = covered(ivs, a, b)
        if part:
            out.append((label, part))
            left -= part
    if left > 0:
        out.append((rest, left))
    return out


def read_chrome(path: str, meta) -> Trace:
    """A Trace from a profiler's exported Chrome trace."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    spans, kernels, activity = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        if cat == "user_annotation" and name.split("/")[0] in DIRECTIONS:
            spans.append((name, s, e))
        elif cat in DEVICE_CATS:
            activity.append((name, s, e))
            if cat == "kernel":
                kernels.append((name, s, e))
    return Trace(spans, kernels, activity, meta)

