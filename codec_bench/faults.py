"""Faults planted underneath the timed path, to show that the judge
catches them: `stale` (a decode hands back what the previous call made),
`half` (every other code-block of an encode coded as empty) and
`altered` (a decoded sample changed where it is produced: the first
component off by one).  The benchmark's own runs never plant one."""

from __future__ import annotations

import contextlib

import numpy as np

FAULTS = ("stale", "half", "altered")


class Faulty:
    """A port with one fault planted under its two calls."""

    def __init__(self, port, fault: str):
        if fault not in FAULTS:
            raise ValueError(f"no fault {fault!r}")
        self.port, self.fault, self.last = port, fault, None

    def __getattr__(self, name):
        return getattr(self.port, name)

    def encode(self, img, prec, params):
        with self._half() if self.fault == "half" else \
                contextlib.nullcontext():
            return self.port.encode(img, prec, params)

    def decode(self, data):
        out = self.port.decode(data)
        if self.fault == "stale":  # the first hands back an empty frame
            out, self.last = (self.last if self.last is not None
                              else np.zeros_like(out)), out
        elif self.fault == "altered":
            out = out.copy()
            out[..., 0] += 1
        return out

    @contextlib.contextmanager
    def _half(self):
        from grok_tpu_torch.t1 import backend
        real = backend.encode_batch

        def dropped(jobs, *a, **k):
            real(jobs, *a, **k)
            for j in jobs[::2]:
                j.data, j.numbps, j.passes = b"", 0, []
        backend.encode_batch = dropped
        try:
            yield
        finally:
            backend.encode_batch = real
