"""Tier-1 backend dispatch: python reference / native C++.

Parity: T1Interface / T1Factory (SURVEY.md §2.1 "Tier-1 interface").  The
reference dispatches per codeblock between MQ and HT coders; we additionally
dispatch between implementations:

- "python": the MQ implementation in t1/coder.py (correctness oracle); the
  pure-Python HT coder is not ported (ROADMAP A14)
- "native": C++ batch coder (native/t1.cc via ctypes), threads across
  codeblocks — the production host path.  "auto" and "device" code on it
  too: device Tier-1 is not ported yet (ROADMAP A8-A12), so the device
  backend runs the transforms on the card and Tier-1 here

Batch API: lists of codeblock jobs so the native backend can parallelize
freely (SURVEY.md §2.3 "codeblock-batch axis").
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..params import CblkStyle
from . import coder as pycoder


class LazyPasses:
    """Sequence of PassInfo materialized on demand from the native
    coder's pooled (rates, dists, terms) arrays.

    Building ~25 PassInfo objects per codeblock was ~15% of rate-targeted
    encode wall time; the hot consumers (hulls, Tier-2 statics) read the
    arrays directly and never materialize."""

    __slots__ = ("rates", "dists", "terms", "numbps", "_mat")

    def __init__(self, rates, dists, terms, numbps):
        self.rates = rates
        self.dists = dists
        self.terms = terms
        self.numbps = numbps
        self._mat = None

    def _list(self):
        if self._mat is None:
            from .coder import PassInfo

            out = []
            passno = 0
            n = len(self.rates)
            for bpno in range(self.numbps - 1, -1, -1):
                for ptype in ((2,) if bpno == self.numbps - 1 else (0, 1, 2)):
                    if passno >= n:
                        break
                    out.append(PassInfo(ptype, bpno,
                                        bool(self.terms[passno]),
                                        int(self.rates[passno]),
                                        float(self.dists[passno])))
                    passno += 1
            self._mat = out
        return self._mat

    def __len__(self):
        return len(self.rates)

    def __bool__(self):
        return len(self.rates) > 0

    def __getitem__(self, k):
        return self._list()[k]

    def __iter__(self):
        return iter(self._list())


@dataclass
class EncodeJob:
    coeffs: np.ndarray
    orient: int
    style: CblkStyle
    ht: bool = False          # Part 15 HT block coder instead of MQ
    need_dist: bool = True    # PCRD distortion tracking required
    numbps_bound: int = 32  # static magnitude-bitcount bound (band M_b)
    # deferred quantization: > 0 means coeffs is a float32 band view and
    # the backend applies floor(|v|/delta) during ingest (the native
    # coder fuses it; other backends materialize via _materialize_quant)
    quant_delta: float = 0.0
    # max-shift ROI upshift applied to magnitudes during ingest
    roi_shift: int = 0
    # > 0: stop after the first pass whose cumulative rate reaches this
    # many bytes (rate-quota PCRD; see TileCompressor.run_t1)
    rate_cap: int = 0
    # results
    data: bytes = b""
    numbps: int = 0
    passes: list = field(default_factory=list)
    # native backend: e0 measured during coefficient ingest (sum m^2);
    # None on backends that don't provide it
    e0_out: float | None = None


def _materialize_quant(j: EncodeJob) -> None:
    """Apply deferred quantization/ROI for backends without fused ingest."""
    if j.quant_delta > 0.0:
        from ..transform.quant import quantize

        j.coeffs = quantize(np.asarray(j.coeffs), j.quant_delta)
        j.quant_delta = 0.0
    if j.roi_shift:
        j.coeffs = (np.asarray(j.coeffs).astype(np.int64)
                    << j.roi_shift).astype(np.int32)
        j.roi_shift = 0


@dataclass
class DecodeJob:
    data: bytes
    seg_lengths: list[int]
    num_passes: int
    numbps: int
    h: int
    w: int
    orient: int
    style: CblkStyle
    ht: bool = False
    out: np.ndarray | None = None  # doubled-domain signed int32
    # optional pre-zeroed (h, w) int32 view into the destination band
    # array: native backends write it directly (no paste copy) and set
    # direct_done; other backends ignore it and fill `out` as usual
    out_dest: np.ndarray | None = None
    direct_done: bool = False


def _encode_python(jobs: list[EncodeJob], num_threads: int = 0) -> None:
    for j in jobs:
        j.data, j.numbps, j.passes = pycoder.encode_cblk(
            j.coeffs, j.orient, j.style, rate_cap=j.rate_cap)


def _decode_python(jobs: list[DecodeJob], num_threads: int = 0) -> None:
    for j in jobs:
        j.out = pycoder.decode_cblk(
            j.data, j.seg_lengths, j.num_passes, j.numbps,
            j.h, j.w, j.orient, j.style)


_BACKENDS = {"python": (_encode_python, _decode_python)}
_HT_NATIVE = None  # (encode_fn, decode_fn) once native lib registers


def register_backend(name: str, encode_fn, decode_fn) -> None:
    _BACKENDS[name] = (encode_fn, decode_fn)


def register_ht_backend(encode_fn, decode_fn) -> None:
    global _HT_NATIVE
    _HT_NATIVE = (encode_fn, decode_fn)


def _load_native() -> bool:
    if "native" not in _BACKENDS:
        # registers itself; a failed build raises with g++'s output
        from . import native  # noqa: F401
    return "native" in _BACKENDS


def resolve(backend: str = "device") -> str:
    # "device" refers to the transform pipeline; T1 entropy coding runs on
    # the native host backend in that mode (SURVEY.md §7 device/host split)
    if backend in ("auto", "native", "device") and _load_native():
        return "native"
    return "python"


_NO_PY_HT = ("the pure-Python HT block coder (grok_tpu/t1/ht.py) is not "
             "ported: ROADMAP A14; HT codes on the native coder")


def _encode_ht(jobs: list[EncodeJob]) -> None:
    raise NotImplementedError(_NO_PY_HT)


def _decode_ht(jobs: list[DecodeJob]) -> None:
    raise NotImplementedError(_NO_PY_HT)


def encode_batch(jobs: list[EncodeJob], backend: str = "device",
                 num_threads: int = 0) -> None:
    """num_threads sizes the native thread pool (-H parity; 0 = all
    cores).  Output is byte-identical for any thread count — jobs are
    independent and land in per-job buffers (the reference's determinism
    invariant, SURVEY.md §4)."""
    ht_jobs = [j for j in jobs if j.ht]
    mq_jobs = [j for j in jobs if not j.ht]
    if ht_jobs:
        name = resolve(backend)
        for j in ht_jobs:  # native HT ingest has no fused quantizer
            _materialize_quant(j)
        if name == "native" and _HT_NATIVE is not None and \
                backend != "python":
            _HT_NATIVE[0](ht_jobs, num_threads)
        else:
            _encode_ht(ht_jobs)
    if mq_jobs:
        name = resolve(backend)
        if name != "native":  # the native MQ coder fuses quant/ROI
            for j in mq_jobs:
                _materialize_quant(j)
        _BACKENDS[name][0](mq_jobs, num_threads)


def decode_batch(jobs: list[DecodeJob], backend: str = "device",
                 num_threads: int = 0) -> None:
    ht_jobs = [j for j in jobs if j.ht]
    mq_jobs = [j for j in jobs if not j.ht]
    if ht_jobs:
        name = resolve(backend)
        if name == "native" and _HT_NATIVE is not None and \
                backend != "python":
            _HT_NATIVE[1](ht_jobs, num_threads)
        else:
            _decode_ht(ht_jobs)
    if mq_jobs:
        name = resolve(backend)
        _BACKENDS[name][1](mq_jobs, num_threads)
