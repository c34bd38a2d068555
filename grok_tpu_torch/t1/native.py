"""ctypes bindings for the native C++ Tier-1 batch coder.

The production host entropy path: serial-bitstream stages in native
code.  The C++ sources in the repository's `native/` directory are shared
with grok_tpu; this module compiles them itself, with the flags and the
profile-guided steps of native/build.sh, into
`build/grok_tpu_torch/libgrk_t1.so` at first use, and never loads or
writes grok_tpu's own copy.  Importing it registers the "native" backend.

Pointer fields are declared as c_uint64 (same size/alignment as a
pointer on LP64) and filled with raw addresses from
`__array_interface__` — per-job `ctypes.cast` calls were ~12% of
decode wall time.  Per-job scratch arrays are pooled into one
allocation per batch for the same reason.
"""

from __future__ import annotations

import ctypes as ct
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from . import backend as bk

_DWT_SCRATCH = threading.local()

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC_DIR = os.path.join(_ROOT, "native")
BUILD_DIR = os.path.join(_ROOT, "build", "grok_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libgrk_t1.so")
_SOURCES = ("t1.cc", "ht.cc", "dwt.cc", "mct.cc", "t2.cc", "amalgam.cc",
            "train.cc", "util.h")
# -ffp-contract=off: the float paths (9/7 DWT, fused MCT) must round after
# every multiply and add exactly like numpy ufuncs, with no FMA fusion
FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread",
         "-funroll-loops", "-flto", "-ffp-contract=off")


class NativeBuildError(RuntimeError):
    """The native host coder could not be compiled."""


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(os.path.join(SRC_DIR, s)) > built
               for s in _SOURCES)


def _gxx(args, cwd) -> subprocess.CompletedProcess:
    return subprocess.run(["g++", *FLAGS, *args], cwd=cwd,
                          capture_output=True, text=True)


def _compile(out: str) -> str:
    """Compile amalgam.cc into the shared library `out`: profile-guided
    where every step succeeds (amalgam.cc built twice to one object path,
    first instrumented to run train.cc's branch mix, then with the
    profile), else a plain -O3 build.  Returns the failed PGO step's
    output ("" when PGO succeeded); raises NativeBuildError with g++'s
    output when the plain build fails too."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as pgo:
        obj = os.path.join(pgo, "amalgam.o")
        gen, use = f"-fprofile-generate={pgo}", f"-fprofile-use={pgo}"
        steps = (
            lambda: _gxx(["-DGRK_TRAIN_MAIN", gen, "-c", "amalgam.cc",
                          "-o", obj], SRC_DIR),
            lambda: _gxx([gen, obj, "-o", os.path.join(pgo, "train")], pgo),
            lambda: subprocess.run([os.path.join(pgo, "train")], cwd=pgo,
                                   capture_output=True, text=True),
            lambda: _gxx([use, "-fprofile-correction",
                          "-fprofile-partial-training", "-c", "amalgam.cc",
                          "-o", obj], SRC_DIR),
            lambda: _gxx(["-shared", obj, "-o", out], pgo),
        )
        for step in steps:
            proc = step()
            if proc.returncode != 0:
                break
        else:
            return ""
    pgo_log = proc.stderr + proc.stdout
    proc = _gxx(["-shared", "-o", out, "amalgam.cc"], SRC_DIR)
    if proc.returncode != 0:
        raise NativeBuildError(
            f"g++ failed to build the native host coder from {SRC_DIR} "
            f"(exit {proc.returncode}):\n{proc.stderr}{proc.stdout}")
    return pgo_log


def build() -> None:
    """Build LIB_PATH from native/ if it is missing or older than a
    source.  A file lock lets one process build while concurrent ones
    (parallel test workers) wait, and the library is moved into place
    atomically, so a loader never sees half a file."""
    if not _stale():
        return
    if shutil.which("g++") is None:
        raise NativeBuildError("g++ not found: the native host coder "
                               f"builds from {SRC_DIR} with g++")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():  # another process built it while this one waited
            return
        tmp = f"{LIB_PATH}.tmp.{os.getpid()}"
        _compile(tmp)
        os.replace(tmp, LIB_PATH)


build()


def _addr(a: np.ndarray) -> int:
    return a.__array_interface__["data"][0]


class _EncJob(ct.Structure):
    _fields_ = [
        ("h", ct.c_int32), ("w", ct.c_int32),
        ("orient", ct.c_int32), ("style", ct.c_int32),
        ("need_dist", ct.c_int32),
        ("stride", ct.c_int32),
        ("coeffs", ct.c_uint64),
        ("out", ct.c_uint64),
        ("out_cap", ct.c_int32), ("out_len", ct.c_int32),
        ("numbps", ct.c_int32), ("num_passes", ct.c_int32),
        ("pass_rates", ct.c_uint64),
        ("pass_dists", ct.c_uint64),
        ("pass_terms", ct.c_uint64),
        ("status", ct.c_int32),
        ("_pad", ct.c_int32),
        ("e0", ct.c_double),
        ("delta", ct.c_float),
        ("roi_shift", ct.c_int32),
        ("rate_cap", ct.c_int32),
        ("hull_pass", ct.c_uint64),
        ("hull_slope", ct.c_uint64),
        ("hull_n", ct.c_int32),
        ("_pad2", ct.c_int32),
        ("hull_rate", ct.c_uint64),
    ]


class _DecJob(ct.Structure):
    _fields_ = [
        ("h", ct.c_int32), ("w", ct.c_int32),
        ("orient", ct.c_int32), ("style", ct.c_int32),
        ("numbps", ct.c_int32), ("num_passes", ct.c_int32),
        ("data", ct.c_uint64), ("data_len", ct.c_int32),
        ("seg_lens", ct.c_uint64), ("num_segs", ct.c_int32),
        ("out", ct.c_uint64),
        ("out_stride", ct.c_int32),
        ("status", ct.c_int32),
    ]


_ABI_VERSION = 13  # exported surface (v13: encode_tile PCRD feed)

_lib = ct.CDLL(LIB_PATH)
if _lib.grk_t1_abi_version() != _ABI_VERSION:
    # a library with a different struct layout would read garbage through
    # the job pointers
    raise NativeBuildError(
        f"{LIB_PATH} has ABI {_lib.grk_t1_abi_version()}, expected "
        f"{_ABI_VERSION}; delete it to rebuild from {SRC_DIR}")
_lib.grk_t1_encode_batch.argtypes = [ct.POINTER(_EncJob), ct.c_int, ct.c_int]
_lib.grk_t1_encode_batch.restype = ct.c_int
_lib.grk_t1_decode_batch.argtypes = [ct.POINTER(_DecJob), ct.c_int, ct.c_int]
_lib.grk_t1_decode_batch.restype = ct.c_int

MAX_PASSES = 3 * 32


def _as_strided_int32(a) -> np.ndarray:
    """Accept 2-D int32 row-major views without copying (the native coders
    take a row stride); anything else is converted/copied."""
    arr = np.asarray(a)
    if arr.dtype == np.int32 and arr.ndim == 2 and \
            arr.strides[1] == 4 and arr.strides[0] >= 4 * arr.shape[1]:
        return arr
    return np.ascontiguousarray(arr, dtype=np.int32)


def _as_strided_f32(a) -> np.ndarray:
    """float32 variant for fused-quantization inputs."""
    arr = np.asarray(a)
    if arr.dtype == np.float32 and arr.ndim == 2 and \
            arr.strides[1] == 4 and arr.strides[0] >= 4 * arr.shape[1]:
        return arr
    return np.ascontiguousarray(arr, dtype=np.float32)


def encode_batch_native(jobs: list[bk.EncodeJob], num_threads: int = 0) -> None:
    n = len(jobs)
    if n == 0:
        return
    cjobs = (_EncJob * n)()
    coeff_arrs = [_as_strided_f32(j.coeffs) if j.quant_delta > 0.0
                  else _as_strided_int32(j.coeffs) for j in jobs]
    # output cap must scale with the bitplane bound like the C arena
    # does (~2.57 coded bits/sample/plane worst case; budget 4 plus a
    # fixed term for per-pass TERMALL flushes) or deep blocks (ROI
    # shift, 16-bit planes) could trip the final-copy overflow check
    caps = [max(4096,
                a.shape[0] * a.shape[1]
                * max(4, (getattr(j, "numbps_bound", None) or 32)) // 2
                + 2048)
            for a, j in zip(coeff_arrs, jobs)]
    out_pool = np.empty(sum(caps), dtype=np.uint8)
    rates_pool = np.zeros(n * MAX_PASSES, dtype=np.int32)
    dists_pool = np.zeros(n * MAX_PASSES, dtype=np.float64)
    terms_pool = np.zeros(n * MAX_PASSES, dtype=np.uint8)
    hullp_pool = np.zeros(n * MAX_PASSES, dtype=np.int32)
    hulls_pool = np.zeros(n * MAX_PASSES, dtype=np.float64)
    hullr_pool = np.zeros(n * MAX_PASSES, dtype=np.int32)
    out_base = _addr(out_pool)
    rates_base = _addr(rates_pool)
    dists_base = _addr(dists_pool)
    terms_base = _addr(terms_pool)
    hullp_base = _addr(hullp_pool)
    hulls_base = _addr(hulls_pool)
    hullr_base = _addr(hullr_pool)

    out_off = 0
    for i, j in enumerate(jobs):
        coeffs = coeff_arrs[i]
        h, w = coeffs.shape
        c = cjobs[i]
        c.h, c.w = h, w
        c.orient = int(j.orient)
        c.style = int(j.style)
        c.need_dist = 1 if j.need_dist else 0
        c.stride = coeffs.strides[0] // 4
        c.coeffs = _addr(coeffs)
        c.delta = j.quant_delta
        c.roi_shift = j.roi_shift
        c.rate_cap = j.rate_cap
        c.out = out_base + out_off
        c.out_cap = caps[i]
        c.pass_rates = rates_base + i * MAX_PASSES * 4
        c.pass_dists = dists_base + i * MAX_PASSES * 8
        c.pass_terms = terms_base + i * MAX_PASSES
        c.hull_pass = hullp_base + i * MAX_PASSES * 4
        c.hull_slope = hulls_base + i * MAX_PASSES * 8
        c.hull_rate = hullr_base + i * MAX_PASSES * 4
        out_off += caps[i]
    rc = _lib.grk_t1_encode_batch(cjobs, n, num_threads)
    if rc != 0:
        raise RuntimeError("native T1 encode overflow")
    out_off = 0
    for i, j in enumerate(jobs):
        c = cjobs[i]
        j.data = out_pool[out_off: out_off + c.out_len].tobytes()
        out_off += caps[i]
        j.numbps = int(c.numbps)
        np_ = c.num_passes
        base = i * MAX_PASSES
        # pooled-array views; PassInfo objects materialize lazily (hot
        # consumers read the arrays, see backend.LazyPasses)
        j.passes = bk.LazyPasses(rates_pool[base:base + np_],
                                 dists_pool[base:base + np_],
                                 terms_pool[base:base + np_], j.numbps)
        j.e0_out = c.e0
        if c.hull_n >= 0:
            j.hull_pass_arr = hullp_pool[base:base + c.hull_n]
            j.hull_slope_arr = hulls_pool[base:base + c.hull_n]
            j.hull_rate_arr = hullr_pool[base:base + c.hull_n]


def decode_batch_native(jobs: list[bk.DecodeJob], num_threads: int = 0) -> None:
    n = len(jobs)
    if n == 0:
        return
    cjobs = (_DecJob * n)()
    data_pool = np.frombuffer(
        b"".join(j.data if j.data else b"\x00" for j in jobs)
        or b"\x00", dtype=np.uint8)
    seg_lists = [j.seg_lengths or [0] for j in jobs]
    segs_pool = np.asarray([x for s in seg_lists for x in s], dtype=np.int32)
    out_pool = np.zeros(sum(j.h * j.w for j in jobs
                            if j.out_dest is None), dtype=np.int32)
    data_base = _addr(data_pool)
    segs_base = _addr(segs_pool)
    out_base = _addr(out_pool)

    data_off = seg_off = out_off = 0
    for i, j in enumerate(jobs):
        c = cjobs[i]
        c.h, c.w = j.h, j.w
        c.orient = int(j.orient)
        c.style = int(j.style)
        c.numbps = int(j.numbps)
        c.num_passes = int(j.num_passes)
        c.data = data_base + data_off
        c.data_len = len(j.data)
        data_off += len(j.data) if j.data else 1
        c.seg_lens = segs_base + seg_off * 4
        c.num_segs = len(seg_lists[i])
        seg_off += len(seg_lists[i])
        if j.out_dest is not None:
            # direct band write: pre-zeroed destination view, row stride
            c.out = _addr(j.out_dest)
            c.out_stride = j.out_dest.strides[0] // 4
        else:
            c.out = out_base + out_off * 4
            out_off += j.h * j.w
    _lib.grk_t1_decode_batch(cjobs, n, num_threads)
    out_off = 0
    for j in jobs:
        if j.out_dest is not None:
            j.direct_done = True
            continue
        j.out = out_pool[out_off: out_off + j.h * j.w].reshape(j.h, j.w)
        out_off += j.h * j.w


class _HTEncJob(ct.Structure):
    _fields_ = [
        ("h", ct.c_int32), ("w", ct.c_int32),
        ("stride", ct.c_int32), ("_pad", ct.c_int32),
        ("coeffs", ct.c_uint64),
        ("out", ct.c_uint64),
        ("out_cap", ct.c_int32), ("out_len", ct.c_int32),
        ("numbps", ct.c_int32), ("status", ct.c_int32),
    ]


class _HTDecJob(ct.Structure):
    _fields_ = [
        ("h", ct.c_int32), ("w", ct.c_int32),
        ("data", ct.c_uint64), ("data_len", ct.c_int32),
        ("out", ct.c_uint64),
        ("out_stride", ct.c_int32), ("status", ct.c_int32),
    ]


_lib.grk_ht_encode_batch.argtypes = [ct.POINTER(_HTEncJob), ct.c_int, ct.c_int]
_lib.grk_ht_encode_batch.restype = ct.c_int
_lib.grk_ht_decode_batch.argtypes = [ct.POINTER(_HTDecJob), ct.c_int, ct.c_int]
_lib.grk_ht_decode_batch.restype = ct.c_int


def _struct_dtype(cls) -> np.dtype:
    """numpy record dtype mirroring a ctypes Structure layout (offsets
    and padding included), so job arrays fill via vectorized column
    assignment instead of per-field ctypes setattr (~3.5x faster
    marshalling on this box)."""
    names, formats, offsets = [], [], []
    for fname, ftyp in cls._fields_:
        names.append(fname)
        formats.append(np.uint64 if ct.sizeof(ftyp) == 8 else np.int32)
        offsets.append(getattr(cls, fname).offset)
    return np.dtype({"names": names, "formats": formats,
                     "offsets": offsets, "itemsize": ct.sizeof(cls)})


_HTENC_DT = _struct_dtype(_HTEncJob)
_HTDEC_DT = _struct_dtype(_HTDecJob)


def ht_encode_batch_native(jobs: list[bk.EncodeJob],
                           num_threads: int = 0) -> None:
    from ..t1.coder import PassInfo

    n = len(jobs)
    if n == 0:
        return
    coeff_arrs = [_as_strided_int32(j.coeffs) for j in jobs]
    rec = np.zeros(n, dtype=_HTENC_DT)
    rec["h"] = hs = np.fromiter((a.shape[0] for a in coeff_arrs),
                                np.int32, n)
    rec["w"] = ws = np.fromiter((a.shape[1] for a in coeff_arrs),
                                np.int32, n)
    rec["stride"] = np.fromiter((a.strides[0] >> 2 for a in coeff_arrs),
                                np.int32, n)
    rec["coeffs"] = np.fromiter((a.ctypes.data for a in coeff_arrs),
                                np.uint64, n)
    caps = np.maximum(4096, hs.astype(np.int64) * ws * 5 + 2048)
    out_pool = np.empty(int(caps.sum()), dtype=np.uint8)
    offs = np.concatenate(([0], np.cumsum(caps)[:-1]))
    rec["out"] = _addr(out_pool) + offs.astype(np.uint64)
    rec["out_cap"] = caps
    rc = _lib.grk_ht_encode_batch(
        rec.ctypes.data_as(ct.POINTER(_HTEncJob)), n, num_threads)
    if rc != 0:
        raise RuntimeError("native HT encode overflow")
    out_lens = rec["out_len"]
    numbps = rec["numbps"]
    for i, j in enumerate(jobs):
        off = int(offs[i])
        j.data = out_pool[off: off + int(out_lens[i])].tobytes()
        j.numbps = int(numbps[i])
        if j.numbps == 0:
            j.passes = []
        else:
            # coefficient energy = distortion removed by the (single) HT
            # pass; only rate control across layers reads it
            e0 = 0.0
            if j.need_dist:
                a = coeff_arrs[i].astype(np.float64)
                e0 = float((a * a).sum())
            j.passes = [PassInfo(2, j.numbps - 1, True, len(j.data), e0)]


def ht_decode_batch_native(jobs: list[bk.DecodeJob],
                           num_threads: int = 0) -> None:
    n = len(jobs)
    if n == 0:
        return
    data_pool = np.frombuffer(
        b"".join(j.data if j.data else b"\x00" for j in jobs)
        or b"\x00", dtype=np.uint8)
    rec = np.zeros(n, dtype=_HTDEC_DT)
    lens = np.fromiter((len(j.data) for j in jobs), np.int64, n)
    rec["h"] = np.fromiter((j.h for j in jobs), np.int32, n)
    rec["w"] = np.fromiter((j.w for j in jobs), np.int32, n)
    rec["data_len"] = lens
    doffs = np.concatenate(([0], np.cumsum(np.maximum(lens, 1))[:-1]))
    rec["data"] = _addr(data_pool) + doffs.astype(np.uint64)
    out_pool = np.zeros(sum(j.h * j.w for j in jobs
                            if j.out_dest is None), dtype=np.int32)
    out_base = _addr(out_pool)
    out_off = 0
    outs = rec["out"]
    strides = rec["out_stride"]
    for i, j in enumerate(jobs):
        if j.out_dest is not None:
            outs[i] = _addr(j.out_dest)
            strides[i] = j.out_dest.strides[0] >> 2
        else:
            outs[i] = out_base + out_off * 4
            out_off += j.h * j.w
    _lib.grk_ht_decode_batch(
        rec.ctypes.data_as(ct.POINTER(_HTDecJob)), n, num_threads)
    out_off = 0
    for j in jobs:
        if j.out_dest is not None:
            j.direct_done = True
            continue
        j.out = out_pool[out_off: out_off + j.h * j.w].reshape(j.h, j.w)
        out_off += j.h * j.w


bk.register_backend("native", encode_batch_native, decode_batch_native)
bk.register_ht_backend(ht_encode_batch_native, ht_decode_batch_native)

_lib.grk_ht_set_vlc.argtypes = [ct.c_uint64] * 4


def _install_vlc_tables() -> None:
    from . import ht_tables

    enc = np.ascontiguousarray(ht_tables.ENC_CWD, dtype=np.uint8)
    ln = np.ascontiguousarray(ht_tables.ENC_LEN, dtype=np.uint8)
    lut_rho = np.ascontiguousarray(ht_tables.DEC_LUT_RHO, dtype=np.uint8)
    lut_len = np.ascontiguousarray(ht_tables.DEC_LUT_LEN, dtype=np.uint8)
    _lib.grk_ht_set_vlc(_addr(enc), _addr(ln), _addr(lut_rho),
                        _addr(lut_len))


from . import ht_tables as _ht_tables  # noqa: E402

_ht_tables.on_swap(_install_vlc_tables)


# ----------------------------------------------------------- native 5/3 DWT

_lib.grk_fwd53_level.argtypes = [ct.c_uint64, ct.c_int, ct.c_int,
                                 ct.c_uint64, ct.c_uint64, ct.c_uint64,
                                 ct.c_uint64, ct.c_uint64]
_lib.grk_inv53_level_h.argtypes = [ct.c_uint64, ct.c_uint64, ct.c_uint64,
                                   ct.c_uint64, ct.c_int, ct.c_int,
                                   ct.c_uint64, ct.c_uint64, ct.c_int]


def _dwt_scratch_addr(nbytes: int) -> int:
    """Address of a thread-local scratch buffer of >= nbytes (the DWT
    level kernels use it only within the call; reusing one grown buffer
    avoids a full-plane malloc + page-fault per level)."""
    buf = getattr(_DWT_SCRATCH, "buf", None)
    if buf is None or buf.nbytes < nbytes:
        buf = np.empty(nbytes, np.uint8)
        _DWT_SCRATCH.buf = buf
    return _addr(buf)


def fwd53_level_native(x: np.ndarray):
    """One forward 5/3 level (even-parity origin) -> (ll, hl, lh, hh)."""
    h, w = x.shape
    x = np.ascontiguousarray(x, dtype=np.int32)
    eh, ew = (h + 1) // 2, (w + 1) // 2
    oh, ow = h // 2, w // 2
    ll = np.empty((eh, ew), np.int32)
    hl = np.empty((eh, ow), np.int32)
    lh = np.empty((oh, ew), np.int32)
    hh = np.empty((oh, ow), np.int32)
    _lib.grk_fwd53_level(_addr(x), h, w, _addr(ll), _addr(hl), _addr(lh),
                         _addr(hh), _dwt_scratch_addr(4 * h * w))
    return ll, hl, lh, hh


def inv53_level_native(ll, hl, lh, hh, h: int, w: int,
                       halve: int = 0) -> np.ndarray:
    """One inverse 5/3 level.  `halve` fuses the T1 doubled-domain ->
    value conversion ((v - (v >> 31)) >> 1, halve toward zero) into the
    band loads: bit0 halves
    ll, bit1 halves hl/lh/hh — saves a full-plane numpy pass per band on
    the lossless decode path."""
    ll = np.ascontiguousarray(ll, dtype=np.int32)
    hl = np.ascontiguousarray(hl, dtype=np.int32)
    lh = np.ascontiguousarray(lh, dtype=np.int32)
    hh = np.ascontiguousarray(hh, dtype=np.int32)
    out = np.empty((h, w), np.int32)
    _lib.grk_inv53_level_h(_addr(ll), _addr(hl), _addr(lh), _addr(hh), h, w,
                           _addr(out), _dwt_scratch_addr(4 * h * w), halve)
    return out


_lib.grk_fwd97_level.argtypes = [ct.c_uint64, ct.c_int, ct.c_int,
                                 ct.c_uint64, ct.c_uint64, ct.c_uint64,
                                 ct.c_uint64, ct.c_uint64]
_lib.grk_inv97_level.argtypes = [ct.c_uint64, ct.c_uint64, ct.c_uint64,
                                 ct.c_uint64, ct.c_int, ct.c_int,
                                 ct.c_uint64, ct.c_uint64]


def fwd97_level_native(x: np.ndarray):
    """One forward 9/7 level (even-parity origin) -> (ll, hl, lh, hh)."""
    h, w = x.shape
    x = np.ascontiguousarray(x, dtype=np.float32)
    eh, ew = (h + 1) // 2, (w + 1) // 2
    oh, ow = h // 2, w // 2
    ll = np.empty((eh, ew), np.float32)
    hl = np.empty((eh, ow), np.float32)
    lh = np.empty((oh, ew), np.float32)
    hh = np.empty((oh, ow), np.float32)
    _lib.grk_fwd97_level(_addr(x), h, w, _addr(ll), _addr(hl), _addr(lh),
                         _addr(hh), _dwt_scratch_addr(4 * h * w))
    return ll, hl, lh, hh


def inv97_level_native(ll, hl, lh, hh, h: int, w: int) -> np.ndarray:
    ll = np.ascontiguousarray(ll, dtype=np.float32)
    hl = np.ascontiguousarray(hl, dtype=np.float32)
    lh = np.ascontiguousarray(lh, dtype=np.float32)
    hh = np.ascontiguousarray(hh, dtype=np.float32)
    out = np.empty((h, w), np.float32)
    _lib.grk_inv97_level(_addr(ll), _addr(hl), _addr(lh), _addr(hh), h, w,
                         _addr(out), _dwt_scratch_addr(4 * h * w))
    return out


_lib.grk_inv97_level_dq.argtypes = [ct.c_uint64, ct.c_uint64, ct.c_uint64,
                                    ct.c_uint64, ct.c_int, ct.c_int,
                                    ct.c_uint64, ct.c_uint64, ct.c_int,
                                    ct.c_float, ct.c_float, ct.c_float,
                                    ct.c_float]


def inv97_level_dq_native(ll, hl, lh, hh, h: int, w: int,
                          dll, dhl, dlh, dhh) -> np.ndarray:
    """One inverse 9/7 level with dequantization (value = doubled *
    np.float32(0.5 * Delta_b), transform/quant.py) fused into the band
    loads.  hl/lh/hh are int32 doubled-domain planes; ll is int32 when
    dll is not None (level 1) else the previous level's float32 output."""
    dq_ll = dll is not None
    ll = np.ascontiguousarray(ll, dtype=np.int32 if dq_ll else np.float32)
    hl = np.ascontiguousarray(hl, dtype=np.int32)
    lh = np.ascontiguousarray(lh, dtype=np.int32)
    hh = np.ascontiguousarray(hh, dtype=np.int32)
    out = np.empty((h, w), np.float32)
    _lib.grk_inv97_level_dq(_addr(ll), _addr(hl), _addr(lh), _addr(hh),
                            h, w, _addr(out), _dwt_scratch_addr(4 * h * w),
                            1 if dq_ll else 0,
                            float(dll or 0.0), float(dhl), float(dlh),
                            float(dhh))
    return out


# ------------------------------------------------- fused MCT / DC shift

_lib.grk_ict_inv_shift.argtypes = [ct.c_uint64] * 3 + [ct.c_int64] + \
    [ct.c_int] * 6 + [ct.c_uint64] * 3
_lib.grk_rct_inv_shift.argtypes = [ct.c_uint64] * 3 + [ct.c_int64] + \
    [ct.c_int] * 6 + [ct.c_uint64] * 3
_lib.grk_ict_fwd_shift.argtypes = [ct.c_uint64] * 3 + [ct.c_int64] + \
    [ct.c_int32] * 3 + [ct.c_uint64] * 3
_lib.grk_rct_fwd_shift.argtypes = [ct.c_uint64] * 3 + [ct.c_int64] + \
    [ct.c_int32] * 3 + [ct.c_uint64] * 3
_lib.grk_f32_shift_i32.argtypes = [ct.c_uint64, ct.c_int64, ct.c_int,
                                   ct.c_int, ct.c_uint64]
_lib.grk_i32_shift_i32.argtypes = [ct.c_uint64, ct.c_int64, ct.c_int,
                                   ct.c_int, ct.c_uint64]
_lib.grk_i32_shift_f32.argtypes = [ct.c_uint64, ct.c_int64, ct.c_int32,
                                   ct.c_uint64]


def _c3(a, b, c, dtype):
    return (np.ascontiguousarray(a, dtype=dtype),
            np.ascontiguousarray(b, dtype=dtype),
            np.ascontiguousarray(c, dtype=dtype))


def ict_inv_shift_native(y, cb, cr, precs, sgnds):
    """Fused inverse ICT + rint + DC unshift + clip (prec <= 24)."""
    y, cb, cr = _c3(y, cb, cr, np.float32)
    outs = [np.empty(y.shape, np.int32) for _ in range(3)]
    _lib.grk_ict_inv_shift(_addr(y), _addr(cb), _addr(cr), y.size,
                           precs[0], sgnds[0], precs[1], sgnds[1],
                           precs[2], sgnds[2], *(map(_addr, outs)))
    return outs


def rct_inv_shift_native(y, cb, cr, precs, sgnds):
    y, cb, cr = _c3(y, cb, cr, np.int32)
    outs = [np.empty(y.shape, np.int32) for _ in range(3)]
    _lib.grk_rct_inv_shift(_addr(y), _addr(cb), _addr(cr), y.size,
                           precs[0], sgnds[0], precs[1], sgnds[1],
                           precs[2], sgnds[2], *(map(_addr, outs)))
    return outs


def ict_fwd_shift_native(r, g, b, dcs):
    r, g, b = _c3(r, g, b, np.int32)
    outs = [np.empty(r.shape, np.float32) for _ in range(3)]
    _lib.grk_ict_fwd_shift(_addr(r), _addr(g), _addr(b), r.size,
                           dcs[0], dcs[1], dcs[2], *(map(_addr, outs)))
    return outs


def rct_fwd_shift_native(r, g, b, dcs):
    r, g, b = _c3(r, g, b, np.int32)
    outs = [np.empty(r.shape, np.int32) for _ in range(3)]
    _lib.grk_rct_fwd_shift(_addr(r), _addr(g), _addr(b), r.size,
                           dcs[0], dcs[1], dcs[2], *(map(_addr, outs)))
    return outs


def f32_shift_i32_native(x, prec, sgnd):
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.shape, np.int32)
    _lib.grk_f32_shift_i32(_addr(x), x.size, prec, sgnd, _addr(out))
    return out


def i32_shift_i32_native(x, prec, sgnd):
    x = np.ascontiguousarray(x, dtype=np.int32)
    out = np.empty(x.shape, np.int32)
    _lib.grk_i32_shift_i32(_addr(x), x.size, prec, sgnd, _addr(out))
    return out


def i32_shift_f32_native(x, dc):
    x = np.ascontiguousarray(x, dtype=np.int32)
    out = np.empty(x.shape, np.float32)
    _lib.grk_i32_shift_f32(_addr(x), x.size, dc, _addr(out))
    return out
