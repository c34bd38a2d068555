"""Build and load the port's CUDA kernels.

Every `grok_tpu_torch/csrc/*.cu` is compiled by its own `nvcc` for Hopper
(`sm_90a`), all at once, and the objects are linked into one shared library
with a plain C interface, at first use, and loaded with ctypes.  The library goes to `build/grok_tpu_torch/` beside
the package and is rebuilt when a source is newer.  There is no fallback:
a missing `nvcc` or a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "grok_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libgrk_torch_kernels.so")
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points: (argument types); each returns a cudaError_t as int
_SIGNATURES = {
    # x, ll, hl, lh, hh, h, w, planes, stream
    "grk_fwd53_level": (_P,) * 5 + (_I,) * 3 + (_P,),
    # ll, hl, lh, hh, out, h, w, planes, stream
    "grk_inv53_level": (_P,) * 5 + (_I,) * 3 + (_P,),
    # r, g, b, y, cb, cr, count, shift, stream
    "grk_rct_fwd": (_P,) * 6 + (_I, _I, _P),
    # y, cb, cr, r, g, b, count, prec, sgnd, stream
    "grk_rct_inv": (_P,) * 6 + (_I, _I, _I, _P),
    # x, ll, hl, lh, hh, h, w, planes, consts (host float32: ALPHA, BETA,
    # GAMMA, DELTA, K, 1/K, then the ll, hl, lh, hh steps), stream
    "grk_fwd97_level": (_P,) * 5 + (_I,) * 3 + (_P, _P),
    # ll, hl, lh, hh, out, h, w, planes, consts (the same, with half
    # steps), stream
    "grk_inv97_level": (_P,) * 5 + (_I,) * 3 + (_P, _P),
    # planes, out, ncomp, count, shift, ict, consts (host float32: the
    # nine ICT coefficients, the step), stream
    "grk_ict_fwd": (_P, _P, _I, _L, _I, _I, _P, _P),
    # x, out, ncomp, count, prec, sgnd, ict, consts (host float32: m02,
    # m11, m12, m21 of the inverse, the half step), stream
    "grk_ict_inv": (_P, _P, _I, _L, _I, _I, _I, _P, _P),
    # desc, enc_cwd, enc_len, pool, pool_used, meta, nblocks, pool_cap,
    # max_quads, max_qw, scup_max, stream
    "grk_ht_encode": (_P,) * 6 + (_I, _L, _I, _I, _I, _P),
    # desc, data, scratch, streams, longest, nblocks, stream
    "grk_ht_destuff": (_P,) * 5 + (_I, _P),
    # desc, streams, scratch, lut_rho, lut_len, rho, umax, nblocks, maxc,
    # max_qw, stream
    "grk_ht_decode": (_P,) * 7 + (_I, _I, _I, _P),
    # desc, streams, scratch, rho, umax, longest, nblocks, stream
    "grk_ht_magsgn": (_P,) * 6 + (_I, _P),
    # desc, tables, slots, packed, used, meta, rates, terms, dists,
    # nblocks, pool_cap, smem_bytes, stream
    "grk_mq_encode": (_P,) * 9 + (_I, _L, _I, _P),
    # desc, tables, segs, pmap, data, nblocks, smem_bytes, stream
    "grk_mq_decode": (_P,) * 5 + (_I, _I, _P),
}


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be compiled or loaded."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[str]:
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(nvcc):
        raise KernelBuildError(
            "nvcc not found (looked on PATH and in "
            f"{os.path.join(cuda_home, 'bin')}); the CUDA kernels of "
            "grok_tpu_torch build only where the CUDA toolkit is installed")
    return nvcc


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in sources())


def _run(cmds: list[list[str]]) -> str:
    """Run the commands at once; returns their output, or raises with the
    first failure's."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs = [(cmd, proc.communicate()[0], proc.returncode)
            for cmd, proc in procs]
    for cmd, out, rc in outs:
        if rc != 0:
            raise KernelBuildError(
                f"nvcc failed (exit {rc}): {' '.join(cmd)}\n{out}")
    return "".join(out for _, out, _ in outs)


def build() -> str:
    """Compile the kernels into LIB_PATH, one nvcc a source in parallel,
    then link; returns nvcc's output, which holds ptxas's register and
    spill report for each kernel."""
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"tmp.{os.getpid()}"
    objs = []
    compiles = []
    for src in sources():
        if src.endswith(".cu"):
            obj = os.path.join(BUILD_DIR,
                               f"{os.path.basename(src)[:-3]}.{tag}.o")
            objs.append(obj)
            compiles.append([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src])
    tmp = f"{LIB_PATH}.{tag}"
    try:
        report = _run(compiles)
        report += _run([[nvcc, *GENCODE, "-shared", "-o", tmp, *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader never sees half
    return report


def load() -> ctypes.CDLL:
    """The kernel library, built first if it is missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            try:
                lib = ctypes.CDLL(LIB_PATH)
            except OSError as e:
                raise KernelBuildError(
                    f"cannot load {LIB_PATH}: {e}") from e
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.grk_cuda_error_string.argtypes = (ctypes.c_int,)
            lib.grk_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def int_args(name: str) -> tuple:
    """The ctypes of C entry point `name`'s integer arguments, in order."""
    return tuple(t for t in _SIGNATURES[name] if t is not _P)


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        text = load().grk_cuda_error_string(err).decode(errors="replace")
        raise KernelLaunchError(f"{name} failed: cudaError_t {err} ({text})")
