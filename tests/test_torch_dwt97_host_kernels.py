"""The 9/7 level and ICT kernels' own sources, run on the CPU, against the
twins.

grok_tpu_torch/csrc/dwt97_level.cu and ict.cu are compiled with g++ under
tests/grid_host_shim.h (a CTA as fibers on one host thread, __syncthreads,
__syncwarp and the shuffles as barriers, cp.async a copy, shared memory
NaN-filled before each CTA, the float intrinsics as plain IEEE operations
under -ffp-contract=off, the conversions saturating), with the `extern
"C"` launchers replaced by ones that run the grid for a chosen number of
resident CTAs and a chosen variant, fed the constants the wrappers pass,
and held bit for bit to the plain twins: bands, steps, odd and short
sizes, strips, segments and chunks, both variants, ICT stacks of 1, 3 and
4 components, extremes and NaN.  This checks
the kernels' logic where there is no card; their build for sm_90a and their
speed show only on one (tests/test_torch_cuda.py, chip_smoke.py).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from grok_tpu_torch.ops import dwt, mct
from grok_tpu_torch.ops.lifting import f32

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "grok_tpu_torch", "csrc")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

_LAUNCHERS = {
    "dwt97_level.cu": '''
extern "C" int host_fwd97(const void* x, void* ll, void* hl, void* lh,
                          void* hh, int h, int w, int planes,
                          const float* consts, int capacity, int vec) {
  Plan p;
  unsigned ctas;
  if (plan_for(h, w, planes, capacity, &p, &ctas) != cudaSuccess) return 1;
  const Consts c = consts_from(consts);
  return run_grid(dim3(ctas), dim3(kThreads), [&] {
    if (vec)
      fwd97_level_kernel<true>((const float*)x, ll, hl, lh, hh, h, w, p, c);
    else
      fwd97_level_kernel<false>((const float*)x, ll, hl, lh, hh, h, w, p, c);
  });
}
extern "C" int host_inv97(const void* ll, const void* hl, const void* lh,
                          const void* hh, void* out, int h, int w,
                          int planes, const float* consts, int capacity,
                          int vec) {
  Plan p;
  unsigned ctas;
  if (plan_for(h, w, planes, capacity, &p, &ctas) != cudaSuccess) return 1;
  const Consts c = consts_from(consts);
  return run_grid(dim3(ctas), dim3(kThreads), [&] {
    if (vec)
      inv97_level_kernel<true>(ll, hl, lh, hh, (float*)out, h, w, p, c);
    else
      inv97_level_kernel<false>(ll, hl, lh, hh, (float*)out, h, w, p, c);
  });
}
''',
    "ict.cu": '''
extern "C" int host_ict_fwd(const void* x, void* out, int ncomp,
                            long long count, int shift, int ict,
                            const float* consts) {
  unsigned blocks;
  if (blocks_for(ncomp, count, ict, &blocks) != cudaSuccess) return 1;
  FwdConsts c;
  for (int i = 0; i < 9; ++i) c.m[i] = consts[i];
  c.step = consts[9];
  return run_grid(dim3(blocks < 4 ? blocks : 4), dim3(kThreads), [&] {
    ict_fwd_kernel((const int32_t*)x, out, ncomp, count, shift, ict, c);
  });
}
extern "C" int host_ict_inv(const void* x, void* out, int ncomp,
                            long long count, int prec, int sgnd, int ict,
                            const float* consts) {
  unsigned blocks;
  if (blocks_for(ncomp, count, ict, &blocks) != cudaSuccess) return 1;
  const long long half = 1LL << (prec - 1);
  const int32_t shift = sgnd ? 0 : (int32_t)half;
  const int32_t lo = sgnd ? (int32_t)-half : 0;
  const int32_t hi = (int32_t)(sgnd ? half - 1 : 2 * half - 1);
  InvConsts c{consts[0], consts[1], consts[2], consts[3], consts[4]};
  return run_grid(dim3(blocks < 4 ? blocks : 4), dim3(kThreads), [&] {
    ict_inv_kernel(x, (int32_t*)out, ncomp, count, shift, lo, hi, ict, c);
  });
}
''',
}
_SIGS = {
    "host_fwd97": (_P,) * 5 + (_I,) * 3 + (_P, _I, _I),
    "host_inv97": (_P,) * 5 + (_I,) * 3 + (_P, _I, _I),
    "host_ict_fwd": (_P, _P, _I, _L, _I, _I, _P),
    "host_ict_inv": (_P, _P, _I, _L, _I, _I, _I, _P),
}


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    """The kernels built for the host: {C function name: function}."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("dwt97_host_kernels")
    for header in ("cuda_runtime.h", "cuda_pipeline.h"):
        (out / header).write_text("")
    fns = {}
    for src, launcher in _LAUNCHERS.items():
        text = open(os.path.join(CSRC, src)).read()
        name = src.split(".")[0]
        tu = out / f"{name}.cc"
        tu.write_text('#include "grid_host_shim.h"\n'
                      + text[:text.index('extern "C"')] + launcher)
        lib = out / f"lib{name}.so"
        proc = subprocess.run(
            [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-pthread",
             "-shared", "-fPIC", f"-I{out}", f"-I{HERE}", "-o", str(lib),
             str(tu)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr
        so = ctypes.CDLL(str(lib))
        for fn, argtypes in _SIGS.items():
            if hasattr(so, fn):
                f = getattr(so, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                fns[fn] = f
    return fns


def _floats(values):
    return (ctypes.c_float * len(values))(*values)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype, shape and bits (float32 compared as int32, so -0.0 and
    NaN payloads count)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


# CTAs resident at once on the card the kernels are planned for (132 SMs,
# 5 CTAs each): small planes get one chunk a segment, as there
CARD = 660


def _fwd(kernels, x, steps, capacity=CARD, vec=None):
    """The forward level kernel; `vec` picks the variant (default: the
    launcher's choice, 16-byte copies when the width is a multiple of 4),
    `capacity` the resident CTAs the launch is planned for."""
    *lead, h, w = x.shape
    bands = [torch.empty(s, dtype=dwt._band_dtype(st))
             for s, st in zip(dwt._band_shapes(lead, h, w), steps)]
    consts = dwt._LIFT_CONSTS + tuple(f32(s) for s in steps)
    assert kernels["host_fwd97"](
        x.data_ptr(), *(b.data_ptr() for b in bands), h, w,
        int(np.prod(lead)), _floats(consts), capacity,
        int(w % 4 == 0 if vec is None else vec)) == 0
    return bands


def _inv(kernels, bands, h, w, steps, capacity=CARD, vec=None):
    out = torch.empty((*bands[0].shape[:-2], h, w), dtype=torch.float32)
    consts = dwt._LIFT_CONSTS + tuple(f32(0.5 * s) if s > 0 else 0.0
                                      for s in steps)
    assert kernels["host_inv97"](
        *(b.data_ptr() for b in bands), out.data_ptr(), h, w,
        int(np.prod(bands[0].shape[:-2])), _floats(consts), capacity,
        int(w % 4 == 0 if vec is None else vec)) == 0
    return out


SIZES = (1, 2, 3, 5, 8, 37, 64)
STEPS = (0.37, 0.61, 0.59, 1.13)


@pytest.mark.parametrize("h", SIZES)
def test_level_kernels_match_twins(kernels, h):
    """Every width of SIZES at this height: the forward level with and
    without steps, the inverse from the quantized bands (doubled) and from
    float bands."""
    rng = np.random.default_rng(h)
    for w in SIZES:
        x = torch.from_numpy(rng.normal(0, 400, (2, h, w)).astype(np.float32))
        for steps in ((0.0,) * 4, STEPS):
            got = _fwd(kernels, x, steps)
            want = dwt.fwd_level_plain(x, False, steps)
            for g, r in zip(got, want):
                assert _bits_equal(g, r), (h, w, steps)
        q = dwt.fwd_level_plain(x, False, STEPS)
        dbl = [2 * b + torch.sign(b) for b in q]
        assert _bits_equal(_inv(kernels, dbl, h, w, STEPS),
                           dwt.inv_level_plain(*dbl, h, w, False, STEPS))
        fl = dwt.fwd_level_plain(x, False)
        assert _bits_equal(_inv(kernels, fl, h, w, (0.0,) * 4),
                           dwt.inv_level_plain(*fl, h, w, False))


@pytest.mark.parametrize("shape,capacity,vec", [
    ((1, 130, 250), CARD, None), ((3, 61, 125), CARD, None),
    # capacity 1: one CTA a strip, walking every chunk down it, the last
    # ragged; the 16-byte variant (width 0 mod 4) and the 4-byte one on
    # the same plane
    ((2, 101, 252), 1, None), ((2, 101, 252), 1, False),
    # capacity 4: two segments of several chunks a strip, chunk and segment
    # boundaries inside every strip; widths 1, 2 and 3 mod 4
    ((1, 170, 129), 4, None), ((1, 170, 254), 4, None),
    ((1, 170, 131), 4, None),
    # a 2048-wide row: 18 strips, the last 4 pairs wide
    ((1, 6, 2048), CARD, None)])
def test_level_kernels_across_ctas(kernels, shape, capacity, vec):
    """Planes of several CTAs each way (strips of 60 pairs, segments of
    chunks of pair rows), LL quantized too, as at a tile's coarsest level;
    the inverse from doubled and from float bands."""
    rng = np.random.default_rng(shape[1] + shape[2])
    x = torch.from_numpy(rng.normal(0, 900, shape).astype(np.float32))
    h, w = shape[-2:]
    got = _fwd(kernels, x, STEPS, capacity, vec)
    want = dwt.fwd_level_plain(x, False, STEPS)
    for g, r in zip(got, want):
        assert _bits_equal(g, r)
    dbl = [2 * b - torch.sign(b) for b in want]
    assert _bits_equal(_inv(kernels, dbl, h, w, STEPS, capacity, vec),
                       dwt.inv_level_plain(*dbl, h, w, False, STEPS))
    fl = dwt.fwd_level_plain(x, False)
    assert _bits_equal(_inv(kernels, fl, h, w, (0.0,) * 4, capacity, vec),
                       dwt.inv_level_plain(*fl, h, w, False))


def _ict_fwd(kernels, planes, ict, prec, sgnd, step):
    out = torch.empty(planes.shape,
                      dtype=torch.int32 if step > 0 else torch.float32)
    m = [v for row in mct.ICT_FWD_F32 for v in row]
    consts = m + [f32(step)]
    assert kernels["host_ict_fwd"](
        planes.data_ptr(), out.data_ptr(), planes.shape[0],
        planes[0].numel(), 0 if sgnd else 1 << (prec - 1), int(ict),
        _floats(consts)) == 0
    return out


def _ict_inv(kernels, x, ict, prec, sgnd, step):
    out = torch.empty(x.shape, dtype=torch.int32)
    m = mct.ICT_INV_F32
    consts = (m[0][2], m[1][1], m[1][2], m[2][1],
              f32(0.5 * step) if step > 0 else 0.0)
    assert kernels["host_ict_inv"](
        x.data_ptr(), out.data_ptr(), x.shape[0], x[0].numel(), prec,
        int(sgnd), int(ict), _floats(consts)) == 0
    return out


@pytest.mark.parametrize("c,mct_", [(1, 0), (3, 0), (3, 1), (4, 1)])
@pytest.mark.parametrize("prec,sgnd", [(8, False), (12, True), (16, False),
                                       (16, True)])
def test_ict_kernels_match_twins(kernels, c, mct_, prec, sgnd):
    rng = np.random.default_rng(prec + c)
    lo = -(1 << (prec - 1)) if sgnd else 0
    planes = torch.from_numpy(rng.integers(lo, lo + (1 << prec),
                                           (c, 2, 37, 29)).astype(np.int32))
    kw = dict(mct=mct_, prec=prec, sgnd=sgnd)
    ict = mct._ict(mct_, planes)
    for step in (0.0, 0.73):
        got = _ict_fwd(kernels, planes, ict, prec, sgnd, step)
        assert _bits_equal(got, mct.ict_forward_shift_plain(
            planes, step=step, **kw))
    # the inverse from floats around the range, so the clip engages, and
    # from doubled-domain ints
    x = torch.from_numpy(rng.normal(0, 1 << prec, planes.shape).astype(
        np.float32))
    assert _bits_equal(_ict_inv(kernels, x, ict, prec, sgnd, 0.0),
                       mct.ict_inverse_unshift_plain(x, **kw))
    q = torch.from_numpy(rng.integers(-(1 << prec), 1 << prec,
                                      planes.shape).astype(np.int32))
    assert _bits_equal(_ict_inv(kernels, q, ict, prec, sgnd, 0.73),
                       mct.ict_inverse_unshift_plain(q, step=0.73, **kw))


def test_ict_inverse_extremes(kernels):
    """NaN, infinities, huge values and ties: the saturating, NaN-to-0
    conversion and the wrapping unshift, as the twin (and XLA) do them."""
    vals = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 2.5, 3.5, -2.5,
                     -0.5, 0.5, 2147483520.0, -2147483648.0, 1e-40,
                     -1e-40, 255.5, 127.49999], np.float32)
    x = torch.from_numpy(np.resize(vals, (4, 1, 4, 16)).copy())
    x[:3] = x[:3].flip(-1)
    for prec, sgnd in ((8, False), (8, True), (16, False), (31, True)):
        for mct_ in (0, 1):
            kw = dict(mct=mct_, prec=prec, sgnd=sgnd)
            assert _bits_equal(
                _ict_inv(kernels, x, mct._ict(mct_, x), prec, sgnd, 0.0),
                mct.ict_inverse_unshift_plain(x, **kw)), (prec, sgnd, mct_)
    q = torch.tensor([[2 ** 31 - 1, -(2 ** 31), 7, -7]], dtype=torch.int32)
    assert _bits_equal(_ict_inv(kernels, q, False, 8, False, 3e9),
                       mct.ict_inverse_unshift_plain(q, mct=0, prec=8,
                                                     sgnd=False, step=3e9))


def test_quantizer_extremes(kernels):
    """NaN, infinities and huge coefficients quantize as the twin does
    (saturating at INT32_MAX in magnitude, NaN to 0)."""
    vals = np.array([np.nan, np.inf, -np.inf, 3e38, -3e38, 0.0, -0.0, 1e-40,
                     5.0, -5.0, 4.999999], np.float32)
    x = torch.from_numpy(np.resize(vals, (1, 8, 8)).copy())
    got = _fwd(kernels, x, (1e-3, 0.5, 0.5, 0.5))
    want = dwt.fwd_level_plain(x, False, (1e-3, 0.5, 0.5, 0.5))
    for g, r in zip(got, want):
        assert _bits_equal(g, r)
