"""The HT decode kernels' own source, run on the CPU, against the twins.

grok_tpu_torch/csrc/ht_decode.cu is compiled with g++ under
tests/grid_host_shim.h (a CTA as fibers on one host thread; the warp
shuffles, votes and reductions and __syncthreads as barriers that yield, so
a missing barrier fails deterministically; cp.async a plain copy), its
`__shared__` arrays made static (one CTA runs at a time) and its dynamic
shared memory the shim's buffer.  The `extern "C"` launchers are replaced
by ones that run the grid with the CTA shapes the card's launchers use, and
the kernels are fed the wrapper's own arguments (`decode_args`, built on
the CPU) and held bit for bit to the twins: grk_ht_destuff's streams (the
words, the two zero words after each, the bit counts, the offsets
grk_ht_decode reads) and the batch's longest against `destuff_streams`,
grk_ht_decode's rho and umax against `quad_chains_plain`, and
grk_ht_magsgn's samples against `decode_cblks_ht_plain`, on
tests/torch_ht_cases.py's inputs: mixed shapes, 0xFF-dense blocks, bad
Scup, corrupt and truncated segments, a MagSgn cursor that wraps by L, the
three table swaps, batches of several CTAs, and destinations with and
without 8-byte aligned rows.  This checks the kernels' logic where there
is no card; their build for sm_90a and their speed show only on one
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import torch_ht_cases as cases
from grok_tpu_torch.ops import ht_decode, ht_encode
from grok_tpu_torch.t1 import ht_tables

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "grok_tpu_torch", "csrc")
CPU = torch.device("cpu")
_P, _I = ctypes.c_void_p, ctypes.c_int

_LAUNCHERS = '''
extern "C" int host_ht_destuff(const void* desc, const void* data,
                               void* scratch, void* streams, void* longest,
                               int nblocks) {
  if (nblocks <= 0 || reinterpret_cast<uintptr_t>(data) & 15) return 2;
  return run_grid(dim3((nblocks + kDsWarps - 1) / kDsWarps),
                  dim3(32 * kDsWarps), [&] {
    ht_destuff_kernel((const int64_t*)desc, (const uint8_t*)data,
                      (uint32_t*)scratch, (int64_t*)streams,
                      (unsigned long long*)longest, nblocks);
  });
}
extern "C" int host_ht_decode(const void* desc, const void* streams,
                              const void* scratch, const void* lut_rho,
                              const void* lut_len, void* rho, void* umax,
                              int nblocks, int maxc, int max_qw) {
  return run_grid(dim3((nblocks + 31) / 32), dim3(32), [&] {
    ht_decode_kernel((const int64_t*)desc, (const int64_t*)streams,
                     (const uint32_t*)scratch, (const uint8_t*)lut_rho,
                     (const uint8_t*)lut_len, (uint8_t*)rho,
                     (int32_t*)umax, nblocks, maxc, max_qw);
  });
}
extern "C" int host_ht_magsgn(const void* desc, const void* streams,
                              const void* scratch, const void* rho,
                              const void* umax, const void* longest,
                              int nblocks) {
  if (nblocks <= 0 || (reinterpret_cast<uintptr_t>(rho) |
                       reinterpret_cast<uintptr_t>(umax)) & 15) return 2;
  return run_grid(dim3(nblocks), dim3(32 * kMsWarps), [&] {
    ht_magsgn_kernel((const int64_t*)desc, (const int64_t*)streams,
                     (const uint32_t*)scratch, (const uint8_t*)rho,
                     (const int32_t*)umax,
                     (const unsigned long long*)longest);
  });
}
'''
_SIGS = {
    "host_ht_destuff": (_P,) * 5 + (_I,),
    "host_ht_decode": (_P,) * 7 + (_I,) * 3,
    "host_ht_magsgn": (_P,) * 6 + (_I,),
}


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    """The three kernels built for the host: {C function name: function}."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("ht_host_kernels")
    for header in ("cuda_runtime.h", "cuda_pipeline.h"):
        (out / header).write_text("")
    text = open(os.path.join(CSRC, "ht_decode.cu")).read()
    body = text[:text.index('extern "C"')]
    # dynamic shared memory is the shim's buffer; a CTA's static shared
    # arrays are static locals (the CTAs run one after another)
    body = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                  r"\1* const \2 = reinterpret_cast<\1*>(smem);", body)
    body = body.replace("__shared__", "static")
    tu = out / "ht_decode.cc"
    tu.write_text('#include "grid_host_shim.h"\n' + body + _LAUNCHERS)
    lib = out / "libht_decode.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC",
         f"-I{out}", f"-I{HERE}", "-o", str(lib), str(tu)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    so = ctypes.CDLL(str(lib))
    fns = {}
    for name, argtypes in _SIGS.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _decode(kernels, items, outs=None):
    """The three launches on decode_args' CPU tensors, as launch_decode
    makes them; returns (the arguments, the destinations)."""
    if outs is None:
        outs = [torch.full((h, w), 12345, dtype=torch.int32)
                for _, h, w in items]
    args = ht_decode.decode_args(items, CPU, outs)
    desc, data, scratch, streams, longest, rho, umax, max_qw = args
    longest.zero_()
    n = len(items)
    lut_rho, lut_len = ht_decode._device_tables(CPU)
    assert kernels["host_ht_destuff"](*(t.data_ptr() for t in (
        desc, data, scratch, streams, longest)), n) == 0
    assert kernels["host_ht_decode"](*(t.data_ptr() for t in (
        desc, streams, scratch, lut_rho, lut_len, rho, umax)), n,
        ht_tables.MAX_CWD_LEN, max_qw) == 0
    assert kernels["host_ht_magsgn"](*(t.data_ptr() for t in (
        desc, streams, scratch, rho, umax, longest)), n) == 0
    return args, outs


def _segments(rng, shapes, n=4, mag=cases.MAX_MAG):
    """Segments of cases.blocks coded by the twin, as (data, h, w)."""
    items = []
    for h, w in shapes:
        bl = torch.from_numpy(cases.blocks(rng, h, w, n=n, mag=mag))
        segs, _ = ht_encode.encode_cblks_ht_plain(list(bl))
        items += [(s, h, w) for s, _ in segs]
    return items


@pytest.mark.parametrize("shape", cases.ENC_SHAPES)
def test_host_kernels_match_twins(kernels, shape):
    """Densities 0.05-0.95, magnitudes up to 2^25 - 1; 9 blocks, so two
    CTAs of each kernel, the second part empty; long MagSgn streams wrap
    the destuffing ring many times."""
    rng = np.random.default_rng(100 * shape[0] + shape[1])
    items = _segments(rng, [shape], n=9)
    cases.check_decode(ht_decode, *_decode(kernels, items), items)


def test_host_kernels_mixed_shapes(kernels):
    """Mixed shapes in one launch, segments at every byte offset: a
    one-byte and a three-byte segment first shift every MagSgn start."""
    rng = np.random.default_rng(11)
    items = [(b"\x05", 2, 2), (b"\x00\x22\x00", 4, 4)]
    items += _segments(rng, cases.DEC_SHAPES, n=3)
    cases.check_decode(ht_decode, *_decode(kernels, items), items)


def test_host_kernels_dense_ff(kernels):
    """MagSgn bytes mostly 0xFF: stuffing grows the stream and nearly
    every lane drops bits."""
    bl = torch.from_numpy(cases.dense_ff())
    segs, _ = ht_encode.encode_cblks_ht_plain(list(bl))
    items = [(s, 32, 32) for s, _ in segs]
    items += [(bytes([0xFF] * 700) + bytes([0x80, 0x7F, 0xFF, 0x12,
                                           0x0F, 0x2B]), 16, 16)]
    cases.check_decode(ht_decode, *_decode(kernels, items), items)


def test_host_kernels_corrupt(kernels):
    """Random bytes with a valid Scup, and truncations of real segments
    (half, one byte, none), decoded as the twin (and grok_tpu's device
    decoder) decodes them."""
    rng = np.random.default_rng(12)
    items = _segments(rng, cases.DEC_SHAPES, n=2)
    items = cases.corrupt(rng, items, n=24) + items[:3]
    cases.check_decode(ht_decode, *_decode(kernels, items), items)


def test_host_kernels_long_corrupt_magsgn(kernels):
    """Random bytes with a short suffix (Scup 2-64), so the MagSgn stream
    is long: the windows of quads whose umax lies outside [0, 30] are
    read from real bytes, where a shift count outside [0, 31] must give
    what sar32 gives."""
    rng = np.random.default_rng(16)
    items = []
    for i in range(24):
        h, w = cases.DEC_SHAPES[i % len(cases.DEC_SHAPES)]
        size = int(rng.integers(300, 2000))
        d = bytearray(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        scup = int(rng.integers(2, 65))
        d[-1] = (scup >> 4) & 0xFF
        d[-2] = (d[-2] & 0xF0) | (scup & 0xF)
        items.append((bytes(d), h, w))
    cases.check_decode(ht_decode, *_decode(kernels, items), items)


def test_host_kernels_bad_scup_and_wrap(kernels):
    """Bad Scup (fewer than 2 bytes, below 2, above the length) gives
    three empty streams; a corrupt block whose MagSgn cursor goes negative
    reads at cursor + L, alone and beside a long block (another L)."""
    items = cases.bad_scup(np.random.default_rng(8)) + [
        (cases.WRAP_SEG, 8, 8)]
    big = np.random.default_rng(7).integers(-(1 << 20), 1 << 20, (1, 64, 64))
    long_seg = ht_encode.encode_cblks_ht_plain(
        list(torch.from_numpy(big.astype(np.int32))))[0][0][0]
    for batch in (items, items + [(long_seg, 64, 64)]):
        cases.check_decode(ht_decode, *_decode(kernels, batch), batch)


@pytest.mark.parametrize("swap", ["fixed", "variable", "context"])
def test_host_kernels_swapped_tables(kernels, swap):
    """The chain kernel reads the installed CxtVLC tables."""
    rng = np.random.default_rng(13)
    try:
        ht_tables.set_tables(*cases.table_swaps()[swap])
        items = _segments(rng, [(16, 16)], n=6, mag=900)
        items += cases.corrupt(rng, items[:2], n=6)
        cases.check_decode(ht_decode, *_decode(kernels, items), items)
    finally:
        ht_tables.reset_tables()


@pytest.mark.parametrize("aligned", [True, False])
def test_host_kernels_write_views(kernels, aligned):
    """Blocks written in place into views of one band: rows 8-byte aligned
    (one 8-byte store a quad row) or not (4-byte stores), the rest of the
    band untouched."""
    rng = np.random.default_rng(14)
    items = _segments(rng, [(32, 32), (32, 12), (10, 32)], n=1)
    band = torch.full((64, 98 if aligned else 97), 7, dtype=torch.int32)
    x = 0 if aligned else 1
    dests = [band[0:32, x:x + 32], band[32:64, x:x + 12],
             band[0:10, x + 40:x + 72]]
    args, outs = _decode(kernels, items, dests)
    cases.check_decode(ht_decode, args, outs, items)
    mask = torch.ones_like(band, dtype=torch.bool)
    for d in ((slice(0, 32), slice(x, x + 32)),
              (slice(32, 64), slice(x, x + 12)),
              (slice(0, 10), slice(x + 40, x + 72))):
        mask[d] = False
    assert bool((band[mask] == 7).all())


def test_host_kernels_cursor_bound(kernels):
    """The 32-bit MagSgn cursors: random segments decoded as the widest
    blocks (4x1024, 2x1024, 64x64) keep |umax - 1| <= 65 (qx + 1) on every
    quad, the bound the kernel's header derives, and decode as the twin."""
    rng = np.random.default_rng(15)
    items = []
    for h, w in ((4, 1024), (2, 1024), (64, 64)) * 3:
        size = int(rng.integers(600, 3000))
        d = bytearray(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        scup = int(rng.integers(size // 2, min(size, 4079) + 1))
        d[-1] = (scup >> 4) & 0xFF
        d[-2] = (d[-2] & 0xF0) | (scup & 0xF)
        items.append((bytes(d), h, w))
    _, umax_q = ht_decode.quad_chains_plain(items)
    for i, (_, h, w) in enumerate(items):
        qx = torch.arange((h // 2) * (w // 2)) % (w // 2)
        assert bool(((umax_q[i, :len(qx)] - 1).abs() <= 65 * (qx + 1)).all())
    cases.check_decode(ht_decode, *_decode(kernels, items), items)
