"""The MQ kernels' own sources, run on the CPU, against the twins.

grok_tpu_torch/csrc/mq_encode.cu and mq_decode.cu are compiled with g++
under tests/mq_host_shim.h (a CTA as 32 host threads, the warp intrinsics
emulated, the `extern "C"` launcher replaced by one that runs the grid),
fed the wrappers' own arguments (`encode_args`, `decode_args`,
`device_tables`, built on the CPU) and held bit for bit to the plain twins:
codewords, rates, terminations, distortions, e0 and samples.  This checks
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

import torch_mq_cases as cases
from grok_tpu_torch.ops import mq_decode, mq_encode
from grok_tpu_torch.params import CblkStyle

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "grok_tpu_torch", "csrc")
CPU = torch.device("cpu")
_P, _I = ctypes.c_void_p, ctypes.c_int

_LAUNCHERS = {
    "mq_encode.cu": ("host_mq_encode", (_P,) * 9 + (_I,), '''
extern "C" int host_mq_encode(const void* desc, const void* tables,
    void* slots, void* packed, void* used, void* meta, void* rates,
    void* terms, void* dists, int nblocks) {
  run_grid(nblocks, [&] {
    mq_encode_kernel((const int64_t*)desc, (const uint8_t*)tables,
        (uint8_t*)slots, (uint8_t*)packed, (unsigned long long*)used,
        (int64_t*)meta, (int32_t*)rates, (uint8_t*)terms, (int64_t*)dists);
  });
  return 0;
}
'''),
    "mq_decode.cu": ("host_mq_decode", (_P,) * 5 + (_I,), '''
extern "C" int host_mq_decode(const void* desc, const void* tables,
    const void* segs, const void* pmap, const void* data, int nblocks) {
  run_grid(nblocks, [&] {
    mq_decode_kernel((const int64_t*)desc, (const uint8_t*)tables,
        (const int32_t*)segs, (const uint8_t*)pmap, (const uint8_t*)data);
  });
  return 0;
}
'''),
}


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    """The two kernels built for the host: {source: C function}."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("mq_host_kernels")
    (out / "cuda_runtime.h").write_text("")
    fns = {}
    for src, (name, argtypes, launcher) in _LAUNCHERS.items():
        text = open(os.path.join(CSRC, src)).read()
        tu = out / f"{name}.cc"
        tu.write_text('#include "mq_host_shim.h"\n'
                      + text[:text.index('extern "C"')] + launcher)
        lib = out / f"lib{name}.so"
        proc = subprocess.run(
            [gxx, "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC",
             f"-I{out}", f"-I{HERE}", f"-I{CSRC}", "-o", str(lib), str(tu)],
            capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr
        fn = getattr(ctypes.CDLL(str(lib)), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[src] = fn
    return fns


def _encode(kernels, blocks, orients, lazy, dist):
    n = len(blocks)
    args = mq_encode.encode_args(blocks, orients, lazy, dist, [26] * n, CPU)
    args[3].zero_()
    tabs = mq_encode.device_tables(CPU)
    kernels["mq_encode.cu"](*(t.data_ptr() for t in (args[0], tabs,
                                                     *args[1:8])), n)
    return mq_encode.finish_encode(args)


def _decode(kernels, items):
    outs = [torch.full((it[4], it[5]), 12345, dtype=torch.int32)
            for it in items]
    args = mq_decode.decode_args(items, CPU, outs)
    tabs = mq_encode.device_tables(CPU)
    kernels["mq_decode.cu"](*(t.data_ptr() for t in (args[0], tabs,
                                                     *args[1:4])), len(items))
    return outs


def _same(a, b):
    assert a.data == b.data
    for f in ("numbps", "rates", "terms", "dists", "e0"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def _items(enc, blocks, orients, lazy, capped):
    """Decode items of the encode's codewords; with capped, every third
    block keeps 2/3 of its passes."""
    items = []
    for k, b in enumerate(blocks):
        n = enc.num_passes(k)
        npd = max(1, 2 * n // 3) if capped and k % 3 == 1 and n else n
        seg, last = [], 0
        for i in range(npd):
            if enc.terms[k, i] or i == npd - 1:
                seg.append(int(enc.rates[k, i]) - last)
                last = int(enc.rates[k, i])
        items.append((enc.data[k][:last], seg, npd, int(enc.numbps[k]),
                      b.shape[0], b.shape[1], orients[k],
                      CblkStyle.LAZY if lazy[k] else CblkStyle.NONE))
    return items


def _round(kernels, blocks, orients, lazy, dist, capped=True):
    """Both kernels against the twins: the encode, then the decode of its
    codewords."""
    blocks = [torch.from_numpy(np.ascontiguousarray(b)) for b in blocks]
    n = len(blocks)
    per = (lambda v: [int(v)] * n if np.isscalar(v) else [int(x) for x in v])
    orients, lazy, dist = per(orients), per(lazy), per(dist)
    enc = _encode(kernels, blocks, orients, lazy, dist)
    _same(enc, mq_encode.encode_cblks_mq_plain(blocks, orients, lazy, dist))
    items = _items(enc, blocks, orients, lazy, capped)
    for o, w in zip(_decode(kernels, items),
                    mq_decode.decode_cblks_mq_plain(items, CPU)):
        assert torch.equal(o, w)
    return enc


@pytest.mark.parametrize("style", cases.STYLES)
@pytest.mark.parametrize("case", cases.ENC_CASES)
def test_host_kernels_match_twins(kernels, case, style):
    rng = np.random.default_rng(21)
    bl = list(cases.enc_blocks(rng, *case))
    _round(kernels, bl, rng.integers(0, 4, len(bl)), style != cases.STYLES[0],
           0)


@pytest.mark.parametrize("lazy", [0, 1])
def test_host_kernels_distortions(kernels, lazy):
    rng = np.random.default_rng(22)
    _round(kernels, cases.dist_blocks(rng), 0, lazy, 1)


def test_host_kernels_mixed_batch(kernels):
    rng = np.random.default_rng(23)
    bl = cases.mixed_blocks(rng, 8)
    n = len(bl)
    _round(kernels, bl, rng.integers(0, 4, n), rng.integers(0, 2, n),
           [int(np.abs(b).max(initial=0) < (1 << 20)) for b in bl])


def test_host_kernels_extreme_shapes(kernels):
    """4x1024, 1024x4, 8x512, 512x8 and 64x64 in one launch."""
    rng = np.random.default_rng(24)
    bl = cases.extreme_blocks(rng, mx=40)
    _round(kernels, bl, rng.integers(0, 4, len(bl)), 1, 1)


def test_host_decode_corrupt_streams(kernels):
    """Pass-capped, corrupt and truncated streams decode as the twin (and
    grok_tpu's device decoder) decodes them."""
    rng = np.random.default_rng(25)
    bl = cases.mixed_blocks(rng, 8)
    items = cases.dec_items(rng, bl, [cases.STYLES[k % 2]
                                      for k in range(len(bl))])
    items = items + cases.corrupt_items(rng, items, 12)
    for o, w in zip(_decode(kernels, items),
                    mq_decode.decode_cblks_mq_plain(items, CPU)):
        assert torch.equal(o, w)


@pytest.mark.parametrize("style", cases.STYLES)
def test_host_kernels_full_depth_lossless(kernels, style):
    """Lossless blocks coded to the last of 19 planes and decoded with
    every pass, in one launch with photo-depth blocks."""
    rng = np.random.default_rng(26)
    bl = cases.full_depth_blocks(rng)
    enc = _round(kernels, bl, rng.integers(0, 4, len(bl)),
                 style == CblkStyle.LAZY, 0, capped=False)
    assert enc.numbps.tolist()[:2] == [19, 19]
    assert enc.num_passes(0) == 3 * 19 - 2
    assert max(enc.numbps[3:]) <= 10


def test_host_encode_slot_overflow_raises(kernels):
    """A block whose codeword outgrows its slot writes nothing past it and
    nothing into the packed pool, reports STATUS_SLOT, and the wrapper
    raises; the other blocks of the launch code as the twin codes them."""
    rng = np.random.default_rng(27)
    deep, _, noise, photo, _ = cases.full_depth_blocks(rng)
    blocks = [torch.from_numpy(b) for b in (photo, noise, deep)]
    n = len(blocks)
    # the deep block's slot sized for a block of one plane: 2,389 bytes
    args = list(mq_encode.encode_args(blocks, [1] * n, [0] * n, [0] * n,
                                      [26, 26, 1], CPU))
    total = len(args[1])
    args[1] = torch.full((total + 4096,), 0xA5, dtype=torch.uint8)
    args[2] = torch.full((total + 4096,), 0xA5, dtype=torch.uint8)
    args[3].zero_()
    kernels["mq_encode.cu"](*(t.data_ptr() for t in (
        args[0], mq_encode.device_tables(CPU), *args[1:8])), n)
    meta = args[4].numpy()
    assert meta[:, 3].tolist() == [0, 0, mq_encode.STATUS_SLOT]
    assert int(args[1][total:].ne(0xA5).sum()) == 0
    used = int(args[3][0])
    assert used == int(meta[:2, 1].sum())
    assert int(args[2][used:].ne(0xA5).sum()) == 0
    twin = mq_encode.encode_cblks_mq_plain(blocks[:2], [1, 1], 0)
    packed = args[2].numpy()
    for k in range(2):
        off, ln = meta[k, :2].tolist()
        assert packed[off:off + ln].tobytes() == twin.data[k]
    with pytest.raises(RuntimeError, match="outgrew its slot"):
        mq_encode.finish_encode(args)
