"""The MQ kernels' shared-memory sizing and word-form tables, on the CPU.

The kernels (grok_tpu_torch/csrc/mq_{encode,decode}.cu) keep a codeblock's
whole state in dynamic shared memory, sized by the wrapper from the
launch's largest block, and form contexts from native/t1.cc's 16-bit flag
word.  These tests hold the sizing to the card's limit for every legal
codeblock shape, the launch arguments to the batch maximum, the layout
constants to csrc/mq_common.cuh, and the word-form tables to the twins'
context formation.
"""

import os
import re

import numpy as np
import pytest
import torch

from grok_tpu_torch.ops import mq_decode, mq_encode, mq_tables
from grok_tpu_torch.params import CblkStyle
from grok_tpu_torch.t1.coder import _SC_TABLE
from grok_tpu_torch.t1.mq import QE_TABLE

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "grok_tpu_torch", "csrc")

# the shared memory a CTA of an H100 may use
MAX_SMEM = 232448
# every legal (xcb, ycb): 2 <= xcb, ycb <= 10, xcb + ycb <= 12
LEGAL = [(x, y) for x in range(2, 11) for y in range(2, 11) if x + y <= 12]


@pytest.mark.parametrize("xcb,ycb", LEGAL)
def test_smem_fits_every_legal_codeblock(xcb, ycb):
    h, w = 1 << ycb, 1 << xcb
    need = mq_tables.smem_bytes(h, w)
    assert need <= MAX_SMEM
    # the tables, the flag words with their border, the plane map
    assert need >= mq_tables.SMEM_FIXED + (h // 4 + 2) * (w + 2) * 8 \
        + 2 * (h // 4) * w
    # a block cut at a band edge never needs more than its nominal shape
    for hh, ww in ((h - 1, w), (h, w - 1), (max(1, h // 2 + 1), 1),
                   (1, max(1, w // 2 + 1)), (1, 1)):
        if hh > 0 and ww > 0:
            assert mq_tables.smem_bytes(hh, ww) <= need


def test_smem_fits_every_block_the_wrappers_take():
    """check_blocks takes h * w <= 4096 and w <= 1024: all fit, and all
    stay under the 48 KB a launch gets without an opt-in, which the
    kernels' launchers do not ask for."""
    worst = max(mq_tables.smem_bytes(h, w) for w in range(1, 1025)
                for h in range(1, 4096 // w + 1))
    assert worst <= 48 * 1024 <= MAX_SMEM


def _blocks(rng):
    shapes = [(64, 64), (4, 1024), (7, 13), (1024, 4), (32, 32)]
    return [torch.from_numpy(rng.integers(-50, 51, s).astype(np.int32))
            for s in shapes]


def test_launch_uses_the_batch_maximum():
    rng = np.random.default_rng(0)
    blocks = _blocks(rng)
    shapes = [tuple(b.shape) for b in blocks]
    cpu = torch.device("cpu")
    n = len(blocks)
    want = max(mq_tables.smem_bytes(h, w) for h, w in shapes)
    args = mq_encode.encode_args(blocks, [0] * n, [1] * n, [0] * n,
                                 [26] * n, cpu)
    assert args[-1] == want == mq_tables.launch_smem(shapes)
    assert args[0].shape == (n, len(mq_encode.DESC))
    items = [(b"", [], 0, 0, h, w, 0, CblkStyle.LAZY) for h, w in shapes]
    outs = [torch.zeros(s, dtype=torch.int32) for s in shapes]
    dargs = mq_decode.decode_args(items, cpu, outs)
    assert dargs[-1] == want
    assert dargs[0].shape == (n, len(mq_decode.DESC))
    # one block alone: its own size
    one = mq_encode.encode_args(blocks[2:3], [0], [0], [0], [26], cpu)
    assert one[-1] == mq_tables.smem_bytes(7, 13)


def _header_consts():
    text = open(os.path.join(CSRC, "mq_common.cuh")).read()
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}


def test_layout_constants_match_the_kernels():
    c = _header_consts()
    assert c["kTabQe"] == 0
    assert c["kTabZc"] == 4 * mq_tables.QE_FUSED.size
    assert c["kTabSc"] == c["kTabZc"] + mq_tables.ZC_LUT.size
    assert c["kTabInit"] == c["kTabSc"] + mq_tables.SC_WORD.size
    assert c["kTabBytes"] == c["kTabInit"] + mq_tables.INIT_CTX.size
    assert c["kTabBytes"] == mq_encode.device_tables(torch.device(
        "cpu")).numel()
    text = open(os.path.join(CSRC, "mq_common.cuh")).read()
    assert f"kSmemFixed == {mq_tables.SMEM_FIXED}" in text
    # tables 376 + 1024 + 256 B, 19 uint32 states and the sink the lanes
    # that do not lead store into, each to 16 B
    assert mq_tables.SMEM_FIXED == (376 + 1024 + 256 + 15) // 16 * 16 \
        + 2 * ((4 * 19 + 15) // 16 * 16)


def test_fused_qe_table_derives_from_the_standard():
    f = mq_tables.QE_FUSED.astype(np.int64)
    for s, (qe, nmps, nlps, switch) in enumerate(QE_TABLE):
        for mps in range(2):
            e = int(f[2 * s + mps])
            assert e & 0x7FFF == qe
            assert (e >> 15) & 1 == mps
            assert (e >> 16) & 0xFF == 2 * nmps + mps
            assert e >> 24 == 2 * nlps + (mps ^ switch)
    tab = mq_encode.device_tables(torch.device("cpu")).numpy()
    assert np.array_equal(tab[:376].view("<u4"), mq_tables.QE_FUSED)


def test_sc_word_table_derives_from_table_d2():
    """SC_WORD indexed by the word gather (N W E S sig, W E N S neg from
    bit 0), built here from Table D.2 alone."""
    for i in range(256):
        def contrib(sig_bit, neg_bit):
            if not (i >> sig_bit) & 1:
                return 0
            return -1 if (i >> neg_bit) & 1 else 1
        hc = max(-1, min(1, contrib(1, 4) + contrib(2, 5)))
        vc = max(-1, min(1, contrib(0, 6) + contrib(3, 7)))
        off, xr = _SC_TABLE[(hc, vc)]
        assert mq_tables.SC_WORD[i] == (mq_tables.CTX_SC + off) | xr << 7


# native/t1.cc's flag word
_NBR = {(-1, -1): 0, (-1, 0): 1, (-1, 1): 2, (0, -1): 3, (0, 1): 4,
        (1, -1): 5, (1, 0): 6, (1, 1): 7}   # NW N NE W E SW S SE
_NEG = {(0, -1): 8, (0, 1): 9, (-1, 0): 10, (1, 0): 11}   # W E N S


def _words(sig, neg):
    """The flag word of every sample, as set_sig builds it: each
    significant sample sets its bit in its 8 neighbours' words, and its
    sign in its 4 direct neighbours'."""
    h, w = sig.shape
    words = np.zeros((h, w), np.int64)
    for y, x in zip(*np.nonzero(sig)):
        for (dy, dx), bit in _NBR.items():
            ny, nx = y - dy, x - dx   # the sample sees (y, x) at (dy, dx)
            if 0 <= ny < h and 0 <= nx < w:
                words[ny, nx] |= 1 << bit
                if neg[y, x] and (dy, dx) in _NEG:
                    words[ny, nx] |= 1 << _NEG[(dy, dx)]
    return words


def _gather(f):
    return (((f >> 1) & 1) | ((f >> 2) & 6) | ((f >> 3) & 8)
            | ((f >> 4) & 0xF0))


def test_word_contexts_equal_the_twins():
    """On random significance and sign maps, the ZC pattern and SC context
    the kernels form from a flag word equal those the twins form from the
    neighbours (mq_encode._nbr_index with SC_CN, SC_XOR)."""
    rng = np.random.default_rng(3)
    for density in (0.1, 0.5, 0.9):
        sig = rng.random((13, 11)) < density
        neg = rng.random((13, 11)) < 0.5
        words = _words(sig, neg)
        times = torch.from_numpy(np.where(sig, 0, 1 << 30)[None]
                                 .astype(np.int64))
        signs = torch.from_numpy(neg[None].astype(np.int64))
        zc, sc = mq_encode._nbr_index(times, signs, 1)
        zc, sc = zc[0].numpy(), sc[0].numpy()
        assert np.array_equal(words & 0xFF, zc)
        word_sc = mq_tables.SC_WORD[_gather(words)]
        assert np.array_equal(word_sc & 0x7F, mq_tables.SC_CN[sc])
        assert np.array_equal(word_sc >> 7, mq_tables.SC_XOR[sc])
