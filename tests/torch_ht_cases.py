"""Inputs shared by the HT tests of the port (tests/test_torch_ht.py on the
CPU, tests/test_torch_cuda.py on the card): codeblocks made from a seed
with numpy, segments, corrupt streams and the three CxtVLC table swaps;
and `check_decode`, the HT decode kernels' outputs held to the twins stage
by stage.  Imports neither jax nor grok_tpu, so the card tests can use
it."""

import numpy as np
import torch

NUM_CTX = 8

# (h, w) of the encode cases, zero densities and magnitude ceilings
ENC_SHAPES = [(2, 8), (8, 2), (32, 32), (64, 32), (64, 64)]
DENSITIES = [0.05, 0.35, 0.65, 0.95]
MAX_MAG = (1 << 25) - 1
# mixed shapes decoded in one batch (grok_tpu's test_device_ops.py)
DEC_SHAPES = [(32, 32), (32, 12), (10, 32), (10, 12), (2, 4)]


def blocks(rng, h, w, n=4, mag=MAX_MAG):
    """n int32 (h, w) blocks, the i-th with zero density DENSITIES[i % 4]
    and magnitudes below `mag`, scaled down block by block so every bit
    depth shows up."""
    out = rng.integers(-mag, mag + 1, size=(n, h, w)).astype(np.int32)
    for i in range(n):
        out[i][rng.random((h, w)) < DENSITIES[i % len(DENSITIES)]] = 0
        out[i] >>= int(rng.integers(0, 24))
    return out


def dense_ff():
    """Blocks whose packed MagSgn bytes are mostly 0xFF, so stuffing grows
    the stream (grok_tpu's test_device_ops.py:223)."""
    batch = np.full((2, 32, 32), (1 << 20) - 1, dtype=np.int32)
    batch[0, ::2, ::2] = -((1 << 20) - 1)
    return batch


def corrupt(rng, segs, n=24):
    """Random bytes with a valid Scup, then truncations of real segments
    (half, one byte, none), as (data, h, w)."""
    out = []
    for i in range(n):
        h, w = DEC_SHAPES[i % len(DEC_SHAPES)]
        size = int(rng.integers(4, 300))
        d = bytearray(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        scup = int(rng.integers(2, size + 1))
        d[-1] = (scup >> 4) & 0xFF
        d[-2] = (d[-2] & 0xF0) | (scup & 0xF)
        out.append((bytes(d), h, w))
    for data, h, w in segs:
        out += [(data[:len(data) // 2], h, w), (data[:1], h, w),
                (b"", h, w)]
    return out


def bad_scup(rng):
    """Segments with fewer than 2 bytes, a Scup below 2 or above the
    length, as (data, h, w)."""
    body = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
    return [(b"", 16, 16), (b"\x07", 16, 16)] + [
        (body[:-2] + bytes([v & 0xF, v >> 4]), 16, 16)
        for v in (0, 1, 41, 4095)]


# an 8x8 block's corrupt segment whose MagSgn cursor goes negative, so it
# reads at cursor + L, L from the batch's longest stream
WRAP_SEG = bytes.fromhex("e92f42458210c0a1b5a298cdc623cb5f965f9826081301")


VL_LENS = [2, 7, 3, 5, 4, 6, 3, 5, 4, 7, 3, 5, 4, 6, 5, 7]


def _canonical_code(lens):
    order = sorted(range(16), key=lambda r: (lens[r], r))
    cwds = [0] * 16
    code, prev = 0, lens[order[0]]
    for r in order[1:]:
        code = (code + 1) << (lens[r] - prev)
        cwds[r] = code
        prev = lens[r]
    return cwds


def table_swaps():
    """{name: (enc_cwd, enc_len)}: fixed-length permuted, variable-length
    (2-7 bit canonical prefix code) and context-varying (a different code
    in every context) table sets, as grok_tpu's tests install them."""
    fixed = (np.tile(np.arange(16, dtype=np.uint8) ^ 9, (NUM_CTX, 1)),
             np.full((NUM_CTX, 16), 4, dtype=np.uint8))
    variable = (np.tile(np.asarray(_canonical_code(VL_LENS), np.uint8),
                        (NUM_CTX, 1)),
                np.tile(np.asarray(VL_LENS, np.uint8), (NUM_CTX, 1)))
    enc = np.zeros((NUM_CTX, 16), np.uint8)
    ln = np.zeros((NUM_CTX, 16), np.uint8)
    for c in range(NUM_CTX):
        lens = VL_LENS[c:] + VL_LENS[:c]
        enc[c] = _canonical_code(lens)
        ln[c] = lens
    return {"fixed": fixed, "variable": variable, "context": (enc, ln)}


def check_decode(ht_decode, args, outs, items):
    """The three HT decode launches' outputs on `decode_args`' tensors
    (`args`, on any device) against the twins of grok_tpu_torch.ops.
    ht_decode, bit for bit: grk_ht_destuff's streams (the words, the two
    zero words after each, the bit counts and the offsets grk_ht_decode
    reads) and the batch's longest against `destuff_streams`, grk_ht_decode's
    rho and umax against `quad_chains_plain`, and the samples in `outs`
    against `decode_cblks_ht_plain`."""
    desc, data, scratch, streams, longest, rho, umax = (
        t.cpu() for t in args[:7])
    first, count, step = ht_decode.split_segments(data, desc[:, 4],
                                                  desc[:, 5])
    bits, starts, nbits = ht_decode.destuff_streams(data, first, count, step)
    bits, starts, nbits = bits.numpy(), starts.numpy(), nbits.numpy()
    got = streams.numpy().reshape(-1, 2)
    assert np.array_equal(got[:, 1], nbits)
    assert int(longest) == int(nbits.max(initial=0))
    # each stream after the last, its region (count + 3) // 4 + 2 words
    region = (count.numpy().reshape(-1, 3) + 3) // 4 + 2
    offs = desc[:, 6].numpy()[:, None] + np.cumsum(region, 1) - region
    assert np.array_equal(got[:, 0], offs.reshape(-1))
    words = scratch.numpy().view(np.uint32)
    for (off, n), s0 in zip(got.tolist(), starts.tolist()):
        nw = -(-n // 32)
        want = np.zeros(32 * (nw + 2), np.uint8)
        want[:n] = bits[s0:s0 + n]
        assert np.array_equal(words[off:off + nw + 2],
                              np.packbits(want).view(">u4").astype(
                                  np.uint32))
    rho_q, umax_q = ht_decode.quad_chains_plain(items)
    for i, (off, (_, h, w)) in enumerate(zip(desc[:, 7].tolist(), items)):
        nq = (h // 2) * (w // 2)
        assert torch.equal(rho[off:off + nq].to(torch.int64), rho_q[i, :nq])
        assert torch.equal(umax[off:off + nq].to(torch.int64),
                           umax_q[i, :nq])
    for o, w in zip(outs, ht_decode.decode_cblks_ht_plain(items)):
        assert torch.equal(o.cpu(), w)
