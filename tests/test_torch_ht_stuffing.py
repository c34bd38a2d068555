"""The HT twins' 0xFF stuffing, destuffing, segment assembly and Scup
parsing against grok_tpu, on the CPU, tolerance 0.

Stuffing (ops/ht_encode.py `stuff_streams`) against grok_tpu's `stuff_bits`
and `_stuff_bits_py`; destuffing (ops/ht_decode.py `destuff_streams`)
against grok_tpu's `_destuff`; whole segments of the encode twin against
grok_tpu's device coder; and the decode twin on raw segments with a bad
Scup and on a batch where a corrupt block's output depends on another
block's longest stream, against grok_tpu's device decoder.
"""

import numpy as np
import pytest
import torch

import torch_ht_cases as cases
from grok_tpu.ops import ht_decode as ref_dec
from grok_tpu.ops import ht_encode as ref_enc
from grok_tpu.t1 import ht as ref_ht

from grok_tpu_torch.ops import ht_decode, ht_encode


def _stuff(streams):
    """The twin's stuffing of [(packed bytes, nbits)], as bytes each."""
    bits, starts, nbits, at = [], [], [], 0
    for raw, n in streams:
        b = np.unpackbits(np.frombuffer(raw, np.uint8))[:n]
        region = 8 * ((n + 7) // 8 + 1)
        bits.append(np.concatenate([b, np.zeros(region - n, np.uint8)]))
        starts.append(at)
        nbits.append(n)
        at += region
    out, offs, lens = ht_encode.stuff_streams(
        torch.from_numpy(np.concatenate(bits)), torch.tensor(starts),
        torch.tensor(nbits))
    out = out.numpy()
    return [out[o:o + n].tobytes() for o, n in zip(offs.tolist(),
                                                   lens.tolist())]


def _streams(rng):
    """Random streams of 0, 1, 7, 8, 9 and more bits, all-ones streams,
    0xFF-dense streams and streams that end on a 0xFF byte."""
    out = []
    for n in (0, 1, 7, 8, 9, 15, 16, 17, 63, 64, 65, 300, 2049):
        raw = rng.integers(0, 256, (n + 7) // 8 + 1, dtype=np.uint8)
        out.append((raw.tobytes(), n))
    for n in (1, 7, 8, 9, 15, 16, 23, 24, 64, 71, 200):
        out.append((b"\xff" * ((n + 7) // 8), n))
    for _ in range(12):   # mostly 0xFF bytes, at every bit alignment
        n = int(rng.integers(8, 400))
        raw = np.full((n + 7) // 8, 0xFF, np.uint8)
        raw[rng.random(len(raw)) < 0.15] = rng.integers(0, 256)
        out.append((raw.tobytes(), n))
    for n in (8, 16, 24, 8 * 37):  # the last 8 bits are all ones
        raw = rng.integers(0, 256, n // 8, dtype=np.uint8)
        raw[-1] = 0xFF
        out.append((raw.tobytes(), n))
    return out


def test_stuffing_matches_reference(rng):
    """All streams in one call, each equal to grok_tpu's stuffing of it on
    its own: 7 bits after 0xFF, zero-padded last byte, the 0x00 guard,
    nothing for 0 bits."""
    streams = _streams(rng)
    got = _stuff(streams)
    for (raw, n), g in zip(streams, got):
        want = ref_enc.stuff_bits(np.frombuffer(raw, np.uint8), n)
        assert g == want, n
        if n:
            assert g == ref_enc._stuff_bits_py(np.frombuffer(raw, np.uint8),
                                               n)
    assert got[0] == b""
    # the streams ending on 0xFF carry the guard byte
    assert sum(g.endswith(b"\xff\x00") for g in got[-4:]) >= 3


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9])
def test_stuffing_short_streams(rng, n):
    for raw in (rng.integers(0, 256, 2, dtype=np.uint8).tobytes(),
                b"\xff\xff"):
        got, = _stuff([(raw, n)])
        assert got == ref_enc.stuff_bits(np.frombuffer(raw, np.uint8), n)


def _destuff(chunks):
    """The twin's destuffing of [(bytes, backward)], as 0/1 arrays."""
    data = np.frombuffer(b"".join(c for c, _ in chunks) or b"\0", np.uint8)
    first, count, step, at = [], [], [], 0
    for c, backward in chunks:
        first.append(at + len(c) - 1 if backward else at)
        count.append(len(c))
        step.append(-1 if backward else 1)
        at += len(c)
    bits, starts, nbits = ht_decode.destuff_streams(
        torch.from_numpy(data.copy()), torch.tensor(first),
        torch.tensor(count), torch.tensor(step))
    bits = bits.numpy()
    return [bits[s:s + n] for s, n in zip(starts.tolist(), nbits.tolist())]


def test_destuffing_matches_reference(rng):
    """Random bytes, 0xFF runs, bytes with the top bit set after a 0xFF,
    read forward and backward."""
    chunks = [b"", b"\xff", b"\xff\x80", b"\xff\xff\xff\xfe", b"\x7f\xff"]
    for n in (1, 2, 9, 33, 100, 1000):
        raw = rng.integers(0, 256, n, dtype=np.uint8)
        raw[rng.random(n) < 0.3] = 0xFF
        chunks.append(raw.tobytes())
    items = [(c, False) for c in chunks] + [(c, True) for c in chunks]
    for (c, backward), got in zip(items, _destuff(items)):
        want = ref_dec._destuff(c[::-1] if backward else c)
        assert np.array_equal(got, want), (c[:8], backward)
    # a byte with the top bit set after 0xFF gives its low 7 bits only
    got, = _destuff([(b"\xff\xc1", False)])
    assert got.tolist() == [1] * 8 + [1, 0, 0, 0, 0, 0, 1]


def test_encode_twin_segments_dense_ff():
    """The 0xFF-dense blocks, whose stuffing grows the MagSgn stream, with
    their all-ones and mixed-sign variants in one call: segments equal
    grok_tpu's device and Python coders, and decode back exactly."""
    batch = np.concatenate([cases.dense_ff(),
                            -cases.dense_ff()[:1],
                            np.full((1, 32, 32), (1 << 24) - 1, np.int32)])
    segs, _ = ht_encode.encode_cblks_ht_plain(
        [torch.from_numpy(b) for b in batch])
    assert segs == ref_enc.encode_cblks_ht_device(batch)
    assert segs == [ref_ht.encode_cblk_ht(b) for b in batch]
    items = [(s, 32, 32) for s, _ in segs]
    for g, b in zip(ht_decode.decode_cblks_ht_plain(items), batch):
        exp = np.where(b != 0, np.sign(b) * (2 * np.abs(b) + 1), 0)
        assert np.array_equal(g.numpy(), exp)


def _bad_scup_items(rng):
    """Segments with fewer than 2 bytes, a Scup below 2 and one above the
    segment's length, beside a valid one."""
    c = rng.integers(-300, 300, (16, 16)).astype(np.int32)
    good = ref_ht.encode_cblk_ht(c)[0]
    body = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
    items = [(good, 16, 16), (b"", 16, 16), (b"\x07", 16, 16)]
    for scup in (0, 1, 41, 42, 4095):  # below 2, then above the length
        items.append((body[:-2] + bytes([scup & 0xF, scup >> 4]), 16, 16))
    items.append((good[:-2] + bytes([0x0F, 0xFF]), 16, 16))
    return items


def test_decode_twin_bad_scup(rng):
    items = _bad_scup_items(rng)
    data, desc = ht_decode.join_segments(items)
    first, count, _ = ht_decode.split_segments(
        torch.from_numpy(data.copy()), torch.from_numpy(desc[:, 4]),
        torch.from_numpy(desc[:, 5]))
    assert count.reshape(-1, 3)[1:].sum() == 0   # no stream read
    got = ht_decode.decode_cblks_ht_plain(items)
    for g, r in zip(got, ref_dec.decode_cblks_ht_device(items)):
        assert np.array_equal(g.numpy(), r)
    assert np.array_equal(got[0].numpy(),
                          ref_ht.decode_cblk_ht(items[0][0], 16, 16))


# random bytes with a valid Scup whose MagSgn cursor goes negative: where
# it reads depends on the padded length L of its batch
WRAPS = bytes.fromhex("e92f42458210c0a1b5a298cdc623cb5f965f9826081301")


def test_wrap_bits_follow_the_batch():
    """The corrupt block decodes differently alone and beside a long
    block, and equals grok_tpu's device decoder both ways (ROADMAP C8)."""
    big = np.random.default_rng(7).integers(-(1 << 20), 1 << 20, (64, 64)
                                            ).astype(np.int32)
    long_seg = ref_ht.encode_cblk_ht(big)[0]
    alone = [(WRAPS, 8, 8)]
    beside = [(WRAPS, 8, 8), (long_seg, 64, 64)]
    outs = []
    for batch in (alone, beside):
        got = ht_decode.decode_cblks_ht_plain(batch)
        for g, r in zip(got, ref_dec.decode_cblks_ht_device(batch)):
            assert np.array_equal(g.numpy(), r)
        outs.append(got[0])
    assert not torch.equal(outs[0], outs[1])
    for batch in (alone, beside):  # grok_tpu's L, from the longest stream
        data, desc = ht_decode.join_segments(batch)
        t = torch.from_numpy(data.copy())
        _, _, nbits = ht_decode.destuff_streams(
            t, *ht_decode.split_segments(t, torch.from_numpy(desc[:, 4]),
                                         torch.from_numpy(desc[:, 5])))
        longest = max(len(s) for d, _, _ in batch for s in _ref_streams(d))
        assert ht_decode.wrap_bits(nbits) == \
            1 << (max(longest, 1) + 63).bit_length()


def _ref_streams(data):
    if len(data) < 2:
        return ()
    scup = (data[-1] << 4) | (data[-2] & 0x0F)
    if scup < 2 or scup > len(data):
        return ()
    suffix = data[len(data) - scup:len(data) - 2]
    return (ref_dec._destuff(data[:len(data) - scup]),
            ref_dec._destuff(suffix), ref_dec._destuff(suffix[::-1]))


def test_suffix_overflow_raises(monkeypatch, rng):
    """A Scup above SCUP_MAX raises, as grok_tpu's assembly does above
    4079 (no legal block reaches it, so the limit is lowered here)."""
    block = torch.from_numpy(rng.integers(-99, 99, (16, 16)).astype(
        np.int32))
    segs, _ = ht_encode.encode_cblks_ht_plain([block])
    scup = (segs[0][0][-1] << 4) | (segs[0][0][-2] & 0x0F)
    monkeypatch.setattr(ht_encode, "SCUP_MAX", scup - 1)
    with pytest.raises(ValueError, match="HT suffix overflow"):
        ht_encode.encode_cblks_ht_plain([block])
    monkeypatch.setattr(ht_encode, "SCUP_MAX", scup)
    assert ht_encode.encode_cblks_ht_plain([block])[0] == segs
