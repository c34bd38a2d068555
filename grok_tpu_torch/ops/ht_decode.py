"""HT (Part 15) cleanup-pass decoder for batches of codeblocks: the port of
grok_tpu/ops/ht_decode.py.

`decode_cblks_ht(items, device)` takes the segments as Tier-2 hands them
over, (segment, h, w) per codeblock.  The host joins them into one byte
buffer and builds per-block descriptors with numpy; that is all it does.
Each segment's Scup is parsed, and its three streams (MagSgn, the MEL
suffix read forward, the VLC suffix read backward) are 0xFF-destuffed, where
the blocks are decoded.  Then, per block, the MEL automaton and the VLC
quad parse with the u-predictor chain are replayed, and the MagSgn samples
are read from bit offsets that are an exclusive prefix sum of
popcount(rho) * (umax + 1).

On a CUDA device that is three launches of csrc/ht_decode.cu after one
host-to-device copy of the segments: `grk_ht_destuff` (Scup, destuffing,
the batch's longest stream), `grk_ht_decode` (the MEL and VLC chain of
every block, one thread a block) and `grk_ht_magsgn` (the samples, every
block, mixed shapes together, each written at its place in its destination
tensor).  A tile's
blocks can also go as flat arrays: `flat_args` takes the bytes the
segments lie in (a tile's stream as Tier-2 read it) and descriptor rows the
caller built with numpy, and the same three launches run on them.  On the
CPU it is the plain PyTorch twin `decode_cblks_ht_plain`, whose destuffing
(`destuff_streams`) is a running sum of byte widths and one scatter of
bits, vectorised across streams.

Corrupt streams decode exactly as grok_tpu's device decoder decodes them
when the batch is the same (one batch a tile, as its router makes): a bad
Scup (fewer than 2 bytes, Scup below 2 or above the length) gives three
empty streams; reads past a stream's end return zeros; a MagSgn cursor
that went negative reads where JAX's dynamic_slice puts it, at cursor + L
clamped to 0, where L is the batch's padded stream length in bits
(`wrap_bits`, from the longest destuffed stream of the batch); an int32
right shift by a count outside [0, 31] fills with the sign bit (`sar32`);
and sums wrap as int32.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..kernels import launch
from ..t1 import ht_tables
from ..t1.ht import MEL_E
from .ht_encode import check_shapes
from .ht_meta import wrap_int32

_PAD = 8            # zero bytes after every destuffed stream of the twin
_MS_WIN = 31        # umax (<=30) + sign
_VLC_WIN = 17       # max 7-bit CxtVLC cwd + '111' + 7-bit escape
_MEL_RUN_WIN = 5    # max run-length field width
_REF_PAD = 64       # grok_tpu's cursor overrun guard, in bits

# per block, filled by the host: output pointer and row stride (elements),
# h, w, the segment's byte offset and length in the joined buffer, the word
# offset of the block's destuffing scratch on the card and the offset of its
# quads in the rho and umax arrays
DESC = ("out_ptr", "out_stride", "h", "w", "seg_off", "seg_len",
        "scratch_off", "quad_off")
# per block, filled by grk_ht_destuff: word offset and bit count of the
# destuffed MagSgn, MEL and VLC streams in the scratch
STREAMS = ("ms_off", "ms_bits", "mel_off", "mel_bits", "vlc_off",
           "vlc_bits")

# torch.device -> (DEC_LUT_RHO, DEC_LUT_LEN) uint8 tensors on that device
_DEVICE_TABLES: dict = {}


def _device_tables(device: torch.device):
    tabs = _DEVICE_TABLES.get(device)
    if tabs is None:
        tabs = _DEVICE_TABLES[device] = tuple(
            torch.from_numpy(np.ascontiguousarray(t, dtype=np.uint8)).to(
                device)
            for t in (ht_tables.DEC_LUT_RHO, ht_tables.DEC_LUT_LEN))
    return tabs


def scratch_words(seg_len: np.ndarray) -> np.ndarray:
    """Scratch words a segment's three destuffed streams may need: at most
    8 bits a stuffed byte, the MagSgn and MEL streams share the segment
    and the VLC stream reads the MEL bytes again, each stream rounded up
    to whole words and followed by two zero words."""
    return seg_len // 2 + 12


def join_segments(items):
    """The host half of the decode: (joined bytes uint8, desc (B, 8) int64)
    for items of (segment, h, w); the output pointers and strides and the
    scratch and quad offsets are left 0."""
    desc = np.zeros((len(items), len(DESC)), np.int64)
    desc[:, 2:4] = [(h, w) for _, h, w in items]
    check_shapes(desc[:, 2], desc[:, 3])
    segs = [bytes(s) for s, _, _ in items]  # memoryviews join too
    lens = np.fromiter(map(len, segs), np.int64, len(segs))
    desc[:, 4] = np.cumsum(lens) - lens
    desc[:, 5] = lens
    return np.frombuffer(bytearray(b"".join(segs)) or bytearray(1),
                         np.uint8), desc


def _dests(items, device, out):
    if out is None:
        return [torch.empty((h, w), dtype=torch.int32, device=device)
                for _, h, w in items]
    out = list(out)
    if len(out) != len(items):
        raise ValueError("one destination a codeblock")
    for o, (_, h, w) in zip(out, items):
        if o.dtype != torch.int32 or tuple(o.shape) != (h, w) \
                or o.device != device or (w > 1 and o.stride(1) != 1):
            raise ValueError(f"destination must be an int32 ({h}, {w}) "
                             f"tensor on {device} with contiguous rows")
    return out


def decode_cblks_ht(items, device, out=None):
    """Decode HT cleanup segments of mixed shapes.  items: (segment, h, w)
    per codeblock, h and w even.  Writes each block, doubled-domain
    sign * (2m + 1), into `out[i]` (int32 (h, w) tensors on `device` with
    contiguous rows, e.g. views into band tensors) or into new tensors,
    and returns them.  A CUDA device launches the kernels, the CPU runs
    the twin; other devices raise."""
    device = torch.device(device)
    if device.type == "cpu":
        return decode_cblks_ht_plain(items, device, out)
    if device.type != "cuda":
        raise ValueError(f"no kernel route for device {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    out = _dests(items, device, out)
    if items:
        launch_decode(decode_args(items, device, out), device)
    return out


def decode_args(items, device: torch.device, out):
    """The kernels' arguments: (desc, joined segments, scratch, streams,
    longest, rho, umax) on the device and the widest quad row, writing
    items[i] into out[i], which must outlive the launches."""
    data, desc = join_segments(items)
    desc[:, 0] = [o.data_ptr() for o in out]
    desc[:, 1] = [o.stride(0) for o in out]
    return flat_args(data, desc, device)


def flat_args(data, desc: np.ndarray, device: torch.device):
    """decode_args from the bytes the segments lie in (bytes-like or a
    uint8 array) and descriptor rows (B, 8) int64 whose first six columns
    the caller filled; the scratch and quad offsets are set here.  The
    kernels read whole aligned 16-byte chunks: the bytes go up in one copy
    to an allocation padded with zeros to whole chunks, and rho and umax
    have 16 bytes to spare."""
    words = scratch_words(desc[:, 5])
    desc[:, 6] = np.cumsum(words) - words
    quads = (desc[:, 2] // 2) * (desc[:, 3] // 2)
    desc[:, 7] = np.cumsum(quads) - quads
    nq = int(quads.sum())
    src = np.frombuffer(data, np.uint8)
    n = len(src)
    chunks = torch.empty(max(-(-n // 16) * 16, 16), dtype=torch.uint8,
                         device=device)
    chunks[n:].zero_()
    if n:
        with warnings.catch_warnings():
            # read-only bytes: the tensor is only the copy's source
            warnings.simplefilter("ignore", UserWarning)
            chunks[:n].copy_(torch.from_numpy(src))
    return (torch.from_numpy(desc).to(device), chunks,
            torch.empty(int(words.sum()), dtype=torch.int32, device=device),
            torch.empty((len(desc), len(STREAMS)), dtype=torch.int64,
                        device=device),
            torch.empty(1, dtype=torch.int64, device=device),
            torch.empty(nq + 16, dtype=torch.uint8, device=device),
            torch.empty(nq + 4, dtype=torch.int32, device=device),
            int(desc[:, 3].max()) // 2)


def launch_destuff(args, device: torch.device) -> None:
    """One launch of grk_ht_destuff on decode_args' tensors: Scup, the
    destuffed streams, the batch's longest."""
    desc, data, scratch, streams, longest = args[:5]
    longest.zero_()
    launch("ht_destuff", "grk_ht_destuff", device,
           (desc, data, scratch, streams, longest), (len(desc),))


def launch_chains(args, device: torch.device) -> None:
    """One launch of grk_ht_decode after launch_destuff: the MEL and VLC
    chain of every block, rho and umax of every quad."""
    desc, _, scratch, streams, _, rho, umax, max_qw = args
    lut_rho, lut_len = _device_tables(device)
    launch("ht_decode", "grk_ht_decode", device,
           (desc, streams, scratch, lut_rho, lut_len, rho, umax),
           (len(desc), ht_tables.MAX_CWD_LEN, max_qw))


def launch_magsgn(args, device: torch.device) -> None:
    """One launch of grk_ht_magsgn after launch_chains: the samples."""
    desc, _, scratch, streams, longest, rho, umax, _ = args
    launch("ht_magsgn", "grk_ht_magsgn", device,
           (desc, streams, scratch, rho, umax, longest), (len(desc),))


def launch_decode(args, device: torch.device) -> None:
    """The three launches on decode_args' tensors, with no host round trip
    between them."""
    launch_destuff(args, device)
    launch_chains(args, device)
    launch_magsgn(args, device)


# ------------------------------------------------------------ plain twin

def split_segments(data: torch.Tensor, seg_off: torch.Tensor,
                   seg_len: torch.Tensor):
    """Scup of every segment, as grok_tpu's device decoder reads it: the
    (first byte, byte count, step) of the MagSgn, MEL and VLC streams,
    each (3B,) with a block's three together.  MEL is the suffix read
    forward, VLC the suffix read backward; a segment with fewer than 2
    bytes, a Scup below 2 or one above its length has three empty
    streams."""
    d = torch.cat([data.to(torch.int64),
                   torch.zeros(2, dtype=torch.int64, device=data.device)])
    end = seg_off + seg_len
    scup = (d[(end - 1).clamp(min=0)] << 4) | (d[(end - 2).clamp(min=0)]
                                               & 0x0F)
    ok = (seg_len >= 2) & (scup >= 2) & (scup <= seg_len)
    suffix = torch.where(ok, scup - 2, 0)
    first = torch.stack([seg_off, end - scup, end - 3], dim=1)
    count = torch.stack([torch.where(ok, seg_len - scup, 0), suffix,
                         suffix], dim=1)
    step = torch.tensor([1, 1, -1], device=data.device).expand_as(first)
    return first.reshape(-1), count.reshape(-1), step.reshape(-1)


def destuff_streams(data: torch.Tensor, first: torch.Tensor,
                    count: torch.Tensor, step: torch.Tensor):
    """0xFF destuffing of many streams at once (grk_destuff_bits): every
    byte gives 8 bits, MSB first, or its low 7 after a 0xFF byte of its
    stream.  Stream i is count[i] bytes of `data` from first[i], walking
    by step[i] (1, or -1 for a stream read backward).  Returns (bits, one
    0/1 uint8 a bit; region starts; bit counts): each stream in a region
    of count * 8 bits followed by _PAD zero bytes, regions on bytes."""
    dev = data.device
    n = len(count)
    total = int(count.sum())
    sid = torch.repeat_interleave(torch.arange(n, device=dev), count)
    k = torch.arange(total, device=dev) - (torch.cumsum(count, 0)
                                           - count)[sid]
    idx = first[sid] + step[sid] * k
    d = data.to(torch.int64)
    byte = d[idx]
    before = d[(idx - step[sid]).clamp(0, len(d) - 1)]
    after_ff = (k > 0) & (before == 0xFF)
    width = 8 - after_ff.to(torch.int64)
    nbits = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, sid, width)
    region = 8 * (count + _PAD)
    starts = torch.cumsum(region, 0) - region
    at = (starts - (torch.cumsum(nbits, 0) - nbits))[sid] + (
        torch.cumsum(width, 0) - width)
    bits = torch.zeros(int(region.sum()), dtype=torch.uint8, device=dev)
    for j in range(8):
        m = width > j
        bits[at[m] + j] = ((byte[m] >> (width[m] - 1 - j)) & 1).to(
            torch.uint8)
    return bits, starts, nbits


def wrap_bits(nbits) -> int:
    """grok_tpu's padded stream length L for a batch whose destuffed
    streams have `nbits` bits: the longest (at least 1) plus the 64-bit
    guard, rounded up to a power of two."""
    longest = max(1, int(nbits.max()) if len(nbits) else 0)
    return 1 << (longest + _REF_PAD - 1).bit_length()


def sar32(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int32 arithmetic right shift with XLA's semantics for any count: a
    count outside [0, 31] fills with the sign bit."""
    out = x >> s.clamp(0, 31)
    return torch.where((s < 0) | (s > 31), torch.where(x < 0, -1, 0), out)


def _windows(pool: torch.Tensor) -> torch.Tensor:
    """W[p] = the 40 bits of pool bytes p..p+4, for every byte p."""
    b = torch.cat([pool.to(torch.int64),
                   torch.zeros(4, dtype=torch.int64, device=pool.device)])
    n = len(pool)
    return ((b[:n] << 32) | (b[1:n + 1] << 24) | (b[2:n + 2] << 16)
            | (b[3:n + 3] << 8) | b[4:n + 4])


def _read(win40, off, length, pos, n: int) -> torch.Tensor:
    """n bits (<= 32) MSB-first at bit `pos` (>= 0) of the stream at byte
    `off`, `length` bytes long; zeros past its end."""
    byte = torch.minimum(pos >> 3, length)   # past the end: the zero pad
    w = win40[off + byte]
    return (w >> (40 - (pos & 7) - n)) & ((1 << n) - 1)


def _streams_plain(items, device):
    """The twin's Scup parsing and destuffing: (desc, 40-bit windows of the
    packed destuffed streams, their byte offsets and byte lengths, each
    (B, 3), and the batch's wrap_bits)."""
    data, desc = join_segments(items)
    d = torch.from_numpy(desc).to(device)
    data = torch.from_numpy(data).to(device)
    bits, starts, nbits = destuff_streams(
        data, *split_segments(data, d[:, 4], d[:, 5]))
    win40 = _windows((bits.reshape(-1, 8).to(torch.int64) << torch.arange(
        7, -1, -1, device=device)).sum(1))
    return (d, win40, (starts // 8).reshape(-1, 3),
            ((nbits + 7) // 8).reshape(-1, 3), wrap_bits(nbits))


def _chains(d, win40, offs, lens):
    """The MEL and VLC chain of every block, a loop over quad steps
    vectorised across blocks: rho and umax of every quad, (B, max quads)
    int64 (past a block's own quads, values nothing reads)."""
    device = d.device
    hs, ws = d[:, 2], d[:, 3]
    qw = ws // 2
    nq = (hs // 2) * qw
    nqmax = int(nq.max())
    b = len(d)
    _, mel_off, vlc_off = offs.T
    _, mel_len, vlc_len = lens.T

    def z():
        return torch.zeros(b, dtype=torch.int64, device=device)

    e_tab = torch.tensor(MEL_E, dtype=torch.int64, device=device)
    lut_rho, lut_len = (torch.from_numpy(t.astype(np.int64)).to(device)
                        for t in (ht_tables.DEC_LUT_RHO,
                                  ht_tables.DEC_LUT_LEN))
    maxc = ht_tables.MAX_CWD_LEN
    k, pz, mpos, vpos, left0, pup0 = z(), z(), z(), z(), z(), z()
    pone = torch.zeros(b, dtype=torch.bool, device=device)
    upred = z() + 1
    rrow = torch.zeros((b, int(qw.max())), dtype=torch.int64, device=device)
    rho_q = torch.zeros((b, nqmax), dtype=torch.int64, device=device)
    umax_q = torch.zeros_like(rho_q)
    one = z() + 1
    for t in range(nqmax):
        valid = t < nq
        qx = t % qw
        first = qx == 0
        upred = torch.where(first & valid, 1, upred)
        up = rrow.gather(1, qx[:, None])[:, 0]
        left = torch.where(first, 0, left0)
        upleft = torch.where(first, 0, pup0)
        ctx = (left > 0).to(torch.int64) + 2 * (up > 0) + 4 * (upleft > 0)
        # one MEL event (t1.ht.MELDecoder)
        fresh = (pz == 0) & ~pone
        bit = torch.where(fresh, _read(win40, mel_off, mel_len, mpos, 1), 0)
        e = e_tab[k]
        run = torch.where(fresh & (bit == 0), _read(
            win40, mel_off, mel_len, mpos + 1, _MEL_RUN_WIN)
            >> (_MEL_RUN_WIN - e), 0)
        ev = torch.where(fresh, (bit == 0) & (run == 0), pz == 0)
        k_new = torch.where(fresh, torch.where(
            bit == 1, (k + 1).clamp(max=12), (k - 1).clamp(min=0)), k)
        pz_new = torch.where(fresh, torch.where(
            bit == 1, (one << e) - 1, (run - 1).clamp(min=0)),
            (pz - 1).clamp(min=0))
        pone_new = torch.where(fresh, (bit == 0) & (run > 0),
                               pone & (pz > 0))
        mpos_new = mpos + torch.where(fresh, torch.where(bit == 1, 1, 1 + e),
                                      0)
        # the VLC quad parse: rho and codeword length from the LUT window
        win = _read(win40, vlc_off, vlc_len, vpos, _VLC_WIN)
        cw = win >> (_VLC_WIN - maxc)
        rho = lut_rho[ctx, cw]
        clen = lut_len[ctx, cw]
        uw = sar32(win, _VLC_WIN - clen - 10) & 0x3FF
        u0, u1, u2 = (uw >> 9) & 1, (uw >> 8) & 1, (uw >> 7) & 1
        zz = torch.where(u0 == 0, 0, torch.where(
            u1 == 0, 1, torch.where(u2 == 0, 2, 3 + (uw & 0x7F))))
        ulen = torch.where(u0 == 0, 1, torch.where(
            u1 == 0, 2, torch.where(u2 == 0, 3, 10)))
        diff = torch.where((zz & 1) == 1, -((zz + 1) >> 1), zz >> 1)
        umax = upred + diff
        rho = torch.where(ev, rho, 0)
        # padding steps of a smaller block change no state
        k = torch.where(valid, k_new, k)
        pz = torch.where(valid, pz_new, pz)
        pone = torch.where(valid, pone_new, pone)
        mpos = torch.where(valid, mpos_new, mpos)
        vpos = torch.where(valid & ev, vpos + clen + ulen, vpos)
        upred = torch.where(valid & ev, umax, upred)
        rrow.scatter_(1, qx[:, None], torch.where(valid, rho, up)[:, None])
        left0 = torch.where(valid, rho, left0)
        pup0 = torch.where(valid, up, pup0)
        rho_q[:, t] = torch.where(valid, rho, 0)
        umax_q[:, t] = umax

    return rho_q, umax_q


def quad_chains_plain(items, device="cpu"):
    """Twin of grk_ht_decode: rho and umax of every quad of every block,
    (B, max quads) int64."""
    d, win40, offs, lens, _ = _streams_plain(items, torch.device(device))
    return _chains(d, win40, offs, lens)


def decode_cblks_ht_plain(items, device="cpu", out=None):
    """Plain PyTorch twin of decode_cblks_ht, run on `device`: Scup and
    destuffing vectorised over every byte; the MEL and VLC chain is a loop
    over quad steps, vectorised across blocks; the MagSgn reads are
    vectorised over every sample."""
    device = torch.device(device)
    out = _dests(items, device, out)
    if not items:
        return out
    d, win40, offs, lens, wrap = _streams_plain(items, device)
    rho_q, umax_q = _chains(d, win40, offs, lens)
    b, nqmax = rho_q.shape
    ms_off, ms_len = offs[:, 0], lens[:, 0]
    # MagSgn: cursor of each quad = exclusive prefix sum of its bits
    step = umax_q + 1
    count = torch.zeros_like(rho_q)
    for i in range(4):
        count += (rho_q >> i) & 1
    nbits_q = count * step
    spos = torch.cumsum(nbits_q, dim=1) - nbits_q
    vals = torch.zeros((b, nqmax, 4), dtype=torch.int64, device=device)
    before = torch.zeros_like(rho_q)
    for i in range(4):
        sig = (rho_q >> i) & 1
        pos = spos + before * step
        pos = torch.where(pos < 0, (pos + wrap).clamp(min=0), pos)
        win = _read(win40, ms_off[:, None], ms_len[:, None], pos, _MS_WIN)
        m = sar32(win, _MS_WIN - umax_q) + 1
        sgn = sar32(win, _MS_WIN - umax_q - 1) & 1
        v = torch.where(sgn == 1, -(2 * m + 1), 2 * m + 1)
        vals[:, :, i] = torch.where(sig == 1, v, 0)
        before += sig
    vals = wrap_int32(vals)
    for i, (o, (_, h, w)) in enumerate(zip(out, items)):
        q = vals[i, :(h // 2) * (w // 2)].reshape(h // 2, w // 2, 2, 2)
        o.copy_(q.permute(0, 3, 1, 2).reshape(h, w))
    return out
