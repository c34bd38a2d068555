"""HT (Part 15) cleanup-pass decoder for batches of codeblocks: the port of
grok_tpu/ops/ht_decode.py.

The host parses each segment's Scup, destuffs its three streams (MagSgn,
MEL and the byte-reversed VLC) through the native coder
(`destuff_streams_native`, all streams of a batch in one buffer), and
packs the bits back into bytes (`np.packbits`, 8x smaller than the
one-byte-a-bit destuffer output) into one pool, each stream followed by 8
zero bytes.  Then `decode_cblks_ht(items, device)`
replays, per block, the MEL automaton and the VLC quad parse with the
u-predictor chain, and reads the MagSgn samples from bit offsets that are
an exclusive prefix sum of popcount(rho) * (umax + 1).  On a CUDA device
that is one launch of csrc/ht_decode.cu (`grk_ht_decode`) for every block,
mixed shapes together, each written at its place in its destination
tensor; on the CPU it is the plain PyTorch twin `decode_cblks_ht_plain`.

Corrupt streams decode exactly as grok_tpu's device decoder decodes them
when the batch is the same (one batch a tile, as its router makes): reads
past a stream's end return zeros; a MagSgn cursor that went negative reads
where JAX's dynamic_slice puts it, at cursor + L clamped to 0, where L is
the batch's padded stream length in bits (`wrap_bits`); an int32 right
shift by a count outside [0, 31] fills with the sign bit (`sar32`); and
sums wrap as int32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import launch
from ..t1 import ht_tables
from ..t1.ht import MEL_E
from .ht_encode import shape_ok
from .ht_meta import wrap_int32

_PAD = 8            # zero bytes after every stream: bounded 5-byte windows
_MS_WIN = 31        # umax (<=30) + sign
_VLC_WIN = 17       # max 7-bit CxtVLC cwd + '111' + 7-bit escape
_MEL_RUN_WIN = 5    # max run-length field width
_REF_PAD = 64       # grok_tpu's cursor overrun guard, in bits

# per block: output pointer and row stride (elements), h, w, then byte
# offset and byte length of the MagSgn, MEL and VLC streams in the pool
DESC = ("out_ptr", "out_stride", "h", "w", "ms_off", "ms_len", "mel_off",
        "mel_len", "vlc_off", "vlc_len")

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


def split_streams(data: bytes):
    """(MagSgn, MEL, VLC) stuffed, as grok_tpu's device decoder reads them:
    the VLC stream is the suffix reversed; a segment with a bad Scup has
    three empty ones."""
    data = bytes(data)  # a memoryview of the codestream reverses badly
    if len(data) < 2:
        return b"", b"", b""
    scup = ((data[-1] & 0xFF) << 4) | (data[-2] & 0x0F)
    if scup < 2 or scup > len(data):
        return b"", b"", b""
    suffix = data[len(data) - scup:len(data) - 2]
    return data[:len(data) - scup], suffix, suffix[::-1]


def prepare(items):
    """Host half of the decode: (pool uint8, desc (B, 10) int64, wrap_bits)
    for items of (segment, h, w); the output pointers and strides are left
    0.  Every stream is destuffed by the native coder into one bit array,
    each in a region of its byte length * 8 + 64 bits, so one np.packbits
    packs them all, each followed by 8 zero bytes.  wrap_bits is
    grok_tpu's padded stream length L for this batch."""
    desc = np.zeros((len(items), len(DESC)), np.int64)
    streams = []
    for i, (data, h, w) in enumerate(items):
        if not shape_ok(h, w):
            raise ValueError("device HT path requires even, non-empty "
                             f"codeblock dims within 4096 samples and 1024 "
                             f"columns, got {(h, w)}")
        desc[i, 2:4] = h, w
        streams += split_streams(data)
    from ..t1 import native

    lens = np.fromiter(map(len, streams), np.int64, len(streams))
    offs = np.cumsum(lens) - lens
    regions = 8 * lens + 8 * _PAD
    bit_offs = np.cumsum(regions) - regions
    bits = np.zeros(max(int(regions.sum()), 8), np.uint8)
    nbits = native.destuff_streams_native(
        np.frombuffer(b"".join(streams), np.uint8), offs, lens, bits,
        bit_offs)
    desc[:, 4::2] = (bit_offs // 8).reshape(-1, 3)
    desc[:, 5::2] = ((nbits + 7) // 8).reshape(-1, 3)
    longest = max(1, int(nbits.max(initial=0)))
    return (np.packbits(bits), desc,
            1 << (longest + _REF_PAD - 1).bit_length())


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
    and returns them.  A CUDA device launches the kernel, the CPU runs the
    twin; other devices raise."""
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
    """The kernel's arguments: (desc, pool) on the device and wrap_bits,
    writing items[i] into out[i], which must outlive the launches."""
    pool, desc, wrap_bits = prepare(items)
    desc[:, 0] = [o.data_ptr() for o in out]
    desc[:, 1] = [o.stride(0) for o in out]
    return (torch.from_numpy(desc).to(device),
            torch.from_numpy(pool).to(device), wrap_bits)


def launch_decode(args, device: torch.device) -> None:
    """One launch of grk_ht_decode on decode_args' tensors."""
    desc, pool, wrap_bits = args
    lut_rho, lut_len = _device_tables(device)
    launch("ht_decode", "grk_ht_decode", device,
           (desc, pool, lut_rho, lut_len),
           (len(desc), ht_tables.MAX_CWD_LEN, wrap_bits))


# ------------------------------------------------------------ plain twin

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


def decode_cblks_ht_plain(items, device="cpu", out=None):
    """Plain PyTorch twin of decode_cblks_ht, run on `device`: the MEL and
    VLC chain is a loop over quad steps, vectorised across blocks; the
    MagSgn reads are vectorised over every sample."""
    device = torch.device(device)
    out = _dests(items, device, out)
    if not items:
        return out
    pool, desc, wrap_bits = prepare(items)
    d = torch.from_numpy(desc).to(device)
    win40 = _windows(torch.from_numpy(pool).to(device))
    hs, ws = d[:, 2], d[:, 3]
    qw = ws // 2
    nq = (hs // 2) * qw
    nqmax = int(nq.max())
    b = len(items)
    ms_off, ms_len, mel_off, mel_len, vlc_off, vlc_len = d[:, 4:].T

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

    # MagSgn: cursor of each quad = exclusive prefix sum of its bits
    step = umax_q + 1
    count = torch.zeros_like(rho_q)
    for i in range(4):
        count += (rho_q >> i) & 1
    bits = count * step
    spos = torch.cumsum(bits, dim=1) - bits
    vals = torch.zeros((b, nqmax, 4), dtype=torch.int64, device=device)
    before = torch.zeros_like(rho_q)
    for i in range(4):
        sig = (rho_q >> i) & 1
        pos = spos + before * step
        pos = torch.where(pos < 0, (pos + wrap_bits).clamp(min=0), pos)
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
