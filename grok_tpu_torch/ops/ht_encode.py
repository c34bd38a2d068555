"""HT (Part 15) cleanup-pass encoder for batches of codeblocks: the port of
grok_tpu/ops/ht_encode.py.

`encode_cblks_ht(blocks)` codes a list of (H, W) int32 codeblocks with even
H and W and magnitudes below 2^25, mixed shapes allowed, into finished
cleanup segments.  The blocks may be views into band tensors (row stride
free, unit column stride), so the codeblocks are read in place.

Per block a segment is: the MagSgn stream 0xFF-stuffed, the MEL stream
stuffed, the VLC stream stuffed and byte-reversed, then the two Scup bytes
(the reference's `assemble_segments`).  On CUDA tensors one launch of
csrc/ht_encode.cu (`grk_ht_encode`) does all of it, stuffing included, and
writes every segment into one pool on the card; the host makes one
device-to-host copy of the pool and slices it into segments.  A tile's
blocks can also go as flat arrays: `desc_args` takes the descriptor rows
the caller built with numpy (a block's address, row stride and shape), and
`finish_encode_flat` hands back the pool and the per-block results as
arrays, with no per-block Python object.  On CPU
tensors the plain PyTorch twin `encode_cblks_ht_plain` does the same work:
the codes of every block, packed, stuffed by `stuff_streams` (vectorised
across streams) and assembled by index arithmetic.  The segments are
byte-identical to t1/ht.py::encode_cblk_ht and to grok_tpu's device coder.

The CxtVLC tables (t1/ht_tables.py) are arguments of the kernel, uploaded
once per device into _DEVICE_TABLES, which ht_tables.set_tables() clears.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from ..kernels import launch
from ..t1 import ht_tables
from ..t1.ht import MEL_E
from .ht_meta import bit_length, quad_metadata, quad_samples

# device path supports magnitudes below 2^25 (MagSgn value fits int32 and
# every VLC u-residual fits the 7-bit escape); callers route the rest to
# the host coder
MAX_NUMBPS_DEVICE = 25
_MS_MAXLEN = MAX_NUMBPS_DEVICE + 1   # (m-1) in umax bits + sign
_VLC_MAXLEN = 7 + 10                 # max CxtVLC cwd + '111' + 7-bit escape
_MEL_MAXLEN = 6                      # '0' + up to 5 run bits
_CHUNK = 1024                        # blocks a plain-route pass holds
# the largest Scup (suffix bytes + 2) a segment may carry; read by both
# routes at each call
SCUP_MAX = 4079

# per block in the kernel's output: segment offset in the pool and length,
# numbps, sum of squared magnitudes, status (STATUS_*)
META = ("seg_off", "seg_len", "numbps", "sumsq", "status")
STATUS_SCUP = 1   # the suffix would exceed SCUP_MAX
STATUS_POOL = 2   # the pool was too small for the segment

# torch.device -> (ENC_CWD, ENC_LEN) uint8 tensors on that device
_DEVICE_TABLES: dict = {}


def _device_tables(device: torch.device):
    tabs = _DEVICE_TABLES.get(device)
    if tabs is None:
        tabs = _DEVICE_TABLES[device] = tuple(
            torch.from_numpy(np.ascontiguousarray(t, dtype=np.uint8)).to(
                device)
            for t in (ht_tables.ENC_CWD, ht_tables.ENC_LEN))
    return tabs


def _stuffed_max(nbits: int) -> int:
    """Most bytes a stream of `nbits` bits can stuff to: 7 bits a byte
    after 0xFF bytes, and the guard byte."""
    return (nbits + 6) // 7 + 1


def worst_case_bytes(h, w):
    """Pool bytes an (h, w) block's segment may need: every stream at its
    longest and stuffed at 7 bits a byte, and the two Scup bytes (ints, or
    numpy arrays of them)."""
    nq = (h // 2) * (w // 2)
    return (_stuffed_max(4 * nq * _MS_MAXLEN) + _stuffed_max(
        nq * _MEL_MAXLEN + 1) + _stuffed_max(nq * _VLC_MAXLEN) + 2)


def shape_ok(h: int, w: int) -> bool:
    """Shapes the kernels take: even and non-empty, and within a JPEG 2000
    codeblock's limits (4096 samples, 1024 columns)."""
    return (h > 0 and w > 0 and h % 2 == 0 and w % 2 == 0
            and h * w <= 4096 and w <= 1024)


def check_shapes(h: np.ndarray, w: np.ndarray) -> None:
    """shape_ok over arrays of heights and widths: raise on the first
    shape the kernels do not take."""
    bad = ~((h > 0) & (w > 0) & (h % 2 == 0) & (w % 2 == 0)
            & (h * w <= 4096) & (w <= 1024))
    if bad.any():
        i = int(np.argmax(bad))
        raise ValueError("device HT path requires even, non-empty "
                         f"codeblock dims within 4096 samples and 1024 "
                         f"columns, got {(int(h[i]), int(w[i]))}")


def _check(blocks) -> torch.device:
    devices = {b.device for b in blocks}
    if len(devices) != 1:
        raise ValueError(f"codeblocks lie on different devices: {devices}")
    for b in blocks:
        if b.dtype != torch.int32:
            raise TypeError(f"expected int32 codeblocks, got {b.dtype}")
        if b.dim() != 2:
            raise ValueError(f"expected (H, W) codeblocks, got {b.shape}")
        h, w = b.shape
        if not shape_ok(h, w):
            raise ValueError("device HT path requires even, non-empty "
                             f"codeblock dims within 4096 samples and 1024 "
                             f"columns, got {(h, w)}")
        if w > 1 and b.stride(1) != 1:
            raise ValueError("codeblock rows must be contiguous")
    return devices.pop()


def encode_cblks_ht(blocks):
    """Code a list of (H, W) int32 codeblocks (even H, W; magnitudes below
    2^25).  Returns ([(segment, numbps)], [sum of squared magnitudes]),
    the segments byte-identical to t1/ht.py::encode_cblk_ht.  CUDA tensors
    launch the kernel, CPU tensors run the twin; other devices raise."""
    blocks = list(blocks)
    if not blocks:
        return [], []
    device = _check(blocks)
    if device.type == "cpu":
        return _encode_plain(blocks)
    if device.type != "cuda":
        raise ValueError(f"no kernel route for device {device}")
    args = encode_args(blocks, device)
    launch_encode(args, device)
    return finish_encode(args)


def encode_cblks_ht_plain(blocks):
    """Plain PyTorch twin of encode_cblks_ht, on the blocks' own device."""
    blocks = list(blocks)
    if not blocks:
        return [], []
    _check(blocks)
    return _encode_plain(blocks)


# ------------------------------------------------------------ kernel route

def encode_args(blocks, device: torch.device, pool_cap: int | None = None):
    """The kernel's arguments for CUDA codeblocks: (desc, pool, used, meta)
    on the device and the launch's largest quad count and quad-row width.
    The pool holds `pool_cap` bytes, by default every block's worst case.
    The blocks must outlive the launches."""
    desc = np.array([[b.data_ptr(), b.stride(0), *b.shape] for b in blocks],
                    dtype=np.int64).reshape(-1, 4)
    return desc_args(desc, device, pool_cap)


def desc_args(desc: np.ndarray, device: torch.device,
              pool_cap: int | None = None):
    """encode_args from descriptor rows built by the caller: (n, 4) int64,
    a block's address, row stride in elements, h and w.  One copy takes
    the rows to the device; the blocks must outlive the launches."""
    h, w = desc[:, 2], desc[:, 3]
    if pool_cap is None:
        pool_cap = int(worst_case_bytes(h, w).sum())
    return (torch.from_numpy(np.ascontiguousarray(desc)).to(device),
            torch.empty(max(pool_cap, 1), dtype=torch.uint8,
                        device=device)[:pool_cap],
            torch.empty(1, dtype=torch.int64, device=device),
            torch.empty((len(desc), len(META)), dtype=torch.int64,
                        device=device),
            int(((h // 2) * (w // 2)).max()), int((w // 2).max()))


def launch_encode(args, device: torch.device) -> None:
    """One launch of grk_ht_encode on encode_args' tensors."""
    desc, pool, used, meta, max_quads, max_qw = args
    used.zero_()
    enc_cwd, enc_len = _device_tables(device)
    launch("ht_encode", "grk_ht_encode", device,
           (desc, enc_cwd, enc_len, pool, used, meta),
           (len(desc), len(pool), max_quads, max_qw, SCUP_MAX))


def finish_encode(args):
    """The host half after a launch: the results and the pool's used
    bytes in one copy, the segments in another, then the checks and the
    slicing.  Returns encode_cblks_ht's result."""
    data, meta = finish_encode_flat(args)
    segs = [(data[o:o + n].tobytes(), nb) for o, n, nb in
            meta[:, :3].tolist()]
    return segs, meta[:, 3].tolist()


def finish_encode_flat(args, extra: int = 0):
    """finish_encode without the slicing: (the pool's used bytes, followed
    by `extra` bytes left for the caller, as one uint8 array; meta (n, 5)
    int64, META's columns), after the checks."""
    _, pool, used, meta = args[:4]
    small = torch.cat([used, meta.reshape(-1)]).cpu().numpy()
    meta = small[1:].reshape(-1, len(META))
    _raise_on(meta[:, 2], meta[:, 4])
    n = int(small[0])
    data = np.empty(n + extra, np.uint8)
    if n:
        torch.from_numpy(data[:n]).copy_(pool[:n])
    return data, meta


def _raise_on(numbps, status) -> None:
    if len(numbps) and int(numbps.max()) > MAX_NUMBPS_DEVICE:
        raise ValueError("magnitudes exceed device HT range")
    if (status == STATUS_SCUP).any():
        raise ValueError("HT suffix overflow")
    if (status == STATUS_POOL).any():
        raise RuntimeError("HT encode: the segment pool is too small")


# ------------------------------------------------------------ plain twin

def _mel_codes(events: torch.Tensor):
    """MEL-encode (n, nq) 0/1 events per block -> (vals, lens) of shape
    (n, nq + 1): one code a step plus the final flush; mirrors
    t1.ht.MELEncoder."""
    n, nq = events.shape
    dev = events.device
    e_tab = torch.tensor(MEL_E, dtype=torch.int64, device=dev)
    k = torch.zeros(n, dtype=torch.int64, device=dev)
    run = torch.zeros_like(k)
    vals = torch.zeros((n, nq + 1), dtype=torch.int64, device=dev)
    lens = torch.zeros_like(vals)
    one = torch.ones_like(k)
    for t in range(nq):
        ev = events[:, t]
        e = e_tab[k]
        run0 = run + 1
        hit = run0 == (one << e)
        # event 1: '0' + run in E[k] bits; event 0: '1' when the run fills
        vals[:, t] = torch.where(ev, run, one)
        lens[:, t] = torch.where(ev, e + 1, hit.to(torch.int64))
        k = torch.where(ev, (k - 1).clamp(min=0),
                        torch.where(hit, (k + 1).clamp(max=12), k))
        run = torch.where(ev | hit, 0, run0)
    vals[:, nq] = 1
    lens[:, nq] = (run > 0).to(torch.int64)
    return vals, lens


def _u_pred(umax: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per quad row: umax of the previous nonempty quad, 1 if none."""
    qw = umax.shape[-1]
    idx = torch.arange(qw, device=umax.device).expand_as(umax)
    last = torch.where(valid, idx, -1).cummax(dim=-1).values
    prev = torch.cat([torch.full_like(last[..., :1], -1), last[..., :-1]],
                     dim=-1)
    return torch.where(prev >= 0, umax.gather(-1, prev.clamp(min=0)), 1)


def _codes(x: torch.Tensor):
    """The codes of n (h, w) blocks: for each stream (vals, lens) of shape
    (n, codes) in stream order, plus numbps and the sum of squares (n,)."""
    n = x.shape[0]
    mags = x.to(torch.int64).abs()
    numbps = bit_length(mags.amax(dim=(1, 2)))
    sumsq = (mags * mags).sum(dim=(1, 2))
    rho, umax, _ = (t.to(torch.int64) for t in quad_metadata(x))
    qm = quad_samples(mags)                               # (n, qh, qw, 4)
    qs = quad_samples((x < 0).to(torch.int64))
    sig = qm > 0
    nonempty = rho != 0

    mel = _mel_codes(nonempty.reshape(n, -1))

    diff = umax - _u_pred(umax, nonempty)
    zz = torch.where(diff >= 0, diff << 1, ((-diff) << 1) - 1)
    ucode = torch.where(zz == 0, 0, torch.where(
        zz == 1, 0b10, torch.where(zz == 2, 0b110, (0b111 << 7) | (zz - 3))))
    ulen = torch.where(zz == 0, 1, torch.where(
        zz == 1, 2, torch.where(zz == 2, 3, 10)))
    # neighbour-significance context from the rho of left, up, up-left
    z = torch.zeros_like(rho)
    left = torch.cat([z[:, :, :1], rho[:, :, :-1]], dim=2)
    up = torch.cat([z[:, :1], rho[:, :-1]], dim=1)
    upleft = torch.cat([z[:, :, :1], up[:, :, :-1]], dim=2)
    ctx = (left > 0).to(torch.int64) + 2 * (up > 0) + 4 * (upleft > 0)
    enc_cwd, enc_len = (torch.from_numpy(t.astype(np.int64)).to(x.device)
                        for t in (ht_tables.ENC_CWD, ht_tables.ENC_LEN))
    vlc_vals = (enc_cwd[ctx, rho] << ulen) | ucode
    vlc_lens = torch.where(nonempty, enc_len[ctx, rho] + ulen, 0)

    ms_vals = ((qm - 1) << 1) | qs
    ms_lens = torch.where(sig, umax[..., None] + 1, 0)
    return ((ms_vals.reshape(n, -1), ms_lens.reshape(n, -1)), mel,
            (vlc_vals.reshape(n, -1), vlc_lens.reshape(n, -1)),
            numbps, sumsq)


def _pack_bits(vals: torch.Tensor, lens: torch.Tensor, max_len: int):
    """MSB-first bits of (n, codes) variable-length codes, one 0/1 byte a
    bit, each block's stream in a region of whole bytes with at least 8
    zero bits after it.  Bits are placed from cumulative offsets, one
    vectorised scatter a bit position of the codes.  Returns (bits uint8,
    region starts (n,), bit counts (n,))."""
    n = vals.shape[0]
    dev = vals.device
    nbits = lens.sum(dim=1)
    region = 8 * ((nbits + 7) // 8 + 1)
    starts = torch.cumsum(region, 0) - region
    keep = lens > 0
    blk = torch.arange(n, device=dev)[:, None].expand_as(lens)[keep]
    v, ln = vals[keep], lens[keep]
    first = torch.cumsum(ln, 0) - ln                # global exclusive
    pos = first - (torch.cumsum(nbits, 0) - nbits)[blk] + starts[blk]
    bits = torch.zeros(int(region.sum()), dtype=torch.uint8, device=dev)
    for j in range(max_len):
        m = ln > j
        if not bool(m.any()):
            break
        bits[pos[m] + j] = ((v[m] >> (ln[m] - 1 - j)) & 1).to(torch.uint8)
    return bits, starts, nbits


def _segment_sum(values: torch.Tensor, index: torch.Tensor, n: int):
    return torch.zeros(n, dtype=values.dtype, device=values.device
                       ).index_add_(0, index, values)


def stuff_streams(bits: torch.Tensor, starts: torch.Tensor,
                  nbits: torch.Tensor):
    """0xFF bit stuffing of many streams at once (grk_stuff_bits, grok_tpu's
    `_stuff_bits_py`): 8 payload bits a byte, 7 after a 0xFF byte, the
    final byte zero-padded, a 0x00 guard after a trailing 0xFF, nothing at
    all for a stream of 0 bits.

    bits: one 0/1 uint8 a bit; stream i is nbits[i] bits from
    bits[starts[i]], followed by at least 8 zero bits.  Returns (bytes
    uint8, offsets, lengths) with the streams one after another.

    A round takes each unfinished stream from its cursor up to and
    including its next 0xFF byte (or its end): the byte at every bit
    position is known up front, so the next 0xFF on the cursor's 8-bit
    grid is a reverse running minimum, and the rounds are as many as the
    most 0xFF bytes in one stream, plus one."""
    dev = bits.device
    n = len(nbits)
    m = len(bits)
    starts = starts.to(torch.int64)
    nbits = nbits.to(torch.int64)
    size = m + (-m) % 8
    b = torch.zeros(size + 8, dtype=torch.int32, device=dev)
    b[:m] = bits.to(torch.int32)
    byte = torch.zeros(size, dtype=torch.int32, device=dev)
    for j in range(8):
        byte |= b[j:j + size] << (7 - j)
    never = size + 8
    pos = torch.arange(size, dtype=torch.int64, device=dev)
    cand = torch.where(byte == 0xFF, pos, never).reshape(-1, 8)
    next_ff = cand.flip(0).cummin(0).values.flip(0).reshape(-1)
    next_ff = torch.cat([next_ff, torch.full((8,), never, device=dev)])

    guard = torch.zeros(n, dtype=torch.bool, device=dev)
    recs = []   # (stream, 7-bit first byte, its position, first 8-bit
    #             byte position, 8-bit bytes)
    act = torch.nonzero(nbits > 0).reshape(-1)
    cur = starts[act]
    seven = torch.zeros(len(act), dtype=torch.bool, device=dev)
    while len(act):
        end = starts[act] + nbits[act]
        first8 = cur + 7 * seven
        inside = first8 < end
        f = next_ff[first8.clamp(max=size + 7)]
        hit = inside & (f < end)
        count = torch.where(hit, (f - first8) // 8 + 1, torch.where(
            inside, (end - first8 + 7) // 8, 0))
        recs.append((act, seven, cur, first8, count))
        after = f + 8
        more = hit & (after < end)
        guard[act[hit & ~more]] = True
        act, cur = act[more], after[more]
        seven = torch.ones(len(act), dtype=torch.bool, device=dev)
    if not recs:
        z = torch.zeros(n, dtype=torch.int64, device=dev)
        return torch.zeros(0, dtype=torch.uint8, device=dev), z, z
    stream, seven, cur, first8, count = (torch.cat(c) for c in zip(*recs))
    order = torch.sort(stream, stable=True).indices
    stream, seven, cur, first8, count = (
        t[order] for t in (stream, seven, cur, first8, count))
    per_rec = count + seven.to(torch.int64)
    rec = torch.repeat_interleave(torch.arange(len(per_rec), device=dev),
                                  per_rec)
    k = torch.arange(len(rec), device=dev) - (
        torch.cumsum(per_rec, 0) - per_rec)[rec]
    is7 = seven[rec] & (k == 0)
    at = torch.where(is7, cur[rec],
                     first8[rec] + 8 * (k - seven[rec].to(torch.int64)))
    vals = (byte[at] >> is7.to(torch.int32)).to(torch.uint8)
    s = stream[rec]
    nbytes = _segment_sum(per_rec, stream, n)
    lens = nbytes + guard.to(torch.int64)
    offs = torch.cumsum(lens, 0) - lens
    out = torch.zeros(int(lens.sum()), dtype=torch.uint8, device=dev)
    rank = torch.arange(len(s), device=dev) - (
        torch.cumsum(nbytes, 0) - nbytes)[s]
    out[offs[s] + rank] = vals
    return out, offs, lens


def _segments(x: torch.Tensor):
    """Finished segments of n (h, w) blocks: (bytes uint8, segment offsets,
    lengths, numbps, sums of squares), numpy."""
    n = x.shape[0]
    dev = x.device
    *streams, numbps, sumsq = _codes(x)
    numbps_h = numbps.cpu().numpy()
    if numbps_h.max() > MAX_NUMBPS_DEVICE:
        raise ValueError("magnitudes exceed device HT range")
    coded = numbps > 0
    parts = [_pack_bits(vals, lens, max_len) for (vals, lens), max_len in
             zip(streams, (_MS_MAXLEN, _MEL_MAXLEN, _VLC_MAXLEN))]
    base = 0
    bits, starts, nbits = [], [], []
    for bt, st, nb in parts:
        bits.append(bt)
        starts.append(st + base)
        nbits.append(torch.where(coded, nb, 0))   # numbps 0: no segment
        base += len(bt)
    out, offs, lens = stuff_streams(torch.cat(bits), torch.cat(starts),
                                    torch.cat(nbits))
    ms_len, mel_len, vlc_len = lens.reshape(3, n)
    scup = mel_len + vlc_len + 2
    if bool((coded & (scup > SCUP_MAX)).any()):
        raise ValueError("HT suffix overflow")
    seg_len = torch.where(coded, ms_len + scup, 0)
    seg_off = torch.cumsum(seg_len, 0) - seg_len
    # each stuffed byte's place: MagSgn, MEL forward, VLC backward
    first = torch.stack([seg_off, seg_off + ms_len,
                         seg_off + ms_len + mel_len + vlc_len - 1])
    step = torch.tensor([1, 1, -1], device=dev)[:, None].expand(3, n)
    sid = torch.repeat_interleave(torch.arange(3 * n, device=dev), lens)
    rank = torch.arange(len(out), device=dev) - offs[sid]
    seg = torch.zeros(int(seg_len.sum()), dtype=torch.uint8, device=dev)
    seg[first.reshape(-1)[sid] + step.reshape(-1)[sid] * rank] = out
    end = (seg_off + seg_len)[coded]
    seg[end - 2] = (scup[coded] & 0x0F).to(torch.uint8)
    seg[end - 1] = ((scup[coded] >> 4) & 0xFF).to(torch.uint8)
    return (seg.cpu().numpy(), seg_off.cpu().numpy(), seg_len.cpu().numpy(),
            numbps_h, sumsq.cpu().numpy())


def _encode_plain(blocks):
    """The twin: blocks of one shape together, _CHUNK at a time."""
    data, meta = encode_plain_flat(blocks)
    segs = [(data[o:o + n].tobytes(), nb) for o, n, nb in
            meta[:, :3].tolist()]
    return segs, meta[:, 3].tolist()


def encode_plain_flat(blocks, extra: int = 0):
    """The twin's results as finish_encode_flat gives the kernel's: every
    block's segment in one uint8 array (with `extra` bytes to spare after
    them) and meta (n, 5) int64, status 0."""
    meta = np.zeros((len(blocks), len(META)), np.int64)
    parts: list = []
    groups: dict = defaultdict(list)
    for i, b in enumerate(blocks):
        groups[tuple(b.shape)].append(i)
    base = 0
    for idx in groups.values():
        for c0 in range(0, len(idx), _CHUNK):
            part = idx[c0:c0 + _CHUNK]
            data, offs, lens, numbps, sumsq = _segments(
                torch.stack([blocks[i] for i in part]))
            meta[part, 0] = offs + base
            meta[part, 1] = lens
            meta[part, 2] = numbps
            meta[part, 3] = sumsq
            parts.append(data)
            base += len(data)
    data = np.empty(base + extra, np.uint8)
    if parts:
        data[:base] = np.concatenate(parts)
    return data, meta
