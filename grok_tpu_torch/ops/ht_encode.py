"""HT (Part 15) cleanup-pass encoder for batches of codeblocks: the port of
grok_tpu/ops/ht_encode.py.

`encode_cblks_ht(blocks)` codes a list of (H, W) int32 codeblocks with even
H and W and magnitudes below 2^25, mixed shapes allowed.  The blocks may be
views into band tensors (row stride free, unit column stride), so the
codeblocks are read in place.  On CUDA tensors one launch of
csrc/ht_encode.cu (`grk_ht_encode`) codes them all; on CPU tensors the
plain PyTorch twin `encode_cblks_ht_plain` does.  Both produce the three
UNSTUFFED streams of each block (MagSgn, MEL, VLC) with their bit counts,
the block's numbps and the exact sum of its squared magnitudes; the host
then applies the 0xFF bit-stuffing through the native coder
(`stuff_streams_native`, all streams of a batch in one pool), reverses the
VLC stream and appends Scup (`assemble_segments`).  The segments are byte-identical to
t1/ht.py::encode_cblk_ht and to grok_tpu's device coder.

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

# per block: byte offset and bit count of the MagSgn, MEL and VLC streams
# in the pool, numbps, sum of squared magnitudes
META = ("ms_off", "ms_bits", "mel_off", "mel_bits", "vlc_off", "vlc_bits",
        "numbps", "sumsq")

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


def worst_case_bytes(h: int, w: int) -> int:
    """Pool bytes an (h, w) block may need: every stream at its longest."""
    nq = (h // 2) * (w // 2)
    return ((4 * nq * _MS_MAXLEN + 7) // 8 + (nq * _MEL_MAXLEN + 8) // 8
            + (nq * _VLC_MAXLEN + 7) // 8)


def shape_ok(h: int, w: int) -> bool:
    """Shapes the kernels take: even and non-empty, and within a JPEG 2000
    codeblock's limits (4096 samples, 1024 columns)."""
    return (h > 0 and w > 0 and h % 2 == 0 and w % 2 == 0
            and h * w <= 4096 and w <= 1024)


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
        return assemble_segments(*_streams_plain(blocks))
    if device.type != "cuda":
        raise ValueError(f"no kernel route for device {device}")
    return assemble_segments(*_streams_cuda(blocks, device))


def encode_cblks_ht_plain(blocks):
    """Plain PyTorch twin of encode_cblks_ht, on the blocks' own device."""
    blocks = list(blocks)
    if not blocks:
        return [], []
    _check(blocks)
    return assemble_segments(*_streams_plain(blocks))


def encode_args(blocks, device: torch.device):
    """The kernel's arguments for CUDA codeblocks: (desc, pool, used, meta)
    on the device.  The blocks must outlive the launches."""
    desc = torch.tensor([[b.data_ptr(), b.stride(0), b.shape[0], b.shape[1]]
                         for b in blocks], dtype=torch.int64).to(device)
    cap = sum(worst_case_bytes(*b.shape) for b in blocks)
    return (desc, torch.empty(cap, dtype=torch.uint8, device=device),
            torch.empty(1, dtype=torch.int64, device=device),
            torch.empty((len(blocks), len(META)), dtype=torch.int64,
                        device=device))


def launch_encode(args, device: torch.device) -> None:
    """One launch of grk_ht_encode on encode_args' tensors."""
    desc, pool, used, meta = args
    used.zero_()
    enc_cwd, enc_len = _device_tables(device)
    launch("ht_encode", "grk_ht_encode", device,
           (desc, enc_cwd, enc_len, pool, used, meta),
           (len(desc), len(pool)))


def _streams_cuda(blocks, device):
    args = encode_args(blocks, device)
    launch_encode(args, device)
    _, pool, used, meta = args
    return pool[:int(used.item())].cpu().numpy(), meta.cpu().numpy()


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


def _pack(vals: torch.Tensor, lens: torch.Tensor, max_len: int):
    """MSB-first packing of (n, codes) variable-length codes, each block's
    stream starting on a byte.  Bits are placed from cumulative offsets,
    one vectorised scatter a bit position of the codes, so memory grows
    with the bits written.  Returns (bytes uint8, byte offsets (n,), bit
    counts (n,))."""
    n = vals.shape[0]
    dev = vals.device
    nbits = lens.sum(dim=1)
    nbytes = (nbits + 7) // 8
    byte_off = torch.cumsum(nbytes, 0) - nbytes
    keep = lens > 0
    blk = torch.arange(n, device=dev)[:, None].expand_as(lens)[keep]
    v, ln = vals[keep], lens[keep]
    start = torch.cumsum(ln, 0) - ln                # global exclusive
    blk_bits = torch.cumsum(nbits, 0) - nbits
    pos = start - blk_bits[blk] + 8 * byte_off[blk]
    bits = torch.zeros(int(nbytes.sum()) * 8, dtype=torch.uint8, device=dev)
    for j in range(max_len):
        m = ln > j
        if not bool(m.any()):
            break
        bits[pos[m] + j] = ((v[m] >> (ln[m] - 1 - j)) & 1).to(torch.uint8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int64,
                           device=dev)
    out = (bits.reshape(-1, 8).to(torch.int64) * weights).sum(1)
    return out.to(torch.uint8), byte_off, nbits


def _streams_plain(blocks):
    """Twin of the kernel's output: (pool bytes, meta (B, 8)) as numpy."""
    meta = np.zeros((len(blocks), len(META)), np.int64)
    pools = []
    base = 0
    groups: dict = defaultdict(list)
    for i, b in enumerate(blocks):
        groups[tuple(b.shape)].append(i)
    for idx in groups.values():
        for c0 in range(0, len(idx), _CHUNK):
            part = idx[c0:c0 + _CHUNK]
            x = torch.stack([blocks[i] for i in part])
            *streams, numbps, sumsq = _codes(x)
            numbps = numbps.cpu().numpy()
            if numbps.max() > MAX_NUMBPS_DEVICE:
                raise ValueError("magnitudes exceed device HT range")
            m = meta[part]
            for s, ((vals, lens), max_len) in enumerate(zip(
                    streams, (_MS_MAXLEN, _MEL_MAXLEN, _VLC_MAXLEN))):
                data, off, nbits = _pack(vals, lens, max_len)
                pools.append(data.cpu().numpy())
                m[:, 2 * s] = off.cpu().numpy() + base
                m[:, 2 * s + 1] = nbits.cpu().numpy()
                base += len(pools[-1])
            m[:, 6] = numbps
            m[:, 7] = sumsq.cpu().numpy()
            meta[part] = m
    pool = np.concatenate(pools) if pools else np.zeros(0, np.uint8)
    return pool, meta


# ----------------------------------------------------------- host assembly

def assemble_segments(pool: np.ndarray, meta: np.ndarray):
    """Host assembly: stuff every stream (the native coder's 0xFF
    stuffing, one pass over the pool), reverse VLC, append Scup.  Returns
    ([(segment, numbps)], [sum of squares]) matching t1.ht.encode_cblk_ht."""
    from ..t1 import native

    if len(meta) and int(meta[:, 6].max()) > MAX_NUMBPS_DEVICE:
        raise ValueError("magnitudes exceed device HT range")
    coded = meta[:, 6] > 0
    streams = meta[coded][:, :6].reshape(-1, 2)   # (offset, bits) rows
    out, offs, lens = native.stuff_streams_native(pool, streams[:, 0],
                                                  streams[:, 1])
    segs = []
    k = 0
    for nb in meta[:, 6].tolist():
        if nb == 0:
            segs.append((b"", 0))
            continue
        ms, mel, vlc = (out[o:o + n] for o, n in zip(
            offs[k:k + 3].tolist(), lens[k:k + 3].tolist()))
        k += 3
        scup = len(mel) + len(vlc) + 2
        if scup > 4079:
            raise ValueError("HT suffix overflow")
        segs.append((ms.tobytes() + mel.tobytes() + vlc[::-1].tobytes()
                     + bytes([0x0F & scup, (scup >> 4) & 0xFF]), nb))
    return segs, meta[:, 7].tolist()
