"""EBCOT Tier-1 MQ decoder for batches of codeblocks: the port of
grok_tpu/ops/mq_decode.py (`decode_cblks_mq_device`).

`decode_cblks_mq(items, device, outs)` decodes codeblocks of styles NONE
and LAZY, mixed shapes in one call.  items: (data, seg_lengths,
num_passes, numbps, h, w, orient, style) per block, as Tier-2 hands them
over.  Each block is written, in the doubled domain (sign * (2q + 1) when
every pass is decoded), into its `outs[k]`: an int32 (h, w) tensor with
contiguous rows, e.g. a view into a device band tensor.

The host computes what depends only on the packet headers, as the
reference does: each codeword segment's byte range and, through
t1/coder.py `segment_layout`, the segment and bypass flag of every pass
(`layout`).  It joins the blocks' bytes and uploads them with those tables
in one copy.  A tile's blocks can also go as flat arrays: `flat_layout`
regroups the chunk records Tier-2 read (a block's records lie one after
another in the tile's stream) into the same descriptor and segment rows
with numpy, the pass maps point into one shared table (`pass_maps`), and
`flat_args` uploads the rows and the tile's stream, which the blocks'
offsets point into.  On a CUDA device one launch of csrc/mq_decode.cu
(`grk_mq_decode`, one warp a codeblock with its flag words, context states
and plane map in shared memory, running the bit-plane decoder in step with
only lane 0 storing, its lanes split over applying each plane to the
destination) decodes everything; on the CPU the plain PyTorch twin
`decode_cblks_mq_plain` does.

Every path decodes corrupt and truncated streams exactly as grok_tpu's
device decoder does: a segment reads 0xFF past its end; a segment the
headers do not give is empty; the MQ and raw readers switch at pass starts
as the pass map says; the visited flags clear after each cleanup pass; and
a segment that reaches past its block's bytes reads zeros up to the
reference's padded batch length Lb (the next power of two of the longest
block of the same shape, `padded_lengths`) and 0xFF beyond.

The twin keeps the passes in step across blocks and, within a pass, lets
every block move through its own decisions: each step decodes one MQ or
raw decision of every block that still has one.  The samples a pass
visits are listed at its start (MRP and CUP visit a fixed set, SPP the
samples next to a significant one), and SPP adds the later neighbours of a
sample that turns significant as it goes.  The MRP contexts are fixed
when the pass starts, so its MQ decisions run as a loop of bare decodes.
So the loop has about as many steps as the longest block has decisions,
where the reference's scan steps through every (plane, pass, stripe,
column); its CPU time is what the port's codec tests pay.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from ..kernels import launch
from ..params import CblkStyle
from ..t1.coder import segment_layout
from .mq_encode import script
from .mq_tables import (
    CTX_RL,
    CTX_UNI,
    INIT_CTX,
    MAX_NUMBPS_DEVICE,
    NLPS,
    NMPS,
    NUM_CTX,
    QE,
    SC_CN,
    SC_XOR,
    ZC_LUT,
    launch_smem,
)

# per block, filled by the host: output pointer and row stride (elements),
# h, w, orient, numbps, passes to decode, offset and length of its bytes in
# the joined buffer, the padded length Lb, offset and count of its segments
# in the segment table, offset of its pass map
DESC = ("out_ptr", "out_stride", "h", "w", "orient", "numbps", "passes",
        "data_off", "data_len", "lb", "seg_off", "nseg", "pass_off")
RAW_FLAG = 0x80      # in the pass map: the pass is a bypass (raw) pass


def _style_ok(style) -> bool:
    return CblkStyle(int(style)) in (CblkStyle.NONE, CblkStyle.LAZY)


def padded_lengths(items) -> np.ndarray:
    """The reference's padded batch length Lb of each item: the next power
    of two of the longest (at least 1 byte) block of its shape."""
    cols = np.array([(it[4], it[5], len(it[0])) for it in items],
                    np.int64).reshape(-1, 3)
    return _padded(*cols.T)


def _padded(h, w, data_len) -> np.ndarray:
    """padded_lengths over arrays of the blocks' h, w and byte counts."""
    _, grp = np.unique(h * 8192 + w, return_inverse=True)
    longest = np.zeros(len(data_len) and grp.max() + 1, np.int64)
    np.maximum.at(longest, grp, np.maximum(data_len, 1))
    _, e = np.frexp(longest - 1)
    return (np.int64(1) << e.astype(np.int64))[grp]


def layout(items):
    """The host half: (desc (B, 13) int64 with the pointers and strides
    left 0, joined bytes uint8, segment table (S, 2) int32
    [start, end) within each block's bytes, pass map uint8)."""
    n = len(items)
    desc = np.zeros((n, len(DESC)), np.int64)
    lbs = padded_lengths(items)
    segs, pmaps, datas = [], [], []
    seg_n = pass_n = data_n = 0
    for k, (dat, seg_lengths, npass, nb, h, w, orient, style) in \
            enumerate(items):
        if not _style_ok(style):
            raise ValueError("the device MQ decoder takes styles NONE and "
                             f"LAZY, got {CblkStyle(int(style))!r}")
        if not (0 <= nb <= MAX_NUMBPS_DEVICE):
            raise ValueError("numbps exceeds the device MQ range")
        if not (h > 0 and w > 0 and h * w <= 4096 and w <= 1024):
            raise ValueError("MQ codeblocks must be non-empty, within 4096 "
                             f"samples and 1024 columns, got {(h, w)}")
        dat = bytes(dat)
        npb = 3 * nb - 2 if nb > 0 else 0
        lay = segment_layout(CblkStyle(int(style)), nb) if nb > 0 else []
        bounds = np.zeros((max(len(lay), 1), 2), np.int64)
        off = 0
        for si, ln in enumerate(list(seg_lengths)[:len(bounds)]):
            bounds[si] = off, off + int(ln)
            off += int(ln)
        pm = np.zeros(npb, np.uint8)
        for si, (plist, is_raw) in enumerate(lay):
            for p in plist:
                pm[p] = si | (RAW_FLAG if is_raw else 0)
        desc[k, 2:10] = (h, w, orient, nb, max(0, min(int(npass), npb)),
                         data_n, len(dat), lbs[k])
        desc[k, 10:13] = seg_n, len(bounds), pass_n
        segs.append(bounds)
        pmaps.append(pm)
        datas.append(dat)
        seg_n += len(bounds)
        pass_n += npb
        data_n += len(dat)
    joined = np.frombuffer(bytearray(b"".join(datas)) or bytearray(1),
                           np.uint8)
    return (desc, joined, np.concatenate(segs).astype(np.int32),
            np.concatenate(pmaps + [np.zeros(1, np.uint8)]))


@functools.cache
def pass_maps():
    """The pass maps of every (lazy, numbps) the device takes, in one
    table: (table uint8, offset (2, 27) int64 of each map in it, segment
    rows (2, 27) int64, at least 1), all read-only.  A map depends only on
    the style and numbps, so blocks point into this one."""
    off = np.zeros((2, MAX_NUMBPS_DEVICE + 1), np.int64)
    nseg = np.ones_like(off)
    parts, at = [], 0
    for lazy, style in enumerate((CblkStyle.NONE, CblkStyle.LAZY)):
        for nb in range(1, MAX_NUMBPS_DEVICE + 1):
            lay = segment_layout(style, nb)
            pm = np.zeros(3 * nb - 2, np.uint8)
            for si, (plist, is_raw) in enumerate(lay):
                pm[plist] = si | (RAW_FLAG if is_raw else 0)
            off[lazy, nb], nseg[lazy, nb] = at, max(len(lay), 1)
            parts.append(pm)
            at += len(pm)
    out = (np.concatenate(parts), off, nseg)
    for a in out:
        a.setflags(write=False)
    return out


def flat_layout(nb, lazy, h, w, rblk, rpass, rlen):
    """layout's descriptor columns 2 to 12 and segment rows for blocks
    whose bytes each lie in one range of a tile's stream, from Tier-2's
    chunk records, as t2/packets.py collect_seg_lengths and layout make
    them from the same records: per block numbps (0 to 26), lazy flag, h
    and w; per record (grouped by block, each block's in arrival order,
    every block with one at least) its block, passes and length.  A
    record's bytes count to the segment of the block's first pass in it
    (segment 0 past the last pass); the segments given lengths, in order,
    are the block's segment rows, as many as its layout has.  Returns
    (desc (n, 13) int64 with the pointer, stride and data_off columns left
    0, segment rows (S, 2) int32, the shared pass map table)."""
    table, poff, pnseg = pass_maps()
    n = len(nb)
    rblk = np.asarray(rblk, np.int64)
    rlen = np.asarray(rlen, np.int64)
    npb = np.where(nb > 0, 3 * nb - 2, 0)
    pm_off = poff[lazy, nb]
    nseg = pnseg[lazy, nb]
    first_rec = np.searchsorted(rblk, np.arange(n))
    done = np.cumsum(rpass) - rpass
    p = done - done[first_rec][rblk]           # the record's first pass
    last = npb[rblk] - 1
    seg = np.where(p <= last, table[pm_off[rblk]
                                    + np.clip(p, 0, np.maximum(last, 0))]
                   & 0x7F, 0).astype(np.int64)
    # the segments given lengths: sorted by block, then segment
    key, inv = np.unique(rblk * 128 + seg, return_inverse=True)
    sums = np.bincount(inv, weights=rlen).astype(np.int64)
    kblk = key >> 7
    kfirst = np.searchsorted(kblk, np.arange(n))[kblk]
    rank = np.arange(len(key)) - kfirst
    keep = rank < nseg[kblk]
    sums = np.where(keep, sums, 0)
    starts = np.cumsum(sums) - sums
    starts -= starts[kfirst]
    seg_off = np.cumsum(nseg) - nseg
    segs = np.zeros((int(nseg.sum()), 2), np.int32)
    rows = seg_off[kblk[keep]] + rank[keep]
    segs[rows, 0] = starts[keep]
    segs[rows, 1] = starts[keep] + sums[keep]
    data_len = np.bincount(rblk, weights=rlen, minlength=n).astype(np.int64)
    passes = np.bincount(rblk, weights=rpass, minlength=n).astype(np.int64)
    desc = np.zeros((n, len(DESC)), np.int64)
    desc[:, 2], desc[:, 3], desc[:, 5] = h, w, nb
    desc[:, 6] = np.clip(passes, 0, npb)
    desc[:, 8] = data_len
    desc[:, 9] = _padded(h, w, data_len)
    desc[:, 10], desc[:, 11], desc[:, 12] = seg_off, nseg, pm_off
    return desc, segs, table


def _dests(items, device, outs):
    if outs is None:
        return [torch.zeros((it[4], it[5]), dtype=torch.int32,
                            device=device) for it in items]
    outs = list(outs)
    if len(outs) != len(items):
        raise ValueError("one destination a codeblock")
    for o, it in zip(outs, items):
        h, w = it[4], it[5]
        if o.dtype != torch.int32 or tuple(o.shape) != (h, w) \
                or o.device != device or (w > 1 and o.stride(1) != 1):
            raise ValueError(f"destination must be an int32 ({h}, {w}) "
                             f"tensor on {device} with contiguous rows")
    return outs


def decode_cblks_mq(items, device, outs=None):
    """Decode MQ codeblocks (styles NONE and LAZY, mixed shapes) into
    `outs` (or new tensors) on `device`, and return them.  A CUDA device
    launches the kernel, the CPU runs the twin; other devices raise."""
    device = torch.device(device)
    if device.type == "cpu":
        return decode_cblks_mq_plain(items, device, outs)
    if device.type != "cuda":
        raise ValueError(f"no kernel route for device {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    outs = _dests(items, device, outs)
    if items:
        launch_decode(decode_args(items, device, outs), device)
    return outs


def decode_args(items, device: torch.device, outs):
    """The kernel's arguments: (desc, segment table, pass map, joined
    bytes) on the device, uploaded in one copy, then the launch's dynamic
    shared memory in bytes; writes items[k] into outs[k], which must
    outlive the launch."""
    desc, data, segs, pmap = layout(items)
    desc[:, 0] = [o.data_ptr() for o in outs]
    desc[:, 1] = [o.stride(0) for o in outs]
    parts = [desc.view(np.uint8).reshape(-1), segs.view(np.uint8).reshape(
        -1), pmap, data]
    sizes = [len(p) for p in parts]
    blob = torch.from_numpy(np.concatenate(parts)).to(device)
    o = np.cumsum([0] + sizes)
    return (blob[o[0]:o[1]].view(torch.int64).view(-1, len(DESC)),
            blob[o[1]:o[2]].view(torch.int32), blob[o[2]:o[3]],
            blob[o[3]:o[4]], launch_smem(desc[:, 2:4]))


def flat_args(data, desc: np.ndarray, segs: np.ndarray, pmap: np.ndarray,
              device: torch.device):
    """decode_args for flat_layout's rows, whose data_off column the
    caller set into `data` (bytes-like: the tile's stream) and whose
    pointer and stride columns it filled: the rows go up in one copy and
    the stream in another."""
    parts = [desc.view(np.uint8).reshape(-1), segs.view(np.uint8).reshape(
        -1), pmap]
    o = np.cumsum([0] + [len(p) for p in parts])
    blob = torch.from_numpy(np.concatenate(parts)).to(device)
    src = np.frombuffer(data, np.uint8)
    stream = torch.empty(max(len(src), 1), dtype=torch.uint8, device=device)
    if len(src):
        with warnings.catch_warnings():
            # read-only bytes: the tensor is only the copy's source
            warnings.simplefilter("ignore", UserWarning)
            stream[:len(src)].copy_(torch.from_numpy(src))
    return (blob[o[0]:o[1]].view(torch.int64).view(-1, len(DESC)),
            blob[o[1]:o[2]].view(torch.int32), blob[o[2]:o[3]], stream,
            launch_smem(desc[:, 2:4]))


def launch_decode(args, device: torch.device) -> None:
    """One launch of grk_mq_decode on decode_args' tensors."""
    from .mq_encode import device_tables

    desc = args[0]
    launch("mq_decode", "grk_mq_decode", device,
           (desc, device_tables(device), *args[1:4]), (len(desc), args[4]))


# ------------------------------------------------------------ plain twin

def _seg_bytes(data, lb, s, e):
    """The bytes a segment [s, e) of a block reads, as the reference reads
    them: data, then zeros up to Lb; nothing past Lb (0xFF from there)."""
    end = min(e, lb)
    if s >= end:
        return np.zeros(0, np.uint8)
    out = np.zeros(end - s, np.uint8)
    real = data[s:min(end, len(data))]
    out[:len(real)] = real
    return out


def _reader_tables(seg_list):
    """For a list of segments' bytes: the MQ BYTEIN table over every bp of
    every segment (add << 4 | ct, and whether bp advances), each segment's
    base, the byte at each bp; and the raw bits of each segment (destuffed,
    then a 1 for every read past the end) with each segment's base and
    last index."""
    mq_add, mq_adv, mq_byte, mq_base = [], [], [], []
    raw_bits, raw_base, raw_last = [], [], []
    at = rat = 0
    for e in seg_list:
        x = np.concatenate([e, [0xFF, 0xFF]]).astype(np.int64)
        b1 = np.concatenate([x[1:], [0xFF]])
        ff = x == 0xFF
        marker = ff & (b1 > 0x8F)
        add = np.where(marker, 0xFF00, np.where(ff, b1 << 9, b1 << 8))
        ct = np.where(marker, 8, np.where(ff, 7, 8))
        mq_add.append((add << 4) | ct)
        mq_adv.append((~marker).astype(np.int64))
        mq_byte.append(x)
        mq_base.append(at)
        at += len(x)
        prev_ff = np.concatenate([[False], e[:-1] == 0xFF]) if len(e) else \
            np.zeros(0, bool)
        bits = np.unpackbits(e.astype(np.uint8).reshape(-1, 1), axis=1)
        keep = np.ones_like(bits, dtype=bool)
        keep[prev_ff, 0] = False
        rb = np.concatenate([bits[keep], [1]]).astype(np.int64)
        raw_bits.append(rb)
        raw_base.append(rat)
        raw_last.append(rat + len(rb) - 1)
        rat += len(rb)
    cat = (lambda v: np.concatenate(v) if v else np.zeros(1, np.int64))
    return (cat(mq_add), cat(mq_adv), cat(mq_byte), np.array(mq_base),
            cat(raw_bits), np.array(raw_base), np.array(raw_last))


def _mq_step(ctx, do, lanes, states, a, c, ct, bp, qe_t, nmps_t, nlps_t,
             nsh, mq_tab, mq_adv):
    # type: (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]
    """One MQ decision (t1/mq.py MQDecoder.decode) of every lane `do` in
    context ctx: returns (bits, a, c, ct, bp).  A lane that decodes nothing
    reads the dummy context, whose Qe of 0 changes no register.  The
    renormalisation shifts the code register in at most two pieces, each
    ending where BYTEIN (a lookup in the segment's table) adds a byte."""
    k = lanes * 20 + torch.where(do, ctx, torch.full_like(ctx, 19))
    si = states[k]
    qe = qe_t[si]
    a2 = a - qe
    ge = (c >> 16) >= qe
    c = torch.where(ge, c - (qe << 16), c)
    hi = ge & (a2 >= 0x8000)
    lps = ((a2 < qe) == ge) & ~hi
    a3 = torch.where(ge, a2, qe)
    states[k] = torch.where(hi, si, torch.where(lps, nlps_t[si],
                                                   nmps_t[si]))
    d = (si & 1) ^ lps.to(torch.int64)
    n = nsh[a3]
    a = (a3 << n) & 0xFFFF
    for _ in range(2):
        r = ct < n
        if not bool(r.any()):
            break
        sft = torch.where(r, ct, torch.zeros_like(ct))
        tab = mq_tab[bp]
        c = torch.where(r, ((c << sft) & 0xFFFFFFFF) + (tab >> 4), c)
        n = n - sft
        ct = torch.where(r, tab & 15, ct)
        bp = torch.where(r, bp + mq_adv[bp], bp)
    c = (c << n) & 0xFFFFFFFF
    ct = ct - n
    return torch.where(do, d, torch.zeros_like(d)), a, c, ct, bp


def _refine_loop(ctx, cnt, mql, lanes, states, a, c, ct, bp, qe_t, nmps_t,
                 nlps_t, nsh, mq_tab, mq_adv):
    # type: (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]
    """The MQ decisions of a refinement pass, whose contexts are fixed:
    (bits (n, K), a, c, ct, bp)."""
    bits = torch.zeros_like(ctx)
    for j in range(ctx.shape[1]):
        do = mql & (cnt > j)
        d, a, c, ct, bp = _mq_step(ctx[:, j], do, lanes, states, a, c, ct,
                                   bp, qe_t, nmps_t, nlps_t, nsh, mq_tab,
                                   mq_adv)
        bits[:, j] = d
    return bits, a, c, ct, bp


# flags of a sample on the twin's canvas (csrc/mq_common.cuh's too)
_SIG, _NEG, _VIS, _REF = 1, 2, 4, 8


def _step_tables():
    """The twin's per-step lookups.  c9[4 j + (flags & 3)]: what neighbour
    j of a 3 x 3 window (row-major, the sample at 4) adds to the ZC index
    (bits 0-7) and the SC index (bits 8-15).  By code = 4 ph + 2 agg + bit,
    with the phase ph 0 (a sample's first decision, or a column's run-length
    decision when agg), 1 (its sign), 2 and 3 (the run's two UNI
    decisions), 4 (the sign of the run's first sample): the next phase, the
    list entries it passes (-1: the run's first sample's row + 1) and
    whether it ends a sample's visit."""
    zcw = [1, 2, 4, 8, 0, 16, 32, 64, 128]
    scw = [0, 16, 0, 1, 0, 4, 0, 64, 0]      # W 3, E 5, N 1, S 7
    c9 = np.zeros(36, np.int64)
    for j in range(9):
        for f in range(4):
            sig, neg = f & 1, (f >> 1) & 1
            c9[4 * j + f] = sig * zcw[j] + ((sig * scw[j]) << 8) + (
                (sig * neg * scw[j]) << 9)
    nph = np.zeros(20, np.int64)
    skip = np.zeros(20, np.int64)
    done = np.zeros(20, bool)
    for code in range(20):
        ph, agg, bit = code >> 2, (code >> 1) & 1, code & 1
        if ph == 0 and agg:
            nph[code], skip[code] = (2, 0) if bit else (0, 4)
        elif ph == 0:
            nph[code], skip[code], done[code] = (1, 0, 0) if bit else \
                (0, 1, 1)
        elif ph == 1:
            nph[code], skip[code], done[code] = 0, 1, 1
        elif ph in (2, 3):
            nph[code] = ph + 1
        else:
            nph[code], skip[code] = 0, -1
    return c9, nph, skip, done


def _pass_loop(cup, lst, n_pos, wp, wmax, top, w, h, raw_t, first_rec, full,
               zc_base, fl, rec, states, a, c, ct, bp, rpos, rlast, qe_t,
               nmps_t, nlps_t, zc_t, sccn_t, scxor_t, nsh, mq_tab, mq_adv,
               raw_bits, off18, ar9, c9, nph_t, skip_t, done_t):
    # type: (bool, Tensor, int, int, int, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]
    """A significance (cup False) or cleanup pass of every block, one
    decision of each a step; see _Twin.spp_cup.  Returns (a, c, ct, bp,
    rpos)."""
    n = lst.shape[0]
    dev = lst.device
    lanes = torch.arange(n, device=dev)
    w4 = 4 * w
    dummy = fl.shape[1] - 1
    span = 4 * wmax + 8
    dyn = torch.zeros((n, n_pos + span + 1), dtype=torch.bool, device=dev)
    last = n_pos + span
    ar_span = torch.arange(1, span + 1, device=dev)
    j4 = 4 * ar9
    zero = torch.zeros_like(w)
    ptr = zero
    cur = lst[:, 0]
    ph = zero
    u1 = zero
    first = zero
    # the later neighbours a new significance makes eligible (SPP): window
    # row and column offsets and scan-position steps in the stripe, then
    # row 0 of the next stripe
    t_dr = torch.tensor([2, 0, 1, 2], device=dev)
    t_dc = torch.tensor([1, 2, 2, 2], device=dev)
    t_dp = torch.tensor([1, 3, 4, 5], device=dev)
    t_nc = torch.tensor([0, 1, 2], device=dev)
    while True:
        act = cur < n_pos
        if not bool(act.any()):
            break
        curg = torch.where(act, cur, zero)
        base = top.gather(1, curg[:, None])[:, 0]
        k = curg & 3
        wfl = fl.gather(1, base[:, None] + off18)
        row = torch.where(ph == 4, first, k)
        v = c9[(wfl.gather(1, row[:, None] * 3 + ar9) & 3) + j4].sum(1)
        sci = v >> 8
        if cup:
            agg = (ph == 0) & (k == 0) & act & full.gather(
                1, (curg >> 2)[:, None])[:, 0] & ((wfl & 1).sum(1) == 0)
        else:
            agg = torch.zeros_like(act)
        ctx = torch.where(ph == 0, torch.where(agg, zero + 17,
                                               zc_t[zc_base + (v & 255)]),
                          torch.where((ph == 1) | (ph == 4), sccn_t[sci],
                                      zero + 18))
        bit = zero
        dm = act & ~raw_t
        if bool(dm.any()):
            bit, a, c, ct, bp = _mq_step(ctx, dm, lanes, states, a, c, ct,
                                         bp, qe_t, nmps_t, nlps_t, nsh,
                                         mq_tab, mq_adv)
        dr = act & raw_t
        if bool(dr.any()):
            rb = raw_bits[torch.minimum(rpos, rlast)]
            rpos = rpos + dr.to(torch.int64)
            bit = torch.where(dr, rb, bit)
        code = ph * 4 + agg.to(torch.int64) * 2 + bit
        newsig = act & ((ph == 1) | (ph == 4))
        done = act & done_t[code]
        f = base + (row + 1) * wp + 1
        sg = torch.where(raw_t, bit, bit ^ scxor_t[sci])
        if cup:
            put = newsig
            visited = zero
        else:
            put = newsig | done
            visited = done.to(torch.int64) * 4
        fl.index_put_((lanes, torch.where(put, f, zero + dummy)),
                      wfl.gather(1, (row * 3 + 4)[:, None])[:, 0]
                      | newsig.to(torch.int64) * (1 + 2 * sg) | visited)
        rec.index_put_((lanes, torch.where(newsig, f, zero + dummy)),
                       first_rec)
        skip = skip_t[code]
        skip = torch.where(act, torch.where(skip < 0, first + 1, skip),
                           zero)
        nph = torch.where(act, nph_t[code], ph)
        u1 = torch.where(act & (nph == 3), bit, u1)
        first = torch.where(act & (nph == 4), (u1 << 1) | bit, first)
        ph = nph
        moved = skip > 0
        if cup:
            ptr = ptr + skip
            nxt = lst.gather(1, ptr[:, None])[:, 0]
        else:
            on_list = lst.gather(1, ptr[:, None])[:, 0] == cur
            ptr = ptr + (moved & on_list).to(torch.int64)
            if bool(newsig.any()):
                s = torch.div(curg, w4, rounding_mode="floor")
                x = (curg - s * w4) >> 2
                y = 4 * s + k
                ok4 = newsig[:, None] & (k[:, None] + t_dr[None] - 1 >= 0) \
                    & (k[:, None] + t_dr[None] - 1 <= 3) \
                    & (x[:, None] + t_dc[None] - 1 < w[:, None]) \
                    & (y[:, None] + t_dr[None] - 1 < h[:, None])
                xx = x[:, None] + t_nc[None] - 1
                ok3 = (newsig & (k == 3) & (y + 1 < h))[:, None] & (xx >= 0) \
                    & (xx < w[:, None])
                widx = torch.cat([(k[:, None] + t_dr[None]) * 3 + t_dc[None],
                                  15 + t_nc[None].expand(n, 3)], 1)
                pos = torch.cat([cur[:, None] + t_dp[None],
                                 ((s + 1) * w4)[:, None] + 4 * xx], 1)
                m = torch.cat([ok4, ok3], 1) & \
                    ((wfl.gather(1, widx) & 1) == 0)
                dyn.index_put_((lanes[:, None].expand(n, 7),
                                torch.where(m, pos, torch.full_like(pos,
                                                                    last))),
                               torch.ones_like(m))
            dyn.index_put_((lanes, torch.where(moved, cur, zero + last)),
                           torch.zeros_like(moved))
            nxt = lst.gather(1, ptr[:, None])[:, 0]
            win = dyn.gather(1, torch.clamp(cur[:, None] + ar_span, max=last))
            dpos = cur + 1 + win.to(torch.int64).argmax(1)
            nxt = torch.where(win.any(1), torch.minimum(nxt, dpos), nxt)
        cur = torch.where(moved, nxt, cur)
    return a, c, ct, bp, rpos


class _Twin:
    """The twin's state for one call: blocks on a canvas of 4 S + 2 rows
    by W + 2 columns (a border of insignificant samples), flattened, with
    a dummy slot at the end that masked writes go to."""

    def __init__(self, lay, device):
        self.dev = dev = device
        desc, joined, segs, pmap = lay
        self.n = n = len(desc)
        self.h = torch.tensor(desc[:, 2], device=dev)
        self.w = torch.tensor(desc[:, 3], device=dev)
        self.orient = torch.tensor(desc[:, 4], device=dev)
        self.nb = desc[:, 5]
        self.npass = desc[:, 6]
        hmax, wmax = int(desc[:, 2].max()), int(desc[:, 3].max())
        self.S = S = (hmax + 3) // 4
        self.Wp = Wp = wmax + 2
        self.Hp = 4 * S + 2
        self.NC = self.Hp * Wp
        self.N = 4 * S * wmax               # scan positions (upper bound)
        # segments: bytes as read, tables for both readers
        seg_list, seg_index = [], {}
        for k in range(n):
            dat = joined[desc[k, 7]:desc[k, 7] + desc[k, 8]]
            for si in range(desc[k, 11]):
                s, e = segs[desc[k, 10] + si]
                seg_index[(k, si)] = len(seg_list)
                seg_list.append(_seg_bytes(dat, int(desc[k, 9]), int(s),
                                           int(e)))
        (mq_tab, mq_adv, mq_byte, mq_base, raw_bits, raw_base,
         raw_last) = _reader_tables(seg_list)
        t = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev))
        self.mq_tab, self.mq_adv, self.mq_byte = t(mq_tab), t(mq_adv), \
            t(mq_byte)
        self.raw_bits = t(raw_bits)
        self.seg_index = seg_index
        self.mq_base, self.raw_base, self.raw_last = mq_base, raw_base, \
            raw_last
        self.pmap = [pmap[desc[k, 12]:desc[k, 12] + max(0, 3 * self.nb[k]
                                                         - 2)]
                     for k in range(n)]
        z = (lambda: torch.zeros((n, self.NC + 1), dtype=torch.int64,
                                 device=dev))
        self.fl, self.rec = z(), z()     # flags (_SIG | _NEG | ...), values
        self.lanes = torch.arange(n, device=dev)
        self.dummy = self.NC
        # MQ registers, raw reader, context states (a dummy 20th, si 94, Qe 0)
        zz = (lambda v=0: torch.full((n,), v, dtype=torch.int64,
                                     device=dev))
        self.a, self.c, self.ct, self.bp = zz(0x8000), zz(), zz(), zz()
        self.rpos, self.rlast = zz(), zz()
        self.states = torch.cat([torch.from_numpy(INIT_CTX.astype(
            np.int64)), torch.tensor([94])]).to(dev).repeat(n)
        self.cur_seg = np.full(n, -1)
        self.tabs = dict(
            qe=t(np.concatenate([QE.astype(np.int64), [0, 0]])),
            nmps=t(np.concatenate([NMPS.astype(np.int64), [94, 94]])),
            nlps=t(np.concatenate([NLPS.astype(np.int64), [94, 94]])),
            zc=t(ZC_LUT.reshape(-1).astype(np.int64)),
            sc_cn=t(SC_CN.astype(np.int64)),
            sc_xor=t(SC_XOR.astype(np.int64)))
        nsh = np.zeros(1 << 16, np.int64)
        v = np.arange(1, 1 << 16)
        nsh[1:] = np.maximum(0, 15 - np.floor(np.log2(v)).astype(np.int64))
        self.nsh = t(nsh)
        # canvas position (flat) and scan index of every sample
        yy = torch.arange(4 * S, device=dev)[:, None]
        xx = torch.arange(wmax, device=dev)[None, :]
        self.flat_of = ((yy + 1) * Wp + xx + 1).reshape(-1)   # (4S*wmax)
        wv = self.w[:, None, None]
        self.inside = ((yy[None] < self.h[:, None, None])
                       & (xx[None] < wv)).reshape(n, -1)
        self.scan_of = ((yy[None] >> 2) * 4 * wv + xx[None] * 4
                        + (yy[None] & 3)).reshape(n, -1)
        # at each scan position: the canvas index of the top-left corner of
        # the 6 x 3 window around its stripe column
        p = torch.arange(self.N, device=dev)[None]
        sp = torch.div(p, 4 * wv[:, :, 0], rounding_mode="floor")
        self.top = 4 * sp * Wp + ((p - sp * 4 * wv[:, :, 0]) >> 2)
        off = [r * Wp + c for r in range(6) for c in range(3)]
        self.off18 = torch.tensor(off, device=dev)
        self.ar9 = torch.arange(9, device=dev)
        self.steps = tuple(t(v) for v in _step_tables())

    # -------------------------------------------------------- readers

    def switch(self, i, pt, live):
        """At the start of pass (plane i, type pt): move each live block
        whose pass lies in another segment to it."""
        ordl = 0 if i == 0 else 3 * i + pt - 2
        rows = []
        for k in np.flatnonzero(live):
            code = int(self.pmap[k][ordl])
            si, raw = code & 0x7F, bool(code & RAW_FLAG)
            if si != self.cur_seg[k]:
                self.cur_seg[k] = si
                rows.append((k, raw, self.seg_index[(k, si)]))
        if not rows:
            return
        mq = [(k, g) for k, raw, g in rows if not raw]
        rw = [(k, g) for k, raw, g in rows if raw]
        dev = self.dev
        if rw:
            ks = torch.tensor([k for k, _ in rw], device=dev)
            self.rpos[ks] = torch.tensor([self.raw_base[g] for _, g in rw],
                                         device=dev)
            self.rlast[ks] = torch.tensor([self.raw_last[g] for _, g in rw],
                                          device=dev)
        if mq:
            ks = torch.tensor([k for k, _ in mq], device=dev)
            bp = torch.tensor([self.mq_base[g] for _, g in mq], device=dev)
            c = self.mq_byte[bp] << 16
            tab = self.mq_tab[bp]
            c = ((c + (tab >> 4)) << 7) & 0xFFFFFFFF
            self.c[ks] = c
            self.ct[ks] = (tab & 15) - 7
            self.bp[ks] = bp + self.mq_adv[bp]
            self.a[ks] = 0x8000

    # -------------------------------------------------------- passes

    def listing(self, mask):
        """The scan positions of each block's samples in `mask` (n, 4S *
        wmax), in scan order: ((n, K) padded with N, counts)."""
        key = torch.where(mask & self.inside, self.scan_of, self.N)
        srt = key.sort(1).values
        cnt = (srt < self.N).sum(1)
        kmax = max(1, int(cnt.max()))
        return torch.cat([srt[:, :kmax], torch.full(
            (self.n, 1), self.N, dtype=torch.int64, device=self.dev)], 1), \
            cnt

    def canvas(self, arr):
        """(n, NC + 1) canvas values at every sample (n, 4S * wmax)."""
        return arr[:, self.flat_of]

    def nbr_sig(self):
        """Any of the 8 neighbours significant, at every sample."""
        s = (self.fl[:, :self.NC] & _SIG).reshape(self.n, self.Hp, self.Wp)
        m = torch.zeros_like(s[:, 1:-1, 1:-1])
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    m = m | s[:, 1 + dy:self.Hp - 1 + dy,
                              1 + dx:self.Wp - 1 + dx]
        return m[:, :, :self.Wp - 2].reshape(self.n, -1)

    def mrp(self, bpno, live, raw):
        """The refinement pass of every live block: the samples and
        their contexts are fixed at the pass start."""
        f = self.canvas(self.fl)
        cand = ((f & (_SIG | _VIS)) == _SIG) \
            & torch.from_numpy(live).to(self.dev)[:, None] & self.inside
        cnt = cand.sum(1)
        kmax = int(cnt.max())
        if kmax == 0:
            return
        # the listed samples in scan order, and their contexts
        order = torch.argsort(torch.where(cand, self.scan_of, self.N),
                              1)[:, :kmax]
        ctx = torch.where((f & _REF) != 0, 16,
                          14 + self.nbr_sig()).gather(1, order)
        fl = self.flat_of[order]
        raw_t = torch.from_numpy(raw).to(self.dev)
        rank = torch.arange(kmax, device=self.dev)[None]
        ok = rank < cnt[:, None]
        bits = torch.zeros_like(ctx)
        if bool(raw_t.any()):
            idx = torch.minimum(self.rpos[:, None] + rank,
                                self.rlast[:, None])
            bits = torch.where(raw_t[:, None], self.raw_bits[idx], bits)
            self.rpos = torch.where(raw_t, self.rpos + cnt, self.rpos)
        mql = ~raw_t
        if bool((mql & (cnt > 0)).any()):
            tb = self.tabs
            mq_bits, self.a, self.c, self.ct, self.bp = script(
                _refine_loop)(ctx, cnt, mql, self.lanes, self.states, self.a,
                              self.c, self.ct, self.bp, tb["qe"],
                              tb["nmps"], tb["nlps"], self.nsh, self.mq_tab,
                              self.mq_adv)
            bits = torch.where(mql[:, None], mq_bits, bits)
        old = self.rec.gather(1, fl)
        bp = bpno[:, None]
        half = torch.ones_like(bp) << torch.clamp(bp - 1, min=0)
        new = torch.where(bp > 0, torch.where(bits == 1, old + half,
                                              old - half),
                          torch.where(bits == 1, old, old - 1))
        fl = torch.where(ok, fl, self.dummy)
        self.rec.scatter_(1, fl, torch.where(ok, new, old))
        self.fl.scatter_(1, fl, self.fl.gather(1, fl) | _REF)

    def spp_cup(self, cup, bpno, live, raw):
        """The significance (cup False) or cleanup pass of every live
        block: one decision a step."""
        dev = self.dev
        live_t = torch.from_numpy(live).to(dev)
        raw_t = torch.from_numpy(raw).to(dev) & ~torch.tensor(cup)
        f = self.canvas(self.fl)
        if cup:
            cand = (f & (_SIG | _VIS)) == 0
        else:
            cand = ((f & _SIG) == 0) & self.nbr_sig().bool()
        cand = cand & live_t[:, None] & self.inside
        lst, cnt = self.listing(cand)
        if int(cnt.max()) == 0:
            return
        if cup:
            # stripe columns (index scan position >> 2) whose four rows are
            # all listed
            full = torch.zeros((self.n, self.N // 4 + 1), dtype=torch.int64,
                               device=dev)
            full.scatter_add_(1, torch.where(cand, self.scan_of >> 2,
                                             self.N // 4),
                              cand.to(torch.int64))
            full = full == 4
        else:
            full = torch.zeros((self.n, 1), dtype=torch.bool, device=dev)
        first_rec = (torch.ones_like(bpno) << bpno) | (
            (torch.ones_like(bpno) << bpno) >> 1)
        tb = self.tabs
        self.a, self.c, self.ct, self.bp, self.rpos = script(_pass_loop)(
            cup, lst, self.N, self.Wp, self.Wp - 2, self.top, self.w, self.h,
            raw_t, first_rec, full, self.orient * 256, self.fl, self.rec,
            self.states, self.a, self.c, self.ct, self.bp, self.rpos,
            self.rlast, tb["qe"], tb["nmps"], tb["nlps"], tb["zc"],
            tb["sc_cn"], tb["sc_xor"], self.nsh, self.mq_tab, self.mq_adv,
            self.raw_bits, self.off18, self.ar9, *self.steps)

    def run(self):
        maxnb = int(self.nb.max()) if self.n else 0
        nbt = torch.from_numpy(self.nb).to(self.dev)
        for i in range(maxnb):
            bpno = torch.clamp(nbt - i, min=0)      # doubled-domain plane
            for pt in ((2,) if i == 0 else (0, 1, 2)):
                ordl = 0 if i == 0 else 3 * i + pt - 2
                live = (i < self.nb) & (ordl < self.npass)
                if not live.any():
                    continue
                self.switch(i, pt, live)
                raw = np.array([bool(live[k]) and bool(
                    self.pmap[k][ordl] & RAW_FLAG) for k in range(self.n)])
                if pt == 1:
                    self.mrp(bpno, live, raw)
                else:
                    self.spp_cup(pt == 2, bpno, live, raw)
                if pt == 2:
                    self.fl &= ~_VIS    # visited clears after a cleanup

    def result(self):
        v = self.canvas(self.rec)
        v = torch.where((self.canvas(self.fl) & _NEG) != 0, -v, v)
        return v


def decode_cblks_mq_plain(items, device="cpu", outs=None):
    """Plain PyTorch twin of decode_cblks_mq, run on `device`."""
    device = torch.device(device)
    outs = _dests(items, device, outs)
    if items:
        decode_flat_plain(layout(items), device, outs)
    return outs


def decode_flat_plain(lay, device, outs) -> None:
    """The twin on a layout (desc, bytes, segment rows, pass maps), as
    layout or flat_layout make it (the bytes a uint8 array, which desc's
    data_off column points into), writing block k into outs[k]."""
    tw = _Twin(lay, torch.device(device))
    tw.run()
    vals = tw.result().to(torch.int32)
    wmax = tw.Wp - 2
    for k, (o, (h, w)) in enumerate(zip(outs, lay[0][:, 2:4].tolist())):
        o.copy_(vals[k].reshape(4 * tw.S, wmax)[:h, :w])
