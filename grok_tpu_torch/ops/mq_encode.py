"""EBCOT Tier-1 MQ encoder for batches of codeblocks: the port of
grok_tpu/ops/mq_encode.py (`encode_cblks_mq_device`).

`encode_cblks_mq(blocks, orients, lazy, need_dist)` codes a list of (h, w)
int32 codeblocks of mixed shapes, styles NONE (lazy False) or LAZY (lazy
True), magnitudes below 2^26 (below 2^20 with need_dist), into finished
codewords.  The blocks may be views into band tensors (row stride free,
unit column stride): they are read in place.  The result (`MQEncoded`)
holds, per block, the codeword bytes and numbps, and, in flat (B, 76)
arrays, every pass's cumulative rate, termination flag and cumulative
distortion, with e0 = sum of squared magnitudes; t1/backend.py wraps
them in LazyPasses.  Everything equals t1/coder.py `encode_cblk` and
grok_tpu's device coder: bytes, rates (the host coder's `+4` rule for an
MQ pass that is not terminated, the raw writer's completed bytes `+1` for
a raw one, clamped to be monotone) and, with need_dist, distortions.

On CUDA tensors it is one launch of csrc/mq_encode.cu (`grk_mq_encode`,
one warp a codeblock with its flag words, context states and plane map in
shared memory, running the bit-plane coder and the MQ and raw writers in
step with only lane 0 storing, the warp's lanes split over the load, the
plane bits and the distortions, segments finished in the kernel; dynamic shared memory sized by the launch's
largest block, `mq_tables.launch_smem`), then two copies back.  A tile's
blocks can also go as flat arrays: `desc_args` takes the descriptor rows
the caller built with numpy (`desc_rows`, then the addresses), and
`finish_encode_flat` hands back the pool, the per-block results and the
rates as arrays, with the distortions where the rows ask for them, and no
per-block Python object.  On CPU
tensors it is the plain PyTorch twin `encode_cblks_mq_plain`, written
after the reference's formulation so its stages can be held to the
reference's:
- per plane, data-parallel across blocks of a shape: every sample's
  significance time (the SPP wavefront as a fixpoint of 8-neighbour
  minimum propagation), then the ordered decision slots of SPP, MRP and
  CUP with their contexts, compacted to one (context, bit) stream a
  block (`decision_streams`);
- the MQ automaton as a loop over decisions, vectorised across every
  block of the call (`mq_automaton`);
- the closed-form distortions from the significance times;
- the raw (bypass) segments packed with the writer's 0xFF rule, and the
  codeword spliced, per block on the host.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import launch
from .mq_tables import (
    CTX_MAG,
    CTX_RL,
    CTX_UNI,
    INIT_CTX,
    MAX_NUMBPS_DEVICE,
    MAX_NUMBPS_DIST,
    NLPS,
    NMPS,
    NUM_CTX,
    QE,
    QE_FUSED,
    SC_CN,
    SC_WORD,
    SC_XOR,
    ZC_LUT,
    launch_smem,
    out_capacity,
)

MAX_PASSES = 3 * MAX_NUMBPS_DEVICE - 2
_INF = 0x7FFFFFFF
_POS_BITS = 14       # scan positions fit 14 bits (codeblock area <= 4096)
_PAD = 255           # an empty decision slot
_FLUSH = 240         # a segment end in a decision stream
_CHUNK = 256         # blocks a stream-building pass holds
_NBRS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
         (1, 1))

# per block, filled by the host: coefficient pointer and row stride
# (elements), h, w, orient, lazy, need_dist, the byte offset and size of
# its output slot
DESC = ("ptr", "stride", "h", "w", "orient", "lazy", "need_dist",
        "slot_off", "slot_cap")
# per block, filled by the kernel: offset and length of the codeword in
# the packed pool, numbps, status, sum of squared magnitudes, and the MQ
# and raw decisions coded (the length of the block's serial chain)
META = ("out_off", "out_len", "numbps", "status", "sumsq", "decisions")
STATUS_RANGE = 1     # numbps above the block's limit (26, or 20 with dist)
STATUS_SLOT = 2      # the codeword outgrew its slot


@dataclass
class MQEncoded:
    """Per block: data (bytes), numbps; per block and pass (B, 76):
    rates (int64), terms (uint8), dists (float64, zero without
    need_dist); e0 (B,) float64 (sum of squared magnitudes)."""
    data: list
    numbps: np.ndarray
    rates: np.ndarray
    terms: np.ndarray
    dists: np.ndarray
    e0: np.ndarray

    def num_passes(self, k: int) -> int:
        nb = int(self.numbps[k])
        return 3 * nb - 2 if nb else 0


def _per_block(v, n: int, name: str) -> list:
    if isinstance(v, (bool, int, np.integer, np.bool_)):
        return [int(v)] * n
    v = [int(x) for x in v]
    if len(v) != n:
        raise ValueError(f"one {name} a codeblock")
    return v


def check_blocks(blocks) -> torch.device:
    devices = {b.device for b in blocks}
    if len(devices) != 1:
        raise ValueError(f"codeblocks lie on different devices: {devices}")
    for b in blocks:
        if b.dtype != torch.int32:
            raise TypeError(f"expected int32 codeblocks, got {b.dtype}")
        if b.dim() != 2:
            raise ValueError(f"expected (h, w) codeblocks, got {b.shape}")
        h, w = b.shape
        if not (h > 0 and w > 0 and h * w <= 4096 and w <= 1024):
            raise ValueError("MQ codeblocks must be non-empty, within 4096 "
                             f"samples and 1024 columns, got {(h, w)}")
        if w > 1 and b.stride(1) != 1:
            raise ValueError("codeblock rows must be contiguous")
    return devices.pop()


def encode_cblks_mq(blocks, orients, lazy, need_dist=False,
                    numbps_bound=None) -> MQEncoded:
    """Code (h, w) int32 codeblocks, mixed shapes; orients, lazy and
    need_dist per block (or one value for all).  numbps_bound (per block,
    default 26) sizes each block's output slot on the card.  CUDA tensors
    launch the kernel, CPU tensors run the twin; other devices raise."""
    blocks = list(blocks)
    n = len(blocks)
    orients = _per_block(orients, n, "orient")
    lazy = _per_block(lazy, n, "lazy flag")
    need_dist = _per_block(need_dist, n, "need_dist flag")
    if not blocks:
        return _empty()
    device = check_blocks(blocks)
    if device.type == "cpu":
        return _encode_plain(blocks, orients, lazy, need_dist)
    if device.type != "cuda":
        raise ValueError(f"no kernel route for device {device}")
    bounds = _per_block(MAX_NUMBPS_DEVICE if numbps_bound is None
                        else numbps_bound, n, "numbps bound")
    args = encode_args(blocks, orients, lazy, need_dist, bounds, device)
    launch_encode(args, device)
    return finish_encode(args)


def encode_cblks_mq_plain(blocks, orients, lazy, need_dist=False):
    """Plain PyTorch twin of encode_cblks_mq, on the blocks' own device."""
    blocks = list(blocks)
    n = len(blocks)
    orients = _per_block(orients, n, "orient")
    lazy = _per_block(lazy, n, "lazy flag")
    need_dist = _per_block(need_dist, n, "need_dist flag")
    if not blocks:
        return _empty()
    check_blocks(blocks)
    return _encode_plain(blocks, orients, lazy, need_dist)


def _empty() -> MQEncoded:
    z = np.zeros((0, MAX_PASSES))
    return MQEncoded([], np.zeros(0, np.int64), z.astype(np.int64),
                     z.astype(np.uint8), z, np.zeros(0))


# ------------------------------------------------------------ kernel route

def encode_args(blocks, orients, lazy, need_dist, bounds,
                device: torch.device):
    """The kernel's arguments: (desc, slots, packed, used, meta, rates,
    terms, dists) on the device, then the launch's dynamic shared memory in
    bytes.  The blocks must outlive the launch."""
    hw = np.array([tuple(b.shape) for b in blocks], np.int64).reshape(-1, 2)
    desc = desc_rows(hw[:, 0], hw[:, 1], orients, lazy, need_dist, bounds)
    desc[:, 0] = [b.data_ptr() for b in blocks]
    desc[:, 1] = [b.stride(0) for b in blocks]
    return desc_args(desc, device)


def desc_rows(h, w, orient, lazy, need_dist, bounds) -> np.ndarray:
    """DESC rows with the coefficient pointer and row stride left 0: per
    block (arrays, or one value for all but h) h, w, orient, the lazy and
    need_dist flags, and an output slot sized by the block's numbps bound,
    the slots one after another."""
    desc = np.zeros((len(h), len(DESC)), np.int64)
    desc[:, 2] = h
    desc[:, 3] = w
    desc[:, 4] = orient
    desc[:, 5] = lazy
    desc[:, 6] = need_dist
    desc[:, 8] = out_capacity(desc[:, 2], desc[:, 3], np.asarray(bounds))
    desc[:, 7] = np.cumsum(desc[:, 8]) - desc[:, 8]
    return desc


def desc_args(desc: np.ndarray, device: torch.device):
    """encode_args from descriptor rows built by the caller: (n, 9) int64,
    DESC's columns, each block's slot inside the sum of the slot sizes.
    One copy takes the rows to the device; the blocks must outlive the
    launch."""
    n = len(desc)
    total = int(desc[:, 8].sum())
    return (torch.from_numpy(np.ascontiguousarray(desc)).to(device),
            torch.empty(total, dtype=torch.uint8, device=device),
            torch.empty(total, dtype=torch.uint8, device=device),
            torch.empty(1, dtype=torch.int64, device=device),
            torch.empty((n, len(META)), dtype=torch.int64, device=device),
            torch.empty((n, MAX_PASSES), dtype=torch.int32, device=device),
            torch.empty((n, MAX_PASSES), dtype=torch.uint8, device=device),
            torch.empty((n, MAX_PASSES), dtype=torch.int64, device=device),
            launch_smem(desc[:, 2:4]))


_DEVICE_TABLES: dict = {}


def device_tables(device: torch.device) -> torch.Tensor:
    """The MQ tables the kernels take, one uint8 tensor on `device`
    (csrc/mq_common.cuh kTab*): QE_FUSED as little-endian uint32 (94), ZC
    (4 x 256), SC_WORD (256), the initial contexts (19)."""
    tab = _DEVICE_TABLES.get(device)
    if tab is None:
        host = np.concatenate([
            QE_FUSED.astype("<u4").view(np.uint8), ZC_LUT.reshape(-1),
            SC_WORD, INIT_CTX])
        tab = _DEVICE_TABLES[device] = torch.from_numpy(
            np.ascontiguousarray(host)).to(device)
    return tab


def launch_encode(args, device: torch.device) -> None:
    """One launch of grk_mq_encode on encode_args' tensors."""
    desc, slots, packed, used = args[:4]
    used.zero_()
    launch("mq_encode", "grk_mq_encode", device,
           (desc, device_tables(device), *args[1:8]),
           (len(desc), len(slots), args[8]))


def finish_encode(args) -> MQEncoded:
    """The host half after a launch: the per-block results and the pool's
    used bytes in one copy, the codewords in another."""
    _, _, packed, used, meta, rates, terms, dists, _ = args
    n = len(meta)
    small = torch.cat([used, meta.reshape(-1), rates.to(torch.int64)
                       .reshape(-1), terms.to(torch.int64).reshape(-1),
                       dists.reshape(-1)]).cpu().numpy()
    m = small[1:1 + n * len(META)].reshape(n, len(META))
    k = 1 + n * len(META)
    r = small[k:k + n * MAX_PASSES].reshape(n, MAX_PASSES)
    k += n * MAX_PASSES
    t = small[k:k + n * MAX_PASSES].reshape(n, MAX_PASSES).astype(np.uint8)
    k += n * MAX_PASSES
    d = small[k:].reshape(n, MAX_PASSES).astype(np.float64)
    _raise_on(m[:, 3])
    pool = packed[:int(small[0])].cpu().numpy()
    data = [pool[o:o + ln].tobytes() for o, ln in m[:, :2].tolist()]
    return MQEncoded(data, m[:, 2].copy(), r, t, d,
                     m[:, 4].astype(np.float64))


def finish_encode_flat(args, extra: int = 0, need_dist: bool = False):
    """finish_encode without the per-block bytes: (the pool's used bytes,
    followed by `extra` bytes left for the caller, as one uint8 array;
    meta (n, 6) int64, META's columns; rates (n, MAX_PASSES) int32; with
    need_dist the cumulative distortions (n, MAX_PASSES) float64, else
    None), after the checks.  e0 is META's `sumsq`.  The results, the
    distortions and the used count come back in one copy, the pool in
    another."""
    _, _, packed, used, meta, rates, _, dists = args[:8]
    n = len(meta)
    parts = [used, meta.reshape(-1), rates.view(torch.int64).reshape(-1)]
    if need_dist:
        parts.append(dists.reshape(-1))
    small = torch.cat(parts).cpu().numpy()
    k = 1 + n * len(META)
    m = small[1:k].reshape(n, len(META))
    r = small[k:k + n * MAX_PASSES // 2].view(np.int32).reshape(
        n, MAX_PASSES)
    d = None
    if need_dist:
        d = small[k + n * MAX_PASSES // 2:].reshape(n, MAX_PASSES).astype(
            np.float64)
    _raise_on(m[:, 3])
    used = int(small[0])
    data = np.empty(used + extra, np.uint8)
    if used:
        torch.from_numpy(data[:used]).copy_(packed[:used])
    return data, m, r, d


def _raise_on(status) -> None:
    if (status == STATUS_RANGE).any():
        raise ValueError("magnitudes exceed the device MQ range")
    if (status == STATUS_SLOT).any():
        raise RuntimeError("MQ encode: a codeword outgrew its slot")


# ------------------------------------------------------------ plain twin

def _tables(device):
    return dict(
        zc=torch.from_numpy(ZC_LUT.astype(np.int64)).to(device),
        sc_cn=torch.from_numpy(SC_CN.astype(np.int64)).to(device),
        sc_xor=torch.from_numpy(SC_XOR.astype(np.int64)).to(device))


def _views8(a: torch.Tensor, fill: int):
    """The 8 neighbour views of (n, h, w), order NW N NE W E SW S SE (the
    neighbour's value seen from each sample), as slices of one padded
    copy."""
    h, w = a.shape[-2:]
    p = F.pad(a, (1, 1, 1, 1), value=fill)
    return [p[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w] for dy, dx in _NBRS]


def _min8(t: torch.Tensor) -> torch.Tensor:
    """The smallest neighbour time of every sample."""
    v = _views8(t, _INF)
    m = torch.minimum(v[0], v[1])
    for x in v[2:]:
        m = torch.minimum(m, x)
    return m


def _nbr_index(times, signs, visit):
    """ZC index and SC index of every sample, a neighbour counting as
    significant when its time is below `visit`."""
    sig = [(v < visit).to(torch.int32) for v in _views8(times, _INF)]
    ns = _views8(signs, 0)
    zc = sig[0]
    for k in range(1, 8):
        zc = zc | (sig[k] << k)
    ws, es, nn, ss = sig[3], sig[4], sig[1], sig[6]
    sc = (ws | ((ws & ns[3]) << 1) | (es << 2) | ((es & ns[4]) << 3)
          | (nn << 4) | ((nn & ns[1]) << 5) | (ss << 6)
          | ((ss & ns[6]) << 7))
    return zc.to(torch.int64), sc.to(torch.int64)


def _to_slots(a: torch.Tensor, stripes: int) -> torch.Tensor:
    """(n, h, w) -> (n, S, w, 4) in scan order, partial stripes padded."""
    n, h, w = a.shape
    ap = F.pad(a, (0, 0, 0, 4 * stripes - h))
    return ap.reshape(n, stripes, 4, w).transpose(2, 3)


def _plane(mag, sign, nb, orient, lazy, i, times, tabs):
    """One plane's decision slots for a group of (n, h, w) blocks (the
    reference's `_plane_slots`).  Returns (times', mq_ctx (n, P), mq_bit,
    raw_bit (n, R), raw_valid, section counts (n, 3), raw SPP count)."""
    n, h, w = mag.shape
    dev = mag.device
    S = (h + 3) // 4
    y = torch.arange(h, device=dev)[:, None]
    x = torch.arange(w, device=dev)[None, :]
    sidx = ((y >> 2) * (4 * w) + x * 4 + (y & 3)).to(torch.int32)
    rows_of = torch.clamp(h - 4 * torch.arange(S, device=dev), max=4)
    pv = (i < nb)[:, None, None]                                 # (n,1,1)
    p = torch.clamp(nb - 1 - i, min=0)[:, None, None]
    bit = ((mag >> p) & 1) * pv
    base = (3 * i) << _POS_BITS
    spp_visit = base + sidx
    mrp_thresh = base + (1 << _POS_BITS)
    cup_visit = base + (2 << _POS_BITS) + sidx
    sig_before = times < base
    is_top = i == 0
    is_raw = (lazy & (i >= 4)).view(n, 1, 1, 1, 1)

    # SPP wavefront: the exact fixpoint of forward significance spread
    cand = ~sig_before & (bit == 1) & pv & (not is_top)
    if bool(cand.any()):
        while True:
            t2 = torch.where(cand & (_min8(times) < spp_visit),
                             torch.minimum(times, spp_visit), times)
            if torch.equal(t2, times):
                break
            times = t2
    m8 = _min8(times)
    spp_member = ~sig_before & pv & (m8 < spp_visit) & (not is_top)

    zc_idx, sc_idx = _nbr_index(times, sign, spp_visit)
    zc_o = tabs["zc"][orient][:, None, :]                        # (n,1,256)
    zc_ctx = torch.gather(zc_o.expand(n, h, 256), 2, zc_idx)
    row_valid = _to_slots(torch.ones((n, h, w), dtype=torch.int64,
                                     device=dev), S) > 0
    s_bit = _to_slots(bit, S)
    v0 = (_to_slots(spp_member.to(torch.int64), S) > 0) & row_valid
    v1 = v0 & (s_bit > 0)
    spp_ctx = torch.stack(
        [torch.where(v0, _to_slots(zc_ctx, S), _PAD),
         torch.where(v1, _to_slots(tabs["sc_cn"][sc_idx], S), _PAD)], -1)
    spp_bitv = torch.stack(
        [s_bit, _to_slots(sign ^ tabs["sc_xor"][sc_idx], S)], -1)

    # MRP
    mrp_member = sig_before & pv & (not is_top)
    firstsig = torch.frexp(mag.clamp(min=1).to(torch.float64)).exponent - 1
    first_ref = p == (firstsig - 1)
    any_nb = m8 < mrp_thresh
    mr_ctx = torch.where(first_ref, CTX_MAG + any_nb.to(torch.int64),
                         CTX_MAG + 2)
    vm = (_to_slots(mrp_member.to(torch.int64), S) > 0) & row_valid
    mrp_ctx = torch.where(vm, _to_slots(mr_ctx, S), _PAD)[..., None]
    mrp_bitv = s_bit[..., None]

    # CUP: cleanup significance times, aggregation, slots
    remaining = ~sig_before & ~spp_member & pv
    times = torch.where(remaining & (bit == 1),
                        torch.minimum(times, cup_visit), times)
    cv = base + (2 << _POS_BITS) + _to_slots(sidx[None].expand(n, h, w),
                                             S)[..., 0]          # (n,S,w)
    m8c = _min8(times)
    sig_or_vis = (times < base + (2 << _POS_BITS)) | spp_member
    sv = _to_slots(sig_or_vis.to(torch.int64), S) > 0
    nbr_lt = _to_slots(m8c, S) < cv[..., None]
    full = (rows_of == 4)[None, :, None]
    agg = full & pv & ~(sv | nbr_lt).any(-1)
    ones = torch.ones_like(s_bit[..., :1])
    first = (torch.cat([s_bit, ones], -1) > 0).to(torch.int64).argmax(-1)
    has_first = first < 4
    zc_c, sc_c = _nbr_index(times, sign, cup_visit)
    cup_zc = _to_slots(torch.gather(zc_o.expand(n, h, 256), 2, zc_c), S)
    cup_sc = _to_slots(tabs["sc_cn"][sc_c], S)
    cup_scb = _to_slots(sign ^ tabs["sc_xor"][sc_c], S)
    uni = agg & has_first
    fk = first.clamp(max=3)[..., None]
    sc_first = cup_sc.gather(-1, fk)[..., 0]
    scb_first = cup_scb.gather(-1, fk)[..., 0]
    k4 = torch.arange(4, device=dev)
    rem_s = _to_slots(remaining.to(torch.int64), S) > 0
    vzc = rem_s & row_valid & torch.where(
        agg[..., None], uni[..., None] & (k4 > first[..., None]), True)
    vsc = vzc & (s_bit > 0)
    per_k = torch.stack([torch.where(vzc, cup_zc, _PAD),
                         torch.where(vsc, cup_sc, _PAD)], -1).reshape(
        n, S, w, 8)
    per_kb = torch.stack([s_bit, cup_scb], -1).reshape(n, S, w, 8)
    cup_ctx = torch.cat([torch.stack(
        [torch.where(agg, CTX_RL, _PAD), torch.where(uni, CTX_UNI, _PAD),
         torch.where(uni, CTX_UNI, _PAD), torch.where(uni, sc_first, _PAD)],
        -1), per_k], -1)
    cup_bit = torch.cat([torch.stack(
        [has_first.to(torch.int64), (first >> 1) & 1, first & 1,
         scb_first], -1), per_kb], -1)

    # raw routing under bypass; one flush slot when the CUP terminates
    mq_spp = torch.where(is_raw, _PAD, spp_ctx)
    mq_mrp = torch.where(is_raw, _PAD, mrp_ctx)
    raw_spp_v = is_raw & (spp_ctx != _PAD)
    raw_mrp_v = is_raw & (mrp_ctx != _PAD)
    raw_spp_b = torch.stack([s_bit, _to_slots(sign, S)], -1)
    term = ((lazy & (i >= 3)) | (i == nb - 1)) & (i < nb)
    flush = torch.where(term, _FLUSH, _PAD)[:, None]
    mq_ctx = torch.cat([mq_spp.reshape(n, -1), mq_mrp.reshape(n, -1),
                        cup_ctx.reshape(n, -1), flush], 1)
    mq_bit = torch.cat([spp_bitv.reshape(n, -1), mrp_bitv.reshape(n, -1),
                        cup_bit.reshape(n, -1),
                        torch.zeros((n, 1), dtype=torch.int64,
                                    device=dev)], 1)
    raw_bit = torch.cat([raw_spp_b.reshape(n, -1), mrp_bitv.reshape(n, -1)],
                        1)
    raw_valid = torch.cat([raw_spp_v.reshape(n, -1),
                           raw_mrp_v.reshape(n, -1)], 1)
    ls, lm = mq_spp.reshape(n, -1).shape[1], mq_mrp.reshape(n, -1).shape[1]
    v = mq_ctx != _PAD
    sec = torch.stack([v[:, :ls].sum(1), v[:, ls:ls + lm].sum(1),
                       v[:, ls + lm:].sum(1)], 1)
    raw_spp = raw_spp_v.reshape(n, -1).sum(1)
    return times, mq_ctx, mq_bit, raw_bit, raw_valid, sec, raw_spp


def _compact(vals: torch.Tensor, valid: torch.Tensor):
    """Stable compaction of the valid entries of each row to its front:
    ((n, max count) values, counts)."""
    counts = valid.sum(1)
    width = max(1, int(counts.max()) if len(counts) else 1)
    pos = torch.where(valid, torch.cumsum(valid, 1) - 1, width)
    out = torch.zeros((len(vals), width + 1), dtype=vals.dtype,
                      device=vals.device)
    out.scatter_(1, pos, vals)
    return out[:, :width], counts


def decision_streams(mag, sign, nb, orient, lazy, maxp):
    """The ordered decisions of a group of (n, h, w) blocks, planes 0 ..
    maxp - 1 from each block's top: (mq_ctx (n, L), mq_bit, counts,
    section counts (n, maxp, 3), raw bits (n, R), raw counts a plane
    (n, maxp), raw SPP counts a plane, significance times (n, h, w))."""
    tabs = _tables(mag.device)
    times = torch.full(mag.shape, _INF, dtype=torch.int32, device=mag.device)
    planes = []
    for i in range(maxp):
        times, *rest = _plane(mag, sign, nb, orient, lazy, i, times, tabs)
        planes.append(rest)
    mq_ctx, mq_bit, raw_bit, raw_valid, sec, raw_spp = (
        list(t) for t in zip(*planes))
    ctx = torch.cat(mq_ctx, 1)
    valid = ctx != _PAD
    ctx_c, counts = _compact(ctx, valid)
    bit_c, _ = _compact(torch.cat(mq_bit, 1), valid)
    rv = torch.cat(raw_valid, 1)
    raw_c, _ = _compact(torch.cat(raw_bit, 1), rv)
    raw_counts = torch.stack([r.sum(1) for r in raw_valid], 1)
    return (ctx_c, bit_c, counts, torch.stack(sec, 1), raw_c, raw_counts,
            torch.stack(raw_spp, 1), times)


def _byteout(c, last, do):
    # type: (Tensor, Tensor, Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]
    """The MQ writer's BYTEOUT on the lanes `do`, the last byte held in a
    register: returns (c, ct after it, last, the byte it finishes)."""
    carry = (last != 0xFF) & (c >= 0x8000000)
    done = last + carry.to(torch.int64)
    ff = done == 0xFF
    c = c - (carry.to(torch.int64) << 27)
    sh = torch.where(ff, torch.full_like(c, 20), torch.full_like(c, 19))
    return (torch.where(do, c & ((torch.ones_like(sh) << sh) - 1), c),
            27 - sh, torch.where(do, (c >> sh) & 0xFF, last), done)


def _writer_loop(ix, dbit, flt, fl_steps, states, qe_k, lps_k, nsi_k, nsh,
                 cap, nseg):
    # type: (Tensor, Tensor, Tensor, List[bool], Tensor, Tensor, Tensor, Tensor, Tensor, int, int) -> Tuple[Tensor, Tensor, Tensor]
    """mq_automaton's step loop: (out (B, cap + 1), seg_end, tots (L, B))."""
    L, b = ix.shape
    dev = ix.device
    lanes = torch.arange(b, device=dev)
    zero = torch.zeros(b, dtype=torch.int64, device=dev)
    a = zero + 0x8000
    c = zero
    ct = zero + 12
    last = zero
    wpos = zero
    tot = zero
    segi = zero
    out = torch.zeros((b, cap + 1), dtype=torch.uint8, device=dev)
    seg_end = torch.zeros((b, max(1, nseg)), dtype=torch.int64, device=dev)
    tots = torch.zeros((L, b), dtype=torch.int64, device=dev)
    full = 0xFFFFFFFF
    for t in range(L):
        k = ix[t]
        st = states[k]
        key = st + dbit[t]
        qe = qe_k[key]
        a2 = a - qe
        swap = (a2 < qe) ^ lps_k[key]
        c = torch.where(swap, c, c + qe)
        a_n = torch.where(swap, qe, a2)
        n = nsh[a_n]
        states[k] = torch.where(n == 0, st, nsi_k[key])
        a = (a_n << n) & 0xFFFF
        do = ct <= n
        for _ in range(2):
            if not bool(do.any()):
                break
            sft = torch.where(do, ct, zero)
            c = (c << sft) & full
            n = n - sft
            ct = ct - sft
            c, ct2, last2, done = _byteout(c, last, do)
            out.index_put_((lanes, wpos), done.to(torch.uint8))
            wpos = wpos + do.to(torch.int64)
            last = last2
            ct = torch.where(do, ct2, ct)
            tot = tot + do.to(torch.int64)
            do = do & (ct <= n)
        c = (c << n) & full
        ct = ct - n
        if fl_steps[t]:
            # SETBITS, two BYTEOUTs, the last byte unless it is 0xFF,
            # then a fresh segment (contexts kept)
            fl = flt[t]
            cf = c | 0xFFFF
            cf = torch.where(cf >= c + a, cf - 0x8000, cf)
            c = torch.where(fl, (cf << ct) & full, c)
            for _ in range(2):
                c, ct2, last2, done = _byteout(c, last, fl)
                out.index_put_((lanes, wpos), done.to(torch.uint8))
                wpos = wpos + fl.to(torch.int64)
                last = last2
                ct = torch.where(fl, ct2, ct)
                c = torch.where(fl, (c << ct) & full, c)
            out.index_put_((lanes, wpos), last.to(torch.uint8))
            wpos = wpos + (fl & (last != 0xFF)).to(torch.int64)
            tot = tot + 2 * fl.to(torch.int64)
            seg_end.index_put_((lanes, torch.where(fl, segi, zero)),
                               torch.where(fl, wpos, seg_end[:, 0]))
            segi = segi + fl.to(torch.int64)
            a = torch.where(fl, zero + 0x8000, a)
            c = torch.where(fl, zero, c)
            ct = torch.where(fl, zero + 12, ct)
            last = torch.where(fl, zero, last)
        tots[t] = tot
    return out, seg_end, tots


def _key_tables(device):
    """Per MQ context state si (stored doubled, 2 si) and decision d, at
    2 si + d: Qe, whether d is the LPS, and the successor (doubled) when
    the interval renormalises.  Entry 188/189 is a dummy state with Qe 0,
    so a lane that codes no decision changes nothing."""
    keys = np.arange(190)
    si, d = keys >> 1, keys & 1
    sic = np.minimum(si, 93)
    lps = (d ^ sic) & 1
    qe = np.where(si < 94, QE[sic].astype(np.int64), 0)
    nsi = np.where(lps == 1, NLPS[sic], NMPS[sic]).astype(np.int64) * 2
    nsi = np.where(si < 94, nsi, 188)
    return tuple(torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for v in (qe, (lps == 1) & (si < 94), nsi))


_SCRIPTED: dict = {}


def script(fn):
    """fn compiled with TorchScript at first use.  The twins' step loops
    run thousands of steps of small tensor operations, which is the CPU
    time of the port's codec tests; TorchScript runs the loops without
    Python's cost per statement (the operations cost what they cost)."""
    if fn.__name__ not in _SCRIPTED:
        _SCRIPTED[fn.__name__] = torch.jit.script(fn)
    return _SCRIPTED[fn.__name__]


def mq_automaton(ctx: torch.Tensor, bit: torch.Tensor, cap: int):
    """The MQ writer over (B, L) decision streams (contexts 0..18, _FLUSH
    for a segment end, _PAD past a block's end), vectorised across blocks.
    Returns (out (B, cap) uint8: every segment's bytes one after another,
    each behind its fake lead byte and without a trailing 0xFF; seg_end
    (B, segments) the write position after each segment; tot (B, L) the
    BYTEOUTs up to and including each step)."""
    dev = ctx.device
    b, L = ctx.shape
    qe_k, lps_k, nsi_k = _key_tables(dev)
    nsh = torch.zeros(1 << 16, dtype=torch.int64, device=dev)
    av = torch.arange(1, 1 << 16, device=dev)
    nsh[1:] = torch.clamp(16 - torch.frexp(av.to(torch.float64)).exponent,
                          min=0)
    lanes = torch.arange(b, device=dev)
    # the flat index of each step's context state; a step without a
    # decision reads and writes the lane's dummy state
    dec = ctx < NUM_CTX
    ix = (lanes[:, None] * (NUM_CTX + 1)
          + torch.where(dec, ctx, NUM_CTX)).T.contiguous()
    flush = ctx == _FLUSH
    states = torch.cat([torch.from_numpy(INIT_CTX.astype(np.int64) * 2),
                        torch.tensor([188])]).to(dev).repeat(b)
    nseg = int(flush.sum(1).max()) if L else 0
    out, seg_end, tots = script(_writer_loop)(
        ix, bit.T.contiguous(), flush.T.contiguous(),
        flush.any(0).tolist(), states, qe_k, lps_k, nsi_k, nsh, cap, nseg)
    return out[:, :cap], seg_end, tots.T


def _raw_pack(bits: np.ndarray):
    """The bypass writer on a 0/1 bit array: (bytes, bit ends of the
    complete bytes).  8 bits a byte, 7 after a 0xFF byte, the last byte
    zero-padded (not counted complete unless full)."""
    n = len(bits)
    out = []
    ends = []
    pos = 0
    seven = False
    while pos < n:
        if seven:
            k = min(7, n - pos)
            v = 0
            for j in range(k):
                v = (v << 1) | int(bits[pos + j])
            out.append(v << (7 - k))
            pos += k
            if k == 7:
                ends.append(pos)
            seven = False
            continue
        packed = np.packbits(bits[pos:])
        full = (n - pos) // 8
        ff = np.flatnonzero(packed[:full] == 0xFF)
        take = int(ff[0]) + 1 if len(ff) else len(packed)
        out.extend(packed[:take].tolist())
        nfull = min(take, full)
        ends.extend(range(pos + 8, pos + 8 * nfull + 1, 8))
        pos = min(n, pos + 8 * take)
        seven = bool(len(ff))
    return bytes(out), np.asarray(ends, np.int64)


def _raw_segment(bits: np.ndarray) -> bytes:
    data, _ = _raw_pack(bits)
    return data[:-1] if data and data[-1] == 0xFF else data


def _raw_pending(bits: np.ndarray, nbits: int) -> int:
    """The writer's num_bytes() after `nbits` of a segment's bits:
    complete bytes, plus one for a partial byte."""
    if nbits <= 0:
        return 0
    _, ends = _raw_pack(bits)
    full = int(np.searchsorted(ends, nbits, side="right"))
    done = int(ends[full - 1]) if full else 0
    return full + (1 if nbits > done else 0)


def _dists(mag, times, nb, maxp):
    """Exact cumulative distortion decrease after each (plane, SPP/MRP/
    CUP) of a group, from the significance times: (n, 3 * maxp) int64,
    and e0 (n,) int64 (the reference's `_dists_fn`, in integers)."""
    m = mag.to(torch.int64)
    evt = times >> _POS_BITS
    ever = times < _INF
    sig_i = evt // 3
    sig_cup = (evt % 3) == 2
    nbv = nb[:, None, None]
    flat = []
    for i in range(maxp):
        bp = torch.clamp(nbv - 1 - i, min=0)
        valid = i < nbv
        one = torch.ones_like(bp) << bp
        nr = one | (one >> 1)
        dsig = m * m - (m - nr) ** 2
        here = ever & (sig_i == i) & valid
        old = ((m >> (bp + 1)) << (bp + 1)) + one
        new = torch.where(bp >= 1, ((m >> bp) << bp) + (one >> 1), m)
        dref = (m - old) ** 2 - (m - new) ** 2
        ref = ever & (sig_i < i) & valid
        flat += [(dsig * (here & ~sig_cup)).sum((1, 2)),
                 (dref * ref).sum((1, 2)),
                 (dsig * (here & sig_cup)).sum((1, 2))]
    return torch.cumsum(torch.stack(flat, 1), 1), (m * m).sum((1, 2))


def _assemble(nb, lazy, out, seg_end, tot, sec, raw_bits, raw_counts,
              raw_spp):
    """Splice one block's MQ and raw segments (numpy inputs): (data, rates
    (3 nb - 2,), terms)."""
    if nb == 0:
        return b"", np.zeros(0, np.int64), np.zeros(0, np.uint8)
    bnd = np.cumsum(sec[:nb].reshape(-1))           # steps through pass k
    cbo = np.concatenate([[0], tot])                # BYTEOUTs in steps < j
    terms = [i for i in range(nb) if (lazy and i >= 3) or i == nb - 1]
    raw_off = np.concatenate([[0], np.cumsum(raw_counts[:nb])])
    data = bytearray()
    rates, tflags = [], []
    seg_start = 0                                   # first step, first byte
    seg_byte = 0
    for i in range(nb):
        if i > 0 and lazy and i >= 4:
            bits = raw_bits[raw_off[i]:raw_off[i + 1]]
            rates.append(len(data) + _raw_pending(bits, int(raw_spp[i]))
                         + 1)
            tflags.append(0)
            data += _raw_segment(bits)
            rates.append(len(data))
            tflags.append(1)
        elif i > 0:
            for k in (3 * i, 3 * i + 1):
                rates.append(len(data) + int(cbo[bnd[k]] - cbo[seg_start])
                             + 4)
                tflags.append(0)
        if i in terms:
            end = int(seg_end[len(terms[:terms.index(i)])])
            data += out[seg_byte + 1:end].tobytes()
            rates.append(len(data))
            tflags.append(1)
            seg_start, seg_byte = int(bnd[3 * i + 2]), end
        else:
            rates.append(len(data) + int(cbo[bnd[3 * i + 2]]
                                         - cbo[seg_start]) + 4)
            tflags.append(0)
    rates = np.minimum(np.asarray(rates, np.int64), len(data))
    rates = np.minimum.accumulate(rates[::-1])[::-1]
    return bytes(data), rates, np.asarray(tflags, np.uint8)


def encode_plain_flat(blocks, orients, lazy, extra: int = 0,
                      need_dist: bool = False):
    """The twin's results as finish_encode_flat gives the kernel's: every
    block's codeword in one uint8 array (with `extra` bytes to spare after
    them), meta (n, 6) int64 (offset, length, numbps; status 0; sumsq),
    rates (n, MAX_PASSES) int32 and, with need_dist, the distortions (n,
    MAX_PASSES) float64 (else None)."""
    n = len(blocks)
    res = _encode_plain(list(blocks), _per_block(orients, n, "orient"),
                        _per_block(lazy, n, "lazy flag"),
                        [int(need_dist)] * n)
    lens = np.fromiter(map(len, res.data), np.int64, n)
    meta = np.zeros((n, len(META)), np.int64)
    meta[:, 0] = np.cumsum(lens) - lens
    meta[:, 1] = lens
    meta[:, 2] = res.numbps
    meta[:, 4] = res.e0
    used = int(lens.sum())
    data = np.empty(used + extra, np.uint8)
    data[:used] = np.frombuffer(b"".join(res.data), np.uint8)
    return data, meta, res.rates.astype(np.int32), (
        res.dists if need_dist else None)


def _encode_plain(blocks, orients, lazy, need_dist) -> MQEncoded:
    """The twin: decision streams per shape, _CHUNK blocks at a time; one
    automaton over every block; distortions; splicing per block."""
    n = len(blocks)
    dev = blocks[0].device
    mags = [b.to(torch.int64).abs() for b in blocks]
    numbps = torch.stack([torch.frexp(m.max().to(torch.float64)).exponent
                          for m in mags]).to(torch.int64).cpu().numpy()
    limit = np.where(np.asarray(need_dist) != 0, MAX_NUMBPS_DIST,
                     MAX_NUMBPS_DEVICE)
    if (numbps > limit).any():
        raise ValueError("magnitudes exceed the device MQ range")
    maxp = max(1, int(numbps.max()))
    groups: dict = defaultdict(list)
    for k, b in enumerate(blocks):
        groups[tuple(b.shape)].append(k)
    per = [None] * n
    dist = np.zeros((n, MAX_PASSES))
    e0 = np.zeros(n)
    for (h, w), idx in groups.items():
        for c0 in range(0, len(idx), _CHUNK):
            part = idx[c0:c0 + _CHUNK]
            mag = torch.stack([mags[k] for k in part])
            sign = torch.stack([(blocks[k] < 0).to(torch.int32)
                                for k in part])
            nb = torch.tensor(numbps[part], device=dev)
            pmax = max(1, int(numbps[part].max()))
            res = decision_streams(
                mag.to(torch.int32), sign, nb,
                torch.tensor([orients[k] for k in part], device=dev),
                torch.tensor([bool(lazy[k]) for k in part], device=dev),
                pmax)
            ctx, bit, counts, sec, raw_c, raw_counts, raw_spp, times = res
            for j, k in enumerate(part):
                per[k] = (ctx[j], bit[j], int(counts[j]), sec[j], raw_c[j],
                          raw_counts[j], raw_spp[j])
            if any(need_dist[k] for k in part):
                cum, _ = _dists(mag, times, nb, pmax)
                cum = cum.cpu().numpy()
                for j, k in enumerate(part):
                    nbk = int(numbps[k])
                    if need_dist[k] and nbk:
                        sel = [2] + list(range(3, 3 * nbk))
                        dist[k, :len(sel)] = cum[j, sel].astype(np.float64)
            e0[part] = (mag * mag).sum((1, 2)).cpu().numpy()
    L = max(1, max(p[2] for p in per))
    ctx = torch.full((n, L), _PAD, dtype=torch.int64, device=dev)
    bit = torch.zeros((n, L), dtype=torch.int64, device=dev)
    for k, p in enumerate(per):
        ctx[k, :p[2]] = p[0][:p[2]]
        bit[k, :p[2]] = p[1][:p[2]]
    cap = int(max(out_capacity(int(b.shape[0]), int(b.shape[1]), maxp)
                  for b in blocks)) + 2 * MAX_NUMBPS_DEVICE
    out, seg_end, tot = (t.cpu().numpy() for t in mq_automaton(ctx, bit,
                                                                 cap))
    data = []
    rates = np.zeros((n, MAX_PASSES), np.int64)
    terms = np.zeros((n, MAX_PASSES), np.uint8)
    for k, p in enumerate(per):
        nbk = int(numbps[k])
        cnt = p[2]
        d, r, t = _assemble(nbk, bool(lazy[k]), out[k], seg_end[k],
                            tot[k, :cnt], p[3].cpu().numpy(),
                            p[4].cpu().numpy().astype(np.uint8),
                            p[5].cpu().numpy(), p[6].cpu().numpy())
        data.append(d)
        rates[k, :len(r)] = r
        terms[k, :len(t)] = t
    return MQEncoded(data, numbps.astype(np.int64), rates, terms, dist, e0)
