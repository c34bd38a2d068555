"""A tile's codeblocks as one flat batch for the device coders.

The tile processor walks a tile's codeblocks once, in the order the native
whole-tile coders take them (the precinct walk on encode, the packet-order
walk on decode), into a BlockTable that stays cached on the pooled tile.
The functions here turn a table, the tile's band tensors and, on decode,
the sequence decode's chunk records and the stream into the batch objects
of t1/backend.py (HTEncodeTile, MQEncodeTile, HTDecodeTile, MQDecodeTile)
with array expressions, so that a call builds no per-block Python object
for the blocks the device codes.  backend.on_card places the blocks; the
rest code on the native coder, as jobs built here on encode and, on
decode, as the indices the caller makes jobs of.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops import ht_encode, mq_decode, mq_encode
from ..params import CblkStyle
from .backend import (EncodeJob, HTDecodeTile, HTEncodeTile, MQDecodeTile,
                      MQEncodeTile, on_card)

log = logging.getLogger("grok_tpu_torch")

# BlockTable.cols, one column a name
_COLS = ("band", "y", "x", "h", "w", "orient", "style", "mb")


@dataclass(frozen=True, eq=False)
class BlockTable:
    """A tile's codeblocks, one row a block, in the order the native
    whole-tile coders take them.

    Given, as the native coders take them: `hw` (2n,) int32, h and w;
    `meta` (4n,) int32, orient, style, the band's M_b (0 for an empty
    block on encode) and the band id; `flags` (n,) int32, bit 0 HT (on
    decode bit 1 the ht_mixed set); `off` (n,) the block's first sample
    in its band, row-major (int64 on encode, int32 on decode).  A band:
    `band_keys` (compno, resno, orient), `band_shape` (h, w) and, on
    encode only, `band_delta`, its 9/7 step (0 on 5/3).

    Derived once, here: `cols` (n, 8) int64 with one attribute a column
    (`band`, `y` and `x` in the band, `h`, `w`, `orient`, `style`, `mb`),
    `blk` its first five columns, `ht` and `coded` (both sides non-zero)
    a block, `band_w` a band (its width, at least 1); on encode `caps`
    (n,) int32, each block's output slot as t1/native.py sizes it, and
    `slot_off`, its offset in the `total_cap` bytes of all."""

    hw: np.ndarray
    meta: np.ndarray
    flags: np.ndarray
    off: np.ndarray
    band_keys: list
    band_shape: list
    band_delta: np.ndarray | None = None

    @classmethod
    def from_rows(cls, rows: list, band_keys: list, band_shape: list,
                  off_dtype, band_delta=None) -> BlockTable:
        """A table from one (h, w, orient, style, mb, band id, flags, off)
        tuple a block."""
        a = np.asarray(rows, np.int64).reshape(-1, 8)
        return cls(a[:, :2].astype(np.int32).reshape(-1),
                   a[:, 2:6].astype(np.int32).reshape(-1),
                   a[:, 6].astype(np.int32), a[:, 7].astype(off_dtype),
                   band_keys, band_shape, band_delta)

    def __post_init__(self):
        hw = self.hw.reshape(-1, 2).astype(np.int64)
        m = self.meta.reshape(-1, 4).astype(np.int64)
        band_w = np.asarray([max(w, 1) for _, w in self.band_shape],
                            np.int64)
        off = self.off.astype(np.int64)
        bw = band_w[m[:, 3]]
        cols = np.stack([m[:, 3], off // bw, off % bw, hw[:, 0], hw[:, 1],
                         m[:, 0], m[:, 1], m[:, 2]], 1)
        derived = dict(zip(_COLS, cols.T), cols=cols, band_w=band_w,
                       _plans={},
                       blk=np.ascontiguousarray(cols[:, :5]),
                       ht=(self.flags & 1).astype(bool),
                       coded=(hw[:, 0] > 0) & (hw[:, 1] > 0))
        if self.band_delta is not None:
            area, mb = hw[:, 0] * hw[:, 1], m[:, 2]
            caps = np.where(derived["coded"], np.where(
                derived["ht"], np.maximum(4096, area * 5 + 2048),
                np.maximum(4096, area * np.maximum(4, mb) // 2 + 2048)),
                0).astype(np.int32)
            derived.update(
                caps=caps, total_cap=int(caps.sum(dtype=np.int64)),
                slot_off=np.cumsum(caps, dtype=np.int64) - caps)
        for k, v in derived.items():
            object.__setattr__(self, k, v)

    def __len__(self) -> int:
        return len(self.flags)

    def encode_plan(self, need_dist: bool = False) -> _EncodePlan:
        """The table's flat encode split, with or without distortions
        tracked (which caps the card's MQ numbps lower), made once a
        flag."""
        plan = self._plans.get(need_dist)
        if plan is None:
            plan = self._plans[need_dist] = self._make_plan(need_dist)
        return plan

    def _make_plan(self, need_dist: bool) -> _EncodePlan:
        card = self.coded & on_card(self.ht, self.h, self.w, self.style,
                                    self.mb, need_dist=need_dist)
        dev = np.flatnonzero(card)
        host = np.flatnonzero(self.coded & ~card)
        mq_desc = None
        if self.ht.any():
            ht_encode.check_shapes(self.h[dev], self.w[dev])
        else:
            mq_desc = mq_encode.desc_rows(
                self.h[dev], self.w[dev], self.orient[dev],
                self.style[dev] == CblkStyle.LAZY, int(need_dist),
                self.mb[dev])
        return _EncodePlan(dev, host, np.concatenate([dev, host]),
                           np.unique(self.band[self.coded]).tolist(),
                           mq_desc)


class _EncodePlan(NamedTuple):
    """A table's flat encode split, the same every call: the coded
    blocks on the device (`dev`) and those the native coder takes
    (`host`), as indices into the table, and both in the batch's `order`;
    the bands they lie in (`used`); for MQ the encoder's rows less the
    addresses, with the plan's need_dist flag (`mq_desc`, None for HT)."""
    dev: np.ndarray
    host: np.ndarray
    order: np.ndarray
    used: list
    mq_desc: np.ndarray | None


def _resolved(device) -> torch.device:
    """`device` with its index, as a tensor made there reports it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _addresses(table: BlockTable, bands: list, used, blk: np.ndarray,
               device):
    """(address, row stride) of each `blk` row's first sample in its band
    tensor, or None where a band of `used` is not an int32 (h, w) tensor
    on `device` with the table's width and unit column stride."""
    device = _resolved(device)
    base = np.zeros(len(bands), np.int64)
    stride = np.zeros(len(bands), np.int64)
    for i in used:
        t = bands[i]
        if (not isinstance(t, torch.Tensor) or t.device != device
                or t.dtype != torch.int32 or t.dim() != 2
                or t.shape[1] != table.band_w[i]
                or (t.shape[1] > 1 and t.stride(1) != 1)):
            return None
        base[i] = t.data_ptr()
        stride[i] = t.stride(0)
    b = blk[:, 0]
    return base[b] + (blk[:, 1] * stride[b] + blk[:, 2]) * 4, stride[b]


def encode_tile(table: BlockTable, bands: list, device,
                need_dist: bool = False):
    """A tile of all-HT or all-MQ blocks as one HTEncodeTile or
    MQEncodeTile over `bands` (a tensor a band of the table, None where
    the tile has none); an MQ tile may track distortions (`need_dist`), an
    HT tile may not.  None where it would, where the table has no block or
    where a band the batch reads is not fit to read in place.  The blocks
    the native coder takes come to the host a band at a time, as jobs."""
    ht = bool(table.ht.any())
    if not len(table) or ht and need_dist:
        return None
    plan = table.encode_plan(need_dist)
    blk = table.blk[plan.dev]
    got = _addresses(table, bands, plan.used, blk, device)
    if got is None:
        return None
    if ht:
        desc = np.empty((len(blk), 4), np.int64)
        desc[:, 2:] = blk[:, 3:]
    else:
        desc = plan.mq_desc.copy()
    desc[:, 0], desc[:, 1] = got
    host = []
    on_host: dict = {}
    for bi, y, x, h, w, orient, style, mb in table.cols[plan.host].tolist():
        a = on_host.get(bi)
        if a is None:
            a = on_host[bi] = bands[bi].cpu().numpy()
        host.append(EncodeJob(a[y:y + h, x:x + w], orient, CblkStyle(style),
                              ht=ht, need_dist=need_dist, numbps_bound=mb))
    if ht:
        return HTEncodeTile(bands, blk, desc, host)
    return MQEncodeTile(bands, blk, desc, host, need_dist=need_dist)


class EncodeResults(NamedTuple):
    """A coded batch's results in the table's block order, as the native
    whole-tile encode leaves them: each block's byte offset (`offs`) and
    length (`lens`) in the batch's data, `numbps`, `npasses`, and its
    passes' cumulative `rates`, (n, stride); where the batch tracked
    distortions their raw cumulative `dists` (n, stride) float64 and each
    block's `e0`, else None."""
    offs: np.ndarray
    lens: np.ndarray
    numbps: np.ndarray
    npasses: np.ndarray
    rates: np.ndarray
    dists: np.ndarray | None
    e0: np.ndarray | None


def encode_results(table: BlockTable, t) -> EncodeResults:
    """A coded encode_tile batch's EncodeResults; a block the batch does
    not hold reads as uncoded.  HT: one cleanup pass a coded block, its
    length the pass's rate; MQ: 3 numbps - 2 passes and their rates and,
    where the batch tracked distortions, their distortions and e0.  A
    numbps above the band's M_b is clamped to it, with a warning."""
    n = len(table)
    mq = isinstance(t, MQEncodeTile)
    order = table.encode_plan(mq and t.need_dist).order
    offs = np.zeros(n, np.int64)
    lens = np.zeros(n, np.int32)
    numbps = np.zeros(n, np.int32)
    offs[order] = t.offs
    lens[order] = t.lens
    numbps[order] = t.numbps
    dists = e0 = None
    if mq:
        npasses = np.where(numbps > 0, 3 * numbps - 2, 0).astype(np.int32)
        rates = np.zeros((n, t.rates.shape[1]), np.int32)
        rates[order] = t.rates
        if t.need_dist:
            dists = np.zeros((n, t.dists.shape[1]))
            dists[order] = t.dists
            e0 = np.zeros(n)
            e0[order] = t.e0
    for g in np.flatnonzero(numbps > table.mb).tolist():
        log.warning("codeblock numbps %d exceeds band M_b %d",
                    numbps[g], table.mb[g])
        numbps[g] = table.mb[g]
    if not mq:
        npasses = (numbps > 0).astype(np.int32)
        rates = lens.reshape(n, 1)
    return EncodeResults(offs, lens, numbps, npasses, rates, dists, e0)


def decode_tile(table: BlockTable, recs: np.ndarray, data, zb: np.ndarray,
                bands: list, device):
    """A tile of all-HT or all-MQ blocks, as Tier-2's sequence decode
    left it (`recs`: chunk records (block, passes, offset in `data`,
    length), `data`: the tile's stream, `zb`: each block's zero
    bit-planes), as one HTDecodeTile or MQDecodeTile writing `bands` (a
    device tensor a band of the table), with no host jobs; and the
    indices of the coded blocks with passes that it leaves to the native
    coder.  None where the records do not fit the table or the stream, an
    HT block has more than one chunk, or an MQ block's chunks do not
    follow one another in the stream.  The descriptor rows come from the
    records in array expressions, and the bytes stay where they lie."""
    n = len(table)
    r = recs.reshape(-1, 4).astype(np.int64)
    if len(zb) != n or len(r) and (
            r[:, 0].min() < 0 or r[:, 0].max() >= n or r[:, 2:].min() < 0
            or (r[:, 2] + r[:, 3]).max() > len(data)):
        return None
    ht = bool(table.ht.any())
    g = r[:, 0]
    if ht and len(g) and np.bincount(g, minlength=n).max() > 1:
        return None
    if not ht:
        r = r[np.argsort(g, kind="stable")]
        g, rp, ro, rl = r.T
        if (rp.min(initial=0) < 0
                or (ro[1:] != ro[:-1] + rl[:-1])[g[1:] == g[:-1]].any()):
            return None
    nb = table.mb - zb
    live = np.flatnonzero(
        (np.bincount(g, weights=r[:, 1], minlength=n) > 0) & table.coded)
    dev = np.zeros(n, bool)
    dev[live] = on_card(table.ht[live], table.h[live], table.w[live],
                        table.style[live], nb[live], decode=True)
    host = live[~dev[live]]
    if ht:
        rd = r[dev[g]]
        blk = table.blk[rd[:, 0]]
        ht_encode.check_shapes(blk[:, 3], blk[:, 4])
        desc = np.empty((len(rd), 8), np.int64)
        desc[:, 2:4] = blk[:, 3:5]
        desc[:, 4:6] = rd[:, 2:4]
        t = HTDecodeTile(data, desc, bands, blk, [])
    else:
        idx = np.flatnonzero(dev)
        pos = np.cumsum(dev) - 1
        rd = dev[g]
        desc, segs, pmap = mq_decode.flat_layout(
            nb[idx], (table.style[idx] == CblkStyle.LAZY).astype(np.int64),
            table.h[idx], table.w[idx], pos[g[rd]], rp[rd], rl[rd])
        desc[:, 4] = table.orient[idx]
        desc[:, 7] = ro[np.searchsorted(g, idx)]
        t = MQDecodeTile(data, desc, segs, pmap, bands, table.blk[idx], [])
    got = _addresses(table, bands, np.unique(t.blk[:, 0]).tolist(), t.blk,
                     device)
    if got is None:
        return None
    t.desc[:, 0], t.desc[:, 1] = got
    return t, host
