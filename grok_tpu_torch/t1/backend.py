"""Tier-1 backend dispatch: python reference / native C++ / device.

Parity: T1Interface / T1Factory (SURVEY.md §2.1 "Tier-1 interface").  The
reference dispatches per codeblock between MQ and HT coders; we additionally
dispatch between implementations:

- "python": the reference implementation in t1/coder.py (MQ) and t1/ht.py
  (HT), always available, the correctness oracle
- "native": C++ batch coder (native/t1.cc via ctypes), threads across
  codeblocks — the production host path; "auto" resolves to it
- "device": the codeblocks grok_tpu's device routers take code on the
  torch device the tile processor passes in (the CUDA kernels on a card,
  their plain twins on the CPU): HT blocks through the HT cleanup coders
  (ops/ht_encode.py, ops/ht_decode.py), MQ blocks through the MQ coders
  (ops/mq_encode.py, ops/mq_decode.py); `on_card` is the one rule that
  decides which blocks those are.  The rest code on the native coder.

Batch API: lists of codeblock jobs so the native backend can parallelize
freely (SURVEY.md §2.3 "codeblock-batch axis").  Under backend="device" a
tile whose codeblocks are all HT, or all MQ, may come instead as one flat
batch (HTEncodeTile, HTDecodeTile, MQEncodeTile, MQDecodeTile, built by
t1/tile_batch.py): per-block numpy arrays over the tile's band tensors,
and job objects only for the few blocks the native coder takes.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

from ..params import CblkStyle
from . import coder as pycoder


class LazyPasses:
    """Sequence of PassInfo materialized on demand from the native
    coder's pooled (rates, dists, terms) arrays.

    Building ~25 PassInfo objects per codeblock was ~15% of rate-targeted
    encode wall time; the hot consumers (hulls, Tier-2 statics) read the
    arrays directly and never materialize."""

    __slots__ = ("rates", "dists", "terms", "numbps", "_mat")

    def __init__(self, rates, dists, terms, numbps):
        self.rates = rates
        self.dists = dists
        self.terms = terms
        self.numbps = numbps
        self._mat = None

    def _list(self):
        if self._mat is None:
            from .coder import PassInfo

            out = []
            passno = 0
            n = len(self.rates)
            for bpno in range(self.numbps - 1, -1, -1):
                for ptype in ((2,) if bpno == self.numbps - 1 else (0, 1, 2)):
                    if passno >= n:
                        break
                    out.append(PassInfo(ptype, bpno,
                                        bool(self.terms[passno]),
                                        int(self.rates[passno]),
                                        float(self.dists[passno])))
                    passno += 1
            self._mat = out
        return self._mat

    def __len__(self):
        return len(self.rates)

    def __bool__(self):
        return len(self.rates) > 0

    def __getitem__(self, k):
        return self._list()[k]

    def __iter__(self):
        return iter(self._list())


# codeblocks coded through encode_batch / decode_batch under
# backend="device", by direction and coder: "encode_device" and friends
# count HT blocks, "mq_encode_device" and friends MQ blocks; "device" is
# the kernels (or their twins on the CPU), "host" the native or Python
# coder; "e0_host" counts device-coded HT blocks whose distortion e0 was
# summed on the host (sum of squares above 2^53, see _e0);
# "ht_encode_flat" and "ht_decode_flat" count the HT blocks of
# "encode_device" and "decode_device" that came in a flat tile batch;
# "mq_encode_passes" and "mq_decode_passes" sum the coding passes of the
# "mq_encode_device" and "mq_decode_device" blocks (their chain lengths);
# "mq_encode_flat" and "mq_decode_flat" count the MQ blocks of
# "mq_encode_device" and "mq_decode_device" that came in a flat tile batch,
# "mq_encode_flat_dist" those of "mq_encode_flat" whose batch tracked
# distortions
DEVICE_CODEBLOCKS: dict[str, int] = dict.fromkeys(
    ("encode_device", "encode_host", "decode_device", "decode_host",
     "mq_encode_device", "mq_encode_host", "mq_decode_device",
     "mq_decode_host", "e0_host", "ht_encode_flat", "ht_decode_flat",
     "mq_encode_passes", "mq_decode_passes", "mq_encode_flat",
     "mq_decode_flat", "mq_encode_flat_dist"), 0)


@dataclass
class EncodeJob:
    coeffs: np.ndarray        # numpy, or a torch view into a band tensor
    orient: int
    style: CblkStyle
    ht: bool = False          # Part 15 HT block coder instead of MQ
    need_dist: bool = True    # PCRD distortion tracking required
    numbps_bound: int = 32  # static magnitude-bitcount bound (band M_b)
    # deferred quantization: > 0 means coeffs is a float32 band view and
    # the backend applies floor(|v|/delta) during ingest (the native
    # coder fuses it; other backends materialize via _materialize_quant)
    quant_delta: float = 0.0
    # max-shift ROI upshift applied to magnitudes during ingest
    roi_shift: int = 0
    # > 0: stop after the first pass whose cumulative rate reaches this
    # many bytes (rate-quota PCRD; see TileCompressor.run_t1)
    rate_cap: int = 0
    # results
    data: bytes = b""
    numbps: int = 0
    passes: list = field(default_factory=list)
    # native backend: e0 measured during coefficient ingest (sum m^2);
    # None on backends that don't provide it
    e0_out: float | None = None


def _materialize_quant(j: EncodeJob) -> None:
    """Apply deferred quantization/ROI for backends without fused ingest."""
    if j.quant_delta > 0.0:
        from ..transform.quant import quantize

        j.coeffs = quantize(np.asarray(j.coeffs), j.quant_delta)
        j.quant_delta = 0.0
    if j.roi_shift:
        j.coeffs = (np.asarray(j.coeffs).astype(np.int64)
                    << j.roi_shift).astype(np.int32)
        j.roi_shift = 0


@dataclass
class DecodeJob:
    data: bytes
    seg_lengths: list[int]
    num_passes: int
    numbps: int
    h: int
    w: int
    orient: int
    style: CblkStyle
    ht: bool = False
    out: np.ndarray | None = None  # doubled-domain signed int32
    # optional pre-zeroed (h, w) int32 view into the destination band
    # array: native backends write it directly (no paste copy) and set
    # direct_done; other backends ignore it and fill `out` as usual
    out_dest: np.ndarray | None = None
    direct_done: bool = False
    # optional (h, w) int32 torch view into a device band tensor: the
    # device HT decoder writes the block there and sets device_done
    out_device: torch.Tensor | None = None
    device_done: bool = False


@dataclass
class _EncodeTile:
    """A tile's codeblocks of one coder for the device encoder as flat
    arrays.  `bands`: int32 band tensors on the device, by band id; `blk`
    (n, 5) int64: a device block's band id, row and column in its band, h
    and w; `desc`: the encoder's descriptor rows for them; `host`: jobs for
    the blocks the native coder takes.  encode_batch sets `data`, every
    codeword or segment in one uint8 array (the device blocks' first, then
    the host jobs'), and `offs`, `lens`, `numbps`, one entry a block in
    that order."""
    bands: list
    blk: np.ndarray
    desc: np.ndarray
    host: list
    data: np.ndarray | None = None
    offs: np.ndarray | None = None
    lens: np.ndarray | None = None
    numbps: np.ndarray | None = None


@dataclass
class HTEncodeTile(_EncodeTile):
    """HT blocks: `desc` grk_ht_encode's rows (address, row stride, h,
    w)."""


@dataclass
class MQEncodeTile(_EncodeTile):
    """MQ blocks: `desc` grk_mq_encode's rows (ops/mq_encode.py DESC:
    address, row stride, h, w, orient, lazy flag, need_dist, slot offset
    and size), distortions tracked where `need_dist` (the host jobs' flag
    too).  encode_batch also sets `rates` (n, stride) int32, each block's
    cumulative pass rates, in the same order, and with need_dist `dists`
    (n, stride) float64, their raw cumulative distortions, and `e0` (n,)
    float64, each block's sum of squared magnitudes."""
    need_dist: bool = False
    rates: np.ndarray | None = None
    dists: np.ndarray | None = None
    e0: np.ndarray | None = None


@dataclass
class HTDecodeTile:
    """A tile's HT codeblocks for the device decoder as flat arrays.
    `data`: the bytes the segments lie in (the tile's stream); `desc` (n, 8)
    int64: the first six DESC columns of ops/ht_decode.py for the device
    blocks (output address and row stride in a device band, h, w, segment
    offset in `data` and length); `bands`, `blk` as _EncodeTile's for
    those outputs; `host`: jobs for the blocks the native coder takes,
    decoded into host band arrays."""
    data: object
    desc: np.ndarray
    bands: list
    blk: np.ndarray
    host: list


@dataclass
class MQDecodeTile:
    """A tile's MQ codeblocks for the device decoder as flat arrays.
    `data`: the tile's stream; `desc` (n, 13) int64: ops/mq_decode.py DESC
    rows for the device blocks, their output addresses in the device bands
    and their bytes' offsets in `data` filled; `segs`, `pmap`: the segment
    rows and the pass map table desc points into (flat_layout); `bands`,
    `blk` as _EncodeTile's for the outputs; `host`: jobs for the blocks
    the native coder takes, decoded into host band arrays."""
    data: object
    desc: np.ndarray
    segs: np.ndarray
    pmap: np.ndarray
    bands: list
    blk: np.ndarray
    host: list


def _views(bands, blk) -> list[torch.Tensor]:
    """The blocks of a flat batch as views of its band tensors."""
    return [bands[b][y:y + h, x:x + w] for b, y, x, h, w in blk.tolist()]


def _encode_python(jobs: list[EncodeJob], num_threads: int = 0) -> None:
    for j in jobs:
        j.data, j.numbps, j.passes = pycoder.encode_cblk(
            j.coeffs, j.orient, j.style, rate_cap=j.rate_cap)


def _decode_python(jobs: list[DecodeJob], num_threads: int = 0) -> None:
    for j in jobs:
        j.out = pycoder.decode_cblk(
            j.data, j.seg_lengths, j.num_passes, j.numbps,
            j.h, j.w, j.orient, j.style)


_BACKENDS = {"python": (_encode_python, _decode_python)}
_HT_NATIVE = None  # (encode_fn, decode_fn) once native lib registers


def register_backend(name: str, encode_fn, decode_fn) -> None:
    _BACKENDS[name] = (encode_fn, decode_fn)


def register_ht_backend(encode_fn, decode_fn) -> None:
    global _HT_NATIVE
    _HT_NATIVE = (encode_fn, decode_fn)


def _load_native() -> bool:
    if "native" not in _BACKENDS:
        # registers itself; a failed build raises with g++'s output
        from . import native  # noqa: F401
    return "native" in _BACKENDS


def resolve(backend: str = "device") -> str:
    # the host coder of a backend: "device" codes its MQ and ragged HT
    # blocks on the native coder (SURVEY.md §7 device/host split)
    if backend in ("auto", "native", "device") and _load_native():
        return "native"
    return "python"


def _encode_ht(jobs: list[EncodeJob]) -> None:
    from ..t1.coder import PassInfo
    from . import ht

    for j in jobs:
        j.data, j.numbps = ht.encode_cblk_ht(j.coeffs)
        if j.numbps == 0:
            j.passes = []
        else:
            # HTONLY: one cleanup pass carrying everything
            e0 = float((np.abs(j.coeffs).astype(np.float64) ** 2).sum())
            j.passes = [PassInfo(2, j.numbps - 1, True, len(j.data), e0)]


def _decode_ht(jobs: list[DecodeJob]) -> None:
    from . import ht

    for j in jobs:
        j.out = ht.decode_cblk_ht(j.data, j.h, j.w)


# grok_tpu's decode router sends an MQ shape group to its device only from
# this many blocks (there, to pay for a jit compile a shape); kept so the
# same blocks decode on the card, corrupt streams included
MQ_DECODE_MIN_GROUP = 8


def on_card(ht, h, w, style, numbps, decode: bool = False,
            need_dist=False) -> np.ndarray:
    """The placement rule: which codeblocks of one call code on the
    device, the ones grok_tpu's device routers take; the rest code on the
    native coder.  Per block (arrays, or one value for all): HT or MQ, h,
    w, style and numbps (on encode the band's bound M_b, on decode the
    block's own), and on encode need_dist.
    - HT: even h and w and, on encode, numbps <= ops/ht_encode.py
      MAX_NUMBPS_DEVICE (25).
    - MQ: style NONE or LAZY and 0 <= numbps <= ops/mq_tables.py
      MAX_NUMBPS_DEVICE (26), or MAX_NUMBPS_DIST (20) with need_dist; on
      decode only in shape groups of MQ_DECODE_MIN_GROUP or more such
      blocks in the call.
    Returns one bool a block."""
    from ..ops.ht_encode import MAX_NUMBPS_DEVICE as HT_MAX
    from ..ops.mq_tables import MAX_NUMBPS_DEVICE, MAX_NUMBPS_DIST

    ht, h, w, style, numbps = np.broadcast_arrays(
        *(np.asarray(v, np.int64) for v in (ht, h, w, style, numbps)))
    ht = ht.astype(bool)
    even = (h % 2 == 0) & (w % 2 == 0)
    mq = ~ht & ((style == CblkStyle.NONE) | (style == CblkStyle.LAZY)) \
        & (numbps >= 0) & (numbps <= np.where(need_dist, MAX_NUMBPS_DIST,
                                              MAX_NUMBPS_DEVICE))
    if not decode:
        return np.where(ht, even & (numbps <= HT_MAX), mq)
    idx = np.flatnonzero(mq)
    _, grp, cnt = np.unique(h[idx] * 8192 + w[idx], return_inverse=True,
                            return_counts=True)
    mq[idx] = cnt[grp] >= MQ_DECODE_MIN_GROUP
    return np.where(ht, even, mq)


def _placed(jobs: list, decode: bool = False) -> tuple[list, list]:
    """on_card over a job list: (the jobs it places on the device, the
    rest), each in job order."""
    if decode:
        f = [(j.ht, j.h, j.w, int(j.style), j.numbps, False) for j in jobs]
    else:
        f = [(j.ht, *j.coeffs.shape, int(j.style), j.numbps_bound,
              j.need_dist) for j in jobs]
    a = np.array(f, np.int64).reshape(-1, 6).T
    card = on_card(*a[:5], decode=decode, need_dist=a[5] != 0).tolist()
    return ([j for j, c in zip(jobs, card) if c],
            [j for j, c in zip(jobs, card) if not c])


def _on_device(arrs, device: torch.device) -> list[torch.Tensor]:
    """The codeblocks as int32 tensors on `device`: torch views stay where
    they are (bands already on the device are read in place); numpy blocks
    go up stacked, one copy a shape."""
    out: list = [None] * len(arrs)
    host: dict = defaultdict(list)
    for i, a in enumerate(arrs):
        if isinstance(a, torch.Tensor):
            out[i] = a.to(device)
        else:
            host[a.shape].append(i)
    for idx in host.values():
        stack = torch.from_numpy(np.ascontiguousarray(np.stack(
            [np.asarray(arrs[i], dtype=np.int32) for i in idx]))).to(device)
        for i, t in zip(idx, stack):
            out[i] = t
    return out


_EXACT_F64 = 1 << 53


def _e0(j: EncodeJob, sumsq: int) -> float:
    """A block's distortion e0 as grok_tpu computes it (numpy float64 sum of
    squared magnitudes).  Below 2^53 every partial sum is exact, so the
    kernel's exact integer sum rounded once equals it; above, numpy's
    pairwise order may round otherwise, and the block is summed here."""
    if sumsq <= _EXACT_F64:
        return float(sumsq)
    DEVICE_CODEBLOCKS["e0_host"] += 1
    c = j.coeffs
    c = c.cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c)
    return float((np.abs(c).astype(np.float64) ** 2).sum())


def _encode_ht_device(jobs: list[EncodeJob],
                      device: torch.device) -> list[EncodeJob]:
    """Code the HT jobs on_card places on the device in one call of the
    cleanup encoder (mixed shapes together); returns the jobs left for the
    host coder."""
    from ..ops import ht_encode as dht
    from ..t1.coder import PassInfo

    dev, rest = _placed(jobs)
    if dev:
        segs, sumsq = dht.encode_cblks_ht(
            _on_device([j.coeffs for j in dev], device))
        for j, (seg, nb), ss in zip(dev, segs, sumsq):
            j.data, j.numbps = seg, nb
            j.e0_out = _e0(j, ss) if nb else 0.0
            j.passes = ([PassInfo(2, nb - 1, True, len(seg), j.e0_out)]
                        if nb else [])
    DEVICE_CODEBLOCKS["encode_device"] += len(dev)
    return rest


def _decode_ht_device(jobs: list[DecodeJob],
                      device: torch.device) -> list[DecodeJob]:
    """Decode the HT jobs on_card places on the device in one call of the
    cleanup decoder (mixed shapes together: one batch, as grok_tpu's router
    makes, which corrupt streams depend on).  A job with `out_device` is
    written there; the others come back to the host in one copy.  Returns
    the jobs left for the host decoder."""
    from ..ops import ht_decode as dht

    dev, rest = _placed(jobs, decode=True)
    if dev:
        _decode_into(dev, device, dht.decode_cblks_ht,
                     [(j.data, j.h, j.w) for j in dev])
    DEVICE_CODEBLOCKS["decode_device"] += len(dev)
    return rest


def _encode_mq_device(jobs: list[EncodeJob],
                      device: torch.device) -> list[EncodeJob]:
    """Code the MQ jobs on_card places on the device in one call of the MQ
    encoder (mixed shapes and styles together); returns the jobs left for
    the host coder."""
    from ..ops import mq_encode as dmq

    dev, rest = _placed(jobs)
    passes = 0
    if dev:
        res = dmq.encode_cblks_mq(
            _on_device([j.coeffs for j in dev], device),
            [j.orient for j in dev],
            [CblkStyle(int(j.style)) == CblkStyle.LAZY for j in dev],
            [j.need_dist for j in dev],
            numbps_bound=[j.numbps_bound for j in dev])
        for k, j in enumerate(dev):
            nb = int(res.numbps[k])
            n = res.num_passes(k)
            passes += n
            j.data, j.numbps = res.data[k], nb
            j.passes = LazyPasses(res.rates[k, :n], res.dists[k, :n],
                                  res.terms[k, :n], nb)
            j.e0_out = float(res.e0[k]) if j.need_dist else None
    DEVICE_CODEBLOCKS["mq_encode_device"] += len(dev)
    DEVICE_CODEBLOCKS["mq_encode_passes"] += passes
    return rest


def _decode_mq_device(jobs: list[DecodeJob],
                      device: torch.device) -> list[DecodeJob]:
    """Decode the MQ jobs on_card places on the device in one call of the
    MQ decoder, mixed shapes together.  A job with `out_device` is written
    there; the others come back to the host in one copy.  Returns the jobs
    left for the host decoder."""
    from ..ops import mq_decode as dmqd

    dev, rest = _placed(jobs, decode=True)
    if dev:
        _decode_into(dev, device, dmqd.decode_cblks_mq,
                     [(j.data, j.seg_lengths, j.num_passes, j.numbps, j.h,
                       j.w, j.orient, j.style) for j in dev])
    DEVICE_CODEBLOCKS["mq_decode_device"] += len(dev)
    DEVICE_CODEBLOCKS["mq_decode_passes"] += sum(j.num_passes for j in dev)
    return rest


def _decode_into(dev, device, decode, items) -> None:
    """Run `decode(items, device, outs)`: a job with `out_device` is
    written there, the others into one flat tensor that comes back to the
    host in one copy."""
    back = [j for j in dev if j.out_device is None]
    flat = torch.empty(sum(j.h * j.w for j in back), dtype=torch.int32,
                       device=device)
    outs, k = [], 0
    for j in dev:
        if j.out_device is None:
            outs.append(flat[k:k + j.h * j.w].view(j.h, j.w))
            k += j.h * j.w
        else:
            outs.append(j.out_device)
    decode(items, device, outs)
    host = flat.cpu().numpy()
    k = 0
    for j in dev:
        if j.out_device is None:
            j.out = host[k:k + j.h * j.w].reshape(j.h, j.w)
            k += j.h * j.w
        else:
            j.device_done = True


def _need_device(device) -> torch.device:
    if device is None:
        raise ValueError("backend='device' needs the torch device to code "
                         "on")
    return torch.device(device)


def _kernel_route(device: torch.device) -> bool:
    """A flat tile batch runs the kernels on CUDA and the twins on the
    CPU; other devices raise."""
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel route for device {device}")
    return device.type == "cuda"


def _encode_ht_tile(t: HTEncodeTile, backend: str, num_threads: int,
                    device: torch.device) -> None:
    """A flat tile batch: one launch of the cleanup encoder (the twin on
    the CPU) for the device blocks, the native coder for the host jobs
    while the card works, and one result array for both."""
    from ..ops import ht_encode as dht

    n = len(t.blk)
    args = None
    if n and _kernel_route(device):
        args = dht.desc_args(t.desc, device)
        dht.launch_encode(args, device)
    _encode_ht_host(t.host, backend, num_threads)
    lens_h = np.fromiter((len(j.data) for j in t.host), np.int64,
                         len(t.host))
    extra = int(lens_h.sum())
    if args is not None:
        data, meta = dht.finish_encode_flat(args, extra)
    elif n:
        data, meta = dht.encode_plain_flat(_views(t.bands, t.blk), extra)
    else:
        data, meta = np.empty(extra, np.uint8), np.zeros((0, 5), np.int64)
    _join_host(t, data, meta, extra, lens_h)
    DEVICE_CODEBLOCKS["encode_device"] += n
    DEVICE_CODEBLOCKS["ht_encode_flat"] += n
    DEVICE_CODEBLOCKS["encode_host"] += len(t.host)


def _decode_ht_tile(t: HTDecodeTile, backend: str, num_threads: int,
                    device: torch.device) -> None:
    """A flat tile batch: the three decode launches (the twin on the CPU)
    for the device blocks, writing their device bands, and the native
    coder for the host jobs."""
    from ..ops import ht_decode as dht

    n = len(t.desc)
    if n and _kernel_route(device):
        dht.launch_decode(dht.flat_args(t.data, t.desc, device), device)
    elif n:
        mv = memoryview(t.data)
        items = [(mv[o:o + ln], h, w) for h, w, o, ln in
                 t.desc[:, 2:6].tolist()]
        dht.decode_cblks_ht_plain(items, device, _views(t.bands, t.blk))
    DEVICE_CODEBLOCKS["decode_device"] += n
    DEVICE_CODEBLOCKS["ht_decode_flat"] += n
    DEVICE_CODEBLOCKS["decode_host"] += len(t.host)
    _decode_ht_host(t.host, backend, num_threads)


def _join_host(t: _EncodeTile, data: np.ndarray, meta: np.ndarray,
               extra: int, lens_h: np.ndarray) -> None:
    """A flat encode's results: the host jobs' bytes into the `extra`
    bytes after the device blocks', and `data`, `offs`, `lens`, `numbps`
    set on the batch, the device blocks first."""
    used = len(data) - extra
    offs_h = used + np.cumsum(lens_h) - lens_h
    for j, o in zip(t.host, offs_h.tolist()):
        data[o:o + len(j.data)] = np.frombuffer(j.data, np.uint8)
    t.data = data
    t.offs = np.concatenate([meta[:, 0], offs_h])
    t.lens = np.concatenate([meta[:, 1], lens_h])
    t.numbps = np.concatenate([meta[:, 2], np.fromiter(
        (j.numbps for j in t.host), np.int64, len(t.host))])


def _encode_mq_tile(t: MQEncodeTile, backend: str, num_threads: int,
                    device: torch.device) -> None:
    """A flat MQ tile batch: one launch of the MQ encoder (the twin on
    the CPU) for the device blocks, the native coder for the host jobs
    while the card works, then one result array for both and the pass
    rates of every block (with need_dist their distortions and e0 too,
    in the same small copy)."""
    from ..ops import mq_encode as dmq

    n = len(t.blk)
    args = None
    if n and _kernel_route(device):
        args = dmq.desc_args(t.desc, device)
        dmq.launch_encode(args, device)
    if t.host:
        _BACKENDS[resolve(backend)][0](t.host, num_threads)
    lens_h = np.fromiter((len(j.data) for j in t.host), np.int64,
                         len(t.host))
    extra = int(lens_h.sum())
    if args is not None:
        data, meta, rates, dists = dmq.finish_encode_flat(args, extra,
                                                          t.need_dist)
    elif n:
        data, meta, rates, dists = dmq.encode_plain_flat(
            _views(t.bands, t.blk), t.desc[:, 4], t.desc[:, 5], extra,
            t.need_dist)
    else:
        data, meta = np.empty(extra, np.uint8), np.zeros((0, 6), np.int64)
        rates = np.zeros((0, dmq.MAX_PASSES), np.int32)
        dists = np.zeros((0, dmq.MAX_PASSES)) if t.need_dist else None
    _join_host(t, data, meta, extra, lens_h)
    t.rates = _rows(rates, [j.passes.rates for j in t.host], np.int32)
    if t.need_dist:  # the native coder's distortions and e0
        t.dists = _rows(dists, [j.passes.dists for j in t.host], np.float64)
        t.e0 = np.concatenate([meta[:, 4].astype(np.float64), np.fromiter(
            (j.e0_out for j in t.host), np.float64, len(t.host))])
        DEVICE_CODEBLOCKS["mq_encode_flat_dist"] += n
    nb = meta[:, 2]
    DEVICE_CODEBLOCKS["mq_encode_device"] += n
    DEVICE_CODEBLOCKS["mq_encode_flat"] += n
    DEVICE_CODEBLOCKS["mq_encode_passes"] += int(
        np.where(nb > 0, 3 * nb - 2, 0).sum())
    DEVICE_CODEBLOCKS["mq_encode_host"] += len(t.host)


def _rows(dev: np.ndarray, host: list, dtype) -> np.ndarray:
    """The device blocks' per-pass rows, then one row a host job, in one
    zero-padded matrix as wide as the widest."""
    out = np.zeros((len(dev) + len(host),
                    max([dev.shape[1]] + [len(r) for r in host])), dtype)
    out[:len(dev), :dev.shape[1]] = dev
    for k, r in enumerate(host):
        out[len(dev) + k, :len(r)] = r
    return out


def _decode_mq_tile(t: MQDecodeTile, backend: str, num_threads: int,
                    device: torch.device) -> None:
    """A flat MQ tile batch: one launch of the MQ decoder (the twin on
    the CPU) for the device blocks, writing their device bands, and the
    native coder for the host jobs."""
    from ..ops import mq_decode as dmqd

    n = len(t.desc)
    if n and _kernel_route(device):
        dmqd.launch_decode(dmqd.flat_args(t.data, t.desc, t.segs, t.pmap,
                                          device), device)
    elif n:
        dmqd.decode_flat_plain(
            (t.desc, np.frombuffer(t.data, np.uint8), t.segs, t.pmap),
            device, _views(t.bands, t.blk))
    DEVICE_CODEBLOCKS["mq_decode_device"] += n
    DEVICE_CODEBLOCKS["mq_decode_flat"] += n
    DEVICE_CODEBLOCKS["mq_decode_passes"] += int(t.desc[:, 6].sum())
    DEVICE_CODEBLOCKS["mq_decode_host"] += len(t.host)
    if t.host:
        _BACKENDS[resolve(backend)][1](t.host, num_threads)


def _encode_ht_host(jobs: list[EncodeJob], backend: str,
                    num_threads: int) -> None:
    """HT jobs on the host coder: native where it loaded, else Python."""
    if not jobs:
        return
    for j in jobs:  # native HT ingest has no fused quantizer
        _materialize_quant(j)
    if resolve(backend) == "native" and _HT_NATIVE is not None and \
            backend != "python":
        _HT_NATIVE[0](jobs, num_threads)
    else:
        _encode_ht(jobs)


def _decode_ht_host(jobs: list[DecodeJob], backend: str,
                    num_threads: int) -> None:
    if not jobs:
        return
    if resolve(backend) == "native" and _HT_NATIVE is not None and \
            backend != "python":
        _HT_NATIVE[1](jobs, num_threads)
    else:
        _decode_ht(jobs)


def encode_batch(jobs: list[EncodeJob] | HTEncodeTile | MQEncodeTile,
                 backend: str = "device", num_threads: int = 0,
                 device=None) -> None:
    """num_threads sizes the native thread pool (-H parity; 0 = all
    cores).  Output is byte-identical for any thread count — jobs are
    independent and land in per-job buffers (the reference's determinism
    invariant, SURVEY.md §4).  `device` is where backend="device" codes
    its device-eligible blocks; a flat tile batch is coded there too."""
    if isinstance(jobs, HTEncodeTile):
        _encode_ht_tile(jobs, backend, num_threads, _need_device(device))
        return
    if isinstance(jobs, MQEncodeTile):
        _encode_mq_tile(jobs, backend, num_threads, _need_device(device))
        return
    ht_jobs = [j for j in jobs if j.ht]
    mq_jobs = [j for j in jobs if not j.ht]
    if mq_jobs and backend == "device":
        for j in mq_jobs:
            _materialize_quant(j)
        mq_jobs = _encode_mq_device(mq_jobs, _need_device(device))
    if ht_jobs and backend == "device":
        for j in ht_jobs:
            _materialize_quant(j)
        ht_jobs = _encode_ht_device(ht_jobs, _need_device(device))
    if backend == "device":
        DEVICE_CODEBLOCKS["encode_host"] += len(ht_jobs)
        DEVICE_CODEBLOCKS["mq_encode_host"] += len(mq_jobs)
    _encode_ht_host(ht_jobs, backend, num_threads)
    if mq_jobs:
        name = resolve(backend)
        if name != "native":  # the native MQ coder fuses quant/ROI
            for j in mq_jobs:
                _materialize_quant(j)
        _BACKENDS[name][0](mq_jobs, num_threads)


def decode_batch(jobs: list[DecodeJob] | HTDecodeTile | MQDecodeTile,
                 backend: str = "device", num_threads: int = 0,
                 device=None) -> None:
    if isinstance(jobs, HTDecodeTile):
        _decode_ht_tile(jobs, backend, num_threads, _need_device(device))
        return
    if isinstance(jobs, MQDecodeTile):
        _decode_mq_tile(jobs, backend, num_threads, _need_device(device))
        return
    ht_jobs = [j for j in jobs if j.ht]
    mq_jobs = [j for j in jobs if not j.ht]
    if mq_jobs and backend == "device":
        mq_jobs = _decode_mq_device(mq_jobs, _need_device(device))
    if ht_jobs and backend == "device":
        ht_jobs = _decode_ht_device(ht_jobs, _need_device(device))
    if backend == "device":
        DEVICE_CODEBLOCKS["decode_host"] += len(ht_jobs)
        DEVICE_CODEBLOCKS["mq_decode_host"] += len(mq_jobs)
    _decode_ht_host(ht_jobs, backend, num_threads)
    if mq_jobs:
        name = resolve(backend)
        _BACKENDS[name][1](mq_jobs, num_threads)
