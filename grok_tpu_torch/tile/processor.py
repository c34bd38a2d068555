"""Tile compression / decompression orchestration.

Parity: TileProcessor (SURVEY.md §2.1 "TileProcessor",
src/lib/core/tile/TileProcessor.cpp [P]) — drives one tile end-to-end in
both directions: DC shift, MCT, DWT, quantization, Tier-1 (batched through
the backend dispatch), PCRD rate allocation and Tier-2 packet assembly on
compress; the mirror image on decompress.

With a `device` set, eligible tiles, reversible 5/3 or irreversible 9/7,
run their sample transforms on it through the port's pipeline
(ops/pipeline.py, one host-to-device copy of the tile stack); the 9/7 path
quantizes there too, and such a tile is marked _device_quantized so that
Tier-1 does not quantize its bands a second time.  Every other tile takes
the numpy host path here and is counted in HOST_PATH_TILES.  Under
backend="device" the codeblocks that grok_tpu's device routers take are
Tier-1 coded on the device too, placed by t1/backend.py on_card; a tile
that may code as one flat batch is built into one by t1/tile_batch.py
from the tile's BlockTable, which the walks here fill.  A tile
with such blocks ("card Tier-1", _card_t1) skips the whole-tile native
Tier-1 calls and keeps its bands on the device: the encoders read their
codeblocks there in place, and a band goes to the host only for the blocks
the native coder codes; on decode the device decoders write their blocks
straight into device band tensors that the synthesis takes, and the native
coder's blocks go up as small copies.  A deferred synthesis (the strip
decode) comes back as DeferredPlanes: its copy to pinned host memory is
still in flight behind a CUDA event until materialize().
"""

from __future__ import annotations

import logging
import math
from types import SimpleNamespace

import numpy as np
import torch

from ..ops import pipeline
from ..parallel import mesh as pmesh
from ..params import (
    CblkStyle,
    CodingParams,
    QuantStyle,
    StepSize,
    TileCodingParams,
)
from ..t1 import backend as t1_backend
from ..t1 import tile_batch
from ..t2 import packets as t2
from ..trace import span
from ..transform import dwt as dwt_mod
from ..transform import mct as mct_mod
from ..transform import quant as quant_mod
from .geometry import (
    BAND_GAIN,
    Rect,
    Tile,
    TileComponent,
    build_resolutions,
    tile_comp_rect,
)
from .ratecontrol import (HullIndex, candidate_slopes, convex_hull,
                          convex_hulls_flat, passes_for_threshold)

log = logging.getLogger("grok_tpu_torch")

# tiles whose transforms took the host path, by direction
HOST_PATH_TILES: dict[str, int] = {"encode": 0, "decode": 0}


def host_backend(backend: str) -> str:
    """The Tier-1 backend for a requested codec backend.  "device" stays
    "device": the device transforms and device HT and MQ Tier-1, with the
    native host coder for what stays on the host (the blocks
    t1_backend.on_card leaves there, Tier-2), which must load: where it
    does not, this raises rather than coding those blocks in pure
    Python."""
    if backend == "device" and t1_backend.resolve("native") != "native":
        raise RuntimeError(
            "backend='device' codes the blocks the device coders do not "
            "take and Tier-2 on the native host coder, which did not load")
    return backend


def _card_t1(tcp) -> bool:
    """Whether backend="device" codes blocks of this tile on the device:
    it has HT blocks, or MQ blocks of a style the device MQ coders take."""
    return bool(t1_backend.on_card(
        [t.ht for t in tcp.tccps], 0, 0,
        [int(t.cblk_style) for t in tcp.tccps], 0).any())


# whole-tile encode scratch (arena + rates matrix), grown and reused per
# thread — alive from run_t1 until the same tile's write_packets consumed it
import threading as _threading

_ENC_TL = _threading.local()
_MAX_PASSES = 96  # == t1/native.py MAX_PASSES (3 * 32 pass slots)


class _EncSeq:
    """Flat whole-tile Tier-1 encode results (grk_t1_encode_tile), the
    no-per-codeblock-state feed for _write_packets_seq and the flat PCRD
    path.  Array fields are views into thread-local pooled scratch —
    valid until the next tile encoded on this thread (_write_packets_seq
    clears the reference after emission)."""

    __slots__ = ("arena", "offs", "lens", "numbps", "npasses", "zb",
                 "isht", "rates", "stride", "gmap", "cblks", "ncb",
                 # PCRD feed (need_dist encodes only, else None)
                 "e0", "hull_pass", "hull_slope", "hull_rate", "hull_n",
                 "weights",
                 # layer assignment outputs (set by assign_layers)
                 "npl", "first")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))

# Rate-quota early-stop margin: each codeblock may emit up to this many
# times its area-proportional share of the final byte target before
# Tier-1 stops coding deeper passes (revalidation catches the tail).
QUOTA_FACTOR = 3.0


def band_stepsize_index(resno: int, orient: int) -> int:
    """Index into the QCD/QCC step-size list for band (resno, orient)."""
    return 0 if resno == 0 else 3 * (resno - 1) + orient


def band_eps_mant(tccp, resno: int, orient: int, numres: int):
    """Resolve (expn, mant) for a band under the signaled quant style."""
    if tccp.qnt_style == QuantStyle.SCALAR_DERIVED:
        ss0 = tccp.stepsizes[0]
        nl = numres - 1
        # derived: eps_b = eps_0 - NL + n_b, n_b = decomposition count of band
        nb = nl if resno == 0 else nl - resno + 1
        return ss0.expn - nl + nb, ss0.mant
    if not tccp.stepsizes:
        # corrupt/absent quantization info: fall back to a sane reversible
        # default so tolerant decode can proceed
        return 10, 0
    idx = band_stepsize_index(resno, orient)
    if idx >= len(tccp.stepsizes):
        idx = len(tccp.stepsizes) - 1
    ss = tccp.stepsizes[idx]
    return ss.expn, ss.mant


def build_tile(tile_idx: int, trect: Rect, image, tcp: TileCodingParams) -> Tile:
    tile = Tile(index=tile_idx, rect=trect)
    for compno, comp in enumerate(image.comps):
        tccp = tcp.tccps[compno]
        # tolerate partially-applied (corrupt) COD/COC: precinct lists must
        # cover every resolution
        while len(tccp.prcw) < tccp.numresolutions:
            tccp.prcw.append(15)
        while len(tccp.prch) < tccp.numresolutions:
            tccp.prch.append(15)
        tc_rect = tile_comp_rect(trect, comp.dx, comp.dy)
        tc = TileComponent(compno=compno, rect=tc_rect)
        tc.resolutions = build_resolutions(
            tc_rect, tccp.numresolutions, tccp.prcw, tccp.prch,
            tccp.cblkw, tccp.cblkh)
        tile.comps.append(tc)
    # quantization metadata per band: R_b = prec + gain_b for both the
    # reversible and irreversible paths (verified against the oracle).
    # A max-shift ROI extends M_b by roi_shift on both sides without
    # touching the signaled step sizes.  Shared with the pooled-acquire
    # path so the formula lives in exactly one place.
    _refresh_tile_quant(tile, image, tcp)
    return tile



# ---------------------------------------------------------------------------
# Tile geometry pool: the resolution/precinct/codeblock tree for a given
# (tile rect, coding geometry) is identical across images — video frames,
# strip decodes and bench loops rebuild it constantly.  acquire_tile()
# reuses a fully-reset tree from the pool; release_tile() scrubs all
# per-image state (so no coefficient/byte references linger) and returns
# it.  Quantization metadata (band numbps/stepsize) is refreshed on every
# acquire since it depends on QCD/QCC/ROI, not geometry.
# ---------------------------------------------------------------------------

_TILE_POOL: dict = {}
_TILE_POOL_CAP = 4    # trees kept per geometry key
_TILE_POOL_KEYS = 8   # distinct geometry keys kept (FIFO eviction) —
                      # pooled trees hold native Tier-2 state, so the
                      # pool must not grow with workload variety


def _tile_geo_key(trect: Rect, image, tcp: TileCodingParams):
    return (trect.x0, trect.y0, trect.x1, trect.y1,
            tuple((c.dx, c.dy) for c in image.comps),
            tuple((t.numresolutions,
                   tuple(t.prcw[:t.numresolutions]),
                   tuple(t.prch[:t.numresolutions]),
                   t.cblkw, t.cblkh) for t in tcp.tccps))


def _refresh_tile_quant(tile: Tile, image, tcp: TileCodingParams) -> None:
    for compno, tc in enumerate(tile.comps):
        tccp = tcp.tccps[compno]
        comp = image.comps[compno]
        for res in tc.resolutions:
            for band in res.bands:
                eps, mant = band_eps_mant(tccp, res.resno, band.orient,
                                          tccp.numresolutions)
                ss = StepSize(eps, mant)
                band.numbps = max(0, quant_mod.band_max_bitplanes(
                    ss, tccp.num_guard_bits) + tccp.roi_shift)
                rb = comp.prec + BAND_GAIN[band.orient]
                band.stepsize = quant_mod.decode_stepsize(ss, rb)


_CBLK_KEEP = frozenset(("rect", "idx"))


def _scrub_tile(tile: Tile) -> None:
    """Clear every per-image field so a pooled tree holds no references
    to coefficient arrays or coded bytes, and no stale ad-hoc state
    (e.g. decode_pass_cap from a max_layers decode, is_ht from a MIXED
    stream, hull/e0 caches from rate control)."""
    for tc in tile.comps:
        tc.data = None
        for res in tc.resolutions:
            for prc in res.precincts:
                h = getattr(prc, "_nt2", None)
                if h is not None:
                    h.reset()
                    h.rates = None  # statics are per-image
                for pband in prc.pbands:
                    pband.incl_tree = None
                    pband.imsb_tree = None
                    for cblk in pband.cblks:
                        d = cblk.__dict__
                        # drop EVERYTHING but the immutable geometry —
                        # encoder, decoder and ad-hoc attrs alike
                        for k in [k for k in d if k not in _CBLK_KEEP]:
                            del d[k]
                        cblk.data = b""
                        cblk.numbps = 0
                        cblk.pass_rates = []
                        cblk.pass_dists = []
                        cblk.pass_term = []
                        cblk.num_passes_by_layer = []
                        cblk.layer_start = []
                        cblk.seg_data = []
                        cblk.seg_passes = []
                        cblk.included_in_layer = -1
                        cblk.total_passes = 0
                        cblk.lblock = 3
                        cblk.zero_bitplanes = 0


def acquire_tile(tile_idx: int, trect: Rect, image,
                 tcp: TileCodingParams) -> Tile:
    """build_tile() through the geometry pool (scrubbed + quant-refreshed
    on reuse).  Pair with release_tile() when the tile's work is done."""
    key = _tile_geo_key(trect, image, tcp)
    pool = _TILE_POOL.get(key)
    if pool:
        tile = pool.pop()
        tile.index = tile_idx
        _refresh_tile_quant(tile, image, tcp)
        tile._geo_key = key
        return tile
    tile = build_tile(tile_idx, trect, image, tcp)
    tile._geo_key = key
    return tile


def release_tile(tile: Tile) -> None:
    key = getattr(tile, "_geo_key", None)
    if key is None:
        return
    pool = _TILE_POOL.get(key)
    if pool is None:
        while len(_TILE_POOL) >= _TILE_POOL_KEYS:
            _TILE_POOL.pop(next(iter(_TILE_POOL)))  # FIFO oldest key
        pool = _TILE_POOL[key] = []
    if len(pool) < _TILE_POOL_CAP:
        _scrub_tile(tile)
        pool.append(tile)
    tile._geo_key = None  # double-release is a no-op


def _device_eligible(t, decode: bool = False) -> bool:
    """Whether the device pipeline takes the tile of TileCompressor or
    TileDecompressor `t`: grid-aligned, unsubsampled, uniform tiles, and
    on decode with no reduce, window or ROI; everything else uses the
    host numpy path."""
    tile, tcp, image = t.tile, t.tcp, t.image
    if decode and (t.reduce or t.window is not None):
        return False
    t0 = tcp.tccps[0]
    nl = t0.numresolutions - 1
    align = 1 << nl
    for compno, tc in enumerate(tile.comps):
        comp = image.comps[compno]
        tccp = tcp.tccps[compno]
        if comp.dx != 1 or comp.dy != 1:
            return False
        if (tccp.numresolutions != t0.numresolutions
                or tccp.qmfbid != t0.qmfbid
                or comp.prec != image.comps[0].prec
                or comp.sgnd != image.comps[0].sgnd
                or (decode and tccp.roi_shift)):
            return False
        if tc.rect.x0 % align or tc.rect.y0 % align:
            return False
        if tc.rect != tile.comps[0].rect:
            return False
    return tcp.mct in (0, 1) and _uniform_quant(tcp)


def _uniform_quant(tcp) -> bool:
    """Device pipelines apply ONE (resno, orient) -> stepsize table to the
    whole component stack, so per-component quantization (QCC) must fall
    back to the host path."""
    t0 = tcp.tccps[0]
    for tccp in tcp.tccps[1:]:
        if (tccp.qnt_style != t0.qnt_style
                or tccp.num_guard_bits != t0.num_guard_bits
                or [(ss.expn, ss.mant) for ss in tccp.stepsizes]
                != [(ss.expn, ss.mant) for ss in t0.stepsizes]):
            return False
    return True


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------

class TileCompressor:
    """`device` (a torch.device, or None for the host path) is where the
    transforms of eligible tiles run, and `mesh` (a parallel.mesh.Mesh or
    None) the devices they shard over when its sp axis takes the tile;
    `backend` is the Tier-1 backend (see host_backend)."""

    def __init__(self, tile: Tile, tcp: TileCodingParams, image,
                 cp: CodingParams, device: torch.device | None,
                 backend: str = "native", mct_norms_arr=None,
                 num_threads: int = 0, mesh=None):
        self.device = device
        self.mesh = mesh
        self.tile = tile
        self.tcp = tcp
        self.image = image
        self.cp = cp
        self.backend = backend
        self.mct_norms = mct_norms_arr
        self.num_threads = num_threads  # -H parity: native pool size

    def release(self) -> None:
        """The tile back to the geometry pool, scrubbed, and this
        compressor's Tier-1 state dropped: on a card Tier-1 tile its jobs
        hold views of the batched device bands, which must not outlive
        the tile row."""
        for c in self.tile.comps:
            c.data = None  # a full pool keeps the tile unscrubbed
        release_tile(self.tile)
        self._t1_jobs = None
        self._enc_seq = None

    # ---- stage 1: sample pipeline (DC shift + MCT + DWT + quant + T1) ----

    def run_transforms(self) -> None:
        if getattr(self, "_transforms_done", False):
            return  # already produced by the batched call
        if self.device is not None and _device_eligible(self):
            mesh = self.mesh
            if mesh is not None and (pmesh.sp_size(mesh) == 1
                                     or not _sp_fits(mesh, [self])):
                mesh = None  # a lone tile shards over sp only
            _analyse([self], mesh)
            return
        HOST_PATH_TILES["encode"] += 1
        self._transforms_done = True
        self._device_quantized = False
        tile, tcp, image = self.tile, self.tcp, self.image
        reversible = tcp.tccps[0].qmfbid == 1
        raw = []
        for compno, tc in enumerate(tile.comps):
            comp = image.comps[compno]
            # extract tile-component samples from the component plane
            # (_data_y0: strip-mode encodes hold only a tile row of it)
            r = tc.rect
            y0 = r.y0 - comp.y0 - getattr(comp, "_data_y0", 0)
            x0 = r.x0 - comp.x0
            raw.append(comp.data[y0:y0 + r.h, x0:x0 + r.w])
        planes: list = [None] * len(raw)
        fused3 = False
        if tcp.mct == 1 and len(raw) >= 3:
            # fused native DC shift + forward MCT over the triple
            precs = tuple(image.comps[i].prec for i in range(3))
            sgnds = tuple(image.comps[i].sgnd for i in range(3))
            fn = (mct_mod.rct_forward_shift if reversible
                  else mct_mod.ict_forward_shift)
            planes[0], planes[1], planes[2] = fn(
                raw[0], raw[1], raw[2], precs, sgnds)
            fused3 = True
        for compno, comp in enumerate(image.comps[:len(raw)]):
            if fused3 and compno < 3:
                continue
            if tcp.tccps[compno].qmfbid == 0:
                # fused DC shift + float conversion (the forward_dwt
                # input below is float32 either way)
                planes[compno] = mct_mod.shift_to_float(
                    raw[compno], comp.prec, comp.sgnd)
            else:
                planes[compno] = mct_mod.dc_shift_forward(
                    raw[compno], comp.prec, comp.sgnd)
        if tcp.mct == 2 and tcp.mct_matrix is not None:
            n = tcp.mct_matrix.shape[0]
            planes[:n] = mct_mod.matrix_forward(planes[:n], tcp.mct_matrix)

        for compno, tc in enumerate(tile.comps):
            tccp = tcp.tccps[compno]
            data = planes[compno]
            if tccp.qmfbid == 0:
                data = data.astype(np.float32, copy=False)
            bands = dwt_mod.forward_dwt(
                data, tc.rect, tccp.numresolutions, tccp.qmfbid == 1)
            tc.data = bands

    def run_t1(self, rate_quota: float | None = None) -> None:
        """rate_quota: total byte budget of the final layer (all-finite
        targets only).  Each MQ codeblock then early-stops once its
        cumulative rate reaches ~3x its area-proportional share — passes
        a byte cap will provably discard.  revalidate_rate_truncation()
        re-encodes the rare block whose hull still bites at the final
        slope threshold."""
        tile, tcp = self.tile, self.tcp
        # distortion statistics only matter when rate control truncates
        need_dist = tcp.numlayers > 1 or bool(getattr(
            self.cp, "_has_rate_targets", False))
        quota_scale = None
        if rate_quota:
            total_samples = sum(c.rect.area for c in tile.comps)
            if total_samples > 0:
                quota_scale = QUOTA_FACTOR * rate_quota / total_samples
        # whole-tile native fast path (the encode mirror of
        # grk_t1_decode_tile): coefficients go from the band arrays to
        # coded bytes in ONE C call and the results stay in flat arrays
        # that _write_packets_seq consumes directly.  Rate-targeted and
        # multi-layer encodes ride it too: the C epilogue emits the PCRD
        # feed (e0 + per-block convex hulls) and assign_layers runs its
        # flat-array path.  -q quality mode keeps the per-codeblock loop
        # (its calibration re-decodes from per-codeblock state), as do
        # rate-quota early stop and ROI.
        self._enc_seq = None
        card_t1 = self.backend == "device" and _card_t1(tcp)
        whole_tile = (quota_scale is None
                      and not getattr(self.cp, "_has_quality_targets", False)
                      and t2._native is not None
                      and not card_t1
                      and t1_backend.resolve(self.backend) == "native"
                      and not getattr(self, "_device_quantized", False)
                      and not any(t.roi_shift for t in tcp.tccps))
        if whole_tile:
            with span("grk/encode/t1"):
                whole_tile = self._run_t1_tile_native_enc(need_dist)
        if whole_tile:
            self._t1_jobs = []
            self._t1_need_dist = need_dist
            return
        with span("grk/encode/t1_jobs"):
            jobs, job_meta = self._encode_jobs(need_dist, quota_scale)
        with span("grk/encode/t1"):
            t1_backend.encode_batch(jobs, self.backend,
                                    getattr(self, 'num_threads', 0),
                                    device=self.device)
        with span("grk/encode/t1_ingest"):
            self._t1_need_dist = need_dist
            if isinstance(jobs, t1_backend._EncodeTile):
                self._t1_jobs = []
                self._ingest_flat_tile(jobs, job_meta)
                return
            self._t1_jobs = list(zip(jobs, job_meta))
            for job, meta in self._t1_jobs:
                self._ingest_t1_job(job, meta, need_dist)

    def _encode_jobs(self, need_dist: bool, quota_scale: float | None):
        """The tile's Tier-1 encode jobs and, for each, (compno, resno,
        band, codeblock); or, where the tile's blocks code on the device as
        flat arrays (_flat_tile_encode), one t1_backend.HTEncodeTile or
        MQEncodeTile and the statics it was built from."""
        if quota_scale is None:
            flat = self._flat_tile_encode(need_dist)
            if flat is not None:
                return flat
        tile, tcp = self.tile, self.tcp
        # the blocks on_card places on the device, by index in the table
        table, _, gmap = self._t1enc_statics()
        card = t1_backend.on_card(table.ht, table.h, table.w, table.style,
                                  table.mb, need_dist=need_dist)
        jobs = []
        job_meta = []
        for compno, tc in enumerate(tile.comps):
            tccp = tcp.tccps[compno]
            reversible = tccp.qmfbid == 1
            for res in tc.resolutions:
                for bi, band in enumerate(res.bands):
                    if band.rect.is_empty():
                        continue
                    coeffs = tc.data[(res.resno, band.orient)]
                    # a band on the device goes to the host only if one of
                    # its blocks codes there, and then once
                    on_dev = isinstance(coeffs, torch.Tensor)
                    host_band = None
                    # quantization + ROI upshift are deferred to the
                    # backend layer: the native coder fuses them into its
                    # coefficient ingest (one pass instead of two numpy
                    # full-band passes); other backends materialize
                    delta = 0.0
                    if not reversible and not getattr(
                            self, "_device_quantized", False):
                        delta = float(band.stepsize)
                    mixed = tccp.ht and getattr(self.cp, "ht_mixed", False)
                    for prc in res.precincts:
                        pband = prc.pbands[bi]
                        for cblk in pband.cblks:
                            cr = cblk.rect
                            if cr.is_empty():
                                continue
                            sl = coeffs[cr.y0 - band.rect.y0:cr.y1 - band.rect.y0,
                                        cr.x0 - band.rect.x0:cr.x1 - band.rect.x0]
                            # MIXED-set policy: MQ for LL-band blocks (fine
                            # truncation where the energy is), HT elsewhere
                            use_ht = tccp.ht and not (mixed and res.resno == 0)
                            cblk.is_ht = use_ht
                            if on_dev and (tccp.roi_shift
                                           or not card[gmap[id(cblk)]]):
                                if host_band is None:
                                    host_band = coeffs.cpu().numpy()
                                sl = host_band[
                                    cr.y0 - band.rect.y0:
                                    cr.y1 - band.rect.y0,
                                    cr.x0 - band.rect.x0:
                                    cr.x1 - band.rect.x0]
                            # numpy views pass through (the native coders
                            # take strided input)
                            cap = 0
                            if quota_scale is not None and not use_ht:
                                cap = max(320,
                                          int(quota_scale * cr.area) + 64)
                            jobs.append(t1_backend.EncodeJob(
                                sl, band.orient,
                                tccp.cblk_style, ht=use_ht,
                                need_dist=need_dist,
                                numbps_bound=band.numbps,
                                quant_delta=delta,
                                roi_shift=tccp.roi_shift,
                                rate_cap=cap))
                            job_meta.append((compno, res.resno, band, cblk))
        return jobs, job_meta

    def _ingest_t1_job(self, job, meta, need_dist: bool) -> None:
        compno, resno, band, cblk = meta
        tcp = self.tcp
        cblk.data = job.data
        lazy = isinstance(job.passes, t1_backend.LazyPasses)
        if lazy:
            cblk.pass_rates = job.passes.rates.tolist()
        else:
            cblk.pass_rates = [p.rate for p in job.passes]
        tccp = tcp.tccps[compno]
        if job.numbps > band.numbps:
            log.warning("codeblock numbps %d exceeds band M_b %d",
                        job.numbps, band.numbps)
            job.numbps = band.numbps
        cblk.zero_bitplanes = band.numbps - job.numbps
        cblk.numbps = job.numbps
        # weighted distortion for PCRD — only rate control reads it, and
        # every targeted/multi-layer encode runs with need_dist=True, so
        # the untargeted default skips the band-norm/weight math entirely
        # (_scrub_tile resets pass_dists on pooled-tile reuse)
        if need_dist:
            weight = self._band_weight(compno, resno, band.orient,
                                       band.stepsize)
            if lazy:
                cblk.pass_dists = (job.passes.dists * weight).tolist()
            else:
                cblk.pass_dists = [p.dist * weight for p in job.passes]
        else:
            weight = 1.0
            cblk.pass_dists = []
        cblk._passes = job.passes  # kept for layer maths
        # native PCRD acceleration: hull indices + raw slopes computed in
        # the coder epilogue, rate array view (HullIndex consumes these)
        cblk._hull_pass = getattr(job, "hull_pass_arr", None)
        cblk._hull_slope_raw = getattr(job, "hull_slope_arr", None)
        cblk._hull_rate = getattr(job, "hull_rate_arr", None)
        cblk._hull_weight = weight
        cblk._rates_arr = job.passes.rates if lazy else None
        # kept for -q actual-error measurement (truncated re-decode)
        cblk._orient = band.orient
        cblk._style = tccp.cblk_style
        cblk._ht = cblk.is_ht if hasattr(cblk, "is_ht") else tccp.ht
        # initial (nothing-decoded) weighted squared error, for -q
        # mode — only when rate control needs it (avoids pulling
        # device-resident coefficients back to the host)
        if need_dist:
            e0 = getattr(job, "e0_out", None)
            if e0 is None:
                e0 = float(
                    (np.abs(np.asarray(job.coeffs)).astype(np.float64)
                     ** 2).sum())
            cblk._e0 = weight * e0

    def _t1enc_statics(self):
        """The tile's encode BlockTable (t1/tile_batch.py), the codeblock
        objects in its order and `gmap`, codeblock identity -> index in it,
        which _write_packets_seq gathers results by.  A pure function of
        the pooled tile's geometry plus the coding/quant key below, cached
        on the tile object (mirror of the decode-side _seq_state); the
        walk is the precinct walk grk_t1_encode_tile takes."""
        tcp = self.tcp
        skey = (getattr(self.cp, "ht_mixed", False),
                tuple((int(t.cblk_style), bool(t.ht), int(t.qmfbid))
                      for t in tcp.tccps),
                tuple((b.numbps, float(b.stepsize))
                      for tc in self.tile.comps
                      for res in tc.resolutions for b in res.bands))
        cached = getattr(self.tile, "_t1enc_cache", None)
        if cached is not None and cached[0] == skey:
            return cached[1]
        ht_mixed = skey[0]
        band_ids: dict = {}
        band_shape: dict = {}
        band_delta: list = []
        rows: list = []
        cblks: list = []
        gmap: dict = {}
        for tc in self.tile.comps:
            tccp = tcp.tccps[tc.compno]
            reversible = tccp.qmfbid == 1
            style = int(tccp.cblk_style)
            for res in tc.resolutions:
                brect = {b.orient: b.rect for b in res.bands}
                bmeta = {b.orient: (b.numbps, float(b.stepsize))
                         for b in res.bands}
                for prc in res.precincts:
                    for pband in prc.pbands:
                        orient = pband.band_orient
                        r = brect[orient]
                        mb = bmeta[orient][0]
                        bkey = (tc.compno, res.resno, orient)
                        if bkey not in band_ids:
                            band_ids[bkey] = len(band_ids)
                            band_shape[bkey] = (r.h, r.w)
                            band_delta.append(
                                0.0 if reversible else bmeta[orient][1])
                        bid = band_ids[bkey]
                        use_ht = int(tccp.ht and not (
                            ht_mixed and res.resno == 0))
                        for cblk in pband.cblks:
                            gmap[id(cblk)] = len(rows)
                            cblks.append(cblk)
                            cr = cblk.rect
                            # never coded: zb must come out 0 like the
                            # scrubbed default, so mb is recorded as 0
                            rows.append(
                                (0, 0, orient, style, 0, bid, use_ht, 0)
                                if cr.is_empty() else
                                (cr.h, cr.w, orient, style, mb, bid, use_ht,
                                 (cr.y0 - r.y0) * r.w + (cr.x0 - r.x0)))
        table = tile_batch.BlockTable.from_rows(
            rows, list(band_ids), list(band_shape.values()), np.int64,
            np.asarray(band_delta, np.float32))
        statics = (table, cblks, gmap)
        self.tile._t1enc_cache = (skey, statics)
        return statics

    def _flat_tile_encode(self, need_dist: bool):
        """The card route of a whole tile as one flat batch
        (t1/tile_batch.py encode_tile) and the statics it was built from,
        or None where the tile keeps the per-codeblock route: its
        components are not all HT (not ht_mixed) or all MQ, it has an ROI
        or a -q target, or encode_tile refuses it (HT with distortions, or
        its bands).  The caller has checked that no rate quota is set."""
        tccps = self.tcp.tccps
        ht = all(t.ht for t in tccps)
        if (self.backend != "device" or self.device is None
                or getattr(self.cp, "ht_mixed", False)
                or getattr(self.cp, "_has_quality_targets", False)
                or any(t.roi_shift for t in tccps)
                or (not ht and any(t.ht for t in tccps))):
            return None
        table, cblks, gmap = self._t1enc_statics()
        bands = []
        for compno, resno, orient in table.band_keys:
            data = self.tile.comps[compno].data
            bands.append(data.get((resno, orient)) if data is not None
                         else None)
        t = tile_batch.encode_tile(table, bands, self.device, need_dist)
        return None if t is None else (t, (table, cblks, gmap))

    def _ingest_flat_tile(self, t, statics) -> None:
        """A flat tile's results into the whole-tile encode arrays
        (_EncSeq) that _assign_layers_flat and _write_packets_seq read, as
        the native whole-tile encode leaves them: with distortions, the
        PCRD feed too (e0, the hulls of the raw distortions, the weights)."""
        table, cblks, gmap = statics
        r = tile_batch.encode_results(table, t)
        es = self._enc_seq = _EncSeq(
            arena=t.data, offs=r.offs, lens=r.lens, numbps=r.numbps,
            npasses=r.npasses, zb=table.mb - r.numbps, isht=table.flags,
            rates=r.rates, stride=r.rates.shape[1], gmap=gmap, cblks=cblks,
            ncb=len(table))
        if r.e0 is not None:
            es.e0 = r.e0
            es.hull_pass, es.hull_slope, es.hull_rate, es.hull_n = \
                convex_hulls_flat(r.rates, r.dists, r.npasses)
            es.weights = self._block_weights(table)

    def _band_weight(self, compno: int, resno: int, orient: int,
                     stepsize: float) -> float:
        """A band's PCRD distortion weight, (Delta_b * norm_b *
        mct_norm)^2: on a reversible component Delta_b 1 and the 5/3
        norms."""
        tccp = self.tcp.tccps[compno]
        if tccp.qmfbid == 1:
            norm = quant_mod.band_norm_53(tccp.numresolutions, resno, orient)
            delta = 1.0
        else:
            norm = quant_mod.band_norm(tccp.numresolutions, resno, orient)
            delta = stepsize
        mctw = 1.0
        if self.mct_norms is not None and compno < len(self.mct_norms):
            mctw = float(self.mct_norms[compno])
        return (delta * norm * mctw) ** 2

    def _block_weights(self, table) -> np.ndarray:
        """_band_weight of each block of an encode BlockTable."""
        wb = np.array([self._band_weight(*key, float(delta)) for key, delta
                       in zip(table.band_keys, table.band_delta)])
        return wb[table.band]

    def _run_t1_tile_native_enc(self, need_dist: bool = False) -> bool:
        """Whole-tile native Tier-1 encode: every codeblock coded from
        its band-array view in one C call (grk_t1_encode_tile), results
        left in flat arrays (`self._enc_seq`) that _write_packets_seq
        feeds straight to grk_t2_encode_seq — no per-codeblock Python
        objects.  With need_dist the call also returns the PCRD feed
        (per-block e0 + convex hulls) for the flat assign_layers path."""
        nat = t2._native
        table, cblks, gmap = self._t1enc_statics()
        ncb = len(table)
        if ncb == 0:
            return False
        band_keys, bdelta = table.band_keys, table.band_delta
        bstride = table.band_w.astype(np.int32)
        band_base = np.zeros(len(band_keys), np.uint64)
        for i, (compno, resno, orient) in enumerate(band_keys):
            data = self.tile.comps[compno].data
            arr = data.get((resno, orient)) if data is not None else None
            if arr is None:
                return False  # missing band plane: per-codeblock path
            want = np.float32 if bdelta[i] > 0 else np.int32
            if not isinstance(arr, np.ndarray) or arr.dtype != want \
                    or not arr.flags.c_contiguous:
                return False  # device/odd layout: per-codeblock path
            if arr.size and arr.shape[1] != int(bstride[i]):
                return False
            if arr.size:
                band_base[i] = arr.__array_interface__["data"][0]
        tl = _ENC_TL
        arena = getattr(tl, "arena", None)
        if arena is None or arena.nbytes < table.total_cap:
            arena = tl.arena = np.empty(max(table.total_cap, 1), np.uint8)
        rates = getattr(tl, "rates", None)
        if rates is None or rates.shape[0] < ncb:
            rates = tl.rates = np.empty((ncb, _MAX_PASSES), np.int32)
        dist = None
        if need_dist:
            e0 = getattr(tl, "e0", None)
            if e0 is None or e0.shape[0] < ncb:
                e0 = tl.e0 = np.empty(ncb, np.float64)
                tl.hull_pass = np.empty((ncb, _MAX_PASSES), np.int32)
                tl.hull_slope = np.empty((ncb, _MAX_PASSES), np.float64)
                tl.hull_rate = np.empty((ncb, _MAX_PASSES), np.int32)
                tl.hull_n = np.empty(ncb, np.int32)
            dist = (tl.e0, tl.hull_pass, tl.hull_slope, tl.hull_rate,
                    tl.hull_n)
        out_lens = np.empty(ncb, np.int32)
        out_numbps = np.empty(ncb, np.int32)
        out_npasses = np.empty(ncb, np.int32)
        rc = nat.encode_tile(
            ncb, table.hw, table.meta, table.flags, table.off, band_base,
            bstride, bdelta, arena, table.slot_off, table.caps, out_lens,
            out_numbps, out_npasses, rates, _MAX_PASSES,
            getattr(self, "num_threads", 0), dist=dist)
        if rc < 0:
            return False
        es = _EncSeq(arena=arena, offs=table.slot_off, lens=out_lens,
                     numbps=out_numbps, npasses=out_npasses,
                     zb=table.mb - out_numbps, isht=table.flags,
                     rates=rates[:ncb], stride=_MAX_PASSES, gmap=gmap,
                     cblks=cblks, ncb=ncb)
        if need_dist:
            es.e0 = tl.e0[:ncb]
            es.hull_pass = tl.hull_pass[:ncb]
            es.hull_slope = tl.hull_slope[:ncb]
            es.hull_rate = tl.hull_rate[:ncb]
            es.hull_n = tl.hull_n[:ncb]
            es.weights = self._block_weights(table)
        self._enc_seq = es
        return True

    def _enc_perm(self, order, gmap, cblks):
        """Gather permutation write-packets order -> encode order, cached
        on the tile (both inputs are themselves tile caches, compared by
        identity like the decode-side _seq_state)."""
        c = getattr(self.tile, "_enc_perm_cache", None)
        if c is not None and c[0] is order and c[1] is gmap \
                and len(c[2]) == len(cblks):
            return c[2]
        perm = np.fromiter((gmap[id(cb)] for cb in cblks), np.int64,
                           len(cblks))
        self.tile._enc_perm_cache = (order, gmap, perm)
        return perm

    def _materialize_enc_seq(self) -> None:
        """Fallback bridge: mirror the whole-tile encode results into the
        per-codeblock fields the non-seq consumers read (exactly what
        _ingest_t1_job + assign_layers would have set)."""
        es = getattr(self, "_enc_seq", None)
        if es is None:
            return
        arena, offs, lens = es.arena, es.offs, es.lens
        rates = es.rates
        offs_l = offs.tolist()
        lens_l = lens.tolist()
        nb_l = es.numbps.tolist()
        np_l = es.npasses.tolist()
        zb_l = es.zb.tolist()
        isht_l = es.isht.tolist()
        numlayers = self.tcp.numlayers
        has_dist = es.hull_n is not None
        npl = es.npl  # set when assign_layers ran on the flat path
        for g, cblk in enumerate(es.cblks):
            n = np_l[g]
            o = offs_l[g]
            cblk.data = arena[o:o + lens_l[g]].tobytes()
            cblk.numbps = nb_l[g]
            cblk.zero_bitplanes = zb_l[g]
            cblk.is_ht = bool(isht_l[g])
            cblk.pass_rates = rates[g, :n].tolist()
            cblk.pass_dists = []
            if npl is not None:
                cblk.num_passes_by_layer = npl[:, g].tolist()
            else:
                cblk.num_passes_by_layer = [n] + [0] * (numlayers - 1)
            # per-pass distortions stay in native scratch: zero-dist pass
            # records keep any later consumer well-defined (the hulls
            # below carry the PCRD-relevant truncation data)
            cblk._passes = t1_backend.LazyPasses(
                rates[g, :n].copy(), np.zeros(n), np.zeros(n, np.uint8),
                nb_l[g])
            if has_dist:
                hn = int(es.hull_n[g])
                cblk._hull_pass = es.hull_pass[g, :hn].copy()
                cblk._hull_slope_raw = es.hull_slope[g, :hn].copy()
                cblk._hull_rate = es.hull_rate[g, :hn].copy()
                cblk._hull_weight = float(es.weights[g])
                cblk._e0 = float(es.e0[g]) * float(es.weights[g])
            else:
                cblk._hull_pass = None
                cblk._e0 = 0.0
        self._enc_seq = None

    # ---- stage 2: rate control ----

    def all_cblks(self):
        for tc in self.tile.comps:
            for res in tc.resolutions:
                for bi, band in enumerate(res.bands):
                    for prc in res.precincts:
                        for cblk in prc.pbands[bi].cblks:
                            yield cblk

    def assign_layers(self, layer_targets: list[float | None]) -> None:
        """layer_targets: cumulative byte budgets (None = all passes)."""
        numlayers = len(layer_targets)
        es = getattr(self, "_enc_seq", None)
        if es is not None:
            untargeted = all(t is None for t in layer_targets)
            if untargeted or es.hull_n is not None:
                self._assign_layers_flat(layer_targets)
                return
            # targets arrived without the PCRD feed (direct
            # TileCompressor use where run_t1 gated need_dist off):
            # re-run the whole-tile encode with distortion tracking —
            # statics and band pointers are cached, so this is one
            # extra C call, not a silent rate-only degradation
            if self._run_t1_tile_native_enc(True):
                self._assign_layers_flat(layer_targets)
                return
            log.warning("layer targets arrived after a no-distortion "
                        "Tier-1 fast path and the distortion re-encode "
                        "failed; assignment is rate-only")
            self._materialize_enc_seq()
        if all(t is None for t in layer_targets):
            # untargeted layers take every pass in layer 0 — no hulls,
            # no slope index (the common single-layer default; on the HT
            # path each block has a single pass, so this is pure setup)
            for cblk in self.all_cblks():
                cblk.num_passes_by_layer = [0] * numlayers
                if cblk.pass_rates:
                    cblk.num_passes_by_layer[0] = len(cblk.pass_rates)
            self._last_lambda = math.inf
            self._hull_index = None
            return
        entries = []
        for cblk in self.all_cblks():
            cblk.num_passes_by_layer = [0] * numlayers
            if not cblk.pass_rates:
                continue
            # hull=None marks an array-backed entry: the native coder
            # already computed the hull (HullIndex reads the arrays).
            # The fallback hulls RAW distortions so both paths produce
            # bit-identical slopes (raw slope x weight, applied in
            # HullIndex) — hull selection is weight-invariant.
            if getattr(cblk, "_hull_pass", None) is not None:
                entries.append((cblk, None))
            else:
                draw = [p.dist for p in cblk._passes]
                entries.append((cblk, convex_hull(cblk.pass_rates, draw)))

        prev = {id(c): 0 for c, _ in entries}
        self._last_lambda = math.inf  # min applied threshold over layers
        hidx = self._hull_index = HullIndex(entries)
        slopes = hidx.distinct_slopes()
        sim = self._sim_state = self._build_sim_state(entries, numlayers)
        prev_v = np.zeros(len(entries), dtype=np.int64)
        try:
            for layno, target in enumerate(layer_targets):
                if target is None or not slopes:
                    # include-everything layer: all passes, independent
                    # of the distortion hull (which is empty when
                    # tracking is skipped)
                    counts = {id(c): len(c.pass_rates)
                              for c, h in entries}
                else:
                    counts = self._bisect_layer(entries, prev, slopes,
                                                layno, target)
                counts_v = np.asarray([counts[id(c)] for c, _ in entries],
                                      dtype=np.int64)
                counts_v = np.maximum(counts_v, prev_v)
                if sim is not None:
                    self._sim_finalize_layer(sim, counts_v - prev_v,
                                             layno)
                for c, h in entries:
                    c.num_passes_by_layer[layno] = max(
                        0, counts[id(c)] - prev[id(c)])
                prev = {k: max(prev[k], counts[k]) for k in prev}
                prev_v = counts_v
        finally:
            self._sim_state = None

    def _assign_layers_flat(self, layer_targets: list[float | None]) -> None:
        """Flat-array layer assignment over _enc_seq: the whole-tile
        native encode's PCRD feed (per-block hulls, pooled rate matrix)
        drives the same two-stage bisect with no per-codeblock Python
        state; the result is the (numlayers, ncb) pass-count matrix
        grk_t2_encode_seq consumes directly."""
        es = self._enc_seq
        numlayers = len(layer_targets)
        ncb = es.ncb
        self._last_lambda = math.inf
        self._hull_index = None
        npl = np.zeros((numlayers, ncb), np.int32)
        if all(t is None for t in layer_targets):
            # untargeted: every pass in its first layer, no hulls needed
            npl[0, :] = es.npasses
        else:
            hidx = HullIndex.from_flat(
                es.hull_pass, es.hull_slope, es.hull_rate, es.hull_n,
                es.weights)
            slopes = hidx.distinct_slopes()
            sim = self._build_sim_state_flat(es, numlayers)
            npasses = es.npasses.astype(np.int64)
            rates2d = es.rates
            gi = np.arange(ncb)
            prev = np.zeros(ncb, np.int64)
            for layno, target in enumerate(layer_targets):
                if target is None or not slopes:
                    counts = npasses
                else:
                    prev_rates = np.where(
                        prev > 0, rates2d[gi, np.maximum(prev, 1) - 1],
                        0).astype(np.int64)
                    size_fn = (lambda cv, _l=layno, _p=prev:
                               self._simulate_size_fast(sim, cv - _p, _l))
                    counts = self._bisect_layer_v(
                        hidx, prev, prev_rates, slopes, layno, target,
                        size_fn)
                    if counts is None:
                        counts = prev
                counts = np.maximum(counts, prev)
                self._sim_finalize_layer(sim, counts - prev, layno)
                npl[layno] = (counts - prev).astype(np.int32)
                prev = counts
        es.npl = npl
        incl = npl > 0
        es.first = np.where(incl.any(axis=0), np.argmax(incl, axis=0),
                            numlayers).astype(np.int32)

    def _build_sim_state_flat(self, es, numlayers: int):
        """Sim state for the flat PCRD path: per precinct handle, the
        encoder statics (zb / numbps / coder choice / pass rates) land
        directly from the _enc_seq arrays — the per-codeblock
        _ensure_rates walk never runs — and eidx maps handle slots to
        global encode indices so delta vectors scatter straight in."""
        state = []
        gmap = es.gmap
        rates2d = es.rates
        for tc in self.tile.comps:
            tccp = self.tcp.tccps[tc.compno]
            mixed = tccp.ht and getattr(self.cp, "ht_mixed", False)
            for res in tc.resolutions:
                for precno in range(res.pw * res.ph):
                    h = t2._native.get_handle(res.precincts[precno])
                    idx = np.fromiter((gmap[id(c)] for c in h.cblks),
                                      np.intp, h.ncb)
                    if h.ncb:
                        h.zb[:h.ncb] = es.zb[idx]
                        h.numbps[:h.ncb] = es.numbps[idx]
                        h.is_ht[:h.ncb] = es.isht[idx]
                        h.rates = np.ascontiguousarray(rates2d[idx])
                        h.rates_stride = es.stride
                    npl = np.zeros(
                        (numlayers, max(h.ncb, 1)), dtype=np.int32)
                    fl = np.full(max(h.ncb, 1), numlayers, dtype=np.int32)
                    state.append((h, int(tccp.cblk_style), mixed, npl,
                                  np.arange(h.ncb, dtype=np.intp),
                                  idx, fl))
        return state

    def revalidate_rate_truncation(self) -> bool:
        """Rate-quota safety net: re-encode (without a cap) every early-
        stopped codeblock whose truncated hull still bites at the applied
        slope threshold — its missing deeper passes could have been
        included.  Returns True when any block was re-encoded (the caller
        must redo assign_layers).

        The 0.5x margin below the threshold is a HEURISTIC, not a proof:
        hull merging can in principle pop a truncated tail into a point
        whose slope exceeds the threshold even when the truncated hull's
        last slope sat below half of it.  This (plus the measured
        no-win, PERF_NOTES.md) is why rate_quota ships off by default —
        it trades a bounded, usually-invisible R-D deviation for Tier-1
        time on tight-target workloads."""
        pairs = getattr(self, "_t1_jobs", None)
        if not pairs:
            return False
        lam = getattr(self, "_last_lambda", None)
        redo = []
        for job, meta in pairs:
            if not job.rate_cap:
                continue
            total = 3 * job.numbps - 2
            if job.numbps <= 0 or len(job.passes) >= total:
                continue  # not actually truncated
            cblk = meta[3]
            hull = convex_hull(cblk.pass_rates, cblk.pass_dists)
            last_slope = hull[-1][3] if hull else 0.0
            if lam is None or not math.isfinite(lam) \
                    or last_slope >= lam * 0.5:
                redo.append((job, meta))
        if not redo:
            return False
        log.debug("rate quota: re-encoding %d/%d truncated codeblocks",
                  len(redo), len(pairs))
        for job, _ in redo:
            job.rate_cap = 0
            job.passes = []
            job.data = b""
            job.hull_pass_arr = None
            job.hull_slope_arr = None
            job.hull_rate_arr = None
        t1_backend.encode_batch([j for j, _ in redo], self.backend,
                                getattr(self, 'num_threads', 0),
                                device=self.device)
        for job, meta in redo:
            self._ingest_t1_job(job, meta, self._t1_need_dist)
        # re-encoding changed pass rates/numbps: the native Tier-2
        # handles cache those as "static after Tier-1" — invalidate
        for prc in self._precinct_list():
            h = getattr(prc, "_nt2", None)
            if h is not None:
                h.rates = None
                h.statics_built = False
        return True

    def assign_layers_quality(self, psnr_targets: list[float]) -> None:
        """-q mode (SURVEY.md B.8): per-layer distortion thresholds.

        Two stages per layer: (1) the classic hull walk using the per-band
        L2-norm error estimate picks a candidate truncation, then (2) the
        candidate is calibrated against the ACTUAL reconstruction error —
        truncated codeblocks are Tier-1 decoded, dequantized and
        inverse-transformed, and the measured image-domain PSNR drives a
        multiplicative threshold correction until the achieved PSNR is
        within 0.2 dB of the target (or the error floor is reached).  This
        removes the ~1 dB high-target bias of the independence
        approximation."""
        # -q calibration decodes from per-codeblock state; run_t1 gates
        # the flat path off for quality targets, but a direct caller may
        # not have set the flag — bridge defensively
        self._materialize_enc_seq()
        numlayers = len(psnr_targets)
        entries = []
        e0_total = 0.0
        for cblk in self.all_cblks():
            cblk.num_passes_by_layer = [0] * numlayers
            e0_total += getattr(cblk, "_e0", 0.0)
            if not cblk.pass_rates:
                continue
            entries.append((cblk, convex_hull(cblk.pass_rates,
                                              cblk.pass_dists)))

        total_samples = sum(tc.rect.area for tc in self.tile.comps)
        peak = (1 << self.image.comps[0].prec) - 1
        slopes = candidate_slopes([h for _, h in entries])
        prev = {id(c): 0 for c, _ in entries}

        def estimate_counts(e_target):
            lo, hi = 0, len(slopes)
            best = None
            while lo < hi:
                mid = (lo + hi) // 2
                lam = slopes[mid]
                cand = {}
                dtot = 0.0
                for c, h in entries:
                    n = max(prev[id(c)], passes_for_threshold(h, lam))
                    cand[id(c)] = n
                    if n:
                        dtot += c.pass_dists[n - 1]
                if e0_total - dtot <= e_target:
                    best = cand
                    hi = mid
                else:
                    lo = mid + 1
            return best

        all_counts = {id(c): (h[-1][0] + 1 if h else 0) for c, h in entries}
        for layno, target_db in enumerate(psnr_targets):
            if target_db <= 0 or not slopes:
                counts = dict(all_counts)
            else:
                e_target = (peak ** 2 / (10.0 ** (target_db / 10.0))
                            * total_samples)
                factor = 1.0
                counts = None
                best_gap = None
                for _ in range(6):
                    cand = estimate_counts(e_target * factor)
                    if cand is None:
                        cand = dict(all_counts)
                    e_act = self._measure_actual_error(entries, cand)
                    if e_act is None:
                        counts = cand  # measurement unavailable: estimate
                        break
                    if e_act <= 0:
                        counts = cand  # error floor (effectively lossless)
                        break
                    ach_db = 10.0 * math.log10(
                        peak ** 2 * total_samples / e_act)
                    gap = abs(ach_db - target_db)
                    if best_gap is None or gap < best_gap:
                        best_gap, counts = gap, cand
                    if gap <= 0.2:
                        break
                    if cand == all_counts and ach_db < target_db:
                        break  # all passes included, target unreachable
                    # proportional threshold correction: the estimate maps
                    # threshold T to actual error ~c*T, so retarget with
                    # T' = T * e_target / e_act (monotone in passes)
                    factor *= e_target / e_act
                    factor = min(64.0, max(1.0 / 4096.0, factor))
                if counts is None:
                    counts = dict(all_counts)
            for c, h in entries:
                c.num_passes_by_layer[layno] = max(
                    0, counts[id(c)] - prev[id(c)])
            prev = {k: max(prev[k], counts[k]) for k in prev}

    def _measure_actual_error(self, entries, counts):
        """Measure the true squared reconstruction error (image domain) of
        a candidate truncation: Tier-1 decode each truncated codeblock,
        rebuild band planes, run the full synthesis (dequant + inverse DWT
        + inverse MCT + DC unshift with precision clamp) and compare to the
        original tile samples.  Returns None when the tile shape prevents
        measurement (nothing ingested)."""
        tile, tcp, image = self.tile, self.tcp, self.image
        jobs = []
        meta = []
        for cblk, _h in entries:
            n = counts[id(cblk)]
            if n <= 0 or not cblk.pass_rates:
                continue
            passes = cblk._passes[:n]
            nbytes = passes[-1].rate
            # segment byte lengths as the decoder would see them: split at
            # pass terminations (bypass transitions always terminate)
            seg_lens = []
            last = 0
            for pi, p in enumerate(passes):
                if p.term or pi == len(passes) - 1:
                    seg_lens.append(p.rate - last)
                    last = p.rate
            jobs.append(t1_backend.DecodeJob(
                cblk.data[:nbytes], seg_lens, n, cblk.numbps,
                cblk.rect.h, cblk.rect.w, cblk._orient,
                cblk._style, ht=cblk._ht))
            meta.append(cblk)
        t1_backend.decode_batch(jobs, self.backend,
                                getattr(self, 'num_threads', 0),
                                device=self.device)
        decoded = {id(c): j.out for j, c in zip(jobs, meta)}

        total_err = 0.0
        planes = []
        for compno, tc in enumerate(tile.comps):
            tccp = tcp.tccps[compno]
            reversible = tccp.qmfbid == 1
            bands = {}
            deltas = {}
            for res in tc.resolutions:
                for bi, band in enumerate(res.bands):
                    arr = np.zeros((band.rect.h, band.rect.w), dtype=np.int32)
                    for prc in res.precincts:
                        for cblk in prc.pbands[bi].cblks:
                            out = decoded.get(id(cblk))
                            if out is None:
                                continue
                            if tccp.roi_shift:
                                mag = np.abs(out)
                                is_roi = mag >= (1 << (tccp.roi_shift + 1))
                                mag = np.where(is_roi, mag >> tccp.roi_shift,
                                               mag)
                                out = np.where(out < 0, -mag,
                                               mag).astype(np.int32)
                            y0 = cblk.rect.y0 - band.rect.y0
                            x0 = cblk.rect.x0 - band.rect.x0
                            arr[y0:y0 + cblk.rect.h,
                                x0:x0 + cblk.rect.w] = out
                    bands[(res.resno, band.orient)] = arr
                    deltas[(res.resno, band.orient)] = float(band.stepsize)
            # halving / dequantization fused into the native band loads
            planes.append(dwt_mod.inverse_dwt(
                bands, tc.rect, tccp.numresolutions, reversible,
                doubled=reversible,
                deltas=None if reversible else deltas))
        done3 = False
        if tcp.mct == 1 and len(planes) >= 3:
            precs = tuple(image.comps[i].prec for i in range(3))
            sgnds = tuple(image.comps[i].sgnd for i in range(3))
            fn = (mct_mod.rct_inverse_shift if tcp.tccps[0].qmfbid == 1
                  else mct_mod.ict_inverse_shift)
            planes[0], planes[1], planes[2] = fn(
                planes[0], planes[1], planes[2], precs, sgnds)
            done3 = True
        elif tcp.mct == 2 and tcp.mct_matrix is not None:
            planes[:tcp.mct_matrix.shape[0]] = mct_mod.matrix_inverse(
                planes[:tcp.mct_matrix.shape[0]], tcp.mct_matrix)
        for compno, p in enumerate(planes):
            comp = image.comps[compno]
            if done3 and compno < 3:
                rec = p
            else:
                rec = mct_mod.shift_round_clip(p, comp.prec, comp.sgnd)
            tc = tile.comps[compno]
            r = tc.rect
            y0 = r.y0 - comp.y0 - getattr(comp, "_data_y0", 0)
            x0 = r.x0 - comp.x0
            orig = comp.data[y0:y0 + r.h, x0:x0 + r.w]
            if orig.shape != rec.shape:
                return None
            d = rec.astype(np.float64) - orig
            total_err += float((d * d).sum())
        return total_err

    def _bisect_layer(self, entries, prev, slopes, layno, target):
        """Object-path wrapper over the vector bisect core: builds the
        per-entry prev vectors from codeblock state, adapts the Tier-2
        dry run, and maps the result back to a counts dict."""
        hidx = getattr(self, "_hull_index", None)
        if hidx is None:
            hidx = self._hull_index = HullIndex(entries)
        prev_counts = np.asarray([prev[id(c)] for c, _ in entries],
                                 dtype=np.int64)
        prev_rates = np.asarray(
            [c.pass_rates[p - 1] if p > 0 else 0
             for (c, _), p in zip(entries, prev_counts)], dtype=np.int64)
        sim = getattr(self, "_sim_state", None)
        if sim is not None:
            def size_fn(counts_v):
                return self._simulate_size_fast(
                    sim, counts_v - prev_counts, layno)
        else:
            def size_fn(counts_v):
                counts = {id(c): int(n)
                          for (c, _), n in zip(entries, counts_v)}
                return self._simulate_size(entries, prev, counts, layno)
        counts_v = self._bisect_layer_v(hidx, prev_counts, prev_rates,
                                        slopes, layno, target, size_fn)
        if counts_v is None:
            return dict(prev)
        return {id(c): int(n) for (c, _), n in zip(entries, counts_v)}

    def _bisect_layer_v(self, hidx, prev_counts, prev_rates, slopes,
                        layno, target, size_fn):
        """Two-stage feasible-slope search (B.8 'feasible' PCRD), vector
        core shared by the object and flat paths.

        Stage 1 bisects on BODY bytes only, fully vectorized over the
        flattened hull index — no Tier-2 calls.  Since headers are
        non-negative, any candidate whose bodies alone exceed the target
        is infeasible, so stage 1 yields an upper bound on the feasible
        slope index.  Stage 2 walks down from that bound with exact
        Tier-2 dry runs (typically 1-3, vs log2(slopes) before) until the
        full packet size fits.  Returns the per-entry included-pass
        vector (int64), or None when no feasible threshold exists."""

        def cand_counts(lam):
            counts, rates = hidx.counts_rates(lam)
            counts = np.maximum(counts, prev_counts)
            rates = np.maximum(rates, prev_rates)
            return counts, int(rates.sum())

        def body_bisect(eff_target):
            # last index whose body total fits (body monotone in index)
            lo, hi = 0, len(slopes)
            best = None
            while lo < hi:
                mid = (lo + hi) // 2
                _, body = cand_counts(slopes[mid])
                if body <= eff_target:
                    best = mid
                    lo = mid + 1
                else:
                    hi = mid
            return best

        def exact(idx):
            counts_v, body = cand_counts(slopes[idx])
            return counts_v, body, size_fn(counts_v)

        # stage 2: fixed-point on the header+framing overhead.  One exact
        # Tier-2 dry run per iteration measures overhead = size - body;
        # re-bisecting bodies against (target - overhead) converges in
        # 2-4 iterations because the overhead barely moves with the index.
        # At the fixed point, body(idx) <= target - overhead(idx) implies
        # size(idx) <= target, so convergence is feasibility.
        def exact_bisect(lo, hi, best, best_idx):
            # last-resort exact search (the old algorithm): monotone in
            # the index, O(log) Tier-2 dry runs
            while lo < hi:
                mid = (lo + hi) // 2
                counts, _, size = exact(mid)
                if size <= target:
                    best, best_idx = counts, mid
                    lo = mid + 1
                else:
                    hi = mid
            return best, best_idx

        overhead = 0
        last_idx = None
        best = None
        best_idx = None
        for _ in range(10):
            idx = body_bisect(target - overhead)
            if idx is None:
                break
            if idx == last_idx:
                break
            last_idx = idx
            counts, body, size = exact(idx)
            overhead = size - body
            if size <= target:
                best = counts
                best_idx = idx
        if best is None:
            if last_idx is None:
                # bodies alone exceed the target at every index (the
                # first bisect failed with overhead 0) — exact sizes can
                # only be larger, so skip the futile dry runs
                return None
            # overhead never stabilized on a feasible index: fall back to
            # the exact bisection so a feasible smaller index (if any) is
            # still found — the fixed point is an accelerator, not the
            # correctness path
            best, best_idx = exact_bisect(0, len(slopes), None, None)
            if best is None:
                return None
        # push-up: the overhead approximation may land short of the true
        # maximum feasible index; walk up a few steps, then finish with
        # an exact bisection if the walk never hit an infeasible index
        idx = best_idx
        exhausted = True
        for _ in range(3):
            if idx + 1 >= len(slopes):
                exhausted = False
                break
            counts, _, size = exact(idx + 1)
            if size > target:
                exhausted = False
                break
            best = counts
            idx += 1
        if exhausted:
            best2, idx2 = exact_bisect(idx + 1, len(slopes), None, None)
            if best2 is not None:
                best, idx = best2, idx2
        # the smallest slope threshold actually applied across layers
        # (rate-quota revalidation compares truncated hulls against it)
        self._last_lambda = min(getattr(self, "_last_lambda", math.inf),
                                slopes[idx])
        return best

    def _simulate_size(self, entries, prev, counts, layno) -> int:
        """Tier-2 dry run: bytes of all packets up to and including layno
        with the proposed assignment."""
        for c, _ in entries:
            c.num_passes_by_layer[layno] = max(0, counts[id(c)] - prev[id(c)])
        saved = self._snapshot_t2()
        try:
            total = 0
            npkts = 0
            for layer in range(layno + 1):
                sz, np_ = self._layer_packets_size(layer)
                total += sz
                npkts += np_
        finally:
            self._restore_t2(saved)
        # per-packet framing (SOP/EPH) + SOT+SOD per tile-part
        total += npkts * getattr(self.cp, "_sim_pkt_overhead", 0)
        return total + 14 * max(1, getattr(self.cp, "_sim_tile_parts", 1))

    def _build_sim_state(self, entries, numlayers: int):
        """Vectorized Tier-2 dry-run context (native T2 only): per
        precinct handle, the entry-index/slot scatter maps plus a
        layer-major (numlayers x ncb) pass-count matrix and the running
        first-contributing-layer vector.  A bisect trial then costs two
        array writes + one native size_layers() call per precinct
        instead of per-cblk Python loops (grk_t2_size_layers replays all
        layers in C).  Byte-identical to _simulate_size
        (differential-tested)."""
        if t2._native is None:
            return None
        eix = {id(c): i for i, (c, _) in enumerate(entries)}
        state = []
        for tc in self.tile.comps:
            tccp = self.tcp.tccps[tc.compno]
            mixed = tccp.ht and getattr(self.cp, "ht_mixed", False)
            for res in tc.resolutions:
                for precno in range(res.pw * res.ph):
                    h = t2._native.get_handle(res.precincts[precno])
                    slots, eidx = [], []
                    for s, c in enumerate(h.cblks):
                        i = eix.get(id(c))
                        if i is not None:
                            slots.append(s)
                            eidx.append(i)
                    npl = np.zeros(
                        (numlayers, max(h.ncb, 1)), dtype=np.int32)
                    fl = np.full(max(h.ncb, 1), numlayers, dtype=np.int32)
                    state.append((h, int(tccp.cblk_style), mixed, npl,
                                  np.asarray(slots, dtype=np.intp),
                                  np.asarray(eidx, dtype=np.intp), fl))
        return state

    def _simulate_size_fast(self, sim, delta, layno: int) -> int:
        """Tier-2 dry run over the vectorized sim state: total bytes of
        all packets up to and including layno with `delta` extra passes
        (vector over hull entries) assigned to layer layno."""
        nlay = layno + 1
        total = 0
        for h, style, mixed, npl, slots, eidx, fl_prev in sim:
            fl = fl_prev
            if h.ncb:
                row = npl[layno]
                row[:] = 0
                if slots.size:
                    d = delta[eidx]
                    row[slots] = d
                    inc = d > 0
                    if inc.any():
                        fl = fl_prev.copy()
                        si = slots[inc]
                        fl[si] = np.minimum(fl[si], layno)
            total += h.size_layers(nlay, style, mixed, npl, fl)
        total += len(sim) * nlay * getattr(self.cp, "_sim_pkt_overhead", 0)
        return total + 14 * max(1, getattr(self.cp, "_sim_tile_parts", 1))

    def _sim_finalize_layer(self, sim, delta, layno: int) -> None:
        """Commit layer layno's final pass deltas into the sim state so
        later layers' trials replay it correctly."""
        for h, _style, _mixed, npl, slots, eidx, fl_prev in sim:
            if not h.ncb:
                continue
            row = npl[layno]
            row[:] = 0
            if slots.size:
                d = delta[eidx]
                row[slots] = d
                si = slots[d > 0]
                fl_prev[si] = np.minimum(fl_prev[si], layno)

    def _layer_packets_size(self, layno: int) -> tuple[int, int]:
        """(total bytes, packet count) of one layer's packets (LRCP-local
        order) without materializing headers or bodies (t2.packet_size)."""
        total = 0
        npkts = 0
        for tc in self.tile.comps:
            tccp = self.tcp.tccps[tc.compno]
            mixed = tccp.ht and getattr(self.cp, "ht_mixed", False)
            for res in tc.resolutions:
                for precno in range(res.pw * res.ph):
                    total += t2.packet_size(res, precno, layno,
                                            tccp.cblk_style, mixed=mixed)
                    npkts += 1
        return total, npkts

    def _precinct_list(self):
        plist = getattr(self, "_t2_prc_cache", None)
        if plist is None:
            plist = [prc for tc in self.tile.comps
                     for res in tc.resolutions for prc in res.precincts]
            self._t2_prc_cache = plist
        return plist

    def _snapshot_t2(self):
        # the native Tier-2 state is reset (not saved): simulation always
        # starts from fresh state and real packet emission resets again
        # via reset_t2(), so "fresh" IS the saved state here
        if t2._native is not None:
            # native path: Python-side trees/counters are never touched by
            # the native coder, so only the native state needs resetting
            for prc in self._precinct_list():
                t2.reset_precinct(prc)
            return None
        state = []
        for prc in self._precinct_list():
            for pband in prc.pbands:
                state.append((pband, pband.incl_tree, pband.imsb_tree))
                pband.incl_tree = None
                pband.imsb_tree = None
                for cblk in pband.cblks:
                    state.append(
                        (cblk, cblk.included_in_layer, cblk.lblock,
                         cblk.total_passes))
                    cblk.included_in_layer = -1
                    cblk.lblock = 3
                    cblk.total_passes = 0
        return state

    def _restore_t2(self, state):
        if state is None:  # native path: next consumer resets first
            return
        for item in state:
            if len(item) == 3:
                pband, it, zt = item
                pband.incl_tree = it
                pband.imsb_tree = zt
                if it is not None:
                    it.reset()
                    zt.reset()
                    # re-derive values on next encode
                    pband.incl_tree = None
                    pband.imsb_tree = None
            else:
                cblk, inc, lb, tp = item
                cblk.included_in_layer = inc
                cblk.lblock = lb
                cblk.total_passes = tp

    # ---- stage 3: Tier-2 packet emission ----

    def reset_t2(self):
        for prc in self._precinct_list():
            t2.reset_precinct(prc)
            for pband in prc.pbands:
                pband.incl_tree = None
                pband.imsb_tree = None
                for cblk in pband.cblks:
                    cblk.included_in_layer = -1
                    cblk.lblock = 3
                    cblk.total_passes = 0

    def write_layer_packets(self, layno: int) -> bytes:
        """Packets of one layer in LRCP-local order (used for simulation)."""
        out = bytearray()
        for tc in self.tile.comps:
            tccp = self.tcp.tccps[tc.compno]
            mixed = tccp.ht and getattr(self.cp, "ht_mixed", False)
            for res in tc.resolutions:
                for precno in range(res.pw * res.ph):
                    out += t2.encode_packet(res, precno, layno,
                                            tccp.cblk_style, mixed=mixed)
        return bytes(out)

    def write_packets(self, comp_info, sop=False, eph=False, ppt=False):
        """All packets in the tile's signaled progression order.

        Returns (body bytes, per-packet lengths, packet coords, ppt_hdr) —
        lengths feed PLT emission, coords feed tile-part splitting (-u);
        with ppt=True the packet headers come back separately for a PPT
        marker segment and the body holds only packet bodies."""
        self.reset_t2()
        order = t2.packet_order(self.tile, self.tcp, comp_info)
        if t2._native is not None and order:
            return self._write_packets_seq(order, sop, eph, ppt)
        self._materialize_enc_seq()  # per-packet path reads cblk state
        out = bytearray()
        hdrs = bytearray()
        lengths: list[int] = []
        for n, pc in enumerate(order):
            tc = self.tile.comps[pc.compno]
            tccp = self.tcp.tccps[pc.compno]
            res = tc.resolutions[pc.resno]
            mixed = tccp.ht and getattr(self.cp, "ht_mixed", False)
            if ppt:
                hdr, body = t2.encode_packet(
                    res, pc.precno, pc.layno, tccp.cblk_style,
                    eph=eph, split_header=True, mixed=mixed)
                hdrs += hdr
                out += body
                lengths.append(len(body))
            else:
                pkt = t2.encode_packet(
                    res, pc.precno, pc.layno, tccp.cblk_style,
                    sop=sop, eph=eph, sop_index=n & 0xFFFF, mixed=mixed)
                out += pkt
                lengths.append(len(pkt))
        return bytes(out), lengths, order, bytes(hdrs)

    def _write_packets_seq(self, order, sop, eph, ppt):
        """Whole-tile packet emission through grk_t2_encode_seq: ONE C
        call assembles every packet (SOP/header/EPH/body) from flat
        per-packet arrays plus per-global-codeblock statics — the encode
        mirror of _decode_packets_seq.  Byte-identical to the per-packet
        loop (the native call reuses grk_t2_encode_packet internally);
        differential-tested in tests/test_native_t2.py."""
        nat = t2._native
        npk = len(order)
        prc_a = np.empty(npk, np.uint64)
        lay_a = np.empty(npk, np.int32)
        sty_a = np.empty(npk, np.int32)
        mix_a = np.empty(npk, np.int32)
        base_a = np.empty(npk, np.int32)
        handles_by_prc: dict = {}
        cblks: list = []
        base = 0
        ht_mixed = getattr(self.cp, "ht_mixed", False)
        for n, pc in enumerate(order):
            tccp = self.tcp.tccps[pc.compno]
            res = self.tile.comps[pc.compno].resolutions[pc.resno]
            prc = res.precincts[pc.precno]
            ent = handles_by_prc.get(id(prc))
            if ent is None:
                h = nat.get_handle(prc)
                ent = handles_by_prc[id(prc)] = (base, h)
                cblks.extend(h.cblks)
                base += h.ncb
            prc_a[n] = ent[1].ptr
            lay_a[n] = pc.layno
            sty_a[n] = int(tccp.cblk_style)
            mix_a[n] = 1 if (tccp.ht and ht_mixed) else 0
            base_a[n] = ent[0]
        ncbt = max(base, 1)
        nlayers = self.tcp.numlayers
        es = getattr(self, "_enc_seq", None)
        if es is not None and base:
            # whole-tile fast path: gather the grk_t1_encode_tile arrays
            # into this order — no per-codeblock Python state exists
            perm = self._enc_perm(order, es.gmap, cblks)
            zb = np.zeros(ncbt, np.int32)
            nbps = np.zeros(ncbt, np.int32)
            isht = np.zeros(ncbt, np.int32)
            zb[:base] = es.zb[perm]
            nbps[:base] = es.numbps[perm]
            isht[:base] = es.isht[perm]
            npl = np.zeros((max(nlayers, 1), ncbt), np.int32)
            if es.npl is not None and es.npl.shape[0] == nlayers:
                # layer assignment from the flat PCRD path
                npl[:, :base] = es.npl[:, perm]
                first = np.full(ncbt, nlayers, np.int32)
                first[:base] = es.first[perm]
            else:
                # no assignment ran (direct write_packets use): all
                # passes in layer 0, the untargeted single-layer default
                npl[0, :base] = es.npasses[perm]
                first = np.full(ncbt, nlayers, np.int32)
                first[:base] = np.where(npl[0, :base] > 0, 0, nlayers)
            rates = np.ascontiguousarray(es.rates[perm])
            lens_p = es.lens[perm]
            ptrs = np.zeros(ncbt, np.uint64)
            abase = es.arena.__array_interface__["data"][0]
            ptrs[:base] = np.where(
                lens_p > 0, abase + es.offs[perm].astype(np.uint64), 0)
            keep = [es.arena]
            body, lengths, hdrs = nat.encode_seq(
                prc_a, lay_a, sty_a, mix_a, base_a, npl, first, zb, nbps,
                isht, rates, es.stride, ptrs, sop=sop, eph=eph, split=ppt)
            del keep
            # the flat arrays are views into thread-local scratch the
            # NEXT tile on this thread overwrites — drop the reference
            # so no later consumer reads stale data
            self._enc_seq = None
            return body, lengths, order, hdrs
        zb = np.zeros(ncbt, np.int32)
        nbps = np.zeros(ncbt, np.int32)
        isht = np.zeros(ncbt, np.int32)
        if base:
            zb[:base] = np.fromiter((c.zero_bitplanes for c in cblks),
                                    np.int32, base)
            nbps[:base] = np.fromiter((c.numbps for c in cblks),
                                      np.int32, base)
            isht[:base] = np.fromiter(
                (1 if getattr(c, "is_ht", False) else 0 for c in cblks),
                np.int32, base)
        prs = [c.pass_rates for c in cblks]
        stride = max(map(len, prs), default=1) or 1
        rates = np.zeros((ncbt, stride), np.int32)
        npl = np.zeros((max(nlayers, 1), ncbt), np.int32)
        first = np.zeros(ncbt, np.int32)
        if base and nlayers == 1:
            # single-layer fast path (the untargeted default): layer 0
            # takes every pass, so the nested per-layer loop collapses to
            # two vectorized pulls.  first == len(nplc) when no layer-0
            # passes exist, matching the generic loop exactly (entries
            # past index 0 are ignored there too: ln < nlayers).
            npls = [c.num_passes_by_layer for c in cblks]
            npl[0, :base] = np.fromiter(
                ((n_[0] if n_ else 0) for n_ in npls), np.int32, base)
            first[:base] = np.fromiter(
                ((0 if (n_ and n_[0]) else len(n_)) for n_ in npls),
                np.int32, base)
            if stride == 1:
                rates[:base, 0] = np.fromiter(
                    ((r[0] if r else 0) for r in prs), np.int32, base)
            else:
                for g, r in enumerate(prs):
                    if r:
                        rates[g, :len(r)] = r
        else:
            for g, c in enumerate(cblks):
                nplc = c.num_passes_by_layer
                f = len(nplc)
                for ln, v in enumerate(nplc):
                    if v and ln < nlayers:
                        npl[ln, g] = v
                        if f > ln:
                            f = ln
                first[g] = f
                r = prs[g]
                if r:
                    rates[g, :len(r)] = r
        # one joined pool replaces a frombuffer view per codeblock; the
        # pool array pins the bytes for the native call
        datas = [c.data or b"" for c in cblks]
        lens = (np.fromiter(map(len, datas), np.int64, base) if base
                else np.zeros(0, np.int64))
        pool = np.frombuffer(b"".join(datas) or b"\x00", np.uint8)
        offs = np.concatenate(([0], np.cumsum(lens)[:-1]))[:base]
        ptrs = np.zeros(ncbt, np.uint64)
        if base:
            pbase = pool.__array_interface__["data"][0]
            ptrs[:base] = np.where(lens > 0, pbase + offs, 0)
        keep = [pool]  # pins the joined codeblock bytes for the call
        body, lengths, hdrs = nat.encode_seq(
            prc_a, lay_a, sty_a, mix_a, base_a, npl, first, zb, nbps,
            isht, rates, stride, ptrs, sop=sop, eph=eph, split=ppt)
        del keep
        return body, lengths, order, hdrs


def _tcp_device_key(tcp) -> tuple:
    """Parameters the batched device pipelines share across tiles: tiles
    whose tile-part headers override any of these must not batch."""
    t0 = tcp.tccps[0]
    return (t0.numresolutions, t0.qmfbid, t0.qnt_style, t0.num_guard_bits,
            tcp.mct, tuple((ss.expn, ss.mant) for ss in t0.stepsizes))


def _uniform_batch(tiles, decode: bool = False) -> bool:
    """Can these tiles go through one batched pipeline call: all eligible,
    one tile shape, one set of coding parameters (the batch applies the
    FIRST tile's; per-tile COD/QCD overrides drop to the per-tile path)."""
    first = tiles[0]
    shape = first.tile.comps[0].rect
    key = _tcp_device_key(first.tcp)
    return all(_device_eligible(t, decode)
               and t.tile.comps[0].rect.w == shape.w
               and t.tile.comps[0].rect.h == shape.h
               and _tcp_device_key(t.tcp) == key for t in tiles)


def _deltas(tile, reversible: bool) -> tuple:
    """The 9/7 path's quantization steps, ((resno, orient, delta), ...),
    from the tile's first component (_uniform_quant makes them the same
    across components); () on the 5/3 path."""
    if reversible:
        return ()
    return tuple((res.resno, band.orient, float(band.stepsize))
                 for res in tile.comps[0].resolutions for band in res.bands)


def _sp_fits(mesh, tiles) -> bool:
    """Whether the mesh's sp axis can row-shard these uniform tiles."""
    t = tiles[0]
    return pmesh.sp_transform_ok(mesh, t.tile.comps[0].rect.h,
                                 t.tcp.tccps[0].numresolutions)


def _pad_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """(C, B, ...) padded to a multiple of the mesh's dp by repeating the
    last tile (the padding is dropped on gather)."""
    pad = (-x.shape[1]) % pmesh.dp_size(mesh)
    return torch.cat([x, x[:, -1:].expand(-1, pad, *x.shape[2:])], dim=1) \
        if pad else x


def _analyse(tcs: list[TileCompressor], mesh=None) -> None:
    """Device analysis of a uniform batch of tiles, sharded over `mesh`
    when given; installs each tile component's bands (quantized on the
    9/7 path): tensors on the tiles' device for a tile with card Tier-1,
    host int32 arrays otherwise."""
    first = tcs[0]
    comp0 = first.image.comps[0]
    ncomp = len(first.tile.comps)
    reversible = first.tcp.tccps[0].qmfbid == 1

    def plane(t, compno):
        comp = t.image.comps[compno]
        r = t.tile.comps[compno].rect
        # _data_y0: strip-mode encodes hold only a tile row of the plane
        y0 = r.y0 - comp.y0 - getattr(comp, "_data_y0", 0)
        return comp.data[y0:y0 + r.h, r.x0 - comp.x0:r.x1 - comp.x0]

    stack = np.array([[plane(t, c) for t in tcs] for c in range(ncomp)],
                     dtype=np.int32)  # (C, B, H, W)
    x = torch.from_numpy(stack).to(first.device or "cpu")
    kw = dict(numres=first.tcp.tccps[0].numresolutions,
              reversible=reversible, mct=first.tcp.mct, prec=comp0.prec,
              sgnd=comp0.sgnd, deltas=_deltas(first.tile, reversible))
    if mesh is None:
        bands = pipeline.analysis(x, **kw)
    else:  # the summed energy is not used here, as in the reference
        bands, _ = pmesh.sharded_analysis(mesh, _pad_batch(x, mesh), **kw)
        bands = {k: v[:, :len(tcs)] for k, v in bands.items()}
    keep = [t.backend == "device" and _card_t1(t.tcp) for t in tcs]
    host = ({k: v.cpu().numpy() for k, v in bands.items()}
            if not all(keep) else None)
    for bi, t in enumerate(tcs):
        src = bands if keep[bi] else host
        for compno, tc in enumerate(t.tile.comps):
            tc.data = {k: v[compno, bi] for k, v in src.items()}
        t._device_quantized = not reversible
        t._transforms_done = True


def run_transforms_device_batched(tcs: list[TileCompressor],
                                  mesh=None) -> bool:
    """One device analysis over a batch of uniform tiles.  Returns False,
    and does nothing, unless there are two or more tiles (one with an sp
    mesh) and all are eligible with one geometry and one set of coding
    parameters.

    With `mesh`, the tile batch shards over the mesh's "dp" axis (padded
    to a dp multiple by repeating the last tile, the padding dropped on
    gather) and, with sp > 1, each tile's rows over "sp" (halo-exchange
    DWT), so that one tile is a batch too; a tile height that
    sp_transform_ok refuses returns False (the per-tile path)."""
    sp = 1 if mesh is None else pmesh.sp_size(mesh)
    if len(tcs) < (1 if sp > 1 else 2) \
            or not _uniform_batch(tcs):
        return False
    if mesh is not None and not _sp_fits(mesh, tcs):
        return False
    _analyse(tcs, mesh)
    return True


def _synthesise(tds: list["TileDecompressor"],
                defer: bool = False, mesh=None):
    """Device synthesis of a uniform batch of tiles, sharded over `mesh`
    when given: per tile, its component planes.  Bands the Tier-1
    decoders wrote on the device are taken as they are; host bands go up
    (to the mesh from the host where the tiles have no device).  With
    `defer` (one tile, no mesh) the result is a DeferredPlanes with the
    synthesis and its copy back still in flight."""
    first = tds[0]
    comp0 = first.image.comps[0]
    ncomp = len(first.tile.comps)
    reversible = first.tcp.tccps[0].qmfbid == 1
    bands = {}
    for res in first.tile.comps[0].resolutions:
        for band in res.bands:
            key = (res.resno, band.orient)
            if any(t._dev_bands is not None for t in tds):
                bands[key] = torch.stack([torch.stack(
                    [t._device_band((c,) + key) for t in tds])
                    for c in range(ncomp)])
                continue
            stack = np.array(
                [[t._band_arrays[(c,) + key] for t in tds]
                 for c in range(ncomp)], dtype=np.int32)
            bands[key] = torch.from_numpy(stack).to(first.device or "cpu")
    r = first.tile.comps[0].rect
    kw = dict(numres=first.tcp.tccps[0].numresolutions,
              reversible=reversible, mct=first.tcp.mct, prec=comp0.prec,
              sgnd=comp0.sgnd, shape=(r.h, r.w),
              deltas=_deltas(first.tile, reversible))
    if mesh is None:
        out = pipeline.synthesis(bands, **kw)
    else:
        out = pmesh.sharded_synthesis(
            mesh, {k: _pad_batch(v, mesh) for k, v in bands.items()},
            **kw)[:, :len(tds)]
    if defer:
        return DeferredPlanes(out)
    out = out.cpu().numpy()
    return [[out[c, bi] for c in range(ncomp)] for bi in range(len(tds))]


def reconstruct_device_batched(tds: list["TileDecompressor"], mesh=None):
    """Device synthesis over a batch of uniform tiles, sharded over `mesh`
    when given (the mirror of run_transforms_device_batched).  Returns
    {id(td): planes}, or None if the batch is not eligible."""
    sp = 1 if mesh is None else pmesh.sp_size(mesh)
    if len(tds) < (1 if sp > 1 else 2) \
            or not _uniform_batch(tds, decode=True):
        return None
    if mesh is not None and not _sp_fits(mesh, tds):
        return None
    return {id(t): planes
            for t, planes in zip(tds, _synthesise(tds, mesh=mesh))}


# ---------------------------------------------------------------------------
# Decompression
# ---------------------------------------------------------------------------

class DeferredPlanes:
    """One tile's device synthesis, not yet read back, so that host work
    (the next tile's Tier-2 and Tier-1) overlaps it.

    On a CUDA tensor the output is copied with non_blocking=True into a
    pinned host tensor on the current stream, the stream the synthesis
    ran on, and an event is recorded after the copy; materialize() waits
    for that event and returns numpy views of the pinned tensor.  Nothing
    may read the pinned tensor before the event completes: it would give
    stale planes with no error.  On a CPU tensor the planes are already
    computed and materialize() returns them."""

    __slots__ = ("_host", "_event")

    def __init__(self, out: torch.Tensor):
        """`out`: (C, 1, H, W) int32, the synthesis of one tile."""
        if out.is_cuda:
            self._host = torch.empty(out.shape, dtype=out.dtype,
                                     pin_memory=True)
            self._host.copy_(out, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = out
            self._event = None

    def materialize(self) -> list[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        out = self._host.numpy()
        self._host = None
        return [out[c, 0] for c in range(out.shape[0])]


class TileDecompressor:
    """`device` and `backend` as for TileCompressor."""

    def __init__(self, tile: Tile, tcp: TileCodingParams, image,
                 cp: CodingParams, device: torch.device | None,
                 backend: str = "native", reduce: int = 0,
                 max_layers: int = 0, window: Rect | None = None,
                 pkt_lens: list[int] | None = None, num_threads: int = 0):
        self.device = device
        self.tile = tile
        self.tcp = tcp
        self.image = image
        self.cp = cp
        self.backend = backend
        self.reduce = reduce
        self.max_layers = max_layers
        self.window = window  # canvas-coords decode region or None
        self.pkt_lens = pkt_lens  # PLT index: per-packet byte lengths
        self.num_threads = num_threads  # -H parity: native pool size
        # device band tensors the HT decoder writes (see run_t1), or None
        self._dev_bands = None

    def _packet_needed(self, pc) -> bool:
        """Does this packet contribute to the requested decode?  False only
        for packets that are provably irrelevant: reduced-away resolutions,
        discarded layers, and precincts disjoint from the decode window.
        Skipping a whole precinct (or a tail of layers) never desyncs the
        remaining headers: Tier-2 state is per-precinct and layer-monotone."""
        tccp = self.tcp.tccps[pc.compno]
        numres_used = max(1, tccp.numresolutions - self.reduce)
        if pc.resno >= numres_used:
            return False
        if self.max_layers and pc.layno >= self.max_layers:
            return False
        if self.window is None:
            return True
        prc = self.tile.comps[pc.compno].resolutions[pc.resno].precincts[
            pc.precno]
        for pband in prc.pbands:
            if not pband.cblks:
                continue
            wrect = self._window_band_rect(pc.compno, pc.resno,
                                           pband.band_orient)
            if wrect is None:
                return True
            if not pband.rect.intersect(wrect).is_empty():
                return True
        return False

    def decode_packets(self, data: bytes, sop=False, eph=False,
                       strict=False) -> None:
        comp_info = [(c.dx, c.dy, self.tcp.tccps[i].numresolutions)
                     for i, c in enumerate(self.image.comps)]
        # every decodable packet costs >= 1 byte inline (>= 1 header bit
        # under PPT), so the stream size bounds the packets worth
        # enumerating — a corrupt COD signaling 65535 layers must not
        # cost millions of coords for a tiny tile-part (fuzz-found)
        ppt = self.tcp.ppt_data
        cap = len(data) + 8 * len(ppt or b"") + 64
        # packet order is a pure function of pooled-tile geometry plus
        # these coding params — cache it on the tile (throughput decodes
        # re-enumerate the same order every frame otherwise)
        okey = (int(self.tcp.prog_order), self.tcp.numlayers,
                tuple((ch.res_s, ch.comp_s, ch.lay_e, ch.res_e, ch.comp_e,
                       int(ch.prog))
                      for ch in (self.tcp.progression_changes or ())),
                tuple(comp_info))
        cached = getattr(self.tile, "_t2_order_cache", None)
        order = None
        if cached is not None and cached[0] == okey and \
                (not cached[2] or len(cached[1]) >= cap):
            order = cached[1]
        if order is None:
            order = t2.packet_order(self.tile, self.tcp, comp_info,
                                    max_packets=cap)
            self.tile._t2_order_cache = (okey, order, len(order) >= cap)
        pos = 0
        hdr_pos = 0
        # PLT-guided packet skipping needs inline headers (with PPT the
        # header stream has no length index) and a plausible PLT
        plt = self.pkt_lens if ppt is None and self.pkt_lens and \
            len(self.pkt_lens) >= len(order) else None
        if (t2._native is not None and not sop and not eph
                and ppt is None and self.window is None
                and not self.reduce and not self.max_layers
                and order and len(data) < (1 << 31)
                and self._decode_packets_seq(data, order)):
            return
        resume_at = -1
        check_nsop = sop and ppt is None
        for n, pc in enumerate(order):
            if n < resume_at:
                continue  # packets lost to a corrupt span (SOP resync)
            tc = self.tile.comps[pc.compno]
            tccp = self.tcp.tccps[pc.compno]
            res = tc.resolutions[pc.resno]
            band_numbps = {b.orient: b.numbps for b in res.bands}
            if pos >= len(data):
                break  # tolerant: truncated tile data
            if plt is not None and not self._packet_needed(pc):
                pos += plt[n]  # skip without parsing (O(region) path)
                self._skipped_packets = getattr(
                    self, "_skipped_packets", 0) + 1
                continue
            discard = bool(self.max_layers) and pc.layno >= self.max_layers
            mixed = tccp.ht and getattr(self.cp, "ht_mixed", False)
            prev_pos = pos
            try:
                pos, hdr_pos = t2.decode_packet(
                    data, pos, res, pc.precno, pc.layno,
                    tccp.cblk_style, band_numbps, sop=sop, eph=eph,
                    hdr_data=ppt, hdr_pos=hdr_pos, discard=discard,
                    mixed=mixed, sop_index=n if check_nsop else -1)
                if pos < prev_pos:
                    # a smashed header can "parse" into garbage segment
                    # lengths whose sum wraps the position backwards —
                    # flag THIS packet as the corrupt one (pos beyond
                    # len(data) is plain truncation, handled tolerantly
                    # by the bounds check above)
                    raise ValueError(
                        f"packet consumed implausible span "
                        f"{prev_pos}->{pos}")
            except Exception as e:
                pos = prev_pos  # failed packet's start anchors the scan
                if strict or not sop:
                    raise
                if ppt is not None:
                    # packed headers: the PPT/PPM header-stream position
                    # is lost with the failed packet (headers carry no
                    # length index), so resuming at a later body SOP
                    # would pair bodies with stale headers — abandon the
                    # tile remainder instead
                    log.warning("packet %d parse error (%s); packed "
                                "headers preclude SOP resync", n, e)
                    break
                # mid-tile SOP resynchronization (SURVEY.md §5
                # "error-resilience coding options"): scan forward for
                # the next SOP whose Nsop is consistent with a packet
                # still ahead, resume the iterator at exactly that
                # packet (already-attached segments stay attached), and
                # skip the lost span.  Scanning starts AT pos: when the
                # marker here is valid but carries a later Nsop (packets
                # lost upstream), it is itself the resync point.
                r = t2.find_sop_resync(data, pos, n, len(order))
                log.warning(
                    "packet %d parse error (%s); SOP resync -> %s",
                    n, e, "none" if r is None else
                    f"packet {r[1]} at offset {r[0]}")
                if r is None:
                    break
                pos, resume_at = r

    def _seq_state(self, order, nat):
        """Per-packet/per-codeblock arrays for grk_t2_decode_seq.  Pure
        function of the pooled tile's geometry, the packet order, and
        the coding params in the key below — cached on the tile object
        (native handles, their ptrs, and the codeblock objects all share
        the pooled tile's lifetime).  `order` is compared by identity:
        it comes from the tile's own order cache, so a hit there makes
        a hit here; a rebuilt order rebuilds this too."""
        skey = (getattr(self.cp, "ht_mixed", False),
                tuple((int(t.cblk_style), bool(t.ht))
                      for t in self.tcp.tccps),
                tuple(b.numbps for tc in self.tile.comps
                      for res in tc.resolutions for b in res.bands))
        cached = getattr(self.tile, "_t2_seq_cache", None)
        if cached is not None and cached[0] == skey and cached[1] is order:
            return cached[2]
        handles_by_prc: dict = {}
        handles: list = []
        cblk_by_g: list = []
        npk = len(order)
        prc_a = np.empty(npk, np.uint64)
        lay_a = np.empty(npk, np.int32)
        sty_a = np.empty(npk, np.int32)
        mix_a = np.empty(npk, np.int32)
        mb_a = np.empty(npk, np.uint64)
        base_a = np.empty(npk, np.int32)
        base = 0
        ht_mixed = skey[0]
        # the tile's decode BlockTable (t1/tile_batch.py), for
        # grk_t1_decode_tile and the flat route, built alongside (same
        # global-g order): h/w, orient/style/mb/band_id, flags, dest
        # offset in the (window-less) band array
        band_ids: dict = {}
        band_shape: dict = {}
        rows: list = []
        for n, pc in enumerate(order):
            tc = self.tile.comps[pc.compno]
            tccp = self.tcp.tccps[pc.compno]
            res = tc.resolutions[pc.resno]
            prc = res.precincts[pc.precno]
            ent = handles_by_prc.get(id(prc))
            if ent is None:
                h = nat.get_handle(prc)
                bn = {b.orient: b.numbps for b in res.bands}
                brect = {b.orient: b.rect for b in res.bands}
                mb = np.asarray([bn[pb.band_orient] for pb in prc.pbands],
                                dtype=np.int32)
                ent = handles_by_prc[id(prc)] = (
                    base, h, mb, bool(tccp.ht and ht_mixed))
                handles.append((base, h, mb.tolist(),
                                bool(tccp.ht and ht_mixed)))
                cblk_by_g.extend(h.cblks)
                mbl = mb.tolist()
                style = int(tccp.cblk_style)
                flags = (1 if tccp.ht else 0) | \
                    (2 if (tccp.ht and ht_mixed) else 0)
                for i, cblk in enumerate(h.cblks):
                    bi = h.cblk_band[i]
                    orient = prc.pbands[bi].band_orient
                    r = brect[orient]
                    bkey = (pc.compno, pc.resno, orient)
                    if bkey not in band_ids:
                        band_ids[bkey] = len(band_ids)
                        band_shape[bkey] = (r.h, r.w)
                    cr = cblk.rect
                    rows.append((cr.h, cr.w, orient, style, mbl[bi],
                                 band_ids[bkey], flags,
                                 (cr.y0 - r.y0) * r.w + (cr.x0 - r.x0)))
                base += h.ncb
            b, h, mb, _mx = ent
            prc_a[n] = h.ptr
            lay_a[n] = pc.layno
            sty_a[n] = int(tccp.cblk_style)
            mix_a[n] = 1 if (tccp.ht and ht_mixed) else 0
            mb_a[n] = mb.__array_interface__["data"][0]
            base_a[n] = b
        table = tile_batch.BlockTable.from_rows(
            rows, list(band_ids), list(band_shape.values()), np.int32)
        state = (prc_a, lay_a, sty_a, mix_a, mb_a, base_a, max(base, 1),
                 cblk_by_g, handles, table)
        # keep the mb arrays alive alongside the pointers in mb_a
        self.tile._t2_seq_cache = (skey, order, state,
                                   [e[2] for e in handles_by_prc.values()])
        return state

    def _decode_packets_seq(self, data, order) -> bool:
        """Whole-tile native packet-sequence decode (the band-batched
        run_t1 roadmap item, decode side): one C call parses every
        inline packet header and body range (grk_t2_decode_seq) into
        compact chunk records, which the whole-tile Tier-1 routes read as
        they are and the per-codeblock route mirrors into the codeblocks
        (_mirror_seq).  Only the common case routes here (no SOP/EPH/
        PPT, no window/reduce/layer skipping — the caller gates); a
        malformed header mid-sequence resets the native precinct state
        and returns False so the per-packet path reruns from scratch
        with identical behavior."""
        import ctypes as ct

        nat = t2._native
        (prc_a, lay_a, sty_a, mix_a, mb_a, base_a, ncb_total, cblk_by_g,
         handles, table) = self._seq_state(order, nat)
        npk = len(order)
        g_zb = np.zeros(ncb_total, np.int32)
        g_isht = np.zeros(ncb_total, np.int32)
        g_newly = np.zeros(ncb_total, np.int32)
        dview = np.frombuffer(data, dtype=np.uint8) if len(data) else \
            np.zeros(1, np.uint8)
        addr = nat._addr
        pos_io = ct.c_long(0)
        recs_p = ct.POINTER(ct.c_int32)()
        nrec = ct.c_long(0)
        rc = nat._lib.grk_t2_decode_seq(
            addr(prc_a), addr(lay_a), addr(sty_a),
            addr(mix_a), addr(mb_a), addr(base_a), npk,
            addr(dview), len(data), ct.byref(pos_io),
            addr(g_zb), addr(g_isht), addr(g_newly),
            ct.byref(recs_p), ct.byref(nrec))
        if rc < 0:
            # malformed header mid-sequence: rewind the native state and
            # let the per-packet path replay from scratch (it raises /
            # resyncs exactly as before, mirroring earlier packets)
            for b, h, mbl, mx in handles:
                h.reset()
            return False
        n = int(nrec.value)
        recs = (np.ctypeslib.as_array(recs_p, shape=(n * 4,)).copy() if n
                else np.empty(0, np.int32))
        # run_t1's whole-tile paths consume these records (plus the stream
        # bytes) instead of re-walking the codeblock objects; the
        # per-codeblock route mirrors them first (_mirror_seq)
        self._seq_result = (recs, data, g_zb, g_isht, ncb_total, table,
                            cblk_by_g)
        self._seq_mirror = (handles, g_newly)
        return True

    def _mirror_seq(self) -> None:
        """Mirror a packet-sequence decode into the codeblocks' decoder
        state (first inclusion, codeword segments in arrival order), which
        the per-codeblock Tier-1 route reads; the whole-tile routes read
        the records and never call this."""
        mirror = getattr(self, "_seq_mirror", None)
        if mirror is None:
            return
        self._seq_mirror = None
        handles, g_newly = mirror
        recs, data, g_zb, g_isht, _, _, cblk_by_g = self._seq_result
        # first-inclusion state: touched codeblocks only (bulk tolist —
        # per-element numpy scalar reads dominate otherwise)
        zb_l = g_zb.tolist()
        newly_l = g_newly.tolist()
        isht_l = g_isht.tolist()
        for b, h, mbl, mx in handles:
            for i in np.flatnonzero(g_newly[b:b + h.ncb]).tolist():
                cblk = h.cblks[i]
                g = b + i
                cblk.zero_bitplanes = zb_l[g]
                cblk.numbps = mbl[h.cblk_band[i]] - zb_l[g]
                cblk.included_in_layer = newly_l[g] - 1
                cblk.lblock = 3
                if mx:
                    cblk.is_ht = bool(isht_l[g])
        # codeword segments, in arrival order
        if len(recs):
            mv = memoryview(data)
            rl = recs.tolist()
            for r in range(0, len(rl), 4):
                cblk = cblk_by_g[rl[r]]
                np_ = rl[r + 1]
                off = rl[r + 2]
                cblk.seg_data.append(mv[off:off + rl[r + 3]])
                cblk.seg_passes.append(np_)
                cblk.total_passes += np_

    def _window_produce(self, compno: int) -> dict | None:
        """Per-resolution rects the window-aware synthesis reconstructs for
        this component (SURVEY.md §3.3 region decode), cached."""
        if self.window is None:
            return None
        cache = getattr(self, "_produce_cache", None)
        if cache is None:
            cache = self._produce_cache = {}
        if compno in cache:
            return cache[compno]
        comp = self.image.comps[compno]
        tccp = self.tcp.tccps[compno]
        tc = self.tile.comps[compno]
        numres_used = max(1, tccp.numresolutions - self.reduce)
        max_res = numres_used - 1
        nl = tccp.numresolutions - 1
        w = self.window
        div = 1 << (nl - max_res)
        win_res = Rect((w.x0 // comp.dx) // div, (w.y0 // comp.dy) // div,
                       -(-(-(-w.x1 // comp.dx)) // div),
                       -(-(-(-w.y1 // comp.dy)) // div))
        produce = dwt_mod.window_produce_rects(
            tc.rect, tccp.numresolutions, tccp.qmfbid == 1, win_res,
            max_res=max_res)
        cache[compno] = produce
        return produce

    def _window_band_rect(self, compno: int, resno: int,
                          orient: int) -> Rect | None:
        """Decode-window rect in band coordinates — exactly what the
        window-aware inverse DWT will read, so Tier-1 skip and band
        allocation stay consistent with the synthesis crops."""
        produce = self._window_produce(compno)
        if produce is None:
            return None
        if resno not in produce and resno - 1 not in produce:
            return Rect(0, 0, 0, 0)  # above max_res (reduced away)
        return dwt_mod.window_band_rect(produce, resno)

    def run_t1(self) -> None:
        # band arrays first (doubled-domain; conversion to final sample
        # values happens in reconstruct()) so the native backends can
        # decode straight into them — no per-codeblock paste copies.
        # With a decode window the arrays cover only the window's span of
        # each band (SURVEY.md §2.1 SparseBuffer role: O(window) memory).
        with span("grk/decode/t1_jobs"):
            self._alloc_band_arrays()
        self._dev_bands = None
        with span("grk/decode/t1"):
            if self._run_t1_tile_native():
                return
        with span("grk/decode/t1_jobs"):
            jobs, meta = self._decode_jobs()
        with span("grk/decode/t1"):
            t1_backend.decode_batch(jobs, self.backend,
                                    getattr(self, 'num_threads', 0),
                                    device=self.device)
        with span("grk/decode/t1_ingest"):
            self._ingest_decoded(jobs, meta)

    def _decode_jobs(self):
        """The tile's Tier-1 decode jobs and, for each, its band's key and
        its rect; on a card Tier-1 tile also `_dev_bands`, the device bands
        the decoders write into.  Where the tile's blocks decode on the
        device as flat arrays (_flat_tile_decode) the jobs are one
        t1_backend.HTDecodeTile or MQDecodeTile, with keys and rects for
        its host jobs."""
        if self._card_tile():
            # the device decoders write into these; the synthesis takes
            # them
            self._alloc_dev_bands()
            flat = self._flat_tile_decode()
            if flat is not None:
                return flat
        self._mirror_seq()
        jobs = []
        meta = []
        mixed = getattr(self.cp, "ht_mixed", False)
        for tc in self.tile.comps:
            tccp = self.tcp.tccps[tc.compno]
            numres_used = max(1, tccp.numresolutions - self.reduce)
            for res in tc.resolutions[:numres_used]:
                for bi, band in enumerate(res.bands):
                    wrect = self._window_band_rect(
                        tc.compno, res.resno, band.orient)
                    if wrect is not None and wrect.is_empty():
                        continue  # whole band outside the decode window
                    key = (tc.compno, res.resno, band.orient)
                    arr = self._band_arrays[key]
                    crop = self._band_offsets[key]
                    direct_ok = not tccp.roi_shift
                    style = tccp.cblk_style
                    band_ht = tccp.ht
                    orient = band.orient
                    for prc in res.precincts:
                        pband = prc.pbands[bi]
                        if wrect is not None and \
                                pband.rect.intersect(wrect).is_empty():
                            continue  # whole precinct outside the window
                        for cblk in pband.cblks:
                            if cblk.total_passes <= 0 or cblk.rect.is_empty():
                                continue
                            if wrect is not None and \
                                    cblk.rect.intersect(wrect).is_empty():
                                continue  # outside decode window: skip T1
                            data, seg_lens, npasses = t2.collect_seg_lengths(
                                cblk, style)
                            block_ht = band_ht and (
                                getattr(cblk, "is_ht", True)
                                if mixed else True)
                            job = t1_backend.DecodeJob(
                                data, seg_lens, npasses, cblk.numbps,
                                cblk.rect.h, cblk.rect.w, orient,
                                style, ht=block_ht)
                            if direct_ok and crop.contains(cblk.rect):
                                job.out_dest = arr[
                                    cblk.rect.y0 - crop.y0:
                                    cblk.rect.y1 - crop.y0,
                                    cblk.rect.x0 - crop.x0:
                                    cblk.rect.x1 - crop.x0]
                            if self._dev_bands is not None:
                                job.out_device = self._dev_bands[key][
                                    cblk.rect.y0 - crop.y0:
                                    cblk.rect.y1 - crop.y0,
                                    cblk.rect.x0 - crop.x0:
                                    cblk.rect.x1 - crop.x0]
                            jobs.append(job)
                            meta.append((key, cblk.rect))
        return jobs, meta

    def _alloc_dev_bands(self) -> None:
        """`_dev_bands`: a zeroed device tensor a band, as views of one
        allocation."""
        shapes = [a.shape for a in self._band_arrays.values()]
        sizes = [h * w for h, w in shapes]
        flat = torch.zeros(sum(sizes), dtype=torch.int32, device=self.device)
        self._dev_bands = {
            k: t.view(shape) for k, t, shape in zip(
                self._band_arrays, flat.split(sizes), shapes)}

    def _flat_tile_decode(self):
        """The card route of a `_card_tile` as one flat batch
        (t1/tile_batch.py decode_tile) and the keys and rects of its host
        jobs, decoded into the host band arrays; or None where the tile
        keeps the per-codeblock route: its components are not all HT (not
        ht_mixed) or all MQ in one layer, the sequence decode did not run
        (_seq_result) or its band arrays lack the table's shapes."""
        seq = getattr(self, "_seq_result", None)
        tccps = self.tcp.tccps
        ht = all(t.ht for t in tccps)
        if (seq is None or getattr(self.cp, "ht_mixed", False)
                or (not ht and (any(t.ht for t in tccps)
                                or self.tcp.numlayers != 1))):
            return None
        recs, data, g_zb, _, _, table, cblk_by_g = seq
        arrs = self._band_arrays
        if any(arrs.get(k) is None or arrs[k].shape != shape
               for k, shape in zip(table.band_keys, table.band_shape)):
            return None
        got = tile_batch.decode_tile(
            table, recs, data, g_zb,
            [self._dev_bands[k] for k in table.band_keys], self.device)
        if got is None:
            return None
        t, host = got
        # each host block's chunks, in arrival order
        r = recs.reshape(-1, 4)
        r = r[np.argsort(r[:, 0], kind="stable")]
        lo = np.searchsorted(r[:, 0], host).tolist()
        hi = np.searchsorted(r[:, 0], host, side="right").tolist()
        mv = memoryview(data)
        meta = []
        for gg, first, end in zip(host.tolist(), lo, hi):
            bi, y, x, h, w, orient, sty, mb = table.cols[gg].tolist()
            part = r[first:end].tolist()
            nb = mb - int(g_zb[gg])
            seg = t2.collect_seg_lengths(SimpleNamespace(
                total_passes=sum(p[1] for p in part), numbps=nb,
                seg_data=[mv[p[2]:p[2] + p[3]] for p in part],
                seg_passes=[p[1] for p in part]), CblkStyle(sty))
            job = t1_backend.DecodeJob(*seg, nb, h, w, orient,
                                       CblkStyle(sty), ht=ht)
            key = table.band_keys[bi]
            job.out_dest = arrs[key][y:y + h, x:x + w]
            t.host.append(job)
            meta.append((key, cblk_by_g[gg].rect))
        return t, meta

    def _ingest_decoded(self, jobs, meta) -> None:
        """The blocks the host coder decoded, into the band arrays (and
        up to the device bands on a card Tier-1 tile)."""
        if isinstance(jobs, (t1_backend.HTDecodeTile,
                             t1_backend.MQDecodeTile)):
            jobs = jobs.host
        for job, (key, rect) in zip(jobs, meta):
            if job.device_done:
                continue  # a device decoder wrote the device band
            arr = self._band_arrays[key]
            crop = self._band_offsets[key]
            if self._dev_bands is not None:
                # a block the host coder decoded goes up on its own (the
                # device tiles have no window, crop or ROI)
                rows = slice(rect.y0 - crop.y0, rect.y1 - crop.y0)
                cols = slice(rect.x0 - crop.x0, rect.x1 - crop.x0)
                if not job.direct_done:
                    arr[rows, cols] = job.out
                self._dev_bands[key][rows, cols].copy_(
                    torch.from_numpy(arr[rows, cols]))
                continue
            if job.direct_done:
                continue  # native backend wrote the band array in place
            out = job.out
            shift = self.tcp.tccps[key[0]].roi_shift
            if shift:
                # max-shift ROI: values at/above 2^shift are ROI samples;
                # downshift them (operating in the doubled domain)
                mag = np.abs(out)
                is_roi = mag >= (1 << (shift + 1))
                mag = np.where(is_roi, mag >> shift, mag)
                out = np.where(out < 0, -mag, mag).astype(np.int32)
            # clipped paste: an intersecting codeblock may extend past the
            # window crop
            ix = rect.intersect(crop)
            if ix.is_empty():
                continue
            arr[ix.y0 - crop.y0:ix.y1 - crop.y0,
                ix.x0 - crop.x0:ix.x1 - crop.x0] = \
                out[ix.y0 - rect.y0:ix.y1 - rect.y0,
                    ix.x0 - rect.x0:ix.x1 - rect.x0]

    def _run_t1_tile_native(self) -> bool:
        """Whole-tile native Tier-1 decode (grk_t1_decode_tile): consume
        the packet-sequence chunk records straight from the stream —
        segment regrouping, byte gather, job build, and the MQ/HT batch
        dispatch all happen in one C call writing into the band arrays.
        Requires a successful _decode_packets_seq (which already implies
        no window/reduce/layer caps), the native backend, and no ROI
        upshift (ROI post-processing stays in the fallback loop)."""
        seq = getattr(self, "_seq_result", None)
        if seq is None or self.window is not None or self.reduce:
            return False
        if t1_backend.resolve(self.backend) != "native":
            return False
        if self.backend == "device" and _card_t1(self.tcp):
            return False  # blocks decode on the device
        if any(t.roi_shift for t in self.tcp.tccps):
            return False
        recs, data, g_zb, g_isht, ncb_total, table, _ = seq
        if len(table) != ncb_total:
            return False
        nb = len(table.band_keys)
        band_base = np.empty(nb, np.uint64)
        band_stride = np.empty(nb, np.int32)
        for i, (key, shape) in enumerate(zip(table.band_keys,
                                             table.band_shape)):
            arr = self._band_arrays.get(key)
            if arr is None or arr.shape != shape:
                return False  # windowed/cropped alloc: fallback
            band_base[i] = arr.__array_interface__["data"][0]
            band_stride[i] = shape[1]
        nat = t2._native
        addr = nat._addr
        dview = np.frombuffer(data, dtype=np.uint8) if len(data) else \
            np.zeros(1, np.uint8)
        rc = nat._lib.grk_t1_decode_tile(
            addr(recs) if len(recs) else 0, len(recs) // 4,
            addr(dview), len(data), ncb_total,
            addr(table.hw), addr(table.meta), addr(table.flags),
            addr(table.off),
            addr(g_zb), addr(g_isht), addr(band_base), addr(band_stride),
            getattr(self, "num_threads", 0))
        return rc >= 0

    def _card_tile(self) -> bool:
        """Whether the device decoders write this tile's bands on the
        device (`_dev_bands`) and the synthesis takes them there."""
        return (self.backend == "device" and self.device is not None
                and _card_t1(self.tcp) and _device_eligible(self, True))

    def _alloc_band_arrays(self) -> None:
        """Zeroed host band arrays, each cropped to the decode window.  On
        a card tile only the blocks the host coder decodes land in them,
        so they are views of one allocation, large enough that its pages
        are zeroed where they are first touched, not all up front."""
        self._band_offsets = {}
        for tc in self.tile.comps:
            tccp = self.tcp.tccps[tc.compno]
            numres_used = max(1, tccp.numresolutions - self.reduce)
            for res in tc.resolutions[:numres_used]:
                for band in res.bands:
                    crop = band.rect
                    wrect = self._window_band_rect(
                        tc.compno, res.resno, band.orient)
                    if wrect is not None:
                        crop = band.rect.intersect(wrect)
                    key = (tc.compno, res.resno, band.orient)
                    self._band_offsets[key] = crop
        shapes = [(max(0, c.h), max(0, c.w))
                  for c in self._band_offsets.values()]
        if self._card_tile():
            sizes = [h * w for h, w in shapes]
            parts = np.split(np.zeros(sum(sizes), np.int32),
                             np.cumsum(sizes)[:-1])
            self._band_arrays = {k: a.reshape(shape) for k, a, shape in zip(
                self._band_offsets, parts, shapes)}
        else:
            self._band_arrays = {k: np.zeros(shape, np.int32) for k, shape
                                 in zip(self._band_offsets, shapes)}

    def _device_band(self, key) -> torch.Tensor:
        if self._dev_bands is not None:
            return self._dev_bands[key]
        return torch.from_numpy(self._band_arrays[key]).to(self.device)

    def reconstruct_device(self, defer: bool = False):
        """Device synthesis of this tile: per-component planes, or None if
        the tile is not eligible.  With defer=True the result is a
        DeferredPlanes whose synthesis and copy back are still in flight
        on the card, so the caller can run the NEXT tile's host entropy
        stages meanwhile (decode-side StripCache-overlap parity)."""
        if self.device is None or not _device_eligible(self, True):
            return None
        if defer:
            return _synthesise([self], defer=True)
        return _synthesise([self])[0]

    def reconstruct(self, defer: bool = False):
        """Inverse DWT + MCT + DC shift; returns per-component planes at the
        reduced resolution (a DeferredPlanes for a deferred device tile).
        With a decode window set, the synthesis is window-aware: only the
        produce-chain spans are lifted (SURVEY.md §3.3) and the planes
        cover just the window (self._out_rects)."""
        planes = self.reconstruct_device(defer=defer)
        if planes is not None:
            return planes
        HOST_PATH_TILES["decode"] += 1
        planes = []
        tcp = self.tcp
        self._out_rects = []
        for tc in self.tile.comps:
            tccp = tcp.tccps[tc.compno]
            reversible = tccp.qmfbid == 1
            numres_used = max(1, tccp.numresolutions - self.reduce)
            # Whole-image decodes hand inverse_dwt the raw doubled-domain
            # band arrays: the (v - (v >> 31)) >> 1 halving (reversible) or
            # the * float32(0.5 * Delta_b) dequantization (irreversible)
            # is fused into the native lifting's band loads (window
            # decodes crop through _merge_2d, which needs value-domain
            # inputs).
            fuse_halve = reversible and self.window is None
            fuse_dq = not reversible and self.window is None
            deltas = {} if fuse_dq else None
            bands = {}
            for res in tc.resolutions[:numres_used]:
                for band in res.bands:
                    doubled = self._band_arrays[
                        (tc.compno, res.resno, band.orient)]
                    if fuse_halve or fuse_dq:
                        vals = doubled
                        if fuse_dq:
                            deltas[(res.resno, band.orient)] = float(
                                band.stepsize)
                    elif reversible:
                        vals = dwt_mod._halve_doubled(doubled)
                    else:
                        vals = quant_mod.dequantize(
                            doubled, band.stepsize)
                    bands[(res.resno, band.orient)] = vals
            if self.window is not None:
                produce = self._window_produce(tc.compno)
                offsets = {
                    (res.resno, band.orient):
                        self._band_offsets[(tc.compno, res.resno,
                                            band.orient)]
                    for res in tc.resolutions[:numres_used]
                    for band in res.bands}
                out = dwt_mod.inverse_dwt_window(
                    bands, offsets, tc.rect, tccp.numresolutions,
                    reversible, produce, max_res=numres_used - 1)
                self._out_rects.append(produce[numres_used - 1])
            else:
                out = dwt_mod.inverse_dwt(
                    bands, tc.rect, tccp.numresolutions,
                    reversible, max_res=numres_used - 1,
                    doubled=fuse_halve, deltas=deltas)
                self._out_rects.append(
                    tc.resolutions[numres_used - 1].rect)
            planes.append(out)
        mct_shapes_ok = (len(planes) >= 3 and
                         planes[0].shape == planes[1].shape
                         == planes[2].shape)
        done3 = False
        if tcp.mct == 1 and len(planes) >= 3 and not mct_shapes_ok:
            # corrupt per-component COD/SIZ can leave the three planes on
            # different grids (fuzz-found); skipping the MCT beats a
            # broadcast crash in tolerant mode
            log.warning("inverse MCT skipped: component planes differ "
                        "in shape")
        elif tcp.mct == 1 and len(planes) >= 3:
            # fused native inverse MCT + rint + DC unshift + clip (one
            # pass over the triple instead of 8+ numpy plane passes)
            precs = tuple(self.image.comps[i].prec for i in range(3))
            sgnds = tuple(self.image.comps[i].sgnd for i in range(3))
            fn = (mct_mod.rct_inverse_shift if tcp.tccps[0].qmfbid == 1
                  else mct_mod.ict_inverse_shift)
            planes[0], planes[1], planes[2] = fn(
                planes[0], planes[1], planes[2], precs, sgnds)
            done3 = True
        elif tcp.mct == 2 and tcp.mct_dec_matrix is not None:
            # Part-2 wire convention: MCT carries the DECODING matrix and
            # the offset array carries the post-transform DC offsets (they
            # replace the standard DC level shift for those components)
            dec = tcp.mct_dec_matrix
            n = dec.shape[0]
            planes[:n] = mct_mod.matrix_forward(planes[:n], dec)
            if tcp.mct_offsets is not None:
                for i in range(n):
                    comp = self.image.comps[i]
                    std = 0 if comp.sgnd else 1 << (comp.prec - 1)
                    delta = int(tcp.mct_offsets[i]) - std
                    if delta:
                        planes[i] = planes[i] + delta
        elif tcp.mct == 2 and tcp.mct_matrix is not None:
            n = tcp.mct_matrix.shape[0]
            planes[:n] = mct_mod.matrix_inverse(planes[:n], tcp.mct_matrix)
        # DC unshift + rounding + clamp (native-fused single pass)
        out_planes = []
        for compno, p in enumerate(planes):
            if done3 and compno < 3:
                out_planes.append(p)  # fused path already finalized
                continue
            comp = self.image.comps[compno]
            out_planes.append(
                mct_mod.shift_round_clip(p, comp.prec, comp.sgnd))
        return out_planes
