"""Codestream compression driver.

Parity: CodeStreamCompress (SURVEY.md §2.1 "Codestream compress",
src/lib/core/codestream/CodeStreamCompress.cpp [P]): writes the main header
(SOC SIZ [CAP] COD [COC] QCD [QCC] [POC] [COM] [RGN]), drives per-tile
compression, emits tile-parts (SOT..SOD..data), rewrites TLM at the end,
terminates with EOC.

grok_tpu's driver with the port's tile processor: with a device, all
uniform full-size tiles go through one batched device analysis (a tile
row at a time under a strip reader), and each tile's card Tier-1
codeblocks through one launch of the device encoder.  With a mesh
(parallel/mesh.py) that batch's transforms shard over its devices, on
the host route too; Tier-1 and Tier-2 stay where they run without one.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from ..errors import ParamError
from ..image import GrkImage
from ..params import (
    CblkStyle,
    CodingParams,
    CompressParams,
    Profile,
    QuantStyle,
    TileCodingParams,
    TileComponentCodingParams,
)
from ..tile.geometry import Rect, tile_rect
from ..tile.processor import (TileCompressor, acquire_tile, host_backend,
                              release_tile, run_transforms_device_batched)
from ..trace import span
from ..transform import mct as mct_mod
from ..transform import quant as quant_mod
from . import markers as mk

log = logging.getLogger("grok_tpu_torch")


def setup_coding_params(image: GrkImage, p: CompressParams) -> CodingParams:
    from . import profiles

    profiles.apply_profile(p, image)
    p.validate()
    cp = CodingParams()
    cp.rsiz = int(p.profile)
    if Profile.BC_SINGLE.value <= int(p.profile) <= Profile.IMF_8K_R.value:
        # Broadcast/IMF: mainlevel in Rsiz bits 0-3, IMF sublevel bits 4-7
        cp.rsiz |= (p.profile_level & 0xF)
        if int(p.profile) >= Profile.IMF_2K.value:
            cp.rsiz |= (p.profile_sublevel & 0xF) << 4
    if p.ht:
        cp.rsiz |= int(Profile.PART15)
        cp.ht = True
        cp.ht_mixed = p.ht_mixed
    if p.tile_size:
        cp.t_width, cp.t_height = p.tile_size
        cp.tx0, cp.ty0 = p.tile_offset
        # ISO 15444-1: XTOsiz <= XOsiz and XTOsiz + XTsiz > XOsiz so the
        # tile grid covers the image starting at the first tile
        if cp.tx0 > image.x0 or cp.ty0 > image.y0:
            raise ParamError(
                f"tile offset ({cp.tx0},{cp.ty0}) must not exceed the "
                f"image offset ({image.x0},{image.y0})")
        if cp.tx0 + cp.t_width <= image.x0 or \
                cp.ty0 + cp.t_height <= image.y0:
            raise ParamError("first tile does not intersect the image")
    else:
        cp.tx0, cp.ty0 = 0, 0
        cp.t_width = image.x1 - cp.tx0
        cp.t_height = image.y1 - cp.ty0
    cp.t_grid_w = -(-(image.x1 - cp.tx0) // cp.t_width)
    cp.t_grid_h = -(-(image.y1 - cp.ty0) // cp.t_height)

    numlayers = p.numlayers
    if p.layer_rates:
        numlayers = len(p.layer_rates)
    elif p.layer_psnr:
        numlayers = len(p.layer_psnr)

    mct = p.mct
    if p.custom_mct is not None:
        mct = 2
    elif mct is None:
        mct = 1 if image.numcomps >= 3 and all(
            c.dx == image.comps[0].dx and c.dy == image.comps[0].dy
            and c.prec == image.comps[0].prec
            for c in image.comps[:3]) else 0
    reversible = not p.irreversible
    guard = p.num_guard_bits if p.num_guard_bits is not None else 2

    # Adaptive base step for byte-targeted irreversible encodes: at
    # ratios >= ~8:1 the PCRD truncation point sits far above the
    # quantizer floor, so the ecosystem-default fine steps only generate
    # deep coding passes the cap immediately discards (measured: PSNR at
    # 10:1..80:1 is IDENTICAL with 2-4x coarser steps, while Tier-1 does
    # ~2x the work with fine ones).  Explicit quant_step/quant_style and
    # -q quality targets keep the fine default untouched.
    quant_step = p.quant_step
    if (p.irreversible and quant_step == 0.0 and p.quant_style is None
            and not p.layer_psnr):
        min_ratio = 0.0
        if p.layer_rates:
            # a rate <= 1.0 means "no truncation" (params.py): that
            # layer's quality is bounded by the quantizer alone, so the
            # fine default must stay
            if all(r > 1.0 for r in p.layer_rates):
                min_ratio = min(p.layer_rates)
        elif p.max_cs_size > 0:
            # same raw-size definition as the rate-control budget below
            # (actual component plane shapes, not image-rect division)
            raw = sum(c.h * c.w * c.prec for c in image.comps) / 8.0
            min_ratio = raw / p.max_cs_size
        if min_ratio >= 24.0:
            quant_step = 4.0
        elif min_ratio >= 6.0:
            quant_step = 2.0  # 6:1 measured identical, 8:1 within 0.02 dB

    for tidx in range(cp.numtiles):
        tcp = TileCodingParams()
        tcp.prog_order = p.prog_order
        tcp.numlayers = numlayers
        tcp.mct = mct
        tcp.progression_changes = list(
            p.tile_progression_changes.get(tidx, p.progression_changes)
            if getattr(p, "tile_progression_changes", None)
            else p.progression_changes)
        if mct == 2:
            m = np.asarray(p.custom_mct, dtype=np.float64)
            if m.ndim != 2 or m.shape[0] != m.shape[1] \
                    or m.shape[0] > len(image.comps):
                raise ParamError(
                    f"custom MCT matrix must be square with dimension <= "
                    f"number of components, got shape {m.shape}")
            if abs(np.linalg.det(m)) < 1e-12:
                raise ParamError("custom MCT matrix is singular "
                                 "(not invertible)")
            tcp.mct_matrix = m
        for compno, comp in enumerate(image.comps):
            tccp = TileComponentCodingParams()
            tccp.numresolutions = p.numresolution
            tccp.cblkw = int(math.log2(p.cblk_width))
            tccp.cblkh = int(math.log2(p.cblk_height))
            if p.cblk_style is None:
                # auto policy (see CompressParams.cblk_style): bypass for
                # throughput unless ROI (oracle bypass+ROI asymmetry) or
                # PSNR targeting (exact R-D) is requested
                style = (CblkStyle.NONE
                         if (p.roi_shift and p.roi_comp != -1) or p.layer_psnr
                         else CblkStyle.LAZY)
            else:
                style = p.cblk_style
            if style & ~0x3F:
                # bits beyond the six defined switches corrupt the COD
                # style byte (0x40 is the Part-15 HT flag)
                raise ParamError(
                    f"invalid code-block style 0x{style:02X}: only "
                    f"bits 0x01..0x20 (LAZY RESET TERMALL VSC PTERM "
                    f"SEGSYM) are defined")
            tccp.cblk_style = style
            tccp.qmfbid = 1 if reversible else 0
            tccp.num_guard_bits = guard
            tccp.ht = p.ht
            if p.precincts:
                # CLI order: highest resolution first; replicate last entry
                n = tccp.numresolutions
                prc = list(p.precincts)
                while len(prc) < n:
                    prc.append(prc[-1])
                prc = prc[:n]
                # signaled low-res-first; auto-halve like the oracle does?
                # the reference maps CLI entries highest-res-first:
                tccp.prcw = [int(math.log2(prc[n - 1 - r][0]))
                             for r in range(n)]
                tccp.prch = [int(math.log2(prc[n - 1 - r][1]))
                             for r in range(n)]
            else:
                tccp.prcw = [15] * tccp.numresolutions
                tccp.prch = [15] * tccp.numresolutions
            tccp.qnt_style = (QuantStyle.NONE if reversible
                              else QuantStyle.SCALAR_EXPOUNDED)
            if p.quant_style is not None:
                tccp.qnt_style = p.quant_style
            tccp.stepsizes = quant_mod.default_stepsizes(
                comp.prec, tccp.numresolutions, reversible, quant_step)
            if (p.roi_comp == compno or p.roi_comp == -2) and p.roi_shift:
                # upshifted magnitudes must stay inside the int32 T1
                # domain (doubled-domain decode adds one more bit): bound
                # by the ACTUAL signaled band depth Mb = guard + expn - 1,
                # which for irreversible steps exceeds prec + gain by
                # ceil(log2(norm_b))
                max_expn = max(ss.expn for ss in tccp.stepsizes)
                mb = max(0, guard + max_expn - 1)
                if mb + p.roi_shift + 1 > 31:
                    raise ParamError(
                        f"roi_shift {p.roi_shift} overflows the 32-bit "
                        f"coefficient range (band depth {mb} bits at "
                        f"precision {comp.prec})")
            if p.roi_comp == compno or p.roi_comp == -2:
                # max-shift ROI: QCD/QCC stay untouched; both encoder and
                # decoder extend M_b by roi_shift internally (the decoder
                # learns the shift from the RGN marker) — verified against
                # the oracle decoder in tests/test_features.py.
                tccp.roi_shift = p.roi_shift
            tcp.tccps.append(tccp)
        cp.tcps.append(tcp)
    return cp


def compress_codestream(image: GrkImage, p: CompressParams,
                        device: torch.device | None,
                        strip_reader=None, sink=None, mesh=None) -> bytes:
    """Encode a full codestream; `device` is where the transforms run
    (None: on the host), and `mesh` (p.mesh resolved by
    parallel.mesh.resolve_mesh, or None) the devices the batched
    transforms shard over.  With `strip_reader` set (the streaming dual of
    decompress_strips), component data is fetched one tile row at a
    time — reader(y0, h) returns one 2-D array per component covering
    canvas rows [y0, y0+h) at that component's subsampling — and memory
    stays O(tile row) instead of O(image), on the card too: a row's
    device tensors are dropped before the next row is read.

    With `sink` set (a seekable binary file), tile-parts are written as
    they are produced and the TLM index is patched into a reserved span
    by seek-back with a COM filler absorbing the reservation slack; the
    return value is b"" and the codestream lives in the sink.  PPM/PLM
    need post-hoc main-header assembly and are rejected with a sink."""
    if sink is not None and (p.ppm or p.plm):
        raise ParamError("PPM/PLM main-header indexes cannot be "
                         "seek-back patched into a sink; use ppt/plt")
    for c in image.comps:
        if c.data is not None:
            c.h, c.w = c.data.shape
        elif strip_reader is None:
            raise ParamError("component has no data (use compress_strips "
                             "with a reader for streaming encodes)")
        elif not (c.w and c.h):
            c.w = -(-image.x1 // c.dx) - c.x0
            c.h = -(-image.y1 // c.dy) - c.y0
    with span("grk/encode/header"):
        cp = setup_coding_params(image, p)
        tcp0 = cp.tcps[0]
        out = _main_header(image, p, cp)

    # TLM/PPM are assembled after all tile-parts are encoded and inserted
    # here; tile-part bytes accumulate in `body_out`.
    body_out = bytearray()
    ppm_chunks: list[bytes] = []
    plm_entries: list[list[int]] = []

    img_rect = Rect(image.x0, image.y0, image.x1, image.y1)
    raw_bytes = sum(c.h * c.w * c.prec for c in image.comps) / 8.0
    p._raw_bytes_total = raw_bytes  # for -W per-tile share scaling
    # -W is a TOTAL codestream cap: subtract the main-header bytes written
    # so far plus EOC and the TLM index
    p._cap_overhead = (len(out) + 2
                       + (len(mk.write_tlm(
                              0, _predict_tlm_entries(cp, p, image))) + 6
                          if p.tlm else 0))
    if p.ppm and p.max_cs_size:
        p._cap_overhead += (4 * cp.numtiles
                            + 5 * (p.max_cs_size // 65528 + 1))

    cp._has_rate_targets = bool(p.layer_rates or p.layer_psnr
                                or p.max_cs_size)
    cp._has_quality_targets = bool(p.layer_psnr)
    cp._sim_pkt_overhead = (6 if p.sop else 0) + (2 if p.eph else 0)
    ntp = 1
    if p.new_tile_part_progression == "R":
        ntp = p.numresolution
    elif p.new_tile_part_progression == "L":
        ntp = p.numlayers
    elif p.new_tile_part_progression == "C":
        ntp = image.numcomps
    cp._sim_tile_parts = ntp
    mct_norms_arr = None
    if tcp0.mct == 1:
        mct_norms_arr = mct_mod.mct_norms(p.irreversible)
    elif tcp0.mct == 2:
        mct_norms_arr = mct_mod.custom_mct_norms(tcp0.mct_matrix)

    backend = host_backend(p.backend)

    def _make_compressor(q, pt):
        tidx = q * cp.t_grid_w + pt
        tcp = cp.tcps[tidx]
        trect = tile_rect(pt, q, cp.t_width, cp.t_height,
                          cp.tx0, cp.ty0, img_rect)
        tile = acquire_tile(tidx, trect, image, tcp)
        return (tidx, tcp, trect, TileCompressor(
            tile, tcp, image, cp, device, backend=backend,
            mct_norms_arr=mct_norms_arr, num_threads=p.num_threads,
            mesh=mesh))

    def _make_row(rows, cols):
        with span("grk/encode/tiles"):
            return [_make_compressor(q, pt) for q in rows for pt in cols]

    def _batch_full(row):
        # with a device or a mesh, the uniform full-size tiles go through
        # ONE batched analysis (sharded over the mesh)
        if device is not None or mesh is not None:
            with span("grk/encode/transform"):
                run_transforms_device_batched(
                    [t for (_, _, tr, t) in row
                     if tr.w == cp.t_width and tr.h == cp.t_height],
                    mesh=mesh)

    # phase 1: build every tile's compressor.  Strip-reader encodes defer
    # construction to the row loop below so memory stays O(tile row).
    compressors = None
    if strip_reader is None:
        compressors = _make_row(range(cp.t_grid_h), range(cp.t_grid_w))
        _batch_full(compressors)

    if (p.plt or p.plm) and p.max_cs_size:
        # reserve the packet-length indexes' footprint in the byte budget
        # (a bound that no packet sizes can overshoot)
        if compressors is not None:
            npkts = sum(res.pw * res.ph
                        for (_ti, _tcpx, _tr, tcx) in compressors
                        for comp in tcx.tile.comps
                        for res in comp.resolutions) * tcp0.numlayers
        else:
            npkts = _count_packets_geometry(cp, image, img_rect) \
                * tcp0.numlayers
        big = sum(min(npkts, p.max_cs_size >> s) for s in (14, 21, 28))
        p._cap_overhead += 2 * npkts + big + 8 * (npkts // 8000 + 2)

    def _tile_iter():
        if compressors is not None:
            yield from compressors
            return
        # strip mode: one reader call per tile row, tiles built lazily,
        # strip planes released as soon as the row is done; with a device
        # the row's uniform tiles go through one batched analysis
        for q in range(cp.t_grid_h):
            ty0 = max(image.y0, cp.ty0 + q * cp.t_height)
            ty1 = min(image.y1, cp.ty0 + (q + 1) * cp.t_height)
            _install_strips(image, ty0, ty1, strip_reader)
            try:
                row = _make_row((q,), range(cp.t_grid_w))
                _batch_full(row)
                while row:
                    yield row.pop(0)
            finally:
                for c in image.comps:
                    c.data = None
                    c._data_y0 = 0

    tlm_pos = tlm_reserve = 0
    if sink is not None:
        sink.write(out)
        if p.tlm:
            # reserve an upper-bound TLM span now; the real index (known
            # only after encoding) is seek-back patched, with a COM
            # filler absorbing the remainder
            tlm_reserve = len(mk.write_tlm(
                0, _predict_tlm_entries(cp, p, image))) + 6
            tlm_pos = sink.tell()
            sink.write(b"\x00" * tlm_reserve)

    tlm_entries = []
    for (tidx, tcp, trect, tc) in _tile_iter():
        with span("grk/encode/transform"):
            tc.run_transforms()
        # layer budgets
        if p.layer_psnr:
            tc.run_t1()
            with span("grk/encode/ratecontrol"):
                tc.assign_layers_quality(p.layer_psnr)
        else:
            tile_frac = (trect.area / max(1, (img_rect.area))) if \
                cp.numtiles > 1 else 1.0
            targets = _layer_targets(p, tcp.numlayers,
                                     raw_bytes * tile_frac)
            # all-finite byte budgets let Tier-1 early-stop each codeblock;
            # revalidate re-encodes the rare block whose truncated hull
            # still bites at the final threshold
            quota = (targets[-1] if p.rate_quota and targets
                     and all(t is not None for t in targets) else None)
            tc.run_t1(rate_quota=quota)
            with span("grk/encode/ratecontrol"):
                tc.assign_layers(targets)
                if quota:
                    for _ in range(3):
                        if not tc.revalidate_rate_truncation():
                            break
                        tc.assign_layers(targets)
        comp_info = [(c.dx, c.dy, tcp.tccps[i].numresolutions)
                     for i, c in enumerate(image.comps)]
        with span("grk/encode/t2"):
            body, pkt_lens, coords, ppt_hdrs = tc.write_packets(
                comp_info, sop=p.sop, eph=p.eph, ppt=p.ppt or p.ppm)
        with span("grk/encode/assemble"):
            if p.ppm:
                ppm_chunks.append(ppt_hdrs)
            # tile-part segmentation (-u R|L|C): split at changes of the chosen
            # index in progression order
            groups = _split_tile_parts(
                coords, None if p.ppt else p.new_tile_part_progression)
            tnsot = len(groups)
            off = 0
            zplt = 0  # PLT segment index: sequential per tile across tile-parts
            for tpno, (p0, p1) in enumerate(groups):
                glen = sum(pkt_lens[p0:p1])
                chunk = body[off:off + glen]
                off += glen
                plt_seg = b""
                if tpno == 0 and tcp.progression_changes \
                        and getattr(p, "tile_progression_changes", None):
                    # per-tile -P mode: every tile signals its own POC in its
                    # first tile-part header
                    plt_seg += mk.write_poc(tcp.progression_changes,
                                            image.numcomps)
                if p.plt:
                    seg, zplt = mk.write_plt(
                        zplt & 0xFF, pkt_lens[p0:p1], return_next=True)
                    plt_seg += seg
                if p.plm:
                    plm_entries.append(list(pkt_lens[p0:p1]))
                if p.ppt and not p.ppm and tpno == 0:
                    # packed packet headers: PPT segments of <= 65528 bytes
                    z = 0
                    off2 = 0
                    while off2 < len(ppt_hdrs) or z == 0:
                        seg = ppt_hdrs[off2:off2 + 65528]
                        plt_seg += mk.write_ppt(z & 0xFF, seg)
                        off2 += 65528
                        z += 1
                psot = 12 + len(plt_seg) + 2 + len(chunk)
                tp = bytearray()
                tp += mk.write_sot(tidx, psot, tpno, tnsot)
                tp += plt_seg
                tp += mk.u16(mk.SOD)
                tp += chunk
                if sink is not None:
                    sink.write(tp)
                else:
                    body_out += tp
                tlm_entries.append((tidx, len(tp)))
            if compressors is None:
                # strip mode: the tile back to the pool and its device tensors
                # dropped, so a row's bands leave the card with the row
                tc.release()
                del tc

    with span("grk/encode/assemble"):
        if sink is not None:
            sink.write(mk.u16(mk.EOC))
            if p.tlm:
                actual = mk.write_tlm(0, tlm_entries)
                end = sink.tell()
                sink.seek(tlm_pos)
                gap = tlm_reserve - len(actual)
                if gap == 0 or gap >= 6:
                    sink.write(actual)
                    sink.write(_com_filler(gap))
                else:  # can't happen with the 255-per-tile bound; stay safe
                    log.warning("TLM (%d B) exceeds its %d B reservation; "
                                "stream written without a TLM index",
                                len(actual), tlm_reserve)
                    sink.write(_com_filler(tlm_reserve))
                sink.seek(end)
            for (_tidx, _tcp, _trect, tc) in compressors or ():
                tc.release()
            return b""

        if p.tlm:
            out += mk.write_tlm(0, tlm_entries)
        if p.plm and plm_entries:
            out += mk.write_plm(0, plm_entries)
        if p.ppm:
            # one Nppm-framed chunk per tile-part, split into <= 65528-byte
            # PPM marker segments
            stream = bytearray()
            for chunk in ppm_chunks:
                stream += mk.u32(len(chunk)) + chunk
            z = 0
            off = 0
            while off < len(stream) or z == 0:
                out += mk.write_ppm(z & 0xFF, bytes(stream[off:off + 65528]))
                off += 65528
                z += 1
        out += body_out
        out += mk.u16(mk.EOC)
        for (_tidx, _tcp, _trect, tc) in compressors or ():
            tc.release()  # geometry tree back to the pool, scrubbed
        return bytes(out)


def _main_header(image: GrkImage, p: CompressParams,
                 cp: CodingParams) -> bytearray:
    """SOC and the main header's marker segments, up to the first SOT."""
    tcp0 = cp.tcps[0]
    out = bytearray()
    out += mk.u16(mk.SOC)
    si = mk.SizInfo(
        rsiz=cp.rsiz, xsiz=image.x1, ysiz=image.y1,
        xosiz=image.x0, yosiz=image.y0,
        xtsiz=cp.t_width, ytsiz=cp.t_height,
        xtosiz=cp.tx0, ytosiz=cp.ty0,
        comps=[(c.prec, c.sgnd, c.dx, c.dy) for c in image.comps])
    out += mk.write_siz(si)
    if cp.ht:
        # Ccap15 set bits (B.9): 0 = HTONLY, 3 = MIXED (per-block MQ/HT)
        out += mk.write_cap(ccap15=0xC000 if cp.ht_mixed else 0)
    has_prc = p.precincts is not None
    out += mk.write_cod(tcp0, has_prc, sop=p.sop, eph=p.eph)
    out += mk.write_qcd(tcp0.tccps[0])
    # per-component overrides (differing precision/ROI -> stepsizes/guard)
    for compno in range(1, image.numcomps):
        t_c, t_0 = tcp0.tccps[compno], tcp0.tccps[0]
        if (t_c.stepsizes != t_0.stepsizes
                or t_c.num_guard_bits != t_0.num_guard_bits):
            out += mk.write_qcc(compno, image.numcomps, t_c)
    if tcp0.mct == 2:
        # Part-2 MCT/MCC/MCO triplet: decorrelation array #1 carries the
        # DECODING matrix, offset array #2 the DC offsets re-added after it
        nmat = tcp0.mct_matrix.shape[0]
        dec = np.linalg.inv(tcp0.mct_matrix.astype(np.float64))
        offs = [0 if image.comps[i].sgnd else 1 << (image.comps[i].prec - 1)
                for i in range(nmat)]
        out += mk.write_mct_record(
            1, mk.MCT_ARRAY_DECORRELATION, mk.MCT_ELEM_FLOAT32, dec.ravel())
        out += mk.write_mct_record(
            2, mk.MCT_ARRAY_OFFSET, mk.MCT_ELEM_INT32, offs)
        out += mk.write_mcc(1, nmat, deco_index=1, offset_index=2,
                            irreversible=True)
        out += mk.write_mco([1])
    if p.progression_changes \
            and not getattr(p, "tile_progression_changes", None):
        # codestream-wide POC; with per-tile overrides every tile gets a
        # tile-header POC instead
        out += mk.write_poc(p.progression_changes, image.numcomps)
    for compno in range(image.numcomps):
        if tcp0.tccps[compno].roi_shift:
            out += mk.write_rgn(compno, image.numcomps,
                                tcp0.tccps[compno].roi_shift)
    comments = p.comment
    if isinstance(comments, str):
        comments = [comments]
    for c in comments or []:
        out += mk.write_com(c)
    if p.comp_registration:
        if len(p.comp_registration) != image.numcomps:
            raise ParamError("comp_registration needs one (Xcrg, Ycrg) "
                             "pair per component")
        out += mk.write_crg(p.comp_registration)
    return out


def _install_strips(image: GrkImage, cy0: int, cy1: int,
                    strip_reader) -> None:
    """Fetch canvas rows [cy0, cy1) from the reader and install them as
    the components' (offset) data planes for one tile row."""
    arrs = strip_reader(cy0, cy1 - cy0)
    if len(arrs) != len(image.comps):
        raise ParamError(
            f"strip reader returned {len(arrs)} planes for "
            f"{len(image.comps)} components")
    for c, a in zip(image.comps, arrs):
        r0 = -(-cy0 // c.dy) - c.y0  # first component row of the strip
        r1 = -(-cy1 // c.dy) - c.y0
        a = np.ascontiguousarray(a, dtype=np.int32)
        if a.ndim != 2 or a.shape != (r1 - r0, c.w):
            raise ParamError(
                f"strip reader plane shape {a.shape} != expected "
                f"{(r1 - r0, c.w)} for canvas rows [{cy0}, {cy1})")
        c.data = a
        c._data_y0 = r0


def _tlm_parts_per_tile(cp, p, image) -> int:
    """Upper bound on tile-parts per tile.  Without -u (or with PPT,
    which forces single tile-parts) every tile emits exactly one
    tile-part.  With -u the number of runs of the split key equals the
    product of the loop sizes at or outside that key in the progression
    order; a prefix containing the position loop (e.g. -u R under CPRL,
    the IMF default) is bounded only by _split_tile_parts' 255-group
    merge, as is any POC-reordered tile."""
    if p.ppt or not p.new_tile_part_progression:
        return 1
    if any(tcp.progression_changes for tcp in cp.tcps):
        return 255
    sizes = {"L": max(t.numlayers for t in cp.tcps),
             "R": p.numresolution,
             "C": max(1, image.numcomps)}
    per = 1
    for prog in {t.prog_order for t in cp.tcps}:
        order = prog.name  # e.g. "LRCP"
        prefix = order[:order.index(p.new_tile_part_progression) + 1]
        if "P" in prefix:
            return 255
        n = 1
        for ch in prefix:
            n *= sizes[ch]
        per = max(per, n)
    return min(255, per)


def _predict_tlm_entries(cp, p, image) -> list:
    """Upper-bound TLM entry list for the sink reservation and the -W
    cap budget."""
    per = _tlm_parts_per_tile(cp, p, image)
    return [(t, 0) for t in range(cp.numtiles) for _ in range(per)]


def _split_tile_parts(coords, mode: str | None):
    """Packet-index ranges [(start, end), ...] for tile-part generation:
    a new tile-part starts at each change of resolution ('R'), layer ('L')
    or component ('C') in progression order."""
    n = len(coords)
    if not mode or n == 0:
        return [(0, n)]
    key = {"R": lambda c: c.resno, "L": lambda c: c.layno,
           "C": lambda c: c.compno}[mode]
    groups = []
    start = 0
    for i in range(1, n):
        if key(coords[i]) != key(coords[i - 1]):
            groups.append((start, i))
            start = i
    groups.append((start, n))
    # TNsot is a byte: merge overflow groups
    while len(groups) > 255:
        a = groups.pop()
        b = groups.pop()
        groups.append((b[0], a[1]))
    return groups


def _layer_targets(p: CompressParams, numlayers: int, raw_bytes: float):
    if p.layer_rates:
        # reference semantics: ratios <= 1 mean "no truncation" (lossless
        # cap) rather than a literal byte budget
        targets = []
        for r in p.layer_rates:
            if r <= 1.0:
                targets.append(None)
            else:
                targets.append(raw_bytes / r)
        return targets
    if p.layer_psnr:
        # quality mode: handled by assign_layers_quality (distortion
        # thresholds calibrated against measured reconstruction error)
        return [None] * numlayers
    if p.max_cs_size:
        # -W is a TOTAL codestream cap: scale each tile's share of the
        # packet-byte budget (total minus the measured main-header +
        # framing overhead) by its area fraction (tile_frac folded into
        # raw_bytes by the caller)
        budget = max(64.0, p.max_cs_size
                     - getattr(p, "_cap_overhead", 64.0))
        share = budget * (raw_bytes / max(1.0, p._raw_bytes_total)
                          if getattr(p, "_raw_bytes_total", 0)
                          else 1.0)
        share = max(64.0, share)
        step = share / numlayers
        return [step * (i + 1) for i in range(numlayers - 1)] + [share]
    return [None] * numlayers


def _com_filler(nbytes: int) -> bytes:
    """Exactly nbytes of COM padding (nbytes == 0 or >= 6), split into
    as many marker segments as the 64KB Lcom limit requires."""
    out = bytearray()
    while nbytes:
        seg = min(nbytes, 65537)  # 6 bytes framing + 65531 text max
        if 0 < nbytes - seg < 6:
            seg = nbytes - 6  # leave room for a final minimal segment
        out += mk.write_com("~" * (seg - 6))
        nbytes -= seg
    return bytes(out)


def _count_packets_geometry(cp, image, img_rect) -> int:
    """Total packets per layer, from transient tile geometry (strip-mode
    encodes size the PLT/PLM budget before any tile data exists).  Tiles
    sharing a geometry-pool key have identical precinct grids."""
    from ..tile.processor import _tile_geo_key

    total = 0
    seen: dict = {}
    for q in range(cp.t_grid_h):
        for pt in range(cp.t_grid_w):
            tidx = q * cp.t_grid_w + pt
            tcp = cp.tcps[tidx]
            trect = tile_rect(pt, q, cp.t_width, cp.t_height,
                              cp.tx0, cp.ty0, img_rect)
            key = _tile_geo_key(trect, image, tcp)
            cnt = seen.get(key)
            if cnt is None:
                tile = acquire_tile(tidx, trect, image, tcp)
                cnt = sum(res.pw * res.ph for comp in tile.comps
                          for res in comp.resolutions)
                release_tile(tile)
                seen[key] = cnt
            total += cnt
    return total
