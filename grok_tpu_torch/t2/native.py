"""ctypes bindings for the native C++ Tier-2 packet-header coder.

Parity: the reference's T2Compress/T2Decompress are native C++ (SURVEY.md
§2.1 "Tier-2"); this module routes the per-packet header coding through
native/t2.cc while the progression iteration, SOP/EPH framing and body
assembly stay in Python (t2/packets.py).  The native side owns
the resumable per-precinct state (tag trees, Lblock, inclusion layer,
pass counters); the Python Codeblock state is mirrored on decode so the
rest of the pipeline (Tier-1, window skip) sees the same fields the pure
Python coder maintains.

The pure-Python implementation in packets.py remains the correctness
oracle; tests/test_native_t2.py differential-tests both per packet.
"""

from __future__ import annotations

import ctypes as ct

import numpy as np

from ..t1 import native as _t1_native  # builds + loads libgrk_t1.so

_lib = _t1_native._lib

MAX_CHUNKS = 200

_lib.grk_t2_prc_new.argtypes = [ct.c_int, ct.c_uint64, ct.c_uint64]
_lib.grk_t2_prc_new.restype = ct.c_void_p
_lib.grk_t2_prc_free.argtypes = [ct.c_void_p]
_lib.grk_t2_prc_reset.argtypes = [ct.c_void_p]
_lib.grk_t2_encode_packet.argtypes = [
    ct.c_void_p, ct.c_int, ct.c_int, ct.c_int,
    ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_uint64,
    ct.c_uint64, ct.c_int, ct.c_uint64]
_lib.grk_t2_encode_packet.restype = ct.c_long
_lib.grk_t2_prc_hdr.argtypes = [ct.c_void_p]
_lib.grk_t2_prc_hdr.restype = ct.c_void_p
_lib.grk_t2_size_layers.argtypes = [
    ct.c_void_p, ct.c_int, ct.c_int, ct.c_int,
    ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_uint64,
    ct.c_uint64, ct.c_int, ct.c_uint64]
_lib.grk_t2_size_layers.restype = ct.c_long
_lib.grk_t2_decode_seq.argtypes = [
    ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_uint64,
    ct.c_uint64, ct.c_int, ct.c_uint64, ct.c_long,
    ct.POINTER(ct.c_long),
    ct.c_uint64, ct.c_uint64, ct.c_uint64,
    ct.POINTER(ct.POINTER(ct.c_int32)), ct.POINTER(ct.c_long)]
_lib.grk_t2_decode_seq.restype = ct.c_long
_lib.grk_t1_decode_tile.argtypes = [
    ct.c_uint64, ct.c_long, ct.c_uint64, ct.c_long, ct.c_int,
    ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_uint64,
    ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_int]
_lib.grk_t1_decode_tile.restype = ct.c_long
_lib.grk_t1_encode_tile.argtypes = [
    ct.c_int, ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_uint64,
    ct.c_uint64, ct.c_uint64, ct.c_uint64,
    ct.c_uint64, ct.c_uint64, ct.c_uint64,
    ct.c_uint64, ct.c_uint64, ct.c_uint64,
    ct.c_uint64, ct.c_int,
    ct.c_int, ct.c_uint64,
    ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_uint64,
    ct.c_int]
_lib.grk_t1_encode_tile.restype = ct.c_long
_lib.grk_t2_encode_seq.argtypes = [
    ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_uint64,
    ct.c_int,
    ct.c_uint64, ct.c_int,
    ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_uint64,
    ct.c_uint64, ct.c_int,
    ct.c_uint64,
    ct.c_int, ct.c_int, ct.c_int,
    ct.POINTER(ct.POINTER(ct.c_uint8)), ct.POINTER(ct.c_long),
    ct.POINTER(ct.POINTER(ct.c_uint8)), ct.POINTER(ct.c_long),
    ct.POINTER(ct.POINTER(ct.c_int64))]
_lib.grk_t2_encode_seq.restype = ct.c_long
_lib.grk_t2_decode_packet.argtypes = [
    ct.c_void_p, ct.c_int, ct.c_int, ct.c_int,
    ct.c_uint64, ct.c_long, ct.c_long, ct.c_uint64,
    ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_uint64, ct.c_uint64,
    ct.c_uint64, ct.c_int, ct.POINTER(ct.c_long)]
_lib.grk_t2_decode_packet.restype = ct.c_int


def _addr(a: np.ndarray) -> int:
    return a.__array_interface__["data"][0]


class PrecinctHandle:
    """Owns the native per-precinct Tier-2 state plus the reusable
    marshalling arrays (one allocation per precinct, not per packet)."""

    __slots__ = (
        "ptr", "ncb", "cblks", "cblk_band", "npasses", "first_layer", "zb",
        "numbps", "is_ht", "rates", "rates_stride", "ranges",
        "out_incl", "out_newly", "out_zb", "out_isht", "out_nchunks",
        "out_chunks", "hdr_pos_out", "statics_built", "maxch",
    )

    def __init__(self, prc, maxch: int = MAX_CHUNKS) -> None:
        cw = np.asarray([pb.cblk_w if pb.cblks else 0 for pb in prc.pbands],
                        dtype=np.int32)
        ch = np.asarray([pb.cblk_h if pb.cblks else 0 for pb in prc.pbands],
                        dtype=np.int32)
        self.ptr = _lib.grk_t2_prc_new(len(prc.pbands), _addr(cw), _addr(ch))
        self.maxch = maxch
        self.cblks = [c for pb in prc.pbands for c in pb.cblks]
        self.cblk_band = [bi for bi, pb in enumerate(prc.pbands)
                          for _ in pb.cblks]
        self.ncb = len(self.cblks)
        n = max(self.ncb, 1)
        self.npasses = np.zeros(n, dtype=np.int32)
        self.first_layer = np.zeros(n, dtype=np.int32)
        self.zb = np.zeros(n, dtype=np.int32)
        self.numbps = np.zeros(n, dtype=np.int32)
        self.is_ht = np.zeros(n, dtype=np.int32)
        self.rates = None
        self.rates_stride = 0
        self.ranges = np.zeros(2 * n, dtype=np.int32)
        self.out_incl = np.zeros(n, dtype=np.int32)
        self.out_newly = np.zeros(n, dtype=np.int32)
        self.out_zb = np.zeros(n, dtype=np.int32)
        self.out_isht = np.zeros(n, dtype=np.int32)
        self.out_nchunks = np.zeros(n, dtype=np.int32)
        self.out_chunks = np.zeros(n * maxch * 2, dtype=np.int32)
        self.hdr_pos_out = ct.c_long(0)
        self.statics_built = False

    def __del__(self):  # pragma: no cover - interpreter teardown order
        try:
            _lib.grk_t2_prc_free(self.ptr)
        except Exception:
            pass

    def reset(self) -> None:
        _lib.grk_t2_prc_reset(self.ptr)
        # rate control may have reassigned layers since the last pass:
        # the inclusion-tree leaf values (first contributing layer) must
        # be rederived, but zb/numbps/rates are static after Tier-1
        self.statics_built = False

    # ------------------------------------------------------------ encoder

    def _build_statics(self) -> None:
        """Refresh the per-cblk encoder inputs.  The tag-tree leaf values
        (first contributing layer) change with every rate-control trial;
        zero bitplanes / numbps / coder choice / pass rates are static
        after Tier-1 and are built only once."""
        for i, c in enumerate(self.cblks):
            npl = c.num_passes_by_layer
            first = len(npl)
            for ln, np_ in enumerate(npl):
                if np_ > 0:
                    first = ln
                    break
            self.first_layer[i] = first
        self._ensure_rates()
        self.statics_built = True

    def _ensure_rates(self) -> None:
        if self.rates is None:
            stride = 1
            for c in self.cblks:
                stride = max(stride, len(c.pass_rates))
            rates = np.zeros((max(self.ncb, 1), stride), dtype=np.int32)
            for i, c in enumerate(self.cblks):
                self.zb[i] = c.zero_bitplanes
                self.numbps[i] = c.numbps
                self.is_ht[i] = 1 if getattr(c, "is_ht", False) else 0
                if c.pass_rates:
                    rates[i, :len(c.pass_rates)] = c.pass_rates
            self.rates = rates
            self.rates_stride = stride

    def _encode_packet_native(self, layno: int, style: int,
                              mixed: bool) -> int:
        """Shared encode/size prologue: fill per-cblk pass counts and run
        the native packet coder; returns the header bit length in bytes.
        The header lands in a native growable buffer (huge precincts /
        tiny codeblocks can legitimately exceed any fixed cap) and the
        body ranges land in self.ranges."""
        if not self.statics_built:
            self._build_statics()
        for i, c in enumerate(self.cblks):
            npl = c.num_passes_by_layer
            self.npasses[i] = npl[layno] if layno < len(npl) else 0
        return _lib.grk_t2_encode_packet(
            self.ptr, layno, int(style), 1 if mixed else 0,
            _addr(self.npasses), _addr(self.first_layer), _addr(self.zb),
            _addr(self.numbps), _addr(self.is_ht),
            _addr(self.rates), self.rates_stride, _addr(self.ranges))

    def encode(self, layno: int, style: int, mixed: bool):
        """Returns (header bytes, body ranges int32[2*ncb])."""
        n = self._encode_packet_native(layno, style, mixed)
        hdr = ct.string_at(_lib.grk_t2_prc_hdr(self.ptr), n)
        return hdr, self.ranges

    def size(self, layno: int, style: int, mixed: bool) -> int:
        """Header + body bytes of this packet WITHOUT materializing them
        (rate-control dry runs only need the length; the header copy and
        body slicing were most of the simulate cost)."""
        n = self._encode_packet_native(layno, style, mixed)
        r = self.ranges[:2 * self.ncb]
        s, e = r[0::2], r[1::2]
        inc = s >= 0
        return int(n) + int((e[inc] - s[inc]).sum())

    def size_layers(self, nlayers_sim: int, style: int, mixed: bool,
                    npl_mat: np.ndarray, first_layer: np.ndarray) -> int:
        """Header + body bytes of this precinct's packets for layers
        0..nlayers_sim-1, replayed natively in one call (rate-control
        dry runs; the per-trial Python cblk loops of size() collapse to
        two array writes).  `npl_mat` is (nlayers_sim, ncb) int32
        C-contiguous; `first_layer` is the per-cblk first contributing
        layer under this trial (len ncb)."""
        self._ensure_rates()
        self.first_layer[:self.ncb] = first_layer
        # the native replay resets state itself (and leaves it fresh)
        self.statics_built = False
        return int(_lib.grk_t2_size_layers(
            self.ptr, nlayers_sim, int(style), 1 if mixed else 0,
            _addr(npl_mat), _addr(self.first_layer), _addr(self.zb),
            _addr(self.numbps), _addr(self.is_ht),
            _addr(self.rates), self.rates_stride, _addr(self.ranges)))

    # ------------------------------------------------------------ decoder

    def decode(self, layno: int, style: int, mixed: bool,
               hdr: bytes, hdr_pos: int, mb_per_band) -> int:
        """Decode one packet header starting at hdr[hdr_pos].  Results are
        left in the out_* arrays; returns the aligned position after the
        header.  Raises ValueError on a malformed header."""
        mb = np.asarray(mb_per_band, dtype=np.int32)
        rc = _lib.grk_t2_decode_packet(
            self.ptr, layno, int(style), 1 if mixed else 0,
            _addr(np.frombuffer(hdr, dtype=np.uint8)) if hdr else 0,
            len(hdr), hdr_pos, _addr(mb),
            _addr(self.out_incl), _addr(self.out_newly), _addr(self.out_zb),
            _addr(self.out_isht), _addr(self.out_nchunks),
            _addr(self.out_chunks), self.maxch,
            ct.byref(self.hdr_pos_out))
        if rc != 0:
            raise ValueError("malformed packet header")
        return self.hdr_pos_out.value


def encode_seq(prc_a, lay_a, sty_a, mix_a, base_a, npl_mat, first_layer,
               zb, numbps, is_ht, rates, rates_stride, data_ptrs,
               sop: bool, eph: bool, split: bool):
    """Whole-tile packet emission in ONE native call (the encode mirror
    of grk_t2_decode_seq): per-packet arrays in progression order +
    per-GLOBAL-codeblock statics (bases index into them).  Returns
    (body bytes, per-packet lengths list, header bytes) — header bytes
    are only populated with split=True (PPT packed headers); otherwise
    the body holds the full SOP+header+EPH+body packet stream and the
    lengths are whole-packet lengths."""
    npk = len(lay_a)
    hdr_p = ct.POINTER(ct.c_uint8)()
    hdr_n = ct.c_long(0)
    body_p = ct.POINTER(ct.c_uint8)()
    body_n = ct.c_long(0)
    lens_p = ct.POINTER(ct.c_int64)()
    _lib.grk_t2_encode_seq(
        _addr(prc_a), _addr(lay_a), _addr(sty_a), _addr(mix_a),
        _addr(base_a), npk,
        _addr(npl_mat), npl_mat.shape[1],
        _addr(first_layer), _addr(zb), _addr(numbps), _addr(is_ht),
        _addr(rates), rates_stride,
        _addr(data_ptrs),
        1 if sop else 0, 1 if eph else 0, 1 if split else 0,
        ct.byref(hdr_p), ct.byref(hdr_n),
        ct.byref(body_p), ct.byref(body_n),
        ct.byref(lens_p))
    body = ct.string_at(body_p, body_n.value) if body_n.value else b""
    hdrs = ct.string_at(hdr_p, hdr_n.value) if hdr_n.value else b""
    lens = np.ctypeslib.as_array(lens_p, (npk,)).tolist() if npk else []
    return body, lens, hdrs


def encode_tile(ncb, st_hw, st_meta, st_flags, st_coff, band_base,
                band_stride, band_delta, arena, out_offs, out_caps,
                out_lens, out_numbps, out_npasses, rates, rates_stride,
                num_threads, dist=None) -> int:
    """Whole-tile Tier-1 encode (grk_t1_encode_tile): one C call codes
    every codeblock from band-array views into `arena`, pass rates into
    the (ncb, rates_stride) matrix.  `dist`, when given, is the PCRD
    feed tuple (e0, hull_pass, hull_slope, hull_rate, hull_n) of
    caller-owned output arrays — the hull matrices are (ncb,
    rates_stride) rows like `rates`.  Returns the job count (< 0 on
    overflow — the caller re-runs the per-codeblock path)."""
    if dist is None:
        nd, e0 = 0, 0
        hp = hs = hr = hn = 0
    else:
        e0_a, hp_a, hs_a, hr_a, hn_a = dist
        nd = 1
        e0, hp, hs = _addr(e0_a), _addr(hp_a), _addr(hs_a)
        hr, hn = _addr(hr_a), _addr(hn_a)
    return int(_lib.grk_t1_encode_tile(
        ncb, _addr(st_hw), _addr(st_meta), _addr(st_flags), _addr(st_coff),
        _addr(band_base), _addr(band_stride), _addr(band_delta),
        _addr(arena), _addr(out_offs), _addr(out_caps),
        _addr(out_lens), _addr(out_numbps), _addr(out_npasses),
        _addr(rates), rates_stride, nd, e0, hp, hs, hr, hn, num_threads))


def get_handle(prc, maxch: int = MAX_CHUNKS) -> PrecinctHandle:
    h = getattr(prc, "_nt2", None)
    if h is None or maxch > h.maxch:
        # a pooled tile can be reused by a stream whose codeblock style
        # needs more chunk capacity (TERMALL/LAZY after a NONE decode):
        # rebuild the handle rather than letting the native parser
        # reject valid packets at the old cap.  Within one decode the
        # style (hence maxch) is constant, so this never fires mid-tile.
        h = PrecinctHandle(prc, maxch)
        prc._nt2 = h
    return h


def reset_precinct(prc) -> None:
    h = getattr(prc, "_nt2", None)
    if h is not None:
        h.reset()
