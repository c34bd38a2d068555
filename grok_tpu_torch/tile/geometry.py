"""Canvas / tile / resolution / band / precinct / codeblock geometry.

Parity: TileComponent tree (SURVEY.md §2.1 "TileComponent & canvas geometry",
src/lib/core/tile/ [P]) and the coordinate formulas of ISO/IEC 15444-1
Annex B:

- tile (p,q): tx0 = max(XTOsiz + p*XTsiz, XOsiz), tx1 = min(XTOsiz+(p+1)*XTsiz, Xsiz)
- tile-component: tcx0 = ceil(tx0 / dx)
- resolution r (numres = N_L+1): trx0 = ceil(tcx0 / 2^(N_L - r))
- band b at decomposition level nb = N_L - r + 1:
    tbx0 = ceil((tcx0 - 2^(nb-1) * xob) / 2^nb), xob in {0,1} per orientation
- precinct grid: anchored at 0 with size 2^PPx on resolution coords
- codeblock grid: anchored at 0 with size 2^cblk_expn on band coords,
  cblk_expn = min(xcb, PPx - (1 if r else 0))

All geometry is host-side Python (SURVEY.md §7 "keep geometry math host-side
and explicit"); device kernels receive padded rectangular batches.
"""

from __future__ import annotations

from dataclasses import dataclass, field


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _cdp2(a: int, p: int) -> int:
    """ceil(a / 2^p) for possibly-negative a (Python >> floors)."""
    return -((-a) >> p)


def floor_div_pow2(a: int, p: int) -> int:
    return a >> p


@dataclass(frozen=True)
class Rect:
    x0: int
    y0: int
    x1: int
    y1: int

    @property
    def w(self) -> int:
        return max(0, self.x1 - self.x0)

    @property
    def h(self) -> int:
        return max(0, self.y1 - self.y0)

    @property
    def area(self) -> int:
        return self.w * self.h

    def is_empty(self) -> bool:
        return self.x1 <= self.x0 or self.y1 <= self.y0

    def intersect(self, o: "Rect") -> "Rect":
        return Rect(max(self.x0, o.x0), max(self.y0, o.y0),
                    min(self.x1, o.x1), min(self.y1, o.y1))

    def contains(self, o: "Rect") -> bool:
        return (self.x0 <= o.x0 and self.y0 <= o.y0
                and self.x1 >= o.x1 and self.y1 >= o.y1)


# band orientations
LL, HL, LH, HH = 0, 1, 2, 3
BAND_GAIN = {LL: 0, HL: 1, LH: 1, HH: 2}
# (xob, yob) band origin offsets
BAND_OFFSET = {LL: (0, 0), HL: (1, 0), LH: (0, 1), HH: (1, 1)}


@dataclass
class Codeblock:
    rect: Rect                 # in band coordinates
    idx: int                   # raster index within precinct
    # --- encoder state ---
    data: bytes = b""          # coded bytes (all passes)
    numbps: int = 0            # magnitude bitplanes actually coded
    pass_rates: list[int] = field(default_factory=list)      # cumulative bytes at each pass end
    pass_dists: list[float] = field(default_factory=list)    # cumulative distortion *decrease*
    pass_term: list[bool] = field(default_factory=list)      # pass ends a codeword segment
    num_passes_by_layer: list[int] = field(default_factory=list)
    layer_start: list[int] = field(default_factory=list)     # byte offset of each layer chunk
    # --- decoder state ---
    # codeword segments: list of byte chunks in arrival order
    seg_data: list[bytes] = field(default_factory=list)
    seg_passes: list[int] = field(default_factory=list)
    included_in_layer: int = -1   # first layer this block was included in
    total_passes: int = 0         # passes received so far (decoder)
    lblock: int = 3
    zero_bitplanes: int = 0


@dataclass
class PrecinctBand:
    """The part of one precinct that lives in one band: a codeblock grid."""

    band_orient: int
    rect: Rect                 # band-coordinate rect of this precinct's area
    cblk_w: int = 0            # codeblock grid dims
    cblk_h: int = 0
    cblks: list[Codeblock] = field(default_factory=list)
    # tag-tree state created lazily by Tier-2
    incl_tree: object = None
    imsb_tree: object = None


@dataclass
class Precinct:
    idx: int                   # raster index within resolution
    rect: Rect                 # resolution-coordinate rect (clipped)
    pbands: list[PrecinctBand] = field(default_factory=list)


@dataclass
class Band:
    orient: int
    rect: Rect                 # band coordinates
    # quantization
    stepsize: float = 1.0
    numbps: int = 0            # M_b: max bitplanes for this band


@dataclass
class Resolution:
    resno: int
    rect: Rect                 # resolution coordinates
    ppx: int = 15
    ppy: int = 15
    pw: int = 0                # precinct grid dims
    ph: int = 0
    cblk_expn: tuple[int, int] = (6, 6)   # log2 codeblock dims in band coords
    bands: list[Band] = field(default_factory=list)
    precincts: list[Precinct] = field(default_factory=list)

    @property
    def num_precincts(self) -> int:
        return self.pw * self.ph


def band_rect(tc: Rect, numres: int, resno: int, orient: int) -> Rect:
    """Band rectangle in band coordinates."""
    nl = numres - 1
    if resno == 0:
        nb = nl
        xob = yob = 0
    else:
        nb = nl - resno + 1
        xob, yob = BAND_OFFSET[orient]
    if nb == 0:
        # resno == numres-1 == 0: no decomposition, band == tile-comp
        return tc
    h = 1 << (nb - 1)
    return Rect(
        _cdp2(tc.x0 - h * xob, nb), _cdp2(tc.y0 - h * yob, nb),
        _cdp2(tc.x1 - h * xob, nb), _cdp2(tc.y1 - h * yob, nb),
    )


def res_rect(tc: Rect, numres: int, resno: int) -> Rect:
    s = numres - 1 - resno
    return Rect(_cdp2(tc.x0, s), _cdp2(tc.y0, s), _cdp2(tc.x1, s), _cdp2(tc.y1, s))


def build_resolutions(
    tc: Rect,
    numres: int,
    prcw: list[int],
    prch: list[int],
    cblkw_expn: int,
    cblkh_expn: int,
) -> list[Resolution]:
    """Build the full resolution/band/precinct/codeblock tree for one
    tile-component.  prcw/prch are per-resolution precinct exponents
    (index 0 = resolution 0)."""
    out: list[Resolution] = []
    for r in range(numres):
        rr = res_rect(tc, numres, r)
        ppx, ppy = prcw[r], prch[r]
        res = Resolution(resno=r, rect=rr, ppx=ppx, ppy=ppy)
        if rr.is_empty():
            res.pw = res.ph = 0
        else:
            res.pw = _cdp2(rr.x1, ppx) - (rr.x0 >> ppx)
            res.ph = _cdp2(rr.y1, ppy) - (rr.y0 >> ppy)
        # codeblock exponent in band coords; the max(0, ...) clamp keeps
        # corrupt streams that signal PPx=0 above the lowest resolution
        # (spec-illegal, ISO B.6) from producing a negative shift
        cbw = max(0, min(cblkw_expn, ppx - (1 if r > 0 else 0)))
        cbh = max(0, min(cblkh_expn, ppy - (1 if r > 0 else 0)))
        res.cblk_expn = (cbw, cbh)
        orients = [LL] if r == 0 else [HL, LH, HH]
        for o in orients:
            res.bands.append(Band(orient=o, rect=band_rect(tc, numres, r, o)))
        # precincts
        if res.pw and res.ph:
            px_start = (rr.x0 >> ppx) << ppx
            py_start = (rr.y0 >> ppy) << ppy
            idx = 0
            for pj in range(res.ph):
                for pi in range(res.pw):
                    # unclipped precinct rect in resolution coords
                    ux0 = px_start + (pi << ppx)
                    uy0 = py_start + (pj << ppy)
                    prc_unclipped = Rect(ux0, uy0, ux0 + (1 << ppx), uy0 + (1 << ppy))
                    prc = Precinct(idx=idx, rect=prc_unclipped.intersect(rr))
                    for band in res.bands:
                        pband = _build_precinct_band(
                            band, prc_unclipped, r, cbw, cbh)
                        prc.pbands.append(pband)
                    res.precincts.append(prc)
                    idx += 1
        out.append(res)
    return out


def _build_precinct_band(
    band: Band, prc_unclipped: Rect, resno: int, cbw: int, cbh: int
) -> PrecinctBand:
    """Map a precinct (resolution coords, unclipped grid cell) into one band
    and enumerate its codeblocks."""
    if resno == 0:
        cbg = prc_unclipped
    else:
        # band coords = resolution coords / 2; grid cells are aligned so
        # floor division is exact for the unclipped cell
        cbg = Rect(prc_unclipped.x0 >> 1, prc_unclipped.y0 >> 1,
                   prc_unclipped.x1 >> 1, prc_unclipped.y1 >> 1)
    area = cbg.intersect(band.rect)
    pband = PrecinctBand(band_orient=band.orient, rect=area)
    if area.is_empty():
        return pband
    cw = 1 << cbw
    ch = 1 << cbh
    x_start = (area.x0 >> cbw) << cbw
    y_start = (area.y0 >> cbh) << cbh
    pband.cblk_w = _cdp2(area.x1, cbw) - (area.x0 >> cbw)
    pband.cblk_h = _cdp2(area.y1, cbh) - (area.y0 >> cbh)
    idx = 0
    for j in range(pband.cblk_h):
        for i in range(pband.cblk_w):
            cx0 = x_start + i * cw
            cy0 = y_start + j * ch
            cell = Rect(cx0, cy0, cx0 + cw, cy0 + ch)
            pband.cblks.append(Codeblock(rect=cell.intersect(area), idx=idx))
            idx += 1
    return pband


@dataclass
class TileComponent:
    compno: int
    rect: Rect                 # tile-component rect (component coords)
    resolutions: list[Resolution] = field(default_factory=list)
    data: object = None        # numpy array (h, w) of coefficients / samples


@dataclass
class Tile:
    index: int
    rect: Rect                 # canvas coords
    comps: list[TileComponent] = field(default_factory=list)


def tile_rect(
    p: int, q: int,
    xt_siz: int, yt_siz: int, xt_o: int, yt_o: int,
    img: Rect,
) -> Rect:
    tx0 = max(xt_o + p * xt_siz, img.x0)
    ty0 = max(yt_o + q * yt_siz, img.y0)
    tx1 = min(xt_o + (p + 1) * xt_siz, img.x1)
    ty1 = min(yt_o + (q + 1) * yt_siz, img.y1)
    return Rect(tx0, ty0, tx1, ty1)


def tile_comp_rect(t: Rect, dx: int, dy: int) -> Rect:
    return Rect(ceil_div(t.x0, dx), ceil_div(t.y0, dy),
                ceil_div(t.x1, dx), ceil_div(t.y1, dy))
