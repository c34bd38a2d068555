"""Color/metadata post-processing of decoded images.

Parity: GrkImage_Conversion (SURVEY.md §2.1 "GrkImage",
src/lib/core/util/GrkImage*.cpp [P]): sYCC->RGB (420/422/444 upsampling),
palette (pclr/cmap) application, cdef channel reordering, component
upsampling, precision shifts.  ICC application via littlecms is replaced by
profile attachment (profiles are carried through; application is delegated
to the consumer, as Pillow does by default).
"""

from __future__ import annotations

import logging

import numpy as np

from ..image import ColorSpace, GrkImage, ImageComponent

log = logging.getLogger("grok_tpu_torch")


def apply_palette(img: GrkImage) -> None:
    pal = img.meta.palette
    if pal.lut is None or not pal.component_mapping:
        return
    src_comps = img.comps
    ncols = pal.lut.shape[1]
    for (cmp_, typ, col) in pal.component_mapping:
        # cmap indices come straight off an untrusted stream: a bad
        # component or palette-column reference must degrade gracefully,
        # not IndexError out of the decode
        if cmp_ >= len(src_comps) or col >= ncols \
                or col >= len(pal.channel_prec):
            log.warning("cmap references component %d / palette column "
                        "%d outside the image; palette not applied",
                        cmp_, col)
            return
    out = []
    for (cmp_, typ, col) in pal.component_mapping:
        src = src_comps[cmp_]
        if typ == 1:  # palette mapping
            idx = np.clip(src.data, 0, pal.lut.shape[0] - 1)
            c = ImageComponent(
                dx=src.dx, dy=src.dy, prec=pal.channel_prec[col],
                sgnd=pal.channel_sgnd[col])
            c.data = pal.lut[idx, col].astype(np.int32)
            c.w, c.h, c.x0, c.y0 = src.w, src.h, src.x0, src.y0
            out.append(c)
        else:  # direct use
            out.append(src)
    img.comps = out
    img.meta.palette = None


def apply_channel_definitions(img: GrkImage) -> None:
    defs = img.meta.channel_definitions
    if not defs:
        return
    order = sorted(defs, key=lambda d: (d[1] != 0, d[2]))  # colors first
    new_comps = []
    seen = set()
    for (cn, typ, asoc) in order:
        if cn < len(img.comps):
            c = img.comps[cn]
            c.type = typ
            c.association = asoc
            new_comps.append(c)
            seen.add(id(c))
    for c in img.comps:
        if id(c) not in seen:
            new_comps.append(c)
    img.comps = new_comps
    img.meta.channel_definitions = None


def upsample_components(img: GrkImage) -> None:
    """Replicate-upsample subsampled components to dx=dy=1.  Canvas
    pixel (X, Y) takes sample (floor(Y/dy) - y0, floor(X/dx) - x0),
    clipped — a plain repeat-and-crop mis-sizes and mis-aligns images
    whose canvas origin is not grid-aligned (odd x0 with dx=2)."""
    h = img.y1 - img.y0
    w = img.x1 - img.x0
    for c in img.comps:
        if c.dx == 1 and c.dy == 1:
            continue
        xs = np.clip(np.arange(img.x0, img.x1) // c.dx - c.x0, 0, c.w - 1)
        ys = np.clip(np.arange(img.y0, img.y1) // c.dy - c.y0, 0, c.h - 1)
        c.data = c.data[np.ix_(ys, xs)]
        c.h, c.w = h, w
        c.dx = c.dy = 1
        c.x0, c.y0 = img.x0, img.y0


def sycc_to_rgb(img: GrkImage) -> None:
    """sYCC -> sRGB with 420/422/444 chroma upsampling."""
    if img.numcomps < 3:
        return
    y, cb, cr = img.comps[0], img.comps[1], img.comps[2]
    if any(c.dx != y.dx or c.dy != y.dy for c in (cb, cr)):
        upsample_components(img)
        y, cb, cr = img.comps[0], img.comps[1], img.comps[2]
    offset = 1 << (cb.prec - 1)
    yf = y.data.astype(np.float32)
    cbf = cb.data.astype(np.float32) - offset
    crf = cr.data.astype(np.float32) - offset
    r = yf + 1.402 * crf
    g = yf - 0.344136 * cbf - 0.714136 * crf
    b = yf + 1.772 * cbf
    mx = (1 << y.prec) - 1
    for comp, vals in zip((y, cb, cr), (r, g, b)):
        comp.data = np.clip(np.round(vals), 0, mx).astype(np.int32)
        comp.prec = y.prec
        comp.sgnd = False  # offset-encoded chroma is unsigned sRGB now
    img.color_space = ColorSpace.SRGB


def eycc_to_rgb(img: GrkImage) -> None:
    """e-sYCC -> sRGB (JP2 EnumCS 24): the extended-gamut inverse matrix
    (ITU-T T.801 / OpenJPEG color_esycc_to_rgb constants), honoring
    signed chroma components (common for e-sYCC)."""
    if img.numcomps < 3:
        return
    y, cb, cr = img.comps[0], img.comps[1], img.comps[2]
    if any(c.dx != y.dx or c.dy != y.dy for c in (cb, cr)):
        upsample_components(img)
        y, cb, cr = img.comps[0], img.comps[1], img.comps[2]
    yf = y.data.astype(np.float32)
    cbf = cb.data.astype(np.float32)
    crf = cr.data.astype(np.float32)
    if not cb.sgnd:
        cbf -= 1 << (cb.prec - 1)
    if not cr.sgnd:
        crf -= 1 << (cr.prec - 1)
    r = 1.000000 * yf - 0.0000368 * cbf + 1.40199 * crf
    g = 1.000300 * yf - 0.3441250 * cbf - 0.71411280 * crf
    b = 0.999823 * yf + 1.7720400 * cbf + 0.00000410 * crf
    mx = (1 << y.prec) - 1
    for comp, vals in zip((y, cb, cr), (r, g, b)):
        comp.data = np.clip(np.round(vals), 0, mx).astype(np.int32)
        comp.prec = y.prec
        comp.sgnd = False
    img.color_space = ColorSpace.SRGB


def cielab_to_srgb(img: GrkImage) -> None:
    """CIELab -> sRGB (JP2 EnumCS 14) via Lab -> XYZ(D50) -> linear sRGB,
    replacing the reference's littlecms path with direct math (SURVEY.md
    §2.1 GrkImage 'CIELab->sRGB via lcms2').  Assumes the default Lab
    encoding ranges (L in [0,100], a/b in [-85,85]/[-75,125] per the JP2
    default Lab parameters, approximated by the common [-128,127]).

    util/icc.py walks the same Lab -> XYZ(D50) -> sRGB pipeline for
    Lab-PCS A2B profiles but adapts D50 -> D65 in a separate Bradford
    step; this path uses the equivalent single-step combined matrix.
    Keep the CIE knee constants in sync if either changes."""
    if img.numcomps < 3:
        return
    L, a, b = (c.data.astype(np.float64) for c in img.comps[:3])
    prec = img.comps[0].prec
    mx = (1 << prec) - 1
    Lf = L / mx * 100.0
    # signed a/b components already carry their offset; unsigned ones
    # are offset-encoded around 2^(prec-1)
    if img.comps[1].sgnd:
        af = a / (mx / 2.0) * 127.5
    else:
        af = a / mx * 255.0 - 128.0
    if img.comps[2].sgnd:
        bf = b / (mx / 2.0) * 127.5
    else:
        bf = b / mx * 255.0 - 128.0
    fy = (Lf + 16.0) / 116.0
    fx = fy + af / 500.0
    fz = fy - bf / 200.0

    def finv(t):
        # exact CIE constants (eps = 216/24389, kappa = 24389/27): the
        # legacy 0.008856/7.787 approximations leave a visible seam at
        # the knee vs the lcms reference
        t3 = t ** 3
        return np.where(t3 > 216.0 / 24389.0, t3,
                        (116.0 * t - 16.0) / (24389.0 / 27.0))

    # D50 white point
    X = finv(fx) * 0.9642
    Y = finv(fy) * 1.0
    Z = finv(fz) * 0.8249
    # XYZ (D50) -> linear sRGB (Bradford-adapted matrix)
    r = 3.1338561 * X - 1.6168667 * Y - 0.4906146 * Z
    g = -0.9787684 * X + 1.9161415 * Y + 0.0334540 * Z
    bl = 0.0719453 * X - 0.2289914 * Y + 1.4052427 * Z

    def gamma(u):
        u = np.clip(u, 0.0, 1.0)
        return np.where(u <= 0.0031308, 12.92 * u,
                        1.055 * u ** (1 / 2.4) - 0.055)

    for comp, vals in zip(img.comps[:3], (r, g, bl)):
        comp.data = np.clip(np.round(gamma(vals) * mx), 0, mx).astype(
            np.int32)
        comp.prec = prec
        # signed a/b planes hold unsigned sRGB now: a signed output
        # dtype (raw/PGX writers) would wrap values >= 2^(prec-1)
        comp.sgnd = False
    img.color_space = ColorSpace.SRGB


def cmyk_to_rgb(img: GrkImage) -> None:
    """Naive CMYK -> RGB (JP2 EnumCS 12): R = (1-C)(1-K) etc., integer."""
    if img.numcomps < 4:
        return
    if any(c.dx != img.comps[0].dx or c.dy != img.comps[0].dy
           for c in img.comps[:4]):
        upsample_components(img)  # subsampled ink planes (e.g. K)
    c, m, yc, k = (comp.data.astype(np.float32) for comp in img.comps[:4])
    mx = (1 << img.comps[0].prec) - 1
    r = (mx - c) * (mx - k) / mx
    g = (mx - m) * (mx - k) / mx
    b = (mx - yc) * (mx - k) / mx
    out = []
    for vals in (r, g, b):
        comp = img.comps[0].copy()
        comp.data = np.clip(np.round(vals), 0, mx).astype(np.int32)
        comp.sgnd = False
        out.append(comp)
    # extra channels (e.g. alpha) survive the ink-plane consolidation
    img.comps = out + list(img.comps[4:])
    img.color_space = ColorSpace.SRGB


def apply_icc_profile(img: GrkImage) -> None:
    """Apply an embedded ICC profile, converting to sRGB (the reference
    delegates to littlecms; we reach the same lcms2 through Pillow's
    ImageCms).  RGB/gray/CMYK layouts; others keep the profile
    attached for the consumer.  CMYK consumes four ink planes and
    yields three sRGB planes (extra channels survive)."""
    if not img.meta.icc_profile:
        return
    try:
        import io as _io

        from PIL import Image, ImageCms
    except ImportError:  # pragma: no cover
        log.warning("Pillow ImageCms unavailable; ICC profile not applied")
        return
    comps = img.comps
    is_cmyk = (len(img.meta.icc_profile) >= 20
               and img.meta.icc_profile[16:20] == b"CMYK"
               and len(comps) >= 4)
    ncolor = 4 if is_cmyk else (3 if len(comps) >= 3 else 1)
    # eligibility is judged on the COLOR components only: a 1-bit alpha
    # next to an 8-bit gray plane must not force the high-precision path
    if any(c.sgnd for c in comps[:ncolor]) or \
            len({c.data.shape for c in comps[:ncolor]}) != 1:
        log.warning("ICC application needs unsigned, unsubsampled "
                    "components; profile left attached")
        return
    if any(c.prec != 8 for c in comps[:ncolor]):
        # Pillow's ImageCms cannot build >8-bit transforms (every 16-bit
        # mode fails with "cannot build transform" on Pillow 12.1), so
        # high-precision images go through our own matrix/TRC evaluator
        # (util/icc.py) at full float64 precision; LUT profiles fall back
        # with the profile left attached.
        if len({c.prec for c in comps[:ncolor]}) != 1:
            # the evaluator normalizes every plane by comps[0].prec, so
            # mixed-precision color (e.g. 16/12/12) would mis-scale
            # channels 1-2
            log.warning("ICC application needs uniform component "
                        "precision; profile left attached")
            return
        from . import icc as icc_mod

        res = icc_mod.profile_to_srgb(
            [c.data for c in comps], img.meta.icc_profile,
            comps[0].prec)
        if res is None:
            log.warning("ICC profile outside the matrix/TRC class at "
                        ">8-bit precision; profile left attached")
            return
        # CMYK: res is [R, G, B, extras...] while comps is
        # [C, M, Y, K, extras...] — the K plane is consumed
        out_comps = (list(comps[:3]) + list(comps[4:]) if is_cmyk
                     else list(comps))
        for c, plane in zip(out_comps, res):
            c.data = plane
            if is_cmyk:
                c.sgnd = False
        img.comps = out_comps
        if ncolor >= 3:
            img.color_space = ColorSpace.SRGB
        img.meta.icc_profile = None
        return
    if is_cmyk:
        arr = np.stack([c.data for c in comps[:4]], axis=-1)
        mode = "CMYK"
    elif len(comps) >= 3:
        arr = np.stack([c.data for c in comps[:3]], axis=-1)
        mode = "RGB"
    else:
        arr = comps[0].data
        mode = "L"
    pil = Image.fromarray(arr.astype(np.uint8), mode)
    try:
        src = ImageCms.ImageCmsProfile(_io.BytesIO(img.meta.icc_profile))
        dst = ImageCms.createProfile("sRGB")
        out = ImageCms.profileToProfile(pil, src, dst,
                                        outputMode="RGB")
    except Exception as e:
        log.warning("ICC application failed: %s", e)
        return
    res = np.asarray(out).astype(np.int32)
    new_comps = []
    for i in range(3):
        c = comps[i] if i < ncolor else comps[0].copy()
        c.data = res[..., i]
        new_comps.append(c)
    # keep non-color channels (alpha of gray+alpha or RGB+alpha images)
    img.comps = new_comps + list(comps[ncolor:])
    img.color_space = ColorSpace.SRGB
    img.meta.icc_profile = None


def shift_precision(img: GrkImage, precisions: list[int]) -> None:
    """Scale components to the requested precisions (CLI -p parity)."""
    for i, c in enumerate(img.comps):
        want = precisions[i] if i < len(precisions) else precisions[-1]
        if want == c.prec:
            continue
        if want > c.prec:
            c.data = (c.data.astype(np.int64) << (want - c.prec)).astype(
                np.int32)
        else:
            c.data = (c.data.astype(np.int64) >> (c.prec - want)).astype(
                np.int32)
        c.prec = want
