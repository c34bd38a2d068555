"""Minimal ICC profile application for high-precision images.

Parity: the reference applies embedded ICC profiles through lcms2 at any
bit depth (ref: src/lib/core/util/GrkImage_Conversion.cpp [P]).  Pillow's
ImageCms only builds 8-bit transforms (verified on Pillow 12.1: every
16-bit mode fails with "cannot build transform"), so the >8-bit path here
evaluates the common matrix/TRC profile class directly in float64:

    device RGB --rTRC/gTRC/bTRC--> linear RGB --rXYZ/gXYZ/bXYZ--> XYZ(D50)
              --Bradford D50->D65--> XYZ(D65) --sRGB matrix + EOTF--> sRGB

Monochrome profiles use kTRC -> Y -> sRGB gray.  LUT-based A2B0
profiles of the lut8Type/lut16Type class ('mft1'/'mft2', ICC.1 §10.8-9)
evaluate the full pipeline — 3x3 matrix, input curves, multi-dimensional
CLUT with lcms-matching TETRAHEDRAL interpolation, output curves — into
the PCS (XYZ u1.15 or legacy 16-bit/8-bit Lab encoding), then share the
Bradford + sRGB tail with the matrix/TRC path.  CMYK device spaces run
the same mft pipeline with a 4-input CLUT (lcms Eval4Inputs order:
linear along the first channel, tetrahedral over the rest).  v4 'mAB '
(lutAtoBType) pipelines evaluate A curves -> per-axis-grid CLUT -> M
curves -> 3x4 matrix -> B curves with v4 XYZ/Lab PCS encodings.  Curve
types handled: 'curv' (identity / u8.8 gamma / sampled table) and 'para'
(types 0-4, ICC.1 §10.18).
"""

from __future__ import annotations

import struct

import numpy as np

# Bradford-adapted D50 -> D65 chromatic adaptation (ICC PCS is D50)
_D50_TO_D65 = np.array([
    [0.9555766, -0.0230393, 0.0631636],
    [-0.0282895, 1.0099416, 0.0210077],
    [0.0122982, -0.0204830, 1.3299098]])

# XYZ(D65) -> linear sRGB
_XYZ_TO_SRGB = np.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252]])


class UnsupportedProfile(Exception):
    pass


def _tags(icc: bytes) -> dict[bytes, bytes]:
    if len(icc) < 132:
        raise UnsupportedProfile("profile too short")
    (count,) = struct.unpack(">I", icc[128:132])
    if count > 1024:
        raise UnsupportedProfile("implausible tag count")
    out = {}
    for i in range(count):
        off = 132 + 12 * i
        sig, toff, size = struct.unpack(">4sII", icc[off:off + 12])
        if toff + size > len(icc):
            raise UnsupportedProfile("tag out of bounds")
        out[sig] = icc[toff:toff + size]
    return out


def _xyz(tag: bytes) -> np.ndarray:
    if tag[:4] != b"XYZ " or len(tag) < 20:
        raise UnsupportedProfile("bad XYZ tag")
    return np.array(struct.unpack(">iii", tag[8:20]), dtype=np.float64) \
        / 65536.0


def _curve(tag: bytes):
    """Returns f(x)->linear for x in [0,1], vectorized."""
    kind = tag[:4]
    if kind == b"curv":
        (n,) = struct.unpack(">I", tag[8:12])
        if n == 0:
            return lambda x: x
        if n == 1:
            (g,) = struct.unpack(">H", tag[12:14])
            gamma = g / 256.0
            return lambda x: np.power(np.clip(x, 0.0, 1.0), gamma)
        if 12 + 2 * n > len(tag):
            # declared count exceeds the tag: a corrupt profile must not
            # drive a huge linspace allocation below
            raise UnsupportedProfile("curv table out of bounds")
        table = np.frombuffer(tag[12:12 + 2 * n],
                              dtype=">u2").astype(np.float64) / 65535.0
        xs = np.linspace(0.0, 1.0, n)
        return lambda x: np.interp(np.clip(x, 0.0, 1.0), xs, table)
    if kind == b"para":
        (ftype,) = struct.unpack(">H", tag[8:10])
        nparams = {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}.get(ftype)
        if nparams is None:
            raise UnsupportedProfile("parametric curve type")
        vals = struct.unpack(f">{nparams}i",
                             tag[12:12 + 4 * nparams])
        g, a, b, c, d, e, f = (list(np.array(vals) / 65536.0)
                               + [0.0] * 7)[:7]

        def para(x, g=g, a=a, b=b, c=c, d=d, e=e, f=f, ftype=ftype):
            # a == 0 or a*x+b < 0 would produce inf/NaN; clamp the power
            # base at 0 (the ICC convention for out-of-domain input) and
            # the caller's finite check catches anything else
            x = np.clip(x, 0.0, 1.0)
            with np.errstate(invalid="ignore", divide="ignore"):
                pw = np.power(np.maximum(a * x + b, 0.0), g)
                # a == 0: the domain condition a*x+b >= 0 is constant —
                # always satisfied when b >= 0, never otherwise
                knee = ((-b / a) if a != 0.0
                        else (-np.inf if b >= 0.0 else np.inf))
                if ftype == 0:
                    return np.power(x, g)
                if ftype == 1:
                    return np.where(x >= knee, pw, 0.0)
                if ftype == 2:
                    return np.where(x >= knee, pw + c, c)
                if ftype == 3:
                    return np.where(x >= d, pw, c * x)
                return np.where(x >= d, pw + e, c * x + f)
        return para
    raise UnsupportedProfile("curve tag kind")


def _srgb_encode(lin: np.ndarray) -> np.ndarray:
    lin = np.clip(lin, 0.0, 1.0)
    return np.where(lin <= 0.0031308, 12.92 * lin,
                    1.055 * np.power(lin, 1 / 2.4) - 0.055)


# ---------------------------------------------------------- LUT (A2B0)

# D50 PCS white point (ICC.1 Annex A)
_D50 = np.array([0.9642, 1.0, 0.8249])


def _parse_mft(tag: bytes):
    """Parse an 'mft1' (lut8) / 'mft2' (lut16) tag.  Returns (matrix,
    input_tables, clut, output_tables, in_ch, out_ch, grid) with every
    table normalized to float64 in [0, 1]."""
    kind = tag[:4]
    if kind not in (b"mft1", b"mft2") or len(tag) < 48:
        raise UnsupportedProfile("not an mft LUT")
    in_ch, out_ch, grid = tag[8], tag[9], tag[10]
    if not (1 <= in_ch <= 4) or not (1 <= out_ch <= 4) or grid < 2:
        raise UnsupportedProfile("LUT channel/grid out of range")
    mat = np.array(struct.unpack(">9i", tag[12:48]),
                   dtype=np.float64).reshape(3, 3) / 65536.0
    if kind == b"mft2":
        n_in, n_out = struct.unpack(">HH", tag[48:52])
        off = 52
        width, scale, dt = 2, 65535.0, ">u2"
    else:
        n_in = n_out = 256
        off = 48
        width, scale, dt = 1, 255.0, ">u1"
    need = off + width * (in_ch * n_in + (grid ** in_ch) * out_ch
                          + out_ch * n_out)
    if n_in < 2 or n_out < 2 or need > len(tag):
        raise UnsupportedProfile("LUT tables out of bounds")

    def read(count):
        nonlocal off
        arr = np.frombuffer(tag[off:off + width * count],
                            dtype=dt).astype(np.float64) / scale
        off += width * count
        return arr

    in_tabs = [read(n_in) for _ in range(in_ch)]
    clut = read((grid ** in_ch) * out_ch).reshape((grid,) * in_ch
                                                  + (out_ch,))
    out_tabs = [read(n_out) for _ in range(out_ch)]
    return mat, in_tabs, clut, out_tabs, in_ch, out_ch, grid


def _interp1d(table: np.ndarray, x: np.ndarray) -> np.ndarray:
    xs = np.linspace(0.0, 1.0, len(table))
    return np.interp(np.clip(x, 0.0, 1.0), xs, table)


def _tetrahedral3(clut: np.ndarray, x: np.ndarray,
                  idx0: np.ndarray | None = None) -> np.ndarray:
    """Tetrahedral interpolation of a (g, g, g, out_ch) CLUT at
    x: (3, ...) in [0, 1] — the interpolant lcms2 uses for 3-input
    CLUTs, so 8-bit results track ImageCms within an LSB.  With idx0
    (per-sample integer index), clut is (g, g, g, g, out_ch) and the
    evaluation runs in the idx0 slice of the leading dimension (the
    4-input path's inner step).  Per-axis grid sizes (mAB CLUTs declare
    one per input channel) are taken from clut.shape."""
    dims = np.array(clut.shape[-4:-1], dtype=np.int64) - 1  # g-1 per axis
    shp = (3,) + (1,) * (x.ndim - 1)
    p = np.clip(x, 0.0, 1.0) * dims.reshape(shp)
    i = np.minimum(p.astype(np.int64), (dims - 1).reshape(shp))
    r = p - i
    ix, iy, iz = i[0], i[1], i[2]
    rx, ry, rz = r[0], r[1], r[2]

    def c(dx, dy, dz):
        if idx0 is None:
            return clut[ix + dx, iy + dy, iz + dz]
        return clut[idx0, ix + dx, iy + dy, iz + dz]

    c000 = c(0, 0, 0)
    c100, c010, c001 = c(1, 0, 0), c(0, 1, 0), c(0, 0, 1)
    c110, c101, c011 = c(1, 1, 0), c(1, 0, 1), c(0, 1, 1)
    c111 = c(1, 1, 1)
    rx_, ry_, rz_ = rx[..., None], ry[..., None], rz[..., None]
    # the six tetrahedra, in lcms2's comparison order
    m1 = (rx >= ry) & (ry >= rz)
    m2 = (rx >= rz) & (rz >= ry)
    m3 = (rz >= rx) & (rx >= ry)
    m4 = (ry >= rx) & (rx >= rz)
    m5 = (ry >= rz) & (rz >= rx)
    t1 = c000 + rx_ * (c100 - c000) + ry_ * (c110 - c100) \
        + rz_ * (c111 - c110)
    t2 = c000 + rx_ * (c100 - c000) + rz_ * (c101 - c100) \
        + ry_ * (c111 - c101)
    t3 = c000 + rz_ * (c001 - c000) + rx_ * (c101 - c001) \
        + ry_ * (c111 - c101)
    t4 = c000 + ry_ * (c010 - c000) + rx_ * (c110 - c010) \
        + rz_ * (c111 - c110)
    t5 = c000 + ry_ * (c010 - c000) + rz_ * (c011 - c010) \
        + rx_ * (c111 - c011)
    t6 = c000 + rz_ * (c001 - c000) + ry_ * (c011 - c001) \
        + rx_ * (c111 - c011)
    m = np.broadcast_to
    sel = np.where(m(m1[..., None], t1.shape), t1,
                   np.where(m(m2[..., None], t1.shape), t2,
                            np.where(m(m3[..., None], t1.shape), t3,
                                     np.where(m(m4[..., None], t1.shape),
                                              t4,
                                              np.where(m(m5[..., None],
                                                         t1.shape),
                                                       t5, t6)))))
    return sel


def _eval_clut4(clut: np.ndarray, x: np.ndarray) -> np.ndarray:
    """4-input CLUT evaluation matching lcms2 Eval4Inputs: linear
    interpolation along the FIRST input channel between two 3-input
    tetrahedral evaluations of the remaining channels."""
    g = clut.shape[0]
    p0 = np.clip(x[0], 0.0, 1.0) * (g - 1)
    k = np.minimum(p0.astype(np.int64), g - 2)
    t = (p0 - k)[..., None]
    lo = _tetrahedral3(clut, x[1:], idx0=k)
    hi = _tetrahedral3(clut, x[1:], idx0=k + 1)
    return lo + t * (hi - lo)


def _lab_to_xyz_d50(L, a, b):
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def finv(t):
        d = 6.0 / 29.0
        return np.where(t > d, t ** 3, 3.0 * d * d * (t - 4.0 / 29.0))

    return np.stack([finv(fx) * _D50[0], finv(fy) * _D50[1],
                     finv(fz) * _D50[2]])


def _apply_a2b_lut(planes, a2b: bytes, pcs: bytes,
                   peak: float) -> np.ndarray:
    """Run 3 (RGB) or 4 (CMYK) device planes through an mft1/mft2 A2B0
    pipeline; returns XYZ(D50) stacked (3, h, w)."""
    mat, in_tabs, clut, out_tabs, in_ch, out_ch, _g = _parse_mft(a2b)
    if in_ch not in (3, 4) or out_ch != 3 or len(planes) < in_ch:
        raise UnsupportedProfile("unsupported LUT pipeline shape")
    x = np.stack([p.astype(np.float64) / peak for p in planes[:in_ch]])
    if in_ch == 3 and not np.allclose(mat, np.eye(3)):
        # per ICC.1 the matrix is only meaningful for XYZ input data;
        # lcms applies it unconditionally — but only builds the matrix
        # stage for 3-channel input, so 4-channel LUTs skip it
        x = np.einsum("ij,jhw->ihw", mat, x)
    x = np.stack([_interp1d(in_tabs[i], x[i]) for i in range(in_ch)])
    out = (_tetrahedral3(clut, x) if in_ch == 3
           else _eval_clut4(clut, x))      # (h, w, 3)
    out = np.stack([_interp1d(out_tabs[i], out[..., i])
                    for i in range(3)])
    is16 = a2b[:4] == b"mft2"
    if pcs == b"XYZ ":
        # PCS XYZ: u1.15 encoding (0x8000 = 1.0)
        return out * (65535.0 / 32768.0)
    if pcs == b"Lab ":
        if is16:
            # legacy 16-bit Lab: L on 0..0xFF00, a/b offset 0x8000
            raw = out * 65535.0
            L = raw[0] * 100.0 / 65280.0
            a = raw[1] / 256.0 - 128.0
            b = raw[2] / 256.0 - 128.0
        else:
            raw = out * 255.0
            L = raw[0] * 100.0 / 255.0
            a = raw[1] - 128.0
            b = raw[2] - 128.0
        return _lab_to_xyz_d50(L, a, b)
    raise UnsupportedProfile("PCS")


def _read_mab_curves(tag: bytes, off: int, count: int):
    """`count` consecutive curve elements ('curv'/'para', each padded to
    a 4-byte boundary) starting at tag[off:] — the A/M/B curve lists of
    a lutAtoBType (ICC.1 §10.12)."""
    curves = []
    for _ in range(count):
        if off + 12 > len(tag):
            raise UnsupportedProfile("mAB curve list out of bounds")
        kind = tag[off:off + 4]
        if kind == b"curv":
            (n,) = struct.unpack(">I", tag[off + 8:off + 12])
            size = 12 + 2 * n
        elif kind == b"para":
            (ftype,) = struct.unpack(">H", tag[off + 8:off + 10])
            nparams = {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}.get(ftype)
            if nparams is None:
                raise UnsupportedProfile("parametric curve type")
            size = 12 + 4 * nparams
        else:
            raise UnsupportedProfile("mAB curve element kind")
        if off + size > len(tag):
            raise UnsupportedProfile("mAB curve out of bounds")
        curves.append(_curve(tag[off:off + size]))
        off += size + ((-size) % 4)
    return curves


def _apply_mab_lut(planes, tag: bytes, pcs: bytes,
                   peak: float) -> np.ndarray:
    """Run device planes through a v4 'mAB ' (lutAtoBType) pipeline:
    A curves -> CLUT -> M curves -> matrix -> B curves (ICC.1 §10.12;
    absent elements are identity).  Returns XYZ(D50) stacked (3, h, w).
    Ref: GrkImage_Conversion.cpp applies any profile via lcms2 [P]."""
    if tag[:4] != b"mAB " or len(tag) < 32:
        raise UnsupportedProfile("not an mAB LUT")
    in_ch, out_ch = tag[8], tag[9]
    off_b, off_mat, off_m, off_clut, off_a = struct.unpack(
        ">5I", tag[12:32])
    if out_ch != 3 or in_ch not in (3, 4) or len(planes) < in_ch:
        raise UnsupportedProfile("unsupported mAB pipeline shape")
    x = np.stack([p.astype(np.float64) / peak for p in planes[:in_ch]])

    if off_clut:
        if off_a:
            a_curves = _read_mab_curves(tag, off_a, in_ch)
            x = np.stack([a_curves[i](x[i]) for i in range(in_ch)])
        if off_clut + 20 > len(tag):
            raise UnsupportedProfile("mAB CLUT header out of bounds")
        grids = tag[off_clut:off_clut + 16][:in_ch]
        prec_b = tag[off_clut + 16]
        if any(g < 2 for g in grids) or prec_b not in (1, 2):
            raise UnsupportedProfile("mAB CLUT grid/precision")
        n = int(np.prod([int(g) for g in grids])) * out_ch
        width, scale, dt = ((1, 255.0, "u1") if prec_b == 1
                            else (2, 65535.0, ">u2"))
        data_off = off_clut + 20
        if data_off + width * n > len(tag):
            raise UnsupportedProfile("mAB CLUT data out of bounds")
        clut = np.frombuffer(tag[data_off:data_off + width * n],
                             dtype=dt).astype(np.float64) / scale
        clut = clut.reshape(tuple(int(g) for g in grids) + (out_ch,))
        x = (_tetrahedral3(clut, x) if in_ch == 3
             else _eval_clut4(clut, x))        # (h, w, 3)
        x = np.stack([x[..., i] for i in range(3)])
    elif in_ch != 3 or off_a:
        # without a CLUT the pipeline cannot change channel count, and
        # A curves are only present when a CLUT is (§10.12)
        raise UnsupportedProfile("mAB missing CLUT")
    if off_m:
        m_curves = _read_mab_curves(tag, off_m, 3)
        x = np.stack([m_curves[i](x[i]) for i in range(3)])
    if off_mat:
        if off_mat + 48 > len(tag):
            raise UnsupportedProfile("mAB matrix out of bounds")
        vals = np.array(struct.unpack(">12i", tag[off_mat:off_mat + 48]),
                        dtype=np.float64) / 65536.0
        x = np.einsum("ij,jhw->ihw", vals[:9].reshape(3, 3), x) \
            + vals[9:].reshape(3, 1, 1)
    if off_b:
        b_curves = _read_mab_curves(tag, off_b, 3)
        x = np.stack([b_curves[i](x[i]) for i in range(3)])
    if pcs == b"XYZ ":
        return x * (65535.0 / 32768.0)        # u1.15
    if pcs == b"Lab ":
        # v4 16-bit Lab encoding (ICC.1 §6.3.4.2): the FULL 0..1 range
        # maps L to [0, 100] and a/b to [-128, +127] (unlike legacy v2
        # Lab, whose top code is 0xFF00 and a/b reach 127+255/256)
        L = x[0] * 100.0
        a = x[1] * 255.0 - 128.0
        b = x[2] * 255.0 - 128.0
        return _lab_to_xyz_d50(L, a, b)
    raise UnsupportedProfile("PCS")


def profile_to_srgb(planes: list[np.ndarray], icc: bytes,
                    prec: int) -> list[np.ndarray] | None:
    """Convert device planes (len 1, 3 or 4, unsigned, `prec` bits) to
    sRGB at the same precision.  Returns None for profiles outside the
    matrix/TRC class (the caller warns and keeps the profile attached).
    CMYK profiles consume four planes and return three (+ extras)."""
    def xyz_tail(xyz_d50, extras):
        xyz_d65 = np.einsum("ij,jhw->ihw", _D50_TO_D65, xyz_d50)
        srgb_lin = np.einsum("ij,jhw->ihw", _XYZ_TO_SRGB, xyz_d65)
        if not np.isfinite(srgb_lin).all():
            # degenerate curves/matrices: keep the profile attached
            # rather than writing NaN/inf-derived samples (check
            # BEFORE the encode clip maps inf to 1.0)
            return None
        enc = _srgb_encode(srgb_lin)
        out = np.rint(enc * peak).astype(np.int64)
        return [np.clip(out[i], 0, int(peak)).astype(np.int32)
                for i in range(3)] + list(extras)

    try:
        tags = _tags(icc)
        peak = float((1 << prec) - 1)
        a2b = tags.get(b"A2B0")
        lut_kinds = (b"mft1", b"mft2", b"mAB ")
        def a2b_eval(dev_planes):
            if a2b[:4] == b"mAB ":
                return _apply_mab_lut(dev_planes, a2b, icc[20:24], peak)
            return _apply_a2b_lut(dev_planes, a2b, icc[20:24], peak)
        if len(planes) >= 4 and a2b is not None \
                and a2b[:4] in lut_kinds \
                and icc[16:20] == b"CMYK":
            # 4-ink device space: the A2B0 LUT is the only device->PCS
            # description a CMYK profile carries
            return xyz_tail(a2b_eval(planes[:4]), planes[4:])
        if len(planes) >= 3 and a2b is not None \
                and a2b[:4] in lut_kinds \
                and icc[16:20] == b"RGB ":
            # lcms prefers the A2B pipeline over matrix/TRC when both
            # are present, so mirror that order
            return xyz_tail(a2b_eval(planes[:3]), planes[3:])
        if len(planes) >= 3 and all(
                t in tags for t in (b"rXYZ", b"gXYZ", b"bXYZ",
                                    b"rTRC", b"gTRC", b"bTRC")):
            mat = np.stack([_xyz(tags[b"rXYZ"]), _xyz(tags[b"gXYZ"]),
                            _xyz(tags[b"bXYZ"])], axis=1)
            lin = [
                _curve(tags[t])(planes[i].astype(np.float64) / peak)
                for i, t in enumerate((b"rTRC", b"gTRC", b"bTRC"))]
            xyz_d50 = np.einsum("ij,jhw->ihw", mat, np.stack(lin))
            return xyz_tail(xyz_d50, planes[3:])
        if b"kTRC" in tags and (len(planes) < 3
                                or icc[16:20] == b"GRAY"):
            # a monochrome (kTRC-only) profile converts plane 0 alone:
            # applying it to an RGB image would leave planes 1-2 as raw
            # device values while the caller marks the image sRGB
            y = _curve(tags[b"kTRC"])(
                planes[0].astype(np.float64) / peak)
            if not np.isfinite(y).all():
                return None
            enc = _srgb_encode(y)
            out = np.clip(np.rint(enc * peak), 0, peak).astype(np.int32)
            return [out] + [p for p in planes[1:]]
        return None
    except UnsupportedProfile:
        return None
    except (struct.error, IndexError, ValueError):
        return None
