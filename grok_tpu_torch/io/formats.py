"""Image-format I/O for the CLI tools.

Parity: src/bin/image_format/ (SURVEY.md §2.2 "Image formats"): TIFF, PNG,
JPEG, BMP, PNM/PAM (+split), PGX (conformance-suite format), RAW/RAWL.
General formats go through Pillow (the host I/O stack per SURVEY.md
§2.4), imported only when such a file is read or written; PGX and RAW are
implemented natively here since Pillow lacks them, and so are the binary
PGM/PPM files Pillow reads and writes losslessly (P5 at 8 and 16 bits, P6
at 8 bits), byte for byte as Pillow does, so that the codec's PNM path
needs no Pillow.
"""

from __future__ import annotations

import logging
import os
import re

import numpy as np

from ..errors import GrkError, ParamError
from ..image import ColorSpace, GrkImage, ImageComponent

log = logging.getLogger("grok_tpu_torch")

PIL_FORMATS = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".pnm",
               ".pgm", ".ppm", ".pbm", ".pam"}
J2K_FORMATS = {".j2k", ".j2c", ".jp2", ".jpc", ".jph", ".jhc"}


def sniff_format(path: str) -> str:
    return os.path.splitext(path)[1].lower()


# --------------------------------------------------------------------- PGX

_PGX_HEADER = re.compile(
    rb"PG\s*(?P<endian>ML|LM)?\s*(?P<sign>[+-])?\s*(?P<prec>\d+)"
    rb"\s+(?P<w>\d+)\s+(?P<h>\d+)\s")


def read_pgx(path: str) -> GrkImage:
    with open(path, "rb") as f:
        data = f.read()
    m = _PGX_HEADER.match(data)
    if not m:
        raise GrkError(f"{path}: not a PGX file")
    prec = int(m.group("prec"))
    sgnd = m.group("sign") == b"-"
    w = int(m.group("w"))
    h = int(m.group("h"))
    big = (m.group("endian") or b"ML") == b"ML"
    body = data[m.end():]
    nbytes = 1 if prec <= 8 else (2 if prec <= 16 else 4)
    dt = {1: "i1" if sgnd else "u1", 2: "i2" if sgnd else "u2",
          4: "i4" if sgnd else "u4"}[nbytes]
    dt = (">" if big else "<") + dt
    arr = np.frombuffer(body, dtype=dt, count=w * h).reshape(h, w)
    img = GrkImage(x0=0, y0=0, x1=w, y1=h, color_space=ColorSpace.GRAY)
    c = ImageComponent(prec=prec, sgnd=sgnd)
    c.data = arr.astype(np.int32)
    c.h, c.w = h, w
    img.comps.append(c)
    return img


def write_pgx(img: GrkImage, path: str) -> list[str]:
    """PGX holds one component per file; multi-component images write
    path_0.pgx, path_1.pgx, ... (reference behavior)."""
    base, ext = os.path.splitext(path)
    out = []
    for i, c in enumerate(img.comps):
        p = path if img.numcomps == 1 else f"{base}_{i}{ext or '.pgx'}"
        sign = "-" if c.sgnd else "+"
        header = f"PG ML {sign}{c.prec} {c.data.shape[1]} {c.data.shape[0]}\n"
        nbytes = 1 if c.prec <= 8 else (2 if c.prec <= 16 else 4)
        dt = {1: "i1" if c.sgnd else "u1", 2: "i2" if c.sgnd else "u2",
              4: "i4" if c.sgnd else "u4"}[nbytes]
        with open(p, "wb") as f:
            f.write(header.encode())
            f.write(c.data.astype(">" + dt).tobytes())
        out.append(p)
    return out


# --------------------------------------------------------------------- RAW

def parse_raw_descriptor(desc: str):
    """Parse the -F descriptor: `w,h,ncomp,bitdepth,[s|u]@dx1xdy1:...`
    (SURVEY.md §2.2 grk_compress)."""
    m = re.match(
        r"(\d+),(\d+),(\d+),(\d+),([su])(?:@(.*))?$", desc)
    if not m:
        raise ParamError(f"bad raw descriptor: {desc!r}")
    w, h, nc, prec = (int(m.group(i)) for i in range(1, 5))
    sgnd = m.group(5) == "s"
    subs = [(1, 1)] * nc
    if m.group(6):
        parts = m.group(6).split(":")
        for i, p in enumerate(parts[:nc]):
            dx, dy = p.split("x")
            subs[i] = (int(dx), int(dy))
    return w, h, nc, prec, sgnd, subs


def read_raw(path: str, desc: str, little_endian: bool = False) -> GrkImage:
    w, h, nc, prec, sgnd, subs = parse_raw_descriptor(desc)
    nbytes = 1 if prec <= 8 else (2 if prec <= 16 else 4)
    dt = {1: "i1" if sgnd else "u1", 2: "i2" if sgnd else "u2",
          4: "i4" if sgnd else "u4"}[nbytes]
    dt = ("<" if little_endian else ">") + dt
    img = GrkImage(x0=0, y0=0, x1=w, y1=h)
    img.color_space = ColorSpace.SRGB if nc >= 3 else ColorSpace.GRAY
    with open(path, "rb") as f:
        for i in range(nc):
            dx, dy = subs[i]
            cw = -(-w // dx)
            ch = -(-h // dy)
            buf = f.read(cw * ch * nbytes)
            c = ImageComponent(dx=dx, dy=dy, prec=prec, sgnd=sgnd)
            c.data = np.frombuffer(buf, dtype=dt, count=cw * ch) \
                .reshape(ch, cw).astype(np.int32)
            c.h, c.w = ch, cw
            img.comps.append(c)
    return img


def _pnm_token(f) -> bytes:
    tok = b""
    while True:
        ch = f.read(1)
        if not ch:
            raise ParamError("truncated PNM header")
        if ch in b" \t\r\n":
            if tok:
                return tok
            continue
        if ch == b"#":
            while ch and ch != b"\n":
                ch = f.read(1)
            continue
        tok += ch


def open_pnm_strips(path: str):
    """(meta GrkImage, reader) for a binary PGM/PPM file: the reader
    fetches rows from disk on demand, so `compress_strips` encodes the
    file in O(tile row) memory (grk_compress --stream-strips; the
    streaming-input dual of the decode side's strip writer)."""
    f = open(path, "rb")
    magic = f.read(2)
    if magic not in (b"P5", b"P6"):
        f.close()
        raise ParamError(
            "--stream-strips needs binary PGM (P5) or PPM (P6) input")
    nc = 3 if magic == b"P6" else 1
    w = int(_pnm_token(f))
    h = int(_pnm_token(f))
    maxval = int(_pnm_token(f))
    off = f.tell()  # the token reader consumed the single post-maxval ws
    prec = 8 if maxval < 256 else 16
    bps = 1 if maxval < 256 else 2
    stride = w * nc * bps
    dt = "u1" if bps == 1 else ">u2"  # PNM 16-bit is big-endian

    meta = GrkImage(x0=0, y0=0, x1=w, y1=h)
    meta.color_space = ColorSpace.SRGB if nc == 3 else ColorSpace.GRAY
    for _ in range(nc):
        c = ImageComponent(prec=prec, sgnd=False)
        c.w, c.h = w, h
        meta.comps.append(c)

    def reader(y0: int, rows: int) -> list[np.ndarray]:
        f.seek(off + y0 * stride)
        buf = f.read(rows * stride)
        if len(buf) != rows * stride:
            raise ParamError(f"{path}: truncated PNM body")
        a = np.frombuffer(buf, dtype=dt).reshape(rows, w, nc)
        return [a[:, :, i].astype(np.int32) for i in range(nc)]

    reader.close = f.close
    return meta, reader


def write_raw(img: GrkImage, path: str, little_endian: bool = False) -> None:
    with open(path, "wb") as f:
        for c in img.comps:
            nbytes = 1 if c.prec <= 8 else (2 if c.prec <= 16 else 4)
            dt = {1: "i1" if c.sgnd else "u1", 2: "i2" if c.sgnd else "u2",
                  4: "i4" if c.sgnd else "u4"}[nbytes]
            dt = ("<" if little_endian else ">") + dt
            f.write(c.data.astype(dt).tobytes())


# ------------------------------------------------------------- binary PNM

# (magic, maxval) pairs read and written here; the rest go through Pillow
_NATIVE_PNM = {(b"P5", 255), (b"P5", 65535), (b"P6", 255)}


def _pnm_header(f):
    """(magic, width, height, maxval, body offset) of a PNM file."""
    magic = f.read(2)
    if magic not in (b"P5", b"P6"):
        return magic, 0, 0, 0, 0
    w = int(_pnm_token(f))
    h = int(_pnm_token(f))
    maxval = int(_pnm_token(f))
    return magic, w, h, maxval, f.tell()


def read_pnm(path: str) -> GrkImage | None:
    """A binary PGM/PPM of the kinds in _NATIVE_PNM as read_pil reads it,
    or None for other PNM files."""
    with open(path, "rb") as f:
        try:
            magic, w, h, maxval, off = _pnm_header(f)
        except ValueError:
            return None
        if (magic, maxval) not in _NATIVE_PNM:
            return None
        nc = 3 if magic == b"P6" else 1
        dt = "u1" if maxval == 255 else ">u2"
        f.seek(off)
        body = f.read()
    n = w * h * nc
    if len(body) < n * np.dtype(dt).itemsize:
        raise GrkError(f"{path}: truncated PNM body")
    arr = np.frombuffer(body, dtype=dt, count=n).reshape(h, w, nc)
    img = GrkImage.from_array(arr, prec=8 if maxval == 255 else 16)
    if nc == 1:
        img.color_space = ColorSpace.GRAY
    return img


def _pnm_array(img: GrkImage, ext: str) -> np.ndarray | None:
    """write_pil's sample array for a PGM/PPM it writes losslessly or
    downshifts (one or three components), or None."""
    comps = img.comps
    if len({c.data.shape for c in comps}) > 1:
        from ..util import color as color_mod

        color_mod.upsample_components(img)
        comps = img.comps
    if len(comps) not in (1, 3):
        return None
    arr = np.stack([c.data for c in comps], axis=-1)
    prec = max(c.prec for c in comps)
    if prec <= 8:
        return arr.clip(0, 255).astype(np.uint8)
    arr = arr.clip(0, (1 << prec) - 1).astype(np.uint16)
    if len(comps) == 1:
        return arr
    log.warning(
        "multi-channel output at %d bits exceeds %s's 8-bit RGB "
        "support; downshifting to 8 bits — use a .pgx/.raw output "
        "or --split-pnm for a lossless route", prec, ext)
    return (arr >> (prec - 8)).astype(np.uint8)


def write_pnm(img: GrkImage, path: str, split_pnm: bool = False) -> bool:
    """Write a PGM/PPM as write_pil would, byte for byte; False (nothing
    written) for images write_pil writes otherwise."""
    ext = sniff_format(path)
    if split_pnm and ext in (".pnm", ".pgm") and len(img.comps) > 1:
        base, _ = os.path.splitext(path)
        for i, c in enumerate(img.comps):
            write_pnm(GrkImage(x0=img.x0, y0=img.y0, x1=img.x1, y1=img.y1,
                               comps=[c], color_space=ColorSpace.GRAY),
                      f"{base}_{i}.pgm")
        return True
    arr = _pnm_array(img, ext)
    if arr is None:
        return False
    h, w, nc = arr.shape
    magic = b"P6" if nc == 3 else b"P5"
    maxval = 255 if arr.dtype == np.uint8 else 65535
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n%d\n" % (w, h, maxval))
        f.write(arr.astype(">u2" if maxval > 255 else np.uint8).tobytes())
    return True


# ------------------------------------------------------------------ Pillow

def read_pil(path: str) -> GrkImage:
    from PIL import Image

    im = Image.open(path)
    if im.mode == "P":
        im = im.convert("RGB")
    arr = np.asarray(im)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8) * 255
    prec = 16 if arr.dtype in (np.uint16, np.int32, np.int16) else 8
    if arr.dtype == np.int32:  # Pillow 'I' mode
        arr = arr.astype(np.int64).clip(0, 65535).astype(np.uint16)
    img = GrkImage.from_array(np.atleast_3d(arr), prec=prec)
    if arr.ndim == 2 or arr.shape[2] == 1:
        img.color_space = ColorSpace.GRAY
    # carry ICC profile / resolution metadata if present
    icc = im.info.get("icc_profile")
    if icc:
        img.meta.icc_profile = icc
    exif = im.info.get("exif")
    if exif:
        img.meta.exif = exif
    dpi = im.info.get("dpi")
    if dpi:
        ppm = (dpi[1] * 39.3701, dpi[0] * 39.3701)
        img.meta.capture_resolution = ppm
    if arr.ndim == 3 and arr.shape[2] in (2, 4):
        # alpha channel: mark with cdef-style type
        img.comps[-1].type = 1
    return img


def write_pil(img: GrkImage, path: str, split_pnm: bool = False,
              tiff_compression: str | None = None) -> None:
    from PIL import Image

    ext = sniff_format(path)
    comps = img.comps
    if split_pnm and ext in (".pnm", ".pgm") and len(comps) > 1:
        base, _ = os.path.splitext(path)
        for i, c in enumerate(comps):
            sub = GrkImage(x0=img.x0, y0=img.y0, x1=img.x1, y1=img.y1,
                           comps=[c], color_space=ColorSpace.GRAY)
            write_pil(sub, f"{base}_{i}.pgm")
        return
    shapes = {c.data.shape for c in comps}
    if len(shapes) > 1:
        from ..util import color as color_mod

        color_mod.upsample_components(img)
        comps = img.comps
    arr = np.stack([c.data for c in comps], axis=-1)
    prec = max(c.prec for c in comps)
    if prec <= 8:
        arr = arr.clip(0, 255).astype(np.uint8)
    else:
        arr = arr.clip(0, (1 << prec) - 1).astype(np.uint16)
    if arr.shape[2] == 1:
        arr = arr[:, :, 0]
        im = Image.fromarray(arr)
    elif arr.shape[2] == 3:
        if arr.dtype == np.uint16:
            log.warning(
                "multi-channel output at %d bits exceeds %s's 8-bit RGB "
                "support; downshifting to 8 bits — use a .pgx/.raw output "
                "or --split-pnm for a lossless route", prec, ext)
            arr8 = (arr >> (prec - 8)).astype(np.uint8)
            im = Image.fromarray(arr8)
        else:
            im = Image.fromarray(arr)
    elif arr.shape[2] == 4:
        if arr.dtype == np.uint16:
            log.warning(
                "4-channel output at %d bits exceeds %s's 8-bit RGBA "
                "support; downshifting to 8 bits — use a .pgx/.raw output "
                "or --split-pnm for a lossless route", prec, ext)
            arr = (arr >> (prec - 8)).astype(np.uint8)
        im = Image.fromarray(arr.astype(np.uint8), "RGBA")
    else:
        im = Image.fromarray(arr[:, :, 0])
    kw = {}
    if img.meta.icc_profile:
        kw["icc_profile"] = img.meta.icc_profile
    if img.meta.exif and ext in (".jpg", ".jpeg", ".png", ".tif", ".tiff",
                                 ".webp"):
        kw["exif"] = img.meta.exif
    if ext in (".tif", ".tiff") and tiff_compression:
        kw["compression"] = tiff_compression
    im.save(path, **kw)


# -------------------------------------------------------------- dispatch

def load_image(path: str, raw_desc: str | None = None) -> GrkImage:
    ext = sniff_format(path)
    if ext == ".pgx":
        return read_pgx(path)
    if ext in (".raw", ".rawl"):
        if not raw_desc:
            raise ParamError("raw input requires -F descriptor")
        return read_raw(path, raw_desc, little_endian=ext == ".rawl")
    if ext in (".pnm", ".pgm", ".ppm"):
        img = read_pnm(path)
        if img is not None:
            return img
    if ext in PIL_FORMATS:
        return read_pil(path)
    raise ParamError(f"unsupported input format: {ext}")


def save_image(img: GrkImage, path: str, split_pnm: bool = False,
               tiff_compression: str | None = None) -> None:
    ext = sniff_format(path)
    if ext == ".pgx":
        write_pgx(img, path)
        return
    if ext in (".raw", ".rawl"):
        write_raw(img, path, little_endian=ext == ".rawl")
        return
    if ext in (".pnm", ".pgm", ".ppm") and write_pnm(img, path, split_pnm):
        return
    if ext in PIL_FORMATS:
        write_pil(img, path, split_pnm=split_pnm,
                  tiff_compression=tiff_compression)
        return
    raise ParamError(f"unsupported output format: {ext}")
