"""GrkImage equivalent: the in-memory image structure.

Parity target: `grk_image` / GrkImage (SURVEY.md §2.1 "GrkImage",
src/lib/core/util/GrkImage*.cpp [P]): per-component subsampling (dx/dy),
canvas offsets (x0/y0), precision 1..16+ bits signed/unsigned, planar
storage.  Color/metadata fields cover the JP2 box surface (colr/pclr/cmap/
cdef/res/ICC, SURVEY.md Appendix A.3).

Components are stored planar as numpy int32 arrays (one per component) —
int32 is the universal working precision of the codec; device kernels
convert as needed.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np


class ColorSpace(enum.Enum):
    """Enumerated colourspace (JP2 `colr` box EnumCS + codestream defaults)."""

    UNKNOWN = 0
    SRGB = 16
    GRAY = 17
    SYCC = 18
    EYCC = 24
    CMYK = 12
    CIELAB = 14


@dataclass
class ImageComponent:
    """One image component plane.

    Geometry lives on the *reference grid* (canvas): the component covers
    canvas coordinates [x0, x1) x [y0, y1) sampled every (dx, dy).  `data`
    has shape (h, w) where w = ceil(x1/dx) - ceil(x0/dx) etc.
    """

    dx: int = 1
    dy: int = 1
    prec: int = 8
    sgnd: bool = False
    data: np.ndarray | None = None  # int32, shape (h, w)

    # component dimensions in component-sample units (set by the codec)
    w: int = 0
    h: int = 0
    x0: int = 0  # component-grid origin = ceil(canvas_x0 / dx)
    y0: int = 0

    # JP2 cdef association (0 = whole image); type 0=color 1=alpha 2=premul-alpha
    association: int = 0
    type: int = 0  # GRK_CHANNEL_TYPE: 0 color, 1 opacity, 2 premultiplied opacity

    def copy(self) -> "ImageComponent":
        c = ImageComponent(
            dx=self.dx, dy=self.dy, prec=self.prec, sgnd=self.sgnd,
            data=None if self.data is None else self.data.copy(),
            w=self.w, h=self.h, x0=self.x0, y0=self.y0,
            association=self.association, type=self.type,
        )
        return c


@dataclass
class PaletteEntry:
    """JP2 pclr palette + cmap component mapping (SURVEY.md §2.1 GrkImage)."""

    channel_prec: list[int] = field(default_factory=list)
    channel_sgnd: list[bool] = field(default_factory=list)
    lut: np.ndarray | None = None  # shape (num_entries, num_channels), int32
    # cmap: list of (component_index, mapping_type, palette_column)
    component_mapping: list[tuple[int, int, int]] = field(default_factory=list)


@dataclass
class ImageMeta:
    """Container-level metadata (JP2 boxes)."""

    icc_profile: bytes | None = None
    xmp: bytes | None = None  # uuid/xml box payload
    exif: bytes | None = None  # EXIF payload (uuid box "JpgTiffExif->JP2")
    xml: list[bytes] = field(default_factory=list)
    capture_resolution: tuple[float, float] | None = None  # (vres, hres) ppm
    display_resolution: tuple[float, float] | None = None
    palette: PaletteEntry | None = None
    # cdef channel definitions: list of (channel_index, type, association)
    channel_definitions: list[tuple[int, int, int]] | None = None


@dataclass
class GrkImage:
    """Planar image on the JPEG 2000 reference grid."""

    x0: int = 0
    y0: int = 0
    x1: int = 0  # Xsiz (canvas width bound)
    y1: int = 0
    comps: list[ImageComponent] = field(default_factory=list)
    color_space: ColorSpace = ColorSpace.UNKNOWN
    meta: ImageMeta = field(default_factory=ImageMeta)
    # true if the decoded data still has the MCT applied (internal use)
    has_multiple_tiles: bool = False

    @property
    def numcomps(self) -> int:
        return len(self.comps)

    @property
    def width(self) -> int:
        return self.x1 - self.x0

    @property
    def height(self) -> int:
        return self.y1 - self.y0

    # ---------------------------------------------------------------- helpers

    @staticmethod
    def from_array(
        arr: np.ndarray,
        prec: int | None = None,
        sgnd: bool | None = None,
        color_space: ColorSpace | None = None,
        subsampling: list[tuple[int, int]] | None = None,
        offset: tuple[int, int] = (0, 0),
    ) -> "GrkImage":
        """Build a GrkImage from an (h, w) or (h, w, c) array (no subsampling
        applied to the data — caller supplies already-subsampled planes via
        `comps` directly if needed).  `sgnd=None` infers signedness: arrays
        of a signed dtype that actually hold negative values encode as
        signed components (they cannot round-trip as unsigned); everything
        else keeps the unsigned default."""
        if arr.ndim == 2:
            arr = arr[:, :, None]
        h, w, nc = arr.shape
        if sgnd is None:
            sgnd = bool(arr.size
                        and np.issubdtype(arr.dtype, np.signedinteger)
                        and arr.min() < 0)
        if prec is None:
            if arr.dtype in (np.uint8, np.int8):
                prec = 8
            elif arr.dtype in (np.uint16, np.int16):
                prec = 16
            elif sgnd and arr.size:
                # smallest p with -2^(p-1) <= min and max <= 2^(p-1)-1
                bound = max(int(arr.max()) + 1, -int(arr.min()), 1)
                prec = max((bound - 1).bit_length() + 1, 2)
            else:
                prec = int(arr.max()).bit_length() if arr.size else 8
                prec = max(prec, 1)
        x0, y0 = offset
        img = GrkImage(x0=x0, y0=y0, x1=x0 + w, y1=y0 + h)
        if color_space is None:
            color_space = ColorSpace.SRGB if nc >= 3 else ColorSpace.GRAY
        img.color_space = color_space
        for c in range(nc):
            dx, dy = (subsampling[c] if subsampling else (1, 1))
            comp = ImageComponent(dx=dx, dy=dy, prec=prec, sgnd=sgnd)
            comp.data = arr[:, :, c].astype(np.int32)
            comp.h, comp.w = comp.data.shape
            comp.x0 = -(-x0 // dx)
            comp.y0 = -(-y0 // dy)
            img.comps.append(comp)
        return img

    def to_array(self) -> np.ndarray:
        """Interleave equally-sized components into (h, w, c) (or (h, w))."""
        from .trace import root  # torch loads with the codec, not here

        if not self.comps:
            raise ValueError("image has no components")
        shapes = {c.data.shape for c in self.comps}
        if len(shapes) != 1:
            raise ValueError(
                f"components have mismatched shapes {shapes}; upsample first"
            )
        if len(self.comps) == 1:
            return self.comps[0].data
        with root("grk/to_array"):
            return np.stack([c.data for c in self.comps], axis=-1)

    def clip_to_precision(self) -> None:
        """Clamp every component to its declared precision range."""
        for c in self.comps:
            if c.sgnd:
                lo, hi = -(1 << (c.prec - 1)), (1 << (c.prec - 1)) - 1
            else:
                lo, hi = 0, (1 << c.prec) - 1
            np.clip(c.data, lo, hi, out=c.data)
