"""High-level codec API of the port: compress, decompress and read_header.

The same entry points as grok_tpu/codec.py, writing the same codestreams.
They run on the card unless the caller asks otherwise: `backend="device"`
(the default) runs on `device` ("cuda" by default, which raises where there
is no CUDA device; "cpu" runs the kernels' plain PyTorch versions) the
sample transforms and Tier-1 of every codeblock grok_tpu's device routers
take (the HT cleanup pass of every even-sized HT codeblock, MQ codeblocks
of styles NONE and LAZY), and on the native host coder only the MQ blocks
outside those routers' limits, the MQ decode shape groups under 8, the
ragged HT blocks, and Tier-2; `backend="native"` is the host route.  The strip, file and stream variants
are not ported yet (ROADMAP A14).
"""

from __future__ import annotations

import torch

from .codestream import jp2 as jp2_mod
from .codestream.compress import compress_codestream
from .codestream.decompress import CodestreamDecoder, HeaderInfo
from .device import resolve_device
from .image import ColorSpace, GrkImage
from .params import CompressParams, DecompressParams

Device = str | torch.device


def _device_for(backend: str, device: Device) -> torch.device | None:
    return resolve_device(device) if backend == "device" else None


def compress(image: GrkImage, params: CompressParams | None = None,
             device: Device = "cuda") -> bytes:
    """Encode a GrkImage to a raw codestream (.j2k) or JP2 file."""
    params = params or CompressParams()
    cs = compress_codestream(image, params,
                             _device_for(params.backend, device))
    if params.cod_format == "jp2":
        return jp2_mod.wrap_jp2(cs, image, ht=params.ht)
    return cs


def read_header(data: bytes, strict: bool = False,
                lazy: bool = True) -> HeaderInfo:
    """Parse the container + codestream headers without decoding tiles
    (grk_decompress_read_header parity).  lazy=False forces scanning every
    tile-part even when a TLM index would let the decoder skip them."""
    if jp2_mod.is_jp2(data):
        cs, meta, colorspace = jp2_mod.unwrap_jp2(data)
    else:
        cs, meta, colorspace = data, None, None
    dec = CodestreamDecoder(cs, strict=strict)
    hi = dec.parse()
    if not lazy:
        # materialize in stream order so the marker log reads naturally
        order = sorted((sp[0], t) for t, sps in dec._lazy_spans.items()
                       for sp in sps)
        for _, tidx in order:
            dec._ensure_tile(tidx)
    if meta is not None:
        hi.image.meta = meta
    if colorspace is not None:
        hi.image.color_space = colorspace
    return hi


def decompress(data: bytes, params: DecompressParams | None = None,
               cache=None, device: Device = "cuda") -> GrkImage:
    """Decode a raw codestream or JP2 file to a GrkImage.  `cache` is any
    object with grok_tpu.util.caches.TileCache's key/get/put, serving
    repeated requests from cache."""
    params = params or DecompressParams()
    meta = None
    colorspace = None
    if jp2_mod.is_jp2(data):
        cs, meta, colorspace = jp2_mod.unwrap_jp2(data)
    else:
        cs = data
    dec = CodestreamDecoder(cs, strict=params.strict,
                            device=_device_for(params.backend, device))
    dec.parse()
    img = dec.decode(params, cache=cache)
    if meta is not None:
        img.meta = meta
    if colorspace is not None:
        img.color_space = colorspace
    _postprocess(img, params)
    return img


_NO_COLOR = ("colour conversion after decode (palette, channel "
             "definitions, sYCC/eYCC/CMYK/CIELAB, upsampling, ICC, "
             "precision) is not ported yet: ROADMAP A14")


def _postprocess(img: GrkImage, params: DecompressParams) -> None:
    """JP2-level post-processing.  The port does what needs no colour
    module (grey to RGB on force_rgb) and raises for the rest."""
    meta = img.meta
    needs_color = (
        (meta.palette is not None and meta.palette.lut is not None)
        or meta.channel_definitions
        or (img.color_space in (ColorSpace.SYCC, ColorSpace.EYCC,
                                ColorSpace.CIELAB) and img.numcomps >= 3)
        or (img.color_space == ColorSpace.CMYK and img.numcomps >= 4
            and params.force_rgb)
        or params.upsample
        or (params.apply_icc and meta.icc_profile)
        or params.precision)
    if needs_color:
        raise NotImplementedError(_NO_COLOR)
    if params.force_rgb and img.numcomps == 1:
        img.comps = [img.comps[0], img.comps[0].copy(), img.comps[0].copy()]
        img.color_space = ColorSpace.SRGB
