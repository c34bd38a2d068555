"""High-level codec API of the port: compress and decompress, their strip,
file and stream variants, read_header and set_msg_handlers.

The same entry points as grok_tpu/codec.py, writing the same codestreams.
They run on the card unless the caller asks otherwise: `backend="device"`
(the default) runs on `device` ("cuda" by default, which raises where there
is no CUDA device; "cpu" runs the kernels' plain PyTorch versions) the
sample transforms and Tier-1 of every codeblock grok_tpu's device routers
take (the HT cleanup pass of every even-sized HT codeblock, MQ codeblocks
of styles NONE and LAZY), and on the native host coder only the MQ blocks
outside those routers' limits, the MQ decode shape groups under 8, the
ragged HT blocks, and Tier-2; `backend="native"` is the host route.  The
strip variants keep memory O(tile row): the encode runs one device
analysis a tile row, the decode keeps one tile's synthesis in flight on
the card while the next tile's Tier-2 and Tier-1 run.  Colour
post-processing after decode (util/color.py, util/icc.py) runs on the
host.

`params.mesh` shards the sample transforms over several devices
(parallel/mesh.py): an int n builds a dp mesh over n visible CUDA
devices (raising where fewer are visible), or with `device="cpu"` over
the CPU repeated; a parallel.mesh.Mesh, whose devices must be of
`device`'s type, is taken as it is.  The batched tiles of compress and
decompress (and of compress_strips, a tile row at a time) then shard
over its dp axis and, with sp > 1, each tile's rows over its sp axis
(one tile is then a batch too); the codestream and the decoded samples
are those of one device, bit for bit.  Tier-1 and Tier-2 run where they
run without a mesh: on `device` under `backend="device"`, on the host
under `backend="native"`.  Strip decodes take no mesh.
"""

from __future__ import annotations

import logging

import torch

from .codestream import jp2 as jp2_mod
from .codestream.compress import compress_codestream
from .codestream.decompress import CodestreamDecoder, HeaderInfo
from .device import resolve_device
from .image import ColorSpace, GrkImage
from .parallel.mesh import resolve_mesh
from .params import CompressParams, DecompressParams
from .trace import root, span

Device = str | torch.device


def _device_for(backend: str, device: Device) -> torch.device | None:
    return resolve_device(device) if backend == "device" else None


def compress(image: GrkImage, params: CompressParams | None = None,
             device: Device = "cuda") -> bytes:
    """Encode a GrkImage to a raw codestream (.j2k) or JP2 file."""
    params = params or CompressParams()
    with root("grk/encode"):
        cs = compress_codestream(image, params,
                                 _device_for(params.backend, device),
                                 mesh=resolve_mesh(params.mesh, device))
        return _wrap(cs, image, params)


def _wrap(cs: bytes, image: GrkImage, params: CompressParams) -> bytes:
    if params.cod_format != "jp2":
        return cs
    with span("grk/encode/assemble"):
        return jp2_mod.wrap_jp2(cs, image, ht=params.ht)


def compress_strips(image: GrkImage, reader,
                    params: CompressParams | None = None,
                    device: Device = "cuda") -> bytes:
    """Streaming encode — the dual of decompress_strips.  `image` carries
    geometry/metadata only (component `data` may be None); `reader(y0, h)`
    is called once per tile row and must return one 2-D array per
    component covering canvas rows [y0, y0+h) at that component's
    subsampling (shape (ceil((y0+h)/dy) - ceil(y0/dy), comp.w)).  Peak
    memory is O(tile row), not O(image), on the host and on the card —
    the gigapixel encode path."""
    params = params or CompressParams()
    with root("grk/encode"):
        cs = compress_codestream(image, params,
                                 _device_for(params.backend, device),
                                 strip_reader=reader,
                                 mesh=resolve_mesh(params.mesh, device))
        return _wrap(cs, image, params)


def compress_strips_file(image: GrkImage, reader, path: str,
                         params: CompressParams | None = None,
                         device: Device = "cuda") -> int:
    """compress_strips straight to a file: tile-parts stream to disk as
    they are produced and the TLM index is patched by seek-back, so
    neither the canvas NOR the codestream is ever held in memory.
    Returns the bytes written.  PPM/PLM (post-hoc main-header indexes)
    are rejected; use ppt/plt."""
    params = params or CompressParams()
    dev = _device_for(params.backend, device)
    with root("grk/encode"), open(path, "wb") as f:
        if params.cod_format == "jp2":
            # jp2c LBox=0: codestream runs to end of file (I.5.1)
            f.write(jp2_mod.jp2_prefix(image, ht=params.ht))
        compress_codestream(image, params, dev, strip_reader=reader, sink=f,
                            mesh=resolve_mesh(params.mesh, device))
        return f.tell()


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
    hi._decoder = dec  # cached for a subsequent decompress_strips() call
    return hi


def decompress(data: bytes, params: DecompressParams | None = None,
               cache=None, device: Device = "cuda") -> GrkImage:
    """Decode a raw codestream or JP2 file to a GrkImage.  Pass a
    util.caches.TileCache to serve repeated multi-window/tile requests
    from cache."""
    params = params or DecompressParams()
    with root("grk/decode"):
        with span("grk/decode/parse"):
            meta = None
            colorspace = None
            if jp2_mod.is_jp2(data):
                cs, meta, colorspace = jp2_mod.unwrap_jp2(data)
            else:
                cs = data
            dec = CodestreamDecoder(cs, strict=params.strict,
                                    device=_device_for(params.backend,
                                                       device))
            dec.parse()
        img = dec.decode(params, cache=cache,
                         mesh=resolve_mesh(params.mesh, device))
        if meta is not None:
            img.meta = meta
        if colorspace is not None:
            img.color_space = colorspace
        with span("grk/decode/post"):
            _postprocess(img, params)
        return img


def decompress_strips(data: bytes, params: DecompressParams | None = None,
                      strip_height: int | None = None,
                      header: HeaderInfo | None = None,
                      device: Device = "cuda"):
    """Strip-streaming decode generator: yields (y0, {compno: strip
    ndarray}) — one tile row at a time by default, or `strip_height`
    canvas rows at a time via the window-aware decode path (memory
    O(strip) even inside huge tiles; windowed tiles take the host path) —
    the gigapixel decode path.  Pass the HeaderInfo from read_header(data)
    to reuse its parsed state instead of re-scanning the headers; the
    decode then runs on `device`."""
    params = params or DecompressParams()
    dev = _device_for(params.backend, device)
    dec = getattr(header, "_decoder", None) if header is not None else None
    if dec is None:
        cs = jp2_mod.unwrap_jp2(data)[0] if jp2_mod.is_jp2(data) else data
        dec = CodestreamDecoder(cs, strict=params.strict, device=dev)
        dec.parse()
    else:
        dec.device = dev
    yield from dec.decode_strips(params, strip_height=strip_height)


def decompress_file(path: str, params: DecompressParams | None = None,
                    cache=None, device: Device = "cuda") -> GrkImage:
    """Decode straight from a file through a read-only memory map: tile
    data is touched lazily, so region/tile decodes of large files only
    fault in the pages they use.  Every byte that goes to the card is
    first copied out of the map (tile-parts are joined into bytes)."""
    import mmap

    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        # no explicit close: the map is released by refcount once the
        # decoder's slices over it are collected (closing earlier would
        # invalidate exported views)
        return decompress(memoryview(mm), params, cache=cache, device=device)


def compress_file(image: GrkImage, path: str,
                  params: CompressParams | None = None,
                  device: Device = "cuda") -> int:
    """Encode to a file; returns the byte count."""
    data = compress(image, params, device=device)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def decompress_stream(stream, params: DecompressParams | None = None,
                      cache=None, device: Device = "cuda") -> GrkImage:
    """Decode from a user stream object (grk_stream_params callback-stream
    parity): anything with read() — a file object, socket wrapper,
    BytesIO — or with a buffer protocol."""
    data = stream.read() if hasattr(stream, "read") else stream
    return decompress(data, params, cache=cache, device=device)


def compress_stream(image: GrkImage, stream,
                    params: CompressParams | None = None,
                    device: Device = "cuda") -> int:
    """Encode to a user stream object with write(); returns byte count."""
    data = compress(image, params, device=device)
    stream.write(data)
    return len(data)


# ---------------------------------------------------------------- logging

def set_msg_handlers(info=None, warn=None, error=None) -> None:
    """grk_set_msg_handlers parity: route the codec's messages (the
    "grok_tpu_torch" logger) to user callbacks."""
    logger = logging.getLogger("grok_tpu_torch")

    class _Handler(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if record.levelno >= logging.ERROR and error:
                error(msg)
            elif record.levelno >= logging.WARNING and warn:
                warn(msg)
            elif info:
                info(msg)

    for h in list(logger.handlers):
        if isinstance(h, _Handler) or h.__class__.__name__ == "_Handler":
            logger.removeHandler(h)
    logger.addHandler(_Handler())
    logger.setLevel(logging.INFO)


def _postprocess(img: GrkImage, params: DecompressParams) -> None:
    """JP2-level post-processing on the host: palette application, cdef
    reordering, sYCC/eYCC/CMYK/CIELAB conversion, upsampling, ICC and
    precision overrides (GrkImage_Conversion parity)."""
    from .util import color

    if img.meta.palette is not None and img.meta.palette.lut is not None:
        color.apply_palette(img)
    if img.meta.channel_definitions:
        color.apply_channel_definitions(img)
    if img.color_space == ColorSpace.SYCC and img.numcomps >= 3:
        color.sycc_to_rgb(img)
    elif img.color_space == ColorSpace.EYCC and img.numcomps >= 3:
        color.eycc_to_rgb(img)
    elif img.color_space == ColorSpace.CMYK and img.numcomps >= 4 and \
            params.force_rgb and not (params.apply_icc
                                      and img.meta.icc_profile):
        # an embedded CMYK ICC profile supersedes the naive ink formula;
        # the apply_icc step below consumes it (falling back afterwards
        # if the profile turns out unsupported)
        color.cmyk_to_rgb(img)
    elif img.color_space == ColorSpace.CIELAB and img.numcomps >= 3:
        color.cielab_to_srgb(img)
    if params.upsample:
        color.upsample_components(img)
    if params.force_rgb and img.numcomps == 1:
        img.comps = [img.comps[0], img.comps[0].copy(), img.comps[0].copy()]
        img.color_space = ColorSpace.SRGB
    if params.apply_icc and img.meta.icc_profile:
        color.apply_icc_profile(img)
    if img.color_space == ColorSpace.CMYK and img.numcomps >= 4 and \
            params.force_rgb:
        # ICC application declined (unsupported profile class): honor
        # force_rgb with the naive ink conversion instead
        color.cmyk_to_rgb(img)
    if params.precision:
        color.shift_precision(img, params.precision)
