"""grok_tpu_torch — the PyTorch and CUDA port of grok_tpu.

The port runs grok_tpu's encode and decode with their sample transforms on
an NVIDIA Hopper card, through CUDA kernels written by hand for sm_90a
(grok_tpu_torch/csrc) that replace grok_tpu's Pallas kernels and the XLA
stages of its device pipeline: the lossless path (DC shift, reversible
colour transform, multi-level 5/3 DWT) and the lossy one (DC shift,
irreversible colour transform, multi-level 9/7 DWT with the quantizer).  It imports
torch and never jax, and nothing of grok_tpu: parameters, images, markers,
geometry, rate control and Tier-2 are the port's own copies of grok_tpu's
host modules.  Under `backend="device"` Tier-1 runs on the card too, through
hand-written HT and MQ kernels, for every codeblock grok_tpu's device
routers take; only the MQ blocks outside those routers' limits, the MQ
decode shape groups under 8, the ragged HT blocks and Tier-2 stay on the
native C++ coder in `native/`, which the port compiles itself
(t1/native.py).  Both packages write the same codestreams.  By default the
entry points run on the card: compress and decompress, their strip, file
and stream variants (the strip ones in memory O(tile row), for gigapixel
images), and the command-line tools in grok_tpu_torch.cli (grk_compress,
grk_decompress, grk_dump and the compare tools).  Colour post-processing
after decode runs on the host.  `CompressParams.mesh` and
`DecompressParams.mesh` shard the sample transforms over several devices
(grok_tpu_torch.parallel.mesh: tile batches over a dp axis, one tile's
rows over an sp axis), with the codestreams of one device.
"""

__version__ = "0.1.0"

from .image import GrkImage  # noqa: F401
from .params import CompressParams, DecompressParams  # noqa: F401

_CODEC_API = (
    "compress", "compress_strips", "compress_strips_file", "decompress",
    "read_header",
    "decompress_strips", "decompress_file", "compress_file",
    "decompress_stream", "compress_stream", "set_msg_handlers",
)
_ERRORS = ("GrkError", "CodestreamError", "ParamError")


def __getattr__(name):
    # keep the top-level import light: torch and the native coder load
    # with the codec
    if name in _CODEC_API:
        from . import codec

        return getattr(codec, name)
    if name in _ERRORS:
        from . import errors

        return getattr(errors, name)
    raise AttributeError(name)
