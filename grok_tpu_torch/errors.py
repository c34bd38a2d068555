"""Error types for grok_tpu_torch (the same as grok_tpu's).

Parity: the reference reports errors through grk_set_msg_handlers callbacks
and boolean return codes (SURVEY.md §2.1 "Public API").  We use exceptions
for hard failures and the logging module for warnings; `strict=False`
decode mode (tolerant decoding of truncated/corrupt streams, SURVEY.md §5
"Failure detection") downgrades many decode errors to warnings.
"""


class GrkError(Exception):
    """Base class for all grok_tpu_torch errors."""


class CodestreamError(GrkError):
    """Malformed or unsupported codestream."""


class UnsupportedError(GrkError):
    """Feature signaled in the stream that this build does not implement."""


class ParamError(GrkError):
    """Invalid user-supplied compression/decompression parameters."""


class TruncatedStreamError(CodestreamError):
    """Stream ended before expected data (raised only in strict mode)."""
