"""The port's hand-written CUDA kernels: how a wrapper picks its route, launches
a kernel, and counts the launch.

A wrapper in `grok_tpu_torch.ops` runs its plain PyTorch twin when its
tensors lie on the CPU, and its kernel when they lie on a CUDA device;
anything else raises.  Each kernel launch adds one to the wrapper's entry
in LAUNCHES (a run of the twin does not), so a run can show that the main
path went through the kernels.  The slots of a multi-device mesh launch
from threads of their own (parallel/mesh.py), so the count is taken
under a lock.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import build

LAUNCHES: dict[str, int] = dict.fromkeys(
    ("fwd53_level", "inv53_level", "rct_forward_shift",
     "rct_inverse_unshift", "fwd97_level", "inv97_level",
     "ict_forward_shift", "ict_inverse_unshift", "ht_encode", "ht_destuff",
     "ht_decode", "ht_magsgn", "mq_encode", "mq_decode"), 0)


_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(counter: str) -> None:
    """Add one to LAUNCHES[counter]; safe from any thread."""
    with _COUNT_LOCK:
        LAUNCHES[counter] += 1


def on_card(*tensors: torch.Tensor,
            dtype: torch.dtype | None = torch.int32) -> bool:
    """True when the tensors, all of `dtype` (None: the caller checked
    their types), lie on one CUDA device (kernel route), False when they
    lie on the CPU (plain route); raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on different devices: {devices}")
    for t in tensors:
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"expected {dtype} tensors, got {t.dtype}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no kernel route for device {device}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    return True


def launch(counter: str, entry: str, device: torch.device,
           tensors: tuple[torch.Tensor, ...], ints: tuple[int, ...],
           floats: tuple[float, ...] = ()) -> None:
    """Launch C entry point `entry` with the tensors' pointers, then the
    ints, then (when given) a host array of the floats as float32, on the
    current stream of `device`; raise on a CUDA error, and count the
    launch under `counter`."""
    for v, ctype in zip(ints, build.int_args(entry)):
        bits = 8 * ctypes.sizeof(ctype)
        if not -2 ** (bits - 1) <= v < 2 ** (bits - 1):
            raise ValueError(f"{entry}: {v} does not fit a {bits}-bit C "
                             "int; the tensor is too large for one launch")
    lib = build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        extra = ((ctypes.c_float * len(floats))(*floats),) if floats else ()
        err = getattr(lib, entry)(*(t.data_ptr() for t in tensors), *ints,
                                  *extra, stream)
    build.check(entry, err)
    count_launch(counter)
