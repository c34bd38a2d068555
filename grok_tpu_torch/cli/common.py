"""Shared CLI plumbing.

Parity: src/bin/common/ (SURVEY.md §2.2 "CLI common"): argument helpers,
batch-directory mode, repetition timing, logging setup.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time


def setup_logging(verbose: bool, logfile: str | None = None) -> None:
    handlers = None
    if logfile:
        handlers = [logging.FileHandler(logfile),
                    logging.StreamHandler(sys.stderr)]
    logging.basicConfig(
        level=logging.INFO if verbose else logging.WARNING,
        format="[%(levelname)s] %(message)s",
        handlers=handlers)


def parse_int_pair(s: str, sep: str = ",") -> tuple[int, int]:
    a, b = s.split(sep)
    return int(a), int(b)


def parse_window(s: str) -> tuple[int, int, int, int]:
    parts = [int(x) for x in s.split(",")]
    if len(parts) != 4:
        raise argparse.ArgumentTypeError("window must be x0,y0,x1,y1")
    return tuple(parts)


def batch_inputs(img_dir: str, out_dir: str, out_fmt: str,
                 exts: set[str]) -> list[tuple[str, str]]:
    """-y ImgDir batch mode: every image in img_dir -> out_dir with the
    requested output format (SURVEY.md §2.2)."""
    pairs = []
    for name in sorted(os.listdir(img_dir)):
        base, ext = os.path.splitext(name)
        if ext.lower() in exts:
            pairs.append((os.path.join(img_dir, name),
                          os.path.join(out_dir, base + "." + out_fmt)))
    return pairs


def run_repeated(fn, repetitions: int, duration: float | None = None,
                 profile_dir: str | None = None):
    """-e repetitions / -j duration benchmarking loops, optionally inside
    a torch.profiler trace (--profile DIR -> a Chrome trace file in DIR,
    which Perfetto and chrome://tracing open; SURVEY.md §5
    "Tracing/profiling").  The trace records the host (CPU activity) and,
    where a CUDA device is present, the card's kernels and copies."""
    import contextlib

    ctx = contextlib.nullcontext()
    if profile_dir:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        ctx = profile(activities=activities)
    times = []
    n = max(1, repetitions)
    with ctx:
        start = time.perf_counter()
        for i in range(n if not duration else 1 << 30):
            t0 = time.perf_counter()
            result = fn()
            times.append(time.perf_counter() - t0)
            if duration and time.perf_counter() - start > duration:
                break
            if not duration and i + 1 >= n:
                break
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"trace_{os.getpid()}_"
                            f"{time.time_ns()}.json")
        ctx.export_chrome_trace(path)
        logging.getLogger("grok_tpu_torch").warning(
            "profiler trace written to %s (open with Perfetto or "
            "chrome://tracing)", path)
    return result, times


def shard_pairs(pairs: list, num_hosts: int, host_id: int) -> list:
    """Multi-host batch sharding (SURVEY.md §2.3 DCN row): slice the
    batch for this host.  num_hosts == 0 defers to torch.distributed
    (runs without an initialized process group keep the whole list)."""
    from ..parallel import distributed as dist

    if num_hosts and num_hosts > 1:
        return dist.shard_batch(pairs, num_hosts, host_id)
    if num_hosts == 0:
        return dist.auto_shard(pairs)
    return pairs
