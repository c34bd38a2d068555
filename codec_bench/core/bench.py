"""One run of one cell: set-up, the measured window, the traced reading,
the judge, and the result line.

The window is the mix's loop (`loops/<name>.py`; the closed loop of one
caller, `round_trip`, unless the mix names another) over the pool that
the mix's generator made.  Both calls keep the port's defaults (the
card).  The process stays a user's process: the collector runs, the inputs
are plain host arrays, and nothing is pinned or staged ahead.
"""

from __future__ import annotations

import gc
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import guard, manifest, roofline
from . import traffic as gen
from .trace import Spans, read_chrome

# the traced run records at most this many seconds of its window: the
# profiler's record of every host op costs about its own length again to
# write and read, and the whole run must end within its time limit
TRACE_SECONDS = 15.0


class Card:
    """The CUDA cards a cell runs on: a run without them fails."""

    platform = "gpu"

    def __init__(self, chips: int):
        self.count = chips
        self.kind = torch.cuda.get_device_name(0)

    @staticmethod
    def missing(chips: int) -> str | None:
        if not torch.cuda.is_available():
            return "torch.cuda.is_available() is False"
        if torch.cuda.device_count() < chips:
            return (f"{torch.cuda.device_count()} CUDA devices, the cell "
                    f"needs {chips}")
        return None

    def sync(self) -> None:
        torch.cuda.synchronize()

    def peak_bytes(self) -> int:
        return max(torch.cuda.max_memory_allocated(i)
                   for i in range(self.count))

    def power_note(self) -> str:
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout.strip().splitlines()
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"nvidia-smi unavailable: {e}"
        return out[0] if out else "nvidia-smi printed nothing"


class Port:
    """The system under test: the port's two calls with their defaults,
    and its counters."""

    def __init__(self):
        import grok_tpu_torch
        from grok_tpu_torch import kernels
        from grok_tpu_torch.t1 import backend
        from grok_tpu_torch.tile import processor
        self.lib = grok_tpu_torch
        self.counters = {"LAUNCHES": kernels.LAUNCHES,
                         "DEVICE_CODEBLOCKS": backend.DEVICE_CODEBLOCKS,
                         "HOST_PATH_TILES": processor.HOST_PATH_TILES}

    def encode(self, img: np.ndarray, prec: int, params: dict) -> bytes:
        lib = self.lib
        return lib.compress(lib.GrkImage.from_array(img, prec=prec),
                            lib.CompressParams(**params))

    def decode(self, data: bytes) -> np.ndarray:
        return self.lib.decompress(data).to_array()

    def host_tiles(self) -> int:
        return sum(self.counters["HOST_PATH_TILES"].values())

    def snapshot(self) -> dict:
        return {k: dict(v) for k, v in self.counters.items()}


@dataclass
class Window:
    """What a loop (`loops/<name>.py`) hands back: each round trip's
    (pool index, codestream, decode), and per direction the wall seconds
    of each call and the pixels it did; the end-to-end readers
    (`metrics/<name>.py`) read it."""
    frames: list = field(default_factory=list)
    seconds: dict = field(default_factory=lambda: {"encode": [],
                                                   "decode": []})
    px: dict = field(default_factory=lambda: {"encode": 0, "decode": 0})
    attempted: int = 0
    failed: int = 0
    host_path_calls: int = 0
    errors: list = field(default_factory=list)
    setup_s: float | None = None

    def add(self, direction: str, seconds: float, px: int) -> None:
        self.seconds[direction].append(seconds)
        self.px[direction] += px

    def rate(self, direction: str) -> float | None:
        return rate_mps(self.px[direction], self.seconds[direction])


def rate_mps(pixels: int, seconds: list) -> float | None:
    """Megapixels a second over all the work and all the time of the
    window's calls: a stall in any call lowers it."""
    return pixels / sum(seconds) / 1e6 if seconds else None


def call_meta(frames, pool, params) -> dict:
    """Per direction, per call in order: what the roofline prices."""
    from ..reference.codestream import packet_bytes
    numres = params.get("numresolution", 6)
    ht = bool(params.get("ht"))
    meta = {"encode": [], "decode": []}
    for k, cs, out in frames:
        if cs is None:
            continue
        img = pool[k]
        h, w = img.shape[:2]
        comps = 1 if img.ndim == 2 else img.shape[2]
        m = {"h": h, "w": w, "comps": comps, "numres": numres,
             "coded": packet_bytes(cs), "ht": ht}
        meta["encode"].append(m)
        if out is not None:
            meta["decode"].append(m)
    return meta


def least_ms(layer: str, direction: str):
    """The roofline's pricing of one call's work in a layer."""
    def price(m):
        if layer == "transform":
            return roofline.least_ms(roofline.transform_bytes(
                m["h"], m["w"], m["comps"], m["numres"]))
        return roofline.least_ms(roofline.t1_bytes(
            m["h"], m["w"], m["comps"], m["coded"],
            m["ht"] and direction == "decode"))
    return price


def _emit(result: dict, checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    result["checks"] = checks
    print(json.dumps(result), flush=True)


def run(args, card=None, port=None, t0=None, manifest_path=None) -> int:
    """A run as `run.py` describes; `card`, `port` and another manifest
    may stand in for the CUDA card, the port and BENCHMARK.json (the CPU
    tests)."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = manifest.load(manifest_path)
    cell = manifest.cell(bench, args.workload)
    if card is None:
        why = Card.missing(cell["chips"])
        if why:
            print(f"codec_bench: no card for {cell['name']}: {why}",
                  file=sys.stderr)
            return 2
        card = Card(cell["chips"])
    config = manifest.config(cell["config"])
    mix = manifest.traffic(cell["traffic"])
    params, prec = config["params"], mix["precision"]
    print(f"card: {card.power_note()}", file=sys.stderr, flush=True)

    # ---- set-up: the port (its first use builds it), the pool, a warm
    # round trip at the cell's shape
    port = Port() if port is None else port
    pool = gen.make_pool(mix, args.seed,
                         "cuda" if card.platform == "gpu" else "cpu")
    loop = gen.loop(mix)
    for i in range(mix["warm"]):
        port.decode(port.encode(pool[i % len(pool)], prec, params))
    card.sync()
    setup_s = time.perf_counter() - t0
    before = port.snapshot()
    gc_before = [g["collections"] for g in gc.get_stats()]
    use0, cpu0 = resource.getrusage(resource.RUSAGE_SELF), time.process_time()

    # ---- the window
    traced = bool(args.trace)
    trace_file = None
    if traced:
        gc.collect()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if card.platform == "gpu":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts, acc_events=True)
        with prof, Spans(card.sync):
            w = loop.run(port, pool, prec, params,
                         min(args.seconds, TRACE_SECONDS), True)
        fd, trace_file = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        prof.export_chrome_trace(trace_file)
        del prof
    else:
        w = loop.run(port, pool, prec, params, args.seconds)
    w.setup_s = setup_s
    after = port.snapshot()
    peak = card.peak_bytes()
    use1 = resource.getrusage(resource.RUSAGE_SELF)
    print(f"process over the window: gc collections by generation "
          f"{[g['collections'] - c for g, c in zip(gc.get_stats(), gc_before)]}"
          f", cpu {time.process_time() - cpu0:.3f} s, minor faults "
          f"{use1.ru_minflt - use0.ru_minflt}, context switches "
          f"{use1.ru_nvcsw - use0.ru_nvcsw} voluntary "
          f"{use1.ru_nivcsw - use0.ru_nivcsw} involuntary, "
          f"{len(os.sched_getaffinity(0))} cpus", file=sys.stderr)
    for name, now in after.items():
        delta = {k: v - before[name].get(k, 0) for k, v in now.items()}
        print(f"counter {name} over the window: {delta}", flush=True)
    for err in w.errors[:3]:
        print(err, file=sys.stderr)

    result = {"correct": False, "attempted": w.attempted,
              "failed": w.failed, "metrics": {},
              "device": {"platform": card.platform, "kind": card.kind,
                         "count": card.count, "memory_peak_bytes": peak}}
    if traced:
        meta = call_meta(w.frames, pool, params)
        trace = read_chrome(trace_file, meta)
        os.remove(trace_file)
        for m in manifest.cell_metrics(bench, cell["name"], "per_layer"):
            value = manifest.metric_reader(m["name"])(trace)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["device"]["busy_s"] = trace.busy_s()
        result["device"]["window_s"] = trace.window_s()
        result["breakdown"] = trace.breakdown()
        del trace
    else:
        for m in manifest.cell_metrics(bench, cell["name"], "end_to_end"):
            value = manifest.metric_reader(m["name"])(w)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
    print(f"window{' (traced)' if traced else ''}: "
          f"encode {w.rate('encode')} MP/s, decode {w.rate('decode')} MP/s; "
          f"{len(w.seconds['encode'])} encodes "
          f"{sum(w.seconds['encode']):.6f} s, {len(w.seconds['decode'])} "
          f"decodes {sum(w.seconds['decode']):.6f} s, set-up {setup_s:.3f} s;"
          f" ms a call, encode "
          f"{[round(1e3 * t, 1) for t in w.seconds['encode']]}, decode "
          f"{[round(1e3 * t, 1) for t in w.seconds['decode']]}",
          file=sys.stderr,
          flush=True)

    # ---- the judge, once the program's state is freed
    if card.platform == "gpu":
        torch.cuda.empty_cache()
    gc.collect()
    checks = judge(w, pool, config["params"],
                   manifest.judge_spec(cell["name"]), args.seed)
    result["correct"] = all(c["value"] <= c["limit"]
                            for c in checks.values())
    found = guard.loaded()
    if found:
        print(f"codec_bench: modules that must not load were loaded: "
              f"{found}", file=sys.stderr)
        return 3
    _emit(result, checks)
    return 0


def judge(w: Window, pool, params: dict, spec: dict, seed: int) -> dict:
    """Every number compared, beside its limit."""
    from ..reference.judge import judge_window
    t = time.perf_counter()
    nums = judge_window(w.frames, pool, params,
                        np.random.SeedSequence([seed & (2 ** 64 - 1), 1]),
                        spec["frames"], spec["windows"], spec["size"])
    nums["host_path_calls"] = w.host_path_calls
    nums["failed_calls"] = w.failed
    print(f"judge: {time.perf_counter() - t:.1f} s", file=sys.stderr,
          flush=True)
    limits = dict(spec["limits"], host_path_calls=0, failed_calls=0)
    return {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
