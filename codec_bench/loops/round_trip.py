"""The closed loop of one caller, as an ingest worker that checks each
frame: take the next image of the pool, `compress` it, `decompress` the
bytes just made, and again, until the window's seconds are up.  The host
clock runs around each call; a decode's stops once its samples are in host
memory as the API hands them (`to_array()`).  A call that raises, or in
which a tile took the host path, is a failed call."""

import contextlib
import time
import traceback

import torch

from codec_bench.core.bench import Window


def run(port, pool, prec, params, seconds, traced=False) -> Window:
    w = Window()
    mark = torch.profiler.record_function if traced else \
        (lambda _name: contextlib.nullcontext())
    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < seconds:
        k = i % len(pool)
        img = pool[k]
        px = img.shape[0] * img.shape[1]
        cs = out = None
        for direction in ("encode", "decode"):
            if direction == "decode" and cs is None:
                break
            w.attempted += 1
            host0 = port.host_tiles()
            try:
                with mark(direction):
                    t = time.perf_counter()
                    if direction == "encode":
                        cs = port.encode(img, prec, params)
                    else:
                        out = port.decode(cs)
                    dt = time.perf_counter() - t
            except Exception:
                w.failed += 1
                w.errors.append(traceback.format_exc(limit=4))
                continue
            if port.host_tiles() != host0:
                w.failed += 1
                w.host_path_calls += 1
            w.add(direction, dt, px)
        w.frames.append((k, cs, out))
        i += 1
    return w
