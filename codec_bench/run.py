#!/usr/bin/env python3
"""The benchmark of grok_tpu_torch, the PyTorch/CUDA port of grok_tpu.

    python3 codec_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json once, from the root of a checkout, on the
CUDA cards of this machine, and prints as its last line one JSON object:
`correct`, `attempted`, `failed`, `metrics` (with --trace 0 the cell's
end-to-end metrics, with --trace 1 its per-layer metrics), `device`, with
--trace 1 `breakdown`, and last `checks`, every number the judge compared
beside its limit (also the last lines of standard error).  Exits non-zero
and prints no result without the cards the cell asks for.
"""

import os
import sys
import time

# set-up counts from the first start, across the re-start below (the
# monotonic clock is the machine's, not the process's)
T0 = float(os.environ.get("CODEC_BENCH_T0", time.perf_counter()))


def hash_seed(argv) -> str | None:
    """The interpreter's hash seed for a run, from its `--seed`: dict and
    set order, and with them the order of the port's per-codeblock work
    and the collector's, follow the hash seed, so each seed fixes one of
    the orderings a user's process may have and the runs of several seeds
    sample them."""
    for i, a in enumerate(argv):
        value = a.split("=", 1)[1] if a.startswith("--seed=") else \
            argv[i + 1] if a == "--seed" and i + 1 < len(argv) else None
        if value is not None:
            try:
                return str(int(value) % 2 ** 32)
            except ValueError:
                return None
    return None


SEED_HASH = hash_seed(sys.argv[1:])
if SEED_HASH is not None and os.environ.get("PYTHONHASHSEED") != SEED_HASH:
    os.execve(sys.executable, [sys.executable] + sys.argv,
              dict(os.environ, PYTHONHASHSEED=SEED_HASH,
                   CODEC_BENCH_T0=str(T0)))

import argparse  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from codec_bench.core import bench
    return bench.run(args, t0=T0)


if __name__ == "__main__":
    sys.exit(main())
