#!/usr/bin/env python3
"""The judge's readings on many seeds in one process: the limits' sources.

    python3 codec_bench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control-seeds <n> ...]

For each seed: the cell's pool, a short window of the program at the
cell's own size and load, and the judge's numbers on its outputs (the
lower readings); for each control seed, the same window judged with the
control, the reference one precision step down in the program's place
(the upper readings); for each fault seed, a window with each fault of
codec_bench.faults planted under the program.  One line of JSON a reading.  The benchmark's own
runs never run this.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[],
                    help="seeds read with each fault of codec_bench.faults")
    args = ap.parse_args(argv)

    import numpy as np

    from codec_bench.core import bench, manifest
    from codec_bench.core import traffic as gen
    from codec_bench.reference.judge import judge_window

    cell = manifest.cell(manifest.load(), args.workload)
    why = bench.Card.missing(cell["chips"])
    if why:
        print(f"control: no card: {why}", file=sys.stderr)
        return 2
    config = manifest.config(cell["config"])
    mix = manifest.traffic(cell["traffic"])
    spec = manifest.judge_spec(cell["name"])
    from codec_bench.faults import FAULTS, Faulty

    real = bench.Port()
    runs = [(s, "program") for s in args.seeds] + \
        [(s, "control") for s in args.control_seeds] + \
        [(s, f) for s in args.fault_seeds for f in FAULTS]
    for seed, reading in runs:
        control = reading == "control"
        port = real if reading in ("program", "control") else \
            Faulty(real, reading)
        pool = gen.make_pool(mix, seed, "cuda")
        port.decode(port.encode(pool[0], mix["precision"], config["params"]))
        w = gen.loop(mix).run(port, pool, mix["precision"],
                              config["params"], args.seconds)
        t = time.perf_counter()
        nums = judge_window(w.frames, pool, config["params"],
                            np.random.SeedSequence([seed & (2 ** 64 - 1), 1]),
                            spec["frames"], spec["windows"], spec["size"],
                            control=control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reading": reading,
                          "frames": len(w.frames), "failed": w.failed,
                          "judge_s": time.perf_counter() - t, **nums}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
