"""Drive the harness on the CPU at a tiny size: a copy of the benchmark's
tree with a tiny traffic mix, the port on its plain twins (device="cpu")
standing in for the card, and a fault of codec_bench.faults planted
underneath where asked."""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil

from codec_bench.core import bench, manifest
from codec_bench.faults import Faulty

CELLS = {"lossless": "htj2k_lossless", "lossy": "j2k_lossy_mq"}
TINY = dict(manifest.traffic("photo2k"), why="tiny frames for the CPU tests",
            width=96, height=64, pool=2, warm=1)


def tiny_tree(tmp: str) -> str:
    """A copy of codec_bench with the tiny mix and a manifest of one cell
    a configuration on it; returns the manifest's path."""
    base = os.path.join(tmp, "codec_bench")
    shutil.copytree(manifest.HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(base, "traffic", "tiny.json"), "w") as f:
        json.dump(TINY, f)
    bench_json = manifest.load()
    for w in bench_json["workloads"]:
        shutil.copy(os.path.join(base, "cells", w["name"] + ".json"),
                    os.path.join(base, "cells", w["config"] + ".tiny.json"))
    bench_json["workloads"] = [
        {"name": f"{c}.tiny", "config": c, "traffic": "tiny", "chips": 1,
         "why": "CPU test"} for c in CELLS.values()]
    for m in bench_json["per_layer"]:
        m["workloads"] = [w["name"] for w in bench_json["workloads"]]
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench_json, f)
    return path


class CpuCard:
    platform, kind, count = "cpu", "cpu stand-in", 1

    def sync(self):
        pass

    def peak_bytes(self):
        return 0

    def power_note(self):
        return "no card (CPU test)"


class CpuPort(bench.Port):
    """The port on its plain twins (device="cpu")."""

    def encode(self, img, prec, params):
        lib = self.lib
        return lib.compress(lib.GrkImage.from_array(img, prec=prec),
                            lib.CompressParams(**params), device="cpu")

    def decode(self, data):
        return self.lib.decompress(data, device="cpu").to_array()


def run(manifest_path: str, workload: str, seed: int = 20261017,
        seconds: float = 0.5, trace: int = 0, fault: str | None = None):
    """One run on the CPU; (exit code, the result line's object, stdout)."""
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port = CpuPort() if fault is None else Faulty(CpuPort(), fault)
        rc = bench.run(args, card=CpuCard(), port=port,
                       manifest_path=manifest_path)
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result, out.getvalue()


def numbers(result) -> dict:
    return {k: v["value"] for k, v in result["checks"].items()}


