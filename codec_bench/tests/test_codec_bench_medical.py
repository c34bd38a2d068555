"""The one-component lossless mixes on the CPU at a tiny size: the DICOM
JPEG 2000 lossless mammogram (the cell `dicom_j2k_lossless.ffdm`) and the
HTJ2K CT slice (`traffic/ct512.json` on `htj2k_lossless`, with its judge
in `cells/htj2k_lossless.ct512.json`, not yet a cell of BENCHMARK.json),
on a tree of their own built with cpu_run's helpers.  A sound run is
correct, a traced one reports the Tier-1 span and kernel times, and each
fault of codec_bench.faults comes out not correct."""

import contextlib
import json
import os

import pytest

from codec_bench.core import manifest
from codec_bench.faults import Faulty
from codec_bench.tests import cpu_run

# cell -> its tiny stand-in: the cell's own mix at a few blocks' size
CELLS = {"dicom_j2k_lossless.ffdm": dict(height=48, width=40),
         "htj2k_lossless.ct512": dict(height=64, width=64)}
NEW = ("t1_kernel_ms.encode", "t1_kernel_ms.decode")


class FlatHalf(Faulty):
    """codec_bench.faults' `half` on a tile whose HT blocks code as one
    flat batch (t1.backend.HTEncodeTile), which has no job list to slice:
    every other block of the batch handed on as coded empty."""

    @contextlib.contextmanager
    def _half(self):
        from grok_tpu_torch.t1 import backend
        real = backend.encode_batch

        def dropped(t, *a, **k):
            real(t, *a, **k)
            t.lens[::2] = 0
            t.numbps[::2] = 0
        backend.encode_batch = dropped
        try:
            yield
        finally:
            backend.encode_batch = real


def tiny_name(cell: str) -> str:
    config, mix = cell.split(".")
    return f"{config}.tiny_{mix}"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("medical")
    path = cpu_run.tiny_tree(str(tmp))
    base = os.path.join(str(tmp), "codec_bench")
    with open(path) as f:
        bench_json = json.load(f)
    bench_json["workloads"] = []
    for cell, size in CELLS.items():
        config, traffic = cell.split(".")
        mix = dict(manifest.traffic(traffic), pool=2, warm=1, **size)
        with open(os.path.join(base, "traffic", f"tiny_{traffic}.json"),
                  "w") as f:
            json.dump(mix, f)
        name = tiny_name(cell)
        with open(os.path.join(base, "cells", cell + ".json")) as src, \
                open(os.path.join(base, "cells", name + ".json"), "w") as f:
            f.write(src.read())
        bench_json["workloads"].append(
            {"name": name, "config": config, "traffic": f"tiny_{traffic}",
             "chips": 1, "why": "CPU test"})
    names = [w["name"] for w in bench_json["workloads"]]
    for m in bench_json["per_layer"]:
        m["workloads"] = names
    with open(path, "w") as f:
        json.dump(bench_json, f)
    return path, base


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_traced(tree, monkeypatch, cell):
    path, base = tree
    monkeypatch.setattr(manifest, "HERE", base)
    rc, result, out = cpu_run.run(path, tiny_name(cell), seconds=0.2)
    assert rc == 0 and result["correct"], out
    assert cpu_run.numbers(result)["decode_mismatch"] == 0
    assert {"encode_mps", "decode_mps", "setup_s"} <= set(result["metrics"])
    rc, result, out = cpu_run.run(path, tiny_name(cell), seconds=0.2,
                                  trace=1)
    assert rc == 0 and result["correct"], out
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(NEW) <= set(got), got
    # no card: no kernel time inside Tier-1 spans that do take time
    assert got["t1_kernel_ms.encode"] == got["t1_kernel_ms.decode"] == 0
    assert got["t1_ms.encode"] > 0 and got["t1_ms.decode"] > 0


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_run_is_not_correct(tree, monkeypatch, cell, fault):
    path, base = tree
    monkeypatch.setattr(manifest, "HERE", base)
    if fault == "half" and cell.startswith("htj2k"):
        # the HT tile codes as one flat batch, which the stock `half`
        # cannot slice (PERF.md section 7)
        monkeypatch.setattr(cpu_run, "Faulty", FlatHalf)
    rc, result, out = cpu_run.run(path, tiny_name(cell), seconds=10.0,
                                  fault=fault)
    assert rc == 0, out
    # a stale decode hands back a frame, also on a loaded machine
    assert result["attempted"] >= 4
    assert result["correct"] is False, cpu_run.numbers(result)
