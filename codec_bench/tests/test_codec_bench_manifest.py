"""BENCHMARK.json against the contract's shapes, and the files it names
found by name, new ones without an edit."""

import json
import os

import pytest

from codec_bench.core import manifest, traffic
from codec_bench.tests import cpu_run

KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture
def bench():
    return manifest.load()


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == KEYS
    assert bench["command"] == ["python3", "codec_bench/run.py"]
    assert bench["paths"] == ["codec_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert manifest.NAME.match(entry["name"]), entry["name"]
            names.append((group in ("end_to_end", "per_layer"),
                          entry["name"]))
            if "unit" in entry:
                assert manifest.UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in bench["workloads"]:
        assert manifest.NAME.match(w["config"])
        assert manifest.NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


def test_every_file_found_by_name(bench):
    for c in bench["configs"]:
        cfg = manifest.config(c["name"])
        assert c["file"] == f"codec_bench/configs/{c['name']}.json"
        assert {"params", "source", "assumed", "reduced"} <= set(cfg)
        assert cfg["reduced"] == c["reduced"] == []
    for w in bench["workloads"]:
        spec = manifest.judge_spec(w["name"])
        assert {"frames", "windows", "size", "limits"} <= set(spec)
        mix = manifest.traffic(w["traffic"])
        assert {"width", "height", "components", "precision", "pool",
                "warm", "content", "params"} <= set(mix)
        assert callable(manifest.content(mix["content"]))
        assert callable(traffic.loop(mix).run)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]))
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in manifest.cell_metrics(
            bench, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.cell_metrics(bench, w["name"], "per_layer")
        for m in manifest.cell_metrics(bench, w["name"], "per_layer"):
            assert m["moves"] in e2e


def test_new_config_mix_and_metric_need_no_edit(tmp_path, monkeypatch):
    """A later change adds a configuration, a mix with its own content and
    loop, and an end-to-end and a per-layer metric, as files and entries;
    the harness takes them as they are."""
    path = cpu_run.tiny_tree(str(tmp_path))
    base = tmp_path / "codec_bench"
    monkeypatch.setattr(manifest, "HERE", str(base))
    cfg = manifest.config("j2k_lossy_mq")
    cfg["params"] = dict(cfg["params"], numresolution=3)
    (base / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    (base / "content" / "dummy_steps.py").write_text(
        "import torch\n"
        "def make(height, width, components, gen, device, level):\n"
        "    x = torch.arange(width, device=device, dtype=torch.float64)\n"
        "    step = (x // 8 * 16 + level)[None, :, None]\n"
        "    return step.expand(height, width, components) + torch.rand(\n"
        "        height, width, components, generator=gen, device=device,\n"
        "        dtype=torch.float64)\n")
    (base / "loops" / "dummy_loop.py").write_text(
        "from codec_bench.core import manifest\n"
        "def run(port, pool, prec, params, seconds, traced=False):\n"
        "    w = manifest.loop('round_trip').run(port, pool, prec, params,\n"
        "                                        seconds, traced)\n"
        "    w.dummy_trips = len(w.frames)\n"
        "    return w\n")
    mix = dict(manifest.traffic("tiny"), width=40, height=24,
               content="dummy_steps", params={"level": 3}, loop="dummy_loop")
    (base / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    cell = json.loads((base / "cells" / "j2k_lossy_mq.tiny.json").read_text())
    cell["judge"]["limits"]["max_mse"] = 100.0  # a cell's own limits
    (base / "cells" / "dummy_cfg.dummy_mix.json").write_text(json.dumps(cell))
    (base / "metrics" / "dummy_calls.encode.py").write_text(
        "def read(trace):\n    return float(trace.n_calls('encode'))\n")
    (base / "metrics" / "dummy_trips.py").write_text(
        "def read(window):\n    return float(window.dummy_trips)\n")
    bench = json.loads(open(path).read())
    bench["workloads"] = [{"name": "dummy_cfg.dummy_mix", "config":
                           "dummy_cfg", "traffic": "dummy_mix", "chips": 1,
                           "why": "a new cell"}]
    bench["end_to_end"].append({"name": "dummy_trips", "unit": "trips",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock"})
    bench["per_layer"] = [{"name": "dummy_calls.encode", "unit": "calls",
                           "better": "higher", "source": "program_span",
                           "layer": "codec", "moves": "encode_mps"}]
    with open(path, "w") as f:
        json.dump(bench, f)
    rc, result, _ = cpu_run.run(path, "dummy_cfg.dummy_mix", seconds=0.2)
    assert rc == 0 and result["correct"], result
    assert result["metrics"]["dummy_trips"]["value"] >= 1
    assert {"encode_mps", "decode_mps", "setup_s"} <= set(result["metrics"])
    rc, result, _ = cpu_run.run(path, "dummy_cfg.dummy_mix", trace=1,
                                seconds=0.2)
    assert rc == 0 and result["correct"]
    assert result["metrics"]["dummy_calls.encode"]["value"] >= 1
