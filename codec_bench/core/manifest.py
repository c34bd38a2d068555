"""The benchmark's manifest, BENCHMARK.json at the root of the checkout,
and the files it names: a cell's configuration (`configs/<name>.json`), its
traffic mix (`traffic/<name>.json`) with the mix's content
(`content/<name>.py`) and loop (`loops/<name>.py`), its judge
(`cells/<cell>.json`) and each metric's reader (`metrics/<name>.py`), all
found by name so that a new cell, mix, content, loop or metric is new
files and an entry, never an edit."""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def _read(kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def config(name: str) -> dict:
    """A configuration: `params` (CompressParams keywords), `source`,
    `assumed` and `reduced`."""
    return _read("configs", name)


def judge_spec(cell_name: str) -> dict:
    """A cell's judge: how many frames, windows and window samples it
    reads, and the limit of each number compared."""
    return _read("cells", cell_name)["judge"]


def traffic(name: str) -> dict:
    """A traffic mix: the images the generator makes and the loop."""
    return _read("traffic", name)


def _module(kind: str, name: str):
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"codec_bench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        os.path.join(HERE, kind, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def content(name: str):
    """A mix's content: `make(height, width, components, generator,
    device, **params)`, a float64 (height, width, components) tensor."""
    return _module("content", name).make


def loop(name: str):
    """A mix's loop: a module whose `run(port, pool, prec, params,
    seconds, traced)` drives the window and returns its `Window`."""
    return _module("loops", name)


def metric_reader(name: str):
    """The `read` function of a metric's own file: an end-to-end metric's
    reads the `Window`, a per-layer metric's the traced window's `Trace`."""
    return _module("metrics", name).read


def cell_metrics(bench: dict, name: str, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` entries that a cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]
