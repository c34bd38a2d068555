"""The port's own `grk/` phase spans (grok_tpu_torch/trace.py) beside the
benchmark's: on a hand-built Chrome trace and in a traced run on the CPU,
every per-layer reader, `busy_s`, `window_s` and the breakdown read the
same with those spans as without them."""

import json

import pytest

from codec_bench.core import bench, manifest
from codec_bench.core.trace import read_chrome
from codec_bench.tests import cpu_run

OLD = ("host_self_ms", "transform_ms", "t1_ms", "transform_roofline_pct",
       "t1_roofline_pct", "device_idle_pct")
META = {"h": 64, "w": 64, "comps": 3, "numres": 3, "coded": 1000,
        "ht": True}

# the benchmark's spans, the card's records and the port's spans of two
# encode calls and one decode, in microseconds
BENCH = [("encode", 0, 1000), ("encode/transform", 100, 200),
         ("encode/t1", 300, 500), ("decode", 1000, 1600),
         ("decode/t1", 1200, 1300), ("decode/transform", 1350, 1450),
         ("encode", 2000, 2500)]
CARD = [("kernel", "k1", 120, 150), ("kernel", "k2", 310, 330),
        ("gpu_memcpy", "Memcpy HtoD", 400, 450), ("kernel", "k3", 1220, 1250),
        ("kernel", "k4", 1360, 1380), ("gpu_memset", "Memset", 2300, 2310)]
GRK = [("grk/encode", 10, 990), ("grk/encode/header", 10, 50),
       ("grk/encode/tiles", 50, 80), ("grk/encode/transform", 90, 210),
       ("grk/encode/t1_jobs", 220, 290), ("grk/gc/gen0", 230, 250),
       ("grk/encode/t1", 295, 505), ("grk/encode/t1_ingest", 510, 560),
       ("grk/encode/ratecontrol", 560, 700), ("grk/gc/gen2", 600, 640),
       ("grk/encode/t2", 700, 850), ("grk/encode/assemble", 850, 980),
       ("grk/decode", 1005, 1560), ("grk/decode/parse", 1005, 1050),
       ("grk/decode/tiles", 1050, 1100), ("grk/decode/t2", 1100, 1190),
       ("grk/decode/t1_jobs", 1190, 1200), ("grk/decode/t1", 1200, 1300),
       ("grk/decode/t1_ingest", 1300, 1340),
       ("grk/decode/transform", 1340, 1460),
       ("grk/decode/paste", 1460, 1500), ("grk/decode/post", 1500, 1550),
       ("grk/to_array", 1565, 1590),
       ("grk/gc/gen1", 1570, 1580),
       ("grk/encode", 2000, 2500), ("grk/encode/t2", 2100, 2200),
       ("grk/encode/t2", 2120, 2150),
       ("grk/gc/gen0", 2490, 2510)]

def chrome(path, with_grk: bool) -> str:
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s,
               "dur": e - s} for n, s, e in BENCH + (GRK if with_grk else [])]
    events += [{"ph": "X", "cat": c, "name": n, "ts": s, "dur": e - s}
               for c, n, s, e in CARD]
    events.append({"ph": "i", "cat": "cpu_op", "name": "aten::add",
                   "ts": 5})
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def read(path):
    return read_chrome(path, {"encode": [META, META], "decode": [META]})


def readings(trace, families) -> dict:
    return {f"{f}.{d}": manifest.metric_reader(f"{f}.{d}")(trace)
            for f in families for d in ("encode", "decode")}


def test_old_readers_unmoved_by_the_ports_spans(tmp_path):
    plain = read(chrome(tmp_path / "plain.json", False))
    spanned = read(chrome(tmp_path / "spanned.json", True))
    old = readings(plain, OLD)
    assert len(old) == 12 and all(v is not None for v in old.values())
    assert readings(spanned, OLD) == old
    assert spanned.breakdown() == plain.breakdown()
    assert spanned.busy_s() == plain.busy_s()
    assert spanned.window_s() == plain.window_s()


@pytest.mark.parametrize("cell", ["htj2k_lossless.tiny",
                                  "j2k_lossy_mq.tiny"])
def test_traced_run_drops_the_ports_spans(tmp_path, monkeypatch, cell):
    """A --trace 1 run on the CPU: the Chrome trace holds the port's
    roots and phases, the benchmark's reader keeps none of them, and the
    result line carries the benchmark's metrics and no other."""
    path = cpu_run.tiny_tree(str(tmp_path))
    monkeypatch.setattr(manifest, "HERE", str(tmp_path / "codec_bench"))
    seen = {}
    real = bench.read_chrome

    def reading(trace_file, meta):
        events = json.loads(open(trace_file).read())["traceEvents"]
        seen["grk"] = {e["name"] for e in events
                       if e.get("cat") == "user_annotation"
                       and e["name"].startswith("grk/")}
        got = real(trace_file, meta)
        seen["layers"] = set(got.layers)
        return got

    monkeypatch.setattr(bench, "read_chrome", reading)
    rc, result, _ = cpu_run.run(path, cell, trace=1, seconds=0.3)
    assert rc == 0 and result["correct"], result
    assert {"grk/encode", "grk/decode", "grk/to_array", "grk/encode/t2",
            "grk/decode/t2"} <= seen["grk"]
    assert not any(n.startswith("grk") for n in seen["layers"])
    names = {m["name"] for m in manifest.load(path)["per_layer"]}
    assert {"host_self_ms.encode", "host_self_ms.decode"} \
        <= set(result["metrics"]) <= names
