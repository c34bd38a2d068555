"""The port's phase spans (grok_tpu_torch/trace.py) on the CPU twins.

Round trips under torch.profiler export their `grk/` ranges to a Chrome
trace: every phase appears, inside its call's root, and the phases of a
call do not overlap; a collection inside a phase is a `grk/gc/gen2`
range; the collector hook lives only while a root is open.  Without a
profiler no range is entered and no hook installed.
"""

import gc
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import grok_tpu_torch
from grok_tpu_torch import trace
from grok_tpu_torch.tile import processor

ENCODE = ("header", "tiles", "transform", "t1_jobs", "t1", "t1_ingest",
          "ratecontrol", "t2", "assemble")
DECODE = ("parse", "tiles", "t2", "t1_jobs", "t1", "t1_ingest", "transform",
          "paste", "post")
CASES = {
    "ht_lossless": dict(numresolution=3, ht=True),
    "lossy_97": dict(numresolution=3, irreversible=True, layer_rates=[20]),
    "tiled_ht": dict(numresolution=2, ht=True, tile_size=(32, 32)),
}
EPS = 1e-3  # the export's microseconds carry three decimals


def image(h=48, w=64, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)


def round_trip(kw, arr=None):
    arr = image() if arr is None else arr
    data = grok_tpu_torch.compress(
        grok_tpu_torch.GrkImage.from_array(arr),
        grok_tpu_torch.CompressParams(**kw), device="cpu")
    return grok_tpu_torch.decompress(data, device="cpu").to_array()


def traced(tmp_path, kw):
    """The `grk/` ranges of one profiled round trip, (name, start, end),
    from the exported Chrome trace, in order of start."""
    round_trip(kw)  # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = round_trip(kw)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e["name"].startswith("grk/"))
    return sorted(spans, key=lambda s: s[1]), out


def inside(span, outer) -> bool:
    return outer[1] - EPS <= span[1] and span[2] <= outer[2] + EPS


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_phase_inside_its_root(tmp_path, case):
    spans, out = traced(tmp_path, CASES[case])
    assert out.shape == image().shape
    roots = {d: [s for s in spans if s[0] == f"grk/{d}"]
             for d in ("encode", "decode")}
    assert len(roots["encode"]) == len(roots["decode"]) == 1
    names = {s[0] for s in spans}
    for d, phases in (("encode", ENCODE), ("decode", DECODE)):
        root = roots[d][0]
        want = {f"grk/{d}/{p}" for p in phases}
        assert want <= names, sorted(want - names)
        mine = [s for s in spans if s[0].startswith(f"grk/{d}/")]
        assert all(inside(s, root) for s in mine)
        # one phase at a time
        for a, b in zip(mine, mine[1:]):
            assert b[1] >= a[2] - EPS, (a, b)
    # the planes' interleaving follows the decode, outside it
    to_array = [s for s in spans if s[0] == "grk/to_array"]
    assert len(to_array) == 1
    assert to_array[0][1] >= roots["decode"][0][2] - EPS
    assert roots["decode"][0][1] >= roots["encode"][0][2] - EPS
    assert trace._Collector.hook not in gc.callbacks


@pytest.mark.parametrize("where, direction, phase", [
    ("_encode_jobs", "encode", "t1_jobs"),
    ("_decode_jobs", "decode", "t1_jobs"),
])
def test_collection_inside_a_phase_is_a_span(tmp_path, monkeypatch, where,
                                             direction, phase):
    owner = processor.TileCompressor if direction == "encode" \
        else processor.TileDecompressor
    real = getattr(owner, where)

    def collecting(self, *a, **k):
        gc.collect()
        return real(self, *a, **k)

    monkeypatch.setattr(owner, where, collecting)
    spans, _ = traced(tmp_path, CASES["ht_lossless"])
    root = next(s for s in spans if s[0] == f"grk/{direction}")
    holder = [s for s in spans if s[0] == f"grk/{direction}/{phase}"]
    pauses = [s for s in spans if s[0] == "grk/gc/gen2"]
    assert any(inside(g, root) and any(inside(g, h) for h in holder)
               for g in pauses), pauses
    assert trace._Collector.hook not in gc.callbacks


def test_collection_inside_to_array_is_a_span(tmp_path, monkeypatch):
    """`to_array` is a root of its own, after the decode's: a collection
    while it interleaves the planes is a `grk/gc/gen2` range inside it."""
    from grok_tpu_torch import image as image_module

    class CollectingNumpy:
        def __getattr__(self, name):
            return getattr(np, name)

        def stack(self, *a, **k):
            gc.collect()
            return np.stack(*a, **k)

    monkeypatch.setattr(image_module, "np", CollectingNumpy())
    spans, out = traced(tmp_path, CASES["ht_lossless"])
    assert out.shape == image().shape
    (root,) = [s for s in spans if s[0] == "grk/to_array"]
    pauses = [s for s in spans if s[0] == "grk/gc/gen2"]
    assert any(inside(g, root) for g in pauses), pauses
    assert trace._Collector.hook not in gc.callbacks


class CountingRange:
    entered = 0

    def __init__(self, name, args=None):
        self.name = name

    def __enter__(self):
        CountingRange.entered += 1
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("case", ["ht_lossless", "lossy_97"])
def test_no_profiler_no_ranges_no_hook(monkeypatch, case):
    round_trip(CASES[case])  # warm
    hooks = []
    real = processor.TileCompressor._encode_jobs

    def watching(self, *a, **k):
        hooks.append(list(gc.callbacks))
        return real(self, *a, **k)

    monkeypatch.setattr(processor.TileCompressor, "_encode_jobs", watching)
    monkeypatch.setattr(torch.profiler, "record_function", CountingRange)
    CountingRange.entered = 0
    before = list(gc.callbacks)
    out = round_trip(CASES[case])
    assert out.shape == image().shape
    assert CountingRange.entered == 0
    assert hooks and all(h == before for h in hooks)
    assert gc.callbacks == before
    assert trace.span("grk/encode/t2") is trace.root("grk/encode")


def test_hook_leaves_when_the_call_raises():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(grok_tpu_torch.CodestreamError):
            grok_tpu_torch.decompress(b"\x00" * 64, device="cpu")
        assert trace._Collector.hook not in gc.callbacks
        with trace.root("grk/encode"):
            with trace.root("grk/decode"):
                assert gc.callbacks.count(trace._Collector.hook) == 1
            assert trace._Collector.hook in gc.callbacks
    assert trace._Collector.hook not in gc.callbacks
    assert trace._Collector.roots == 0


def test_cli_profile_holds_the_spans(tmp_path):
    """grk_compress and grk_decompress --profile DIR: the Chrome trace
    holds each call's root and its phases."""
    import os

    from grok_tpu_torch.cli import grk_compress, grk_decompress

    arr = image(24, 32)[:, :, 0]
    src = tmp_path / "in.pgm"
    src.write_bytes(b"P5\n32 24\n255\n" + arr.tobytes())
    cs = tmp_path / "out.j2k"
    for tool, args, direction in (
            (grk_compress, ["-i", str(src), "-o", str(cs), "-n", "2"],
             "encode"),
            (grk_decompress, ["-i", str(cs), "-o", str(tmp_path / "o.pgm")],
             "decode")):
        prof = tmp_path / direction
        assert tool.main(args + ["--profile", str(prof), "--device",
                                 "cpu"]) == 0
        (name,) = os.listdir(prof)
        events = json.loads((prof / name).read_text())["traceEvents"]
        names = {e["name"] for e in events
                 if e.get("cat") == "user_annotation"}
        want = {f"grk/{direction}/{p}"
                for p in (ENCODE if direction == "encode" else DECODE)}
        assert {f"grk/{direction}"} | want <= names, sorted(want - names)
    assert trace._Collector.hook not in gc.callbacks
