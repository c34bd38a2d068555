"""The harness's arithmetic: rates over all the work and all the time,
self time and the device's idle share on synthetic spans, and the
roofline's bytes against PERF.md's bounds."""

import pytest

from codec_bench.core import bench, roofline
from codec_bench.core.trace import Trace, covered, union


def test_rate_is_all_work_over_all_time():
    px = 3840 * 2160
    steady = bench.rate_mps(4 * px, [0.4, 0.4, 0.4, 0.4])
    assert steady == pytest.approx(4 * px / 1.6 / 1e6)
    stalled = bench.rate_mps(4 * px, [0.4, 0.4, 2.0, 0.4])
    assert stalled < steady
    # not a median of calls: one stall moves it
    assert stalled == pytest.approx(4 * px / 3.2 / 1e6)
    assert bench.rate_mps(0, []) is None


def test_union_and_covered():
    merged = union([(5, 7), (0, 2), (1, 3), (6, 9)])
    assert merged == [(0, 3), (5, 9)]
    assert covered(merged, 2, 6) == 2  # [2, 3) and [5, 6)


def synthetic():
    # two encode calls of 100 us; inside each a transform span and a t1
    # span; kernels and a copy on the card
    spans = [("encode", 0, 100), ("encode/transform", 10, 30),
             ("encode/t1", 40, 80),
             ("encode", 200, 300), ("encode/transform", 210, 230),
             ("encode/t1", 240, 280),
             ("decode", 100, 150)]
    kernels = [("k1", 12, 18), ("k2", 50, 60), ("k1", 212, 218),
               ("k2", 250, 60 + 200)]
    activity = kernels + [("Memcpy HtoD", 20, 30), ("Memcpy HtoD", 220, 230)]
    meta = {"encode": [{"h": 2160, "w": 3840, "comps": 3, "numres": 6,
                        "coded": 0, "ht": True}] * 2, "decode": []}
    return Trace(spans, kernels, activity, meta)


def test_self_time_and_layers():
    t = synthetic()
    assert t.layer_ms("encode", "transform") == pytest.approx(0.020)
    assert t.layer_ms("encode", "t1") == pytest.approx(0.040)
    assert t.self_ms("encode") == pytest.approx(0.040)  # 100 - 20 - 40
    assert t.self_ms("decode") == pytest.approx(0.050)
    assert t.layer_ms("decode", "t1") is None


def test_idle_share_is_the_union_of_device_records():
    t = synthetic()
    # busy in each encode call: 12-18, 20-30, 50-60 -> 26 of 100 us
    assert t.idle_pct("encode") == pytest.approx(74.0)
    assert t.idle_pct("decode") == pytest.approx(100.0)
    assert t.busy_s() == pytest.approx(52e-6)
    assert t.window_s() == pytest.approx(300e-6)


def test_kernels_matched_by_span_not_name():
    t = synthetic()
    assert t.kernel_us("encode", "transform") == pytest.approx(12)
    assert t.kernel_us("encode", "t1") == pytest.approx(20)


def test_breakdown_names_gaps_by_span():
    b = synthetic().breakdown()
    gaps = dict(b["idle_gaps"])
    assert gaps["encode/host"] == pytest.approx(80e-6)  # 2 x (100 - 60)
    assert gaps["encode/transform"] == pytest.approx(8e-6)
    assert gaps["encode/t1"] == pytest.approx(60e-6)
    assert gaps["decode/host"] == pytest.approx(50e-6)
    assert dict(b["device_ops"])["Memcpy HtoD"] == pytest.approx(20e-6)


def test_roofline_bytes_against_the_kernel_table():
    # PERF.md's bounds: a 5/3 level-1 pass over 3 x 2160 x 3840 samples,
    # a 9/7 level-1 pass over 3 x 2048 x 2048
    assert roofline.least_ms(8 * 3 * 2160 * 3840) == pytest.approx(
        0.0594, abs=5e-5)
    assert roofline.least_ms(8 * 3 * 2048 * 2048) == pytest.approx(
        0.0300, abs=5e-5)
    # a whole UHD encode: the colour pass and five levels
    b = roofline.transform_bytes(2160, 3840, 3, 6)
    levels = sum(3 * -(-2160 // 2 ** k) * -(-3840 // 2 ** k)
                 for k in range(5))
    assert b == 8 * (3 * 2160 * 3840 + levels)
    assert roofline.t1_bytes(64, 64, 1, 100, True) == 4 * 4096 + 200
    assert roofline.t1_bytes(64, 64, 1, 100, False) == 4 * 4096 + 100


def test_roofline_share_from_trace():
    t = synthetic()
    share = t.roofline_pct("encode", "transform",
                           bench.least_ms("transform", "encode"))
    want = 100 * 2 * roofline.least_ms(roofline.transform_bytes(
        2160, 3840, 3, 6)) * 1e3 / 12
    assert share == pytest.approx(want)
    assert t.roofline_pct("decode", "t1", bench.least_ms("t1", "decode")) \
        is None

