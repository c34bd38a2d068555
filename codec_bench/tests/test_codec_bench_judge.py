"""The judge: sound outputs read 0 where the comparison is exact, the
control one precision step down fails, and a run with its timed path
broken underneath comes out not correct, for each fault a cell can have."""

import numpy as np
import pytest
import torch

import grok_tpu_torch as port_lib
from codec_bench.core import manifest
from codec_bench.core import traffic as gen
from codec_bench.reference import judge, transforms
from codec_bench.tests import cpu_run

CELLS = {"htj2k_lossless": "htj2k_lossless.uhd_camera",
         "j2k_lossy_mq": "j2k_lossy_mq.photo2k"}
CONFIGS = list(CELLS)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tree")
    path = cpu_run.tiny_tree(str(tmp))
    return path, str(tmp / "codec_bench")


def frames_of(config, w=96, h=64, pool=2, seed=5):
    mix = dict(manifest.traffic("photo2k"), width=w, height=h, pool=pool)
    imgs = gen.make_pool(mix, seed)
    params = manifest.config(config)["params"]
    frames = []
    for k, img in enumerate(imgs):
        cs = port_lib.compress(port_lib.GrkImage.from_array(img, prec=8),
                               port_lib.CompressParams(**params),
                               device="cpu")
        out = port_lib.decompress(cs, device="cpu").to_array()
        frames.append((k, cs, out))
    return imgs, params, frames


@pytest.mark.parametrize("config", CONFIGS)
def test_sound_reads_zero_and_control_fails(config):
    imgs, params, frames = frames_of(config)
    seq = np.random.SeedSequence([3, 1])
    sound = judge.judge_window(frames, imgs, params, seq, 2, 3, 16)
    limits = manifest.judge_spec(CELLS[config])["limits"]
    assert all(sound[k] <= limits[k] for k in limits), sound
    assert sound["enc_mismatch"] == 0
    ctl = judge.judge_window(frames, imgs, params, seq, 2, 3, 16,
                             control=True)
    assert any(ctl[k] > limits[k] for k in limits), ctl
    assert ctl["enc_mismatch"] > 0.01
    if "dec_mismatch" in ctl:
        assert ctl["dec_mismatch"] > 0.1


def test_cone_holds_every_dependency():
    """Coefficients outside a window's cone do not move its samples: the
    synthesis reads nothing beyond the blocks the judge decodes."""
    g = torch.Generator().manual_seed(1)
    numres, h, w = 5, 96, 128
    bands = transforms.analysis(torch.randn(h, w, generator=g), numres,
                                False)
    base = transforms.synthesis97(bands, numres)
    for y0, x0 in ((0, 0), (40, 57), (80, 112)):
        y1, x1 = y0 + 16, x0 + 16
        noisy = {}
        ys, xs = judge.cone(y0, y1, numres - 1), judge.cone(x0, x1,
                                                             numres - 1)
        for (r, o), b in bands.items():
            lev = numres - 1 - r if r else numres - 2
            (ya, yb), (xa, xb) = ys[lev], xs[lev]
            keep = torch.zeros_like(b, dtype=torch.bool)
            keep[ya:yb, xa:xb] = True
            noisy[(r, o)] = torch.where(keep, b, b + 1000.0)
        moved = transforms.synthesis97(noisy, numres)
        assert torch.equal(moved[y0:y1, x0:x1], base[y0:y1, x0:x1])


@pytest.mark.parametrize("config", CONFIGS)
def test_a_sound_run_is_correct(tiny, monkeypatch, config):
    path, base = tiny
    monkeypatch.setattr(manifest, "HERE", base)
    rc, result, out = cpu_run.run(path, f"{config}.tiny", seconds=0.2)
    assert rc == 0 and result["correct"], out
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(result)


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("config", CONFIGS)
def test_a_broken_run_is_not_correct(tiny, monkeypatch, config, fault):
    path, base = tiny
    monkeypatch.setattr(manifest, "HERE", base)
    # a window of several CPU round trips, also on a loaded machine
    rc, result, out = cpu_run.run(path, f"{config}.tiny", seconds=3.0,
                                  fault=fault)
    assert rc == 0, out
    assert result["attempted"] >= 4  # a stale decode hands back a frame
    assert result["correct"] is False, cpu_run.numbers(result)
