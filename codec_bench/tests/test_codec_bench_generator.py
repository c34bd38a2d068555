"""The traffic generator: the same seed gives the same pool, other seeds
other pools, for seeds beyond 32 bits too."""

import numpy as np
import pytest

from codec_bench.core import manifest
from codec_bench.core import traffic as gen


def small(name):
    return dict(manifest.traffic(name), width=80, height=48, pool=3)


@pytest.mark.parametrize("name", ["uhd_camera", "photo2k"])
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, 2 ** 40 + 3, -5])
def test_deterministic_and_distinct(name, seed):
    a = gen.make_pool(small(name), seed)
    b = gen.make_pool(small(name), seed)
    c = gen.make_pool(small(name), seed + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))
    assert not np.array_equal(a[0], a[1])  # the pool's frames differ


@pytest.mark.parametrize("name", ["uhd_camera", "photo2k"])
def test_shape_range_and_content(name):
    mix = small(name)
    img = gen.make_pool(mix, 7)[0]
    assert img.shape == (48, 80, 3) and img.dtype == np.uint8
    # smooth fields under the noise: neighbours agree far more than far
    # samples do, and the frame uses much of the 8-bit range
    near = np.abs(np.diff(img.astype(int), axis=1)).mean()
    assert near < img.astype(int).std()
    assert img.max() - img.min() > 100


@pytest.mark.parametrize("name", ["uhd_camera", "photo2k"])
def test_mix_is_data_with_named_content_and_loop(name):
    """A mix is a data file; its content and loop are found by name."""
    mix = manifest.traffic(name)
    assert all(isinstance(v, (int, float, str, dict)) for v in mix.values())
    assert callable(manifest.content(mix["content"]))
    assert callable(gen.loop(mix).run)
    assert gen.loop({}).__name__ == "codec_bench_loops_round_trip"


def test_frame_seeds_fit_a_torch_generator():
    for seed in (0, 2 ** 31 + 1, 2 ** 63 + 5):
        s = gen.frame_seed(seed, 3)
        assert 0 <= s < 2 ** 63
