"""Without the cards a cell asks for, a run fails and prints no result:
it never falls back to the CPU."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(cwd, cell):
    return subprocess.run(
        [sys.executable, "codec_bench/run.py", "--workload", cell,
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("cell", ["htj2k_lossless.uhd_camera",
                                  "j2k_lossy_mq.photo2k"])
def test_no_card_no_result(cell):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = run(ROOT, cell)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "device" not in out.stdout and "no card" in out.stderr


def probe_hash_seed(tmp_path, *args):
    """The hash seed that run.py's re-start gives a run with `args`,
    whatever the caller's environment."""
    probe = tmp_path / "codec_bench"
    probe.mkdir(exist_ok=True)
    src = open(os.path.join(ROOT, "codec_bench", "run.py")).read()
    head = src.split("import argparse")[0]
    (probe / "run.py").write_text(
        head + "print(os.environ['PYTHONHASHSEED'], hash('codec') ==\n"
        "      hash('codec'))\n")
    out = subprocess.run([sys.executable, str(probe / "run.py"), *args],
                         capture_output=True, text=True, timeout=60,
                         env=dict(os.environ, PYTHONHASHSEED="random"))
    assert out.returncode == 0, out.stderr
    return out.stdout.split()[0]


@pytest.mark.parametrize("args, want", [
    (("--workload", "x", "--seed", "2147483659"), "2147483659"),
    (("--seed=5000000000", "--trace", "0"), str(5000000000 % 2 ** 32)),
    (("--seed", "-3"), str(2 ** 32 - 3)),
])
def test_hash_seed_follows_the_seed(tmp_path, args, want):
    """run.py re-starts itself under a hash seed drawn from `--seed`, so a
    seed's run is repeatable and other seeds give other orderings."""
    assert probe_hash_seed(tmp_path, *args) == want


def test_benchmark_alone_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder:
    no port to run, so no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "codec_bench"),
                    tmp_path / "codec_bench")
    out = run(tmp_path, "htj2k_lossless.uhd_camera")
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
