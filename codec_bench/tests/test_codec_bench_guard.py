"""What the benchmark loads: never JAX, flax or the JAX package; and the
judge's reference loads nothing of the port either.  Names are compared
whole, by the part before the first dot."""

import json
import os
import subprocess
import sys

from codec_bench.core import guard

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_names_compared_whole():
    mods = ["grok_tpu_torch", "grok_tpu_torch.ops.dwt", "numpy", "jaxy",
            "grok_tpu.ops", "jax.numpy", "jaxlib", "flax.linen"]
    assert guard.loaded(modules=mods) == ["flax.linen", "grok_tpu.ops",
                                          "jax.numpy", "jaxlib"]


def fresh(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_port():
    tops = fresh(
        "import json, sys\n"
        "import codec_bench.reference.judge, codec_bench.reference.t1_mq\n"
        "import codec_bench.reference.t1_ht\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    for name in ("grok_tpu_torch", "grok_tpu", "jax", "jaxlib", "flax"):
        assert name not in tops


def test_harness_and_port_load_no_jax():
    found = fresh(
        "import json\n"
        "from codec_bench.core import bench, guard, manifest\n"
        "b = manifest.load()\n"
        "[manifest.metric_reader(m['name'])\n"
        " for m in b['per_layer'] + b['end_to_end']]\n"
        "from codec_bench.core import traffic\n"
        "for w in b['workloads']:\n"
        "    mix = manifest.traffic(w['traffic'])\n"
        "    manifest.content(mix['content']), traffic.loop(mix)\n"
        "port = bench.Port()\n"
        "from codec_bench.reference import judge\n"
        "print(json.dumps(guard.loaded()))")
    assert found == []
