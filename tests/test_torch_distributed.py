"""The port's multi-host batch sharding (parallel/distributed.py) against
grok_tpu's: the same round-robin partition, (0, 1) with nothing to
initialize, and under a two-process torch.distributed group (gloo,
file:// rendezvous) disjoint shards that cover the batch, through the
CLI's shard_pairs too.
"""

import json
import os
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")

from grok_tpu.parallel import distributed as ref_dist  # noqa: E402
from grok_tpu_torch.cli import common  # noqa: E402
from grok_tpu_torch.parallel import distributed as dist  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n,hosts", [(0, 1), (7, 1), (7, 3), (10, 4),
                                     (3, 5)])
def test_shard_batch_matches_reference(n, hosts):
    items = [f"img{i}.pgm" for i in range(n)]
    shards = [dist.shard_batch(items, hosts, h) for h in range(hosts)]
    assert shards == [ref_dist.shard_batch(items, hosts, h)
                      for h in range(hosts)]
    assert sorted(sum(shards, [])) == sorted(items)
    for bad in ((0, 0), (hosts, hosts), (hosts, -1)):
        with pytest.raises(ValueError):
            dist.shard_batch(items, *bad)


def test_single_process_defaults():
    """No group: init_distributed() has nothing to do, auto_shard and
    shard_pairs(num_hosts=0) keep the whole list."""
    assert dist.init_distributed() == (0, 1)
    items = list(range(5))
    assert dist.auto_shard(items) == items
    assert common.shard_pairs(items, 0, 0) == items
    assert common.shard_pairs(items, 2, 1) == [1, 3]


_WORKER = """
import json, sys
import torch.distributed as tdist
from grok_tpu_torch.cli import common
from grok_tpu_torch.parallel import distributed as dist
rank, init = int(sys.argv[1]), sys.argv[2]
tdist.init_process_group("gloo", init_method=init, world_size=2, rank=rank)
got = dist.init_distributed()
items = [f"img{i}.pgm" for i in range(9)]
print(json.dumps({"init": list(got), "shard": dist.auto_shard(items),
                  "pairs": common.shard_pairs(items, 0, 0)}))
tdist.destroy_process_group()
"""


def test_two_process_gloo_group(tmp_path):
    init = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), init],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    items = [f"img{i}.pgm" for i in range(9)]
    for r, o in enumerate(outs):
        assert o["init"] == [r, 2]
        assert o["shard"] == o["pairs"] == ref_dist.shard_batch(items, 2, r)
    assert not set(outs[0]["shard"]) & set(outs[1]["shard"])
    assert sorted(outs[0]["shard"] + outs[1]["shard"]) == sorted(items)
