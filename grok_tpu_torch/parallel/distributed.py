"""Multi-host batch sharding.

Parity: SURVEY.md §2.3 "Distributed backend" — the reference is single-
node (pthreads), and the codec's units of work (images, tiles) are
embarrassingly parallel, so the multi-host story is DATA sharding, not
collectives: each process of a torch.distributed job takes a
deterministic slice of the work list and runs the ordinary single-process
pipeline.  No collective carries codec data.

Two entry styles:

- explicit: ``shard_batch(items, num_hosts, host_id)`` — usable from any
  launcher (mpirun, k8s indexed jobs, SLURM) without initializing
  torch.distributed;
- torch-managed: ``init_distributed(...)`` wraps
  ``torch.distributed.init_process_group`` and ``auto_shard(items)``
  then slices by ``get_rank()/get_world_size()``.

The interleaved (round-robin) assignment keeps per-host work balanced
when file sizes correlate with directory order.
"""

from __future__ import annotations

import logging

import torch
import torch.distributed as tdist

log = logging.getLogger("grok_tpu_torch")


def shard_batch(items: list, num_hosts: int, host_id: int) -> list:
    """Deterministic, disjoint, complete partition of a work list:
    host k takes items k, k+N, k+2N, ...  (round-robin)."""
    if num_hosts < 1:
        raise ValueError("num_hosts must be >= 1")
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
    return list(items[host_id::num_hosts])


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Join a torch.distributed job and return (rank, world_size).

    With `coordinator_address` ("host:port") the group is initialized
    from tcp://<coordinator_address> with the given world size and rank;
    with only `num_processes`, from the environment (env://: MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE).  The backend is nccl where CUDA is
    present, gloo otherwise.  Returns (0, 1) when there is nothing to
    initialize: no arguments and no group initialized already, or a
    build of torch without distributed support."""
    if not tdist.is_available():
        log.warning("torch.distributed unavailable; single-host")
        return 0, 1
    if not tdist.is_initialized():
        if coordinator_address is None and num_processes is None:
            return 0, 1  # nothing to initialize in a single-process run
        backend = "nccl" if torch.cuda.is_available() else "gloo"
        init = (f"tcp://{coordinator_address}"
                if coordinator_address is not None else "env://")
        tdist.init_process_group(
            backend, init_method=init,
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id)
    return tdist.get_rank(), tdist.get_world_size()


def auto_shard(items: list) -> list:
    """This process's slice of a work list under an initialized
    torch.distributed job; the full list when no group is initialized."""
    if not (tdist.is_available() and tdist.is_initialized()):
        return list(items)
    return shard_batch(items, tdist.get_world_size(), tdist.get_rank())
