"""Which modules a process holds that the benchmark must never load: the
JAX package the port was made from, JAX itself and flax.  Names are
compared whole, by the part before the first dot, so that the port,
whose name begins with the JAX package's, does not match."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "grok_tpu")


def loaded(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)
