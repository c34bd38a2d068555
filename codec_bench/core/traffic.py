"""The one generator of traffic.  A mix is a data file
(`traffic/<name>.json`) of parameters: the image size, components and
precision, the pool's size, the warm round trips, the named content
(`content/<name>.py`) with its parameters, and the named loop
(`loops/<name>.py`, `round_trip` unless the mix says otherwise).  This
turns a mix and a seed into the pool of images a run cycles through; each
pool image draws from its own seed, derived from the run's seed and its
index.
"""

from __future__ import annotations

import numpy as np
import torch

from . import manifest

DEFAULT_LOOP = "round_trip"


def frame_seed(seed: int, index: int) -> int:
    """A 63-bit seed for pool image `index` of a run with `seed`."""
    ss = np.random.SeedSequence([seed & (2 ** 64 - 1), index])
    return int(ss.generate_state(1, dtype=np.uint64)[0]) >> 1


def make_image(mix: dict, seed: int, device="cpu") -> np.ndarray:
    """One (height, width, components) image of the mix, unsigned, in the
    smallest numpy integer type that holds its precision."""
    prec = mix["precision"]
    gen = torch.Generator(device=device).manual_seed(seed)
    x = manifest.content(mix["content"])(
        mix["height"], mix["width"], mix["components"], gen, device,
        **mix.get("params", {}))
    x = x.clamp(0, (1 << prec) - 1).floor()
    out = x.to(torch.uint8 if prec <= 8 else torch.int32).cpu().numpy()
    return out[:, :, 0] if mix["components"] == 1 else out


def make_pool(mix: dict, seed: int, device="cpu") -> list[np.ndarray]:
    return [make_image(mix, frame_seed(seed, k), device)
            for k in range(mix["pool"])]


def loop(mix: dict):
    """The mix's loop: `run(port, pool, prec, params, seconds, traced)`."""
    return manifest.loop(mix.get("loop", DEFAULT_LOOP))
