"""j2k_random_tile_access — tile-independence conformance tool.

Parity: tests/j2k_random_tile_access.cpp (SURVEY.md §4 family 3): decode
every tile of a codestream in a shuffled order via the single-tile decode
API (grk_decompress_tile parity -> DecompressParams.tile_index) and verify
each tile's pixels match the corresponding window of a full decode.  Tile
independence is what makes random access — and the tile-parallel device
batching — sound.

Every decode runs on the card unless `--device cpu` asks for the
kernels' plain PyTorch versions.

Exit code 0 = all tiles match, 1 = mismatch or decode failure.

Usage:
  python -m grok_tpu_torch.cli.random_tile_access -i in.j2k [--seed N] [--device cpu]
"""

from __future__ import annotations

import argparse
import random
import sys

import numpy as np

from .. import codec
from ..device import resolve_device
from ..params import DecompressParams


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="j2k_random_tile_access")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    dev = resolve_device(args.device)  # no card: an error, not the CPU

    with open(args.input, "rb") as f:
        data = f.read()

    hi = codec.read_header(data)
    cp = hi.cp
    ngrid = cp.t_grid_w * cp.t_grid_h
    full = codec.decompress(data, DecompressParams(), device=dev)

    order = list(range(ngrid))
    random.Random(args.seed).shuffle(order)
    print(f"decoding {ngrid} tiles in order {order}")
    for tidx in order:
        dp = DecompressParams()
        dp.tile_index = tidx
        try:
            timg = codec.decompress(data, dp, device=dev)
        except Exception as e:  # decode must not depend on earlier tiles
            print(f"tile {tidx}: FAILED to decode: {e}")
            return 1
        # canvas rect of this tile, clipped to the image
        ti, tj = tidx % cp.t_grid_w, tidx // cp.t_grid_w
        tx0 = max(cp.tx0 + ti * cp.t_width, hi.image.x0)
        ty0 = max(cp.ty0 + tj * cp.t_height, hi.image.y0)
        tx1 = min(cp.tx0 + (ti + 1) * cp.t_width, hi.image.x1)
        ty1 = min(cp.ty0 + (tj + 1) * cp.t_height, hi.image.y1)
        for c, (tcomp, fcomp) in enumerate(zip(timg.comps, full.comps)):
            # component-sample window of the tile on each plane
            cx0 = -(-tx0 // fcomp.dx) - fcomp.x0
            cy0 = -(-ty0 // fcomp.dy) - fcomp.y0
            cx1 = -(-tx1 // fcomp.dx) - fcomp.x0
            cy1 = -(-ty1 // fcomp.dy) - fcomp.y0
            got = tcomp.data[cy0:cy1, cx0:cx1]
            want = fcomp.data[cy0:cy1, cx0:cx1]
            if not np.array_equal(got, want):
                print(f"tile {tidx} comp {c}: MISMATCH vs full decode")
                return 1
    print(f"all {ngrid} tiles bit-identical to the full decode")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
