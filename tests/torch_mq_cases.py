"""Inputs shared by the MQ tests of the port (tests/test_torch_mq.py on the
CPU, tests/test_torch_cuda.py and chip_smoke.py on the card): codeblocks
made from a seed with numpy, their codewords, pass-capped decodes and
corrupt streams.  Imports neither jax nor grok_tpu; codewords come from the
port's own Python coder (grok_tpu_torch/t1/coder.py)."""

import numpy as np

from grok_tpu_torch.params import CblkStyle
from grok_tpu_torch.t1 import coder

# grok_tpu's tests/test_device_ops.py test_device_mq_encoder_bit_exact:
# (h, w, largest magnitude, density of nonzeros)
ENC_CASES = [(16, 16, 900, 0.5), (7, 13, 40, 0.3), (32, 32, 1 << 20, 0.8),
             (1, 9, 5, 1.0)]
STYLES = (CblkStyle.NONE, CblkStyle.LAZY)


def enc_blocks(rng, h, w, mx, dens, n=3):
    """n int32 (h, w) blocks, the last all zero."""
    batch = rng.integers(-mx, mx + 1, size=(n, h, w)).astype(np.int32)
    batch[rng.random(batch.shape) > dens] = 0
    batch[n - 1] = 0
    return batch


def photo(h, w):
    """BASELINE config 2's photo content (smooth colour fields, noise sigma
    3) at h x w, 8-bit RGB as int32."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    rgb = np.stack([128 + 90 * np.sin(xx / 23) * np.cos(yy / 17),
                    128 + 80 * np.sin(xx / 15),
                    128 + 80 * np.cos(yy / 19)], -1)
    return (rgb + rng.normal(0, 3, rgb.shape)).clip(0, 255).astype(np.int32)


def dist_blocks(rng, n=5, h=32, w=32):
    """grok_tpu's test_device_mq_encode_with_distortion_tracking blocks."""
    return [rng.normal(0, 300, (h, w)).astype(np.int32) for _ in range(n)]


def mixed_blocks(rng, n=24):
    """Blocks of mixed shapes, magnitudes and orients, some all zero."""
    shapes = [(64, 64), (32, 32), (16, 16), (7, 13), (4, 64), (64, 4),
              (1, 9), (33, 17)]
    out = []
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        mx = int(1 << int(rng.integers(0, 18)))
        b = rng.integers(-mx, mx + 1, size=(h, w)).astype(np.int32)
        b[rng.random((h, w)) < rng.random()] = 0
        if i % 7 == 6:
            b[:] = 0
        out.append(b)
    return out


# the widest legal codeblocks (xcb + ycb = 12 and 11 with xcb or ycb 2 or
# 3), launched together with 64 x 64 blocks: the kernels size their shared
# memory by the launch's largest block
EXTREME_SHAPES = [(1024, 4), (4, 1024), (512, 8), (8, 512)]


def extreme_blocks(rng, mx=3000):
    """One block of each extreme shape and two of 64 x 64, 40% zeros."""
    out = []
    for h, w in EXTREME_SHAPES + [(64, 64), (64, 64)]:
        b = rng.integers(-mx, mx + 1, size=(h, w)).astype(np.int32)
        b[rng.random((h, w)) < 0.4] = 0
        out.append(b)
    return out


def full_depth_blocks(rng):
    """Lossless blocks to the last plane beside photo-depth ones, for one
    launch: a dense 32 x 32 and a 64 x 16 band-edge block with magnitudes
    up to 2^18 (numbps 19, a 16-bit image's deepest band), a 32 x 64 of a
    16-bit mammogram's quantum noise (numbps about 9), and two 20:1 photo
    blocks (numbps up to 10).  The deep blocks are kept small: the twins
    take a step a decision, and a dense 64 x 64 to 19 planes is a minute
    of them."""
    deep = [rng.integers(-(1 << 18), (1 << 18) + 1, size=s).astype(np.int32)
            for s in ((32, 32), (64, 16))]
    deep[1][rng.random(deep[1].shape) < 0.2] = 0
    for b in deep:
        b.flat[int(rng.integers(0, b.size))] = -(1 << 18)
    noise = np.round(rng.normal(0, 60, (32, 64))).astype(np.int32)
    photo = []
    for h, w in ((64, 64), (16, 64)):
        b = rng.integers(-(1 << 9), (1 << 9) + 1, size=(h, w)).astype(
            np.int32)
        b[rng.random((h, w)) < 0.6] = 0
        photo.append(b)
    return deep + [noise] + photo


def segments(passes, npd):
    """The codeword segment lengths of the first npd passes, as Tier-2
    hands them over (split at terminations and after the last pass)."""
    seg, last = [], 0
    for pi, p in enumerate(passes[:npd]):
        if p.term or pi == npd - 1:
            seg.append(p.rate - last)
            last = p.rate
    return seg, last


def dec_items(rng, blocks, styles, capped=True):
    """Decode items (data, seg_lengths, num_passes, numbps, h, w, orient,
    style) of the blocks coded by the Python coder; with capped, every
    third block keeps only its first passes (a layer-limited decode)."""
    items = []
    for i, (b, style) in enumerate(zip(blocks, styles)):
        orient = int(rng.integers(0, 4))
        data, nb, passes = coder.encode_cblk(b, orient, style)
        npd = len(passes)
        if capped and i % 3 == 1 and npd:
            npd = max(1, 2 * npd // 3)
        seg, last = segments(passes, npd)
        items.append((data[:last], seg, npd, nb, b.shape[0], b.shape[1],
                      orient, style))
    return items


def corrupt_items(rng, items, n=24):
    """Random bytes under plausible headers, truncations, and segment
    lengths that reach past the block's bytes."""
    out = []
    for i in range(n):
        h, w = [(16, 16), (7, 13), (32, 32), (64, 64)][i % 4]
        nb = int(rng.integers(1, 14))
        style = STYLES[i % 2]
        npass = 3 * nb - 2
        data = rng.integers(0, 256, int(rng.integers(0, 400)),
                            dtype=np.uint8).tobytes()
        nseg = len(coder.segment_layout(style, nb))
        cuts = np.sort(rng.integers(0, len(data) + 1, max(0, nseg - 1)))
        seg = np.diff(np.concatenate([[0], cuts, [len(data)]])).tolist()
        out.append((data, seg, npass, nb, h, w, int(rng.integers(0, 4)),
                    style))
    for data, seg, npd, nb, h, w, orient, style in items:
        if not data:
            continue
        out.append((data[:len(data) // 2], seg, npd, nb, h, w, orient,
                    style))
        out.append((data[:1], seg, npd, nb, h, w, orient, style))
        out.append((b"", seg, npd, nb, h, w, orient, style))
        out.append((data, [s + 5 for s in seg], npd, nb, h, w, orient,
                    style))
        out.append((data, seg[:1], npd, nb, h, w, orient, style))
    return out
