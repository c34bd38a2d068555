#!/usr/bin/env python3
"""Smoke run of grok_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --mq-times PATH   # only the MQ kernels' times,
                                            # from the checkout at PATH
    python3 chip_smoke.py --dwt97-times PATH  # only the 9/7 level kernels'
                                              # check and times, likewise
    python3 chip_smoke.py --ht-times PATH   # only the HT decode kernels'
                                            # checks and times, likewise
    python3 chip_smoke.py --gigapixel       # only the BASELINE config 5
                                            # run (cell (e))

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
a source, in parallel) and the native host coder from native/, holds each
kernel bit-exact against its plain PyTorch twin at the shapes the lossless
5/3 path and the lossy 9/7 path give it (the 9/7 level and ICT kernels
bit for bit, float outputs by their bits, on config 2's level shapes, odd
and short planes, widths of each residue mod 4 in segments of several
chunks, misaligned tensors, 8-, 12- and 16-bit stacks of 1, 3 and 4
components, and NaN and huge inputs; the HT Tier-1 kernels byte for byte, on corrupt
streams and under the three CxtVLC table swaps too; the MQ Tier-1 kernels
on grok_tpu's test shapes, distortion-tracked blocks, corrupt and truncated
streams, the widest legal shapes and case (a)'s 70 codeblocks), times
kernel and twin (the transform kernels at cases (b) and (d)'s level-1
shapes, the 9/7 level and ICT kernels also by the device's own time,
torch.profiler's kernel records and a CUDA graph of 16 launches, the 9/7
levels at each of case (d)'s four level shapes and summed; the four HT kernels on case (b)'s codeblocks, HT destuffing and
MagSgn also by the device's own time there and on one of cell (e)'s
1024x1024 tiles (its 259 codeblocks, one launch), the two MQ kernels
on three launch shapes: case (c)'s 3,360 codeblocks, its tile 0 and case
(a)'s blocks, each with a round-trip check), then drives
grok_tpu_torch.compress / decompress with their defaults (the card) on
four cases:

  (a) BASELINE config 1: 512x512 8-bit gray, 6 resolutions, MQ coder;
  (b) a 3840x2160 8-bit RGB frame, lossless 5/3 + RCT, 6 resolutions,
      HT block coder, one tile: the main path at full size;
  (c) 2048x2048 8-bit RGB in 512x512 tiles, MQ coder (batched tiles);
  (d) BASELINE config 2: 2048x2048 8-bit RGB, lossy 9/7 + ICT, 5
      resolutions, layer_rates [20], MQ coder, one tile.

Each case must write the same bytes as the port's plain route (its twins,
device="cpu") and its host route (backend="native") in this process,
decode bit-exact, raise every launch counter of its path (case (b): one
launch of each level kernel a DWT level, one of each RCT kernel, one of
each HT kernel; cases (a) and (c): one MQ encode and one MQ decode launch
a tile) and send no tile down the host path; each case says how many
codeblocks each direction coded on the card and on the native coder.
Where a call's time goes is not split here: the port's `grk/` phase spans
(grok_tpu_torch/trace.py) split it under any torch.profiler, as the
benchmark's traced runs do.  Case (c)'s and (d)'s plain routes (the MQ twins on the CPU,
slow at this size) are compared on a first 512x512 part coded as an image
of its own; a multi-layer variant of (c) (layer_rates [40, 10, 1], the
distortion-tracking path) is held to the host route.  Case (d) is lossy:
instead of an exact decode it must meet its 20:1 rate, its round trip's
PSNR must be within 0.1 dB of the host route's, and the card's decode of
the host route's codestream within 1 of the host route's own decode.

A `mesh` phase then runs parallel/mesh.py on the card: every sharded
5/3 and 9/7 level (the 9/7 with and without case (d)'s steps) at sp 2, 4
and 8, at case (d)'s and case (b)'s level-1 shapes, bit for bit against
the level kernels on the whole tensors and against the plain sharded
route on a part; case (c) on dp 2 x sp 2, case (d) and a 2048x2048
lossless HT tile on sp 4, and case (b) on sp 2 (a height the mesh cannot
row-shard: one device) through compress and decompress, equal to this
process's single-device bytes and decodes with one level launch a shard
a level, their times beside one device's; the mesh's slots are the
visible cards in turn (cuda:0 repeated on a one-card machine), and with
two or more cards cases (c) and (d) run again over distinct cards, or a
line says the copies between cards were not run; then the dry run and
the refusal of an int mesh larger than the visible cards.

Then two phases drive the port's other entry points.  `cli`: BASELINE
config 1 through the command-line tools in process with their defaults
(the card): the 512x512 gray image as PGM through grk_compress and
grk_decompress (the codestream equal to compress on the card and on the
host route, the decode to the input, MQ blocks coded on the card, no tile
on the host path), case (c)'s image as PPM in 512x512 tiles with and
without --stream-strips (byte-identical files, then decoded through the
strip writer to the input), grk_dump, and --profile writing a trace that
names the port's kernels (run before the kernel checks, ahead of every
other profiler session).  `gigapixel`: BASELINE config 5 with
tests/test_gigapixel.py's settings (32768x32768 8-bit gray, HT, 6
resolutions, 1024x1024 tiles, TLM and PLT), in a process of its own
started before the kernel checks: the whole image made a strip at a time
and written by compress_strips_file, the mmapped file decoded a tile row
at a time with every strip exact (deferred synthesis on the card, no tile
on the host path) and through a 512x512 window across tile seams, with
its peak RSS under 6 GB and its peak card memory under 4 GB; after the
cli phase, a part of it (4096 x 8192) coded by compress_strips and
compress on the card and by the host route to one codestream, its
strip_height=300 decode equal to its whole decode.  No jax, no grok_tpu
and no Pillow module may load.
Every phase raises on failure.  The last two lines are one JSON object with
the kernels' launches, errors, times and bounds, and the ok line.  Exits
nonzero, printing neither, when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

SEED = 20261016
INT_MIN, INT_MAX = -(2 ** 31), 2 ** 31 - 1
UHD = (2160, 3840)
QUEUED = 16  # launches queued before one synchronize, for amortised times
GRAPH_REPLAYS = 4  # replays of a CUDA graph of QUEUED launches
# the card's peak rates (H100 SXM data sheet, at a 700 W power limit):
# device memory, and 32-bit operations outside the tensor cores (the float32
# rate; the integer lifting and colour sums run on the same lanes)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def run(cmd: list[str]) -> str:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"<{cmd[0]} unavailable: {e}>"
    return (proc.stdout or proc.stderr).strip()


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ inputs

def make_image(h=512, w=512, seed=0):
    """bench.py make_image: BASELINE config 1's 8-bit test content."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 20 * np.pi, w)
    arr = ((np.sin(x)[None, :] * np.linspace(-1, 1, h)[:, None] * 0.4 + 0.5)
           * 255 + rng.normal(0, 8, (h, w))).clip(0, 255).astype(np.uint8)
    return arr


def make_rgb(h, w, seed):
    """Three make_image planes of different phase and noise: photographic
    smoothness with sensor-like noise, 8 bits a sample."""
    return np.stack([make_image(h, w, seed + c)[:, ::(-1) ** c]
                     for c in range(3)], axis=-1)


def make_config2(h, w):
    """bench.py config2's content: BASELINE config 2's RGB (smooth colour
    fields and sensor-like noise), 8 bits a sample, made at h x w."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    rgb = np.stack([128 + 90 * np.sin(xx / 23) * np.cos(yy / 17),
                    128 + 80 * np.sin(xx / 15),
                    128 + 80 * np.cos(yy / 19)], -1)
    return (rgb + rng.normal(0, 3, rgb.shape)).clip(0, 255).astype(np.int32)


def tiles_c():
    """Case (c)'s image as 16 batched 512x512 tiles, (3, 16, 512, 512)
    int32, as the batched drivers hand them to the pipeline."""
    rgb = make_rgb(2048, 2048, SEED)
    return np.moveaxis(rgb.astype(np.int32), -1, 0).reshape(
        3, 4, 512, 4, 512).transpose(0, 1, 3, 2, 4).reshape(3, 16, 512, 512)


def randint(gen, shape, lo, hi):
    """int32 tensor on the card, uniform in [lo, hi)."""
    return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                         dtype=torch.int64).to(torch.int32)


def normal(gen, shape, scale):
    """float32 tensor on the card, normal with this standard deviation."""
    return torch.randn(shape, generator=gen, device="cuda") * scale


def extremes(gen, shape):
    """Full-range int32 salted with INT_MAX and INT_MIN, so the lifting
    and colour sums overflow and must wrap like int32."""
    t = randint(gen, shape, INT_MIN, INT_MAX + 1).reshape(-1)
    t[0::3] = INT_MAX
    t[1::3] = INT_MIN
    return t.reshape(shape)


# --------------------------------------------------------- kernel vs twin

def level_shapes(h, w, numres):
    """(H, W) of each forward level of an h x w tile."""
    out = []
    for _ in range(numres - 1):
        out.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    return out


def level_cases(gen):
    """(planes, H, W) inputs for the level checks: every level of case
    (b) and of case (c)'s 16 batched 512x512 tiles, the short and odd
    sizes, and int32 extremes."""
    cases = [randint(gen, (3, 1, h, w), -512, 512)
             for (h, w) in level_shapes(*UHD, 6)]
    cases += [randint(gen, (3, 16, h, w), -512, 512)
              for (h, w) in level_shapes(512, 512, 6)]
    sizes = (1, 2, 3, 37, 135, 257)
    cases += [randint(gen, (2, h, w), -5000, 5000)
              for h in sizes for w in sizes]
    cases += [extremes(gen, shape)
              for shape in ((3, 1, 37, 53), (2, 64, 67), (1, 135, 257),
                            (2, 1, 9), (2, 9, 1))]
    return cases


def check_levels(gen, dwt):
    err = {"fwd53_level": 0, "inv53_level": 0}
    for x in level_cases(gen):
        h, w = x.shape[-2:]
        bands = dwt.fwd_level(x)
        ref = dwt.fwd_level_plain(x)
        err["fwd53_level"] = max([err["fwd53_level"]] +
                                 [max_err(b, r) for b, r in zip(bands, ref)])
        # the inverse, from the forward bands and from arbitrary bands
        arb = [x.reshape(-1)[:b.numel()].reshape(b.shape).contiguous()
               for b in bands]
        for bs in (bands, arb):
            err["inv53_level"] = max(err["inv53_level"], max_err(
                dwt.inv_level(*bs, h, w), dwt.inv_level_plain(*bs, h, w)))
        if not torch.equal(dwt.inv_level(*bands, h, w), x):
            raise AssertionError(f"5/3 round trip differs at "
                                 f"{tuple(x.shape)}")
    return err


def check_rct(gen, mct):
    err = {"rct_forward_shift": 0, "rct_inverse_unshift": 0}
    shapes = [UHD, (1080, 1920), (37, 53), (1, 1), (1, 257)]
    for prec in (8, 12, 16):
        for sgnd in (False, True):
            lo = -(1 << (prec - 1)) if sgnd else 0
            for shape in shapes:
                rgb = [randint(gen, shape, lo, lo + (1 << prec))
                       for _ in range(3)]
                out = mct.rct_forward_shift(*rgb, prec, sgnd)
                ref = mct.rct_forward_shift_plain(*rgb, prec, sgnd)
                err["rct_forward_shift"] = max(err["rct_forward_shift"],
                                               max_err(out, ref))
                # inverse input wider than the range, so the clip engages
                ycc = [randint(gen, shape, -(1 << (prec + 1)),
                               1 << (prec + 1)) for _ in range(3)]
                out = mct.rct_inverse_unshift(*ycc, prec, sgnd)
                ref = mct.rct_inverse_unshift_plain(*ycc, prec, sgnd)
                err["rct_inverse_unshift"] = max(err["rct_inverse_unshift"],
                                                 max_err(out, ref))
    for shape in ((37, 53), (64, 67)):
        planes = [extremes(gen, shape) for _ in range(3)]
        for sgnd in (False, True):
            pairs = ((mct.rct_forward_shift, mct.rct_forward_shift_plain,
                      "rct_forward_shift"),
                     (mct.rct_inverse_unshift, mct.rct_inverse_unshift_plain,
                      "rct_inverse_unshift"))
            for fn, plain, name in pairs:
                err[name] = max(err[name], max_err(fn(*planes, 16, sgnd),
                                                   plain(*planes, 16, sgnd)))
    return err


# quantizer steps of a level's (ll, hl, lh, hh), of the size the codec
# gives 8-bit 9/7 bands; LL is quantized only at the coarsest level
STEPS_97 = (0.37, 0.61, 0.59, 1.13)
FLOAT_EXTREMES = (float("nan"), float("inf"), -float("inf"), 3e9, -3e9, 2.5,
                  3.5, -2.5, -0.5, 0.5, 2147483520.0, -2147483648.0, 1e-40,
                  -1e-40, 255.5, 127.49999)


def bit_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """max_err of two tensors on their bits: float32 compared as int32, so
    any differing bit counts."""
    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype:
        raise AssertionError(f"dtype {a.dtype} != {b.dtype}")
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return max_err(a, b)


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t that starts 4 bytes past an allocation."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return out[1:].view(t.shape).copy_(t)


def check_lossy(gen, dwt, mct):
    """The 9/7 level and ICT kernels against their twins (on the CPU),
    bit for bit: every level shape of case (d) (3 x 2048 x 2048 down to
    256 x 256), odd and short planes, widths of each residue mod 4 cut into
    segments of several chunks, misaligned tensors, with and without steps,
    the inverse from the forward's float and doubled-domain bands; the ICT
    kernels on 8-, 12- and 16-bit stacks, signed and unsigned, of 1, 3 and
    4 components with and without the ICT, with and without a step, on
    case (d)'s full stack, and on NaN, infinite, huge and tied inputs."""
    err = dict.fromkeys(("fwd97_level", "inv97_level", "ict_forward_shift",
                         "ict_inverse_unshift"), 0)
    sizes = (1, 2, 3, 37, 135, 257)
    cases = [normal(gen, (3, 1, h, w), 600.0)
             for (h, w) in level_shapes(2048, 2048, 5)]
    cases += [normal(gen, (2, h, w), 300.0) for h in sizes for w in sizes]
    # widths 0, 1, 2 and 3 mod 4 (the 16-byte and the 4-byte variants) on
    # planes the launch cuts into segments of two chunks, the last ragged;
    # and misaligned (contiguous) tensors, which take the 4-byte variant
    cases += [normal(gen, (4, 1030, w), 300.0)
              for w in (1028, 1029, 1030, 1031)]
    cases += [misaligned(normal(gen, (2, 130, 252), 300.0))]
    for x in cases:
        h, w = x.shape[-2:]
        for steps in (None, STEPS_97):
            bands = dwt.fwd_level(x, False, steps)
            want = dwt.fwd_level_plain(x.cpu(), False, steps)
            err["fwd97_level"] = max([err["fwd97_level"]] + [
                bit_err(b, r) for b, r in zip(bands, want)])
            if steps is not None:
                bands = [2 * b + torch.sign(b) for b in bands]
            if x.data_ptr() % 16:
                bands = [misaligned(b) for b in bands]
            err["inv97_level"] = max(err["inv97_level"], bit_err(
                dwt.inv_level(*bands, h, w, False, steps),
                dwt.inv_level_plain(*(b.cpu() for b in bands), h, w, False,
                                    steps)))
    stacks = []
    for prec in (8, 12, 16):
        for sgnd in (False, True):
            lo = -(1 << (prec - 1)) if sgnd else 0
            for c, m in ((1, 0), (3, 0), (3, 1), (4, 1)):
                stacks.append((randint(gen, (c, 1, 135, 257), lo,
                                       lo + (1 << prec)), m, prec, sgnd))
    stacks.append((randint(gen, (3, 1, 2048, 2048), 0, 256), 1, 8, False))
    for x, m, prec, sgnd in stacks:
        kw = dict(mct=m, prec=prec, sgnd=sgnd)
        for step in (0.0, 0.73):
            err["ict_forward_shift"] = max(err["ict_forward_shift"], bit_err(
                mct.ict_forward_shift(x, step=step, **kw),
                mct.ict_forward_shift_plain(x.cpu(), step=step, **kw)))
        for y, step in ((normal(gen, x.shape, float(1 << prec)), 0.0),
                        (randint(gen, x.shape, -(1 << prec), 1 << prec),
                         0.73)):
            err["ict_inverse_unshift"] = max(
                err["ict_inverse_unshift"], bit_err(
                    mct.ict_inverse_unshift(y, step=step, **kw),
                    mct.ict_inverse_unshift_plain(y.cpu(), step=step, **kw)))
    vals = torch.tensor(FLOAT_EXTREMES)
    x = vals.repeat(4, 1, 4, 1).contiguous()
    for prec, sgnd in ((8, False), (8, True), (16, False), (31, True)):
        for m in (0, 1):
            kw = dict(mct=m, prec=prec, sgnd=sgnd)
            err["ict_inverse_unshift"] = max(
                err["ict_inverse_unshift"], bit_err(
                    mct.ict_inverse_unshift(x.cuda(), **kw),
                    mct.ict_inverse_unshift_plain(x, **kw)))
    big = vals.reshape(1, 4, 4) * 1e30
    err["fwd97_level"] = max([err["fwd97_level"]] + [
        bit_err(b, r) for b, r in zip(dwt.fwd_level(big.cuda(), False,
                                                    STEPS_97),
                                      dwt.fwd_level_plain(big, False,
                                                          STEPS_97))])
    return err


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# ------------------------------------------------------------ HT Tier-1

def seg_err(a, b) -> int:
    """Largest difference between two encode results ([(segment, numbps)],
    [sum of squares]): bytes, numbps and sums; 256 for a length mismatch."""
    (sa, qa), (sb, qb) = a, b
    err = max([abs(x - y) for x, y in zip(qa, qb)] + [0])
    for (da, na), (db, nb) in zip(sa, sb):
        err = max(err, abs(na - nb))
        if len(da) != len(db):
            err = max(err, 256)
        elif da:
            err = max(err, int(np.abs(np.frombuffer(da, np.uint8).astype(
                int) - np.frombuffer(db, np.uint8)).max()))
    return err if len(sa) == len(sb) else max(err, 256)


def check_stages(ht_decode, items, err, dargs=None):
    """The first two decode launches against the twin on `items`:
    grk_ht_destuff's streams (bits and bit counts) and the batch's longest
    (error: differing bits and counts), grk_ht_decode's rho and umax of
    every quad (error: largest difference)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    if dargs is None:
        outs = [torch.empty((h, w), dtype=torch.int32, device=dev)
                for _, h, w in items]
        dargs = ht_decode.decode_args(items, dev, outs)
    ht_decode.launch_destuff(dargs, dev)
    ht_decode.launch_chains(dargs, dev)
    desc, data, scratch, streams, longest, rho, umax = dargs[:7]
    words = scratch.cpu().numpy().view(np.uint32).byteswap()
    got_bits = np.unpackbits(words.view(np.uint8))
    got = streams.cpu().numpy().reshape(-1, 2)
    d = desc.cpu()
    data = data.cpu()
    bits, starts, nbits = ht_decode.destuff_streams(
        data, *ht_decode.split_segments(data, d[:, 4], d[:, 5]))
    bits, starts, nbits = bits.numpy(), starts.numpy(), nbits.numpy()
    bad = int((got[:, 1] != nbits).sum())
    bad += abs(int(longest.item()) - int(nbits.max(initial=0)))
    for (off, n), s0 in zip(got.tolist(), starts.tolist()):
        bad += int((got_bits[32 * off:32 * off + n]
                    != bits[s0:s0 + n]).sum())
    err["ht_destuff"] = max(err["ht_destuff"], bad)
    rho_q, umax_q = ht_decode.quad_chains_plain(items)
    rho, umax = rho.cpu().to(torch.int64), umax.cpu().to(torch.int64)
    for i, (off, (_, h, w)) in enumerate(zip(d[:, 7].tolist(), items)):
        nq = (h // 2) * (w // 2)
        err["ht_decode"] = max(err["ht_decode"], max_err(
            rho[off:off + nq], rho_q[i, :nq]), max_err(
            umax[off:off + nq], umax_q[i, :nq]))


def check_ht_pair(ht_encode, ht_decode, blocks, items, err):
    """Kernel against twin on numpy blocks (encode) and on their segments
    plus `items` (decode); the twins on the CPU."""
    cpu = [torch.from_numpy(np.ascontiguousarray(b)) for b in blocks]
    ref = ht_encode.encode_cblks_ht_plain(cpu)
    err["ht_encode"] = max(err["ht_encode"], seg_err(
        ht_encode.encode_cblks_ht([b.cuda() for b in cpu]), ref))
    items = [(s, *b.shape) for (s, _), b in zip(ref[0], blocks)] + items
    got = ht_decode.decode_cblks_ht(items, "cuda")
    want = ht_decode.decode_cblks_ht_plain(items, "cpu")
    err["ht_magsgn"] = max([err["ht_magsgn"]] + [
        max_err(g.cpu(), w) for g, w in zip(got, want)])
    check_stages(ht_decode, items, err)
    return ref


def check_ht(ht_encode, ht_decode, ht_tables, cases):
    """The HT kernels against their twins on tests/torch_ht_cases.py's
    inputs: the encode shapes at densities 0.05-0.95 and magnitudes up to
    2^25 - 1, a 0xFF-dense block, mixed shapes in one batch, corrupt and
    truncated streams, the three table swaps; and numbps above 25
    (INT32_MIN too) refused."""
    rng = np.random.default_rng(SEED)
    err = {"ht_encode": 0, "ht_destuff": 0, "ht_decode": 0, "ht_magsgn": 0}
    blocks = [b for shape in cases.ENC_SHAPES + cases.DEC_SHAPES
              for b in cases.blocks(rng, *shape, n=8)]
    blocks += list(cases.dense_ff())
    ref = check_ht_pair(ht_encode, ht_decode, blocks, [], err)
    items = [(s, *b.shape) for (s, _), b in zip(ref[0], blocks)]
    check_ht_pair(ht_encode, ht_decode, [], cases.corrupt(rng, items[:40]),
                  err)
    for tables in cases.table_swaps().values():
        try:
            ht_tables.set_tables(*tables)
            sw = list(cases.blocks(rng, 16, 16, 6, mag=900))
            ref = check_ht_pair(ht_encode, ht_decode, sw, [], err)
            check_ht_pair(ht_encode, ht_decode, [], cases.corrupt(
                rng, [(s, 16, 16) for s, _ in ref[0]], n=8), err)
        finally:
            ht_tables.reset_tables()
    for v in (1 << 25, INT_MIN):
        block = torch.zeros((8, 8), dtype=torch.int32, device="cuda")
        block[3, 4] = v
        try:
            ht_encode.encode_cblks_ht([block])
        except ValueError:
            continue
        raise AssertionError(f"ht_encode took a magnitude of {v}")
    return err


def ht_population(arr, pipeline):
    """An image's device-coded HT codeblocks: its bands from the device
    analysis (6 resolutions, lossless, RCT for RGB), cut into the codec's
    64x64 grid, even-sized blocks only; one HT launch's blocks each way:
    case (b)'s frame, or one of cell (e)'s tiles."""
    a = arr.astype(np.int32)
    x = torch.from_numpy(np.ascontiguousarray(
        a[None, None] if a.ndim == 2 else np.moveaxis(a, -1, 0)[:, None]
    )).cuda()
    bands = pipeline.analysis(x, numres=6, reversible=True,
                              mct=int(a.ndim == 3), prec=8, sgnd=False)
    blocks = []
    for v in bands.values():
        for c in range(v.shape[0]):
            band = v[c, 0]
            h, w = band.shape
            for y in range(0, h, 64):
                for x0 in range(0, w, 64):
                    b = band[y:y + 64, x0:x0 + 64]
                    if b.shape[0] % 2 == 0 and b.shape[1] % 2 == 0:
                        blocks.append(b)
    return blocks


def time_once(fn) -> float:
    """Host-clock ms of one call of a long run (the twins), synchronized."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t)


def time_ht(blocks, tile_blocks, ht_encode, ht_decode, err):
    """The HT kernels and their twins on case (b)'s codeblock population:
    each kernel per launch and amortised, the wrapper with its copies and
    host work, the twin once on the card's tensors; bounds from the bytes
    of the work (encode: 4 B a coefficient in, the segment bytes out;
    destuff: the segment bytes in; decode: 4 B a sample out; scratch not
    counted); then time_ht_shape on the population and on `tile_blocks`
    (one of cell (e)'s tiles), whose CUDA-graph times are destuff's and
    MagSgn's ms.  Returns {name: (ms, plain_ms, bound_ms, bound_by)}."""
    dev = torch.device("cuda", torch.cuda.current_device())
    cpu = [b.cpu() for b in blocks]
    samples = sum(b.numel() for b in blocks)
    args = ht_encode.encode_args(blocks, dev)
    k_enc = time_ms(lambda: ht_encode.launch_encode(args, dev))
    seg_bytes = int(args[2].item())
    w_enc = time_once(lambda: ht_encode.encode_cblks_ht(blocks))
    segs = ht_encode.encode_cblks_ht(blocks)
    p_enc = time_once(lambda: ht_encode.encode_cblks_ht_plain(blocks))
    err["ht_encode"] = max(err["ht_encode"], seg_err(
        segs, ht_encode.encode_cblks_ht_plain(cpu)))
    items = [(s, *b.shape) for (s, _), b in zip(segs[0], blocks)]
    outs = [torch.empty(b.shape, dtype=torch.int32, device=dev)
            for b in blocks]
    dargs = ht_decode.decode_args(items, dev, outs)
    k_des = time_ms(lambda: ht_decode.launch_destuff(dargs, dev))
    k_dec = time_ms(lambda: ht_decode.launch_chains(dargs, dev))
    k_mag = time_ms(lambda: ht_decode.launch_magsgn(dargs, dev))
    k_all = time_ms(lambda: ht_decode.launch_decode(dargs, dev))
    w_dec = time_once(lambda: ht_decode.decode_cblks_ht(items, dev))
    p_dec = time_once(lambda: ht_decode.decode_cblks_ht_plain(items, dev))
    # (time_ht_shape below holds the decode to the twin, stage by stage)
    # destuffed bytes of the MagSgn streams, and of the MEL and VLC ones
    bits = dargs[3].cpu().numpy()[:, 1::2]
    ms_bytes = int(((bits[:, 0] + 7) // 8).sum())
    suffix_bytes = int(((bits[:, 1:] + 7) // 8).sum())
    quads = samples // 4
    log(f"time ht_destuff+decode+magsgn  the three launches: "
        f"{k_all[0]:.4f} ms per launch triple, {k_all[1]:.4f} ms amortised; "
        f"bound {1e3 * (seg_bytes + 4 * samples) / PEAK_BYTES_S:.4f} ms "
        f"(bytes: the segments in, 4 B a sample out)")
    times = {}
    # each launch's bytes: its inputs read once, its outputs written once
    for name, (k_single, k_amort), wrapper, plain, nbytes in (
            ("ht_encode", k_enc, w_enc, p_enc, 4 * samples + seg_bytes),
            ("ht_destuff", k_des, w_dec, p_dec,
             seg_bytes + ms_bytes + suffix_bytes),
            ("ht_decode", k_dec, w_dec, p_dec, suffix_bytes + 5 * quads),
            ("ht_magsgn", k_mag, w_dec, p_dec,
             ms_bytes + 5 * quads + 4 * samples)):
        bound = 1e3 * nbytes / PEAK_BYTES_S
        log(f"time {name:24s} {len(blocks)} codeblocks, {samples} samples, "
            f"{seg_bytes} segment B, bound on {nbytes} B: kernel "
            f"{k_single:.4f} ms per launch, {k_amort:.4f} ms amortised; "
            f"wrapper (copies, descriptors, slicing) {wrapper:.1f} ms; twin "
            f"on the card {plain:.1f} ms; bound {bound:.4f} ms (bytes)")
        times[name] = (k_amort, plain, bound, "bytes")
    # destuffing and MagSgn also by the device's own time, on case (b)'s
    # launch and on one of cell (e)'s tiles
    for name, (graph, *_) in time_ht_shape(
            "case (b)", blocks, ht_encode, ht_decode, err).items():
        times[name] = (graph,) + times[name][1:]
    time_ht_shape("cell (e) tile", tile_blocks, ht_encode, ht_decode, err)
    return times


def giga_tile_blocks(pipeline):
    """The HT codeblocks of cell (e)'s first 1024x1024 tile, as its codec
    launches them (one launch a tile each way)."""
    return ht_population(giga_content(0, GIGA_TILE, n=GIGA_TILE), pipeline)


def time_ht_shape(label, blocks, ht_encode, ht_decode, err) -> dict:
    """The three HT decode launches on one launch shape: the blocks coded
    by the card, decoded, and held to the twin (stages and samples); then
    for grk_ht_destuff and grk_ht_magsgn (and grk_ht_decode, for context)
    the device's own time (device_ms: torch.profiler's kernel records and
    a CUDA graph of QUEUED launches) beside the CUDA-event times (time_ms:
    per launch and amortised), each against its bound from this launch's
    bytes (destuff: the segments in, the destuffed streams out; chains:
    the suffix streams in, 5 B a quad out; MagSgn: the MagSgn streams and
    5 B a quad in, 4 B a sample out).  Returns {name: (graph ms, per-launch
    ms, amortised ms, bound ms)}."""
    from grok_tpu_torch.kernels import launch

    dev = torch.device("cuda", torch.cuda.current_device())
    segs = ht_encode.encode_cblks_ht(blocks)
    items = [(seg, *b.shape) for (seg, _), b in zip(segs[0], blocks)]
    outs = [torch.empty(b.shape, dtype=torch.int32, device=dev)
            for b in blocks]
    dargs = ht_decode.decode_args(items, dev, outs)
    ht_decode.launch_decode(dargs, dev)
    want = ht_decode.decode_cblks_ht_plain(items, "cpu")
    check_stages(ht_decode, items, err, dargs)
    n = len(items)
    samples = sum(b.numel() for b in blocks)
    seg_bytes = sum(len(seg) for seg, _, _ in items)
    bits = dargs[3].cpu().numpy()[:, 1::2]
    ms_bytes = int(((bits[:, 0] + 7) // 8).sum())
    suffix_bytes = int(((bits[:, 1:] + 7) // 8).sum())
    quads = samples // 4

    def destuff():  # longest already holds the batch's: atomicMax keeps it
        launch("ht_destuff", "grk_ht_destuff", dev, dargs[:5], (n,))

    result = {}
    for name, fn, kernel, nbytes in (
            ("ht_destuff", destuff, "ht_destuff_kernel",
             seg_bytes + ms_bytes + suffix_bytes),
            ("ht_decode", lambda: ht_decode.launch_chains(dargs, dev),
             "ht_decode_kernel", suffix_bytes + 5 * quads),
            ("ht_magsgn", lambda: ht_decode.launch_magsgn(dargs, dev),
             "ht_magsgn_kernel", ms_bytes + 5 * quads + 4 * samples)):
        single, amort = time_ms(fn)
        prof, graph = device_ms(fn, kernel)
        bound = 1e3 * nbytes / PEAK_BYTES_S
        log(f"time {name} device {label}: {n} codeblocks, {samples} "
            f"samples, {seg_bytes} segment B: {fmt_ms(prof)} ms a launch "
            f"(profiler), {graph:.4f} ms a launch in a CUDA graph of "
            f"{QUEUED} ({bound / graph:.0%} of the bound); {single:.4f} ms "
            f"per launch, {amort:.4f} ms amortised (CUDA events); bound "
            f"{bound:.4f} ms on {nbytes} B (bytes)")
        result[name] = (graph, single, amort, bound)
    err["ht_magsgn"] = max([err["ht_magsgn"]] + [
        max_err(o.cpu(), w) for o, w in zip(outs, want)])
    return result


def ht_times_only(tree: str) -> int:
    """`chip_smoke.py --ht-times TREE`: only the HT decode kernels, from
    the grok_tpu_torch of the checkout at TREE (for A/B runs against
    another tree unpacked beside this one): ptxas's lines, the HT kernels
    against their twins on tests/torch_ht_cases.py's inputs (check_ht),
    and time_ht_shape on case (b)'s launch and one of cell (e)'s tiles,
    each held to the twin."""
    sys.path.insert(0, os.path.abspath(tree))
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import grok_tpu_torch
    import torch_ht_cases
    from grok_tpu_torch.kernels import build
    from grok_tpu_torch.ops import ht_decode, ht_encode, pipeline
    from grok_tpu_torch.t1 import ht_tables

    log(f"tree {tree}: grok_tpu_torch from "
        f"{os.path.dirname(os.path.abspath(grok_tpu_torch.__file__))}")
    log(run(["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]).splitlines()[0])
    report = build.build()
    build.load()
    for name, lines in ptxas_lines(report, HT_DECODE_KERNELS).items():
        log(f"ptxas {name}: {'; '.join(lines)}")
    err = check_ht(ht_encode, ht_decode, ht_tables, torch_ht_cases)
    for label, blocks in (
            ("case (b)", ht_population(make_rgb(*UHD, seed=SEED), pipeline)),
            ("cell (e) tile", giga_tile_blocks(pipeline))):
        time_ht_shape(label, blocks, ht_encode, ht_decode, err)
    log(f"HT kernels vs twin max abs err: {err}")
    if any(err.values()):
        raise AssertionError(f"the HT kernels disagree with the twins: "
                             f"{err}")
    return 0



# ------------------------------------------------------------ MQ Tier-1

def mq_err(a, b) -> int:
    """Largest difference between two MQ encode results: codeword bytes
    (256 for a length mismatch), numbps, rates, terminations, distortions
    and e0."""
    err = 0 if len(a.data) == len(b.data) else 256
    for x, y in zip(a.data, b.data):
        if len(x) != len(y):
            err = max(err, 256)
        elif x:
            err = max(err, int(np.abs(np.frombuffer(x, np.uint8).astype(
                int) - np.frombuffer(y, np.uint8)).max()))
    for f in ("numbps", "rates", "terms", "dists", "e0"):
        u, v = getattr(a, f), getattr(b, f)
        if u.shape != v.shape:
            err = max(err, 256)
        elif u.size:
            err = max(err, int(np.abs(u.astype(np.float64)
                                      - v.astype(np.float64)).max()))
    return err


def mq_items(enc, shapes, orients, lazy):
    """Decode items of every pass of an MQ encode result."""
    from grok_tpu_torch.params import CblkStyle

    items = []
    for k, ((h, w), o, lz) in enumerate(zip(shapes, orients, lazy)):
        n = enc.num_passes(k)
        seg, last = [], 0
        for i in range(n):
            if enc.terms[k, i] or i == n - 1:
                seg.append(int(enc.rates[k, i]) - last)
                last = int(enc.rates[k, i])
        items.append((enc.data[k], seg, n, int(enc.numbps[k]), h, w, o,
                      CblkStyle.LAZY if lz else CblkStyle.NONE))
    return items


def check_mq_pair(mq_encode, mq_decode, blocks, orients, lazy, dist, items,
                  err):
    """Kernel against twin: the encode of `blocks` (tensors on the card,
    the twin on CPU copies), then the decode of their codewords and of
    `items`; returns the kernel's encode result."""
    enc = ref = None
    if blocks:
        enc = mq_encode.encode_cblks_mq(blocks, orients, lazy, dist)
        ref = mq_encode.encode_cblks_mq_plain([b.cpu() for b in blocks],
                                              orients, lazy, dist)
        err["mq_encode"] = max(err["mq_encode"], mq_err(enc, ref))
        n = len(blocks)
        lz = lazy if isinstance(lazy, list) else [lazy] * n
        items = mq_items(enc, [tuple(b.shape) for b in blocks],
                         orients if isinstance(orients, list)
                         else [orients] * n, lz) + items
    if items:
        got = mq_decode.decode_cblks_mq(items, "cuda")
        want = mq_decode.decode_cblks_mq_plain(items, "cpu")
        err["mq_decode"] = max([err["mq_decode"]] + [
            max_err(g.cpu(), w) for g, w in zip(got, want)])
    return enc


def band_blocks(bands, size=64):
    """The codeblocks of (C, B, h, w) band tensors on a size x size grid,
    as views, with their orients: every block of component c of tile b,
    tile by tile."""
    blocks, orients = [], []
    first = next(iter(bands.values()))
    for b in range(first.shape[1]):
        for c in range(first.shape[0]):
            for (_, orient), v in bands.items():
                band = v[c, b]
                h, w = band.shape
                for y in range(0, h, size):
                    for x0 in range(0, w, size):
                        blocks.append(band[y:y + size, x0:x0 + size])
                        orients.append(orient)
    return blocks, orients


def check_mq(mq_encode, mq_decode, cases, blocks_a, orients_a):
    """The MQ kernels against their twins on tests/torch_mq_cases.py's
    inputs (grok_tpu's test shapes and styles, all-zero blocks, magnitudes
    up to 2^20; distortion-tracked blocks; the widest legal shapes, 4x1024,
    1024x4, 8x512 and 512x8, with 64x64 blocks in one launch, each style
    with and without distortions; mixed shapes, styles and flags in one
    launch; pass-capped, corrupt and truncated streams) and
    on case (a)'s 70 codeblocks; numbps above the limits refused."""
    rng = np.random.default_rng(SEED)
    err = {"mq_encode": 0, "mq_decode": 0}
    cuda = (lambda bl: [torch.from_numpy(np.ascontiguousarray(b)).cuda()
                        for b in bl])
    for case in cases.ENC_CASES:
        for style in cases.STYLES:
            bl = cases.enc_blocks(rng, *case)
            check_mq_pair(mq_encode, mq_decode, cuda(bl),
                          rng.integers(0, 4, len(bl)).tolist(),
                          int(style != cases.STYLES[0]), 0, [], err)
    for lazy in (0, 1):
        check_mq_pair(mq_encode, mq_decode, cuda(cases.dist_blocks(rng)), 0,
                      lazy, 1, [], err)
        for dist in (0, 1):
            ext = cases.extreme_blocks(rng)
            check_mq_pair(mq_encode, mq_decode, cuda(ext),
                          rng.integers(0, 4, len(ext)).tolist(), lazy, dist,
                          [], err)
    mixed = cases.mixed_blocks(rng)
    n = len(mixed)
    check_mq_pair(mq_encode, mq_decode, cuda(mixed),
                  rng.integers(0, 4, n).tolist(),
                  rng.integers(0, 2, n).tolist(),
                  [int(np.abs(b).max(initial=0) < (1 << 20)) for b in mixed],
                  [], err)
    items = cases.dec_items(rng, mixed, [cases.STYLES[k % 2]
                                         for k in range(n)])
    check_mq_pair(mq_encode, mq_decode, [], 0, 0, 0,
                  items + cases.corrupt_items(rng, items), err)
    check_mq_pair(mq_encode, mq_decode, blocks_a, orients_a, 1, 0, [], err)
    for v, dist in ((1 << 26, 0), (1 << 20, 1), (INT_MIN, 0)):
        block = torch.zeros((8, 8), dtype=torch.int32, device="cuda")
        block[3, 4] = v
        try:
            mq_encode.encode_cblks_mq([block], 0, 0, dist)
        except ValueError:
            continue
        raise AssertionError(f"mq_encode took a magnitude of {v}")
    return err


def mq_card_items(items):
    """The indices of the decode items the decode router sends to the
    card, by the placement rule (t1/backend.py on_card)."""
    from grok_tpu_torch.t1.backend import on_card

    h, w, style, nb = np.array([(it[4], it[5], int(it[7]), it[3])
                                for it in items], np.int64).reshape(-1, 4).T
    return np.flatnonzero(on_card(False, h, w, style, nb,
                                  decode=True)).tolist()


def time_mq_shape(label, blocks, orients, mq_encode, mq_decode):
    """Both MQ kernels on one launch shape (style LAZY, as the codec codes
    it; decode: the blocks the decode router sends to the card), each per
    launch and amortised, with the longest chain of decisions (counted by
    the encode kernel) and the time a decision of it; bounds from the bytes
    (encode: 4 B a coefficient in, the codewords out; decode: the codewords
    in, 4 B a sample out); the decode must give the blocks back in the
    doubled domain.  Returns ({name: (amortised ms, bound ms)}, the encode
    result, the decode items, the decode outputs)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    n = len(blocks)
    args = mq_encode.encode_args(blocks, orients, [1] * n, [0] * n,
                                 [26] * n, dev)
    k_enc = time_ms(lambda: mq_encode.launch_encode(args, dev))
    enc = mq_encode.finish_encode(args)
    chains = args[4][:, 5].cpu().numpy()
    items = mq_items(enc, [tuple(b.shape) for b in blocks], orients,
                     [1] * n)
    keep = mq_card_items(items)
    items = [items[k] for k in keep]
    outs = [torch.empty((it[4], it[5]), dtype=torch.int32, device=dev)
            for it in items]
    dargs = mq_decode.decode_args(items, dev, outs)
    k_dec = time_ms(lambda: mq_decode.launch_decode(dargs, dev))
    # every pass decoded: the blocks come back in the doubled domain
    for k, o in zip(keep, outs):
        b = blocks[k].to(torch.int64)
        if not torch.equal(o.to(torch.int64), torch.where(
                b != 0, b.sign() * (2 * b.abs() + 1), 0)):
            raise AssertionError(f"MQ round trip differs, {label}, block "
                                 f"{k}")
    times = {}
    for name, (k_single, k_amort), sel in (("mq_encode", k_enc,
                                            list(range(n))),
                                           ("mq_decode", k_dec, keep)):
        samples = sum(blocks[k].numel() for k in sel)
        code_bytes = sum(len(enc.data[k]) for k in sel)
        longest = int(chains[sel].max())
        nbytes = 4 * samples + code_bytes
        bound = 1e3 * nbytes / PEAK_BYTES_S
        log(f"time {name} {label}: {len(sel)} codeblocks, {samples} "
            f"samples, {code_bytes} codeword B; kernel {k_single:.4f} ms "
            f"per launch, {k_amort:.4f} ms amortised; longest chain "
            f"{longest} decisions ({int(chains[sel].mean())} on average), "
            f"{1e6 * k_single / longest:.1f} ns a decision of it per "
            f"launch, {1e6 * k_amort / longest:.1f} amortised; bound "
            f"{bound:.4f} ms on {nbytes} B (bytes)")
        times[name] = (k_amort, bound)
    return times, enc, items, outs


def mq_launch_shapes(bands_c, bands_a):
    """The three launch shapes of the MQ kernels: case (c)'s 3,360
    codeblocks in one launch, its tile 0 (210 blocks, the launch the codec
    makes), and case (a)'s 70 blocks (the main path's one launch)."""
    blocks_c, orients_c = band_blocks(bands_c)
    blocks_a, orients_a = band_blocks(bands_a)
    return (("case (c) population", blocks_c, orients_c),
            ("case (c) tile 0", blocks_c[:210], orients_c[:210]),
            ("case (a)", blocks_a, orients_a))


def time_mq(shapes, mq_encode, mq_decode, err):
    """The MQ kernels on the three launch shapes, the wrappers with their
    copies and host work on the population, and the twins on the card on
    tile 0 (their time is set by the longest chain of decisions, not by the
    count of blocks), held to the kernels' results there.  Returns {name:
    (ms, plain_ms, bound_ms, bound_by)} on the population."""
    dev = torch.device("cuda", torch.cuda.current_device())
    results = [time_mq_shape(label, b, o, mq_encode, mq_decode)
               for label, b, o in shapes]
    (_, blocks, orients), (_, tile, tile_or) = shapes[:2]
    w_enc = time_once(lambda: mq_encode.encode_cblks_mq(blocks, orients, 1))
    items = mq_items(mq_encode.encode_cblks_mq(blocks, orients, 1),
                     [tuple(b.shape) for b in blocks], orients,
                     [1] * len(blocks))
    w_dec = time_once(lambda: mq_decode.decode_cblks_mq(items, dev))
    _, enc, items, outs = results[1]
    p_enc = time_once(lambda: mq_encode.encode_cblks_mq_plain(tile, tile_or,
                                                              1))
    err["mq_encode"] = max(err["mq_encode"], mq_err(
        enc, mq_encode.encode_cblks_mq_plain(tile, tile_or, 1)))
    p_dec = time_once(lambda: mq_decode.decode_cblks_mq_plain(items, dev))
    want = mq_decode.decode_cblks_mq_plain(items, dev)
    err["mq_decode"] = max([err["mq_decode"]] + [
        max_err(o, w) for o, w in zip(outs, want)])
    log(f"time mq wrappers and twins: encode_cblks_mq (copies, descriptors, "
        f"slicing) {w_enc:.1f} ms and decode_cblks_mq {w_dec:.1f} ms on "
        f"the population; the twins on the card on tile 0: encode "
        f"{p_enc:.1f} ms, decode {p_dec:.1f} ms; no single PyTorch call")
    pop = results[0][0]
    return {name: (pop[name][0], plain, pop[name][1], "bytes")
            for name, plain in (("mq_encode", p_enc), ("mq_decode", p_dec))}


HT_DECODE_KERNELS = ("ht_destuff_kernel", "ht_magsgn_kernel")


def ptxas_lines(report: str, kernels) -> dict:
    """ptxas's stack, spill, register and shared memory lines of each
    kernel whose mangled name holds one of `kernels`."""
    out: dict = {}
    cur = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            cur = next((k for k in kernels if k in line), None)
            if cur and "ILb1E" in line:  # a template's <true> variant
                cur += "<true>"
            elif cur and "ILb0E" in line:
                cur += "<false>"
        elif cur and ("stack frame" in line or "registers" in line):
            out.setdefault(cur, []).append(
                line.replace("ptxas info    :", "").strip())
    return out


def mq_times_only(tree: str) -> int:
    """`chip_smoke.py --mq-times TREE`: only the MQ kernels' times on the
    three launch shapes, from the grok_tpu_torch of the checkout at TREE
    (for A/B runs against another tree unpacked beside this one)."""
    sys.path.insert(0, os.path.abspath(tree))
    import grok_tpu_torch
    from grok_tpu_torch.kernels import build
    from grok_tpu_torch.ops import mq_decode, mq_encode, pipeline

    log(f"tree {tree}: grok_tpu_torch from "
        f"{os.path.dirname(os.path.abspath(grok_tpu_torch.__file__))}")
    log(run(["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]).splitlines()[0])
    report = build.build()
    build.load()
    for name, lines in ptxas_lines(report, ("mq_encode_kernel",
                                            "mq_decode_kernel")).items():
        log(f"ptxas {name}: {'; '.join(lines)}")
    bands = [pipeline.analysis(torch.from_numpy(np.ascontiguousarray(
        x)).cuda(), numres=6, reversible=True, mct=m, prec=8, sgnd=False)
        for x, m in ((tiles_c(), 1),
                     (make_image().astype(np.int32)[None, None], 0))]
    for label, blocks, orients in mq_launch_shapes(*bands):
        time_mq_shape(label, blocks, orients, mq_encode, mq_decode)
    return 0


def time_ms(fn) -> tuple[float, float]:
    """(per-launch ms: median of single launches each synchronized,
    amortised ms: QUEUED launches then one synchronize), CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    single = []
    for _ in range(5):
        start.record()
        fn()
        end.record()
        end.synchronize()
        single.append(start.elapsed_time(end))
    start.record()
    for _ in range(QUEUED):
        fn()
    end.record()
    end.synchronize()
    return statistics.median(single), start.elapsed_time(end) / QUEUED


def device_ms(fn, kernel: str) -> tuple[float | None, float]:
    """The device's own time of the launches `fn` makes of the kernel whose
    name holds `kernel`: (the median ms of one launch in torch.profiler's
    CUDA kernel records, None where it records none; the ms a call when a
    CUDA graph of QUEUED calls is replayed GRAPH_REPLAYS times, CUDA
    events), so that no host work around the launches counts."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(QUEUED):
            fn()
        torch.cuda.synchronize()
    runs = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if kernel in e.name]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capturing stream, as torch.cuda.graph asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(QUEUED):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return (statistics.median(runs) if runs else None,
            start.elapsed_time(end) / (GRAPH_REPLAYS * QUEUED))


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def dwt97_levels(gen, dwt):
    """Case (d)'s four 9/7 levels as the codec calls the kernels: (h, w,
    input, steps, the inverse's bands); the high bands quantized (the
    inverse's doubled), LL only at the coarsest level."""
    shapes = level_shapes(2048, 2048, 5)
    out = []
    for i, (h, w) in enumerate(shapes):
        x = normal(gen, (3, 1, h, w), 600.0)
        steps = ((STEPS_97[0] if i == len(shapes) - 1 else 0.0,)
                 + STEPS_97[1:])
        bands = dwt.fwd_level(x, False, steps)
        out.append((h, w, x, steps,
                    [2 * b + torch.sign(b) if s > 0 else b
                     for b, s in zip(bands, steps)]))
    return out


def time_dwt97(gen, dwt) -> dict:
    """The 9/7 level kernels at case (d)'s four level shapes: the device's
    own time (device_ms) beside the wrapper's CUDA-event times (time_ms,
    per launch and amortised), each against its bound (8 B a sample over
    the memory rate), and the sums over the codec's four launches a
    direction.  Returns {name: (level-1 ms, the four launches' ms)}, the
    device's times in a CUDA graph."""
    levels = dwt97_levels(gen, dwt)
    result = {}
    for name in ("fwd97_level", "inv97_level"):
        total = dict.fromkeys(("prof", "graph", "single", "amort", "bound",
                               "bytes"), 0.0)
        first = None
        for h, w, x, steps, dbl in levels:
            if name == "fwd97_level":
                def fn(x=x, steps=steps):
                    dwt.fwd_level(x, False, steps)
            else:
                def fn(dbl=dbl, h=h, w=w, steps=steps):
                    dwt.inv_level(*dbl, h, w, False, steps)
            single, amort = time_ms(fn)
            prof, graph = device_ms(fn, f"{name}_kernel")
            nbytes = 8 * x.numel()
            bound = 1e3 * nbytes / PEAK_BYTES_S
            log(f"time {name} device {tuple(x.shape)}: {fmt_ms(prof)} ms a "
                f"launch (profiler), {graph:.4f} ms a launch in a CUDA graph "
                f"of {QUEUED} ({bound / graph:.0%} of the bound); wrapper "
                f"{single:.4f} ms per launch, {amort:.4f} ms amortised "
                f"(CUDA events); bound {bound:.4f} ms (bytes)")
            for key, v in (("prof", prof), ("graph", graph),
                           ("single", single), ("amort", amort),
                           ("bound", bound), ("bytes", nbytes)):
                total[key] = None if v is None or total[key] is None \
                    else total[key] + v
            first = first or graph
        log(f"time {name} device, case (d)'s four launches: "
            f"{fmt_ms(total['prof'])} ms (profiler), {total['graph']:.4f} "
            f"ms (CUDA graph); wrapper {total['single']:.4f} ms per launch, "
            f"{total['amort']:.4f} amortised; bound {total['bound']:.4f} ms "
            f"on {total['bytes'] / 1e6:.1f} MB")
        result[name] = (first, total["graph"])
    return result


def dwt97_times_only(tree: str) -> int:
    """`chip_smoke.py --dwt97-times TREE`: only the 9/7 level kernels, from
    the grok_tpu_torch of the checkout at TREE (for A/B runs against
    another tree unpacked beside this one): ptxas's lines, a bit-for-bit
    check against the twin at level 1, and time_dwt97."""
    sys.path.insert(0, os.path.abspath(tree))
    import grok_tpu_torch
    from grok_tpu_torch.kernels import build
    from grok_tpu_torch.ops import dwt

    log(f"tree {tree}: grok_tpu_torch from "
        f"{os.path.dirname(os.path.abspath(grok_tpu_torch.__file__))}")
    log(run(["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]).splitlines()[0])
    report = build.build()
    build.load()
    for name, lines in ptxas_lines(report, ("fwd97_level_kernel",
                                            "inv97_level_kernel")).items():
        log(f"ptxas {name}: {'; '.join(lines)}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    h, w, x, steps, dbl = dwt97_levels(gen, dwt)[0]
    err = max([bit_err(b, r) for b, r in zip(
        dwt.fwd_level(x, False, steps),
        dwt.fwd_level_plain(x.cpu(), False, steps))] + [bit_err(
            dwt.inv_level(*dbl, h, w, False, steps),
            dwt.inv_level_plain(*(b.cpu() for b in dbl), h, w, False,
                                steps))])
    log(f"9/7 levels vs twin at {tuple(x.shape)}: max abs err {err}")
    if err:
        raise AssertionError("the 9/7 level kernels disagree with the twins")
    time_dwt97(gen, dwt)
    return 0


def time_kernels(gen, dwt, mct):
    """Kernel and twin at case (b)'s level-1 shapes, in turns (twin,
    kernel, kernel, twin); returns {name: (ms, plain_ms, bound_ms,
    bound_by)}, times amortised."""
    h, w = UHD
    x = randint(gen, (3, 1, h, w), -512, 512)
    bands = dwt.fwd_level(x)
    rgb = [randint(gen, UHD, 0, 256) for _ in range(3)]
    ycc = [randint(gen, UHD, -255, 256) for _ in range(3)]
    samples = x.numel()
    # (kernel, twin, samples, integer operations a sample): a level does,
    # on each axis and for each pair of samples, a predict (add, shift,
    # subtract) and an update (add, add, shift, add): 7 a sample for both
    # axes; the forward RCT with its DC shift about 3 a sample, the
    # inverse with its unshift and clip about 5
    runs = {
        "fwd53_level": (lambda: dwt.fwd_level(x),
                        lambda: dwt.fwd_level_plain(x), samples, 7),
        "inv53_level": (lambda: dwt.inv_level(*bands, h, w),
                        lambda: dwt.inv_level_plain(*bands, h, w),
                        samples, 7),
        "rct_forward_shift": (
            lambda: mct.rct_forward_shift(*rgb, 8, False),
            lambda: mct.rct_forward_shift_plain(*rgb, 8, False),
            3 * h * w, 3),
        "rct_inverse_unshift": (
            lambda: mct.rct_inverse_unshift(*ycc, 8, False),
            lambda: mct.rct_inverse_unshift_plain(*ycc, 8, False),
            3 * h * w, 5),
    }
    times = {}
    for name, (kernel, plain, samples, ops) in runs.items():
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kernel), time_ms(kernel),
                          time_ms(plain))
        k_single, k_amort = min(k1[0], k2[0]), min(k1[1], k2[1])
        p_single, p_amort = min(p1[0], p2[0]), min(p1[1], p2[1])
        # each kernel reads every int32 sample once and writes it once
        nbytes = 8 * samples
        bounds = {"bytes": 1e3 * nbytes / PEAK_BYTES_S,
                  "operations": 1e3 * ops * samples / PEAK_OPS_S}
        bound_by = max(bounds, key=bounds.get)
        log(f"time {name:24s} {samples} samples: kernel {k_single:.4f} ms "
            f"per launch, {k_amort:.4f} ms amortised "
            f"({samples / k_amort / 1e6:.2f} GS/s, "
            f"{nbytes / k_amort / 1e9:.1f} TB/s at 8 B/sample); "
            f"twin {p_single:.4f} ms per launch, {p_amort:.4f} ms "
            f"amortised; bound {bounds[bound_by]:.4f} ms ({bound_by})")
        times[name] = (k_amort, p_amort, bounds[bound_by], bound_by)
    return times


ICT_KERNELS = {"ict_forward_shift": "ict_fwd_kernel",
               "ict_inverse_unshift": "ict_inv_kernel"}


def time_lossy(gen, dwt, mct):
    """The 9/7 level and ICT kernels and their twins (on the card) at case
    (d)'s level-1 shapes, 3 x 2048 x 2048, as the codec calls them (the
    level's LL float32, its high bands quantized; the inverse from
    doubled-domain high bands), in turns (twin, kernel, kernel, twin); for
    grk_ict_fwd also the one PyTorch call that computes its 3x3 transform,
    torch.matmul of the matrix and the (3, H W) float32 samples (timed
    only: it rounds otherwise).  Returns ({name: (ms, plain_ms, bound_ms,
    bound_by)}, {name: library ms}), times amortised."""
    h = w = 2048
    x = normal(gen, (3, 1, h, w), 600.0)
    steps = (0.0,) + STEPS_97[1:]
    bands = dwt.fwd_level(x, False, steps)
    dbl = [bands[0]] + [2 * b + torch.sign(b) for b in bands[1:]]
    img = randint(gen, (3, 1, h, w), 0, 256)
    ycc = mct.ict_forward_shift(img, mct=1, prec=8, sgnd=False)
    matrix = torch.tensor(mct.ICT_FWD_F32, device="cuda")
    flat = img.reshape(3, -1).to(torch.float32)
    n = x.numel()
    kw = dict(mct=1, prec=8, sgnd=False)
    # (kernel, twin, library call, float operations a sample): a level
    # does, on each axis, four lifting steps of three operations on half
    # the samples and a scaling (7), and the quantizer or dequantizer's
    # few; the forward ICT with its shift and cast 7, the inverse with its
    # rounding, unshift and clip about 6
    runs = {
        "fwd97_level": (lambda: dwt.fwd_level(x, False, steps),
                        lambda: dwt.fwd_level_plain(x, False, steps),
                        None, 18),
        "inv97_level": (lambda: dwt.inv_level(*dbl, h, w, False, steps),
                        lambda: dwt.inv_level_plain(*dbl, h, w, False,
                                                    steps), None, 16),
        "ict_forward_shift": (
            lambda: mct.ict_forward_shift(img, **kw),
            lambda: mct.ict_forward_shift_plain(img, **kw),
            lambda: torch.matmul(matrix, flat), 7),
        "ict_inverse_unshift": (
            lambda: mct.ict_inverse_unshift(ycc, **kw),
            lambda: mct.ict_inverse_unshift_plain(ycc, **kw), None, 6),
    }
    times, library_ms = {}, {}
    for name, (kernel, plain, library, ops) in runs.items():
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kernel), time_ms(kernel),
                          time_ms(plain))
        k_single, k_amort = min(k1[0], k2[0]), min(k1[1], k2[1])
        p_single, p_amort = min(p1[0], p2[0]), min(p1[1], p2[1])
        lib = time_ms(library) if library else None
        # 4 B a sample in and 4 B out (every band, float32 or int32)
        nbytes = 8 * n
        bounds = {"bytes": 1e3 * nbytes / PEAK_BYTES_S,
                  "operations": 1e3 * ops * n / PEAK_OPS_S}
        bound_by = max(bounds, key=bounds.get)
        log(f"time {name:24s} {n} samples: kernel {k_single:.4f} ms per "
            f"launch, {k_amort:.4f} ms amortised "
            f"({nbytes / k_amort / 1e9:.1f} TB/s at 8 B/sample); twin "
            f"{p_single:.4f} ms per launch, {p_amort:.4f} ms amortised; "
            + (f"torch.matmul {lib[0]:.4f} ms per launch, {lib[1]:.4f} ms "
               "amortised; " if lib else "no single PyTorch call; ")
            + f"bound {bounds[bound_by]:.4f} ms ({bound_by})")
        times[name] = (k_amort, p_amort, bounds[bound_by], bound_by)
        if lib:
            library_ms[name] = lib[1]
        if name in ICT_KERNELS:
            prof, graph = device_ms(kernel, ICT_KERNELS[name])
            log(f"time {name} device: {fmt_ms(prof)} ms a launch "
                f"(profiler), {graph:.4f} ms a launch in a CUDA graph of "
                f"{QUEUED}")
    return times, library_ms


def psnr(a: np.ndarray, b: np.ndarray, peak: int = 255) -> float:
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(peak * peak / mse)


# ------------------------------------------------------------- codec cases

def codec_case(name, arr, kw, expect, counters, exact=None, plain=True,
               mq=None, rate=None, quality=False):
    """Encode and decode `arr` through grok_tpu_torch on the card, with
    the entry points' defaults; check the bytes against the port's plain
    route (its twins on the CPU: on `arr`, or, with plain an array, on that
    array coded on the card and on the plain route on its own; with plain
    False not at all) and its host route (backend="native"), the decode
    against the input, and the launch and host-path counters (every
    counter in `expect` risen; `exact`, if given, the counts exactly; `mq`,
    if given, those MQ codeblock counts exactly; on an HT case without
    ht_mixed, every HT block coded on the card in a flat tile batch).
    With `rate` (lossy, layer_rates [rate]) the bytes are not held to the
    host route's and the decode not to the input: lossy_checks instead.
    With `quality` (lossy, a layer_psnr target) the bytes are held to the
    host route's, and the decode to the host route's decode of them
    within 1 (quality_checks).
    Returns the launch counts and the encoded bytes."""
    import grok_tpu_torch
    from grok_tpu_torch import CompressParams, DecompressParams, GrkImage
    from grok_tpu_torch.kernels import LAUNCHES, reset_launches
    from grok_tpu_torch.t1.backend import DEVICE_CODEBLOCKS
    from grok_tpu_torch.tile.processor import HOST_PATH_TILES

    img = GrkImage.from_array(arr)
    pixels = arr.shape[0] * arr.shape[1]

    refs = []
    if plain is not False:
        own = arr if plain is True else plain
        t = time.perf_counter()
        ref = grok_tpu_torch.compress(GrkImage.from_array(own),
                                      CompressParams(**kw), device="cpu")
        plain_s = time.perf_counter() - t
        what = "" if plain is True else f" on a {own.shape} part"
        log(f"case {name}: the plain route (twins on the CPU) encoded{what} "
            f"in {plain_s:.1f} s" + (" (more than 60 s)" if plain_s > 60
                                    else ""))
        if plain is True:
            refs.append((ref, "plain route"))
        elif grok_tpu_torch.compress(GrkImage.from_array(own),
                                     CompressParams(**kw)) != ref:
            raise AssertionError(f"case {name}: the card's codestream of "
                                 f"{own.shape} differs from the plain route")
    host = grok_tpu_torch.compress(img, CompressParams(backend="native",
                                                       **kw))
    if rate is None:
        refs.append((host, "host route"))
    reset_launches()
    for counts in (HOST_PATH_TILES, DEVICE_CODEBLOCKS):
        for k in counts:
            counts[k] = 0
    data = grok_tpu_torch.compress(img, CompressParams(**kw))
    out = grok_tpu_torch.decompress(data)
    counts = dict(LAUNCHES)
    host_tiles = dict(HOST_PATH_TILES)
    blocks = dict(DEVICE_CODEBLOCKS)
    for ref, route in refs:
        if data != ref:
            raise AssertionError(f"case {name}: codestream differs from the "
                                 f"{route} ({len(data)} vs {len(ref)} bytes)")
    if rate is not None:
        lossy_checks(name, arr, rate, data, out.to_array(), host)
    elif quality:
        quality_checks(name, arr, kw["layer_psnr"], out.to_array(), host)
    elif not np.array_equal(out.to_array(), arr.astype(np.int32)):
        raise AssertionError(f"case {name}: decode is not bit-exact")
    missing = [k for k in expect if counts[k] == 0]
    if missing:
        raise AssertionError(f"case {name}: no launches of {missing}")
    if exact is not None and counts != exact:
        raise AssertionError(f"case {name}: launches {counts}, expected "
                             f"{exact}")
    if any(host_tiles.values()):
        raise AssertionError(f"case {name}: tiles took the host path: "
                             f"{host_tiles}")
    if mq is not None and any(blocks[k] != v for k, v in mq.items()):
        raise AssertionError(f"case {name}: MQ codeblocks {blocks}, "
                             f"expected {mq}")
    if kw.get("ht") and not kw.get("ht_mixed") and not (
            blocks["ht_encode_flat"] == blocks["encode_device"] > 0
            and blocks["ht_decode_flat"] == blocks["decode_device"]):
        raise AssertionError(f"case {name}: HT codeblocks {blocks}, "
                             "expected every card-coded one in a flat "
                             "tile batch")
    same = (' and '.join(r for _, r in refs)
            or "plain route on the part coded on its own (above)")
    log(f"case {name}: {len(data)} bytes identical to the {same}, decode "
        f"{'lossy (above)' if rate or quality else 'bit-exact'}, launches "
        f"{counts}, host-path tiles {host_tiles}")
    log(f"case {name}: codeblocks through Tier-1 under backend=device: HT "
        f"encode {blocks['encode_device']} on the card, "
        f"{blocks['encode_host']} on the native coder; HT decode "
        f"{blocks['decode_device']} on the card, {blocks['decode_host']} "
        f"on the native coder; MQ encode {blocks['mq_encode_device']} on the "
        f"card, {blocks['mq_encode_host']} on the native coder; MQ decode "
        f"{blocks['mq_decode_device']} on the card, "
        f"{blocks['mq_decode_host']} on the native coder; e0 summed on the "
        f"host for {blocks['e0_host']}; HT in flat tile batches: encode "
        f"{blocks['ht_encode_flat']}, decode {blocks['ht_decode_flat']}; MQ "
        f"in flat tile batches: encode {blocks['mq_encode_flat']} (with "
        f"distortions {blocks['mq_encode_flat_dist']}), decode "
        f"{blocks['mq_decode_flat']}")

    def encode(backend):
        def run():
            grok_tpu_torch.compress(img, CompressParams(backend=backend,
                                                        **kw), device="cuda")
        return run

    def decode(backend):
        def run():
            grok_tpu_torch.decompress(data, DecompressParams(backend=backend),
                                      device="cuda")
        return run

    # in turns on one machine: host route, card, card, host route
    enc_ref, enc = turns(encode("native"), encode("device"))
    dec_ref, dec = turns(decode("native"), decode("device"))
    log(f"e2e {name}: {arr.shape} {len(data)} B; grok_tpu_torch on the card "
        f"encode {pixels / enc / 1e6:.2f} MP/s ({enc * 1e3:.1f} ms), decode "
        f"{pixels / dec / 1e6:.2f} MP/s ({dec * 1e3:.1f} ms); host route "
        f"(backend=native): encode {pixels / enc_ref / 1e6:.2f} MP/s "
        f"({enc_ref * 1e3:.1f} ms), decode {pixels / dec_ref / 1e6:.2f} MP/s "
        f"({dec_ref * 1e3:.1f} ms); {counters}")
    return counts, data


def packet_bytes(data: bytes) -> int:
    """The bytes of a raw codestream's packets: every tile-part's length
    (Psot) less its SOT..SOD header, walking the marker segments."""
    pos, total = 2, 0  # after SOC
    while data[pos:pos + 2] != b"\xff\x90":  # the main header, to the SOT
        pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
    while data[pos:pos + 2] == b"\xff\x90":
        start = pos
        psot = int.from_bytes(data[pos + 6:pos + 10], "big")
        while data[pos:pos + 2] != b"\xff\x93":  # the tile-part header
            pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        total += psot - (pos + 2 - start)
        pos = start + psot
    return total


def lossy_checks(name, arr, rate, data, out, host):
    """A lossy case's checks: the card's packet bytes within the 1/rate of
    the samples' bytes that layer_rates [rate] asks for (rate control
    budgets the packets; the headers come on top); the PSNR of its
    round trip within 0.1 dB of the host route's; the card's decode of the
    host route's codestream within 1 of the host route's own decode.  Says
    whether the card's bytes and that decode also equal the host route's
    exactly (they do when the 9/7 arithmetic agrees to the bit)."""
    import grok_tpu_torch
    from grok_tpu_torch import DecompressParams

    limit = arr.size * 1 / rate  # 8-bit samples: one byte each
    packets = packet_bytes(data)
    if packets > limit:
        raise AssertionError(f"case {name}: {packets} packet bytes, over "
                             f"the {limit:.0f} of a {rate}:1 rate")
    host_out = grok_tpu_torch.decompress(
        host, DecompressParams(backend="native")).to_array()
    card_of_host = grok_tpu_torch.decompress(host).to_array()
    p_card, p_host = psnr(arr, out), psnr(arr, host_out)
    if abs(p_card - p_host) > 0.1:
        raise AssertionError(f"case {name}: PSNR {p_card:.3f} dB on the "
                             f"card, {p_host:.3f} dB on the host route")
    diff = int(np.abs(card_of_host.astype(np.int64) - host_out).max())
    if diff > 1:
        raise AssertionError(f"case {name}: the card's decode of the host "
                             f"route's codestream is {diff} off its own")
    log(f"case {name}: {len(data)} bytes, {packets} of them packets, of "
        f"{limit:.0f} allowed ({rate}:1); "
        f"PSNR card {p_card:.4f} dB, host route {p_host:.4f} dB; the card's "
        f"codestream {'equals' if data == host else 'differs from'} the "
        f"host route's ({len(host)} bytes); the card's decode of the host "
        f"route's codestream is {diff} off the host route's own decode, "
        f"{int(np.count_nonzero(card_of_host != host_out))} samples differ")


def quality_checks(name, arr, targets, out, host):
    """A quality case's decode check: the card's decode of the host
    route's codestream (which the case holds the card's bytes to) within 1
    of the host route's own decode.  Logs the PSNR of both beside the
    layer_psnr targets."""
    import grok_tpu_torch
    from grok_tpu_torch import DecompressParams

    host_out = grok_tpu_torch.decompress(
        host, DecompressParams(backend="native")).to_array()
    diff = int(np.abs(out.astype(np.int64) - host_out).max())
    if diff > 1:
        raise AssertionError(f"case {name}: the card's decode is {diff} "
                             "off the host route's decode of the same "
                             "codestream")
    log(f"case {name}: {len(host)} bytes; PSNR card {psnr(arr, out):.4f} "
        f"dB, host route {psnr(arr, host_out):.4f} dB, target {targets}; "
        f"the card's decode is {diff} off the host route's, "
        f"{int(np.count_nonzero(out != host_out))} samples differ")


def turns(ref, port) -> tuple[float, float]:
    """Best host-clock seconds of `ref` and `port`, run in turns (ref,
    port, port, ref), each ending in a synchronize."""
    times = {ref: [], port: []}
    for fn in (ref, port, port, ref):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[fn].append(time.perf_counter() - t)
    return min(times[ref]), min(times[port])


# -------------------------------------------------------------------- main

# ------------------------------------------------------- the CLI and strips

PORT_KERNELS = ("fwd53_level_kernel", "inv53_level_kernel", "rct_fwd_kernel",
                "rct_inv_kernel", "fwd97_level_kernel", "inv97_level_kernel",
                "ict_fwd_kernel", "ict_inv_kernel", "ht_encode_kernel",
                "ht_destuff_kernel", "ht_decode_kernel", "ht_magsgn_kernel",
                "mq_encode_kernel", "mq_decode_kernel")


def write_pnm(path: str, arr: np.ndarray) -> None:
    """8-bit binary PGM (h, w) or PPM (h, w, 3), without Pillow."""
    magic = b"P6" if arr.ndim == 3 else b"P5"
    with open(path, "wb") as f:
        f.write(magic + f"\n{arr.shape[1]} {arr.shape[0]}\n255\n".encode())
        f.write(np.ascontiguousarray(arr, dtype=np.uint8).tobytes())


def reset_counts() -> None:
    from grok_tpu_torch.kernels import reset_launches
    from grok_tpu_torch.t1.backend import DEVICE_CODEBLOCKS
    from grok_tpu_torch.tile.processor import HOST_PATH_TILES

    reset_launches()
    for counts in (HOST_PATH_TILES, DEVICE_CODEBLOCKS):
        for k in counts:
            counts[k] = 0


def trace_kernels(trace_dir: str) -> Counter:
    """The port's kernels among the device kernel records of the
    torch.profiler Chrome traces in trace_dir."""
    names = Counter()
    for f in os.listdir(trace_dir):
        with open(os.path.join(trace_dir, f)) as fh:
            events = json.load(fh).get("traceEvents", [])
        for ev in events:
            if ev.get("cat") == "kernel":
                for k in PORT_KERNELS:
                    if k in ev.get("name", ""):
                        names[k] += 1
    return names


def cli_phase(card_note: str, gray: np.ndarray, rgb_c: np.ndarray,
              tmp: str) -> None:
    """BASELINE config 1 through the port's command-line tools, called in
    process with their default flags (the card): (i) the 512x512 gray
    image as PGM, encoded and decoded, its codestream the library's on the
    card and on the host route, its decode the input, its MQ blocks coded
    on the card and no tile on the host path; (ii) case (c)'s RGB image as
    PPM in 512x512 tiles, streamed (--stream-strips) and whole, the two
    files byte-identical, then decoded through the strip writer; (iii)
    grk_dump.  (iv) is cli_profile_check, run first."""
    import grok_tpu_torch
    from grok_tpu_torch import CompressParams, GrkImage
    from grok_tpu_torch.cli import grk_compress, grk_decompress, grk_dump
    from grok_tpu_torch.kernels import LAUNCHES
    from grok_tpu_torch.t1.backend import DEVICE_CODEBLOCKS
    from grok_tpu_torch.tile.processor import HOST_PATH_TILES

    def call(tool, argv):
        t = time.perf_counter()
        rc = tool.main(argv)
        if rc != 0:
            raise AssertionError(f"cli: {tool.__name__} {argv} exited {rc}")
        return time.perf_counter() - t

    pgm, j2k, back = (os.path.join(tmp, f) for f in
                      ("gray.pgm", "gray.j2k", "back.pgm"))
    write_pnm(pgm, gray)
    reset_counts()
    enc_s = call(grk_compress, ["-i", pgm, "-o", j2k])
    dec_s = call(grk_decompress, ["-i", j2k, "-o", back])
    blocks, host_tiles = dict(DEVICE_CODEBLOCKS), dict(HOST_PATH_TILES)
    counts = dict(LAUNCHES)
    with open(j2k, "rb") as f:
        data = f.read()
    img = GrkImage.from_array(gray)
    for route, kw in (("card", {}), ("host route", dict(backend="native"))):
        if grok_tpu_torch.compress(img, CompressParams(**kw)) != data:
            raise AssertionError(f"cli (i): grk_compress's codestream "
                                 f"differs from compress on the {route}")
    with open(pgm, "rb") as a, open(back, "rb") as b:
        if a.read() != b.read():
            raise AssertionError("cli (i): the decoded PGM differs from "
                                 "the input")
    if not (blocks["mq_encode_device"] and blocks["mq_decode_device"]):
        raise AssertionError(f"cli (i): no MQ blocks on the card: {blocks}")
    if any(host_tiles.values()):
        raise AssertionError(f"cli (i): host-path tiles {host_tiles}")
    log(f"cli (i) config-1 512x512 PGM: grk_compress {enc_s * 1e3:.1f} ms, "
        f"grk_decompress {dec_s * 1e3:.1f} ms (first calls), {len(data)} B "
        f"identical to compress on the card and on the host route, decode "
        f"identical to the input; MQ blocks on the card "
        f"{blocks['mq_encode_device']} / {blocks['mq_decode_device']}, "
        f"launches {counts}; {card_note}")

    ppm, streamed, whole, back_ppm = (
        os.path.join(tmp, f) for f in
        ("c.ppm", "c-streamed.j2k", "c-whole.j2k", "c-back.ppm"))
    write_pnm(ppm, rgb_c)
    reset_counts()
    st_s = call(grk_compress, ["-i", ppm, "-o", streamed, "-t", "512,512",
                               "--stream-strips"])
    wh_s = call(grk_compress, ["-i", ppm, "-o", whole, "-t", "512,512"])
    dc_s = call(grk_decompress, ["-i", streamed, "-o", back_ppm])
    counts = dict(LAUNCHES)
    with open(streamed, "rb") as a, open(whole, "rb") as b:
        size = len(a.read())
        a.seek(0)
        if a.read() != b.read():
            raise AssertionError("cli (ii): --stream-strips wrote other "
                                 "bytes than the whole-image encode")
    with open(ppm, "rb") as a, open(back_ppm, "rb") as b:
        if a.read() != b.read():
            raise AssertionError("cli (ii): the strip-written PPM differs "
                                 "from the input")
    missing = [k for k in ("rct_forward_shift", "rct_inverse_unshift",
                           "fwd53_level", "inv53_level", "mq_encode",
                           "mq_decode") if not counts[k]]
    if missing or any(HOST_PATH_TILES.values()):
        raise AssertionError(f"cli (ii): no launches of {missing}, or "
                             f"host-path tiles {dict(HOST_PATH_TILES)}")
    log(f"cli (ii) case (c) 2048x2048 PPM, 512x512 tiles: --stream-strips "
        f"{st_s * 1e3:.1f} ms, whole {wh_s * 1e3:.1f} ms, {size} B "
        f"identical; strip-written decode {dc_s * 1e3:.1f} ms, identical to "
        f"the input; launches {counts}; {card_note}")

    call(grk_dump, ["-i", j2k, "-o", os.path.join(tmp, "dump.txt")])
    log("cli (iii) grk_dump exited 0")


def cli_profile_check(gray: np.ndarray) -> None:
    """The cli phase's (iv): grk_compress --profile DIR on the 512x512
    gray PGM writes a Chrome trace whose device kernel records name the
    port's kernels.  Run before any other torch.profiler session of the
    process: after the kernel timings' sessions (CUDA activity only, CUDA
    graphs) a new session's trace held no kernel records on the H100."""
    from grok_tpu_torch.cli import grk_compress

    with tempfile.TemporaryDirectory(prefix="grk_prof_") as tmp:
        pgm, prof = os.path.join(tmp, "gray.pgm"), os.path.join(tmp, "prof")
        write_pnm(pgm, gray)
        rc = grk_compress.main(["-i", pgm, "-o", os.path.join(tmp, "p.j2k"),
                                "--profile", prof])
        named = trace_kernels(prof)
    if rc != 0 or not named:
        raise AssertionError(f"cli (iv): grk_compress --profile exited {rc}; "
                             f"the trace names none of the port's kernels")
    log(f"cli (iv) --profile trace kernel records: {dict(named)}")


GIGA_N = 32768  # BASELINE config 5: 32768^2 = 1.074 GP, 8-bit gray
GIGA_TILE = 1024


def giga_content(y0: int, y1: int, n: int = GIGA_N) -> np.ndarray:
    """tests/test_gigapixel.py's rows [y0, y1): smooth texture and
    structure, regenerated a strip at a time.  The same values as the
    test's int64 formula (every term fits int32 below 2^16 a side),
    made 64 rows at a time so that no temporary outgrows 8 MB."""
    out = np.empty((y1 - y0, n), np.int32)
    x = np.arange(n, dtype=np.int32)[None, :]
    for r in range(y0, y1, 64):
        y = np.arange(r, min(r + 64, y1), dtype=np.int32)[:, None]
        out[r - y0:r - y0 + y.shape[0]] = (
            ((x * 7 + y * 13) >> 5) ^ ((x >> 8) * (y >> 8))) & 0xFF
    return out


def rss_gb() -> tuple[float, float]:
    """This process's resident set now (/proc/self/statm) and at its peak
    (getrusage), GB."""
    import resource

    with open("/proc/self/statm") as f:
        now = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    return now / 1e9, resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1e6


def giga_params(**kw):
    from grok_tpu_torch import CompressParams

    return CompressParams(numresolution=6, tile_size=(GIGA_TILE, GIGA_TILE),
                          ht=True, tlm=True, plt=True, **kw)


def giga_meta(h: int, w: int):
    from grok_tpu_torch import GrkImage
    from grok_tpu_torch.image import ImageComponent

    meta = GrkImage(x0=0, y0=0, x1=w, y1=h)
    meta.comps.append(ImageComponent(prec=8, w=w, h=h))
    return meta


def giga_part_checks(card_note: str) -> None:
    """The byte check on a part of config 5's image, its first 4096 rows
    at 8192 wide (32 tiles): compress_strips on the card, compress on the
    card and on the host route give one codestream, which decodes to the
    part, and a strip_height=300 decode equals the whole decode."""
    import grok_tpu_torch
    from grok_tpu_torch import DecompressParams, GrkImage

    h, w = 4096, 8192
    part = giga_content(0, h, w)
    t = time.perf_counter()
    strips = grok_tpu_torch.compress_strips(
        giga_meta(h, w), lambda y0, n: [part[y0:y0 + n]], giga_params())
    strips_s = time.perf_counter() - t
    whole = grok_tpu_torch.compress(GrkImage.from_array(part), giga_params())
    host = grok_tpu_torch.compress(GrkImage.from_array(part),
                                   giga_params(backend="native"))
    if not strips == whole == host:
        raise AssertionError("gigapixel part: compress_strips, compress and "
                             "the host route disagree")
    full = grok_tpu_torch.decompress(strips).comps[0].data
    if not np.array_equal(full, part):
        raise AssertionError("gigapixel part: decode is not bit-exact")
    t = time.perf_counter()
    rows = 0
    for y0, planes in grok_tpu_torch.decompress_strips(
            strips, DecompressParams(), strip_height=300):
        if not np.array_equal(planes[0], full[y0:y0 + planes[0].shape[0]]):
            raise AssertionError(f"gigapixel part: strip at {y0} differs "
                                 "from the whole decode")
        rows += planes[0].shape[0]
    if rows != h:
        raise AssertionError(f"gigapixel part: strips gave {rows} rows")
    log(f"gigapixel part {h}x{w}: {len(strips)} B identical from "
        f"compress_strips ({strips_s * 1e3:.1f} ms), compress on the card and "
        f"the host route, decode exact; strip_height=300 decode "
        f"{(time.perf_counter() - t) * 1e3:.1f} ms equals the whole decode; "
        f"{card_note}")


def gigapixel_phase(card_note: str) -> None:
    """BASELINE config 5 with tests/test_gigapixel.py's settings on the
    card: a GIGA_N-square 8-bit gray image, made a strip at a time, HT, 6
    resolutions, 1024x1024 tiles, TLM and PLT, encoded with
    compress_strips_file to a file; the mmapped file decoded a tile row at
    a time (deferred synthesis on the card, every strip exact) and through
    a 512x512 window across tile seams (exact).  Peak RSS under 6 GB and
    peak card memory under 4 GB."""
    import mmap
    import resource

    import grok_tpu_torch
    from grok_tpu_torch import DecompressParams
    from grok_tpu_torch.kernels import LAUNCHES
    from grok_tpu_torch.tile.processor import HOST_PATH_TILES

    n = GIGA_N
    log("gigapixel RSS now / peak, GB: at the start %.2f / %.2f" % rss_gb())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mp = n * n / 1e6
    tmp = tempfile.mkdtemp(prefix="grk_giga_")
    path = os.path.join(tmp, "giga.j2k")
    try:
        reset_counts()
        t = time.perf_counter()
        nbytes = grok_tpu_torch.compress_strips_file(
            giga_meta(n, n), lambda y0, h: [giga_content(y0, y0 + h, n)],
            path, giga_params())
        t_enc = time.perf_counter() - t
        log("gigapixel RSS after the encode %.2f / %.2f" % rss_gb())
        enc_counts = dict(LAUNCHES)
        if HOST_PATH_TILES["encode"] or not (
                enc_counts["fwd53_level"] and enc_counts["ht_encode"]):
            raise AssertionError(f"gigapixel encode: launches {enc_counts}, "
                                 f"host-path tiles {dict(HOST_PATH_TILES)}")
        reset_counts()
        with open(path, "rb") as f:
            data = memoryview(mmap.mmap(f.fileno(), 0,
                                        access=mmap.ACCESS_READ))
        t = time.perf_counter()
        rows = 0
        for y0, planes in grok_tpu_torch.decompress_strips(
                data, DecompressParams()):
            strip = planes.pop(0)
            for r in range(0, strip.shape[0], 64):  # small temporaries
                want = giga_content(y0 + r, y0 + min(r + 64,
                                                     strip.shape[0]), n)
                if not np.array_equal(strip[r:r + 64], want):
                    raise AssertionError(f"gigapixel: strip at row {y0} "
                                         "is not exact")
            rows += strip.shape[0]
            del strip
        t_dec = time.perf_counter() - t
        log("gigapixel RSS after the strip decode %.2f / %.2f" % rss_gb())
        dec_counts = dict(LAUNCHES)
        if rows != n:
            raise AssertionError(f"gigapixel: strips gave {rows} rows")
        if HOST_PATH_TILES["decode"] or not all(
                dec_counts[k] for k in ("inv53_level", "ht_destuff",
                                        "ht_decode", "ht_magsgn")):
            raise AssertionError(f"gigapixel decode: launches {dec_counts}, "
                                 f"host-path tiles {dict(HOST_PATH_TILES)}")
        cx, cy = n * 5 // 8, n * 7 // 8  # tile corners: the window
        dp = DecompressParams()           # crosses both seams
        dp.window = (cx - 256, cy - 256, cx + 256, cy + 256)
        t = time.perf_counter()
        roi = grok_tpu_torch.decompress(data, dp).comps[0].data
        t_roi = time.perf_counter() - t
        if not np.array_equal(roi, giga_content(cy - 256, cy + 256, n)
                              [:, cx - 256:cx + 256]):
            raise AssertionError("gigapixel: the 512x512 ROI is not exact")
        del data
    finally:
        for f in os.listdir(tmp):
            os.unlink(os.path.join(tmp, f))
        os.rmdir(tmp)
    peak_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    card_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"gigapixel {n}x{n} ({mp:.0f} MP) HT lossless, 1024^2 tiles: encode "
        f"{mp / t_enc:.2f} MP/s ({t_enc:.1f} s), strip decode "
        f"{mp / t_dec:.2f} MP/s ({t_dec:.1f} s, every strip exact), 512^2 "
        f"ROI across tile seams {t_roi * 1e3:.1f} ms (exact), stream "
        f"{nbytes / 1e6:.1f} MB, peak RSS {peak_rss:.2f} GB, peak card memory "
        f"{card_gb:.3f} GB; launches encode {enc_counts} decode "
        f"{dec_counts}; {card_note}")
    if peak_rss >= 6:
        raise AssertionError(f"gigapixel: peak RSS {peak_rss:.2f} GB >= 6")
    if card_gb >= 4:
        raise AssertionError(f"gigapixel: peak card memory {card_gb:.3f} GB "
                             ">= 4")


def gigapixel_only() -> int:
    """The gigapixel phase in a process of its own, so that its peak RSS
    is its own: builds (or finds built) the kernels and the native coder,
    runs the phase, and checks that no jax or grok_tpu module loaded."""
    from grok_tpu_torch.kernels import build
    from grok_tpu_torch.tile import processor

    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    build.build()
    build.load()
    processor.host_backend("device")
    gigapixel_phase(f"card {card}")
    no_reference_loaded()
    log("gigapixel phase passed")
    return 0


# ------------------------------------------------------------ mesh phase

def case_d_steps() -> tuple[float, ...]:
    """Case (d)'s quantization steps at its first level (resolution 4 of
    5) as the codec gives them to the level kernels: (ll, hl, lh, hh),
    LL unquantized there."""
    from grok_tpu_torch.tile.geometry import BAND_GAIN, HH, HL, LH
    from grok_tpu_torch.transform import quant

    ss = quant.default_stepsizes(8, 5, False)
    return (0.0,) + tuple(
        quant.decode_stepsize(ss[1 + 3 * 3 + j], 8 + BAND_GAIN[o])
        for j, o in enumerate((HL, LH, HH)))


def card_slots(n: int) -> list[torch.device]:
    """n mesh slots over the visible cards in turn: cuda:0 n times on a
    machine with one card."""
    k = torch.cuda.device_count()
    return [torch.device("cuda", i % k) for i in range(n)]


def card_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """bit_err on the card: float32 compared by its bits."""
    if a.dtype != b.dtype:
        raise AssertionError(f"dtype {a.dtype} != {b.dtype}")
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return max_err(a, b)


def mesh_levels(pmesh, dwt) -> dict:
    """Every sharded level against the level kernel on the whole tensor,
    bit for bit: the forward and inverse 5/3 and 9/7 levels (the 9/7
    without steps and with case (d)'s), at case (d)'s level-1 shape
    3 x 2048 x 2048 and case (b)'s 3 x 2160 x 3840, on sp 2, 4 and 8
    slots of the visible card(s); and the card's sharded route against
    the plain sharded route (the CPU's slots) on a 3 x 256 x 512 part.
    Returns the largest error of each comparison."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    steps = case_d_steps()
    err = {"whole": 0, "plain": 0}
    calls = 0
    for h, w in ((2048, 2048), UHD):
        x = randint(gen, (3, 1, h, w), -512, 512)
        xf = normal(gen, (3, 1, h, w), 600.0)
        # (input, reversible, steps, its level's bands, the inverse's
        # bands (the 9/7's doubled where a step is given), its output)
        cases = []
        for inp, rev, st in ((x, True, None), (xf, False, None),
                             (xf, False, steps)):
            fwd = dwt.fwd_level(inp, rev, st)
            inb = [2 * b + torch.sign(b) if s > 0 else b
                   for b, s in zip(fwd, st or (0,) * 4)]
            cases.append((inp, rev, st, fwd, inb,
                          dwt.inv_level(*inb, h, w, rev, st)))
        for sp in (2, 4, 8):
            mesh = pmesh.Mesh([card_slots(sp)])
            cpu = pmesh.Mesh([["cpu"] * sp])
            for inp, rev, st, fwd, inb, want in cases:
                def level(m, t, bs):
                    if rev:
                        return (pmesh.sp_sharded_fwd_53_level(m, t),
                                pmesh.sp_sharded_inv_53_level(m, *bs))
                    return (pmesh.sp_sharded_fwd_97_level(m, t, st),
                            pmesh.sp_sharded_inv_97_level(m, *bs, steps=st))

                got, back = level(mesh, inp, inb)
                calls += 2
                err["whole"] = max([err["whole"], card_err(back, want)] +
                                   [card_err(g, r) for g, r in zip(got, fwd)])
                if (h, w) == UHD:
                    part = inp[..., :256, :512].contiguous()
                    bpart = [b[..., :128, :256].contiguous() for b in inb]
                    (cf, cb), (pf, pb) = (
                        level(mesh, part, bpart),
                        level(cpu, part.cpu(), [b.cpu() for b in bpart]))
                    err["plain"] = max(
                        [err["plain"], bit_err(cb, pb)] +
                        [bit_err(a, b) for a, b in zip(cf, pf)])
    torch.cuda.synchronize()
    log(f"mesh levels: {calls} sharded level calls (sp 2, 4, 8 at 3x2048x"
        f"2048 and 3x2160x3840; 5/3, 9/7, 9/7 with case (d)'s steps "
        f"{tuple(round(s, 6) for s in steps)}, each way) against the level "
        f"kernels on the whole tensors: max bit error {err['whole']}; the "
        f"card's sharded route against the plain sharded route on a "
        f"3x256x512 part: {err['plain']}")
    if any(err.values()):
        raise AssertionError(f"sharded levels differ: {err}")
    return err


def mesh_codec(name, arr, kw, mesh, data, want, levels, card_note):
    """compress and decompress on the card through `mesh`: the bytes
    `data` (the same process's single-device codestream), the decode
    `want`, no tile on the host path, and the launches of the transform
    kernels `levels` ({counter: launches} each way).  Returns (encode s,
    decode s)."""
    import grok_tpu_torch
    from grok_tpu_torch import CompressParams, DecompressParams, GrkImage
    from grok_tpu_torch.kernels import LAUNCHES
    from grok_tpu_torch.tile.processor import HOST_PATH_TILES

    img = GrkImage.from_array(arr)
    reset_counts()
    t = time.perf_counter()
    got = grok_tpu_torch.compress(img, CompressParams(mesh=mesh, **kw))
    torch.cuda.synchronize()
    enc = time.perf_counter() - t
    t = time.perf_counter()
    out = grok_tpu_torch.decompress(got, DecompressParams(mesh=mesh))
    torch.cuda.synchronize()
    dec = time.perf_counter() - t
    counts = {k: LAUNCHES[k] for k in levels}
    if got != data:
        raise AssertionError(f"mesh {name}: codestream differs from the "
                             f"single-device one ({len(got)} vs {len(data)} "
                             "bytes)")
    if not np.array_equal(out.to_array(), want):
        raise AssertionError(f"mesh {name}: decode differs from the "
                             "single-device card decode")
    if counts != levels:
        raise AssertionError(f"mesh {name}: launches {counts}, expected "
                             f"{levels}")
    if any(HOST_PATH_TILES.values()):
        raise AssertionError(f"mesh {name}: tiles took the host path: "
                             f"{dict(HOST_PATH_TILES)}")
    log(f"mesh {name} on {mesh}: {len(got)} bytes identical to the "
        f"single-device card route, decode equal to it, launches {counts}; "
        f"e2e encode {enc * 1e3:.1f} ms, decode {dec * 1e3:.1f} ms; "
        f"{card_note}")
    return enc, dec


def single_times(arr, kw, data):
    """One single-device card encode and decode (s), for the mesh lines."""
    import grok_tpu_torch
    from grok_tpu_torch import CompressParams, GrkImage

    img = GrkImage.from_array(arr)
    t = time.perf_counter()
    grok_tpu_torch.compress(img, CompressParams(**kw))
    torch.cuda.synchronize()
    enc = time.perf_counter() - t
    t = time.perf_counter()
    out = grok_tpu_torch.decompress(data)
    torch.cuda.synchronize()
    return enc, time.perf_counter() - t, out.to_array()


def mesh_phase(card_note, rgb_c, kw_c, data_c, rgb_d, kw_d, data_d, uhd,
               kw_b, data_b) -> None:
    """The multi-device mesh (parallel/mesh.py) on the card: the sharded
    levels bit for bit; cases (c) on dp 2 x sp 2, (d) on sp 4 and a 2048^2
    lossless HT tile on sp 4 through the codec, equal to this process's
    single-device bytes and decodes, each level kernel launched once a
    shard a level; case (b) on sp 2, whose height the mesh cannot
    row-shard, on one device; the same cases over distinct cards where
    there are several; the dry run; the refusal of an int mesh larger
    than the visible cards."""
    from grok_tpu_torch.ops import dwt
    from grok_tpu_torch.parallel import mesh as pmesh

    mesh_levels(pmesh, dwt)
    kw_h = dict(numresolution=6, ht=True)
    import grok_tpu_torch
    from grok_tpu_torch import CompressParams, GrkImage

    data_h = grok_tpu_torch.compress(GrkImage.from_array(rgb_c),
                                     CompressParams(**kw_h))
    single = {"c": single_times(rgb_c, kw_c, data_c),
              "d": single_times(rgb_d, kw_d, data_d),
              "h": single_times(rgb_c, kw_h, data_h)}

    def levels(n, lossy, numres):
        """The transform kernels' launches each way on n shards."""
        if lossy:
            return dict(fwd97_level=n * (numres - 1), ict_forward_shift=n,
                        inv97_level=n * (numres - 1), ict_inverse_unshift=n)
        return dict(fwd53_level=n * (numres - 1), rct_forward_shift=n,
                    inv53_level=n * (numres - 1), rct_inverse_unshift=n)

    def cases(slots_c, dp_c, slots_d, where):
        times = {}
        mesh_c = pmesh.make_mesh(len(slots_c), dp=dp_c,
                                 sp=len(slots_c) // dp_c, devices=slots_c)
        times["c"] = mesh_codec(
            f"c {where}", rgb_c, kw_c, mesh_c, data_c, rgb_c,
            levels(mesh_c.size, False, 6), card_note)
        mesh_d = pmesh.make_mesh(len(slots_d), dp=1, sp=len(slots_d),
                                 devices=slots_d)
        times["d"] = mesh_codec(
            f"d {where}", rgb_d, kw_d, mesh_d, data_d, single["d"][2],
            levels(mesh_d.size, True, 5), card_note)
        return times, mesh_d

    one = card_slots(4)
    times, mesh4 = cases(one, 2, one, "dp 2 x sp 2 / sp 4")
    times["h"] = mesh_codec("2048x2048 RGB HT lossless, one tile, sp 4",
                            rgb_c, kw_h, mesh4, data_h, rgb_c,
                            levels(4, False, 6), card_note)
    mesh_b = pmesh.make_mesh(2, dp=1, sp=2, devices=card_slots(2))
    if pmesh.sp_transform_ok(mesh_b, UHD[0], 6):
        raise AssertionError("case (b)'s height should not row-shard")
    mesh_codec("b on sp 2 (2160 rows do not row-shard 6 resolutions: one "
               "device)", uhd, kw_b, mesh_b, data_b, uhd,
               levels(1, False, 6), card_note)
    for k, label in (("c", "c dp 2 x sp 2"), ("d", "d sp 4"),
                     ("h", "HT 2048x2048 sp 4")):
        log(f"mesh e2e {label}: encode {times[k][0] * 1e3:.1f} ms, decode "
            f"{times[k][1] * 1e3:.1f} ms against one device's "
            f"{single[k][0] * 1e3:.1f} / {single[k][1] * 1e3:.1f} ms (one "
            f"run each, the mesh's slots on "
            f"{sorted({str(d) for d in one})}; no gain claimed); "
            f"{card_note}")
    n = torch.cuda.device_count()
    if n >= 2:
        cards = [torch.device("cuda", i) for i in range(min(n, 4))]
        sp_d = 4 if len(cards) >= 4 else 2
        cases(cards[:2 * (len(cards) // 2)], len(cards) // 2,
              cards[:sp_d], f"over {len(cards)} distinct cards")
        log(f"mesh: copies between cards ran, over {len(cards)} of {n} "
            "cards")
    else:
        log("mesh: only one card was visible, so the copies between cards "
            "were not run (every slot above is cuda:0)")
    pmesh.dryrun_multichip(4, card_slots(4))
    try:
        pmesh.resolve_mesh(n + 1, "cuda")
    except ValueError as e:
        log(f"mesh: resolve_mesh({n + 1}, 'cuda') raises with {n} visible: "
            f"{e}")
    else:
        raise AssertionError(f"resolve_mesh({n + 1}, 'cuda') did not raise "
                             f"with {n} card(s) visible")


def no_reference_loaded() -> None:
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "grok_tpu",
                                           "PIL"))
    if loaded:
        raise AssertionError(f"jax, grok_tpu or Pillow modules loaded: "
                             f"{loaded}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--mq-times"]:
        return mq_times_only(sys.argv[2] if len(sys.argv) > 2 else ".")
    if sys.argv[1:2] == ["--dwt97-times"]:
        return dwt97_times_only(sys.argv[2] if len(sys.argv) > 2 else ".")
    if sys.argv[1:2] == ["--ht-times"]:
        return ht_times_only(sys.argv[2] if len(sys.argv) > 2 else ".")
    if sys.argv[1:2] == ["--gigapixel"]:
        return gigapixel_only()
    import grok_tpu_torch  # noqa: F401  (fails outside a checkout)
    from grok_tpu_torch.kernels import LAUNCHES, build
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import torch_ht_cases  # the HT inputs the tests use
    import torch_mq_cases  # the MQ inputs the tests use
    from grok_tpu_torch.ops import (dwt, ht_decode, ht_encode, mct,
                                    mq_decode, mq_encode, pipeline)
    from grok_tpu_torch.t1 import ht_tables

    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, "
        f"{run([build.find_nvcc(), '--version']).splitlines()[-1]}")

    t0 = time.perf_counter()
    report = build.build()
    build.load()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s from "
        f"{[os.path.relpath(s) for s in build.sources()]}")
    log(report.strip())
    for name, lines in ptxas_lines(report, (
            "mq_encode_kernel", "mq_decode_kernel", "fwd97_level_kernel",
            "inv97_level_kernel") + HT_DECODE_KERNELS).items():
        log(f"ptxas {name}: {'; '.join(lines)}")
    t0 = time.perf_counter()
    from grok_tpu_torch.tile import processor  # builds the native coder
    processor.host_backend("device")  # raises if the native coder fails
    log(f"native host coder ready in {time.perf_counter() - t0:.1f} s")

    # config 5 in a process of its own, so that its peak RSS is its own,
    # started while this process is small: a child's ru_maxrss starts from
    # its parent's resident set at the fork
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--gigapixel"], timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the gigapixel phase exited "
                             f"{proc.returncode}")
    log(f"gigapixel phase (its own process) done in "
        f"{time.perf_counter() - t0:.0f} s")
    cli_profile_check(make_image())
    start = time.perf_counter()

    def phase(label):
        log(f"phase {label} done at {time.perf_counter() - start:.0f} s")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    err = check_levels(gen, dwt)
    err.update(check_rct(gen, mct))
    err.update(check_lossy(gen, dwt, mct))
    err.update(check_ht(ht_encode, ht_decode, ht_tables, torch_ht_cases))
    gray = make_image()
    bands_a = pipeline.analysis(
        torch.from_numpy(gray.astype(np.int32)[None, None]).cuda(),
        numres=6, reversible=True, mct=0, prec=8, sgnd=False)
    err.update(check_mq(mq_encode, mq_decode, torch_mq_cases,
                        *band_blocks(bands_a)))
    torch.cuda.synchronize()
    phase("kernel checks")
    log(f"kernel vs twin max abs err: {err}")
    if any(err.values()):
        raise AssertionError(f"kernels disagree with their twins: {err}")
    times = time_kernels(gen, dwt, mct)
    lossy_times, library_ms = time_lossy(gen, dwt, mct)
    # the 9/7 level kernels' rows: the device's own time at level 1
    for name, (ms, _) in time_dwt97(gen, dwt).items():
        lossy_times[name] = (ms,) + lossy_times[name][1:]
    times.update(lossy_times)
    uhd = make_rgb(*UHD, seed=SEED)
    times.update(time_ht(ht_population(uhd, pipeline),
                         giga_tile_blocks(pipeline), ht_encode, ht_decode,
                         err))
    phase("transform and HT kernel times")
    rgb_c = make_rgb(2048, 2048, SEED)
    bands_c = pipeline.analysis(torch.from_numpy(np.ascontiguousarray(
        tiles_c())).cuda(), numres=6, reversible=True, mct=1, prec=8,
        sgnd=False)
    times.update(time_mq(mq_launch_shapes(bands_c, bands_a), mq_encode,
                         mq_decode, err))
    if any(err.values()):
        raise AssertionError(f"kernels disagree with their twins: {err}")

    phase("MQ kernel times")
    lift = ("fwd53_level", "inv53_level")
    transforms = lift + ("rct_forward_shift", "rct_inverse_unshift")
    lossy = ("fwd97_level", "inv97_level", "ict_forward_shift",
             "ict_inverse_unshift")
    ht = ("ht_encode", "ht_destuff", "ht_decode", "ht_magsgn")
    mq = ("mq_encode", "mq_decode")
    every = transforms + lossy + ht + mq
    if set(LAUNCHES) != set(every):
        raise AssertionError(f"launch counters {sorted(LAUNCHES)}, "
                             f"expected {sorted(every)}")
    card_note = f"card {card}"
    # case (a): one tile, one launch of each level kernel a level and one
    # MQ launch each way; 70 codeblocks coded on the card, 63 decoded there
    # (grok_tpu's router decodes shape groups of 8 or more on its device)
    codec_case(
        "a config-1 512x512 gray MQ", gray, dict(numresolution=6), lift + mq,
        card_note,
        exact=dict(dict.fromkeys(every, 0), fwd53_level=5, inv53_level=5,
                   mq_encode=1, mq_decode=1),
        mq=dict(mq_encode_device=70, mq_encode_host=0,
                mq_decode_device=63, mq_decode_host=7))
    # the main path: one launch of each level kernel a level, five levels,
    # and one of each HT kernel for the tile's even codeblocks (decode: the
    # destuffing, chain and MagSgn launches)
    kw_b = dict(numresolution=6, ht=True)
    counts, data_b = codec_case(
        "b 3840x2160 RGB HT lossless", uhd, kw_b, transforms + ht,
        card_note,
        exact=dict(dict.fromkeys(every, 0), fwd53_level=5, inv53_level=5,
                   rct_forward_shift=1, rct_inverse_unshift=1,
                   **dict.fromkeys(ht, 1)))
    # case (c): 16 tiles, 210 codeblocks a tile on the card each way; its
    # plain route on its first tile coded as an image of its own
    kw_c = dict(numresolution=6, tile_size=(512, 512))
    mq_c = dict(mq_encode_device=3360, mq_encode_host=0,
                mq_decode_device=3360, mq_decode_host=0)
    counts_c, data_c = codec_case(
        "c 2048x2048 RGB 512^2 tiles MQ", rgb_c, kw_c, transforms + mq,
        card_note, plain=rgb_c[:512, :512], mq=mq_c)
    for k in mq:
        if counts_c[k] != 16:
            raise AssertionError(f"case c: {counts_c[k]} {k} launches, "
                                 "expected one a tile")
    # the MQ kernels' launches are those of their own path, case (c)
    counts.update({k: counts_c[k] for k in mq})
    codec_case("c-layers 2048x2048 RGB 512^2 tiles MQ, layer_rates "
               "[40, 10, 1]", rgb_c, dict(kw_c, layer_rates=[40, 10, 1]),
               transforms + mq, card_note, plain=False,
               mq=dict(mq_c, mq_encode_flat=3360, mq_encode_flat_dist=3360))
    phase("cases (a) to c-layers")
    # case (d), BASELINE config 2: one tile, four launches of each 9/7
    # level kernel (5 resolutions), one of each ICT kernel, one MQ launch
    # each way for its 3,072 codeblocks (1,024 a component, all within the
    # rate-targeted router's numbps 20; on encode one flat batch that
    # tracks distortions, as c-layers' tiles); its plain route on its first
    # 512x512 part coded as an image of its own
    rgb_d = make_config2(2048, 2048)
    kw_d = dict(numresolution=5, irreversible=True, layer_rates=[20])
    counts_d, data_d = codec_case(
        "d config-2 2048x2048 RGB 9/7 + ICT, layer_rates [20]", rgb_d, kw_d,
        lossy + mq, card_note, plain=rgb_d[:512, :512], rate=20,
        exact=dict(dict.fromkeys(every, 0), fwd97_level=4, inv97_level=4,
                   ict_forward_shift=1, ict_inverse_unshift=1, mq_encode=1,
                   mq_decode=1),
        mq=dict(mq_encode_device=3072, mq_encode_host=0,
                mq_encode_flat=3072, mq_encode_flat_dist=3072))
    # the 9/7 and ICT kernels' launches are those of their own path
    counts.update({k: counts_d[k] for k in lossy})
    # case (d-q): case (d)'s frame to a PSNR target, which keeps the
    # per-codeblock card route (a job a block, distortions tracked): its
    # 3,072 blocks on the card, none in a flat batch, none on the native
    # coder; its quality search decodes on its own, so no exact launches
    codec_case(
        "d-q config-2 2048x2048 RGB 9/7 + ICT, layer_psnr [40]", rgb_d,
        dict(numresolution=5, irreversible=True, layer_psnr=[40]),
        lossy + mq, card_note, plain=False, quality=True,
        mq=dict(mq_encode_device=3072, mq_encode_host=0, mq_encode_flat=0,
                mq_encode_flat_dist=0))
    phase("cases (d) and (d-q)")
    mesh_phase(card_note, rgb_c, kw_c, data_c, rgb_d, kw_d, data_d, uhd,
               kw_b, data_b)
    phase("mesh")
    with tempfile.TemporaryDirectory(prefix="grk_cli_") as tmp:
        cli_phase(card_note, gray, rgb_c, tmp)
    phase("cli")
    giga_part_checks(card_note)
    phase("gigapixel part checks")
    no_reference_loaded()

    kernels = []
    replaces = {
        "fwd53_level": ("grok_tpu_torch/csrc/dwt53_level.cu",
                        "grok_tpu/ops/pallas_dwt.py:78"),
        "inv53_level": ("grok_tpu_torch/csrc/dwt53_level.cu",
                        "grok_tpu/ops/pallas_dwt.py:105"),
        "rct_forward_shift": ("grok_tpu_torch/csrc/rct.cu",
                              "grok_tpu/ops/mct.py:92"),
        "rct_inverse_unshift": ("grok_tpu_torch/csrc/rct.cu",
                                "grok_tpu/ops/mct.py:130"),
        "ht_encode": ("grok_tpu_torch/csrc/ht_encode.cu",
                      "grok_tpu/ops/ht_encode.py:247"),
        "ht_destuff": ("grok_tpu_torch/csrc/ht_decode.cu",
                       "grok_tpu/ops/ht_decode.py:183"),
        "ht_decode": ("grok_tpu_torch/csrc/ht_decode.cu",
                      "grok_tpu/ops/ht_decode.py:194"),
        "ht_magsgn": ("grok_tpu_torch/csrc/ht_decode.cu",
                      "grok_tpu/ops/ht_decode.py:194"),
        "mq_encode": ("grok_tpu_torch/csrc/mq_encode.cu",
                      "grok_tpu/ops/mq_encode.py:729"),
        "mq_decode": ("grok_tpu_torch/csrc/mq_decode.cu",
                      "grok_tpu/ops/mq_decode.py:340"),
        "fwd97_level": ("grok_tpu_torch/csrc/dwt97_level.cu",
                        "grok_tpu/ops/dwt.py:119"),
        "inv97_level": ("grok_tpu_torch/csrc/dwt97_level.cu",
                        "grok_tpu/ops/dwt.py:129"),
        "ict_forward_shift": ("grok_tpu_torch/csrc/ict.cu",
                              "grok_tpu/ops/mct.py:46"),
        "ict_inverse_unshift": ("grok_tpu_torch/csrc/ict.cu",
                                "grok_tpu/ops/mct.py:54"),
    }
    for name in every:
        source, tpu = replaces[name]
        ms, plain_ms, bound_ms, bound_by = times[name]
        # no single PyTorch call computes a 5/3 or 9/7 level, the fused
        # RCT, the ICT's inverse with its rounding and clip, an HT cleanup
        # pass, HT destuffing or an MQ Tier-1 pass (library_ms None); the
        # forward ICT's 3x3 transform is one torch.matmul
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": tpu, "launches": counts[name],
                        "max_abs_err": err[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by,
                        "library_ms": library_ms.get(name)})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
