"""The judge: what decides `correct`.  Plain NumPy and PyTorch on the host;
it imports nothing of the program and takes nothing the program made but
its outputs, the codestreams and the decoded images of the window, which it
reads to judge them.

Every answer is judged whole where that is cheap, and by a sample drawn
from the run's seed where a plain decoder is too slow for it:

- every codestream and every decode of a pool image equals every other of
  that image (`repeat_mismatch`);
- lossless: every decoded image equals its input (`decode_mismatch`);
- lossy: every codestream's packets keep within its layer's rate
  (`rate_ratio`), and every decoded image keeps near its input (`max_mse`,
  the worst frame's mean squared error: a block coded empty is a legal
  truncation that the comparisons below cannot tell from rate control's);
- on a few frames, windows of pixels drawn from the seed: the plain
  reader parses the whole codestream (markers, Tier-2), decodes every
  code-block that the windows' samples depend on, and compares each with
  the plain forward transform of the input (`enc_mismatch`: coefficients,
  at the bit-planes the codestream holds in full, that differ, as a share);
- lossy: on those windows, the plain inverse transform of the decoded
  blocks against the program's decoded samples (`dec_mismatch`: the share
  of samples that differ).

The control (`control=True`) runs the same comparison with the
reference computed one step below what the configuration states: the
9/7 path and the ICT in bfloat16, the lossless path's 5/3 and RCT in
float32 rounded to nearest (which breaks reversibility).
"""

from __future__ import annotations

import numpy as np
import torch

from . import codestream as cs_mod
from . import t1_ht, t1_mq, transforms

MARGIN = 3  # extra band samples each side of a synthesis cone


def cone(lo: int, hi: int, levels: int):
    """Band index ranges [a, b) that samples [lo, hi) of a signal depend
    on, level by level from the finest: what a synthesis that starts at
    the coarsest band reads, with MARGIN to spare each side."""
    out = []
    for _ in range(levels):
        lo, hi = max(0, lo // 2 - MARGIN), hi // 2 + 1 + MARGIN
        out.append((lo, hi))
    return out


def window_blocks(tile, hdr, wins):
    """The code-blocks of every component whose coefficients the pixel
    windows [(y0, y1, x0, x1)] (tile coordinates) depend on."""
    need = set()
    levels = hdr.numres - 1
    for y0, y1, x0, x1 in wins:
        ys, xs = cone(y0, y1, levels), cone(x0, x1, levels)
        for lev in range(levels):
            resno = hdr.numres - 1 - lev
            (ya, yb), (xa, xb) = ys[lev], xs[lev]
            orients = (1, 2, 3) + ((0,) if lev == levels - 1 else ())
            for o in orients:
                r = 0 if o == 0 else resno
                need.add((r, o, ya, yb, xa, xb))
        if levels == 0:
            need.add((0, 0, y0, y1, x0, x1))
    blocks = []
    for c in range(hdr.numcomps):
        for r, o, ya, yb, xa, xb in need:
            band = tile.bands[(c, r, o)]
            for b in band.blocks:
                oy, ox = b.y0 - band.y0, b.x0 - band.x0
                if oy < yb and oy + b.h > ya and ox < xb and ox + b.w > xa:
                    blocks.append(b)
    return list({id(b): b for b in blocks}.values())


def decode(block, hdr) -> np.ndarray:
    """A code-block's doubled-domain samples, by the plain decoders."""
    if hdr.ht:
        return t1_ht.decode_block(block.data, block.h, block.w)
    return t1_mq.decode_block(block.chunks, block.numbps, block.h, block.w,
                              block.orient, hdr.style)


def full_planes(block, hdr) -> int:
    """The lowest bit-plane that a block's received passes hold in full
    (each plane ends with its cleanup pass): with none received, every
    plane the band can have is known to be empty."""
    if block.passes <= 0:
        return hdr.mb(block.resno, block.orient)
    return block.numbps - (1 + (block.passes - 1) // 3)


def expected_q(bands, hdr, compno, block, dtype=torch.float32):
    """The reference's quantized coefficients of one block (int64)."""
    band = bands[compno][(block.resno, block.orient)]
    sub = band[block.y0:block.y1, block.x0:block.x1]
    if hdr.reversible:
        return sub.to(torch.int64).numpy()
    return transforms.quantize(sub, hdr.delta(compno, block.resno,
                                              block.orient), dtype).numpy()


def block_mismatch(got: np.ndarray, q: np.ndarray, block, hdr) -> int:
    """Coefficients of a block that disagree with the reference at the
    bit-planes the codestream holds in full (all of them, lossless)."""
    if hdr.reversible:  # every plane: sign * (2|q| + 1) -> q
        dec = np.sign(got) * (np.abs(got) >> 1)
        return int(np.count_nonzero(dec != q))
    p = full_planes(block, hdr)
    dec_mag = np.abs(got) >> (p + 1)
    ref_mag = np.abs(q) >> p
    bad = dec_mag != ref_mag
    bad |= (ref_mag > 0) & (np.sign(got) != np.sign(q))
    return int(np.count_nonzero(bad))


def reconstruct(decoded, tile, hdr, dtype=torch.float32) -> torch.Tensor:
    """(C, H, W) samples of a lossy tile from the decoded blocks (others
    zero): dequantize, 9/7 synthesis, inverse ICT, round half to even,
    DC unshift, clip."""
    planes = []
    for c in range(hdr.numcomps):
        bands = {}
        for r in range(hdr.numres):
            for o in ((0,) if r == 0 else (1, 2, 3)):
                band = tile.bands[(c, r, o)]
                arr = torch.zeros((band.y1 - band.y0, band.x1 - band.x0),
                                  dtype=dtype)
                delta = hdr.delta(c, r, o)
                for b in band.blocks:
                    got = decoded.get(id(b))
                    if got is not None:
                        arr[b.y0 - band.y0:b.y1 - band.y0,
                            b.x0 - band.x0:b.x1 - band.x0] = \
                            transforms.dequantize(torch.from_numpy(got),
                                                  delta, dtype)
                bands[(r, o)] = arr
        planes.append(transforms.synthesis97(bands, hdr.numres, dtype))
    if hdr.mct and hdr.numcomps >= 3:
        planes[:3] = transforms.ict_inverse(*planes[:3], dtype=dtype)
    out = []
    for c, p in enumerate(planes):
        v = torch.round(p.to(torch.float32)).to(torch.int64) + \
            (1 << (hdr.precs[c] - 1))
        out.append(v.clamp(0, (1 << hdr.precs[c]) - 1))
    return torch.stack(out)


def pick_windows(rng, tile, count: int, size: int):
    """`count` pixel windows of `size` x `size` inside a tile, in tile
    coordinates."""
    h, w = tile.y1 - tile.y0, tile.x1 - tile.x0
    wins = []
    for _ in range(count):
        y0 = int(rng.integers(0, max(1, h - size + 1)))
        x0 = int(rng.integers(0, max(1, w - size + 1)))
        wins.append((y0, min(h, y0 + size), x0, min(w, x0 + size)))
    return wins


def _doubled(q: np.ndarray) -> np.ndarray:
    """Quantized coefficients as a decoder gives them: sign * (2|q| + 1)."""
    return np.sign(q) * (2 * np.abs(q) + 1)


def judge_frame(image: np.ndarray, codestream: bytes, decoded: np.ndarray,
                rng, windows: int, size: int, control: bool = False):
    """The sampled comparison on one frame: (mismatched coefficients,
    compared coefficients, mismatched window samples, compared samples).
    With `control`, the reference one precision step down stands in for
    the program: its coefficients for the codestream's, its synthesis for
    the program's decode."""
    hdr, tiles = cs_mod.read_codestream(codestream)
    enc_bad = enc_n = dec_bad = dec_n = 0
    x = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(image.reshape(image.shape[0], image.shape[1], -1), -1, 0)
    ).astype(np.int64))
    planes_out = np.moveaxis(decoded.reshape(
        decoded.shape[0], decoded.shape[1], -1), -1, 0)
    for tile in tiles:
        wins = pick_windows(rng, tile, windows, size)
        blocks = window_blocks(tile, hdr, wins)
        region = x[:, tile.y0 - hdr.y0:tile.y1 - hdr.y0,
                   tile.x0 - hdr.x0:tile.x1 - hdr.x0]
        origin = (tile.x0, tile.y0)
        bands = transforms.forward_planes(region, hdr.precs, hdr.mct,
                                          hdr.numres, hdr.reversible, origin)
        if control:
            low = transforms.forward_planes(
                region, hdr.precs, hdr.mct, hdr.numres, hdr.reversible,
                origin, dtype=torch.bfloat16, exact=False)
        got = {}
        for b in blocks:
            got[id(b)] = decode(b, hdr)
            q = expected_q(bands, hdr, b.compno, b)
            mine = _doubled(expected_q(low, hdr, b.compno, b,
                                       torch.bfloat16)) if control \
                else got[id(b)]
            enc_bad += block_mismatch(mine, q, b, hdr)
            enc_n += q.size
        if hdr.reversible:
            continue
        # every block of the windows' cones is decoded, so the windows'
        # samples are exact; the rest of the plane is not looked at
        rec = reconstruct(got, tile, hdr)
        if control:
            low_rec = reconstruct(got, tile, hdr, torch.bfloat16).numpy()
        for y0, y1, x0, x1 in wins:
            ref = rec[:, y0:y1, x0:x1].numpy()
            mine = low_rec[:, y0:y1, x0:x1] if control else planes_out[
                :, tile.y0 - hdr.y0 + y0:tile.y0 - hdr.y0 + y1,
                tile.x0 - hdr.x0 + x0:tile.x0 - hdr.x0 + x1]
            dec_bad += int(np.count_nonzero(ref != mine))
            dec_n += ref.size
    return enc_bad, enc_n, dec_bad, dec_n


def judge_window(frames, pool, params: dict, seed_seq, frames_judged: int,
                 windows: int, size: int, control: bool = False) -> dict:
    """The numbers compared, from the window's outputs.  `frames` is a list
    of (pool index, codestream, decoded array or None when the call
    failed); `params` the configuration's CompressParams keywords."""
    rng = np.random.default_rng(seed_seq)
    nums = {}
    firsts: dict[int, tuple] = {}
    repeat = 0
    for k, cs, out in frames:
        if cs is None or out is None:
            continue
        if k in firsts:
            cs0, out0 = firsts[k]
            repeat += int(cs != cs0 or not np.array_equal(out, out0))
        else:
            firsts[k] = (cs, out)
    nums["repeat_mismatch"] = repeat
    lossy = bool(params.get("irreversible"))
    if not lossy:
        nums["decode_mismatch"] = sum(
            int(np.count_nonzero(out != pool[k].reshape(out.shape)))
            for k, cs, out in frames if out is not None)
    rates = params.get("layer_rates") or []
    if lossy and rates:
        worst = 0.0
        for k, cs, out in frames:
            if cs is not None:
                worst = max(worst, cs_mod.packet_bytes(cs) * rates[-1]
                            / pool[k].nbytes)
        nums["rate_ratio"] = worst
    if lossy:
        nums["max_mse"] = max(
            (float(np.mean((out.astype(np.float64)
                            - pool[k].reshape(out.shape)) ** 2))
             for k, cs, out in frames if out is not None), default=0.0)
    done = [f for f in frames if f[1] is not None and f[2] is not None]
    picks = rng.choice(len(done), size=min(frames_judged, len(done)),
                       replace=False) if done else []
    enc = [0, 0]
    dec = [0, 0]
    for i in sorted(int(i) for i in picks):
        k, cs, out = done[i]
        eb, en, db, dn = judge_frame(pool[k], cs, out, rng, windows, size,
                                     control)
        enc[0] += eb
        enc[1] += en
        dec[0] += db
        dec[1] += dn
    nums["enc_mismatch"] = enc[0] / enc[1] if enc[1] else 1.0
    if lossy:
        nums["dec_mismatch"] = dec[0] / dec[1] if dec[1] else 1.0
    return nums
