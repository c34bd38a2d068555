"""PCRD rate control: pass-slope convex hulls + global threshold bisection.

Parity: TileProcessor::pcrdBisect* / RateControl (SURVEY.md §2.1 "Rate
control", B.8): per-codeblock candidate truncation points are pass ends on
the convex hull of (rate, distortion); a global slope threshold lambda picks
each block's contribution per layer; the threshold is bisected against the
layer's byte budget with a Tier-2 dry run to account for header overhead
("feasible" variant).  `-q` quality mode thresholds on distortion instead.

Hull points are plain tuples (passno, rate, dist, slope) — this runs once
per codeblock per tile, and object construction showed up at ~15% of
encode wall time as dataclasses.
"""

from __future__ import annotations

import math


def convex_hull(rates, dists) -> list[tuple]:
    """Feasible truncation points with strictly decreasing slopes.

    `rates`/`dists` are the cumulative per-pass byte counts and
    distortion decreases, already in image-MSE units (callers weight
    the dists by (Delta_b * norm_b * mct_norm)^2 up front — hull
    selection itself is weight-invariant).  Returns
    [(passno, rate, dist, slope), ...].
    """
    hull: list[tuple] = []
    base_r = 0
    base_d = 0.0
    for i, (rate, dist) in enumerate(zip(rates, dists)):
        while True:
            dr = rate - base_r
            dd = dist - base_d
            if dd <= 0:
                break  # no distortion gain: not a feasible truncation point
            slope = math.inf if dr <= 0 else dd / dr
            if hull and hull[-1][3] <= slope:
                hull.pop()  # previous point is dominated
                if hull:
                    base_r, base_d = hull[-1][1], hull[-1][2]
                else:
                    base_r, base_d = 0, 0.0
                continue
            hull.append((i, rate, dist, slope))
            base_r, base_d = rate, dist
            break
    return hull


def convex_hulls_flat(rates, dists, npasses):
    """convex_hull over many blocks at once, in the layout of the native
    whole-tile encoder's PCRD feed: `rates` (n, stride) cumulative pass
    rates, `dists` (n, stride) cumulative raw distortions, `npasses` (n,)
    the passes a block has.  Returns (hull_pass (n, stride) int32,
    hull_slope (n, stride) float64, hull_rate (n, stride) int32, hull_n
    (n,) int32), row k's first hull_n[k] entries convex_hull's points and
    slopes for block k, slope for slope.

    One step a pass column over the blocks that have it (a prefix once
    the blocks are sorted longest first); inside it, the blocks whose top
    point the new one dominates pop together until none does, with
    convex_hull's comparisons and float64 divisions.  Each block's top
    point is kept apart, its slope NaN on an empty hull, where nothing
    pops."""
    import numpy as np

    npasses = np.asarray(npasses, np.int64)
    n, stride = np.shape(rates)
    cols = int(npasses.max(initial=0))
    order = np.argsort(-npasses, kind="stable")
    live = np.bincount(npasses, minlength=cols + 1)[::-1].cumsum()[::-1]
    rates = np.asarray(rates)[order, :cols].astype(np.int64)
    dists = np.asarray(dists, np.float64)[order, :cols]
    hull_pass = np.zeros(n * stride, np.int32)
    hull_slope = np.zeros(n * stride, np.float64)
    hull_rate = np.zeros(n * stride, np.int32)
    hull_dist = np.zeros(n * stride, np.float64)
    row = order * stride            # a sorted block's first slot
    hn = np.zeros(n, np.int64)
    top_r = np.zeros(n, np.int64)
    top_d = np.zeros(n, np.float64)
    top_s = np.full(n, np.nan)
    pos = np.arange(n)
    # dd / 0 is inf where dd > 0, the only slopes read
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(cols):
            act = slice(0, live[i + 1])
            rate, dist = rates[act, i], dists[act, i]
            while True:
                ids = pos[act]
                dd = dist - top_d[act]
                slope = dd / np.maximum(rate - top_r[act], 0)
                gain = dd > 0
                pop = gain & (top_s[act] <= slope)
                push = gain & ~pop
                g = ids[push]
                at = row[g] + hn[g]
                hull_pass[at] = i
                hull_slope[at] = top_s[g] = slope[push]
                hull_rate[at] = top_r[g] = rate[push]
                hull_dist[at] = top_d[g] = dist[push]
                hn[g] += 1
                act = ids[pop]
                if not len(act):
                    break
                rate, dist = rate[pop], dist[pop]
                hn[act] -= 1
                at = row[act] + np.maximum(hn[act] - 1, 0)
                empty = hn[act] == 0
                top_r[act] = np.where(empty, 0, hull_rate[at])
                top_d[act] = np.where(empty, 0.0, hull_dist[at])
                top_s[act] = np.where(empty, np.nan, hull_slope[at])
    hull_n = np.empty(n, np.int32)
    hull_n[order] = hn
    return (hull_pass.reshape(n, stride), hull_slope.reshape(n, stride),
            hull_rate.reshape(n, stride), hull_n)


def passes_for_threshold(hull: list[tuple], lam: float) -> int:
    """Number of passes included when keeping hull slopes >= lam."""
    n = 0
    for pt in hull:
        if pt[3] >= lam:
            n = pt[0] + 1
        else:
            break
    return n


def candidate_slopes(hulls: list[list[tuple]]) -> list[float]:
    """All distinct finite hull slopes, descending."""
    s = {pt[3] for hull in hulls for pt in hull if math.isfinite(pt[3])}
    return sorted(s, reverse=True)


class HullIndex:
    """Vectorized per-tile view of all codeblock hulls.

    PCRD bisection evaluates O(log slopes) candidate thresholds; walking
    every hull in Python per candidate was ~15% of rate-targeted encode
    wall time.  This flattens all hulls into numpy arrays once so each
    candidate costs three vector ops: a >=-mask, a segment-sum
    (add.reduceat) and a gather."""

    def __init__(self, entries):
        import numpy as np

        self._np = np
        # entries mix two hull representations: tuples from convex_hull()
        # and hull=None meaning the native coder's array outputs live on
        # the codeblock (_hull_pass / _hull_slope_raw / _hull_weight)
        pass_chunks, rate_chunks, slope_chunks = [], [], []
        weights = []
        sizes = []
        for c, hull in entries:
            if hull is None:
                # native outputs: int32 pool views, raw slopes; the
                # weight is applied once on the concatenated vector
                hp = c._hull_pass
                sizes.append(len(hp))
                if len(hp):
                    pass_chunks.append(hp)
                    rate_chunks.append(c._hull_rate)
                    slope_chunks.append(c._hull_slope_raw)
                    weights.append(c._hull_weight)
            else:
                # tuple hulls carry RAW slopes (assign_layers hulls
                # unweighted distortions); same raw-slope x weight math
                sizes.append(len(hull))
                if hull:
                    pass_chunks.append(np.asarray(
                        [pt[0] for pt in hull], dtype=np.int32))
                    rate_chunks.append(np.asarray(
                        [pt[1] for pt in hull], dtype=np.int32))
                    slope_chunks.append(np.asarray(
                        [pt[3] for pt in hull], dtype=np.float64))
                    weights.append(getattr(c, "_hull_weight", 1.0))
        if pass_chunks:
            self.pass_at = np.concatenate(pass_chunks).astype(np.int64) + 1
            self.rate_at = np.concatenate(rate_chunks).astype(np.int64)
            wrep = np.repeat(np.asarray(weights, dtype=np.float64),
                             [len(ch) for ch in slope_chunks])
            self.slopes = np.concatenate(slope_chunks) * wrep
        else:
            self.pass_at = np.zeros(0, dtype=np.int64)
            self.rate_at = np.zeros(0, dtype=np.int64)
            self.slopes = np.zeros(0, dtype=np.float64)
        sizes_arr = np.asarray(sizes, dtype=np.int64)
        offsets = np.zeros(len(sizes) + 1, dtype=np.int64)
        np.cumsum(sizes_arr, out=offsets[1:])
        self.off = offsets[:-1]
        self.sizes = sizes_arr
        self.nonempty = self.sizes > 0

    @classmethod
    def from_flat(cls, hull_pass, hull_slope, hull_rate, hull_n, weights):
        """Build the index straight from the whole-tile native encoder's
        flat PCRD feed (grk_t1_encode_tile with need_dist): (ncb, stride)
        hull matrices with per-block point counts `hull_n` and per-block
        distortion weights — no per-codeblock objects touched."""
        import numpy as np

        self = cls.__new__(cls)
        self._np = np
        sizes = np.maximum(hull_n.astype(np.int64), 0)
        mask = np.arange(hull_pass.shape[1])[None, :] < sizes[:, None]
        self.pass_at = hull_pass[mask].astype(np.int64) + 1
        self.rate_at = hull_rate[mask].astype(np.int64)
        self.slopes = hull_slope[mask] * np.repeat(
            np.asarray(weights, dtype=np.float64), sizes)
        offsets = np.zeros(len(sizes) + 1, dtype=np.int64)
        np.cumsum(sizes, out=offsets[1:])
        self.off = offsets[:-1]
        self.sizes = sizes
        self.nonempty = sizes > 0
        return self

    def distinct_slopes(self) -> list[float]:
        """All distinct finite hull slopes, descending (the candidate
        thresholds PCRD bisects over)."""
        np = self._np
        s = self.slopes
        u = np.unique(s[np.isfinite(s)])
        return u[::-1].tolist()

    def counts_rates(self, lam: float):
        """Per-entry (passes included, cumulative body bytes) for slope
        threshold `lam` (hull slopes >= lam are kept)."""
        np = self._np
        nent = len(self.off)
        counts = np.zeros(nent, dtype=np.int64)
        rates = np.zeros(nent, dtype=np.int64)
        if len(self.slopes) == 0:
            return counts, rates
        mask = (self.slopes >= lam).astype(np.int64)
        ninc = np.zeros(nent, dtype=np.int64)
        ne = self.nonempty
        ninc[ne] = np.add.reduceat(mask, self.off[ne])
        # hull slopes are strictly decreasing per entry, so the included
        # points are a prefix: the last one is at off + ninc - 1
        has = ninc > 0
        idx = self.off[has] + ninc[has] - 1
        counts[has] = self.pass_at[idx]
        rates[has] = self.rate_at[idx]
        return counts, rates
