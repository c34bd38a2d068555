"""Sharding of the codec's sample transforms over several devices: the
port of grok_tpu/parallel/mesh.py.

A Mesh is a (dp, sp) grid of torch devices driven by this one process,
as grok_tpu's mesh is one controller over jax.devices():

- **dp** (tile data parallel): a (C, B, H, W) tile batch splits along B,
  one part a dp slot, and every part runs the one pipeline
  (ops/pipeline.py) on its slot's device;
- **sp** (rows of one tile): each part also splits its rows over the sp
  slots of its dp row, so that one oversized tile uses the whole mesh.
  Every DWT level then takes halo rows from the neighbouring shards, runs
  the ordinary level (ops/dwt.py: on a card the level kernel, on the CPU
  its plain twin) on the shard widened by them, and drops the outputs of
  the halo rows.  The first and last shards take no halo at the tile's
  edges, where the level's own symmetric extension is the single-device
  one; elsewhere every row the level's edge extension can reach is a halo
  row, so the kept rows are those of the whole tile, bit for bit.

Every slot runs in a thread of its own (the reference's shard_map): the
halo rows of an sp row of slots meet at a barrier and move with
`Tensor.to(device, non_blocking=True)`, a peer copy between cards that
is ordered on both devices' current streams.  No slot takes a side
stream.  A mesh may repeat a device (a Mesh the caller built, never an
int spec): its slots then run in turn on that device, and no copy moves.
Tier-1 and Tier-2 stay where the codec runs them.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..device import resolve_device
from ..ops import dwt as ddwt
from ..ops import pipeline

# halo widths: sample rows of a forward level, band rows of an inverse one
_FWD_HALO = {True: 2, False: 4}
_INV_HALO = {True: 1, False: 2}


class Mesh:
    """A (dp, sp) grid of torch devices, all of one type.  `devices`: dp
    rows of sp devices each."""

    def __init__(self, devices):
        rows = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh needs dp rows of sp devices each")
        types = {d.type for row in rows for d in row}
        if len(types) != 1 or not types <= {"cpu", "cuda"}:
            raise ValueError(f"a mesh's devices are all cpu or all cuda, "
                             f"got {sorted(types)}")
        self.devices = rows
        self.shape = {"dp": len(rows), "sp": len(rows[0])}

    @property
    def size(self) -> int:
        return self.shape["dp"] * self.shape["sp"]

    @property
    def device_type(self) -> str:
        return self.devices[0][0].type

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, "
                f"devices={[[str(d) for d in r] for r in self.devices]})")


def _visible_cards() -> list[torch.device]:
    resolve_device("cuda")  # raises where there is no CUDA device
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              sp: int | None = None, devices=None) -> Mesh:
    """A mesh over the first `n_devices` of `devices` (default: the visible
    CUDA devices, all of them unless `n_devices`), dp x sp of them; with
    dp or sp not given, all on the dp axis."""
    devs = list(_visible_cards() if devices is None else devices)
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"{n} devices requested but only {len(devs)} "
                         "given or visible")
    devs = devs[:n]
    if dp is None or sp is None:
        dp, sp = n, 1
    if dp * sp != n:
        raise ValueError(f"dp {dp} x sp {sp} is not {n} devices")
    return Mesh([devs[i * sp:(i + 1) * sp] for i in range(dp)])


def resolve_mesh(spec, device) -> Mesh | None:
    """Resolve the public `mesh` parameter (CompressParams.mesh,
    DecompressParams.mesh) for a codec call on `device`: a Mesh passes
    through (its devices of `device`'s type), an int builds a dp mesh:
    over the visible CUDA devices, which must be that many, or with
    device "cpu" over the CPU repeated.  None where the spec describes a
    single slot."""
    if spec is None:
        return None
    dev = resolve_device(device)
    if isinstance(spec, Mesh):
        if spec.device_type != dev.type:
            raise ValueError(f"the mesh's devices are {spec.device_type}, "
                             f"the call's device is {dev}")
        return spec if spec.size > 1 else None
    if isinstance(spec, int) and not isinstance(spec, bool):
        if spec <= 1:
            return None
        if dev.type == "cpu":
            return make_mesh(spec, devices=[dev] * spec)
        cards = _visible_cards()
        if spec > len(cards):
            raise ValueError(f"mesh={spec} devices requested but only "
                             f"{len(cards)} visible")
        return make_mesh(spec, devices=cards)
    raise TypeError(f"mesh must be a Mesh or int, got {type(spec)!r}")


def dp_size(mesh: Mesh) -> int:
    return mesh.shape.get("dp", 1)


def sp_size(mesh: Mesh) -> int:
    return mesh.shape.get("sp", 1)


def sp_transform_ok(mesh: Mesh, h: int, numres: int) -> bool:
    """Whether a tile of height `h` can row-shard its `numres`-level
    transform over the mesh's 'sp' axis: every DWT level needs each
    shard's rows even-aligned and even-counted, and enough local rows at
    the deepest level to source the 4-row 9/7 halos."""
    sp = sp_size(mesh)
    if sp == 1:
        return True
    nl = numres - 1
    if nl <= 0:
        return h % sp == 0 and h // sp >= 1
    return h % (sp << nl) == 0 and (h >> nl) // sp >= 8


# ---------------------------------------------------------------------------
# the slots' threads and the halo exchange
# ---------------------------------------------------------------------------

def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    # a copy to the host waits for the data; one between cards is ordered
    # on both devices' current streams
    return t.to(device, non_blocking=device.type == "cuda")


class _Halo:
    """The halo exchange of one dp row of the mesh's slots."""

    def __init__(self, devices):
        self.devices = devices
        self._barrier = threading.Barrier(len(devices))
        self._posted = [None] * len(devices)

    def swap(self, i: int, first: tuple, last: tuple):
        """Post shard i's first and last rows (tuples of tensors) and take
        the previous shard's last rows and the next shard's first rows
        onto shard i's device: (above, below), None at the tile's
        edges."""
        self._posted[i] = (first, last)
        self._barrier.wait()
        dev = self.devices[i]
        above = below = None
        if i > 0:
            above = tuple(_to(t, dev) for t in self._posted[i - 1][1])
        if i < len(self.devices) - 1:
            below = tuple(_to(t, dev) for t in self._posted[i + 1][0])
        self._barrier.wait()  # every shard took its rows: the next swap
        return above, below   # may post

    def abort(self) -> None:
        self._barrier.abort()


def _run_slots(mesh: Mesh, body):
    """body(d, s, halo) on every slot (d, s) of the mesh, each in a thread
    of its own; returns the results as [d][s], or raises the first
    slot's error (the other slots of its dp row stop at their next
    swap)."""
    dp, sp = dp_size(mesh), sp_size(mesh)
    halos = [_Halo(row) for row in mesh.devices]
    out = [[None] * sp for _ in range(dp)]
    errors = []

    def run(d, s):
        try:
            out[d][s] = body(d, s, halos[d])
        except Exception as e:  # re-raised below, in the caller's thread
            errors.append(e)
            halos[d].abort()

    threads = [threading.Thread(target=run, args=(d, s), daemon=True)
               for d in range(dp) for s in range(sp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise next((e for e in errors
                    if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])
    return out


# ---------------------------------------------------------------------------
# sp: one DWT level on a row shard
# ---------------------------------------------------------------------------

def _widen(t, above, below, j: int) -> torch.Tensor:
    return torch.cat([*(() if above is None else (above[j],)), t,
                      *(() if below is None else (below[j],))], dim=-2)


def _fwd_level_local(x, reversible, steps, *, halo: _Halo, i: int):
    """fwd_level on row shard i of a level's input: the shard widened by
    its neighbours' rows, then the outputs of those rows dropped."""
    k = _FWD_HALO[reversible]
    if x.shape[-2] % 2 or x.shape[-2] < k:
        raise ValueError(f"a row shard of {x.shape[-2]} rows: a forward "
                         f"level needs an even count of {k} or more")
    above, below = halo.swap(i, (x[..., :k, :],), (x[..., -k:, :],))
    bands = ddwt.fwd_level(_widen(x, above, below, 0).contiguous(),
                           reversible, steps)
    top = 0 if above is None else k // 2
    m = x.shape[-2] // 2
    return tuple(b[..., top:top + m, :].contiguous() for b in bands)


def _inv_level_local(ll, hl, lh, hh, h, w, reversible, steps, *,
                     halo: _Halo, i: int):
    """inv_level on row shard i of a level's bands (`h`, the whole
    level's height, is implied by the shard): each band widened by its
    neighbours' band rows, then the output rows of those dropped."""
    q = _INV_HALO[reversible]
    if ll.shape[-2] < q:
        raise ValueError(f"a row shard of {ll.shape[-2]} band rows: an "
                         f"inverse level needs {q} or more")
    bands = (ll, hl, lh, hh)
    above, below = halo.swap(i, tuple(b[..., :q, :] for b in bands),
                             tuple(b[..., -q:, :] for b in bands))
    wide = [_widen(b, above, below, j).contiguous()
            for j, b in enumerate(bands)]
    out = ddwt.inv_level(*wide, 2 * wide[0].shape[-2], w, reversible, steps)
    top = 0 if above is None else 2 * q
    return out[..., top:top + 2 * ll.shape[-2], :].contiguous()


def _sp_forward_dwt(halo: _Halo, i: int):
    """forward_dwt_batch on row shard i, with halo-exchange levels: the
    `dwt` hook of ops.pipeline.analysis."""
    def fwd(x, numres, reversible=True, deltas=None):
        return ddwt.forward_dwt_batch(
            x, numres, reversible, deltas,
            fwd=lambda *a: _fwd_level_local(*a, halo=halo, i=i))
    return fwd


def _sp_inverse_dwt(halo: _Halo, i: int):
    """inverse_dwt_batch on row-sharded bands: the `dwt` hook of
    ops.pipeline.synthesis (`shape` is the whole tile's)."""
    def inv(bands, numres, shape, reversible=True, deltas=None):
        return ddwt.inverse_dwt_batch(
            bands, numres, shape, reversible, deltas,
            inv=lambda *a: _inv_level_local(*a, halo=halo, i=i))
    return inv


# ---------------------------------------------------------------------------
# scattering and gathering (C, B, H, W) batches
# ---------------------------------------------------------------------------

def _check_split(mesh: Mesh, b: int, h: int, numres: int) -> None:
    """A batch of b tiles of height h splits over dp, and the rows of
    every level of numres over sp."""
    if b % dp_size(mesh):
        raise ValueError(f"a batch of {b} tiles does not split over "
                         f"dp={dp_size(mesh)}: pad it to a multiple")
    if h % (sp_size(mesh) << max(numres - 1, 0)):
        raise ValueError(f"{h} rows do not split over sp={sp_size(mesh)} "
                         f"at each of {numres} resolutions")


def _part(t: torch.Tensor, mesh: Mesh, d: int, s: int) -> torch.Tensor:
    """Slot (d, s)'s part of a (C, B, h, w) tensor, on its device."""
    nb = t.shape[1] // dp_size(mesh)
    nh = t.shape[-2] // sp_size(mesh)
    return _to(t[:, d * nb:(d + 1) * nb, s * nh:(s + 1) * nh].contiguous(),
               mesh.devices[d][s])


def _gather(parts, device: torch.device) -> torch.Tensor:
    """The (C, B, h, w) tensor of the slots' parts [d][s] on `device`."""
    return torch.cat([torch.cat([_to(p, device) for p in row], dim=-2)
                      for row in parts], dim=1)


def sharded_analysis(mesh: Mesh, planes: torch.Tensor, *, numres: int,
                     reversible: bool, mct: int, prec: int, sgnd: bool,
                     deltas=()):
    """ops.pipeline.analysis with the tile-batch axis sharded over the
    mesh's 'dp' axis and, when the mesh has sp > 1, tile rows over 'sp'
    with the halo-exchange DWT.  planes: (C, B, H, W) int32 with B a
    multiple of dp and, for sp > 1, H splitting evenly over sp at every
    level into shards no shorter than the halos (sp_transform_ok is the
    codec's stricter test).
    Returns (bands, energy) on planes' device: the bands as analysis
    gives them, and the float32 sum of their squares over every shard
    (the reference's psum'd distortion statistic)."""
    _check_split(mesh, planes.shape[1], planes.shape[-2], numres)
    sp = sp_size(mesh)

    def body(d, s, halo):
        bands = pipeline.analysis(
            _part(planes, mesh, d, s), numres=numres,
            reversible=reversible, mct=mct, prec=prec, sgnd=sgnd,
            deltas=deltas, dwt=_sp_forward_dwt(halo, s) if sp > 1 else None)
        energy = sum((b.to(torch.float32) ** 2).sum()
                     for b in bands.values())
        return bands, energy

    parts = _run_slots(mesh, body)
    dev = planes.device
    bands = {k: _gather([[p[0][k] for p in row] for row in parts], dev)
             for k in parts[0][0][0]}
    energy = sum(_to(p[1], dev) for row in parts for p in row)
    return bands, energy


def sharded_synthesis(mesh: Mesh, bands: dict, *, numres: int,
                      reversible: bool, mct: int, prec: int, sgnd: bool,
                      shape, deltas=()) -> torch.Tensor:
    """ops.pipeline.synthesis sharded as sharded_analysis: bands
    {(resno, orient): (C, B, h, w)} with B a multiple of dp; returns the
    (C, B, H, W) samples on the bands' device."""
    first = bands[(0, 0)]
    _check_split(mesh, first.shape[1], shape[0], numres)
    sp = sp_size(mesh)

    def body(d, s, halo):
        return pipeline.synthesis(
            {k: _part(v, mesh, d, s) for k, v in bands.items()},
            numres=numres, reversible=reversible, mct=mct, prec=prec,
            sgnd=sgnd, shape=tuple(shape), deltas=deltas,
            dwt=_sp_inverse_dwt(halo, s) if sp > 1 else None)

    return _gather(_run_slots(mesh, body), first.device)


# ---------------------------------------------------------------------------
# sp: the level API on row-sharded tensors
# ---------------------------------------------------------------------------

def _sp_level(mesh: Mesh, tensors, local):
    """local(shards..., halo=, i=) on the rows of `tensors` (..., rows, w)
    split over the mesh's first sp row of slots; the results gathered
    back onto the first tensor's device."""
    sp = sp_size(mesh)
    devs = mesh.devices[0]
    rows = tensors[0].shape[-2]
    if rows % sp:
        raise ValueError(f"{rows} rows do not split over sp={sp}")
    n = rows // sp

    def body(_, s, halo):
        shards = [_to(t[..., s * n:(s + 1) * n, :].contiguous(), devs[s])
                  for t in tensors]
        return local(*shards, halo=halo, i=s)

    out = _run_slots(Mesh([devs]), body)[0]
    dev = tensors[0].device
    if isinstance(out[0], tuple):
        return tuple(torch.cat([_to(o[j], dev) for o in out], dim=-2)
                     for j in range(len(out[0])))
    return torch.cat([_to(o, dev) for o in out], dim=-2)


def _sp_fwd(mesh, x, reversible, steps):
    return _sp_level(mesh, (x,),
                     lambda x, halo, i: _fwd_level_local(
                         x, reversible, steps, halo=halo, i=i))


def _sp_inv(mesh, ll, hl, lh, hh, reversible, steps):
    w = ll.shape[-1] + hl.shape[-1]
    return _sp_level(mesh, (ll, hl, lh, hh),
                     lambda *b, halo, i: _inv_level_local(
                         *b, None, w, reversible, steps, halo=halo, i=i))


def sp_sharded_fwd_53_level(mesh: Mesh, x: torch.Tensor):
    """One forward 5/3 level of (..., H, W) int32 with rows sharded over
    the mesh's 'sp' axis (its first dp row of slots), halo-exchange
    lifting: (ll, hl, lh, hh) on x's device, those of ops.dwt.fwd_level
    bit for bit."""
    return _sp_fwd(mesh, x, True, None)


def sp_sharded_inv_53_level(mesh: Mesh, ll, hl, lh, hh) -> torch.Tensor:
    """One inverse 5/3 level with rows sharded over 'sp': the inverse of
    sp_sharded_fwd_53_level, ops.dwt.inv_level's output bit for bit."""
    return _sp_inv(mesh, ll, hl, lh, hh, True, None)


def sp_sharded_fwd_97_level(mesh: Mesh, x: torch.Tensor, steps=None):
    """One forward 9/7 level of (..., H, W) float32 with rows sharded over
    'sp'; `steps` as for ops.dwt.fwd_level.  Bit for bit its output."""
    return _sp_fwd(mesh, x, False, steps)


def sp_sharded_inv_97_level(mesh: Mesh, ll, hl, lh, hh,
                            steps=None) -> torch.Tensor:
    """One inverse 9/7 level with rows sharded over 'sp'; `steps` as for
    ops.dwt.inv_level.  Bit for bit its output."""
    return _sp_inv(mesh, ll, hl, lh, hh, False, steps)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Build a (dp, sp) mesh over `n_devices` slots of `devices` (default:
    the visible CUDA devices) and run one full codec device step on it:
    the tile batch sharded over dp (analysis and synthesis round trip and
    the summed energy), one tile's rows sharded over sp (5/3 and 9/7
    levels with halo exchange, against a single device), and compress
    and decompress through the mesh against a single device.  The twin
    of grok_tpu's __graft_entry__ dry run, step for step; prints one
    line."""
    import grok_tpu_torch
    from grok_tpu_torch import CompressParams, DecompressParams, GrkImage

    devs = list(_visible_cards() if devices is None else devices)
    if len(devs) < n_devices:
        raise ValueError(f"{n_devices} device slots requested, "
                         f"{len(devs)} given or visible")
    devs = [torch.device(d) for d in devs[:n_devices]]
    sp = next((c for c in (4, 2) if n_devices % c == 0), 1)
    dp = n_devices // sp
    mesh = make_mesh(n_devices, dp=dp, sp=sp, devices=devs)
    dev = devs[0]
    rng = np.random.default_rng(1)

    # ---- dp: tile-batch-sharded analysis + synthesis round trip ----
    b = dp * 2
    x = rng.integers(0, 256, size=(3, b, 64, 64), dtype=np.int32)
    bands, energy = sharded_analysis(
        mesh, torch.from_numpy(x).to(dev), numres=3, reversible=True,
        mct=1, prec=8, sgnd=False)
    doubled = {k: torch.sign(v) * (2 * torch.abs(v) + 1)
               for k, v in bands.items()}
    back = sharded_synthesis(mesh, doubled, numres=3, reversible=True,
                             mct=1, prec=8, sgnd=False, shape=(64, 64))
    if not np.array_equal(back.cpu().numpy(), x):
        raise AssertionError("dp-sharded round trip mismatch")
    if not torch.isfinite(energy):
        raise AssertionError("dp-sharded energy not finite")

    # ---- sp: row-sharded single-tile DWT levels with halo exchange ----
    big = torch.from_numpy(rng.integers(-1000, 1000, size=(sp * 32, 128))
                           .astype(np.int32)).to(dev)
    got = sp_sharded_fwd_53_level(mesh, big)
    if not all(torch.equal(g, r) for g, r in zip(got,
                                                 ddwt.fwd_level(big))):
        raise AssertionError("sp-sharded DWT level mismatch")
    if not torch.equal(sp_sharded_inv_53_level(mesh, *got), big):
        raise AssertionError("sp-sharded 5/3 inverse round trip mismatch")
    bigf = big.to(torch.float32)
    got = sp_sharded_fwd_97_level(mesh, bigf)
    if not all(torch.equal(g, r)
               for g, r in zip(got, ddwt.fwd_level(bigf, False))):
        raise AssertionError("sp-sharded 9/7 level mismatch")
    if (sp_sharded_inv_97_level(mesh, *got) - bigf).abs().max() >= 2e-2:
        raise AssertionError("sp-sharded 9/7 inverse round trip mismatch")

    # ---- the public API through the mesh (Tier-1 on the host coder, as
    # grok_tpu's default backend) ----
    arr = rng.integers(0, 256, size=(256, 256, 3)).astype(np.int32)
    dp_mesh = make_mesh(n_devices, dp=n_devices, sp=1, devices=devs)
    cpar = dict(tile_size=(64, 64), numresolution=3, tlm=True, plt=True,
                backend="native")
    data_mesh = grok_tpu_torch.compress(
        GrkImage.from_array(arr), CompressParams(mesh=dp_mesh, **cpar),
        device=dev.type)
    data_one = grok_tpu_torch.compress(
        GrkImage.from_array(arr), CompressParams(**cpar), device=dev.type)
    if data_mesh != data_one:
        raise AssertionError("mesh-sharded encode differs from "
                             "single-device encode")
    out = grok_tpu_torch.decompress(
        data_one, DecompressParams(mesh=dp_mesh, backend="native"),
        device=dev.type)
    if not np.array_equal(out.to_array(), arr):
        raise AssertionError("mesh-sharded decode not bit-exact")

    # ---- the public API's sp path: ONE oversized tile ----
    sp_ok = ""
    if sp > 1:
        kw = dict(numresolution=3, backend="native")
        one = grok_tpu_torch.compress(GrkImage.from_array(arr),
                                      CompressParams(**kw), device=dev.type)
        many = grok_tpu_torch.compress(
            GrkImage.from_array(arr), CompressParams(mesh=mesh, **kw),
            device=dev.type)
        if one != many:
            raise AssertionError("sp-sharded single-tile encode differs "
                                 "from single-device")
        out = grok_tpu_torch.decompress(
            one, DecompressParams(mesh=mesh, backend="native"),
            device=dev.type)
        if not np.array_equal(out.to_array(), arr):
            raise AssertionError("sp-sharded single-tile decode not "
                                 "bit-exact")
        sp_ok = (f"; public-API single-tile codec through the (dp={dp}, "
                 f"sp={sp}) mesh bit-exact both directions")

    print(f"dryrun_multichip OK: mesh dp={dp} sp={sp} over "
          f"{[str(d) for d in devs]}, dp round-trip bit-exact, sp "
          f"halo-exchange 5/3 and 9/7 levels bit-exact to one device and "
          f"their inverses round-trip, summed energy={float(energy):.3e}; "
          f"public-API codec encode+decode through the dp={n_devices} mesh "
          f"bit-exact vs single-device" + sp_ok, flush=True)
