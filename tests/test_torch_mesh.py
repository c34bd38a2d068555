"""grok_tpu_torch.parallel.mesh against grok_tpu.parallel.mesh, on the CPU.

The port's meshes here repeat the CPU (one slot a thread of this process);
grok_tpu's are the 8 virtual CPU devices of tests/conftest.py.  Inputs are
made from a seed with numpy.  Tolerances: the 5/3 levels, the codestreams
and the lossless decodes are exact; the port's sharded 9/7 levels equal its
unsharded ones bit for bit, and grok_tpu's sp 9/7 within 5e-3 (its own
tolerance: its halo lifting reorders float additions, ROADMAP C2); the
summed energy within a relative 1e-5 (float32 sums in another order).  The
codec cases run Tier-1 on the native coder (the sharded transforms still
run on the mesh), one HT case on the twins' device route, and hold the
bytes to grok_tpu.compress on one device, which grok_tpu's own mesh tests
pin equal to its mesh bytes.
"""

import sys
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import grok_tpu  # noqa: E402
import grok_tpu_torch  # noqa: E402
from grok_tpu import CompressParams, DecompressParams, GrkImage  # noqa: E402
from grok_tpu.parallel import mesh as ref  # noqa: E402
from grok_tpu_torch import kernels  # noqa: E402
from grok_tpu_torch.ops import dwt, pipeline  # noqa: E402
from grok_tpu_torch.parallel import mesh as pm  # noqa: E402
from grok_tpu_torch.params import from_reference as port  # noqa: E402

C2_TOL = 5e-3
ENERGY_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs grok_tpu's 8 virtual CPU devices")


def _cpu_mesh(dp, sp):
    return pm.make_mesh(dp * sp, dp=dp, sp=sp, devices=["cpu"] * (dp * sp))


def _same_mesh(a, b):
    if a is None or b is None:
        return a is None and b is None
    return (pm.dp_size(a), pm.sp_size(a)) == (ref.dp_size(b), ref.sp_size(b))


# ----------------------------------------------------------- mesh answers

@pytest.mark.parametrize("sp", [1, 2, 4, 8])
def test_sizes_and_sp_transform_ok_match_reference(sp):
    dp = 8 // sp
    ours, theirs = _cpu_mesh(dp, sp), ref.make_mesh(8, dp=dp, sp=sp)
    assert (pm.dp_size(ours), pm.sp_size(ours)) == (
        ref.dp_size(theirs), ref.sp_size(theirs))
    for h in (1, 2, 8, 16, 48, 64, 96, 128, 250, 256, 512, 1024, 2048,
              2160):
        for numres in range(1, 8):
            assert pm.sp_transform_ok(ours, h, numres) == \
                ref.sp_transform_ok(theirs, h, numres), (h, numres)


@pytest.mark.parametrize("spec", [None, 0, 1, 2, 4, 8])
def test_resolve_mesh_matches_reference(spec):
    assert _same_mesh(pm.resolve_mesh(spec, "cpu"), ref.resolve_mesh(spec))


def test_resolve_mesh_passes_a_mesh_through():
    one, two = _cpu_mesh(1, 1), _cpu_mesh(1, 2)
    assert pm.resolve_mesh(one, "cpu") is None
    assert pm.resolve_mesh(two, "cpu") is two
    assert ref.resolve_mesh(ref.make_mesh(1)) is None
    for bad in ("2", 2.0, True):
        with pytest.raises(TypeError):
            pm.resolve_mesh(bad, "cpu")
    with pytest.raises(TypeError):
        ref.resolve_mesh("2")
    # an int spec repeats the CPU however large (the reference's virtual
    # devices): 9 slots
    assert pm.resolve_mesh(9, "cpu").shape == {"dp": 9, "sp": 1}
    with pytest.raises(ValueError):
        pm.make_mesh(4, dp=3, sp=2, devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        pm.Mesh([["cpu"], ["meta"]])


def test_cuda_mesh_without_a_card_raises(monkeypatch):
    """No fallback: a mesh on "cuda" needs CUDA; an int mesh needs that
    many visible cards (it never repeats a card); a mesh's devices are of
    the call's device type."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pm.resolve_mesh(2, "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        pm.make_mesh(2)
    img = port(GrkImage.from_array(np.zeros((16, 16), np.uint8)))
    for backend in ("device", "native"):
        with pytest.raises(RuntimeError, match="cuda"):
            grok_tpu_torch.compress(img, grok_tpu_torch.CompressParams(
                mesh=2, backend=backend))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 visible"):
        pm.resolve_mesh(2, "cuda")
    with pytest.raises(ValueError, match="cpu"):
        pm.resolve_mesh(_cpu_mesh(1, 2), "cuda")
    with pytest.raises(ValueError, match="cuda"):
        pm.resolve_mesh(pm.Mesh([["cuda:0", "cuda:0"]]), "cpu")


# ------------------------------------------------------------- sp levels

def _ints(rng, shape):
    return rng.integers(-1000, 1000, shape).astype(np.int32)


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_sp_53_levels_match_unsharded_and_reference(rng, sp):
    """At the deepest shard sp_transform_ok allows (8 rows), an odd width:
    the sharded forward and inverse 5/3 level equal the unsharded level
    and grok_tpu's sp level bit for bit."""
    x = _ints(rng, (3, 8 * sp, 37))
    m = ref.make_mesh(sp, dp=1, sp=sp)
    theirs = jax.jit(lambda a: ref.sp_sharded_fwd_53_level(m, a))(
        jnp.asarray(x))
    ours = pm.sp_sharded_fwd_53_level(_cpu_mesh(1, sp), torch.from_numpy(x))
    for o, u, t in zip(ours, dwt.fwd_level(torch.from_numpy(x)), theirs):
        assert torch.equal(o, u)
        assert np.array_equal(o.numpy(), np.asarray(t))
    back = pm.sp_sharded_inv_53_level(_cpu_mesh(1, sp), *ours)
    theirs_back = jax.jit(lambda *b: ref.sp_sharded_inv_53_level(m, *b))(
        *theirs)
    assert torch.equal(back, dwt.inv_level(*ours, 8 * sp, 37))
    assert np.array_equal(back.numpy(), np.asarray(theirs_back))
    assert np.array_equal(back.numpy(), x)


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("rows", [8, 12, 40])
@pytest.mark.parametrize("w", [1, 6, 37])
def test_sp_levels_at_many_heights(rng, sp, rows, w):
    """Every shard height from the deepest (8 local rows) up, widths odd
    and short: the 5/3 and 9/7 levels, with and without steps, bit for bit
    the unsharded ones (a crop off by a row shows here)."""
    mesh = _cpu_mesh(1, sp)
    h = rows * sp
    x = torch.from_numpy(_ints(rng, (2, h, w)))
    for o, u in zip(pm.sp_sharded_fwd_53_level(mesh, x), dwt.fwd_level(x)):
        assert torch.equal(o, u)
    bands = [torch.from_numpy(_ints(rng, tuple(b.shape)))
             for b in dwt.fwd_level(x)]
    assert torch.equal(pm.sp_sharded_inv_53_level(mesh, *bands),
                       dwt.inv_level(*bands, h, w))
    xf = x.to(torch.float32) * 0.37
    for steps in (None, (0.25, 0.5, 0.75, 1.5)):
        ours = pm.sp_sharded_fwd_97_level(mesh, xf, steps)
        for o, u in zip(ours, dwt.fwd_level(xf, False, steps)):
            assert torch.equal(o, u)
        q = [2 * b + torch.sign(b) if steps else b for b in ours]
        assert torch.equal(pm.sp_sharded_inv_97_level(mesh, *q, steps=steps),
                           dwt.inv_level(*q, h, w, False, steps))


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_sp_97_levels_within_c2_of_reference(rng, sp):
    x = _ints(rng, (3, 8 * sp, 37)).astype(np.float32)
    m = ref.make_mesh(sp, dp=1, sp=sp)
    theirs = jax.jit(lambda a: ref.sp_sharded_fwd_97_level(m, a))(
        jnp.asarray(x))
    ours = pm.sp_sharded_fwd_97_level(_cpu_mesh(1, sp), torch.from_numpy(x))
    for o, t in zip(ours, theirs):
        assert np.abs(o.numpy() - np.asarray(t)).max() < C2_TOL
    theirs_back = jax.jit(lambda *b: ref.sp_sharded_inv_97_level(m, *b))(
        *theirs)
    back = pm.sp_sharded_inv_97_level(_cpu_mesh(1, sp), *ours)
    assert np.abs(back.numpy() - np.asarray(theirs_back)).max() < C2_TOL


def test_sp_level_refuses_shards_too_small(rng):
    mesh = _cpu_mesh(1, 4)
    with pytest.raises(ValueError, match="rows"):
        pm.sp_sharded_fwd_97_level(mesh, torch.zeros(3, 8, 8))  # 2 a shard
    with pytest.raises(ValueError, match="split"):
        pm.sp_sharded_fwd_53_level(mesh, torch.zeros(3, 18, 8,
                                                     dtype=torch.int32))


# ------------------------------------------------ the sharded pipeline

def test_sharded_pipeline_matches_reference(rng):
    """tests/test_device_ops.py's dp=2 x sp=4 case at dp=2 x sp=2: bands
    and round trip exact, the summed energy within a relative 1e-5."""
    x = rng.integers(0, 256, size=(3, 4, 64, 64)).astype(np.int32)
    m = ref.make_mesh(4, dp=2, sp=2)
    kw = dict(numres=3, reversible=True, mct=1, prec=8, sgnd=False)
    theirs, energy_ref = jax.jit(
        lambda a: ref.sharded_analysis(m, a, **kw))(jnp.asarray(x))
    mesh = _cpu_mesh(2, 2)
    ours, energy = pm.sharded_analysis(mesh, torch.from_numpy(x), **kw)
    assert set(ours) == set(theirs)
    for k in ours:
        assert np.array_equal(ours[k].numpy(), np.asarray(theirs[k])), k
    assert energy.dtype == torch.float32
    assert abs(float(energy) - float(energy_ref)) \
        <= ENERGY_RTOL * float(energy_ref)
    doubled = {k: torch.sign(v) * (2 * torch.abs(v) + 1)
               for k, v in ours.items()}
    back = pm.sharded_synthesis(mesh, doubled, shape=(64, 64), **kw)
    theirs_back = jax.jit(lambda b: ref.sharded_synthesis(
        m, b, shape=(64, 64), **kw))(
        {k: jnp.asarray(v.numpy()) for k, v in doubled.items()})
    assert np.array_equal(back.numpy(), np.asarray(theirs_back))
    assert np.array_equal(back.numpy(), x)


_LOSSY = dict(numres=4, reversible=False, mct=1, prec=8, sgnd=False,
              deltas=tuple((r, o, 0.5 + 0.25 * r) for r in range(4)
                           for o in ((0,) if r == 0 else (1, 2, 3))))


@pytest.mark.parametrize("dp,sp", [(2, 1), (1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("kw", [dict(numres=4, reversible=True, mct=1,
                                     prec=8, sgnd=False), _LOSSY],
                         ids=["53", "97"])
def test_sharded_pipeline_equals_one_device(rng, dp, sp, kw):
    """Sharded analysis and synthesis (9/7 with its quantizer and
    dequantizer) equal the one pipeline on one device, bit for bit."""
    x = torch.from_numpy(rng.integers(0, 256, (3, 2 * dp, 64, 48)).astype(
        np.int32))
    mesh = _cpu_mesh(dp, sp)
    ours, _ = pm.sharded_analysis(mesh, x, **kw)
    one = pipeline.analysis(x, **kw)
    for k in one:
        assert torch.equal(ours[k], one[k]), k
    doubled = {k: 2 * v + torch.sign(v) for k, v in one.items()}
    assert torch.equal(
        pm.sharded_synthesis(mesh, doubled, shape=(64, 48), **kw),
        pipeline.synthesis(doubled, shape=(64, 48), **kw))


def test_sharded_pipeline_refuses_a_batch_that_does_not_split():
    mesh = _cpu_mesh(2, 2)
    kw = dict(numres=3, reversible=True, mct=0, prec=8, sgnd=False)
    with pytest.raises(ValueError, match="pad"):
        pm.sharded_analysis(mesh, torch.zeros(1, 3, 64, 64,
                                              dtype=torch.int32), **kw)
    with pytest.raises(ValueError, match="rows"):
        pm.sharded_analysis(mesh, torch.zeros(1, 2, 60, 64,
                                              dtype=torch.int32), **kw)


def test_a_slot_error_reaches_the_caller():
    """An error in one slot's thread is raised in the caller; its sp
    neighbours, waiting at the halo barrier, stop instead of hanging."""
    mesh = _cpu_mesh(1, 4)

    def body(d, s, halo):
        if s == 2:
            raise KeyError("slot 2")
        return halo.swap(s, (), ())

    with pytest.raises(KeyError, match="slot 2"):
        pm._run_slots(mesh, body)


def test_launch_counts_survive_threads():
    """The slots count kernel launches from threads of their own: no
    update may be lost (a short switch interval makes a race likely)."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        kernels.reset_launches()
        threads = [threading.Thread(target=lambda: [
            kernels.count_launch("fwd53_level") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert kernels.LAUNCHES["fwd53_level"] == 16 * 2000
    finally:
        sys.setswitchinterval(interval)
        kernels.reset_launches()


def test_dryrun_multichip_on_cpu_slots(capsys):
    pm.dryrun_multichip(8, ["cpu"] * 8)
    out = capsys.readouterr().out
    assert "dryrun_multichip OK: mesh dp=2 sp=4" in out
    assert "(dp=2, sp=4) mesh bit-exact both directions" in out


# ------------------------------------------------------------ the codec

def _rgb(rng, h, w):
    return rng.integers(0, 256, (h, w, 3)).astype(np.int32)


def _gray(rng, h, w):
    return rng.integers(0, 256, (h, w)).astype(np.int32)


# (image maker, compress parameters, mesh: (dp, sp) of a jax mesh carried
# across, or an int)
CODEC_CASES = {
    "dp": (lambda r: _rgb(r, 256, 256), dict(tile_size=(64, 64),
                                             numresolution=3), (8, 1)),
    "dp_x_sp": (lambda r: _rgb(r, 256, 256), dict(tile_size=(256, 128),
                                                  numresolution=3), (2, 4)),
    "sp_one_tile": (lambda r: _rgb(r, 256, 256), dict(numresolution=3),
                    (2, 4)),
    "int_8": (lambda r: _rgb(r, 128, 128), dict(tile_size=(64, 64),
                                                numresolution=3), 8),
    "batch_not_multiple_of_dp": (lambda r: _gray(r, 128, 192),
                                 dict(tile_size=(64, 64), numresolution=3),
                                 (8, 1)),
    "nonuniform_tiles": (lambda r: _rgb(r, 200, 168),
                         dict(tile_size=(64, 64), numresolution=3), (8, 1)),
    "sp_ineligible_height": (lambda r: _gray(r, 250, 256),
                             dict(numresolution=3), (2, 4)),
    "lossy_sp": (lambda r: _rgb(r, 256, 256),
                 dict(numresolution=3, irreversible=True), (2, 4)),
    "lossy_dp_x_sp_rates": (lambda r: _rgb(r, 128, 256),
                            dict(tile_size=(128, 128), numresolution=4,
                                 irreversible=True, layer_rates=[20]),
                            (2, 2)),
}


def _mesh_param(spec):
    return spec if isinstance(spec, int) else ref.make_mesh(
        spec[0] * spec[1], dp=spec[0], sp=spec[1])


@pytest.mark.parametrize("case", list(CODEC_CASES))
def test_codec_through_the_mesh(rng, case):
    """compress and decompress with a mesh (Tier-1 on the native coder)
    give grok_tpu.compress's bytes and decode as grok_tpu does: the input
    exactly, or (lossy) grok_tpu's own decode."""
    make, kw, spec = CODEC_CASES[case]
    arr = make(rng)
    img = GrkImage.from_array(arr, prec=8)
    theirs = grok_tpu.compress(img, CompressParams(backend="native", **kw))
    mesh = _mesh_param(spec)
    params = port(CompressParams(backend="native", mesh=mesh, **kw))
    assert isinstance(params.mesh, int) or isinstance(params.mesh, pm.Mesh)
    ours = grok_tpu_torch.compress(port(img), params, device="cpu")
    assert ours == theirs
    out = grok_tpu_torch.decompress(
        ours, port(DecompressParams(backend="native", mesh=mesh)),
        device="cpu").to_array()
    if kw.get("irreversible"):
        want = grok_tpu.decompress(
            theirs, DecompressParams(backend="native")).to_array()
    else:
        want = arr
    assert np.array_equal(out, want)


def test_codec_sp_case_runs_sharded(rng, monkeypatch):
    """A one-tile image on an sp mesh goes through the sharded analysis
    and synthesis (one call each), and an ineligible height through
    neither."""
    calls = []
    for name in ("sharded_analysis", "sharded_synthesis"):
        orig = getattr(pm, name)
        monkeypatch.setattr(pm, name, lambda *a, _o=orig, _n=name, **k: (
            calls.append(_n), _o(*a, **k))[1])
    mesh = _cpu_mesh(1, 2)
    for h, want in ((128, ["sharded_analysis", "sharded_synthesis"]),
                    (100, [])):
        calls.clear()
        arr = _gray(rng, h, 64)
        p = grok_tpu_torch.CompressParams(numresolution=3, backend="native",
                                          mesh=mesh)
        data = grok_tpu_torch.compress(port(GrkImage.from_array(arr,
                                                                prec=8)),
                                       p, device="cpu")
        out = grok_tpu_torch.decompress(data, grok_tpu_torch.DecompressParams(
            backend="native", mesh=mesh), device="cpu")
        assert np.array_equal(out.comps[0].data, arr)
        assert calls == want, h


def test_ht_device_route_through_the_mesh(rng):
    """HT on the twins' device route (device="cpu") with an sp mesh: the
    transforms shard, Tier-1 runs as it does on one device."""
    arr = _rgb(rng, 128, 96)
    img = GrkImage.from_array(arr)
    kw = dict(numresolution=3, ht=True)
    theirs = grok_tpu.compress(img, CompressParams(backend="native", **kw))
    mesh = ref.make_mesh(4, dp=2, sp=2)
    ours = grok_tpu_torch.compress(
        port(img), port(CompressParams(backend="device", mesh=mesh, **kw)),
        device="cpu")
    assert ours == theirs
    out = grok_tpu_torch.decompress(
        ours, port(DecompressParams(backend="device", mesh=mesh)),
        device="cpu")
    assert np.array_equal(out.to_array(), arr)


def test_strip_encode_through_the_mesh(rng):
    """compress_strips with a mesh: each tile row's tiles through one
    sharded analysis, grok_tpu.compress's bytes."""
    arr = _rgb(rng, 256, 256)
    img = GrkImage.from_array(arr)
    kw = dict(tile_size=(64, 64), numresolution=3)
    theirs = grok_tpu.compress(img, CompressParams(backend="native", **kw))
    meta = port(GrkImage(x0=img.x0, y0=img.y0, x1=img.x1, y1=img.y1))
    meta.color_space = port(img.color_space)
    for c in port(img).comps:
        c.data = None
        meta.comps.append(c)
    planes = [c.data for c in img.comps]
    ours = grok_tpu_torch.compress_strips(
        meta, lambda y0, h: [pl[y0:y0 + h] for pl in planes],
        port(CompressParams(backend="native",
                            mesh=ref.make_mesh(8, dp=8, sp=1), **kw)),
        device="cpu")
    assert ours == theirs
