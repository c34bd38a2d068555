"""The port's boundaries: no jax, no grok_tpu, no hidden CPU fallback, no
silent build.

grok_tpu_torch imports torch and never jax (a machine with a GPU may have no
jax at all), and nothing of grok_tpu: it carries its own host modules and
builds its own copy of the native coder; by default it runs on the card,
and a CUDA device that is missing raises instead of moving work to the CPU;
a library that cannot be built raises with the reason; and only kernel
launches, never runs of the plain twins, count as launches.
"""

import ast
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from grok_tpu_torch import device as device_mod
from grok_tpu_torch.kernels import LAUNCHES, build, reset_launches
from grok_tpu_torch.ops import dwt, mct, pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = """
import json, sys
before = set(sys.modules)
import numpy as np
import grok_tpu_torch
from grok_tpu_torch import CompressParams, DecompressParams, GrkImage
rng = np.random.default_rng(0)
for arr, kw in ((rng.integers(0, 256, (64, 64, 3)).astype(np.uint8),
                 dict(ht=True)),
                (rng.integers(0, 256, (96, 80)).astype(np.uint8),
                 dict(tile_size=(32, 32), numresolution=3))):
    data = grok_tpu_torch.compress(GrkImage.from_array(arr),
                                   CompressParams(**kw), device="cpu")
    out = grok_tpu_torch.decompress(data, DecompressParams(), device="cpu")
    assert np.array_equal(out.to_array(), arr)
rgb = rng.integers(0, 256, (48, 40, 3)).astype(np.uint8)
lossy = grok_tpu_torch.compress(
    GrkImage.from_array(rgb), CompressParams(irreversible=True,
                                             layer_rates=[20]), device="cpu")
grok_tpu_torch.decompress(lossy, DecompressParams(), device="cpu")
print(json.dumps(sorted(m for m in set(sys.modules) - before
                        if m.split(".")[0] in ("jax", "jaxlib", "grok_tpu"))))
"""


def test_port_imports_no_jax():
    """A compress and decompress through the port (HT RGB, MQ gray in
    tiles, and lossy 9/7 RGB) loads no jax and no grok_tpu module."""
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


_NO_JAX_VARIANTS = """
import io, json, os, sys, tempfile
before = set(sys.modules)
import numpy as np
import grok_tpu_torch
from grok_tpu_torch import CompressParams, DecompressParams, GrkImage
from grok_tpu_torch.cli import (common, compare_dump_files, compare_images,
                                compare_raw_files, grk_compress,
                                grk_decompress, grk_dump, random_tile_access)
from grok_tpu_torch.image import ColorSpace
from grok_tpu_torch.io import formats, stripio
from grok_tpu_torch.parallel import distributed
from grok_tpu_torch.util import caches, color, icc
rng = np.random.default_rng(0)
arr = rng.integers(0, 256, (40, 36, 3)).astype(np.uint8)
img = GrkImage.from_array(arr)
p = CompressParams(tile_size=(16, 16), numresolution=3, ht=True, tlm=True)
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "s.j2k")
    planes = [c.data for c in img.comps]
    grok_tpu_torch.compress_strips_file(
        img, lambda y0, h: [pl[y0:y0 + h] for pl in planes], path, p,
        device="cpu")
    rows = [s for _, s in grok_tpu_torch.decompress_strips(
        open(path, "rb").read(), DecompressParams(), device="cpu")]
    assert np.array_equal(np.vstack([r[0] for r in rows]), arr[..., 0])
    out = grok_tpu_torch.decompress_file(path, DecompressParams(
        precision=[4, 4, 4], upsample=True), device="cpu")
    src, back = os.path.join(tmp, "g.pgm"), os.path.join(tmp, "b.pgm")
    with open(src, "wb") as f:
        f.write(b"P5\\n36 40\\n255\\n" + arr[..., 0].tobytes())
    for argv, tool in (([src, path + "2", "-n", "3"], grk_compress),
                       ([path + "2", back], grk_decompress)):
        assert tool.main(["-i", argv[0], "-o", argv[1], "--device", "cpu"]
                         + argv[2:]) == 0
    assert open(src, "rb").read() == open(back, "rb").read()
    assert grk_dump.main(["-i", path, "-o", os.path.join(tmp, "d")]) == 0
ycc = GrkImage.from_array(arr)
ycc.color_space = ColorSpace.SYCC
color.sycc_to_rgb(ycc)
print(json.dumps(sorted(m for m in set(sys.modules) - before
                        if m.split(".")[0] in ("jax", "jaxlib", "grok_tpu",
                                               "PIL"))))
"""


def test_variants_cli_and_color_import_no_jax_or_pillow():
    """The strip, file and stream variants, the CLI on PNM files, the
    colour post-processing and every new module of the port load no jax,
    no grok_tpu and no Pillow module."""
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_VARIANTS],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


_NO_JAX_MESH = """
import json, sys
before = set(sys.modules)
import numpy as np
import grok_tpu_torch
from grok_tpu_torch import CompressParams, DecompressParams, GrkImage
from grok_tpu_torch.parallel import mesh as pm
pm.dryrun_multichip(4, ["cpu"] * 4)
arr = np.random.default_rng(0).integers(0, 256, (64, 64, 3)).astype(np.uint8)
m = pm.make_mesh(4, dp=2, sp=2, devices=["cpu"] * 4)
for p in (dict(mesh=m, numresolution=3, ht=True),
          dict(mesh=2, irreversible=True, numresolution=3, ht=True)):
    data = grok_tpu_torch.compress(GrkImage.from_array(arr),
                                   CompressParams(**p), device="cpu")
    out = grok_tpu_torch.decompress(data, DecompressParams(mesh=p["mesh"]),
                                    device="cpu")
    assert out.to_array().shape == arr.shape
print(json.dumps(sorted(m for m in set(sys.modules) - before
                        if m.split(".")[0] in ("jax", "jaxlib", "grok_tpu"))))
"""


def test_mesh_path_imports_no_jax():
    """The mesh path on the CPU (the dry run; a dp x sp and an int mesh
    through compress and decompress on the twins) loads no jax and no
    grok_tpu module."""
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_MESH], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("where", ["checkout", "bare"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    """chip_smoke.py exits nonzero, printing no result line, where torch
    finds no CUDA device, in the checkout and alone in a directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if where == "bare":
        cwd = str(tmp_path)
        with open(script) as src, open(tmp_path / "chip_smoke.py", "w") as f:
            f.write(src.read())
        script = str(tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, script], cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _port_sources():
    """Every Python source of the port, and chip_smoke.py."""
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "grok_tpu_torch")):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return out


def _imported_packages(path):
    """Top-level packages a source imports (absolute imports only)."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module.split(".")[0]


def _imported_modules(path):
    """Absolute names of what a port source imports, at any depth,
    relative imports resolved: each module, and each name imported from
    one as a submodule."""
    pkg = os.path.relpath(os.path.dirname(path), ROOT).split(os.sep)
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = pkg[:len(pkg) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            yield mod
            yield from (f"{mod}.{a.name}" for a in node.names)


def test_tier1_seam_points_one_way():
    """The card's Tier-1 has one seam, tile -> t1 -> ops: the tile
    processor imports no ops module but pipeline (its transforms), and no
    module of t1/ imports anything of tile/."""
    port = os.path.join(ROOT, "grok_tpu_torch")
    ops = {m for m in _imported_modules(
        os.path.join(port, "tile", "processor.py"))
        if m.startswith("grok_tpu_torch.ops.")}
    assert ops == {"grok_tpu_torch.ops.pipeline"}
    t1 = os.path.join(port, "t1")
    for f in sorted(os.listdir(t1)):
        if f.endswith(".py"):
            bad = [m for m in _imported_modules(os.path.join(t1, f))
                   if m.split(".")[:2] == ["grok_tpu_torch", "tile"]]
            assert not bad, (f, bad)


def test_port_sources_do_not_import_jax():
    pkg = os.path.join(ROOT, "grok_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    text = fh.read()
                assert not re.search(r"^\s*(import|from)\s+jax\b", text,
                                     re.MULTILINE), f


def test_port_sources_do_not_import_grok_tpu():
    """No import statement of the port or of chip_smoke.py, at any depth,
    names grok_tpu or jax (grok_tpu_torch itself excepted)."""
    for path in _port_sources():
        bad = {m for m in _imported_packages(path)
               if m in ("grok_tpu", "jax", "jaxlib")}
        assert not bad, (path, bad)


def test_native_coder_is_the_ports_own():
    """The native host coder the port loads is its own build from
    native/, under build/grok_tpu_torch/, not grok_tpu's copy."""
    from grok_tpu_torch.t1 import native

    root = os.path.realpath(ROOT)
    lib = os.path.realpath(native._lib._name)
    assert lib == os.path.join(root, "build", "grok_tpu_torch",
                               "libgrk_t1.so")
    assert os.path.realpath(native.SRC_DIR) == os.path.join(root, "native")
    assert not lib.startswith(os.path.join(root, "grok_tpu") + os.sep)


def _fake_native_tree(tmp_path, monkeypatch, amalgam):
    from grok_tpu_torch.t1 import native

    src = tmp_path / "native"
    src.mkdir()
    for name in native._SOURCES:
        (src / name).write_text("")
    (src / "amalgam.cc").write_text(amalgam)
    monkeypatch.setattr(native, "SRC_DIR", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "LIB_PATH",
                        str(tmp_path / "build" / "libgrk_t1.so"))
    return native


def test_native_build_failure_raises_with_gxx_output(tmp_path, monkeypatch):
    native = _fake_native_tree(tmp_path, monkeypatch,
                               "int broken( { return 0; }\n")
    with pytest.raises(native.NativeBuildError, match="amalgam.cc"):
        native.build()
    assert not os.path.exists(native.LIB_PATH)


def test_native_build_runs_once_under_the_lock(tmp_path, monkeypatch):
    """Concurrent builders (the test workers) wait on the lock: one
    compiles, the others find the library fresh."""
    native = _fake_native_tree(tmp_path, monkeypatch, "")
    calls = []

    def fake_compile(out):
        calls.append(out)
        time.sleep(0.2)
        with open(out, "w") as f:
            f.write("lib")
        return ""

    monkeypatch.setattr(native, "_compile", fake_compile)
    threads = [threading.Thread(target=native.build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1
    assert os.path.exists(native.LIB_PATH)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build()
    # a fresh process with no library and no nvcc cannot load either
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "LIB_PATH", str(tmp_path / "missing.so"))
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.load()


def test_resolve_device_never_falls_back(monkeypatch):
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="cuda"):
            device_mod.resolve_device(dev)
    with pytest.raises(ValueError):
        device_mod.resolve_device("meta")


def test_device_codec_without_cuda_raises(monkeypatch):
    import grok_tpu_torch
    from grok_tpu_torch import CompressParams, GrkImage

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = GrkImage.from_array(np.zeros((16, 16), np.uint8))
    with pytest.raises(RuntimeError):
        grok_tpu_torch.compress(img, CompressParams(backend="device"))


def test_defaults_target_the_card(monkeypatch):
    """compress and decompress with nothing asked for run on the card:
    without CUDA they raise; the host route needs asking for."""
    import grok_tpu_torch
    from grok_tpu_torch import CompressParams, DecompressParams, GrkImage

    assert CompressParams().backend == "device"
    assert DecompressParams().backend == "device"
    img = GrkImage.from_array(np.zeros((16, 16), np.uint8))
    data = grok_tpu_torch.compress(img, CompressParams(backend="native"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        grok_tpu_torch.compress(img)
    with pytest.raises(RuntimeError, match="cuda"):
        grok_tpu_torch.decompress(data)


def test_variants_default_to_the_card(monkeypatch, tmp_path):
    """Every codec entry point runs on the card unless asked for the CPU:
    without CUDA each one raises instead of moving to the CPU."""
    import io

    import grok_tpu_torch
    from grok_tpu_torch import CompressParams, GrkImage

    arr = np.zeros((16, 16), np.uint8)
    img = GrkImage.from_array(arr)
    data = grok_tpu_torch.compress(img, CompressParams(backend="native"))
    path = tmp_path / "d.j2k"
    path.write_bytes(data)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: grok_tpu_torch.compress_strips(
            img, lambda y0, h: [arr[y0:y0 + h]]),
        lambda: grok_tpu_torch.compress_strips_file(
            img, lambda y0, h: [arr[y0:y0 + h]], str(tmp_path / "s.j2k")),
        lambda: grok_tpu_torch.compress_file(img, str(tmp_path / "f.j2k")),
        lambda: grok_tpu_torch.compress_stream(img, io.BytesIO()),
        lambda: list(grok_tpu_torch.decompress_strips(data)),
        lambda: grok_tpu_torch.decompress_file(str(path)),
        lambda: grok_tpu_torch.decompress_stream(io.BytesIO(data)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_cpu_defaults_launch_nothing():
    """device="cpu" with default parameters runs the plain twins: no
    launch, and no tile sent down the host path."""
    import grok_tpu_torch
    from grok_tpu_torch import GrkImage
    from grok_tpu_torch.tile.processor import HOST_PATH_TILES

    reset_launches()
    for k in HOST_PATH_TILES:
        HOST_PATH_TILES[k] = 0
    arr = np.arange(48 * 40 * 3, dtype=np.int64).reshape(48, 40, 3) % 256
    data = grok_tpu_torch.compress(GrkImage.from_array(arr), device="cpu")
    out = grok_tpu_torch.decompress(data, device="cpu")
    assert np.array_equal(out.to_array(), arr)
    assert all(v == 0 for v in LAUNCHES.values())
    assert HOST_PATH_TILES == {"encode": 0, "decode": 0}


def test_from_reference_rebuilds_the_ports_types():
    """params.from_reference carries grok_tpu's image and parameters over
    to the port's own classes, nested dataclasses and enums included."""
    from grok_tpu import image as ref_image
    from grok_tpu import params as ref_params
    from grok_tpu_torch import image as port_image
    from grok_tpu_torch import params as port_params

    poc = ref_params.ProgressionChange(0, 0, 1, 2, 3,
                                       ref_params.Progression.RLCP)
    p = port_params.from_reference(ref_params.CompressParams(
        prog_order=ref_params.Progression.CPRL, progression_changes=[poc],
        cblk_style=ref_params.CblkStyle.LAZY, tile_size=(32, 32)))
    assert type(p) is port_params.CompressParams
    assert p.prog_order is port_params.Progression.CPRL
    assert type(p.progression_changes[0]) is port_params.ProgressionChange
    assert p.progression_changes[0].prog is port_params.Progression.RLCP
    assert p.cblk_style == port_params.CblkStyle.LAZY
    assert p.tile_size == (32, 32) and p.backend == "auto"
    arr = np.arange(12, dtype=np.uint8).reshape(3, 4)
    img = port_params.from_reference(ref_image.GrkImage.from_array(arr))
    assert type(img) is port_image.GrkImage
    assert type(img.comps[0]) is port_image.ImageComponent
    assert img.color_space is port_image.ColorSpace.GRAY
    assert np.array_equal(img.to_array(), arr)


def test_device_backend_needs_the_native_coder(monkeypatch):
    """backend="device" codes its MQ and ragged HT codeblocks on the native
    host coder (the even HT ones on the device); where that coder does not
    load, the port raises instead of coding them in pure Python."""
    from grok_tpu_torch.tile import processor

    assert processor.host_backend("device") == "device"
    assert processor.t1_backend.resolve("device") == "native"
    assert processor.host_backend("python") == "python"
    monkeypatch.setattr(processor.t1_backend, "resolve", lambda b: "python")
    with pytest.raises(RuntimeError, match="native host coder"):
        processor.host_backend("device")
    assert processor.host_backend("native") == "native"


def test_cpu_runs_launch_nothing(rng):
    reset_launches()
    x = torch.from_numpy(rng.integers(0, 256, (3, 1, 16, 24)).astype(
        np.int32))
    bands = pipeline.analysis(x, numres=3, reversible=True, mct=1, prec=8,
                              sgnd=False)
    pipeline.synthesis({k: 2 * v for k, v in bands.items()}, numres=3,
                       reversible=True, mct=1, prec=8, sgnd=False,
                       shape=(16, 24))
    lossy = dict(numres=3, reversible=False, mct=1, prec=8, sgnd=False,
                 deltas=tuple((r, o, 0.5) for r in range(3)
                              for o in ((0,) if r == 0 else (1, 2, 3))))
    bands = pipeline.analysis(x, **lossy)
    pipeline.synthesis({k: 2 * v for k, v in bands.items()}, shape=(16, 24),
                       **lossy)
    assert set(LAUNCHES) == {"fwd53_level", "inv53_level",
                             "rct_forward_shift", "rct_inverse_unshift",
                             "fwd97_level", "inv97_level",
                             "ict_forward_shift", "ict_inverse_unshift",
                             "ht_encode", "ht_destuff", "ht_decode",
                             "ht_magsgn", "mq_encode", "mq_decode"}
    assert all(v == 0 for v in LAUNCHES.values())


def test_wrappers_check_their_input():
    x = torch.zeros((4, 4), dtype=torch.int64)
    with pytest.raises(TypeError):
        dwt.fwd_level(x)
    with pytest.raises(ValueError):
        dwt.fwd_level(torch.zeros(4, dtype=torch.int32))
    bands = dwt.fwd_level(x.to(torch.int32))
    with pytest.raises(ValueError):
        dwt.inv_level(*bands, 5, 4)
    with pytest.raises(ValueError, match="no kernel route"):
        mct.rct_forward_shift(*[torch.zeros((2, 2), dtype=torch.int32,
                                            device="meta")] * 3, 8, False)
    # the 9/7 wrappers: float32 levels, int32 bands where a step is given
    with pytest.raises(TypeError):
        dwt.fwd_level(x.to(torch.int32), False)
    f = dwt.fwd_level(x.to(torch.float32), False, (0.5, 0.5, 0.5, 0.5))
    with pytest.raises(TypeError):
        dwt.inv_level(*f, 4, 4, False)
    with pytest.raises(ValueError, match="steps"):
        dwt.fwd_level(x.to(torch.float32), False, (0.5, 0.5))
    with pytest.raises(TypeError):
        mct.ict_forward_shift(x.to(torch.float32), mct=1, prec=8,
                              sgnd=False)
    with pytest.raises(TypeError):
        mct.ict_inverse_unshift(x.to(torch.float32), mct=0, prec=8,
                                sgnd=False, step=0.5)
    with pytest.raises(ValueError, match="no kernel route"):
        mct.ict_forward_shift(torch.zeros((3, 2, 2), dtype=torch.int32,
                                          device="meta"), mct=1, prec=8,
                              sgnd=False)
