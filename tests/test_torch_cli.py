"""The port's command-line tools against grok_tpu's, in process.

Each port CLI runs with `--device cpu` (the kernels' plain twins; its
default `--device cuda` needs a card), grok_tpu's with its defaults (its
native host path), on the same input files: the same codestream bytes,
the same decoded files, the same grk_dump text and the same exit codes,
in single-file and batch mode, through PGX, raw and PNM (and PNG where
Pillow is present), streamed (--stream-strips, the strip writer) and
whole; random_tile_access and the compare tools behave alike; --profile
writes a torch.profiler trace; without a card the default device is an
error, not a quiet run on the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from grok_tpu.cli import compare_dump_files as ref_cmp_dump  # noqa: E402
from grok_tpu.cli import compare_images as ref_cmp_img  # noqa: E402
from grok_tpu.cli import compare_raw_files as ref_cmp_raw  # noqa: E402
from grok_tpu.cli import grk_compress as ref_comp  # noqa: E402
from grok_tpu.cli import grk_decompress as ref_decomp  # noqa: E402
from grok_tpu.cli import grk_dump as ref_dump  # noqa: E402
from grok_tpu.cli import random_tile_access as ref_rta  # noqa: E402
from grok_tpu_torch.cli import compare_dump_files as cmp_dump  # noqa: E402
from grok_tpu_torch.cli import compare_images as cmp_img  # noqa: E402
from grok_tpu_torch.cli import compare_raw_files as cmp_raw  # noqa: E402
from grok_tpu_torch.cli import grk_compress, grk_decompress  # noqa: E402
from grok_tpu_torch.cli import grk_dump, random_tile_access  # noqa: E402

CPU = ["--device", "cpu"]


def _pnm(path, arr, maxval=255):
    """Binary PGM/PPM, big-endian above 8 bits."""
    magic = b"P6" if arr.ndim == 3 else b"P5"
    body = arr.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    path.write_bytes(magic + f"\n{arr.shape[1]} {arr.shape[0]}\n"
                     f"{maxval}\n".encode() + body)


@pytest.fixture
def rgb(rng):
    yy, xx = np.mgrid[0:40, 0:48].astype(float)
    base = 128 + 80 * np.sin(xx / 11) * np.cos(yy / 7)
    arr = np.stack([base, xx * 4, yy * 5], axis=-1)
    return (arr + rng.normal(0, 4, arr.shape)).clip(0, 255).astype(np.uint8)


def _compress_both(tmp_path, src, flags, ext=".j2k"):
    """grok_tpu's grk_compress and the port's on `src`: both exit 0 and
    write the same bytes.  Returns the port's output path."""
    theirs = tmp_path / f"ref{ext}"
    ours = tmp_path / f"ours{ext}"
    assert ref_comp.main(["-i", str(src), "-o", str(theirs)] + flags) == 0
    assert grk_compress.main(["-i", str(src), "-o", str(ours)] + flags
                             + CPU) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    return ours


def _written(tmp_path, stem):
    """The files a decode to `stem` wrote (PGX writes one a component),
    by the part of their names after the stem."""
    return {f[len(stem):]: (tmp_path / f).read_bytes()
            for f in sorted(os.listdir(tmp_path)) if f.startswith(stem)}


def _decompress_both(tmp_path, src, ext, flags=()):
    """grok_tpu's grk_decompress and the port's: both exit 0 and write the
    same files.  Returns the port's output path."""
    theirs = tmp_path / f"back_ref{ext}"
    ours = tmp_path / f"back_ours{ext}"
    assert ref_decomp.main(["-i", str(src), "-o", str(theirs)]
                           + list(flags)) == 0
    assert grk_decompress.main(["-i", str(src), "-o", str(ours)]
                               + list(flags) + CPU) == 0
    written = _written(tmp_path, "back_ours")
    assert written and written == _written(tmp_path, "back_ref")
    return ours


@pytest.mark.parametrize("flags,ext", [
    ([], ".j2k"),
    ([], ".jp2"),
    (["-n", "3", "-I", "-r", "20,5", "-p", "RPCL", "-b", "16,16", "-S",
      "-E"], ".j2k"),
    (["-n", "3", "--ht", "-t", "32,32", "-A", "-L"], ".jp2"),
    (["-n", "3", "-t", "32,24", "-u", "R", "-A", "-M", "0"], ".j2k"),
])
def test_codestreams_and_decodes_match(tmp_path, rgb, flags, ext):
    src = tmp_path / "in.ppm"
    _pnm(src, rgb)
    out = _compress_both(tmp_path, src, flags, ext)
    back = _decompress_both(tmp_path, out, ".ppm")
    if "-I" not in flags:
        assert back.read_bytes() == src.read_bytes()


def test_reduced_and_windowed_decodes_match(tmp_path, rgb):
    """-r (PGX output, a file a component), -d (raw output) and -t."""
    src = tmp_path / "in.ppm"
    _pnm(src, rgb)
    out = _compress_both(tmp_path, src, ["-n", "3", "--ht", "-t", "32,32"])
    _decompress_both(tmp_path, out, ".pgx", ["-r", "1"])
    _decompress_both(tmp_path, out, ".raw", ["-d", "8,4,40,30"])
    _decompress_both(tmp_path, out, ".ppm", ["-t", "1"])


@pytest.mark.parametrize("nc", [1, 3])
@pytest.mark.parametrize("prec,sgnd", [(8, False), (12, False), (16, False),
                                       (8, True)])
def test_pnm_io_matches_the_pillow_route(tmp_path, rng, nc, prec, sgnd):
    """The port reads and writes binary PGM/PPM without Pillow, to the
    same bytes and images as grok_tpu's Pillow route (16-bit PPM output
    downshifted to 8 bits, as Pillow writes it; split PNM a component a
    file)."""
    import copy

    from grok_tpu.image import GrkImage
    from grok_tpu.io import formats as ref_formats
    from grok_tpu_torch.io import formats
    from grok_tpu_torch.params import from_reference as port

    shape = (6, 9, nc) if nc > 1 else (6, 9)
    arr = rng.integers(-300 if sgnd else 0, 1 << prec, shape)
    img = GrkImage.from_array(arr.astype(np.int32), prec=prec, sgnd=sgnd)
    for ext in (".pgm", ".ppm", ".pnm"):
        for split in (False, True):
            ref_formats.save_image(copy.deepcopy(img), str(tmp_path /
                                   f"r{ext}"), split_pnm=split)
            formats.save_image(port(copy.deepcopy(img)), str(tmp_path /
                               f"o{ext}"), split_pnm=split)
            assert _written(tmp_path, "o") == _written(tmp_path, "r")
            for f in os.listdir(tmp_path):
                (tmp_path / f).unlink()
    magic = b"P6" if nc == 3 else b"P5"
    maxval = 255 if prec == 8 else 65535
    src = tmp_path / "in.pnm"
    _pnm(src, np.abs(arr) % (maxval + 1), maxval)
    want = ref_formats.load_image(str(src))
    got = formats.load_image(str(src))
    assert (got.x0, got.y0, got.x1, got.y1) == (want.x0, want.y0, want.x1,
                                                want.y1)
    assert got.color_space.value == want.color_space.value
    for a, b in zip(got.comps, want.comps):
        assert (a.prec, a.sgnd, a.dx, a.dy, a.w, a.h) == \
            (b.prec, b.sgnd, b.dx, b.dy, b.w, b.h)
        assert np.array_equal(a.data, b.data)
    assert src.read_bytes()[:2] == magic


def test_pgx_raw_and_16bit_inputs(tmp_path, rng):
    """PGX (12-bit signed), raw with a -F descriptor and 16-bit PGM
    inputs; PGX and raw outputs."""
    from grok_tpu.image import GrkImage
    from grok_tpu.io import formats as ref_formats

    arr = rng.integers(-2048, 2048, size=(24, 30)).astype(np.int32)
    pgx = tmp_path / "in.pgx"
    ref_formats.write_pgx(GrkImage.from_array(arr, prec=12, sgnd=True),
                          str(pgx))
    out = _compress_both(tmp_path, pgx, ["-n", "3"])
    _decompress_both(tmp_path, out, ".pgx")

    raw = tmp_path / "in.raw"
    raw.write_bytes(rng.integers(0, 256, (20, 28, 3)).astype(
        np.uint8).transpose(2, 0, 1).tobytes())
    out = _compress_both(tmp_path, raw, ["-n", "2", "-F", "28,20,3,8,u"])
    _decompress_both(tmp_path, out, ".raw")

    g16 = rng.integers(0, 65536, (18, 22)).astype(np.uint16)
    src = tmp_path / "in16.pgm"
    _pnm(src, g16, maxval=65535)
    out = _compress_both(tmp_path, src, ["-n", "3"])
    assert _decompress_both(tmp_path, out, ".pgm").read_bytes() == \
        src.read_bytes()


def test_png_input_and_output(tmp_path, rgb):
    PIL = pytest.importorskip("PIL")  # noqa: F841
    from PIL import Image

    src = tmp_path / "in.png"
    Image.fromarray(rgb).save(src)
    out = _compress_both(tmp_path, src, ["-n", "3"], ".jp2")
    back = _decompress_both(tmp_path, out, ".png")
    assert np.array_equal(np.asarray(Image.open(back)), rgb)


def test_stream_strips_and_strip_writer(tmp_path, rng):
    """--stream-strips (compress_strips_file on the port) writes what the
    whole-image encode writes and what grok_tpu writes; grk_decompress's
    strip writer (the port's deferred strip decode) writes grok_tpu's
    PNM, 8- and 16-bit."""
    yy, xx = np.mgrid[0:70, 0:60].astype(float)
    arr = np.stack([128 + 90 * np.sin(xx / 9) * np.cos(yy / 7)] * 3, -1)
    arr = (arr + rng.normal(0, 8, arr.shape)).clip(0, 255).astype(np.uint8)
    src = tmp_path / "in.ppm"
    _pnm(src, arr)
    flags = ["-n", "3", "-t", "32,32", "--ht"]
    streamed = _compress_both(tmp_path, src, flags + ["--stream-strips"])
    whole = tmp_path / "whole.j2k"
    assert grk_compress.main(["-i", str(src), "-o", str(whole)] + flags
                             + CPU) == 0
    assert whole.read_bytes() == streamed.read_bytes()
    back = _decompress_both(tmp_path, streamed, ".ppm")
    assert back.read_bytes() == src.read_bytes()

    g16 = rng.integers(0, 65536, (40, 36)).astype(np.uint16)
    src16 = tmp_path / "in16.pgm"
    _pnm(src16, g16, maxval=65535)
    out = _compress_both(tmp_path, src16, ["-n", "3", "-t", "24,24",
                                           "--ht", "--stream-strips"])
    assert _decompress_both(tmp_path, out, ".pgm").read_bytes() == \
        src16.read_bytes()


def test_dump_text_matches(tmp_path, rgb, capsys):
    src = tmp_path / "in.ppm"
    _pnm(src, rgb)
    out = _compress_both(tmp_path, src, ["-n", "3", "-t", "32,32", "-A",
                                         "-u", "R"], ".jp2")
    texts = []
    for tool in (ref_dump, grk_dump):
        capsys.readouterr()
        assert tool.main(["-i", str(out)]) == 0
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1] and "SIZ" in texts[1]
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    assert ref_dump.main(["-i", str(out), "-o", str(a)]) == 0
    assert grk_dump.main(["-i", str(out), "-o", str(b)]) == 0
    for tool in (ref_cmp_dump, cmp_dump):
        assert tool.main(["-b", str(a), "-t", str(b)]) == 0
    b.write_text(b.read_text().replace("LRCP", "RLCP"))
    assert ref_cmp_dump.main(["-b", str(a), "-t", str(b)]) == 1
    assert cmp_dump.main(["-b", str(a), "-t", str(b)]) == 1


def test_error_paths_exit_alike(tmp_path, rgb):
    missing = str(tmp_path / "nope.ppm")
    bad = tmp_path / "bad.j2k"
    bad.write_bytes(b"garbage")
    src = tmp_path / "in.ppm"
    _pnm(src, rgb)
    cases = [
        (ref_comp, grk_compress, ["-i", missing, "-o", str(tmp_path / "x")]),
        (ref_comp, grk_compress, []),
        (ref_comp, grk_compress, ["-i", str(src), "-o",
                                  str(tmp_path / "x.j2k"), "-r", "20,abc"]),
        (ref_comp, grk_compress, ["-y", str(tmp_path)]),
        (ref_decomp, grk_decompress, ["-i", str(bad), "-o",
                                      str(tmp_path / "y.ppm")]),
        (ref_decomp, grk_decompress, ["-i", missing, "-o",
                                      str(tmp_path / "y.ppm")]),
        (ref_dump, grk_dump, ["-i", missing]),
    ]
    for ref, ours, argv in cases:
        extra = CPU if ours is not grk_dump else []
        assert ref.main(argv) == ours.main(argv + extra) == 1, argv


def test_batch_mode(tmp_path, rng):
    """-y/-a batch mode: every input coded alike, a bad file logged and
    counted (exit 1) without stopping the batch."""
    indir = tmp_path / "in"
    indir.mkdir()
    for k in range(2):
        _pnm(indir / f"g{k}.pgm",
             rng.integers(0, 256, (20 + k, 24)).astype(np.uint8))
    (indir / "z.pgm").write_bytes(b"P5\n")
    dirs = {}
    for name, tool, extra in (("ref", ref_comp, []),
                              ("ours", grk_compress, CPU)):
        out = tmp_path / f"{name}_j2k"
        out.mkdir()
        assert tool.main(["-y", str(indir), "-a", str(out), "-O", "j2k",
                          "-n", "3"] + extra) == 1
        dirs[name] = out
    names = sorted(os.listdir(dirs["ref"]))
    assert names == sorted(os.listdir(dirs["ours"])) == ["g0.j2k", "g1.j2k"]
    for n in names:
        assert (dirs["ref"] / n).read_bytes() == \
            (dirs["ours"] / n).read_bytes()
    back = {}
    for name, tool, extra in (("ref", ref_decomp, []),
                              ("ours", grk_decompress, CPU)):
        out = tmp_path / f"{name}_back"
        out.mkdir()
        assert tool.main(["-y", str(dirs["ours"]), "-a", str(out),
                          "-O", "pgm"] + extra) == 0
        back[name] = out
    for k in range(2):
        assert (back["ours"] / f"g{k}.pgm").read_bytes() == \
            (back["ref"] / f"g{k}.pgm").read_bytes() == \
            (indir / f"g{k}.pgm").read_bytes()


def test_random_tile_access_and_compare_tools(tmp_path, rng, capsys):
    from grok_tpu import codec as gcodec
    from grok_tpu.image import GrkImage
    from grok_tpu.params import CompressParams

    arr = rng.integers(0, 256, (50, 70, 3)).astype(np.uint8)
    f = tmp_path / "rta.j2k"
    f.write_bytes(gcodec.compress(GrkImage.from_array(arr), CompressParams(
        numresolution=3, tile_size=(32, 32), tlm=True, ht=True)))
    outs = []
    for tool, extra in ((ref_rta, []), (random_tile_access, CPU)):
        capsys.readouterr()
        assert tool.main(["-i", str(f), "--seed", "5"] + extra) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "bit-identical" in outs[1]

    a, b = tmp_path / "a.pgm", tmp_path / "b.pgm"
    _pnm(a, arr[..., 0])
    near = arr[..., 0].astype(np.int32)
    near[3, 4] = (near[3, 4] + 2) % 256
    _pnm(b, near.astype(np.uint8))
    for argv, rc in ((["-b", str(a), "-t", str(a)], 0),
                     (["-b", str(a), "-t", str(b)], 1),
                     (["-b", str(a), "-t", str(b), "-m", "1", "-p", "2"], 0)):
        got = []
        for tool in (ref_cmp_img, cmp_img):
            capsys.readouterr()
            assert tool.main(argv) == rc
            got.append(capsys.readouterr().out)
        assert got[0] == got[1]
    for tool in (ref_cmp_raw, cmp_raw):
        assert tool.main(["-b", str(a), "-t", str(a)]) == 0
        assert tool.main(["-b", str(a), "-t", str(b)]) == 1


def test_profile_writes_a_torch_trace(tmp_path, rng):
    src = tmp_path / "p.pgm"
    _pnm(src, rng.integers(0, 256, (24, 24)).astype(np.uint8))
    prof = tmp_path / "trace"
    assert grk_compress.main(["-i", str(src), "-o", str(tmp_path / "p.j2k"),
                              "-n", "2", "--profile", str(prof)] + CPU) == 0
    files = os.listdir(prof)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(prof / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(ev.get("ph") == "X" for ev in events)


def test_default_device_needs_a_card(tmp_path, rng, capsys):
    """Without a CUDA device the tools' default (--device cuda) exits
    non-zero with the error; --backend native needs no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = tmp_path / "in.pgm"
    _pnm(src, rng.integers(0, 256, (16, 16)).astype(np.uint8))
    out = tmp_path / "o.j2k"
    capsys.readouterr()
    assert grk_compress.main(["-i", str(src), "-o", str(out)]) == 1
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    assert not out.exists()
    assert grk_compress.main(["-i", str(src), "-o", str(out), "-n", "2",
                              "--backend", "native"]) == 0
    assert grk_decompress.main(["-i", str(out), "-o",
                                str(tmp_path / "b.pgm")]) == 1
    with pytest.raises(RuntimeError, match="is_available"):
        random_tile_access.main(["-i", str(out)])
