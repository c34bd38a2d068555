"""Cinema / Broadcast / IMF profile parameter enforcement and validation.

Parity: the profile handling of CodeStreamCompress::init + the CLI
(-w/-x/-U/-z, SURVEY.md §2.1 "Codestream compress": "validate profiles
(Cinema/Broadcast/IMF caps)"; §2.2 grk_compress).

Digital-cinema (DCI) constants follow the published DCI spec values used by
the reference family: per-frame codestream caps 1,302,083 bytes (24 fps)
and 651,041 bytes (48 fps); 2K frames <= 2048x1080 at <= 6 resolutions,
4K <= 4096x2160 at <= 7 resolutions with a mandatory resolution-layered
POC; CPRL progression; 32x32 codeblocks; 256x256 precincts (128x128 at the
lowest); SOP/EPH on; single tile.
"""

from __future__ import annotations

import logging

from ..errors import ParamError
from ..params import CompressParams, Profile, Progression, ProgressionChange

log = logging.getLogger("grok_tpu_torch")

CINEMA_24_CS = 1_302_083
CINEMA_48_CS = 651_041
CINEMA_24_COMP = 1_041_666
CINEMA_48_COMP = 520_833


def apply_profile(p: CompressParams, image) -> None:
    """Normalize parameters for the selected profile and validate the
    image against its constraints.  Mutates `p` in place."""
    if p.profile in (Profile.CINEMA_2K, Profile.CINEMA_4K):
        _apply_cinema(p, image)
    elif Profile.BC_SINGLE.value <= int(p.profile) <= Profile.BC_MULTI_R.value:
        _apply_broadcast(p, image)
    elif Profile.IMF_2K.value <= int(p.profile) <= Profile.IMF_8K_R.value:
        _apply_imf(p, image)


def _apply_cinema(p: CompressParams, image) -> None:
    is4k = p.profile == Profile.CINEMA_4K
    w = image.x1 - image.x0
    h = image.y1 - image.y0
    if not is4k and (w > 2048 or h > 1080):
        raise ParamError(
            f"Cinema 2K requires <= 2048x1080, got {w}x{h}")
    if is4k and (w > 4096 or h > 2160):
        raise ParamError(
            f"Cinema 4K requires <= 4096x2160, got {w}x{h}")
    if image.numcomps != 3:
        raise ParamError("Cinema profiles require 3 components (XYZ)")
    for c in image.comps:
        if c.prec != 12:
            log.warning("Cinema profiles expect 12-bit components "
                        "(component has %d)", c.prec)
    p.irreversible = True
    p.prog_order = Progression.CPRL
    p.cblk_width = p.cblk_height = 32
    p.tile_size = None  # single tile
    maxres = 7 if is4k else 6
    if p.numresolution > maxres:
        log.warning("clamping resolutions to %d for cinema profile", maxres)
        p.numresolution = maxres
    if p.numresolution < 2:
        p.numresolution = 2
    # precincts: 256x256, 128x128 at the lowest resolution
    p.precincts = [(256, 256)] * (p.numresolution - 1) + [(128, 128)]
    p.sop = True
    p.eph = True
    p.new_tile_part_progression = "C"
    if is4k:
        # 4K: the 2K sub-resolution must come first (POC with two volumes)
        p.progression_changes = [
            ProgressionChange(0, 0, 1, p.numresolution - 1, 3,
                              Progression.CPRL),
            ProgressionChange(p.numresolution - 1, 0, 1, p.numresolution, 3,
                              Progression.CPRL),
        ]
    cap = CINEMA_48_CS if p.framerate >= 48 else CINEMA_24_CS
    if p.max_cs_size <= 0 or p.max_cs_size > cap:
        p.max_cs_size = cap
    if p.max_comp_size <= 0:
        p.max_comp_size = (CINEMA_48_COMP if p.framerate >= 48
                           else CINEMA_24_COMP)
    if p.layer_rates or p.layer_psnr:
        log.warning("cinema profile overrides explicit rates with the DCI "
                    "codestream cap")
        p.layer_rates = None
        p.layer_psnr = None
    p.numlayers = 1


def _apply_broadcast(p: CompressParams, image) -> None:
    """Broadcast contribution profiles (15444-1 Amd.3): full constraint
    set.  Rsiz = 0x0100 (single tile) / 0x0200 (multi) / 0x0300 (multi
    reversible) with the mainlevel in bits 0..3."""
    if not 0 <= p.profile_level <= 11:
        raise ParamError("Broadcast mainlevel must be in [0, 11]")
    if image.x0 or image.y0 or p.tile_offset != (0, 0):
        raise ParamError("Broadcast profiles require zero image and tile "
                         "offsets")
    if image.numcomps > 4:
        raise ParamError("Broadcast profiles allow at most 4 components")
    for c in image.comps:
        if c.prec > 12:
            log.warning("Broadcast profiles expect <= 12-bit components "
                        "(component has %d)", c.prec)
        if c.dx not in (1, 2) or c.dy not in (1, 2):
            raise ParamError("Broadcast subsampling factors must be 1 or 2")
    if p.profile == Profile.BC_SINGLE:
        if p.tile_size is not None:
            log.warning("Broadcast single-tile profile: dropping tiling")
            p.tile_size = None
        p.irreversible = True
    else:
        if p.tile_size is not None:
            tw, th = p.tile_size
            w = image.x1 - image.x0
            h = image.y1 - image.y0
            ok = (tw >= w and th >= h) or (2 * tw >= w and 2 * th >= h)
            if not ok:
                raise ParamError(
                    "Broadcast multi-tile profiles allow 1 or 4 equal tiles")
        p.irreversible = p.profile != Profile.BC_MULTI_R
    p.sop = False
    p.eph = True
    if p.numresolution > 6:
        log.warning("clamping resolutions to 6 for the Broadcast profile")
        p.numresolution = 6


# IMF picture-size limits per variant: (max width, max height, max NL)
_IMF_LIMITS = {
    Profile.IMF_2K: (2048, 1556, 5), Profile.IMF_2K_R: (2048, 1556, 5),
    Profile.IMF_4K: (4096, 3112, 6), Profile.IMF_4K_R: (4096, 3112, 6),
    Profile.IMF_8K: (8192, 6224, 7), Profile.IMF_8K_R: (8192, 6224, 7),
}


def _apply_imf(p: CompressParams, image) -> None:
    """IMF profiles (15444-1 Amd.8 / SMPTE ST 2067-21): full constraint
    set — single tile at origin, 32x32 codeblocks, 256/128 precincts,
    per-variant picture-size and decomposition caps, mandatory TLM with
    resolution-ordered tile-parts, 9/7 (lossy) or 5/3 (_R variants)."""
    if not 0 <= p.profile_level <= 11 or not 0 <= p.profile_sublevel <= 9:
        raise ParamError("IMF mainlevel must be in [0,11], sublevel [0,9]")
    if image.x0 or image.y0 or p.tile_offset != (0, 0):
        raise ParamError("IMF profiles require zero image and tile offsets")
    if p.tile_size is not None:
        log.warning("IMF profiles are single-tile: dropping tiling")
    p.tile_size = None
    if image.numcomps > 4:
        raise ParamError("IMF profiles allow at most 4 components")
    for c in image.comps:
        if c.prec > 16:
            raise ParamError("IMF components must be <= 16-bit")
        if (c.dx, c.dy) not in ((1, 1), (2, 1)):
            raise ParamError(
                "IMF allows only 4:4:4 or horizontally subsampled 4:2:2")
    w = image.x1 - image.x0
    h = image.y1 - image.y0
    maxw, maxh, maxnl = _IMF_LIMITS[p.profile]
    if w > maxw or h > maxh:
        raise ParamError(
            f"{p.profile.name} requires <= {maxw}x{maxh}, got {w}x{h}")
    if p.numresolution > maxnl + 1:
        log.warning("clamping resolutions to %d for %s", maxnl + 1,
                    p.profile.name)
        p.numresolution = maxnl + 1
    reversible_profile = int(p.profile) >= Profile.IMF_2K_R.value
    p.irreversible = not reversible_profile
    if p.cblk_width != 32 or p.cblk_height != 32:
        log.warning("IMF requires 32x32 codeblocks; overriding %dx%d",
                    p.cblk_width, p.cblk_height)
    p.cblk_width = p.cblk_height = 32
    p.precincts = [(256, 256)] * (p.numresolution - 1) + [(128, 128)]
    p.tlm = True
    if p.new_tile_part_progression is None:
        p.new_tile_part_progression = "R"


def validate_decoded_profile(rsiz: int, hi) -> list[str]:
    """Decoder-side conformance report: list of profile violations found in
    a parsed header (used by grk_dump and tests)."""
    issues = []
    profile = rsiz & 0x3FFF
    if profile in (int(Profile.CINEMA_2K), int(Profile.CINEMA_4K)):
        tcp = hi.cp.tcps[0]
        if tcp.prog_order != Progression.CPRL:
            issues.append("cinema stream must use CPRL progression")
        t = tcp.tccps[0]
        if (1 << t.cblkw) > 32 or (1 << t.cblkh) > 32:
            issues.append("cinema codeblocks must be <= 32x32")
        if t.qmfbid != 0:
            issues.append("cinema streams must use the 9/7 transform")
        if hi.cp.numtiles != 1:
            issues.append("cinema streams must be single-tile")
    base = profile & 0xFF00
    if Profile.BC_SINGLE.value <= base <= Profile.BC_MULTI_R.value:
        if (profile & 0xF) > 11:
            issues.append("broadcast mainlevel out of range [0,11]")
        if hi.siz.xosiz or hi.siz.yosiz or hi.siz.xtosiz or hi.siz.ytosiz:
            issues.append("broadcast streams require zero offsets")
        if base == Profile.BC_SINGLE.value and hi.cp.numtiles != 1:
            issues.append("broadcast single-tile stream has multiple tiles")
        if hi.cp.numtiles not in (1, 4):
            issues.append("broadcast streams allow 1 or 4 tiles")
        t = hi.cp.tcps[0].tccps[0]
        if base == Profile.BC_MULTI_R.value:
            if t.qmfbid != 1:
                issues.append("broadcast reversible stream must use 5/3")
        elif t.qmfbid != 0:
            issues.append("broadcast lossy stream must use 9/7")
    if Profile.IMF_2K.value <= base <= Profile.IMF_8K_R.value:
        if (profile & 0xF) > 11 or ((profile >> 4) & 0xF) > 9:
            issues.append("IMF main/sublevel out of range")
        if hi.siz.xosiz or hi.siz.yosiz or hi.siz.xtosiz or hi.siz.ytosiz:
            issues.append("IMF streams require zero offsets")
        if hi.cp.numtiles != 1:
            issues.append("IMF streams must be single-tile")
        t = hi.cp.tcps[0].tccps[0]
        if (1 << t.cblkw) != 32 or (1 << t.cblkh) != 32:
            issues.append("IMF codeblocks must be 32x32")
        reversible_variant = base >= Profile.IMF_2K_R.value
        if reversible_variant and t.qmfbid != 1:
            issues.append("IMF _R stream must use the 5/3 transform")
        if not reversible_variant and t.qmfbid != 0:
            issues.append("IMF lossy stream must use the 9/7 transform")
        w = hi.siz.xsiz - hi.siz.xosiz
        lim = {Profile.IMF_2K.value: 2048, Profile.IMF_4K.value: 4096,
               Profile.IMF_8K.value: 8192, Profile.IMF_2K_R.value: 2048,
               Profile.IMF_4K_R.value: 4096,
               Profile.IMF_8K_R.value: 8192}[base]
        if w > lim:
            issues.append(f"IMF picture width {w} exceeds {lim}")
        if hi.cp.tlm is None:
            issues.append("IMF streams must carry a TLM index")
    return issues
