"""Parameter structures.

Parity targets (SURVEY.md §2.1, §5 "Config/flag system"):
- `grk_cparameters` -> CompressParams
- `grk_decompress_parameters` -> DecompressParams
- CodingParams/TCP/TCCP tree (src/lib/core/codestream/CodingParams.* [P])
  -> CodingParams/TileCodingParams/TileComponentCodingParams

Defaults mirror the reference CLI defaults: 64x64 codeblocks, 6 resolutions,
LRCP, one layer, reversible 5/3, no precincts (implicit 2^15), 2 guard bits.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
from dataclasses import dataclass, field

from .errors import ParamError


class Progression(enum.IntEnum):
    """SGcod progression order codes (SURVEY.md Appendix A.2)."""

    LRCP = 0
    RLCP = 1
    RPCL = 2
    PCRL = 3
    CPRL = 4


class QuantStyle(enum.IntEnum):
    """Sqcd & 0x1F quantization styles (SURVEY.md Appendix A.2)."""

    NONE = 0           # reversible: exponents only (8-bit entries)
    SCALAR_DERIVED = 1   # one 16-bit (eps, mant) value for all subbands
    SCALAR_EXPOUNDED = 2  # one 16-bit value per subband


class CblkStyle(enum.IntFlag):
    """SPcod code-block style bits (SURVEY.md Appendix A.2)."""

    NONE = 0
    LAZY = 1       # selective arithmetic bypass
    RESET = 2      # reset context probabilities each pass
    TERMALL = 4    # terminate MQ after every pass
    VSC = 8        # vertically stripe-causal contexts
    PTERM = 16     # predictable termination
    SEGSYM = 32    # segmentation symbols at end of each cleanup pass


class Profile(enum.IntEnum):
    """Rsiz profile values (subset; Cinema/Broadcast/IMF, SURVEY.md §2.2)."""

    NONE = 0x0000
    PROFILE_0 = 0x0001
    PROFILE_1 = 0x0002
    CINEMA_2K = 0x0003
    CINEMA_4K = 0x0004
    CINEMA_S2K = 0x0005
    CINEMA_S4K = 0x0006
    CINEMA_LTS = 0x0007
    BC_SINGLE = 0x0100
    BC_MULTI = 0x0200
    BC_MULTI_R = 0x0300
    IMF_2K = 0x0400
    IMF_4K = 0x0500
    IMF_8K = 0x0600
    IMF_2K_R = 0x0700
    IMF_4K_R = 0x0800
    IMF_8K_R = 0x0900
    # Part 15 (HTJ2K) capability is signaled via CAP, with Rsiz bit 14 set
    PART15 = 0x4000


# POC progression-change entry: mirrors grk_progression (SURVEY.md B.7)
@dataclass
class ProgressionChange:
    res_s: int          # RSpoc: resolution index start
    comp_s: int         # CSpoc: component index start
    lay_e: int          # LYEpoc: layer index end (exclusive)
    res_e: int          # REpoc: resolution index end (exclusive)
    comp_e: int         # CEpoc: component index end (exclusive)
    prog: Progression   # Ppoc


@dataclass
class CompressParams:
    """Mirror of grk_cparameters (the `-` flags of grk_compress)."""

    # tiling: None => single tile covering the image
    tile_size: tuple[int, int] | None = None     # -t
    tile_offset: tuple[int, int] = (0, 0)        # -T
    image_offset: tuple[int, int] = (0, 0)       # -d

    numresolution: int = 6                        # -n
    cblk_width: int = 64                          # -b
    cblk_height: int = 64
    # list of (PPx, PPy) per resolution, lowest-res-last like the CLI; None =>
    # maximal precincts (2^15)
    precincts: list[tuple[int, int]] | None = None  # -c
    prog_order: Progression = Progression.LRCP    # -p
    progression_changes: list[ProgressionChange] = field(default_factory=list)  # -P
    # -P with T<idx>= selectors: per-tile overrides of the global list;
    # the overriding tiles get their own tile-header POC marker
    tile_progression_changes: dict[int, list[ProgressionChange]] = \
        field(default_factory=dict)

    numlayers: int = 1
    # -r: compression ratios per layer (1 = lossless cap); mutually exclusive with -q
    layer_rates: list[float] | None = None
    # -q: PSNR targets per layer
    layer_psnr: list[float] | None = None

    irreversible: bool = False                    # -I (9/7 + ICT)
    mct: int | None = None                        # -Y 0/1/2; None = auto
    custom_mct: object | None = None              # -m: numpy matrix, Part-2 MCT
    roi_comp: int = -1                            # -R c,U: component
    roi_shift: int = 0                            # ROI max-shift value
    # -M mode switches.  None = auto policy: selective MQ bypass (LAZY —
    # raw bits for SigProp/MagRef below the 4 most significant bitplanes)
    # unless ROI or PSNR targeting is requested.  Bypass streams remain
    # Part-1 conformant (signaled in COD/COC, decodable by any decoder
    # incl. the OpenJPEG oracle) while encode+decode run 25-40% faster on
    # deep-bitplane content for <1% size cost — the right default for a
    # throughput-first framework.  Excluded under ROI because the oracle
    # decoder mishandles bypass+ROI streams (known OpenJPEG asymmetry,
    # t1/coder.py), and under -q targets where exact R-D matters most.
    # Set CblkStyle.NONE (CLI -M 0) explicitly for classic all-MQ coding.
    cblk_style: CblkStyle | None = None
    num_guard_bits: int | None = None             # -G; default 2
    sop: bool = False                             # -S: SOP markers
    eph: bool = False                             # -E: EPH markers
    tlm: bool = False                             # -A: write TLM
    plt: bool = False                             # write PLT
    plm: bool = False                             # write PLM (main header)
    ppt: bool = False                             # packed packet headers (PPT)
    ppm: bool = False                             # packed headers in main (PPM)
    comment: str | list[str] | None = "Created by grok_tpu"  # -C
    # CRG: per-component registration offsets (Xcrg, Ycrg) in 1/65536 of
    # the sample spacing; informative marker in the main header
    comp_registration: list[tuple[int, int]] | None = None

    # container
    cod_format: str = "j2k"                       # "j2k" (raw) or "jp2"

    # profiles
    profile: Profile = Profile.NONE               # -w/-x/-U/-z
    profile_level: int = 0                        # BC/IMF mainlevel (Rsiz 0-3)
    profile_sublevel: int = 0                     # IMF sublevel (Rsiz 4-7)
    framerate: int = 24                           # cinema fps (rate caps)
    max_cs_size: int = 0                          # -W total size cap (bytes)
    max_comp_size: int = 0
    # tile-part generation: None, or 'R'|'L'|'C' (split by res/layer/comp)
    new_tile_part_progression: str | None = None  # -u

    # HTJ2K (Part 15)
    ht: bool = False                              # block coder = HT
    # Part-15 MIXED set: per-codeblock choice between the HT and MQ
    # coders within one tile (signaled via CAP Ccap15 set bits).  The
    # default policy codes LL-band (resolution-0) blocks with MQ for its
    # finer truncation points and everything else with HT for speed.
    ht_mixed: bool = False

    # experimental: Tier-1 early-stops each codeblock at ~3x its
    # area-proportional share of the byte target (passes a cap provably
    # discards), with hull revalidation + re-encode of the tail.  Off by
    # default: on the bench content the revalidation/reassignment
    # overhead cancels the Tier-1 savings (see PERF_NOTES.md); useful
    # when targets are very tight relative to content entropy.
    rate_quota: bool = False

    # quantization override: explicit base step size (0 = derived default)
    quant_step: float = 0.0
    quant_style: QuantStyle | None = None

    # number of threads for host stages (0 = all cores); parity with -H
    num_threads: int = 0

    # which backend: "device" (the transforms and HT and MQ Tier-1 on the
    # codec call's device; the MQ blocks outside the device routers'
    # limits, MQ decode shape groups under 8, ragged HT blocks and Tier-2
    # on the native host coder) | "native" (C++ host path) | "python" |
    # "auto" (as "native")
    backend: str = "device"

    # the devices the sample transforms shard over (parallel/mesh.py): a
    # Mesh, or an int n for a dp mesh over n devices of the call's device
    # type; Tier-1 and Tier-2 stay where the backend runs them
    mesh: object | None = None

    def validate(self) -> None:
        if self.layer_rates and self.layer_psnr:
            raise ParamError("layer_rates (-r) and layer_psnr (-q) are mutually exclusive")
        if self.ppt and self.sop:
            raise ParamError(
                "SOP markers cannot be used with packed headers (PPT)")
        if self.ppm and (self.sop or self.ppt
                         or self.new_tile_part_progression):
            raise ParamError(
                "PPM excludes SOP, PPT and tile-part generation")
        if not (1 <= self.numresolution <= 33):
            raise ParamError("numresolution out of range [1,33]")
        for dim, name in ((self.cblk_width, "cblk_width"), (self.cblk_height, "cblk_height")):
            if dim < 4 or dim > 1024 or (dim & (dim - 1)):
                raise ParamError(f"{name} must be a power of two in [4,1024]")
        if self.cblk_width * self.cblk_height > 4096:
            raise ParamError("code-block area must be <= 4096")
        if self.precincts:
            for (px, py) in self.precincts:
                if px & (px - 1) or py & (py - 1):
                    raise ParamError("precinct dims must be powers of two")
                if px < 2 or py < 2:
                    # PPx=0 is only legal at the lowest resolution (ISO
                    # B.6); the list replicates across resolutions here,
                    # so size-1 precincts are rejected outright
                    raise ParamError("precinct dims must be >= 2")
        if self.ht_mixed and not self.ht:
            raise ParamError("ht_mixed requires ht")
        if self.roi_shift:
            # SPrgn is a u8 on the wire; and upshifted coefficients must
            # still fit the 32-bit T1 magnitude range (prec + gain(2) +
            # shift headroom)
            if not 0 <= self.roi_shift <= 255:
                raise ParamError("roi_shift must be in [0,255]")


@dataclass
class DecompressParams:
    """Mirror of grk_decompress_parameters (grk_decompress flags)."""

    reduce: int = 0              # -r: discard this many highest resolutions
    max_layers: int = 0          # -l: 0 = all
    # decode window on the canvas: (x0, y0, x1, y1) or None for full image
    window: tuple[int, int, int, int] | None = None  # -d
    tile_index: int | None = None  # -t: decode a single tile
    strict: bool = False         # fail hard on malformed streams
    # post-processing parity flags
    force_rgb: bool = False      # -f
    upsample: bool = False       # -u
    split_pnm: bool = False
    precision: list[int] | None = None  # -p precision override per comp
    apply_icc: bool = False
    num_threads: int = 0
    backend: str = "device"  # as CompressParams.backend
    mesh: object | None = None  # as CompressParams.mesh (full decodes)
    # resource limit: refuse decodes whose (reduced, windowed) output
    # exceeds this many pixels (0 = library default, 2^32).  A 30 KB
    # stream can legally declare a multi-gigapixel canvas; services
    # decoding untrusted data should set an application budget here.
    max_pixels: int = 0


# ----------------------------------------------------------------- internal

@dataclass
class StepSize:
    expn: int = 0
    mant: int = 0


@dataclass
class TileComponentCodingParams:
    """TCCP: per tile-component coding parameters (COD/COC/QCD/QCC image)."""

    numresolutions: int = 6
    cblkw: int = 6               # log2 codeblock width
    cblkh: int = 6
    cblk_style: CblkStyle = CblkStyle.NONE
    qmfbid: int = 1              # 1 = reversible 5/3, 0 = irreversible 9/7
    # per-resolution precinct exponents (len == numresolutions)
    prcw: list[int] = field(default_factory=list)
    prch: list[int] = field(default_factory=list)
    qnt_style: QuantStyle = QuantStyle.NONE
    num_guard_bits: int = 2
    stepsizes: list[StepSize] = field(default_factory=list)
    roi_shift: int = 0
    ht: bool = False             # this component uses the HT block coder

    def clone(self) -> "TileComponentCodingParams":
        """Independent copy (cheaper than deepcopy on the decode hot path:
        one clone per tile seeds the per-tile TCP from the main header).
        copy.copy skips __init__/default factories; StepSize leaves are
        immutable once parsed (QCC overrides install new lists) and stay
        shared."""
        c = copy.copy(self)
        c.prcw = list(self.prcw)
        c.prch = list(self.prch)
        c.stepsizes = list(self.stepsizes)
        return c


@dataclass
class TileCodingParams:
    """TCP: per-tile coding parameters."""

    prog_order: Progression = Progression.LRCP
    numlayers: int = 1
    mct: int = 0                  # 0 none, 1 RCT/ICT, 2 custom matrix
    tccps: list[TileComponentCodingParams] = field(default_factory=list)
    progression_changes: list[ProgressionChange] = field(default_factory=list)
    # decoder state
    ppt_data: bytes | None = None
    num_tile_parts: int = 0
    mct_matrix: object | None = None   # forward decorrelation matrix (numpy)
    # Part-2 MCT/MCC/MCO decoder state: raw arrays by index, collections,
    # apply order, and the resolved decoding matrix + DC offsets
    mct_records: dict = field(default_factory=dict)
    mcc_records: dict = field(default_factory=dict)
    mco_order: list = field(default_factory=list)
    mct_dec_matrix: object | None = None
    mct_offsets: object | None = None
    rates: list[float] = field(default_factory=list)
    distortions: list[float] = field(default_factory=list)

    def clone(self) -> "TileCodingParams":
        """Independent per-tile copy of the main-header TCP.  Containers
        are copied one level deep; leaf records (MCT arrays, progression
        change entries) are read-only once parsed and stay shared."""
        c = copy.copy(self)
        c.tccps = [t.clone() for t in self.tccps]
        c.progression_changes = list(self.progression_changes)
        c.mct_records = dict(self.mct_records)
        c.mcc_records = dict(self.mcc_records)
        c.mco_order = list(self.mco_order)
        c.rates = list(self.rates)
        c.distortions = list(self.distortions)
        return c


@dataclass
class CodingParams:
    """CP: image-level coding parameters mirroring the codestream."""

    tx0: int = 0
    ty0: int = 0
    t_width: int = 0
    t_height: int = 0
    t_grid_w: int = 1
    t_grid_h: int = 1
    rsiz: int = 0
    tcps: list[TileCodingParams] = field(default_factory=list)
    comments: list[str] = field(default_factory=list)
    # decoder: main-header PPM data
    ppm_data: bytes | None = None
    # TLM tile index: list of (tile_index, length) in codestream order
    tlm: list[tuple[int, int]] | None = None
    ht: bool = False
    ht_mixed: bool = False  # Part-15 MIXED set (CAP Ccap15 set bits = 3)

    @property
    def numtiles(self) -> int:
        return self.t_grid_w * self.t_grid_h


# ------------------------------------------------------ carrying state across

def from_reference(obj):
    """The port's counterpart of `obj`: an instance of a dataclass or enum
    of grok_tpu's params or image modules (or any object whose class name
    and fields match one of this package's params or image classes) is
    rebuilt as that class of grok_tpu_torch, field by field, recursing
    into nested dataclasses, enums, lists, tuples and dicts.  A
    jax.sharding.Mesh (a "Mesh" with "dp" and "sp" axes) becomes a
    parallel.mesh.Mesh of the same dp x sp shape over the CPU.  Other
    values, numpy arrays included, are passed on as they are (not
    copied)."""
    from . import image

    classes = {name: cls for mod in (globals(), vars(image))
               for name, cls in mod.items()
               if isinstance(cls, type)
               and (dataclasses.is_dataclass(cls)
                    or issubclass(cls, enum.Enum))}
    return _rebuild(obj, classes)


def _rebuild(obj, classes: dict):
    if isinstance(obj, (list, tuple)):
        return type(obj)(_rebuild(v, classes) for v in obj)
    if isinstance(obj, dict):
        return {_rebuild(k, classes): _rebuild(v, classes)
                for k, v in obj.items()}
    name = type(obj).__name__
    if name == "Mesh" and getattr(obj, "axis_names", None) == ("dp", "sp"):
        from .parallel.mesh import make_mesh

        dp, sp = obj.shape["dp"], obj.shape["sp"]
        return make_mesh(dp * sp, dp=dp, sp=sp, devices=["cpu"] * (dp * sp))
    cls = classes.get(name)
    if cls is None:
        return obj
    if issubclass(cls, enum.Enum):
        return cls(obj.value)
    return cls(**{f.name: _rebuild(getattr(obj, f.name), classes)
                  for f in dataclasses.fields(cls) if f.init})
