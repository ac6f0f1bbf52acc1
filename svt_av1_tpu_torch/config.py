"""Encoder/decoder configuration and presets.

Mirrors the public configuration surface of the reference encoder
(``EbSvtAv1EncConfiguration``, SVT-AV1 Source/API/EbSvtAv1Enc.h:87-723)
as a frozen dataclass, with the same validation rules as the reference's
``verify_settings`` (SVT-AV1 Source/Lib/Encoder/Globals/EbEncHandle.c:2511)
and per-preset feature derivation in :func:`derive_signals` standing in for the
reference's ``signal_derivation_*_oq`` family.

Unlike the reference (mutable C struct copied between stages), configuration
here is immutable: the pipeline closes over it and jitted kernels receive it
as static arguments, so XLA can specialize on shapes/feature flags.
"""
from __future__ import annotations

import dataclasses
import enum
from fractions import Fraction


class RateControlMode(enum.IntEnum):
    CQP = 0    # constant qindex (+ TPL-modulated CRF when tpl enabled)
    VBR = 1
    CVBR = 2


class PredStructure(enum.IntEnum):
    LOW_DELAY_P = 0
    LOW_DELAY_B = 1
    RANDOM_ACCESS = 2


class ColorFormat(enum.IntEnum):
    YUV400 = 0
    YUV420 = 1
    YUV422 = 2
    YUV444 = 3


MIN_PRESET = -2   # "MR" modes in the reference (EbDefinitions.h:1997-2007)
MAX_PRESET = 8


class ConfigError(ValueError):
    """Raised for invalid encoder settings (ref: EbSvtAv1ErrorCodes.h)."""


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Public encoder configuration.

    Field groups follow the reference API struct; fields default to the
    reference defaults (``svt_svt_enc_init_parameter``, EbEncHandle.c:3056).
    A value of ``-1`` on tool toggles means "derived from preset".
    """

    # --- GOP / structure ---
    enc_mode: int = MAX_PRESET                  # preset -2..8
    intra_period_length: int = -2               # -2 auto, -1 = only first frame
    intra_refresh_type: int = 2                 # 1 CRA (open GOP), 2 IDR (closed)
    hierarchical_levels: int = 4                # 0..5 -> 1..6 temporal layers
    pred_structure: PredStructure = PredStructure.RANDOM_ACCESS

    # --- Input description ---
    source_width: int = 0
    source_height: int = 0
    frame_rate: Fraction = Fraction(60, 1)
    encoder_bit_depth: int = 8                  # 8 or 10
    encoder_color_format: ColorFormat = ColorFormat.YUV420

    # --- Coding structure ---
    super_block_size: int = 128                 # 64 or 128
    partition_depth: int = -1

    # --- Quality / QP ---
    qp: int = 50                                # 0..63 CQP quantizer
    use_fixed_qindex_offsets: bool = False
    qindex_offsets: tuple[int, ...] = ()
    key_frame_qindex_offset: int = 0
    stat_report: bool = False

    # --- Rate control ---
    rate_control_mode: RateControlMode = RateControlMode.CQP
    target_bit_rate: int = 7_000_000
    look_ahead_distance: int = -1               # -1 auto
    enable_tpl_la: bool = True
    max_qp_allowed: int = 63
    min_qp_allowed: int = 1
    vbv_bufsize: int = 0
    under_shoot_pct: int = 25
    over_shoot_pct: int = 25
    enable_adaptive_quantization: int = -1

    # --- Tool toggles (-1 = per-preset auto) ---
    disable_dlf: bool = False
    cdef_level: int = -1
    enable_restoration: int = -1
    enable_warped_motion: int = -1
    enable_global_motion: bool = True
    film_grain_denoise_strength: int = 0
    enable_paeth: int = -1
    enable_smooth: int = -1
    enable_cfl: int = -1
    intra_angle_delta: int = -1
    filter_intra_level: int = -1
    enable_intra_edge_filter: int = -1
    palette_level: int = -1
    intrabc_mode: int = -1
    screen_content_mode: int = -1
    obmc_level: int = -1
    compound_level: int = -1
    inter_intra_compound: int = -1
    rdoq_level: int = -1
    enable_mfmv: int = -1
    frame_end_cdf_update: int = -1
    pic_based_rate_est: int = -1

    # --- ME / HME ---
    enable_hme: bool = True
    enable_hme_level0: bool = True
    enable_hme_level1: int = -1
    enable_hme_level2: int = -1
    # -1 = auto (use_default_me_hme analog: preset-derived area)
    search_area_width: int = -1
    search_area_height: int = -1

    # --- Alt-ref ---
    tf_level: int = -1
    altref_strength: int = 5
    altref_nframes: int = 7
    enable_overlays: bool = False

    # --- Super-resolution ---
    superres_mode: int = 0
    superres_denom: int = 8
    superres_kf_denom: int = 8
    superres_qthres: int = 43

    # --- Bitstream conformance ---
    profile: int = 0
    tier: int = 0
    level: int = 0                              # 0 = auto

    # --- Tiles / outputs ---
    tile_columns: int = 0                       # log2
    tile_rows: int = 0                          # log2
    recon_enabled: bool = False

    # --- Platform (TPU-native analog of the reference's thread knobs) ---
    channel_id: int = 0
    active_channel_count: int = 1
    pictures_in_flight: int = -1                # -1 auto from device memory

    def __post_init__(self):
        validate_config(self)

    # Convenience geometry -------------------------------------------------
    @property
    def sb_size(self) -> int:
        return self.super_block_size

    @property
    def sb_cols(self) -> int:
        return -(-self.source_width // self.sb_size)

    @property
    def sb_rows(self) -> int:
        return -(-self.source_height // self.sb_size)

    @property
    def mi_cols(self) -> int:
        return 2 * ((self.source_width + 7) >> 3)

    @property
    def mi_rows(self) -> int:
        return 2 * ((self.source_height + 7) >> 3)


def validate_config(cfg: EncoderConfig) -> None:
    """Reject invalid settings (ref behavior: verify_settings,
    EbEncHandle.c:2511 — same bounds, raised as exceptions instead of
    error codes)."""
    if not (MIN_PRESET <= cfg.enc_mode <= MAX_PRESET):
        raise ConfigError(f"enc_mode must be in [{MIN_PRESET},{MAX_PRESET}]")
    if cfg.rdoq_level not in (-1, 0, 1):
        raise ConfigError("rdoq_level must be -1 (auto), 0 (off) or 1 "
                          "(full trellis); the reference's levels 2/3 "
                          "only add speed gates on top of 1")
    if cfg.source_width % 2 or cfg.source_height % 2:
        raise ConfigError("source dimensions must be even")
    if cfg.source_width and not (4 <= cfg.source_width <= 16384):
        raise ConfigError("source_width out of range [4, 16384]")
    if cfg.source_height and not (4 <= cfg.source_height <= 8704):
        raise ConfigError("source_height out of range [4, 8704]")
    if not (0 <= cfg.qp <= 63):
        raise ConfigError("qp out of range [0, 63]")
    if cfg.encoder_bit_depth not in (8, 10):
        raise ConfigError("encoder_bit_depth must be 8 or 10")
    if cfg.super_block_size not in (64, 128):
        raise ConfigError("super_block_size must be 64 or 128")
    if not (0 <= cfg.hierarchical_levels <= 5):
        raise ConfigError("hierarchical_levels out of range [0, 5]")
    if cfg.rate_control_mode != RateControlMode.CQP and cfg.target_bit_rate <= 0:
        raise ConfigError("target_bit_rate must be positive in VBR/CVBR")
    if not (0 <= cfg.tile_columns <= 6 and 0 <= cfg.tile_rows <= 6):
        raise ConfigError("tile log2 counts out of range [0, 6]")
    if cfg.min_qp_allowed > cfg.max_qp_allowed:
        raise ConfigError("min_qp_allowed > max_qp_allowed")
    # Unimplemented tools: accepting a knob and silently ignoring it is
    # worse than rejecting it (verify_settings parity: unsupported
    # combinations error out).  -1 = auto resolves to "off" today; any
    # explicit enable is refused until the tool lands.
    for field, label in (("pic_based_rate_est", "picture-based rate "
                          "estimation"),
                         ("enable_mfmv", "temporal MV prediction"),
                         ("inter_intra_compound", "inter-intra compound")):
        v = getattr(cfg, field)
        if v not in (-1, 0):
            raise ConfigError(f"{field}={v}: {label} is not implemented "
                              "yet (use -1 or 0)")
    if cfg.enable_overlays:
        raise ConfigError("enable_overlays: overlay pictures are not "
                          "implemented yet")
    if cfg.active_channel_count != 1:
        raise ConfigError("active_channel_count must be 1 (run one "
                          "Encoder per channel)")
    if cfg.profile != 0:
        raise ConfigError("profile must be 0 (main: 4:2:0, 8/10-bit); "
                          "high/professional input formats are not "
                          "supported")
    if cfg.tier not in (0, 1):
        raise ConfigError("tier must be 0 (main) or 1 (high)")
    if cfg.encoder_color_format != ColorFormat.YUV420:
        raise ConfigError("encoder_color_format must be YUV420 (the "
                          "pipeline is 4:2:0-only; profile 0)")
    if cfg.intra_refresh_type != 2:
        raise ConfigError("intra_refresh_type must be 2 (closed-GOP "
                          "key frames); CRA open GOPs are not "
                          "implemented")
    if cfg.partition_depth != -1:
        raise ConfigError("partition_depth is derived per preset; "
                          "use -1 (auto)")
    if cfg.look_ahead_distance != -1 and not (
            0 <= cfg.look_ahead_distance <= 120):
        raise ConfigError("look_ahead_distance out of range [0, 120] "
                          "(-1 = auto)")
    if cfg.palette_level not in (-1, 0, 1):
        raise ConfigError("palette_level must be -1 (auto), 0 or 1")
    if cfg.intrabc_mode not in (-1, 0, 1):
        raise ConfigError("intrabc_mode must be -1 (auto), 0 (off) or "
                          "1 (on for intra frames)")
    if cfg.screen_content_mode not in (-1, 0, 1):
        raise ConfigError("screen_content_mode must be -1 (auto), 0 "
                          "(off) or 1 (on); content detection (2) is "
                          "not implemented")
    if cfg.use_fixed_qindex_offsets:
        if cfg.rate_control_mode != RateControlMode.CQP:
            raise ConfigError("use_fixed_qindex_offsets requires CQP")
        if any(abs(v) > 255 for v in cfg.qindex_offsets) \
                or abs(cfg.key_frame_qindex_offset) > 255:
            raise ConfigError("qindex offsets out of range [-255, 255]")
    for v in (cfg.search_area_width, cfg.search_area_height):
        if v != -1 and not (1 <= v <= 256):
            raise ConfigError("search_area dimensions out of range "
                              "[1, 256] (-1 = auto)")
    if cfg.superres_mode:
        # scaled-reference MC is not implemented, so super-resolution is
        # only usable on all-intra configs (intra period -2/0); silently
        # signaling-but-ignoring it would waste a per-frame bit and
        # surprise the user (ADVICE r1)
        if cfg.intra_period_length not in (-2, 0):
            raise ConfigError("superres_mode>0 requires an all-intra "
                              "config (intra_period_length -2 or 0); "
                              "scaled-reference MC is not yet supported")
        if not (8 <= cfg.superres_denom <= 16):
            raise ConfigError("superres_denom out of range [8, 16] "
                              "(8 = no scaling)")


@dataclasses.dataclass(frozen=True)
class DerivedSignals:
    """Per-preset feature levels, the analog of the reference's
    ``signal_derivation_multi_processes_oq``
    (EbPictureDecisionProcess.c:799) and friends.  Only the signals the
    current pipeline consumes are here; it grows with the feature set.
    """

    enable_hme_level1: bool
    enable_hme_level2: bool
    enable_paeth: bool
    enable_smooth: bool
    enable_cfl: bool
    enable_filter_intra: bool
    enable_intra_edge_filter: bool
    intra_angle_delta: bool
    cdef_level: int
    cdef_multi: bool           # per-64x64 strength presets (cdef_bits>0)
    enable_restoration: bool
    enable_warped_motion: bool
    enable_adaptive_quantization: bool
    obmc_level: int
    compound_level: int
    palette_level: int
    intrabc_level: int
    tf_level: int
    rdoq_level: int            # 0 off / 1 full trellis + fp quant
    md_stage_nics: tuple[int, int, int, int]   # candidates kept per MD stage
    open_loop_me: bool         # batched plan MEs against ref SOURCES
    interintra_level: int      # 0 off / 1 smooth+wedge II trials



def derive_signals(cfg: EncoderConfig) -> DerivedSignals:
    """Map preset -> feature levels.

    The ladder follows the reference's intent (faster presets disable
    expensive tools), re-tuned for TPU costs: tools that are nearly free in
    batched form (e.g. multiple TX types evaluated as one extra matmul) stay
    on at faster presets than in the reference.
    """
    m = cfg.enc_mode

    def auto(value: int, default: bool) -> bool:
        return default if value == -1 else bool(value)

    def auto_i(value: int, default: int) -> int:
        return default if value == -1 else int(value)

    return DerivedSignals(
        enable_hme_level1=auto(cfg.enable_hme_level1, True),
        enable_hme_level2=auto(cfg.enable_hme_level2, m <= 6),
        enable_paeth=auto(cfg.enable_paeth, m <= 7),
        enable_smooth=auto(cfg.enable_smooth, m <= 7),
        enable_cfl=auto(cfg.enable_cfl, m <= 6),
        enable_filter_intra=auto(cfg.filter_intra_level, m <= 4),
        enable_intra_edge_filter=auto(cfg.enable_intra_edge_filter, True),
        intra_angle_delta=auto(cfg.intra_angle_delta, m <= 5),
        cdef_level=cfg.cdef_level if cfg.cdef_level != -1 else (4 if m <= 5 else 2),
        # per-fb strength indices need the entropy pass to run after the
        # search (finish_cdef_search); quality presets already re-code
        # tiles for LR, so the signalling rides along
        cdef_multi=m <= 6,
        enable_restoration=auto(cfg.enable_restoration, m <= 6),
        # derived signal surface stays honest
        enable_warped_motion=auto(cfg.enable_warped_motion,
                                  m <= 5 and cfg.encoder_bit_depth == 8),
        enable_adaptive_quantization=auto(
            cfg.enable_adaptive_quantization, m <= 6),
        obmc_level=auto_i(cfg.obmc_level,
                          1 if m <= 5 and cfg.encoder_bit_depth == 8
                          else 0),
        # the frame-batched device path scores averaged compound per
        # unit at negligible cost, so compound stays on across the
        # preset ladder (set_comp_controls analog)
        # 1 = averaged compound; 2 adds the masked types (wedge +
        # diffwtd, the reference's inter_compound_mode ladder) at the
        # quality presets where the per-block RD walk runs
        compound_level=cfg.compound_level if cfg.compound_level != -1
        else (2 if m <= 4 else 1),
        interintra_level=1 if m <= 4 else 0,
        # the reference filters layer-0 pictures at EVERY preset: level
        # 1/2 (full window) below M7, level 4 (small window) above
        # (set_tf_controls, EbPictureDecisionProcess.c:3820-3840); our
        # level 2 = small (3-frame) window
        tf_level=cfg.tf_level if cfg.tf_level != -1 else (1 if m <= 6 else 2),
        # the reference keeps RDOQ on at every preset (rdoq_level 1 for
        # <=M7, 2/3 with speed gates above); our level 1 = full trellis
        # with quantize_fp feeding it (set_rdoq_controls,
        # EbEncDecProcess.c:2090)
        rdoq_level=auto_i(cfg.rdoq_level, 1),
        # palette: on when screen-content mode requests it (the
        # reference gates palette_level by sc_class; explicit knob wins)
        palette_level=(cfg.palette_level if cfg.palette_level != -1
                       else (1 if cfg.screen_content_mode == 1 else 0)),
        intrabc_level=(cfg.intrabc_mode if cfg.intrabc_mode != -1
                       else (1 if cfg.screen_content_mode == 1 else 0)),
        md_stage_nics=(64, 16, 8, 4) if m <= 2 else ((32, 12, 6, 3) if m <= 5 else (16, 8, 4, 2)),
        # the reference's ME process searches SOURCE pictures at every
        # preset (open loop, EbMotionEstimationProcess.c); the batched
        # plan adopts that at the fastest preset, which also decouples
        # the device plan from the recon chain (cross-frame pipelining)
        open_loop_me=(m >= 8),
    )


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Decoder configuration (ref: EbSvtAv1DecConfiguration,
    Source/API/EbSvtAv1Dec.h)."""

    max_bit_depth: int = 10
    color_format: ColorFormat = ColorFormat.YUV420
    skip_frames: int = 0
    frames_to_decode: int = -1
    compute_md5: bool = False
