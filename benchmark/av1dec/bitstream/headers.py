"""AV1 OBU syntax: sequence header, frame header, OBU wrapping.

Writer and parser for the uncompressed header layer (AV1 spec sections
5.5 sequence_header_obu, 5.9 frame_header_obu, 5.2 OBU framing).
Behavioral parity: writer Source/Lib/Encoder/Codec/EbEntropyCoding.c
(write_sequence_header / write_frame_header_av1), parser
Source/Lib/Decoder/Codec/EbDecParseObu.c.

Both directions are implemented side by side and kept feature-locked;
the parser is also the conformance harness for our own streams.
"""
from __future__ import annotations


class UnsupportedBitstream(ValueError):
    """A legal AV1 feature this decoder does not implement yet (raised
    with a typed surface instead of bare asserts — the
    EbSvtAv1ErrorCodes.h contract analog)."""


import dataclasses

from ..constants import FrameType, ObuType
from .bits import BitReader, BitWriter, leb128_decode, leb128_encode

PRIMARY_REF_NONE = 7

# qp (0..63) -> qindex (EbModeDecisionProcess.h:632; libaom convention)
QUANTIZER_TO_QINDEX = [q * 4 for q in range(62)] + [249, 255]


@dataclasses.dataclass
class SequenceHeader:
    """The sequence-level feature set (subset of spec fields we emit;
    all omitted spec fields are written as their 'disabled' choice)."""

    max_frame_width: int = 0
    max_frame_height: int = 0
    seq_profile: int = 0
    seq_level_idx: int = 8          # 4.0; always legal for our sizes
    seq_tier: int = 0
    use_128x128_superblock: bool = False
    enable_filter_intra: bool = True
    enable_intra_edge_filter: bool = True
    enable_order_hint: bool = False
    order_hint_bits: int = 7
    enable_superres: bool = False
    enable_cdef: bool = False
    enable_restoration: bool = False
    bit_depth: int = 8
    monochrome: bool = False
    color_range: int = 0
    chroma_sample_position: int = 0
    separate_uv_delta_q: bool = False
    enable_warped_motion: bool = False
    enable_interintra_compound: bool = False
    enable_masked_compound: bool = False
    film_grain_params_present: bool = False
    still_picture: bool = False
    # screen content: 0 = off, 2 = per-frame selection (spec
    # seq_force_screen_content_tools / seq_force_integer_mv)
    force_screen_content_tools: int = 0
    force_integer_mv: int = 2
    # derived
    frame_width_bits: int = 16
    frame_height_bits: int = 16

    @property
    def sb_size(self) -> int:
        return 128 if self.use_128x128_superblock else 64


@dataclasses.dataclass
class FrameHeader:
    """Per-frame header state (subset for the all-intra path)."""

    frame_type: FrameType = FrameType.KEY_FRAME
    show_frame: bool = True
    showable_frame: bool = False
    error_resilient_mode: bool = False
    order_hint: int = 0
    ref_frame_idx: tuple = (0, 0, 0, 0, 0, 0, 0)   # LAST..ALTREF -> slot
    reference_select: bool = False
    frame_width: int = 0
    frame_height: int = 0
    base_q_idx: int = 50
    disable_cdf_update: bool = False
    allow_screen_content_tools: bool = False
    force_integer_mv: bool = False
    allow_intrabc: bool = False
    interpolation_filter: int = 0    # frame-level (EIGHTTAP_REGULAR..)
    tx_mode_select: bool = False     # False -> TX_MODE_LARGEST
    reduced_tx_set: bool = False
    filter_level: tuple[int, int] = (0, 0)
    filter_level_uv: tuple[int, int] = (0, 0)
    sharpness: int = 0
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    context_update_tile_id: int = 0
    tile_size_bytes: int = 4
    primary_ref_frame: int = PRIMARY_REF_NONE
    is_motion_mode_switchable: bool = False
    allow_warped_motion: bool = False
    # segmentation: per-segment ALT_Q deltas; () -> disabled
    seg_qdeltas: tuple = ()
    # global motion per named ref LAST..ALTREF: (wmtype, (m0..m5)) with
    # wmmat in WARPEDMODEL_PREC_BITS precision; () -> all IDENTITY
    global_motion: tuple = ()
    # PrevGmParams: the primary ref frame's gm mats (7 x (m0..m5)),
    # reference values for delta-coding this frame's params (spec
    # read_global_param); () -> identity (primary_ref_frame == NONE)
    prev_gm: tuple = ()
    refresh_frame_flags: int = 0xFF
    disable_frame_end_update_cdf: bool = False
    # CDEF (spec 5.9.19 cdef_params; only read when seq.enable_cdef)
    cdef_damping: int = 3
    cdef_bits: int = 0
    cdef_y_strengths: tuple = (0,)
    cdef_uv_strengths: tuple = (0,)
    # loop restoration (spec 5.9.20 lr_params)
    lr_type: tuple = (0, 0, 0)        # RestorationType per plane
    # luma unit = 256 >> (2 - shift); 128x128 superblocks need shift >= 1
    lr_unit_shift: int = 1
    lr_uv_shift: int = 1

    film_grain: object = None         # FilmGrainParams when signaled
    # super-resolution: frame_width is the CODED width; denom 8 = off
    superres_denom: int = 8
    upscaled_width: int = 0

    def lr_unit_size(self, plane: int) -> int:
        size = 256 >> (2 - self.lr_unit_shift)
        return size >> (self.lr_uv_shift if plane else 0)

    @property
    def uses_lr(self) -> bool:
        return any(self.lr_type)

    @property
    def coded_lossless(self) -> bool:
        return self.base_q_idx == 0

    def mi_cols(self) -> int:
        return 2 * ((self.frame_width + 7) >> 3)

    def mi_rows(self) -> int:
        return 2 * ((self.frame_height + 7) >> 3)


# --------------------------------------------------------------------------
# Sequence header
# --------------------------------------------------------------------------

def write_sequence_header(seq: SequenceHeader) -> bytes:
    w = BitWriter()
    w.f(seq.seq_profile, 3)
    w.flag(seq.still_picture)
    w.flag(False)                       # reduced_still_picture_header
    w.flag(False)                       # timing_info_present
    w.flag(False)                       # initial_display_delay_present
    w.f(0, 5)                           # operating_points_cnt_minus_1
    w.f(0, 12)                          # operating_point_idc[0]
    w.f(seq.seq_level_idx, 5)
    if seq.seq_level_idx > 7:
        w.flag(seq.seq_tier)
    w.f(seq.frame_width_bits - 1, 4)
    w.f(seq.frame_height_bits - 1, 4)
    w.f(seq.max_frame_width - 1, seq.frame_width_bits)
    w.f(seq.max_frame_height - 1, seq.frame_height_bits)
    w.flag(False)                       # frame_id_numbers_present
    w.flag(seq.use_128x128_superblock)
    w.flag(seq.enable_filter_intra)
    w.flag(seq.enable_intra_edge_filter)
    w.flag(seq.enable_interintra_compound)
    w.flag(seq.enable_masked_compound)
    w.flag(seq.enable_warped_motion)
    w.flag(False)                       # enable_dual_filter
    w.flag(seq.enable_order_hint)
    if seq.enable_order_hint:
        w.flag(False)                   # enable_jnt_comp
        w.flag(False)                   # enable_ref_frame_mvs
    if seq.force_screen_content_tools == 2:
        w.flag(True)                    # seq_choose_screen_content_tools
    else:
        w.flag(False)
        w.flag(seq.force_screen_content_tools == 1)
    if seq.force_screen_content_tools > 0:
        if seq.force_integer_mv == 2:
            w.flag(True)                # seq_choose_integer_mv
        else:
            w.flag(False)
            w.flag(seq.force_integer_mv == 1)
    if seq.enable_order_hint:
        w.f(seq.order_hint_bits - 1, 3)
    w.flag(seq.enable_superres)
    w.flag(seq.enable_cdef)
    w.flag(seq.enable_restoration)
    _write_color_config(w, seq)
    w.flag(seq.film_grain_params_present)
    w.trailing_bits()
    return w.bytes()


def _write_color_config(w: BitWriter, seq: SequenceHeader) -> None:
    high_bitdepth = seq.bit_depth > 8
    w.flag(high_bitdepth)
    if seq.seq_profile == 2 and high_bitdepth:
        w.flag(seq.bit_depth == 12)     # twelve_bit
    if seq.seq_profile != 1:
        w.flag(seq.monochrome)
    w.flag(False)                       # color_description_present
    if seq.monochrome:
        w.flag(bool(seq.color_range))
        return
    # color unspecified: NOT (ITU-R 709 + sRGB identity) path
    w.flag(bool(seq.color_range))
    # profile 0: 420 implied; subsampling_x/y = 1
    w.f(seq.chroma_sample_position, 2)
    w.flag(seq.separate_uv_delta_q)


def parse_sequence_header(data: bytes) -> SequenceHeader:
    r = BitReader(data)
    seq = SequenceHeader()
    seq.seq_profile = r.f(3)
    seq.still_picture = r.flag()
    reduced = r.flag()
    if reduced:
        raise UnsupportedBitstream("reduced_still_picture_header")
    timing = r.flag()
    assert not timing
    r.flag()                             # initial_display_delay
    op_cnt = r.f(5) + 1
    for _ in range(op_cnt):
        r.f(12)
        idx = r.f(5)
        if idx > 7:
            r.flag()
    seq.seq_level_idx = idx
    seq.frame_width_bits = r.f(4) + 1
    seq.frame_height_bits = r.f(4) + 1
    seq.max_frame_width = r.f(seq.frame_width_bits) + 1
    seq.max_frame_height = r.f(seq.frame_height_bits) + 1
    fid = r.flag()
    if fid:
        raise UnsupportedBitstream("frame_id_numbers")
    seq.use_128x128_superblock = r.flag()
    seq.enable_filter_intra = r.flag()
    seq.enable_intra_edge_filter = r.flag()
    seq.enable_interintra_compound = r.flag()
    seq.enable_masked_compound = r.flag()
    seq.enable_warped_motion = r.flag()
    r.flag()                             # enable_dual_filter
    seq.enable_order_hint = r.flag()
    if seq.enable_order_hint:
        if r.flag():
            raise UnsupportedBitstream("enable_jnt_comp")
        if r.flag():
            raise UnsupportedBitstream("enable_ref_frame_mvs")
    choose_sc = r.flag()
    if choose_sc:
        force_sc = 2
    else:
        force_sc = r.f(1)
    seq.force_screen_content_tools = force_sc
    if force_sc > 0:
        if r.flag():                     # seq_choose_integer_mv
            seq.force_integer_mv = 2
        else:
            seq.force_integer_mv = r.f(1)
    if seq.enable_order_hint:
        seq.order_hint_bits = r.f(3) + 1
    seq.enable_superres = r.flag()
    seq.enable_cdef = r.flag()
    seq.enable_restoration = r.flag()
    _parse_color_config(r, seq)
    seq.film_grain_params_present = r.flag()
    return seq


def _parse_color_config(r: BitReader, seq: SequenceHeader) -> None:
    high = r.flag()
    if seq.seq_profile == 2 and high:
        seq.bit_depth = 12 if r.flag() else 10
    else:
        seq.bit_depth = 10 if high else 8
    seq.monochrome = r.flag() if seq.seq_profile != 1 else False
    desc = r.flag()
    if desc:
        r.f(8)
        r.f(8)
        r.f(8)
    if seq.monochrome:
        seq.color_range = r.f(1)
        return
    seq.color_range = r.f(1)
    if seq.seq_profile == 0:
        pass                             # 420
    else:
        raise UnsupportedBitstream("profile > 0 chroma")
    seq.chroma_sample_position = r.f(2)
    seq.separate_uv_delta_q = r.flag()


# --------------------------------------------------------------------------
# Frame header (key frame / intra-only path)
# --------------------------------------------------------------------------

def _tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


def tile_limits(seq: SequenceHeader, fh: FrameHeader):
    sb_shift = 5 if seq.use_128x128_superblock else 4
    sb_size_log2 = sb_shift + 2
    sb_cols = (fh.mi_cols() + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (fh.mi_rows() + (1 << sb_shift) - 1) >> sb_shift
    max_tile_width_sb = 4096 >> sb_size_log2
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size_log2)
    min_log2_tile_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_tile_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_tile_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_tile_cols,
                         _tile_log2(max_tile_area_sb, sb_cols * sb_rows))
    return (sb_cols, sb_rows, min_log2_tile_cols, max_log2_tile_cols,
            max_log2_tile_rows, min_log2_tiles)


def write_show_existing_header(w: BitWriter, map_idx: int) -> None:
    """show_existing_frame short header (spec 5.9.2)."""
    w.flag(True)
    w.f(map_idx, 3)


def get_relative_dist(seq: SequenceHeader, a: int, b: int) -> int:
    """spec get_relative_dist over wrapped order hints."""
    if not seq.enable_order_hint:
        return 0
    bits = seq.order_hint_bits
    diff = (a - b) & ((1 << bits) - 1)
    m = 1 << (bits - 1)
    return (diff & (m - 1)) - (diff & m)


def skip_mode_allowed(seq: SequenceHeader, fh: FrameHeader,
                      ref_order_hints) -> bool:
    """spec 5.9.22 skip mode params: whether skip_mode_present is coded.
    ref_order_hints: order hint per DPB slot (the decoder's state)."""
    if (fh.frame_type != FrameType.INTER_FRAME or not fh.reference_select
            or not seq.enable_order_hint):
        return False
    cur = fh.order_hint & ((1 << seq.order_hint_bits) - 1)
    fwd_idx = bwd_idx = -1
    fwd_hint = bwd_hint = 0
    for i in range(7):
        ref_hint = ref_order_hints[fh.ref_frame_idx[i]]
        d = get_relative_dist(seq, ref_hint, cur)
        if d < 0:
            if fwd_idx < 0 or get_relative_dist(seq, ref_hint, fwd_hint) > 0:
                fwd_idx, fwd_hint = i, ref_hint
        elif d > 0:
            if bwd_idx < 0 or get_relative_dist(seq, ref_hint, bwd_hint) < 0:
                bwd_idx, bwd_hint = i, ref_hint
    if fwd_idx < 0:
        return False
    if bwd_idx >= 0:
        return True
    snd_idx = -1
    snd_hint = 0
    for i in range(7):
        ref_hint = ref_order_hints[fh.ref_frame_idx[i]]
        if get_relative_dist(seq, ref_hint, fwd_hint) < 0:
            if snd_idx < 0 or get_relative_dist(seq, ref_hint, snd_hint) > 0:
                snd_idx, snd_hint = i, ref_hint
    return snd_idx >= 0


def write_frame_header(w: BitWriter, seq: SequenceHeader, fh: FrameHeader,
                       ref_order_hints=(0,) * 8) -> None:
    """Write the uncompressed header (no trailing bits; the caller
    byte-aligns per OBU type).  Syntax mirrors the reference writer
    write_uncompressed_header_obu (EbEntropyCoding.c:4022)."""
    is_inter = fh.frame_type == FrameType.INTER_FRAME
    w.flag(False)                        # show_existing_frame
    w.f(int(fh.frame_type), 2)
    w.flag(fh.show_frame)
    if not fh.show_frame:
        w.flag(fh.showable_frame)
    if not (fh.frame_type == FrameType.KEY_FRAME and fh.show_frame):
        w.flag(fh.error_resilient_mode)
    w.flag(fh.disable_cdf_update)
    if seq.force_screen_content_tools == 2:
        w.flag(fh.allow_screen_content_tools)
    if fh.allow_screen_content_tools and seq.force_integer_mv == 2:
        # force_integer_mv: 1 whenever screen content is on (intra
        # frames override to 1 regardless, spec 5.9.2)
        w.flag(True)
    w.flag(False)                        # frame_size_override_flag
    if seq.enable_order_hint:
        w.f(fh.order_hint & ((1 << seq.order_hint_bits) - 1),
            seq.order_hint_bits)
    if not fh.error_resilient_mode and is_inter:
        w.f(fh.primary_ref_frame, 3)
    if is_inter:
        w.f(fh.refresh_frame_flags, 8)
        if fh.error_resilient_mode and seq.enable_order_hint:
            raise UnsupportedBitstream("ER + order hints ref_order_hint")
        if seq.enable_order_hint:
            w.flag(False)                # frame_refs_short_signaling
        for i in range(7):
            w.f(fh.ref_frame_idx[i], 3)
        _write_frame_size(w, seq, fh)
        _write_render_size(w)
        w.flag(False)                    # allow_high_precision_mv
        w.flag(False)                    # is_filter_switchable
        # frame-level filter (read_interpolation_filter): the encoder's
        # 3-way search picks REGULAR/SMOOTH/SHARP per inter frame
        # (interpolation_filter_search analog, EbEncInterPrediction.c:3047)
        w.f(fh.interpolation_filter, 2)
        w.flag(fh.is_motion_mode_switchable)
        # use_ref_frame_mvs: seq.enable_ref_frame_mvs == 0 -> skipped
    else:
        if not fh.show_frame:
            w.f(fh.refresh_frame_flags, 8)
        _write_frame_size(w, seq, fh)
        _write_render_size(w)
        if fh.allow_screen_content_tools and fh.superres_denom == 8:
            w.flag(fh.allow_intrabc)
    if not fh.disable_cdf_update:
        w.flag(fh.disable_frame_end_update_cdf)
    _write_tile_info(w, seq, fh)
    _write_quantization_params(w, seq, fh)
    _write_segmentation(w, fh)
    if fh.base_q_idx > 0:
        w.flag(False)                    # delta_q_present
    if not (fh.coded_lossless or fh.allow_intrabc):
        _write_loop_filter_params(w, seq, fh)
    _write_cdef_params(w, seq, fh)
    _write_lr_params(w, seq, fh)
    if not fh.coded_lossless:
        w.flag(fh.tx_mode_select)        # read_tx_mode
    if is_inter:
        w.flag(fh.reference_select)
    if skip_mode_allowed(seq, fh, ref_order_hints):
        w.flag(False)                    # skip_mode_present
    if (is_inter and not fh.error_resilient_mode
            and seq.enable_warped_motion):
        w.flag(fh.allow_warped_motion)
    w.flag(fh.reduced_tx_set)
    if is_inter:
        _write_global_motion(w, fh)
    _write_film_grain(w, seq, fh)


def _write_frame_size(w: BitWriter, seq: SequenceHeader, fh: FrameHeader) -> None:
    # frame_size_override_flag == 0: the (upscaled) size comes from the
    # sequence header; superres_params derive the coded width (spec 5.9.8)
    assert (fh.upscaled_width or fh.frame_width) == seq.max_frame_width
    assert fh.frame_height == seq.max_frame_height
    if seq.enable_superres:
        use = fh.superres_denom != 8
        w.flag(use)
        if use:
            w.f(fh.superres_denom - 9, 3)
    # compute_image_size side effects only


def _write_render_size(w: BitWriter) -> None:
    w.flag(False)                        # render_and_frame_size_different


def _write_tile_info(w: BitWriter, seq: SequenceHeader, fh: FrameHeader) -> None:
    (sb_cols, sb_rows, min_lc, max_lc, max_lr, min_lt) = tile_limits(seq, fh)
    tcl, trl = fh.tile_cols_log2, fh.tile_rows_log2
    assert min_lc <= tcl <= max_lc, (min_lc, tcl, max_lc)
    w.flag(True)                         # uniform_tile_spacing
    for i in range(min_lc, max_lc):      # increment_tile_cols_log2
        more = tcl > i
        w.flag(more)
        if not more:
            break
    min_log2_tile_rows = max(min_lt - tcl, 0)
    assert min_log2_tile_rows <= trl <= max_lr
    for i in range(min_log2_tile_rows, max_lr):
        more = trl > i
        w.flag(more)
        if not more:
            break
    if tcl > 0 or trl > 0:
        w.f(fh.context_update_tile_id, tcl + trl)
        w.f(fh.tile_size_bytes - 1, 2)   # tile_size_bytes_minus_1


def _write_quantization_params(w: BitWriter, seq: SequenceHeader, fh: FrameHeader) -> None:
    w.f(fh.base_q_idx, 8)
    w.flag(False)                        # delta_q_y_dc == 0
    if not seq.monochrome:
        if seq.separate_uv_delta_q:
            w.flag(False)                # diff_uv_delta
        w.flag(False)                    # delta_q_u_dc
        w.flag(False)                    # delta_q_u_ac
    w.flag(False)                        # using_qmatrix


def _write_loop_filter_params(w: BitWriter, seq: SequenceHeader, fh: FrameHeader) -> None:
    w.f(fh.filter_level[0], 6)
    w.f(fh.filter_level[1], 6)
    if not seq.monochrome:
        if fh.filter_level[0] or fh.filter_level[1]:
            w.f(fh.filter_level_uv[0], 6)
            w.f(fh.filter_level_uv[1], 6)
    w.f(fh.sharpness, 3)
    w.flag(False)                        # loop_filter_delta_enabled


def _write_cdef_params(w: BitWriter, seq: SequenceHeader, fh: FrameHeader) -> None:
    if fh.coded_lossless or fh.allow_intrabc or not seq.enable_cdef:
        return
    w.f(fh.cdef_damping - 3, 2)
    w.f(fh.cdef_bits, 2)
    n = 1 << fh.cdef_bits
    assert len(fh.cdef_y_strengths) == n
    for i in range(n):
        w.f(fh.cdef_y_strengths[i], 6)
        if not seq.monochrome:
            w.f(fh.cdef_uv_strengths[i], 6)


# coded lr_type value -> RestorationType (spec remap_lr_type)
REMAP_LR_TYPE = (0, 3, 1, 2)          # NONE, SWITCHABLE, WIENER, SGRPROJ
LR_TYPE_TO_CODED = {t: i for i, t in enumerate(REMAP_LR_TYPE)}


def _write_lr_params(w: BitWriter, seq: SequenceHeader, fh: FrameHeader) -> None:
    if fh.coded_lossless or fh.allow_intrabc or not seq.enable_restoration:
        return
    n_planes = 1 if seq.monochrome else 3
    for p in range(n_planes):
        w.f(LR_TYPE_TO_CODED[fh.lr_type[p]], 2)
    uses_lr = any(fh.lr_type[:n_planes])
    uses_chroma_lr = any(fh.lr_type[1:n_planes])
    if not uses_lr:
        return
    if seq.use_128x128_superblock:
        w.f(fh.lr_unit_shift - 1, 1)
    else:
        w.f(min(fh.lr_unit_shift, 1), 1)
        if fh.lr_unit_shift:
            w.f(fh.lr_unit_shift - 1, 1)
    if not seq.monochrome and uses_chroma_lr:
        w.f(fh.lr_uv_shift, 1)           # 4:2:0: one shift bit


def _parse_superres(r: BitReader, seq: SequenceHeader,
                    fh: FrameHeader) -> None:
    from ..ops.superres import scaled_dim

    fh.upscaled_width = fh.frame_width
    if not seq.enable_superres:
        return
    if r.flag():
        fh.superres_denom = r.f(3) + 9
        fh.frame_width = scaled_dim(fh.upscaled_width, fh.superres_denom)


def parse_frame_header(r: BitReader, seq: SequenceHeader,
                       ref_order_hints=(0,) * 8, saved_gm=None):
    """Returns a FrameHeader, or an int map_idx for show_existing_frame.

    ``saved_gm``: per-DPB-slot SavedGmParams (8 entries of 7 mats or
    None) used as the delta-coding reference for global motion when
    primary_ref_frame != NONE (spec load_previous)."""
    fh = FrameHeader()
    show_existing = r.flag()
    if show_existing:
        return r.f(3)
    fh.frame_type = FrameType(r.f(2))
    fh.show_frame = r.flag()
    is_inter = fh.frame_type == FrameType.INTER_FRAME
    assert fh.frame_type in (
        FrameType.KEY_FRAME, FrameType.INTER_FRAME), "unsupported frame type"
    if not fh.show_frame:
        fh.showable_frame = r.flag()
    if not (fh.frame_type == FrameType.KEY_FRAME and fh.show_frame):
        fh.error_resilient_mode = r.flag()
    fh.disable_cdf_update = r.flag()
    if seq.force_screen_content_tools == 2:
        fh.allow_screen_content_tools = r.flag()
    else:
        fh.allow_screen_content_tools = seq.force_screen_content_tools == 1
    if fh.allow_screen_content_tools and seq.force_integer_mv == 2:
        fh.force_integer_mv = r.flag()
    # Screen-content syntax (palette / IBC / integer-MV) is only
    # implemented for intra frames; fail loud on foreign SCT inter
    # streams rather than silently desyncing the symbol decoder.
    if fh.allow_screen_content_tools and \
            fh.frame_type != FrameType.KEY_FRAME:
        raise UnsupportedBitstream(
            "screen content tools on a non-key frame")
    size_override = r.flag()
    assert not size_override
    fh.frame_width = seq.max_frame_width
    fh.frame_height = seq.max_frame_height
    if seq.enable_order_hint:
        fh.order_hint = r.f(seq.order_hint_bits)
    if not fh.error_resilient_mode and is_inter:
        fh.primary_ref_frame = r.f(3)
    if is_inter:
        fh.refresh_frame_flags = r.f(8)
        assert not (fh.error_resilient_mode and seq.enable_order_hint)
        if seq.enable_order_hint:
            assert not r.flag()          # frame_refs_short_signaling
        fh.ref_frame_idx = tuple(r.f(3) for _ in range(7))
        if fh.primary_ref_frame != PRIMARY_REF_NONE and saved_gm:
            prev = saved_gm[fh.ref_frame_idx[fh.primary_ref_frame]]
            fh.prev_gm = tuple(prev) if prev else ()
        _parse_superres(r, seq, fh)
        assert not r.flag()              # render size diff
        assert not r.flag()              # allow_high_precision_mv
        assert not r.flag()              # is_filter_switchable
        fh.interpolation_filter = r.f(2)
        fh.is_motion_mode_switchable = r.flag()
    else:
        if not fh.show_frame:
            fh.refresh_frame_flags = r.f(8)
        _parse_superres(r, seq, fh)
        render_diff = r.flag()
        assert not render_diff
        if fh.allow_screen_content_tools and fh.superres_denom == 8:
            fh.allow_intrabc = r.flag()
    if not fh.disable_cdf_update:
        fh.disable_frame_end_update_cdf = r.flag()
    else:
        fh.disable_frame_end_update_cdf = True
    # tile info
    (sb_cols, sb_rows, min_lc, max_lc, max_lr, min_lt) = tile_limits(seq, fh)
    uniform = r.flag()
    assert uniform
    tcl = min_lc
    while tcl < max_lc:
        if not r.flag():
            break
        tcl += 1
    fh.tile_cols_log2 = tcl
    min_log2_tile_rows = max(min_lt - tcl, 0)
    trl = min_log2_tile_rows
    while trl < max_lr:
        if not r.flag():
            break
        trl += 1
    fh.tile_rows_log2 = trl
    if tcl > 0 or trl > 0:
        fh.context_update_tile_id = r.f(tcl + trl)
        fh.tile_size_bytes = r.f(2) + 1
    # quantization
    fh.base_q_idx = r.f(8)
    assert not r.flag()                  # delta_q_y_dc
    if not seq.monochrome:
        if seq.separate_uv_delta_q:
            assert not r.flag()
        assert not r.flag()              # u_dc
        assert not r.flag()              # u_ac
    assert not r.flag()                  # using_qmatrix
    _parse_segmentation(r, fh)
    if fh.base_q_idx > 0:
        assert not r.flag()              # delta_q_present
    if not (fh.coded_lossless or fh.allow_intrabc):
        l0 = r.f(6)
        l1 = r.f(6)
        fh.filter_level = (l0, l1)
        if not seq.monochrome and (l0 or l1):
            fh.filter_level_uv = (r.f(6), r.f(6))
        fh.sharpness = r.f(3)
        assert not r.flag()              # delta enabled
    if seq.enable_cdef and not (fh.coded_lossless or fh.allow_intrabc):
        fh.cdef_damping = r.f(2) + 3
        fh.cdef_bits = r.f(2)
        ys, uvs = [], []
        for _ in range(1 << fh.cdef_bits):
            ys.append(r.f(6))
            uvs.append(r.f(6) if not seq.monochrome else 0)
        fh.cdef_y_strengths = tuple(ys)
        fh.cdef_uv_strengths = tuple(uvs)
    if seq.enable_restoration and not (fh.coded_lossless or fh.allow_intrabc):
        n_planes = 1 if seq.monochrome else 3
        fh.lr_type = tuple(REMAP_LR_TYPE[r.f(2)] for _ in range(n_planes))
        uses_lr = any(fh.lr_type)
        uses_chroma_lr = any(fh.lr_type[1:])
        fh.lr_uv_shift = 0
        if uses_lr:
            if seq.use_128x128_superblock:
                fh.lr_unit_shift = r.f(1) + 1
            else:
                fh.lr_unit_shift = r.f(1)
                if fh.lr_unit_shift:
                    fh.lr_unit_shift += r.f(1)
            if not seq.monochrome and uses_chroma_lr:
                fh.lr_uv_shift = r.f(1)
    if not fh.coded_lossless:
        fh.tx_mode_select = r.flag()
    if is_inter:
        fh.reference_select = r.flag()
    if skip_mode_allowed(seq, fh, ref_order_hints):
        assert not r.flag(), "skip_mode_present unsupported"
    if (is_inter and not fh.error_resilient_mode
            and seq.enable_warped_motion):
        fh.allow_warped_motion = r.flag()
    fh.reduced_tx_set = r.flag()
    if is_inter:
        _parse_global_motion(r, fh)
    _parse_film_grain(r, seq, fh)
    return fh


def _write_film_grain(w: BitWriter, seq: SequenceHeader,
                      fh: FrameHeader) -> None:
    """spec 5.9.30 film_grain_params (write path; update_grain only)."""
    if not seq.film_grain_params_present or not (fh.show_frame
                                                 or fh.showable_frame):
        return
    fg = fh.film_grain
    w.flag(fg is not None and fg.apply_grain)
    if fg is None or not fg.apply_grain:
        return
    w.f(fg.grain_seed, 16)
    if fh.frame_type == FrameType.INTER_FRAME:
        w.flag(True)                     # update_grain
    w.f(len(fg.scaling_points_y), 4)
    for x, v in fg.scaling_points_y:
        w.f(x, 8)
        w.f(v, 8)
    if not seq.monochrome:
        w.flag(fg.chroma_scaling_from_luma)
    no_chroma = seq.monochrome or fg.chroma_scaling_from_luma or \
        not fg.scaling_points_y        # 4:2:0 && num_y == 0
    if not no_chroma:
        w.f(len(fg.scaling_points_cb), 4)
        for x, v in fg.scaling_points_cb:
            w.f(x, 8)
            w.f(v, 8)
        w.f(len(fg.scaling_points_cr), 4)
        for x, v in fg.scaling_points_cr:
            w.f(x, 8)
            w.f(v, 8)
    w.f(fg.scaling_shift - 8, 2)
    w.f(fg.ar_coeff_lag, 2)
    num_pos = 2 * fg.ar_coeff_lag * (fg.ar_coeff_lag + 1)
    if fg.scaling_points_y:
        for c in fg.ar_coeffs_y:
            w.f(c + 128, 8)
    if fg.chroma_scaling_from_luma or fg.scaling_points_cb:
        for c in fg.ar_coeffs_cb:
            w.f(c + 128, 8)
    if fg.chroma_scaling_from_luma or fg.scaling_points_cr:
        for c in fg.ar_coeffs_cr:
            w.f(c + 128, 8)
    w.f(fg.ar_coeff_shift - 6, 2)
    w.f(fg.grain_scale_shift, 2)
    if fg.scaling_points_cb:
        w.f(fg.cb_mult, 8)
        w.f(fg.cb_luma_mult, 8)
        w.f(fg.cb_offset, 9)
    if fg.scaling_points_cr:
        w.f(fg.cr_mult, 8)
        w.f(fg.cr_luma_mult, 8)
        w.f(fg.cr_offset, 9)
    w.flag(fg.overlap_flag)
    w.flag(fg.clip_to_restricted_range)


def _parse_film_grain(r: BitReader, seq: SequenceHeader,
                      fh: FrameHeader) -> None:
    from ..ops.film_grain import FilmGrainParams

    if not seq.film_grain_params_present or not (fh.show_frame
                                                 or fh.showable_frame):
        return
    if not r.flag():                     # apply_grain
        return
    fg = FilmGrainParams(apply_grain=True)
    fg.grain_seed = r.f(16)
    if fh.frame_type == FrameType.INTER_FRAME:
        assert r.flag(), "film grain ref-load unsupported"
    n = r.f(4)
    fg.scaling_points_y = [(r.f(8), r.f(8)) for _ in range(n)]
    if not seq.monochrome:
        fg.chroma_scaling_from_luma = r.flag()
    no_chroma = seq.monochrome or fg.chroma_scaling_from_luma or \
        not fg.scaling_points_y
    if not no_chroma:
        n = r.f(4)
        fg.scaling_points_cb = [(r.f(8), r.f(8)) for _ in range(n)]
        n = r.f(4)
        fg.scaling_points_cr = [(r.f(8), r.f(8)) for _ in range(n)]
    fg.scaling_shift = r.f(2) + 8
    fg.ar_coeff_lag = r.f(2)
    num_pos = 2 * fg.ar_coeff_lag * (fg.ar_coeff_lag + 1)
    if fg.scaling_points_y:
        fg.ar_coeffs_y = [r.f(8) - 128 for _ in range(num_pos)]
    npc = num_pos + (1 if fg.scaling_points_y else 0)
    if fg.chroma_scaling_from_luma or fg.scaling_points_cb:
        fg.ar_coeffs_cb = [r.f(8) - 128 for _ in range(npc)]
    if fg.chroma_scaling_from_luma or fg.scaling_points_cr:
        fg.ar_coeffs_cr = [r.f(8) - 128 for _ in range(npc)]
    fg.ar_coeff_shift = r.f(2) + 6
    fg.grain_scale_shift = r.f(2)
    if fg.scaling_points_cb:
        fg.cb_mult = r.f(8)
        fg.cb_luma_mult = r.f(8)
        fg.cb_offset = r.f(9)
    if fg.scaling_points_cr:
        fg.cr_mult = r.f(8)
        fg.cr_luma_mult = r.f(8)
        fg.cr_offset = r.f(9)
    fg.overlap_flag = r.flag()
    fg.clip_to_restricted_range = r.flag()
    fh.film_grain = fg


# --------------------------------------------------------------------------
# OBU framing
# --------------------------------------------------------------------------

def wrap_obu(obu_type: ObuType, payload: bytes) -> bytes:
    header = bytes([(int(obu_type) << 3) | 0x02])   # has_size_field
    return header + leb128_encode(len(payload)) + payload


def temporal_delimiter_obu() -> bytes:
    return wrap_obu(ObuType.OBU_TEMPORAL_DELIMITER, b"")


def iter_obus(data: bytes):
    """Yield (obu_type, payload) from a frame unit."""
    pos = 0
    while pos < len(data):
        hdr = data[pos]
        obu_type = ObuType((hdr >> 3) & 0xF)
        has_ext = (hdr >> 2) & 1
        has_size = (hdr >> 1) & 1
        pos += 1 + has_ext
        if not has_size:
            yield obu_type, data[pos:]
            return
        size, pos = leb128_decode(data, pos)
        yield obu_type, data[pos:pos + size]
        pos += size

# --------------------------------------------------------------------------
# Global motion (global_motion_params, spec 5.9.24; write:
# EbEntropyCoding.c:3535 write_global_motion_params, read:
# EbDecParseObu.c:1136 read_global_param)
# --------------------------------------------------------------------------

GM_IDENTITY, GM_TRANSLATION, GM_ROTZOOM, GM_AFFINE = 0, 1, 2, 3
WARPEDMODEL_PREC = 16
GM_ALPHA_PREC_BITS = 15
GM_ABS_ALPHA_BITS = 12
GM_TRANS_PREC_BITS = 6
GM_ABS_TRANS_BITS = 12
GM_ABS_TRANS_ONLY_BITS = GM_ABS_TRANS_BITS - GM_TRANS_PREC_BITS + 3
GM_TRANS_ONLY_PREC_BITS = 3
GM_IDENTITY_MAT = (0, 0, 1 << WARPEDMODEL_PREC, 0, 0, 1 << WARPEDMODEL_PREC)


def _gm_entry(fh: "FrameHeader", ref_i: int):
    if fh.global_motion and ref_i < len(fh.global_motion):
        return fh.global_motion[ref_i]
    return (GM_IDENTITY, GM_IDENTITY_MAT)


def _ns_bits(n: int) -> int:
    return max((n - 1).bit_length(), 1)


def _write_ns(w: BitWriter, n: int, v: int) -> None:
    if n <= 1:
        return
    l = _ns_bits(n)
    m = (1 << l) - n
    if v < m:
        w.f(v, l - 1)
    else:
        w.f(m + ((v - m) >> 1), l - 1)
        w.f((v - m) & 1, 1)


def _read_ns(r: BitReader, n: int) -> int:
    if n <= 1:
        return 0
    l = _ns_bits(n)
    m = (1 << l) - n
    v = r.f(l - 1)
    if v < m:
        return v
    return (v << 1) - m + r.f(1)


def _recenter_nonneg(ref: int, v: int) -> int:
    if v > (ref << 1):
        return v
    if v >= ref:
        return (v - ref) << 1
    return ((ref - v) << 1) - 1


def _inv_recenter_nonneg(ref: int, v: int) -> int:
    if v > (ref << 1):
        return v
    if v & 1:
        return ref - ((v + 1) >> 1)
    return ref + (v >> 1)


def _write_subexp(w: BitWriter, num_syms: int, v: int, k: int = 3) -> None:
    i = mk = 0
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if num_syms <= mk + 3 * a:
            _write_ns(w, num_syms - mk, v - mk)
            return
        if v >= mk + a:
            w.flag(True)
            i += 1
            mk += a
        else:
            w.flag(False)
            w.f(v - mk, b2)
            return


def _read_subexp(r: BitReader, num_syms: int, k: int = 3) -> int:
    i = mk = 0
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if num_syms <= mk + 3 * a:
            return _read_ns(r, num_syms - mk) + mk
        if r.flag():
            i += 1
            mk += a
        else:
            return r.f(b2) + mk


def _write_signed_subexp_ref(w, low, high, ref, v):
    mx = high - low
    ref -= low
    x = v - low
    if (ref << 1) <= mx:
        s = _recenter_nonneg(ref, x)
    else:
        s = _recenter_nonneg(mx - 1 - ref, mx - 1 - x)
    _write_subexp(w, mx, s)


def _read_signed_subexp_ref(r, low, high, ref):
    mx = high - low
    ref -= low
    v = _read_subexp(r, mx)
    if (ref << 1) <= mx:
        x = _inv_recenter_nonneg(ref, v)
    else:
        x = mx - 1 - _inv_recenter_nonneg(mx - 1 - ref, v)
    return x + low


def _gm_param_spec(wmtype: int, idx: int, allow_hp: bool):
    """(abs_bits, prec_bits, round, sub) for one wmmat index."""
    abs_bits, prec_bits = GM_ABS_ALPHA_BITS, GM_ALPHA_PREC_BITS
    if idx < 2:
        if wmtype == GM_TRANSLATION:
            abs_bits = GM_ABS_TRANS_ONLY_BITS - (not allow_hp)
            prec_bits = GM_TRANS_ONLY_PREC_BITS - (not allow_hp)
        else:
            abs_bits, prec_bits = GM_ABS_TRANS_BITS, GM_TRANS_PREC_BITS
    rnd = (1 << WARPEDMODEL_PREC) if idx % 3 == 2 else 0
    sub = (1 << prec_bits) if idx % 3 == 2 else 0
    return abs_bits, prec_bits, rnd, sub


def _write_global_motion(w: BitWriter, fh: "FrameHeader") -> None:
    for ref_i in range(7):
        wmtype, mat = _gm_entry(fh, ref_i)
        prev = getattr(fh, "prev_gm", ())
        prev_mat = prev[ref_i] if prev else GM_IDENTITY_MAT
        w.flag(wmtype != GM_IDENTITY)
        if wmtype != GM_IDENTITY:
            w.flag(wmtype == GM_ROTZOOM)
            if wmtype != GM_ROTZOOM:
                w.flag(wmtype == GM_TRANSLATION)
        idxs = []
        if wmtype >= GM_ROTZOOM:
            idxs += [2, 3]
        if wmtype == GM_AFFINE:
            idxs += [4, 5]
        if wmtype >= GM_TRANSLATION:
            idxs += [0, 1]
        for idx in idxs:
            abs_bits, prec_bits, rnd, sub = _gm_param_spec(
                wmtype, idx, False)
            prec_diff = WARPEDMODEL_PREC - prec_bits
            mx = 1 << abs_bits
            ref_v = (prev_mat[idx] >> prec_diff) - sub
            v = (mat[idx] >> prec_diff) - sub
            _write_signed_subexp_ref(w, -mx, mx + 1, ref_v, v)


def _parse_global_motion(r: BitReader, fh: "FrameHeader") -> None:
    out = []
    prev = getattr(fh, "prev_gm", ())
    for ref_i in range(7):
        prev_mat = prev[ref_i] if prev else GM_IDENTITY_MAT
        if r.flag():
            wmtype = GM_ROTZOOM if r.flag() else (
                GM_TRANSLATION if r.flag() else GM_AFFINE)
        else:
            wmtype = GM_IDENTITY
        mat = list(GM_IDENTITY_MAT)
        idxs = []
        if wmtype >= GM_ROTZOOM:
            idxs += [2, 3]
        if wmtype == GM_AFFINE:
            idxs += [4, 5]
        if wmtype >= GM_TRANSLATION:
            idxs += [0, 1]
        for idx in idxs:
            abs_bits, prec_bits, rnd, sub = _gm_param_spec(
                wmtype, idx, False)
            prec_diff = WARPEDMODEL_PREC - prec_bits
            mx = 1 << abs_bits
            ref_v = (prev_mat[idx] >> prec_diff) - sub
            mat[idx] = (_read_signed_subexp_ref(r, -mx, mx + 1, ref_v)
                        << prec_diff) + rnd
        if wmtype == GM_ROTZOOM:
            mat[4] = -mat[3]
            mat[5] = mat[2]
        out.append((wmtype, tuple(mat)))
    fh.global_motion = tuple(out)

# --------------------------------------------------------------------------
# Segmentation (spec 5.9.14 segmentation_params; ALT_Q feature only)
# --------------------------------------------------------------------------

SEG_FEATURE_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
SEG_FEATURE_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)


def _write_su(w: BitWriter, v: int, bits: int) -> None:
    """su(1+bits): sign-magnitude-free two's complement literal."""
    w.f(v & ((1 << (bits + 1)) - 1), bits + 1)


def _read_su(r: BitReader, bits: int) -> int:
    v = r.f(bits + 1)
    sign = 1 << bits
    return v - ((v & sign) << 1)


def _write_segmentation(w: BitWriter, fh: "FrameHeader") -> None:
    qd = fh.seg_qdeltas
    w.flag(bool(qd))
    if not qd:
        return
    # primary_ref_frame == NONE forces update_map=1, temporal_update=0,
    # update_data=1 with no flags coded; with a primary ref the same
    # semantics are coded explicitly (spec 5.9.14)
    if fh.primary_ref_frame != PRIMARY_REF_NONE:
        w.flag(True)                     # segmentation_update_map
        w.flag(False)                    # segmentation_temporal_update
        w.flag(True)                     # segmentation_update_data
    for seg in range(8):
        delta = qd[seg] if seg < len(qd) else 0
        w.flag(delta != 0)               # feature_enabled (SEG_LVL_ALT_Q)
        if delta:
            _write_su(w, delta, SEG_FEATURE_BITS[0])
        for _ in range(7):               # remaining features disabled
            w.flag(False)


def _parse_segmentation(r: BitReader, fh: "FrameHeader") -> None:
    if not r.flag():
        fh.seg_qdeltas = ()
        return
    if fh.primary_ref_frame != PRIMARY_REF_NONE:
        if not r.flag():                 # segmentation_update_map
            raise UnsupportedBitstream("inherited segmentation map")
        if r.flag():                     # segmentation_temporal_update
            raise UnsupportedBitstream("temporal segmentation update")
        if not r.flag():                 # segmentation_update_data
            raise UnsupportedBitstream("inherited segmentation data")
    qd = []
    for seg in range(8):
        delta = 0
        if r.flag():
            delta = max(-255, min(255, _read_su(r, SEG_FEATURE_BITS[0])))
        for feat in range(1, 8):
            if r.flag():
                raise UnsupportedBitstream(f"segmentation feature {feat}")
        qd.append(delta)
    fh.seg_qdeltas = tuple(qd)


def seg_last_active(fh: "FrameHeader") -> int:
    """last_active_seg_id: highest segment with any feature on."""
    last = 0
    for i, d in enumerate(fh.seg_qdeltas):
        if d:
            last = i
    return last

