"""Key-frame (all-intra) tile codec: the normative coding loop.

One implementation serves both encoder and decoder through a symmetric
SymbolIO shim, guaranteeing the two sides agree symbol-for-symbol.
Behavioral parity: encoder write path EbEntropyCoding.c (write_modes_b:
5440, encode_partition_av1:1159, encode_intra_luma_mode_av1:1271,
av1_write_coeffs_txb_1d:548), decoder parse path EbDecParseBlock.c, and
the recon loop of EbCodingLoop.c av1_encode_decode restructured as
predict -> transform -> quantize -> inverse -> recon per tx block.

Current scope: key frames, square partitions (NONE/SPLIT), all intra Y
modes with angle deltas, UV modes (no CFL yet), TX_MODE_LARGEST, 8-bit
4:2:0, single tile.  The structure extends: each feature adds syntax at
the marked points identically for both directions.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..constants import (BlockSize, FrameType, PredictionMode, TxSize,
                         TxType, TX_WIDTH, TX_HEIGHT)
from ..entropy import coeffs as cf
from ..entropy.ec import RangeDecoder, RangeEncoder
from ..entropy.tables import FrameCdfs, table
from ..ops import intra as intra_ops
from ..ops import quant as qz
from ..ops import transforms as tf
from ..bitstream.headers import (FrameHeader, SequenceHeader,
                                 UnsupportedBitstream)
from ..entropy.mv import (MV_SUBPEL_LOW_PRECISION, MV_SUBPEL_NONE,
                          decode_mv, encode_mv)
from . import mv_pred
from ..ops import inter as inter_ops

# intra size groups (size_group_lookup, EbDefinitions.h:1333; the tail
# covers 4x16,16x4,8x32,32x8,16x64,64x16)
_SIZE_GROUP_BY_ENUM = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3,
                       3, 3, 3, 3, 0, 0, 1, 1, 2, 2)
REF_PAD = 96

MI = 4  # mode-info unit in pixels

# Filter_Intra_Mode_To_Intra_Dir (spec: tx-type context for FI blocks;
# fimode_to_intradir EbCommonUtils.h:103 = DC,V,H,D157,DC)
FILTER_INTRA_TO_DIR = (0, 1, 2, 6, 0)

# Split_Tx_Size (spec 5.11.16 / sub_tx_size_map)
SUB_TX_SIZE = {
    TxSize.TX_4X4: TxSize.TX_4X4, TxSize.TX_8X8: TxSize.TX_4X4,
    TxSize.TX_16X16: TxSize.TX_8X8, TxSize.TX_32X32: TxSize.TX_16X16,
    TxSize.TX_64X64: TxSize.TX_32X32, TxSize.TX_4X8: TxSize.TX_4X4,
    TxSize.TX_8X4: TxSize.TX_4X4, TxSize.TX_8X16: TxSize.TX_8X8,
    TxSize.TX_16X8: TxSize.TX_8X8, TxSize.TX_16X32: TxSize.TX_16X16,
    TxSize.TX_32X16: TxSize.TX_16X16, TxSize.TX_32X64: TxSize.TX_32X32,
    TxSize.TX_64X32: TxSize.TX_32X32, TxSize.TX_4X16: TxSize.TX_4X8,
    TxSize.TX_16X4: TxSize.TX_8X4, TxSize.TX_8X32: TxSize.TX_8X16,
    TxSize.TX_32X8: TxSize.TX_16X8, TxSize.TX_16X64: TxSize.TX_16X32,
    TxSize.TX_64X16: TxSize.TX_32X16,
}


def depth_to_tx_size(depth: int, bw: int, bh: int) -> TxSize:
    ts = max_txsize_rect(bw, bh)
    for _ in range(depth):
        ts = SUB_TX_SIZE[ts]
    return ts


def bsize_max_tx_depth(bw: int, bh: int) -> int:
    """bsize_to_max_depth: split-chain length capped at MAX_TX_DEPTH=2."""
    ts = max_txsize_rect(bw, bh)
    d = 0
    while d < 2 and ts != TxSize.TX_4X4:
        d += 1
        ts = SUB_TX_SIZE[ts]
    return d


def bsize_tx_size_cat(bw: int, bh: int) -> int:
    """bsize_to_tx_size_cat: full chain depth - 1, capped at 3."""
    ts = max_txsize_rect(bw, bh)
    d = 0
    while ts != TxSize.TX_4X4:
        d += 1
        ts = SUB_TX_SIZE[ts]
    return min(d - 1, 3)

# intra mode -> kf ctx bucket (libaom intra_mode_context)
INTRA_MODE_CONTEXT = [0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0]

PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT = 0, 1, 2, 3
(PARTITION_HORZ_A, PARTITION_HORZ_B, PARTITION_VERT_A,
 PARTITION_VERT_B, PARTITION_HORZ_4, PARTITION_VERT_4) = 4, 5, 6, 7, 8, 9


def _part_ctx(bw: int, bh: int):
    """partition_context_lookup (EbDefinitions.h:1299): the above code
    clears log2(w4) low bits, the left code log2(h4)."""
    above = (31 << ((bw // 4).bit_length() - 1)) & 31
    left = (31 << ((bh // 4).bit_length() - 1)) & 31
    return above, left

# chroma tx type derivation for intra (EbCommonUtils.h:68)
_INTRA_MODE_TO_TX_TYPE = [
    TxType.DCT_DCT, TxType.ADST_DCT, TxType.DCT_ADST, TxType.DCT_DCT,
    TxType.ADST_ADST, TxType.ADST_DCT, TxType.DCT_ADST, TxType.DCT_ADST,
    TxType.ADST_DCT, TxType.ADST_ADST, TxType.ADST_DCT, TxType.DCT_ADST,
    TxType.ADST_ADST,
]

# ext-tx set machinery (EbDefinitions.h:1520, EbCabacContextModel.h:824)
EXT_TX_SET_DCTONLY = 0
EXT_TX_SET_DCT_IDTX = 1
EXT_TX_SET_DTT4_IDTX = 2
EXT_TX_SET_DTT4_IDTX_1DDCT = 3
EXT_TX_SET_DTT9_IDTX_1DDCT = 4
EXT_TX_SET_ALL16 = 5

AV1_EXT_TX_IND = [
    [0] * 16,
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [1, 3, 4, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [1, 5, 6, 4, 0, 0, 0, 0, 0, 0, 2, 3, 0, 0, 0, 0],
    [3, 4, 5, 8, 6, 7, 9, 10, 11, 0, 1, 2, 0, 0, 0, 0],
    [7, 8, 9, 12, 10, 11, 13, 14, 15, 0, 1, 2, 3, 4, 5, 6],
]
AV1_EXT_TX_INV = [
    [0] * 16,
    [9, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [9, 0, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [9, 0, 10, 11, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [9, 10, 11, 0, 1, 2, 4, 5, 3, 6, 7, 8, 0, 0, 0, 0],
    [9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 4, 5, 3, 6, 7, 8],
]
AV1_NUM_EXT_TX_SET = [1, 2, 5, 7, 12, 16]
EXT_TX_SET_INDEX = [[0, -1, 2, 1, -1, -1], [0, 3, -1, -1, 2, 1]]


def get_ext_tx_set_type(tx_size: TxSize, is_inter: bool, reduced: bool) -> int:
    w, h = TX_WIDTH[tx_size], TX_HEIGHT[tx_size]
    sqr_up = max(w, h)
    if sqr_up > 32:
        return EXT_TX_SET_DCTONLY
    if sqr_up == 32:
        return EXT_TX_SET_DCT_IDTX if is_inter else EXT_TX_SET_DCTONLY
    if reduced:
        return EXT_TX_SET_DCT_IDTX if is_inter else EXT_TX_SET_DTT4_IDTX
    sqr = min(w, h)
    if is_inter:
        return EXT_TX_SET_DTT9_IDTX_1DDCT if sqr == 16 else EXT_TX_SET_ALL16
    return EXT_TX_SET_DTT4_IDTX if sqr == 16 else EXT_TX_SET_DTT4_IDTX_1DDCT


def ext_tx_used(set_type: int, tx_type: TxType) -> bool:
    if set_type == EXT_TX_SET_DCTONLY:
        return tx_type == TxType.DCT_DCT
    ind = AV1_EXT_TX_IND[set_type]
    return tx_type == TxType.DCT_DCT or ind[tx_type] != 0 or \
        (set_type >= EXT_TX_SET_DTT4_IDTX and tx_type == TxType.IDTX)


def max_txsize_rect(w: int, h: int) -> TxSize:
    """Largest tx for a (w, h) block (square path; rect later)."""
    for ts in TxSize:
        if TX_WIDTH[ts] == min(w, 64) and TX_HEIGHT[ts] == min(h, 64):
            return ts
    raise ValueError((w, h))


# --------------------------------------------------------------------------
# Symbol IO: one code path, two directions
# --------------------------------------------------------------------------

class SymbolWriter:
    is_decoder = False

    def __init__(self):
        from ..entropy.native_ec import make_range_encoder
        self.ec = make_range_encoder()

    def symbol(self, value: int, cdf: np.ndarray, nsyms: int) -> int:
        self.ec.encode_symbol(value, cdf, nsyms)
        return value

    def literal(self, value: int, bits: int) -> int:
        self.ec.encode_literal(value, bits)
        return value


class SymbolReader:
    is_decoder = True

    def __init__(self, data: bytes):
        self.ec = RangeDecoder(data)

    def symbol(self, value, cdf: np.ndarray, nsyms: int) -> int:
        return self.ec.decode_symbol(cdf, nsyms)

    def literal(self, value, bits: int) -> int:
        return self.ec.decode_literal(bits)


# --------------------------------------------------------------------------
# Decisions (encoder side)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class BlockDecision:
    y_mode: PredictionMode = PredictionMode.DC_PRED
    angle_delta_y: int = 0
    uv_mode: int = 0                    # UVPredictionMode (13 = UV_CFL)
    angle_delta_uv: int = 0
    cfl_signs: int = 0                  # joint sign (when uv_mode == 13)
    cfl_idx: int = 0
    tx_type_y: TxType = TxType.DCT_DCT
    filter_intra_mode: int = -1         # FILTER_DC..FILTER_PAETH; -1 off
    tx_depth: int = 0                   # luma tx split depth (TX_MODE_SELECT)
    motion_mode: int = 0                # SIMPLE / OBMC_CAUSAL / WARPED_CAUSAL
    segment_id: int = 0
    # inter fields
    # palette (screen content): sorted luma colors + per-pixel index map
    palette_colors: tuple = ()
    palette_map: object = None
    use_intrabc: bool = False           # DV in .mv (full-pel, 1/8 units)
    is_inter: bool = False
    inter_mode: int = 0                 # PredictionMode NEARESTMV..NEW_NEWMV
    mv: tuple = (0, 0)                  # (row, col) 1/8 pel
    ref_mv_idx: int = 0
    ref: int = 1                        # named reference (LAST..ALTREF)
    ref1: int = 0                       # second ref (compound); 0 = none
    mv1: tuple = (0, 0)
    # masked compound (COMPOUND_WEDGE / COMPOUND_DIFFWTD)
    compound_type: int = 0              # 0 avg / 1 wedge / 2 diffwtd
    wedge_index: int = 0
    wedge_sign: int = 0
    mask_type: int = 0                  # DIFFWTD_38 / DIFFWTD_38_INV
    # inter-intra (single ref, rf[1] = INTRA_FRAME)
    interintra: bool = False
    interintra_mode: int = 0            # II_DC/II_V/II_H/II_SMOOTH
    wedge_interintra: bool = False
    interintra_wedge_index: int = 0


class ModeDecider:
    """Chooses partitions and modes.  The base version: fixed square
    partition to ``block_size``, per-block intra mode by prediction SSE
    against the source (open-loop on recon edges)."""

    def __init__(self, block_size: int = 32,
                 modes=(PredictionMode.DC_PRED, PredictionMode.V_PRED,
                        PredictionMode.H_PRED, PredictionMode.SMOOTH_PRED,
                        PredictionMode.PAETH_PRED)):
        self.block_size = block_size
        self.modes = modes

    def partition(self, bsize: int, mi_row: int, mi_col: int,
                  has_rows: bool = True, has_cols: bool = True) -> int:
        if bsize > self.block_size or not (has_rows and has_cols):
            return PARTITION_SPLIT
        return PARTITION_NONE

    def decide_inter(self, codec: "FrameCodec", x, y, bw, bh,
                     mi_row, mi_col, w4, h4=None) -> BlockDecision:
        """Inter-frame decision: per candidate reference, try NEAREST/
        NEAR/GLOBAL/NEW against the best intra mode by prediction SAD
        (full RD in RdoDecider)."""
        if h4 is None:
            h4 = w4
        from . import mv_pred as mp
        from ..ops import me as me_ops

        src = codec.source[0][y:y + bh, x:x + bw].astype(np.int32)
        in_frame = lambda mv: codec.mv_window_in_frame(mv, x, y, bw, bh)
        vis_w, vis_h = codec.fh.frame_width, codec.fh.frame_height
        blk = src.astype(np.uint8)
        cands = []                         # (cost, mode, mv, drl_idx, ref)
        for ref in codec.search_refs():
            stack_res = mp.find_mv_stack(
                codec.mi, mi_row, mi_col, w4, h4, ref,
                codec.mi_rows, codec.mi_cols, sb_mi=codec.seq.sb_size // 4,
                sign_bias=codec.sign_bias, tile=codec.tile,
                **codec.gm_stack_kwargs(ref, 0, mi_row, mi_col, w4, h4))

            def mc_sad(mv, ref=ref):
                pred = codec.predict_inter(0, mv, x, y, bw, bh, ref)
                return int(np.abs(src - pred).sum())

            nearest = stack_res.ref_mv_list[0]
            near = stack_res.ref_mv_list[1]
            if in_frame(nearest):
                cands.append((mc_sad(nearest), mp.NEARESTMV, nearest, 0, ref))
            if len(stack_res.stack) >= 2 and near != nearest and in_frame(near):
                cands.append((mc_sad(near) + 16, mp.NEARMV, near, 0, ref))
            gmv = codec.gm_mv_for(ref, mi_row, mi_col, bw, bh)
            if codec.gm_entry(ref)[0] > 1 and min(bw, bh) >= 8:
                wp = codec.predict_warp(0, ref, x, y, bw, bh)
                cands.append((int(np.abs(src - wp).sum()) + 32,
                              mp.GLOBALMV, gmv, 0, ref))
            elif in_frame(gmv):
                cands.append((mc_sad(gmv) + 32, mp.GLOBALMV, gmv, 0, ref))
            # NEWMV: full-pel ME around the nearest predictor, window kept
            # inside the visible frame (the reference decoder build does
            # not pad references in its MT path, so out-of-frame reads
            # are avoided entirely, like SVT's restricted-MV default)
            ref_vis = codec.refs[ref][0][REF_PAD:REF_PAD + vis_h,
                                         REF_PAD:REF_PAD + vis_w]
            if bw <= vis_w and bh <= vis_h and x + bw <= vis_w \
                    and y + bh <= vis_h:
                # predictor-centered integer search over the configured
                # area (search_area_width/height; EbSvtAv1Enc.h:669)
                sa_w, sa_h = getattr(codec, "search_area", (48, 48))
                rx = max(sa_w // 2, 4)
                ry = max(sa_h // 2, 4)
                cx = int(np.clip(x + (nearest[1] >> 3), 4,
                                 max(vis_w - bw - 4, 4)))
                cy = int(np.clip(y + (nearest[0] >> 3), 4,
                                 max(vis_h - bh - 4, 4)))
                dx, dy, sad = me_ops.hme_search(blk, ref_vis, cx, cy, rx, ry)
                # HME candidate: decimated wide search around the block
                # itself recovers large motion beyond the local area
                # (hme_level_0/1/2; gated by enable_hme_level1/2)
                hme = getattr(codec, "hme_controls", (True, True, True))
                if hme[0] and bw == bh and bw >= 32 \
                        and x + bw <= vis_w and y + bh <= vis_h:
                    pyrs = getattr(codec, "_hme_pyr", None)
                    if pyrs is None:
                        pyrs = codec._hme_pyr = {}
                    if ref not in pyrs:
                        src_vis = codec.source[0][:vis_h, :vis_w]
                        pyrs[ref] = (me_ops.decimate(src_vis, 4),
                                     me_ops.decimate(ref_vis, 4),
                                     me_ops.decimate(src_vis, 2),
                                     me_ops.decimate(ref_vis, 2))
                    hx, hy, hsad = me_ops.hierarchical_me(
                        codec.source[0][:vis_h, :vis_w], ref_vis, x, y, bw,
                        level1=bool(hme[1]), level2=bool(hme[2]),
                        pyr=pyrs[ref])
                    if hsad < sad:
                        dx, dy, sad = hx + x - cx, hy + y - cy, hsad
                best_x = int(np.clip(cx + dx, 4, vis_w - bw - 4))
                best_y = int(np.clip(cy + dy, 4, vis_h - bh - 4))
                new_mv = ((best_y - y) * 8, (best_x - x) * 8)
                # sub-pel refinement: half then quarter (hp disabled keeps
                # components even in 1/8 units)
                best_mv = new_mv
                best_sad = mc_sad(new_mv) if in_frame(new_mv) else (1 << 30)
                for step in (4, 2):
                    improved = True
                    while improved:
                        improved = False
                        for drow, dcol in ((-step, 0), (step, 0), (0, -step),
                                           (0, step), (-step, -step),
                                           (-step, step), (step, -step),
                                           (step, step)):
                            cand = (best_mv[0] + drow, best_mv[1] + dcol)
                            if not in_frame(cand):
                                continue
                            csad = mc_sad(cand)
                            if csad < best_sad:
                                best_mv, best_sad = cand, csad
                                improved = True
                if in_frame(best_mv):
                    cands.append((best_sad + 96, mp.NEWMV, best_mv, 0, ref))
        if not cands:
            return self.decide(codec, x, y, bw, bh)

        best = min(cands, key=lambda c: c[0])

        # WARPED_CAUSAL trial on the best single-ref candidate: derive
        # local params from the neighbour samples and compare the warp
        # prediction (motion_estimation warp refinement analog)
        warp_mode = 0
        if (codec.fh.is_motion_mode_switchable
                and codec.fh.allow_warped_motion
                and min(bw, bh) >= 8):
            d_tmp = BlockDecision(is_inter=True, inter_mode=best[1],
                                  mv=(int(best[2][0]), int(best[2][1])),
                                  ref=best[4])
            if codec._warp_eligible(d_tmp, mi_row, mi_col, w4, h4, bw, bh):
                mat = codec.local_warp_mat(d_tmp, mi_row, mi_col,
                                           w4, h4, bw, bh)
                if mat is not None:
                    from ..ops import warp as warp_ops
                    ref_vis2 = codec.refs[best[4]][0][
                        REF_PAD:REF_PAD + vis_h, REF_PAD:REF_PAD + vis_w]
                    wp = warp_ops.warp_plane(mat, ref_vis2, x, y, bw, bh,
                                             0, 0, bd=codec.seq.bit_depth)
                    wsad = int(np.abs(src - wp).sum()) + 16
                    if wsad < best[0]:
                        best = (wsad, best[1], best[2], best[3], best[4])
                        warp_mode = 2
            # OBMC trial on the same candidate
            if getattr(codec, "obmc_level", 1) > 0 and \
                    codec._warp_eligible(d_tmp, mi_row, mi_col, w4, h4,
                                         bw, bh):
                base = codec.predict_inter(0, d_tmp.mv, x, y, bw, bh,
                                           d_tmp.ref)
                ob = codec._obmc_pred(0, base, x, y, bw, bh, mi_row,
                                      mi_col, bw, bh)
                osad = int(np.abs(src - ob).sum()) + 16
                if osad < best[0]:
                    best = (osad, best[1], best[2], best[3], best[4])
                    warp_mode = 1

        # compound trial: average the best forward and backward singles
        # (gated by compound_level; EbSvtAv1Enc.h compound_level)
        comp_best = None
        if codec.fh.reference_select and bw >= 8 and bh >= 8 \
                and getattr(codec, "compound_level", 1) > 0:
            fwd = [c for c in cands if c[4] < 5 and c[1] != mp.GLOBALMV]
            bwd = [c for c in cands if c[4] >= 5 and c[1] != mp.GLOBALMV]
            if fwd and bwd:
                bf = min(fwd, key=lambda c: c[0])
                bb = min(bwd, key=lambda c: c[0])
                rf, rb = bf[4], bb[4]
                stack = mp.find_mv_stack(
                    codec.mi, mi_row, mi_col, w4, h4, rf,
                    codec.mi_rows, codec.mi_cols,
                    sb_mi=codec.seq.sb_size // 4, sign_bias=codec.sign_bias,
                    ref_frame1=rb, tile=codec.tile,
                    **codec.gm_stack_kwargs(rf, rb, mi_row, mi_col,
                                            w4, h4)).stack
                lower = lambda mv: mp.lower_mv_precision(mv, False, False)
                trials = [(mp.NEW_NEWMV, bf[2], bb[2], 96)]
                if stack:
                    trials.append((mp.NEAREST_NEARESTMV,
                                   lower(stack[0][0]), lower(stack[0][1]), 0))
                for mode, mv0, mv1, pen in trials:
                    if not (in_frame(mv0) and in_frame(mv1)):
                        continue
                    pred = codec.predict_compound(0, mv0, mv1, x, y, bw, bh,
                                                  rf, rb)
                    sad = int(np.abs(src - pred).sum()) + pen
                    if comp_best is None or sad < comp_best[0]:
                        comp_best = (sad, mode, mv0, mv1, rf, rb)

        # masked compound trial (wedge / diffwtd) on the winning pair:
        # blend the already-computed CONV pair through each candidate
        # mask (compound_type search, EbModeDecision.c inter_comp)
        comp_masked = None
        if comp_best is not None and codec.seq.enable_masked_compound:
            from ..ops import masks as mk

            _, cmode, mv0, mv1, rf, rb = comp_best
            bufs = []
            flt = codec.fh.interpolation_filter
            for mv, name in ((mv0, rf), (mv1, rb)):
                refp = codec.refs[name][0]
                ix, iy, sx, sy = codec._mc_pos(refp, 0, mv, x, y, bw, bh)
                bufs.append(np.asarray(inter_ops.jnt_convolve(
                    refp, ix, iy, bw, bh, sx, sy, filter_x=flt,
                    filter_y=flt, bd=codec.seq.bit_depth)))
            trials = []
            if mk.wedge_used(bw, bh):
                for widx in range(16):
                    for ws in (0, 1):
                        trials.append((1, widx, ws, 0,
                                       mk.wedge_mask(bw, bh, widx, ws),
                                       24))
            for mt in (0, 1):
                trials.append((2, 0, 0, mt,
                               mk.diffwtd_mask_d16(bufs[0], bufs[1], mt,
                                                   codec.seq.bit_depth),
                               16))
            for ctype, widx, ws, mt, mask, pen in trials:
                p = mk.blend_a64_d16(bufs[0], bufs[1], mask, 0, 0,
                                     codec.seq.bit_depth)
                sad = int(np.abs(src - p).sum()) + pen
                if sad < comp_best[0] and (comp_masked is None
                                           or sad < comp_masked[0]):
                    comp_masked = (sad, ctype, widx, ws, mt)

        # inter-intra trial on the best single-ref candidate
        # (inter_intra candidate class; wedge sign always 0)
        ii_best = None
        if (codec.seq.enable_interintra_compound
                and 8 <= bw <= 32 and 8 <= bh <= 32
                and (bw, bh) not in ((8, 32), (32, 8))
                and in_frame(best[2])):
            from ..ops import masks as mk

            inter_p = codec.predict_inter(0, best[2], x, y, bw, bh,
                                          best[4])
            ii_map = (PredictionMode.DC_PRED, PredictionMode.V_PRED,
                      PredictionMode.H_PRED, PredictionMode.SMOOTH_PRED)
            for iim in range(4):
                ip = codec.predict(0, ii_map[iim], 0, x, y, bw, bh,
                                   max_txsize_rect(bw, bh))
                m = mk.smooth_interintra_mask(bw, bh, iim)
                p = mk.blend_a64_pixels(ip, inter_p, m)
                sad = int(np.abs(src - p).sum()) + 24
                if ii_best is None or sad < ii_best[0]:
                    ii_best = (sad, iim, False, 0, ip)
            if mk.wedge_used(bw, bh) and ii_best is not None:
                ip = codec.predict(0, ii_map[ii_best[1]], 0, x, y, bw,
                                   bh, max_txsize_rect(bw, bh))
                for widx in range(16):
                    m = mk.wedge_mask(bw, bh, widx, 0)
                    p = mk.blend_a64_pixels(ip, inter_p, m)
                    sad = int(np.abs(src - p).sum()) + 32
                    if sad < ii_best[0]:
                        ii_best = (sad, ii_best[1], True, widx, ip)

        # intra fallback
        intra_d = self.decide(codec, x, y, bw, bh)
        pred = codec.predict(0, intra_d.y_mode, 0, x, y, bw, bh,
                             max_txsize_rect(bw, bh))
        intra_sad = int(np.abs(src - pred).sum()) + 128
        comp_cost = comp_masked[0] if comp_masked is not None \
            else (comp_best[0] if comp_best is not None else 1 << 40)
        single_cost = ii_best[0] if ii_best is not None \
            and ii_best[0] < best[0] else best[0]
        if comp_best is not None and comp_cost < single_cost \
                and comp_cost < intra_sad:
            d = BlockDecision(
                is_inter=True, inter_mode=comp_best[1],
                mv=(int(comp_best[2][0]), int(comp_best[2][1])),
                mv1=(int(comp_best[3][0]), int(comp_best[3][1])),
                ref=comp_best[4], ref1=comp_best[5])
            if comp_masked is not None:
                d.compound_type = comp_masked[1]
                d.wedge_index = comp_masked[2]
                d.wedge_sign = comp_masked[3]
                d.mask_type = comp_masked[4]
            return d
        if intra_sad < single_cost:
            return intra_d
        d = BlockDecision(is_inter=True, inter_mode=best[1],
                          mv=(int(best[2][0]), int(best[2][1])),
                          ref_mv_idx=best[3], ref=best[4],
                          motion_mode=warp_mode)
        if ii_best is not None and ii_best[0] < best[0]:
            d.interintra = True
            d.interintra_mode = ii_best[1]
            d.wedge_interintra = ii_best[2]
            d.interintra_wedge_index = ii_best[3]
            d.motion_mode = 0          # rf[1] = INTRA -> SIMPLE
        return d

    def decide(self, codec: "FrameCodec", x: int, y: int, bw: int, bh: int
               ) -> BlockDecision:
        src = codec.source[0][y:y + bh, x:x + bw].astype(np.int64)
        best, best_mode = None, PredictionMode.DC_PRED
        for mode in self.modes:
            pred = codec.predict(0, mode, 0, x, y, bw, bh,
                                 max_txsize_rect(bw, bh))
            sse = int(((src - pred) ** 2).sum())
            if best is None or sse < best:
                best, best_mode = sse, mode
        d = BlockDecision(y_mode=best_mode,
                          segment_id=codec.aq_seg(x, y))
        # chroma: DC or follow luma if it maps to a chroma mode cheaply
        d.uv_mode = int(best_mode) if best_mode <= PredictionMode.PAETH_PRED else 0
        return d


# --------------------------------------------------------------------------
# The codec
# --------------------------------------------------------------------------

class FrameCodec:
    """Encodes or decodes one key frame's tile data."""

    def __init__(self, seq: SequenceHeader, fh: FrameHeader,
                 source_planes=None, refs=None, init_fc=None, device=None):
        if device is None:
            raise ValueError("FrameCodec needs the torch device of its "
                             "kernels")
        self.seq = seq
        self.fh = fh
        # torch device of the encoder's kernels
        self.device = device
        self.dev_source = None
        # starting CDF state: the primary ref's saved (frame-end
        # adapted) contexts, or None for spec defaults (load_cdfs vs
        # init_non_coeff_cdfs, spec 7.20 / EbDecParseFrame primary ref)
        self.init_fc = init_fc
        self.mi_cols = fh.mi_cols()
        self.mi_rows = fh.mi_rows()
        self.aligned_w = self.mi_cols * MI
        self.aligned_h = self.mi_rows * MI
        self.sub_x = self.sub_y = 1      # 4:2:0
        self.num_planes = 1 if seq.monochrome else 3
        # buffers are SB-aligned: blocks may legally overhang the frame
        # edge (partition allowed while the half boundary starts inside)
        sb = seq.sb_size
        self.buf_w = -(-self.aligned_w // sb) * sb
        self.buf_h = -(-self.aligned_h // sb) * sb
        cw, ch = self.buf_w >> 1, self.buf_h >> 1
        self.recon = [np.zeros((self.buf_h, self.buf_w), np.int32),
                      np.zeros((ch, cw), np.int32),
                      np.zeros((ch, cw), np.int32)]
        if source_planes is not None:
            self.source = [self._pad_plane(p, i) for i, p in enumerate(source_planes)]
        else:
            self.source = None
        self.fc = self._fresh_fc()
        self.yq, self.uq, self.vq = qz.build_quantizer(seq.bit_depth)
        # tile-level contexts
        self.above_part = np.zeros(self.mi_cols + 32, np.int32)
        self.left_part = np.zeros(self.mi_rows + 32, np.int32)
        self.y_modes = np.zeros((self.mi_rows, self.mi_cols), np.int32)
        self.skips = np.zeros((self.mi_rows, self.mi_cols), np.int32)
        # palette neighbor state: per-mi size + colors of the covering
        # block (above/left cache + mode ctx, EbDecParseBlock.c:53,570)
        self.pal_size = np.zeros((self.mi_rows, self.mi_cols), np.int32)
        self.pal_colors = np.zeros((self.mi_rows, self.mi_cols, 8),
                                   np.int32)
        self.intrabc_grid = np.zeros((self.mi_rows, self.mi_cols), bool)
        # comp_group_idx of the covering block (masked-compound ctx,
        # get_comp_group_idx_context_enc)
        self.comp_group = np.zeros((self.mi_rows, self.mi_cols), np.int8)
        self.partitions = np.zeros((self.mi_rows, self.mi_cols), np.int32)
        self.seg_map = np.zeros((self.mi_rows, self.mi_cols), np.int8)
        # var-tx split contexts: above tx widths / left tx heights in
        # pixels (TXFM_CONTEXT; txfm_partition_context,
        # EbEntropyCoding.c:4986); left is scoped to one SB row
        self.txfm_above = np.full(self.mi_cols + 32, 64, np.uint8)
        self.txfm_left = np.full(self.mi_rows + 32, 64, np.uint8)
        # txb level|dcsign contexts per plane (4px units in plane space)
        self.txb_above = [np.zeros(self.buf_w >> (2 + (p > 0)), np.int32)
                          for p in range(3)]
        self.txb_left = [np.zeros(self.buf_h >> (2 + (p > 0)), np.int32)
                         for p in range(3)]
        # per-plane tx geometry grids (4px units) for the loop filter
        def _g(p):
            return np.zeros((self.buf_h >> (2 + (p > 0)),
                             self.buf_w >> (2 + (p > 0))), np.int32)
        self.tx_w_grid = [_g(p) for p in range(3)]
        self.tx_h_grid = [_g(p) for p in range(3)]
        self.bedge_x = [_g(p).astype(bool) for p in range(3)]
        self.bedge_y = [_g(p).astype(bool) for p in range(3)]
        self.skip_grid = [_g(p).astype(bool) for p in range(3)]
        self.mi = mv_pred.MiGrid.create(self.mi_rows, self.mi_cols)
        # per-64x64 cdef unit state (cdef_bits > 0): searched/parsed
        # strength indices + the first-non-skip-coded tracker
        nfb_r, nfb_c = (self.mi_rows + 15) >> 4, (self.mi_cols + 15) >> 4
        self.cdef_idx_grid = np.zeros((nfb_r, nfb_c), np.int32)
        self._cdef_coded = np.zeros((nfb_r, nfb_c), bool)
        # reference frames for inter coding: {named_ref 1..7: [padded planes]}
        # identical plane lists may be shared between names (slot aliasing)
        self.refs = None
        if refs is not None:
            pad_cache = {}
            vis_h = self.fh.frame_height

            def padded(planes):
                # callers that pass DPB entries (api.Dpb.padded) hand in
                # already-padded int32 planes: share, don't re-pad
                p0 = planes[0]
                if p0.dtype == np.int32 and p0.shape[0] != vis_h:
                    return list(planes)
                key = id(planes)
                if key not in pad_cache:
                    pad_cache[key] = [self._pad_ref(p) for p in planes]
                return pad_cache[key]

            self.refs = {name: padded(planes)
                         for name, planes in refs.items()}
        # RefFrameSignBias per named ref (spec: ref order hint after the
        # current frame); filled by the caller from DPB order hints
        self.sign_bias = [0] * 8
        # current tile rect (mi units): (r0, c0, r1, c1); contexts and
        # candidate availability are tile-bounded (spec is_inside)
        self.tile = (0, 0, self.mi_rows, self.mi_cols)
        self.io = None
        self.decider = None
        # decision/coefficient cache for the filter-search re-encode:
        # txb_cache (dict) collects (decision, txbs) per block on the
        # first pass; txb_replay replays them so the second entropy
        # pass skips decide + predict + transform + quantize entirely
        # (the reference instead orders entropy after REST,
        # EbEncHandle.c:1802-1866 — same single-compute property)
        self.txb_cache = None
        self.txb_replay = None
        self.deblocked = None        # post-DLF pre-CDEF copy (for LR)
        self.lr_units = None
        self.lr_plan = None
        self.lr_source = None        # upscaled-width source (superres)

    @staticmethod
    def _pad_ref(plane: np.ndarray) -> np.ndarray:
        return np.pad(plane.astype(np.int32), REF_PAD, mode="edge")

    def _pad_plane(self, p: np.ndarray, plane: int) -> np.ndarray:
        tw = self.buf_w >> (1 if plane else 0)
        th = self.buf_h >> (1 if plane else 0)
        out = np.zeros((th, tw), np.int32)
        h, w = p.shape
        out[:h, :w] = p
        if w < tw:
            out[:h, w:] = p[:, w - 1:w]
        if h < th:
            out[h:, :] = out[h - 1:h, :]
        return out

    # -- public entries ----------------------------------------------------

    def encode_tile(self, decider: ModeDecider) -> bytes:
        blobs = self.encode_tiles(decider)
        assert len(blobs) == 1, "multi-tile frames use encode_tiles"
        return blobs[0]

    def encode_tiles(self, decider: ModeDecider) -> list:
        """Encode every tile; returns per-tile byte blobs in tile order.
        Each tile resets its symbol contexts (fresh CDFs, cleared
        neighbor state — EbEntropyCodingProcess.c:357 per-tile reset)."""
        self.decider = decider
        self._init_lr_state()
        from ..native import tile_coder
        if self.fh.frame_type == FrameType.KEY_FRAME:
            got = tile_coder.try_encode_tiles_native(self, decider)
        else:
            got = tile_coder.try_encode_tiles_native_inter(self, decider)
        if got is not None:
            return got
        blobs = []
        for rect in self.tile_rects():
            self.tile = rect
            self._reset_tile_contexts()
            self.io = SymbolWriter()
            self._walk_superblocks()
            blobs.append(self.io.ec.done())
        return blobs

    def decode_tile(self, data: bytes) -> None:
        self.decode_tiles([data])

    def decode_tiles(self, blobs: list) -> None:
        self._init_lr_state()
        rects = self.tile_rects()
        assert len(blobs) == len(rects), (len(blobs), len(rects))
        self.saved_fc = None
        for ti, (rect, data) in enumerate(zip(rects, blobs)):
            self.tile = rect
            self._reset_tile_contexts()
            self.io = SymbolReader(data)
            self._walk_superblocks()
            if ti == self.fh.context_update_tile_id:
                # frame-end CDF save source (spec 7.20 SavedCdfs)
                self.saved_fc = self.fc

    # -- structure ---------------------------------------------------------

    def tile_rects(self) -> list:
        """Uniform-spacing tile mi rects (r0, c0, r1, c1) in tile order
        (spec 5.9.15 tile_info uniform path)."""
        sb_mi = self.seq.sb_size // MI
        sb_cols = -(-self.mi_cols // sb_mi)
        sb_rows = -(-self.mi_rows // sb_mi)

        def starts(total, log2):
            tw = (total + (1 << log2) - 1) >> log2
            return list(range(0, total, tw)), tw

        col_starts, tw = starts(sb_cols, self.fh.tile_cols_log2)
        row_starts, th = starts(sb_rows, self.fh.tile_rows_log2)
        rects = []
        for r in row_starts:
            r0 = r * sb_mi
            r1 = min((r + th) * sb_mi, self.mi_rows)
            for c in col_starts:
                c0 = c * sb_mi
                c1 = min((c + tw) * sb_mi, self.mi_cols)
                rects.append((r0, c0, r1, c1))
        return rects

    def _fresh_fc(self) -> FrameCdfs:
        """Per-tile starting CDFs: primary-ref chained or defaults."""
        if self.init_fc is not None:
            return self.init_fc.copy()
        return FrameCdfs(self.fh.base_q_idx)

    def _reset_tile_contexts(self):
        from ..ops import restoration as lr

        r0, c0, r1, c1 = self.tile
        self.fc = self._fresh_fc()
        self.above_part[c0:c1 + 32] = 0
        self.left_part[r0:r1 + 32] = 0
        self.txfm_above[c0:c1 + 32] = 64
        for p in range(self.num_planes):
            sub = 1 if p else 0
            x0, x1 = (c0 * MI >> sub) >> 2, (c1 * MI >> sub) >> 2
            y0, y1 = (r0 * MI >> sub) >> 2, (r1 * MI >> sub) >> 2
            self.txb_above[p][x0:x1] = 0
            self.txb_left[p][y0:y1] = 0
        if self.lr_units is not None:
            self.lr_ref = [{"wiener": lr.default_wiener_taps() * 2,
                            "sgr": lr.default_sgr_xqd()}
                           for _ in range(self.num_planes)]

    def _walk_superblocks(self):
        sb = self.seq.sb_size
        sb_mi = sb // MI
        plan = None
        if not self.io.is_decoder:
            plan = getattr(self.decider, "plan_superblock", None)
        r0, c0, r1, c1 = self.tile
        for mi_row in range(r0, r1, sb_mi):
            # left tx context is scoped to one SB row (clear_left_context,
            # EbDecParseFrame.c:110)
            self.txfm_left[mi_row:mi_row + sb_mi] = 64
            for mi_col in range(c0, c1, sb_mi):
                self._code_lr(mi_row, mi_col)
                if plan is not None:
                    plan(self, mi_row, mi_col)
                self._partition(sb, mi_row, mi_col)

    # -- loop restoration syntax (read_lr, EbDecParseBlock.c:2829) ---------

    def _init_lr_state(self):
        from ..ops import restoration as lr

        self.lr_units = None
        if not self.fh.uses_lr or self.fh.allow_intrabc:
            return
        self.lr_units = []
        self.lr_ref = []
        for p in range(self.num_planes):
            sub = 1 if p else 0
            size = self.fh.lr_unit_size(p)
            pw = (self._lr_width() + sub) >> sub
            ph = (self.fh.frame_height + sub) >> sub
            rows = lr.count_units(ph, size)
            cols = lr.count_units(pw, size)
            self.lr_units.append([[None] * cols for _ in range(rows)])
            self.lr_ref.append({"wiener": lr.default_wiener_taps() * 2,
                                "sgr": lr.default_sgr_xqd()})

    def _code_lr(self, mi_row, mi_col):
        from ..entropy import subexp as se
        from ..ops import restoration as lr

        if self.lr_units is None:
            return
        sb_mi = self.seq.sb_size // MI
        for p in range(self.num_planes):
            if self.fh.lr_type[p] == lr.RESTORE_NONE:
                continue
            sub = 1 if p else 0
            size = self.fh.lr_unit_size(p)
            pw = (self._lr_width() + sub) >> sub
            ph = (self.fh.frame_height + sub) >> sub
            rows = lr.count_units(ph, size)
            cols = lr.count_units(pw, size)
            r0 = (mi_row * (MI >> sub) + size - 1) // size
            r1 = min(rows, ((mi_row + sb_mi) * (MI >> sub) + size - 1) // size)
            # column mapping scales mi positions (coded width) into the
            # upscaled LR domain (spec 5.11.57 read_lr: numerator picks
            # up SuperresDenom/SUPERRES_NUM when superres is in use)
            up = self.fh.upscaled_width or self.fh.frame_width
            if up != self.fh.frame_width:
                num = (MI >> sub) * self.fh.superres_denom
                den = size * 8                      # SUPERRES_NUM
            else:
                num, den = MI >> sub, size
            c0 = (mi_col * num + den - 1) // den
            c1 = min(cols, ((mi_col + sb_mi) * num + den - 1) // den)
            for ur in range(r0, r1):
                for uc in range(c0, c1):
                    self._code_lr_unit(p, ur, uc, se, lr)

    def _code_lr_unit(self, plane, ur, uc, se, lr):
        """Per-unit restoration syntax: wiener / sgrproj flags or the
        switchable 3-way symbol, then the chosen filter's params
        (read_lr_unit, EbDecParseBlock.c:2790).  Plan/unit entries are
        tagged: ("wiener", taps_v, taps_h) | ("sgr", ep, xqd)."""
        io = self.io
        frame_type = self.fh.lr_type[plane]
        plan = None
        if not io.is_decoder:
            plan = self.lr_plan[plane][ur][uc] \
                if getattr(self, "lr_plan", None) else None
        if frame_type == lr.RESTORE_WIENER:
            use = io.symbol(None if io.is_decoder else int(plan is not None),
                            self.fc.wiener_restore, 2)
            kind = lr.RESTORE_WIENER if use else lr.RESTORE_NONE
        elif frame_type == lr.RESTORE_SGRPROJ:
            use = io.symbol(None if io.is_decoder else int(plan is not None),
                            self.fc.sgrproj_restore, 2)
            kind = lr.RESTORE_SGRPROJ if use else lr.RESTORE_NONE
        else:                               # RESTORE_SWITCHABLE
            want = None
            if not io.is_decoder:
                want = 0 if plan is None else (
                    1 if plan[0] == "wiener" else 2)
            sym = io.symbol(want, self.fc.switchable_restore, 3)
            kind = (lr.RESTORE_NONE, lr.RESTORE_WIENER,
                    lr.RESTORE_SGRPROJ)[sym]
        if kind == lr.RESTORE_NONE:
            self.lr_units[plane][ur][uc] = None
            return
        enc = None if io.is_decoder else plan
        if kind == lr.RESTORE_WIENER:
            ref = self.lr_ref[plane]["wiener"]
            taps_v, taps_h = [0, 0, 0], [0, 0, 0]
            for d, taps in ((0, taps_v), (1, taps_h)):
                for k in range(3):
                    if plane > 0 and k == 0:
                        taps[k] = 0      # 5-tap chroma window
                        continue
                    want = None if enc is None else enc[1 + d][k]
                    taps[k] = se.code_signed_subexp_ref(
                        io, want, lr.WIENER_TAPS_MIN[k],
                        lr.WIENER_TAPS_MAX[k] + 1, lr.WIENER_SUBEXP_K[k],
                        ref[3 * d + k])
            self.lr_ref[plane]["wiener"] = taps_v + taps_h
            self.lr_units[plane][ur][uc] = ("wiener", list(taps_v),
                                            list(taps_h))
            return
        # RESTORE_SGRPROJ (read_sgrproj_filter, EbDecParseBlock.c:2754)
        ref = self.lr_ref[plane]["sgr"]
        ep = io.literal(None if enc is None else enc[1],
                        lr.SGRPROJ_PARAMS_BITS)
        params, _, _ = lr._sgr_tables()
        r0, r1 = int(params[ep][0]), int(params[ep][1])
        xqd = [0, 0]
        if r0 == 0:
            xqd[1] = se.code_signed_subexp_ref(
                io, None if enc is None else enc[2][1],
                lr.SGRPROJ_PRJ_MIN1, lr.SGRPROJ_PRJ_MAX1 + 1,
                lr.SGRPROJ_PRJ_SUBEXP_K, ref[1])
        elif r1 == 0:
            xqd[0] = se.code_signed_subexp_ref(
                io, None if enc is None else enc[2][0],
                lr.SGRPROJ_PRJ_MIN0, lr.SGRPROJ_PRJ_MAX0 + 1,
                lr.SGRPROJ_PRJ_SUBEXP_K, ref[0])
            xqd[1] = int(np.clip((1 << lr.SGRPROJ_PRJ_BITS) - xqd[0],
                                 lr.SGRPROJ_PRJ_MIN1, lr.SGRPROJ_PRJ_MAX1))
        else:
            xqd[0] = se.code_signed_subexp_ref(
                io, None if enc is None else enc[2][0],
                lr.SGRPROJ_PRJ_MIN0, lr.SGRPROJ_PRJ_MAX0 + 1,
                lr.SGRPROJ_PRJ_SUBEXP_K, ref[0])
            xqd[1] = se.code_signed_subexp_ref(
                io, None if enc is None else enc[2][1],
                lr.SGRPROJ_PRJ_MIN1, lr.SGRPROJ_PRJ_MAX1 + 1,
                lr.SGRPROJ_PRJ_SUBEXP_K, ref[1])
        self.lr_ref[plane]["sgr"] = list(xqd)
        self.lr_units[plane][ur][uc] = ("sgr", ep, list(xqd))

    def _lr_width(self) -> int:
        """LR operates on the superres-upscaled frame (spec 7.17)."""
        return self.fh.upscaled_width or self.fh.frame_width

    def apply_superres(self):
        """Normative horizontal upscale after CDEF, before LR (7.16);
        the saved deblock rows upscale too (save_deblock_boundary_lines
        parity for the LR stripe context)."""
        from ..ops import superres as sr

        fh = self.fh
        up = fh.upscaled_width or fh.frame_width
        if fh.superres_denom == 8 or up == fh.frame_width:
            self.out_w = fh.frame_width
            return
        bd = self.seq.bit_depth
        for p in range(self.num_planes):
            sub = 1 if p else 0
            cw = (fh.frame_width + sub) >> sub
            uw = (up + sub) >> sub
            ph = (fh.frame_height + sub) >> sub
            ctx_w = self.aligned_w >> sub    # mi_col_end << 2 per plane
            self.recon[p] = sr.upscale_plane(self.recon[p], cw, uw, ph, bd,
                                             ctx_w)
            if self.deblocked is not None:
                self.deblocked[p] = sr.upscale_plane(
                    self.deblocked[p], cw, uw, ph, bd, ctx_w)
        self.out_w = up

    def apply_lr(self):
        """Normative Wiener loop restoration on the post-CDEF recon."""
        from ..ops import restoration as lr

        if self.lr_units is None or self.deblocked is None:
            return
        for p in range(self.num_planes):
            if self.fh.lr_type[p] == lr.RESTORE_NONE:
                continue
            sub = 1 if p else 0
            size = self.fh.lr_unit_size(p)
            # LR operates on the superres-upscaled frame (spec 7.17)
            pw = (self._lr_width() + sub) >> sub
            ph = (self.fh.frame_height + sub) >> sub
            vlims = lr.unit_limits_vert(ph, size, sub)
            hlims = lr.unit_limits(pw, size)
            # pure function of (cdef output, deblock output): the oracle
            # decoder's save/restore of seam columns keeps every block's
            # context pre-LR (EbDecRestoration.c:445-464), so no unit
            # ordering effects exist
            cdef_out = self.recon[p]
            out = cdef_out.copy()
            for ur, (v0, v1) in enumerate(vlims):
                for uc, (h0, h1) in enumerate(hlims):
                    unit = self.lr_units[p][ur][uc]
                    if unit is None:
                        continue
                    if unit[0] == "wiener":
                        out[v0:v1, h0:h1] = lr.apply_wiener_unit(
                            cdef_out, self.deblocked[p], v0, v1, h0, h1,
                            unit[1], unit[2], sub, pw, ph,
                            self.seq.bit_depth)
                    else:
                        out[v0:v1, h0:h1] = lr.apply_sgr_unit(
                            cdef_out, self.deblocked[p], v0, v1, h0, h1,
                            unit[1], unit[2], sub, pw, ph,
                            self.seq.bit_depth)
            self.recon[p] = out

    def search_lr(self, lam: float = 1000.0):
        """Encoder Wiener search; fills fh.lr_type and self.lr_plan.
        Returns True when any unit picked a filter."""
        from ..ops import restoration as lr

        if self.deblocked is None:
            return False
        # the search compares against the source in the LR (upscaled)
        # domain; with superres active the caller provides the original
        # full-width planes as lr_source
        src_planes = self.lr_source if self.lr_source is not None \
            else self.source
        self.lr_plan = []
        types = []
        any_used = False
        for p in range(self.num_planes):
            sub = 1 if p else 0
            size = self.fh.lr_unit_size(p)
            pw = (self._lr_width() + sub) >> sub
            ph = (self.fh.frame_height + sub) >> sub
            vlims = lr.unit_limits_vert(ph, size, sub)
            hlims = lr.unit_limits(pw, size)
            plane_plan = [[None] * len(hlims) for _ in range(len(vlims))]
            kinds = set()
            for ur, (v0, v1) in enumerate(vlims):
                for uc, (h0, h1) in enumerate(hlims):
                    tv, th, w_sse, sse_n = lr.pick_wiener_unit(
                        src_planes[p], self.recon[p], self.deblocked[p],
                        v0, v1, h0, h1, sub, pw, ph, self.seq.bit_depth,
                        is_chroma=p > 0)
                    ep, xqd, s_sse, _ = lr.pick_sgr_unit(
                        src_planes[p], self.recon[p], self.deblocked[p],
                        v0, v1, h0, h1, sub, pw, ph, self.seq.bit_depth)
                    # filter flag + ~30 (wiener) / ~20 (sgr) param bits
                    cand = [(sse_n + lam * 1, None)]
                    if tv is not None:
                        cand.append((w_sse + lam * 32,
                                     ("wiener", tv, th)))
                    cand.append((s_sse + lam * 22, ("sgr", ep, xqd)))
                    best = min(cand, key=lambda c: c[0])[1]
                    plane_plan[ur][uc] = best
                    if best is not None:
                        kinds.add(best[0])
            if not kinds:
                types.append(lr.RESTORE_NONE)
            elif kinds == {"wiener"}:
                types.append(lr.RESTORE_WIENER)
            elif kinds == {"sgr"}:
                types.append(lr.RESTORE_SGRPROJ)
            else:
                types.append(lr.RESTORE_SWITCHABLE)
            any_used |= bool(kinds)
            self.lr_plan.append(plane_plan)
        self.fh.lr_type = tuple(types) + (0,) * (3 - len(types))
        return any_used

    def _partition(self, bsize: int, mi_row: int, mi_col: int):
        if mi_row >= self.mi_rows or mi_col >= self.mi_cols:
            return
        bs_mi = bsize // MI
        hbs = bs_mi // 2
        has_rows = mi_row + hbs < self.mi_rows
        has_cols = mi_col + hbs < self.mi_cols
        if bsize >= 8:
            part = self._code_partition(bsize, mi_row, mi_col, has_rows, has_cols)
        else:
            part = PARTITION_NONE
        half = bsize // 2
        quarter = bsize // 4
        qbs = bs_mi // 4
        self._cur_part = part      # intra availability tables (VERT_A/B)
        if part == PARTITION_NONE:
            self._block(bsize, bsize, mi_row, mi_col)
            pa, pl = _part_ctx(bsize, bsize)
        elif part == PARTITION_SPLIT:
            self._partition(half, mi_row, mi_col)
            self._partition(half, mi_row, mi_col + hbs)
            self._partition(half, mi_row + hbs, mi_col)
            self._partition(half, mi_row + hbs, mi_col + hbs)
            return
        elif part == PARTITION_HORZ:
            self._block(bsize, half, mi_row, mi_col)
            if has_rows:
                self._block(bsize, half, mi_row + hbs, mi_col)
            pa, pl = _part_ctx(bsize, half)
        elif part == PARTITION_VERT:
            self._block(half, bsize, mi_row, mi_col)
            if has_cols:
                self._block(half, bsize, mi_row, mi_col + hbs)
            pa, pl = _part_ctx(half, bsize)
        elif part == PARTITION_HORZ_A:
            self._block(half, half, mi_row, mi_col)
            self._block(half, half, mi_row, mi_col + hbs)
            self._block(bsize, half, mi_row + hbs, mi_col)
            # update_ext_partition_context: above from the HORZ subsize,
            # left split per half (EbEncDecProcess / libaom semantics)
            pa, _ = _part_ctx(bsize, half)
            _, pl2 = _part_ctx(half, half)
            _, plh = _part_ctx(bsize, half)
            self.above_part[mi_col:mi_col + bs_mi] = pa
            self.left_part[mi_row:mi_row + hbs] = pl2
            self.left_part[mi_row + hbs:mi_row + bs_mi] = plh
            return
        elif part == PARTITION_HORZ_B:
            self._block(bsize, half, mi_row, mi_col)
            self._block(half, half, mi_row + hbs, mi_col)
            self._block(half, half, mi_row + hbs, mi_col + hbs)
            pa, _ = _part_ctx(half, half)
            _, plh = _part_ctx(bsize, half)
            _, pl2 = _part_ctx(half, half)
            self.above_part[mi_col:mi_col + bs_mi] = pa
            self.left_part[mi_row:mi_row + hbs] = plh
            self.left_part[mi_row + hbs:mi_row + bs_mi] = pl2
            return
        elif part == PARTITION_VERT_A:
            self._block(half, half, mi_row, mi_col)
            self._block(half, half, mi_row + hbs, mi_col)
            self._block(half, bsize, mi_row, mi_col + hbs)
            pa2, _ = _part_ctx(half, half)
            pav, pl = _part_ctx(half, bsize)
            self.above_part[mi_col:mi_col + hbs] = pa2
            self.above_part[mi_col + hbs:mi_col + bs_mi] = pav
            self.left_part[mi_row:mi_row + bs_mi] = pl
            return
        elif part == PARTITION_VERT_B:
            self._block(half, bsize, mi_row, mi_col)
            self._block(half, half, mi_row, mi_col + hbs)
            self._block(half, half, mi_row + hbs, mi_col + hbs)
            pav, _ = _part_ctx(half, bsize)
            pa2, pl = _part_ctx(half, half)
            self.above_part[mi_col:mi_col + hbs] = pav
            self.above_part[mi_col + hbs:mi_col + bs_mi] = pa2
            self.left_part[mi_row:mi_row + bs_mi] = pl
            return
        elif part == PARTITION_HORZ_4:
            for i in range(4):
                if i > 0 and mi_row + i * qbs >= self.mi_rows:
                    break
                self._block(bsize, quarter, mi_row + i * qbs, mi_col)
            pa, pl = _part_ctx(bsize, quarter)
        elif part == PARTITION_VERT_4:
            for i in range(4):
                if i > 0 and mi_col + i * qbs >= self.mi_cols:
                    break
                self._block(quarter, bsize, mi_row, mi_col + i * qbs)
            pa, pl = _part_ctx(quarter, bsize)
        else:
            raise NotImplementedError(f"partition {part}")
        self.above_part[mi_col:mi_col + bs_mi] = pa
        self.left_part[mi_row:mi_row + bs_mi] = pl

    def _code_partition(self, bsize, mi_row, mi_col, has_rows, has_cols) -> int:
        bsl = (bsize // 8).bit_length() - 1      # mi_size_wide_log2 - 1
        above = (int(self.above_part[mi_col]) >> bsl) & 1
        left = (int(self.left_part[mi_row]) >> bsl) & 1
        ctx = (left * 2 + above) + bsl * 4
        n = 4 if bsize == 8 else (8 if bsize == 128 else 10)
        cdf = self.fc.partition[ctx]
        if not has_rows and not has_cols:
            return PARTITION_SPLIT
        if self.io.is_decoder:
            if has_rows and has_cols:
                return self.io.symbol(None, cdf, n)
            gathered = self._gather_split_cdf(cdf, bsize, vert=not has_rows)
            is_split = self.io.symbol(None, gathered, 2)
            return PARTITION_SPLIT if is_split else (
                1 if not has_rows else 2)        # HORZ / VERT forced
        part = self.decider.partition(bsize, mi_row, mi_col, has_rows, has_cols)
        if has_rows and has_cols:
            self.io.symbol(part, cdf, n)
        else:
            assert part == PARTITION_SPLIT, "boundary partitions must split"
            gathered = self._gather_split_cdf(cdf, bsize, vert=not has_rows)
            self.io.symbol(1, gathered, 2)
        return part

    @staticmethod
    def _gather_split_cdf(cdf: np.ndarray, bsize: int, vert: bool) -> np.ndarray:
        """partition_gather_{horz,vert}_alike (EbCabacContextModel.h:863).
        Returns a 2-symbol icdf for P(split-alike).  Note: 'vert' True
        means we gather vertical-alike probabilities (!has_rows case)."""
        def elem(e):
            prev = 32768 if e == 0 else int(cdf[e - 1])
            return prev - int(cdf[e])
        top = 32768
        # gather per reference: horz-alike: HORZ,SPLIT,HORZ_A,HORZ_B,VERT_A,(HORZ_4)
        if not vert:
            items = [1, 3, 4, 5, 6]
            if bsize != 128:
                items.append(8)
        else:
            items = [2, 3, 4, 6, 7]
            if bsize != 128:
                items.append(9)
        for e in items:
            top -= elem(e)
        out = np.zeros(3, np.uint16)
        out[0] = 32768 - top
        out[1] = 0
        out[2] = 0
        return out

    # -- block level -------------------------------------------------------

    def _block(self, bw: int, bh: int, mi_row: int, mi_col: int):
        if self.fh.frame_type == FrameType.INTER_FRAME:
            return self._block_inter(bw, bh, mi_row, mi_col)
        io = self.io
        x, y = mi_col * MI, mi_row * MI
        w4, h4 = bw // MI, bh // MI
        up_avail = mi_row > self.tile[0]
        left_avail = mi_col > self.tile[1]

        decision = None
        txbs = None
        if not io.is_decoder:
            key = (mi_row, mi_col, bw, bh)
            if self.txb_replay is not None and key in self.txb_replay:
                decision, txbs = self.txb_replay[key]
                for t in txbs:      # DLF geometry (compute is skipped)
                    self._record_tx_geometry(t["plane"], t["px"],
                                             t["py"], t["pw"], t["ph"],
                                             t["tx_size"])
            else:
                decision = self.decider.decide(self, x, y, bw, bh)
                if self.fh.allow_screen_content_tools:
                    decision = self._try_palette(decision, x, y, bw, bh)
                if self.fh.allow_intrabc:
                    decision = self._try_intrabc(decision, x, y, bw, bh,
                                                 mi_row, mi_col, w4, h4)
                txbs = self._compute_block(decision, x, y, bw, bh)
            if self.txb_cache is not None:
                self.txb_cache[key] = (decision, txbs)
            skip = all(t["eob"] == 0 for t in txbs)
        else:
            skip = None

        # skip flag (ctx: above/left skip)
        skip_ctx = 0
        if up_avail:
            skip_ctx += int(self.skips[mi_row - 1, mi_col])
        if left_avail:
            skip_ctx += int(self.skips[mi_row, mi_col - 1])
        skip = io.symbol(None if skip is None else int(skip),
                         self.fc.skip[skip_ctx], 2)

        # segment id (SegIdPreSkip == 0: after the skip flag)
        seg = self._code_segment_id(decision, skip, mi_row, mi_col, w4, h4)
        if decision is not None and seg != decision.segment_id:
            decision = dataclasses.replace(decision, segment_id=seg)

        self._code_cdef_idx(skip, mi_row, mi_col, w4, h4)

        # use_intrabc (intra_frame_mode_info, spec 5.11.18): IBC blocks
        # code a DV and skip the whole intra mode syntax
        use_ibc = 0
        if self.fh.allow_intrabc:
            use_ibc = io.symbol(
                None if decision is None else int(decision.use_intrabc),
                self.fc.intrabc, 2)
        if use_ibc:
            from . import palette as pal
            y_mode = 0
            angle_delta_y = angle_delta_uv = 0
            uv_mode = 0
            pal_colors = ()
            fi_mode = -1
            dv_ref = self._dv_ref(mi_row, mi_col, w4, h4)
            if io.is_decoder:
                dv = decode_mv(io.ec, dv_ref[0], dv_ref[1], self.fc.ndv,
                               MV_SUBPEL_NONE)
                dv = ((dv[0] >> 3) * 8, (dv[1] >> 3) * 8)
                decision = BlockDecision(use_intrabc=True,
                                         mv=(int(dv[0]), int(dv[1])),
                                         segment_id=seg)
            else:
                encode_mv(io.ec, decision.mv[0], decision.mv[1],
                          dv_ref[0], dv_ref[1], self.fc.ndv,
                          MV_SUBPEL_NONE)
            npal = 0
            self.pal_size[mi_row:mi_row + h4, mi_col:mi_col + w4] = 0
        else:
            # intra_frame_y_mode
            above_mode = int(self.y_modes[mi_row - 1, mi_col]) if up_avail else 0
            left_mode = int(self.y_modes[mi_row, mi_col - 1]) if left_avail else 0
            kf_cdf = self.fc.kf_y_mode[INTRA_MODE_CONTEXT[above_mode]][
                INTRA_MODE_CONTEXT[left_mode]]
            y_mode = io.symbol(None if decision is None else int(decision.y_mode),
                               kf_cdf, 13)
            use_delta = _bsize_enum(bw, bh) >= 3      # av1_use_angle_delta
            angle_delta_y = 0
            if use_delta and intra_ops.is_directional(PredictionMode(y_mode)):
                sym = io.symbol(None if decision is None
                                else decision.angle_delta_y + 3,
                                self.fc.angle_delta[y_mode - 1], 7)
                angle_delta_y = sym - 3

            # chroma
            uv_mode = 0
            angle_delta_uv = 0
            if self.num_planes > 1:
                cfl_allowed = bw <= 32 and bh <= 32
                uv_cdf = self.fc.uv_mode[int(cfl_allowed)][y_mode]
                uv_mode = io.symbol(None if decision is None else decision.uv_mode,
                                    uv_cdf, 14 if cfl_allowed else 13)
                if uv_mode == 13:
                    cfl_signs, cfl_idx = self._code_cfl(decision)
                elif use_delta and intra_ops.is_directional(PredictionMode(uv_mode)):
                    sym = io.symbol(None if decision is None
                                    else decision.angle_delta_uv + 3,
                                    self.fc.angle_delta[uv_mode - 1], 7)
                    angle_delta_uv = sym - 3

            # palette (palette_mode_info, spec 5.11.46)
            pal_colors = ()
            from . import palette as pal
            if pal.allow_palette(self.fh.allow_screen_content_tools, bw, bh):
                bctx = pal.bsize_ctx(bw, bh)
                if y_mode == 0:
                    mctx = 0
                    if up_avail:
                        mctx += int(self.pal_size[mi_row - 1, mi_col] > 0)
                    if left_avail:
                        mctx += int(self.pal_size[mi_row, mi_col - 1] > 0)
                    has = io.symbol(
                        None if decision is None
                        else int(len(decision.palette_colors) > 0),
                        self.fc.palette_y_mode[bctx][mctx], 2)
                    if has:
                        nsym = io.symbol(
                            None if decision is None
                            else len(decision.palette_colors) - 2,
                            self.fc.palette_y_size[bctx], 7) + 2
                        cache = pal.get_cache(self, mi_row, mi_col)
                        if io.is_decoder:
                            pal_colors = tuple(pal.read_colors_y(
                                io, cache, nsym, self.seq.bit_depth))
                        else:
                            pal_colors = tuple(decision.palette_colors)
                            pal.write_colors_y(io, cache, list(pal_colors),
                                               self.seq.bit_depth)
                if self.num_planes > 1 and uv_mode == 0:
                    # uv palette: flag coded, tool not searched (always 0)
                    uv_has = io.symbol(0 if decision is not None else None,
                                       self.fc.palette_uv_mode[
                                           int(len(pal_colors) > 0)], 2)
                    if io.is_decoder and uv_has:
                        raise UnsupportedBitstream("uv palette")
            # record palette neighbor state over the block extent
            npal = len(pal_colors)
            self.pal_size[mi_row:mi_row + h4, mi_col:mi_col + w4] = npal
            if npal:
                self.pal_colors[mi_row:mi_row + h4, mi_col:mi_col + w4,
                                :npal] = np.asarray(pal_colors, np.int32)

            # filter_intra (read_filter_intra_mode_info; palette blocks
            # exclude it, filter_intra_allowed EbDecParseBlock.c:293)
            fi_mode = -1
            if (self.seq.enable_filter_intra and y_mode == 0
                    and not pal_colors
                    and bw <= 32 and bh <= 32):
                use_fi = io.symbol(
                    None if decision is None
                    else int(decision.filter_intra_mode >= 0),
                    self.fc.filter_intra[_bsize_enum(bw, bh)], 2)
                if use_fi:
                    fi_mode = io.symbol(
                        None if decision is None
                        else decision.filter_intra_mode,
                        self.fc.filter_intra_mode, 5)

            if io.is_decoder:
                decision = BlockDecision(
                    y_mode=PredictionMode(y_mode), angle_delta_y=angle_delta_y,
                    uv_mode=uv_mode, angle_delta_uv=angle_delta_uv,
                    cfl_signs=cfl_signs if uv_mode == 13 else 0,
                    cfl_idx=cfl_idx if uv_mode == 13 else 0,
                    filter_intra_mode=fi_mode, segment_id=seg,
                    palette_colors=pal_colors)


        # palette color index map (palette_tokens: after mode_info,
        # before read_block_tx_size — EbDecParseBlock.c:2487; coded
        # skip or not, it IS the prediction)
        if pal_colors:
            on_w = min(bw, (self.mi_cols - mi_col) * MI)
            on_h = min(bh, (self.mi_rows - mi_row) * MI)
            cmap = pal.code_color_map(
                io, self.fc,
                None if io.is_decoder else decision.palette_map,
                bw, bh, len(pal_colors), 0, on_w, on_h)
            if io.is_decoder:
                decision.palette_map = cmap

        # luma tx size (read_tx_size; signaled even for skip intra blocks)
        if self.fh.tx_mode_select and not (bw == 4 and bh == 4):
            mdep = bsize_max_tx_depth(bw, bh)
            ctx = self._tx_size_ctx(mi_row, mi_col, bw, bh)
            depth = io.symbol(
                None if io.is_decoder else decision.tx_depth,
                self.fc.tx_size[bsize_tx_size_cat(bw, bh)][ctx], mdep + 1)
            decision.tx_depth = depth

        # record mode info
        self.y_modes[mi_row:mi_row + h4, mi_col:mi_col + w4] = y_mode
        self.skips[mi_row:mi_row + h4, mi_col:mi_col + w4] = int(skip)

        self._record_mi(mi_row, mi_col, w4, h4, decision, int(skip))

        # residual
        if io.is_decoder:
            self._decode_residual(decision, skip, x, y, bw, bh)
        else:
            self._write_residual(decision, txbs, skip, x, y, bw, bh)

    # -- compute (encoder) -------------------------------------------------

    def tx_size_for(self, plane: int, bw: int, bh: int) -> TxSize:
        if plane == 0:
            return max_txsize_rect(bw, bh)
        return max_txsize_rect(max(bw >> self.sub_x, 4),
                               max(bh >> self.sub_y, 4))

    def luma_tx_size(self, decision, bw: int, bh: int) -> TxSize:
        """Coded luma tx size: the block's max rect size split
        ``decision.tx_depth`` times (TX_MODE_SELECT)."""
        d = getattr(decision, "tx_depth", 0) if decision is not None else 0
        return depth_to_tx_size(d, bw, bh)

    def aq_seg(self, x: int, y: int) -> int:
        m = getattr(self, "aq_map", None)
        if m is None:
            return 0
        sb = self.seq.sb_size
        return int(m[min(y // sb, m.shape[0] - 1),
                     min(x // sb, m.shape[1] - 1)])

    def seg_qidx(self, segment_id: int) -> int:
        """Per-segment qindex (get_qindex: base + ALT_Q delta)."""
        qd = self.fh.seg_qdeltas
        if not qd or segment_id >= len(qd) or not qd[segment_id]:
            return self.fh.base_q_idx
        return int(np.clip(self.fh.base_q_idx + qd[segment_id], 1, 255))

    def _seg_pred(self, mi_row, mi_col):
        """Spatial predictor + cdf index (read_segment_id,
        EbDecParseBlock.c:504)."""
        up = mi_row > self.tile[0]
        left = mi_col > self.tile[1]
        prev_ul = int(self.seg_map[mi_row - 1, mi_col - 1]) \
            if up and left else -1
        prev_u = int(self.seg_map[mi_row - 1, mi_col]) if up else -1
        prev_l = int(self.seg_map[mi_row, mi_col - 1]) if left else -1
        if prev_ul < 0:
            cdf_num = 0
        elif prev_ul == prev_u and prev_ul == prev_l:
            cdf_num = 2
        elif prev_ul == prev_u or prev_ul == prev_l or prev_u == prev_l:
            cdf_num = 1
        else:
            cdf_num = 0
        if prev_u == -1:
            pred = 0 if prev_l == -1 else prev_l
        elif prev_l == -1:
            pred = prev_u
        else:
            pred = prev_u if prev_ul == prev_u else prev_l
        return pred, cdf_num

    @staticmethod
    def _neg_interleave(x, ref, mx):
        d = x - ref
        if ref == 0:
            return x
        if ref >= mx - 1:
            return -d
        if 2 * ref < mx:
            if abs(d) <= ref:
                return 2 * d - 1 if d > 0 else -2 * d
            return x
        if abs(d) <= mx - ref - 1:
            return 2 * d - 1 if d > 0 else -2 * d
        return mx - 1 - x

    @staticmethod
    def _neg_deinterleave(diff, ref, mx):
        if ref == 0:
            return diff
        if ref >= mx - 1:
            return mx - diff - 1
        if 2 * ref < mx:
            if diff <= 2 * ref:
                return ref + ((diff + 1) >> 1) if diff & 1 \
                    else ref - (diff >> 1)
            return diff
        if diff <= 2 * (mx - ref - 1):
            return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
        return mx - 1 - diff

    def _code_cdef_idx(self, skip, mi_row, mi_col, w4, h4):
        """Per-64x64 cdef strength index, a cdef_bits literal at the
        unit's first non-skip block (read_cdef, EbDecParseBlock.c:332;
        write_cdef, EbEntropyCoding.c:4406).  The per-SB preset reset of
        the reference is equivalent to this per-unit coded tracker: a
        cdef unit lies inside exactly one superblock."""
        fh, seq = self.fh, self.seq
        if (not seq.enable_cdef or fh.coded_lossless
                or fh.allow_intrabc or fh.cdef_bits == 0 or skip):
            return
        ur, uc = mi_row >> 4, mi_col >> 4
        if self._cdef_coded[ur, uc]:
            return
        if self.io.is_decoder:
            idx = self.io.literal(None, fh.cdef_bits)
        else:
            idx = self.io.literal(int(self.cdef_idx_grid[ur, uc]),
                                  fh.cdef_bits)
        # blocks larger than 64px propagate to every spanned unit
        r1 = max(ur + 1, min(ur + ((h4 + 15) >> 4),
                             self._cdef_coded.shape[0]))
        c1 = max(uc + 1, min(uc + ((w4 + 15) >> 4),
                             self._cdef_coded.shape[1]))
        self._cdef_coded[ur:r1, uc:c1] = True
        self.cdef_idx_grid[ur:r1, uc:c1] = idx

    def _code_segment_id(self, decision, skip, mi_row, mi_col, w4, h4):
        """intra_segment_id: spatial-pred coded id; skip blocks take
        the predictor without a symbol."""
        from ..bitstream.headers import seg_last_active
        if not self.fh.seg_qdeltas:
            return 0
        pred, cdf_num = self._seg_pred(mi_row, mi_col)
        if skip:
            seg = pred
        else:
            mx = seg_last_active(self.fh) + 1
            io = self.io
            if io.is_decoder:
                coded = io.symbol(None, self.fc.seg_spatial[cdf_num], 8)
                seg = self._neg_deinterleave(coded, pred, mx)
            else:
                seg = min(decision.segment_id, mx - 1)
                io.symbol(self._neg_interleave(seg, pred, mx),
                          self.fc.seg_spatial[cdf_num], 8)
        r1 = min(mi_row + h4, self.mi_rows)
        c1 = min(mi_col + w4, self.mi_cols)
        self.seg_map[mi_row:r1, mi_col:c1] = seg
        return seg

    def _tx_size_ctx(self, mi_row, mi_col, bw, bh) -> int:
        """get_tx_size_context (EbDecParseHelper.c:56): above/left coded
        tx dims vs this block's max tx dims.  Key-frame form (all
        neighbors intra, so no inter block-size override)."""
        max_ts = max_txsize_rect(bw, bh)
        up = mi_row > self.tile[0]
        left = mi_col > self.tile[1]
        a = int(self.tx_w_grid[0][mi_row - 1, mi_col] >= TX_WIDTH[max_ts]) \
            if up else 0
        l = int(self.tx_h_grid[0][mi_row, mi_col - 1] >= TX_HEIGHT[max_ts]) \
            if left else 0
        if up and left:
            return a + l
        return a if up else (l if left else 0)

    def tx_type_for(self, plane: int, decision: BlockDecision,
                    tx_size: TxSize) -> TxType:
        if max(TX_WIDTH[tx_size], TX_HEIGHT[tx_size]) > 32:
            return TxType.DCT_DCT
        if plane == 0:
            return decision.tx_type_y
        mode = 0 if decision.uv_mode == 13 else decision.uv_mode
        tt = _INTRA_MODE_TO_TX_TYPE[mode]
        set_type = get_ext_tx_set_type(tx_size, False, self.fh.reduced_tx_set)
        if not ext_tx_used(set_type, tt):
            return TxType.DCT_DCT
        return tt

    def _plane_quant(self, plane: int) -> qz.PlaneQuant:
        return (self.yq, self.uq, self.vq)[plane]

    def _code_cfl(self, decision):
        """cfl_alpha_signs + per-plane alpha magnitudes
        (read_cfl_alphas, EbDecParseBlock.c:316)."""
        io = self.io
        enc = None if io.is_decoder else decision
        signs = io.symbol(None if enc is None else enc.cfl_signs,
                          self.fc.cfl_sign, 8)
        idx = 0
        if intra_ops.cfl_sign_u(signs) != 0:
            u = io.symbol(None if enc is None else enc.cfl_idx >> 4,
                          self.fc.cfl_alpha[signs + 1 - 3], 16)
            idx = u << 4
        if intra_ops.cfl_sign_v(signs) != 0:
            ctx = intra_ops.cfl_sign_v(signs) * 3 \
                + intra_ops.cfl_sign_u(signs) - 3
            v = io.symbol(None if enc is None else enc.cfl_idx & 15,
                          self.fc.cfl_alpha[ctx], 16)
            idx += v
        return signs, idx

    def predict_chroma(self, plane, decision, px, py, pw, ph, ts):
        """Chroma intra prediction incl. chroma-from-luma."""
        if decision.uv_mode == 13:
            luma = self.recon[0][py * 2:py * 2 + ph * 2,
                                 px * 2:px * 2 + pw * 2]
            return self.predict_chroma_with_luma(plane, decision, px, py,
                                                 pw, ph, ts, luma)
        return self.predict(plane, PredictionMode(decision.uv_mode),
                            decision.angle_delta_uv, px, py, pw, ph, ts)

    def predict_chroma_with_luma(self, plane, decision, px, py, pw, ph,
                                 ts, luma_recon):
        """CfL prediction from an explicit luma recon buffer (the RDO
        trial path supplies it before the block lands in the frame)."""
        dc = self.predict(plane, PredictionMode.DC_PRED, 0,
                          px, py, pw, ph, ts)
        ac = intra_ops.cfl_ac(intra_ops.cfl_luma_q3(luma_recon))
        alpha = intra_ops.cfl_idx_to_alpha(
            decision.cfl_idx, decision.cfl_signs, plane == 1)
        return np.asarray(intra_ops.cfl_predict(
            dc, ac, alpha, self.seq.bit_depth))

    def _compute_block(self, decision, x, y, bw, bh):
        """Predict/transform/quantize/recon every tx block; returns their
        coded info in plane order (y, u, v).  With TX_MODE_SELECT the
        luma plane is covered by several tx blocks of the signaled size,
        each predicted from the running recon (spec reconstruct())."""
        out = []
        for plane in range(self.num_planes):
            sx = self.sub_x if plane else 0
            sy = self.sub_y if plane else 0
            px0, py0 = x >> sx, y >> sy
            pw, ph = bw >> sx, bh >> sy
            if plane == 0:
                ts = self.luma_tx_size(decision, bw, bh)
            else:
                ts = self.tx_size_for(plane, bw, bh)
            tt = self.tx_type_for(plane, decision, ts)
            tw, th = TX_WIDTH[ts], TX_HEIGHT[ts]
            ch, cw = min(th, 32), min(tw, 32)
            for py in range(py0, py0 + ph, th):
                for px in range(px0, px0 + pw, tw):
                    if decision.use_intrabc:
                        pred = self._ibc_pred(decision, plane, px, py,
                                              tw, th)
                    elif plane == 0 and decision.palette_colors:
                        pred = self._palette_pred(decision, px, py, tw,
                                                  th, (px0, py0, pw, ph))
                    elif plane == 0:
                        pred = self.predict(
                            plane, decision.y_mode, decision.angle_delta_y,
                            px, py, tw, th, ts, decision.filter_intra_mode,
                            blk=(px0, py0, pw, ph))
                    else:
                        pred = self.predict_chroma(plane, decision, px, py,
                                                   tw, th, ts)
                    src = self.source[plane][py:py + th, px:px + tw]
                    rdoq_ctx = None
                    if self.rdoq_level:
                        # same call the write pass makes (_write_residual);
                        # for sub-TX luma blocks later txbs see slightly
                        # stale neighbor levels — a rate-table choice
                        # only, never a conformance problem
                        sk_ctx, dc_ctx = self._txb_ctx(
                            plane, px, py, tw, th, ts,
                            pw == tw and ph == th)
                        rdoq_ctx = (sk_ctx, dc_ctx, decision.is_inter)
                    qc, eob, recon = self._tx_quant_recon(
                        plane, src, pred, ts, tt,
                        self.seg_qidx(decision.segment_id),
                        rdoq_ctx=rdoq_ctx)
                    self.recon[plane][py:py + th, px:px + tw] = recon
                    self._record_tx_geometry(plane, px, py, tw, th, ts)
                    out.append(dict(plane=plane, tx_size=ts, tx_type=tt,
                                    qcoeff=qc[:ch, :cw], eob=eob,
                                    px=px, py=py, pw=tw, ph=th,
                                    beq=(pw == tw and ph == th),
                                    blk=(px0, py0, pw, ph)))
        return out

    # -- RDOQ (trellis level optimization) --------------------------------

    rdoq_level = 0                 # set by the encoder (DerivedSignals)
    rdoq_layer = (0, 0)            # (temporal_layer, max_layer)

    def _rdoq_state(self):
        """(RdoqTables, frame sse-lambda) — frame-constant, built from
        the INITIAL frame CDFs like the reference's md_rate_estimation
        (av1_estimate_coefficients_rate, EbMdRateEstimation.c:420)."""
        if getattr(self, "_rdoq_cache", None) is None:
            from ..ops import rdoq as rq
            tl, ml = self.rdoq_layer
            lam = rq.compute_rdmult(
                self.fh.base_q_idx, self.seq.bit_depth,
                self.fh.frame_type in (FrameType.KEY_FRAME,
                                       FrameType.INTRA_ONLY_FRAME),
                tl, ml)
            self._rdoq_cache = (rq.tables_for_qindex(self.fh.base_q_idx),
                                lam)
        return self._rdoq_cache

    def _rdoq_run(self, plane, ts, tt, sk_ctx, dc_ctx, is_inter):
        """The per-txb run descriptor consumed by the native kernel and
        the Python fallback: (tabs7, rdmult, tx_class, shape, use_fp)."""
        from ..ops import rdoq as rq
        tables, lam = self._rdoq_state()
        plane_type = int(plane > 0)
        tabs = rq.sliced_tabs(tables, cf.txs_ctx(ts), plane_type,
                              sk_ctx, dc_ctx, cf.eob_multi_size(ts))
        rdmult = rq.plane_rdmult(lam, is_inter, plane_type)
        return (tabs, rdmult, cf.TX_TYPE_TO_CLASS[tt],
                cf._tx_shape(ts), 1)

    def _tx_quant_recon(self, plane, src, pred, ts, tt, qidx=None,
                        rdoq_ctx=None):
        """Forward TX + quantize [+ trellis] + eob + recon for one
        block; the fused native kernel when available, the batched
        Python path otherwise (bit-identical —
        tests/test_native_block.py, tests/test_rdoq.py).

        ``rdoq_ctx``: (txb_skip_ctx, dc_sign_ctx, is_inter) enables the
        trellis optimizer fed by quantize_fp (rdoq_level 1 semantics,
        EbFullLoop.c:1190)."""
        if qidx is None:
            qidx = self.fh.base_q_idx
        rd = None
        if rdoq_ctx is not None and self.rdoq_level:
            rd = self._rdoq_run(plane, ts, tt, *rdoq_ctx)
        resid = src.astype(np.int32) - pred
        from ..native import block_plan
        got = block_plan.code_block(self._plane_quant(plane),
                                    qidx, ts, tt,
                                    self.seq.bit_depth, resid, pred,
                                    rdoq=rd) \
            if block_plan.available() else None
        if got is not None:
            return got
        coeffs = np.asarray(tf.fwd_txfm2d(resid, tt, ts, self.seq.bit_depth))
        if rd is None:
            qc, dqc = qz.quantize_b(coeffs, qidx,
                                    self._plane_quant(plane), ts)
        else:
            qc, dqc = qz.quantize_fp(coeffs, qidx,
                                     self._plane_quant(plane), ts)
        qc, dqc = np.asarray(qc), np.asarray(dqc)
        ch = min(TX_HEIGHT[ts], 32)
        cw = min(TX_WIDTH[ts], 32)
        eob = cf.compute_eob(qc[:ch, :cw], ts, tt)
        if rd is not None and eob > 0:
            from ..ops import rdoq as rq
            tabs, rdmult, tx_class, shape, _ = rd
            pq = self._plane_quant(plane)
            deq = pq.dequant[qidx]
            scan = np.ascontiguousarray(
                cf.scan_for(ts, tt).astype(np.int16))
            qcc = np.ascontiguousarray(qc[:ch, :cw])
            dqcc = np.ascontiguousarray(dqc[:ch, :cw])
            eob = rq.optimize_txb(
                np.ascontiguousarray(coeffs[:ch, :cw]).astype(np.int32),
                qcc, dqcc, eob, scan, cw, ch, tx_class,
                qz.tx_log_scale(ts), (int(deq[0]), int(deq[1])), rdmult,
                (tabs[0], tabs[1], tabs[2], tabs[3], tabs[4], tabs[5]),
                tabs[6].reshape(2, 11), shape)
            qc[:ch, :cw] = qcc
            dqc[:ch, :cw] = dqcc
        if eob == 0:
            dqc = np.zeros_like(dqc)
        recon = np.asarray(tf.inv_txfm2d_add(dqc, pred, tt, ts,
                                             self.seq.bit_depth))
        return qc, eob, recon

    # -- prediction --------------------------------------------------------

    def predict(self, plane: int, mode: PredictionMode, angle_delta: int,
                px: int, py: int, pw: int, ph: int, tx_size: TxSize,
                filter_intra_mode: int = -1, blk=None) -> np.ndarray:
        """Normative intra prediction for a tx block at plane position
        (px, py) with the current recon state.  ``blk`` = (px, py, pw,
        ph) of the CODING block in plane coords when the tx block is a
        sub block of it (TX_MODE_SELECT); availability (top-right /
        bottom-left) follows the block geometry + tx offset
        (has_top_right, EbIntraPrediction.c:431)."""
        rec = self.recon[plane]
        plane_w = self.aligned_w >> (self.sub_x if plane else 0)
        plane_h = self.aligned_h >> (self.sub_y if plane else 0)
        txw, txh = TX_WIDTH[tx_size], TX_HEIGHT[tx_size]
        t_r0, t_c0, t_r1, t_c1 = self.tile
        sub = (self.sub_x, self.sub_y) if plane else (0, 0)
        have_top = py > (t_r0 * MI) >> sub[1]
        have_left = px > (t_c0 * MI) >> sub[0]
        xr = plane_w - (px + txw)
        yd = plane_h - (py + txh)
        mi_row, mi_col = (py << (self.sub_y if plane else 0)) // MI, \
            (px << (self.sub_x if plane else 0)) // MI
        right_available = (mi_col + ((txw >> 2) << sub[0])) < t_c1
        bottom_available = yd > 0 and \
            (mi_row + ((txh >> 2) << sub[1])) < t_r1
        bpx, bpy, bpw, bph = blk if blk is not None else (px, py, pw, ph)
        row_off = (py - bpy) >> 2
        col_off = (px - bpx) >> 2
        bmi_row = (bpy << sub[1]) // MI
        bmi_col = (bpx << sub[0]) // MI
        part = getattr(self, "_cur_part", 0)
        have_top_right = _has_top_right(
            self.seq.sb_size, bpw, bph, bmi_row, bmi_col, have_top,
            right_available, tx_size, row_off, col_off, sub[0], sub[1],
            part)
        have_bottom_left = _has_bottom_left(
            self.seq.sb_size, bpw, bph, bmi_row, bmi_col, bottom_available,
            have_left, tx_size, row_off, col_off, sub[0], sub[1], part)

        n_top = min(txw, xr + txw) if have_top else 0
        n_topright = min(txw, xr) if have_top_right else 0
        n_left = min(txh, yd + txh) if have_left else 0
        n_bottomleft = min(txh, yd) if have_bottom_left else 0

        above_ref = rec[py - 1, px:px + n_top + n_topright + txw] if have_top else None
        if above_ref is not None and len(above_ref) < n_top + n_topright:
            n_topright = max(0, len(above_ref) - n_top)
        left_ref = rec[py:py + n_left + n_bottomleft, px - 1] if have_left else None
        topleft = int(rec[py - 1, px - 1]) if (have_top and have_left) else None
        filt_type = self._filter_type(plane, bpx, bpy)
        return np.asarray(intra_ops.predict_intra_block(
            mode, angle_delta, tx_size, above_ref, left_ref, topleft,
            n_top, n_topright, n_left, n_bottomleft, filt_type,
            disable_edge_filter=not self.seq.enable_intra_edge_filter,
            filter_intra_mode=filter_intra_mode,
            bd=self.seq.bit_depth))

    def _filter_type(self, plane: int, px: int, py: int) -> int:
        """Edge-filter type: 1 when above AND left neighbors are smooth
        intra modes (dec_get_filt_type).  All-intra: check neighbor
        y_modes for SMOOTH family."""
        mi_row = (py << (self.sub_y if plane else 0)) // MI
        mi_col = (px << (self.sub_x if plane else 0)) // MI
        def smooth(r, c):
            if r < self.tile[0] or c < self.tile[1]:
                return False
            m = int(self.y_modes[r, c])
            return m in (9, 10, 11)
        ab = smooth(mi_row - 1, mi_col)
        le = smooth(mi_row, mi_col - 1)
        return 1 if (ab or le) else 0

    # -- residual ----------------------------------------------------------

    def _txb_ctx(self, plane: int, px: int, py: int, pw: int, ph: int,
                 tx_size: TxSize, bsize_eq_tx: bool):
        """txb_skip + dc_sign contexts (get_txb_ctx, EbEntropyCoding.c:362)."""
        above = self.txb_above[plane]
        left = self.txb_left[plane]
        x4, y4 = px >> 2, py >> 2
        plane_w = self.aligned_w >> (1 if plane else 0)
        plane_h = self.aligned_h >> (1 if plane else 0)
        wu = min(TX_WIDTH[tx_size] >> 2, (plane_w - px) >> 2)
        hu = min(TX_HEIGHT[tx_size] >> 2, (plane_h - py) >> 2)
        signs = [0, -1, 1]
        dc_sign = 0
        for k in range(wu):
            dc_sign += signs[int(above[x4 + k]) >> cf.COEFF_CONTEXT_BITS]
        for k in range(hu):
            dc_sign += signs[int(left[y4 + k]) >> cf.COEFF_CONTEXT_BITS]
        dc_ctx = 2 if dc_sign > 0 else (1 if dc_sign < 0 else 0)

        if plane == 0:
            if bsize_eq_tx:
                return 0, dc_ctx
            skip_contexts = [[1, 2, 2, 2, 3], [1, 4, 4, 4, 5], [1, 4, 4, 4, 5],
                             [1, 4, 4, 4, 5], [1, 4, 4, 4, 6]]
            top = 0
            lft = 0
            for k in range(wu):
                top |= int(above[x4 + k])
            for k in range(hu):
                lft |= int(left[y4 + k])
            top &= cf.COEFF_CONTEXT_MASK
            lft &= cf.COEFF_CONTEXT_MASK
            mx = min(top | lft, 4)
            mn = min(min(top, lft), 4)
            return skip_contexts[mn][mx], dc_ctx
        ctx_base = int(any(above[x4 + k] for k in range(wu))) + \
            int(any(left[y4 + k] for k in range(hu)))
        ctx_offset = 7 if (pw == TX_WIDTH[tx_size] and ph == TX_HEIGHT[tx_size]) else 10
        return ctx_base + ctx_offset, dc_ctx

    def _update_txb_ctx(self, plane, px, py, tx_size, cul_level):
        x4, y4 = px >> 2, py >> 2
        wu, hu = TX_WIDTH[tx_size] >> 2, TX_HEIGHT[tx_size] >> 2
        self.txb_above[plane][x4:x4 + wu] = cul_level
        self.txb_left[plane][y4:y4 + hu] = cul_level

    def _tx_type_io(self, plane, tx_size, y_mode, tx_type_val):
        """Signal/parse the luma tx type (av1_write_tx_type)."""
        if plane != 0 or self.fh.base_q_idx == 0:
            return tx_type_val
        set_type = get_ext_tx_set_type(tx_size, False, self.fh.reduced_tx_set)
        nset = AV1_NUM_EXT_TX_SET[set_type]
        if nset <= 1:
            return TxType.DCT_DCT
        eset = EXT_TX_SET_INDEX[0][set_type]
        sq = cf._sq_idx(min(TX_WIDTH[tx_size], TX_HEIGHT[tx_size]))
        cdf = self.fc.intra_ext_tx[eset][sq][y_mode]
        if self.io.is_decoder:
            sym = self.io.symbol(None, cdf, nset)
            return TxType(AV1_EXT_TX_INV[set_type][sym])
        self.io.symbol(AV1_EXT_TX_IND[set_type][tx_type_val], cdf, nset)
        return tx_type_val

    def _write_residual(self, decision, txbs, skip, x, y, bw, bh):
        if skip:
            for t in txbs:
                plane = t["plane"]
                # re-run recon with zero coeffs (decision pass may have coded
                # nonzero levels that skip now discards)
                self._recon_skip(plane, decision, t)
                self._update_txb_ctx(plane, t["px"], t["py"], t["tx_size"], 0)
            return
        for t in txbs:
            plane = t["plane"]
            plane_type = int(plane > 0)
            bsize_eq_tx = t.get("beq", (t["pw"] == TX_WIDTH[t["tx_size"]]
                                        and t["ph"] == TX_HEIGHT[t["tx_size"]]))
            sk_ctx, dc_ctx = self._txb_ctx(plane, t["px"], t["py"], t["pw"],
                                           t["ph"], t["tx_size"], bsize_eq_tx)
            if plane != 0:
                ttw = None
            elif decision.use_intrabc:
                # intrabc blocks are inter for tx-type purposes
                # (is_inter_block includes use_intrabc, spec 5.11.47)
                ttw = (lambda ts=t["tx_size"], tt=t["tx_type"]:
                       self._inter_tx_type_io(ts, tt))
            else:
                ttw = (lambda ts=t["tx_size"], tt=t["tx_type"],
                       ym=_ctx_dir(decision):
                       self._tx_type_io(plane, ts, ym, tt))
            if hasattr(self.io.ec, "write_coeffs_fast"):
                cul = self.io.ec.write_coeffs_fast(
                    self.fc, t["qcoeff"], t["tx_size"], t["tx_type"],
                    plane_type, sk_ctx, dc_ctx, t["eob"], tx_type_writer=ttw)
            else:
                cul = cf.write_coeffs_txb(
                    self.io.ec, self.fc, t["qcoeff"], t["tx_size"],
                    t["tx_type"], plane_type, sk_ctx, dc_ctx, t["eob"],
                    tx_type_writer=ttw)
            self._update_txb_ctx(plane, t["px"], t["py"], t["tx_size"], cul)

    def _dv_ref(self, mi_row, mi_col, w4, h4):
        """DV prediction for intrabc (assign_intrabc_mv,
        EbDecParseInterBlock.c:1559): INTRA_FRAME MV stack nearest/near,
        falling back to av1_find_ref_dv's defaults."""
        stack_res = mv_pred.find_mv_stack(
            self.mi, mi_row, mi_col, w4, h4, 0,
            self.mi_rows, self.mi_cols, sb_mi=self.seq.sb_size // MI,
            sign_bias=self.sign_bias, force_int=True, tile=self.tile)
        nearest = tuple(stack_res.ref_mv_list[0])
        near = tuple(stack_res.ref_mv_list[1])
        dv = near if nearest == (0, 0) else nearest
        if dv == (0, 0):
            mib = self.seq.sb_size // MI
            if mi_row - mib < self.tile[0]:
                dv = (0, -(self.seq.sb_size + 256) * 8)
            else:
                dv = (-self.seq.sb_size * 8, 0)
        return ((dv[0] >> 3) * 8, (dv[1] >> 3) * 8)

    # INTRABC_DELAY_PIXELS = 256 => four 64-px superblocks of hardware
    # reconstruction delay (EbInterPrediction.h:42).
    INTRABC_DELAY_SB64 = 4

    def _dv_valid(self, dv, mi_row, mi_col, bw, bh) -> bool:
        """is_dv_valid (EbDecParseInterBlock.c:1478): full-pel, tile
        bounds, 256-px (four 64-SB) delay, wavefront constraint."""
        if (dv[0] & 7) or (dv[1] & 7):
            return False
        t_r0, t_c0, t_r1, t_c1 = self.tile
        src_top = mi_row * MI * 8 + dv[0]
        src_left = mi_col * MI * 8 + dv[1]
        src_bottom = (mi_row * MI + bh) * 8 + dv[0]
        src_right = (mi_col * MI + bw) * 8 + dv[1]
        if src_top < t_r0 * MI * 8 or src_left < t_c0 * MI * 8:
            return False
        if src_bottom > t_r1 * MI * 8 or src_right > t_c1 * MI * 8:
            return False
        if self.num_planes > 1:
            if bw < 8 and src_left < t_c0 * MI * 8 + 4 * 8:
                return False
            if bh < 8 and src_top < t_r0 * MI * 8 + 4 * 8:
                return False
        mib_log2 = 5 if self.seq.sb_size == 128 else 4
        sb_size = self.seq.sb_size
        active_sb_row = mi_row >> mib_log2
        active_sb64_col = (mi_col * MI) >> 6
        src_sb_row = ((src_bottom >> 3) - 1) // sb_size
        src_sb64_col = ((src_right >> 3) - 1) >> 6
        total = ((t_c1 - t_c0 - 1) >> 4) + 1
        active = active_sb_row * total + active_sb64_col
        src = src_sb_row * total + src_sb64_col
        if src >= active - self.INTRABC_DELAY_SB64:
            return False
        grad = 1 + self.INTRABC_DELAY_SB64 + (sb_size > 64)
        wf = grad * (active_sb_row - src_sb_row)
        if src_sb_row > active_sb_row or \
                src_sb64_col >= active_sb64_col \
                - self.INTRABC_DELAY_SB64 + wf:
            return False
        return True

    def _ibc_pred(self, decision, plane, px, py, pw, ph):
        """Intrabc prediction: copy from this frame's recon at the DV
        offset (filters are off on IBC frames, so recon is final).  The
        encoder restricts DVs to even full-pel, so chroma lands on
        integer positions."""
        sh = 1 if plane else 0
        dr = (decision.mv[0] >> 3) >> sh
        dc = (decision.mv[1] >> 3) >> sh
        return self.recon[plane][py + dr:py + dr + ph,
                                 px + dc:px + dc + pw].copy()

    def _try_intrabc(self, decision, x, y, bw, bh, mi_row, mi_col, w4,
                     h4):
        """IBC candidate: try a small set of valid even full-pel DVs
        (dv_ref, neighbor DVs, block-width/height strides) by recon SAD
        vs the chosen intra mode (hash-ME analog envelope,
        hash_motion.c:369)."""
        if decision.palette_colors or decision.use_intrabc:
            return decision
        from .rdo import rd_lambda
        cands = [self._dv_ref(mi_row, mi_col, w4, h4)]
        if mi_col > self.tile[1] and self.intrabc_grid[mi_row, mi_col - 1]:
            cands.append((int(self.mi.mv_row[mi_row, mi_col - 1]),
                          int(self.mi.mv_col[mi_row, mi_col - 1])))
        if mi_row > self.tile[0] and self.intrabc_grid[mi_row - 1, mi_col]:
            cands.append((int(self.mi.mv_row[mi_row - 1, mi_col]),
                          int(self.mi.mv_col[mi_row - 1, mi_col])))
        for k in (1, 2, 3, 4):
            cands.append((0, -8 * k * bw))
            cands.append((-8 * k * bh, 0))
        # Delay-4 legal region starts 256 px back on the same SB row
        # (or any position ≥1 SB row up within the wavefront): add
        # SB-granular candidates that clear INTRABC_DELAY_PIXELS.
        sb = self.seq.sb_size
        for k in (1, 2):
            cands.append((0, -8 * (256 + (k - 1) * bw)))
            cands.append((-8 * k * sb, 0))
            cands.append((-8 * k * sb, -8 * bw))
        src = self.source[0][y:y + bh, x:x + bw].astype(np.int64)
        best = None
        seen = set()
        for dv in cands:
            dv = ((dv[0] >> 4) * 16, (dv[1] >> 4) * 16)   # even full-pel
            if dv in seen or dv == (0, 0):
                continue
            seen.add(dv)
            if not self._dv_valid(dv, mi_row, mi_col, bw, bh):
                continue
            d = BlockDecision(use_intrabc=True,
                              mv=(int(dv[0]), int(dv[1])))
            pred = self._ibc_pred(d, 0, x, y, bw, bh)
            sad = int(np.abs(src - pred).sum())
            if best is None or sad < best[0]:
                best = (sad, dv)
        if best is None:
            return decision
        ts = self.tx_size_for(0, bw, bh)
        pred_m = self.predict(0, decision.y_mode, decision.angle_delta_y,
                              x, y, bw, bh, ts,
                              decision.filter_intra_mode)
        sad_m = int(np.abs(src - pred_m).sum())
        lam = rd_lambda(self.fh.base_q_idx, self.seq.bit_depth)
        # dv bits proxy ~ 12; intra mode bits ~ 4: charge the difference
        if best[0] + np.sqrt(lam) * 8 < sad_m:
            return BlockDecision(use_intrabc=True,
                                 mv=(int(best[1][0]), int(best[1][1])),
                                 segment_id=decision.segment_id)
        return decision

    def _try_palette(self, decision, x, y, bw, bh):
        """Palette candidate for one intra block: k-means palette vs
        the chosen intra mode by luma SSE + rate proxies (the
        reference's palette RD search shape, palette.c search in
        EbModeDecision)."""
        from . import palette as pal
        from .rdo import rd_lambda
        if decision.is_inter or decision.palette_colors:
            return decision
        if not pal.allow_palette(True, bw, bh):
            return decision
        src = self.source[0][y:y + bh, x:x + bw]
        got = pal.kmeans_palette(src)
        if got is None:
            return decision
        colors, cmap, sse_pal = got
        ts = self.tx_size_for(0, bw, bh)
        pred = self.predict(0, decision.y_mode, decision.angle_delta_y,
                            x, y, bw, bh, ts,
                            decision.filter_intra_mode)
        sse_mode = float(((src.astype(np.int64) - pred) ** 2).sum())
        lam = rd_lambda(self.fh.base_q_idx, self.seq.bit_depth)
        bits_pal = (bw * bh * 0.7 * np.log2(len(colors))
                    + 10.0 * len(colors) + 8.0)
        if sse_pal + lam * bits_pal < sse_mode:
            return dataclasses.replace(
                decision, y_mode=PredictionMode.DC_PRED, angle_delta_y=0,
                filter_intra_mode=-1, tx_depth=0,
                palette_colors=tuple(colors), palette_map=cmap)
        return decision

    def _palette_pred(self, decision, px, py, tw, th, blk):
        """Luma palette prediction for one tx block: colors[index map]
        (palette_tokens' prediction step, EbDecParseInterBlock.c:2378)."""
        x0, y0 = blk[0], blk[1]
        m = decision.palette_map[py - y0:py - y0 + th,
                                 px - x0:px - x0 + tw]
        return np.asarray(decision.palette_colors, np.int32)[m]

    def _recon_skip(self, plane, decision, t):
        """Redo recon with zero residual for skip blocks."""
        if decision.use_intrabc:
            pred = self._ibc_pred(decision, plane, t["px"], t["py"],
                                  t["pw"], t["ph"])
        elif plane == 0 and decision.palette_colors:
            pred = self._palette_pred(decision, t["px"], t["py"],
                                      t["pw"], t["ph"], t.get("blk"))
        elif plane == 0:
            pred = self.predict(plane, decision.y_mode,
                                decision.angle_delta_y, t["px"], t["py"],
                                t["pw"], t["ph"], t["tx_size"],
                                decision.filter_intra_mode,
                                blk=t.get("blk"))
        else:
            pred = self.predict_chroma(plane, decision, t["px"], t["py"],
                                       t["pw"], t["ph"], t["tx_size"])
        self.recon[plane][t["py"]:t["py"] + t["ph"],
                          t["px"]:t["px"] + t["pw"]] = pred

    def _decode_residual(self, decision, skip, x, y, bw, bh):
        for plane in range(self.num_planes):
            sx = self.sub_x if plane else 0
            sy = self.sub_y if plane else 0
            px0, py0 = x >> sx, y >> sy
            pw, ph = bw >> sx, bh >> sy
            if plane == 0:
                ts = self.luma_tx_size(decision, bw, bh)
            else:
                ts = self.tx_size_for(plane, bw, bh)
            tw, th = TX_WIDTH[ts], TX_HEIGHT[ts]
            beq = pw == tw and ph == th
            for py in range(py0, py0 + ph, th):
                for px in range(px0, px0 + pw, tw):
                    self._decode_txb(decision, skip, plane, px, py, tw, th,
                                     ts, beq, (px0, py0, pw, ph))

    def _decode_txb(self, decision, skip, plane, px, py, tw, th, ts, beq,
                    blk):
        self._record_tx_geometry(plane, px, py, tw, th, ts)

        def _pred():
            if decision.use_intrabc:
                return self._ibc_pred(decision, plane, px, py, tw, th)
            if plane == 0 and decision.palette_colors:
                return self._palette_pred(decision, px, py, tw, th, blk)
            if plane == 0:
                return self.predict(plane, decision.y_mode,
                                    decision.angle_delta_y,
                                    px, py, tw, th, ts,
                                    decision.filter_intra_mode, blk=blk)
            return self.predict_chroma(plane, decision, px, py, tw, th, ts)

        if skip:
            self.recon[plane][py:py + th, px:px + tw] = _pred()
            self._update_txb_ctx(plane, px, py, ts, 0)
            return
        plane_type = int(plane > 0)
        sk_ctx, dc_ctx = self._txb_ctx(plane, px, py, tw, th, ts, beq)
        default_tt = self.tx_type_for(plane, decision, ts)
        if plane != 0:
            ttr = None
        elif decision.use_intrabc:
            ttr = (lambda ts=ts: self._inter_tx_type_io(ts, None))
        else:
            ttr = (lambda ts=ts, ym=_ctx_dir(decision):
                   self._tx_type_io(plane, ts, ym, None))
        qc, eob, cul, tt = cf.parse_coeffs_txb(
            self.io.ec, self.fc, ts,
            default_tt, plane_type, sk_ctx, dc_ctx,
            tx_type_reader=ttr)
        self._update_txb_ctx(plane, px, py, ts, cul)
        pred = _pred()
        if eob == 0:
            self.recon[plane][py:py + th, px:px + tw] = pred
            return
        full = np.zeros((TX_HEIGHT[ts], TX_WIDTH[ts]), np.int32)
        full[:qc.shape[0], :qc.shape[1]] = qc
        dqc = np.asarray(qz.dequant_block(
            full, self.seg_qidx(decision.segment_id),
            self._plane_quant(plane), ts))
        recon = np.asarray(tf.inv_txfm2d_add(dqc, pred, tt, ts,
                                             self.seq.bit_depth))
        self.recon[plane][py:py + th, px:px + tw] = recon

    def _record_tx_geometry(self, plane, px, py, pw, ph, ts):
        x4, y4 = px >> 2, py >> 2
        w4, h4 = pw >> 2, ph >> 2
        self.tx_w_grid[plane][y4:y4 + h4, x4:x4 + w4] = TX_WIDTH[ts]
        self.tx_h_grid[plane][y4:y4 + h4, x4:x4 + w4] = TX_HEIGHT[ts]
        self.bedge_x[plane][y4:y4 + h4, x4] = True
        self.bedge_y[plane][y4, x4:x4 + w4] = True

    def apply_loop_filter(self):
        """In-loop deblocking, applied after the whole frame reconstructs
        (intra prediction saw the unfiltered recon, matching the spec
        pipeline), on the codec's device (the deblocking kernel).  The
        encoder searches the level over the candidate ladder and applies
        the winner (EbDlfProcess.c level search analog); the searched
        level lands in the header.  The decoder, and the encoder's second
        entropy pass over a searched header, apply the header's levels."""
        from ..ops import dlf

        fh = self.fh
        if fh.coded_lossless or fh.allow_intrabc \
                or max(fh.filter_level) == 0:
            self._save_deblocked()
            return
        if self.source is None or getattr(fh, "dlf_level_searched", False):
            self._apply_header_deblocking()
            self._save_deblocked()
            return
        if self.num_planes != 3:
            raise NotImplementedError("deblocking of monochrome frames is "
                                      "not ported")
        grids = [(self.tx_w_grid[p], self.tx_h_grid[p],
                  self.skip_grid[p], self.bedge_x[p], self.bedge_y[p])
                 for p in range(3)]
        vis = [((fh.frame_width + (1 if p else 0)) >> (1 if p else 0),
                (fh.frame_height + (1 if p else 0)) >> (1 if p else 0))
               for p in range(3)]
        out, level = dlf.dlf_search_apply_device(
            self.recon[:3], self.device_source()[0], grids, vis,
            max(fh.filter_level), fh.sharpness, self.seq.bit_depth)
        fh.filter_level = (level, level)
        fh.filter_level_uv = (level, level)
        fh.dlf_level_searched = True
        if level > 0:
            for p in range(3):
                self.recon[p] = out[p]
        self._save_deblocked()

    def _apply_header_deblocking(self):
        """Decoder: normative deblocking of every plane at the header's
        levels (luma vertical / horizontal, then filter_level_uv per
        chroma plane) through the deblocking kernel."""
        import torch

        from ..device import to_device, to_host
        from ..ops import dlf

        fh = self.fh
        levels = [tuple(fh.filter_level), (fh.filter_level_uv[0],) * 2,
                  (fh.filter_level_uv[1],) * 2]
        for p in range(self.num_planes):
            lv, lh = levels[p]
            if lv == 0 and lh == 0:
                continue
            sub = 1 if p else 0
            vw = (fh.frame_width + sub) >> sub
            vh = (fh.frame_height + sub) >> sub
            masks = dlf.edge_params(
                self.tx_w_grid[p], self.tx_h_grid[p], self.skip_grid[p],
                self.bedge_x[p], self.bedge_y[p], vw, vh, p > 0)
            plane = to_device(torch.from_numpy(np.ascontiguousarray(
                self.recon[p], np.int32)), self.device)
            out = dlf.deblock(plane, *masks, vw, vh, lv, lh, fh.sharpness,
                              self.seq.bit_depth)
            self.recon[p] = to_host(out).numpy()

    def apply_cdef(self):
        """Normative CDEF at the header's strengths (spec 7.15) on the
        codec's device: the direction search, then the filter (the CDEF
        kernels), at the frame-level strengths or, with cdef_bits > 0,
        at each 64x64 filter block's preset (spec 7.15.1: cdef_idx,
        coded in-tile, selects into the header's lists).  The decoder
        and the encoder's second entropy pass call it."""
        import torch

        from ..device import to_device, to_host
        from ..ops import cdef as cdef_ops

        fh = self.fh
        if (not self.seq.enable_cdef or fh.coded_lossless
                or fh.allow_intrabc):
            return
        y_str, uv_str = fh.cdef_y_strengths[0], fh.cdef_uv_strengths[0]
        if fh.cdef_bits == 0 and y_str == 0 and uv_str == 0:
            return
        ns = cdef_ops.nonskip_grid(self.skips, self.mi_rows, self.mi_cols)
        if not ns.any():
            return
        fw, fh_px = self.mi_cols * 4, self.mi_rows * 4
        planes = self._recon_on_device()
        ns = to_device(torch.from_numpy(ns), self.device)
        bd = self.seq.bit_depth
        dirs, var = cdef_ops.cdef_direction(planes[0], fw, fh_px,
                                            max(bd - 8, 0))
        if fh.cdef_bits > 0:
            out = cdef_ops.cdef_apply_multi(
                planes, ns, dirs, var, fh.cdef_y_strengths,
                fh.cdef_uv_strengths, self.cdef_idx_grid, fh.cdef_damping,
                fw, fh_px, bd)
        else:
            out = cdef_ops.cdef_apply(planes, ns, dirs, var, y_str, uv_str,
                                      fh.cdef_damping, fw, fh_px, bd)
        for p, o in enumerate(out):
            self.recon[p] = to_host(o).numpy()

    def _recon_on_device(self):
        """The recon planes as int32 tensors on the codec's device."""
        import torch

        from ..device import to_device

        return [to_device(torch.from_numpy(np.ascontiguousarray(p, np.int32)),
                          self.device) for p in self.recon[:self.num_planes]]

    def _save_deblocked(self):
        if self.seq.enable_restoration:
            self.deblocked = [self.recon[p].copy()
                              for p in range(self.num_planes)]

    def device_source(self):
        """The source planes as narrow tensors on the codec's device,
        uploaded once per frame (the planner may already have done so)
        and shared by the intra decision and the filter searches."""
        if self.dev_source is None:
            import torch

            from ..device import SAMPLE_DTYPES, to_device

            dt = SAMPLE_DTYPES[self.seq.bit_depth]
            self.dev_source = tuple(
                to_device(torch.from_numpy(np.ascontiguousarray(p)),
                          self.device, dt)
                for p in self.source)
        return self.dev_source

    def search_and_apply_cdef(self):
        """Encoder: strength search over the full grid and apply of the
        winner on the codec's device (single recon upload / download)."""
        from ..ops import cdef as cdef_ops

        fh = self.fh
        if (not self.seq.enable_cdef or fh.coded_lossless
                or fh.allow_intrabc):
            return
        got = cdef_ops.cdef_search_apply_device(
            self.device_source()[:self.num_planes],
            self.recon[:self.num_planes], self.skips, self.mi_rows,
            self.mi_cols, fh.cdef_damping, self.seq.bit_depth)
        if got is None:
            fh.cdef_y_strengths = (0,)
            fh.cdef_uv_strengths = (0,)
            return
        out, y_str, uv_str = got
        fh.cdef_y_strengths = (y_str,)
        fh.cdef_uv_strengths = (uv_str,)
        if y_str == 0 and uv_str == 0:
            return                    # strengths 0: recon unchanged
        for p in range(self.num_planes):
            self.recon[p] = out[p]

    def search_and_apply_cdef_multi(self, lambda_sse: int) -> bool:
        """Multi-preset CDEF search (finish_cdef_search,
        EbEncCdef.c:1167) on the codec's device: per-64x64-fb error maps
        over the full strength grid (K4's per-fb search), joint
        preset-set selection under the frame SSE lambda on the host,
        per-fb indices, and the apply of the winners (K4's per-fb apply).
        Fills the frame header + ``cdef_idx_grid``; returns True when
        cdef_bits > 0 (the tile syntax must then be coded with the
        indices)."""
        import torch

        from ..device import to_device, to_host
        from ..ops import cdef as cdef_ops

        fh = self.fh
        if (not self.seq.enable_cdef or fh.coded_lossless
                or fh.allow_intrabc or self.source is None):
            return False
        nonskip = cdef_ops.nonskip_grid(self.skips, self.mi_rows,
                                        self.mi_cols)
        if not nonskip.any():
            fh.cdef_y_strengths = (0,)
            fh.cdef_uv_strengths = (0,)
            return False
        planes = self._recon_on_device()
        out, bits, y_list, uv_list, idx_grid = cdef_ops.search_apply_multi(
            self.device_source()[:self.num_planes], planes,
            to_device(torch.from_numpy(nonskip), self.device),
            self.mi_cols * 4,
            self.mi_rows * 4, fh.cdef_damping, self.seq.bit_depth,
            lambda_sse)
        fh.cdef_bits = bits
        fh.cdef_y_strengths = y_list
        fh.cdef_uv_strengths = uv_list
        self.cdef_idx_grid[:] = idx_grid[:self.cdef_idx_grid.shape[0],
                                         :self.cdef_idx_grid.shape[1]]
        for p, o in enumerate(out):
            self.recon[p] = to_host(o).numpy()
        return bits > 0

    def search_cdef(self):
        """Encoder-side frame-level strength search on the codec's device
        (K3's directions, K4's search over the full grid); fills the
        frame-header fields."""
        import torch

        from ..device import to_device
        from ..ops import cdef as cdef_ops

        fh = self.fh
        if (not self.seq.enable_cdef or fh.coded_lossless
                or fh.allow_intrabc):
            return
        nonskip = cdef_ops.nonskip_grid(self.skips, self.mi_rows,
                                        self.mi_cols)
        if not nonskip.any():
            fh.cdef_y_strengths = (0,)
            fh.cdef_uv_strengths = (0,)
            return
        fw, fh_px, bd = self.mi_cols * 4, self.mi_rows * 4, \
            self.seq.bit_depth
        planes = self._recon_on_device()
        dirs, var = cdef_ops.cdef_direction(planes[0], fw, fh_px,
                                            max(bd - 8, 0))
        err_y, err_uv = cdef_ops.cdef_search(
            self.device_source()[:self.num_planes], planes, dirs, var,
            to_device(torch.from_numpy(nonskip), self.device), fw, fh_px,
            fh.cdef_damping, bd)
        fh.cdef_y_strengths = (cdef_ops.pick_strength(
            err_y, cdef_ops.PRI_SET, cdef_ops.SEC_SET),)
        fh.cdef_uv_strengths = (cdef_ops.pick_strength(
            err_uv, cdef_ops.PRI_SET, cdef_ops.SEC_SET)
            if err_uv is not None else 0,)

    # -- inter frames ------------------------------------------------------

    def _record_mi(self, mi_row, mi_col, w4, h4, decision, skip):
        g = self.mi
        r0, r1 = mi_row, min(mi_row + h4, self.mi_rows)
        c0, c1 = mi_col, min(mi_col + w4, self.mi_cols)
        if decision.is_inter:
            g.ref_frame[r0:r1, c0:c1] = decision.ref
            g.mv_row[r0:r1, c0:c1] = decision.mv[0]
            g.mv_col[r0:r1, c0:c1] = decision.mv[1]
            g.mode[r0:r1, c0:c1] = decision.inter_mode
            g.ref_frame1[r0:r1, c0:c1] = decision.ref1
            g.mv1_row[r0:r1, c0:c1] = decision.mv1[0]
            g.mv1_col[r0:r1, c0:c1] = decision.mv1[1]
            self.comp_group[r0:r1, c0:c1] = \
                1 if getattr(decision, "compound_type", 0) else 0
            if g.interintra is not None:
                g.interintra[r0:r1, c0:c1] = \
                    bool(getattr(decision, "interintra", False))
        elif decision.use_intrabc:
            # spec: IBC blocks carry RefFrame INTRA_FRAME with the DV in
            # Mvs (feeds the INTRA_FRAME stack of later blocks)
            g.ref_frame[r0:r1, c0:c1] = 0
            g.mv_row[r0:r1, c0:c1] = decision.mv[0]
            g.mv_col[r0:r1, c0:c1] = decision.mv[1]
            g.mode[r0:r1, c0:c1] = 0
            g.ref_frame1[r0:r1, c0:c1] = 0
            self.intrabc_grid[r0:r1, c0:c1] = True
        else:
            g.ref_frame[r0:r1, c0:c1] = 0
            g.mv_row[r0:r1, c0:c1] = 0
            g.mv_col[r0:r1, c0:c1] = 0
            g.mode[r0:r1, c0:c1] = int(decision.y_mode)
            g.ref_frame1[r0:r1, c0:c1] = 0
        g.bw4[r0:r1, c0:c1] = w4
        g.bh4[r0:r1, c0:c1] = h4
        # DLF skip grids (inter blocks only count as skip for edge rules)
        dlf_skip = bool(skip) and decision.is_inter
        for plane in range(self.num_planes):
            sh = 1 if plane else 0
            y4a = (mi_row * MI >> sh) >> 2
            x4a = (mi_col * MI >> sh) >> 2
            gh = max((h4 * MI >> sh) >> 2, 1)
            gw = max((w4 * MI >> sh) >> 2, 1)
            self.skip_grid[plane][y4a:y4a + gh, x4a:x4a + gw] = dlf_skip

    def _comp_group_ctx(self, mi_row, mi_col):
        """comp_group_idx cdf context from the above/left neighbors
        (get_comp_group_idx_context_enc, EbEntropyCoding.c:97)."""
        out = 0
        for r, c in ((mi_row - 1, mi_col), (mi_row, mi_col - 1)):
            if r < self.tile[0] or c < self.tile[1]:
                continue
            if self.mi.ref_frame1[r, c] > 0:
                out += int(self.comp_group[r, c])
            elif self.mi.ref_frame[r, c] == 7:      # ALTREF single
                out += 3
        return min(5, out)

    def _intra_inter_ctx(self, mi_row, mi_col):
        up = mi_row > self.tile[0]
        left = mi_col > self.tile[1]
        above_intra = up and self.mi.ref_frame[mi_row - 1, mi_col] == 0
        left_intra = left and self.mi.ref_frame[mi_row, mi_col - 1] == 0
        if up and left:
            return 3 if (above_intra and left_intra) else int(above_intra or left_intra)
        if up or left:
            return 2 * int(above_intra if up else left_intra)
        return 0

    def _neighbor_ref_counts(self, mi_row, mi_col):
        counts = np.zeros(8, np.int32)
        for r, c in ((mi_row - 1, mi_col), (mi_row, mi_col - 1)):
            if r < self.tile[0] or c < self.tile[1]:
                continue
            if self.mi.ref_frame[r, c] > 0:
                counts[int(self.mi.ref_frame[r, c])] += 1
                if self.mi.ref_frame1[r, c] > 0:
                    counts[int(self.mi.ref_frame1[r, c])] += 1
        return counts

    @staticmethod
    def _ctx3(a, b):
        return 1 if a == b else (0 if a < b else 2)

    # named references (spec MvReferenceFrame)
    LAST, LAST2, LAST3, GOLDEN, BWDREF, ALTREF2, ALTREF = range(1, 8)

    def _nbr(self, mi_row, mi_col):
        """(is_avail, is_inter, ref0, has_second, uni_comp) for the
        above and left neighbors."""
        out = []
        for r, c in ((mi_row - 1, mi_col), (mi_row, mi_col - 1)):
            if r < self.tile[0] or c < self.tile[1]:
                out.append(None)
                continue
            rf0 = int(self.mi.ref_frame[r, c])
            rf1 = int(self.mi.ref_frame1[r, c])
            uni = rf1 > 0 and not ((rf0 >= self.BWDREF) ^ (rf1 >= self.BWDREF))
            out.append((rf0 > 0, rf0, rf1 > 0, uni))
        return out

    def _reference_mode_ctx(self, mi_row, mi_col):
        """get_reference_mode_context (EbDecParseInterBlock.c:63)."""
        above, left = self._nbr(mi_row, mi_col)
        bwd = lambda rf: rf >= self.BWDREF
        if above and left:
            a_inter, a_rf0, a_2nd, _ = above
            l_inter, l_rf0, l_2nd, _ = left
            if not a_2nd and not l_2nd:
                return int(bwd(a_rf0)) ^ int(bwd(l_rf0))
            if not a_2nd:
                return 2 + int(bwd(a_rf0) or not a_inter)
            if not l_2nd:
                return 2 + int(bwd(l_rf0) or not l_inter)
            return 4
        if above or left:
            e_inter, e_rf0, e_2nd, _ = above or left
            return 3 if e_2nd else int(bwd(e_rf0))
        return 1

    def _comp_ref_type_ctx(self, mi_row, mi_col):
        """get_comp_reference_type_context (EbDecParseHelper.c:217)."""
        above, left = self._nbr(mi_row, mi_col)
        bwd = lambda rf: rf >= self.BWDREF
        if above and left:
            a_inter, a_rf0, a_2nd, a_uni = above
            l_inter, l_rf0, l_2nd, l_uni = left
            if not a_inter and not l_inter:
                return 2
            if not a_inter or not l_inter:
                inter = above if not l_inter else left
                _, rf0, second, uni = inter
                return 2 if not second else 1 + 2 * int(uni)
            if not a_2nd and not l_2nd:
                return 1 + 2 * int(not (bwd(a_rf0) ^ bwd(l_rf0)))
            if not a_2nd or not l_2nd:
                uni = l_uni if not a_2nd else a_uni
                if not uni:
                    return 1
                return 3 + int(not (bwd(a_rf0) ^ bwd(l_rf0)))
            if not a_uni and not l_uni:
                return 0
            if not a_uni or not l_uni:
                return 2
            return 3 + int(not ((a_rf0 == self.BWDREF) ^ (l_rf0 == self.BWDREF)))
        if above or left:
            e_inter, e_rf0, e_2nd, e_uni = above or left
            if not e_inter:
                return 2
            return 2 if not e_2nd else 4 * int(e_uni)
        return 2

    def _code_comp_ref_frames(self, mi_row, mi_col, refs=None):
        """Compound (bidirectional) reference pair signaling."""
        io = self.io
        rc = self._neighbor_ref_counts(mi_row, mi_col)
        ctx3 = self._ctx3
        crt_ctx = self._comp_ref_type_ctx(mi_row, mi_col)
        crt = io.symbol(None if refs is None else 1,
                        self.fc.comp_ref_type[crt_ctx], 2)
        assert crt == 1, "unidirectional compound unsupported"

        def bit(value, cdf_set, ctx, idx):
            return io.symbol(None if refs is None else int(value),
                             cdf_set[ctx][idx], 2)

        r0 = None if refs is None else refs[0]
        b = bit(None if refs is None else r0 in (self.LAST3, self.GOLDEN),
                self.fc.comp_ref, ctx3(rc[1] + rc[2], rc[3] + rc[4]), 0)
        if not b:
            b1 = bit(None if refs is None else r0 == self.LAST2,
                     self.fc.comp_ref, ctx3(rc[1], rc[2]), 1)
            ref0 = self.LAST2 if b1 else self.LAST
        else:
            b2 = bit(None if refs is None else r0 == self.GOLDEN,
                     self.fc.comp_ref, ctx3(rc[3], rc[4]), 2)
            ref0 = self.GOLDEN if b2 else self.LAST3
        r1 = None if refs is None else refs[1]
        bb = bit(None if refs is None else r1 == self.ALTREF,
                 self.fc.comp_bwdref, ctx3(rc[5] + rc[6], rc[7]), 0)
        if bb:
            ref1 = self.ALTREF
        else:
            bb1 = bit(None if refs is None else r1 == self.ALTREF2,
                      self.fc.comp_bwdref, ctx3(rc[5], rc[6]), 1)
            ref1 = self.ALTREF2 if bb1 else self.BWDREF
        return ref0, ref1

    def _code_ref_frames(self, mi_row, mi_col, ref=None):
        """Single-reference signaling tree over all 7 named refs
        (read_ref_frames, EbDecParseInterBlock.c:242)."""
        io = self.io
        rc = self._neighbor_ref_counts(mi_row, mi_col)
        ctx3 = self._ctx3
        sr = self.fc.single_ref

        def bit(value, ctx, idx):
            return io.symbol(None if io.is_decoder else int(value),
                             sr[ctx][idx], 2)

        fwd = rc[1] + rc[2] + rc[3] + rc[4]
        bwd = rc[5] + rc[6] + rc[7]
        bit0 = bit(None if ref is None else ref >= self.BWDREF,
                   ctx3(fwd, bwd), 0)
        if bit0:
            bit1 = bit(None if ref is None else ref == self.ALTREF,
                       ctx3(rc[5] + rc[6], rc[7]), 1)
            if bit1:
                return self.ALTREF
            bit5 = bit(None if ref is None else ref == self.ALTREF2,
                       ctx3(rc[5], rc[6]), 5)
            return self.ALTREF2 if bit5 else self.BWDREF
        bit2 = bit(None if ref is None else ref in (self.LAST3, self.GOLDEN),
                   ctx3(rc[1] + rc[2], rc[3] + rc[4]), 2)
        if bit2:
            bit4 = bit(None if ref is None else ref == self.GOLDEN,
                       ctx3(rc[3], rc[4]), 4)
            return self.GOLDEN if bit4 else self.LAST3
        bit3 = bit(None if ref is None else ref == self.LAST2,
                   ctx3(rc[1], rc[2]), 3)
        return self.LAST2 if bit3 else self.LAST

    def _code_inter_mode(self, mode_ctx, mode):
        """newmv/zeromv/refmv flag ladder."""
        io = self.io
        newmv_ctx = mode_ctx & mv_pred.NEWMV_CTX_MASK
        notnew = io.symbol(None if io.is_decoder else int(mode != mv_pred.NEWMV),
                           self.fc.newmv[newmv_ctx], 2)
        if not notnew:
            return mv_pred.NEWMV
        zero_ctx = (mode_ctx >> mv_pred.GLOBALMV_OFFSET) & mv_pred.GLOBALMV_CTX_MASK
        notzero = io.symbol(None if io.is_decoder
                            else int(mode != mv_pred.GLOBALMV),
                            self.fc.zeromv[zero_ctx], 2)
        if not notzero:
            return mv_pred.GLOBALMV
        ref_ctx = (mode_ctx >> mv_pred.REFMV_OFFSET) & mv_pred.REFMV_CTX_MASK
        nearmv = io.symbol(None if io.is_decoder
                           else int(mode != mv_pred.NEARESTMV),
                           self.fc.refmv[ref_ctx], 2)
        return mv_pred.NEARMV if nearmv else mv_pred.NEARESTMV

    def _effective_drl_idx(self, mode, stack, ref_mv_idx) -> int:
        """_code_drl's index reconstruction WITHOUT coding: what the
        decoder will derive when a (possibly stale) requested index is
        coded against this stack.  Must mirror _code_drl exactly."""
        out = 0
        if mode in (mv_pred.NEWMV, mv_pred.NEW_NEWMV):
            for idx in range(2):
                if len(stack) > idx + 1:
                    out = idx
                    if ref_mv_idx == idx:
                        return out
                    out = idx + 1
        elif mode in (mv_pred.NEARMV, mv_pred.NEAR_NEARMV,
                      mv_pred.NEAR_NEWMV, mv_pred.NEW_NEARMV):
            for idx in range(1, 3):
                if len(stack) > idx + 1:
                    bit = int(ref_mv_idx > idx - 1)
                    out = idx + bit - 1
                    if not bit:
                        return out
        return out

    def _revalidate_inter_mvs(self, decision, mi_row, mi_col, w4, h4,
                              bw, bh):
        """Re-derive stack-implied MVs against the CODING-time MV
        stacks.  The decider's cached decisions were evaluated inside
        partition-search branches whose neighbor mi state may differ
        from the final pass; NEAREST/NEAR/GLOBAL (and compound) MVs are
        not coded explicitly, so a stale cached value would make the
        encoder predict with an MV the bitstream does not say
        (conformance desync).  Mirrors the derivations in _block_inter
        and _code_compound_mode."""
        mode = decision.inter_mode
        ref, ref1 = decision.ref, int(decision.ref1 or 0)
        lower = lambda mv: mv_pred.lower_mv_precision(mv, False, False)
        if ref1 > 0:
            stack_res = mv_pred.find_mv_stack(
                self.mi, mi_row, mi_col, w4, h4, ref,
                self.mi_rows, self.mi_cols, sb_mi=self.seq.sb_size // MI,
                sign_bias=self.sign_bias, ref_frame1=ref1,
                tile=self.tile,
                **self.gm_stack_kwargs(ref, ref1, mi_row, mi_col,
                                       w4, h4))
            stack = stack_res.stack
            idx = self._effective_drl_idx(mode, stack,
                                          decision.ref_mv_idx)
            nearest = (lower(stack[0][0]), lower(stack[0][1]))
            near_idx = min(idx + 1, len(stack) - 1)
            near = (lower(stack[near_idx][0]), lower(stack[near_idx][1]))
            mv0, mv1 = tuple(decision.mv), tuple(decision.mv1)
            if mode == mv_pred.NEAREST_NEARESTMV:
                mv0, mv1 = nearest
            elif mode == mv_pred.NEAR_NEARMV:
                mv0, mv1 = near
            elif mode == mv_pred.GLOBAL_GLOBALMV:
                mv0 = self.gm_mv_for(ref, mi_row, mi_col, bw, bh)
                mv1 = self.gm_mv_for(ref1, mi_row, mi_col, bw, bh)
            elif mode == mv_pred.NEW_NEARESTMV:
                mv1 = nearest[1]
            elif mode == mv_pred.NEAREST_NEWMV:
                mv0 = nearest[0]
            elif mode == mv_pred.NEW_NEARMV:
                mv1 = near[1]
            elif mode == mv_pred.NEAR_NEWMV:
                mv0 = near[0]
            if (tuple(mv0), tuple(mv1), idx) != \
                    (tuple(decision.mv), tuple(decision.mv1),
                     decision.ref_mv_idx):
                decision = dataclasses.replace(
                    decision, mv=(int(mv0[0]), int(mv0[1])),
                    mv1=(int(mv1[0]), int(mv1[1])), ref_mv_idx=idx)
            return decision
        stack_res = mv_pred.find_mv_stack(
            self.mi, mi_row, mi_col, w4, h4, ref,
            self.mi_rows, self.mi_cols, sb_mi=self.seq.sb_size // MI,
            sign_bias=self.sign_bias, tile=self.tile,
            **self.gm_stack_kwargs(ref, 0, mi_row, mi_col, w4, h4))
        stack = stack_res.stack
        idx = self._effective_drl_idx(mode, stack, decision.ref_mv_idx)
        if mode == mv_pred.NEWMV:
            mv = tuple(decision.mv)
        elif mode == mv_pred.NEARESTMV:
            mv = tuple(stack_res.ref_mv_list[0])
        elif mode == mv_pred.NEARMV:
            mv = tuple(stack_res.ref_mv_list[1])
            if idx > 0:
                mv = tuple(stack[1 + idx][0])
        else:                             # GLOBALMV
            mv = tuple(self.gm_mv_for(ref, mi_row, mi_col, bw, bh))
        if (mv, idx) != (tuple(decision.mv), decision.ref_mv_idx):
            decision = dataclasses.replace(
                decision, mv=(int(mv[0]), int(mv[1])), ref_mv_idx=idx)
        return decision

    def _code_drl(self, mode, stack, ref_mv_idx):
        io = self.io
        out_idx = 0
        if mode in (mv_pred.NEWMV, mv_pred.NEW_NEWMV):
            for idx in range(2):
                if len(stack) > idx + 1:
                    ctx = mv_pred.drl_ctx(stack, idx)
                    bit = io.symbol(None if io.is_decoder
                                    else int(ref_mv_idx != idx),
                                    self.fc.drl[ctx], 2)
                    out_idx = idx
                    if not bit:
                        return out_idx
                    out_idx = idx + 1
        elif mode in (mv_pred.NEARMV, mv_pred.NEAR_NEARMV,
                      mv_pred.NEAR_NEWMV, mv_pred.NEW_NEARMV):
            for idx in range(1, 3):
                if len(stack) > idx + 1:
                    ctx = mv_pred.drl_ctx(stack, idx)
                    bit = io.symbol(None if io.is_decoder
                                    else int(ref_mv_idx > idx - 1),
                                    self.fc.drl[ctx], 2)
                    out_idx = idx + bit - 1
                    if not bit:
                        return out_idx
        return out_idx

    def search_refs(self):
        """Named refs worth searching: one per distinct reference picture
        (slot aliases collapse), preferring the canonical short names."""
        seen = {}
        for name in (1, 5, 7, 4, 2, 3, 6):     # LAST,BWD,ALT,GLD,L2,L3,A2
            if name not in self.refs:
                continue
            key = id(self.refs[name])
            if key not in seen:
                seen[key] = name
        return list(seen.values())

    def mv_window_in_frame(self, mv, x, y, bw, bh) -> bool:
        """True when the MC read windows (luma + chroma, incl. 8-tap
        margins) stay inside the PADDED reference extent.

        References are stored with REF_PAD of edge replication around
        the visible frame, which reproduces the spec's clamped MC reads
        (7.11.3.3 clips every sample coordinate to the frame: infinite
        edge extension) exactly for any window inside the pad.  MVs may
        therefore point outside the visible frame up to the pad reach —
        the reference encoder likewise allows out-of-frame MVs against
        its padded references (EbPictureBufferDesc origin padding).
        Blocking at the visible edge (the old behavior) forced every
        boundary block onto zero-ish MVs or intra, which measurably
        wrecked edge prediction on moving content."""
        B = REF_PAD - 8                 # keep the window inside the pad
        for plane in (0, 1):
            sh = 1 if plane else 0
            px, py = x >> sh, y >> sh
            pw, ph = bw >> sh, bh >> sh
            vw = self.fh.frame_width >> sh
            vh = self.fh.frame_height >> sh
            bb = B >> sh
            pos_x = (px << 4) + (mv[1] << (1 - sh))
            pos_y = (py << 4) + (mv[0] << (1 - sh))
            ix, iy = pos_x >> 4, pos_y >> 4
            sub_x, sub_y = pos_x & 15, pos_y & 15
            mx0 = 3 if sub_x else 0
            mx1 = 4 if sub_x else 0
            my0 = 3 if sub_y else 0
            my1 = 4 if sub_y else 0
            if ix - mx0 < -bb or iy - my0 < -bb:
                return False
            if ix + pw + mx1 > vw + bb or iy + ph + my1 > vh + bb:
                return False
        return True

    def _mc_pos(self, ref, plane, mv, px, py, pw, ph):
        sh = 1 if plane else 0
        pos_x = (px << 4) + (mv[1] << (1 - sh))
        pos_y = (py << 4) + (mv[0] << (1 - sh))
        int_x = (pos_x >> 4) + REF_PAD
        int_y = (pos_y >> 4) + REF_PAD
        int_x = int(np.clip(int_x, 4, ref.shape[1] - pw - 8))
        int_y = int(np.clip(int_y, 4, ref.shape[0] - ph - 8))
        return int_x, int_y, pos_x & 15, pos_y & 15

    def gm_entry(self, ref_name: int):
        """(wmtype, mat) of the global model for a named ref (LAST..
        ALTREF); (0, None) when identity."""
        gm = getattr(self.fh, "global_motion", ())
        if not gm or not (1 <= ref_name <= len(gm)):
            return 0, None
        t, mat = gm[ref_name - 1]
        return (t, mat) if t else (0, None)

    def gm_mv_for(self, ref_name, mi_row, mi_col, bw, bh):
        """GLOBALMV motion vector for a block (gm_get_motion_vector)."""
        t, mat = self.gm_entry(ref_name)
        if not t:
            return (0, 0)
        from ..ops import warp as warp_ops
        return warp_ops.gm_get_motion_vector(t, mat, bw, bh, mi_col, mi_row)

    def gm_stack_kwargs(self, ref, ref1, mi_row, mi_col, w4, h4):
        """find_mv_stack keyword args carrying the block's global mvs
        (GlobalMvs, spec 7.10.2.2) and which refs use a warp model."""
        gmv = self.gm_mv_for(ref, mi_row, mi_col, w4 * 4, h4 * 4)
        gmv1 = self.gm_mv_for(ref1, mi_row, mi_col, w4 * 4, h4 * 4) \
            if ref1 else (0, 0)
        t0, _ = self.gm_entry(ref)
        t1 = self.gm_entry(ref1)[0] if ref1 else 0
        return dict(gm_mv=gmv, gm_mv1=gmv1, gm_warp=(t0 > 1, t1 > 1))

    def _warp_eligible(self, decision, mi_row, mi_col, w4, h4, bw, bh):
        """is_motion_mode_allowed up to the sample scan
        (EbDecParseInterBlock.c:1787): single-ref non-global-warp inter
        block >= 8x8 with an overlappable neighbour."""
        if not decision.is_inter or decision.ref1 > 0:
            return False
        if min(bw, bh) < 8:
            return False
        t, _ = self.gm_entry(decision.ref)
        if decision.inter_mode in (mv_pred.GLOBALMV,
                                   mv_pred.GLOBAL_GLOBALMV) and t > 1:
            return False
        return mv_pred.has_overlappable_cand(self.mi, mi_row, mi_col,
                                             w4, h4, self.tile)

    def _warp_samples(self, decision, mi_row, mi_col, w4, h4):
        return mv_pred.find_warp_samples(
            self.mi, mi_row, mi_col, w4, h4, decision.ref, self.tile,
            self.seq.sb_size // MI)

    def local_warp_mat(self, decision, mi_row, mi_col, w4, h4, bw, bh):
        """WARPED_CAUSAL params from the neighbour samples (pure
        function of the mi grid; EbDecProcessBlock.c:217)."""
        from ..ops import warp as warp_ops
        n, pts, ptsr = self._warp_samples(decision, mi_row, mi_col, w4, h4)
        if n == 0:
            return None
        mv = decision.mv
        if n > 1:
            n = warp_ops.select_samples((mv[0], mv[1]), pts, ptsr, n,
                                        bw, bh)
        return warp_ops.find_projection(n, pts, ptsr, bw, bh,
                                        mv[0], mv[1], mi_row, mi_col)

    # OBMC (motion_mode == OBMC_CAUSAL): overlapped blending of the
    # above/left neighbours' motion over the block's border strips
    # (dec_build_obmc_inter_predictors_sb, EbDecObmc.c:518)
    _MAX_NEIGHBOR_OBMC = (0, 1, 2, 3, 4, 4)

    def _obmc_segments(self, mi_row, mi_col, w4, h4):
        """(above_segs, left_segs): (pos, seg_len, mv, ref) per
        overlappable neighbour, with the 4xN pairing rule."""
        g = self.mi
        t_r0, t_c0, t_r1, t_c1 = self.tile
        above = []
        if mi_row > t_r0:
            nb_max = self._MAX_NEIGHBOR_OBMC[min(w4.bit_length() - 1, 5)]
            end = min(mi_col + w4, self.mi_cols, t_c1)
            c = mi_col
            while c < end and len(above) < nb_max:
                step = min(int(g.bw4[mi_row - 1, c]), 16)
                cc = c
                if step == 1:
                    cc = min(c | 1, self.mi_cols - 1)
                    step = 2
                if int(g.ref_frame[mi_row - 1, cc]) > 0:
                    above.append((c, min(w4, step),
                                  (int(g.mv_row[mi_row - 1, cc]),
                                   int(g.mv_col[mi_row - 1, cc])),
                                  int(g.ref_frame[mi_row - 1, cc])))
                c += step
        left = []
        if mi_col > t_c0:
            nb_max = self._MAX_NEIGHBOR_OBMC[min(h4.bit_length() - 1, 5)]
            end = min(mi_row + h4, self.mi_rows, t_r1)
            r = mi_row
            while r < end and len(left) < nb_max:
                step = min(int(g.bh4[r, mi_col - 1]), 16)
                rr = r
                if step == 1:
                    rr = min(r | 1, self.mi_rows - 1)
                    step = 2
                if int(g.ref_frame[rr, mi_col - 1]) > 0:
                    left.append((r, min(h4, step),
                                 (int(g.mv_row[rr, mi_col - 1]),
                                  int(g.mv_col[rr, mi_col - 1])),
                                 int(g.ref_frame[rr, mi_col - 1])))
                r += step
        return above, left

    @staticmethod
    def _skip_u4x4_obmc(bw, bh, direction, sub):
        """svt_av1_skip_u4x4_pred_in_obmc: sub-8 plane blocks blend one
        side only (above skipped)."""
        pw, ph = max(bw >> sub, 4), max(bh >> sub, 4)
        if (pw, ph) in ((4, 4), (8, 4), (4, 8)):
            return direction == 0
        return False

    def _obmc_pred(self, plane, pred, px, py, pw, ph, mi_row, mi_col,
                   bw, bh):
        pred = pred.copy()
        sub = 1 if plane else 0
        above, left = self._obmc_segments(mi_row, mi_col, bw // MI,
                                          bh // MI)
        overlap_y = min(bh, 64) >> 1
        if not self._skip_u4x4_obmc(bw, bh, 0, sub):
            oh = overlap_y >> sub
            mask = table(f"obmc_mask_{oh}").astype(np.int32)[:, None]
            for (c, seg, mv, ref) in above:
                sx = ((c - mi_col) * MI) >> sub
                sw = (seg * MI) >> sub
                nb = self.predict_inter(plane, mv, px + sx, py, sw, oh,
                                        ref)
                cur = pred[0:oh, sx:sx + sw]
                pred[0:oh, sx:sx + sw] =                     (mask * cur + (64 - mask) * nb + 32) >> 6
        overlap_x = min(bw, 64) >> 1
        if not self._skip_u4x4_obmc(bw, bh, 1, sub):
            ow = overlap_x >> sub
            mask = table(f"obmc_mask_{ow}").astype(np.int32)[None, :]
            for (r, seg, mv, ref) in left:
                sy = ((r - mi_row) * MI) >> sub
                sh2 = (seg * MI) >> sub
                nb = self.predict_inter(plane, mv, px, py + sy, ow, sh2,
                                        ref)
                cur = pred[sy:sy + sh2, 0:ow]
                pred[sy:sy + sh2, 0:ow] =                     (mask * cur + (64 - mask) * nb + 32) >> 6
        return pred

    def _code_motion_mode(self, decision, mi_row, mi_col, w4, h4, bw, bh):
        """read_motion_mode (EbDecParseInterBlock.c:1815).  Returns the
        coded mode; the encoder passes its desired mode via
        decision.motion_mode (already validated)."""
        io = self.io
        if not self.fh.is_motion_mode_switchable:
            return 0
        if not self._warp_eligible(decision, mi_row, mi_col, w4, h4,
                                   bw, bh):
            return 0
        n, _, _ = self._warp_samples(decision, mi_row, mi_col, w4, h4)
        bs = _bsize_enum(bw, bh)
        if n >= 1 and self.fh.allow_warped_motion:
            return io.symbol(
                None if io.is_decoder else decision.motion_mode,
                self.fc.motion_mode[bs], 3)
        return io.symbol(
            None if io.is_decoder else min(decision.motion_mode, 1),
            self.fc.obmc[bs], 2)

    def _is_warp_global(self, decision, plane_bw, plane_bh, plane):
        """do_warp (EbDecInterPrediction.c:903): GLOBALMV family with a
        >TRANSLATION model, PLANE block dims >= 8 (so the chroma of an
        8x8 luma block falls back to translation MC)."""
        if decision.inter_mode not in (mv_pred.GLOBALMV,
                                       mv_pred.GLOBAL_GLOBALMV):
            return False
        if min(plane_bw, plane_bh) < 8:
            return False
        t, _ = self.gm_entry(decision.ref)
        return t > 1

    def predict_warp(self, plane, ref_name, px, py, pw, ph):
        """Global-warp MC of one plane block (svt_warp_plane)."""
        from ..ops import warp as warp_ops
        _, mat = self.gm_entry(ref_name)
        sh = 1 if plane else 0
        vis_w = (self.fh.frame_width + sh) >> sh
        vis_h = (self.fh.frame_height + sh) >> sh
        ref = self.refs[ref_name][plane][REF_PAD:REF_PAD + vis_h,
                                         REF_PAD:REF_PAD + vis_w]
        out = warp_ops.warp_plane(mat, ref, px, py, pw, ph, sh, sh,
                                  bd=self.seq.bit_depth)
        assert out is not None, "unwarpable gm model signaled"
        return out

    def predict_inter(self, plane, mv, px, py, pw, ph, ref_name=1):
        """Motion-compensated prediction from a named reference."""
        ref = self.refs[ref_name][plane]
        int_x, int_y, sub_x, sub_y = self._mc_pos(ref, plane, mv, px, py,
                                                  pw, ph)
        flt = self.fh.interpolation_filter
        return np.asarray(inter_ops.convolve_2d_sr(
            ref, int_x, int_y, pw, ph, sub_x, sub_y,
            filter_x=flt, filter_y=flt, bd=self.seq.bit_depth))

    def predict_compound(self, plane, mv0, mv1, px, py, pw, ph,
                         ref0_name, ref1_name):
        """COMPOUND_AVERAGE prediction (jnt convolve, no dist weights)."""
        bufs = []
        flt = self.fh.interpolation_filter
        for mv, name in ((mv0, ref0_name), (mv1, ref1_name)):
            ref = self.refs[name][plane]
            int_x, int_y, sub_x, sub_y = self._mc_pos(ref, plane, mv,
                                                      px, py, pw, ph)
            bufs.append(np.asarray(inter_ops.jnt_convolve(
                ref, int_x, int_y, pw, ph, sub_x, sub_y,
                filter_x=flt, filter_y=flt, bd=self.seq.bit_depth)))
        return np.asarray(inter_ops.jnt_average(
            bufs[0], bufs[1], self.seq.bit_depth))

    def predict_masked_compound(self, plane, decision, px, py, pw, ph):
        """COMPOUND_WEDGE / COMPOUND_DIFFWTD: CONV-domain pair blended
        through the soft mask (build_masked_compound_no_round +
        blend_a64_d16_mask, EbInterPrediction.c:1936).  The diffwtd
        mask derives from the LUMA pair and is cached for chroma."""
        from ..ops import masks as mk

        flt = self.fh.interpolation_filter
        bufs = []
        for mv, name in ((decision.mv, decision.ref),
                         (decision.mv1, decision.ref1)):
            ref = self.refs[name][plane]
            int_x, int_y, sub_x, sub_y = self._mc_pos(ref, plane, mv,
                                                      px, py, pw, ph)
            bufs.append(np.asarray(inter_ops.jnt_convolve(
                ref, int_x, int_y, pw, ph, sub_x, sub_y,
                filter_x=flt, filter_y=flt, bd=self.seq.bit_depth)))
        sub = 1 if plane else 0
        if decision.compound_type == 1:          # WEDGE
            mask = mk.wedge_mask(pw << sub, ph << sub,
                                 decision.wedge_index,
                                 decision.wedge_sign)
        else:                                    # DIFFWTD
            if plane == 0:
                mask = mk.diffwtd_mask_d16(bufs[0], bufs[1],
                                           decision.mask_type,
                                           self.seq.bit_depth)
                self._seg_mask = mask
            else:
                mask = self._seg_mask
        return mk.blend_a64_d16(bufs[0], bufs[1], mask, sub, sub,
                                self.seq.bit_depth)

    def predict_interintra(self, plane, decision, px, py, pw, ph):
        """Inter-intra: single-ref MC blended with an intra prediction;
        the mask weights the INTRA side (combine_interintra,
        EbInterPrediction.c:2154; wedge sign is always 0)."""
        from ..ops import masks as mk

        if self._is_warp_global(decision, pw, ph, plane):
            # do_warp applies to the inter side of GLOBALMV interintra
            # blocks too (EbDecInterPrediction.c:904)
            inter = self.predict_warp(plane, decision.ref, px, py, pw, ph)
        else:
            inter = self.predict_inter(plane, decision.mv, px, py, pw,
                                       ph, decision.ref)
        ii_to_intra = (PredictionMode.DC_PRED, PredictionMode.V_PRED,
                       PredictionMode.H_PRED, PredictionMode.SMOOTH_PRED)
        intra = self.predict(plane, ii_to_intra[decision.interintra_mode],
                             0, px, py, pw, ph, max_txsize_rect(pw, ph))
        sub = 1 if plane else 0
        if decision.wedge_interintra:
            mask = mk.wedge_mask(pw << sub, ph << sub,
                                 decision.interintra_wedge_index, 0)
            return mk.blend_a64_pixels(intra, inter, mask, sub, sub)
        mask = mk.smooth_interintra_mask(pw, ph, decision.interintra_mode)
        return mk.blend_a64_pixels(intra, inter, mask, 0, 0)

    def predict_inter_block(self, plane, decision, px, py, pw, ph):
        if decision.ref1 > 0:
            if getattr(decision, "compound_type", 0):
                return self.predict_masked_compound(plane, decision, px,
                                                    py, pw, ph)
            return self.predict_compound(plane, decision.mv, decision.mv1,
                                         px, py, pw, ph, decision.ref,
                                         decision.ref1)
        if getattr(decision, "interintra", False):
            return self.predict_interintra(plane, decision, px, py,
                                           pw, ph)
        if decision.motion_mode == 1:
            base = self.predict_inter(plane, decision.mv, px, py, pw, ph,
                                      decision.ref)
            sh = 1 if plane else 0
            return self._obmc_pred(plane, base, px, py, pw, ph,
                                   (py << sh) // MI, (px << sh) // MI,
                                   pw << sh, ph << sh)
        if decision.motion_mode == 2 and min(pw, ph) >= 8:
            from ..ops import warp as warp_ops
            sh = 1 if plane else 0
            vis_w = (self.fh.frame_width + sh) >> sh
            vis_h = (self.fh.frame_height + sh) >> sh
            ref = self.refs[decision.ref][plane][
                REF_PAD:REF_PAD + vis_h, REF_PAD:REF_PAD + vis_w]
            out = warp_ops.warp_plane(self._cur_warp_mat, ref, px, py,
                                      pw, ph, sh, sh,
                                      bd=self.seq.bit_depth)
            assert out is not None
            return out
        if self._is_warp_global(decision, pw, ph, plane):
            return self.predict_warp(plane, decision.ref, px, py, pw, ph)
        return self.predict_inter(plane, decision.mv, px, py, pw, ph,
                                  decision.ref)

    def _compute_block_inter(self, decision, x, y, bw, bh):
        """Predict (MC or intra) / transform / quantize / recon per plane."""
        out = []
        for plane in range(self.num_planes):
            sx = 1 if plane else 0
            px, py = x >> sx, y >> sx
            pw, ph = bw >> sx, bh >> sx
            ts = self.tx_size_for(plane, bw, bh)
            if decision.is_inter:
                tt = TxType.DCT_DCT
                pred = self.predict_inter_block(plane, decision, px, py,
                                                pw, ph)
                if (plane == 0 and self.fh.tx_mode_select
                        and self.fh.base_q_idx > 0):
                    out += self._luma_vartx_txbs(decision, pred, px, py,
                                                 pw, ph, bw, bh)
                    continue
            else:
                tt = self.tx_type_for(plane, decision, ts)
                if plane == 0:
                    pred = self.predict(plane, decision.y_mode,
                                        decision.angle_delta_y,
                                        px, py, pw, ph, ts,
                                        decision.filter_intra_mode)
                else:
                    pred = self.predict_chroma(plane, decision,
                                               px, py, pw, ph, ts)
            src = self.source[plane][py:py + ph, px:px + pw]
            rdoq_ctx = None
            if self.rdoq_level:
                sk_ctx, dc_ctx = self._txb_ctx(
                    plane, px, py, pw, ph, ts,
                    pw == TX_WIDTH[ts] and ph == TX_HEIGHT[ts])
                rdoq_ctx = (sk_ctx, dc_ctx, decision.is_inter)
            qc, eob, recon = self._tx_quant_recon(plane, src, pred, ts, tt,
                                                  rdoq_ctx=rdoq_ctx)
            ch = min(TX_HEIGHT[ts], 32)
            cw = min(TX_WIDTH[ts], 32)
            self.recon[plane][py:py + ph, px:px + pw] = recon
            self._record_tx_geometry(plane, px, py, pw, ph, ts)
            out.append(dict(plane=plane, tx_size=ts, tx_type=tt,
                            qcoeff=qc[:ch, :cw], eob=eob, pred=pred,
                            px=px, py=py, pw=pw, ph=ph))
        return out

    def _luma_vartx_txbs(self, decision, pred, px, py, pw, ph, bw, bh):
        """Var-tx luma TUs for one inter block: uniform split depth 0 vs
        1 chosen by true SSE + a coefficient-rate proxy (the encoder's
        envelope of write_tx_size_vartx — depth <= 1 keeps the TU order
        raster).  Sets ``decision.tx_depth`` and writes the winning
        recon/geometry."""
        from .rdo import rd_lambda
        lam = rd_lambda(self.fh.base_q_idx, self.seq.bit_depth)
        max_ts = max_txsize_rect(bw, bh)
        depths = (0,) if max_ts == TxSize.TX_4X4 else (0, 1)
        forced = getattr(self, "force_tx_depth", None)
        if forced is not None:
            depths = (min(int(forced), len(depths) - 1),)
        best = None
        for d in depths:
            ts = depth_to_tx_size(d, bw, bh)
            tw, th = TX_WIDTH[ts], TX_HEIGHT[ts]
            txbs = []
            sse = 0.0
            bits = 1.0 + (4.0 if d else 0.0)     # txfm_partition flags
            for ty in range(py, py + ph, th):
                for tx_ in range(px, px + pw, tw):
                    sblk = self.source[0][ty:ty + th, tx_:tx_ + tw]
                    pblk = pred[ty - py:ty - py + th,
                                tx_ - px:tx_ - px + tw]
                    beq = pw == tw and ph == th
                    rdoq_ctx = None
                    if self.rdoq_level:
                        sk_ctx, dc_ctx = self._txb_ctx(
                            0, tx_, ty, tw, th, ts, beq)
                        rdoq_ctx = (sk_ctx, dc_ctx, True)
                    qc, eob, recon = self._tx_quant_recon(
                        0, sblk, pblk, ts, TxType.DCT_DCT,
                        rdoq_ctx=rdoq_ctx)
                    sse += float(((sblk.astype(np.int64) - recon) ** 2)
                                 .sum())
                    nnz = int((qc != 0).sum())
                    bits += (1.2 * nnz + 2.0
                             + float(np.log2(1.0 + np.abs(qc)).sum()))
                    ch, cw = min(th, 32), min(tw, 32)
                    txbs.append(dict(
                        plane=0, tx_size=ts, tx_type=TxType.DCT_DCT,
                        qcoeff=qc[:ch, :cw], eob=eob, pred=pblk,
                        px=tx_, py=ty, pw=tw, ph=th, beq=beq,
                        recon=recon))
            cost = sse + lam * bits
            if best is None or cost < best[0]:
                best = (cost, d, txbs)
        decision.tx_depth = best[1]
        for t in best[2]:
            self.recon[0][t["py"]:t["py"] + t["ph"],
                          t["px"]:t["px"] + t["pw"]] = t.pop("recon")
        # tx geometry (DLF edge grid) is recorded at residual-write
        # time: a block whose TUs all quantize to zero codes SKIP, and
        # skip blocks take the implicit max tx size, not the TU grid
        return best[2]

    # -- var-tx (TX_MODE_SELECT on inter frames) ----------------------------

    _SQR_TX = {4: TxSize.TX_4X4, 8: TxSize.TX_8X8, 16: TxSize.TX_16X16,
               32: TxSize.TX_32X32, 64: TxSize.TX_64X64,
               128: TxSize.TX_64X64}

    def _txfm_split_ctx(self, ts, mi_row, mi_col, bw, bh) -> int:
        """txfm_partition_context (EbEntropyCoding.c:4986 /
        get_txfm_split_ctx, EbDecParseBlock.c:1362)."""
        above = int(int(self.txfm_above[mi_col]) < TX_WIDTH[ts])
        left = int(int(self.txfm_left[mi_row]) < TX_HEIGHT[ts])
        max_ts = self._SQR_TX[min(64, max(bw, bh))]
        sqr_up = self._SQR_TX[min(64, max(TX_WIDTH[ts], TX_HEIGHT[ts]))]
        return (int(sqr_up != max_ts) * 3 + (4 - int(max_ts)) * 6
                + above + left)

    def _vartx_tree(self, ts, depth, mi_row, mi_col, bw, bh, enc_depth,
                    leaves) -> None:
        """write_tx_size_vartx / read_var_tx_size: the recursive
        txfm_split tree of one max-tx unit.  The encoder codes a UNIFORM
        ``enc_depth`` (split every node above it); the parser accepts
        any legal tree.  Leaves append as (tx_size, mi_row, mi_col) in
        recursion order — the residual TU order."""
        io = self.io
        if mi_row >= self.mi_rows or mi_col >= self.mi_cols:
            return
        if ts == TxSize.TX_4X4 or depth == 2:       # MAX_VARTX_DEPTH
            split = 0
        else:
            ctx = self._txfm_split_ctx(ts, mi_row, mi_col, bw, bh)
            split = io.symbol(
                None if io.is_decoder else int(depth < enc_depth),
                self.fc.txfm_partition[ctx], 2)
        if split:
            sub = SUB_TX_SIZE[ts]
            sh4 = max(TX_HEIGHT[sub] // MI, 1)
            sw4 = max(TX_WIDTH[sub] // MI, 1)
            for r in range(0, TX_HEIGHT[ts] // MI, sh4):
                for c in range(0, TX_WIDTH[ts] // MI, sw4):
                    self._vartx_tree(sub, depth + 1, mi_row + r,
                                     mi_col + c, bw, bh, enc_depth,
                                     leaves)
            return
        leaves.append((ts, mi_row, mi_col))
        self.txfm_above[mi_col:mi_col + TX_WIDTH[ts] // MI] = TX_WIDTH[ts]
        self.txfm_left[mi_row:mi_row + TX_HEIGHT[ts] // MI] = \
            TX_HEIGHT[ts]

    def _tx_size_ctx_inter(self, mi_row, mi_col, bw, bh) -> int:
        """get_tx_size_context for inter frames: inter neighbors count
        with their BLOCK dims (EbDecParseHelper.c:56)."""
        max_ts = max_txsize_rect(bw, bh)
        up = mi_row > self.tile[0]
        left = mi_col > self.tile[1]
        a = l = 0
        if up:
            if self.mi.ref_frame[mi_row - 1, mi_col] > 0:
                a = int(self.mi.bw4[mi_row - 1, mi_col] * MI
                        >= TX_WIDTH[max_ts])
            else:
                a = int(self.txfm_above[mi_col] >= TX_WIDTH[max_ts])
        if left:
            if self.mi.ref_frame[mi_row, mi_col - 1] > 0:
                l = int(self.mi.bh4[mi_row, mi_col - 1] * MI
                        >= TX_HEIGHT[max_ts])
            else:
                l = int(self.txfm_left[mi_row] >= TX_HEIGHT[max_ts])
        if up and left:
            return a + l
        return a if up else (l if left else 0)

    def _code_block_tx_size(self, decision, skip, is_inter, mi_row,
                            mi_col, bw, bh):
        """read_block_tx_size analog (EbDecParseBlock.c:1540): var-tx
        split tree for coded inter blocks under TX_MODE_SELECT, tx_size
        depth symbol for intra blocks, txfm context updates for all.
        Returns the luma TU leaf list for var-tx blocks, else None."""
        io = self.io
        fh = self.fh
        w4, h4 = bw // MI, bh // MI
        if not fh.tx_mode_select or fh.base_q_idx == 0:
            return None
        if is_inter and not skip:
            max_ts = max_txsize_rect(bw, bh)
            enc_depth = None if io.is_decoder \
                else getattr(decision, "tx_depth", 0)
            leaves = []
            # one max-tx unit covers every block <= 64px
            self._vartx_tree(max_ts, 0, mi_row, mi_col, bw, bh,
                             enc_depth, leaves)
            return leaves
        if not is_inter:
            if not (bw == 4 and bh == 4):
                mdep = bsize_max_tx_depth(bw, bh)
                ctx = self._tx_size_ctx_inter(mi_row, mi_col, bw, bh)
                depth = io.symbol(
                    None if io.is_decoder
                    else getattr(decision, "tx_depth", 0),
                    self.fc.tx_size[bsize_tx_size_cat(bw, bh)][ctx],
                    mdep + 1)
                if io.is_decoder:
                    decision.tx_depth = depth
            ts = self.luma_tx_size(decision, bw, bh)
            txw, txh = TX_WIDTH[ts], TX_HEIGHT[ts]
        else:
            # skipped inter: implicit largest tx; ctx takes BLOCK dims
            txw, txh = min(bw, 64), min(bh, 64)
        self.txfm_above[mi_col:mi_col + w4] = min(txw, 64)
        self.txfm_left[mi_row:mi_row + h4] = min(txh, 64)
        return None

    def _block_inter(self, bw: int, bh: int, mi_row: int, mi_col: int):
        io = self.io
        x, y = mi_col * MI, mi_row * MI
        w4, h4 = bw // MI, bh // MI
        up_avail = mi_row > self.tile[0]
        left_avail = mi_col > self.tile[1]

        decision = None
        txbs = None
        self._cur_warp_mat = None
        if not io.is_decoder and self.txb_replay is not None \
                and (mi_row, mi_col, bw, bh) in self.txb_replay:
            decision, txbs = self.txb_replay[(mi_row, mi_col, bw, bh)]
            vartx_luma = (decision.is_inter and self.fh.tx_mode_select
                          and self.fh.base_q_idx > 0)
            for t in txbs:          # DLF geometry (compute is skipped;
                if vartx_luma and t["plane"] == 0:
                    continue        # vartx TUs record at residual-write)
                self._record_tx_geometry(t["plane"], t["px"], t["py"],
                                         t["pw"], t["ph"], t["tx_size"])
            skip = all(t["eob"] == 0 for t in txbs)
        elif not io.is_decoder:
            decision = self.decider.decide_inter(self, x, y, bw, bh,
                                                 mi_row, mi_col, w4, h4)
            if decision.is_inter:
                decision = self._revalidate_inter_mvs(
                    decision, mi_row, mi_col, w4, h4, bw, bh)
            if not decision.is_inter:
                # intra sub-tx inside inter frames is not wired into the
                # inter residual path: code depth 0 (legal; the intra tx
                # search stays a key-frame tool)
                decision.tx_depth = 0
            if decision.motion_mode == 2:
                # re-validate against the mi state of THIS coding pass
                # (the decide cache may span partition-trial contexts)
                mat = None
                if self.fh.is_motion_mode_switchable                         and self.fh.allow_warped_motion                         and self._warp_eligible(decision, mi_row, mi_col,
                                                w4, h4, bw, bh):
                    mat = self.local_warp_mat(decision, mi_row, mi_col,
                                              w4, h4, bw, bh)
                if mat is None:
                    decision = dataclasses.replace(decision, motion_mode=0)
                else:
                    self._cur_warp_mat = mat
            txbs = self._compute_block_inter(decision, x, y, bw, bh)
            skip = all(t["eob"] == 0 for t in txbs)
        else:
            skip = None

        if not io.is_decoder and self.txb_cache is not None:
            self.txb_cache[(mi_row, mi_col, bw, bh)] = (decision, txbs)

        skip_ctx = 0
        if up_avail:
            skip_ctx += int(self.skips[mi_row - 1, mi_col])
        if left_avail:
            skip_ctx += int(self.skips[mi_row, mi_col - 1])
        skip = io.symbol(None if skip is None else int(skip),
                         self.fc.skip[skip_ctx], 2)

        self._code_cdef_idx(skip, mi_row, mi_col, w4, h4)

        ii_ctx = self._intra_inter_ctx(mi_row, mi_col)
        is_inter = io.symbol(None if decision is None
                             else int(decision.is_inter),
                             self.fc.intra_inter[ii_ctx], 2)

        if is_inter:
            comp = 0
            if self.fh.reference_select and min(bw, bh) >= 8:
                rm_ctx = self._reference_mode_ctx(mi_row, mi_col)
                comp = io.symbol(
                    None if decision is None else int(decision.ref1 > 0),
                    self.fc.comp_inter[rm_ctx], 2)
            if comp:
                ref, ref1 = self._code_comp_ref_frames(
                    mi_row, mi_col,
                    None if decision is None
                    else (decision.ref, decision.ref1))
                decision2 = self._code_compound_mode(
                    decision, ref, ref1, mi_row, mi_col, w4, h4)
                if io.is_decoder:
                    decision = decision2
            else:
                ref = self._code_ref_frames(
                    mi_row, mi_col,
                    None if decision is None else decision.ref)
                stack_res = mv_pred.find_mv_stack(
                    self.mi, mi_row, mi_col, w4, h4, ref,
                    self.mi_rows, self.mi_cols,
                    sb_mi=self.seq.sb_size // MI, sign_bias=self.sign_bias,
                    tile=self.tile,
                    **self.gm_stack_kwargs(ref, 0, mi_row, mi_col, w4, h4))
                mode = self._code_inter_mode(
                    stack_res.mode_context,
                    None if decision is None else decision.inter_mode)
                ref_mv_idx = self._code_drl(
                    mode, stack_res.stack,
                    0 if decision is None else decision.ref_mv_idx)
                nearestmv = stack_res.ref_mv_list[0]
                nearmv = stack_res.ref_mv_list[1]
                if ref_mv_idx > 0 and mode == mv_pred.NEARMV:
                    nearmv = stack_res.stack[1 + ref_mv_idx][0]
                if mode == mv_pred.NEWMV:
                    ref_mv = nearestmv
                    if len(stack_res.stack) > 1:
                        ref_mv = stack_res.stack[ref_mv_idx][0]
                    if io.is_decoder:
                        mv = decode_mv(io.ec, ref_mv[0], ref_mv[1],
                                       self.fc.nmv, MV_SUBPEL_LOW_PRECISION)
                    else:
                        mv = decision.mv
                        encode_mv(io.ec, mv[0], mv[1], ref_mv[0], ref_mv[1],
                                  self.fc.nmv, MV_SUBPEL_LOW_PRECISION)
                elif mode == mv_pred.NEARESTMV:
                    mv = nearestmv
                elif mode == mv_pred.NEARMV:
                    mv = nearmv
                else:                    # GLOBALMV
                    mv = self.gm_mv_for(ref, mi_row, mi_col, bw, bh)
                if io.is_decoder:
                    decision = BlockDecision(is_inter=True, inter_mode=mode,
                                             mv=(int(mv[0]), int(mv[1])),
                                             ref_mv_idx=ref_mv_idx, ref=ref)
        else:
            decision2 = self._code_intra_in_inter(decision, bw, bh)
            if io.is_decoder:
                decision = decision2

        # inter-intra (read_interintra_mode; rf[1] = INTRA_FRAME):
        # single-ref blocks 8x8..32x32, before motion_mode
        interintra = False
        if is_inter and not comp and self.seq.enable_interintra_compound \
                and (8 <= bw <= 32 and 8 <= bh <= 32
                     and (bw, bh) not in ((8, 32), (32, 8))):
            from ..ops import masks as mk
            grp = _SIZE_GROUP_BY_ENUM[_bsize_enum(bw, bh)]
            interintra = bool(io.symbol(
                None if decision is None else int(decision.interintra),
                self.fc.interintra[grp], 2))
            ii_mode = use_w = widx = 0
            if interintra:
                ii_mode = io.symbol(
                    None if decision is None
                    else int(decision.interintra_mode),
                    self.fc.interintra_mode[grp], 4)
                if mk.wedge_used(bw, bh):
                    use_w = io.symbol(
                        None if decision is None
                        else int(decision.wedge_interintra),
                        self.fc.wedge_interintra[_bsize_enum(bw, bh)], 2)
                    if use_w:
                        widx = io.symbol(
                            None if decision is None
                            else int(decision.interintra_wedge_index),
                            self.fc.wedge_idx[_bsize_enum(bw, bh)], 16)
            if io.is_decoder:
                decision.interintra = interintra
                decision.interintra_mode = ii_mode
                decision.wedge_interintra = bool(use_w)
                decision.interintra_wedge_index = widx

        if is_inter:
            if interintra:
                # rf[1] == INTRA_FRAME skips motion_mode (SIMPLE)
                mm = 0
                if io.is_decoder:
                    decision.motion_mode = 0
            else:
                mm = self._code_motion_mode(decision, mi_row, mi_col,
                                            w4, h4, bw, bh)
            if io.is_decoder:
                decision.motion_mode = mm
                if mm == 2:
                    self._cur_warp_mat = self.local_warp_mat(
                        decision, mi_row, mi_col, w4, h4, bw, bh)
                    assert self._cur_warp_mat is not None, \
                        "WARPED_CAUSAL with invalid projection"

        # masked compound (read_compound_type): comp_group_idx then
        # wedge / diffwtd parameters
        if is_inter and comp and self.seq.enable_masked_compound:
            from ..ops import masks as mk
            cg_ctx = self._comp_group_ctx(mi_row, mi_col)
            cgi = io.symbol(
                None if decision is None
                else int(decision.compound_type > 0),
                self.fc.comp_group_idx[cg_ctx], 2)
            ctype = widx = wsign = mtype = 0
            if cgi:
                if mk.wedge_used(bw, bh):
                    ctype = io.symbol(
                        None if decision is None
                        else int(decision.compound_type) - 1,
                        self.fc.compound_type[_bsize_enum(bw, bh)], 2)
                else:
                    ctype = 1                    # DIFFWTD implied
                if ctype == 0:                   # COMPOUND_WEDGE
                    widx = io.symbol(
                        None if decision is None
                        else int(decision.wedge_index),
                        self.fc.wedge_idx[_bsize_enum(bw, bh)], 16)
                    wsign = io.literal(
                        None if decision is None
                        else int(decision.wedge_sign), 1)
                else:                            # COMPOUND_DIFFWTD
                    mtype = io.literal(
                        None if decision is None
                        else int(decision.mask_type), 1)
            # comp_group_idx == 0: enable_jnt_comp is 0 at the sequence
            # level, so compound_idx is implied 1 (simple average)
            if io.is_decoder:
                decision.compound_type = (1 + ctype) if cgi else 0
                decision.wedge_index = widx
                decision.wedge_sign = wsign
                decision.mask_type = mtype

        vartx = self._code_block_tx_size(decision, skip, is_inter,
                                         mi_row, mi_col, bw, bh)
        if io.is_decoder and not is_inter \
                and getattr(decision, "tx_depth", 0):
            raise UnsupportedBitstream("intra sub-tx in inter frame")

        self.y_modes[mi_row:mi_row + h4, mi_col:mi_col + w4] = \
            0 if is_inter else int(decision.y_mode)
        self.skips[mi_row:mi_row + h4, mi_col:mi_col + w4] = int(skip)
        self._record_mi(mi_row, mi_col, w4, h4, decision, int(skip))

        if io.is_decoder:
            self._decode_residual_inter(decision, skip, x, y, bw, bh,
                                        vartx)
        else:
            self._write_residual_inter(decision, txbs, skip, x, y, bw, bh)

    def _code_compound_mode(self, decision, ref, ref1, mi_row, mi_col,
                            w4, h4):
        """Compound mode symbol + DRL + MVs (read path:
        inter_block_mode_info, EbDecParseInterBlock.c:2150+)."""
        io = self.io
        stack_res = mv_pred.find_mv_stack(
            self.mi, mi_row, mi_col, w4, h4, ref,
            self.mi_rows, self.mi_cols, sb_mi=self.seq.sb_size // MI,
            sign_bias=self.sign_bias, ref_frame1=ref1, tile=self.tile,
            **self.gm_stack_kwargs(ref, ref1, mi_row, mi_col, w4, h4))
        ctx = mv_pred.compound_mode_ctx(stack_res.mode_context)
        sym = io.symbol(
            None if decision is None
            else decision.inter_mode - mv_pred.NEAREST_NEARESTMV,
            self.fc.inter_compound_mode[ctx], 8)
        mode = sym + mv_pred.NEAREST_NEARESTMV
        ref_mv_idx = self._code_drl(
            mode, stack_res.stack,
            0 if decision is None else decision.ref_mv_idx)
        stack = stack_res.stack
        lower = lambda mv: mv_pred.lower_mv_precision(
            mv, False, False)
        nearest = (lower(stack[0][0]), lower(stack[0][1]))
        near_idx = min(ref_mv_idx + 1, len(stack) - 1)
        near = (lower(stack[near_idx][0]), lower(stack[near_idx][1]))
        # ref mvs for NEW components (NEAR_NEWMV/NEW_NEARMV shift by 1)
        rmi = ref_mv_idx
        if mode in (mv_pred.NEAR_NEWMV, mv_pred.NEW_NEARMV):
            rmi = 1 + ref_mv_idx
        rmi = min(rmi, len(stack) - 1)
        ref_mv = [nearest[0], nearest[1]]
        if mode in (mv_pred.NEW_NEWMV, mv_pred.NEW_NEARESTMV,
                    mv_pred.NEW_NEARMV):
            ref_mv[0] = stack[rmi][0]
        if mode in (mv_pred.NEW_NEWMV, mv_pred.NEAREST_NEWMV,
                    mv_pred.NEAR_NEWMV):
            ref_mv[1] = stack[rmi][1]

        def code_new(j):
            if io.is_decoder:
                return decode_mv(io.ec, ref_mv[j][0], ref_mv[j][1],
                                 self.fc.nmv, MV_SUBPEL_LOW_PRECISION)
            mv = decision.mv if j == 0 else decision.mv1
            encode_mv(io.ec, mv[0], mv[1], ref_mv[j][0], ref_mv[j][1],
                      self.fc.nmv, MV_SUBPEL_LOW_PRECISION)
            return mv

        if mode == mv_pred.NEAREST_NEARESTMV:
            mv0, mv1 = nearest
        elif mode == mv_pred.NEAR_NEARMV:
            mv0, mv1 = near
        elif mode == mv_pred.GLOBAL_GLOBALMV:
            mv0 = self.gm_mv_for(ref, mi_row, mi_col, w4 * 4, h4 * 4)
            mv1 = self.gm_mv_for(ref1, mi_row, mi_col, w4 * 4, h4 * 4)
        elif mode == mv_pred.NEW_NEWMV:
            mv0 = code_new(0)
            mv1 = code_new(1)
        elif mode == mv_pred.NEW_NEARESTMV:
            mv0 = code_new(0)
            mv1 = nearest[1]
        elif mode == mv_pred.NEAREST_NEWMV:
            mv0 = nearest[0]
            mv1 = code_new(1)
        elif mode == mv_pred.NEW_NEARMV:
            mv0 = code_new(0)
            mv1 = near[1]
        else:                            # NEAR_NEWMV
            mv0 = near[0]
            mv1 = code_new(1)
        # comp_group_idx / compound_idx: seq disables masked + jnt comp,
        # so nothing is coded and prediction is the simple average
        return BlockDecision(is_inter=True, inter_mode=mode,
                             mv=(int(mv0[0]), int(mv0[1])),
                             mv1=(int(mv1[0]), int(mv1[1])),
                             ref_mv_idx=ref_mv_idx, ref=ref, ref1=ref1)

    def _code_intra_in_inter(self, decision, bw, bh):
        """Intra mode syntax inside an inter frame (y_mode_cdf by size
        group instead of the kf neighbor-context cdf)."""
        io = self.io
        grp = _SIZE_GROUP_BY_ENUM[_bsize_enum(bw, bh)]
        y_mode = io.symbol(None if decision is None else int(decision.y_mode),
                           self.fc.y_mode[grp], 13)
        use_delta = _bsize_enum(bw, bh) >= 3
        angle_delta_y = 0
        if use_delta and intra_ops.is_directional(PredictionMode(y_mode)):
            sym = io.symbol(None if decision is None
                            else decision.angle_delta_y + 3,
                            self.fc.angle_delta[y_mode - 1], 7)
            angle_delta_y = sym - 3
        uv_mode = 0
        angle_delta_uv = 0
        if self.num_planes > 1:
            cfl_allowed = bw <= 32 and bh <= 32
            uv_cdf = self.fc.uv_mode[int(cfl_allowed)][y_mode]
            uv_mode = io.symbol(None if decision is None else decision.uv_mode,
                                uv_cdf, 14 if cfl_allowed else 13)
            if uv_mode == 13:
                cfl_signs, cfl_idx = self._code_cfl(decision)
            elif use_delta and intra_ops.is_directional(PredictionMode(uv_mode)):
                sym = io.symbol(None if decision is None
                                else decision.angle_delta_uv + 3,
                                self.fc.angle_delta[uv_mode - 1], 7)
                angle_delta_uv = sym - 3
        fi_mode = -1
        if (self.seq.enable_filter_intra and y_mode == 0
                and bw <= 32 and bh <= 32):
            use_fi = io.symbol(
                None if decision is None
                else int(decision.filter_intra_mode >= 0),
                self.fc.filter_intra[_bsize_enum(bw, bh)], 2)
            if use_fi:
                fi_mode = io.symbol(
                    None if decision is None
                    else decision.filter_intra_mode,
                    self.fc.filter_intra_mode, 5)
        return BlockDecision(y_mode=PredictionMode(y_mode),
                             angle_delta_y=angle_delta_y, uv_mode=uv_mode,
                             angle_delta_uv=angle_delta_uv,
                             cfl_signs=cfl_signs if uv_mode == 13 else 0,
                             cfl_idx=cfl_idx if uv_mode == 13 else 0,
                             filter_intra_mode=fi_mode)

    def _inter_tx_type_io(self, tx_size, tx_type_val):
        """Luma tx-type signaling for inter blocks (inter ext-tx sets)."""
        if self.fh.base_q_idx == 0:
            return TxType.DCT_DCT
        set_type = get_ext_tx_set_type(tx_size, True, self.fh.reduced_tx_set)
        nset = AV1_NUM_EXT_TX_SET[set_type]
        if nset <= 1:
            return TxType.DCT_DCT
        eset = EXT_TX_SET_INDEX[1][set_type]
        sq = cf._sq_idx(min(TX_WIDTH[tx_size], TX_HEIGHT[tx_size]))
        cdf = self.fc.inter_ext_tx[eset][sq]
        if self.io.is_decoder:
            sym = self.io.symbol(None, cdf, nset)
            return TxType(AV1_EXT_TX_INV[set_type][sym])
        self.io.symbol(AV1_EXT_TX_IND[set_type][tx_type_val], cdf, nset)
        return tx_type_val

    def _write_residual_inter(self, decision, txbs, skip, x, y, bw, bh):
        if decision.is_inter and self.fh.tx_mode_select \
                and self.fh.base_q_idx > 0:
            # luma DLF geometry for var-tx blocks: skip codes the
            # implicit max tx size; coded blocks take the TU grid
            if skip:
                self._record_tx_geometry(0, x, y, bw, bh,
                                         self.tx_size_for(0, bw, bh))
            else:
                for t in txbs:
                    if t["plane"] == 0:
                        self._record_tx_geometry(
                            0, t["px"], t["py"], t["pw"], t["ph"],
                            t["tx_size"])
        if skip:
            for t in txbs:
                plane = t["plane"]
                self.recon[plane][t["py"]:t["py"] + t["ph"],
                                  t["px"]:t["px"] + t["pw"]] = t["pred"]
                self._update_txb_ctx(plane, t["px"], t["py"], t["tx_size"], 0)
            return
        for t in txbs:
            plane = t["plane"]
            plane_type = int(plane > 0)
            bsize_eq_tx = t.get("beq", (t["pw"] == TX_WIDTH[t["tx_size"]]
                                        and t["ph"] == TX_HEIGHT[t["tx_size"]]))
            sk_ctx, dc_ctx = self._txb_ctx(plane, t["px"], t["py"], t["pw"],
                                           t["ph"], t["tx_size"], bsize_eq_tx)
            if decision.is_inter:
                ttw = (lambda ts=t["tx_size"], tt=t["tx_type"]:
                       self._inter_tx_type_io(ts, tt)) if plane == 0 else None
            else:
                ttw = (lambda ts=t["tx_size"], tt=t["tx_type"],
                       ym=_ctx_dir(decision):
                       self._tx_type_io(plane, ts, ym, tt)) if plane == 0 else None
            if hasattr(self.io.ec, "write_coeffs_fast"):
                cul = self.io.ec.write_coeffs_fast(
                    self.fc, t["qcoeff"], t["tx_size"], t["tx_type"],
                    plane_type, sk_ctx, dc_ctx, t["eob"], tx_type_writer=ttw)
            else:
                cul = cf.write_coeffs_txb(
                    self.io.ec, self.fc, t["qcoeff"], t["tx_size"],
                    t["tx_type"], plane_type, sk_ctx, dc_ctx, t["eob"],
                    tx_type_writer=ttw)
            self._update_txb_ctx(plane, t["px"], t["py"], t["tx_size"], cul)

    def _decode_vartx_luma(self, decision, leaves, px, py, pw, ph):
        """Parse + recon the luma TUs of a var-tx inter block (leaf
        order from the txfm_split tree)."""
        pred = self.predict_inter_block(0, decision, px, py, pw, ph)
        for ts, lr, lc in leaves:
            tx_, ty = lc * MI, lr * MI
            tw, th = TX_WIDTH[ts], TX_HEIGHT[ts]
            self._record_tx_geometry(0, tx_, ty, tw, th, ts)
            beq = pw == tw and ph == th
            sk_ctx, dc_ctx = self._txb_ctx(0, tx_, ty, tw, th, ts, beq)
            ttr = (lambda ts=ts: self._inter_tx_type_io(ts, None))
            qc, eob, cul, tt = cf.parse_coeffs_txb(
                self.io.ec, self.fc, ts, TxType.DCT_DCT, 0,
                sk_ctx, dc_ctx, tx_type_reader=ttr)
            self._update_txb_ctx(0, tx_, ty, ts, cul)
            pblk = pred[ty - py:ty - py + th, tx_ - px:tx_ - px + tw]
            if eob == 0:
                self.recon[0][ty:ty + th, tx_:tx_ + tw] = pblk
                continue
            full = np.zeros((th, tw), np.int32)
            full[:qc.shape[0], :qc.shape[1]] = qc
            dqc = np.asarray(qz.dequant_block(
                full, self.fh.base_q_idx, self._plane_quant(0), ts))
            self.recon[0][ty:ty + th, tx_:tx_ + tw] = np.asarray(
                tf.inv_txfm2d_add(dqc, pblk, tt, ts, self.seq.bit_depth))

    def _decode_residual_inter(self, decision, skip, x, y, bw, bh,
                               vartx=None):
        for plane in range(self.num_planes):
            sx = 1 if plane else 0
            px, py = x >> sx, y >> sx
            pw, ph = bw >> sx, bh >> sx
            if plane == 0 and vartx is not None and decision.is_inter \
                    and not skip:
                self._decode_vartx_luma(decision, vartx, px, py, pw, ph)
                continue
            ts = self.tx_size_for(plane, bw, bh)
            self._record_tx_geometry(plane, px, py, pw, ph, ts)
            if decision.is_inter:
                pred = self.predict_inter_block(plane, decision, px, py,
                                                pw, ph)
                default_tt = TxType.DCT_DCT
                ttr = (lambda ts=ts: self._inter_tx_type_io(ts, None)) \
                    if plane == 0 else None
            else:
                if plane == 0:
                    pred = self.predict(plane, decision.y_mode,
                                        decision.angle_delta_y,
                                        px, py, pw, ph, ts,
                                        decision.filter_intra_mode)
                else:
                    pred = self.predict_chroma(plane, decision,
                                               px, py, pw, ph, ts)
                default_tt = self.tx_type_for(plane, decision, ts)
                ttr = (lambda ts=ts, ym=_ctx_dir(decision):
                       self._tx_type_io(plane, ts, ym, None)) \
                    if plane == 0 else None
            if skip:
                self.recon[plane][py:py + ph, px:px + pw] = pred
                self._update_txb_ctx(plane, px, py, ts, 0)
                continue
            plane_type = int(plane > 0)
            bsize_eq_tx = (pw == TX_WIDTH[ts] and ph == TX_HEIGHT[ts])
            sk_ctx, dc_ctx = self._txb_ctx(plane, px, py, pw, ph, ts, bsize_eq_tx)
            qc, eob, cul, tt = cf.parse_coeffs_txb(
                self.io.ec, self.fc, ts, default_tt, plane_type,
                sk_ctx, dc_ctx, tx_type_reader=ttr)
            self._update_txb_ctx(plane, px, py, ts, cul)
            if eob == 0:
                self.recon[plane][py:py + ph, px:px + pw] = pred
                continue
            full = np.zeros((TX_HEIGHT[ts], TX_WIDTH[ts]), np.int32)
            full[:qc.shape[0], :qc.shape[1]] = qc
            dqc = np.asarray(qz.dequant_block(full, self.fh.base_q_idx,
                                              self._plane_quant(plane), ts))
            recon = np.asarray(tf.inv_txfm2d_add(dqc, pred, tt, ts,
                                                 self.seq.bit_depth))
            self.recon[plane][py:py + ph, px:px + pw] = recon

    def cropped_recon(self):
        w = getattr(self, "out_w", None) or self.fh.frame_width
        h = self.fh.frame_height
        dt = np.uint8 if self.seq.bit_depth == 8 else np.uint16
        return [self.recon[0][:h, :w].astype(dt),
                self.recon[1][:h >> 1, :w >> 1].astype(dt),
                self.recon[2][:h >> 1, :w >> 1].astype(dt)]


def _ctx_dir(decision) -> int:
    """Intra direction for tx-type cdf context: FI blocks map through
    Filter_Intra_Mode_To_Intra_Dir (spec compute_tx_type)."""
    if decision.filter_intra_mode >= 0:
        return FILTER_INTRA_TO_DIR[decision.filter_intra_mode]
    return int(decision.y_mode)


def _bsize_enum(bw: int, bh: int) -> int:
    """BlockSize enum value from dimensions (square + rect)."""
    table_ = {(4, 4): 0, (4, 8): 1, (8, 4): 2, (8, 8): 3, (8, 16): 4,
              (16, 8): 5, (16, 16): 6, (16, 32): 7, (32, 16): 8,
              (32, 32): 9, (32, 64): 10, (64, 32): 11, (64, 64): 12,
              (64, 128): 13, (128, 64): 14, (128, 128): 15, (4, 16): 16,
              (16, 4): 17, (8, 32): 18, (32, 8): 19, (16, 64): 20,
              (64, 16): 21}
    return table_[(bw, bh)]


# --------------------------------------------------------------------------
# Intra top-right / bottom-left availability (EbIntraPrediction.c:431+)
# --------------------------------------------------------------------------

@functools.cache
def _has_table(kind: str, bw: int, bh: int) -> np.ndarray:
    return table(f"has_{kind}_{bw}x{bh}")


def _has_top_right(sb_size, bw, bh, mi_row, mi_col, top_available,
                   right_available, txsz, row_off, col_off, ss_x, ss_y,
                   part: int = 0) -> bool:
    if not top_available or not right_available:
        return False
    bw_unit = bw >> 2 << (ss_x if False else 0)
    # block dims here are PLANE dims; convert to luma units
    bw_l, bh_l = bw << ss_x, bh << ss_y
    plane_bw_unit = max((bw_l >> 2) >> ss_x, 1)
    tr_count = TX_WIDTH[txsz] >> 2
    if row_off > 0:
        return col_off + tr_count < plane_bw_unit
    if col_off + tr_count < plane_bw_unit:
        return True
    bw_mi_log2 = (bw_l >> 2).bit_length() - 1
    bh_mi_log2 = (bh_l >> 2).bit_length() - 1
    sb_mi = sb_size >> 2
    blk_row_in_sb = (mi_row & (sb_mi - 1)) >> bh_mi_log2
    blk_col_in_sb = (mi_col & (sb_mi - 1)) >> bw_mi_log2
    if blk_row_in_sb == 0:
        return True
    if ((blk_col_in_sb + 1) << bw_mi_log2) >= sb_mi:
        return False
    idx = (blk_row_in_sb << (5 - bw_mi_log2)) + blk_col_in_sb
    vert = part in (PARTITION_VERT_A, PARTITION_VERT_B) and bw_l == bh_l
    tbl = _has_table("tr_vert" if vert else "tr", bw_l, bh_l)
    return bool((int(tbl[idx // 8]) >> (idx % 8)) & 1)


def _has_bottom_left(sb_size, bw, bh, mi_row, mi_col, bottom_available,
                     left_available, txsz, row_off, col_off, ss_x, ss_y,
                     part: int = 0) -> bool:
    if not bottom_available or not left_available:
        return False
    if col_off > 0:
        return False
    bw_l, bh_l = bw << ss_x, bh << ss_y
    plane_bh_unit = max((bh_l >> 2) >> ss_y, 1)
    bl_count = TX_HEIGHT[txsz] >> 2
    if row_off + bl_count < plane_bh_unit:
        return True
    bw_mi_log2 = (bw_l >> 2).bit_length() - 1
    bh_mi_log2 = (bh_l >> 2).bit_length() - 1
    sb_mi = sb_size >> 2
    blk_row_in_sb = (mi_row & (sb_mi - 1)) >> bh_mi_log2
    blk_col_in_sb = (mi_col & (sb_mi - 1)) >> bw_mi_log2
    if blk_col_in_sb == 0:
        blk_start_row_off = blk_row_in_sb << (bh_mi_log2 + 2 - 2) >> ss_y
        row_off_in_sb = blk_start_row_off + row_off
        sb_height_unit = sb_mi >> ss_y
        return row_off_in_sb + bl_count < sb_height_unit
    if ((blk_row_in_sb + 1) << bh_mi_log2) >= sb_mi:
        return False
    idx = (blk_row_in_sb << (5 - bw_mi_log2)) + blk_col_in_sb
    vert = part in (PARTITION_VERT_A, PARTITION_VERT_B) and bw_l == bh_l
    tbl = _has_table("bl_vert" if vert else "bl", bw_l, bh_l)
    return bool((int(tbl[idx // 8]) >> (idx % 8)) & 1)
