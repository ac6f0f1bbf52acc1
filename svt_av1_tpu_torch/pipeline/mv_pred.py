"""Reference MV stack construction (AV1 spec 7.10.2 find_mv_stack).

Single-reference path without temporal MVs (our sequences disable order
hints, so use_ref_frame_mvs is always 0).  Behavioral parity:
dec_setup_ref_mv_list (SVT-AV1 Source/Lib/Decoder/Codec/
EbDecParseInterBlock.c:809) with scan_row_mbmi:460, scan_col_mbmi:515,
scan_blk_mbmi:569, add_ref_mv_candidate:388,
process_single_ref_mv_candidate:772.

Mode info is read from per-mi grids held by the frame codec: ref_frame
(int, 0=intra/-1 outside), mv (row, col in 1/8 pel), mode, bsize dims.
Both encoder and decoder run this identically, so any divergence breaks
conformance loudly.
"""
from __future__ import annotations

import dataclasses

import numpy as np

MAX_REF_MV_STACK_SIZE = 8
MAX_MV_REF_CANDIDATES = 2
MVREF_ROW_COLS = 3
REF_CAT_LEVEL = 640
MV_BORDER = 16 << 3

GLOBALMV_OFFSET = 3
REFMV_OFFSET = 4
NEWMV_CTX_MASK = (1 << GLOBALMV_OFFSET) - 1
GLOBALMV_CTX_MASK = (1 << (REFMV_OFFSET - GLOBALMV_OFFSET)) - 1
REFMV_CTX_MASK = (1 << (8 - REFMV_OFFSET)) - 1

# inter modes (PredictionMode numbering from constants.py)
NEARESTMV, NEARMV, GLOBALMV, NEWMV = 13, 14, 15, 16
# compound modes
NEAREST_NEARESTMV, NEAR_NEARMV = 17, 18
NEAREST_NEWMV, NEW_NEARESTMV = 19, 20
NEAR_NEWMV, NEW_NEARMV = 21, 22
GLOBAL_GLOBALMV, NEW_NEWMV = 23, 24


def has_newmv(mode: int, j: int = 0) -> bool:
    """has_newmv(mode) — the oracle decoder counts any NEW-bearing mode
    regardless of ref position (EbDecParseInterBlock.c:383)."""
    return mode in (NEWMV, NEW_NEWMV, NEAR_NEWMV, NEW_NEARMV,
                    NEAREST_NEWMV, NEW_NEARESTMV)


@dataclasses.dataclass
class MiGrid:
    """Per-mi mode info the stack scans (filled by the frame codec)."""

    ref_frame: np.ndarray      # [mi_rows, mi_cols] int8; 0 = intra
    mv_row: np.ndarray         # [mi_rows, mi_cols] int16 (1/8 pel)
    mv_col: np.ndarray
    mode: np.ndarray           # [mi_rows, mi_cols] uint8
    bw4: np.ndarray            # block width in mi units at that mi
    bh4: np.ndarray
    ref_frame1: np.ndarray = None   # second ref (compound); 0 = none
    mv1_row: np.ndarray = None
    mv1_col: np.ndarray = None
    # inter-intra blocks carry RefFrame[1] = INTRA_FRAME (not NONE):
    # they join MVP stacks via RefFrame[0] but are NOT warp samples
    # (find_samples requires ref_frame[1] == NONE_FRAME,
    # EbAdaptiveMotionVectorPrediction.c:1642)
    interintra: np.ndarray = None

    @classmethod
    def create(cls, mi_rows: int, mi_cols: int) -> "MiGrid":
        z = lambda dt: np.zeros((mi_rows, mi_cols), dt)
        return cls(z(np.int8), z(np.int16), z(np.int16), z(np.uint8),
                   np.ones((mi_rows, mi_cols), np.int16),
                   np.ones((mi_rows, mi_cols), np.int16),
                   z(np.int8), z(np.int16), z(np.int16),
                   z(bool))


@dataclasses.dataclass
class MvStackResult:
    stack: list                # [(mv(row,col), weight)]
    mode_context: int
    newmv_count: int
    ref_mv_list: list          # 2 entries for NEAREST/NEAR


def find_mv_stack(grid: MiGrid, mi_row: int, mi_col: int, bw4: int, bh4: int,
                  ref_frame: int, mi_rows: int, mi_cols: int,
                  sb_mi: int = 16, gm_mv=(0, 0), allow_hp: bool = False,
                  force_int: bool = False, sign_bias=None,
                  ref_frame1: int = 0, tile=None, gm_mv1=(0, 0),
                  gm_warp=(False, False)) -> MvStackResult:
    """ref_frame1 > 0 selects the compound path: stack entries become
    (mv0, mv1, weight) pairs (dec_setup_ref_mv_list compound branches).

    ``tile`` = (mi_r0, mi_c0, mi_r1, mi_c1): candidate availability is
    tile-bounded (spec is_inside, 5.11.53) while the mb_to_* clamp
    ranges stay frame-based, like the reference."""
    compound = ref_frame1 > 0
    t_r0, t_c0, t_r1, t_c1 = tile if tile is not None \
        else (0, 0, mi_rows, mi_cols)

    def inside(r, c):
        return t_c0 <= c < t_c1 and t_r0 <= r < t_r1
    stack: list[list] = []     # single: [r, c, w]; comp: [r0, c0, r1, c1, w]
    found_above = 0
    found_left = 0
    newmv_count = 0
    if sign_bias is None:
        sign_bias = [0] * 8
    gm_mvs = (gm_mv, gm_mv1 if ref_frame1 > 0 else gm_mv)

    def _cand_global(r, c, k):
        """is_gm_block of the candidate: coded GLOBALMV family on a
        >=8x8 block while list-k's model warps (spec 7.10.2.9 gating the
        GlobalMvs substitution)."""
        if not gm_warp[k]:
            return False
        m = int(grid.mode[r, c])
        if m not in (GLOBALMV, GLOBAL_GLOBALMV):
            return False
        return min(int(grid.bw4[r, c]), int(grid.bh4[r, c])) >= 2

    def add_ref_mv(cand_rc, weight, bump):
        """add_ref_mv_candidate (spec 7.10.2.9)."""
        nonlocal newmv_count
        r, c = cand_rc
        found = 0
        cand_refs = (int(grid.ref_frame[r, c]), int(grid.ref_frame1[r, c]))
        cand_mvs = ((int(grid.mv_row[r, c]), int(grid.mv_col[r, c])),
                    (int(grid.mv1_row[r, c]), int(grid.mv1_col[r, c])))
        if compound:
            if cand_refs[0] != ref_frame or cand_refs[1] != ref_frame1:
                return 0
            mv0 = gm_mvs[0] if _cand_global(r, c, 0) else cand_mvs[0]
            mv1 = gm_mvs[1] if _cand_global(r, c, 1) else cand_mvs[1]
            key = mv0 + mv1
            for ent in stack:
                if tuple(ent[:4]) == key:
                    ent[4] += weight
                    break
            else:
                if len(stack) < MAX_REF_MV_STACK_SIZE:
                    stack.append(list(key) + [weight])
            if has_newmv(int(grid.mode[r, c])):
                newmv_count += 1
            return 1
        for j in range(2):
            if cand_refs[j] != ref_frame:
                continue
            mv = gm_mvs[0] if _cand_global(r, c, 0) else cand_mvs[j]
            for ent in stack:
                if (ent[0], ent[1]) == mv:
                    ent[2] += weight
                    break
            else:
                if len(stack) < MAX_REF_MV_STACK_SIZE:
                    stack.append([mv[0], mv[1], weight])
            if has_newmv(int(grid.mode[r, c]), j):
                newmv_count += 1
            found = 1
        return found

    row_adj = (bh4 < 2) and (mi_row & 1)
    col_adj = (bw4 < 2) and (mi_col & 1)
    up_avail = mi_row > t_r0
    left_avail = mi_col > t_c0

    max_row_offset = 0
    max_col_offset = 0
    if up_avail:
        max_row_offset = -(MVREF_ROW_COLS << 1) + row_adj
        if bh4 < 2:
            max_row_offset = -(2 << 1) + row_adj
        max_row_offset = int(np.clip(max_row_offset, t_r0 - mi_row,
                                     t_r1 - mi_row - 1))
    if left_avail:
        max_col_offset = -(MVREF_ROW_COLS << 1) + col_adj
        if bw4 < 2:
            max_col_offset = -(2 << 1) + col_adj
        max_col_offset = int(np.clip(max_col_offset, t_c0 - mi_col,
                                     t_c1 - mi_col - 1))

    processed_rows = 0
    processed_cols = 0

    def scan_row(delta_row):
        nonlocal found_above, processed_rows
        end4 = min(min(bw4, mi_cols - mi_col), 16)
        delta_col = 0
        use_step_16 = bw4 >= 16
        if abs(delta_row) > 1:
            delta_col = 1
            if (mi_col & 1) and bw4 < 2:
                delta_col -= 1
        i = 0
        while i < end4:
            mv_row = mi_row + delta_row
            mv_col = mi_col + delta_col + i
            if not inside(mv_row, mv_col):
                break
            cand_bw4 = int(grid.bw4[mv_row, mv_col])
            cand_bh4 = int(grid.bh4[mv_row, mv_col])
            length = min(bw4, cand_bw4)
            if use_step_16:
                length = max(4, length)
            elif abs(delta_row) > 1:
                length = max(2, length)
            weight = 2
            if bw4 >= 2 and bw4 <= cand_bw4:
                inc = min(-max_row_offset + delta_row + 1, cand_bh4)
                weight = max(weight, inc)
                processed_rows = inc - delta_row - 1
            found_above += add_ref_mv((mv_row, mv_col), length * weight, True)
            i += length

    def scan_col(delta_col):
        nonlocal found_left, processed_cols
        end4 = min(min(bh4, mi_rows - mi_row), 16)
        delta_row = 0
        use_step_16 = bh4 >= 16
        if abs(delta_col) > 1:
            delta_row = 1
            if (mi_row & 1) and bh4 < 2:
                delta_row -= 1
        i = 0
        while i < end4:
            mv_row = mi_row + delta_row + i
            mv_col = mi_col + delta_col
            if not inside(mv_row, mv_col):
                break
            cand_bw4 = int(grid.bw4[mv_row, mv_col])
            cand_bh4 = int(grid.bh4[mv_row, mv_col])
            length = min(bh4, cand_bh4)
            if abs(delta_col) > 1:
                length = max(2, length)
            if use_step_16:
                length = max(4, length)
            weight = 2
            if bh4 >= 2 and bh4 <= cand_bh4:
                inc = min(-max_col_offset + delta_col + 1, cand_bw4)
                weight = max(weight, inc)
                processed_cols = inc - delta_col - 1
            found_left += add_ref_mv((mv_row, mv_col), length * weight, True)
            i += length

    def scan_blk(delta_row, delta_col):
        nonlocal found_above
        mv_row, mv_col = mi_row + delta_row, mi_col + delta_col
        if inside(mv_row, mv_col):
            found_above_inc = add_ref_mv((mv_row, mv_col), 4, False)
            found_above += found_above_inc

    if abs(max_row_offset) >= 1:
        scan_row(-1)
    if abs(max_col_offset) >= 1:
        scan_col(-1)
    if _has_top_right_mv(mi_row, mi_col, bw4, bh4, sb_mi):
        scan_blk(-1, bw4)

    nearest_match = (found_above > 0) + (found_left > 0)
    num_nearest = len(stack)
    num_new = newmv_count
    for ent in stack:
        ent[-1] += REF_CAT_LEVEL

    # no temporal MVs (use_ref_frame_mvs == 0): the reference leaves the
    # GLOBALMV context bit clear in this case (dec_setup_ref_mv_list)
    mode_context = 0

    scan_blk(-1, -1)
    for idx in range(2, MVREF_ROW_COLS + 1):
        row_offset = -(idx << 1) + 1 + row_adj
        col_offset = -(idx << 1) + 1 + col_adj
        if abs(row_offset) <= abs(max_row_offset) and abs(row_offset) > processed_rows:
            scan_row(row_offset)
        if abs(col_offset) <= abs(max_col_offset) and abs(col_offset) > processed_cols:
            scan_col(col_offset)

    # stable partial bubble sorts (nearest group, then the rest)
    def sort_span(start, end):
        while end > start:
            new_end = start
            for idx in range(start + 1, end):
                if stack[idx - 1][-1] < stack[idx][-1]:
                    stack[idx - 1], stack[idx] = stack[idx], stack[idx - 1]
                    new_end = idx
            end = new_end

    sort_span(0, num_nearest)
    sort_span(num_nearest, len(stack))

    # extra search process: neighbor mvs from any ref, sign-flipped when
    # the candidate ref lies on the other temporal side (spec
    # add_extra_mv_candidate; RefFrameSignBias from order hints)
    if len(stack) < MAX_MV_REF_CANDIDATES:
        our_refs = (ref_frame, ref_frame1)
        ref_id = [[], []]            # same-ref candidates per position
        ref_diff = [[], []]          # different-ref (sign-adjusted)
        mi_width = min(min(16, bw4), mi_cols - mi_col)
        mi_height = min(min(16, bh4), mi_rows - mi_row)
        mi_size = min(mi_width, mi_height)
        for pass_ in range(2):
            idx = 0
            while idx < mi_size and (compound
                                     or len(stack) < MAX_MV_REF_CANDIDATES):
                if pass_ == 0:
                    mv_row, mv_col = mi_row - 1, mi_col + idx
                else:
                    mv_row, mv_col = mi_row + idx, mi_col - 1
                if not inside(mv_row, mv_col):
                    break
                for rf, mr, mc in (
                        (grid.ref_frame, grid.mv_row, grid.mv_col),
                        (grid.ref_frame1, grid.mv1_row, grid.mv1_col)):
                    cand_ref = int(rf[mv_row, mv_col])
                    if cand_ref <= 0:
                        continue
                    mv = (int(mr[mv_row, mv_col]), int(mc[mv_row, mv_col]))
                    if compound:
                        for cmp_idx in range(2):
                            if cand_ref == our_refs[cmp_idx] \
                                    and len(ref_id[cmp_idx]) < 2:
                                ref_id[cmp_idx].append(mv)
                            elif len(ref_diff[cmp_idx]) < 2:
                                amv = mv
                                if sign_bias[cand_ref] != \
                                        sign_bias[our_refs[cmp_idx]]:
                                    amv = (-mv[0], -mv[1])
                                ref_diff[cmp_idx].append(amv)
                    else:
                        # NOTE: the reference appends BOTH ref positions of
                        # the final candidate without re-checking the cap,
                        # so the stack may reach 3 entries here
                        # (process_single_ref_mv_candidate,
                        # EbDecParseInterBlock.c:772)
                        amv = mv
                        if sign_bias[cand_ref] != sign_bias[ref_frame]:
                            amv = (-mv[0], -mv[1])
                        if all((e[0], e[1]) != amv for e in stack):
                            stack.append([amv[0], amv[1], 2])
                idx += int(grid.bh4[mv_row, mv_col]) if pass_ else \
                    int(grid.bw4[mv_row, mv_col])
        if compound:
            comp_list = [[], []]
            for cmp_idx in range(2):
                lst = (ref_id[cmp_idx] + ref_diff[cmp_idx])[:2]
                while len(lst) < 2:
                    lst.append(gm_mvs[cmp_idx])
                comp_list[cmp_idx] = lst
            if len(stack) == 1:
                if (comp_list[0][0] + comp_list[1][0]) == tuple(stack[0][:4]):
                    stack.append(list(comp_list[0][1] + comp_list[1][1]) + [2])
                else:
                    stack.append(list(comp_list[0][0] + comp_list[1][0]) + [2])
            elif len(stack) == 0:
                for k in range(MAX_MV_REF_CANDIDATES):
                    stack.append(
                        list(comp_list[0][k] + comp_list[1][k]) + [2])

    # clamp
    bw_px, bh_px = bw4 * 4, bh4 * 4
    mb_to_left = -(mi_col * 4) * 8
    mb_to_right = ((mi_cols - bw4 - mi_col) * 4) * 8
    mb_to_top = -(mi_row * 4) * 8
    mb_to_bottom = ((mi_rows - bh4 - mi_row) * 4) * 8
    lo_c = mb_to_left - bw_px * 8 - MV_BORDER
    hi_c = mb_to_right + bw_px * 8 + MV_BORDER
    lo_r = mb_to_top - bh_px * 8 - MV_BORDER
    hi_r = mb_to_bottom + bh_px * 8 + MV_BORDER
    for ent in stack:
        for base in range(0, len(ent) - 1, 2):
            ent[base] = int(np.clip(ent[base], lo_r, hi_r))
            ent[base + 1] = int(np.clip(ent[base + 1], lo_c, hi_c))

    ref_match_count = (found_above > 0) + (found_left > 0)
    if nearest_match == 0:
        if ref_match_count >= 1:
            mode_context |= 1
        if ref_match_count == 1:
            mode_context |= 1 << REFMV_OFFSET
        elif ref_match_count >= 2:
            mode_context |= 2 << REFMV_OFFSET
    elif nearest_match == 1:
        mode_context |= 2 if num_new > 0 else 3
        if ref_match_count == 1:
            mode_context |= 3 << REFMV_OFFSET
        elif ref_match_count >= 2:
            mode_context |= 4 << REFMV_OFFSET
    else:
        mode_context |= 4 if num_new >= 1 else 5
        mode_context |= 5 << REFMV_OFFSET

    # mv_ref_list: stack mvs padded with the global mv
    ref_list = []
    for idx in range(MAX_MV_REF_CANDIDATES):
        if idx < len(stack):
            mv = (stack[idx][0], stack[idx][1])
        else:
            mv = gm_mv
        ref_list.append(lower_mv_precision(mv, allow_hp, force_int))

    if compound:
        out_stack = [((e[0], e[1]), (e[2], e[3]), e[4]) for e in stack]
    else:
        out_stack = [((e[0], e[1]), e[2]) for e in stack]
    return MvStackResult(
        stack=out_stack,
        mode_context=mode_context,
        newmv_count=newmv_count,
        ref_mv_list=ref_list)


def _has_top_right_mv(mi_row: int, mi_col: int, bw4: int, bh4: int,
                      sb_mi: int) -> bool:
    """has_top_right for the MV scan (EbDecParseInterBlock.c:593; no AB
    partitions)."""
    bs = max(bw4, bh4)
    mask_row = mi_row & (sb_mi - 1)
    mask_col = mi_col & (sb_mi - 1)
    if bs > 16:
        return False
    has_tr = not ((mask_row & bs) and (mask_col & bs))
    b = bs
    while b < sb_mi:
        if mask_col & b:
            if (mask_col & (2 * b)) and (mask_row & (2 * b)):
                has_tr = False
                break
        else:
            break
        b <<= 1
    # rectangular adjustments: the first block of a VERT pair always has
    # a top-right; the second block of a HORZ pair never does
    is_sec_rect = False
    if bw4 < bh4 and (mi_col & (bh4 - 1)):
        is_sec_rect = True
    if bw4 > bh4 and (mi_row & (bw4 - 1)):
        is_sec_rect = True
    if bw4 < bh4 and not is_sec_rect:
        has_tr = True
    if bw4 > bh4 and is_sec_rect:
        has_tr = False
    return has_tr


def lower_mv_precision(mv, allow_hp: bool, force_int: bool):
    """spec lower_mv_precision: strip hp/fractional bits toward zero."""
    row, col = mv
    out = []
    for comp in (row, col):
        if force_int:
            comp = (comp // 8) * 8 if comp >= 0 else -((-comp // 8) * 8)
            # reference: integer rounding toward nearest? use spec rule:
        elif not allow_hp:
            if comp & 1:
                comp += -1 if comp > 0 else 1
        out.append(comp)
    return tuple(out)


def drl_ctx(stack, idx: int) -> int:
    """av1_drl_ctx over stack weights (weight is the last element)."""
    w0, w1 = stack[idx][-1], stack[idx + 1][-1]
    if w0 >= REF_CAT_LEVEL and w1 >= REF_CAT_LEVEL:
        return 0
    if w0 >= REF_CAT_LEVEL and w1 < REF_CAT_LEVEL:
        return 1
    if w0 < REF_CAT_LEVEL and w1 < REF_CAT_LEVEL:
        return 2
    return 0


# compound mode context (svt_mode_context_analyzer,
# EbDecParseInterBlock.c:1209; compound_mode_ctx_map:27)
COMPOUND_MODE_CTX_MAP = [
    [0, 1, 1, 1, 1],
    [1, 2, 3, 4, 4],
    [4, 4, 5, 6, 7],
]


def compound_mode_ctx(mode_context: int) -> int:
    newmv_ctx = mode_context & NEWMV_CTX_MASK
    refmv_ctx = (mode_context >> REFMV_OFFSET) & REFMV_CTX_MASK
    return COMPOUND_MODE_CTX_MAP[refmv_ctx >> 1][min(newmv_ctx, 4)]


# ---------------------------------------------------------------------------
# Warp-sample collection for WARPED_CAUSAL (find_warp_samples /
# has_overlappable_cand, EbDecParseInterBlock.c:1620,1755).  Pure
# functions of the mi grid, shared by encoder and decoder.
# ---------------------------------------------------------------------------

LEAST_SQUARES_SAMPLES_MAX = 8


def _add_sample(grid, r, c, pts, ptsr, row_offset, sign_r, col_offset,
                sign_c):
    bw = int(grid.bw4[r, c]) * 4
    bh = int(grid.bh4[r, c]) * 4
    x = col_offset * 4 + sign_c * max(bw, 4) // 2 - 1
    y = row_offset * 4 + sign_r * max(bh, 4) // 2 - 1
    pts += [x * 8, y * 8]
    ptsr += [x * 8 + int(grid.mv_col[r, c]), y * 8 + int(grid.mv_row[r, c])]


def find_warp_samples(grid: MiGrid, mi_row: int, mi_col: int, bw4: int,
                      bh4: int, ref_frame: int, tile, sb_mi: int):
    """Returns (num_samples, pts, pts_inref) in the spec's 1/8-px sample
    coordinates (block-relative via the current mi position)."""
    t_r0, t_c0, t_r1, t_c1 = tile
    pts: list[int] = []
    ptsr: list[int] = []
    np_ = 0
    do_tl = do_tr = True
    up = mi_row > t_r0
    left = mi_col > t_c0

    def cand_ok(r, c):
        return int(grid.ref_frame[r, c]) == ref_frame \
            and int(grid.ref_frame1[r, c]) == 0 \
            and not (grid.interintra is not None
                     and grid.interintra[r, c])

    if up:
        r = mi_row - 1
        n4_w = int(grid.bw4[r, mi_col])
        if bw4 <= n4_w:
            col_offset = -(mi_col % n4_w)
            if col_offset < 0:
                do_tl = False
            if col_offset + n4_w > bw4:
                do_tr = False
            if cand_ok(r, mi_col):
                _add_sample(grid, r, mi_col, pts, ptsr, 0, -1, col_offset, 1)
                np_ += 1
        else:
            i = 0
            while i < min(bw4, t_c1 - mi_col):
                c = mi_col + i
                n4_w = int(grid.bw4[r, c])
                step = min(bw4, n4_w)
                if cand_ok(r, c):
                    _add_sample(grid, r, c, pts, ptsr, 0, -1, i, 1)
                    np_ += 1
                    if np_ >= LEAST_SQUARES_SAMPLES_MAX:
                        return np_, pts, ptsr
                i += step
        if np_ >= LEAST_SQUARES_SAMPLES_MAX:
            return np_, pts, ptsr

    if left:
        c = mi_col - 1
        n4_h = int(grid.bh4[mi_row, c])
        if bh4 <= n4_h:
            row_offset = -(mi_row % n4_h)
            if row_offset < 0:
                do_tl = False
            if cand_ok(mi_row, c):
                _add_sample(grid, mi_row, c, pts, ptsr, row_offset, 1, 0, -1)
                np_ += 1
        else:
            i = 0
            while i < min(bh4, t_r1 - mi_row):
                r = mi_row + i
                n4_h = int(grid.bh4[r, c])
                step = min(bh4, n4_h)
                if cand_ok(r, c):
                    _add_sample(grid, r, c, pts, ptsr, i, 1, 0, -1)
                    np_ += 1
                    if np_ >= LEAST_SQUARES_SAMPLES_MAX:
                        return np_, pts, ptsr
                i += step
        if np_ >= LEAST_SQUARES_SAMPLES_MAX:
            return np_, pts, ptsr

    if do_tl and up and left:
        r, c = mi_row - 1, mi_col - 1
        if cand_ok(r, c):
            _add_sample(grid, r, c, pts, ptsr, 0, -1, 0, -1)
            np_ += 1
            if np_ >= LEAST_SQUARES_SAMPLES_MAX:
                return np_, pts, ptsr

    if do_tr and _has_top_right_mv(mi_row, mi_col, bw4, bh4, sb_mi):
        r, c = mi_row - 1, mi_col + bw4
        if t_r0 <= r < t_r1 and t_c0 <= c < t_c1 and cand_ok(r, c):
            _add_sample(grid, r, c, pts, ptsr, 0, -1, bw4, 1)
            np_ += 1
    return np_, pts, ptsr


def has_overlappable_cand(grid: MiGrid, mi_row: int, mi_col: int,
                          bw4: int, bh4: int, tile) -> bool:
    t_r0, t_c0, t_r1, t_c1 = tile
    if min(bw4, bh4) < 2:
        return False
    rows_max = grid.ref_frame.shape[0] - 1
    cols_max = grid.ref_frame.shape[1] - 1
    if mi_row > t_r0:
        x4 = mi_col
        while x4 < min(t_c1, mi_col + bw4):
            c = min(x4 | 1, cols_max)
            if int(grid.ref_frame[mi_row - 1, c]) > 0:
                return True
            x4 += max(2, int(grid.bw4[mi_row - 1, c]) >> 2)
    if mi_col > t_c0:
        y4 = mi_row
        while y4 < min(t_r1, mi_row + bh4):
            r = min(y4 | 1, rows_max)
            if int(grid.ref_frame[r, mi_col - 1]) > 0:
                return True
            y4 += max(2, int(grid.bh4[r, mi_col - 1]) >> 2)
    return False
