"""Rate-distortion optimized quantization (trellis) + rate tables.

Behavioral parity with the reference encoder's coefficient optimizer
(svt_av1_optimize_b, EbFullLoop.c:1190) at rdoq_level 1 semantics
(set_rdoq_controls, EbEncDecProcess.c:2090: full trellis, no fast-eob
modes, quantize_fp feeding the trellis on both planes):

  * per-frame syntax rate tables derived from the initial frame CDFs
    (av1_estimate_coefficients_rate, EbMdRateEstimation.c:420) in
    1/512-bit units (av1_cost_symbol / av1_prob_cost);
  * the sequential scan-order optimizer: update_coeff_general for the
    last/DC positions, update_coeff_eob for possible eob reduction while
    at most two nonzeros were seen, update_coeff_simple for the rest,
    and the final all-skip decision (update_skip);
  * the SSE lambda: rdmult = 88*q^2/24 in dc-qlookup q3 units
    (av1_lambda_mode_decision8_bit_sse, EbLambdaRateTables.h:227 --
    regenerated from the formula, not copied), scaled per frame type
    (compute_rdmult_sse, EbRateControlProcess.c:5794) and per plane
    (plane_rd_mult, EbFullLoop.c).

The optimizer only changes which quantized levels the encoder keeps, so
every output stream remains conformant; the native twin
(native/rdoq_core.h) is bit-identical (tests/test_rdoq.py).

This module is deliberately plain NumPy/Python: the trellis is a
sequential per-coefficient recurrence over at most 1024 scan positions
with data-dependent early state (nz_num), which is exactly the shape
XLA cannot batch profitably; production encodes run the C twin inside
the fused native block kernel, and this port is the readable reference
+ fallback.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..entropy.tables import table

AV1_PROB_COST_SHIFT = 9
EC_MIN_PROB = 4
NUM_BASE_LEVELS = 2
COEFF_BASE_RANGE = 12

TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT = 0, 1, 2

# cost of one raw bit in 1/512-bit units
_BIT = 1 << AV1_PROB_COST_SHIFT


@functools.cache
def _prob_cost() -> np.ndarray:
    """round(-log2((i+128)/256) * 512) for i in 0..127 (av1_prob_cost)."""
    i = np.arange(128) + 128
    return np.round(-np.log2(i / 256.0) * _BIT).astype(np.int32)


def _cost_symbol(p15: int) -> int:
    """av1_cost_symbol (EbMdRateEstimation.c:31)."""
    p15 = max(int(p15), EC_MIN_PROB)
    shift = 14 - int(p15).bit_length() + 1  # CDF_PROB_BITS-1 - msb
    prob = ((p15 << shift) * 256 + (1 << 14)) >> 15
    if prob < 1:
        prob = 1
    if prob > 255:
        prob = 255
    return int(_prob_cost()[prob - 128]) + _BIT * shift


def _rates_from_icdf(icdf: np.ndarray) -> np.ndarray:
    """Per-symbol cost from one icdf row (counter excluded).

    Our storage keeps decreasing icdf values ending at 0 followed by the
    adaptation counter: p(s) = prev - icdf[s] with prev starting 32768.
    """
    vals = icdf.astype(np.int64)
    # symbols run until the stored value hits 0 (inclusive)
    n = int(np.argmax(vals == 0)) + 1
    prev = 32768
    out = np.zeros(n, np.int32)
    for s in range(n):
        p15 = prev - int(vals[s])
        out[s] = _cost_symbol(p15)
        prev = int(vals[s])
    return out


@dataclasses.dataclass
class RdoqTables:
    """Frame-constant coefficient rate tables (LvMapCoeffCost /
    LvMapEobCost analogs), all int32 in 1/512-bit units."""
    txb_skip: np.ndarray     # [5][13][2]
    base_eob: np.ndarray     # [5][2][4][3]
    base: np.ndarray         # [5][2][42][8]
    eob_extra: np.ndarray    # [5][2][22][2]
    dc_sign: np.ndarray      # [2][3][2]
    lps: np.ndarray          # [5][2][21][26]
    eob_cost: np.ndarray     # [7][2][2][11]


def build_tables(fc) -> RdoqTables:
    """av1_estimate_coefficients_rate from a FrameCdfs set."""
    txb_skip = np.zeros((5, 13, 2), np.int32)
    for ts in range(5):
        for ctx in range(13):
            txb_skip[ts, ctx, :] = _rates_from_icdf(fc.txb_skip[ts, ctx, :-1])
    base_eob = np.zeros((5, 2, 4, 3), np.int32)
    base = np.zeros((5, 2, 42, 8), np.int32)
    eob_extra = np.zeros((5, 2, 22, 2), np.int32)
    lps = np.zeros((5, 2, 21, 26), np.int32)
    for ts in range(5):
        for pl in range(2):
            for ctx in range(4):
                base_eob[ts, pl, ctx] = _rates_from_icdf(
                    fc.coeff_base_eob[ts, pl, ctx, :-1])
            for ctx in range(42):
                r = _rates_from_icdf(fc.coeff_base[ts, pl, ctx, :-1])
                base[ts, pl, ctx, :4] = r
                base[ts, pl, ctx, 4] = 0
                base[ts, pl, ctx, 5] = r[1] + _BIT - r[0]
                base[ts, pl, ctx, 6] = r[2] - r[1]
                base[ts, pl, ctx, 7] = r[3] - r[2]
            for ctx in range(22):
                eob_extra[ts, pl, ctx] = _rates_from_icdf(
                    fc.eob_extra[ts, pl, ctx, :-1])
            for ctx in range(21):
                br = _rates_from_icdf(
                    fc.coeff_br[min(ts, 3), pl, ctx, :-1])
                prev = 0
                i = 0
                while i < COEFF_BASE_RANGE:
                    for j in range(3):
                        lps[ts, pl, ctx, i + j] = prev + br[j]
                    prev += br[3]
                    i += 3
                lps[ts, pl, ctx, i] = prev
                lps[ts, pl, ctx, COEFF_BASE_RANGE + 1] = lps[ts, pl, ctx, 0]
                for k in range(1, COEFF_BASE_RANGE + 1):
                    lps[ts, pl, ctx, k + COEFF_BASE_RANGE + 1] = (
                        lps[ts, pl, ctx, k] - lps[ts, pl, ctx, k - 1])
    eob_cost = np.zeros((7, 2, 2, 11), np.int32)
    for ems in range(7):
        flag = fc.eob_flag(ems + 4)
        for pl in range(2):
            for ctx in range(2):
                r = _rates_from_icdf(flag[pl, ctx, :-1])
                eob_cost[ems, pl, ctx, :len(r)] = r
    return RdoqTables(txb_skip, base_eob, base, eob_extra,
                      np.ascontiguousarray(
                          _dc_sign_rates(fc)), lps, eob_cost)


@functools.lru_cache(maxsize=8)
def _tables_for_qctx(qctx_rep_qindex: int) -> RdoqTables:
    from ..entropy.tables import FrameCdfs
    return build_tables(FrameCdfs(qctx_rep_qindex))


def tables_for_qindex(base_qindex: int) -> RdoqTables:
    """Frame rate tables for a frame starting from the spec-default CDF
    set at this qindex (cached per coefficient-CDF quality bucket)."""
    from ..entropy.tables import get_qctx
    # representative qindex per bucket keeps the cache tiny
    rep = {0: 15, 1: 50, 2: 100, 3: 200}[get_qctx(base_qindex)]
    return _tables_for_qctx(rep)


def _dc_sign_rates(fc) -> np.ndarray:
    out = np.zeros((2, 3, 2), np.int32)
    for pl in range(2):
        for ctx in range(3):
            out[pl, ctx] = _rates_from_icdf(fc.dc_sign[pl, ctx, :-1])
    return out


# --------------------------------------------------------------------------
# SSE lambda (compute_rdmult_sse)
# --------------------------------------------------------------------------

def _lambda_sse(qindex: int, bit_depth: int) -> int:
    """88*q^2/24 in q3 dc-quant units; higher depths scale down by
    4^(bd-8) (the av1_lambda_mode_decision*_bit_sse tables regenerated
    from libaom's av1_compute_rd_mult formula)."""
    name = {8: "dc_qlookup_q3", 10: "dc_qlookup_10_q3",
            12: "dc_qlookup_12_q3"}[bit_depth]
    q = int(table(name)[np.clip(qindex, 0, 255)])
    rd = 88 * q * q // 24
    sh = 2 * (bit_depth - 8)
    if sh:
        rd = (rd + (1 << (sh - 1))) >> sh
    return max(rd, 1)


def compute_rdmult(qindex: int, bit_depth: int, frame_type_key: bool,
                   temporal_layer: int = 0, max_layer: int = 0) -> int:
    """compute_rdmult_sse (EbRateControlProcess.c:5794): the SSE lambda
    scaled by the frame's mini-GOP role (rd_frame_type_factor)."""
    rd = _lambda_sse(qindex, bit_depth)
    if not frame_type_key:
        factor = 164 if temporal_layer < max_layer or temporal_layer == 0 \
            else 128
        rd = (rd * factor) >> 7
    return rd


# plane_rd_mult[is_inter][plane_type] (EbFullLoop.c)
PLANE_RD_MULT = ((17, 13), (16, 10))


def plane_rdmult(lambda_sse: int, is_inter: bool, plane_type: int) -> int:
    """The optimizer's rdmult: (lambda*plane_rd_mult + 2) >> 2
    (svt_av1_optimize_b, sharpness 0)."""
    return (lambda_sse * PLANE_RD_MULT[1 if is_inter else 0][plane_type]
            + 2) >> 2


def sliced_tabs(t: RdoqTables, ts_ctx: int, plane_type: int, sk_ctx: int,
                dc_ctx: int, ems: int):
    """The 7 ctx-sliced contiguous arrays consumed per txb (order
    matches native/block_native.c fill_rdoq)."""
    a = np.ascontiguousarray
    return (a(t.txb_skip[ts_ctx, sk_ctx]),
            a(t.base_eob[ts_ctx, plane_type]),
            a(t.base[ts_ctx, plane_type]),
            a(t.eob_extra[ts_ctx, plane_type]),
            a(t.dc_sign[plane_type, dc_ctx]),
            a(t.lps[ts_ctx, plane_type]),
            a(t.eob_cost[ems, plane_type]))


# --------------------------------------------------------------------------
# the trellis (svt_av1_optimize_b port)
# --------------------------------------------------------------------------

_EOB_TO_PT_SMALL = np.array(
    [0, 1, 2, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5,
     6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6], np.int32)
_EOB_TO_PT_LARGE = np.array(
    [6, 7, 8, 8, 9, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10, 11],
    np.int32)
_EOB_GROUP_START = np.array(
    [0, 1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513], np.int32)
_EOB_OFFSET_BITS = np.array(
    [0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9], np.int32)


def _eob_pos_token(eob: int):
    if eob < 33:
        t = int(_EOB_TO_PT_SMALL[eob])
    else:
        t = int(_EOB_TO_PT_LARGE[min((eob - 1) >> 5, 16)])
    return t, eob - int(_EOB_GROUP_START[t])


def _get_eob_cost(eob: int, eob_costs, eob_extra_costs, tx_class) -> int:
    """get_eob_cost (EbFullLoop.c:758).  eob_costs: [2][11];
    eob_extra_costs: [22][2] indexed by eob_pt (our cdf convention)."""
    eob_pt, eob_extra = _eob_pos_token(eob)
    ctx = 0 if tx_class == TX_CLASS_2D else 1
    cost = int(eob_costs[ctx][eob_pt - 1])
    offset_bits = int(_EOB_OFFSET_BITS[eob_pt])
    if offset_bits > 0:
        bit = 1 if (eob_extra & (1 << (offset_bits - 1))) else 0
        cost += int(eob_extra_costs[eob_pt][bit])
        if offset_bits > 1:
            cost += _BIT * (offset_bits - 1)
    return cost


def _golomb_cost(abs_qc: int) -> int:
    if abs_qc >= 1 + NUM_BASE_LEVELS + COEFF_BASE_RANGE:
        r = abs_qc - COEFF_BASE_RANGE - NUM_BASE_LEVELS
        return _BIT * (2 * (r.bit_length()) - 1)
    return 0


def _br_cost(level: int, lps_row) -> int:
    base_range = min(level - 1 - NUM_BASE_LEVELS, COEFF_BASE_RANGE)
    return int(lps_row[base_range]) + _golomb_cost(level)


def _levels_buf(qc_flat: np.ndarray, w: int, h: int) -> np.ndarray:
    """|q| clamped to 127 in a (h+4) x (w+4) padded buffer
    (svt_av1_txb_init_levels layout: TX_PAD to the right/bottom)."""
    lv = np.zeros((h + 4, w + 4), np.uint8)
    lv[:h, :w] = np.minimum(np.abs(qc_flat.reshape(h, w)), 127)
    return lv


def _lower_levels_ctx(lv, pos, bwl, w, h, tx_class, shape) -> int:
    """get_lower_levels_ctx == the base-symbol nz ctx used when coding
    (coeffs.py nz ctx; ec_core.h nz_map_ctx is_eob=0)."""
    row, col = pos >> bwl, pos & ((1 << bwl) - 1)
    stride = w + 4
    flat = lv.ravel()
    p = row * stride + col
    c3 = lambda v: min(int(v), 3)
    mag = c3(flat[p + 1]) + c3(flat[p + stride])
    if tx_class == TX_CLASS_2D:
        mag += c3(flat[p + stride + 1]) + c3(flat[p + 2]) \
            + c3(flat[p + 2 * stride])
    elif tx_class == TX_CLASS_VERT:
        mag += c3(flat[p + 2 * stride]) + c3(flat[p + 3 * stride]) \
            + c3(flat[p + 4 * stride])
    else:
        mag += c3(flat[p + 2]) + c3(flat[p + 3]) + c3(flat[p + 4])
    if (tx_class | pos) == 0:
        return 0
    ctx = min((mag + 1) >> 1, 4)
    if tx_class == TX_CLASS_2D:
        if shape == 1 and row < 2:
            off = 11
        elif shape == 2 and col < 2:
            off = 16
        elif row + col < 2:
            off = 1
        elif row + col < 4:
            off = 6
        else:
            off = 21
        return ctx + off
    idx = col if tx_class == TX_CLASS_HORIZ else row
    return ctx + (26 if idx == 0 else (31 if idx == 1 else 36))


def _lower_levels_ctx_eob(bwl, h, si) -> int:
    if si == 0:
        return 0
    if si <= (h << bwl) // 8:
        return 1
    if si <= (h << bwl) // 4:
        return 2
    return 3


def _br_ctx(lv, pos, bwl, w, tx_class) -> int:
    row, col = pos >> bwl, pos & ((1 << bwl) - 1)
    stride = w + 4
    flat = lv.ravel()
    p = row * stride + col
    mag = int(flat[p + 1]) + int(flat[p + stride])
    if tx_class == TX_CLASS_2D:
        mag += int(flat[p + stride + 1])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        if row < 2 and col < 2:
            return mag + 7
    elif tx_class == TX_CLASS_HORIZ:
        mag += int(flat[p + 2])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        if col == 0:
            return mag + 7
    else:
        mag += int(flat[p + 2 * stride])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        if row == 0:
            return mag + 7
    return mag + 14


def _br_ctx_eob(pos, bwl, tx_class) -> int:
    """get_br_ctx_eob."""
    row, col = pos >> bwl, pos & ((1 << bwl) - 1)
    if pos == 0:
        return 0
    if (tx_class == TX_CLASS_2D and row < 2 and col < 2) \
            or (tx_class == TX_CLASS_HORIZ and col == 0) \
            or (tx_class == TX_CLASS_VERT and row == 0):
        return 7
    return 14


def _coeff_cost_general(is_last, pos, abs_qc, sign, coeff_ctx,
                        tabs, bwl, w, tx_class, lv) -> int:
    base_eob, base, dc_sign, lps = tabs
    if is_last:
        cost = int(base_eob[coeff_ctx][min(abs_qc, 3) - 1])
    else:
        cost = int(base[coeff_ctx][min(abs_qc, 3)])
    if abs_qc != 0:
        if pos == 0:
            cost += int(dc_sign[sign])
        else:
            cost += _BIT
        if abs_qc > NUM_BASE_LEVELS:
            bc = _br_ctx_eob(pos, bwl, tx_class) if is_last \
                else _br_ctx(lv, pos, bwl, w, tx_class)
            cost += _br_cost(abs_qc, lps[bc])
    return cost


def _coeff_dist(tqc: int, dqc: int, shift: int) -> int:
    d = (int(tqc) - int(dqc)) << shift
    return d * d


def _rdcost(rdmult: int, rate: int, dist: int) -> int:
    """RDCOST (EbRateDistortionCost.h:106): RDDIV_BITS=7."""
    return ((rate * rdmult + (1 << (AV1_PROB_COST_SHIFT - 1)))
            >> AV1_PROB_COST_SHIFT) + (dist << 7)


def optimize_txb(tcoeff, qc, dqc, eob: int, scan, cw: int, ch: int,
                 tx_class: int, shift: int, dequant, rdmult: int,
                 tabs_ts_pl, eob_tabs, shape: int) -> int:
    """The trellis over one txb (svt_av1_optimize_b, sharpness 0, no
    fast modes).  tcoeff/qc/dqc: [ch][cw] int arrays over the CODED
    coefficient region (qc and dqc are modified in place); dequant:
    (dc, ac) log_scale-adjusted values matching quantize_b's dq output
    domain; rdmult: the plane-scaled value ((lambda*plane_rd_mult+2)>>2).
    Returns the (possibly reduced) eob."""
    if eob <= 0:
        return eob
    txb_skip, base_eob, base, eob_extra, dc_sign, lps = tabs_ts_pl
    tabs = (base_eob, base, dc_sign, lps)
    w, h = cw, ch
    bwl = w.bit_length() - 1
    tq = tcoeff.ravel()
    q = qc.ravel()
    dq = dqc.ravel()
    non_skip_cost = int(txb_skip[0])
    skip_cost = int(txb_skip[1])
    eob_cost0 = _get_eob_cost(eob, eob_tabs, eob_extra, tx_class)
    lv = _levels_buf(q, w, h)

    accu_rate = eob_cost0
    accu_dist = 0
    si = eob - 1
    pos = int(scan[si])
    abs_qc = abs(int(q[pos]))
    max_nz_num = 2
    nz_num = 1
    nz_ci = [pos, 0, 0]

    def upd_general(si, dummy_dist=False):
        nonlocal accu_rate, accu_dist
        dqv = int(dequant[si != 0])
        pos = int(scan[si])
        qcv = int(q[pos])
        is_last = si == eob_state[0] - 1
        coeff_ctx = (_lower_levels_ctx_eob(bwl, h, si) if is_last
                     else _lower_levels_ctx(lv, pos, bwl, w, h, tx_class,
                                            shape))
        if qcv == 0:
            accu_rate += int(base[coeff_ctx][0])
            return
        sign = 1 if qcv < 0 else 0
        abs_qc = abs(qcv)
        tqc = int(tq[pos])
        dqcv = int(dq[pos])
        dist = _coeff_dist(tqc, dqcv, shift)
        dist0 = _coeff_dist(tqc, 0, shift)
        rate = _coeff_cost_general(is_last, pos, abs_qc, sign, coeff_ctx, tabs, bwl, w, tx_class, lv)
        rd = _rdcost(rdmult, rate, dist)
        if abs_qc == 1:
            abs_qc_low = 0
            qc_low = dqc_low = 0
            dist_low = dist0
            rate_low = int(base[coeff_ctx][0])
        else:
            abs_qc_low = abs_qc - 1
            abs_dqc_low = (abs_qc_low * dqv) >> shift
            qc_low = -abs_qc_low if sign else abs_qc_low
            dqc_low = -abs_dqc_low if sign else abs_dqc_low
            dist_low = _coeff_dist(tqc, dqc_low, shift)
            rate_low = _coeff_cost_general(is_last, pos, abs_qc_low, sign, coeff_ctx,
                tabs, bwl, w, tx_class, lv)
        rd_low = _rdcost(rdmult, rate_low, dist_low)
        if rd_low < rd:
            q[pos] = qc_low
            dq[pos] = dqc_low
            lv[pos >> bwl, pos & (w - 1)] = min(abs_qc_low, 127)
            accu_rate += rate_low
            if not dummy_dist:
                accu_dist += dist_low - dist0
        else:
            accu_rate += rate
            if not dummy_dist:
                accu_dist += dist - dist0

    eob_state = [eob]

    if abs_qc >= 2:
        upd_general(si)
        si -= 1
    else:
        coeff_ctx = _lower_levels_ctx_eob(bwl, h, si)
        sign = 1 if int(q[pos]) < 0 else 0
        accu_rate += _coeff_cost_general(True, pos, abs_qc, sign, coeff_ctx, tabs, bwl, w,
                                         tx_class, lv)
        tqc, dqcv = int(tq[pos]), int(dq[pos])
        accu_dist += _coeff_dist(tqc, dqcv, shift) \
            - _coeff_dist(tqc, 0, shift)
        si -= 1

    # --- update_coeff_eob while few nonzeros seen ----------------------
    while si >= 0 and nz_num <= max_nz_num:
        dqv = int(dequant[si != 0])
        pos = int(scan[si])
        qcv = int(q[pos])
        coeff_ctx = _lower_levels_ctx(lv, pos, bwl, w, h, tx_class, shape)
        if qcv == 0:
            accu_rate += int(base[coeff_ctx][0])
            si -= 1
            continue
        lower_level = 0
        abs_qc = abs(qcv)
        tqc = int(tq[pos])
        dqcv = int(dq[pos])
        sign = 1 if qcv < 0 else 0
        dist0 = _coeff_dist(tqc, 0, shift)
        dist = _coeff_dist(tqc, dqcv, shift) - dist0
        rate = _coeff_cost_general(False, pos, abs_qc, sign, coeff_ctx, tabs, bwl, w, tx_class, lv)
        rd = _rdcost(rdmult, accu_rate + rate, accu_dist + dist)

        if abs_qc == 1:
            abs_qc_low = 0
            qc_low = dqc_low = 0
            dist_low = 0
            rate_low = int(base[coeff_ctx][0])
            rd_low = _rdcost(rdmult, accu_rate + rate_low, accu_dist)
        else:
            abs_qc_low = abs_qc - 1
            abs_dqc_low = (abs_qc_low * dqv) >> shift
            qc_low = -abs_qc_low if sign else abs_qc_low
            dqc_low = -abs_dqc_low if sign else abs_dqc_low
            dist_low = _coeff_dist(tqc, dqc_low, shift) - dist0
            rate_low = _coeff_cost_general(False, pos, abs_qc_low, sign, coeff_ctx,
                tabs, bwl, w, tx_class, lv)
            rd_low = _rdcost(rdmult, accu_rate + rate_low,
                             accu_dist + dist_low)

        lower_level_new_eob = 0
        new_eob = si + 1
        ctx_new_eob = _lower_levels_ctx_eob(bwl, h, si)
        new_eob_cost = _get_eob_cost(new_eob, eob_tabs, eob_extra, tx_class)
        rate_coeff_eob = new_eob_cost + _coeff_cost_general(True, pos, abs_qc, sign, ctx_new_eob, tabs,
            bwl, w, tx_class, lv)
        dist_new_eob = dist
        rd_new_eob = _rdcost(rdmult, rate_coeff_eob, dist_new_eob)

        if abs_qc_low > 0:
            rate_eob_low = new_eob_cost + _coeff_cost_general(True, pos, abs_qc_low, sign, ctx_new_eob,
                tabs, bwl, w, tx_class, lv)
            rd_eob_low = _rdcost(rdmult, rate_eob_low, dist_low)
            if rd_eob_low < rd_new_eob:
                lower_level_new_eob = 1
                rd_new_eob = rd_eob_low
                rate_coeff_eob = rate_eob_low
                dist_new_eob = dist_low

        if rd_low < rd:
            lower_level = 1
            rd = rd_low
            rate = rate_low
            dist = dist_low

        if rd_new_eob < rd:
            for ni in range(nz_num):
                last = nz_ci[ni]
                lv[last >> bwl, last & (w - 1)] = 0
                q[last] = 0
                dq[last] = 0
            eob_state[0] = new_eob
            nz_num = 0
            accu_rate = rate_coeff_eob
            accu_dist = dist_new_eob
            lower_level = lower_level_new_eob
        else:
            accu_rate += rate
            accu_dist += dist

        if lower_level:
            q[pos] = qc_low
            dq[pos] = dqc_low
            lv[pos >> bwl, pos & (w - 1)] = min(abs_qc_low, 127)
        if q[pos]:
            nz_ci[nz_num] = pos
            nz_num += 1
        si -= 1

    if si == -1 and nz_num <= max_nz_num:
        # update_skip
        rd = _rdcost(rdmult, accu_rate + non_skip_cost, accu_dist)
        rd_skip = _rdcost(rdmult, skip_cost, 0)
        if rd_skip < rd:
            for ni in range(nz_num):
                q[nz_ci[ni]] = 0
                dq[nz_ci[ni]] = 0
            return 0
        return eob_state[0]

    # --- update_coeff_simple for the rest ------------------------------
    dqv_ac = int(dequant[1])
    while si >= 1:
        pos = int(scan[si])
        qcv = int(q[pos])
        coeff_ctx = _lower_levels_ctx(lv, pos, bwl, w, h, tx_class, shape)
        if qcv == 0:
            accu_rate += int(base[coeff_ctx][0])
            si -= 1
            continue
        abs_qc = abs(qcv)
        abs_tqc = abs(int(tq[pos]))
        abs_dqc = abs(int(dq[pos]))
        # get_two_coeff_cost_simple
        rate = int(base[coeff_ctx][min(abs_qc, 3)])
        diff = int(base[coeff_ctx][abs_qc + 4]) if abs_qc <= 3 else 0
        if abs_qc:
            rate += _BIT
            if abs_qc > NUM_BASE_LEVELS:
                bc = _br_ctx(lv, pos, bwl, w, tx_class)
                base_range = min(abs_qc - 1 - NUM_BASE_LEVELS,
                                 COEFF_BASE_RANGE)
                golomb = 0
                if abs_qc <= COEFF_BASE_RANGE + 1 + NUM_BASE_LEVELS:
                    diff += int(lps[bc][base_range + COEFF_BASE_RANGE + 1])
                if abs_qc >= COEFF_BASE_RANGE + 1 + NUM_BASE_LEVELS:
                    r = abs_qc - COEFF_BASE_RANGE - NUM_BASE_LEVELS
                    golomb = _BIT * (2 * r.bit_length() - 1)
                    # golomb_cost_diff tables (EbFullLoop.c:838): one
                    # extra bit entering golomb (r==1), two more at
                    # every power-of-two length step
                    if r == 1:
                        diff += _BIT
                    elif (r & (r - 1)) == 0:
                        diff += _BIT * 2
                rate += int(lps[bc][base_range]) + golomb
        rate_low = rate - diff
        if abs_dqc < abs_tqc:
            accu_rate += rate
            si -= 1
            continue
        dist = _coeff_dist(abs_tqc, abs_dqc, shift)
        rd = _rdcost(rdmult, rate, dist)
        abs_qc_low = abs_qc - 1
        abs_dqc_low = (abs_qc_low * dqv_ac) >> shift
        dist_low = _coeff_dist(abs_tqc, abs_dqc_low, shift)
        rd_low = _rdcost(rdmult, rate_low, dist_low)
        if rd_low < rd:
            sign = 1 if qcv < 0 else 0
            q[pos] = -abs_qc_low if sign else abs_qc_low
            dq[pos] = -abs_dqc_low if sign else abs_dqc_low
            lv[pos >> bwl, pos & (w - 1)] = min(abs_qc_low, 127)
            accu_rate += rate_low
        else:
            accu_rate += rate
        si -= 1

    if si == 0:
        upd_general(si, dummy_dist=True)

    return eob_state[0]
