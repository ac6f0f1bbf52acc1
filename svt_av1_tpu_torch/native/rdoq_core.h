/*
 * Trellis coefficient optimizer (pure C twin of ops/rdoq.py; behavioral
 * parity with svt_av1_optimize_b, EbFullLoop.c:1190, at rdoq_level 1:
 * full trellis, sharpness 0, no fast-eob modes).
 *
 * Bit-identical to the Python port (tests/test_rdoq.py).  The rate
 * tables arrive prebuilt from Python (ops/rdoq.build_tables) in
 * 1/512-bit units; this header only implements the per-txb recurrence.
 *
 * Context helpers (nz ctx / br ctx) intentionally mirror ec_core.h's
 * coder-side forms so the optimizer prices exactly what the coder will
 * write.
 */
#ifndef SVT_TPU_RDOQ_CORE_H
#define SVT_TPU_RDOQ_CORE_H

#include <stdint.h>
#include <string.h>

#define RDOQ_BIT 512
#define RDOQ_NUM_BASE_LEVELS 2
#define RDOQ_COEFF_BASE_RANGE 12

/* per-(txs_ctx, plane_type) slices of the frame rate tables + per-call
 * contexts; all costs int32 in 1/512-bit units */
typedef struct {
    const int32_t *txb_skip;   /* [2]  (this ctx) */
    const int32_t *base_eob;   /* [4][3] */
    const int32_t *base;       /* [42][8] */
    const int32_t *eob_extra;  /* [22][2] (indexed by eob_pt) */
    const int32_t *dc_sign;    /* [2]  (this ctx) */
    const int32_t *lps;        /* [21][26] */
    const int32_t *eob_cost;   /* [2][11] (this ems, plane) */
    int64_t rdmult;            /* plane-scaled ((lambda*mult+2)>>2) */
    int tx_class;              /* 0 2D / 1 horiz / 2 vert */
    int shape;                 /* 0 square / 1 tall / 2 wide (TRUE dims) */
    int use_fp;                /* quantize_fp feeds the trellis */
} RdoqRun;

static const int16_t rdoq_eob_group_start[12] =
    {0, 1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513};
static const int16_t rdoq_eob_offset_bits[12] =
    {0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9};
static const uint8_t rdoq_eob_to_pos_small[33] = {
    0, 1, 2, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5,
    6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6};
static const uint8_t rdoq_eob_to_pos_large[17] = {
    6, 7, 8, 8, 9, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10, 11};

static int rdoq_msb(int v) {
    int b = 0;
    while (v > 1) { v >>= 1; ++b; }
    return b;
}

static int rdoq_eob_cost(const RdoqRun *rr, int eob) {
    int eob_pt, eob_extra;
    if (eob < 33) eob_pt = rdoq_eob_to_pos_small[eob];
    else {
        int t = (eob - 1) >> 5;
        eob_pt = rdoq_eob_to_pos_large[t > 16 ? 16 : t];
    }
    eob_extra = eob - rdoq_eob_group_start[eob_pt];
    int ctx = rr->tx_class == 0 ? 0 : 1;
    int cost = rr->eob_cost[ctx * 11 + (eob_pt - 1)];
    int offset_bits = rdoq_eob_offset_bits[eob_pt];
    if (offset_bits > 0) {
        int bit = (eob_extra & (1 << (offset_bits - 1))) ? 1 : 0;
        cost += rr->eob_extra[eob_pt * 2 + bit];
        if (offset_bits > 1) cost += RDOQ_BIT * (offset_bits - 1);
    }
    return cost;
}

static int rdoq_golomb_cost(int abs_qc) {
    if (abs_qc >= 1 + RDOQ_NUM_BASE_LEVELS + RDOQ_COEFF_BASE_RANGE) {
        int r = abs_qc - RDOQ_COEFF_BASE_RANGE - RDOQ_NUM_BASE_LEVELS;
        return RDOQ_BIT * (2 * (rdoq_msb(r) + 1) - 1);
    }
    return 0;
}

static int rdoq_br_cost(int level, const int32_t *lps_row) {
    int base_range = level - 1 - RDOQ_NUM_BASE_LEVELS;
    if (base_range > RDOQ_COEFF_BASE_RANGE)
        base_range = RDOQ_COEFF_BASE_RANGE;
    return lps_row[base_range] + rdoq_golomb_cost(level);
}

static inline int rdoq_c3(int v) { return v < 3 ? v : 3; }

/* get_lower_levels_ctx == coder-side nz ctx (ec_core.h nz_map_ctx,
 * is_eob=0); lv: (h+4)x(w+4) level buffer, stride w+4 */
static int rdoq_ll_ctx(const uint8_t *lv, int pos, int bwl, int w,
                       int tx_class, int shape) {
    int row = pos >> bwl, col = pos - (row << bwl);
    int stride = w + 4;
    const uint8_t *p = lv + row * stride + col;
    int mag = rdoq_c3(p[1]) + rdoq_c3(p[stride]);
    if (tx_class == 0)
        mag += rdoq_c3(p[stride + 1]) + rdoq_c3(p[2]) + rdoq_c3(p[2 * stride]);
    else if (tx_class == 2)
        mag += rdoq_c3(p[2 * stride]) + rdoq_c3(p[3 * stride])
            + rdoq_c3(p[4 * stride]);
    else
        mag += rdoq_c3(p[2]) + rdoq_c3(p[3]) + rdoq_c3(p[4]);
    if ((tx_class | pos) == 0) return 0;
    int ctx = (mag + 1) >> 1;
    if (ctx > 4) ctx = 4;
    if (tx_class == 0) {
        int off;
        if (shape == 1 && row < 2) off = 11;
        else if (shape == 2 && col < 2) off = 16;
        else if (row + col < 2) off = 1;
        else if (row + col < 4) off = 6;
        else off = 21;
        return ctx + off;
    }
    int idx = tx_class == 1 ? col : row;
    return ctx + (idx == 0 ? 26 : (idx == 1 ? 31 : 36));
}

static int rdoq_ll_ctx_eob(int bwl, int h, int si) {
    if (si == 0) return 0;
    if (si <= (h << bwl) / 8) return 1;
    if (si <= (h << bwl) / 4) return 2;
    return 3;
}

static int rdoq_br_ctx(const uint8_t *lv, int pos, int bwl, int w,
                       int tx_class) {
    int row = pos >> bwl, col = pos - (row << bwl);
    int stride = w + 4;
    const uint8_t *p = lv + row * stride + col;
    int mag = p[1] + p[stride];
    if (tx_class == 0) {
        mag += p[stride + 1];
        mag = (mag + 1) >> 1;
        if (mag > 6) mag = 6;
        if (pos == 0) return mag;
        if (row < 2 && col < 2) return mag + 7;
    } else if (tx_class == 1) {
        mag += p[2];
        mag = (mag + 1) >> 1;
        if (mag > 6) mag = 6;
        if (pos == 0) return mag;
        if (col == 0) return mag + 7;
    } else {
        mag += p[2 * stride];
        mag = (mag + 1) >> 1;
        if (mag > 6) mag = 6;
        if (pos == 0) return mag;
        if (row == 0) return mag + 7;
    }
    return mag + 14;
}

static int rdoq_br_ctx_eob(int pos, int bwl, int tx_class) {
    int row = pos >> bwl, col = pos - (row << bwl);
    if (pos == 0) return 0;
    if ((tx_class == 0 && row < 2 && col < 2) ||
        (tx_class == 1 && col == 0) || (tx_class == 2 && row == 0))
        return 7;
    return 14;
}

static int rdoq_coeff_cost_general(const RdoqRun *rr, int is_last, int pos,
                                   int abs_qc, int sign, int coeff_ctx,
                                   int bwl, int w, const uint8_t *lv) {
    int cost;
    if (is_last)
        cost = rr->base_eob[coeff_ctx * 3 +
                            ((abs_qc < 3 ? abs_qc : 3) - 1)];
    else
        cost = rr->base[coeff_ctx * 8 + (abs_qc < 3 ? abs_qc : 3)];
    if (abs_qc != 0) {
        if (pos == 0) cost += rr->dc_sign[sign];
        else cost += RDOQ_BIT;
        if (abs_qc > RDOQ_NUM_BASE_LEVELS) {
            int bc = is_last ? rdoq_br_ctx_eob(pos, bwl, rr->tx_class)
                             : rdoq_br_ctx(lv, pos, bwl, w, rr->tx_class);
            cost += rdoq_br_cost(abs_qc, rr->lps + bc * 26);
        }
    }
    return cost;
}

static inline int64_t rdoq_dist(int64_t tqc, int64_t dqc, int shift) {
    int64_t d = (tqc - dqc) << shift;
    return d * d;
}

static inline int64_t rdoq_rdcost(int64_t rdmult, int64_t rate,
                                  int64_t dist) {
    return ((rate * rdmult + 256) >> 9) + (dist << 7);
}

/*
 * The trellis over one txb.  tq/q/dq: [ch][cw] coded-region arrays
 * (row-major, contiguous; q and dq are modified).  scan: [n] positions
 * over the same region.  dequant: {dc, ac} raw table values; shift =
 * av1_get_tx_scale.  Returns the (possibly reduced) eob.
 */
static int rdoq_optimize_txb(const RdoqRun *rr, const int32_t *tq,
                             int32_t *q, int32_t *dq, int eob,
                             const int16_t *scan, int cw, int ch,
                             const int32_t dequant[2], int shift) {
    if (eob <= 0) return eob;
    int w = cw, h = ch;
    int bwl = rdoq_msb(w);
    int64_t rdmult = rr->rdmult;
    int non_skip_cost = rr->txb_skip[0];
    int skip_cost = rr->txb_skip[1];

    uint8_t lvbuf[(32 + 4) * (32 + 4)];
    memset(lvbuf, 0, sizeof(lvbuf));
    int stride = w + 4;
    for (int r = 0; r < h; ++r)
        for (int c = 0; c < w; ++c) {
            int32_t a = q[r * w + c];
            if (a < 0) a = -a;
            lvbuf[r * stride + c] = a > 127 ? 127 : (uint8_t)a;
        }

    int64_t accu_rate = rdoq_eob_cost(rr, eob);
    int64_t accu_dist = 0;
    int si = eob - 1;
    int cur_eob = eob;
    int max_nz_num = 2, nz_num = 1;
    int nz_ci[3] = {scan[si], 0, 0};

    /* ---- last coefficient (update_coeff_general / eob-coeff) ------- */
    {
        int pos = scan[si];
        int32_t qcv = q[pos];
        int abs_qc = qcv < 0 ? -qcv : qcv;
        int sign = qcv < 0;
        if (abs_qc >= 2) {
            int dqv = dequant[si != 0];
            int coeff_ctx = rdoq_ll_ctx_eob(bwl, h, si);
            int64_t tqc = tq[pos], dqcv = dq[pos];
            int64_t dist = rdoq_dist(tqc, dqcv, shift);
            int64_t dist0 = rdoq_dist(tqc, 0, shift);
            int rate = rdoq_coeff_cost_general(rr, 1, pos, abs_qc, sign,
                                               coeff_ctx, bwl, w, lvbuf);
            int64_t rd = rdoq_rdcost(rdmult, rate, dist);
            int abs_qc_low = abs_qc - 1;
            int abs_dqc_low = (abs_qc_low * dqv) >> shift;
            int32_t qc_low = sign ? -abs_qc_low : abs_qc_low;
            int32_t dqc_low = sign ? -abs_dqc_low : abs_dqc_low;
            int64_t dist_low = rdoq_dist(tqc, dqc_low, shift);
            int rate_low = rdoq_coeff_cost_general(
                rr, 1, pos, abs_qc_low, sign, coeff_ctx, bwl, w, lvbuf);
            int64_t rd_low = rdoq_rdcost(rdmult, rate_low, dist_low);
            if (rd_low < rd) {
                q[pos] = qc_low;
                dq[pos] = dqc_low;
                lvbuf[(pos >> bwl) * stride + (pos & (w - 1))] =
                    abs_qc_low > 127 ? 127 : abs_qc_low;
                accu_rate += rate_low;
                accu_dist += dist_low - dist0;
            } else {
                accu_rate += rate;
                accu_dist += dist - dist0;
            }
        } else {
            int coeff_ctx = rdoq_ll_ctx_eob(bwl, h, si);
            accu_rate += rdoq_coeff_cost_general(rr, 1, pos, abs_qc, sign,
                                                 coeff_ctx, bwl, w, lvbuf);
            int64_t tqc = tq[pos], dqcv = dq[pos];
            accu_dist += rdoq_dist(tqc, dqcv, shift)
                - rdoq_dist(tqc, 0, shift);
        }
        --si;
    }

    /* ---- update_coeff_eob while at most 2 nonzeros seen ------------ */
    for (; si >= 0 && nz_num <= max_nz_num; --si) {
        int dqv = dequant[si != 0];
        int pos = scan[si];
        int32_t qcv = q[pos];
        int coeff_ctx = rdoq_ll_ctx(lvbuf, pos, bwl, w, rr->tx_class,
                                    rr->shape);
        if (qcv == 0) {
            accu_rate += rr->base[coeff_ctx * 8 + 0];
            continue;
        }
        int lower_level = 0;
        int abs_qc = qcv < 0 ? -qcv : qcv;
        int sign = qcv < 0;
        int64_t tqc = tq[pos], dqcv = dq[pos];
        int64_t dist0 = rdoq_dist(tqc, 0, shift);
        int64_t dist = rdoq_dist(tqc, dqcv, shift) - dist0;
        int rate = rdoq_coeff_cost_general(rr, 0, pos, abs_qc, sign,
                                           coeff_ctx, bwl, w, lvbuf);
        int64_t rd = rdoq_rdcost(rdmult, accu_rate + rate,
                                 accu_dist + dist);

        int abs_qc_low;
        int32_t qc_low, dqc_low;
        int64_t dist_low, rd_low;
        int rate_low;
        if (abs_qc == 1) {
            abs_qc_low = 0;
            qc_low = dqc_low = 0;
            dist_low = 0;
            rate_low = rr->base[coeff_ctx * 8 + 0];
            rd_low = rdoq_rdcost(rdmult, accu_rate + rate_low, accu_dist);
        } else {
            abs_qc_low = abs_qc - 1;
            int abs_dqc_low = (abs_qc_low * dqv) >> shift;
            qc_low = sign ? -abs_qc_low : abs_qc_low;
            dqc_low = sign ? -abs_dqc_low : abs_dqc_low;
            dist_low = rdoq_dist(tqc, dqc_low, shift) - dist0;
            rate_low = rdoq_coeff_cost_general(
                rr, 0, pos, abs_qc_low, sign, coeff_ctx, bwl, w, lvbuf);
            rd_low = rdoq_rdcost(rdmult, accu_rate + rate_low,
                                 accu_dist + dist_low);
        }

        int lower_level_new_eob = 0;
        int new_eob = si + 1;
        int ctx_new_eob = rdoq_ll_ctx_eob(bwl, h, si);
        int new_eob_cost = rdoq_eob_cost(rr, new_eob);
        int rate_coeff_eob = new_eob_cost + rdoq_coeff_cost_general(
            rr, 1, pos, abs_qc, sign, ctx_new_eob, bwl, w, lvbuf);
        int64_t dist_new_eob = dist;
        int64_t rd_new_eob = rdoq_rdcost(rdmult, rate_coeff_eob,
                                         dist_new_eob);

        if (abs_qc_low > 0) {
            int rate_eob_low = new_eob_cost + rdoq_coeff_cost_general(
                rr, 1, pos, abs_qc_low, sign, ctx_new_eob, bwl, w, lvbuf);
            int64_t rd_eob_low = rdoq_rdcost(rdmult, rate_eob_low,
                                             dist_low);
            if (rd_eob_low < rd_new_eob) {
                lower_level_new_eob = 1;
                rd_new_eob = rd_eob_low;
                rate_coeff_eob = rate_eob_low;
                dist_new_eob = dist_low;
            }
        }

        if (rd_low < rd) {
            lower_level = 1;
            rd = rd_low;
            rate = rate_low;
            dist = dist_low;
        }

        if (rd_new_eob < rd) {
            for (int ni = 0; ni < nz_num; ++ni) {
                int last = nz_ci[ni];
                lvbuf[(last >> bwl) * stride + (last & (w - 1))] = 0;
                q[last] = 0;
                dq[last] = 0;
            }
            cur_eob = new_eob;
            nz_num = 0;
            accu_rate = rate_coeff_eob;
            accu_dist = dist_new_eob;
            lower_level = lower_level_new_eob;
        } else {
            accu_rate += rate;
            accu_dist += dist;
        }

        if (lower_level) {
            q[pos] = qc_low;
            dq[pos] = dqc_low;
            lvbuf[(pos >> bwl) * stride + (pos & (w - 1))] =
                abs_qc_low > 127 ? 127 : abs_qc_low;
        }
        if (q[pos]) {
            nz_ci[nz_num] = pos;
            ++nz_num;
        }
    }

    if (si == -1 && nz_num <= max_nz_num) {
        /* update_skip */
        int64_t rd = rdoq_rdcost(rdmult, accu_rate + non_skip_cost,
                                 accu_dist);
        int64_t rd_skip = rdoq_rdcost(rdmult, skip_cost, 0);
        if (rd_skip < rd) {
            for (int ni = 0; ni < nz_num; ++ni) {
                q[nz_ci[ni]] = 0;
                dq[nz_ci[ni]] = 0;
            }
            return 0;
        }
        return cur_eob;
    }

    /* ---- update_coeff_simple --------------------------------------- */
    for (; si >= 1; --si) {
        int pos = scan[si];
        int32_t qcv = q[pos];
        int coeff_ctx = rdoq_ll_ctx(lvbuf, pos, bwl, w, rr->tx_class,
                                    rr->shape);
        if (qcv == 0) {
            accu_rate += rr->base[coeff_ctx * 8 + 0];
            continue;
        }
        int abs_qc = qcv < 0 ? -qcv : qcv;
        int64_t abs_tqc = tq[pos] < 0 ? -(int64_t)tq[pos] : tq[pos];
        int64_t abs_dqc = dq[pos] < 0 ? -(int64_t)dq[pos] : dq[pos];
        /* get_two_coeff_cost_simple */
        int rate = rr->base[coeff_ctx * 8 + (abs_qc < 3 ? abs_qc : 3)];
        int diff = abs_qc <= 3 ? rr->base[coeff_ctx * 8 + abs_qc + 4] : 0;
        if (abs_qc) {
            rate += RDOQ_BIT;
            if (abs_qc > RDOQ_NUM_BASE_LEVELS) {
                int bc = rdoq_br_ctx(lvbuf, pos, bwl, w, rr->tx_class);
                int base_range = abs_qc - 1 - RDOQ_NUM_BASE_LEVELS;
                if (base_range > RDOQ_COEFF_BASE_RANGE)
                    base_range = RDOQ_COEFF_BASE_RANGE;
                int golomb = 0;
                if (abs_qc <= RDOQ_COEFF_BASE_RANGE + 1
                              + RDOQ_NUM_BASE_LEVELS)
                    diff += rr->lps[bc * 26 + base_range
                                    + RDOQ_COEFF_BASE_RANGE + 1];
                if (abs_qc >= RDOQ_COEFF_BASE_RANGE + 1
                              + RDOQ_NUM_BASE_LEVELS) {
                    int r = abs_qc - RDOQ_COEFF_BASE_RANGE
                        - RDOQ_NUM_BASE_LEVELS;
                    golomb = RDOQ_BIT * (2 * (rdoq_msb(r) + 1) - 1);
                    if (r == 1) diff += RDOQ_BIT;
                    else if ((r & (r - 1)) == 0) diff += RDOQ_BIT * 2;
                }
                rate += rr->lps[bc * 26 + base_range] + golomb;
            }
        }
        int rate_low = rate - diff;
        if (abs_dqc < abs_tqc) {
            accu_rate += rate;
            continue;
        }
        int64_t dist = rdoq_dist(abs_tqc, abs_dqc, shift);
        int64_t rd = rdoq_rdcost(rdmult, rate, dist);
        int abs_qc_low = abs_qc - 1;
        int64_t abs_dqc_low = ((int64_t)abs_qc_low * dequant[1]) >> shift;
        int64_t dist_low = rdoq_dist(abs_tqc, abs_dqc_low, shift);
        int64_t rd_low = rdoq_rdcost(rdmult, rate_low, dist_low);
        if (rd_low < rd) {
            int sign = qcv < 0;
            q[pos] = sign ? -abs_qc_low : abs_qc_low;
            dq[pos] = sign ? (int32_t)-abs_dqc_low : (int32_t)abs_dqc_low;
            lvbuf[(pos >> bwl) * stride + (pos & (w - 1))] =
                abs_qc_low > 127 ? 127 : abs_qc_low;
            accu_rate += rate_low;
        } else
            accu_rate += rate;
    }

    /* ---- DC position (rate only) ----------------------------------- */
    if (si == 0) {
        int dqv = dequant[0];
        int pos = scan[0];
        int32_t qcv = q[pos];
        int is_last = (cur_eob - 1 == 0);
        int coeff_ctx = is_last
            ? rdoq_ll_ctx_eob(bwl, h, 0)
            : rdoq_ll_ctx(lvbuf, pos, bwl, w, rr->tx_class, rr->shape);
        if (qcv != 0) {
            int sign = qcv < 0;
            int abs_qc = qcv < 0 ? -qcv : qcv;
            int64_t tqc = tq[pos], dqcv = dq[pos];
            int64_t dist = rdoq_dist(tqc, dqcv, shift);
            int rate = rdoq_coeff_cost_general(
                rr, is_last, pos, abs_qc, sign, coeff_ctx, bwl, w, lvbuf);
            int64_t rd = rdoq_rdcost(rdmult, rate, dist);
            int abs_qc_low;
            int32_t qc_low, dqc_low;
            int64_t dist_low;
            int rate_low;
            if (abs_qc == 1) {
                /* reference indexes base_cost even with the eob-variant
                 * ctx here (update_coeff_general, EbFullLoop.c:1013) */
                abs_qc_low = 0;
                qc_low = dqc_low = 0;
                dist_low = rdoq_dist(tqc, 0, shift);
                rate_low = rr->base[coeff_ctx * 8 + 0];
            } else {
                abs_qc_low = abs_qc - 1;
                int abs_dqc_low = (abs_qc_low * dqv) >> shift;
                qc_low = sign ? -abs_qc_low : abs_qc_low;
                dqc_low = sign ? -abs_dqc_low : abs_dqc_low;
                dist_low = rdoq_dist(tqc, dqc_low, shift);
                rate_low = rdoq_coeff_cost_general(
                    rr, is_last, pos, abs_qc_low, sign, coeff_ctx, bwl, w,
                    lvbuf);
            }
            int64_t rd_low = rdoq_rdcost(rdmult, rate_low, dist_low);
            if (rd_low < rd) {
                q[pos] = qc_low;
                dq[pos] = dqc_low;
            }
        }
    }

    return cur_eob;
}

#endif /* SVT_TPU_RDOQ_CORE_H */
