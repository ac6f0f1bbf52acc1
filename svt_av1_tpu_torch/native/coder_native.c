/*
 * Native intra tile coder: replays a precomputed frame plan (partition
 * tree + per-block modes from the batched TPU decision pass) through
 * the full conformant coding loop — intra prediction, fused
 * TX/quant/recon (block_core.h), and all tile syntax through the range
 * coder (ec_core.h) — in ONE C call per tile.
 *
 * This is the serial host stage of the TPU build (SURVEY §7: the one
 * native component mirroring the reference's encode-pass/entropy hot
 * loops, EbCodingLoop.c:1987 + EbEntropyCoding.c:6107).  Decisions are
 * made on the device; this replays them conformantly.  Behavior is
 * bit-identical to FrameCodec._walk_superblocks for the supported
 * feature envelope (key frames, 8..32px blocks, no segmentation/CfL/
 * filter-intra/TX-select), enforced by tests/test_native_coder.py.
 *
 * Behavioral parity references: partition/mode syntax write_modes_b
 * (EbEntropyCoding.c:5440), intra edge prep decode_build_intra_predictors
 * (EbDecIntraPrediction.c:302); the implementation is a port of this
 * repo's own Python (pipeline/frame_codec.py, ops/intra.py).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include "ec_core.h"
#include "block_core.h"

#define MI 4
#define P_NONE 0
#define P_HORZ 1
#define P_VERT 2
#define P_SPLIT 3

/* PredictionMode values (constants.py) */
#define M_DC 0
#define M_V 1
#define M_H 2
#define M_D45 3
#define M_D135 4
#define M_D113 5
#define M_D157 6
#define M_D203 7
#define M_D67 8
#define M_SMOOTH 9
#define M_SMOOTH_V 10
#define M_SMOOTH_H 11
#define M_PAETH 12

static const int MODE_ANGLE[13] = {0, 90, 180, 45, 135, 113, 157, 203, 67,
                                   0, 0, 0, 0};
static const int INTRA_MODE_CONTEXT[13] =
    {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};

typedef struct {          /* generic C-contiguous ndarray view */
    void *data;
    Py_ssize_t shape[4];
    int ndim;
} NB;

typedef struct {
    /* geometry */
    int mi_rows, mi_cols, t_r0, t_c0, t_r1, t_c1;
    int buf_w, buf_h, sb_size, bd, num_planes;
    int aligned_w, aligned_h, disable_edge_filter;
    /* planes: [0..2] src, [0..2] rec (int32, stride = plane buf width) */
    const int32_t *src[3];
    int32_t *rec[3];
    int pw_buf[3], ph_buf[3];      /* buffer dims per plane */
    /* context arrays */
    int32_t *y_modes, *skips, *above_part, *left_part;
    int32_t *txb_above[3], *txb_left[3];
    int32_t *txw[3], *txh[3];
    uint8_t *bex[3], *bey[3];
    int grid_w[3], grid_h[3];      /* tx grid dims per plane */
    /* cdfs */
    NB cdf_partition, cdf_skip, cdf_kf_y, cdf_angle, cdf_uv;
    NB cdf_txb_skip, cdf_eob_extra, cdf_base, cdf_base_eob, cdf_br,
       cdf_dc_sign, cdf_ext_tx, cdf_filter_intra;
    int enable_filter_intra;
    NB cdf_eob_flag[7];            /* 16..1024 */
    /* constant tables */
    const int32_t *sm_weights;     /* [128] */
    const int32_t *dr_derivative;  /* [90] */
    const uint8_t *has_tr[7], *has_bl[7];   /* size-pair tables */
    const int32_t *tx_w_tab, *tx_h_tab, *txs_ctx_tab, *tx_shape_tab,
                  *ems_tab;        /* [19] each */
    const int16_t *scans[19];      /* per tx size (2D class) */
    /* block plans [plane][ts][tt] */
    const Plan *plans[3][19][16];
    /* plan sequences */
    const int8_t *part_seq;
    Py_ssize_t part_n, part_i;
    const int32_t *mode_seq;       /* [n][16] */
    Py_ssize_t mode_n, mode_i;
    /* ec */
    EcCore ec;
    int cur_part;
    int err;
    char errmsg[160];
    void *inter;                   /* InterState* on inter frames */
    /* RDOQ (trellis) frame tables — NULL rdq_txb_skip = off */
    const int32_t *rdq_txb_skip;   /* [5][13][2] */
    const int32_t *rdq_base_eob;   /* [5][2][4][3] */
    const int32_t *rdq_base;       /* [5][2][42][8] */
    const int32_t *rdq_eob_extra;  /* [5][2][22][2] */
    const int32_t *rdq_dc_sign;    /* [2][3][2] */
    const int32_t *rdq_lps;        /* [5][2][21][26] */
    const int32_t *rdq_eob_cost;   /* [7][2][2][11] */
    long long rdq_lambda;          /* frame SSE lambda */
} Tile;

/* plane_rd_mult[is_inter][plane_type] (EbFullLoop.c) */
static const int rdq_plane_mult[2][2] = {{17, 13}, {16, 10}};

/* tx_type -> class (0 2D / 1 horiz / 2 vert) */
static const int8_t rdq_tt_class[16] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                        2, 1, 2, 1, 2, 1};

/* build the per-txb trellis descriptor; returns 0 when rdoq is off */
static int rdoq_run_for(Tile *t, int plane, int ts, int tt, int sk_ctx,
                        int dc_ctx, int is_inter, RdoqRun *rr) {
    if (!t->rdq_txb_skip) return 0;
    int ts_ctx = t->txs_ctx_tab[ts];
    int pt = plane > 0;
    int ems = t->ems_tab[ts];
    rr->txb_skip = t->rdq_txb_skip + ((Py_ssize_t)ts_ctx * 13 + sk_ctx) * 2;
    rr->base_eob = t->rdq_base_eob + ((Py_ssize_t)ts_ctx * 2 + pt) * 4 * 3;
    rr->base = t->rdq_base + ((Py_ssize_t)ts_ctx * 2 + pt) * 42 * 8;
    rr->eob_extra = t->rdq_eob_extra
        + ((Py_ssize_t)ts_ctx * 2 + pt) * 22 * 2;
    rr->dc_sign = t->rdq_dc_sign + ((Py_ssize_t)pt * 3 + dc_ctx) * 2;
    rr->lps = t->rdq_lps + ((Py_ssize_t)ts_ctx * 2 + pt) * 21 * 26;
    rr->eob_cost = t->rdq_eob_cost + ((Py_ssize_t)ems * 2 + pt) * 2 * 11;
    rr->rdmult = (t->rdq_lambda * rdq_plane_mult[is_inter][pt] + 2) >> 2;
    rr->tx_class = rdq_tt_class[tt & 15];
    rr->shape = t->tx_shape_tab[ts];
    rr->use_fp = 1;
    return 1;
}

static void tile_err(Tile *t, const char *msg) {
    if (!t->err) {
        t->err = 1;
        strncpy(t->errmsg, msg, sizeof(t->errmsg) - 1);
    }
}

static inline uint16_t *nb_row2(NB *b, int i) {
    return (uint16_t *)b->data + (Py_ssize_t)i * b->shape[1];
}
static inline uint16_t *nb_row3(NB *b, int i, int j) {
    return (uint16_t *)b->data + ((Py_ssize_t)i * b->shape[1] + j) * b->shape[2];
}
static inline uint16_t *nb_row4(NB *b, int i, int j, int k) {
    return (uint16_t *)b->data
        + (((Py_ssize_t)i * b->shape[1] + j) * b->shape[2] + k) * b->shape[3];
}

static inline int ilog2i(int v) { int r = 0; while (v > 1) { v >>= 1; ++r; } return r; }

/* ------------------------------------------------------------------ */
/* intra prediction (port of ops/intra.py + FrameCodec.predict)       */
/* ------------------------------------------------------------------ */

#define EDGE_MAX (2 * (64 + 64 + 16) + 4)

static int size_pair_idx(int bw, int bh) {
    static const int pairs[7][2] = {{8, 8}, {8, 16}, {16, 8}, {16, 16},
                                    {16, 32}, {32, 16}, {32, 32}};
    for (int i = 0; i < 7; ++i)
        if (pairs[i][0] == bw && pairs[i][1] == bh) return i;
    return -1;
}

static int has_top_right(Tile *t, int bw, int bh, int mi_row, int mi_col,
                         int top_available, int right_available, int txw,
                         int ss_x, int ss_y) {
    if (!top_available || !right_available) return 0;
    int bw_l = bw << ss_x, bh_l = bh << ss_y;
    int plane_bw_unit = (bw_l >> 2) >> ss_x;
    if (plane_bw_unit < 1) plane_bw_unit = 1;
    int tr_count = txw >> 2;
    /* row_off == col_off == 0 (single tx block per plane block) */
    if (0 + tr_count < plane_bw_unit) return 1;
    int bw_mi_log2 = ilog2i(bw_l >> 2);
    int bh_mi_log2 = ilog2i(bh_l >> 2);
    int sb_mi = t->sb_size >> 2;
    int blk_row_in_sb = (mi_row & (sb_mi - 1)) >> bh_mi_log2;
    int blk_col_in_sb = (mi_col & (sb_mi - 1)) >> bw_mi_log2;
    if (blk_row_in_sb == 0) return 1;
    if (((blk_col_in_sb + 1) << bw_mi_log2) >= sb_mi) return 0;
    int idx = (blk_row_in_sb << (5 - bw_mi_log2)) + blk_col_in_sb;
    int sp = size_pair_idx(bw_l, bh_l);
    if (sp < 0) { tile_err(t, "has_tr size"); return 0; }
    return (t->has_tr[sp][idx / 8] >> (idx % 8)) & 1;
}

static int has_bottom_left(Tile *t, int bw, int bh, int mi_row, int mi_col,
                           int bottom_available, int left_available, int txh,
                           int ss_x, int ss_y) {
    if (!bottom_available || !left_available) return 0;
    int bw_l = bw << ss_x, bh_l = bh << ss_y;
    int plane_bh_unit = (bh_l >> 2) >> ss_y;
    if (plane_bh_unit < 1) plane_bh_unit = 1;
    int bl_count = txh >> 2;
    if (0 + bl_count < plane_bh_unit) return 1;
    int bw_mi_log2 = ilog2i(bw_l >> 2);
    int bh_mi_log2 = ilog2i(bh_l >> 2);
    int sb_mi = t->sb_size >> 2;
    int blk_row_in_sb = (mi_row & (sb_mi - 1)) >> bh_mi_log2;
    int blk_col_in_sb = (mi_col & (sb_mi - 1)) >> bw_mi_log2;
    if (blk_col_in_sb == 0) {
        int blk_start_row_off = (blk_row_in_sb << bh_mi_log2) >> ss_y;
        int row_off_in_sb = blk_start_row_off + 0;
        int sb_height_unit = sb_mi >> ss_y;
        return row_off_in_sb + bl_count < sb_height_unit;
    }
    if (((blk_row_in_sb + 1) << bh_mi_log2) >= sb_mi) return 0;
    int idx = (blk_row_in_sb << (5 - bw_mi_log2)) + blk_col_in_sb;
    int sp = size_pair_idx(bw_l, bh_l);
    if (sp < 0) { tile_err(t, "has_bl size"); return 0; }
    return (t->has_bl[sp][idx / 8] >> (idx % 8)) & 1;
}

static int edge_filter_strength(int bs0, int bs1, int delta, int ftype) {
    int d = delta < 0 ? -delta : delta;
    int blk_wh = bs0 + bs1;
    if (ftype == 0) {
        if (blk_wh <= 8) return d >= 56 ? 1 : 0;
        if (blk_wh <= 16) return d >= 40 ? 1 : 0;
        if (blk_wh <= 24)
            return d >= 32 ? 3 : (d >= 16 ? 2 : (d >= 8 ? 1 : 0));
        if (blk_wh <= 32)
            return d >= 32 ? 3 : (d >= 4 ? 2 : (d >= 1 ? 1 : 0));
        return d >= 1 ? 3 : 0;
    }
    if (blk_wh <= 8) return d >= 64 ? 2 : (d >= 40 ? 1 : 0);
    if (blk_wh <= 16) return d >= 48 ? 2 : (d >= 20 ? 1 : 0);
    if (blk_wh <= 24) return d >= 4 ? 3 : 0;
    return d >= 1 ? 3 : 0;
}

static int use_edge_upsample(int bs0, int bs1, int delta, int ftype) {
    int d = delta < 0 ? -delta : delta;
    int blk_wh = bs0 + bs1;
    if (d <= 0 || d >= 40) return 0;
    return ftype ? (blk_wh <= 8) : (blk_wh <= 16);
}

/* in-place smoothing of p[0..sz-1] (svt_av1_filter_intra_edge_c port) */
static void filter_edge(int32_t *p, int sz, int strength) {
    static const int kernels[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0},
                                      {2, 4, 4, 4, 2}};
    if (!strength || sz <= 1) return;
    const int *k = kernels[strength - 1];
    int32_t e[EDGE_MAX + 4];
    for (int i = 0; i < sz; ++i) e[i + 2] = p[i];
    e[0] = e[1] = e[2];
    e[sz + 2] = e[sz + 3] = e[sz + 1];
    for (int i = 1; i < sz; ++i) {
        int s = 0;
        for (int j = 0; j < 5; ++j)
            if (k[j]) s += k[j] * e[j + i];
        p[i] = (s + 8) >> 4;
    }
}

/* upsample: in p (topleft at index 0, edge from 1); out gets C index i
 * at out[i + 2]; returns new offset 2.  n = number of edge samples. */
static void upsample_edge(const int32_t *p, int sz, int bd, int32_t *out) {
    int32_t src[EDGE_MAX + 3];
    src[0] = src[1] = p[0];
    for (int i = 0; i < sz; ++i) src[i + 2] = p[i + 1];
    src[sz + 2] = p[sz];
    int pmax = (1 << bd) - 1;
    out[0] = src[0];
    for (int i = 0; i < sz; ++i) {
        int s = -src[i] + 9 * src[i + 1] + 9 * src[i + 2] - src[i + 3];
        s = (s + 8) >> 4;
        out[2 * i + 1] = s < 0 ? 0 : (s > pmax ? pmax : s);
        out[2 * i + 2] = src[i + 2];
    }
    out[2 * sz + 1] = src[sz + 2];
}

/* Full normative intra prediction for one tx block.  Writes [h][w] into
 * pred (stride w). */
static void predict_intra(Tile *t, int plane, int mode, int angle_delta,
                          int px, int py, int w, int h, int fi_mode,
                          int filt_type, int32_t *pred) {
    const int32_t *rec = t->rec[plane];
    int stride = t->pw_buf[plane];
    int sub_x = plane ? 1 : 0, sub_y = plane ? 1 : 0;
    int plane_w = t->aligned_w >> sub_x;
    int plane_h = t->aligned_h >> sub_y;
    int bd = t->bd;

    int have_top = py > ((t->t_r0 * MI) >> sub_y);
    int have_left = px > ((t->t_c0 * MI) >> sub_x);
    int xr = plane_w - (px + w);
    int yd = plane_h - (py + h);
    int mi_row = (py << sub_y) / MI;
    int mi_col = (px << sub_x) / MI;
    int right_available = (mi_col + (((w >> 2) << sub_x))) < t->t_c1;
    int bottom_available = yd > 0 &&
        (mi_row + (((h >> 2) << sub_y))) < t->t_r1;

    int have_tr = has_top_right(t, w, h, mi_row, mi_col, have_top,
                                right_available, w, sub_x, sub_y);
    int have_bl = has_bottom_left(t, w, h, mi_row, mi_col, bottom_available,
                                  have_left, h, sub_x, sub_y);

    int n_top = have_top ? (w < xr + w ? w : xr + w) : 0;
    int n_topright = have_tr ? (w < xr ? w : xr) : 0;
    int n_left = have_left ? (h < yd + h ? h : yd + h) : 0;
    int n_bottomleft = have_bl ? (h < yd ? h : yd) : 0;

    /* numpy slice clipping at the buffer edge */
    if (have_top) {
        int avail = t->pw_buf[plane] - px;
        if (avail < n_top + n_topright) {
            n_topright = avail - n_top;
            if (n_topright < 0) n_topright = 0;
        }
    }

    const int32_t *above_ref = have_top ? rec + (py - 1) * stride + px : NULL;
    /* left_ref strided column at px-1 */
    int topleft_avail = have_top && have_left;
    int32_t topleft_px = topleft_avail ? rec[(py - 1) * stride + (px - 1)] : 0;

    int base = 128 << (bd - 8);

    /* mode needs */
    int is_dr = (mode >= M_V && mode <= M_D67);
    int p_angle = 0;
    int need_above, need_left, need_above_left, need_right, need_bottom;
    switch (mode) {
    case M_DC: need_above = 1; need_left = 1; need_above_left = 0; break;
    case M_V: need_above = 1; need_left = 0; need_above_left = 0; break;
    case M_H: need_above = 0; need_left = 1; need_above_left = 0; break;
    case M_SMOOTH: case M_SMOOTH_V: case M_SMOOTH_H:
        need_above = 1; need_left = 1; need_above_left = 0; break;
    case M_PAETH: need_above = 1; need_left = 1; need_above_left = 1; break;
    default: need_above = need_left = need_above_left = 0; break;
    }
    need_right = (mode == M_D45 || mode == M_D67);
    need_bottom = (mode == M_D203);
    if (is_dr) {
        p_angle = MODE_ANGLE[mode] + angle_delta * 3;
        if (p_angle <= 90) { need_above = 1; need_left = 0; need_above_left = 1; }
        else if (p_angle < 180) { need_above = 1; need_left = 1; need_above_left = 1; }
        else { need_above = 0; need_left = 1; need_above_left = 1; }
        need_right = p_angle < 90;
        need_bottom = p_angle > 180;
    }
    if (fi_mode >= 0) { tile_err(t, "filter-intra"); return; }

    if ((!need_above && n_left == 0) || (!need_left && n_top == 0)) {
        int32_t val;
        if (need_left)
            val = n_top > 0 ? above_ref[0] : base + 1;
        else
            val = n_left > 0 ? rec[py * stride + (px - 1)] : base - 1;
        for (int i = 0; i < w * h; ++i) pred[i] = val;
        return;
    }

    int32_t left_col[EDGE_MAX], above_row[EDGE_MAX];
    memset(left_col, 0, sizeof(left_col));
    memset(above_row, 0, sizeof(above_row));

    if (need_left) {
        int nb = need_bottom;
        int num_left = h + (nb ? w : 0);
        if (n_left > 0) {
            int i;
            for (i = 0; i < n_left; ++i)
                left_col[i] = rec[(py + i) * stride + (px - 1)];
            if (nb && n_bottomleft > 0) {
                int m = n_bottomleft < num_left - i ? n_bottomleft
                                                    : num_left - i;
                for (int k = 0; k < m; ++k)
                    left_col[i + k] = rec[(py + i + k) * stride + (px - 1)];
                i += m;
            }
            for (; i < num_left; ++i) left_col[i] = left_col[i - 1];
        } else {
            int32_t v = n_top > 0 ? above_ref[0] : base + 1;
            for (int i = 0; i < num_left; ++i) left_col[i] = v;
        }
    }

    if (need_above) {
        int nr = need_right;
        int num_top = w + (nr ? h : 0);
        if (n_top > 0) {
            int i;
            for (i = 0; i < n_top; ++i) above_row[i] = above_ref[i];
            if (nr && n_topright > 0) {
                int m = n_topright < num_top - w ? n_topright : num_top - w;
                for (int k = 0; k < m; ++k)
                    above_row[w + k] = above_ref[w + k];
                i = w + m;
            }
            for (; i < num_top; ++i) above_row[i] = above_row[i - 1];
        } else {
            int32_t v = n_left > 0 ? rec[py * stride + (px - 1)] : base - 1;
            for (int i = 0; i < num_top; ++i) above_row[i] = v;
        }
    }

    int32_t topleft;
    if (n_top > 0 && n_left > 0) topleft = topleft_px;
    else if (n_top > 0) topleft = above_ref[0];
    else if (n_left > 0) topleft = rec[py * stride + (px - 1)];
    else topleft = base;

    if (is_dr) {
        /* edge arrays with topleft at index 0 */
        int32_t ab[2 * EDGE_MAX + 4], lf[2 * EDGE_MAX + 4];
        ab[0] = topleft;
        memcpy(ab + 1, above_row, sizeof(above_row[0]) * (w + h + 14));
        lf[0] = topleft;
        memcpy(lf + 1, left_col, sizeof(left_col[0]) * (w + h + 14));
        int off_a = 1, off_l = 1;
        int upsample_above = 0, upsample_left = 0;
        if (!t->disable_edge_filter) {
            if (p_angle != 90 && p_angle != 180) {
                int ab_le = need_above_left ? 1 : 0;
                if (need_above && need_left && (w + h >= 24)) {
                    int32_t s = (lf[1] * 5 + ab[0] * 6 + ab[1] * 5 + 8) >> 4;
                    ab[0] = s;
                    lf[0] = s;
                }
                if (need_above && n_top > 0) {
                    int strength = edge_filter_strength(w, h, p_angle - 90,
                                                        filt_type);
                    int n_px = n_top + ab_le + (need_right ? h : 0);
                    filter_edge(ab + (1 - ab_le), n_px, strength);
                }
                if (need_left && n_left > 0) {
                    int strength = edge_filter_strength(h, w, p_angle - 180,
                                                        filt_type);
                    int n_px = n_left + ab_le + (need_bottom ? w : 0);
                    filter_edge(lf + (1 - ab_le), n_px, strength);
                }
            }
            upsample_above = use_edge_upsample(w, h, p_angle - 90, filt_type);
            if (need_above && upsample_above) {
                int n_px = w + (need_right ? h : 0);
                int32_t up[2 * EDGE_MAX + 4];
                upsample_edge(ab, n_px, bd, up);
                memcpy(ab, up, sizeof(int32_t) * (2 * n_px + 2));
                off_a = 2;
            }
            upsample_left = use_edge_upsample(h, w, p_angle - 180, filt_type);
            if (need_left && upsample_left) {
                int n_px = h + (need_bottom ? w : 0);
                int32_t up[2 * EDGE_MAX + 4];
                upsample_edge(lf, n_px, bd, up);
                memcpy(lf, up, sizeof(int32_t) * (2 * n_px + 2));
                off_l = 2;
            }
        }
        const int32_t *abe = ab + off_a;   /* C index 0 */
        const int32_t *lfe = lf + off_l;
        if (p_angle == 90) {
            for (int r = 0; r < h; ++r)
                for (int c = 0; c < w; ++c) pred[r * w + c] = abe[c];
            return;
        }
        if (p_angle == 180) {
            for (int r = 0; r < h; ++r)
                for (int c = 0; c < w; ++c) pred[r * w + c] = lfe[r];
            return;
        }
        const int32_t *dd = t->dr_derivative;
        int dx = 1, dy = 1;
        if (p_angle > 0 && p_angle < 90) dx = dd[p_angle];
        else if (p_angle > 90 && p_angle < 180) dx = dd[180 - p_angle];
        if (p_angle > 90 && p_angle < 180) dy = dd[p_angle - 90];
        else if (p_angle > 180 && p_angle < 270) dy = dd[270 - p_angle];
        if (p_angle < 90) {
            int ua = upsample_above;
            int max_base = ((w + h) - 1) << ua;
            int frac_bits = 6 - ua;
            for (int r = 0; r < h; ++r) {
                int x = (r + 1) * dx;
                for (int c = 0; c < w; ++c) {
                    int bpos = (x >> frac_bits) + (c << ua);
                    int shift = ((x << ua) & 0x3F) >> 1;
                    if (bpos >= max_base)
                        pred[r * w + c] = abe[max_base];
                    else {
                        int b1 = bpos + 1 > max_base ? max_base : bpos + 1;
                        pred[r * w + c] =
                            (abe[bpos] * (32 - shift) + abe[b1] * shift + 16)
                            >> 5;
                    }
                }
            }
            return;
        }
        if (p_angle > 180) {
            int ul = upsample_left;
            int max_base = ((w + h) - 1) << ul;
            int frac_bits = 6 - ul;
            for (int r = 0; r < h; ++r)
                for (int c = 0; c < w; ++c) {
                    int y = (c + 1) * dy;
                    int bpos = (y >> frac_bits) + (r << ul);
                    int shift = ((y << ul) & 0x3F) >> 1;
                    if (bpos >= max_base)
                        pred[r * w + c] = lfe[max_base];
                    else {
                        int b1 = bpos + 1 > max_base ? max_base : bpos + 1;
                        pred[r * w + c] =
                            (lfe[bpos] * (32 - shift) + lfe[b1] * shift + 16)
                            >> 5;
                    }
                }
            return;
        }
        /* z2: 90 < angle < 180; arrays with C index i at ptr[i + off] */
        {
            int ua = upsample_above, ul = upsample_left;
            int off_a2 = 1 << ua, off_l2 = 1 << ul;
            const int32_t *abz = ab + off_a - off_a2;   /* C index -off_a2 at [0] */
            const int32_t *lfz = lf + off_l - off_l2;
            int frac_x = 6 - ua, frac_y = 6 - ul;
            /* python clip limits: len(edge array) - off - 2; the array
               is the concat (w+h+17) or the upsampled 2*n_px+2 */
            int ab_len = upsample_above ? 2 * (w + (need_right ? h : 0)) + 2
                                        : w + h + 17;
            int lf_len = upsample_left ? 2 * (h + (need_bottom ? w : 0)) + 2
                                       : w + h + 17;
            for (int r = 0; r < h; ++r) {
                int x = -(r + 1) * dx;
                for (int c = 0; c < w; ++c) {
                    int base1 = (x >> frac_x) + (c << ua);
                    int shift1 = ((x * (1 << ua)) & 0x3F) >> 1;
                    int32_t val;
                    if (base1 >= -off_a2) {
                        int b1 = base1;
                        if (b1 > ab_len - off_a2 - 2) b1 = ab_len - off_a2 - 2;
                        val = (abz[b1 + off_a2] * (32 - shift1)
                               + abz[b1 + off_a2 + 1] * shift1 + 16) >> 5;
                    } else {
                        int y = (r << 6) - (c + 1) * dy;
                        int base2 = y >> frac_y;
                        int shift2 = ((y * (1 << ul)) & 0x3F) >> 1;
                        int b2 = base2;
                        if (b2 < -off_l2) b2 = -off_l2;
                        if (b2 > lf_len - off_l2 - 2) b2 = lf_len - off_l2 - 2;
                        val = (lfz[b2 + off_l2] * (32 - shift2)
                               + lfz[b2 + off_l2 + 1] * shift2 + 16) >> 5;
                    }
                    pred[r * w + c] = val;
                }
            }
            return;
        }
    }

    switch (mode) {
    case M_DC: {
        int64_t s = 0;
        int32_t dcv;
        if (n_top > 0 && n_left > 0) {
            for (int i = 0; i < w; ++i) s += above_row[i];
            for (int i = 0; i < h; ++i) s += left_col[i];
            dcv = (int32_t)((s + ((w + h) >> 1)) / (w + h));
        } else if (n_top > 0) {
            for (int i = 0; i < w; ++i) s += above_row[i];
            dcv = (int32_t)((s + (w >> 1)) / w);
        } else if (n_left > 0) {
            for (int i = 0; i < h; ++i) s += left_col[i];
            dcv = (int32_t)((s + (h >> 1)) / h);
        } else {
            dcv = base;
        }
        for (int i = 0; i < w * h; ++i) pred[i] = dcv;
        return;
    }
    case M_V:
        for (int r = 0; r < h; ++r)
            for (int c = 0; c < w; ++c) pred[r * w + c] = above_row[c];
        return;
    case M_H:
        for (int r = 0; r < h; ++r)
            for (int c = 0; c < w; ++c) pred[r * w + c] = left_col[r];
        return;
    case M_PAETH:
        for (int r = 0; r < h; ++r)
            for (int c = 0; c < w; ++c) {
                int32_t a = above_row[c], l = left_col[r], tl = topleft;
                int32_t bse = a + l - tl;
                int32_t pa = bse - a; if (pa < 0) pa = -pa;
                int32_t pl = bse - l; if (pl < 0) pl = -pl;
                int32_t ptl = bse - tl; if (ptl < 0) ptl = -ptl;
                pred[r * w + c] = (pa <= pl && pa <= ptl) ? a
                                  : (pl <= ptl ? l : tl);
            }
        return;
    case M_SMOOTH: {
        const int32_t *sw = t->sm_weights;
        int32_t below = left_col[h - 1], right = above_row[w - 1];
        for (int r = 0; r < h; ++r) {
            int32_t wh = sw[h + r];
            for (int c = 0; c < w; ++c) {
                int32_t ww = sw[w + c];
                int32_t v = above_row[c] * wh + below * (256 - wh)
                          + left_col[r] * ww + right * (256 - ww);
                pred[r * w + c] = (v + 256) >> 9;
            }
        }
        return;
    }
    case M_SMOOTH_V: {
        const int32_t *sw = t->sm_weights;
        int32_t below = left_col[h - 1];
        for (int r = 0; r < h; ++r) {
            int32_t wh = sw[h + r];
            for (int c = 0; c < w; ++c)
                pred[r * w + c] =
                    (above_row[c] * wh + below * (256 - wh) + 128) >> 8;
        }
        return;
    }
    case M_SMOOTH_H: {
        const int32_t *sw = t->sm_weights;
        int32_t right = above_row[w - 1];
        for (int r = 0; r < h; ++r)
            for (int c = 0; c < w; ++c) {
                int32_t ww = t->sm_weights[w + c];
                pred[r * w + c] =
                    (left_col[r] * ww + right * (256 - ww) + 128) >> 8;
            }
        return;
    }
    default:
        tile_err(t, "mode");
    }
}

/* edge-filter type: above/left neighbor y_mode smooth family */
static int filt_type_for(Tile *t, int plane, int px, int py) {
    int sub = plane ? 1 : 0;
    int mi_row = (py << sub) / MI;
    int mi_col = (px << sub) / MI;
    int ab = 0, le = 0;
    if (mi_row - 1 >= t->t_r0) {
        int m = t->y_modes[(Py_ssize_t)(mi_row - 1) * t->mi_cols + mi_col];
        ab = (m >= 9 && m <= 11);
    }
    if (mi_col - 1 >= t->t_c0) {
        int m = t->y_modes[(Py_ssize_t)mi_row * t->mi_cols + (mi_col - 1)];
        le = (m >= 9 && m <= 11);
    }
    return (ab || le) ? 1 : 0;
}

/* ------------------------------------------------------------------ */
/* residual + block syntax                                            */
/* ------------------------------------------------------------------ */

typedef struct {
    int plane, ts, tt, eob, px, py, w, h;
    int32_t qc[32 * 32];
} Txb;

static void txb_ctx_for(Tile *t, int plane, int px, int py, int ts,
                        int bsize_eq_tx, int *sk_ctx, int *dc_ctx) {
    const int32_t *above = t->txb_above[plane];
    const int32_t *left = t->txb_left[plane];
    int x4 = px >> 2, y4 = py >> 2;
    int plane_w = t->aligned_w >> (plane ? 1 : 0);
    int plane_h = t->aligned_h >> (plane ? 1 : 0);
    int tw4 = t->tx_w_tab[ts] >> 2, th4 = t->tx_h_tab[ts] >> 2;
    int wu = (plane_w - px) >> 2; if (tw4 < wu) wu = tw4;
    int hu = (plane_h - py) >> 2; if (th4 < hu) hu = th4;
    static const int signs[3] = {0, -1, 1};
    int dc_sign = 0;
    for (int k = 0; k < wu; ++k)
        dc_sign += signs[above[x4 + k] >> 6];
    for (int k = 0; k < hu; ++k)
        dc_sign += signs[left[y4 + k] >> 6];
    *dc_ctx = dc_sign > 0 ? 2 : (dc_sign < 0 ? 1 : 0);

    if (plane == 0) {
        if (bsize_eq_tx) { *sk_ctx = 0; return; }
        static const int skip_contexts[5][5] = {
            {1, 2, 2, 2, 3}, {1, 4, 4, 4, 5}, {1, 4, 4, 4, 5},
            {1, 4, 4, 4, 5}, {1, 4, 4, 4, 6}};
        int top = 0, lft = 0;
        for (int k = 0; k < wu; ++k) top |= above[x4 + k];
        for (int k = 0; k < hu; ++k) lft |= left[y4 + k];
        top &= 63;
        lft &= 63;
        int mx = top | lft; if (mx > 4) mx = 4;
        int mn = top < lft ? top : lft; if (mn > 4) mn = 4;
        *sk_ctx = skip_contexts[mn][mx];
        return;
    }
    int any_a = 0, any_l = 0;
    for (int k = 0; k < wu; ++k) if (above[x4 + k]) { any_a = 1; break; }
    for (int k = 0; k < hu; ++k) if (left[y4 + k]) { any_l = 1; break; }
    /* chroma blocks here always have tx == block (single txb) */
    *sk_ctx = any_a + any_l + 7;
}

static void update_txb_ctx(Tile *t, int plane, int px, int py, int ts,
                           int cul) {
    int x4 = px >> 2, y4 = py >> 2;
    int wu = t->tx_w_tab[ts] >> 2, hu = t->tx_h_tab[ts] >> 2;
    for (int k = 0; k < wu; ++k) t->txb_above[plane][x4 + k] = cul;
    for (int k = 0; k < hu; ++k) t->txb_left[plane][y4 + k] = cul;
}

static void record_tx_geometry(Tile *t, int plane, int px, int py, int ts) {
    int x4 = px >> 2, y4 = py >> 2;
    int w4 = t->tx_w_tab[ts] >> 2, h4 = t->tx_h_tab[ts] >> 2;
    int gw = t->grid_w[plane];
    for (int r = 0; r < h4; ++r)
        for (int c = 0; c < w4; ++c) {
            t->txw[plane][(Py_ssize_t)(y4 + r) * gw + x4 + c] = t->tx_w_tab[ts];
            t->txh[plane][(Py_ssize_t)(y4 + r) * gw + x4 + c] = t->tx_h_tab[ts];
        }
    for (int r = 0; r < h4; ++r)
        t->bex[plane][(Py_ssize_t)(y4 + r) * gw + x4] = 1;
    for (int c = 0; c < w4; ++c)
        t->bey[plane][(Py_ssize_t)y4 * gw + x4 + c] = 1;
}

/* write one txb's residual syntax (txb_skip + optional tx-type + coeffs) */
static void write_txb(Tile *t, Txb *x, int y_mode_ctx, int sk_ctx, int dc_ctx,
                      int sig_nset, int sig_eset, int sig_sq, int sig_ind) {
    int ts_ctx = t->txs_ctx_tab[x->ts];
    int plane_type = x->plane > 0;
    uint16_t *skip_cdf = nb_row3(&t->cdf_txb_skip, ts_ctx, sk_ctx);
    enc_symbol_adapt(&t->ec, x->eob == 0, skip_cdf, 2);
    if (x->eob == 0) {
        update_txb_ctx(t, x->plane, x->px, x->py, x->ts, 0);
        return;
    }
    if (x->plane == 0 && sig_nset > 1) {
        NB *b = &t->cdf_ext_tx;
        uint16_t *cdf = (uint16_t *)b->data
            + (((Py_ssize_t)sig_eset * b->shape[1] + sig_sq) * b->shape[2]
               + y_mode_ctx) * b->shape[3];
        enc_symbol_adapt(&t->ec, sig_ind, cdf, sig_nset);
    }
    int ems = t->ems_tab[x->ts];
    NB *ef = &t->cdf_eob_flag[ems];
    uint16_t *eob_cdf = nb_row3(ef, plane_type, 0);   /* eob_ctx 0 (2D) */
    int eob_pt;
    if (x->eob < 33) eob_pt = eob_to_pos_small[x->eob];
    else {
        int q = (x->eob - 1) >> 5;
        eob_pt = eob_to_pos_large[q > 16 ? 16 : q];
    }
    uint16_t *eob_extra_cdf = nb_row4(&t->cdf_eob_extra, ts_ctx, plane_type,
                                      eob_pt);
    uint16_t *base = nb_row4(&t->cdf_base, ts_ctx, plane_type, 0);
    uint16_t *base_eob = nb_row4(&t->cdf_base_eob, ts_ctx, plane_type, 0);
    int br_idx = ts_ctx < 3 ? ts_ctx : 3;
    uint16_t *br = nb_row4(&t->cdf_br, br_idx, plane_type, 0);
    uint16_t *dc_sign = nb_row3(&t->cdf_dc_sign, plane_type, dc_ctx);
    long long cul = ec_write_coeffs_core(
        &t->ec, x->qc, t->scans[x->ts], x->eob, x->w, x->h, TX_CLASS_2D,
        eob_cdf, eob_extra_cdf,
        base, (int)t->cdf_base.shape[3],
        base_eob, (int)t->cdf_base_eob.shape[3],
        br, (int)t->cdf_br.shape[3],
        dc_sign, t->tx_shape_tab[x->ts]);
    update_txb_ctx(t, x->plane, x->px, x->py, x->ts, (int)cul);
}

/* ------------------------------------------------------------------ */
/* block + partition walk                                             */
/* ------------------------------------------------------------------ */

static void tile_block_inter(Tile *t, int bw, int bh, int mi_row,
                             int mi_col);

static void tile_block(Tile *t, int bw, int bh, int mi_row, int mi_col) {
    if (t->err) return;
    if (t->inter) { tile_block_inter(t, bw, bh, mi_row, mi_col); return; }
    if (t->mode_i >= t->mode_n) { tile_err(t, "mode_seq exhausted"); return; }
    const int32_t *md = t->mode_seq + t->mode_i * 16;
    t->mode_i++;
    int y_mode = md[0], ad_y = md[1], uv_mode = md[2], ad_uv = md[3];
    int fi_mode = md[4];
    int ts_y = md[6], ts_uv = md[7], tt_y = md[8], tt_uv = md[9];
    int sig_nset = md[10], sig_eset = md[11], sig_sq = md[12],
        sig_ind = md[13];
    if (fi_mode >= 0 || uv_mode == 13) { tile_err(t, "fi/cfl"); return; }

    int x = mi_col * MI, y = mi_row * MI;
    int w4 = bw / MI, h4 = bh / MI;
    int up_avail = mi_row > t->t_r0;
    int left_avail = mi_col > t->t_c0;

    /* ---- compute all tx blocks (prediction + fused coding) ---- */
    Txb txbs[3];
    int n_txb = 0;
    int32_t pred[32 * 32], resid[32 * 32], rec[32 * 32];
    for (int plane = 0; plane < t->num_planes; ++plane) {
        int sub = plane ? 1 : 0;
        int px = x >> sub, py = y >> sub;
        int ts = plane == 0 ? ts_y : ts_uv;
        int tt = plane == 0 ? tt_y : tt_uv;
        int tw = t->tx_w_tab[ts], th = t->tx_h_tab[ts];
        int mode = plane == 0 ? y_mode : uv_mode;
        int ad = plane == 0 ? ad_y : ad_uv;
        int ftype = filt_type_for(t, plane, px, py);
        predict_intra(t, plane, mode, ad, px, py, tw, th, fi_mode,
                      ftype, pred);
        if (t->err) return;
        const int32_t *src = t->src[plane];
        int stride = t->pw_buf[plane];
        for (int r = 0; r < th; ++r)
            for (int c = 0; c < tw; ++c)
                resid[r * tw + c] =
                    src[(Py_ssize_t)(py + r) * stride + px + c]
                    - pred[r * tw + c];
        const Plan *plan = t->plans[plane][ts][tt];
        if (!plan) { tile_err(t, "missing plan"); return; }
        Txb *tb = &txbs[n_txb++];
        tb->plane = plane; tb->ts = ts; tb->tt = tt;
        tb->px = px; tb->py = py; tb->w = tw; tb->h = th;
        RdoqRun rr;
        int sk0, dc0;
        if (t->rdq_txb_skip) {
            /* ctx state here == write-time state: per-plane arrays, one
             * txb per plane per block */
            txb_ctx_for(t, plane, px, py, ts, 1, &sk0, &dc0);
            rdoq_run_for(t, plane, ts, tt, sk0, dc0, 0, &rr);
            tb->eob = block_code_core_rdoq(plan, resid, pred, tb->qc, rec,
                                           &rr);
        } else {
            tb->eob = block_code_core(plan, resid, pred, tb->qc, rec);
        }
        int32_t *rp = t->rec[plane];
        for (int r = 0; r < th; ++r)
            memcpy(rp + (Py_ssize_t)(py + r) * stride + px, rec + r * tw,
                   tw * sizeof(int32_t));
        record_tx_geometry(t, plane, px, py, ts);
    }
    int skip = 1;
    for (int i = 0; i < n_txb; ++i)
        if (txbs[i].eob) { skip = 0; break; }

    /* ---- mode syntax ---- */
    int skip_ctx = 0;
    if (up_avail)
        skip_ctx += t->skips[(Py_ssize_t)(mi_row - 1) * t->mi_cols + mi_col];
    if (left_avail)
        skip_ctx += t->skips[(Py_ssize_t)mi_row * t->mi_cols + (mi_col - 1)];
    enc_symbol_adapt(&t->ec, skip, nb_row2(&t->cdf_skip, skip_ctx), 2);

    int above_mode = up_avail
        ? t->y_modes[(Py_ssize_t)(mi_row - 1) * t->mi_cols + mi_col] : 0;
    int left_mode = left_avail
        ? t->y_modes[(Py_ssize_t)mi_row * t->mi_cols + (mi_col - 1)] : 0;
    uint16_t *kf_cdf = nb_row3(&t->cdf_kf_y, INTRA_MODE_CONTEXT[above_mode],
                               INTRA_MODE_CONTEXT[left_mode]);
    enc_symbol_adapt(&t->ec, y_mode, kf_cdf, 13);
    int use_delta = bw >= 8 && bh >= 8;    /* av1_use_angle_delta */
    if (use_delta && y_mode >= M_V && y_mode <= M_D67)
        enc_symbol_adapt(&t->ec, ad_y + 3,
                         nb_row2(&t->cdf_angle, y_mode - 1), 7);

    if (t->num_planes > 1) {
        int cfl_allowed = bw <= 32 && bh <= 32;
        uint16_t *uv_cdf = nb_row3(&t->cdf_uv, cfl_allowed, y_mode);
        enc_symbol_adapt(&t->ec, uv_mode, uv_cdf, cfl_allowed ? 14 : 13);
        if (use_delta && uv_mode >= M_V && uv_mode <= M_D67)
            enc_symbol_adapt(&t->ec, ad_uv + 3,
                             nb_row2(&t->cdf_angle, uv_mode - 1), 7);
    }

    /* filter_intra flag (plans never select it, so always 0) */
    if (t->enable_filter_intra && y_mode == M_DC && bw <= 32 && bh <= 32) {
        int bs_enum = md[14];
        enc_symbol_adapt(&t->ec, 0,
                         nb_row2(&t->cdf_filter_intra, bs_enum), 2);
    }

    /* record mode info */
    int r1 = mi_row + h4 < t->mi_rows ? mi_row + h4 : t->mi_rows;
    int c1 = mi_col + w4 < t->mi_cols ? mi_col + w4 : t->mi_cols;
    for (int r = mi_row; r < r1; ++r)
        for (int c = mi_col; c < c1; ++c) {
            t->y_modes[(Py_ssize_t)r * t->mi_cols + c] = y_mode;
            t->skips[(Py_ssize_t)r * t->mi_cols + c] = skip;
        }

    /* ---- residual syntax ---- */
    if (skip) {
        for (int i = 0; i < n_txb; ++i)
            update_txb_ctx(t, txbs[i].plane, txbs[i].px, txbs[i].py,
                           txbs[i].ts, 0);
        return;
    }
    for (int i = 0; i < n_txb; ++i) {
        Txb *tb = &txbs[i];
        int sk_ctx, dc_ctx;
        txb_ctx_for(t, tb->plane, tb->px, tb->py, tb->ts, 1, &sk_ctx,
                    &dc_ctx);
        write_txb(t, tb, y_mode, sk_ctx, dc_ctx,
                  tb->plane == 0 ? sig_nset : 0, sig_eset, sig_sq, sig_ind);
    }
}

static void part_ctx_set(Tile *t, int bw, int bh, int mi_col, int mi_row,
                         int w_mi, int h_mi) {
    int above = (31 << ilog2i(bw >> 2)) & 31;
    int left = (31 << ilog2i(bh >> 2)) & 31;
    for (int i = 0; i < w_mi; ++i) t->above_part[mi_col + i] = above;
    for (int i = 0; i < h_mi; ++i) t->left_part[mi_row + i] = left;
}

static void tile_partition(Tile *t, int bsize, int mi_row, int mi_col) {
    if (t->err) return;
    if (mi_row >= t->mi_rows || mi_col >= t->mi_cols) return;
    int bs_mi = bsize / MI;
    int hbs = bs_mi / 2;
    int has_rows = mi_row + hbs < t->mi_rows;
    int has_cols = mi_col + hbs < t->mi_cols;
    int part = P_NONE;
    if (bsize >= 8) {
        if (t->part_i >= t->part_n) { tile_err(t, "part_seq exhausted"); return; }
        part = t->part_seq[t->part_i++];
        /* _code_partition */
        int bsl = ilog2i(bsize >> 3);
        int above = (t->above_part[mi_col] >> bsl) & 1;
        int left = (t->left_part[mi_row] >> bsl) & 1;
        int ctx = (left * 2 + above) + bsl * 4;
        int n = bsize == 8 ? 4 : (bsize == 128 ? 8 : 10);
        uint16_t *cdf = nb_row2(&t->cdf_partition, ctx);
        if (!has_rows && !has_cols) {
            if (part != P_SPLIT) { tile_err(t, "boundary part"); return; }
            /* no symbol */
        } else if (has_rows && has_cols) {
            enc_symbol_adapt(&t->ec, part, cdf, n);
        } else {
            if (part != P_SPLIT) { tile_err(t, "boundary part"); return; }
            /* gather split-alike probability into a 2-symbol cdf */
            int items[6];
            int ni = 0;
            if (!has_rows) {   /* vert-alike gather */
                items[ni++] = 2; items[ni++] = 3; items[ni++] = 4;
                items[ni++] = 6; items[ni++] = 7;
                if (bsize != 128) items[ni++] = 9;
            } else {           /* !has_cols -> horz-alike gather */
                items[ni++] = 1; items[ni++] = 3; items[ni++] = 4;
                items[ni++] = 5; items[ni++] = 6;
                if (bsize != 128) items[ni++] = 8;
            }
            int top = 32768;
            for (int k = 0; k < ni; ++k) {
                int e = items[k];
                int prev = e == 0 ? 32768 : cdf[e - 1];
                top -= prev - cdf[e];
            }
            uint16_t g[3];
            g[0] = (uint16_t)(32768 - top);
            g[1] = 0;
            g[2] = 0;
            enc_symbol_adapt(&t->ec, 1, g, 2);
        }
    }
    int half = bsize / 2;

    switch (part) {
    case P_NONE:
        tile_block(t, bsize, bsize, mi_row, mi_col);
        part_ctx_set(t, bsize, bsize, mi_col, mi_row, bs_mi, bs_mi);
        break;
    case P_SPLIT:
        tile_partition(t, half, mi_row, mi_col);
        tile_partition(t, half, mi_row, mi_col + hbs);
        tile_partition(t, half, mi_row + hbs, mi_col);
        tile_partition(t, half, mi_row + hbs, mi_col + hbs);
        break;
    case P_HORZ:
        tile_block(t, bsize, half, mi_row, mi_col);
        if (has_rows)
            tile_block(t, bsize, half, mi_row + hbs, mi_col);
        part_ctx_set(t, bsize, half, mi_col, mi_row, bs_mi, bs_mi);
        break;
    case P_VERT:
        tile_block(t, half, bsize, mi_row, mi_col);
        if (has_cols)
            tile_block(t, half, bsize, mi_row, mi_col + hbs);
        part_ctx_set(t, half, bsize, mi_col, mi_row, bs_mi, bs_mi);
        break;
    default:
        tile_err(t, "partition kind");
    }
}

/* ================================================================== */
/* Inter-frame path: MV stack, MC, decision replay, inter syntax      */
/* (ports of pipeline/mv_pred.py find_mv_stack, ops/inter.py          */
/*  convolve_2d_sr, pipeline/batched_inter.py decide_inter and        */
/*  frame_codec._block_inter — single-reference preset-8 envelope:    */
/*  no compound, no motion modes, identity global motion)             */
/* ================================================================== */

#define MAX_REF_MV_STACK 8
#define MAX_MV_REF_CANDIDATES 2
#define MVREF_ROW_COLS 3
#define REF_CAT_LEVEL 640
#define MV_BORDER (16 << 3)
#define GLOBALMV_OFFSET 3
#define REFMV_OFFSET 4
#define NEWMV_CTX_MASK ((1 << GLOBALMV_OFFSET) - 1)
#define GLOBALMV_CTX_MASK ((1 << (REFMV_OFFSET - GLOBALMV_OFFSET)) - 1)
#define REFMV_CTX_MASK ((1 << (8 - REFMV_OFFSET)) - 1)
#define NEARESTMV 13
#define NEARMV 14
#define GLOBALMV_MODE 15
#define NEWMV 16
#define NEAREST_NEARESTMV_M 17
#define NEW_NEWMV 24   /* any NEW-bearing compound (has_newmv check) */

typedef struct {
    /* mi grid state (written as blocks code) */
    int32_t *mi_ref, *mi_ref1, *mi_mode, *mi_mvr, *mi_mvc;
    int32_t *mi_mv1r, *mi_mv1c, *mi_bw4, *mi_bh4;
    uint8_t *skip_grid[3];
    /* reference planes (padded by ref_pad), indexed by named ref 1..7 */
    const int32_t *ref_y[8], *ref_u[8], *ref_v[8];
    int ref_w[8], ref_h[8];           /* padded luma dims */
    int ref_cw[8], ref_ch[8];         /* padded chroma dims */
    int ref_pad;
    int frame_w, frame_h;             /* visible dims */
    /* decision maps (per shape) + per-16 MVs (1/8 pel) */
    const uint8_t *is_inter_map[10];  /* shapes: see SHAPE_LIST */
    const int8_t *mode_map[10];
    int map_w[10], map_h[10];
    const int32_t *mv16_r, *mv16_c;   /* [nr16][nc16] chosen/fwd MV */
    const int32_t *sel16, *fwd16, *bwd16;   /* per-16 selection fields */
    const int32_t *mv16_1r, *mv16_1c;       /* compound bwd MV */
    int32_t names[4];                 /* global ref index -> named ref */
    int n_names;
    int nc16;
    /* inter cdfs */
    NB cdf_intra_inter, cdf_single_ref, cdf_newmv, cdf_zeromv, cdf_refmv,
       cdf_drl, cdf_y_mode, cdf_inter_ext_tx, cdf_comp_inter,
       cdf_comp_ref_type, cdf_comp_ref, cdf_comp_bwdref,
       cdf_inter_compound;
    /* nmv cdfs: joints + per-comp arrays */
    uint16_t *nmv_joints;
    uint16_t *nmv_classes[2], *nmv_class0_fp[2], *nmv_fp[2], *nmv_sign[2],
             *nmv_class0_hp[2], *nmv_hp[2], *nmv_class0[2], *nmv_bits[2];
    /* per-ts signaling consts */
    const int32_t *sig_inter;         /* [19][4]: nset, eset, sq, ind_dct */
    const int32_t *sig_intra;         /* [19][4] */
    const int32_t *tt_uv_tab;         /* [19][13] chroma tt per uv mode */
    const int32_t *interp_taps;       /* [2][16][8] REGULAR kernels:
                                         8-tap table then 4-tap table */
    const int32_t *sign_bias;         /* [8] per named ref */
    int reference_select;
    int pen_q8;                       /* trial-penalty scale, q8 (the
                                         SAD-lambda ratio to qindex 160;
                                         batched_inter.selection_pens) */
} InterState;

static const int SHAPE_LIST[10][2] = {{8, 8}, {16, 16}, {32, 32}, {16, 8},
                                      {8, 16}, {32, 16}, {16, 32},
                                      {64, 64}, {64, 32}, {32, 64}};

static int shape_idx(int w, int h) {
    for (int i = 0; i < 10; ++i)
        if (SHAPE_LIST[i][0] == w && SHAPE_LIST[i][1] == h) return i;
    return -1;
}

static int bsize_enum_of(int bw, int bh) {
    static const int tab[10][3] = {{8, 8, 3}, {8, 16, 4}, {16, 8, 5},
                                   {16, 16, 6}, {16, 32, 7}, {32, 16, 8},
                                   {32, 32, 9}, {32, 64, 10}, {64, 32, 11},
                                   {64, 64, 12}};
    for (int i = 0; i < 10; ++i)
        if (tab[i][0] == bw && tab[i][1] == bh) return tab[i][2];
    return -1;
}

static const int SIZE_GROUP_BY_ENUM[22] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3,
                                           3, 3, 3, 3, 3, 0, 0, 1, 1, 2, 2};

/* ---- MV stack (find_mv_stack, single-ref, identity GM) ----------- */

typedef struct {
    int32_t mv[MAX_REF_MV_STACK][4];  /* r0,c0[,r1,c1] (compound pairs) */
    int32_t weight[MAX_REF_MV_STACK];
    int n;
    int mode_context;
    int32_t ref_list[2][2];           /* lowered-precision nearest/near */
} MvStack;

static int has_newmv_mode(int mode) {
    /* mv_pred.has_newmv: NEW-bearing modes only (16, 19..22, 24) —
     * NEAREST_NEAREST/NEAR_NEAR/GLOBAL_GLOBAL do not count */
    return mode == NEWMV || (mode >= 19 && mode <= 22) || mode == NEW_NEWMV;
}


/* find_mv_stack (mv_pred.py:80): ref1 > 0 selects the compound path
 * (stack entries become (mv0, mv1) pairs, dec_setup_ref_mv_list
 * compound branches); gm identity, no temporal MVs. */
static void mv_stack_find(Tile *t, InterState *st, int mi_row, int mi_col,
                          int bw4, int bh4, int ref, int ref1,
                          MvStack *out) {
    int mi_rows = t->mi_rows, mi_cols = t->mi_cols;
    int t_r0 = t->t_r0, t_c0 = t->t_c0, t_r1 = t->t_r1, t_c1 = t->t_c1;
    int sb_mi = t->sb_size / 4;
    int n = 0;
    int compound = ref1 > 0;
    int32_t smv[MAX_REF_MV_STACK][4];
    int32_t swt[MAX_REF_MV_STACK];
    int found_above = 0, found_left = 0, newmv_count = 0;
    Py_ssize_t S = mi_cols;

#define INSIDE(r, c) ((c) >= t_c0 && (c) < t_c1 && (r) >= t_r0 && (r) < t_r1)

    /* add_ref_mv (add_ref_mv_candidate, spec 7.10.2.9) */
#define ADD_REF_MV(r, c, wgt, found_var)                                     \
    do {                                                                     \
        int _found = 0;                                                      \
        int32_t _refs[2] = {st->mi_ref[(r) * S + (c)],                       \
                            st->mi_ref1[(r) * S + (c)]};                     \
        int32_t _mvs[2][2] = {{st->mi_mvr[(r) * S + (c)],                    \
                               st->mi_mvc[(r) * S + (c)]},                   \
                              {st->mi_mv1r[(r) * S + (c)],                   \
                               st->mi_mv1c[(r) * S + (c)]}};                 \
        if (compound) {                                                      \
            if (_refs[0] == ref && _refs[1] == ref1) {                       \
                int _hit = 0;                                                \
                for (int _k = 0; _k < n; ++_k)                               \
                    if (smv[_k][0] == _mvs[0][0]                             \
                        && smv[_k][1] == _mvs[0][1]                          \
                        && smv[_k][2] == _mvs[1][0]                          \
                        && smv[_k][3] == _mvs[1][1]) {                       \
                        swt[_k] += (wgt);                                    \
                        _hit = 1;                                            \
                        break;                                               \
                    }                                                        \
                if (!_hit && n < MAX_REF_MV_STACK) {                         \
                    smv[n][0] = _mvs[0][0];                                  \
                    smv[n][1] = _mvs[0][1];                                  \
                    smv[n][2] = _mvs[1][0];                                  \
                    smv[n][3] = _mvs[1][1];                                  \
                    swt[n] = (wgt);                                          \
                    ++n;                                                     \
                }                                                            \
                if (has_newmv_mode(st->mi_mode[(r) * S + (c)]))              \
                    ++newmv_count;                                           \
                _found = 1;                                                  \
            }                                                                \
        } else                                                               \
        for (int _j = 0; _j < 2; ++_j) {                                     \
            if (_refs[_j] != ref) continue;                                  \
            int _hit = 0;                                                    \
            for (int _k = 0; _k < n; ++_k)                                   \
                if (smv[_k][0] == _mvs[_j][0]                                \
                    && smv[_k][1] == _mvs[_j][1]) {                          \
                    swt[_k] += (wgt);                                        \
                    _hit = 1;                                                \
                    break;                                                   \
                }                                                            \
            if (!_hit && n < MAX_REF_MV_STACK) {                             \
                smv[n][0] = _mvs[_j][0];                                     \
                smv[n][1] = _mvs[_j][1];                                     \
                swt[n] = (wgt);                                              \
                ++n;                                                         \
            }                                                                \
            if (has_newmv_mode(st->mi_mode[(r) * S + (c)])) ++newmv_count;   \
            _found = 1;                                                      \
        }                                                                    \
        found_var += _found;                                                 \
    } while (0)

    int row_adj = (bh4 < 2) && (mi_row & 1);
    int col_adj = (bw4 < 2) && (mi_col & 1);
    int up_avail = mi_row > t_r0;
    int left_avail = mi_col > t_c0;
    int max_row_offset = 0, max_col_offset = 0;
    if (up_avail) {
        max_row_offset = -(MVREF_ROW_COLS << 1) + row_adj;
        if (bh4 < 2) max_row_offset = -(2 << 1) + row_adj;
        int lo = t_r0 - mi_row, hi = t_r1 - mi_row - 1;
        if (max_row_offset < lo) max_row_offset = lo;
        if (max_row_offset > hi) max_row_offset = hi;
    }
    if (left_avail) {
        max_col_offset = -(MVREF_ROW_COLS << 1) + col_adj;
        if (bw4 < 2) max_col_offset = -(2 << 1) + col_adj;
        int lo = t_c0 - mi_col, hi = t_c1 - mi_col - 1;
        if (max_col_offset < lo) max_col_offset = lo;
        if (max_col_offset > hi) max_col_offset = hi;
    }
    int processed_rows = 0, processed_cols = 0;

#define SCAN_ROW(delta_row)                                                  \
    do {                                                                     \
        int end4 = bw4 < mi_cols - mi_col ? bw4 : mi_cols - mi_col;          \
        if (end4 > 16) end4 = 16;                                            \
        int delta_col = 0;                                                   \
        int use_step_16 = bw4 >= 16;                                         \
        if ((delta_row) < -1 || (delta_row) > 1) {                           \
            delta_col = 1;                                                   \
            if ((mi_col & 1) && bw4 < 2) delta_col -= 1;                     \
        }                                                                    \
        int i = 0;                                                           \
        while (i < end4) {                                                   \
            int mr = mi_row + (delta_row);                                   \
            int mc = mi_col + delta_col + i;                                 \
            if (!INSIDE(mr, mc)) break;                                      \
            int cand_bw4 = st->mi_bw4[mr * S + mc];                          \
            int cand_bh4 = st->mi_bh4[mr * S + mc];                          \
            int length = bw4 < cand_bw4 ? bw4 : cand_bw4;                    \
            if (use_step_16) { if (length < 4) length = 4; }                 \
            else if ((delta_row) < -1 || (delta_row) > 1) {                  \
                if (length < 2) length = 2;                                  \
            }                                                                \
            int weight = 2;                                                  \
            if (bw4 >= 2 && bw4 <= cand_bw4) {                               \
                int inc = -max_row_offset + (delta_row) + 1;                 \
                if (inc > cand_bh4) inc = cand_bh4;                          \
                if (inc > weight) weight = inc;                              \
                processed_rows = inc - (delta_row) - 1;                      \
            }                                                                \
            ADD_REF_MV(mr, mc, length * weight, found_above);                \
            i += length;                                                     \
        }                                                                    \
    } while (0)

#define SCAN_COL(delta_col)                                                  \
    do {                                                                     \
        int end4 = bh4 < mi_rows - mi_row ? bh4 : mi_rows - mi_row;          \
        if (end4 > 16) end4 = 16;                                            \
        int delta_row = 0;                                                   \
        int use_step_16 = bh4 >= 16;                                         \
        if ((delta_col) < -1 || (delta_col) > 1) {                           \
            delta_row = 1;                                                   \
            if ((mi_row & 1) && bh4 < 2) delta_row -= 1;                     \
        }                                                                    \
        int i = 0;                                                           \
        while (i < end4) {                                                   \
            int mr = mi_row + delta_row + i;                                 \
            int mc = mi_col + (delta_col);                                   \
            if (!INSIDE(mr, mc)) break;                                      \
            int cand_bw4 = st->mi_bw4[mr * S + mc];                          \
            int cand_bh4 = st->mi_bh4[mr * S + mc];                          \
            int length = bh4 < cand_bh4 ? bh4 : cand_bh4;                    \
            if ((delta_col) < -1 || (delta_col) > 1) {                       \
                if (length < 2) length = 2;                                  \
            }                                                                \
            if (use_step_16) { if (length < 4) length = 4; }                 \
            int weight = 2;                                                  \
            if (bh4 >= 2 && bh4 <= cand_bh4) {                               \
                int inc = -max_col_offset + (delta_col) + 1;                 \
                if (inc > cand_bw4) inc = cand_bw4;                          \
                if (inc > weight) weight = inc;                              \
                processed_cols = inc - (delta_col) - 1;                      \
            }                                                                \
            ADD_REF_MV(mr, mc, length * weight, found_left);                 \
            i += length;                                                     \
        }                                                                    \
    } while (0)

    if (max_row_offset <= -1 || max_row_offset >= 1) SCAN_ROW(-1);
    if (max_col_offset <= -1 || max_col_offset >= 1) SCAN_COL(-1);
    /* has_top_right for the MV scan */
    {
        int bs = bw4 > bh4 ? bw4 : bh4;
        int mask_row = mi_row & (sb_mi - 1);
        int mask_col = mi_col & (sb_mi - 1);
        int has_tr = !((mask_row & bs) && (mask_col & bs));
        if (bs > 16) has_tr = 0;
        else {
            int b = bs;
            while (b < sb_mi) {
                if (mask_col & b) {
                    if ((mask_col & (2 * b)) && (mask_row & (2 * b))) {
                        has_tr = 0;
                        break;
                    }
                } else break;
                b <<= 1;
            }
            int is_sec_rect = 0;
            if (bw4 < bh4 && (mi_col & (bh4 - 1))) is_sec_rect = 1;
            if (bw4 > bh4 && (mi_row & (bw4 - 1))) is_sec_rect = 1;
            if (bw4 < bh4 && !is_sec_rect) has_tr = 1;
            if (bw4 > bh4 && is_sec_rect) has_tr = 0;
        }
        if (has_tr) {
            int mr = mi_row - 1, mc = mi_col + bw4;
            if (INSIDE(mr, mc)) ADD_REF_MV(mr, mc, 4, found_above);
        }
    }

    int nearest_match = (found_above > 0) + (found_left > 0);
    int num_nearest = n;
    int num_new = newmv_count;
    for (int k = 0; k < n; ++k) swt[k] += REF_CAT_LEVEL;
    int mode_context = 0;

    {   /* scan_blk(-1, -1) */
        int mr = mi_row - 1, mc = mi_col - 1;
        if (INSIDE(mr, mc)) ADD_REF_MV(mr, mc, 4, found_above);
    }
    for (int idx = 2; idx <= MVREF_ROW_COLS; ++idx) {
        int row_offset = -(idx << 1) + 1 + row_adj;
        int col_offset = -(idx << 1) + 1 + col_adj;
        int aro = row_offset < 0 ? -row_offset : row_offset;
        int amo = max_row_offset < 0 ? -max_row_offset : max_row_offset;
        if (aro <= amo && aro > processed_rows) SCAN_ROW(row_offset);
        int aco = col_offset < 0 ? -col_offset : col_offset;
        int amc = max_col_offset < 0 ? -max_col_offset : max_col_offset;
        if (aco <= amc && aco > processed_cols) SCAN_COL(col_offset);
    }

    /* stable partial bubble sorts */
#define SORT_SPAN(start_, end_)                                              \
    do {                                                                     \
        int end = (end_);                                                    \
        int start = (start_);                                                \
        while (end > start) {                                                \
            int new_end = start;                                             \
            for (int idx = start + 1; idx < end; ++idx)                      \
                if (swt[idx - 1] < swt[idx]) {                               \
                    int32_t tw = swt[idx - 1];                               \
                    for (int _q = 0; _q < 4; ++_q) {                         \
                        int32_t tv = smv[idx - 1][_q];                       \
                        smv[idx - 1][_q] = smv[idx][_q];                     \
                        smv[idx][_q] = tv;                                   \
                    }                                                        \
                    swt[idx - 1] = swt[idx];                                 \
                    swt[idx] = tw;                                           \
                    new_end = idx;                                           \
                }                                                            \
            end = new_end;                                                   \
        }                                                                    \
    } while (0)

    SORT_SPAN(0, num_nearest);
    SORT_SPAN(num_nearest, n);

    /* extra search: neighbor mvs from any ref, sign-flipped when the
     * candidate ref lies on the other temporal side (add_extra_mv_
     * candidate; compound collects per-position same/diff-ref lists
     * and pads with the identity gm mv, mv_pred.py:289-352) */
    if (n < MAX_MV_REF_CANDIDATES) {
        int our_refs[2] = {ref, ref1};
        int32_t ref_id[2][2][2], ref_diff[2][2][2];
        int n_id[2] = {0, 0}, n_diff[2] = {0, 0};
        int mi_width = bw4 < 16 ? bw4 : 16;
        if (mi_width > mi_cols - mi_col) mi_width = mi_cols - mi_col;
        int mi_height = bh4 < 16 ? bh4 : 16;
        if (mi_height > mi_rows - mi_row) mi_height = mi_rows - mi_row;
        int mi_size = mi_width < mi_height ? mi_width : mi_height;
        for (int pass = 0; pass < 2; ++pass) {
            int idx = 0;
            while (idx < mi_size
                   && (compound || n < MAX_MV_REF_CANDIDATES)) {
                int mr, mc;
                if (pass == 0) { mr = mi_row - 1; mc = mi_col + idx; }
                else { mr = mi_row + idx; mc = mi_col - 1; }
                if (!INSIDE(mr, mc)) break;
                const int32_t *rfs[2] = {st->mi_ref, st->mi_ref1};
                const int32_t *mrr[2] = {st->mi_mvr, st->mi_mv1r};
                const int32_t *mcc[2] = {st->mi_mvc, st->mi_mv1c};
                for (int k = 0; k < 2; ++k) {
                    int cand_ref = rfs[k][mr * S + mc];
                    if (cand_ref <= 0) continue;
                    int32_t cmr = mrr[k][mr * S + mc];
                    int32_t cmc = mcc[k][mr * S + mc];
                    if (compound) {
                        for (int ci = 0; ci < 2; ++ci) {
                            if (cand_ref == our_refs[ci]
                                && n_id[ci] < 2) {
                                ref_id[ci][n_id[ci]][0] = cmr;
                                ref_id[ci][n_id[ci]][1] = cmc;
                                ++n_id[ci];
                            } else if (n_diff[ci] < 2) {
                                int32_t ar = cmr, ac = cmc;
                                if (st->sign_bias[cand_ref]
                                    != st->sign_bias[our_refs[ci]]) {
                                    ar = -ar;
                                    ac = -ac;
                                }
                                ref_diff[ci][n_diff[ci]][0] = ar;
                                ref_diff[ci][n_diff[ci]][1] = ac;
                                ++n_diff[ci];
                            }
                        }
                    } else {
                        int32_t amr = cmr, amc2 = cmc;
                        if (st->sign_bias[cand_ref]
                            != st->sign_bias[ref]) {
                            amr = -amr;
                            amc2 = -amc2;
                        }
                        int dup = 0;
                        for (int e = 0; e < n; ++e)
                            if (smv[e][0] == amr && smv[e][1] == amc2) {
                                dup = 1;
                                break;
                            }
                        if (!dup) {
                            smv[n][0] = amr;
                            smv[n][1] = amc2;
                            swt[n] = 2;
                            ++n;
                        }
                    }
                }
                idx += pass ? st->mi_bh4[mr * S + mc]
                            : st->mi_bw4[mr * S + mc];
            }
        }
        if (compound) {
            /* comp_list: same-ref then diff-ref, padded with gm (0,0) */
            int32_t comp_list[2][2][2];
            for (int ci = 0; ci < 2; ++ci) {
                int m = 0;
                for (int k = 0; k < n_id[ci] && m < 2; ++k, ++m) {
                    comp_list[ci][m][0] = ref_id[ci][k][0];
                    comp_list[ci][m][1] = ref_id[ci][k][1];
                }
                for (int k = 0; k < n_diff[ci] && m < 2; ++k, ++m) {
                    comp_list[ci][m][0] = ref_diff[ci][k][0];
                    comp_list[ci][m][1] = ref_diff[ci][k][1];
                }
                for (; m < 2; ++m) {
                    comp_list[ci][m][0] = 0;
                    comp_list[ci][m][1] = 0;
                }
            }
            if (n == 1) {
                if (comp_list[0][0][0] == smv[0][0]
                    && comp_list[0][0][1] == smv[0][1]
                    && comp_list[1][0][0] == smv[0][2]
                    && comp_list[1][0][1] == smv[0][3]) {
                    smv[1][0] = comp_list[0][1][0];
                    smv[1][1] = comp_list[0][1][1];
                    smv[1][2] = comp_list[1][1][0];
                    smv[1][3] = comp_list[1][1][1];
                } else {
                    smv[1][0] = comp_list[0][0][0];
                    smv[1][1] = comp_list[0][0][1];
                    smv[1][2] = comp_list[1][0][0];
                    smv[1][3] = comp_list[1][0][1];
                }
                swt[1] = 2;
                n = 2;
            } else if (n == 0) {
                for (int k = 0; k < MAX_MV_REF_CANDIDATES; ++k) {
                    smv[k][0] = comp_list[0][k][0];
                    smv[k][1] = comp_list[0][k][1];
                    smv[k][2] = comp_list[1][k][0];
                    smv[k][3] = comp_list[1][k][1];
                    swt[k] = 2;
                }
                n = MAX_MV_REF_CANDIDATES;
            }
        }
    }

    /* clamp */
    {
        int bw_px = bw4 * 4, bh_px = bh4 * 4;
        int mb_to_left = -(mi_col * 4) * 8;
        int mb_to_right = ((mi_cols - bw4 - mi_col) * 4) * 8;
        int mb_to_top = -(mi_row * 4) * 8;
        int mb_to_bottom = ((mi_rows - bh4 - mi_row) * 4) * 8;
        int lo_c = mb_to_left - bw_px * 8 - MV_BORDER;
        int hi_c = mb_to_right + bw_px * 8 + MV_BORDER;
        int lo_r = mb_to_top - bh_px * 8 - MV_BORDER;
        int hi_r = mb_to_bottom + bh_px * 8 + MV_BORDER;
        int nbase = compound ? 4 : 2;
        for (int k = 0; k < n; ++k)
            for (int base = 0; base < nbase; base += 2) {
                if (smv[k][base] < lo_r) smv[k][base] = lo_r;
                if (smv[k][base] > hi_r) smv[k][base] = hi_r;
                if (smv[k][base + 1] < lo_c) smv[k][base + 1] = lo_c;
                if (smv[k][base + 1] > hi_c) smv[k][base + 1] = hi_c;
            }
    }

    int ref_match_count = (found_above > 0) + (found_left > 0);
    if (nearest_match == 0) {
        if (ref_match_count >= 1) mode_context |= 1;
        if (ref_match_count == 1) mode_context |= 1 << REFMV_OFFSET;
        else if (ref_match_count >= 2) mode_context |= 2 << REFMV_OFFSET;
    } else if (nearest_match == 1) {
        mode_context |= num_new > 0 ? 2 : 3;
        if (ref_match_count == 1) mode_context |= 3 << REFMV_OFFSET;
        else if (ref_match_count >= 2) mode_context |= 4 << REFMV_OFFSET;
    } else {
        mode_context |= num_new >= 1 ? 4 : 5;
        mode_context |= 5 << REFMV_OFFSET;
    }

    out->n = n;
    for (int k = 0; k < n; ++k) {
        out->mv[k][0] = smv[k][0];
        out->mv[k][1] = smv[k][1];
        out->mv[k][2] = compound ? smv[k][2] : 0;
        out->mv[k][3] = compound ? smv[k][3] : 0;
        out->weight[k] = swt[k];
    }
    out->mode_context = mode_context;
    for (int idx = 0; idx < MAX_MV_REF_CANDIDATES; ++idx) {
        int32_t r = 0, c = 0;
        if (idx < n) { r = smv[idx][0]; c = smv[idx][1]; }
        /* lower_mv_precision (allow_hp = force_int = 0) */
        if (r & 1) r += r > 0 ? -1 : 1;
        if (c & 1) c += c > 0 ? -1 : 1;
        out->ref_list[idx][0] = r;
        out->ref_list[idx][1] = c;
    }
#undef INSIDE
#undef ADD_REF_MV
#undef SCAN_ROW
#undef SCAN_COL
#undef SORT_SPAN
}

/* ---- motion compensation (convolve_2d_sr, REGULAR filter) -------- */

/* mv_window_in_frame twin: MC read windows (luma + chroma, 8-tap
 * margins) stay inside the PADDED reference extent — references carry
 * ref_pad of edge replication, which reproduces the spec's clamped MC
 * reads (7.11.3.3), so MVs may overhang the visible frame up to the
 * pad reach (FrameCodec.mv_window_in_frame) */
static int mv_window_ok(InterState *st, int mv_r, int mv_c, int x, int y,
                        int bw, int bh) {
    int B = st->ref_pad - 8;
    for (int plane = 0; plane < 2; ++plane) {
        int sh = plane ? 1 : 0;
        int px = x >> sh, py = y >> sh;
        int pw = bw >> sh, ph = bh >> sh;
        int vw = st->frame_w >> sh, vh = st->frame_h >> sh;
        int bb = B >> sh;
        int pos_x = (px << 4) + (mv_c << (1 - sh));
        int pos_y = (py << 4) + (mv_r << (1 - sh));
        int ix = pos_x >> 4, iy = pos_y >> 4;
        int sub_x = pos_x & 15, sub_y = pos_y & 15;
        int mx0 = sub_x ? 3 : 0, mx1 = sub_x ? 4 : 0;
        int my0 = sub_y ? 3 : 0, my1 = sub_y ? 4 : 0;
        if (ix - mx0 < -bb || iy - my0 < -bb) return 0;
        if (ix + pw + mx1 > vw + bb || iy + ph + my1 > vh + bb) return 0;
    }
    return 1;
}

#define FILTER_BITS 7
#define ROUND0_BITS 3

/* single-ref convolve into pred[h][w] (int32), bd-generic */
static void mc_predict(InterState *st, const int32_t *ref, int ref_w,
                       int ref_h, int plane, int mv_r, int mv_c, int px,
                       int py, int pw, int ph, int bd, int32_t *pred) {
    int sh = plane ? 1 : 0;
    int pos_x = (px << 4) + (mv_c << (1 - sh));
    int pos_y = (py << 4) + (mv_r << (1 - sh));
    int int_x = (pos_x >> 4) + st->ref_pad;
    int int_y = (pos_y >> 4) + st->ref_pad;
    if (int_x < 4) int_x = 4;
    if (int_x > ref_w - pw - 8) int_x = ref_w - pw - 8;
    if (int_y < 4) int_y = 4;
    if (int_y > ref_h - ph - 8) int_y = ref_h - ph - 8;
    int sub_x = pos_x & 15, sub_y = pos_y & 15;
    /* 4-tap table (block 1 of interp_taps) when the filtered dimension
     * is <= 4: av1_get_interp_filter_params_with_block_size */
    const int32_t *xf = st->interp_taps + (pw <= 4 ? 128 : 0) + sub_x * 8;
    const int32_t *yf = st->interp_taps + (ph <= 4 ? 128 : 0) + sub_y * 8;
    int round_0 = ROUND0_BITS;
    int round_1 = 2 * FILTER_BITS - round_0;

    if (!sub_x && !sub_y) {
        for (int r = 0; r < ph; ++r)
            for (int c = 0; c < pw; ++c)
                pred[r * pw + c] = ref[(Py_ssize_t)(int_y + r) * ref_w
                                       + int_x + c];
        return;
    }
    if (sub_x && sub_y) {
        int im_h = ph + 7;
        int32_t im[(64 + 7) * 64];      /* largest block: 64x64 luma */
        int off0 = 1 << (bd + FILTER_BITS - 1);
        for (int r = 0; r < im_h; ++r)
            for (int c = 0; c < pw; ++c) {
                int32_t acc = off0;
                const int32_t *row = ref
                    + (Py_ssize_t)(int_y - 3 + r) * ref_w + int_x - 3 + c;
                for (int k = 0; k < 8; ++k) acc += xf[k] * row[k];
                im[r * pw + c] = (acc + (1 << (round_0 - 1))) >> round_0;
            }
        int offset_bits = bd + 2 * FILTER_BITS - round_0;
        int sub = (1 << (offset_bits - round_1))
                + (1 << (offset_bits - round_1 - 1));
        int pmax = (1 << bd) - 1;
        for (int r = 0; r < ph; ++r)
            for (int c = 0; c < pw; ++c) {
                int32_t acc2 = 1 << offset_bits;
                for (int k = 0; k < 8; ++k)
                    acc2 += yf[k] * im[(r + k) * pw + c];
                int32_t v = ((acc2 + (1 << (round_1 - 1))) >> round_1) - sub;
                pred[r * pw + c] = clampi(v, 0, pmax);
            }
        return;
    }
    if (sub_x) {
        int bits = FILTER_BITS - round_0;
        int pmax = (1 << bd) - 1;
        for (int r = 0; r < ph; ++r)
            for (int c = 0; c < pw; ++c) {
                int32_t acc = 0;
                const int32_t *row = ref
                    + (Py_ssize_t)(int_y + r) * ref_w + int_x - 3 + c;
                for (int k = 0; k < 8; ++k) acc += xf[k] * row[k];
                acc = (acc + (1 << (round_0 - 1))) >> round_0;
                int32_t v = (acc + (1 << (bits - 1))) >> bits;
                pred[r * pw + c] = clampi(v, 0, pmax);
            }
        return;
    }
    {
        int pmax = (1 << bd) - 1;
        for (int r = 0; r < ph; ++r)
            for (int c = 0; c < pw; ++c) {
                int32_t acc = 0;
                const int32_t *col = ref
                    + (Py_ssize_t)(int_y - 3 + r) * ref_w + int_x + c;
                for (int k = 0; k < 8; ++k)
                    acc += yf[k] * col[(Py_ssize_t)k * ref_w];
                int32_t v = (acc + (1 << (FILTER_BITS - 1))) >> FILTER_BITS;
                pred[r * pw + c] = clampi(v, 0, pmax);
            }
        return;
    }
}

/* ---- compound MC: jnt convolve (no dist weights) ------------------
 * ports of ops/inter.py jnt_convolve / jnt_average (conv-domain
 * intermediates, COMPOUND_ROUND1_BITS = 7, use_jnt_comp_avg = 0) */

static void mc_predict_jnt(InterState *st, const int32_t *ref, int ref_w,
                           int ref_h, int plane, int mv_r, int mv_c,
                           int px, int py, int pw, int ph, int bd,
                           int32_t *conv) {
    int sh = plane ? 1 : 0;
    int pos_x = (px << 4) + (mv_c << (1 - sh));
    int pos_y = (py << 4) + (mv_r << (1 - sh));
    int int_x = (pos_x >> 4) + st->ref_pad;
    int int_y = (pos_y >> 4) + st->ref_pad;
    if (int_x < 4) int_x = 4;
    if (int_x > ref_w - pw - 8) int_x = ref_w - pw - 8;
    if (int_y < 4) int_y = 4;
    if (int_y > ref_h - ph - 8) int_y = ref_h - ph - 8;
    int sub_x = pos_x & 15, sub_y = pos_y & 15;
    const int32_t *xf = st->interp_taps + (pw <= 4 ? 128 : 0) + sub_x * 8;
    const int32_t *yf = st->interp_taps + (ph <= 4 ? 128 : 0) + sub_y * 8;
    int round_0 = ROUND0_BITS;
    int round_1 = 7;                   /* COMPOUND_ROUND1_BITS */
    int offset_bits = bd + 2 * FILTER_BITS - round_0;
    int round_offset = (1 << (offset_bits - round_1))
                     + (1 << (offset_bits - round_1 - 1));

    if (!sub_x && !sub_y) {
        int bits = 2 * FILTER_BITS - round_1 - round_0;
        for (int r = 0; r < ph; ++r)
            for (int c = 0; c < pw; ++c)
                conv[r * pw + c] =
                    (ref[(Py_ssize_t)(int_y + r) * ref_w + int_x + c]
                     << bits) + round_offset;
        return;
    }
    if (sub_x && sub_y) {
        int im_h = ph + 7;
        int32_t im[(64 + 7) * 64];
        int off0 = 1 << (bd + FILTER_BITS - 1);
        for (int r = 0; r < im_h; ++r)
            for (int c = 0; c < pw; ++c) {
                int32_t acc = off0;
                const int32_t *row = ref
                    + (Py_ssize_t)(int_y - 3 + r) * ref_w + int_x - 3 + c;
                for (int k = 0; k < 8; ++k) acc += xf[k] * row[k];
                im[r * pw + c] = (acc + (1 << (round_0 - 1))) >> round_0;
            }
        for (int r = 0; r < ph; ++r)
            for (int c = 0; c < pw; ++c) {
                int32_t acc2 = 1 << offset_bits;
                for (int k = 0; k < 8; ++k)
                    acc2 += yf[k] * im[(r + k) * pw + c];
                conv[r * pw + c] = (acc2 + (1 << (round_1 - 1))) >> round_1;
            }
        return;
    }
    if (sub_x) {
        int bits = FILTER_BITS - round_1;
        for (int r = 0; r < ph; ++r)
            for (int c = 0; c < pw; ++c) {
                int32_t acc = 0;
                const int32_t *row = ref
                    + (Py_ssize_t)(int_y + r) * ref_w + int_x - 3 + c;
                for (int k = 0; k < 8; ++k) acc += xf[k] * row[k];
                acc = (acc + (1 << (round_0 - 1))) >> round_0;
                conv[r * pw + c] = (acc << bits) + round_offset;
            }
        return;
    }
    {
        int bits = FILTER_BITS - round_0;
        for (int r = 0; r < ph; ++r)
            for (int c = 0; c < pw; ++c) {
                int32_t acc = 0;
                const int32_t *col = ref
                    + (Py_ssize_t)(int_y - 3 + r) * ref_w + int_x + c;
                for (int k = 0; k < 8; ++k)
                    acc += yf[k] * col[(Py_ssize_t)k * ref_w];
                acc <<= bits;
                conv[r * pw + c] = ((acc + (1 << (round_1 - 1))) >> round_1)
                                   + round_offset;
            }
        return;
    }
}

static void jnt_avg(const int32_t *c0, const int32_t *c1, int pw, int ph,
                    int bd, int32_t *pred) {
    int round_0 = ROUND0_BITS, round_1 = 7;
    int round_bits = 2 * FILTER_BITS - round_0 - round_1;
    int offset_bits = bd + 2 * FILTER_BITS - round_0;
    int round_offset = (1 << (offset_bits - round_1))
                     + (1 << (offset_bits - round_1 - 1));
    int pmax = (1 << bd) - 1;
    for (int i = 0; i < pw * ph; ++i) {
        int32_t tmp = ((c0[i] + c1[i]) >> 1) - round_offset;
        tmp = (tmp + (1 << (round_bits - 1))) >> round_bits;
        pred[i] = clampi(tmp, 0, pmax);
    }
}

/* compound prediction for one plane: both refs + average */
static void mc_predict_compound(InterState *st, int plane, int ref0,
                                int ref1, int mv0_r, int mv0_c, int mv1_r,
                                int mv1_c, int px, int py, int pw, int ph,
                                int bd, int32_t *pred) {
    int32_t conv0[64 * 64], conv1[64 * 64];
    const int32_t *rp0 = plane == 0 ? st->ref_y[ref0]
                         : (plane == 1 ? st->ref_u[ref0] : st->ref_v[ref0]);
    const int32_t *rp1 = plane == 0 ? st->ref_y[ref1]
                         : (plane == 1 ? st->ref_u[ref1] : st->ref_v[ref1]);
    int w0 = plane ? st->ref_cw[ref0] : st->ref_w[ref0];
    int h0 = plane ? st->ref_ch[ref0] : st->ref_h[ref0];
    int w1 = plane ? st->ref_cw[ref1] : st->ref_w[ref1];
    int h1 = plane ? st->ref_ch[ref1] : st->ref_h[ref1];
    mc_predict_jnt(st, rp0, w0, h0, plane, mv0_r, mv0_c, px, py, pw, ph,
                   bd, conv0);
    mc_predict_jnt(st, rp1, w1, h1, plane, mv1_r, mv1_c, px, py, pw, ph,
                   bd, conv1);
    jnt_avg(conv0, conv1, pw, ph, bd, pred);
}

/* ---- MV residual coding (entropy/mv.py encode_mv) ---------------- */

static void enc_mv_component(Tile *t, InterState *st, int comp, int ci) {
    int sign = comp < 0;
    int mag = sign ? -comp : comp;
    int z = mag - 1;
    int v = z >> 3;
    int mv_class = 0;
    while (v > 1) { v >>= 1; ++mv_class; }   /* max(bit_length-1, 0) */
    if (z >= 2 * 4096) mv_class = 10;
    int base = mv_class == 0 ? 0 : (2 << (mv_class + 2));
    int offset = z - base;
    int d = offset >> 3;
    int fr = (offset >> 1) & 3;
    enc_symbol_adapt(&t->ec, sign, st->nmv_sign[ci], 2);
    enc_symbol_adapt(&t->ec, mv_class, st->nmv_classes[ci], 11);
    if (mv_class == 0) {
        enc_symbol_adapt(&t->ec, d, st->nmv_class0[ci], 2);
    } else {
        int nb = mv_class + 1 - 1;   /* CLASS0_BITS = 1 */
        for (int i = 0; i < nb; ++i)
            enc_symbol_adapt(&t->ec, (d >> i) & 1,
                             st->nmv_bits[ci] + i * 3, 2);
    }
    /* precision MV_SUBPEL_LOW_PRECISION: fp coded, hp not */
    uint16_t *fp_cdf = mv_class == 0 ? st->nmv_class0_fp[ci] + d * 5
                                     : st->nmv_fp[ci];
    enc_symbol_adapt(&t->ec, fr, fp_cdf, 4);
}

static void enc_mv(Tile *t, InterState *st, int mv_r, int mv_c, int ref_r,
                   int ref_c) {
    int dr = mv_r - ref_r, dc = mv_c - ref_c;
    int j = dr == 0 ? (dc == 0 ? 0 : 1) : (dc == 0 ? 2 : 3);
    enc_symbol_adapt(&t->ec, j, st->nmv_joints, 4);
    if (j == 2 || j == 3) enc_mv_component(t, st, dr, 0);
    if (j == 1 || j == 3) enc_mv_component(t, st, dc, 1);
}

/* ---- neighbor contexts ------------------------------------------- */

static int intra_inter_ctx(Tile *t, InterState *st, int mi_row, int mi_col) {
    Py_ssize_t S = t->mi_cols;
    int up = mi_row > t->t_r0;
    int left = mi_col > t->t_c0;
    int above_intra = up && st->mi_ref[(Py_ssize_t)(mi_row - 1) * S
                                       + mi_col] == 0;
    int left_intra = left && st->mi_ref[(Py_ssize_t)mi_row * S
                                        + (mi_col - 1)] == 0;
    if (up && left)
        return (above_intra && left_intra) ? 3
                                           : (above_intra || left_intra);
    if (up || left) return 2 * (up ? above_intra : left_intra);
    return 0;
}

static inline int ctx3(int a, int b) {
    return a == b ? 1 : (a < b ? 0 : 2);
}

static void neighbor_ref_counts(Tile *t, InterState *st, int mi_row,
                                int mi_col, int *counts) {
    Py_ssize_t S = t->mi_cols;
    for (int k = 0; k < 8; ++k) counts[k] = 0;
    int poss[2][2] = {{mi_row - 1, mi_col}, {mi_row, mi_col - 1}};
    for (int p = 0; p < 2; ++p) {
        int r = poss[p][0], c = poss[p][1];
        if (r < t->t_r0 || c < t->t_c0) continue;
        int rf = st->mi_ref[(Py_ssize_t)r * S + c];
        if (rf > 0) {
            counts[rf] += 1;
            int rf1 = st->mi_ref1[(Py_ssize_t)r * S + c];
            if (rf1 > 0) counts[rf1] += 1;
        }
    }
}

static int reference_mode_ctx(Tile *t, InterState *st, int mi_row,
                              int mi_col) {
    Py_ssize_t S = t->mi_cols;
    /* (avail, is_inter, rf0, has_second) per above/left */
    int av[2] = {0, 0}, inter_[2], rf0[2], snd[2];
    int poss[2][2] = {{mi_row - 1, mi_col}, {mi_row, mi_col - 1}};
    for (int p = 0; p < 2; ++p) {
        int r = poss[p][0], c = poss[p][1];
        if (r < t->t_r0 || c < t->t_c0) continue;
        av[p] = 1;
        rf0[p] = st->mi_ref[(Py_ssize_t)r * S + c];
        inter_[p] = rf0[p] > 0;
        snd[p] = st->mi_ref1[(Py_ssize_t)r * S + c] > 0;
    }
#define BWD(rf) ((rf) >= 5)
    if (av[0] && av[1]) {
        if (!snd[0] && !snd[1]) return BWD(rf0[0]) ^ BWD(rf0[1]);
        if (!snd[0]) return 2 + (BWD(rf0[0]) || !inter_[0]);
        if (!snd[1]) return 2 + (BWD(rf0[1]) || !inter_[1]);
        return 4;
    }
    if (av[0] || av[1]) {
        int p = av[0] ? 0 : 1;
        return snd[p] ? 3 : BWD(rf0[p]);
    }
    return 1;
#undef BWD
}

/* single-reference signaling tree (_code_ref_frames) */
static void write_single_ref(Tile *t, InterState *st, int mi_row,
                             int mi_col, int ref) {
    int rc[8];
    neighbor_ref_counts(t, st, mi_row, mi_col, rc);
    NB *sr = &st->cdf_single_ref;
#define SRBIT(v, ctx, idx)                                                   \
    enc_symbol_adapt(&t->ec, (v),                                            \
                     (uint16_t *)sr->data                                    \
                         + ((Py_ssize_t)(ctx) * sr->shape[1] + (idx))        \
                               * sr->shape[2],                               \
                     2)
    int fwd = rc[1] + rc[2] + rc[3] + rc[4];
    int bwd = rc[5] + rc[6] + rc[7];
    int bit0 = ref >= 5;
    SRBIT(bit0, ctx3(fwd, bwd), 0);
    if (bit0) {
        int bit1 = ref == 7;
        SRBIT(bit1, ctx3(rc[5] + rc[6], rc[7]), 1);
        if (!bit1) SRBIT(ref == 6, ctx3(rc[5], rc[6]), 5);
        return;
    }
    int bit2 = (ref == 3 || ref == 4);
    SRBIT(bit2, ctx3(rc[1] + rc[2], rc[3] + rc[4]), 2);
    if (bit2) {
        SRBIT(ref == 4, ctx3(rc[3], rc[4]), 4);
        return;
    }
    SRBIT(ref == 2, ctx3(rc[1], rc[2]), 3);
#undef SRBIT
}

/* get_comp_reference_type_context (frame_codec._comp_ref_type_ctx,
 * EbDecParseHelper.c:217) */
static int comp_ref_type_ctx(Tile *t, InterState *st, int mi_row,
                             int mi_col) {
    Py_ssize_t S = t->mi_cols;
    int av[2] = {0, 0}, inter_[2], rf0[2], snd[2], uni[2];
    int poss[2][2] = {{mi_row - 1, mi_col}, {mi_row, mi_col - 1}};
    for (int p = 0; p < 2; ++p) {
        int r = poss[p][0], c = poss[p][1];
        if (r < t->t_r0 || c < t->t_c0) continue;
        av[p] = 1;
        rf0[p] = st->mi_ref[(Py_ssize_t)r * S + c];
        int rf1 = st->mi_ref1[(Py_ssize_t)r * S + c];
        inter_[p] = rf0[p] > 0;
        snd[p] = rf1 > 0;
        uni[p] = rf1 > 0 && !((rf0[p] >= 5) ^ (rf1 >= 5));
    }
#define BWD(rf) ((rf) >= 5)
    if (av[0] && av[1]) {
        if (!inter_[0] && !inter_[1]) return 2;
        if (!inter_[0] || !inter_[1]) {
            int p = !inter_[1] ? 0 : 1;
            return !snd[p] ? 2 : 1 + 2 * uni[p];
        }
        if (!snd[0] && !snd[1])
            return 1 + 2 * !(BWD(rf0[0]) ^ BWD(rf0[1]));
        if (!snd[0] || !snd[1]) {
            int u = !snd[0] ? uni[1] : uni[0];
            if (!u) return 1;
            return 3 + !(BWD(rf0[0]) ^ BWD(rf0[1]));
        }
        if (!uni[0] && !uni[1]) return 0;
        if (!uni[0] || !uni[1]) return 2;
        return 3 + !((rf0[0] == 5) ^ (rf0[1] == 5));
    }
    if (av[0] || av[1]) {
        int p = av[0] ? 0 : 1;
        if (!inter_[p]) return 2;
        return !snd[p] ? 2 : 4 * uni[p];
    }
    return 2;
#undef BWD
}

/* compound (bidirectional) reference pair signaling
 * (frame_codec._code_comp_ref_frames) */
static void write_comp_ref_frames(Tile *t, InterState *st, int mi_row,
                                  int mi_col, int ref0, int ref1) {
    int rc[8];
    neighbor_ref_counts(t, st, mi_row, mi_col, rc);
    int crt_ctx = comp_ref_type_ctx(t, st, mi_row, mi_col);
    NB *crt = &st->cdf_comp_ref_type;
    enc_symbol_adapt(&t->ec, 1,
                     (uint16_t *)crt->data
                         + (Py_ssize_t)crt_ctx * crt->shape[1], 2);
#define CRBIT(v, nb, ctx, idx)                                               \
    enc_symbol_adapt(&t->ec, (v),                                            \
                     (uint16_t *)(nb)->data                                  \
                         + ((Py_ssize_t)(ctx) * (nb)->shape[1] + (idx))      \
                               * (nb)->shape[2],                             \
                     2)
    NB *cr = &st->cdf_comp_ref;
    NB *cb = &st->cdf_comp_bwdref;
    int b = ref0 == 3 || ref0 == 4;
    CRBIT(b, cr, ctx3(rc[1] + rc[2], rc[3] + rc[4]), 0);
    if (!b) CRBIT(ref0 == 2, cr, ctx3(rc[1], rc[2]), 1);
    else CRBIT(ref0 == 4, cr, ctx3(rc[3], rc[4]), 2);
    int bb = ref1 == 7;
    CRBIT(bb, cb, ctx3(rc[5] + rc[6], rc[7]), 0);
    if (!bb) CRBIT(ref1 == 6, cb, ctx3(rc[5], rc[6]), 1);
#undef CRBIT
}

/* compound_mode_ctx_map (mv_pred.compound_mode_ctx) */
static const int COMPOUND_MODE_CTX_MAP[3][5] = {
    {0, 1, 1, 1, 1}, {1, 2, 3, 4, 4}, {4, 4, 5, 6, 7}};

static int compound_mode_ctx(int mode_context) {
    int newmv_ctx = mode_context & NEWMV_CTX_MASK;
    int refmv_ctx = (mode_context >> REFMV_OFFSET) & REFMV_CTX_MASK;
    return COMPOUND_MODE_CTX_MAP[refmv_ctx >> 1]
                                [newmv_ctx < 4 ? newmv_ctx : 4];
}

static void record_mi_inter(Tile *t, InterState *st, int mi_row, int mi_col,
                            int w4, int h4, int is_inter, int ref, int mode,
                            int mv_r, int mv_c, int y_mode, int skip,
                            int ref1, int mv1_r, int mv1_c) {
    Py_ssize_t S = t->mi_cols;
    int r1 = mi_row + h4 < t->mi_rows ? mi_row + h4 : t->mi_rows;
    int c1 = mi_col + w4 < t->mi_cols ? mi_col + w4 : t->mi_cols;
    for (int r = mi_row; r < r1; ++r)
        for (int c = mi_col; c < c1; ++c) {
            Py_ssize_t o = (Py_ssize_t)r * S + c;
            if (is_inter) {
                st->mi_ref[o] = ref;
                st->mi_mvr[o] = mv_r;
                st->mi_mvc[o] = mv_c;
                st->mi_mode[o] = mode;
            } else {
                st->mi_ref[o] = 0;
                st->mi_mvr[o] = 0;
                st->mi_mvc[o] = 0;
                st->mi_mode[o] = y_mode;
            }
            st->mi_ref1[o] = is_inter ? ref1 : 0;
            st->mi_mv1r[o] = is_inter ? mv1_r : 0;
            st->mi_mv1c[o] = is_inter ? mv1_c : 0;
            st->mi_bw4[o] = w4;
            st->mi_bh4[o] = h4;
            t->y_modes[o] = is_inter ? 0 : y_mode;
            t->skips[o] = skip;
        }
    int dlf_skip = skip && is_inter;
    for (int plane = 0; plane < t->num_planes; ++plane) {
        int sh = plane ? 1 : 0;
        int y4a = ((mi_row * MI) >> sh) >> 2;
        int x4a = ((mi_col * MI) >> sh) >> 2;
        int gh = ((h4 * MI) >> sh) >> 2; if (gh < 1) gh = 1;
        int gw = ((w4 * MI) >> sh) >> 2; if (gw < 1) gw = 1;
        int gwid = t->grid_w[plane];
        for (int r = 0; r < gh; ++r)
            for (int c = 0; c < gw; ++c)
                st->skip_grid[plane][(Py_ssize_t)(y4a + r) * gwid
                                     + x4a + c] = dlf_skip;
    }
}

/* the inter-frame leaf: decide (plan replay) + compute + syntax */
static void tile_block_inter(Tile *t, int bw, int bh, int mi_row,
                             int mi_col) {
    InterState *st = (InterState *)t->inter;
    int x = mi_col * MI, y = mi_row * MI;
    int w4 = bw / MI, h4 = bh / MI;
    int si = shape_idx(bw, bh);
    if (si < 0) { tile_err(t, "inter shape"); return; }
    int bi = y / bh, bj = x / bw;
    int is_inter = st->is_inter_map[si][(Py_ssize_t)bi * st->map_w[si] + bj];
    int y_mode = st->mode_map[si][(Py_ssize_t)bi * st->map_w[si] + bj];
    int bse = bsize_enum_of(bw, bh);
    if (!is_inter && (bw > 32 || bh > 32)) {
        /* 64-px shapes are inter-only in the plan (batched_inter) */
        tile_err(t, "intra 64");
        return;
    }

    /* ---- decide (port of BatchedDecider.decide_inter: multi-ref
     * single + averaged compound) ---- */
    MvStack stk;
    stk.n = 0;
    stk.mode_context = 0;
    int mode = 0, mv_r = 0, mv_c = 0, ref = 1;
    int ref1 = 0, mv1_r = 0, mv1_c = 0;
    Py_ssize_t u16 = (Py_ssize_t)(y / 16) * st->nc16 + x / 16;
    if (is_inter) {
        int sel = st->sel16[u16];
        int comp_done = 0;
        if (sel >= st->n_names) {
            /* compound unit: NEW_NEW vs NEAREST_NEAREST on the true
             * compound stack (BatchedDecider._decide_compound) */
            int rf = st->names[st->fwd16[u16]];
            int rb = st->names[st->bwd16[u16]];
            mv_stack_find(t, st, mi_row, mi_col, w4, h4, rf, rb, &stk);
            int tmode[2], tmv[2][4], tpen[2], nt = 0;
            tmode[nt] = NEW_NEWMV;
            tmv[nt][0] = st->mv16_r[u16]; tmv[nt][1] = st->mv16_c[u16];
            tmv[nt][2] = st->mv16_1r[u16]; tmv[nt][3] = st->mv16_1c[u16];
            tpen[nt] = (96 * st->pen_q8) >> 8; ++nt;
            if (stk.n > 0) {
                tmode[nt] = NEAREST_NEARESTMV_M;
                for (int j = 0; j < 4; ++j) {
                    int v = stk.mv[0][j];
                    if (v & 1) v += v > 0 ? -1 : 1;   /* lower precision */
                    tmv[nt][j] = v;
                }
                tpen[nt] = 0; ++nt;
            }
            int32_t pred[64 * 64];
            long best_sad = 0;
            int best_i = -1;
            const int32_t *src = t->src[0];
            int stride = t->pw_buf[0];
            for (int k = 0; k < nt; ++k) {
                if (!mv_window_ok(st, tmv[k][0], tmv[k][1], x, y, bw, bh)
                    || !mv_window_ok(st, tmv[k][2], tmv[k][3], x, y, bw,
                                     bh))
                    continue;
                mc_predict_compound(st, 0, rf, rb, tmv[k][0], tmv[k][1],
                                    tmv[k][2], tmv[k][3], x, y, bw, bh,
                                    t->bd, pred);
                long sad = tpen[k];
                for (int r = 0; r < bh; ++r)
                    for (int c = 0; c < bw; ++c) {
                        int32_t d = src[(Py_ssize_t)(y + r) * stride + x + c]
                                    - pred[r * bw + c];
                        sad += d < 0 ? -d : d;
                    }
                if (best_i < 0 || sad < best_sad) {
                    best_sad = sad;
                    best_i = k;
                }
            }
            if (best_i >= 0) {
                mode = tmode[best_i];
                ref = rf; ref1 = rb;
                mv_r = tmv[best_i][0]; mv_c = tmv[best_i][1];
                mv1_r = tmv[best_i][2]; mv1_c = tmv[best_i][3];
                comp_done = 1;
            } else {
                sel = st->fwd16[u16];   /* windows failed: single fwd */
            }
        }
        if (!comp_done) {
        ref = st->names[sel];
        mv_stack_find(t, st, mi_row, mi_col, w4, h4, ref, 0, &stk);
        int pmv_r = st->mv16_r[u16];
        int pmv_c = st->mv16_c[u16];
        int nearest_r = stk.ref_list[0][0], nearest_c = stk.ref_list[0][1];
        int near_r = stk.ref_list[1][0], near_c = stk.ref_list[1][1];
        /* candidates in python order: NEW, NEAREST, NEAR, GLOBAL */
        int cmv[4][2], cmode[4], cpen[4];
        int nc = 0;
        if (mv_window_ok(st, pmv_r, pmv_c, x, y, bw, bh)) {
            cmv[nc][0] = pmv_r; cmv[nc][1] = pmv_c;
            cmode[nc] = NEWMV; cpen[nc] = (96 * st->pen_q8) >> 8; ++nc;
        }
        if (mv_window_ok(st, nearest_r, nearest_c, x, y, bw, bh)) {
            cmv[nc][0] = nearest_r; cmv[nc][1] = nearest_c;
            cmode[nc] = NEARESTMV; cpen[nc] = 0; ++nc;
        }
        if (stk.n >= 2 && (near_r != nearest_r || near_c != nearest_c)
            && mv_window_ok(st, near_r, near_c, x, y, bw, bh)) {
            cmv[nc][0] = near_r; cmv[nc][1] = near_c;
            cmode[nc] = NEARMV; cpen[nc] = (16 * st->pen_q8) >> 8; ++nc;
        }
        if (mv_window_ok(st, 0, 0, x, y, bw, bh)) {
            cmv[nc][0] = 0; cmv[nc][1] = 0;
            cmode[nc] = GLOBALMV_MODE;
            cpen[nc] = (32 * st->pen_q8) >> 8; ++nc;
        }
        if (nc == 0) {
            is_inter = 0;           /* python: falls back to decide() */
        } else {
            int32_t pred[64 * 64];
            long best_sad = 0;
            int best_i = -1;
            const int32_t *src = t->src[0];
            int stride = t->pw_buf[0];
            for (int k = 0; k < nc; ++k) {
                mc_predict(st, st->ref_y[ref], st->ref_w[ref],
                           st->ref_h[ref], 0,
                           cmv[k][0], cmv[k][1], x, y, bw, bh, t->bd, pred);
                long sad = cpen[k];
                for (int r = 0; r < bh; ++r)
                    for (int c = 0; c < bw; ++c) {
                        int32_t d = src[(Py_ssize_t)(y + r) * stride + x + c]
                                    - pred[r * bw + c];
                        sad += d < 0 ? -d : d;
                    }
                if (best_i < 0 || sad < best_sad) {
                    best_sad = sad;
                    best_i = k;
                }
            }
            mode = cmode[best_i];
            mv_r = cmv[best_i][0];
            mv_c = cmv[best_i][1];
            if (mode == NEWMV && mv_r == nearest_r && mv_c == nearest_c)
                mode = NEARESTMV;
        }
        }
    }

    /* ---- compute all tx blocks (luma up to 64x64; the TX_64-family
     * codes a 32x32 band, packed into Txb.qc below) ---- */
    Txb txbs[3];
    int n_txb = 0;
    int32_t pred_buf[3][64 * 64];
    int32_t resid[64 * 64], rec[64 * 64], qc_full[64 * 64];
    int ts_of[3], tt_of[3];
    for (int plane = 0; plane < t->num_planes; ++plane) {
        int sub = plane ? 1 : 0;
        int px = x >> sub, py = y >> sub;
        int pw = bw >> sub, ph = bh >> sub;
        int ts, tt;
        int32_t *pred = pred_buf[plane];
        if (is_inter) {
            /* max_txsize_rect of plane dims, all <= 32 */
            ts = -1;
            for (int k = 0; k < 19; ++k)
                if (t->tx_w_tab[k] == pw && t->tx_h_tab[k] == ph) {
                    ts = k;
                    break;
                }
            if (ts < 0) { tile_err(t, "inter ts"); return; }
            tt = 0;    /* DCT_DCT */
            if (ref1 > 0) {
                mc_predict_compound(st, plane, ref, ref1, mv_r, mv_c,
                                    mv1_r, mv1_c, px, py, pw, ph, t->bd,
                                    pred);
            } else {
                const int32_t *rp = plane == 0 ? st->ref_y[ref]
                                   : (plane == 1 ? st->ref_u[ref]
                                                 : st->ref_v[ref]);
                int rpw = plane ? st->ref_cw[ref] : st->ref_w[ref];
                int rph = plane ? st->ref_ch[ref] : st->ref_h[ref];
                mc_predict(st, rp, rpw, rph, plane, mv_r, mv_c, px, py, pw,
                           ph, t->bd, pred);
            }
        } else {
            int ts_y2 = -1, ts_uv2 = -1;
            for (int k = 0; k < 19; ++k) {
                if (t->tx_w_tab[k] == bw && t->tx_h_tab[k] == bh) ts_y2 = k;
                if (t->tx_w_tab[k] == (bw >> 1)
                    && t->tx_h_tab[k] == (bh >> 1)) ts_uv2 = k;
            }
            ts = plane == 0 ? ts_y2 : ts_uv2;
            if (ts < 0) { tile_err(t, "intra ts"); return; }
            tt = plane == 0 ? 0 : (int)st->tt_uv_tab[ts * 13 + y_mode];
            int ftype = filt_type_for(t, plane, px, py);
            predict_intra(t, plane, y_mode, 0, px, py, pw, ph, -1, ftype,
                          pred);
            if (t->err) return;
        }
        ts_of[plane] = ts;
        tt_of[plane] = tt;
        const int32_t *srcp = t->src[plane];
        int stride = t->pw_buf[plane];
        for (int r = 0; r < ph; ++r)
            for (int c = 0; c < pw; ++c)
                resid[r * pw + c] =
                    srcp[(Py_ssize_t)(py + r) * stride + px + c]
                    - pred[r * pw + c];
        const Plan *plan = t->plans[plane][ts][tt];
        if (!plan) { tile_err(t, "missing plan"); return; }
        Txb *tb = &txbs[n_txb++];
        int cw = pw > 32 ? 32 : pw, ch = ph > 32 ? 32 : ph;
        tb->plane = plane; tb->ts = ts; tb->tt = tt;
        tb->px = px; tb->py = py; tb->w = cw; tb->h = ch;
        RdoqRun rr;
        int sk0, dc0;
        if (t->rdq_txb_skip) {
            txb_ctx_for(t, plane, px, py, ts, 1, &sk0, &dc0);
            rdoq_run_for(t, plane, ts, tt, sk0, dc0, is_inter, &rr);
            tb->eob = block_code_core_rdoq(plan, resid, pred, qc_full, rec,
                                           &rr);
        } else {
            tb->eob = block_code_core(plan, resid, pred, qc_full, rec);
        }
        /* pack the coded cw x ch coefficient band (block stride pw) */
        for (int r = 0; r < ch; ++r)
            for (int c = 0; c < cw; ++c)
                tb->qc[r * cw + c] = qc_full[r * pw + c];
        int32_t *rpn = t->rec[plane];
        if (tb->eob == 0 && is_inter) {
            /* skip recon = the MC pred itself (already clipped) */
            for (int r = 0; r < ph; ++r)
                memcpy(rpn + (Py_ssize_t)(py + r) * stride + px,
                       pred + r * pw, pw * sizeof(int32_t));
        } else {
            for (int r = 0; r < ph; ++r)
                memcpy(rpn + (Py_ssize_t)(py + r) * stride + px,
                       rec + r * pw, pw * sizeof(int32_t));
        }
        record_tx_geometry(t, plane, px, py, ts);
    }
    int skip = 1;
    for (int i = 0; i < n_txb; ++i)
        if (txbs[i].eob) { skip = 0; break; }

    /* ---- syntax ---- */
    int skip_ctx = 0;
    Py_ssize_t S = t->mi_cols;
    if (mi_row > t->t_r0)
        skip_ctx += t->skips[(Py_ssize_t)(mi_row - 1) * S + mi_col];
    if (mi_col > t->t_c0)
        skip_ctx += t->skips[(Py_ssize_t)mi_row * S + (mi_col - 1)];
    enc_symbol_adapt(&t->ec, skip, nb_row2(&t->cdf_skip, skip_ctx), 2);

    int ii_ctx = intra_inter_ctx(t, st, mi_row, mi_col);
    enc_symbol_adapt(&t->ec, is_inter,
                     nb_row2(&st->cdf_intra_inter, ii_ctx), 2);

    if (is_inter) {
        if (st->reference_select && (bw < bh ? bw : bh) >= 8) {
            int rm_ctx = reference_mode_ctx(t, st, mi_row, mi_col);
            enc_symbol_adapt(&t->ec, ref1 > 0,
                             nb_row2(&st->cdf_comp_inter, rm_ctx), 2);
        }
        if (ref1 > 0) {
            /* compound pair + mode + drl + MVDs
             * (frame_codec._code_comp_ref_frames/_code_compound_mode) */
            write_comp_ref_frames(t, st, mi_row, mi_col, ref, ref1);
            int cctx = compound_mode_ctx(stk.mode_context);
            enc_symbol_adapt(&t->ec, mode - NEAREST_NEARESTMV_M,
                             nb_row2(&st->cdf_inter_compound, cctx), 8);
            if (mode == NEW_NEWMV) {
                if (stk.n > 1) {
                    int w0 = stk.weight[0], w1 = stk.weight[1];
                    int dctx = (w0 >= REF_CAT_LEVEL && w1 >= REF_CAT_LEVEL)
                                   ? 0
                                   : (w0 >= REF_CAT_LEVEL
                                          ? 1
                                          : (w1 < REF_CAT_LEVEL ? 2 : 0));
                    enc_symbol_adapt(&t->ec, 0,
                                     nb_row2(&st->cdf_drl, dctx), 2);
                }
                /* ref mvs: the raw stack[0] pair (ref_mv_idx == 0) */
                enc_mv(t, st, mv_r, mv_c, stk.mv[0][0], stk.mv[0][1]);
                enc_mv(t, st, mv1_r, mv1_c, stk.mv[0][2], stk.mv[0][3]);
            }
            /* NEAREST_NEARESTMV: no drl, no mvd */
        } else {
        write_single_ref(t, st, mi_row, mi_col, ref);
        /* inter mode ladder */
        int mc_ctx = stk.mode_context;
        int newmv_ctx = mc_ctx & NEWMV_CTX_MASK;
        enc_symbol_adapt(&t->ec, mode != NEWMV,
                         nb_row2(&st->cdf_newmv, newmv_ctx), 2);
        if (mode != NEWMV) {
            int zero_ctx = (mc_ctx >> GLOBALMV_OFFSET) & GLOBALMV_CTX_MASK;
            enc_symbol_adapt(&t->ec, mode != GLOBALMV_MODE,
                             nb_row2(&st->cdf_zeromv, zero_ctx), 2);
            if (mode != GLOBALMV_MODE) {
                int ref_ctx = (mc_ctx >> REFMV_OFFSET) & REFMV_CTX_MASK;
                enc_symbol_adapt(&t->ec, mode == NEARMV,
                                 nb_row2(&st->cdf_refmv, ref_ctx), 2);
            }
        }
        /* drl (ref_mv_idx == 0) */
        if (mode == NEWMV) {
            for (int idx = 0; idx < 2; ++idx) {
                if (stk.n > idx + 1) {
                    int w0 = stk.weight[idx], w1 = stk.weight[idx + 1];
                    int ctx = (w0 >= REF_CAT_LEVEL && w1 >= REF_CAT_LEVEL)
                                  ? 0
                                  : (w0 >= REF_CAT_LEVEL ? 1
                                     : (w1 < REF_CAT_LEVEL ? 2 : 0));
                    enc_symbol_adapt(&t->ec, 0,
                                     nb_row2(&st->cdf_drl, ctx), 2);
                    break;   /* bit == 0 stops the ladder */
                }
            }
        } else if (mode == NEARMV) {
            for (int idx = 1; idx < 3; ++idx) {
                if (stk.n > idx + 1) {
                    int w0 = stk.weight[idx], w1 = stk.weight[idx + 1];
                    int ctx = (w0 >= REF_CAT_LEVEL && w1 >= REF_CAT_LEVEL)
                                  ? 0
                                  : (w0 >= REF_CAT_LEVEL ? 1
                                     : (w1 < REF_CAT_LEVEL ? 2 : 0));
                    enc_symbol_adapt(&t->ec, 0,
                                     nb_row2(&st->cdf_drl, ctx), 2);
                    break;
                }
            }
        }
        if (mode == NEWMV) {
            int rr = stk.ref_list[0][0], rc2 = stk.ref_list[0][1];
            if (stk.n > 1) { rr = stk.mv[0][0]; rc2 = stk.mv[0][1]; }
            enc_mv(t, st, mv_r, mv_c, rr, rc2);
        }
        }
    } else {
        /* intra mode syntax inside an inter frame */
        int grp = SIZE_GROUP_BY_ENUM[bse];
        enc_symbol_adapt(&t->ec, y_mode,
                         nb_row2(&st->cdf_y_mode, grp), 13);
        int use_delta = bw >= 8 && bh >= 8;
        if (use_delta && y_mode >= M_V && y_mode <= M_D67)
            enc_symbol_adapt(&t->ec, 0 + 3,
                             nb_row2(&t->cdf_angle, y_mode - 1), 7);
        if (t->num_planes > 1) {
            int cfl_allowed = bw <= 32 && bh <= 32;
            enc_symbol_adapt(&t->ec, y_mode,
                             nb_row3(&t->cdf_uv, cfl_allowed, y_mode),
                             cfl_allowed ? 14 : 13);
            if (use_delta && y_mode >= M_V && y_mode <= M_D67)
                enc_symbol_adapt(&t->ec, 0 + 3,
                                 nb_row2(&t->cdf_angle, y_mode - 1), 7);
        }
        if (t->enable_filter_intra && y_mode == M_DC && bw <= 32
            && bh <= 32)
            enc_symbol_adapt(&t->ec, 0,
                             nb_row2(&t->cdf_filter_intra, bse), 2);
    }

    record_mi_inter(t, st, mi_row, mi_col, w4, h4, is_inter, ref, mode,
                    mv_r, mv_c, y_mode, skip, ref1, mv1_r, mv1_c);

    /* ---- residual ---- */
    if (skip) {
        for (int i = 0; i < n_txb; ++i)
            update_txb_ctx(t, txbs[i].plane, txbs[i].px, txbs[i].py,
                           txbs[i].ts, 0);
        return;
    }
    for (int i = 0; i < n_txb; ++i) {
        Txb *tb = &txbs[i];
        int sk_ctx, dc_ctx;
        txb_ctx_for(t, tb->plane, tb->px, tb->py, tb->ts, 1, &sk_ctx,
                    &dc_ctx);
        int sig_nset = 0, sig_eset = 0, sig_sq = 0, sig_ind = 0;
        int ymc = y_mode;
        if (tb->plane == 0) {
            const int32_t *sig = is_inter ? st->sig_inter : st->sig_intra;
            sig_nset = sig[tb->ts * 4 + 0];
            sig_eset = sig[tb->ts * 4 + 1];
            sig_sq = sig[tb->ts * 4 + 2];
            sig_ind = sig[tb->ts * 4 + 3];
        }
        if (is_inter && tb->plane == 0 && sig_nset > 1) {
            /* inter tx-type signaling: cdf has no mode dim */
            int ts_ctx2 = t->txs_ctx_tab[tb->ts];
            uint16_t *skip_cdf = nb_row3(&t->cdf_txb_skip, ts_ctx2, sk_ctx);
            enc_symbol_adapt(&t->ec, tb->eob == 0, skip_cdf, 2);
            if (tb->eob == 0) {
                update_txb_ctx(t, tb->plane, tb->px, tb->py, tb->ts, 0);
                continue;
            }
            NB *b = &st->cdf_inter_ext_tx;
            uint16_t *cdf = (uint16_t *)b->data
                + ((Py_ssize_t)sig_eset * b->shape[1] + sig_sq)
                      * b->shape[2];
            enc_symbol_adapt(&t->ec, sig_ind, cdf, sig_nset);
            /* coeffs without re-writing txb_skip: inline the tail */
            int plane_type = tb->plane > 0;
            int ems = t->ems_tab[tb->ts];
            NB *ef = &t->cdf_eob_flag[ems];
            uint16_t *eob_cdf = nb_row3(ef, plane_type, 0);
            int eob_pt;
            if (tb->eob < 33) eob_pt = eob_to_pos_small[tb->eob];
            else {
                int q = (tb->eob - 1) >> 5;
                eob_pt = eob_to_pos_large[q > 16 ? 16 : q];
            }
            uint16_t *eob_extra_cdf = nb_row4(&t->cdf_eob_extra, ts_ctx2,
                                              plane_type, eob_pt);
            uint16_t *base = nb_row4(&t->cdf_base, ts_ctx2, plane_type, 0);
            uint16_t *base_eob = nb_row4(&t->cdf_base_eob, ts_ctx2,
                                         plane_type, 0);
            int br_idx = ts_ctx2 < 3 ? ts_ctx2 : 3;
            uint16_t *br = nb_row4(&t->cdf_br, br_idx, plane_type, 0);
            uint16_t *dc_sign = nb_row3(&t->cdf_dc_sign, plane_type,
                                        dc_ctx);
            long long cul = ec_write_coeffs_core(
                &t->ec, tb->qc, t->scans[tb->ts], tb->eob, tb->w, tb->h,
                TX_CLASS_2D, eob_cdf, eob_extra_cdf,
                base, (int)t->cdf_base.shape[3],
                base_eob, (int)t->cdf_base_eob.shape[3],
                br, (int)t->cdf_br.shape[3],
                dc_sign, t->tx_shape_tab[tb->ts]);
            update_txb_ctx(t, tb->plane, tb->px, tb->py, tb->ts, (int)cul);
        } else {
            write_txb(t, tb, ymc, sk_ctx, dc_ctx,
                      tb->plane == 0 && !is_inter ? sig_nset : 0, sig_eset,
                      sig_sq, sig_ind);
        }
    }
    (void)ts_of; (void)tt_of;
}

/* ------------------------------------------------------------------ */
/* module entry                                                       */
/* ------------------------------------------------------------------ */

static int nb_get(PyObject *seq, Py_ssize_t i, NB *out) {
    PyObject *o = PyTuple_GET_ITEM(seq, i);
    Py_buffer v;
    if (PyObject_GetBuffer(o, &v, PyBUF_STRIDES) < 0) return -1;
    out->data = v.buf;
    out->ndim = v.ndim;
    for (int d = 0; d < v.ndim && d < 4; ++d) out->shape[d] = v.shape[d];
    PyBuffer_Release(&v);   /* caller keeps the args tuple alive */
    return 0;
}

static void *pbuf(PyObject *seq, Py_ssize_t i) {
    NB b;
    if (nb_get(seq, i, &b) < 0) return NULL;
    return b.data;
}

/* shared setup for both entries; returns 0 on success */
static int tile_setup(Tile *t, PyObject *ints, PyObject *planes,
                      PyObject *ctxs, PyObject *cdfs, PyObject *consts,
                      PyObject *scans, PyObject *plans) {
    long iv[16];
    for (int i = 0; i < 16; ++i)
        iv[i] = PyLong_AsLong(PyTuple_GET_ITEM(ints, i));
    t->mi_rows = iv[0]; t->mi_cols = iv[1];
    t->t_r0 = iv[2]; t->t_c0 = iv[3]; t->t_r1 = iv[4]; t->t_c1 = iv[5];
    t->buf_w = iv[6]; t->buf_h = iv[7]; t->sb_size = iv[8]; t->bd = iv[9];
    t->num_planes = iv[10];
    t->aligned_w = iv[12]; t->aligned_h = iv[13];
    t->disable_edge_filter = iv[14];
    t->enable_filter_intra = iv[15];

    for (int p = 0; p < 3; ++p) {
        t->src[p] = (const int32_t *)pbuf(planes, p);
        t->rec[p] = (int32_t *)pbuf(planes, 3 + p);
        t->pw_buf[p] = p ? t->buf_w >> 1 : t->buf_w;
        t->ph_buf[p] = p ? t->buf_h >> 1 : t->buf_h;
    }
    t->y_modes = (int32_t *)pbuf(ctxs, 0);
    t->skips = (int32_t *)pbuf(ctxs, 1);
    t->above_part = (int32_t *)pbuf(ctxs, 2);
    t->left_part = (int32_t *)pbuf(ctxs, 3);
    for (int p = 0; p < 3; ++p) {
        t->txb_above[p] = (int32_t *)pbuf(ctxs, 4 + p);
        t->txb_left[p] = (int32_t *)pbuf(ctxs, 7 + p);
        NB g;
        nb_get(ctxs, 10 + p, &g);
        t->txw[p] = (int32_t *)g.data;
        t->grid_h[p] = (int)g.shape[0];
        t->grid_w[p] = (int)g.shape[1];
        t->txh[p] = (int32_t *)pbuf(ctxs, 13 + p);
        t->bex[p] = (uint8_t *)pbuf(ctxs, 16 + p);
        t->bey[p] = (uint8_t *)pbuf(ctxs, 19 + p);
    }
    nb_get(cdfs, 0, &t->cdf_partition);
    nb_get(cdfs, 1, &t->cdf_skip);
    nb_get(cdfs, 2, &t->cdf_kf_y);
    nb_get(cdfs, 3, &t->cdf_angle);
    nb_get(cdfs, 4, &t->cdf_uv);
    nb_get(cdfs, 5, &t->cdf_ext_tx);
    nb_get(cdfs, 6, &t->cdf_txb_skip);
    for (int k = 0; k < 7; ++k) nb_get(cdfs, 7 + k, &t->cdf_eob_flag[k]);
    nb_get(cdfs, 14, &t->cdf_eob_extra);
    nb_get(cdfs, 15, &t->cdf_base);
    nb_get(cdfs, 16, &t->cdf_base_eob);
    nb_get(cdfs, 17, &t->cdf_br);
    nb_get(cdfs, 18, &t->cdf_dc_sign);
    nb_get(cdfs, 19, &t->cdf_filter_intra);

    t->sm_weights = (const int32_t *)pbuf(consts, 0);
    t->dr_derivative = (const int32_t *)pbuf(consts, 1);
    for (int k = 0; k < 7; ++k) {
        t->has_tr[k] = (const uint8_t *)pbuf(consts, 2 + k);
        t->has_bl[k] = (const uint8_t *)pbuf(consts, 9 + k);
    }
    t->tx_w_tab = (const int32_t *)pbuf(consts, 16);
    t->tx_h_tab = (const int32_t *)pbuf(consts, 17);
    t->txs_ctx_tab = (const int32_t *)pbuf(consts, 18);
    t->tx_shape_tab = (const int32_t *)pbuf(consts, 19);
    t->ems_tab = (const int32_t *)pbuf(consts, 20);

    for (int ts = 0; ts < 19; ++ts) {
        PyObject *o = PyTuple_GET_ITEM(scans, ts);
        if (o == Py_None) { t->scans[ts] = NULL; continue; }
        Py_buffer v;
        if (PyObject_GetBuffer(o, &v, PyBUF_SIMPLE) < 0) return -1;
        t->scans[ts] = (const int16_t *)v.buf;
        PyBuffer_Release(&v);
    }
    Py_ssize_t n_plans = PyTuple_GET_SIZE(plans);
    for (Py_ssize_t k = 0; k < n_plans; ++k) {
        PyObject *o = PyTuple_GET_ITEM(plans, k);
        if (o == Py_None) continue;
        Plan *pl = (Plan *)PyCapsule_GetPointer(o, "block_plan");
        if (!pl) return -1;
        int plane = (int)(k / (19 * 16));
        int ts = (int)((k / 16) % 19);
        int tt = (int)(k % 16);
        t->plans[plane][ts][tt] = pl;
    }
    return 0;
}

static PyObject *tile_run(Tile *t) {
    if (ec_core_init(&t->ec) < 0) return PyErr_NoMemory();
    int sb_mi = t->sb_size / MI;
    for (int mi_row = t->t_r0; mi_row < t->t_r1 && !t->err; mi_row += sb_mi)
        for (int mi_col = t->t_c0; mi_col < t->t_c1 && !t->err;
             mi_col += sb_mi)
            tile_partition(t, t->sb_size, mi_row, mi_col);

    PyObject *out = NULL;
    if (t->err) {
        PyErr_Format(PyExc_ValueError, "coder_native: %s", t->errmsg);
    } else if (t->part_i != t->part_n
               || (!t->inter && t->mode_i != t->mode_n)) {
        PyErr_Format(PyExc_ValueError,
                     "coder_native: plan mismatch (%zd/%zd parts, %zd/%zd"
                     " modes)", t->part_i, t->part_n, t->mode_i, t->mode_n);
    } else {
        size_t cap = t->ec.offs + 8;
        unsigned char *tmp = (unsigned char *)malloc(cap);
        if (!tmp) {
            PyErr_NoMemory();
        } else {
            size_t total = ec_core_done(&t->ec, tmp);
            out = PyBytes_FromStringAndSize((const char *)tmp,
                                            (Py_ssize_t)total);
            free(tmp);
        }
    }
    ec_core_free(&t->ec);
    return out;
}

/* rdoq arg: None, or (txb_skip, base_eob, base, eob_extra, dc_sign,
 * lps, eob_cost, lambda_int) with the full frame tables from
 * ops/rdoq.build_tables */
static int tile_parse_rdoq(Tile *t, PyObject *rdoq) {
    if (!rdoq || rdoq == Py_None) return 0;
    t->rdq_txb_skip = (const int32_t *)pbuf(rdoq, 0);
    t->rdq_base_eob = (const int32_t *)pbuf(rdoq, 1);
    t->rdq_base = (const int32_t *)pbuf(rdoq, 2);
    t->rdq_eob_extra = (const int32_t *)pbuf(rdoq, 3);
    t->rdq_dc_sign = (const int32_t *)pbuf(rdoq, 4);
    t->rdq_lps = (const int32_t *)pbuf(rdoq, 5);
    t->rdq_eob_cost = (const int32_t *)pbuf(rdoq, 6);
    t->rdq_lambda = PyLong_AsLongLong(PyTuple_GET_ITEM(rdoq, 7));
    if (!t->rdq_txb_skip || !t->rdq_base_eob || !t->rdq_base
        || !t->rdq_eob_extra || !t->rdq_dc_sign || !t->rdq_lps
        || !t->rdq_eob_cost)
        return -1;
    return 0;
}

/*
 * code_intra_tile(ints, planes, ctxs, cdfs, consts, scans, plans,
 *                 part_seq, mode_seq[, rdoq]) -> bytes
 */
static PyObject *code_intra_tile(PyObject *self, PyObject *args) {
    PyObject *ints, *planes, *ctxs, *cdfs, *consts, *scans, *plans;
    PyObject *rdoq = NULL;
    Py_buffer part_v, mode_v;
    if (!PyArg_ParseTuple(args, "OOOOOOOy*y*|O", &ints, &planes, &ctxs,
                          &cdfs, &consts, &scans, &plans, &part_v, &mode_v,
                          &rdoq))
        return NULL;
    Tile t;
    memset(&t, 0, sizeof(t));
    if (tile_setup(&t, ints, planes, ctxs, cdfs, consts, scans, plans) < 0
        || tile_parse_rdoq(&t, rdoq) < 0) {
        PyBuffer_Release(&part_v); PyBuffer_Release(&mode_v);
        return NULL;
    }
    t.part_seq = (const int8_t *)part_v.buf;
    t.part_n = part_v.len;
    t.mode_seq = (const int32_t *)mode_v.buf;
    t.mode_n = mode_v.len / (16 * 4);
    PyObject *out = tile_run(&t);
    PyBuffer_Release(&part_v);
    PyBuffer_Release(&mode_v);
    return out;
}

/*
 * code_inter_tile(ints, planes, ctxs, cdfs, consts, scans, plans,
 *                 part_seq, inter_ints, mi_arrays, skip_grids, refs,
 *                 maps, mvs, inter_cdfs, nmv, sig) -> bytes
 */
static PyObject *code_inter_tile(PyObject *self, PyObject *args) {
    PyObject *ints, *planes, *ctxs, *cdfs, *consts, *scans, *plans;
    PyObject *iints, *mia, *sgrids, *refs, *maps, *mvs, *icdfs, *nmv, *sig;
    PyObject *rdoq = NULL;
    Py_buffer part_v;
    if (!PyArg_ParseTuple(args, "OOOOOOOy*OOOOOOOOO|O", &ints, &planes,
                          &ctxs, &cdfs, &consts, &scans, &plans, &part_v,
                          &iints, &mia, &sgrids, &refs, &maps, &mvs, &icdfs,
                          &nmv, &sig, &rdoq))
        return NULL;
    Tile t;
    InterState st;
    memset(&t, 0, sizeof(t));
    memset(&st, 0, sizeof(st));
    if (tile_setup(&t, ints, planes, ctxs, cdfs, consts, scans, plans) < 0
        || tile_parse_rdoq(&t, rdoq) < 0) {
        PyBuffer_Release(&part_v);
        return NULL;
    }
    t.part_seq = (const int8_t *)part_v.buf;
    t.part_n = part_v.len;
    t.inter = &st;

    st.frame_w = (int)PyLong_AsLong(PyTuple_GET_ITEM(iints, 0));
    st.frame_h = (int)PyLong_AsLong(PyTuple_GET_ITEM(iints, 1));
    st.ref_pad = (int)PyLong_AsLong(PyTuple_GET_ITEM(iints, 2));
    st.reference_select = (int)PyLong_AsLong(PyTuple_GET_ITEM(iints, 3));
    st.pen_q8 = PyTuple_GET_SIZE(iints) > 4
        ? (int)PyLong_AsLong(PyTuple_GET_ITEM(iints, 4)) : 256;

    st.mi_ref = (int32_t *)pbuf(mia, 0);
    st.mi_ref1 = (int32_t *)pbuf(mia, 1);
    st.mi_mode = (int32_t *)pbuf(mia, 2);
    st.mi_mvr = (int32_t *)pbuf(mia, 3);
    st.mi_mvc = (int32_t *)pbuf(mia, 4);
    st.mi_mv1r = (int32_t *)pbuf(mia, 5);
    st.mi_mv1c = (int32_t *)pbuf(mia, 6);
    st.mi_bw4 = (int32_t *)pbuf(mia, 7);
    st.mi_bh4 = (int32_t *)pbuf(mia, 8);
    for (int p = 0; p < 3; ++p)
        st.skip_grid[p] = (uint8_t *)pbuf(sgrids, p);

    /* refs: tuple of (name, y, u, v) */
    Py_ssize_t n_refs = PyTuple_GET_SIZE(refs);
    for (Py_ssize_t k = 0; k < n_refs; ++k) {
        PyObject *ent = PyTuple_GET_ITEM(refs, k);
        int name = (int)PyLong_AsLong(PyTuple_GET_ITEM(ent, 0));
        if (name < 1 || name > 7) continue;
        NB y, u, v;
        nb_get(ent, 1, &y);
        nb_get(ent, 2, &u);
        nb_get(ent, 3, &v);
        st.ref_y[name] = (const int32_t *)y.data;
        st.ref_u[name] = (const int32_t *)u.data;
        st.ref_v[name] = (const int32_t *)v.data;
        st.ref_h[name] = (int)y.shape[0];
        st.ref_w[name] = (int)y.shape[1];
        st.ref_ch[name] = (int)u.shape[0];
        st.ref_cw[name] = (int)u.shape[1];
    }

    /* decision maps: 10 pairs (is_inter uint8, mode int8) */
    for (int k = 0; k < 10; ++k) {
        NB a, b;
        nb_get(maps, 2 * k, &a);
        nb_get(maps, 2 * k + 1, &b);
        st.is_inter_map[k] = (const uint8_t *)a.data;
        st.mode_map[k] = (const int8_t *)b.data;
        st.map_h[k] = (int)a.shape[0];
        st.map_w[k] = (int)a.shape[1];
    }
    {
        NB a, b, c, d, e, f, g, h;
        nb_get(mvs, 0, &a);
        nb_get(mvs, 1, &b);
        nb_get(mvs, 2, &c);
        nb_get(mvs, 3, &d);
        nb_get(mvs, 4, &e);
        nb_get(mvs, 5, &f);
        nb_get(mvs, 6, &g);
        nb_get(mvs, 7, &h);
        st.mv16_r = (const int32_t *)a.data;
        st.mv16_c = (const int32_t *)b.data;
        st.sel16 = (const int32_t *)c.data;
        st.fwd16 = (const int32_t *)d.data;
        st.bwd16 = (const int32_t *)e.data;
        st.mv16_1r = (const int32_t *)f.data;
        st.mv16_1c = (const int32_t *)g.data;
        st.n_names = (int)h.shape[0];
        if (st.n_names > 4) st.n_names = 4;
        for (int k = 0; k < st.n_names; ++k)
            st.names[k] = ((const int32_t *)h.data)[k];
        st.nc16 = (int)a.shape[1];
    }
    nb_get(icdfs, 0, &st.cdf_intra_inter);
    nb_get(icdfs, 1, &st.cdf_single_ref);
    nb_get(icdfs, 2, &st.cdf_newmv);
    nb_get(icdfs, 3, &st.cdf_zeromv);
    nb_get(icdfs, 4, &st.cdf_refmv);
    nb_get(icdfs, 5, &st.cdf_drl);
    nb_get(icdfs, 6, &st.cdf_y_mode);
    nb_get(icdfs, 7, &st.cdf_inter_ext_tx);
    nb_get(icdfs, 8, &st.cdf_comp_inter);
    nb_get(icdfs, 9, &st.cdf_comp_ref_type);
    nb_get(icdfs, 10, &st.cdf_comp_ref);
    nb_get(icdfs, 11, &st.cdf_comp_bwdref);
    nb_get(icdfs, 12, &st.cdf_inter_compound);

    st.nmv_joints = (uint16_t *)pbuf(nmv, 0);
    for (int ci = 0; ci < 2; ++ci) {
        int off = 1 + ci * 8;
        st.nmv_classes[ci] = (uint16_t *)pbuf(nmv, off + 0);
        st.nmv_class0_fp[ci] = (uint16_t *)pbuf(nmv, off + 1);
        st.nmv_fp[ci] = (uint16_t *)pbuf(nmv, off + 2);
        st.nmv_sign[ci] = (uint16_t *)pbuf(nmv, off + 3);
        st.nmv_class0_hp[ci] = (uint16_t *)pbuf(nmv, off + 4);
        st.nmv_hp[ci] = (uint16_t *)pbuf(nmv, off + 5);
        st.nmv_class0[ci] = (uint16_t *)pbuf(nmv, off + 6);
        st.nmv_bits[ci] = (uint16_t *)pbuf(nmv, off + 7);
    }
    st.sig_inter = (const int32_t *)pbuf(sig, 0);
    st.sig_intra = (const int32_t *)pbuf(sig, 1);
    st.tt_uv_tab = (const int32_t *)pbuf(sig, 2);
    st.interp_taps = (const int32_t *)pbuf(sig, 3);
    st.sign_bias = (const int32_t *)pbuf(sig, 4);

    PyObject *out = tile_run(&t);
    PyBuffer_Release(&part_v);
    return out;
}

static PyMethodDef methods[] = {
    {"code_intra_tile", code_intra_tile, METH_VARARGS, NULL},
    {"code_inter_tile", code_inter_tile, METH_VARARGS, NULL},
    {NULL, NULL, 0, NULL},
};

static PyModuleDef mod = {
    PyModuleDef_HEAD_INIT, "coder_native",
    "Native intra tile coder (plan replay)", -1, methods,
};

PyMODINIT_FUNC PyInit_coder_native(void) {
    return PyModule_Create(&mod);
}
