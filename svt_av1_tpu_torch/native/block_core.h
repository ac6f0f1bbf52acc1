/*
 * Core fused per-block coding kernel (pure C, no Python): forward
 * transform -> quantize_b -> eob -> dequant -> inverse transform ->
 * reconstruction, in one call.  Shared by the block_native module
 * (Python-facing) and the coder_native tile coder (C-to-C).
 *
 * All math reproduces ops/transforms.py (fwd_txfm2d / inv_txfm2d_add)
 * and ops/quant.py (quantize_b) bit for bit — the butterfly networks
 * come from the same extracted stage tables (ops/data/txfm_stages.npz),
 * not from the reference's C.  Equivalence is enforced by
 * tests/test_native_block.py.
 */
#ifndef SVT_TPU_BLOCK_CORE_H
#define SVT_TPU_BLOCK_CORE_H

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "rdoq_core.h"

#define KIND_NET 0
#define KIND_IDTX 1
#define KIND_ADST4 2

#define BLK_MAXN 64

typedef struct {
    const int32_t *stmts;   /* [k, 5] */
    const int32_t *offs;    /* [s+1] */
    const int8_t *clamp;    /* [k] */
    const int32_t *cospi;   /* [64] */
    ptrdiff_t n_stages;
    int cos_bit;
    int kind;               /* KIND_* */
    int n;                  /* transform length */
} Net1d;

typedef struct {
    int w, h, bd;
    int fs0, fs1, fs2;      /* forward shift triple */
    int is0, is1;           /* inverse shifts */
    int fwd_flip_v, fwd_flip_h;
    int rect;               /* |log2(w/h)| == 1 */
    int inv_clamp_row, inv_clamp_col;
    Net1d fcol, frow, irow, icol;
    const int32_t *sinpi;   /* [5] for adst4 at the relevant bit */
    const int32_t *sinpi_inv;
    /* quant (column 0 = dc, 1 = ac), already log_scale-adjusted zbin/rnd */
    int32_t zbin[2], rnd[2], quant[2], qshift[2], dequant[2];
    /* fast-path (fp) quantizer vectors (rnd_fp log_scale-adjusted) */
    int32_t quant_fp[2], rnd_fp[2];
    int log_scale;
    const int16_t *scan;    /* [n_scan] over the ch x cw coef region */
    int n_scan, cw, ch;
    void *refs;             /* module-owned keep-alive pointer */
} Plan;

static inline int32_t wrap_mul(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a * (uint32_t)b);
}
static inline int32_t wrap_add(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}

/* svt_av1_round_shift_array: bit>0 rounds right, bit<0 multiplies */
static inline int32_t round_shift(int32_t x, int bit) {
    if (bit == 0) return x;
    if (bit > 0) return wrap_add(x, 1 << (bit - 1)) >> bit;
    return (int32_t)((uint32_t)x << (-bit));
}

#define NEW_SQRT2_BITS 12
#define NEW_SQRT2 5793
#define NEW_INV_SQRT2 2896

static inline int32_t mul_sqrt2_round(int32_t x, int32_t mult) {
    int32_t hi = x >> 15;
    int32_t lo = x - (int32_t)((uint32_t)hi << 15);
    return wrap_add(wrap_mul(hi, mult * 8),
                    wrap_add(wrap_mul(lo, mult), 1 << (NEW_SQRT2_BITS - 1))
                        >> NEW_SQRT2_BITS);
}

static void run_net(const Net1d *net, int32_t *x, int clamp_bit) {
    int32_t bufa[BLK_MAXN], bufb[BLK_MAXN];
    int32_t *cur = bufa, *nxt = bufb;
    memcpy(cur, x, net->n * sizeof(int32_t));
    int32_t rnd = 1 << (net->cos_bit - 1);
    int32_t cmax = clamp_bit > 0 ? (int32_t)((1u << (clamp_bit - 1)) - 1) : 0;
    int32_t cmin = clamp_bit > 0 ? (int32_t)(-(1 << (clamp_bit - 1))) : 0;
    ptrdiff_t n_out = net->offs[net->n_stages] - net->offs[net->n_stages - 1];
    for (ptrdiff_t s = 0; s < net->n_stages; ++s) {
        const int32_t *st = net->stmts + net->offs[s] * 5;
        const int8_t *cl = net->clamp + net->offs[s];
        ptrdiff_t m = net->offs[s + 1] - net->offs[s];
        for (ptrdiff_t i = 0; i < m; ++i) {
            int kind = st[i * 5 + 0];
            int32_t ca = st[i * 5 + 1], ia = st[i * 5 + 2];
            int32_t cb = st[i * 5 + 3], ib = st[i * 5 + 4];
            int32_t v;
            if (kind == 1) {
                int32_t wa = ca < 0 ? -net->cospi[-ca - 1] : net->cospi[ca - 1];
                int32_t wb = cb < 0 ? -net->cospi[-cb - 1]
                           : (cb > 0 ? net->cospi[cb - 1] : 0);
                v = wrap_add(wrap_add(wrap_mul(wa, cur[ia]),
                                      wrap_mul(wb, cur[ib])), rnd)
                    >> net->cos_bit;
            } else {
                v = wrap_add(wrap_mul(ca, cur[ia]), wrap_mul(cb, cur[ib]));
                if (clamp_bit > 0 && cl[i]) {
                    if (v > cmax) v = cmax;
                    else if (v < cmin) v = cmin;
                }
            }
            nxt[i] = v;
        }
        int32_t *t = cur; cur = nxt; nxt = t;
    }
    memcpy(x, cur, n_out * sizeof(int32_t));
}

/*
 * Lane-parallel variant: x is [n][lanes] (row-major, stride = lanes).
 * Each statement applies to every lane; with lanes = the orthogonal
 * transform dimension the compiler vectorizes the inner loop (the TPU
 * build's host-side stand-in for the reference's SIMD transforms).
 */
static void run_net_lanes(const Net1d *net, int32_t *x, int lanes,
                          int clamp_bit) {
    int32_t bufa[BLK_MAXN * BLK_MAXN], bufb[BLK_MAXN * BLK_MAXN];
    int32_t *cur = bufa, *nxt = bufb;
    memcpy(cur, x, (size_t)net->n * lanes * sizeof(int32_t));
    int32_t rnd = 1 << (net->cos_bit - 1);
    int32_t cmax = clamp_bit > 0 ? (int32_t)((1u << (clamp_bit - 1)) - 1) : 0;
    int32_t cmin = clamp_bit > 0 ? (int32_t)(-(1 << (clamp_bit - 1))) : 0;
    ptrdiff_t n_out = net->offs[net->n_stages] - net->offs[net->n_stages - 1];
    for (ptrdiff_t s = 0; s < net->n_stages; ++s) {
        const int32_t *st = net->stmts + net->offs[s] * 5;
        const int8_t *cl = net->clamp + net->offs[s];
        ptrdiff_t m = net->offs[s + 1] - net->offs[s];
        for (ptrdiff_t i = 0; i < m; ++i) {
            int kind = st[i * 5 + 0];
            int32_t ca = st[i * 5 + 1], ia = st[i * 5 + 2];
            int32_t cb = st[i * 5 + 3], ib = st[i * 5 + 4];
            const int32_t *a = cur + ia * lanes;
            const int32_t *b = cur + ib * lanes;
            int32_t *o = nxt + i * lanes;
            if (kind == 1) {
                int32_t wa = ca < 0 ? -net->cospi[-ca - 1] : net->cospi[ca - 1];
                int32_t wb = cb < 0 ? -net->cospi[-cb - 1]
                           : (cb > 0 ? net->cospi[cb - 1] : 0);
                int cbit = net->cos_bit;
                for (int j = 0; j < lanes; ++j)
                    o[j] = wrap_add(wrap_add(wrap_mul(wa, a[j]),
                                             wrap_mul(wb, b[j])), rnd) >> cbit;
            } else if (clamp_bit > 0 && cl[i]) {
                for (int j = 0; j < lanes; ++j) {
                    int32_t v = wrap_add(wrap_mul(ca, a[j]), wrap_mul(cb, b[j]));
                    o[j] = v > cmax ? cmax : (v < cmin ? cmin : v);
                }
            } else {
                for (int j = 0; j < lanes; ++j)
                    o[j] = wrap_add(wrap_mul(ca, a[j]), wrap_mul(cb, b[j]));
            }
        }
        int32_t *t = cur; cur = nxt; nxt = t;
    }
    memcpy(x, cur, (size_t)n_out * lanes * sizeof(int32_t));
}

static void run_idtx_lanes(int32_t *x, int n, int lanes) {
    switch (n) {
    case 4:
        for (int i = 0; i < 4 * lanes; ++i) x[i] = mul_sqrt2_round(x[i], NEW_SQRT2);
        break;
    case 8:
        for (int i = 0; i < 8 * lanes; ++i) x[i] = wrap_mul(x[i], 2);
        break;
    case 16:
        for (int i = 0; i < 16 * lanes; ++i)
            x[i] = mul_sqrt2_round(x[i], 2 * NEW_SQRT2);
        break;
    case 32:
        for (int i = 0; i < 32 * lanes; ++i) x[i] = wrap_mul(x[i], 4);
        break;
    }
}

static void run_adst4_lanes(int32_t *x, int lanes, const int32_t *sp, int bit,
                            int inverse) {
    for (int j = 0; j < lanes; ++j) {
        int32_t x0 = x[0 * lanes + j], x1 = x[1 * lanes + j];
        int32_t x2 = x[2 * lanes + j], x3 = x[3 * lanes + j];
        int32_t o0, o1, o2, o3;
        if (inverse) {
            int32_t s0 = wrap_mul(sp[1], x0);
            int32_t s1 = wrap_mul(sp[2], x0);
            int32_t s2 = wrap_mul(sp[3], x1);
            int32_t s3 = wrap_mul(sp[4], x2);
            int32_t s4 = wrap_mul(sp[1], x2);
            int32_t s5 = wrap_mul(sp[2], x3);
            int32_t s6 = wrap_mul(sp[4], x3);
            int32_t s7 = wrap_add(x0 - x2, x3);
            s0 = wrap_add(s0, s3);
            s1 = s1 - s4;
            s3 = s2;                     /* python: s3 takes the OLD s2 */
            s2 = wrap_mul(sp[3], s7);
            s0 = wrap_add(s0, s5);
            s1 = s1 - s6;
            o0 = wrap_add(s0, s3);
            o1 = wrap_add(s1, s3);
            o2 = s2;
            o3 = wrap_add(s0, s1) - s3;
        } else {
            int32_t s0 = wrap_mul(sp[1], x0);
            int32_t s1 = wrap_mul(sp[4], x0);
            int32_t s2 = wrap_mul(sp[2], x1);
            int32_t s3 = wrap_mul(sp[1], x1);
            int32_t s4 = wrap_mul(sp[3], x2);
            int32_t s5 = wrap_mul(sp[4], x3);
            int32_t s6 = wrap_mul(sp[2], x3);
            int32_t s7 = wrap_add(x0, x1) - x3;
            int32_t t0 = wrap_add(wrap_add(s0, s2), s5);
            int32_t t1 = wrap_mul(sp[3], s7);
            int32_t t2 = wrap_add(s1 - s3, s6);
            int32_t t3 = s4;
            o0 = wrap_add(t0, t3);
            o1 = t1;
            o2 = t2 - t3;
            o3 = wrap_add(t2 - t0, t3);
        }
        x[0 * lanes + j] = round_shift(o0, bit);
        x[1 * lanes + j] = round_shift(o1, bit);
        x[2 * lanes + j] = round_shift(o2, bit);
        x[3 * lanes + j] = round_shift(o3, bit);
    }
}

/* One 1-D pass over a [n][lanes] panel. */
static void run_1d_lanes(const Net1d *net, const int32_t *sinpi, int32_t *x,
                         int lanes, int clamp_bit, int inverse) {
    if (net->kind == KIND_IDTX) run_idtx_lanes(x, net->n, lanes);
    else if (net->kind == KIND_ADST4)
        run_adst4_lanes(x, lanes, sinpi, net->cos_bit, inverse);
    else run_net_lanes(net, x, lanes, clamp_bit);
}

static inline int32_t clampi(int32_t v, int32_t lo, int32_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

/* Transpose [rows][cols] -> [cols][rows]. */
static void blk_transpose(const int32_t *in, int rows, int cols, int32_t *out) {
    for (int r = 0; r < rows; ++r)
        for (int c = 0; c < cols; ++c)
            out[c * rows + r] = in[r * cols + c];
}

/*
 * Fused fwd TX + quantize_b + eob + dequant + inverse TX + recon.
 * resid/pred: [h][w] int32 (row-major, contiguous); qc_out/rec_out
 * likewise.  Returns eob.  Column passes run lane-parallel across the
 * orthogonal dimension via transposes.
 */
static int block_code_core_rdoq(const Plan *p, const int32_t *resid,
                                const int32_t *pred, int32_t *qc_out,
                                int32_t *rec_out, const RdoqRun *rdoq) {
    int w = p->w, h = p->h;
    int32_t buf[BLK_MAXN * BLK_MAXN], tbuf[BLK_MAXN * BLK_MAXN];
    int32_t dq[BLK_MAXN * BLK_MAXN], tp[BLK_MAXN * BLK_MAXN];

    /* ---- forward: column pass (over h), then row pass (over w) ---- */
    for (int i = 0; i < h * w; ++i) buf[i] = resid[i];
    if (p->fwd_flip_v)
        for (int r = 0; r < h / 2; ++r)
            for (int c = 0; c < w; ++c) {
                int32_t t = buf[r * w + c];
                buf[r * w + c] = buf[(h - 1 - r) * w + c];
                buf[(h - 1 - r) * w + c] = t;
            }
    /* column pass on [h][w] directly: lanes = w */
    for (int i = 0; i < h * w; ++i) buf[i] = round_shift(buf[i], p->fs0);
    run_1d_lanes(&p->fcol, p->sinpi, buf, w, 0, 0);
    for (int i = 0; i < h * w; ++i) tbuf[i] = round_shift(buf[i], p->fs1);
    if (p->fwd_flip_h)
        for (int r = 0; r < h; ++r)
            for (int c = 0; c < w / 2; ++c) {
                int32_t t = tbuf[r * w + c];
                tbuf[r * w + c] = tbuf[r * w + (w - 1 - c)];
                tbuf[r * w + (w - 1 - c)] = t;
            }
    /* row pass: transpose to [w][h], lanes = h, transpose back */
    blk_transpose(tbuf, h, w, tp);
    run_1d_lanes(&p->frow, p->sinpi, tp, h, 0, 0);
    blk_transpose(tp, w, h, tbuf);
    for (int i = 0; i < h * w; ++i) {
        int32_t v = round_shift(tbuf[i], p->fs2);
        if (p->rect) v = mul_sqrt2_round(v, NEW_SQRT2);
        tbuf[i] = v;
    }
    /* 64-point transforms only keep the top-left 32x32 coefficients
     * (fwd_txfm2d's band mask) */
    if (w > 32 || h > 32)
        for (int r = 0; r < h; ++r)
            for (int c = 0; c < w; ++c)
                if (r >= 32 || c >= 32) tbuf[r * w + c] = 0;

    /* ---- quantize (b, or fp when the trellis follows) + dequant ---- */
    int ls = p->log_scale;
    if (rdoq && rdoq->use_fp) {
        /* quantize_fp (svt_av1_quantize_fp_c semantics; ops/quant.py
         * quantize_fp): no zbin dead-zone */
        for (int i = 0; i < h * w; ++i) {
            int dc = (i == 0);
            int32_t cv = tbuf[i];
            int32_t sign = cv < 0 ? -1 : 1;
            int32_t ac = cv < 0 ? -cv : cv;
            if ((ac << (1 + ls)) >= p->dequant[dc ? 0 : 1]) {
                int32_t tmp = ac + p->rnd_fp[dc ? 0 : 1];
                if (tmp > 32767) tmp = 32767;
                if (tmp < -32768) tmp = -32768;
                int32_t tmp32 = (int32_t)(((int64_t)tmp
                                           * p->quant_fp[dc ? 0 : 1])
                                          >> (16 - ls));
                qc_out[i] = sign * tmp32;
                dq[i] = tmp32 ? sign * ((tmp32 * p->dequant[dc ? 0 : 1])
                                        >> ls)
                              : 0;
            } else {
                qc_out[i] = 0;
                dq[i] = 0;
            }
        }
    } else {
        for (int i = 0; i < h * w; ++i) {
            int dc = (i == 0);
            int32_t cv = tbuf[i];
            int32_t sign = cv < 0 ? -1 : 1;
            int32_t ac = cv < 0 ? -cv : cv;
            if (ac >= p->zbin[!dc ? 1 : 0]) {
                int32_t tmp = ac + p->rnd[dc ? 0 : 1];
                if (tmp > 32767) tmp = 32767;
                if (tmp < -32768) tmp = -32768;
                int64_t t1 = ((int64_t)tmp * p->quant[dc ? 0 : 1]) >> 16;
                int32_t tmp32 = (int32_t)((((int32_t)t1 + tmp)
                                           * (int64_t)p->qshift[dc ? 0 : 1])
                                          >> (16 - ls));
                qc_out[i] = sign * tmp32;
                dq[i] = sign * ((tmp32 * p->dequant[dc ? 0 : 1]) >> ls);
            } else {
                qc_out[i] = 0;
                dq[i] = 0;
            }
        }
    }

    /* ---- eob over the scan of the cw x ch region ---- */
    int eob = 0;
    for (int k = 0; k < p->n_scan; ++k) {
        int pos = p->scan[k];
        int rr = pos / p->cw, cc = pos % p->cw;
        if (qc_out[rr * w + cc]) eob = k + 1;
    }

    /* ---- trellis level optimization ---- */
    if (rdoq && eob > 0) {
        int cw = p->cw, ch = p->ch;
        int32_t tqp[32 * 32], qp2[32 * 32], dqp[32 * 32];
        for (int r = 0; r < ch; ++r)
            for (int c2 = 0; c2 < cw; ++c2) {
                tqp[r * cw + c2] = tbuf[r * w + c2];
                qp2[r * cw + c2] = qc_out[r * w + c2];
                dqp[r * cw + c2] = dq[r * w + c2];
            }
        eob = rdoq_optimize_txb(rdoq, tqp, qp2, dqp, eob, p->scan,
                                cw, ch, p->dequant, ls);
        for (int r = 0; r < ch; ++r)
            for (int c2 = 0; c2 < cw; ++c2) {
                qc_out[r * w + c2] = qp2[r * cw + c2];
                dq[r * w + c2] = dqp[r * cw + c2];
            }
    }

    if (eob == 0) {
        /* zero residual: recon = clip(pred) without running the nets */
        int32_t pmax0 = (1 << p->bd) - 1;
        for (int i = 0; i < h * w; ++i)
            rec_out[i] = clampi(pred[i], 0, pmax0);
        return 0;
    }

    /* ---- inverse + recon ---- */
    int bd = p->bd;
    for (int i = 0; i < h * w; ++i) {
        int32_t v = dq[i];
        if (p->rect) v = mul_sqrt2_round(v, NEW_INV_SQRT2);
        int cb = bd + 8;
        buf[i] = clampi(v, -(1 << (cb - 1)), (1 << (cb - 1)) - 1);
    }
    /* inverse row pass: transpose to [w][h], lanes = h */
    blk_transpose(buf, h, w, tp);
    run_1d_lanes(&p->irow, p->sinpi_inv, tp, h, p->inv_clamp_row, 1);
    blk_transpose(tp, w, h, buf);
    for (int i = 0; i < h * w; ++i) buf[i] = round_shift(buf[i], p->is0);
    if (p->fwd_flip_h)    /* FLIPADST row: flip output columns */
        for (int r = 0; r < h; ++r)
            for (int c = 0; c < w / 2; ++c) {
                int32_t t = buf[r * w + c];
                buf[r * w + c] = buf[r * w + (w - 1 - c)];
                buf[r * w + (w - 1 - c)] = t;
            }
    int ccb = bd + 6 > 16 ? bd + 6 : 16;
    for (int i = 0; i < h * w; ++i)
        buf[i] = clampi(buf[i], -(1 << (ccb - 1)), (1 << (ccb - 1)) - 1);
    run_1d_lanes(&p->icol, p->sinpi_inv, buf, w, p->inv_clamp_col, 1);
    for (int i = 0; i < h * w; ++i) tbuf[i] = round_shift(buf[i], p->is1);
    if (p->fwd_flip_v)
        for (int r = 0; r < h / 2; ++r)
            for (int c = 0; c < w; ++c) {
                int32_t t = tbuf[r * w + c];
                tbuf[r * w + c] = tbuf[(h - 1 - r) * w + c];
                tbuf[(h - 1 - r) * w + c] = t;
            }
    int32_t int_max = ((1 << (7 + bd)) - 1) + (914 << (bd - 7));
    int32_t pmax = (1 << bd) - 1;
    for (int i = 0; i < h * w; ++i) {
        int32_t v = clampi(tbuf[i], -int_max - 1, int_max);
        rec_out[i] = clampi(pred[i] + v, 0, pmax);
    }
    return eob;
}

static int block_code_core(const Plan *p, const int32_t *resid,
                           const int32_t *pred, int32_t *qc_out,
                           int32_t *rec_out) {
    return block_code_core_rdoq(p, resid, pred, qc_out, rec_out, NULL);
}

#endif /* SVT_TPU_BLOCK_CORE_H */
