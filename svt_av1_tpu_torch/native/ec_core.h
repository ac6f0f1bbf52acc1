/*
 * Core AV1 multisymbol range coder + coefficient-block writer (pure C,
 * no Python).  Shared by the ec_native module (Python-facing encoder
 * object) and the coder_native tile coder, which drives it C-to-C.
 *
 * The range coder's bit-packing is the one inherently serial stage of
 * the pipeline (carry propagation), mirroring the reference's native
 * role for final bitstream assembly (behavioral parity:
 * SVT-AV1 Source/Lib/Common/Codec/EbBitstreamUnit.c od_ec_*,
 * Encoder/Codec/EbEntropyCoding.c av1_write_coeffs_txb_1d).  Twin of
 * svt_av1_tpu_torch/entropy/ec.py + coeffs.py; equivalence enforced by
 * tests/test_native_ec.py.
 */
#ifndef SVT_TPU_EC_CORE_H
#define SVT_TPU_EC_CORE_H

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define PROB_TOP 32768
#define EC_PROB_SHIFT 6
#define EC_MIN_PROB 4
#define WINDOW_MASK 0xFFFFFFFFu

typedef struct {
    uint32_t low;
    uint32_t rng;
    int32_t cnt;
    uint16_t *precarry;
    size_t offs, storage;
} EcCore;

static int nsymbs2speed[17] = {0, 0, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2};

static void ec_update_cdf(uint16_t *icdf, int val, int nsymbs) {
    int count = icdf[nsymbs];
    int rate = 3 + (count > 15) + (count > 31) + nsymbs2speed[nsymbs];
    int tmp = PROB_TOP;
    int i;
    for (i = 0; i < nsymbs - 1; ++i) {
        if (i == val) tmp = 0;
        if (tmp < icdf[i])
            icdf[i] -= (uint16_t)((icdf[i] - tmp) >> rate);
        else
            icdf[i] += (uint16_t)((tmp - icdf[i]) >> rate);
    }
    if (count < 32) icdf[nsymbs] = (uint16_t)(count + 1);
}

static int ec_core_init(EcCore *e) {
    e->low = 0;
    e->rng = 0x8000;
    e->cnt = -9;
    e->storage = 4096;
    e->offs = 0;
    e->precarry = (uint16_t *)malloc(e->storage * sizeof(uint16_t));
    return e->precarry ? 0 : -1;
}

static void ec_core_free(EcCore *e) {
    free(e->precarry);
    e->precarry = NULL;
}

static int enc_grow(EcCore *e, size_t need) {
    if (e->offs + need <= e->storage) return 0;
    size_t ns = e->storage * 2 + need;
    uint16_t *nb = (uint16_t *)realloc(e->precarry, ns * sizeof(uint16_t));
    if (!nb) return -1;
    e->precarry = nb;
    e->storage = ns;
    return 0;
}

static inline int ilog_nz(uint32_t x) {
    /* position of highest set bit + 1 */
    return 32 - __builtin_clz(x);
}

static void enc_normalize(EcCore *e, uint32_t low, uint32_t rng) {
    int d = 16 - ilog_nz(rng);
    int s = e->cnt + d;
    if (s >= 0) {
        int c = e->cnt + 16;
        uint32_t m = (1u << c) - 1;
        enc_grow(e, 2);
        if (s >= 8) {
            e->precarry[e->offs++] = (uint16_t)(low >> c);
            low &= m;
            c -= 8;
            m >>= 8;
        }
        e->precarry[e->offs++] = (uint16_t)(low >> c);
        s = c + d - 24;
        low &= m;
    }
    e->low = (low << d) & WINDOW_MASK;
    e->rng = rng << d;
    e->cnt = s;
}

static void enc_cdf(EcCore *e, int s, const uint16_t *icdf, int nsyms) {
    uint32_t fl = s > 0 ? icdf[s - 1] : PROB_TOP;
    uint32_t fh = icdf[s];
    uint32_t low = e->low;
    uint32_t r = e->rng;
    int n = nsyms - 1;
    if (fl < PROB_TOP) {
        uint32_t u = (((r >> 8) * (fl >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT))
                     + EC_MIN_PROB * (uint32_t)(n - (s - 1));
        uint32_t v = (((r >> 8) * (fh >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT))
                     + EC_MIN_PROB * (uint32_t)(n - s);
        low = (low + (r - u)) & WINDOW_MASK;
        r = u - v;
    } else {
        r -= (((r >> 8) * (fh >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT))
             + EC_MIN_PROB * (uint32_t)(n - s);
    }
    enc_normalize(e, low, r);
}

static void enc_bool_q15(EcCore *e, int val, uint32_t f) {
    uint32_t low = e->low;
    uint32_t r = e->rng;
    uint32_t v = (((r >> 8) * (f >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB;
    if (val) {
        low = (low + (r - v)) & WINDOW_MASK;
        r = v;
    } else {
        r -= v;
    }
    enc_normalize(e, low, r);
}

static void enc_bit(EcCore *e, int bit) {
    /* aom_write_bit: prob8 = 128 */
    uint32_t f = (0x7FFFFFu - (128u << 15) + 128u) >> 8;
    enc_bool_q15(e, bit, f);
}

static void enc_symbol_adapt(EcCore *e, int s, uint16_t *icdf, int nsyms) {
    enc_cdf(e, s, icdf, nsyms);
    ec_update_cdf(icdf, s, nsyms);
}

static void enc_golomb(EcCore *e, int32_t level) {
    int32_t x = level + 1;
    int length = 0, i;
    int32_t t = x;
    while (t) { t >>= 1; ++length; }
    for (i = 0; i < length - 1; ++i) enc_bit(e, 0);
    for (i = length - 1; i >= 0; --i) enc_bit(e, (x >> i) & 1);
}

/* Number of pending bits in the stream (od_ec_enc_tell). */
static inline long long ec_core_tell_bits(const EcCore *e) {
    return (long long)(8 * e->offs) + e->cnt + 10;
}

/* Finalize into caller-provided buffer; returns byte count.  ``out``
 * must have room for offs + 8 bytes. */
static size_t ec_core_done(EcCore *e, unsigned char *out) {
    uint32_t low = e->low;
    int c = e->cnt;
    int s = 10 + c;
    uint32_t m = 0x3FFF;
    uint64_t ev = ((uint64_t)(low + m) & ~(uint64_t)m) | (m + 1);
    size_t n_extra = 0;
    uint16_t extra[8];
    while (s > 0) {
        uint64_t n = (1ull << (c + 16)) - 1;
        extra[n_extra++] = (uint16_t)(ev >> (c + 16));
        ev &= n;
        s -= 8;
        c -= 8;
    }
    size_t total = e->offs + n_extra;
    uint32_t carry = 0;
    for (ptrdiff_t i = (ptrdiff_t)total - 1; i >= 0; --i) {
        uint32_t v = (i < (ptrdiff_t)e->offs) ? e->precarry[i]
                                              : extra[i - e->offs];
        carry += v;
        out[i] = (unsigned char)(carry & 0xFF);
        carry >>= 8;
    }
    return total;
}

/* ---- coefficient block writer ------------------------------------ */

#define TX_CLASS_2D 0
#define TX_CLASS_HORIZ 1
#define TX_CLASS_VERT 2
#define NUM_BASE_LEVELS 2
#define COEFF_BASE_RANGE 12
#define BR_CDF_SIZE 4

static const int16_t k_eob_group_start[12] = {0, 1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513};
static const int16_t k_eob_offset_bits[12] = {0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9};
static const uint8_t eob_to_pos_small[33] = {
    0, 1, 2, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5,
    6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6};
static const uint8_t eob_to_pos_large[17] = {
    6, 7, 8, 8, 9, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10, 11};

static inline int clip3i(int v) { return v < 3 ? v : 3; }

static int nz_map_ctx(const uint8_t *lv, int stride, int pos, int bwl,
                      int height, int scan_idx, int is_eob, int width,
                      int tx_class, int shape) {
    if (is_eob) {
        if (scan_idx == 0) return 0;
        if (scan_idx <= (height << bwl) / 8) return 1;
        if (scan_idx <= (height << bwl) / 4) return 2;
        return 3;
    }
    int row = pos >> bwl, col = pos - (row << bwl);
    const uint8_t *p = lv + row * stride + col;
    int mag = clip3i(p[1]) + clip3i(p[stride]);
    if (tx_class == TX_CLASS_2D)
        mag += clip3i(p[stride + 1]) + clip3i(p[2]) + clip3i(p[2 * stride]);
    else if (tx_class == TX_CLASS_VERT)
        mag += clip3i(p[2 * stride]) + clip3i(p[3 * stride]) + clip3i(p[4 * stride]);
    else
        mag += clip3i(p[2]) + clip3i(p[3]) + clip3i(p[4]);
    if ((tx_class | pos) == 0) return 0;
    int ctx = (mag + 1) >> 1;
    if (ctx > 4) ctx = 4;
    if (tx_class == TX_CLASS_2D) {
        int off;
        if (shape == 1 && row < 2) off = 11;
        else if (shape == 2 && col < 2) off = 16;
        else if (row + col < 2) off = 1;
        else if (row + col < 4) off = 6;
        else off = 21;
        if (pos == 0) return 0;
        return ctx + off;
    }
    int idx = tx_class == TX_CLASS_HORIZ ? col : row;
    return ctx + (idx == 0 ? 26 : (idx == 1 ? 31 : 36));
}

static int br_ctx(const uint8_t *lv, int stride, int pos, int bwl, int tx_class) {
    int row = pos >> bwl, col = pos - (row << bwl);
    const uint8_t *p = lv + row * stride + col;
    int mag = p[1] + p[stride];
    if (tx_class == TX_CLASS_2D) {
        mag += p[stride + 1];
        mag = (mag + 1) >> 1;
        if (mag > 6) mag = 6;
        if (pos == 0) return mag;
        if (row < 2 && col < 2) return mag + 7;
    } else if (tx_class == TX_CLASS_HORIZ) {
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

/*
 * eob + levels + signs for one tx block (the txb_skip symbol and
 * tx-type signaling are coded by the caller — the ordering hook sits
 * between them).  Returns cul_level (with the dc-sign bits folded in).
 */
static long long ec_write_coeffs_core(
        EcCore *e, const int32_t *q, const int16_t *scan, int eob,
        int w, int h, int tx_class,
        uint16_t *eob_pt_cdf, uint16_t *eob_extra_cdf,
        uint16_t *base_cdf, int base_stride,
        uint16_t *base_eob_cdf, int base_eob_stride,
        uint16_t *br_cdf_arr, int br_stride,
        uint16_t *dc_sign_cdf, int shape) {
    if (shape < 0) shape = w < h ? 1 : (w > h ? 2 : 0);
    int bwl = 0;
    while ((1 << (bwl + 1)) <= w) bwl++;
    int stride = w + 4;
    uint8_t levels_buf[(32 + 4) * (32 + 8)];
    memset(levels_buf, 0, sizeof(levels_buf));
    uint8_t *lv = levels_buf;
    for (int r = 0; r < h; ++r)
        for (int c2 = 0; c2 < w; ++c2) {
            int32_t a = q[r * w + c2];
            if (a < 0) a = -a;
            lv[r * stride + c2] = a > 127 ? 127 : (uint8_t)a;
        }

    /* eob token */
    int eob_pt, eob_extra;
    if (eob < 33) eob_pt = eob_to_pos_small[eob];
    else {
        int t = (eob - 1) >> 5;
        eob_pt = eob_to_pos_large[t > 16 ? 16 : t];
    }
    eob_extra = eob - k_eob_group_start[eob_pt];
    int ems = 0;
    {
        int n = w * h;
        while ((1 << (ems + 4 + 1)) <= n) ems++;
    }
    enc_symbol_adapt(e, eob_pt - 1, eob_pt_cdf, ems + 5);
    int offset_bits = k_eob_offset_bits[eob_pt];
    if (offset_bits > 0) {
        int bit = (eob_extra >> (offset_bits - 1)) & 1;
        enc_symbol_adapt(e, bit, eob_extra_cdf, 2);
        for (int i = 1; i < offset_bits; ++i)
            enc_bit(e, (eob_extra >> (offset_bits - 1 - i)) & 1);
    }

    /* base + br levels, reverse scan */
    for (int c = eob - 1; c >= 0; --c) {
        int pos = scan[c];
        int32_t v = q[pos];
        int32_t level = v < 0 ? -v : v;
        if (c == eob - 1) {
            int ctx = nz_map_ctx(lv, stride, pos, bwl, h, c, 1, w, tx_class,
                                 shape);
            int val = (level < 3 ? level : 3) - 1;
            enc_symbol_adapt(e, val, base_eob_cdf + ctx * base_eob_stride, 3);
        } else {
            int ctx = nz_map_ctx(lv, stride, pos, bwl, h, c, 0, w, tx_class,
                                 shape);
            enc_symbol_adapt(e, level < 3 ? level : 3, base_cdf + ctx * base_stride, 4);
        }
        if (level > NUM_BASE_LEVELS) {
            int base_range = level - 1 - NUM_BASE_LEVELS;
            int bc = br_ctx(lv, stride, pos, bwl, tx_class);
            uint16_t *cdf = br_cdf_arr + bc * br_stride;
            for (int idx = 0; idx < COEFF_BASE_RANGE; idx += BR_CDF_SIZE - 1) {
                int k = base_range - idx;
                if (k > BR_CDF_SIZE - 1) k = BR_CDF_SIZE - 1;
                enc_symbol_adapt(e, k, cdf, BR_CDF_SIZE);
                if (k < BR_CDF_SIZE - 1) break;
            }
        }
    }

    /* signs + golomb */
    long long cul_level = 0;
    for (int c = 0; c < eob; ++c) {
        int pos = scan[c];
        int32_t v = q[pos];
        int32_t level = v < 0 ? -v : v;
        cul_level += level;
        if (level) {
            if (c == 0)
                enc_symbol_adapt(e, v < 0, dc_sign_cdf, 2);
            else
                enc_bit(e, v < 0);
            if (level > COEFF_BASE_RANGE + NUM_BASE_LEVELS)
                enc_golomb(e, level - COEFF_BASE_RANGE - 1 - NUM_BASE_LEVELS);
        }
    }
    if (cul_level > 63) cul_level = 63;
    {
        int32_t dc = q[0];
        if (dc < 0) cul_level |= 1 << 6;
        else if (dc > 0) cul_level += 2 << 6;
    }
    return cul_level;
}

#endif /* SVT_TPU_EC_CORE_H */
