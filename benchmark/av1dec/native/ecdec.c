/* The AV1 symbol decoder (specification 8.2) and the transform
 * coefficient syntax (5.11.39, contexts of 8.3.2), written in C for the
 * benchmark's reference decoder.  It mirrors, line for line, the Python
 * RangeDecoder (entropy/ec.py) and parse_coeffs_txb (entropy/coeffs.py)
 * of this package, which stay the definition: the benchmark's CPU tests
 * hold the two decoders' pictures equal.  Plain C; loaded with ctypes. */
#include <stddef.h>
#include <stdint.h>

#define WINDOW 32
#define LOTS_OF_BITS 0x4000
#define PROB_TOP 32768

typedef struct {
    const uint8_t *data;
    int64_t pos, end;
    uint64_t dif;
    uint32_t rng;
    int32_t cnt;
} ecd_t;

static const int speed[17] = {0, 0, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                              2, 2};

static void refill(ecd_t *d) {
    int s = WINDOW - 9 - (d->cnt + 15);
    uint64_t dif = d->dif;
    int32_t cnt = d->cnt;
    int64_t pos = d->pos;
    while (s >= 0 && pos < d->end) {
        dif ^= (uint64_t)d->data[pos] << s;
        cnt += 8;
        pos++;
        s -= 8;
    }
    if (pos >= d->end) cnt = LOTS_OF_BITS;
    d->dif = dif;
    d->cnt = cnt;
    d->pos = pos;
}

static int bitlen(uint32_t x) {
    int n = 0;
    while (x) {
        n++;
        x >>= 1;
    }
    return n;
}

static int normalize(ecd_t *d, uint64_t dif, uint32_t rng, int ret) {
    int dd = 16 - bitlen(rng);
    d->cnt -= dd;
    d->dif = (((dif + 1) << dd) - 1) & 0xFFFFFFFFull;
    d->rng = rng << dd;
    if (d->cnt < 0) refill(d);
    return ret;
}

void ecd_init(ecd_t *d, const uint8_t *data, int64_t size) {
    d->data = data;
    d->pos = 0;
    d->end = size;
    d->dif = (1ull << (WINDOW - 1)) - 1;
    d->rng = 0x8000;
    d->cnt = -15;
    refill(d);
}

static void update_cdf(uint16_t *icdf, int val, int nsymbs) {
    int count = icdf[nsymbs];
    int rate = 3 + (count > 15) + (count > 31) + speed[nsymbs];
    int tmp = PROB_TOP;
    for (int i = 0; i < nsymbs - 1; i++) {
        if (i == val) tmp = 0;
        int c = icdf[i];
        if (tmp < c)
            c -= (c - tmp) >> rate;
        else
            c += (tmp - c) >> rate;
        icdf[i] = (uint16_t)c;
    }
    if (count < 32) icdf[nsymbs] = (uint16_t)(count + 1);
}

static int decode_cdf(ecd_t *d, const uint16_t *icdf, int nsyms) {
    uint64_t dif = d->dif;
    uint32_t r = d->rng, u, v = r;
    int n = nsyms - 1, ret = -1;
    uint32_t c = (uint32_t)(dif >> (WINDOW - 16));
    do {
        ret++;
        u = v;
        v = (((r >> 8) * (uint32_t)(icdf[ret] >> 6)) >> 1)
            + 4u * (uint32_t)(n - ret);
    } while (c < v);
    r = u - v;
    dif -= (uint64_t)v << (WINDOW - 16);
    return normalize(d, dif, r, ret);
}

int ecd_symbol(ecd_t *d, uint16_t *icdf, int nsyms, int adapt) {
    int s = decode_cdf(d, icdf, nsyms);
    if (adapt) update_cdf(icdf, s, nsyms);
    return s;
}

int ecd_bool_q15(ecd_t *d, int f) {
    uint64_t dif = d->dif;
    uint32_t r = d->rng;
    uint32_t v = (((r >> 8) * (uint32_t)(f >> 6)) >> 1) + 4;
    uint64_t vw = (uint64_t)v << (WINDOW - 16);
    int ret;
    if (dif >= vw) {
        ret = 0;
        r -= v;
        dif -= vw;
    } else {
        ret = 1;
        r = v;
    }
    return normalize(d, dif, r, ret);
}

static int bit(ecd_t *d) {
    return ecd_bool_q15(d, (0x7FFFFF - (128 << 15) + 128) >> 8);
}

int ecd_bool_prob8(ecd_t *d, int prob8) {
    return ecd_bool_q15(d, (0x7FFFFF - (prob8 << 15) + prob8) >> 8);
}

int ecd_literal(ecd_t *d, int bits) {
    int v = 0;
    for (int i = 0; i < bits; i++) v = (v << 1) | bit(d);
    return v;
}

static const int eob_group_start[12] = {0, 1, 2, 3, 5, 9, 17, 33, 65, 129,
                                        257, 513};
static const int eob_offset_bits[12] = {0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9};

#define CLIP3(x) ((x) < 3 ? (x) : 3)
#define TX_CLASS_2D 0
#define TX_CLASS_HORIZ 1
#define TX_CLASS_VERT 2

/* One transform block after its txb_skip (and tx_type) symbols: the eob,
 * the base levels, the level ranges, the signs and the Golomb tails.
 * ``qcoeff`` (h*w, zeroed) receives the levels; out[0] the eob, out[1]
 * the cul_level with the dc sign's bits.  Returns 0, or -1 on a Golomb
 * code longer than 32 bits. */
int ecd_coeffs(ecd_t *d, int h, int w, int bwl, int tx_class,
               const int32_t *scan, int ems, uint16_t *eob_cdf,
               uint16_t *eob_extra, int eob_extra_stride,
               uint16_t *base_eob, int base_eob_stride, uint16_t *base,
               int base_stride, uint16_t *br, int br_stride,
               uint16_t *dc_sign, const int32_t *nz_off, int32_t *qcoeff,
               int32_t *levels, int32_t *out) {
    const int ls = w + 4; /* levels: (h + 4) rows of w + 4, zeroed */
    int eob_pt = ecd_symbol(d, eob_cdf, ems + 5, 1) + 1;
    int offset_bits = eob_offset_bits[eob_pt];
    int eob_extra_v = 0;
    if (offset_bits > 0) {
        int b = ecd_symbol(d, eob_extra + eob_pt * eob_extra_stride, 2, 1);
        eob_extra_v = b << (offset_bits - 1);
        for (int i = 1; i < offset_bits; i++)
            eob_extra_v |= bit(d) << (offset_bits - 1 - i);
    }
    int eob = eob_group_start[eob_pt] + eob_extra_v;
    for (int c = eob - 1; c >= 0; c--) {
        int pos = scan[c];
        int row = pos >> bwl, col = pos & (w - 1);
        const int32_t *lv = levels + row * ls + col;
        int level;
        if (c == eob - 1) {
            int ctx;
            if (c == 0)
                ctx = 0;
            else if (c <= (h << bwl) / 8)
                ctx = 1;
            else if (c <= (h << bwl) / 4)
                ctx = 2;
            else
                ctx = 3;
            level = ecd_symbol(d, base_eob + ctx * base_eob_stride, 3, 1) + 1;
        } else {
            int mag = CLIP3(lv[1]) + CLIP3(lv[ls]);
            if (tx_class == TX_CLASS_2D)
                mag += CLIP3(lv[ls + 1]) + CLIP3(lv[2]) + CLIP3(lv[2 * ls]);
            else if (tx_class == TX_CLASS_VERT)
                mag += CLIP3(lv[2 * ls]) + CLIP3(lv[3 * ls]) +
                       CLIP3(lv[4 * ls]);
            else
                mag += CLIP3(lv[2]) + CLIP3(lv[3]) + CLIP3(lv[4]);
            int ctx;
            if ((tx_class | pos) == 0) {
                ctx = 0;
            } else {
                ctx = (mag + 1) >> 1;
                if (ctx > 4) ctx = 4;
                if (tx_class == TX_CLASS_2D) {
                    ctx += nz_off[row * w + col];
                } else {
                    int idx = tx_class == TX_CLASS_HORIZ ? col : row;
                    ctx += idx == 0 ? 26 : (idx == 1 ? 31 : 36);
                }
            }
            level = ecd_symbol(d, base + ctx * base_stride, 4, 1);
        }
        if (level > 2) {
            int mag = lv[1] + lv[ls], brc;
            if (tx_class == TX_CLASS_2D) {
                mag += lv[ls + 1];
                mag = (mag + 1) >> 1;
                if (mag > 6) mag = 6;
                brc = pos == 0 ? mag : ((row < 2 && col < 2) ? mag + 7
                                                              : mag + 14);
            } else if (tx_class == TX_CLASS_HORIZ) {
                mag += lv[2];
                mag = (mag + 1) >> 1;
                if (mag > 6) mag = 6;
                brc = pos == 0 ? mag : (col == 0 ? mag + 7 : mag + 14);
            } else {
                mag += lv[2 * ls];
                mag = (mag + 1) >> 1;
                if (mag > 6) mag = 6;
                brc = pos == 0 ? mag : (row == 0 ? mag + 7 : mag + 14);
            }
            uint16_t *cdf = br + brc * br_stride;
            for (int idx = 0; idx < 12; idx += 3) {
                int k = ecd_symbol(d, cdf, 4, 1);
                level += k;
                if (k < 3) break;
            }
        }
        levels[row * ls + col] = level < 127 ? level : 127;
        qcoeff[pos] = level;
    }
    int64_t cul = 0;
    for (int c = 0; c < eob; c++) {
        int pos = scan[c];
        int64_t level = qcoeff[pos];
        if (level) {
            int sign = c == 0 ? ecd_symbol(d, dc_sign, 2, 1) : bit(d);
            if (level > 14) {
                int length = 0;
                while (bit(d) == 0) {
                    length++;
                    if (length > 31) return -1;
                }
                int64_t x = 1;
                for (int i = 0; i < length; i++) x = (x << 1) | bit(d);
                level += x - 1;
                qcoeff[pos] = (int32_t)level;
            }
            cul += level;
            if (sign) qcoeff[pos] = (int32_t)-level;
        }
    }
    if (cul > 63) cul = 63;
    int dc = eob ? qcoeff[scan[0]] : 0;
    out[0] = eob;
    out[1] = (int32_t)(dc < 0 ? (cul | 64) : (dc > 0 ? cul + 128 : cul));
    return 0;
}
