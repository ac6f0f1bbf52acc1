"""Film grain synthesis (AV1 spec 7.18.3).

Normative output-stage grain: an LFSR-driven Gaussian template (73x82
luma) shaped by an AR filter, piecewise-linear scaling LUTs, and 32x32
block placement with per-block pseudo-random offsets.  Behavioral
parity: grainSynthesis.c (get_random_number:398, generate_luma_grain_
block:422, init_scaling_function:552, add_noise_to_block:632, frame
loop svt_av1_add_film_grain_run:957).

Grain applies to OUTPUT pictures only (never to references), so this is
a pure post-process of the shown frame.  Current scope: overlap_flag=0
streams (our encoder signals overlap off); 4:2:0.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..entropy.tables import table

GAUSS_BITS = 11
SUB_Y = 32                   # luma subblock


@dataclasses.dataclass
class FilmGrainParams:
    apply_grain: bool = False
    grain_seed: int = 0
    update_grain: bool = True
    scaling_points_y: list = dataclasses.field(default_factory=list)
    scaling_points_cb: list = dataclasses.field(default_factory=list)
    scaling_points_cr: list = dataclasses.field(default_factory=list)
    chroma_scaling_from_luma: bool = False
    scaling_shift: int = 8        # grain_scaling_minus_8 + 8
    ar_coeff_lag: int = 0
    ar_coeffs_y: list = dataclasses.field(default_factory=list)
    ar_coeffs_cb: list = dataclasses.field(default_factory=list)
    ar_coeffs_cr: list = dataclasses.field(default_factory=list)
    ar_coeff_shift: int = 6       # ar_coeff_shift_minus_6 + 6
    grain_scale_shift: int = 0
    cb_mult: int = 128
    cb_luma_mult: int = 192
    cb_offset: int = 256
    cr_mult: int = 128
    cr_luma_mult: int = 192
    cr_offset: int = 256
    overlap_flag: bool = False
    clip_to_restricted_range: bool = False


class _Lfsr:
    def __init__(self, value: int):
        self.r = value & 0xFFFF

    def bits(self, n: int) -> int:
        r = self.r
        bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
        r = (r >> 1) | (bit << 15)
        self.r = r
        return (r >> (16 - n)) & ((1 << n) - 1)


def _seed_for_line(seed: int, luma_line: int) -> int:
    luma_num = luma_line >> 5
    r = seed & 0xFFFF
    r ^= ((luma_num * 37 + 178) & 255) << 8
    r ^= (luma_num * 173 + 105) & 255
    return r


def _pred_positions(lag: int):
    pos = []
    for row in range(-lag, 0):
        for col in range(-lag, lag + 1):
            pos.append((row, col, 0))
    for col in range(-lag, 0):
        pos.append((0, col, 0))
    return pos


def _gauss_block(rng: _Lfsr, h: int, w: int, sec_shift: int) -> np.ndarray:
    seq = table("gaussian_sequence")
    idx = np.empty(h * w, np.int32)
    for i in range(h * w):
        idx[i] = rng.bits(GAUSS_BITS)
    vals = (seq[idx] + ((1 << sec_shift) >> 1)) >> sec_shift
    return vals.reshape(h, w).astype(np.int32)


def generate_grain(params: FilmGrainParams, bd: int = 8,
                   ss_x: int = 1, ss_y: int = 1):
    """(luma_grain [73, 82], cb_grain, cr_grain [44, 44]) templates."""
    sec_shift = 12 - bd + params.grain_scale_shift
    gmin = -(128 << (bd - 8))
    gmax = (256 << (bd - 8)) - 1 - (128 << (bd - 8))
    lag = params.ar_coeff_lag
    shift = params.ar_coeff_shift
    rnd = 1 << (shift - 1)
    pos = _pred_positions(lag)

    lbh = 3 + 2 * 3 + 64          # top_pad + 2*ar_padding + 64
    lbw = 3 + 2 * 3 + 64 + 2 * 3 + 3
    luma = np.zeros((lbh, lbw), np.int32)
    if params.scaling_points_y:
        rng = _Lfsr(params.grain_seed)
        luma = _gauss_block(rng, lbh, lbw, sec_shift)
        for i in range(3, lbh):
            for j in range(3, lbw - 3):
                wsum = 0
                for k, (dr, dc, _) in enumerate(pos):
                    wsum += params.ar_coeffs_y[k] * luma[i + dr, j + dc]
                luma[i, j] = np.clip(luma[i, j] + ((wsum + rnd) >> shift),
                                     gmin, gmax)

    cbh = 3 + (2 >> ss_y) * 3 + (64 >> ss_y)
    cbw = 3 + (2 >> ss_x) * 3 + (64 >> ss_x) + (2 >> ss_x) * 3 + 3
    cb = np.zeros((cbh, cbw), np.int32)
    cr = np.zeros((cbh, cbw), np.int32)
    do_cb = bool(params.scaling_points_cb) or params.chroma_scaling_from_luma
    do_cr = bool(params.scaling_points_cr) or params.chroma_scaling_from_luma
    if do_cb:
        cb = _gauss_block(_Lfsr(_seed_for_line(params.grain_seed, 7 << 5)),
                          cbh, cbw, sec_shift)
    if do_cr:
        cr = _gauss_block(_Lfsr(_seed_for_line(params.grain_seed, 11 << 5)),
                          cbh, cbw, sec_shift)
    cpos = list(pos)
    if params.scaling_points_y:
        cpos.append((0, 0, 1))
    for i in range(3, cbh):
        for j in range(3, cbw - 3):
            wcb = wcr = 0
            for k, (dr, dc, kind) in enumerate(cpos):
                if kind == 0:
                    wcb += params.ar_coeffs_cb[k] * cb[i + dr, j + dc] \
                        if do_cb else 0
                    wcr += params.ar_coeffs_cr[k] * cr[i + dr, j + dc] \
                        if do_cr else 0
                else:
                    ly = ((i - 3) << ss_y) + 3
                    lx = ((j - 3) << ss_x) + 3
                    av = int(luma[ly:ly + ss_y + 1, lx:lx + ss_x + 1].sum())
                    av = (av + ((1 << (ss_y + ss_x)) >> 1)) >> (ss_y + ss_x)
                    if do_cb:
                        wcb += params.ar_coeffs_cb[k] * av
                    if do_cr:
                        wcr += params.ar_coeffs_cr[k] * av
            if do_cb:
                cb[i, j] = np.clip(cb[i, j] + ((wcb + rnd) >> shift),
                                   gmin, gmax)
            if do_cr:
                cr[i, j] = np.clip(cr[i, j] + ((wcr + rnd) >> shift),
                                   gmin, gmax)
    return luma, cb, cr


def scaling_lut(points) -> np.ndarray:
    lut = np.zeros(256, np.int32)
    if not points:
        return lut
    lut[:points[0][0]] = points[0][1]
    for p in range(len(points) - 1):
        (x0, y0), (x1, y1) = points[p], points[p + 1]
        dx, dy = x1 - x0, y1 - y0
        delta = dy * ((65536 + (dx >> 1)) // dx)
        xs = np.arange(dx)
        lut[x0:x1] = y0 + ((xs * delta + 32768) >> 16)
    lut[points[-1][0]:] = points[-1][1]
    return lut


def apply_grain(params: FilmGrainParams, planes, bd: int = 8):
    """Add grain to output planes (overlap_flag=0 path); returns new
    planes.  planes: (y, u, v) uint8/uint16 in display order."""
    if not params.apply_grain:
        return planes
    assert not params.overlap_flag, "overlap blending TBD"
    ss_x = ss_y = 1
    luma_g, cb_g, cr_g = generate_grain(params, bd, ss_x, ss_y)
    lut_y = scaling_lut(params.scaling_points_y)
    if params.chroma_scaling_from_luma:
        lut_cb = lut_cr = lut_y
    else:
        lut_cb = scaling_lut(params.scaling_points_cb)
        lut_cr = scaling_lut(params.scaling_points_cr)

    y = planes[0].astype(np.int32)
    u = planes[1].astype(np.int32)
    v = planes[2].astype(np.int32)
    h, w = y.shape
    out_y, out_u, out_v = y.copy(), u.copy(), v.copy()

    apply_y = bool(params.scaling_points_y)
    apply_cb = bool(params.scaling_points_cb) or params.chroma_scaling_from_luma
    apply_cr = bool(params.scaling_points_cr) or params.chroma_scaling_from_luma
    cb_mult = params.cb_mult - 128
    cb_lmult = params.cb_luma_mult - 128
    cb_off = params.cb_offset - 256
    cr_mult = params.cr_mult - 128
    cr_lmult = params.cr_luma_mult - 128
    cr_off = params.cr_offset - 256
    if params.chroma_scaling_from_luma:
        cb_mult, cb_lmult, cb_off = 0, 64, 0
        cr_mult, cr_lmult, cr_off = 0, 64, 0
    rnd = 1 << (params.scaling_shift - 1)
    if params.clip_to_restricted_range:
        min_l, max_l = 16 << (bd - 8), 235 << (bd - 8)
        min_c, max_c = 16 << (bd - 8), 240 << (bd - 8)
    else:
        min_l = min_c = 0
        max_l = max_c = (256 << (bd - 8)) - 1

    for y2 in range(0, h // 2, 16):
        rng = _Lfsr(_seed_for_line(params.grain_seed, y2 * 2))
        for x2 in range(0, w // 2, 16):
            off = rng.bits(8)
            off_x = (off >> 4) & 15
            off_y = off & 15
            lo_y = 3 + 6 + (off_y << 1)
            lo_x = 3 + 6 + (off_x << 1)
            co_y = 3 + 3 + off_y
            co_x = 3 + 3 + off_x
            bh = min(16, h // 2 - y2) * 2
            bw = min(16, w // 2 - x2) * 2
            py, px = y2 * 2, x2 * 2
            yg = luma_g[lo_y:lo_y + bh, lo_x:lo_x + bw]
            blk = y[py:py + bh, px:px + bw]
            if apply_y:
                scale = lut_y[np.clip(blk >> (bd - 8), 0, 255)] \
                    if bd > 8 else lut_y[blk]
                out_y[py:py + bh, px:px + bw] = np.clip(
                    blk + ((scale * yg + rnd) >> params.scaling_shift),
                    min_l, max_l)
            # chroma (4:2:0)
            ch, cw = bh >> 1, bw >> 1
            cy0, cx0 = py >> 1, px >> 1
            lum = blk
            avg = (lum[::2, ::2].astype(np.int32)
                   + lum[::2, 1::2] + 1) >> 1
            for apply_c, plane, outp, g, lut, mult, lmult, offc in (
                    (apply_cb, u, out_u, cb_g, lut_cb, cb_mult, cb_lmult,
                     cb_off),
                    (apply_cr, v, out_v, cr_g, lut_cr, cr_mult, cr_lmult,
                     cr_off)):
                if not apply_c:
                    continue
                cblk = plane[cy0:cy0 + ch, cx0:cx0 + cw]
                idx = np.clip(((avg * lmult + mult * cblk) >> 6) + offc,
                              0, (256 << (bd - 8)) - 1)
                scale = lut[idx >> (bd - 8)] if bd > 8 else lut[idx]
                gblk = g[co_y:co_y + ch, co_x:co_x + cw]
                outp[cy0:cy0 + ch, cx0:cx0 + cw] = np.clip(
                    cblk + ((scale * gblk + rnd) >> params.scaling_shift),
                    min_c, max_c)

    dt = planes[0].dtype
    return (out_y.astype(dt), out_u.astype(dt), out_v.astype(dt))
