"""Warped-motion prediction: affine warp filter + shear parameters.

Behavioral parity: svt_av1_warp_affine_c
(SVT-AV1 Source/Lib/Common/Codec/EbWarpedMotion.c:577) and
svt_get_shear_params (:921).  The filter processes the prediction in
8x8 tiles with two shear passes (horizontal then vertical), each an
8-tap filter indexed by a per-pixel fractional offset — on TPU the
tiles batch into gathers + tensordots over the 193x8 filter table; the
NumPy path here is the bit-exact form used by the conformant coding
pass and as the kernel reference.
"""
from __future__ import annotations

import numpy as np

from ..entropy.tables import table

WARPEDMODEL_PREC_BITS = 16
WARPEDMODEL_TRANS_CLAMP = 128 << WARPEDMODEL_PREC_BITS
WARPEDMODEL_NONDIAGAFFINE_CLAMP = 1 << (WARPEDMODEL_PREC_BITS - 3)
WARP_PARAM_REDUCE_BITS = 6
WARPEDPIXEL_PREC_BITS = 6
WARPEDPIXEL_PREC_SHIFTS = 1 << WARPEDPIXEL_PREC_BITS
WARPEDDIFF_PREC_BITS = WARPEDMODEL_PREC_BITS - WARPEDPIXEL_PREC_BITS
DIV_LUT_BITS = 8
DIV_LUT_PREC_BITS = 14
DIV_LUT_NUM = 1 << DIV_LUT_BITS
FILTER_BITS = 7

# Identity model (default_warp_params)
IDENTITY_MAT = (0, 0, 1 << WARPEDMODEL_PREC_BITS, 0,
                0, 1 << WARPEDMODEL_PREC_BITS, 0, 0)

# wmtype enum (EbDefinitions.h TransformationType)
IDENTITY, TRANSLATION, ROTZOOM, AFFINE = 0, 1, 2, 3


def _round_pow2(x: int, n: int) -> int:
    return (x + (1 << (n - 1))) >> n if n > 0 else x


def _round_pow2_signed(x: int, n: int) -> int:
    return -_round_pow2(-x, n) if x < 0 else _round_pow2(x, n)


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


def resolve_divisor_32(d: int) -> tuple[int, int]:
    """(multiplier, shift) such that x/d ~= (x*mult) >> shift
    (resolve_divisor_32, EbWarpedMotion.c:343).  d > 0."""
    shift = d.bit_length() - 1
    e = d - (1 << shift)
    if shift > DIV_LUT_BITS:
        f = _round_pow2(e, shift - DIV_LUT_BITS)
    else:
        f = e << (DIV_LUT_BITS - shift)
    return int(table("div_lut")[f]), shift + DIV_LUT_PREC_BITS


def get_shear_params(mat) -> tuple[int, int, int, int] | None:
    """alpha/beta/gamma/delta from the affine matrix, or None when the
    model is invalid for the warp filter (svt_get_shear_params)."""
    if mat[2] <= 0:
        return None
    alpha = _clamp(mat[2] - (1 << WARPEDMODEL_PREC_BITS), -32768, 32767)
    beta = _clamp(mat[3], -32768, 32767)
    y, shift = resolve_divisor_32(abs(mat[2]))
    y = -y if mat[2] < 0 else y
    v = (mat[4] << WARPEDMODEL_PREC_BITS) * y
    gamma = _clamp(_round_pow2_signed(v, shift), -32768, 32767)
    v = (mat[3] * mat[4]) * y
    delta = _clamp(mat[5] - _round_pow2_signed(v, shift)
                   - (1 << WARPEDMODEL_PREC_BITS), -32768, 32767)

    def reduce(p):
        return _round_pow2_signed(p, WARP_PARAM_REDUCE_BITS) \
            * (1 << WARP_PARAM_REDUCE_BITS)

    alpha, beta, gamma, delta = map(reduce, (alpha, beta, gamma, delta))
    if (4 * abs(alpha) + 7 * abs(beta) >= (1 << WARPEDMODEL_PREC_BITS)) or \
       (4 * abs(gamma) + 4 * abs(delta) >= (1 << WARPEDMODEL_PREC_BITS)):
        return None
    return alpha, beta, gamma, delta


def warp_affine(mat, ref: np.ndarray, p_col: int, p_row: int,
                p_width: int, p_height: int, sub_x: int, sub_y: int,
                alpha: int, beta: int, gamma: int, delta: int,
                bd: int = 8) -> np.ndarray:
    """Single-reference affine warp of a p_width x p_height block whose
    top-left sits at plane position (p_col, p_row).  ``ref`` is the full
    reference plane (edge-clamped sampling).  Returns [p_height,
    p_width] int32 pixels."""
    height, width = ref.shape
    ref = ref.astype(np.int32)
    reduce_bits_horiz = 3                       # ConvolveParams round_0
    reduce_bits_vert = 2 * FILTER_BITS - reduce_bits_horiz
    offset_bits_horiz = bd + FILTER_BITS - 1
    offset_bits_vert = bd + 2 * FILTER_BITS - reduce_bits_horiz
    filters = table("eb_warped_filter").astype(np.int32)
    pred = np.zeros((p_height, p_width), np.int32)
    max_pix = (1 << bd) - 1

    for i in range(p_row, p_row + p_height, 8):
        for j in range(p_col, p_col + p_width, 8):
            src_x = (j + 4) << sub_x
            src_y = (i + 4) << sub_y
            dst_x = mat[2] * src_x + mat[3] * src_y + mat[0]
            dst_y = mat[4] * src_x + mat[5] * src_y + mat[1]
            x4 = dst_x >> sub_x
            y4 = dst_y >> sub_y
            ix4 = x4 >> WARPEDMODEL_PREC_BITS
            sx4 = x4 & ((1 << WARPEDMODEL_PREC_BITS) - 1)
            iy4 = y4 >> WARPEDMODEL_PREC_BITS
            sy4 = y4 & ((1 << WARPEDMODEL_PREC_BITS) - 1)
            sx4 += alpha * (-4) + beta * (-4)
            sy4 += gamma * (-4) + delta * (-4)
            sx4 &= ~((1 << WARP_PARAM_REDUCE_BITS) - 1)
            sy4 &= ~((1 << WARP_PARAM_REDUCE_BITS) - 1)

            # horizontal pass: 15 rows x 8 cols intermediate (vectorized
            # per tile: gather + one tensordot over the 8 taps)
            ks = np.arange(-7, 8)[:, None]               # [15,1]
            ls = np.arange(-4, 4)[None, :]               # [1,8]
            sx = sx4 + beta * (ks + 4) + alpha * (ls + 4)      # [15,8]
            offs_h = ((sx + (1 << (WARPEDDIFF_PREC_BITS - 1)))
                      >> WARPEDDIFF_PREC_BITS) + WARPEDPIXEL_PREC_SHIFTS
            rows = np.clip(iy4 + ks, 0, height - 1)      # [15,1]
            cols = np.clip(ix4 + ls[:, :, None] - 3
                           + np.arange(8)[None, None, :],
                           0, width - 1)                 # [1,8,8]
            samp = ref[np.broadcast_to(rows[:, :, None], (15, 8, 8)),
                       np.broadcast_to(cols, (15, 8, 8))]
            s = (samp * filters[offs_h]).sum(axis=2) \
                + (1 << offset_bits_horiz)
            tmp = (s + (1 << (reduce_bits_horiz - 1))) >> reduce_bits_horiz

            # vertical pass
            kh = min(4, p_row + p_height - i - 4)
            kw = min(4, p_col + p_width - j - 4)
            ks_v = np.arange(-4, kh)[:, None]            # [kh+4,1]
            ls_v = np.arange(-4, kw)[None, :]            # [1,kw+4]
            sy = sy4 + delta * (ks_v + 4) + gamma * (ls_v + 4)
            offs_v = ((sy + (1 << (WARPEDDIFF_PREC_BITS - 1)))
                      >> WARPEDDIFF_PREC_BITS) + WARPEDPIXEL_PREC_SHIFTS
            # taps read tmp rows k+4..k+11 at column l+4
            m = np.arange(8)[None, None, :]
            rsel = ks_v[:, :, None] + 4 + m              # [kh+4,1,8]
            csel = ls_v[:, :, None] + 4                  # [1,kw+4,1]
            sh_v, sw_v = sy.shape
            vals = tmp[np.broadcast_to(rsel, (sh_v, sw_v, 8)),
                       np.broadcast_to(csel, (sh_v, sw_v, 8))]
            sv = (vals * filters[offs_v]).sum(axis=2) \
                + (1 << offset_bits_vert)
            sv = (sv + (1 << (reduce_bits_vert - 1))) >> reduce_bits_vert
            out = np.clip(sv - (1 << (bd - 1)) - (1 << bd), 0, max_pix)
            pred[i - p_row:i - p_row + sh_v,
                 j - p_col:j - p_col + sw_v] = out
    return pred


def warp_plane(mat, ref, p_col, p_row, p_width, p_height, sub_x, sub_y,
               bd: int = 8) -> np.ndarray | None:
    """Shear-decomposed warp of one block; None when the model cannot be
    expressed by the fast filter (caller falls back per spec rules)."""
    sp = get_shear_params(mat)
    if sp is None:
        return None
    return warp_affine(mat, ref, p_col, p_row, p_width, p_height,
                       sub_x, sub_y, *sp, bd=bd)


def convert_to_trans_prec(allow_hp: bool, v: int) -> int:
    if allow_hp:
        return _round_pow2_signed(v, WARPEDMODEL_PREC_BITS - 3)
    return _round_pow2_signed(v, WARPEDMODEL_PREC_BITS - 2) * 2


def gm_get_motion_vector(wmtype: int, mat, bw: int, bh: int, mi_col: int,
                         mi_row: int, allow_hp: bool = False,
                         is_integer: bool = False) -> tuple[int, int]:
    """Block (row, col) motion vector in 1/8 px implied by a global
    model (gm_get_motion_vector_enc,
    EbAdaptiveMotionVectorPrediction.c)."""
    if wmtype == IDENTITY:
        return (0, 0)
    if wmtype == TRANSLATION:
        row = mat[0] >> (WARPEDMODEL_PREC_BITS - 3)
        col = mat[1] >> (WARPEDMODEL_PREC_BITS - 3)
        if is_integer:
            row = _round_pow2_signed(row, 3) * 8
            col = _round_pow2_signed(col, 3) * 8
        return (row, col)
    x = mi_col * 4 + bw // 2 - 1
    y = mi_row * 4 + bh // 2 - 1
    one = 1 << WARPEDMODEL_PREC_BITS
    xc = (mat[2] - one) * x + mat[3] * y + mat[0]
    yc = mat[4] * x + (mat[5] - one) * y + mat[1]
    tx = convert_to_trans_prec(allow_hp, xc)
    ty = convert_to_trans_prec(allow_hp, yc)
    if is_integer:
        tx = _round_pow2_signed(tx, 3) * 8
        ty = _round_pow2_signed(ty, 3) * 8
    return (ty, tx)


# ---------------------------------------------------------------------------
# Local warp (WARPED_CAUSAL): normative integer least-squares fit of the
# neighbour motion samples (find_affine_int / svt_find_projection,
# EbWarpedMotion.c:373).  Decoder and encoder derive identical params.
# ---------------------------------------------------------------------------

LEAST_SQUARES_SAMPLES_MAX = 8
LS_MV_MAX = 256
LS_STEP = 8
LS_MAT_DOWN = 2 + 2      # the >> (2 + LS_MAT_DOWN_BITS) in the LS macros


def _ls_square(a):
    return (a * a * 4 + a * 4 * LS_STEP + LS_STEP * LS_STEP * 2) >> LS_MAT_DOWN


def _ls_product1(a, b):
    return (a * b * 4 + (a + b) * 2 * LS_STEP
            + LS_STEP * LS_STEP) >> LS_MAT_DOWN


def _ls_product2(a, b):
    return (a * b * 4 + (a + b) * 2 * LS_STEP
            + LS_STEP * LS_STEP * 2) >> LS_MAT_DOWN


def resolve_divisor_64(d: int) -> tuple[int, int]:
    shift = d.bit_length() - 1
    e = d - (1 << shift)
    if shift > DIV_LUT_BITS:
        f = _round_pow2(e, shift - DIV_LUT_BITS)
    else:
        f = e << (DIV_LUT_BITS - shift)
    return int(table("div_lut")[f]), shift + DIV_LUT_PREC_BITS


def _mult_shift_ndiag(p_x: int, i_det: int, shift: int) -> int:
    v = p_x * i_det
    return _clamp(_round_pow2_signed(v, shift),
                  -WARPEDMODEL_NONDIAGAFFINE_CLAMP + 1,
                  WARPEDMODEL_NONDIAGAFFINE_CLAMP - 1)


def _mult_shift_diag(p_x: int, i_det: int, shift: int) -> int:
    v = p_x * i_det
    return _clamp(_round_pow2_signed(v, shift),
                  (1 << WARPEDMODEL_PREC_BITS)
                  - WARPEDMODEL_NONDIAGAFFINE_CLAMP + 1,
                  (1 << WARPEDMODEL_PREC_BITS)
                  + WARPEDMODEL_NONDIAGAFFINE_CLAMP - 1)


def find_affine_int(n: int, pts1, pts2, bw: int, bh: int, mvy: int,
                    mvx: int, mi_row: int, mi_col: int):
    """ROTZOOM fit of n (src, dst) sample pairs; returns wmmat[0..5] or
    None when the system is singular (find_affine_int)."""
    a00 = a01 = a11 = 0
    bx0 = bx1 = by0 = by1 = 0
    rsuy = max(bh, 4) // 2 - 1
    rsux = max(bw, 4) // 2 - 1
    suy, sux = rsuy * 8, rsux * 8
    duy, dux = suy + mvy, sux + mvx
    isuy = mi_row * 4 + rsuy
    isux = mi_col * 4 + rsux
    for i in range(n):
        dx = pts2[2 * i] - dux
        dy = pts2[2 * i + 1] - duy
        sx = pts1[2 * i] - sux
        sy = pts1[2 * i + 1] - suy
        if abs(sx - dx) < LS_MV_MAX and abs(sy - dy) < LS_MV_MAX:
            a00 += _ls_square(sx)
            a01 += _ls_product1(sx, sy)
            a11 += _ls_square(sy)
            bx0 += _ls_product2(sx, dx)
            bx1 += _ls_product1(sy, dx)
            by0 += _ls_product1(sx, dy)
            by1 += _ls_product2(sy, dy)
    det = a00 * a11 - a01 * a01
    if det == 0:
        return None
    i_det, shift = resolve_divisor_64(abs(det))
    i_det = -i_det if det < 0 else i_det
    shift -= WARPEDMODEL_PREC_BITS
    if shift < 0:
        i_det <<= -shift
        shift = 0
    px0 = a11 * bx0 - a01 * bx1
    px1 = -a01 * bx0 + a00 * bx1
    py0 = a11 * by0 - a01 * by1
    py1 = -a01 * by0 + a00 * by1
    m2 = _mult_shift_diag(px0, i_det, shift)
    m3 = _mult_shift_ndiag(px1, i_det, shift)
    m4 = _mult_shift_ndiag(py0, i_det, shift)
    m5 = _mult_shift_diag(py1, i_det, shift)
    one = 1 << WARPEDMODEL_PREC_BITS
    vx = mvx * (1 << (WARPEDMODEL_PREC_BITS - 3)) \
        - (isux * (m2 - one) + isuy * m3)
    vy = mvy * (1 << (WARPEDMODEL_PREC_BITS - 3)) \
        - (isux * m4 + isuy * (m5 - one))
    m0 = _clamp(vx, -WARPEDMODEL_TRANS_CLAMP, WARPEDMODEL_TRANS_CLAMP - 1)
    m1 = _clamp(vy, -WARPEDMODEL_TRANS_CLAMP, WARPEDMODEL_TRANS_CLAMP - 1)
    return (m0, m1, m2, m3, m4, m5)


def find_projection(n: int, pts1, pts2, bw: int, bh: int, mvy: int,
                    mvx: int, mi_row: int, mi_col: int):
    """svt_find_projection: fitted + shear-valid wmmat or None."""
    mat = find_affine_int(n, pts1, pts2, bw, bh, mvy, mvx, mi_row, mi_col)
    if mat is None:
        return None
    if get_shear_params(mat) is None:
        return None
    return mat


def select_samples(mv, pts, pts_inref, length: int, bw: int, bh: int
                   ) -> int:
    """Trim samples by motion-vector difference (select_samples); the
    arrays are edited in place, returns the kept count."""
    thresh = _clamp(max(bw, bh), 16, 112)
    mvd = []
    ret = 0
    for i in range(length):
        d = abs(pts_inref[2 * i] - pts[2 * i] - mv[1]) \
            + abs(pts_inref[2 * i + 1] - pts[2 * i + 1] - mv[0])
        mvd.append(-1 if d > thresh else d)
        if d <= thresh:
            ret += 1
    if ret == 0:
        return 1
    i, j = 0, length - 1
    for _ in range(length - ret):
        while i < length and mvd[i] != -1:
            i += 1
        if j < 0:
            break
        while j >= 0 and mvd[j] == -1:
            j -= 1
        if j < 0 or i > j:
            break
        mvd[i] = mvd[j]
        pts[2 * i] = pts[2 * j]
        pts[2 * i + 1] = pts[2 * j + 1]
        pts_inref[2 * i] = pts_inref[2 * j]
        pts_inref[2 * i + 1] = pts_inref[2 * j + 1]
        i += 1
        j -= 1
    return ret
