"""AV1 intra prediction, vectorized.

Normative intra predictors over prepared edge arrays, plus the edge
preparation itself (neighbor extension, corner/edge filtering, upsample).
Behavioral parity: decode_build_intra_predictors
(/root/reference/Source/Lib/Decoder/Codec/EbDecIntraPrediction.c:302) and
the predictor kernels in EbIntraPrediction.c / C_DEFAULT.

Conventions differ from the C on purpose:
  * edges are passed as ``above``/``left`` arrays with the top-left pixel
    at index 0 and the edge samples from index 1 (so C's above_row[-1]
    is above[0] here); upsampled edges double in length the same way.
  * all predictors are pure array ops over [h, w] index grids, so they
    vectorize/jit directly; block loops live in the caller.

All predictors return int32 arrays (caller clips/casts).
"""
from __future__ import annotations

import functools

import numpy as np

from ..constants import PredictionMode, TxSize, TX_WIDTH, TX_HEIGHT
from ..entropy.tables import table

# extend_modes requirement bits (EbIntraPrediction.c:406)
NEED_LEFT = 1 << 1
NEED_ABOVE = 1 << 2
NEED_ABOVELEFT = 1 << 3
NEED_ABOVERIGHT = 1 << 4
NEED_BOTTOMLEFT = 1 << 5

EXTEND_MODES = {
    PredictionMode.DC_PRED: NEED_ABOVE | NEED_LEFT,
    PredictionMode.V_PRED: NEED_ABOVE,
    PredictionMode.H_PRED: NEED_LEFT,
    PredictionMode.D45_PRED: NEED_ABOVE | NEED_ABOVERIGHT,
    PredictionMode.D135_PRED: NEED_LEFT | NEED_ABOVE | NEED_ABOVELEFT,
    PredictionMode.D113_PRED: NEED_LEFT | NEED_ABOVE | NEED_ABOVELEFT,
    PredictionMode.D157_PRED: NEED_LEFT | NEED_ABOVE | NEED_ABOVELEFT,
    PredictionMode.D203_PRED: NEED_LEFT | NEED_BOTTOMLEFT,
    PredictionMode.D67_PRED: NEED_ABOVE | NEED_ABOVERIGHT,
    PredictionMode.SMOOTH_PRED: NEED_LEFT | NEED_ABOVE,
    PredictionMode.SMOOTH_V_PRED: NEED_LEFT | NEED_ABOVE,
    PredictionMode.SMOOTH_H_PRED: NEED_LEFT | NEED_ABOVE,
    PredictionMode.PAETH_PRED: NEED_LEFT | NEED_ABOVE | NEED_ABOVELEFT,
}

MODE_TO_ANGLE = {
    PredictionMode.V_PRED: 90, PredictionMode.H_PRED: 180,
    PredictionMode.D45_PRED: 45, PredictionMode.D135_PRED: 135,
    PredictionMode.D113_PRED: 113, PredictionMode.D157_PRED: 157,
    PredictionMode.D203_PRED: 203, PredictionMode.D67_PRED: 67,
}
ANGLE_STEP = 3


@functools.cache
def _sm_weights() -> np.ndarray:
    return table("sm_weight_arrays").astype(np.int32)


@functools.cache
def _dr_derivative() -> np.ndarray:
    return table("eb_dr_intra_derivative").astype(np.int32)


@functools.cache
def _filter_taps() -> np.ndarray:
    return table("eb_av1_filter_intra_taps").astype(np.int32)


def get_dx(angle: int) -> int:
    d = _dr_derivative()
    if 0 < angle < 90:
        return int(d[angle])
    if 90 < angle < 180:
        return int(d[180 - angle])
    return 1


def get_dy(angle: int) -> int:
    d = _dr_derivative()
    if 90 < angle < 180:
        return int(d[angle - 90])
    if 180 < angle < 270:
        return int(d[270 - angle])
    return 1


def is_directional(mode: PredictionMode) -> bool:
    return PredictionMode.V_PRED <= mode <= PredictionMode.D67_PRED


# --------------------------------------------------------------------------
# Core predictors (edge arrays WITHOUT the topleft offset: above[0] is the
# first above-row sample; topleft passed separately where needed)
# --------------------------------------------------------------------------

def dc_predictor(w, h, above, left, have_above: bool, have_left: bool,
                 xp=np, bd: int = 8):
    if have_above and have_left:
        s = xp.sum(above[:w]) + xp.sum(left[:h])
        dc = (s + ((w + h) >> 1)) // (w + h)
    elif have_above:
        dc = (xp.sum(above[:w]) + (w >> 1)) // w
    elif have_left:
        dc = (xp.sum(left[:h]) + (h >> 1)) // h
    else:
        dc = 128 << (bd - 8)
    return xp.full((h, w), dc, dtype=xp.int32)


def v_predictor(w, h, above, left, xp=np):
    return xp.broadcast_to(above[:w].astype(xp.int32), (h, w)).copy() if xp is np \
        else xp.broadcast_to(above[:w].astype(xp.int32), (h, w))


def h_predictor(w, h, above, left, xp=np):
    return xp.broadcast_to(left[:h].astype(xp.int32)[:, None], (h, w)).copy() if xp is np \
        else xp.broadcast_to(left[:h].astype(xp.int32)[:, None], (h, w))


def paeth_predictor(w, h, above, left, topleft: int, xp=np):
    a = above[:w].astype(xp.int32)[None, :]
    l = left[:h].astype(xp.int32)[:, None]
    tl = xp.int32(topleft)
    base = a + l - tl
    pa = xp.abs(base - a)
    pl = xp.abs(base - l)
    ptl = xp.abs(base - tl)
    return xp.where((pa <= pl) & (pa <= ptl), a + xp.zeros_like(l),
                    xp.where(pl <= ptl, l + xp.zeros_like(a),
                             xp.broadcast_to(tl, (h, w))))


def smooth_predictor(w, h, above, left, xp=np):
    sw = _sm_weights()
    a = above[:w].astype(xp.int32)[None, :]
    l = left[:h].astype(xp.int32)[:, None]
    below = xp.int32(left[h - 1])
    right = xp.int32(above[w - 1])
    wh = sw[h: h + h][:, None]          # weights over rows
    ww = sw[w: w + w][None, :]          # weights over cols
    pred = a * wh + below * (256 - wh) + l * ww + right * (256 - ww)
    return (pred + 256) >> 9


def smooth_v_predictor(w, h, above, left, xp=np):
    sw = _sm_weights()
    a = above[:w].astype(xp.int32)[None, :]
    below = xp.int32(left[h - 1])
    wh = sw[h: h + h][:, None]
    pred = a * wh + below * (256 - wh)
    return (pred + 128) >> 8


def smooth_h_predictor(w, h, above, left, xp=np):
    sw = _sm_weights()
    l = left[:h].astype(xp.int32)[:, None]
    right = xp.int32(above[w - 1])
    ww = sw[w: w + w][None, :]
    pred = l * ww + right * (256 - ww)
    return (pred + 128) >> 8


def dr_predictor_z1(w, h, above_ext, upsample: int, dx: int, xp=np):
    """Angle < 90.  ``above_ext``: edge from the block's top-left sample
    at index 0 (i.e. C's above_row[0]), long enough for (w+h)<<upsample
    + 1 samples."""
    max_base = ((w + h) - 1) << upsample
    frac_bits = 6 - upsample
    r = np.arange(1, h + 1)[:, None]
    c = np.arange(w)[None, :]
    x = r * dx
    base = (x >> frac_bits) + (c << upsample)
    shift = ((x << upsample) & 0x3F) >> 1
    base_cl = xp.minimum(base, max_base)
    a0 = above_ext[base_cl]
    a1 = above_ext[xp.minimum(base_cl + 1, max_base)]
    val = (a0 * (32 - shift) + a1 * shift + 16) >> 5
    return xp.where(base >= max_base, above_ext[max_base], val).astype(xp.int32)


def dr_predictor_z3(w, h, left_ext, upsample: int, dy: int, xp=np):
    """Angle > 180; mirror of z1 over the left edge."""
    max_base = ((w + h) - 1) << upsample
    frac_bits = 6 - upsample
    r = np.arange(h)[:, None]
    c = np.arange(1, w + 1)[None, :]
    y = c * dy
    base = (y >> frac_bits) + (r << upsample)
    shift = ((y << upsample) & 0x3F) >> 1
    base_cl = xp.minimum(base, max_base)
    l0 = left_ext[base_cl]
    l1 = left_ext[xp.minimum(base_cl + 1, max_base)]
    val = (l0 * (32 - shift) + l1 * shift + 16) >> 5
    return xp.where(base >= max_base, left_ext[max_base], val).astype(xp.int32)


def dr_predictor_z2(w, h, above_tl, left_tl, upsample_above: int,
                    upsample_left: int, dx: int, dy: int, xp=np):
    """90 < angle < 180.  ``above_tl``/``left_tl``: edge arrays whose
    index 0 is C's index -(1<<upsample) (i.e. offset by (1<<upsample)),
    so C index i maps to array index i + (1<<upsample)."""
    off_a = 1 << upsample_above
    off_l = 1 << upsample_left
    frac_x = 6 - upsample_above
    frac_y = 6 - upsample_left
    r = np.arange(h)[:, None]
    c = np.arange(w)[None, :]
    x = -(r + 1) * dx                       # per-row
    base1 = (x >> frac_x) + (c << upsample_above)
    shift1 = ((x * (1 << upsample_above)) & 0x3F) >> 1
    use_above = base1 >= -off_a
    b1 = xp.clip(base1, -off_a, len(above_tl) - off_a - 2)
    av = (above_tl[b1 + off_a] * (32 - shift1)
          + above_tl[b1 + off_a + 1] * shift1 + 16) >> 5
    y = (r << 6) - (c + 1) * dy
    base2 = y >> frac_y
    shift2 = ((y * (1 << upsample_left)) & 0x3F) >> 1
    b2 = xp.clip(base2, -off_l, len(left_tl) - off_l - 2)
    lv = (left_tl[b2 + off_l] * (32 - shift2)
          + left_tl[b2 + off_l + 1] * shift2 + 16) >> 5
    return xp.where(use_above, av, lv).astype(xp.int32)


def filter_intra_predictor(w, h, above, left, topleft: int, fi_mode: int,
                           xp=np, bd: int = 8):
    """Recursive filter-intra (parity: svt_av1_filter_intra_predictor_c).
    Sequential over 4x2 sub-blocks; vectorized within each."""
    taps = _filter_taps()[fi_mode]          # [8, 8] (7 taps + zero pad)
    buf = np.zeros((h + 1, w + 1), dtype=np.int64)
    buf[0, 0] = topleft
    buf[0, 1:] = np.asarray(above[:w])
    buf[1:, 0] = np.asarray(left[:h])

    def rptwos(s):  # ROUND_POWER_OF_TWO_SIGNED(s, FILTER_INTRA_SCALE_BITS=4)
        return (s + 8) >> 4 if s >= 0 else -((-s + 8) >> 4)

    for r in range(1, h + 1, 2):
        for c in range(1, w + 1, 4):
            p = np.array([buf[r - 1, c - 1], buf[r - 1, c], buf[r - 1, c + 1],
                          buf[r - 1, c + 2], buf[r - 1, c + 3], buf[r, c - 1],
                          buf[r + 1, c - 1], 0])
            for k in range(8):
                ro, co = k >> 2, k & 3
                s = int(np.dot(taps[k], p))
                buf[r + ro, c + co] = int(np.clip(rptwos(s), 0, (1 << bd) - 1))
    return buf[1:, 1:].astype(np.int32)


# --------------------------------------------------------------------------
# Edge preparation + full prediction (normative flow)
# --------------------------------------------------------------------------

def filter_intra_edge(p: np.ndarray, sz: int, strength: int) -> np.ndarray:
    """In-place smoothing of edge array p[:sz] (svt_av1_filter_intra_edge_c).
    Each output depends only on the original edge, so the taps vectorize
    as shifted adds over a replicated-padded copy."""
    if not strength or sz <= 1:
        return p
    kernel = [(0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2)][strength - 1]
    e = np.empty(sz + 4, dtype=np.int32)
    e[2:sz + 2] = p[:sz]
    e[0] = e[1] = e[2]
    e[sz + 2] = e[sz + 3] = e[sz + 1]
    s = np.zeros(sz - 1, dtype=np.int32)
    for j, k in enumerate(kernel):
        if k:
            s += k * e[j + 1: j + sz]
    p[1:sz] = (s + 8) >> 4
    return p


def intra_edge_filter_strength(bs0: int, bs1: int, delta: int, ftype: int) -> int:
    d = abs(delta)
    blk_wh = bs0 + bs1
    strength = 0
    if ftype == 0:
        if blk_wh <= 8:
            strength = 1 if d >= 56 else 0
        elif blk_wh <= 16:
            strength = 1 if d >= 40 else 0
        elif blk_wh <= 24:
            strength = 3 if d >= 32 else (2 if d >= 16 else (1 if d >= 8 else 0))
        elif blk_wh <= 32:
            strength = 3 if d >= 32 else (2 if d >= 4 else (1 if d >= 1 else 0))
        else:
            strength = 3 if d >= 1 else 0
    else:
        if blk_wh <= 8:
            strength = 2 if d >= 64 else (1 if d >= 40 else 0)
        elif blk_wh <= 16:
            strength = 2 if d >= 48 else (1 if d >= 20 else 0)
        elif blk_wh <= 24:
            strength = 3 if d >= 4 else 0
        else:
            strength = 3 if d >= 1 else 0
    return strength


def use_intra_edge_upsample(bs0: int, bs1: int, delta: int, ftype: int) -> bool:
    d = abs(delta)
    blk_wh = bs0 + bs1
    if d <= 0 or d >= 40:
        return False
    return blk_wh <= 8 if ftype else blk_wh <= 16


def upsample_intra_edge(p: np.ndarray, sz: int, bd: int = 8) -> np.ndarray:
    """Returns the upsampled edge as a fresh array ``up`` where C's
    p[i] for i in [-2, 2*sz-1) maps to up[i + 2]."""
    src = np.empty(sz + 3, dtype=np.int32)
    src[0] = src[1] = p[0]                 # p[-1] duplicated
    src[2:sz + 2] = p[1:sz + 1]
    src[sz + 2] = p[sz]
    up = np.empty(2 * sz + 2, dtype=np.int32)
    up[0] = src[0]                          # p[-2]
    for i in range(sz):
        s = -src[i] + 9 * src[i + 1] + 9 * src[i + 2] - src[i + 3]
        up[2 * i + 1] = np.clip((s + 8) >> 4, 0, (1 << bd) - 1)  # p[2i-1]
        up[2 * i + 2] = src[i + 2]                       # p[2i]
    up[2 * sz + 1] = src[sz + 2]
    return up


def predict_intra_block(mode: PredictionMode, angle_delta: int,
                        tx_size: TxSize,
                        above_ref: np.ndarray | None,
                        left_ref: np.ndarray | None,
                        topleft_ref: int | None,
                        n_top_px: int, n_topright_px: int,
                        n_left_px: int, n_bottomleft_px: int,
                        filt_type: int = 0,
                        disable_edge_filter: bool = False,
                        filter_intra_mode: int = -1,
                        bd: int = 8) -> np.ndarray:
    """Full normative intra prediction for one block (8-bit path).

    above_ref: available above samples (length >= n_top_px + n_topright_px)
    left_ref: available left samples (length >= n_left_px + n_bottomleft_px)
    topleft_ref: the above-left sample (None if unavailable)
    Returns [h, w] int32 prediction.
    """
    w, h = TX_WIDTH[tx_size], TX_HEIGHT[tx_size]
    use_filter_intra = filter_intra_mode >= 0
    need = EXTEND_MODES[mode]
    need_left = bool(need & NEED_LEFT)
    need_above = bool(need & NEED_ABOVE)
    need_above_left = bool(need & NEED_ABOVELEFT)
    p_angle = 0
    is_dr = is_directional(mode)
    if is_dr:
        p_angle = MODE_TO_ANGLE[mode] + angle_delta * ANGLE_STEP
        if p_angle <= 90:
            need_above, need_left, need_above_left = True, False, True
        elif p_angle < 180:
            need_above, need_left, need_above_left = True, True, True
        else:
            need_above, need_left, need_above_left = False, True, True
    if use_filter_intra:
        need_left = need_above = need_above_left = True

    base = 128 << (bd - 8)
    if (not need_above and n_left_px == 0) or (not need_left and n_top_px == 0):
        val = (int(above_ref[0]) if n_top_px > 0 else base + 1) if need_left \
            else (int(left_ref[0]) if n_left_px > 0 else base - 1)
        return np.full((h, w), val, dtype=np.int32)

    left_col = np.zeros(h + w + 16, dtype=np.int32)
    above_row = np.zeros(w + h + 16, dtype=np.int32)

    if need_left:
        need_bottom = bool(need & NEED_BOTTOMLEFT)
        if use_filter_intra:
            need_bottom = False
        if is_dr:
            need_bottom = p_angle > 180
        num_left = h + (w if need_bottom else 0)
        if n_left_px > 0:
            i = n_left_px
            left_col[:i] = left_ref[:i]
            if need_bottom and n_bottomleft_px > 0:
                m = min(n_bottomleft_px, num_left - i)
                left_col[i:i + m] = left_ref[i:i + m]
                i += m
            if i < num_left:
                left_col[i:num_left] = left_col[i - 1]
        else:
            left_col[:num_left] = int(above_ref[0]) if n_top_px > 0 else base + 1

    if need_above:
        need_right = bool(need & NEED_ABOVERIGHT)
        if use_filter_intra:
            need_right = False
        if is_dr:
            need_right = p_angle < 90
        num_top = w + (h if need_right else 0)
        if n_top_px > 0:
            above_row[:n_top_px] = above_ref[:n_top_px]
            i = n_top_px
            if need_right and n_topright_px > 0:
                m = min(n_topright_px, num_top - w)
                above_row[w:w + m] = above_ref[w:w + m]
                i = w + m
            if i < num_top:
                above_row[i:num_top] = above_row[i - 1]
        else:
            above_row[:num_top] = int(left_ref[0]) if n_left_px > 0 else base - 1

    if n_top_px > 0 and n_left_px > 0:
        topleft = int(topleft_ref)
    elif n_top_px > 0:
        topleft = int(above_ref[0])
    elif n_left_px > 0:
        topleft = int(left_ref[0])
    else:
        topleft = base

    if use_filter_intra:
        return filter_intra_predictor(w, h, above_row, left_col, topleft,
                                      filter_intra_mode, bd=bd)

    if is_dr:
        upsample_above = upsample_left = False
        # Edge arrays with the topleft at index 0, i.e. C index i maps to
        # array index i + 1.  After upsampling, C index i maps to i + 2.
        ab = np.concatenate(([topleft], above_row)).astype(np.int32)
        lf = np.concatenate(([topleft], left_col)).astype(np.int32)
        off_a = off_l = 1
        if not disable_edge_filter:
            need_right = p_angle < 90
            need_bottom = p_angle > 180
            if p_angle != 90 and p_angle != 180:
                ab_le = 1 if need_above_left else 0
                if need_above and need_left and (w + h >= 24):
                    s = (lf[1] * 5 + ab[0] * 6 + ab[1] * 5 + 8) >> 4
                    ab[0] = s
                    lf[0] = s
                if need_above and n_top_px > 0:
                    strength = intra_edge_filter_strength(w, h, p_angle - 90, filt_type)
                    n_px = n_top_px + ab_le + (h if need_right else 0)
                    filter_intra_edge(ab[1 - ab_le:], n_px, strength)
                if need_left and n_left_px > 0:
                    strength = intra_edge_filter_strength(h, w, p_angle - 180, filt_type)
                    n_px = n_left_px + ab_le + (w if need_bottom else 0)
                    filter_intra_edge(lf[1 - ab_le:], n_px, strength)
            upsample_above = use_intra_edge_upsample(w, h, p_angle - 90, filt_type)
            if need_above and upsample_above:
                n_px = w + (h if need_right else 0)
                ab = upsample_intra_edge(ab, n_px, bd)  # C index i -> ab[i + 2]
                off_a = 2
            upsample_left = use_intra_edge_upsample(h, w, p_angle - 180, filt_type)
            if need_left and upsample_left:
                n_px = h + (w if need_bottom else 0)
                lf = upsample_intra_edge(lf, n_px, bd)
                off_l = 2
        ua, ul = int(upsample_above), int(upsample_left)
        if p_angle == 90:
            return v_predictor(w, h, ab[off_a:], lf[off_l:])
        if p_angle == 180:
            return h_predictor(w, h, ab[off_a:], lf[off_l:])
        dx, dy = get_dx(p_angle), get_dy(p_angle)
        if p_angle < 90:
            return dr_predictor_z1(w, h, ab[off_a:], ua, dx)
        if p_angle > 180:
            return dr_predictor_z3(w, h, lf[off_l:], ul, dy)
        # z2 helper expects C index i at array index i + (1 << upsample)
        return dr_predictor_z2(w, h, ab[off_a - (1 << ua):],
                               lf[off_l - (1 << ul):], ua, ul, dx, dy)

    if mode == PredictionMode.DC_PRED:
        return dc_predictor(w, h, above_row, left_col,
                            n_top_px > 0, n_left_px > 0, bd=bd)
    if mode == PredictionMode.V_PRED:
        return v_predictor(w, h, above_row, left_col)
    if mode == PredictionMode.H_PRED:
        return h_predictor(w, h, above_row, left_col)
    if mode == PredictionMode.PAETH_PRED:
        return paeth_predictor(w, h, above_row, left_col, topleft)
    if mode == PredictionMode.SMOOTH_PRED:
        return smooth_predictor(w, h, above_row, left_col)
    if mode == PredictionMode.SMOOTH_V_PRED:
        return smooth_v_predictor(w, h, above_row, left_col)
    if mode == PredictionMode.SMOOTH_H_PRED:
        return smooth_h_predictor(w, h, above_row, left_col)
    raise ValueError(mode)


# --------------------------------------------------------------------------
# Chroma-from-luma (spec 7.11.5; cfl_c.c, EbIntraPrediction.c:349-399)
# --------------------------------------------------------------------------

def cfl_luma_q3(luma_recon_block, xp=np):
    """4:2:0 subsampled Q3 luma buffer: 2x2 box sum << 1."""
    y = luma_recon_block.astype(xp.int32)
    s = y[::2, ::2] + y[::2, 1::2] + y[1::2, ::2] + y[1::2, 1::2]
    return (s << 1).astype(xp.int32)


def cfl_ac(q3, xp=np):
    """Subtract the rounded average (svt_subtract_average_c)."""
    n = q3.size
    log2n = int(n).bit_length() - 1
    avg = (int(q3.sum()) + (n >> 1)) >> log2n
    return q3 - avg


def cfl_predict(dc_pred, ac_q3, alpha_q3: int, bd: int = 8, xp=np):
    """dst = clip(dc + round_signed(alpha_q3 * ac_q3, 6))."""
    v = alpha_q3 * ac_q3
    scaled = xp.where(v >= 0, (v + 32) >> 6, -((-v + 32) >> 6))
    return xp.clip(dc_pred + scaled, 0, (1 << bd) - 1)


def cfl_idx_to_alpha(alpha_idx: int, joint_sign: int, plane_u: bool) -> int:
    sign = cfl_sign_u(joint_sign) if plane_u else cfl_sign_v(joint_sign)
    if sign == 0:                     # CFL_SIGN_ZERO
        return 0
    mag = (alpha_idx >> 4) if plane_u else (alpha_idx & 15)
    return (mag + 1) if sign == 2 else -(mag + 1)


def cfl_sign_u(js: int) -> int:
    return ((js + 1) * 11) >> 5


def cfl_sign_v(js: int) -> int:
    return (js + 1) - 3 * cfl_sign_u(js)
