"""Loop restoration: Wiener filter path (AV1 spec 7.17).

TPU-first formulation: the reference filters 64x64 processing stripes
with line buffers preserving deblocked rows across CDEF
(EbRestoration.c svt_av1_loop_restoration_filter_unit, boundary logic
setup_processing_stripe_boundary:353; convolve core
svt_av1_wiener_convolve_add_src_c, convolve.c).  Because every stripe's
sources are fully determined by (cdef output, deblock output), each
stripe is materialized as one extended tensor and the 7-tap separable
filter runs as stacked shifts — batched, stateless, reproducible on
both encoder and decoder.

Unit geometry follows foreach_rest_unit_in_tile (EbRestoration.c:1366):
unit rows shifted up by RESTORATION_UNIT_OFFSET, last unit absorbs
remainders below 1.5x the unit size.
"""
from __future__ import annotations

import dataclasses

import numpy as np

RESTORATION_UNIT_OFFSET = 8
RESTORATION_PROC_UNIT_SIZE = 64
FILTER_BITS = 7

WIENER_WIN = 7
# coded tap ranges/midpoints (EbRestoration.h:125-153)
WIENER_TAPS_MID = (3, -7, 15)
WIENER_TAPS_MIN = (-5, -23, -17)
WIENER_TAPS_MAX = (10, 8, 46)
WIENER_SUBEXP_K = (1, 2, 3)

RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE = range(4)


def default_wiener_taps():
    return list(WIENER_TAPS_MID)


def unit_limits(frame_size: int, unit_size: int):
    """[(start, end)] unit spans along one axis, with the vertical-style
    extension handled by the caller (horizontal uses this directly)."""
    out = []
    x0 = 0
    while x0 < frame_size:
        remaining = frame_size - x0
        w = remaining if remaining < unit_size * 3 // 2 else unit_size
        out.append((x0, x0 + w))
        x0 += w
    return out


def unit_limits_vert(frame_size: int, unit_size: int, ss_y: int):
    """Vertical spans are shifted up by the unit offset (stripe align)."""
    voff = RESTORATION_UNIT_OFFSET >> ss_y
    out = []
    for (v0, v1) in unit_limits(frame_size, unit_size):
        a = max(0, v0 - voff)
        b = v1 - voff if v1 < frame_size else v1
        out.append((a, b))
    return out


def count_units(frame_size: int, unit_size: int) -> int:
    return max((frame_size + (unit_size >> 1)) // unit_size, 1)


def _stripe_spans(v_start: int, v_end: int, ss_y: int, frame_top: int = 0):
    """Split a unit's row range into processing stripes (the while loop of
    svt_dec_av1_loop_restoration_filter_unit)."""
    fsh = RESTORATION_PROC_UNIT_SIZE >> ss_y
    voff = RESTORATION_UNIT_OFFSET >> ss_y
    spans = []
    v = v_start
    while v < v_end:
        stripe_idx = (v - frame_top + voff) // fsh
        nominal = fsh - (voff if stripe_idx == 0 else 0)
        h = min(nominal, ((v_end - v) + 1) & ~1)
        spans.append((v, v + h))
        v += h
    return spans


def build_stripe_ext(cdef, deblock, v0: int, v1: int, h0: int, h1: int,
                     fw: int, fh: int) -> np.ndarray:
    """Extended source for one stripe: rows [v0-3, v1+3) x cols
    [h0-3, h1+3), int32.  Vertical reads clamp to the stripe +-2 and use
    the DEBLOCKED frame outside the stripe (spec get_source_sample);
    horizontal/frame edges replicate."""
    rows = []
    for r in range(v0 - 3, v1 + 3):
        y = int(np.clip(r, v0 - 2, v1 + 1))
        y = int(np.clip(y, 0, fh - 1))
        src = cdef if v0 <= y < v1 else deblock
        rows.append(src[y])
    buf = np.stack(rows).astype(np.int32)
    cols = np.clip(np.arange(h0 - 3, h1 + 3), 0, fw - 1)
    return buf[:, cols]


def apply_wiener_unit(cdef, deblock, v0, v1, h0, h1, taps_v, taps_h,
                      ss_y: int, fw: int, fh: int, bd: int = 8):
    """Filter one restoration unit; returns the [v1-v0, h1-h0] block."""
    out = np.empty((v1 - v0, h1 - h0), np.int32)
    for (s0, s1) in _stripe_spans(v0, v1, ss_y):
        ext = build_stripe_ext(cdef, deblock, s0, s1, h0, h1, fw, fh)
        # chroma taps: 5-tap window (outer tap zero)
        out[s0 - v0:s1 - v0] = wiener_stripe_vh(ext, taps_v, taps_h, bd)
    return out


def wiener_stripe_vh(ext: np.ndarray, taps_v, taps_h, bd: int = 8):
    """Like wiener_stripe but with distinct vertical/horizontal taps."""
    fh_ = _full_taps(taps_h)
    fv_ = _full_taps(taps_v)
    r0 = 3 + (2 if bd == 12 else 0)
    r1 = 2 * FILTER_BITS - r0
    h = ext.shape[0] - 6
    w = ext.shape[1] - 6
    acc = np.zeros((h + 6, w), np.int64)
    for k in range(7):
        acc += int(fh_[k]) * ext[:, k:k + w]
    acc += (ext[:, 3:3 + w].astype(np.int64) << FILTER_BITS) \
        + (1 << (bd + FILTER_BITS - 1))
    clamp_hi = (1 << (bd + 1 + FILTER_BITS - r0)) - 1
    im = np.clip((acc + (1 << (r0 - 1))) >> r0, 0, clamp_hi)
    acc2 = np.zeros((h, w), np.int64)
    for k in range(7):
        acc2 += int(fv_[k]) * im[k:k + h]
    acc2 += (im[3:3 + h] << FILTER_BITS) - (1 << (bd + r1 - 1))
    out = (acc2 + (1 << (r1 - 1))) >> r1
    return np.clip(out, 0, (1 << bd) - 1).astype(np.int32)


def _full_taps(t3):
    t0, t1, t2 = t3
    return (t0, t1, t2, -2 * (t0 + t1 + t2), t2, t1, t0)


# --------------------------------------------------------------------------
# Encoder-side Wiener pick (the analog of EbRestorationPick.c
# search_wiener: compute_stats + wiener_decompose_sep_sym)
# --------------------------------------------------------------------------

def pick_wiener_unit(src, cdef, deblock, v0, v1, h0, h1, ss_y, fw, fh,
                     bd: int = 8, is_chroma: bool = False):
    """Least-squares separable Wiener taps for one unit; returns
    (taps_v, taps_h, sse_filtered, sse_none) with quantized integer taps
    (None taps if degenerate)."""
    # design matrix from shifted views of the same stripe-extended
    # sources the decoder will see
    win = 7
    half = 3
    cols = []
    tgt = []
    center = []
    for (s0, s1) in _stripe_spans(v0, v1, ss_y):
        ext = build_stripe_ext(cdef, deblock, s0, s1, h0, h1, fw, fh)
        hh = s1 - s0
        ww = h1 - h0
        stack = np.empty((win * win, hh * ww), np.float64)
        idx = 0
        for dy in range(win):
            for dx in range(win):
                stack[idx] = ext[dy:dy + hh, dx:dx + ww].reshape(-1)
                idx += 1
        cols.append(stack)
        tgt.append(src[s0:s1, h0:h1].reshape(-1).astype(np.float64))
        center.append(ext[half:half + hh, half:half + ww].reshape(-1)
                      .astype(np.float64))
    D = np.concatenate(cols, axis=1)          # [49, npx]
    s = np.concatenate(tgt)
    c = np.concatenate(center)
    sse_none = float(((c - s) ** 2).sum())

    # normal equations for the 49-tap filter, then separable ALS
    H = D @ D.T
    M = D @ s
    # symmetric + normalized parametrization: taps (q0,q1,q2) give the
    # 7-tap filter e3 + sum_k q_k (e_k + e_{6-k} - 2 e_3)
    B = np.zeros((win, 3))
    for k in range(3):
        B[k, k] = 1
        B[6 - k, k] = 1
        B[3, k] = -2
    e3 = np.zeros(win)
    e3[3] = 1.0

    def taps_to_full(q):
        return e3 + B @ q

    q_a = np.array([WIENER_TAPS_MID[k] / 128.0 for k in range(3)])
    q_b = q_a.copy()

    Ht = H.reshape(win, win, win, win)

    def solve_dir(fixed_full, vertical):
        if vertical:
            A = np.einsum("j,l,ijkl->ik", fixed_full, fixed_full, Ht)
            rhs = np.einsum("j,ij->i", fixed_full, M.reshape(win, win))
        else:
            A = np.einsum("i,k,ijkl->jl", fixed_full, fixed_full, Ht)
            rhs = np.einsum("i,ij->j", fixed_full, M.reshape(win, win))
        Ar = B.T @ A @ B
        rr = B.T @ (rhs - A @ e3)
        try:
            return np.linalg.lstsq(Ar + 1e-2 * np.eye(3), rr, rcond=None)[0]
        except np.linalg.LinAlgError:
            return None

    for _ in range(2):
        nq = solve_dir(taps_to_full(q_b), vertical=True)
        if nq is not None:
            q_a = nq
        nq = solve_dir(taps_to_full(q_a), vertical=False)
        if nq is not None:
            q_b = nq

    def quantize(q):
        taps = []
        for k in range(3):
            lo, hi = WIENER_TAPS_MIN[k], WIENER_TAPS_MAX[k]
            if is_chroma and k == 0:
                taps.append(0)
                continue
            v = int(np.clip(round(q[k] * 128), lo, hi))
            taps.append(v)
        return taps

    tv, th = quantize(q_a), quantize(q_b)
    filt = apply_wiener_unit(cdef, deblock, v0, v1, h0, h1, tv, th,
                             ss_y, fw, fh, bd)
    sse_f = float(((filt.astype(np.float64)
                    - src[v0:v1, h0:h1]) ** 2).sum())
    return tv, th, sse_f, sse_none


# --------------------------------------------------------------------------
# SGRPROJ restoration (spec 7.17.3; the reference's SGR filter
# EbRestoration.c:1012, its projection apply :1059, svt_decode_xq:707).
# Stripes/borders reuse the Wiener machinery:
# SGRPROJ_BORDER == 3 == the stripe extension this module already builds.
# --------------------------------------------------------------------------

SGRPROJ_PARAMS_BITS = 4
SGRPROJ_PRJ_BITS = 7
SGRPROJ_RST_BITS = 4
SGRPROJ_SGR_BITS = 8
SGRPROJ_SGR = 1 << SGRPROJ_SGR_BITS
SGRPROJ_MTABLE_BITS = 20
SGRPROJ_RECIP_BITS = 12
SGRPROJ_PRJ_MIN0, SGRPROJ_PRJ_MAX0 = -96, 31
SGRPROJ_PRJ_MIN1, SGRPROJ_PRJ_MAX1 = -32, 95
SGRPROJ_PRJ_SUBEXP_K = 4


def default_sgr_xqd():
    """set_default_sgrproj (EbRestoration.h:240; C trunc division)."""
    return [-32, 31]


def _sgr_tables():
    from ..entropy.tables import table
    return (table("eb_sgr_params").astype(np.int64),
            table("eb_x_by_xplus1").astype(np.int64),
            table("eb_one_by_x").astype(np.int64))


def _rpt(x, n: int):
    """ROUND_POWER_OF_TWO (arithmetic shift; n == 0 is the identity)."""
    if n == 0:
        return x
    return (x + (1 << (n - 1))) >> n


def _boxsum_grid(x: np.ndarray, r: int, h: int, w: int) -> np.ndarray:
    """Full (2r+1)^2 box sums of ext array ``x`` [h+6, w+6] at unit
    positions i in [-1, h], j in [-1, w] -> [h+2, w+2] int64."""
    ii = np.cumsum(np.cumsum(x, 0), 1)
    ii = np.pad(ii, ((1, 0), (1, 0)))
    # box centered at unit (i, j) spans ext rows (3+i-r .. 3+i+r)
    r0 = 3 - 1 - r                      # ext row of the first center - r
    c0 = 3 - 1 - r
    n = 2 * r + 1
    H, W = h + 2, w + 2
    return (ii[r0 + n:r0 + n + H, c0 + n:c0 + n + W]
            - ii[r0:r0 + H, c0 + n:c0 + n + W]
            - ii[r0 + n:r0 + n + H, c0:c0 + W]
            + ii[r0:r0 + H, c0:c0 + W])


def _sgr_ab(ext, r: int, s: int, h: int, w: int, bd: int):
    """A'/B' maps [h+2, w+2] (unit coords offset by +1)."""
    _, x_by_xplus1, one_by_x = _sgr_tables()
    x = ext.astype(np.int64)
    B = _boxsum_grid(x, r, h, w)
    A = _boxsum_grid(x * x, r, h, w)
    n = (2 * r + 1) * (2 * r + 1)
    a = _rpt(A, 2 * (bd - 8))
    b = _rpt(B, bd - 8)
    p = np.maximum(a * n - b * b, 0)
    z = _rpt(p * s, SGRPROJ_MTABLE_BITS)
    Ao = x_by_xplus1[np.minimum(z, 255)]
    Bo = _rpt((SGRPROJ_SGR - Ao) * B * one_by_x[n - 1], SGRPROJ_RECIP_BITS)
    return Ao, Bo


def sgr_stripe_flt(ext, ep: int, radius_idx: int, bd: int = 8):
    """One radius of the SGR filter over a stripe-extended source
    [h+6, w+6] -> flt [h, w] int32 (the reference's fast and internal
    SGR filters)."""
    params, _, _ = _sgr_tables()
    r = int(params[ep][radius_idx])
    s = int(params[ep][2 + radius_idx])
    h, w = ext.shape[0] - 6, ext.shape[1] - 6
    A, B = _sgr_ab(ext, r, s, h, w, bd)      # [h+2, w+2], idx (i+1, j+1)
    dgd = ext[3:3 + h, 3:3 + w].astype(np.int64)
    out = np.zeros((h, w), np.int64)
    if radius_idx == 0:                      # fast path: r == 2
        # A/B live on odd unit rows (-1, 1, 3, ...)
        for i in range(h):
            if i % 2 == 0:                   # even row: rows i-1, i+1
                Au, Ad = A[i], A[i + 2]
                Bu, Bd = B[i], B[i + 2]
                a = (Au[1:-1] + Ad[1:-1]) * 6 + \
                    (Au[:-2] + Ad[:-2] + Au[2:] + Ad[2:]) * 5
                b = (Bu[1:-1] + Bd[1:-1]) * 6 + \
                    (Bu[:-2] + Bd[:-2] + Bu[2:] + Bd[2:]) * 5
                nb = 5
            else:
                Ac, Bc = A[i + 1], B[i + 1]
                a = Ac[1:-1] * 6 + (Ac[:-2] + Ac[2:]) * 5
                b = Bc[1:-1] * 6 + (Bc[:-2] + Bc[2:]) * 5
                nb = 4
            v = a * dgd[i] + b
            out[i] = _rpt(v, SGRPROJ_SGR_BITS + nb - SGRPROJ_RST_BITS)
        return out.astype(np.int32)
    # normal path (r == 1): 3x3 cross 4 / diagonal 3 weights, vectorized
    Ac = A[1:-1, 1:-1]
    a = (Ac + A[1:-1, :-2] + A[1:-1, 2:] + A[:-2, 1:-1] + A[2:, 1:-1]) * 4 \
        + (A[:-2, :-2] + A[:-2, 2:] + A[2:, :-2] + A[2:, 2:]) * 3
    Bc = B[1:-1, 1:-1]
    b = (Bc + B[1:-1, :-2] + B[1:-1, 2:] + B[:-2, 1:-1] + B[2:, 1:-1]) * 4 \
        + (B[:-2, :-2] + B[:-2, 2:] + B[2:, :-2] + B[2:, 2:]) * 3
    v = a * dgd + b
    return _rpt(v, SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS).astype(np.int32)


def decode_xq(xqd, ep: int):
    """svt_decode_xq (EbRestoration.c:707)."""
    params, _, _ = _sgr_tables()
    r0, r1 = int(params[ep][0]), int(params[ep][1])
    if r0 == 0:
        return 0, (1 << SGRPROJ_PRJ_BITS) - xqd[1]
    if r1 == 0:
        return xqd[0], 0
    return xqd[0], (1 << SGRPROJ_PRJ_BITS) - xqd[0] - xqd[1]


def _sgr_combine(dgd, flt0, flt1, ep: int, xqd, bd: int):
    """The reference's SGR projection combine (EbRestoration.c)."""
    params, _, _ = _sgr_tables()
    r0, r1 = int(params[ep][0]), int(params[ep][1])
    xq0, xq1 = decode_xq(xqd, ep)
    u = dgd.astype(np.int64) << SGRPROJ_RST_BITS
    v = u << SGRPROJ_PRJ_BITS
    if r0 > 0:
        v = v + xq0 * (flt0.astype(np.int64) - u)
    if r1 > 0:
        v = v + xq1 * (flt1.astype(np.int64) - u)
    w = _rpt(v, SGRPROJ_PRJ_BITS + SGRPROJ_RST_BITS)
    return np.clip(w, 0, (1 << bd) - 1).astype(np.int32)


def apply_sgr_unit(cdef, deblock, v0, v1, h0, h1, ep: int, xqd,
                   ss_y: int, fw: int, fh: int, bd: int = 8) -> np.ndarray:
    """Normative SGR of one LR unit (stripe by stripe); returns the
    restored [v1-v0, h1-h0] block."""
    params, _, _ = _sgr_tables()
    r0, r1 = int(params[ep][0]), int(params[ep][1])
    out = np.zeros((v1 - v0, h1 - h0), np.int32)
    for (s0, s1) in _stripe_spans(v0, v1, ss_y):
        ext = build_stripe_ext(cdef, deblock, s0, s1, h0, h1, fw, fh)
        flt0 = sgr_stripe_flt(ext, ep, 0, bd) if r0 > 0 else None
        flt1 = sgr_stripe_flt(ext, ep, 1, bd) if r1 > 0 else None
        dgd = ext[3:-3, 3:-3]
        out[s0 - v0:s1 - v0] = _sgr_combine(dgd, flt0, flt1, ep, xqd, bd)
    return out


def _quantize_xqd(xq, ep: int):
    """Encoder-side xq -> coded xqd (inverse of decode_xq, clipped)."""
    params, _, _ = _sgr_tables()
    r0, r1 = int(params[ep][0]), int(params[ep][1])
    clip0 = lambda v: int(np.clip(v, SGRPROJ_PRJ_MIN0, SGRPROJ_PRJ_MAX0))
    clip1 = lambda v: int(np.clip(v, SGRPROJ_PRJ_MIN1, SGRPROJ_PRJ_MAX1))
    if r0 == 0:
        return [0, clip1((1 << SGRPROJ_PRJ_BITS) - xq[1])]
    if r1 == 0:
        xqd0 = clip0(xq[0])
        return [xqd0, clip1((1 << SGRPROJ_PRJ_BITS) - xqd0)]
    xqd0 = clip0(xq[0])
    return [xqd0, clip1((1 << SGRPROJ_PRJ_BITS) - xqd0 - xq[1])]


def pick_sgr_unit(src, cdef, deblock, v0, v1, h0, h1, ss_y, fw, fh,
                  bd: int = 8, ep_set=(0, 4, 9, 11, 14)):
    """Search ep candidates + least-squares projection (the analog of
    EbRestorationPick.c search_sgrproj / get_proj_subspace).  Returns
    (ep, xqd, sse_filtered, sse_none)."""
    params, _, _ = _sgr_tables()
    best = None
    spans = _stripe_spans(v0, v1, ss_y)
    exts = [build_stripe_ext(cdef, deblock, s0, s1, h0, h1, fw, fh)
            for (s0, s1) in spans]
    srcs = [src[s0:s1, h0:h1].astype(np.int64) for (s0, s1) in spans]
    sse_none = float(sum(((e[3:-3, 3:-3] - s) ** 2).sum()
                         for e, s in zip(exts, srcs)))
    for ep in ep_set:
        r0, r1 = int(params[ep][0]), int(params[ep][1])
        f0s, f1s, us, ts = [], [], [], []
        for ext, s in zip(exts, srcs):
            dgd = ext[3:-3, 3:-3].astype(np.int64)
            u = dgd << SGRPROJ_RST_BITS
            f0 = sgr_stripe_flt(ext, ep, 0, bd).astype(np.int64) \
                if r0 > 0 else u
            f1 = sgr_stripe_flt(ext, ep, 1, bd).astype(np.int64) \
                if r1 > 0 else u
            f0s.append((f0 - u).ravel())
            f1s.append((f1 - u).ravel())
            us.append(u.ravel())
            ts.append(((s << SGRPROJ_RST_BITS) - u).ravel())
        f0v = np.concatenate(f0s).astype(np.float64)
        f1v = np.concatenate(f1s).astype(np.float64)
        tv = np.concatenate(ts).astype(np.float64)
        # solve the 2x2 least squares for xq (per-radius when one is off)
        H00, H11 = (f0v * f0v).sum(), (f1v * f1v).sum()
        H01 = (f0v * f1v).sum()
        c0, c1 = (f0v * tv).sum(), (f1v * tv).sum()
        xq = [0.0, 0.0]
        if r0 > 0 and r1 > 0:
            det = H00 * H11 - H01 * H01
            if det > 0:
                xq = [(H11 * c0 - H01 * c1) / det * (1 << SGRPROJ_PRJ_BITS),
                      (H00 * c1 - H01 * c0) / det * (1 << SGRPROJ_PRJ_BITS)]
        elif r0 > 0:
            xq[0] = (c0 / H00 if H00 > 0 else 0) * (1 << SGRPROJ_PRJ_BITS)
        else:
            xq[1] = (c1 / H11 if H11 > 0 else 0) * (1 << SGRPROJ_PRJ_BITS)
        xqd = _quantize_xqd([int(round(xq[0])), int(round(xq[1]))], ep)
        # exact SSE with the quantized params
        err = 0.0
        for ext, s, f0r, f1r, ur in zip(exts, srcs, f0s, f1s, us):
            dgd = ext[3:-3, 3:-3]
            flt0v = (f0r + ur).reshape(dgd.shape)
            flt1v = (f1r + ur).reshape(dgd.shape)
            rec = _sgr_combine(dgd, flt0v, flt1v, ep, xqd, bd)
            err += float(((rec.astype(np.int64) - s) ** 2).sum())
        if best is None or err < best[2]:
            best = (ep, xqd, err)
    return best[0], best[1], best[2], sse_none
