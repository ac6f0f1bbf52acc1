"""CDEF: constrained directional enhancement filter (AV1 spec 7.15).

TPU-first formulation: the reference filters 8x8 blocks one at a time
inside a 64x64 filter-block loop with line/column buffers to preserve
pre-CDEF neighbors (EbCdef.c svt_cdef_filter_fb, svt_cdef_find_dir_c:133,
svt_cdef_filter_block_c:204; decoder loop EbDecCdef.c svt_cdef_block).
Because every filtered pixel depends only on *pre-CDEF* pixels, the whole
frame is a pure function of the deblocked frame: we batch every eligible
8x8 unit into one [N, h+4, w+4] tensor and evaluate direction search and
the filter as dense tensor algebra (einsum + shifted windows), which maps
straight onto the TPU VPU with no sequential state.

Integer exactness: all math in int32, matching the reference C bit-for-bit
(oracle-tested in tests/test_cdef.py).
"""
from __future__ import annotations

import functools

import numpy as np

CDEF_VERY_LARGE = 16384
CDEF_SEC_STRENGTHS = 4

# primary tap pairs indexed by (adjusted pri_strength >> coeff_shift) & 1
PRI_TAPS = np.array([[4, 2], [3, 3]], np.int32)
SEC_TAPS = np.array([[2, 1], [2, 1]], np.int32)

# cdef_directions as (row, col) offsets for taps k=0,1
# (EbCdef.c eb_cdef_directions, expressed stride-free)
DIRECTIONS = np.array([
    [[-1, 1], [-2, 2]],
    [[0, 1], [-1, 2]],
    [[0, 1], [0, 2]],
    [[0, 1], [1, 2]],
    [[1, 1], [2, 2]],
    [[1, 0], [2, 1]],
    [[1, 0], [2, 0]],
    [[1, 0], [2, -1]],
], np.int32)                 # [dir, k, (dy, dx)]


# --------------------------------------------------------------------------
# Direction search
# --------------------------------------------------------------------------

@functools.cache
def _dir_matrices():
    """One-hot [8, 15, 64] bin map M and [8, 15] cost weights W such that
    partial[d, b] = sum_p M[d,b,p] * (x[p] - 128) and
    cost[d] = sum_b W[d,b] * partial[d,b]^2 (svt_cdef_find_dir_c)."""
    M = np.zeros((8, 15, 64), np.int32)
    for i in range(8):
        for j in range(8):
            p = i * 8 + j
            M[0, i + j, p] += 1
            M[1, i + j // 2, p] += 1
            M[2, i, p] += 1
            M[3, 3 + i - j // 2, p] += 1
            M[4, 7 + i - j, p] += 1
            M[5, 3 - i // 2 + j, p] += 1
            M[6, j, p] += 1
            M[7, i // 2 + j, p] += 1
    div = [0, 840, 420, 280, 210, 168, 140, 120, 105]
    W = np.zeros((8, 15), np.int64)
    for d in (0, 4):
        for b in range(15):
            W[d, b] = div[min(b, 14 - b) + 1]
    for d in (2, 6):
        W[d, :8] = div[8]
    for d in (1, 3, 5, 7):
        for b in range(3):
            W[d, b] = div[2 * b + 2]
            W[d, 10 - b] = div[2 * (10 - (10 - b)) + 2]  # same table entry
        W[d, 3:8] = div[8]
    return M, W


def find_dir(blocks: np.ndarray, coeff_shift: int = 0):
    """Batched direction search over [N, 8, 8] uint16 luma blocks.
    Returns (dirs [N], var [N]) identical to svt_cdef_find_dir_c."""
    M, W = _dir_matrices()
    x = (blocks.reshape(-1, 64).astype(np.int64) >> coeff_shift) - 128
    partial = np.einsum("dbp,np->ndb", M, x)          # [N, 8, 15]
    cost = np.einsum("db,ndb->nd", W, partial * partial)
    best = np.argmax(cost, axis=1)
    n = np.arange(len(cost))
    var = (cost[n, best] - cost[n, (best + 4) & 7]) >> 10
    return best.astype(np.int32), var.astype(np.int32)


def adjust_strength(strength: int, var: np.ndarray) -> np.ndarray:
    """Variance-adaptive primary strength (luma only)."""
    v6 = var >> 6
    msb = np.zeros_like(var)
    nz = v6 > 0
    msb[nz] = np.minimum(np.int64(np.log2(v6[nz].astype(np.float64))).astype(var.dtype), 12)
    out = (strength * (4 + msb) + 8) >> 4
    return np.where(var > 0, out, 0).astype(np.int32)


# --------------------------------------------------------------------------
# Filter
# --------------------------------------------------------------------------

def _constrain(diff: np.ndarray, strength: np.ndarray, damping: int) -> np.ndarray:
    """Per-element constrain(); strength may be scalar or [N,1,1]."""
    s = np.asarray(strength, np.int32)
    adiff = np.abs(diff)
    # shift = max(0, damping - msb(strength)); strength==0 handled by mask
    msb = np.zeros_like(s)
    pos = s > 0
    msb = np.where(pos, np.int32(np.log2(np.maximum(s, 1))), 0)
    shift = np.maximum(0, damping - msb)
    mag = np.minimum(adiff, np.maximum(0, s - (adiff >> shift)))
    return np.where(pos, np.sign(diff) * mag, 0).astype(np.int32)


def filter_blocks(windows: np.ndarray, dirs: np.ndarray,
                  pri_strength: np.ndarray, sec_strength: int,
                  pri_damping: int, sec_damping: int,
                  coeff_shift: int = 0) -> np.ndarray:
    """Batched CDEF of [N, h+4, w+4] windows (pre-CDEF pixels, int32,
    CDEF_VERY_LARGE padding) -> [N, h, w] filtered pixels.

    dirs: [N] direction per block. pri_strength: [N] (luma: variance
    adjusted; chroma: constant). Matches svt_cdef_filter_block_c.
    """
    n, hp, wp = windows.shape
    h, w = hp - 4, wp - 4
    x = windows[:, 2:2 + h, 2:2 + w].astype(np.int32)
    pri = np.asarray(pri_strength, np.int32).reshape(-1, 1, 1)
    tap_idx = (pri.reshape(-1) >> coeff_shift) & 1
    pri_taps = PRI_TAPS[tap_idx]                     # [N, 2]
    sec_taps = SEC_TAPS[tap_idx]

    sum_ = np.zeros((n, h, w), np.int32)
    mx = x.copy()
    mn = x.copy()
    win = windows.astype(np.int32)

    def shifted(dy_arr, dx_arr):
        """Gather the neighbor plane at per-block offsets (dy, dx)."""
        out = np.empty((n, h, w), np.int32)
        for dy in np.unique(dy_arr):
            for dx in np.unique(dx_arr[dy_arr == dy]):
                sel = (dy_arr == dy) & (dx_arr == dx)
                out[sel] = win[sel][:, 2 + dy:2 + dy + h, 2 + dx:2 + dx + w]
        return out

    dirs = np.asarray(dirs, np.int32)
    for k in range(2):
        off = DIRECTIONS[dirs, k]                    # [N, 2]
        for sign in (1, -1):
            p = shifted(sign * off[:, 0], sign * off[:, 1])
            sum_ += pri_taps[:, k][:, None, None] * _constrain(
                p - x, pri, pri_damping)
            mx = np.maximum(mx, np.where(p == CDEF_VERY_LARGE, mx, p))
            mn = np.minimum(mn, p)
        for rot in (2, 6):
            off = DIRECTIONS[(dirs + rot) & 7, k]
            for sign in (1, -1):
                s = shifted(sign * off[:, 0], sign * off[:, 1])
                sum_ += sec_taps[:, k][:, None, None] * _constrain(
                    s - x, np.int32(sec_strength), sec_damping)
                mx = np.maximum(mx, np.where(s == CDEF_VERY_LARGE, mx, s))
                mn = np.minimum(mn, s)
    y = x + ((8 + sum_ - (sum_ < 0)) >> 4)
    return np.clip(y, mn, mx)


# --------------------------------------------------------------------------
# Frame-level application (normative; encoder and decoder share it)
# --------------------------------------------------------------------------

def _nonskip_units(skips: np.ndarray, mi_rows: int, mi_cols: int):
    """8x8-luma-unit (by, bx) list where not all four 4x4 mi are skip
    (spec 7.15.1; dec_is_8x8_block_skip)."""
    r1 = (mi_rows + 1) // 2
    c1 = (mi_cols + 1) // 2
    s = np.ones((r1 * 2, c1 * 2), bool)
    s[:mi_rows, :mi_cols] = skips[:mi_rows, :mi_cols] != 0
    unit_skip = s.reshape(r1, 2, c1, 2).all(axis=(1, 3))
    by, bx = np.nonzero(~unit_skip)
    return by.astype(np.int32), bx.astype(np.int32)


def _extract_windows(plane: np.ndarray, by, bx, bh: int, bw: int,
                     frame_w: int, frame_h: int) -> np.ndarray:
    """[N, bh+4, bw+4] windows around each unit, CDEF_VERY_LARGE outside
    the (mi-aligned) frame."""
    pad = np.full((frame_h + 4, frame_w + 4), CDEF_VERY_LARGE, np.int32)
    pad[2:2 + frame_h, 2:2 + frame_w] = plane[:frame_h, :frame_w]
    ys = by * bh
    xs = bx * bw
    rows = ys[:, None, None] + np.arange(bh + 4)[None, :, None]
    cols = xs[:, None, None] + np.arange(bw + 4)[None, None, :]
    return pad[rows, cols]


def cdef_frame(planes, skips, mi_rows: int, mi_cols: int,
               y_strength: int, uv_strength: int, damping: int,
               bit_depth: int = 8, dirs_out=None):
    """Apply CDEF to recon ``planes`` (list of int32 arrays, luma first;
    pre-CDEF = post-deblock values). Returns new plane list.

    y_strength/uv_strength use the coded packing pri*4+sec; damping is the
    frame cdef_damping (3..6). Pure function of its inputs (spec 7.15).
    """
    coeff_shift = max(bit_depth - 8, 0)
    by, bx = _nonskip_units(skips, mi_rows, mi_cols)
    if len(by) == 0:
        return [p.copy() for p in planes]
    fw, fh = mi_cols * 4, mi_rows * 4

    y_pri = (y_strength // CDEF_SEC_STRENGTHS) << coeff_shift
    y_sec = y_strength % CDEF_SEC_STRENGTHS
    y_sec = (y_sec + (y_sec == 3)) << coeff_shift
    uv_pri = (uv_strength // CDEF_SEC_STRENGTHS) << coeff_shift
    uv_sec = uv_strength % CDEF_SEC_STRENGTHS
    uv_sec = (uv_sec + (uv_sec == 3)) << coeff_shift

    luma_win = _extract_windows(planes[0], by, bx, 8, 8, fw, fh)
    dirs, var = find_dir(
        luma_win[:, 2:10, 2:10].astype(np.uint16), coeff_shift)
    if dirs_out is not None:
        dirs_out.append((by, bx, dirs, var))

    out = [p.copy() for p in planes]
    if y_pri or y_sec:
        pri_adj = adjust_strength(y_pri, var)
        ctx = _SearchCtx(luma_win, np.where(y_pri > 0, dirs, 0))
        filt = ctx.run(pri_adj, y_sec, damping + coeff_shift,
                       damping + coeff_shift, coeff_shift)
        _scatter(out[0], filt, by * 8, bx * 8)
    if len(planes) > 1 and (uv_pri or uv_sec):
        cw, ch = fw >> 1, fh >> 1
        d = damping + coeff_shift - 1
        cdirs = np.where(uv_pri > 0, dirs, 0)
        pri_arr = np.full(len(by), uv_pri, np.int32)
        for pli in (1, 2):
            wins = _extract_windows(planes[pli], by, bx, 4, 4, cw, ch)
            ctx = _SearchCtx(wins, cdirs)
            filt = ctx.run(pri_arr, uv_sec, d, d, coeff_shift)
            _scatter(out[pli], filt, by * 4, bx * 4)
    return out


def _scatter(plane: np.ndarray, blocks: np.ndarray, ys, xs):
    bh, bw = blocks.shape[1:]
    ph, pw = plane.shape
    for i in range(len(ys)):
        y, x = int(ys[i]), int(xs[i])
        h = min(bh, ph - y)
        w = min(bw, pw - x)
        plane[y:y + h, x:x + w] = blocks[i, :h, :w]


# --------------------------------------------------------------------------
# Encoder-side strength search
# --------------------------------------------------------------------------

class _SearchCtx:
    """Shared per-(windows, dirs) state: the 16 neighbor diffs, clamp
    bounds and center pixels, gathered once so every strength combo is
    pure elementwise math (the batched analog of the reference's combo
    loop in EbEncCdef.c svt_av1_cdef_search)."""

    def __init__(self, windows, dirs):
        n, hp, wp = windows.shape
        h, w = hp - 4, wp - 4
        win = windows.astype(np.int32)
        x = win[:, 2:2 + h, 2:2 + w]
        self.x = x
        diffs_p, diffs_s = [], []
        mx, mn = x.copy(), x.copy()

        def shifted(dy_arr, dx_arr):
            out = np.empty((n, h, w), np.int32)
            for dy in np.unique(dy_arr):
                sel_y = dy_arr == dy
                for dx in np.unique(dx_arr[sel_y]):
                    sel = sel_y & (dx_arr == dx)
                    out[sel] = win[sel][:, 2 + dy:2 + dy + h,
                                        2 + dx:2 + dx + w]
            return out

        dirs = np.asarray(dirs, np.int32)
        for k in range(2):
            off = DIRECTIONS[dirs, k]
            for sign in (1, -1):
                p = shifted(sign * off[:, 0], sign * off[:, 1])
                mx = np.maximum(mx, np.where(p == CDEF_VERY_LARGE, mx, p))
                mn = np.minimum(mn, p)
                diffs_p.append(p - x)
            for rot in (2, 6):
                off2 = DIRECTIONS[(dirs + rot) & 7, k]
                for sign in (1, -1):
                    s = shifted(sign * off2[:, 0], sign * off2[:, 1])
                    mx = np.maximum(mx,
                                    np.where(s == CDEF_VERY_LARGE, mx, s))
                    mn = np.minimum(mn, s)
                    diffs_s.append(s - x)
        # primary diffs ordered [k0+, k0-, k1+, k1-]; secondary
        # [k0: r2+, r2-, r6+, r6-, k1: ...]
        self.dp = diffs_p
        self.ds = diffs_s
        self.mx, self.mn = mx, mn

    def run(self, pri_strength, sec_strength, pri_damping, sec_damping,
            coeff_shift):
        pri = np.asarray(pri_strength, np.int32).reshape(-1, 1, 1)
        tap_idx = (pri.reshape(-1) >> coeff_shift) & 1
        tp = PRI_TAPS[tap_idx][:, :, None, None]      # [N, 2, 1, 1]
        sum_ = np.zeros_like(self.x)
        if np.any(pri):
            for k in range(2):
                for sgn in range(2):
                    sum_ += tp[:, k] * _constrain(self.dp[2 * k + sgn],
                                                  pri, pri_damping)
        if np.any(sec_strength):
            st = SEC_TAPS[tap_idx][:, :, None, None]
            sec = np.asarray(sec_strength, np.int32)
            for k in range(2):
                for j in range(4):
                    sum_ += st[:, k] * _constrain(
                        self.ds[4 * k + j], sec, sec_damping)
        y = self.x + ((8 + sum_ - (sum_ < 0)) >> 4)
        return np.clip(y, self.mn, self.mx)


def cdef_search(source, recon, skips, mi_rows: int, mi_cols: int,
                damping: int, bit_depth: int = 8,
                pri_set=(0, 1, 2, 4, 6, 8, 12, 15), sec_set=(0, 1, 2, 3)):
    """Pick the (y_strength, uv_strength) pair minimizing frame MSE.

    The reference searches 16x4 strength combos per filter block and DP-
    selects 2^cdef_bits presets (EbEncCdef.c svt_av1_cdef_search); here
    the 16 neighbor gathers are hoisted out and a hierarchical sweep
    (primaries at sec=0, then secondaries for the winner) evaluates each
    combo as pure elementwise math over every eligible 8x8 unit.
    Returns (y_strength, uv_strength) in coded pri*4+sec packing.
    """
    coeff_shift = max(bit_depth - 8, 0)
    by, bx = _nonskip_units(skips, mi_rows, mi_cols)
    if len(by) == 0:
        return 0, 0
    if len(by) > 64:
        # subsample the search like the reference's fast presets
        # (EbCdefProcess.c cdef_seg_search row skipping)
        keep = (by % 2) == 0
        by, bx = by[keep], bx[keep]
    fw, fh = mi_cols * 4, mi_rows * 4

    luma_win = _extract_windows(recon[0], by, bx, 8, 8, fw, fh)
    dirs, var = find_dir(
        luma_win[:, 2:10, 2:10].astype(np.uint16), coeff_shift)
    dirs0 = np.zeros_like(dirs)

    def gather_src(plane, ys, xs, bh, bw):
        rows = ys[:, None, None] + np.arange(bh)[None, :, None]
        cols = xs[:, None, None] + np.arange(bw)[None, None, :]
        return plane[np.clip(rows, 0, plane.shape[0] - 1),
                     np.clip(cols, 0, plane.shape[1] - 1)].astype(np.int64)

    def best_strength(pli_planes_src, pli_planes_rec, bh, bw, is_luma):
        src = [gather_src(s, by * bh, bx * bw, bh, bw)
               for s in pli_planes_src]
        wins = [_extract_windows(r, by, bx, bh, bw,
                                 fw >> (0 if is_luma else 1),
                                 fh >> (0 if is_luma else 1))
                for r in pli_planes_rec]
        dmp = damping + coeff_shift - (0 if is_luma else 1)
        ctx = {}          # dir-variant -> per-plane _SearchCtx list

        def err_of(pri, sec):
            if pri == 0 and sec == 0:
                return sum(int(((s - w[:, 2:2 + bh, 2:2 + bw]) ** 2).sum())
                           for s, w in zip(src, wins))
            p = pri << coeff_shift
            s_ = (sec + (sec == 3)) << coeff_shift
            key = bool(p)
            if key not in ctx:
                d = dirs if p else dirs0
                ctx[key] = [_SearchCtx(w_, d) for w_ in wins]
            e = 0
            for sp, sc in zip(src, ctx[key]):
                pri_arr = (adjust_strength(p, var) if is_luma
                           else np.full(len(by), p, np.int32))
                filt = sc.run(pri_arr, s_, dmp, dmp, coeff_shift)
                e += int(((sp - filt) ** 2).sum())
            return e

        best_pri, best_err = 0, err_of(0, 0)
        for pri in pri_set[1:]:
            e = err_of(pri, 0)
            if e < best_err:
                best_pri, best_err = pri, e
        best_sec = 0
        for sec in sec_set[1:]:          # coded values; 3 applies as 4
            e = err_of(best_pri, sec)
            if e < best_err:
                best_sec, best_err = sec, e
        return best_pri * CDEF_SEC_STRENGTHS + best_sec

    y_str = best_strength([source[0]], [recon[0]], 8, 8, True)
    uv_str = 0
    if len(recon) > 1:
        uv_str = best_strength(source[1:3], recon[1:3], 4, 4, False)
    return y_str, uv_str


# --------------------------------------------------------------------------
# Full-plane device formulation (xp = jnp on TPU, np for the reference)
#
# The unit-window form above gathers [N, h+4, w+4] tensors; on TPU,
# gathers lose to static slices, so this form works on whole padded
# planes: every neighbor tap is a static slice, per-unit directions
# become 8 masked selects, and the normative int64 direction cost runs
# in exact base-2^9 digit arithmetic (TPU has no int64).
# --------------------------------------------------------------------------

def _msb_int(x, nbits: int, xp):
    """floor(log2(x)) for x >= 1 (0 for x < 1), exact via comparisons."""
    m = xp.zeros(xp.asarray(x).shape, xp.int32)
    for k in range(1, nbits):
        m = m + (x >= (1 << k)).astype(xp.int32)
    return m


def _constrain_xp(diff, strength, damping, xp):
    """Exact constrain() for array strengths without float log2."""
    s = xp.asarray(strength).astype(xp.int32)
    adiff = xp.abs(diff)
    shift = xp.maximum(0, damping - _msb_int(s, 8, xp))
    mag = xp.minimum(adiff, xp.maximum(0, s - (adiff >> shift)))
    return (xp.where(s > 0, xp.sign(diff) * mag, 0)).astype(xp.int32)


def _ceil_to(v: int, m: int) -> int:
    return -(-v // m) * m


def find_dir_grid(luma_units, coeff_shift: int, xp=np):
    """Normative direction search over [uh, uw, 8, 8] unit blocks.

    Bit-exact equivalent of find_dir (svt_cdef_find_dir_c) without
    int64: partial sums p (|p| < 2^18) are squared via the 9-bit split
    p = p1*2^9 + p0, costs accumulate as base-2^9 digits, and the
    argmax/variance run on carry-normalized digits.
    Returns (dirs [uh, uw] int32, var [uh, uw] int32).
    """
    M, W = _dir_matrices()
    Mf = M.astype(np.float32)                    # [8, 15, 64] one-hot sums
    Wi = W.astype(np.int32)                      # [8, 15] weights (<= 840)
    uh, uw = luma_units.shape[:2]
    x = (luma_units.reshape(uh, uw, 64).astype(xp.int32) >> coeff_shift) \
        - 128
    # partial[d, b] per unit: |x| <= 16256, 8 samples -> |p| < 2^18.
    # The one-hot contraction runs as a matmul (exact in f32: values
    # far below 2^24).
    xf = x.astype(xp.float32)
    Mt = xp.asarray(Mf.reshape(8 * 15, 64).T)    # [64, 120]
    p = (xf @ Mt).astype(xp.int32).reshape(uh, uw, 8, 15)
    p1 = p >> 9
    p0 = p - (p1 << 9)                           # [0, 512)
    w = xp.asarray(Wi)[None, None]               # [1, 1, 8, 15]
    hi = (w * (p1 * p1)).sum(-1)                 # cost = hi*2^18 +
    mid = (w * (2 * p1 * p0)).sum(-1)            #        mid*2^9 + lo
    lo = (w * (p0 * p0)).sum(-1)
    # carry-normalize to digits (H, M9, L9) with M9, L9 in [0, 512)
    m2 = mid + (lo >> 9)
    l9 = lo & 511
    h2 = hi + (m2 >> 9)
    m9 = m2 & 511
    # lexicographic argmax over the 8 directions (first max wins, like
    # np.argmax over the int64 cost)
    NEG = xp.int32(-1)
    mh = h2.max(-1, keepdims=True)
    s2 = h2 == mh
    mm = xp.where(s2, m9, NEG).max(-1, keepdims=True)
    s1 = s2 & (m9 == mm)
    ml = xp.where(s1, l9, NEG).max(-1, keepdims=True)
    s0 = s1 & (l9 == ml)
    best = xp.argmax(s0.astype(xp.int32), axis=-1).astype(xp.int32)
    # var = (cost[best] - cost[(best+4)&7]) >> 10, exact in digits

    def pick(arr, idx):
        sel = (xp.asarray(np.arange(8))[None, None] == idx[..., None])
        return xp.where(sel, arr, 0).sum(-1)

    alt = (best + 4) & 7
    A = pick(h2, best) - pick(h2, alt)
    B = pick(m9, best) - pick(m9, alt)
    C = pick(l9, best) - pick(l9, alt)
    e = B + (C >> 9)
    c0 = C & 511
    f = A + (e >> 9)
    e0 = e & 511
    var = (f << 8) + (((e0 << 9) + c0) >> 10)
    return best, var.astype(xp.int32)


def _units_of(plane_padded, fw: int, fh: int, bs: int, xp):
    """[uh, uw, bs, bs] unit blocks of the VERY_LARGE-padded plane."""
    uh, uw = _ceil_to(fh, 8) // 8, _ceil_to(fw, 8) // 8
    if bs == 4:
        uhp, uwp = uh * 4, uw * 4
    else:
        uhp, uwp = uh * 8, uw * 8
    inner = plane_padded[2:2 + uhp, 2:2 + uwp]
    return inner.reshape(uh, bs, uw, bs).swapaxes(1, 2)


def pad_very_large(plane, fw: int, fh: int, bs: int, xp=np):
    """[H+4, W+4] plane with CDEF_VERY_LARGE outside the visible frame,
    H/W ceil-rounded so bs-sized units tile it exactly (the unit grid
    is the luma 8x8 grid; chroma units are 4x4 at the same indices)."""
    H = _ceil_to(fh, bs)
    Wd = _ceil_to(fw, bs)
    out = xp.full((H + 4, Wd + 4), CDEF_VERY_LARGE, xp.int32)
    src = plane[:fh, :fw].astype(xp.int32)
    if xp is np:
        out[2:2 + fh, 2:2 + fw] = src
    else:
        out = out.at[2:2 + fh, 2:2 + fw].set(src)
    return out


class _PlaneCtx:
    """Neighbor diffs / clamp bounds for one padded plane under a
    per-unit direction map: every tap is a static slice + 8-way masked
    select (no gathers).  Mirrors _SearchCtx on whole planes."""

    def __init__(self, padded, dirs, bs: int, xp):
        H, Wd = padded.shape[0] - 4, padded.shape[1] - 4
        self.xp = xp
        x = padded[2:2 + H, 2:2 + Wd]
        self.x = x
        dmap = xp.repeat(xp.repeat(dirs, bs, axis=0), bs, axis=1)
        masks = [(dmap == d) for d in range(8)]

        def tap(off_table, rot, k, sign):
            p = xp.zeros(x.shape, xp.int32)
            for d in range(8):
                dy, dx = (int(v) for v in off_table[(d + rot) & 7, k])
                dy, dx = sign * dy, sign * dx
                sl = padded[2 + dy:2 + dy + H, 2 + dx:2 + dx + Wd]
                p = xp.where(masks[d], sl, p)
            return p

        self.dp, self.ds = [], []
        mx, mn = x, x
        for k in range(2):
            for sign in (1, -1):
                p = tap(DIRECTIONS, 0, k, sign)
                mx = xp.maximum(mx, xp.where(p == CDEF_VERY_LARGE, mx, p))
                mn = xp.minimum(mn, p)
                self.dp.append(p - x)
            for rot in (2, 6):
                for sign in (1, -1):
                    s = tap(DIRECTIONS, rot, k, sign)
                    mx = xp.maximum(mx,
                                    xp.where(s == CDEF_VERY_LARGE, mx, s))
                    mn = xp.minimum(mn, s)
                    self.ds.append(s - x)
        self.mx, self.mn = mx, mn

    def run(self, pri_map, sec_strength: int, damping: int,
            coeff_shift: int):
        """Filter with per-pixel primary strengths; returns the filtered
        plane (call sites mask by eligibility)."""
        xp = self.xp
        tap_idx = (pri_map >> coeff_shift) & 1
        pt0 = xp.where(tap_idx == 1, 3, 4)
        pt1 = xp.where(tap_idx == 1, 3, 2)
        st0, st1 = 2, 1
        sum_ = xp.zeros(self.x.shape, xp.int32)
        for k, ptap in ((0, pt0), (1, pt1)):
            for sgn in range(2):
                sum_ = sum_ + ptap * _constrain_xp(
                    self.dp[2 * k + sgn], pri_map, damping, xp)
        # sec_strength may be a traced scalar; strength 0 contributes 0
        # (constrain masks s <= 0), so unconditional evaluation is exact
        if not isinstance(sec_strength, int) or sec_strength:
            for k, stap in ((0, st0), (1, st1)):
                for j in range(4):
                    sum_ = sum_ + stap * _constrain_xp(
                        self.ds[4 * k + j], sec_strength, damping, xp)
        y = self.x + ((8 + sum_ - (sum_ < 0)) >> 4)
        return xp.clip(y, self.mn, self.mx)


def _adjust_strength_xp(strength: int, var, xp):
    v6 = var >> 6
    msb = xp.minimum(_msb_int(v6, 26, xp), 12)
    out = (strength * (4 + msb) + 8) >> 4
    return xp.where(var > 0, out, 0).astype(xp.int32)


def cdef_plane_full(planes, dirs, var, nonskip, fw: int, fh: int,
                    y_strength: int, uv_strength: int, damping: int,
                    bit_depth: int = 8, xp=np):
    """Full-plane CDEF apply given precomputed (dirs, var) unit maps.
    Semantics match cdef_frame (spec 7.15); returns new plane list."""
    cs = max(bit_depth - 8, 0)
    y_pri = (y_strength // CDEF_SEC_STRENGTHS) << cs
    y_sec = y_strength % CDEF_SEC_STRENGTHS
    y_sec = (y_sec + (y_sec == 3)) << cs
    uv_pri = (uv_strength // CDEF_SEC_STRENGTHS) << cs
    uv_sec = uv_strength % CDEF_SEC_STRENGTHS
    uv_sec = (uv_sec + (uv_sec == 3)) << cs

    out = []
    for pli, plane in enumerate(planes):
        bs = 8 if pli == 0 else 4
        sub = 0 if pli == 0 else 1
        pw, ph = fw >> sub, fh >> sub
        pri, sec = (y_pri, y_sec) if pli == 0 else (uv_pri, uv_sec)
        if not (pri or sec):
            out.append(plane)
            continue
        padded = pad_very_large(plane, pw, ph, bs, xp)
        d = dirs if pri > 0 else xp.zeros_like(xp.asarray(dirs))
        ctx = _PlaneCtx(padded, d, bs, xp)
        if pli == 0:
            pri_map = xp.repeat(xp.repeat(
                _adjust_strength_xp(pri, var, xp), bs, 0), bs, 1)
        else:
            pri_map = xp.full(ctx.x.shape, pri, xp.int32)
        filt = ctx.run(pri_map, sec, damping + cs - (0 if pli == 0 else 1),
                       cs)
        keep = xp.repeat(xp.repeat(nonskip, bs, 0), bs, 1)
        merged = xp.where(keep, filt, ctx.x)[:ph, :pw]
        if xp is np:
            o = plane.copy()
            o[:ph, :pw] = merged
        else:
            o = plane.at[:ph, :pw].set(merged) if hasattr(plane, "at") \
                else merged
        out.append(o)
    return out


def cdef_search_errs(source, recon, dirs, var, nonskip, fw: int, fh: int,
                     damping: int, bit_depth: int = 8,
                     pri_set=(0, 1, 2, 4, 6, 8, 12, 15),
                     sec_set=(0, 1, 2, 3), xp=np, padded_planes=None):
    """SSE of every (pri, sec) strength combo, full-plane batched.

    Returns (err_y, err_uv): [len(pri_set), len(sec_set)] arrays of
    in-frame SSE over non-skip units (float32; exact for < 2^24-scale
    sums is not required — errors only rank strengths).

    ``padded_planes``: optional pre-padded planes per pli (spatial
    sharding injects true neighbor-stripe rows where pad_very_large
    would write CDEF_VERY_LARGE)."""
    cs = max(bit_depth - 8, 0)
    errs = []
    for group in ((0,), (1, 2)):
        acc = None
        for pli in group:
            if pli >= len(recon):
                continue
            bs = 8 if pli == 0 else 4
            sub = 0 if pli == 0 else 1
            pw, ph = fw >> sub, fh >> sub
            padded = padded_planes[pli] if padded_planes is not None \
                else pad_very_large(recon[pli], pw, ph, bs, xp)
            keep = xp.repeat(xp.repeat(nonskip, bs, 0), bs, 1)
            # in-frame & nonskip weighting
            H, Wd = padded.shape[0] - 4, padded.shape[1] - 4
            inframe = np.zeros((H, Wd), bool)
            inframe[:ph, :pw] = True
            wmask = (keep & xp.asarray(inframe)).astype(xp.float32)
            src = xp.zeros((H, Wd), xp.int32)
            s = source[pli][:ph, :pw].astype(xp.int32)
            if xp is np:
                src[:ph, :pw] = s
            else:
                src = src.at[:ph, :pw].set(s)
            ctx = {True: _PlaneCtx(padded, dirs, bs, xp),
                   False: _PlaneCtx(padded, xp.zeros_like(xp.asarray(dirs)),
                                    bs, xp)}
            dmp = damping + cs - (0 if pli == 0 else 1)
            e = []
            for pri in pri_set:
                row = []
                p = pri << cs
                if pli == 0:
                    pri_map = xp.repeat(xp.repeat(
                        _adjust_strength_xp(p, var, xp), bs, 0), bs, 1)
                else:
                    pri_map = xp.full((H, Wd), p, xp.int32)
                c = ctx[bool(p)]
                for sec in sec_set:
                    s_ = (sec + (sec == 3)) << cs
                    if p == 0 and s_ == 0:
                        filt = c.x
                    else:
                        filt = c.run(pri_map, s_, dmp, cs)
                    d = (filt - src).astype(xp.float32)
                    row.append((d * d * wmask).sum())
                e.append(xp.stack(row))
            plane_err = xp.stack(e)
            acc = plane_err if acc is None else acc + plane_err
        errs.append(acc)
    return errs[0], errs[1]


# --------------------------------------------------------------------------
# Jitted encoder entries (search + apply as two device calls per frame)
# --------------------------------------------------------------------------

def nonskip_grid(skips, mi_rows: int, mi_cols: int) -> np.ndarray:
    """[uh, uw] bool map of 8x8-luma units with any non-skip 4x4."""
    r1 = (mi_rows + 1) // 2
    c1 = (mi_cols + 1) // 2
    s = np.ones((r1 * 2, c1 * 2), bool)
    s[:mi_rows, :mi_cols] = skips[:mi_rows, :mi_cols] != 0
    unit_skip = s.reshape(r1, 2, c1, 2).all(axis=(1, 3))
    uh, uw = -(-mi_rows * 4 // 8), -(-mi_cols * 4 // 8)
    return ~unit_skip[:uh, :uw]


def _cdef_apply_traced(planes, nonskip, y_strength, uv_strength,
                       damping: int, fw: int, fh: int, bd: int, xp,
                       padded_planes=None):
    """cdef_plane_full with traced strength scalars (always filters;
    zero strengths reduce to the identity).  ``padded_planes``: see
    cdef_search_errs."""
    cs = max(bd - 8, 0)
    pris = [(y_strength // CDEF_SEC_STRENGTHS) << cs]
    secs_ = y_strength % CDEF_SEC_STRENGTHS
    secs = [(secs_ + (secs_ == 3)) << cs]
    up = (uv_strength // CDEF_SEC_STRENGTHS) << cs
    us_ = uv_strength % CDEF_SEC_STRENGTHS
    us = (us_ + (us_ == 3)) << cs

    padded_y = padded_planes[0] if padded_planes is not None \
        else pad_very_large(planes[0], fw, fh, 8, xp)
    dirs, var = find_dir_grid(_units_of(padded_y, fw, fh, 8, xp), cs, xp)
    out = []
    for pli, plane in enumerate(planes):
        bs = 8 if pli == 0 else 4
        sub = 0 if pli == 0 else 1
        pw, ph = fw >> sub, fh >> sub
        pri = pris[0] if pli == 0 else up
        sec = secs[0] if pli == 0 else us
        padded = padded_y if pli == 0 \
            else (padded_planes[pli] if padded_planes is not None
                  else pad_very_large(plane, pw, ph, bs, xp))
        d = xp.where(pri > 0, dirs, 0)
        ctx = _PlaneCtx(padded, d, bs, xp)
        if pli == 0:
            pri_map = xp.repeat(xp.repeat(
                _adjust_strength_xp(pri, var, xp), bs, 0), bs, 1)
        else:
            pri_map = xp.full(ctx.x.shape, 0, xp.int32) + pri
        filt = ctx.run(pri_map, sec, damping + cs - (0 if pli == 0 else 1),
                       cs)
        active = (pri > 0) | (sec > 0)
        keep = xp.repeat(xp.repeat(nonskip, bs, 0), bs, 1) & active
        out.append(xp.where(keep, filt, ctx.x)[:ph, :pw])
    return out


def _np_dtype(bd):
    return np.uint8 if bd == 8 else np.uint16














# --------------------------------------------------------------------------
# Multi-strength presets (cdef_bits > 0): per-64x64 filter-block indices
# (finish_cdef_search / joint_strength_search_dual, EbEncCdef.c:1140)
# --------------------------------------------------------------------------

CDEF_STRENGTH_BITS = 6


def cdef_frame_multi(planes, skips, mi_rows: int, mi_cols: int,
                     y_list, uv_list, idx_grid, damping: int,
                     bit_depth: int = 8):
    """Normative CDEF apply with per-64x64-fb strength indices
    (spec 7.15.1: cdef_idx selects into the coded strength lists).

    idx_grid: [nvfb, nhfb] int (ceil(frame/64) grid); entries of
    all-skip fbs are never used.  Returns new plane list."""
    coeff_shift = max(bit_depth - 8, 0)
    by, bx = _nonskip_units(skips, mi_rows, mi_cols)
    if len(by) == 0:
        return [p.copy() for p in planes]
    fw, fh = mi_cols * 4, mi_rows * 4
    y_arr = np.asarray(y_list, np.int32)
    uv_arr = np.asarray(uv_list, np.int32)
    gi = np.asarray(idx_grid, np.int32)[by // 8, bx // 8]     # [N]

    y_str = y_arr[gi]
    uv_str = uv_arr[gi]
    y_pri = (y_str // CDEF_SEC_STRENGTHS) << coeff_shift
    y_sec = y_str % CDEF_SEC_STRENGTHS
    y_sec = (y_sec + (y_sec == 3)) << coeff_shift
    uv_pri = (uv_str // CDEF_SEC_STRENGTHS) << coeff_shift
    uv_sec = uv_str % CDEF_SEC_STRENGTHS
    uv_sec = (uv_sec + (uv_sec == 3)) << coeff_shift

    luma_win = _extract_windows(planes[0], by, bx, 8, 8, fw, fh)
    dirs, var = find_dir(
        luma_win[:, 2:10, 2:10].astype(np.uint16), coeff_shift)

    out = [p.copy() for p in planes]
    if np.any(y_pri) or np.any(y_sec):
        pri_adj = adjust_strength(y_pri, var)
        ctx = _SearchCtx(luma_win, np.where(y_pri > 0, dirs, 0))
        filt = ctx.run(pri_adj, y_sec.reshape(-1, 1, 1),
                       damping + coeff_shift, damping + coeff_shift,
                       coeff_shift)
        _scatter(out[0], filt, by * 8, bx * 8)
    if len(planes) > 1 and (np.any(uv_pri) or np.any(uv_sec)):
        cw, ch = fw >> 1, fh >> 1
        d = damping + coeff_shift - 1
        cdirs = np.where(uv_pri > 0, dirs, 0)
        for pli in (1, 2):
            wins = _extract_windows(planes[pli], by, bx, 4, 4, cw, ch)
            ctx = _SearchCtx(wins, cdirs)
            filt = ctx.run(uv_pri, uv_sec.reshape(-1, 1, 1), d, d,
                           coeff_shift)
            _scatter(out[pli], filt, by * 4, bx * 4)
    return out


def _fb_sums(sq, fbpx: int, nvfb: int, nhfb: int, xp):
    """[H, W] weighted squared errors -> [nvfb, nhfb] per-fb sums."""
    H, W = sq.shape
    ph, pw = nvfb * fbpx, nhfb * fbpx
    if H < ph or W < pw:
        sq = xp.pad(sq, ((0, ph - H), (0, pw - W)))
    else:
        sq = sq[:ph, :pw]
    return sq.reshape(nvfb, fbpx, nhfb, fbpx).sum((1, 3))


def cdef_search_errs_fb(source, recon, dirs, var, nonskip, fw: int,
                        fh: int, damping: int, bit_depth: int = 8,
                        pri_set=(0, 1, 2, 4, 6, 8, 12, 15),
                        sec_set=(0, 1, 2, 3), xp=np):
    """Per-64x64-fb SSE of every (pri, sec) combo, full-plane batched.

    Returns (mse_y, mse_uv): [npri*nsec, nvfb, nhfb] float32 (the
    per-fb form of cdef_search_errs; mse_seg analog, EbCdefProcess.c)."""
    cs = max(bit_depth - 8, 0)
    nvfb = (fh + 63) // 64
    nhfb = (fw + 63) // 64
    outs = []
    for group in ((0,), (1, 2)):
        acc = None
        for pli in group:
            if pli >= len(recon):
                continue
            bs = 8 if pli == 0 else 4
            sub = 0 if pli == 0 else 1
            fbpx = 64 >> sub
            pw, ph = fw >> sub, fh >> sub
            padded = pad_very_large(recon[pli], pw, ph, bs, xp)
            keep = xp.repeat(xp.repeat(nonskip, bs, 0), bs, 1)
            H, Wd = padded.shape[0] - 4, padded.shape[1] - 4
            inframe = np.zeros((H, Wd), bool)
            inframe[:ph, :pw] = True
            wmask = (keep & xp.asarray(inframe)).astype(xp.float32)
            src = xp.zeros((H, Wd), xp.int32)
            s = source[pli][:ph, :pw].astype(xp.int32)
            if xp is np:
                src[:ph, :pw] = s
            else:
                src = src.at[:ph, :pw].set(s)
            ctx = {True: _PlaneCtx(padded, dirs, bs, xp),
                   False: _PlaneCtx(padded, xp.zeros_like(xp.asarray(dirs)),
                                    bs, xp)}
            dmp = damping + cs - (0 if pli == 0 else 1)
            rows = []
            for pri in pri_set:
                p = pri << cs
                if pli == 0:
                    pri_map = xp.repeat(xp.repeat(
                        _adjust_strength_xp(p, var, xp), bs, 0), bs, 1)
                else:
                    pri_map = xp.full((H, Wd), p, xp.int32)
                c = ctx[bool(p)]
                for sec in sec_set:
                    s_ = (sec + (sec == 3)) << cs
                    if p == 0 and s_ == 0:
                        filt = c.x
                    else:
                        filt = c.run(pri_map, s_, dmp, cs)
                    d = (filt - src).astype(xp.float32)
                    rows.append(_fb_sums(d * d * wmask, fbpx, nvfb,
                                         nhfb, xp))
            plane_err = xp.stack(rows)
            acc = plane_err if acc is None else acc + plane_err
        outs.append(acc)
    return outs[0], outs[1]


def _search_one_dual(lev_y, lev_uv, i, my, muv):
    """Add strength pair i minimizing the total min-over-set mse
    (svt_search_one_dual_c, EbEncCdef.c:1070).  my/muv: [n_fb, NC]."""
    n_fb, nc = my.shape
    if i > 0:
        cur = np.min(my[:, lev_y[:i]] + muv[:, lev_uv[:i]], axis=1)
    else:
        cur = np.full(n_fb, np.inf, my.dtype)
    cand = my[:, :, None] + muv[:, None, :]              # [n_fb, NC, NC]
    tot = np.minimum(cur[:, None, None], cand).sum(0)    # [NC, NC]
    j = int(np.argmin(tot))
    lev_y[i], lev_uv[i] = j // nc, j % nc
    return float(tot.ravel()[j])


def joint_strength_search_dual(my, muv, nb_strengths: int):
    """Greedy + refinement set search (joint_strength_search_dual,
    EbEncCdef.c:1140).  Returns (lev_y, lev_uv, total_mse)."""
    lev_y = np.zeros(nb_strengths, np.int64)
    lev_uv = np.zeros(nb_strengths, np.int64)
    best = np.inf
    for i in range(nb_strengths):
        best = _search_one_dual(lev_y, lev_uv, i, my, muv)
    for _ in range(4 * nb_strengths):
        lev_y[:-1] = lev_y[1:]
        lev_uv[:-1] = lev_uv[1:]
        best = _search_one_dual(lev_y, lev_uv, nb_strengths - 1, my, muv)
    return lev_y, lev_uv, best


def pick_cdef_presets(mse_y, mse_uv, eligible, lambda_sse: int,
                      pri_set=(0, 1, 2, 4, 6, 8, 12, 15),
                      sec_set=(0, 1, 2, 3)):
    """finish_cdef_search port: choose cdef_bits (0..3), the strength
    lists and the per-fb indices minimizing mse + lambda * signalling.

    mse_y/mse_uv: [NC, nvfb, nhfb]; eligible: [nvfb, nhfb] bool (fbs
    with any non-skip unit).  Returns (cdef_bits, y_list, uv_list,
    idx_grid [nvfb, nhfb])."""
    combos = [(p, s) for p in pri_set for s in sec_set]
    nc = len(combos)
    el = np.asarray(eligible, bool)
    my = np.asarray(mse_y, np.float64).reshape(nc, -1).T[el.ravel()]
    muv = np.asarray(mse_uv, np.float64).reshape(nc, -1).T[el.ravel()]
    n_fb = my.shape[0]
    if n_fb == 0:
        return 0, (0,), (0,), np.zeros(el.shape, np.int32)

    best_cost = np.inf
    best = None
    for bits in range(4):
        nb = 1 << bits
        lev_y, lev_uv, tot = joint_strength_search_dual(my, muv, nb)
        total_bits = n_fb * bits + nb * CDEF_STRENGTH_BITS * 2
        rate = 512 * total_bits
        dist = int(tot) * 16
        cost = ((rate * lambda_sse + 256) >> 9) + (dist << 7)
        if cost < best_cost:
            best_cost = cost
            best = (bits, lev_y.copy(), lev_uv.copy())
    bits, lev_y, lev_uv = best
    y_list = tuple(combos[int(k)][0] * CDEF_SEC_STRENGTHS
                   + combos[int(k)][1] for k in lev_y)
    uv_list = tuple(combos[int(k)][0] * CDEF_SEC_STRENGTHS
                    + combos[int(k)][1] for k in lev_uv)
    sel = my[:, lev_y] + muv[:, lev_uv]                # [n_fb, nb]
    gi = np.argmin(sel, axis=1).astype(np.int32)
    idx_grid = np.zeros(el.shape, np.int32)
    idx_grid[el] = gi
    return bits, y_list, uv_list, idx_grid
