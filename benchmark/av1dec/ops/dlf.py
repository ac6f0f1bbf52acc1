"""AV1 deblocking loop filter (normative, 8-bit path).

Vectorized edge-parallel formulation: each edge line (a column of
vertical-edge sample groups or a row of horizontal-edge groups) is
filtered as one array op; the frame is two passes (all vertical edges
left-to-right, then all horizontal edges top-to-bottom), which is
order-equivalent to the reference's per-superblock interleave because
vertical filters never read horizontal-filter output and modification
spans of successive edges do not overlap.

Behavioral parity: masks/filters EbDeblockingCommon.c (filter_mask*:148,
filter4:222, filter6:283, filter8:298, filter14:810, thresholds
update_sharpness:587), edge walk EbDecLF.c.
"""
from __future__ import annotations

import numpy as np

MAX_LOOP_FILTER = 63


def filter_levels_from_qindex(qindex: int, bit_depth: int = 8) -> int:
    """Encoder-side level choice (libaom LPF_PICK_FROM_Q keyframe fit)."""
    from ..entropy.tables import ac_q

    q = ac_q(qindex, bit_depth)
    filt = (q * 20723 + 1015158 + (1 << 17)) >> 18
    return int(np.clip(filt, 0, MAX_LOOP_FILTER))


def _thresholds(level: int, sharpness: int):
    inside = level >> ((sharpness > 0) + (sharpness > 4))
    if sharpness > 0:
        inside = min(inside, 9 - sharpness)
    inside = max(inside, 1)
    blimit = 2 * (level + 2) + inside
    hev = level >> 4
    return np.int32(blimit), np.int32(inside), np.int32(hev)


def _sc(x, shift=0, xp=np):
    """signed_char_clamp (bd-scaled) on int32 arrays."""
    return xp.clip(x, -128 << shift, (128 << shift) - 1)


def _setl(arr, idx, val, xp=np):
    """arr[..., idx] = val, functional under jax."""
    if xp is np:
        arr[..., idx] = val
        return arr
    return arr.at[..., idx].set(val)


def _filter_line(p, q, blimit, limit, thresh, size, shift=0, xp=np):
    """Filter one edge line.

    p: [..., np] samples left/above of the edge, p[..., 0] farthest
       (p[..., -1] is p0);  q: [..., nq], q[..., 0] is q0.
    Returns filtered (p, q) copies.  ``size`` in {4, 6, 8, 14}.
    """
    p = p.astype(xp.int32)
    q = q.astype(xp.int32)
    P = p.shape[-1]
    p0, p1 = p[..., P - 1], p[..., P - 2]
    q0, q1 = q[..., 0], q[..., 1]

    if size == 4:
        mask = ((xp.abs(p1 - p0) <= limit) & (xp.abs(q1 - q0) <= limit)
                & (xp.abs(p0 - q0) * 2 + xp.abs(p1 - q1) // 2 <= blimit))
        return _filter4(p, q, mask, thresh, shift, xp)

    p2, q2 = p[..., P - 3], q[..., 2]
    if size == 6:
        mask = ((xp.abs(p2 - p1) <= limit) & (xp.abs(p1 - p0) <= limit)
                & (xp.abs(q1 - q0) <= limit) & (xp.abs(q2 - q1) <= limit)
                & (xp.abs(p0 - q0) * 2 + xp.abs(p1 - q1) // 2 <= blimit))
        fth = 1 << shift
        flat = ((xp.abs(p1 - p0) <= fth) & (xp.abs(q1 - q0) <= fth)
                & (xp.abs(p2 - p0) <= fth) & (xp.abs(q2 - q0) <= fth))
        fp, fq = _filter4(p, q, mask & ~flat, thresh, shift, xp)
        # 5-tap [1,2,2,2,1]
        sel = mask & flat
        op1 = (p2 * 3 + p1 * 2 + p0 * 2 + q0 + 4) >> 3
        op0 = (p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + 4) >> 3
        oq0 = (p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + 4) >> 3
        oq1 = (p0 + q0 * 2 + q1 * 2 + q2 * 3 + 4) >> 3
        fp = _setl(fp, P - 2, xp.where(sel, op1, fp[..., P - 2]), xp)
        fp = _setl(fp, P - 1, xp.where(sel, op0, fp[..., P - 1]), xp)
        fq = _setl(fq, 0, xp.where(sel, oq0, fq[..., 0]), xp)
        fq = _setl(fq, 1, xp.where(sel, oq1, fq[..., 1]), xp)
        return fp, fq

    p3, q3 = p[..., P - 4], q[..., 3]
    mask = ((xp.abs(p3 - p2) <= limit) & (xp.abs(p2 - p1) <= limit)
            & (xp.abs(p1 - p0) <= limit) & (xp.abs(q1 - q0) <= limit)
            & (xp.abs(q2 - q1) <= limit) & (xp.abs(q3 - q2) <= limit)
            & (xp.abs(p0 - q0) * 2 + xp.abs(p1 - q1) // 2 <= blimit))
    fth = 1 << shift
    flat = ((xp.abs(p1 - p0) <= fth) & (xp.abs(q1 - q0) <= fth)
            & (xp.abs(p2 - p0) <= fth) & (xp.abs(q2 - q0) <= fth)
            & (xp.abs(p3 - p0) <= fth) & (xp.abs(q3 - q0) <= fth))

    fp, fq = _filter4(p, q, mask & ~flat, thresh, shift, xp)

    # 7-tap [1,1,1,2,1,1,1]
    sel8 = mask & flat
    op2 = (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3
    op1 = (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3
    op0 = (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3
    oq0 = (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3
    oq1 = (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3
    oq2 = (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3

    if size == 8:
        for idx, v in ((P - 3, op2), (P - 2, op1), (P - 1, op0)):
            fp = _setl(fp, idx, xp.where(sel8, v, fp[..., idx]), xp)
        for idx, v in ((0, oq0), (1, oq1), (2, oq2)):
            fq = _setl(fq, idx, xp.where(sel8, v, fq[..., idx]), xp)
        return fp, fq

    # size 14: flat2 over p6..q6
    p4, p5, p6 = p[..., P - 5], p[..., P - 6], p[..., P - 7]
    q4, q5, q6 = q[..., 4], q[..., 5], q[..., 6]
    flat2 = ((xp.abs(p6 - p0) <= fth) & (xp.abs(p5 - p0) <= fth)
             & (xp.abs(p4 - p0) <= fth) & (xp.abs(q4 - q0) <= fth)
             & (xp.abs(q5 - q0) <= fth) & (xp.abs(q6 - q0) <= fth))
    sel8_only = sel8 & ~flat2
    for idx, v in ((P - 3, op2), (P - 2, op1), (P - 1, op0)):
        fp = _setl(fp, idx, xp.where(sel8_only, v, fp[..., idx]), xp)
    for idx, v in ((0, oq0), (1, oq1), (2, oq2)):
        fq = _setl(fq, idx, xp.where(sel8_only, v, fq[..., idx]), xp)

    sel14 = sel8 & flat2
    vals_p = [
        (P - 6, (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0 + 8) >> 4),
        (P - 5, (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1 + 8) >> 4),
        (P - 4, (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 + q2 + 8) >> 4),
        (P - 3, (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 + q2 + q3 + 8) >> 4),
        (P - 2, (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 + q2 + q3 + q4 + 8) >> 4),
        (P - 1, (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 + q3 + q4 + q5 + 8) >> 4),
    ]
    vals_q = [
        (0, (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 + q4 + q5 + q6 + 8) >> 4),
        (1, (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 + q5 + q6 * 2 + 8) >> 4),
        (2, (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 + q6 * 3 + 8) >> 4),
        (3, (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 + q6 * 4 + 8) >> 4),
        (4, (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5 + 8) >> 4),
        (5, (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7 + 8) >> 4),
    ]
    for idx, v in vals_p:
        fp = _setl(fp, idx, xp.where(sel14, v, fp[..., idx]), xp)
    for idx, v in vals_q:
        fq = _setl(fq, idx, xp.where(sel14, v, fq[..., idx]), xp)
    return fp, fq


def _filter4(p, q, mask, thresh, shift=0, xp=np):
    """4-tap filter applied where mask; returns modified copies."""
    P = p.shape[-1]
    t80 = 128 << shift
    p0, p1 = p[..., P - 1], p[..., P - 2]
    q0, q1 = q[..., 0], q[..., 1]
    hev = (xp.abs(p1 - p0) > thresh) | (xp.abs(q1 - q0) > thresh)
    ps1, ps0 = p1 - t80, p0 - t80
    qs0, qs1 = q0 - t80, q1 - t80
    f = xp.where(hev, _sc(ps1 - qs1, shift, xp), 0)
    f = xp.where(mask, _sc(f + 3 * (qs0 - ps0), shift, xp), 0)
    f1 = _sc(f + 4, shift, xp) >> 3
    f2 = _sc(f + 3, shift, xp) >> 3
    oq0 = _sc(qs0 - f1, shift, xp) + t80
    op0 = _sc(ps0 + f2, shift, xp) + t80
    fo = xp.where(~hev, (f1 + 1) >> 1, 0)
    oq1 = _sc(qs1 - fo, shift, xp) + t80
    op1 = _sc(ps1 + fo, shift, xp) + t80
    fp = p.copy() if xp is np else p
    fq = q.copy() if xp is np else q
    fp = _setl(fp, P - 1, xp.where(mask, op0, p0), xp)
    fp = _setl(fp, P - 2, xp.where(mask, op1, p1), xp)
    fq = _setl(fq, 0, xp.where(mask, oq0, q0), xp)
    fq = _setl(fq, 1, xp.where(mask, oq1, q1), xp)
    return fp, fq


def loop_filter_plane(plane: np.ndarray, tx_w: np.ndarray, tx_h: np.ndarray,
                      skip: np.ndarray, block_edge_x: np.ndarray,
                      block_edge_y: np.ndarray, width: int, height: int,
                      level_v: int, level_h: int, sharpness: int,
                      is_chroma: bool, bd: int = 8) -> np.ndarray:
    """Filter one plane in place (returns the same array).

    tx_w/tx_h/skip/block_edge_*: per-4x4-unit grids in PLANE coordinates
    ([h4, w4]); block_edge_x[y4, x4] true when a prediction-block
    boundary lies at the left edge of that unit (block_edge_y: top edge).
    width/height: the VISIBLE plane size; a 4px unit is filtered only
    when its start coordinate lies inside it (dec_loop_filter_block's
    width <= x || height <= y early-out, EbDecLF.c:115).
    """
    x4max = (width + 3) >> 2
    y4max = (height + 3) >> 2
    shift = bd - 8
    if level_v > 0:
        bl, lim, hev = _thresholds(level_v, sharpness)
        bl, lim, hev = bl << shift, lim << shift, hev << shift
        for x4 in range(1, x4max):
            x = x4 << 2
            left_w = tx_w[:, x4 - 1]
            curr_w = tx_w[:, x4]
            is_tx_edge = (x % np.maximum(curr_w, 1)) == 0
            # unit is a tx-origin column only where x aligns to the
            # current block's tx grid; tx_w grid stores each unit's tx
            # width so alignment is implicit (uniform within a block)
            apply = is_tx_edge & (block_edge_x[:, x4]
                                  | ~(skip[:, x4 - 1] & skip[:, x4]))
            apply = apply[:y4max]
            if not apply.any():
                continue
            fsize = np.minimum(np.minimum(left_w, curr_w)[:y4max], 16)
            fsize = np.where(fsize >= 16, 14 if not is_chroma else 6,
                             np.where(fsize >= 8, 8 if not is_chroma else 6, 4))
            if is_chroma:
                fsize = np.minimum(fsize, 6)
            span = 7
            xl = max(x - span, 0)
            xr = min(x + span, plane.shape[1])
            rows = plane[:y4max * 4, xl:xr]
            for size in (4, 6, 8, 14):
                sel4 = apply & (fsize == size)
                if not sel4.any():
                    continue
                rmask = np.repeat(sel4, 4)
                npx = min(size // 2 if size != 6 else 3, x - xl)
                nqx = min(size // 2 if size != 6 else 3, xr - x)
                if size == 14:
                    npx, nqx = min(7, x - xl), min(7, xr - x)
                elif size == 8:
                    npx, nqx = min(4, x - xl), min(4, xr - x)
                elif size == 6:
                    npx, nqx = min(3, x - xl), min(3, xr - x)
                else:
                    npx, nqx = min(2, x - xl), min(2, xr - x)
                p = plane[:y4max * 4, x - npx:x]
                q = plane[:y4max * 4, x:x + nqx]
                fp, fq = _filter_line(p, q, bl, lim, hev, size, shift)
                sel_rows = rmask
                plane[:y4max * 4, x - npx:x][sel_rows] = fp[sel_rows]
                plane[:y4max * 4, x:x + nqx][sel_rows] = fq[sel_rows]
    if level_h > 0:
        bl, lim, hev = _thresholds(level_h, sharpness)
        bl, lim, hev = bl << shift, lim << shift, hev << shift
        for y4 in range(1, y4max):
            y = y4 << 2
            up_h = tx_h[y4 - 1, :]
            cur_h = tx_h[y4, :]
            is_tx_edge = (y % np.maximum(cur_h, 1)) == 0
            apply = is_tx_edge & (block_edge_y[y4, :]
                                  | ~(skip[y4 - 1, :] & skip[y4, :]))
            apply = apply[:x4max]
            if not apply.any():
                continue
            fsize = np.minimum(np.minimum(up_h, cur_h)[:x4max], 16)
            fsize = np.where(fsize >= 16, 14 if not is_chroma else 6,
                             np.where(fsize >= 8, 8 if not is_chroma else 6, 4))
            if is_chroma:
                fsize = np.minimum(fsize, 6)
            for size in (4, 6, 8, 14):
                sel4 = apply & (fsize == size)
                if not sel4.any():
                    continue
                cmask = np.repeat(sel4, 4)
                if size == 14:
                    npx = min(7, y)
                    nqx = min(7, plane.shape[0] - y)
                elif size == 8:
                    npx, nqx = min(4, y), min(4, plane.shape[0] - y)
                elif size == 6:
                    npx, nqx = min(3, y), min(3, plane.shape[0] - y)
                else:
                    npx, nqx = min(2, y), min(2, plane.shape[0] - y)
                p = plane[y - npx:y, :x4max * 4].T
                q = plane[y:y + nqx, :x4max * 4].T
                fp, fq = _filter_line(p, q, bl, lim, hev, size, shift)
                plane[y - npx:y, :x4max * 4].T[cmask] = fp[cmask]
                plane[y:y + nqx, :x4max * 4].T[cmask] = fq[cmask]
    return plane


# --------------------------------------------------------------------------
# Full-plane device formulation: every vertical (then horizontal) edge
# filters in one batched pass — edges never read each other's writes
# (the geometry guarantees non-overlap, which the per-line host loop
# above already relies on), so "all edges from the original plane" is
# exactly the sequential result.  Sample access is strided slices of an
# 8px-padded plane; per-edge parameters arrive as [y4, n_edge] masks.
# --------------------------------------------------------------------------

PADF = 8


def edge_params(tx_w, tx_h, skip, block_edge_x, block_edge_y,
                width: int, height: int, is_chroma: bool):
    """Host-side mask derivation for both passes.

    Returns (apply_v, fsize_v [y4max, n_ev], apply_h, fsize_h
    [n_eh, x4max]) where n_ev = x4max - 1 vertical edges (at x = 4 *
    (1 + e)) and n_eh = y4max - 1 horizontal edges."""
    x4max = (width + 3) >> 2
    y4max = (height + 3) >> 2
    xs = np.arange(1, x4max)
    left_w = tx_w[:y4max, xs - 1]
    curr_w = tx_w[:y4max, xs]
    is_tx_edge = ((xs << 2)[None, :] % np.maximum(curr_w, 1)) == 0
    apply_v = is_tx_edge & (block_edge_x[:y4max, xs]
                            | ~(skip[:y4max, xs - 1] & skip[:y4max, xs]))
    fs = np.minimum(np.minimum(left_w, curr_w), 16)
    fsize_v = np.where(fs >= 16, 14, np.where(fs >= 8, 8, 4))
    if is_chroma:
        fsize_v = np.minimum(fsize_v, 6)

    ys = np.arange(1, y4max)
    up_h = tx_h[ys - 1, :x4max]
    cur_h = tx_h[ys, :x4max]
    is_tx_edge = ((ys << 2)[:, None] % np.maximum(cur_h, 1)) == 0
    apply_h = is_tx_edge & (block_edge_y[ys, :x4max]
                            | ~(skip[ys - 1, :x4max] & skip[ys, :x4max]))
    fs = np.minimum(np.minimum(up_h, cur_h), 16)
    fsize_h = np.where(fs >= 16, 14, np.where(fs >= 8, 8, 4))
    if is_chroma:
        fsize_h = np.minimum(fsize_h, 6)
    # uint8 filter sizes: these masks ride host->device every frame
    return (apply_v, fsize_v.astype(np.uint8),
            apply_h, fsize_h.astype(np.uint8))


def _edge_filter_batch(p, q, apply_m, fsize, blimit, limit, thresh,
                       shift, xp):
    """Filter a batch of edges: p [..., 7] (p6..p0), q [..., 7]
    (q0..q6), per-position apply/fsize.  Returns (new_p, new_q)."""
    sel4 = apply_m & (fsize == 4)
    sel6 = apply_m & (fsize == 6)
    sel8p = apply_m & (fsize >= 8)
    fp4, fq4 = _filter_line(p, q, blimit, limit, thresh, 4, shift, xp)
    fp6, fq6 = _filter_line(p, q, blimit, limit, thresh, 6, shift, xp)
    fp8, fq8 = _filter_line(p, q, blimit, limit, thresh, 8, shift, xp)
    fp14, fq14 = _filter_line(p, q, blimit, limit, thresh, 14, shift, xp)
    sel14 = apply_m & (fsize == 14)
    sel8 = apply_m & (fsize == 8)

    def pick(orig, f4, f6, f8, f14):
        out = xp.where(sel4[..., None], f4, orig)
        out = xp.where(sel6[..., None], f6, out)
        out = xp.where(sel8[..., None], f8, out)
        out = xp.where(sel14[..., None], f14, out)
        return out

    return (pick(p.astype(xp.int32), fp4, fp6, fp8, fp14),
            pick(q.astype(xp.int32), fq4, fq6, fq8, fq14))


def loop_filter_plane_full(plane, apply_v, fsize_v, apply_h, fsize_h,
                           width: int, height: int, level_v: int,
                           level_h: int, sharpness: int, bd: int = 8,
                           xp=np):
    """Batched whole-plane DLF; bit-exact with loop_filter_plane."""
    shift = bd - 8
    x4max = (width + 3) >> 2
    y4max = (height + 3) >> 2
    P = xp.pad(plane.astype(xp.int32), PADF)

    def thresholds(level):
        # _thresholds with a possibly-traced level (sharpness static)
        inside = level >> ((sharpness > 0) + (sharpness > 4))
        if sharpness > 0:
            inside = xp.minimum(inside, 9 - sharpness)
        inside = xp.maximum(inside, 1)
        blimit = 2 * (level + 2) + inside
        return (blimit << shift, inside << shift, (level >> 4) << shift)

    static_v = isinstance(level_v, int)
    static_h = isinstance(level_h, int)
    if (not static_v or level_v > 0) and x4max > 1:
        bl, lim, hev = thresholds(level_v)
        n_e = x4max - 1
        rows = P[PADF:PADF + y4max * 4]
        # p6..p0 at plane cols 4e+4-7 .. 4e+3; q0..q6 at 4e+4 .. 4e+10
        p = xp.stack([rows[:, PADF - 3 + k: PADF - 3 + k + 4 * n_e: 4]
                      for k in range(7)], axis=-1)
        q = xp.stack([rows[:, PADF + 4 + k: PADF + 4 + k + 4 * n_e: 4]
                      for k in range(7)], axis=-1)
        am = xp.repeat(xp.asarray(apply_v), 4, axis=0)[:y4max * 4]
        fs = xp.repeat(xp.asarray(fsize_v), 4, axis=0)[:y4max * 4]
        fp, fq = _edge_filter_batch(p, q, am, fs, bl, lim, hev, shift, xp)
        # functional reassembly: column 4u+r of the filtered region has
        # up to four writers — p of edges u/u+1, q of edges u-1/u-2 —
        # whose actual modifications never collide (geometry); merge by
        # "changed samples win" per residue class, no scatters
        Hv = y4max * 4
        inner = P[PADF:PADF + Hv, PADF:PADF + 4 * x4max]
        U = inner.reshape(Hv, x4max, 4)

        def aligned(vals, orig, off):
            # candidate/orig pair for unit u taken from edge u + off,
            # zero-padded outside (zero==zero -> "not changed")
            zv = xp.zeros((Hv, x4max), xp.int32)
            zo = xp.zeros((Hv, x4max), xp.int32)
            if off >= 0:
                w = min(n_e - off, x4max)
                if xp is np:
                    zv[:, :w] = vals[:, off:off + w]
                    zo[:, :w] = orig[:, off:off + w]
                else:
                    zv = zv.at[:, :w].set(vals[:, off:off + w])
                    zo = zo.at[:, :w].set(orig[:, off:off + w])
            else:
                w = min(n_e, x4max + off)
                if xp is np:
                    zv[:, -off:-off + w] = vals[:, :w]
                    zo[:, -off:-off + w] = orig[:, :w]
                else:
                    zv = zv.at[:, -off:-off + w].set(vals[:, :w])
                    zo = zo.at[:, -off:-off + w].set(orig[:, :w])
            return zv, zo

        cols = []
        for r in range(4):
            col = U[:, :, r]
            cand = [(fp[..., r + 3], p[..., r + 3], 0),
                    (fq[..., r], q[..., r], -1)]
            if r >= 1:
                cand.append((fp[..., r - 1], p[..., r - 1], 1))
            if r <= 2:
                cand.append((fq[..., r + 4], q[..., r + 4], -2))
            for vals, orig, off in cand:
                zv, zo = aligned(vals, orig, off)
                col = xp.where(zv != zo, zv, col)
            cols.append(col)
        out_inner = xp.stack(cols, axis=-1).reshape(Hv, 4 * x4max)
        if xp is np:
            P[PADF:PADF + Hv, PADF:PADF + 4 * x4max] = out_inner
        else:
            P = P.at[PADF:PADF + Hv, PADF:PADF + 4 * x4max].set(out_inner)

    if (not static_h or level_h > 0) and y4max > 1:
        bl, lim, hev = thresholds(level_h)
        n_e = y4max - 1
        cols = P[:, PADF:PADF + x4max * 4]
        p = xp.stack([cols[PADF - 3 + k: PADF - 3 + k + 4 * n_e: 4]
                      for k in range(7)], axis=-1)        # [n_e*4? no...
        # rows at 4e+1+k for k 0..6 -> transpose to [x, n_e, 7]
        p = xp.swapaxes(p, 0, 1)
        q = xp.stack([cols[PADF + 4 + k: PADF + 4 + k + 4 * n_e: 4]
                      for k in range(7)], axis=-1)
        q = xp.swapaxes(q, 0, 1)
        am = xp.repeat(xp.asarray(apply_h), 4, axis=1)[:, :x4max * 4]
        am = xp.swapaxes(am, 0, 1)
        fs = xp.repeat(xp.asarray(fsize_h), 4, axis=1)[:, :x4max * 4]
        fs = xp.swapaxes(fs, 0, 1)
        fp, fq = _edge_filter_batch(p, q, am, fs, bl, lim, hev, shift, xp)
        po = xp.swapaxes(p, 0, 1)         # [n_e, X, 7]
        qo = xp.swapaxes(q, 0, 1)
        fp = xp.swapaxes(fp, 0, 1)
        fq = xp.swapaxes(fq, 0, 1)
        Wv = x4max * 4
        inner = P[PADF:PADF + 4 * y4max, PADF:PADF + Wv]
        U = inner.reshape(y4max, 4, Wv)

        def aligned(vals, orig, off):
            zv = xp.zeros((y4max, Wv), xp.int32)
            zo = xp.zeros((y4max, Wv), xp.int32)
            if off >= 0:
                w = min(n_e - off, y4max)
                if xp is np:
                    zv[:w] = vals[off:off + w]
                    zo[:w] = orig[off:off + w]
                else:
                    zv = zv.at[:w].set(vals[off:off + w])
                    zo = zo.at[:w].set(orig[off:off + w])
            else:
                w = min(n_e, y4max + off)
                if xp is np:
                    zv[-off:-off + w] = vals[:w]
                    zo[-off:-off + w] = orig[:w]
                else:
                    zv = zv.at[-off:-off + w].set(vals[:w])
                    zo = zo.at[-off:-off + w].set(orig[:w])
            return zv, zo

        rows_out = []
        for r in range(4):
            row = U[:, r, :]
            cand = [(fp[..., r + 3], po[..., r + 3], 0),
                    (fq[..., r], qo[..., r], -1)]
            if r >= 1:
                cand.append((fp[..., r - 1], po[..., r - 1], 1))
            if r <= 2:
                cand.append((fq[..., r + 4], qo[..., r + 4], -2))
            for vals, orig, off in cand:
                zv, zo = aligned(vals, orig, off)
                row = xp.where(zv != zo, zv, row)
            rows_out.append(row)
        out_inner = xp.stack(rows_out, axis=1).reshape(4 * y4max, Wv)
        if xp is np:
            P[PADF:PADF + 4 * y4max, PADF:PADF + Wv] = out_inner
        else:
            P = P.at[PADF:PADF + 4 * y4max, PADF:PADF + Wv].set(out_inner)

    return P[PADF:PADF + plane.shape[0], PADF:PADF + plane.shape[1]]


# --------------------------------------------------------------------------
# Fused encoder entry: level search (luma SSE over candidates) + apply,
# one device call (the analog of EbDlfProcess.c's level search, which
# the round-1 build skipped — levels came straight from qindex).
# --------------------------------------------------------------------------

import functools as _functools




