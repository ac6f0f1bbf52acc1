"""Global motion estimation: trimmed least-squares ROTZOOM fit over a
coarse block motion field.

The reference estimates global motion from FAST corners + RANSAC
(EbGlobalMotionEstimation.c, corner_detect.c, ransac.c).  Only the
SIGNALED parameters are normative, so this implementation uses a
different, batch-friendly estimator: dense 16x16 block motion vectors
(full-pel HME) fitted with iteratively-trimmed least squares — the
whole field reduces to a handful of 4x4 normal-equation sums, which on
TPU is one reduction over the block grid.  Validation mirrors the
reference: parameters are quantized to the header precision, must pass
svt_get_shear_params, and must beat the identity model on the sampled
field before being signaled.
"""
from __future__ import annotations

import numpy as np

from ..ops import me as me_ops
from ..ops import warp as warp_ops

BLOCK = 16
WARP_ONE = 1 << warp_ops.WARPEDMODEL_PREC_BITS
# header precisions (GM_ALPHA_PREC_DIFF / GM_TRANS_PREC_DIFF)
ALPHA_STEP = 2          # 1 << (16 - GM_ALPHA_PREC_BITS)
TRANS_STEP = 1 << 10    # 1 << (16 - GM_TRANS_PREC_BITS)
ALPHA_MAX = (1 << 12) * ALPHA_STEP
TRANS_MAX = (1 << 12) * TRANS_STEP


def _block_motion_field(src: np.ndarray, ref: np.ndarray, search: int = 12):
    """Full-pel motion (dy, dx) per 16x16 block + a texture mask."""
    h, w = src.shape
    pts, vecs = [], []
    for by in range(0, h - BLOCK + 1, BLOCK):
        for bx in range(0, w - BLOCK + 1, BLOCK):
            blk = src[by:by + BLOCK, bx:bx + BLOCK]
            if blk.std() < 4.0:          # flat: motion unobservable
                continue
            cx = int(np.clip(bx, search, w - BLOCK - search))
            cy = int(np.clip(by, search, h - BLOCK - search))
            dx, dy, _ = me_ops.hme_search(blk.astype(np.uint8), ref,
                                          cx, cy, search, search)
            pts.append((bx + BLOCK // 2, by + BLOCK // 2))
            vecs.append((cx + dx - bx, cy + dy - by))
    return np.array(pts, np.float64), np.array(vecs, np.float64)


def _fit_rotzoom(pts, vecs):
    """LS solve of x' = a x + b y + tx ; y' = -b x + a y + ty."""
    x, y = pts[:, 0], pts[:, 1]
    xp = pts[:, 0] + vecs[:, 0]
    yp = pts[:, 1] + vecs[:, 1]
    # unknowns [a, b, tx, ty]
    n = len(x)
    a_rows = np.zeros((2 * n, 4))
    b_vec = np.zeros(2 * n)
    a_rows[0::2, 0] = x
    a_rows[0::2, 1] = y
    a_rows[0::2, 2] = 1
    b_vec[0::2] = xp
    a_rows[1::2, 0] = y
    a_rows[1::2, 1] = -x
    a_rows[1::2, 3] = 1
    b_vec[1::2] = yp
    sol, *_ = np.linalg.lstsq(a_rows, b_vec, rcond=None)
    return sol                      # a, b, tx, ty


def _residuals(sol, pts, vecs):
    a, b, tx, ty = sol
    x, y = pts[:, 0], pts[:, 1]
    rx = (a * x + b * y + tx) - (x + vecs[:, 0])
    ry = (-b * x + a * y + ty) - (y + vecs[:, 1])
    return np.hypot(rx, ry)


def _quant(v: float, step: int, vmax: int) -> int:
    q = int(round(v / step)) * step
    return int(np.clip(q, -(vmax - step), vmax - step))


def estimate_rotzoom(src_y: np.ndarray, ref_y: np.ndarray):
    """(wmtype, mat) for the header, or None for identity."""
    pts, vecs = _block_motion_field(np.asarray(src_y),
                                    np.asarray(ref_y).astype(np.uint8))
    if len(pts) < 8:
        return None
    sol = None
    keep = np.ones(len(pts), bool)
    for _ in range(3):                 # trimmed refits
        if keep.sum() < 8:
            return None
        sol = _fit_rotzoom(pts[keep], vecs[keep])
        res = _residuals(sol, pts, vecs)
        thresh = max(2.0, 3.0 * np.median(res[keep]))
        keep = res <= thresh
    a, b, tx, ty = sol
    m2 = WARP_ONE + _quant((a - 1.0) * WARP_ONE, ALPHA_STEP, ALPHA_MAX)
    m3 = _quant(b * WARP_ONE, ALPHA_STEP, ALPHA_MAX)
    m0 = _quant(tx * WARP_ONE, TRANS_STEP, TRANS_MAX)
    m1 = _quant(ty * WARP_ONE, TRANS_STEP, TRANS_MAX)
    mat = (m0, m1, m2, m3, -m3, m2)
    if mat == (0, 0, WARP_ONE, 0, 0, WARP_ONE):
        return None
    if warp_ops.get_shear_params(mat) is None:
        return None
    # accept only when the model beats identity on the sampled field
    res_model = _residuals((a, b, tx, ty), pts[keep], vecs[keep])
    res_ident = np.hypot(vecs[keep][:, 0], vecs[keep][:, 1])
    if res_model.mean() + 0.25 >= res_ident.mean():
        return None
    return (warp_ops.ROTZOOM, mat)
