"""Quality metrics (ref: Source/Lib/Encoder/Codec/EbPsnr.c)."""
from __future__ import annotations

import numpy as np


def sse(a: np.ndarray, b: np.ndarray) -> float:
    d = a.astype(np.int64) - b.astype(np.int64)
    return float((d * d).sum())


def psnr(a: np.ndarray, b: np.ndarray, peak: int = 255) -> float:
    """svt_aom_sse_to_psnr semantics."""
    s = sse(a, b)
    if s == 0:
        return 99.0
    n = a.size
    return min(10.0 * np.log10(peak * peak * n / s), 99.0)


def frame_psnr(src_planes, rec_planes, peak: int = 255):
    """Returns (y, u, v, combined) PSNR like the reference stat report."""
    ps = [psnr(s, r, peak) for s, r in zip(src_planes, rec_planes)]
    total_sse = sum(sse(s, r) for s, r in zip(src_planes, rec_planes))
    total_n = sum(p.size for p in src_planes)
    comb = 99.0 if total_sse == 0 else min(
        10.0 * np.log10(peak * peak * total_n / total_sse), 99.0)
    return (*ps, comb)


def _ssim_8x8(a: np.ndarray, b: np.ndarray) -> float:
    """aom_ssim2 semantics: 8x8 windows, stride 4, integer moments
    (Source/Lib/Encoder/Codec/EbPsnr.c / aom ssim.c constants)."""
    c1 = (0.01 * 255) ** 2 * 64 * 64
    c2 = (0.03 * 255) ** 2 * 64 * 64
    s = a.astype(np.float64)
    r = b.astype(np.float64)
    H, W = s.shape
    total = 0.0
    count = 0
    for y in range(0, H - 7, 4):
        for x in range(0, W - 7, 4):
            ws = s[y:y + 8, x:x + 8]
            wr = r[y:y + 8, x:x + 8]
            sum_s = ws.sum()
            sum_r = wr.sum()
            sum_sq_s = (ws * ws).sum()
            sum_sq_r = (wr * wr).sum()
            sum_sxr = (ws * wr).sum()
            vs = 64 * sum_sq_s - sum_s * sum_s
            vr = 64 * sum_sq_r - sum_r * sum_r
            cov = 64 * sum_sxr - sum_s * sum_r
            ssim_n = (2 * sum_s * sum_r + c1) * (2 * cov + c2)
            ssim_d = (sum_s * sum_s + sum_r * sum_r + c1) * (vs + vr + c2)
            total += ssim_n / ssim_d
            count += 1
    return total / max(count, 1)


def ssim(a: np.ndarray, b: np.ndarray) -> float:
    """Vectorized aom_ssim2 (windowed moments via stacked shifts)."""
    s = a.astype(np.float64)
    r = b.astype(np.float64)
    H, W = s.shape
    if H < 8 or W < 8:
        return _ssim_8x8(a, b)
    c1 = (0.01 * 255) ** 2 * 64 * 64
    c2 = (0.03 * 255) ** 2 * 64 * 64

    def winsum(x):
        ii = np.cumsum(np.cumsum(x, 0), 1)
        ii = np.pad(ii, ((1, 0), (1, 0)))
        w = ii[8:, 8:] - ii[:-8, 8:] - ii[8:, :-8] + ii[:-8, :-8]
        return w[::4, ::4]

    sum_s = winsum(s)
    sum_r = winsum(r)
    sum_sq_s = winsum(s * s)
    sum_sq_r = winsum(r * r)
    sum_sxr = winsum(s * r)
    vs = 64 * sum_sq_s - sum_s * sum_s
    vr = 64 * sum_sq_r - sum_r * sum_r
    cov = 64 * sum_sxr - sum_s * sum_r
    ssim_n = (2 * sum_s * sum_r + c1) * (2 * cov + c2)
    ssim_d = (sum_s * sum_s + sum_r * sum_r + c1) * (vs + vr + c2)
    return float((ssim_n / ssim_d).mean())


def frame_ssim(src_planes, rec_planes) -> float:
    """Weighted luma/chroma SSIM like the reference stat report
    (aom_calc_ssim: 0.8 luma + 0.1 per chroma plane)."""
    y = ssim(src_planes[0], rec_planes[0])
    if len(src_planes) < 3:
        return y
    u = ssim(src_planes[1], rec_planes[1])
    v = ssim(src_planes[2], rec_planes[2])
    return 0.8 * y + 0.1 * (u + v)
