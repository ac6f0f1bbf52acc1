"""Super-resolution: horizontal-only normative upscale (AV1 spec 7.16;
EbSuperRes.c av1_convolve_horiz_rs_c / upscale_normative_rect) and the
encoder-side downscale (non-normative, EbResize.c analog).

The upscale is a per-row gather + 8-tap filter over 1/64-phase kernels:
fully vectorized over rows and output columns (one [h, w2, 8] gather per
plane), which maps directly onto a TPU gather + dot.
"""
from __future__ import annotations

import numpy as np

from ..entropy.tables import table

RS_SCALE_SUBPEL_BITS = 14
RS_SCALE_SUBPEL_MASK = (1 << RS_SCALE_SUBPEL_BITS) - 1
RS_SCALE_EXTRA_BITS = 8          # 14 - 6
RS_SCALE_EXTRA_OFF = 1 << 7
SCALE_NUMERATOR = 8
FILTER_BITS = 7


def scaled_dim(dim: int, denom: int) -> int:
    """calculate_scaled_size_helper: coded width from upscaled width."""
    if denom == SCALE_NUMERATOR:
        return dim
    out = (dim * SCALE_NUMERATOR + denom // 2) // denom
    return max(out, min(16, dim))


def _tdiv(a: int, b: int) -> int:
    """C-style truncating integer division."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _x_params(in_w: int, out_w: int):
    step = ((in_w << RS_SCALE_SUBPEL_BITS) + out_w // 2) // out_w
    err = out_w * step - (in_w << RS_SCALE_SUBPEL_BITS)
    x0 = _tdiv(-((out_w - in_w) << (RS_SCALE_SUBPEL_BITS - 1)) + out_w // 2,
               out_w) + RS_SCALE_EXTRA_OFF - _tdiv(err, 2)
    return step, x0 & RS_SCALE_SUBPEL_MASK


def upscale_plane(plane: np.ndarray, in_w: int, out_w: int, h: int,
                  bd: int = 8, ctx_w: int | None = None) -> np.ndarray:
    """Normative horizontal upscale of plane[:h, :in_w] -> [h, out_w].

    ctx_w: the mi-aligned source width — the decoder's tile column spans
    mi_col_end << 2 pixels, so right-edge taps read real coded-overhang
    recon up to ctx_w before replication kicks in
    (svt_av1_upscale_normative_rows, EbSuperRes.c:242-244).
    """
    if in_w == out_w:
        return plane[:h, :in_w].astype(np.int32)
    if ctx_w is None:
        ctx_w = in_w
    filt = table("av1_resize_filter_normative").astype(np.int32)
    step, x0 = _x_params(in_w, out_w)
    xq = x0 + np.arange(out_w, dtype=np.int64) * step
    # leftmost tap: the caller passes input-1 into the convolve, which
    # itself backs up taps/2-1 (upscale_normative_rect:131) -> -4 total
    src_x = (xq >> RS_SCALE_SUBPEL_BITS) - 4
    fidx = (xq & RS_SCALE_SUBPEL_MASK) >> RS_SCALE_EXTRA_BITS
    cols = np.clip(src_x[:, None] + np.arange(8)[None, :], 0, ctx_w - 1)
    src = plane[:h, :ctx_w].astype(np.int32)
    win = src[:, cols]                       # [h, out_w, 8]
    acc = np.einsum("hwk,wk->hw", win, filt[fidx])
    out = (acc + (1 << (FILTER_BITS - 1))) >> FILTER_BITS
    return np.clip(out, 0, (1 << bd) - 1)


def downscale_plane(plane: np.ndarray, out_w: int) -> np.ndarray:
    """Encoder-side horizontal downscale (non-normative): low-pass then
    linear resample, like the reference's multistep resize in spirit."""
    h, in_w = plane.shape
    x = plane.astype(np.float64)
    # gentle low-pass proportional to the scale factor
    taps = max(int(round(in_w / out_w)) | 1, 3)
    k = np.hanning(taps + 2)[1:-1]
    k /= k.sum()
    pad = taps // 2
    xp = np.pad(x, ((0, 0), (pad, pad)), mode="edge")
    lp = np.zeros_like(x)
    for i, w in enumerate(k):
        lp += w * xp[:, i:i + in_w]
    pos = (np.arange(out_w) + 0.5) * in_w / out_w - 0.5
    i0 = np.clip(np.floor(pos).astype(int), 0, in_w - 1)
    i1 = np.clip(i0 + 1, 0, in_w - 1)
    frac = pos - i0
    out = lp[:, i0] * (1 - frac) + lp[:, i1] * frac
    hi = np.iinfo(plane.dtype).max if plane.dtype.kind == "u" else 255
    return np.clip(np.round(out), 0, hi).astype(plane.dtype)
