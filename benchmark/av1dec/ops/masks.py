"""Compound-prediction masks: wedge codebooks, difference-weighted
masks, inter-intra smooth masks, and the A64 blend kernels.

Behavioral parity targets (semantics studied from the reference, built
here as vectorized numpy over spec tables):
  * wedge master masks + per-bsize codebooks/signflip
    (EbInterPrediction.c:1505-1810 svt_av1_init_wedge_masks; spec
    Wedge_Master_* tables + block_shape/wedge codebook tables),
  * DIFFWTD_38/38_INV masks from CONV-domain preds
    (EbInterPrediction_c.c:15 diffwtd_mask_d16),
  * masked blend in the CONV (d16) domain
    (EbBlend_a64_mask.c:34 svt_aom_lowbd_blend_a64_d16_mask) and the
    pixel domain (svt_aom_blend_a64_mask),
  * smooth inter-intra masks (EbInterPrediction.c:1823 ii_weights1d /
    build_smooth_interintra_mask).

All blends use AOM_BLEND_A64 semantics: out = (m*a + (64-m)*b + 32)>>6.
"""
from __future__ import annotations

import functools

import numpy as np

from .inter import FILTER_BITS, ROUND0_BITS_8

MAX_ALPHA = 64            # AOM_BLEND_A64_MAX_ALPHA
WEDGE_WEIGHT_BITS = 6
MASK_SIZE = 64            # MASK_PRIMARY_SIZE
DIFF_FACTOR = 16

# wedge directions
HORIZONTAL, VERTICAL, OBLIQUE27, OBLIQUE63, OBLIQUE117, OBLIQUE153 = \
    range(6)

# spec Wedge_Master_Oblique_Odd / _Even / _Vertical (64 taps, 0..64)
_OBLIQUE_ODD = np.asarray([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 1, 2, 6, 18, 37, 53, 60, 63, 64, 64, 64, 64, 64,
    64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64,
    64, 64, 64, 64, 64, 64], np.uint8)
_OBLIQUE_EVEN = np.asarray([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 1, 4, 11, 27, 46, 58, 62, 63, 64, 64, 64, 64, 64,
    64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64,
    64, 64, 64, 64, 64, 64], np.uint8)
_VERTICAL = np.asarray([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 2, 7, 21, 43, 57, 62, 64, 64, 64, 64, 64, 64,
    64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64,
    64, 64, 64, 64, 64, 64], np.uint8)

# per-bsize wedge codebooks: (direction, x_offset, y_offset) in 8ths
_CB_HGTW = ((OBLIQUE27, 4, 4), (OBLIQUE63, 4, 4), (OBLIQUE117, 4, 4),
            (OBLIQUE153, 4, 4), (HORIZONTAL, 4, 2), (HORIZONTAL, 4, 4),
            (HORIZONTAL, 4, 6), (VERTICAL, 4, 4), (OBLIQUE27, 4, 2),
            (OBLIQUE27, 4, 6), (OBLIQUE153, 4, 2), (OBLIQUE153, 4, 6),
            (OBLIQUE63, 2, 4), (OBLIQUE63, 6, 4), (OBLIQUE117, 2, 4),
            (OBLIQUE117, 6, 4))
_CB_HLTW = ((OBLIQUE27, 4, 4), (OBLIQUE63, 4, 4), (OBLIQUE117, 4, 4),
            (OBLIQUE153, 4, 4), (VERTICAL, 2, 4), (VERTICAL, 4, 4),
            (VERTICAL, 6, 4), (HORIZONTAL, 4, 4), (OBLIQUE27, 4, 2),
            (OBLIQUE27, 4, 6), (OBLIQUE153, 4, 2), (OBLIQUE153, 4, 6),
            (OBLIQUE63, 2, 4), (OBLIQUE63, 6, 4), (OBLIQUE117, 2, 4),
            (OBLIQUE117, 6, 4))
_CB_HEQW = ((OBLIQUE27, 4, 4), (OBLIQUE63, 4, 4), (OBLIQUE117, 4, 4),
            (OBLIQUE153, 4, 4), (HORIZONTAL, 4, 2), (HORIZONTAL, 4, 6),
            (VERTICAL, 2, 4), (VERTICAL, 6, 4), (OBLIQUE27, 4, 2),
            (OBLIQUE27, 4, 6), (OBLIQUE153, 4, 2), (OBLIQUE153, 4, 6),
            (OBLIQUE63, 2, 4), (OBLIQUE63, 6, 4), (OBLIQUE117, 2, 4),
            (OBLIQUE117, 6, 4))

# (w, h) -> (codebook, signflip[16])  (wedge_params_lookup rows)
WEDGE_BLOCKS = {
    (8, 8): (_CB_HEQW,
             (1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1)),
    (8, 16): (_CB_HGTW,
              (1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1)),
    (16, 8): (_CB_HLTW,
              (1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1)),
    (16, 16): (_CB_HEQW,
               (1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1)),
    (16, 32): (_CB_HGTW,
               (1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1)),
    (32, 16): (_CB_HLTW,
               (1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1)),
    (32, 32): (_CB_HEQW,
               (1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1)),
    (8, 32): (_CB_HGTW,
              (1, 1, 1, 1, 0, 1, 1, 1, 0, 1, 0, 1, 1, 1, 0, 1)),
    (32, 8): (_CB_HLTW,
              (1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 0, 1, 0, 1, 0, 1)),
}


def wedge_used(bw: int, bh: int) -> bool:
    return (bw, bh) in WEDGE_BLOCKS


@functools.lru_cache(maxsize=1)
def _master_masks() -> np.ndarray:
    """[6 directions][64][64] primary wedge masks (index 0 polarity)."""
    m = np.zeros((6, MASK_SIZE, MASK_SIZE), np.int32)
    # OBLIQUE63 prototype: shifted even/odd primary rows
    shift = MASK_SIZE // 4
    for i in range(0, MASK_SIZE, 2):
        for row, src in ((i, _OBLIQUE_EVEN), (i + 1, _OBLIQUE_ODD)):
            s = shift if row == i else shift - 1
            dst = m[OBLIQUE63, row]
            if s >= 0:
                dst[s:] = src[:MASK_SIZE - s]
                dst[:s] = src[0]
            else:
                dst[:MASK_SIZE + s] = src[-s:]
                dst[MASK_SIZE + s:] = src[-1]
        shift -= 1
        m[VERTICAL, i] = _VERTICAL
        m[VERTICAL, i + 1] = _VERTICAL
    mo = m[OBLIQUE63]
    m[OBLIQUE27] = mo.T
    m[OBLIQUE117] = (MAX_ALPHA - mo)[:, ::-1]
    m[OBLIQUE153] = ((MAX_ALPHA - mo)[:, ::-1]).T
    m[HORIZONTAL] = m[VERTICAL].T
    return m.astype(np.uint8)


@functools.lru_cache(maxsize=128)
def wedge_mask(bw: int, bh: int, index: int, sign: int) -> np.ndarray:
    """[bh, bw] uint8 mask (weights PRED0) for one wedge type."""
    cb, signflip = WEDGE_BLOCKS[(bw, bh)]
    direction, xo, yo = cb[index]
    woff = (xo * bw) >> 3
    hoff = (yo * bh) >> 3
    master = _master_masks()[direction]
    r0 = MASK_SIZE // 2 - hoff
    c0 = MASK_SIZE // 2 - woff
    sub = master[r0:r0 + bh, c0:c0 + bw]
    if sign ^ signflip[index]:
        sub = MAX_ALPHA - sub
    return np.ascontiguousarray(sub)


def diffwtd_mask_d16(conv0: np.ndarray, conv1: np.ndarray, inverse: int,
                     bd: int = 8) -> np.ndarray:
    """DIFFWTD_38[_INV] mask from the two CONV-domain luma preds
    (diffwtd_mask_d16, EbInterPrediction_c.c:15)."""
    rnd = 2 * FILTER_BITS - ROUND0_BITS_8 - 7 + (bd - 8)
    diff = np.abs(conv0.astype(np.int32) - conv1.astype(np.int32))
    diff = (diff + (1 << (rnd - 1))) >> rnd
    m = np.clip(38 + diff // DIFF_FACTOR, 0, MAX_ALPHA)
    return (MAX_ALPHA - m if inverse else m).astype(np.uint8)


def _subsample_mask(mask: np.ndarray, subw: int, subh: int) -> np.ndarray:
    """AOM blend mask collapse for subsampled planes."""
    m = mask.astype(np.int32)
    if subw and subh:
        m = (m[0::2, 0::2] + m[1::2, 0::2] + m[0::2, 1::2]
             + m[1::2, 1::2] + 2) >> 2
    elif subw:
        m = (m[:, 0::2] + m[:, 1::2] + 1) >> 1
    elif subh:
        m = (m[0::2, :] + m[1::2, :] + 1) >> 1
    return m


def blend_a64_d16(conv0: np.ndarray, conv1: np.ndarray, mask: np.ndarray,
                  subw: int, subh: int, bd: int = 8) -> np.ndarray:
    """Masked compound blend in the CONV domain -> pixels
    (svt_aom_{lowbd,highbd}_blend_a64_d16_mask); ``mask`` is
    luma-sized, ``subw/subh`` collapse it for chroma planes."""
    m = _subsample_mask(mask, subw, subh)
    offset_bits = bd + 2 * FILTER_BITS - ROUND0_BITS_8
    round_offset = (1 << (offset_bits - 7)) + (1 << (offset_bits - 8))
    round_bits = 2 * FILTER_BITS - ROUND0_BITS_8 - 7
    res = (m * conv0.astype(np.int64)
           + (MAX_ALPHA - m) * conv1.astype(np.int64)) >> 6
    res = res - round_offset
    res = (res + (1 << (round_bits - 1))) >> round_bits
    return np.clip(res, 0, (1 << bd) - 1).astype(np.int32)


def blend_a64_pixels(a: np.ndarray, b: np.ndarray, mask: np.ndarray,
                     subw: int = 0, subh: int = 0) -> np.ndarray:
    """Pixel-domain A64 blend: (m*a + (64-m)*b + 32) >> 6."""
    m = _subsample_mask(mask, subw, subh)
    return ((m * a.astype(np.int32)
             + (MAX_ALPHA - m) * b.astype(np.int32) + 32) >> 6)


# -- inter-intra ------------------------------------------------------------

II_DC, II_V, II_H, II_SMOOTH = range(4)

_II_WEIGHTS = np.asarray([
    60, 58, 56, 54, 52, 50, 48, 47, 45, 44, 42, 41, 39, 38, 37, 35, 34,
    33, 32, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 22, 21, 20, 19, 19,
    18, 18, 17, 16, 16, 15, 15, 14, 14, 13, 13, 12, 12, 12, 11, 11, 10,
    10, 10, 9, 9, 9, 8, 8, 8, 8, 7, 7, 7, 7, 6, 6, 6, 6, 6, 5, 5, 5, 5,
    5, 4, 4, 4, 4, 4, 4, 4, 4, 3, 3, 3, 3, 3, 3, 3, 3, 3, 2, 2, 2, 2,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1], np.int32)


@functools.lru_cache(maxsize=128)
def smooth_interintra_mask(bw: int, bh: int, mode: int) -> np.ndarray:
    """[bh, bw] mask weighting the INTRA prediction
    (build_smooth_interintra_mask; size_scale = 128 / max dim)."""
    scale = 128 // max(bw, bh)
    if mode == II_V:
        col = _II_WEIGHTS[np.arange(bh) * scale]
        m = np.repeat(col[:, None], bw, axis=1)
    elif mode == II_H:
        row = _II_WEIGHTS[np.arange(bw) * scale]
        m = np.repeat(row[None, :], bh, axis=0)
    elif mode == II_SMOOTH:
        i = np.minimum(np.arange(bh)[:, None], np.arange(bw)[None, :])
        m = _II_WEIGHTS[i * scale]
    else:
        m = np.full((bh, bw), 32, np.int32)
    return m.astype(np.uint8)
