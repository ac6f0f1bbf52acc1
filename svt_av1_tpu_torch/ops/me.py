"""Motion estimation kernels: SAD search grids, pyramids, hierarchical ME.

The TPU-first formulation of the reference's open-loop HME/ME
(SVT-AV1 Source/Lib/Encoder/Codec/EbMotionEstimation.c:
hme_level_0:852, hme_level_1:1028, hme_level_2:1177, integer_search_sb:
1868): instead of per-position SIMD SAD loops, the whole search grid is
one batched tensor op — candidate windows are gathered as a
[n_pos_y, n_pos_x, bh, bw] view (stride tricks on host, dynamic slices
under jit) and reduced in one shot, which maps directly onto the VPU with
the position grid in the lanes.

The 8x8 SAD pyramid mirrors integer_search_sb's trick: 8x8 SADs for the
full search area are computed once, then aggregated into every square
block size's SAD surface with virtually no extra work.
"""
from __future__ import annotations

import numpy as np


def sad_full_search(block, window, xp=np):
    """SAD of ``block`` [bh, bw] at every position of ``window``
    [wh, ww]; returns [wh-bh+1, ww-bw+1] int32."""
    bh, bw = block.shape[-2], block.shape[-1]
    wh, ww = window.shape[-2], window.shape[-1]
    ny, nx = wh - bh + 1, ww - bw + 1
    if xp is np:
        # stride-tricked windows: zero-copy gather on host
        win = np.lib.stride_tricks.sliding_window_view(window, (bh, bw))
        d = np.abs(win.astype(np.int32) - block.astype(np.int32))
        return d.sum(axis=(-2, -1), dtype=np.int32)
    # jit path: accumulate row-shifted differences (VPU-friendly; the
    # inner reduction stays a static unrolled sum over block rows)
    b = block.astype(xp.int32)
    w32 = window.astype(xp.int32)
    acc = xp.zeros((ny, nx), dtype=xp.int32)
    for dy in range(bh):
        row = b[dy]                               # [bw]
        strip = w32[dy:dy + ny]                   # [ny, ww]
        col = xp.zeros((ny, nx), dtype=xp.int32)
        for dx in range(bw):
            col = col + xp.abs(strip[:, dx:dx + nx] - row[dx])
        acc = acc + col
    return acc


def sad8x8_grid(src_sb, window, xp=np):
    """8x8 SAD pyramid base: SADs of every aligned 8x8 sub-block of
    ``src_sb`` [H, W] at every search position in ``window``.

    Returns [H//8, W//8, ny, nx] int32 where (ny, nx) spans window
    positions (integer_search_sb's per-8x8 SAD array)."""
    H, W = src_sb.shape
    wh, ww = window.shape
    ny, nx = wh - H + 1, ww - W + 1
    n8y, n8x = H // 8, W // 8
    out = np.empty((n8y, n8x, ny, nx), dtype=np.int32)
    win = np.lib.stride_tricks.sliding_window_view(window, (8, 8))
    src32 = src_sb.astype(np.int32)
    for by in range(n8y):
        for bx in range(n8x):
            blk = src32[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8]
            w8 = win[by * 8:by * 8 + ny, bx * 8:bx * 8 + nx]
            out[by, bx] = np.abs(w8 - blk).sum(axis=(-2, -1), dtype=np.int32)
    return out


def aggregate_sads(sad8, size: int) -> np.ndarray:
    """Aggregate the 8x8 SAD grid into size x size block SADs
    (size in {8, 16, 32, 64}); returns [n_by, n_bx, ny, nx]."""
    n = size // 8
    n8y, n8x = sad8.shape[:2]
    out = sad8
    if n == 1:
        return out
    oy, ox = n8y // n, n8x // n
    trimmed = sad8[:oy * n, :ox * n]
    return trimmed.reshape(oy, n, ox, n, *sad8.shape[2:]).sum(axis=(1, 3))


def decimate(plane: np.ndarray, factor: int) -> np.ndarray:
    """Open-loop decimation for HME pyramid levels (the reference's
    quarter/sixteenth pictures, EbPictureAnalysisProcess.c
    downsample_filtering_input_picture; plain decimation variant)."""
    return plane[::factor, ::factor]


def hme_search(src_block, ref_plane, center_x: int, center_y: int,
               search_w: int, search_h: int):
    """One HME level: full search of ``src_block`` in ``ref_plane``
    around (center_x, center_y); returns (mv_x, mv_y, sad).

    The search window is clamped to the plane; motion is relative to the
    block's own position (center assumed at same coords)."""
    bh, bw = src_block.shape
    ph, pw = ref_plane.shape
    x0 = int(np.clip(center_x - search_w, 0, pw - bw))
    x1 = int(np.clip(center_x + search_w, 0, pw - bw))
    y0 = int(np.clip(center_y - search_h, 0, ph - bh))
    y1 = int(np.clip(center_y + search_h, 0, ph - bh))
    window = ref_plane[y0:y1 + bh, x0:x1 + bw]
    sads = sad_full_search(src_block, window)
    idx = np.unravel_index(np.argmin(sads), sads.shape)
    return (x0 + int(idx[1]) - center_x, y0 + int(idx[0]) - center_y,
            int(sads[idx]))


def hierarchical_me(src_plane, ref_plane, block_x: int, block_y: int,
                    block_size: int = 64,
                    level0_area: int = 48, level1_area: int = 16,
                    level2_area: int = 7,
                    level1: bool = True, level2: bool = True,
                    pyr=None):
    """3-level hierarchical motion estimation for one block.

    Level 0 searches the 1/16-resolution pyramid over a wide area,
    level 1 refines at 1/4, level 2 at full resolution (the reference's
    hme_level_0/1/2 flow with one candidate carried between levels).
    Returns (mv_x, mv_y, sad) in full-pel units at full resolution.
    """
    if pyr is None:
        pyr = (decimate(src_plane, 4), decimate(ref_plane, 4),
               decimate(src_plane, 2), decimate(ref_plane, 2))
    src16, ref16, src4_p, ref4_p = pyr
    b16 = max(block_size // 4, 4)
    bx16, by16 = block_x // 4, block_y // 4
    blk = src16[by16:by16 + b16, bx16:bx16 + b16]
    dx, dy, _ = hme_search(blk, ref16, bx16, by16,
                           max(level0_area // 4, 4),
                           max(level0_area // 4, 4))
    mv_x, mv_y = dx * 2, dy * 2            # to 1/4-res (decimate-2) units

    if level1:
        src4, ref4 = src4_p, ref4_p
        b4 = block_size // 2
        bx4, by4 = block_x // 2, block_y // 2
        blk = src4[by4:by4 + b4, bx4:bx4 + b4]
        dx, dy, _ = hme_search(blk, ref4, bx4 + mv_x, by4 + mv_y,
                               level1_area // 2, level1_area // 2)
        # accumulate: hme_search reports relative to its own center
        mv_x = (mv_x + dx) * 2             # to full-res units
        mv_y = (mv_y + dy) * 2
    else:
        mv_x *= 2
        mv_y *= 2

    blk = src_plane[block_y:block_y + block_size,
                    block_x:block_x + block_size]
    area = level2_area if level2 else 1
    dx, dy, sad = hme_search(blk, ref_plane,
                             block_x + mv_x, block_y + mv_y,
                             area, area)
    return mv_x + dx, mv_y + dy, sad
