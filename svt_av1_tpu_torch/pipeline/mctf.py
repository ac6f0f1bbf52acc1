"""Motion-compensated temporal filtering (alt-ref / key-frame denoise);
port of svt_av1_tpu/pipeline/mctf.py.

The analog of the reference's MCTF (EbTemporalFiltering.c: planewise
non-local-means weighting svt_av1_apply_temporal_filter_planewise_c:643,
noise estimation estimate_noise:2416, dispatched from Picture Decision
mctf_frame).  Encoder-only: the filtered picture replaces the source of
key / layer-0 pictures before encoding, so no bitstream coupling.

Per neighbor frame, motion compensation is a 32x32 block mosaic whose
MVs come from the batched frame ME on the encoder's device (K5/K6 at
the 32x32 shape), and the weight map is computed for the whole frame at
once on the host (blockwise 5x5 box sums + exp, float64, the JAX
package's arithmetic unchanged), instead of the reference's per-pixel
double loops.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import to_device, to_host
from ..ops import bme
from ..profiling import span


BLK = 32
WINDOW_BALANCE = 5          # TF_WINDOW_BLOCK_BALANCE_WEIGHT
WEIGHT_SCALE = 1000         # TF_PLANEWISE_FILTER_WEIGHT_SCALE
DIST_THRESHOLD = 0.1        # TF_SEARCH_DISTANCE_THRESHOLD
EDGE_THRESHOLD = 50
SQRT_PI_BY_2 = 1.25331413732


def estimate_noise(y: np.ndarray) -> float:
    """Sobel-gated Laplacian noise sigma (estimate_noise:2416)."""
    s = y.astype(np.int64)
    c = s[1:-1, 1:-1]
    nw, n_, ne = s[:-2, :-2], s[:-2, 1:-1], s[:-2, 2:]
    w_, e_ = s[1:-1, :-2], s[1:-1, 2:]
    sw, s_, se = s[2:, :-2], s[2:, 1:-1], s[2:, 2:]
    gx = (nw - ne) + (sw - se) + 2 * (w_ - e_)
    gy = (nw - sw) + (ne - se) + 2 * (n_ - s_)
    mask = (np.abs(gx) + np.abs(gy)) < EDGE_THRESHOLD
    lap = 4 * c - 2 * (w_ + e_ + n_ + s_) + (nw + ne + sw + se)
    num = int(mask.sum())
    if num < 16:
        return -1.0
    return float(np.abs(lap[mask]).sum()) / (6 * num) * SQRT_PI_BY_2


def _block_box5(diff: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """Per-block 5x5 window mean of squared diffs, window clipped at
    block borders (matches the CLIP in the reference's window loop)."""
    h, w = diff.shape
    nb_y, nb_x = h // bh, w // bw
    blocks = diff.reshape(nb_y, bh, nb_x, bw).transpose(0, 2, 1, 3)
    pad = np.pad(blocks.astype(np.float64), ((0, 0), (0, 0), (2, 2), (2, 2)),
                 mode="edge")
    acc = np.zeros_like(blocks, np.float64)
    for dy in range(5):
        for dx in range(5):
            acc += pad[:, :, dy:dy + bh, dx:dx + bw]
    acc /= 25.0
    return acc.transpose(0, 2, 1, 3).reshape(h, w)


def _me32(center_t, neigh_t):
    """Per-32x32-block full-pel MVs [h/32, w/32] (numpy int32) of the
    neighbour onto the centre: the batched frame ME (ops/bme.py, K5 then
    K6 on CUDA planes, their plain versions on CPU ones) with the single
    shape 32x32, in place of the reference's per-block tf motion search.
    Both planes are uint8 [h, w] tensors on one device, h and w
    multiples of 64."""
    me = bme.frame_me(center_t, neigh_t, shapes=((32, 32),))
    mv_r, mv_c, _ = me[(32, 32)]                # [N, 2, 2] per SB
    n_sby, n_sbx = me["grid"]

    def grid(a):
        return to_host(a.reshape(n_sby, n_sbx, 2, 2).permute(0, 2, 1, 3)
                       .reshape(n_sby * 2, n_sbx * 2)).numpy()

    return grid(mv_r), grid(mv_c)


def _upload(plane, device) -> torch.Tensor:
    """The plane as uint8 on ``device``, for the 32x32 ME.  At 10 bits this
    keeps each sample modulo 256, as the JAX package's device path does
    (svt_av1_tpu/pipeline/mctf.py ``_me32``, which hands its jitted ME
    ``center_y.astype(np.uint8)`` and ``ny.astype(np.uint8)``); its numpy
    twin searches the full samples, and may find other MVs.  ROADMAP.md
    section C lists this narrowing as the reference's, kept for byte
    identity; tests/test_torch_tenbit_random_access.py pins it."""
    return to_device(torch.from_numpy(np.ascontiguousarray(plane, np.uint8)),
                     device)


def _mc_blocks(center_y, mv, neigh_planes, bd):
    """Block motion compensation of the neighbor onto the center at the
    per-32x32-block MVs ``mv`` (``_me32``'s pair); returns (pred planes,
    per-block SSE map, per-block mv magnitude map) with 32x32 luma
    blocks (the reference's tf 32x32 unit).  Vectorized: fancy-indexed
    gathers (no per-block Python)."""
    h, w = center_y.shape
    nb_y, nb_x = h // BLK, w // BLK
    ny = neigh_planes[0].astype(np.int32)
    mv_r, mv_c = mv
    by = np.arange(nb_y)[:, None] * BLK
    bx = np.arange(nb_x)[None, :] * BLK
    sy = np.clip(by + mv_r, 0, h - BLK)
    sx = np.clip(bx + mv_c, 0, w - BLK)
    ar = np.arange(BLK)
    rows = sy[..., None, None] + ar[None, None, :, None]
    cols = sx[..., None, None] + ar[None, None, None, :]
    blk_pred = ny[rows, cols]                   # [nb_y, nb_x, 32, 32]
    pred_y = blk_pred.transpose(0, 2, 1, 3).reshape(h, w) \
        .astype(neigh_planes[0].dtype)
    cblk = center_y.reshape(nb_y, BLK, nb_x, BLK).transpose(0, 2, 1, 3)
    d = blk_pred.astype(np.int64) - cblk
    sse = (d * d).sum(axis=(2, 3)).astype(np.float64)
    dist = np.hypot((sy - by) * 8.0, (sx - bx) * 8.0)
    preds = [pred_y]
    hb = BLK // 2
    arc = np.arange(hb)
    for pl in (1, 2):
        cp = neigh_planes[pl]
        cy0 = sy >> 1
        cx0 = sx >> 1
        crows = cy0[..., None, None] + arc[None, None, :, None]
        ccols = cx0[..., None, None] + arc[None, None, None, :]
        cpred = cp[crows, ccols].transpose(0, 2, 1, 3) \
            .reshape(h // 2, w // 2).astype(cp.dtype)
        preds.append(cpred)
    return preds, sse, dist


def temporal_filter(center_planes, neighbor_frames, qp: int, bd: int,
                    device) -> list:
    """Filter the center picture against its neighbors; returns new
    plane list (same dtypes).  neighbor_frames: list of plane tuples.
    The motion search runs on the torch ``device``; the weighting stays
    on the host in float64."""
    h, w = center_planes[0].shape
    if h % 64 or w % 64:
        # pad to SB multiple (the batched frame ME's unit); crop at end
        ph = -(-h // 64) * 64
        pw = -(-w // 64) * 64
        with span("mctf_host"):
            center_planes = [np.pad(p, ((0, (ph - h) >> (1 if i else 0)),
                                        (0, (pw - w) >> (1 if i else 0))),
                                    mode="edge")
                             for i, p in enumerate(center_planes)]
            neighbor_frames = [[np.pad(p, ((0, (ph - h) >> (1 if i else 0)),
                                           (0, (pw - w) >> (1 if i else 0))),
                                       mode="edge")
                                for i, p in enumerate(fr)]
                               for fr in neighbor_frames]
        out = temporal_filter(center_planes, neighbor_frames, qp, bd,
                              device)
        return [o[:h >> (1 if i else 0), :w >> (1 if i else 0)]
                for i, o in enumerate(out)]

    # the device ME of every neighbour onto the centre first (the
    # centre's luma, uploaded once, serves every search), then the host
    # work in one span
    cy = center_planes[0].astype(np.int32)
    mvs = []
    if neighbor_frames:
        center_t = _upload(cy, device)
        mvs = [_me32(center_t, _upload(fr[0].astype(np.int32), device))
               for fr in neighbor_frames]
    with span("mctf_host"):
        return _filter_host(center_planes, neighbor_frames, mvs, cy, qp,
                            bd)


def _filter_host(center_planes, neighbor_frames, mvs, cy, qp: int,
                 bd: int) -> list:
    """``temporal_filter``'s host part: the block motion compensation at
    the neighbours' MVs ``mvs``, the noise estimate, the float64 weights,
    the accumulation and the normalisation."""
    h, w = cy.shape
    noise = [estimate_noise(center_planes[p]) for p in range(3)]
    noise = [max(n, 0.0) for n in noise]
    decay = 3 if (w * h) <= 854 * 480 else 4
    if qp <= 20:
        decay -= 1
    dist_thr = max(min(w, h) * DIST_THRESHOLD, 1.0)

    accum = [np.zeros(p.shape, np.float64) for p in center_planes]
    count = [np.zeros(p.shape, np.float64) for p in center_planes]

    frames = [center_planes] + list(neighbor_frames)
    for fi, fr in enumerate(frames):
        if fi == 0:
            preds = [p.astype(np.int32) for p in center_planes]
            nb = (h // BLK, w // BLK)
            sse = np.zeros(nb)
            dist = np.zeros(nb)
        else:
            preds, sse, dist = _mc_blocks(cy, mvs[fi - 1],
                                          [p.astype(np.int32) for p in fr],
                                          bd)
        diff_y = (preds[0].astype(np.int64) - cy) ** 2
        win_y = _block_box5(diff_y, BLK, BLK)
        blk_err = (sse / 1024.0)
        blk_err_map = np.repeat(np.repeat(blk_err, BLK, 0), BLK, 1)
        d_factor = np.maximum(dist / dist_thr, 1.0)
        d_map = np.repeat(np.repeat(d_factor, BLK, 0), BLK, 1)

        combined = (WINDOW_BALANCE * win_y + blk_err_map) / \
            (WINDOW_BALANCE + 1)
        n_decay = decay * (0.7 + np.log1p(noise[0]))
        scaled = np.minimum(combined * d_map / (2 * n_decay * n_decay), 7)
        wmap = np.floor(np.exp(-scaled) * WEIGHT_SCALE)
        accum[0] += wmap * preds[0]
        count[0] += wmap

        # chroma: luma 2x2 cross term + 5x5 chroma window (num = 29)
        luma22 = diff_y.reshape(h // 2, 2, w // 2, 2).sum(axis=(1, 3))
        for p in (1, 2):
            diff_c = (preds[p].astype(np.int64)
                      - center_planes[p].astype(np.int64)) ** 2
            win_c = _block_box5(diff_c, BLK // 2, BLK // 2) * 25.0
            win = (win_c + luma22) / 29.0
            blk_c = np.repeat(np.repeat(blk_err, BLK // 2, 0), BLK // 2, 1)
            d_c = np.repeat(np.repeat(d_factor, BLK // 2, 0), BLK // 2, 1)
            comb = (WINDOW_BALANCE * win + blk_c) / (WINDOW_BALANCE + 1)
            nd = decay * (0.7 + np.log1p(noise[p]))
            sc = np.minimum(comb * d_c / (2 * nd * nd), 7)
            wc = np.floor(np.exp(-sc) * WEIGHT_SCALE)
            accum[p] += wc * preds[p]
            count[p] += wc

    out = []
    for p in range(3):
        f = (accum[p] + count[p] / 2) / np.maximum(count[p], 1)
        out.append(np.clip(np.round(f), 0, (1 << bd) - 1)
                   .astype(center_planes[p].dtype))
    return out
