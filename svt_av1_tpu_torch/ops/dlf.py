"""AV1 deblocking loop filter (port of svt_av1_tpu/ops/dlf.py).

The host parts (level fit, thresholds and the edge-mask derivation
``edge_params``) are copies.  The whole-plane deblocking the JAX package
ran as a jitted program has two forms here: the plain PyTorch
``loop_filter_plane_full`` and K2, the CUDA kernel
``kernels/csrc/deblock.cu`` (``deblock``, both directions in one
launch).  The reference's per-edge-line
host filter ``loop_filter_plane`` belongs to its decoder and host paths,
which are not ported.

Notes of the reference module:

Edge-parallel formulation: the frame is two passes (all vertical edges,
then all horizontal edges), which is order-equivalent to the reference's
per-superblock interleave because vertical filters never read
horizontal-filter output and modification spans of successive edges do
not overlap.

Behavioral parity: masks/filters EbDeblockingCommon.c (filter_mask*:148,
filter4:222, filter6:283, filter8:298, filter14:810, thresholds
update_sharpness:587), edge walk EbDecLF.c.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

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



# --------------------------------------------------------------------------
# Plain PyTorch version of the full-plane device formulation: every
# vertical (then horizontal) edge filters in one batched pass from the
# un-filtered plane of that pass; edges never modify the same sample (the
# geometry guarantees non-overlap), so "changed samples win" merges them
# into exactly the sequential result.  Per-edge parameters arrive as
# [y4, n_edge] masks from edge_params.
# --------------------------------------------------------------------------

def _tsc(x, shift):
    """signed_char_clamp (bd-scaled) on int32 tensors."""
    return x.clamp(-128 << shift, (128 << shift) - 1)


def _tfilter4(p, q, mask, thresh, shift):
    """4-tap filter applied where mask; returns modified copies."""
    t80 = 128 << shift
    p0, p1 = p[..., 6], p[..., 5]
    q0, q1 = q[..., 0], q[..., 1]
    hev = ((p1 - p0).abs() > thresh) | ((q1 - q0).abs() > thresh)
    ps1, ps0 = p1 - t80, p0 - t80
    qs0, qs1 = q0 - t80, q1 - t80
    zero = torch.zeros_like(p0)
    f = torch.where(hev, _tsc(ps1 - qs1, shift), zero)
    f = torch.where(mask, _tsc(f + 3 * (qs0 - ps0), shift), zero)
    f1 = _tsc(f + 4, shift) >> 3
    f2 = _tsc(f + 3, shift) >> 3
    oq0 = _tsc(qs0 - f1, shift) + t80
    op0 = _tsc(ps0 + f2, shift) + t80
    fo = torch.where(~hev, (f1 + 1) >> 1, zero)
    oq1 = _tsc(qs1 - fo, shift) + t80
    op1 = _tsc(ps1 + fo, shift) + t80
    fp, fq = p.clone(), q.clone()
    fp[..., 6] = torch.where(mask, op0, p0)
    fp[..., 5] = torch.where(mask, op1, p1)
    fq[..., 0] = torch.where(mask, oq0, q0)
    fq[..., 1] = torch.where(mask, oq1, q1)
    return fp, fq


def _tfilter_line(p, q, blimit, limit, thresh, size, shift):
    """Filter a batch of edge lines: p [..., 7] (p6..p0), q [..., 7]
    (q0..q6).  Returns filtered (p, q) copies; ``size`` in {4,6,8,14}."""
    p0, p1, p2, p3 = p[..., 6], p[..., 5], p[..., 4], p[..., 3]
    q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ad = lambda a, b: (a - b).abs()         # noqa: E731
    edge = (ad(p0, q0) * 2 + ad(p1, q1) // 2) <= blimit
    if size == 4:
        mask = (ad(p1, p0) <= limit) & (ad(q1, q0) <= limit) & edge
        return _tfilter4(p, q, mask, thresh, shift)
    fth = 1 << shift
    if size == 6:
        mask = ((ad(p2, p1) <= limit) & (ad(p1, p0) <= limit)
                & (ad(q1, q0) <= limit) & (ad(q2, q1) <= limit) & edge)
        flat = ((ad(p1, p0) <= fth) & (ad(q1, q0) <= fth)
                & (ad(p2, p0) <= fth) & (ad(q2, q0) <= fth))
        fp, fq = _tfilter4(p, q, mask & ~flat, thresh, shift)
        sel = mask & flat
        vals = ((fp, 5, (p2 * 3 + p1 * 2 + p0 * 2 + q0 + 4) >> 3),
                (fp, 6, (p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + 4) >> 3),
                (fq, 0, (p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + 4) >> 3),
                (fq, 1, (p0 + q0 * 2 + q1 * 2 + q2 * 3 + 4) >> 3))
        for arr, i, v in vals:
            arr[..., i] = torch.where(sel, v, arr[..., i])
        return fp, fq
    mask = ((ad(p3, p2) <= limit) & (ad(p2, p1) <= limit)
            & (ad(p1, p0) <= limit) & (ad(q1, q0) <= limit)
            & (ad(q2, q1) <= limit) & (ad(q3, q2) <= limit) & edge)
    flat = ((ad(p1, p0) <= fth) & (ad(q1, q0) <= fth)
            & (ad(p2, p0) <= fth) & (ad(q2, q0) <= fth)
            & (ad(p3, p0) <= fth) & (ad(q3, q0) <= fth))
    fp, fq = _tfilter4(p, q, mask & ~flat, thresh, shift)
    sel8 = mask & flat
    vals8 = ((fp, 4, (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3),
             (fp, 5, (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3),
             (fp, 6, (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3),
             (fq, 0, (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3),
             (fq, 1, (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3),
             (fq, 2, (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3))
    if size == 8:
        for arr, i, v in vals8:
            arr[..., i] = torch.where(sel8, v, arr[..., i])
        return fp, fq
    p4, p5, p6 = p[..., 2], p[..., 1], p[..., 0]
    q4, q5, q6 = q[..., 4], q[..., 5], q[..., 6]
    flat2 = ((ad(p6, p0) <= fth) & (ad(p5, p0) <= fth)
             & (ad(p4, p0) <= fth) & (ad(q4, q0) <= fth)
             & (ad(q5, q0) <= fth) & (ad(q6, q0) <= fth))
    sel8_only = sel8 & ~flat2
    for arr, i, v in vals8:
        arr[..., i] = torch.where(sel8_only, v, arr[..., i])
    sel14 = sel8 & flat2
    vals14 = (
        (fp, 1, (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0 + 8) >> 4),
        (fp, 2, (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0
                 + q1 + 8) >> 4),
        (fp, 3, (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0
                 + q1 + q2 + 8) >> 4),
        (fp, 4, (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0
                 + q1 + q2 + q3 + 8) >> 4),
        (fp, 5, (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0
                 + q1 + q2 + q3 + q4 + 8) >> 4),
        (fp, 6, (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1
                 + q2 + q3 + q4 + q5 + 8) >> 4),
        (fq, 0, (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2
                 + q3 + q4 + q5 + q6 + 8) >> 4),
        (fq, 1, (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3
                 + q4 + q5 + q6 * 2 + 8) >> 4),
        (fq, 2, (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4
                 + q5 + q6 * 3 + 8) >> 4),
        (fq, 3, (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5
                 + q6 * 4 + 8) >> 4),
        (fq, 4, (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2
                 + q6 * 5 + 8) >> 4),
        (fq, 5, (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7 + 8)
         >> 4),
    )
    for arr, i, v in vals14:
        arr[..., i] = torch.where(sel14, v, arr[..., i])
    return fp, fq


def _edge_filter_batch(p, q, apply_m, fsize, blimit, limit, thresh,
                       shift):
    """Filter a batch of edges with per-position apply/fsize; returns
    (new_p, new_q)."""
    out_p, out_q = p.clone(), q.clone()
    for size in (4, 6, 8, 14):
        sel = (apply_m & (fsize == size))[..., None]
        fp, fq = _tfilter_line(p, q, blimit, limit, thresh, size, shift)
        out_p = torch.where(sel, fp, out_p)
        out_q = torch.where(sel, fq, out_q)
    return out_p, out_q


@functools.cache
def thresholds(level: int, sharpness: int, shift: int):
    """(blimit, limit, thresh) of one level, bd-scaled."""
    bl, lim, hev = _thresholds(level, sharpness)
    return int(bl) << shift, int(lim) << shift, int(hev) << shift


def _merge(orig, fp, fq, po, qo, n_units: int, n_e: int):
    """Changed samples win: orig [X, 4 * n_units] (X lines), fp/fq/po/qo
    [X, n_e, 7] filtered and original p/q of edges at 4 * (e + 1)."""
    X = orig.shape[0]
    U = orig.reshape(X, n_units, 4).clone()
    # sample 4u + r has up to four writers: p of edges u / u + 1 and q of
    # edges u - 1 / u - 2 (an edge e sits at 4 * (e + 1))
    for r in range(4):
        col = U[:, :, r]
        cand = [(fp[..., r + 3], po[..., r + 3], 0),
                (fq[..., r], qo[..., r], -1)]
        if r >= 1:
            cand.append((fp[..., r - 1], po[..., r - 1], 1))
        if r <= 2:
            cand.append((fq[..., r + 4], qo[..., r + 4], -2))
        for vals, orig_v, off in cand:
            zv = torch.zeros((X, n_units), dtype=torch.int32,
                             device=orig.device)
            zo = torch.zeros_like(zv)
            if off >= 0:
                w = min(n_e - off, n_units)
                zv[:, :w] = vals[:, off:off + w]
                zo[:, :w] = orig_v[:, off:off + w]
            else:
                w = min(n_e, n_units + off)
                zv[:, -off:-off + w] = vals[:, :w]
                zo[:, -off:-off + w] = orig_v[:, :w]
            col = torch.where(zv != zo, zv, col)
        U[:, :, r] = col
    return U.reshape(X, 4 * n_units)


def loop_filter_plane_full(plane, apply_v, fsize_v, apply_h, fsize_h,
                           width: int, height: int, level_v: int,
                           level_h: int, sharpness: int, bd: int = 8):
    """Batched whole-plane DLF (plain PyTorch); bit-exact with the
    reference's per-edge-line loop_filter_plane.  Returns a new int32
    plane."""
    shift = bd - 8
    x4max = (width + 3) >> 2
    y4max = (height + 3) >> 2
    dev = plane.device
    P = torch.nn.functional.pad(plane.to(torch.int32), (PADF,) * 4)
    apply_v, fsize_v, apply_h, fsize_h = (
        torch.as_tensor(a, device=dev) for a in (apply_v, fsize_v, apply_h,
                                                 fsize_h))
    if level_v > 0 and x4max > 1:
        bl, lim, hev = thresholds(level_v, sharpness, shift)
        n_e = x4max - 1
        Hv = y4max * 4
        rows = P[PADF:PADF + Hv]
        p = torch.stack([rows[:, PADF - 3 + k: PADF - 3 + k + 4 * n_e: 4]
                         for k in range(7)], dim=-1)
        q = torch.stack([rows[:, PADF + 4 + k: PADF + 4 + k + 4 * n_e: 4]
                         for k in range(7)], dim=-1)
        am = apply_v.bool().repeat_interleave(4, 0)[:Hv]
        fs = fsize_v.to(torch.int32).repeat_interleave(4, 0)[:Hv]
        fp, fq = _edge_filter_batch(p, q, am, fs, bl, lim, hev, shift)
        inner = P[PADF:PADF + Hv, PADF:PADF + 4 * x4max]
        P[PADF:PADF + Hv, PADF:PADF + 4 * x4max] = _merge(
            inner, fp, fq, p, q, x4max, n_e)
    if level_h > 0 and y4max > 1:
        bl, lim, hev = thresholds(level_h, sharpness, shift)
        n_e = y4max - 1
        Wv = x4max * 4
        cols = P[:, PADF:PADF + Wv].t()
        p = torch.stack([cols[:, PADF - 3 + k: PADF - 3 + k + 4 * n_e: 4]
                         for k in range(7)], dim=-1)
        q = torch.stack([cols[:, PADF + 4 + k: PADF + 4 + k + 4 * n_e: 4]
                         for k in range(7)], dim=-1)
        am = apply_h.bool().repeat_interleave(4, 1)[:, :Wv].t()
        fs = fsize_h.to(torch.int32).repeat_interleave(4, 1)[:, :Wv].t()
        fp, fq = _edge_filter_batch(p, q, am, fs, bl, lim, hev, shift)
        inner = P[PADF:PADF + 4 * y4max, PADF:PADF + Wv].t()
        P[PADF:PADF + 4 * y4max, PADF:PADF + Wv] = _merge(
            inner, fp, fq, p, q, y4max, n_e).t()
    return P[PADF:PADF + plane.shape[0], PADF:PADF + plane.shape[1]]\
        .contiguous()


# --------------------------------------------------------------------------
# K2: the CUDA deblocking kernel and its wrapper
# --------------------------------------------------------------------------

def deblock(plane, apply_v, fsize_v, apply_h, fsize_h, width: int,
            height: int, level_v: int, level_h: int, sharpness: int,
            bd: int = 8):
    """K2: whole-plane deblocking (vertical edges, then horizontal), out of
    place.  CPU tensors take loop_filter_plane_full; CUDA tensors launch
    the kernel once for both directions.

    The plane must hold samples in [0, 2^bd), as every reconstruction
    does (bd 8..12).  The kernel keeps samples as 16-bit values and does
    not look at their range: a plane with samples outside [0, 32767]
    gives a wrong result on the card, where the plain version takes any
    int32 values."""
    if plane.device.type == "cpu":
        return loop_filter_plane_full(plane, apply_v, fsize_v, apply_h,
                                      fsize_h, width, height, level_v,
                                      level_h, sharpness, bd)
    deblock.calls += 1
    if plane.device.type != "cuda":
        raise ValueError(f"unsupported device {plane.device}")
    if plane.dtype != torch.int32 or plane.dim() != 2 \
            or not plane.is_contiguous():
        raise ValueError("deblock takes a contiguous int32 [H, W] plane")
    x4max = (width + 3) >> 2
    y4max = (height + 3) >> 2
    H, W = plane.shape
    if 4 * y4max > H or 4 * x4max > W:
        raise ValueError("visible size exceeds the plane")
    masks = []
    for a, shape in ((apply_v, (y4max, x4max - 1)),
                     (fsize_v, (y4max, x4max - 1)),
                     (apply_h, (y4max - 1, x4max)),
                     (fsize_h, (y4max - 1, x4max))):
        # the encoder's masks are already uint8 on the card (plane_params)
        if not (isinstance(a, torch.Tensor) and a.dtype == torch.uint8
                and a.is_cuda and a.is_contiguous()):
            a = torch.as_tensor(np.asarray(a, np.uint8)) \
                if not isinstance(a, torch.Tensor) else a
            a = a.to(device=plane.device, dtype=torch.uint8).contiguous()
        if a.shape != shape or a.get_device() != plane.get_device():
            raise ValueError(f"edge mask shape {tuple(a.shape)} != {shape} "
                             f"or on another device than the plane")
        masks.append(a)
    from ..kernels.build import check_launch, cuda_fn, ptr, stream

    shift = bd - 8
    tv = thresholds(level_v, sharpness, shift) if level_v > 0 else (0,) * 3
    th = thresholds(level_h, sharpness, shift) if level_h > 0 else (0,) * 3
    out = torch.empty_like(plane)
    fn = cuda_fn("deblock", "deblock_launch",
                 (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 13
                 + (ctypes.c_void_p,))
    err = fn(ptr(plane), ptr(out), *(ptr(m) for m in masks), H, W, x4max,
             y4max, int(level_v > 0), *tv, int(level_h > 0), *th, shift,
             stream(plane))
    check_launch("deblock", err)
    deblock.launches += 1
    return out


deblock.launches = deblock.calls = 0


# --------------------------------------------------------------------------
# Level search + apply (the fused chain's DLF stage and the standalone
# encoder entry): luma SSE over {L/2, L, 3L/2} and "off", exact int64
# --------------------------------------------------------------------------

def level_candidates(base_level: int) -> list:
    return sorted({max(base_level // 2, 1), max(base_level, 1),
                   min(3 * base_level // 2, MAX_LOOP_FILTER)})


def search_apply(planes, src_y, params, vis_dims, cands, sharpness: int,
                 bd: int):
    """planes: 3 int32 device tensors; src_y: the luma source tensor;
    params: per plane (apply_v, fsize_v, apply_h, fsize_h).  Returns
    (filtered planes, level); the winner is the first minimum of the
    luma SSE (no filter first)."""
    vw, vh = vis_dims[0]
    y = planes[0]
    src = src_y[:vh, :vw].to(torch.int64)

    def sse(a):
        d = a[:vh, :vw].to(torch.int64) - src
        return (d * d).sum()

    sses = [sse(y)]
    filtered = [y]
    for lv in cands:
        fy = deblock(y, *params[0], vw, vh, lv, lv, sharpness, bd)
        sses.append(sse(fy))
        filtered.append(fy)
    best = int(torch.argmin(torch.stack(sses)))
    level = 0 if best == 0 else cands[best - 1]
    out = [filtered[best]]
    for p in (1, 2):
        vw_c, vh_c = vis_dims[p]
        out.append(planes[p] if best == 0 else deblock(
            planes[p], *params[p], vw_c, vh_c, level, level, sharpness, bd))
    return out, level


def plane_params(grids, vis_dims, device):
    """edge_params of the three planes as uint8 tensors on ``device``."""
    out = []
    for p in range(3):
        vw, vh = vis_dims[p]
        tx_w, tx_h, skip, bex, bey = grids[p]
        out.append(tuple(
            torch.from_numpy(np.ascontiguousarray(a, np.uint8)).to(device)
            for a in edge_params(tx_w, tx_h, skip, bex, bey, vw, vh,
                                 p > 0)))
    return out


def dlf_search_apply_device(planes, source_y, grids, vis_dims,
                            base_level: int, sharpness: int, bd: int = 8):
    """Search {L/2, L, 3L/2} (+ off) on luma SSE and apply the winner to
    all planes on the device of ``source_y`` (a tensor).  grids: per
    plane (tx_w, tx_h, skip, bex, bey); vis_dims: per plane (vw, vh).
    Returns (filtered int32 numpy planes, level)."""
    dev = source_y.device
    recon = [torch.from_numpy(np.ascontiguousarray(p, np.int32)).to(dev)
             for p in planes[:3]]
    out, level = search_apply(recon, source_y,
                              plane_params(grids, vis_dims, dev), vis_dims,
                              level_candidates(base_level), sharpness, bd)
    return [o.cpu().numpy() for o in out], level
