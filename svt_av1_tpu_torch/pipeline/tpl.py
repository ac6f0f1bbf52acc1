"""Temporal-dependency model (TPL) -> CRF-style per-frame qindex (port of
svt_av1_tpu/pipeline/tpl.py).

The reference propagates per-16x16 dependency statistics backward over
the lookahead (tpl_mc_flow, EbRateControlProcess.c:1119: open-loop
intra/inter costs per block, mc_dep flow through the MV field, r0/beta
-> qindex scaling in cqp_qindex_calc_tpl_la:5589).

Per consecutive display pair, the batched frame ME on the encoder's
device (K5/K6 at the single shape 16x16) gives the 16x16 SAD/MV field,
and K10 each frame's per-block spatial (intra-proxy) cost, the variance
of its 16x16 blocks; the backward propagation runs on the host over the
small [nr16, nc16] grids; the output is a per-frame r0 that the rate
control turns into kf/gf boosts.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import bme

# qindex steps removed per doubling of the dependency multiplier beta
# (applied ON TOP of the per-layer ladder, so leaves stay unboosted)
QSTEP_PER_OCTAVE = 4.0
MAX_BOOST = 16          # cap (reference: kf/arf boost limits)


# --------------------------------------------------------------------------
# K10: per-16x16 source variance, plain version and wrapper
# --------------------------------------------------------------------------

def block_var16_plain(plane: torch.Tensor) -> torch.Tensor:
    """float32 [H/16, W/16]: sum((b - mean)^2) over each 16x16 block of
    ``plane`` [H, W].  The mean (sum / 256) and each deviation are exact
    in float32 and each square rounds once; the 256 squares are summed
    in one fixed order, which K10 follows: the block read column by
    column in runs of 8 rows, run j added to lane j mod 8 of 8 float32
    accumulators in turn, then the lanes folded in halves (4, 2, 1)."""
    H, W = plane.shape
    nr, nc = H // 16, W // 16
    b = plane.to(torch.int32).reshape(nr, 16, nc, 16).permute(0, 2, 1, 3)
    mean = b.sum((-1, -2), keepdim=True).to(torch.float32) / 256.0
    d = b.to(torch.float32) - mean
    sq = (d * d).transpose(-1, -2).reshape(nr, nc, 32, 8)
    acc = sq[:, :, 0]
    for j in range(1, 32):
        acc = acc + sq[:, :, j]
    for half in (4, 2, 1):
        acc = acc[..., :half] + acc[..., half:2 * half]
    return acc[..., 0].contiguous()


def block_var16(plane: torch.Tensor) -> torch.Tensor:
    """K10: per-16x16 variance sums of a uint8 plane (see
    ``block_var16_plain``).  CPU tensors take the plain version; CUDA
    tensors launch kernels/csrc/block_var16.cu."""
    if plane.device.type == "cpu":
        return block_var16_plain(plane)
    block_var16.calls += 1
    if plane.device.type != "cuda":
        raise ValueError(f"block_var16: unsupported device {plane.device}")
    if plane.dtype != torch.uint8 or plane.dim() != 2 \
            or not plane.is_contiguous():
        raise ValueError("block_var16 takes a contiguous uint8 [H, W] plane")
    H, W = plane.shape
    if H % 16 or W % 16 or H == 0 or W == 0:
        raise ValueError("block_var16: planes must be whole 16x16 blocks")
    from ..kernels.build import check_launch, cuda_lib, ptr, stream

    fn = cuda_lib("block_var16").block_var16_launch
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, I, P, P]
    out = torch.empty((H // 16, W // 16), dtype=torch.float32,
                      device=plane.device)
    err = fn(ptr(plane), H, W, ptr(out), stream(plane))
    check_launch("block_var16", err)
    block_var16.launches += 1
    return out


block_var16.launches = block_var16.calls = 0


def _pair_stats(src, ref):
    """(sad16, mv_r, mv_c) numpy grids [H/16, W/16] of one frame pair
    (open-loop, source-referenced like the reference's TPL ME): the
    batched frame ME of the device planes ``src`` and ``ref`` at the
    single shape 16x16 (K5/K6).  The pair's variance, the fourth
    statistic of the JAX package's _block16_stats, reads the source
    alone: ``tpl_gop_flow`` takes it once per frame from K10."""
    me = bme.frame_me(src, ref, shapes=((16, 16),))
    n_sby, n_sbx = me["grid"]

    def grid(a):
        return a.reshape(n_sby, n_sbx, 4, 4).permute(0, 2, 1, 3) \
            .reshape(n_sby * 4, n_sbx * 4).cpu().numpy()

    mv_r, mv_c, sad = me[(16, 16)]
    return grid(sad), grid(mv_r), grid(mv_c)


def _scatter_dep(tgt, prop, mv_r, mv_c):
    """Bilinear area-weighted deposit of ``prop`` onto the 16x16 grid of
    the reference frame through the MV field (mc_flow_dispenser's grid
    scatter)."""
    nr, nc = prop.shape
    ys = (np.arange(nr)[:, None] * 16 + mv_r).astype(np.float64)
    xs = (np.arange(nc)[None, :] * 16 + mv_c).astype(np.float64)
    y0 = np.floor(ys / 16).astype(int)
    x0 = np.floor(xs / 16).astype(int)
    fy = ys / 16 - y0
    fx = xs / 16 - x0
    for dy in (0, 1):
        wy = np.where(dy == 0, 1 - fy, fy)
        yy = np.clip(y0 + dy, 0, nr - 1)
        for dx in (0, 1):
            wx = np.where(dx == 0, 1 - fx, fx)
            xx = np.clip(x0 + dx, 0, nc - 1)
            np.add.at(tgt, (yy, xx), prop * wy * wx)


def tpl_gop_flow(frames_y, displays, buf_w: int, buf_h: int, bd: int,
                 device, include_first: bool = False) -> dict:
    """Per-display TPL r0 for one mini-GOP window.

    frames_y: luma planes in DISPLAY order; displays: the display index
    of each entry.  Each adjacent pair is measured in BOTH directions
    (forward: i predicted from i-1; backward: i predicted from i+1) and
    every frame deposits its propagated dependency through whichever
    neighbour predicts it better per block.  Chained over the window,
    forward flow credits past anchors (key frames / previous base) and
    backward flow credits the mini-GOP's own base-layer frame — the two
    anchors the dyadic pyramid actually references.

    Returns {display: r0} with r0 = intra_cost / (intra_cost + mc_dep)
    in (0, 1]; small r0 = heavily depended-on frame (generate_r0beta,
    EbSourceBasedOperationsProcess.c).  ``include_first`` also reports
    the first entry (a key frame leading its own group); otherwise the
    seed is context only.  The statistics run on the torch ``device``.
    """
    n = len(frames_y)
    min_h = bme.SB + 2 * (bme.REFINE_R + bme.MARGIN)
    if n < 2 or buf_h < min_h:
        return {}

    # half-resolution stats when the frame is large enough: TPL ranks
    # frames by aggregate dependency, which survives 2x decimation,
    # for 4x less ME work (the reference's tpl dispenser likewise runs
    # on decimated pictures at fast lad levels)
    ds = 2 if (buf_h // 2 >= min_h and buf_h % (2 * bme.SB) == 0
               and buf_w % (2 * bme.SB) == 0) else 1
    buf_w //= ds
    buf_h //= ds

    def bufal(p):
        p = np.asarray(p)
        if ds == 2:
            h2, w2 = (p.shape[0] // 2) * 2, (p.shape[1] // 2) * 2
            p32 = p[:h2, :w2].astype(np.int32)
            p = (p32.reshape(h2 // 2, 2, w2 // 2, 2).sum((1, 3)) + 2) >> 2
        a = np.zeros((buf_h, buf_w), np.int32)
        h0, w0 = min(p.shape[0], buf_h), min(p.shape[1], buf_w)
        a[:h0, :w0] = p[:h0, :w0]
        a[:h0, w0:] = a[:h0, w0 - 1:w0]
        a[h0:, :] = a[h0 - 1:h0, :]
        return a

    # each frame serves as src AND ref of adjacent pairs: one upload per
    # frame for the whole window, and one variance (it reads the source
    # only)
    planes = [torch.from_numpy(bufal(np.asarray(f)).astype(np.uint8))
              .to(device) for f in frames_y]
    # per-frame intra-cost proxy (variance)
    intra = [block_var16(p).cpu().numpy().astype(np.float64) + 1.0
             for p in planes]
    fwd = [None] * n         # i predicted from i-1
    bwd = [None] * n         # i predicted from i+1
    for i in range(n):
        if i > 0:
            sad, mv_r, mv_c = _pair_stats(planes[i], planes[i - 1])
            fwd[i] = ((sad.astype(np.float64) ** 2) / 256.0 + 1.0,
                      mv_r, mv_c)
        if i < n - 1:
            sad, mv_r, mv_c = _pair_stats(planes[i], planes[i + 1])
            bwd[i] = ((sad.astype(np.float64) ** 2) / 256.0 + 1.0,
                      mv_r, mv_c)

    nr, nc = intra[1].shape
    mc_dep = [np.zeros((nr, nc)) for _ in range(n)]
    # two chained sweeps, mirroring the decode-order property that
    # anchors are coded before the frames that reference them:
    # 1) right-to-left: dependency mass flows toward EARLIER frames
    #    through the blocks where forward prediction wins;
    # 2) left-to-right: mass flows toward LATER frames (the mini-GOP
    #    base) where backward prediction wins.
    for i in range(n - 1, 0, -1):
        ic = intra[i]
        f_cost = np.minimum(fwd[i][0], ic)
        b_cost = np.minimum(bwd[i][0], ic) if bwd[i] is not None else None
        use_f = np.ones_like(ic, bool) if b_cost is None \
            else f_cost <= b_cost
        ratio = np.clip((ic - f_cost) / ic, 0, 1) * use_f
        _scatter_dep(mc_dep[i - 1], (ic + mc_dep[i]) * ratio,
                     fwd[i][1], fwd[i][2])
    for i in range(0, n - 1):
        if bwd[i] is None:
            continue
        ic = intra[i]
        b_cost = np.minimum(bwd[i][0], ic)
        f_cost = np.minimum(fwd[i][0], ic) if fwd[i] is not None else None
        use_b = np.ones_like(ic, bool) if f_cost is None \
            else b_cost < f_cost
        ratio = np.clip((ic - b_cost) / ic, 0, 1) * use_b
        _scatter_dep(mc_dep[i + 1], (ic + mc_dep[i]) * ratio,
                     bwd[i][1], bwd[i][2])

    out = {}
    for i, d in enumerate(displays):
        if i == 0 and not include_first:
            continue                      # the seed frame is context only
        intra_sum = float(intra[i].sum())
        out[d] = intra_sum / (intra_sum + float(mc_dep[i].sum()))
    return out


def tpl_gop_offsets(frames_y, displays, buf_w: int, buf_h: int, bd: int,
                    device) -> dict:
    """Legacy qindex-offset form of :func:`tpl_gop_flow` (offset =
    -QSTEP_PER_OCTAVE * log2(1/r0), capped)."""
    r0s = tpl_gop_flow(frames_y, displays, buf_w, buf_h, bd, device)
    out = {}
    for d, r0 in r0s.items():
        boost = min(QSTEP_PER_OCTAVE * np.log2(1.0 / max(r0, 1e-9)),
                    MAX_BOOST)
        out[d] = -int(round(boost))
    return out
