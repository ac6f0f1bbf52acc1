"""Open-loop batched intra mode decision (port of svt_av1_tpu/ops/omd.py).

For a whole frame at once, per block shape, prediction edges come from
the SOURCE picture; every intra mode is scored over the ``[n_rows,
n_cols]`` block grid (prediction, orthonormal DCT, a float model of
quantize_b, Parseval SSE + a rate proxy) and per-block best-mode/cost
maps come out.  The conformant coding pass then replays the decisions.

Two forms of the same function:

* the plain PyTorch version (``intra_decision_arrays`` and its parts,
  with the JAX package's names and ``[nr, nc, ...]`` layouts), taken for
  CPU tensors;
* K1, the hand-written CUDA kernel ``kernels/csrc/intra_decision.cu``,
  launched by ``intra_decision_packed`` for CUDA tensors: one launch for
  all the shapes of a plane, one packed output (``unpack_decisions``);
  ``intra_decision`` is its one-shape form.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..constants import PredictionMode, TxSize, TxType, TX_WIDTH, TX_HEIGHT
from ..device import SAMPLE_DTYPES, resolve_device, to_device, to_host
from . import intra as intra_ops
from . import quant as qz
from . import transforms as tf

# pad applied around the source plane before edge gathering; covers the
# deepest top-right/bottom-left reach (w + h for 32x32) plus the -1 edge
PAD = 72

ALL_MODES = tuple(PredictionMode(m) for m in range(13))

# candidate block shapes (w, h); squares first, then the rectangular
# HORZ/VERT halves the partition DP composes
SQUARE_SHAPES = ((8, 8), (16, 16), (32, 32))
RECT_SHAPES = ((16, 8), (8, 16), (32, 16), (16, 32))
ALL_SHAPES = SQUARE_SHAPES + RECT_SHAPES
# inter-only shapes (inter frames code up to 64x64 NONE; intra stays at
# most 32); the inter pass scores its residual on all of INTER_SHAPES
BIG_SHAPES = ((64, 64), (64, 32), (32, 64))
INTER_SHAPES = ALL_SHAPES + BIG_SHAPES

# coefficient-rate proxy weights (bits ~ A*nnz + B*sum(log2(1+|q|)) + C)
RATE_NNZ = 2.724
RATE_MAG = 1.061
RATE_TXB = 36.242

# the directional modes the kernel predicts from tap tables
DIR_MODES = tuple(PredictionMode(m) for m in range(3, 9))


def txsize_for(w: int, h: int) -> TxSize:
    for ts in TxSize:
        if TX_WIDTH[ts] == w and TX_HEIGHT[ts] == h:
            return ts
    raise ValueError((w, h))


# --------------------------------------------------------------------------
# Host constants (copied from the reference module)
# --------------------------------------------------------------------------

@functools.cache
def _dir_matrices(mode: PredictionMode, w: int, h: int):
    """Constant weight matrices (above, left): [w+h+1, h*w] float32 with
    index 0 = the corner sample, such that
    pred = floor((above @ Wa + left @ Wl + 16) / 32)
    reproduces dr_predictor_z1/z2/z3 with upsample 0 bit-exactly."""
    angle = intra_ops.MODE_TO_ANGLE[mode]
    L = w + h + 1
    r = np.arange(h).reshape(h, 1)
    c = np.arange(w).reshape(1, w)
    max_base = w + h - 1
    wa = np.zeros((L, h * w), np.float32)
    wl = np.zeros((L, h * w), np.float32)
    pos = (r * w + c)                       # flat output position
    if angle < 90:
        dx = intra_ops.get_dx(angle)
        x = np.broadcast_to((r + 1) * dx, (h, w))
        base = (x >> 6) + c
        shift = (x & 0x3F) >> 1
        for i in range(h):
            for j in range(w):
                p = int(pos[i, j])
                if base[i, j] >= max_base:
                    wa[1 + max_base, p] += 32
                else:
                    wa[1 + base[i, j], p] += 32 - shift[i, j]
                    wa[1 + min(base[i, j] + 1, max_base), p] += shift[i, j]
        return wa, None
    if angle > 180:
        dy = intra_ops.get_dy(angle)
        y = np.broadcast_to((c + 1) * dy, (h, w))
        base = (y >> 6) + r
        shift = (y & 0x3F) >> 1
        for i in range(h):
            for j in range(w):
                p = int(pos[i, j])
                if base[i, j] >= max_base:
                    wl[1 + max_base, p] += 32
                else:
                    wl[1 + base[i, j], p] += 32 - shift[i, j]
                    wl[1 + min(base[i, j] + 1, max_base), p] += shift[i, j]
        return None, wl
    dx, dy = intra_ops.get_dx(angle), intra_ops.get_dy(angle)
    x = np.broadcast_to(-(r + 1) * dx, (h, w))
    base1 = (x >> 6) + c
    shift1 = (x & 0x3F) >> 1
    y = np.broadcast_to((r << 6) - (c + 1) * dy, (h, w))
    base2 = y >> 6
    shift2 = (y & 0x3F) >> 1
    for i in range(h):
        for j in range(w):
            p = int(pos[i, j])
            if base1[i, j] >= -1:
                b = int(np.clip(base1[i, j], -1, max_base))
                wa[b + 1, p] += 32 - shift1[i, j]
                wa[b + 2, p] += shift1[i, j]
            else:
                b = int(np.clip(base2[i, j], -1, max_base))
                wl[b + 1, p] += 32 - shift2[i, j]
                wl[b + 2, p] += shift2[i, j]
    return wa, wl


@functools.cache
def _dct_mat(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix [n, n] (rows = frequencies)."""
    k = np.arange(n)
    m = np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
    m *= np.sqrt(2.0 / n)
    m[0] *= np.sqrt(0.5)
    return m.astype(np.float32)


@functools.cache
def _tx_gain(w: int, h: int) -> float:
    """Gain of the integer AV1 forward DCT vs the orthonormal one
    (maps the quantizer tables into the unit-DCT domain)."""
    rng = np.random.default_rng(12345)
    r = rng.integers(-255, 256, (8, h, w)).astype(np.int32)
    ci = np.asarray(tf.fwd_txfm2d(r, TxType.DCT_DCT, txsize_for(w, h),
                                  8, np))
    cu = _dct_mat(h).astype(np.float64) @ r.astype(np.float64) \
        @ _dct_mat(w).astype(np.float64).T
    lh, lw = min(h, 32), min(w, 32)
    return float(np.sqrt((ci[:, :lh, :lw].astype(np.float64) ** 2).sum()
                         / (cu[:, :lh, :lw] ** 2).sum()))


def _quant_scalars(w: int, h: int, qindex: int, pq: qz.PlaneQuant):
    """(zbin, round, step) as (dc, ac) float32 pairs in the unit-DCT
    domain, modeling quantize_b (EbFullLoop.c:37 zbin deadzone)."""
    ts = txsize_for(w, h)
    g = np.float32(_tx_gain(w, h) * (1 << qz.tx_log_scale(ts)))
    return tuple(tuple(np.float32(v) / g
                       for v in table.astype(np.float32)[qindex])
                 for table in (pq.zbin, pq.round, pq.dequant))


def _quant_maps(w: int, h: int, qindex: int, pq: qz.PlaneQuant):
    """(zbin, round, step) per-position float32 maps [h, w] (the DC
    position carries the DC value)."""
    out = []
    for dc, ac in _quant_scalars(w, h, qindex, pq):
        m = np.full((h, w), ac, np.float32)
        m[0, 0] = dc
        out.append(m)
    return tuple(out)


# --------------------------------------------------------------------------
# Near-boundary coefficients in float64 (shared by K1, K8 and their plain
# versions)
# --------------------------------------------------------------------------

# The kernels sum the DCT products in another order than the plain
# versions (3xTF32 tensor-core products against SGEMM), so a coefficient
# within float32 noise of a quantizer decision point could land on the
# other side in one of them.  Both therefore recompute every coefficient
# that lies within a margin delta of the dead zone ``zbin`` or of a point
# where floor((ac + rnd) / step) changes, in float64, from the block's
# integer residual and the float32 DCT matrices widened to float64, and
# decide it from that value rounded to float32.
#
# delta bounds |cf_kernel - cf_plain|: a float32 product C = D_h R D_w^T
# of K-term sums (two products: K = h + w; the tensor cores' TF32 splits
# add about 24 more terms' worth, the dropped small x small parts and the
# small parts' own TF32 rounding) rounds K times at 2^-24 of partial sums
# bounded by sum |D_h||R||D_w| <= max|D_h| max|D_w| sum|R| = 2 / sqrt(h w)
# * S, S = sum |R| of the block.  The rounding errors add like a random
# walk, about sqrt(K) * 2^-24 of that; a factor 4 covers both sides:
#     delta = 4 * sqrt(h + w + 24) * 2^-24 * 2 / sqrt(h w) * S
# (for a 32x32 block of residuals of 10 in magnitude, 0.0014).  The
# worst case, K * 2^-24 (3 * (h + w + 24) for both sides), is 7-10 times
# larger, and its recomputes took K1 a third of its time on the card
# (PERF.md); the measured float32 errors stay below delta / 8
# (tests/test_torch_omd.py).
NEAR_FACTOR = 4.0
NEAR_TF32_TERMS = 24

# counters of the plain versions' near-boundary recomputes and of the
# coefficients they decide as coded (chip_smoke.py prints both)
NEAR_STATS = {"near": 0, "coded": 0}


@functools.cache
def near_margin(w: int, h: int) -> np.float32:
    """delta per unit of the block's sum |R| (float32; the kernels compute
    the same double expression in the same order)."""
    return np.float32(NEAR_FACTOR * math.sqrt(w + h + NEAR_TF32_TERMS)
                      * 2.0 ** -24 * 2.0 / math.sqrt(w * h))


def near_mask(ac, s_abs, zbin, rnd, step, w: int, h: int):
    """Which coefficients of |cf| ``ac`` [..., h, w] lie within delta of a
    decision point: |ac - zbin| < delta, or ac >= zbin and the quotient t
    = (ac + rnd) / step within delta / step of an integer (float32
    throughout, as the kernels test it).  ``s_abs`` [...] is each block's
    sum |R|."""
    delta = (s_abs.to(torch.float32) * float(near_margin(w, h)))[..., None,
                                                                  None]
    t = (ac + rnd) / step
    return ((ac - zbin).abs() < delta) | (
        (ac >= zbin) & ((t - torch.round(t)).abs() * step < delta))


def decide_near_boundary(cf, resid, dh, dwt, zbin, rnd, step, w: int,
                         h: int, band=None):
    """|cf| with its near-boundary coefficients (``near_mask``, inside the
    coded ``band`` [h, w] where given) recomputed in float64 from the
    integer residual ``resid`` [..., h, w] and the float32 DCT matrices
    ``dh`` [h, h], ``dwt`` [w, w] widened, then rounded to float32."""
    ac = cf.abs()
    near = near_mask(ac, resid.abs().sum(dim=(-1, -2)), zbin, rnd, step, w,
                     h)
    coded = ac >= zbin
    if band is not None:
        near &= band
        coded &= band
    n_near = int(near.sum())
    NEAR_STATS["near"] += n_near
    NEAR_STATS["coded"] += int(coded.sum())
    if n_near == 0:
        return ac
    lead = ac.shape[:-2]
    flat_ac = ac.reshape(-1, h, w).clone()
    flat_near = near.reshape(-1, h, w)
    blocks = flat_near.any(dim=(-1, -2)).nonzero()[:, 0]
    r64 = resid.reshape(-1, h, w)[blocks].to(torch.float64)
    c64 = dh.to(torch.float64) @ r64 @ dwt.to(torch.float64)
    flat_ac[blocks] = torch.where(flat_near[blocks],
                                  c64.abs().to(torch.float32),
                                  flat_ac[blocks])
    return flat_ac.reshape(*lead, h, w)


# --------------------------------------------------------------------------
# Plain PyTorch version
# --------------------------------------------------------------------------

def pad_plane(plane: torch.Tensor) -> torch.Tensor:
    """Edge-replicated pad by PAD on every side, int32."""
    H, W = plane.shape
    dev = plane.device
    ys = torch.arange(-PAD, H + PAD, device=dev).clamp(0, H - 1)
    xs = torch.arange(-PAD, W + PAD, device=dev).clamp(0, W - 1)
    return plane.to(torch.int32)[ys][:, xs]


def grid_edges(padded: torch.Tensor, w: int, h: int, buf_w: int,
               buf_h: int):
    """Edges for every (w, h) block tiling the [buf_h, buf_w] plane:
    (above, left) int32 [nr, nc, w + h + 1], [..., 0] the top-left
    neighbor and [..., 1:] the above row / left column extended to the
    top-right / bottom-left reach."""
    nr, nc = buf_h // h, buf_w // w
    L = w + h + 1
    rows = padded[PAD - 1: PAD - 1 + nr * h: h, :]
    above = torch.stack(
        [rows[:, PAD - 1 + k: PAD - 1 + k + nc * w: w] for k in range(L)],
        dim=-1)
    cols = padded[:, PAD - 1: PAD - 1 + nc * w: w]
    left = torch.stack(
        [cols[PAD - 1 + k: PAD - 1 + k + nr * h: h, :] for k in range(L)],
        dim=-1)
    return above, left


def grid_blocks(padded: torch.Tensor, w: int, h: int, buf_w: int,
                buf_h: int) -> torch.Tensor:
    """Source pixels per block: int32 [nr, nc, h, w]."""
    nr, nc = buf_h // h, buf_w // w
    inner = padded[PAD:PAD + buf_h, PAD:PAD + buf_w]
    return inner.reshape(nr, h, nc, w).permute(0, 2, 1, 3)


def predict_mode(mode: PredictionMode, above: torch.Tensor,
                 left: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """Batched prediction [..., h, w] for one mode (angle delta 0,
    open-loop edges: no intra edge filter / upsample)."""
    a = above[..., 1:]
    l = left[..., 1:]
    lead = above.shape[:-1]
    if mode == PredictionMode.DC_PRED:
        s = a[..., :w].sum(-1) + l[..., :h].sum(-1)
        dc = (s + ((w + h) >> 1)) // (w + h)
        return dc[..., None, None].expand(*lead, h, w).to(torch.int32)
    if mode == PredictionMode.V_PRED:
        return a[..., None, :w].expand(*lead, h, w).to(torch.int32)
    if mode == PredictionMode.H_PRED:
        return l[..., :h, None].expand(*lead, h, w).to(torch.int32)
    if mode == PredictionMode.PAETH_PRED:
        av = a[..., None, :w]
        lv = l[..., :h, None]
        tl = above[..., 0][..., None, None]
        base = av + lv - tl
        pa = (base - av).abs()
        pl = (base - lv).abs()
        ptl = (base - tl).abs()
        z = torch.zeros(base.shape, dtype=torch.int32, device=base.device)
        return torch.where((pa <= pl) & (pa <= ptl), av + z,
                           torch.where(pl <= ptl, lv + z, tl + z)
                           ).to(torch.int32)
    if mode in (PredictionMode.SMOOTH_PRED, PredictionMode.SMOOTH_V_PRED,
                PredictionMode.SMOOTH_H_PRED):
        sw = intra_ops._sm_weights()
        dev = above.device
        av = a[..., None, :w]
        lv = l[..., :h, None]
        below = l[..., h - 1][..., None, None]
        right = a[..., w - 1][..., None, None]
        wh = to_device(torch.as_tensor(
            sw[h:h + h].reshape(h, 1).astype(np.int32)), dev)
        ww = to_device(torch.as_tensor(
            sw[w:w + w].reshape(1, w).astype(np.int32)), dev)
        if mode == PredictionMode.SMOOTH_PRED:
            p = av * wh + below * (256 - wh) + lv * ww + right * (256 - ww)
            return ((p + 256) >> 9).to(torch.int32)
        if mode == PredictionMode.SMOOTH_V_PRED:
            return ((av * wh + below * (256 - wh) + 128) >> 8
                    ).to(torch.int32)
        return ((lv * ww + right * (256 - ww) + 128) >> 8).to(torch.int32)
    # directional: the 2-tap interpolation along the angle is a constant
    # linear map of the edge vectors, two float32 products that stay exact
    # integers (TF32 off, device.py)
    wa, wl = _dir_matrices(mode, w, h)
    acc = 0.0
    if wa is not None:
        acc = above.to(torch.float32) @ to_device(torch.as_tensor(wa),
                                                  above.device)
    if wl is not None:
        acc = acc + left.to(torch.float32) @ to_device(torch.as_tensor(wl),
                                                       left.device)
    pred = torch.floor((acc + 16.0) * (1.0 / 32.0))
    return pred.reshape(*lead, h, w).to(torch.int32)


def shape_costs(src_blocks, above, left, w: int, h: int, qindex: int,
                pq: qz.PlaneQuant, lam: float, mode_bits):
    """Best intra mode per block of one (w, h) grid: (best_mode [nr, nc]
    int32, best_cost [nr, nc] float32); cost = pixel-domain SSE of the
    modeled quantized recon (Parseval) + lam * (coeff-rate proxy + mode
    signaling bits)."""
    dev = src_blocks.device
    zbin, rnd, step = (to_device(torch.as_tensor(m), dev)
                       for m in _quant_maps(w, h, qindex, pq))
    mb = to_device(torch.as_tensor(np.asarray(mode_bits, np.float32)), dev)
    dh = to_device(torch.as_tensor(_dct_mat(h)), dev)
    dwt = to_device(torch.as_tensor(np.ascontiguousarray(_dct_mat(w).T)),
                    dev)
    best_cost = None
    best_mode = None
    for mi, mode in enumerate(ALL_MODES):
        pred = predict_mode(mode, above, left, w, h)
        resid = src_blocks - pred
        cf = dh @ resid.to(torch.float32) @ dwt
        ac = decide_near_boundary(cf, resid, dh, dwt, zbin, rnd, step, w, h)
        q = torch.floor((ac + rnd) / step)
        q = torch.where(ac >= zbin, q.clamp_min(0.0), 0.0)
        err = ac - q * step
        sse = (err * err).sum(dim=(-1, -2))
        nnz = (q > 0).sum(dim=(-1, -2)).to(torch.float32)
        mag = torch.log2(1.0 + q).sum(dim=(-1, -2))
        bits = RATE_NNZ * nnz + RATE_MAG * mag \
            + RATE_TXB * (nnz > 0).to(torch.float32) + mb[mi]
        cost = sse + lam * bits
        if best_cost is None:
            best_cost = cost
            best_mode = torch.zeros(cost.shape, dtype=torch.int32,
                                    device=dev)
        else:
            take = cost < best_cost
            best_cost = torch.where(take, cost, best_cost)
            best_mode = torch.where(take, torch.full_like(best_mode, mi),
                                    best_mode)
    return best_mode, best_cost


def pad_stripe(stripe: torch.Tensor, above_row: torch.Tensor,
               halo: torch.Tensor) -> torch.Tensor:
    """The padded plane of a stripe of the frame: ``pad_plane`` of the
    stripe with its true neighbours written in, the row above
    (``above_row`` [W], corners included) and the ``halo`` rows below
    ([n, W], plus the column left of the plane).  Rows further out keep
    the stripe's edge pad."""
    rows, W = stripe.shape
    padded = pad_plane(stripe)
    above = above_row.to(torch.int32)
    below = halo.to(torch.int32)
    padded[PAD - 1, PAD:PAD + W] = above
    padded[PAD - 1, :PAD] = above[0]
    padded[PAD - 1, PAD + W:] = above[-1]
    r0 = PAD + rows
    padded[r0:r0 + below.shape[0], PAD:PAD + W] = below
    padded[r0:r0 + below.shape[0], PAD - 1] = below[:, 0]
    return padded


def intra_decision_plain(plane: torch.Tensor, w: int, h: int, qindex: int,
                         lam: float, mode_bits, bd: int = 8, above_row=None,
                         halo=None):
    """One shape grid of a buf-aligned plane (plain PyTorch); with
    ``above_row`` and ``halo``, of a stripe of the frame between its true
    neighbour rows (``pad_stripe``)."""
    buf_h, buf_w = plane.shape
    padded = pad_plane(plane) if halo is None \
        else pad_stripe(plane, above_row, halo)
    above, left = grid_edges(padded, w, h, buf_w, buf_h)
    src = grid_blocks(padded, w, h, buf_w, buf_h)
    pq = qz.build_quantizer(bd)[0]
    return shape_costs(src, above, left, w, h, qindex, pq, lam, mode_bits)


def intra_decision_arrays(padded: torch.Tensor, buf_w: int, buf_h: int,
                          qindex: int, lam: float, mode_bits, bd: int = 8,
                          shapes=ALL_SHAPES) -> dict:
    """All shape grids for one padded plane -> {(w, h): (mode, cost)}."""
    pq = qz.build_quantizer(bd)[0]
    out = {}
    for (w, h) in shapes:
        above, left = grid_edges(padded, w, h, buf_w, buf_h)
        src = grid_blocks(padded, w, h, buf_w, buf_h)
        out[(w, h)] = shape_costs(src, above, left, w, h, qindex, pq,
                                  lam, mode_bits)
    return out


# --------------------------------------------------------------------------
# K1: the CUDA kernel and its wrapper
# --------------------------------------------------------------------------

@functools.cache
def _dir_taps(w: int, h: int) -> np.ndarray:
    """[6, h*w] int32 tap table of the directional modes D45..D67 from
    _dir_matrices: each output pixel reads at most two samples of ONE
    edge vector with weights summing to 32, packed as
    sel | i0 << 1 | i1 << 8 | w0 << 15 | w1 << 21 (sel 1 = left edge)."""
    out = np.zeros((len(DIR_MODES), h * w), np.int32)
    for mi, mode in enumerate(DIR_MODES):
        wa, wl = _dir_matrices(mode, w, h)
        for p in range(h * w):
            taps = []
            for sel, m in ((0, wa), (1, wl)):
                if m is None:
                    continue
                for i in np.nonzero(m[:, p])[0]:
                    taps.append((sel, int(i), int(m[i, p])))
            assert 1 <= len(taps) <= 2 and len({t[0] for t in taps}) == 1
            assert sum(t[2] for t in taps) == 32
            (sel, i0, w0), (_, i1, w1) = (taps + [(taps[0][0], 0, 0)])[:2]
            out[mi, p] = sel | (i0 << 1) | (i1 << 8) | (w0 << 15) \
                | (w1 << 21)
    return out


@functools.cache
def _k1_taps():
    """The tap tables of every shape of ALL_SHAPES, one after another
    (int32, flat), and the offset of each shape's table in it."""
    tables = [_dir_taps(w, h).reshape(-1) for (w, h) in ALL_SHAPES]
    offsets = np.cumsum([0] + [t.size for t in tables[:-1]])
    return np.concatenate(tables), dict(zip(ALL_SHAPES, offsets.tolist()))


def tf32_split(m: np.ndarray):
    """(big, small) float32 with big = m rounded to TF32 (10 mantissa
    bits, to nearest, ties away from zero: ``cvt.rna.tf32.f32``) and
    small = m - big exactly, so big + small == m; the tensor cores read
    small's TF32 part."""
    bits = np.ascontiguousarray(m, np.float32).view(np.uint32)
    big = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)
    return big, (np.asarray(m, np.float32) - big).astype(np.float32)


# DCT sizes whose fragments K1 holds, in the order of _k1_fragments; K8
# holds the 64-point matrix as well
FRAG_SIZES = (8, 16, 32)
K8_FRAG_SIZES = FRAG_SIZES + (64,)


@functools.cache
def _k1_fragments() -> np.ndarray:
    """The B operands of K1's two products, float32 [2 * (64 + 256 +
    1024)] (``_dct_fragments`` of FRAG_SIZES)."""
    return _dct_fragments(FRAG_SIZES)


@functools.cache
def _dct_fragments(sizes) -> np.ndarray:
    """The B operands of the DCT products on the tensor cores, float32 [2
    * sum(s * s)]: per DCT size s in ``sizes``, B = D_s^T (K = N = s) cut
    into 8x8 tiles (k-step ks, n-tile nt) and, per lane l (g = l // 4, t
    = l % 4) of the tile's mma.sync m16n8k8 B fragment, the float4 (big
    b0, big b1, small b0, small b1) with b0 = B[8ks + t, 8nt + g] and b1 =
    B[8ks + t + 4, 8nt + g]."""
    out = []
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for s in sizes:
        big, small = tf32_split(_dct_mat(s).T)
        tiles = np.empty((s // 8, s // 8, 32, 4), np.float32)
        for ks in range(s // 8):
            for nt in range(s // 8):
                k0, n = 8 * ks + t, 8 * nt + g
                tiles[ks, nt] = np.stack([big[k0, n], big[k0 + 4, n],
                                          small[k0, n], small[k0 + 4, n]],
                                         axis=-1)
        out.append(tiles.reshape(-1))
    return np.concatenate(out)


@functools.cache
def _k1_consts(device: torch.device):
    """(directional tap tables, smooth weights, split DCT fragments) on
    ``device``."""
    sw = intra_ops._sm_weights().astype(np.int32)
    return tuple(to_device(torch.as_tensor(np.ascontiguousarray(a)), device)
                 for a in (_k1_taps()[0], sw, _k1_fragments()))


def pack_decisions(maps: dict, shapes) -> torch.Tensor:
    """The packed form of per-shape maps {(w, h): (mode [nr, nc] int32,
    cost [nr, nc] float32)}: int32 [2, n], row 0 the modes and row 1 the
    costs' float32 bits, shapes in the order of ``shapes`` and blocks in
    raster order within a shape (K1's output)."""
    modes = torch.cat([maps[s][0].reshape(-1).to(torch.int32)
                       for s in shapes])
    costs = torch.cat([maps[s][1].reshape(-1).to(torch.float32)
                       for s in shapes])
    return torch.stack([modes, costs.view(torch.int32)])


def unpack_decisions(packed, shapes, buf_w: int, buf_h: int) -> dict:
    """Per-shape (mode int32 [nr, nc], cost float32 [nr, nc]) views of a
    packed decision (``pack_decisions``) of a [buf_h, buf_w] plane; takes
    a tensor or a numpy array and returns the same kind."""
    is_np = isinstance(packed, np.ndarray)
    out, off = {}, 0
    for (w, h) in shapes:
        nr, nc = buf_h // h, buf_w // w
        n = nr * nc
        cost = packed[1, off:off + n]
        cost = cost.view(np.float32) if is_np else cost.view(torch.float32)
        out[(w, h)] = (packed[0, off:off + n].reshape(nr, nc),
                       cost.reshape(nr, nc))
        off += n
    if off != packed.shape[1]:
        raise ValueError("packed decision does not match the shapes")
    return out


_P, _I = ctypes.c_void_p, ctypes.c_int


def intra_decision_packed(plane: torch.Tensor, qindex: int, lam: float,
                          mode_bits, bd: int = 8, above_row=None, halo=None,
                          shapes=ALL_SHAPES) -> torch.Tensor:
    """K1: best intra mode and its cost for every block of every shape
    in ``shapes`` of a buf-aligned plane, packed (``pack_decisions``;
    ``unpack_decisions`` gives the maps): uint8 at ``bd`` 8, int16 at
    ``bd`` 10 (``device.SAMPLE_DTYPES``; samples in [0, 2^bd)).  Stripe mode:
    ``plane`` is a stripe of the frame, ``above_row`` [W] the row above it
    and ``halo`` [n, W] the rows below it (the plane's dtype), read where
    the whole frame's plane would be (``pad_stripe``).  CPU tensors take
    the plain PyTorch version per shape; CUDA tensors launch the kernel
    once for all shapes."""
    shapes = tuple(tuple(s) for s in shapes)
    if plane.device.type == "cpu":
        return pack_decisions(
            {s: intra_decision_plain(plane, *s, qindex, lam, mode_bits, bd,
                                     above_row, halo) for s in shapes},
            shapes)
    intra_decision_packed.calls += 1
    if plane.device.type != "cuda":
        raise ValueError(f"unsupported device {plane.device}")
    if SAMPLE_DTYPES.get(bd) != plane.dtype or plane.dim() != 2:
        raise ValueError(f"intra_decision takes an [H, W] plane of uint8 at "
                         f"bd 8 or int16 at bd 10, not {plane.dtype} at bd "
                         f"{bd}")
    if not plane.is_contiguous():
        raise ValueError("intra_decision needs a contiguous plane")
    if not shapes or len(set(shapes)) != len(shapes) \
            or any(s not in ALL_SHAPES for s in shapes):
        raise ValueError(f"block shapes must come from {ALL_SHAPES}")
    if len(mode_bits) != len(ALL_MODES):
        raise ValueError("mode_bits needs one entry per intra mode")
    buf_h, buf_w = plane.shape
    if any(buf_h % h or buf_w % w for (w, h) in shapes):
        raise ValueError("plane is not a whole number of blocks")
    if (above_row is None) != (halo is None):
        raise ValueError("stripe mode needs both above_row and halo")
    n_halo = 0
    if halo is not None:
        n_halo = halo.shape[0]
        for t, shape in ((above_row, (buf_w,)), (halo, (n_halo, buf_w))):
            if t.dtype != plane.dtype or tuple(t.shape) != shape \
                    or not t.is_contiguous() or t.device != plane.device:
                raise ValueError(f"intra_decision: stripe rows must be "
                                 f"contiguous {plane.dtype} {shape} on the "
                                 "plane's device")
    from ..kernels.build import check_launch, cuda_fn, ptr, raw_stream

    fn = cuda_fn("intra_decision", "intra_decision_launch",
                 (_P,) * 3 + (_I,) * 5 + (_P,) * 8 + (ctypes.c_float,)
                 + (_P,) * 2)
    taps, sw, frags = _k1_consts(plane.device)
    tap0 = _k1_taps()[1]
    pq = qz.build_quantizer(bd)[0]
    n = len(shapes)
    quant = (ctypes.c_float * (6 * n))(*[
        float(v) for (w, h) in shapes
        for pair in _quant_scalars(w, h, qindex, pq) for v in pair])
    mb = to_device(torch.as_tensor(np.asarray(mode_bits, np.float32)),
                   plane.device)
    n_total = sum((buf_h // h) * (buf_w // w) for (w, h) in shapes)
    out = torch.empty((2, n_total), dtype=torch.int32, device=plane.device)
    err = fn(ptr(plane), None if halo is None else ptr(above_row),
             None if halo is None else ptr(halo), plane.element_size(),
             buf_h, buf_w, n_halo, n,
             (ctypes.c_int * n)(*[w for (w, _) in shapes]),
             (ctypes.c_int * n)(*[h for (_, h) in shapes]), quant,
             (ctypes.c_int * n)(*[tap0[s] for s in shapes]), ptr(taps),
             ptr(sw), ptr(frags), ptr(mb),
             float(np.float32(lam)), ptr(out), raw_stream(plane))
    check_launch("intra_decision", err)
    intra_decision_packed.launches += 1
    return out


intra_decision_packed.launches = intra_decision_packed.calls = 0


def near_recomputes(name: str = "intra_decision", reset: bool = True) -> int:
    """The near-boundary float64 recomputes (``decide_near_boundary``'s
    rule) that the kernel library ``name`` (K1 "intra_decision", K8
    "inter_select") made on the card since the last reset; ``reset`` sets
    the count to 0 after reading."""
    from ..kernels.build import check_launch, cuda_lib

    fn = getattr(cuda_lib(name), f"{name}_near_count")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    out = ctypes.c_ulonglong(0)
    check_launch(f"{name}_near_count", fn(int(reset), ctypes.byref(out)))
    return int(out.value)


def intra_decision(plane: torch.Tensor, w: int, h: int, qindex: int,
                   lam: float, mode_bits, bd: int = 8, above_row=None,
                   halo=None):
    """One shape of ``intra_decision_packed`` (one K1 launch on a CUDA
    plane): (mode int32 [nr, nc], cost float32 [nr, nc]) on the plane's
    device.  The cost is copied out of the packed tensor, so the two do
    not view one storage as two types (which torch.save refuses)."""
    if (w, h) not in ALL_SHAPES:
        raise ValueError(f"unsupported block shape {(w, h)}")
    packed = intra_decision_packed(plane, qindex, lam, mode_bits, bd,
                                   above_row, halo, ((w, h),))
    mode, cost = unpack_decisions(packed, ((w, h),), plane.shape[1],
                                  plane.shape[0])[(w, h)]
    return mode, cost.clone()


# --------------------------------------------------------------------------
# Frame entry
# --------------------------------------------------------------------------

def upload_plane(source_plane, buf_w: int, buf_h: int, bd: int,
                 device) -> torch.Tensor:
    """Buf-aligned (edge-extended) narrow plane on ``device``."""
    if isinstance(source_plane, torch.Tensor):
        if tuple(source_plane.shape) != (buf_h, buf_w):
            raise ValueError(f"device plane {tuple(source_plane.shape)} is "
                             f"not buf-aligned to {(buf_h, buf_w)}")
        return source_plane
    src = np.asarray(source_plane)
    if src.shape != (buf_h, buf_w):
        a = np.empty((buf_h, buf_w), src.dtype)
        h0, w0 = src.shape
        a[:h0, :w0] = src
        a[:h0, w0:] = src[:, w0 - 1:w0]
        a[h0:, :] = a[h0 - 1:h0, :]
        src = a
    return to_device(torch.from_numpy(np.ascontiguousarray(src)), device,
                     SAMPLE_DTYPES[bd])


def intra_decision_frame(source_plane, buf_w: int, buf_h: int, qindex: int,
                         lam: float, mode_bits, bd: int = 8, device=None,
                         shapes=ALL_SHAPES) -> dict:
    """Full-frame open-loop intra decision: returns
    {(w, h): (mode [nr, nc] np.int32, cost [nr, nc] np.float32)}.
    ``source_plane`` is a host array (uploaded here) or a buf-aligned
    tensor already on the device."""
    if isinstance(source_plane, torch.Tensor):
        dev = source_plane.device
    else:
        dev = resolve_device(device)
    plane = upload_plane(source_plane, buf_w, buf_h, bd, dev)
    packed = intra_decision_packed(plane, qindex, lam, mode_bits, bd,
                                   shapes=shapes)
    return unpack_decisions(to_host(packed).numpy(), shapes, buf_w, buf_h)
