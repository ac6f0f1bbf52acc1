"""Frame-batched inter mode decision: device ME + open-loop RD maps (port
of svt_av1_tpu/pipeline/batched_inter.py).

One device pass per inter frame runs full-frame motion estimation against
up to three references (ops/bme.py: K5 coarse search, K6 refinement, K7
quarter-pel), scores every 16x16 unit per reference, picks the winner per
unit under the superblock-level and deviation penalties, assembles the
winning prediction plane and scores every block shape on the residual
through the intra pass's DCT/quantizer cost model (K8), and runs the
intra decision (K1) for the same frame.  The partition DP on the host
then picks per-block intra-vs-inter and the partition tree, and the
conformant coding pass replays the plan.

Motion granularity is 16x16: larger inter blocks are allowed where their
children's selections agree, and smaller blocks inherit the parent
unit's choice.  The averaged-compound candidate (and its joint
refinement, B4) needs a backward reference and is not ported: asking for
it raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops import bme, omd
from ..ops import quant as qz

INTER_MODE_BITS = 3.0        # is_inter + mode ladder proxy
# intra blocks inside inter frames pay is_inter + the full y/uv mode
# syntax; without this the near-zero-residual ties break toward intra
INTRA_IN_INTER_BITS = 6.0
MV_BIT_SCALE = 2.0

# reference selection runs at two levels so the penalties model what the
# syntax charges: ref signaling is paid once per CODED block, so a whole
# superblock switching together is much cheaper per unit than a lone
# 16x16 deviating.  SB-level penalties are per 16-unit-summed SAD;
# DEV_PEN is the extra charge for a unit deviating from its SB's winner.
# The values are the qindex-160 operating point; the live penalties
# scale with the SAD-domain lambda (rdo.sad_lambda).
REF_PEN_SB = 768.0           # non-primary single ref, per SB
COMP_PEN_SB = 640.0          # averaged compound (2 MVs + comp syntax)
DEV_PEN = 320.0              # per-unit deviation from the SB winner
SEL_MV_W = 16.0              # weight of the mv-bits proxy in selection
PEN_TUNE_QINDEX = 160        # the qindex the constants were tuned at

MC_PAD = 80                   # edge pad for the compound joint refinement
JOINT_R = 3                   # its full-pel reach per arm (B4, not ported)

SEL_KEYS = ("sel", "mv_r", "mv_c", "mv1_r", "mv1_c", "fwd_i", "bwd_i")


def selection_pens(qindex: int, bd: int = 8) -> np.ndarray:
    """[ref_pen_sb, comp_pen_sb, dev_pen, sel_mv_w] scaled to the frame's
    quantizer."""
    from .rdo import sad_lambda

    s = sad_lambda(int(qindex), bd) / sad_lambda(PEN_TUNE_QINDEX, bd)
    return np.asarray([REF_PEN_SB * s, COMP_PEN_SB * s, DEV_PEN * s,
                       SEL_MV_W * s], np.float32)


def _nested_to_grid(a, n_sby, n_sbx, oy, ox):
    """[N, oy, ox] per-SB nested -> frame grid [n_sby*oy, n_sbx*ox]."""
    return a.reshape(n_sby, n_sbx, oy, ox).permute(0, 2, 1, 3) \
        .reshape(n_sby * oy, n_sbx * ox).contiguous()


def _take16(stack, idx):
    """stack [K, nr16, nc16, ...]; idx [nr16, nc16] -> [nr16, nc16, ...]."""
    ix = idx.to(torch.int64).reshape((1,) + tuple(idx.shape)
                                     + (1,) * (stack.dim() - 3))
    return torch.gather(stack, 0, ix.expand((1,) + tuple(stack.shape[1:])))[0]


@functools.cache
def _log2_table_np(n: int) -> np.ndarray:
    """float32 log2(1 + d/8) for d in [0, n), computed as the numpy twin
    computes it (float32 division, add and log2)."""
    return np.log2(1.0 + np.arange(n, dtype=np.float32) / 8.0) \
        .astype(np.float32)


@functools.cache
def _log2_table(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_log2_table_np(n)).to(device)


def _table_len(H: int, W: int) -> int:
    """Covers every |mv - sb_mv| in eighth-pel: both MVs stay within a
    plane dimension of their block."""
    return 16 * (max(H, W) + 64)


@functools.cache
def _dct_stack(device: torch.device) -> torch.Tensor:
    """Orthonormal DCT matrices of sizes 8, 16, 32, 64, concatenated."""
    return torch.from_numpy(np.concatenate(
        [omd._dct_mat(n).ravel() for n in (8, 16, 32, 64)])).to(device)


# --------------------------------------------------------------------------
# Plain PyTorch version of K8
# --------------------------------------------------------------------------

def _mc_cost_maps(resid, buf_w, buf_h, qindex, lam, bd,
                  shapes=omd.INTER_SHAPES):
    """Per-shape RD cost of coding the (motion-compensated) residual
    ``resid`` int32 [buf_h, buf_w]: the intra pass's unit-DCT/quantizer
    model with pred = MC.  64-dim shapes model TX_64 semantics: the
    coefficients beyond the top-left 32x32 band are zeroed (their energy
    counts as distortion, they cost no rate)."""
    dev = resid.device
    pq = qz.build_quantizer(bd)[0]
    out = {}
    for (w, h) in shapes:
        nr, nc = buf_h // h, buf_w // w
        blocks = resid.reshape(nr, h, nc, w).permute(0, 2, 1, 3)
        zbin, rnd, step = (torch.as_tensor(m, device=dev)
                           for m in omd._quant_maps(w, h, qindex, pq))
        dh = torch.as_tensor(omd._dct_mat(h), device=dev)
        dwt = torch.as_tensor(np.ascontiguousarray(omd._dct_mat(w).T),
                              device=dev)
        cf = dh @ blocks.to(torch.float32) @ dwt
        ac = cf.abs()
        q = torch.floor((ac + rnd) / step)
        q = torch.where(ac >= zbin, q.clamp_min(0.0), 0.0)
        if w > 32 or h > 32:
            band = torch.zeros((h, w), dtype=torch.float32, device=dev)
            band[:32, :32] = 1.0
            q = q * band
        err = ac - q * step
        sse = (err * err).sum(dim=(-1, -2))
        nnz = (q > 0).sum(dim=(-1, -2)).to(torch.float32)
        mag = torch.log2(1.0 + q).sum(dim=(-1, -2))
        bits = omd.RATE_NNZ * nnz + omd.RATE_MAG * mag \
            + omd.RATE_TXB * (nnz > 0).to(torch.float32) + INTER_MODE_BITS
        out[(w, h)] = sse + lam * bits
    return out


def _mv_bits(mvq_r, mvq_c, sb_r, sb_c, tab):
    """MV_BIT_SCALE * (log2(1 + d_r/8) + log2(1 + d_c/8)), d the
    eighth-pel distance from the reference's 64x64 winner; [K, nr16,
    nc16] float32."""
    def to16(a):
        return a.repeat_interleave(4, 1).repeat_interleave(4, 2)

    d_r = (mvq_r - to16(sb_r) * 8).abs().to(torch.int64)
    d_c = (mvq_c - to16(sb_c) * 8).abs().to(torch.int64)
    return MV_BIT_SCALE * (tab[d_r] + tab[d_c])


def inter_select_plain(src, preds, mvq_r, mvq_c, sb_r, sb_c, qindex, lam,
                       bd: int = 8):
    """Selection, prediction assembly and residual cost maps (plain):
    returns (sel_fields, mvbits16, inter_cost) on the inputs' device."""
    K, H, W = preds.shape
    nr16, nc16 = H // 16, W // 16
    dev = src.device
    pens = [float(p) for p in selection_pens(qindex, bd)]
    mvb = _mv_bits(mvq_r, mvq_c, sb_r, sb_c, _log2_table(_table_len(H, W),
                                                         dev))
    s16 = src.to(torch.int32).reshape(nr16, 16, nc16, 16).permute(0, 2, 1, 3)
    p16 = preds.to(torch.int32).reshape(K, nr16, 16, nc16, 16) \
        .permute(0, 1, 3, 2, 4)
    sad = (s16[None] - p16).abs().sum((-1, -2)).to(torch.float32)
    base = sad + pens[3] * mvb                        # [K, nr16, nc16]

    # SB-level winner: the 16 unit scores summed in numpy's order (each
    # row of 4 left to right, then the rows), then per-unit selection
    # with a deviation charge away from it
    nsy, nsx = nr16 // 4, nc16 // 4
    v = base.reshape(K, nsy, 4, nsx, 4)
    sb_base = None
    for i in range(4):
        row = v[:, :, i, :, 0]
        for j in range(1, 4):
            row = row + v[:, :, i, :, j]
        sb_base = row if sb_base is None else sb_base + row
    sb_pen = torch.tensor([0.0] + [pens[0]] * (K - 1), dtype=torch.float32,
                          device=dev)
    sb_sel = torch.argmin(sb_base + sb_pen[:, None, None], dim=0)
    sb_sel16 = sb_sel.repeat_interleave(4, 0).repeat_interleave(4, 1)
    ks = torch.arange(K, device=dev)[:, None, None]
    score = base + pens[2] * (ks != sb_sel16[None]).to(torch.float32)
    sel = torch.argmin(score, dim=0).to(torch.int32)

    pred_fin = _take16(p16, sel)                      # [nr16, nc16, 16, 16]
    pred_plane = pred_fin.permute(0, 2, 1, 3).reshape(H, W)
    zero = torch.zeros_like(sel)
    fields = dict(sel=sel, mv_r=_take16(mvq_r, sel), mv_c=_take16(mvq_c, sel),
                  mv1_r=zero, mv1_c=zero, fwd_i=zero, bwd_i=zero)
    resid = src.to(torch.int32) - pred_plane
    return fields, _take16(mvb, sel), _mc_cost_maps(resid, W, H, qindex, lam,
                                                     bd)


# --------------------------------------------------------------------------
# K8: the CUDA kernel and its wrapper
# --------------------------------------------------------------------------

@functools.cache
def _k8_consts(qindex: int, bd: int, device: torch.device):
    pq = qz.build_quantizer(bd)[0]
    shapes = torch.tensor([v for s in omd.INTER_SHAPES for v in s],
                          dtype=torch.int32).to(device)
    # one row per shape: (zbin, round, step) as (dc, ac) pairs
    qpar = np.asarray([[v for pair in omd._quant_scalars(w, h, qindex, pq)
                        for v in pair] for (w, h) in omd.INTER_SHAPES],
                      np.float32)
    return shapes, torch.from_numpy(qpar).to(device)


def inter_select(src, preds, mvq_r, mvq_c, sb_r, sb_c, qindex: int,
                 lam: float, bd: int = 8):
    """K8: per-unit reference selection, the winning prediction's residual
    and its cost maps for the 10 INTER_SHAPES.  ``src`` uint8 [H, W];
    ``preds`` uint8 [K, H, W] (K <= 3) the references' quarter-pel
    predictions; ``mvq_r/mvq_c`` int32 [K, H/16, W/16] eighth-pel MVs;
    ``sb_r/sb_c`` int32 [K, H/64, W/64] the full-pel 64x64 winners.
    Returns (sel_fields, mvbits16, {(w, h): cost}).  CPU tensors take the
    plain version; CUDA tensors launch kernels/csrc/inter_select.cu."""
    if src.device.type == "cpu":
        return inter_select_plain(src, preds, mvq_r, mvq_c, sb_r, sb_c,
                                  qindex, lam, bd)
    if src.device.type != "cuda":
        raise ValueError(f"inter_select: unsupported device {src.device}")
    K, H, W = preds.shape
    if bd != 8 or src.dtype != torch.uint8 or preds.dtype != torch.uint8 \
            or tuple(src.shape) != (H, W) or not 1 <= K <= 3:
        raise ValueError("inter_select takes an 8-bit uint8 [H, W] source "
                         "and 1..3 uint8 predictions of the same size")
    if H % 64 or W % 64:
        raise ValueError("inter_select: planes must be whole 64x64 SBs")
    for t, shape in ((mvq_r, (K, H // 16, W // 16)),
                     (mvq_c, (K, H // 16, W // 16)),
                     (sb_r, (K, H // 64, W // 64)),
                     (sb_c, (K, H // 64, W // 64))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != src.device:
            raise ValueError(f"inter_select: MV fields must be contiguous "
                             f"int32 {shape}")
    if not (src.is_contiguous() and preds.is_contiguous()):
        raise ValueError("inter_select needs contiguous planes")
    from ..kernels.build import check_launch, cuda_lib, ptr, stream

    fn = cuda_lib("inter_select").inter_select_launch
    fn.restype = ctypes.c_int
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P, P, I, I, I, P, P, P, P, P, I, F, F, F, P, P, P, F] \
        + [P] * 6
    dev = src.device
    n_tab = _table_len(H, W)
    tab = _log2_table(n_tab, dev)
    shapes, qpar = _k8_consts(int(qindex), bd, dev)
    pens = selection_pens(qindex, bd)
    nr16, nc16 = H // 16, W // 16
    sel = torch.empty((nr16, nc16), dtype=torch.int32, device=dev)
    mv_r, mv_c = torch.empty_like(sel), torch.empty_like(sel)
    mvb = torch.empty((nr16, nc16), dtype=torch.float32, device=dev)
    sizes = [(H // h) * (W // w) for (w, h) in omd.INTER_SHAPES]
    cost = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    err = fn(ptr(src), ptr(preds), K, H, W, ptr(mvq_r), ptr(mvq_c),
             ptr(sb_r), ptr(sb_c), ptr(tab), n_tab, float(pens[0]),
             float(pens[2]), float(pens[3]), ptr(shapes), ptr(qpar),
             ptr(_dct_stack(dev)), float(np.float32(lam)), ptr(sel),
             ptr(mv_r), ptr(mv_c), ptr(mvb), ptr(cost), stream(src))
    check_launch("inter_select", err)
    inter_select.launches += 1
    zero = torch.zeros_like(sel)
    fields = dict(sel=sel, mv_r=mv_r, mv_c=mv_c, mv1_r=zero, mv1_c=zero,
                  fwd_i=zero, bwd_i=zero)
    costs, off = {}, 0
    for (w, h), n in zip(omd.INTER_SHAPES, sizes):
        costs[(w, h)] = cost[off:off + n].reshape(H // h, W // w)
        off += n
    return fields, mvb, costs


inter_select.launches = 0


# --------------------------------------------------------------------------
# The frame program
# --------------------------------------------------------------------------

def inter_frame_maps(src, refs, qindex, lam, mode_bits, bd=8,
                     bwd_mask=None, allow_compound=False, coarse_r=None):
    """(intra_maps, inter_cost_maps, sel_fields, mvbits16): the open-loop
    decision state of one inter frame against 1..3 references, as tensors
    on the device of ``src`` (a buf-aligned uint8 [H, W] plane; ``refs`` a
    list of such planes).  CUDA planes run K5 -> K6 -> K7 per reference,
    then K8, then K1 for the intra maps; CPU planes run the plain
    versions.  MVs are quarter-pel (eighth-pel values, multiples of 2).

    ``bwd_mask[k]`` marks backward references; with ``allow_compound``
    and references in both directions the averaged-compound candidate
    would join the selection, which is not ported: that raises."""
    K = len(refs)
    if bwd_mask is None:
        bwd_mask = (False,) * K
    if allow_compound and any(bwd_mask[:K]) and not all(bwd_mask[:K]):
        raise NotImplementedError(
            "svt_av1_tpu_torch does not port the averaged-compound "
            "candidate (joint refinement, B4) yet")
    if coarse_r is None:
        coarse_r = bme.COARSE_R
    if not isinstance(coarse_r, (tuple, list)):
        coarse_r = (coarse_r,) * K
    mvq_r, mvq_c, preds, sb_r, sb_c = [], [], [], [], []
    for k, ref in enumerate(refs):
        me = bme.frame_me(src, ref, coarse_r[k], shapes=((16, 16), (64, 64)))
        n_sby, n_sbx = me["grid"]
        mv_r16 = _nested_to_grid(me[(16, 16)][0], n_sby, n_sbx, 4, 4)
        mv_c16 = _nested_to_grid(me[(16, 16)][1], n_sby, n_sbx, 4, 4)
        r, c, pred = bme.subpel_refine16(src, ref, mv_r16, mv_c16, bd)
        mvq_r.append(r)
        mvq_c.append(c)
        preds.append(pred)
        sb_r.append(me[(64, 64)][0].reshape(n_sby, n_sbx))
        sb_c.append(me[(64, 64)][1].reshape(n_sby, n_sbx))
    fields, mvb, inter_cost = inter_select(
        src, torch.stack(preds), torch.stack(mvq_r), torch.stack(mvq_c),
        torch.stack(sb_r).contiguous(), torch.stack(sb_c).contiguous(),
        qindex, lam, bd)
    intra = {(w, h): omd.intra_decision(src, w, h, qindex, lam, mode_bits,
                                        bd)
             for (w, h) in omd.ALL_SHAPES}
    return intra, inter_cost, fields, mvb


def inter_maps_dispatch(src, refs, buf_w, buf_h, qindex, lam, mode_bits,
                        bd, device, bwd_mask=None, allow_compound=False,
                        rel_dists=None):
    """Run inter_frame_maps on ``device`` and return numpy results.

    ``src`` and the entries of ``refs`` are buf-aligned host arrays or
    uint8 tensors already on ``device`` (the encoder uploads each coded
    picture's ME plane once).  Each reference's coarse reach follows its
    distance (bme.coarse_r_for_dist)."""
    dev = torch.device(device)
    refs = list(refs)
    src_t = omd.upload_plane(src, buf_w, buf_h, bd, dev)
    ref_t = [omd.upload_plane(r, buf_w, buf_h, bd, dev) for r in refs]
    if bwd_mask is None:
        bwd_mask = (False,) * len(ref_t)
    if rel_dists is None:
        rel_dists = tuple(1 if b else -1 for b in bwd_mask[:len(ref_t)])
    coarse_r = tuple(bme.coarse_r_for_dist(int(d)) for d in rel_dists)
    intra, inter_cost, sf, mvb = inter_frame_maps(
        src_t, ref_t, qindex, lam, mode_bits, bd,
        bwd_mask=tuple(bool(b) for b in bwd_mask),
        allow_compound=allow_compound, coarse_r=coarse_r)
    intra = {s: (m.cpu().numpy(), c.cpu().numpy())
             for s, (m, c) in intra.items()}
    inter_cost = {s: c.cpu().numpy() for s, c in inter_cost.items()}
    sf = {k: v.cpu().numpy() for k, v in sf.items()}
    return intra, inter_cost, sf, mvb.cpu().numpy()
