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
unit's choice.  With references on both sides of the frame, an averaged
compound candidate (best forward + best backward per unit, then the
joint refinement of each arm against the other, K9) joins the selection
as its (K+1)-th row.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..device import SAMPLE_DTYPES, to_device, to_host
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
JOINT_R = 3                   # its full-pel reach per arm

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
    return to_device(torch.from_numpy(_log2_table_np(n)), device)


def _table_len(H: int, W: int) -> int:
    """Covers every |mv - sb_mv| in eighth-pel: both MVs stay within a
    plane dimension of their block."""
    return 16 * (max(H, W) + 64)


@functools.cache
def _dct_stack(device: torch.device) -> torch.Tensor:
    """K8's DCT operands: the split mma.sync fragments of the orthonormal
    DCT matrices of sizes 8, 16, 32 and 64 (``omd._dct_fragments``)."""
    return to_device(torch.from_numpy(omd._dct_fragments(omd.K8_FRAG_SIZES)),
                     device)


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
        zbin, rnd, step = (to_device(torch.as_tensor(m), dev)
                           for m in omd._quant_maps(w, h, qindex, pq))
        dh = to_device(torch.as_tensor(omd._dct_mat(h)), dev)
        dwt = to_device(torch.as_tensor(
            np.ascontiguousarray(omd._dct_mat(w).T)), dev)
        cf = dh @ blocks.to(torch.float32) @ dwt
        band = None
        if w > 32 or h > 32:
            band = torch.zeros((h, w), dtype=torch.bool, device=dev)
            band[:32, :32] = True
        ac = omd.decide_near_boundary(cf, blocks, dh, dwt, zbin, rnd, step,
                                      w, h, band)
        q = torch.floor((ac + rnd) / step)
        q = torch.where(ac >= zbin, q.clamp_min(0.0), 0.0)
        if band is not None:
            q = q * band.to(torch.float32)
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


def _unit_scores(src, preds, mvq_r, mvq_c, sb_r, sb_c, pen_mv):
    """Per unit of 16x16 and reference: (base, mvb, s16, p16) with base =
    SAD + pen_mv * mvb, float32 [K, nr16, nc16]; s16 and p16 the int32
    source and prediction blocks [(K,) nr16, nc16, 16, 16]."""
    K, H, W = preds.shape
    nr16, nc16 = H // 16, W // 16
    mvb = _mv_bits(mvq_r, mvq_c, sb_r, sb_c,
                   _log2_table(_table_len(H, W), src.device))
    s16 = src.to(torch.int32).reshape(nr16, 16, nc16, 16).permute(0, 2, 1, 3)
    p16 = preds.to(torch.int32).reshape(K, nr16, 16, nc16, 16) \
        .permute(0, 1, 3, 2, 4)
    sad = (s16[None] - p16).abs().sum((-1, -2)).to(torch.float32)
    return sad + pen_mv * mvb, mvb, s16, p16


def inter_select_plain(src, preds, mvq_r, mvq_c, sb_r, sb_c, qindex, lam,
                       bd: int = 8, comp=None):
    """Selection, prediction assembly and residual cost maps (plain):
    returns (sel_fields, mvbits16, inter_cost) on the inputs' device.
    ``comp`` (the output of ``compound_joint``) adds the averaged-compound
    candidate as row K: its score is its SAD plus the MV-bits proxy of
    both arms, and it pays the compound SB penalty."""
    K, H, W = preds.shape
    nr16, nc16 = H // 16, W // 16
    dev = src.device
    pens = [float(p) for p in selection_pens(qindex, bd)]
    base, mvb, s16, p16 = _unit_scores(src, preds, mvq_r, mvq_c, sb_r, sb_c,
                                       pens[3])
    nc = K
    if comp is not None:
        fi, bi = comp["fwd_i"], comp["bwd_i"]
        mvb_c = _take16(mvb, fi) + _take16(mvb, bi)
        c16 = comp["pred"].to(torch.int32).reshape(nr16, 16, nc16, 16) \
            .permute(0, 2, 1, 3)
        base = torch.cat([base, (comp["sad"].to(torch.float32)
                                 + pens[3] * mvb_c)[None]])
        p16 = torch.cat([p16, c16[None]])
        nc = K + 1

    # SB-level winner: the 16 unit scores summed in numpy's order (each
    # row of 4 left to right, then the rows), then per-unit selection
    # with a deviation charge away from it
    nsy, nsx = nr16 // 4, nc16 // 4
    v = base.reshape(nc, nsy, 4, nsx, 4)
    sb_base = None
    for i in range(4):
        row = v[:, :, i, :, 0]
        for j in range(1, 4):
            row = row + v[:, :, i, :, j]
        sb_base = row if sb_base is None else sb_base + row
    sb_pen = to_device(torch.tensor(
        [0.0] + [pens[0]] * (K - 1) + [pens[1]] * (nc - K),
        dtype=torch.float32), dev)
    sb_sel = torch.argmin(sb_base + sb_pen[:, None, None], dim=0)
    sb_sel16 = sb_sel.repeat_interleave(4, 0).repeat_interleave(4, 1)
    ks = torch.arange(nc, device=dev)[:, None, None]
    score = base + pens[2] * (ks != sb_sel16[None]).to(torch.float32)
    sel = torch.argmin(score, dim=0).to(torch.int32)

    pred_fin = _take16(p16, sel)                      # [nr16, nc16, 16, 16]
    pred_plane = pred_fin.permute(0, 2, 1, 3).reshape(H, W)
    # a compound unit reads its single-reference fields at fi
    kk = sel.clamp(max=K - 1)
    if comp is not None:
        is_comp = sel == K
        kk = torch.where(is_comp, fi, kk)
    zero = torch.zeros_like(sel)
    fields = dict(sel=sel, mv_r=_take16(mvq_r, kk), mv_c=_take16(mvq_c, kk),
                  mv1_r=zero, mv1_c=zero, fwd_i=zero, bwd_i=zero)
    mvbits16 = _take16(mvb, kk)
    if comp is not None:
        for k in ("mv_r", "mv_c"):
            fields[k] = torch.where(is_comp, comp[k], fields[k])
        for k in ("mv1_r", "mv1_c"):
            fields[k] = torch.where(is_comp, comp[k], zero)
        fields["fwd_i"], fields["bwd_i"] = fi, bi
        mvbits16 = torch.where(is_comp, mvb_c, mvbits16)
    resid = src.to(torch.int32) - pred_plane
    return fields, mvbits16, _mc_cost_maps(resid, W, H, qindex, lam, bd)


# --------------------------------------------------------------------------
# Plain PyTorch version of K9 (the compound candidate and its joint
# refinement)
# --------------------------------------------------------------------------

def _mirror(mvq8, d_from, d_to):
    """The MV of one arm mirrored onto the other side of the frame and
    scaled by the distances, in quarter-pel steps (floor division, as the
    numpy twin divides); clipped to +-512 eighth-pel."""
    q = mvq8 >> 1
    m = -torch.div(q * d_to * 2 + d_from, 2 * d_from,
                   rounding_mode="floor") * 2
    return m.clamp(-512, 512).to(torch.int32)


def _joint_arm(refs, s16, fixed, arm_k, seed_r, seed_c):
    """Joint refinement of one compound arm: with the other arm's
    prediction ``fixed`` held, search reference ``arm_k`` per unit at the
    full-pel offsets within +-JOINT_R of the seed, by the SAD of the
    averaged prediction (first minimum in raster order).  The references
    read as if padded by MC_PAD edge samples (clamped indices), and the
    window origin is clipped to that pad, so the MV comes from the
    origin, not the seed.  Returns (comp [n16, 16, 16] int32, mv_r, mv_c
    eighth-pel, sad), each per unit [nr16, nc16]."""
    K, H, W = refs.shape
    nr16, nc16 = seed_r.shape
    n16 = nr16 * nc16
    dev = refs.device
    B, win = JOINT_R, 16 + 2 * JOINT_R
    gy, gx = torch.meshgrid(torch.arange(nr16, device=dev) * 16,
                            torch.arange(nc16, device=dev) * 16,
                            indexing="ij")
    pos_y, pos_x = gy.reshape(-1), gx.reshape(-1)
    oy = (pos_y + (seed_r.reshape(-1) >> 3) - B + MC_PAD).clamp(
        0, H + 2 * MC_PAD - win)
    ox = (pos_x + (seed_c.reshape(-1) >> 3) - B + MC_PAD).clamp(
        0, W + 2 * MC_PAD - win)
    ar = torch.arange(win, device=dev)
    rows = (oy[:, None] - MC_PAD + ar[None]).clamp(0, H - 1)
    cols = (ox[:, None] - MC_PAD + ar[None]).clamp(0, W - 1)
    patch = refs[arm_k.reshape(-1).to(torch.int64)[:, None, None],
                 rows[:, :, None], cols[:, None, :]].to(torch.int32)
    fx = fixed.reshape(n16, 16, 16)
    sblk = s16.reshape(n16, 16, 16)
    best_sad = best_dy = best_dx = None
    for dy in range(2 * B + 1):
        for dx in range(2 * B + 1):
            comp = (fx + patch[:, dy:dy + 16, dx:dx + 16] + 1) >> 1
            sad = (sblk - comp).abs().sum((-1, -2))
            if best_sad is None:
                best_sad = sad
                best_dy = torch.full_like(sad, dy)
                best_dx = torch.full_like(sad, dx)
            else:
                take = sad < best_sad
                best_sad = torch.where(take, sad, best_sad)
                best_dy = torch.where(take, dy, best_dy)
                best_dx = torch.where(take, dx, best_dx)
    mv_r = (oy - MC_PAD + best_dy - pos_y) * 8
    mv_c = (ox - MC_PAD + best_dx - pos_x) * 8
    ar16 = torch.arange(16, device=dev)
    pb = patch[torch.arange(n16, device=dev)[:, None, None],
               (best_dy[:, None] + ar16[None])[:, :, None],
               (best_dx[:, None] + ar16[None])[:, None, :]]
    comp = (fx + pb + 1) >> 1
    shp = (nr16, nc16)
    return (comp, mv_r.reshape(shp).to(torch.int32),
            mv_c.reshape(shp).to(torch.int32),
            best_sad.reshape(shp).to(torch.int32))


def compound_joint_plain(src, refs, preds, mvq_r, mvq_c, sb_r, sb_c,
                         bwd_mask, rel_dists, qindex: int, bd: int = 8):
    """The averaged-compound candidate per unit (plain): the best forward
    and the best backward reference by single-reference score (first
    minimum), the average of their predictions, and each arm jointly
    re-searched against the other held fixed around its mirrored MV; the
    least SAD of the three pairs wins (first minimum).  Returns the dict
    ``compound_joint`` documents."""
    K, H, W = preds.shape
    nr16, nc16 = H // 16, W // 16
    dev = src.device
    pen_mv = float(selection_pens(qindex, bd)[3])
    base, _, s16, p16 = _unit_scores(src, preds, mvq_r, mvq_c, sb_r, sb_c,
                                     pen_mv)
    fwd = [k for k in range(K) if not bwd_mask[k]]
    bwd = [k for k in range(K) if bwd_mask[k]]

    def first_min(ks):
        gl = to_device(torch.tensor(ks, dtype=torch.int32), dev)
        return gl[torch.argmin(base[ks], dim=0)]

    fi, bi = first_min(fwd), first_min(bwd)
    pf, pb = _take16(p16, fi), _take16(p16, bi)
    mvf_r, mvf_c = _take16(mvq_r, fi), _take16(mvq_c, fi)
    mvb_r, mvb_c = _take16(mvq_r, bi), _take16(mvq_c, bi)
    rel = to_device(torch.tensor([int(d) for d in rel_dists],
                                 dtype=torch.int32), dev)
    df = rel[fi.to(torch.int64)].abs().clamp(min=1)
    db = rel[bi.to(torch.int64)].abs().clamp(min=1)
    cb, cb_r, cb_c, sad_b = _joint_arm(refs, s16, pf, bi,
                                       _mirror(mvf_r, df, db),
                                       _mirror(mvf_c, df, db))
    cf, cf_r, cf_c, sad_f = _joint_arm(refs, s16, pb, fi,
                                       _mirror(mvb_r, db, df),
                                       _mirror(mvb_c, db, df))
    p0 = (pf + pb + 1) >> 1
    sad0 = (s16 - p0).abs().sum((-1, -2)).to(torch.int32)
    pick = torch.argmin(torch.stack([sad0, sad_b, sad_f]), dim=0)
    comp16 = _take16(torch.stack([p0, cb.reshape(p0.shape),
                                  cf.reshape(p0.shape)]), pick)
    pairs = ((mvf_r, mvf_c, mvb_r, mvb_c), (mvf_r, mvf_c, cb_r, cb_c),
             (cf_r, cf_c, mvb_r, mvb_c))
    mv = [_take16(torch.stack([p[i] for p in pairs]), pick)
          for i in range(4)]
    return dict(pred=comp16.permute(0, 2, 1, 3).reshape(H, W)
                .to(SAMPLE_DTYPES[bd]),
                sad=_take16(torch.stack([sad0, sad_b, sad_f]), pick),
                mv_r=mv[0], mv_c=mv[1], mv1_r=mv[2], mv1_c=mv[3],
                fwd_i=fi, bwd_i=bi)


COMP_KEYS = ("pred", "sad", "mv_r", "mv_c", "mv1_r", "mv1_c", "fwd_i",
             "bwd_i")


# --------------------------------------------------------------------------
# K8 and K9: the CUDA kernels and their wrappers
# --------------------------------------------------------------------------

@functools.cache
def _k8_consts(qindex: int, bd: int, device: torch.device):
    pq = qz.build_quantizer(bd)[0]
    shapes = to_device(torch.tensor([v for s in omd.INTER_SHAPES for v in s],
                                    dtype=torch.int32), device)
    # one row per shape: (zbin, round, step) as (dc, ac) pairs
    qpar = np.asarray([[v for pair in omd._quant_scalars(w, h, qindex, pq)
                        for v in pair] for (w, h) in omd.INTER_SHAPES],
                      np.float32)
    return shapes, to_device(torch.from_numpy(qpar), device)


def _check_unit_inputs(name, src, preds, mvq_r, mvq_c, sb_r, sb_c, bd):
    """The shapes, types and device K8 and K9 take: the source and its
    predictions in the sample type of ``bd`` (``device.SAMPLE_DTYPES``:
    uint8 at 8 bits, int16 at 10); returns (K, H, W)."""
    if src.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {src.device}")
    K, H, W = preds.shape
    dt = SAMPLE_DTYPES.get(bd)
    if dt is None or src.dtype != dt or preds.dtype != dt \
            or tuple(src.shape) != (H, W) or not 1 <= K <= 3:
        raise ValueError(f"{name} takes a [H, W] source and 1..3 "
                         "predictions of the same size, uint8 at bd 8 or "
                         f"int16 at bd 10, not {src.dtype} / {preds.dtype} "
                         f"at bd {bd}")
    if H % 64 or W % 64:
        raise ValueError(f"{name}: planes must be whole 64x64 SBs")
    for t, shape in ((mvq_r, (K, H // 16, W // 16)),
                     (mvq_c, (K, H // 16, W // 16)),
                     (sb_r, (K, H // 64, W // 64)),
                     (sb_c, (K, H // 64, W // 64))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != src.device:
            raise ValueError(f"{name}: MV fields must be contiguous int32 "
                             f"{shape}")
    if not (src.is_contiguous() and preds.is_contiguous()) \
            or preds.device != src.device:
        raise ValueError(f"{name} needs contiguous planes on one device")
    return K, H, W


def inter_select(src, preds, mvq_r, mvq_c, sb_r, sb_c, qindex: int,
                 lam: float, bd: int = 8, comp=None):
    """K8: per-unit reference selection, the winning prediction's residual
    and its cost maps for the 10 INTER_SHAPES.  ``src`` [H, W] and
    ``preds`` [K, H, W] (K <= 3, the references' quarter-pel predictions)
    uint8 at ``bd`` 8, int16 at ``bd`` 10; ``mvq_r/mvq_c`` int32 [K, H/16,
    W/16] eighth-pel MVs; ``sb_r/sb_c`` int32 [K, H/64, W/64] the
    full-pel 64x64 winners; ``comp`` the averaged-compound candidate
    (``compound_joint``'s dict) or None.  Returns (sel_fields, mvbits16,
    {(w, h): cost}).  CPU tensors take the plain version; CUDA tensors
    launch kernels/csrc/inter_select.cu, its 8-bit or its 16-bit form."""
    if src.device.type == "cpu":
        return inter_select_plain(src, preds, mvq_r, mvq_c, sb_r, sb_c,
                                  qindex, lam, bd, comp)
    inter_select.calls += 1
    K, H, W = _check_unit_inputs("inter_select", src, preds, mvq_r, mvq_c,
                                 sb_r, sb_c, bd)
    nr16, nc16 = H // 16, W // 16
    if comp is not None:
        if set(comp) != set(COMP_KEYS):
            raise ValueError(f"inter_select: comp must hold {COMP_KEYS}")
        for k in COMP_KEYS:
            t = comp[k]
            want = ((H, W), src.dtype) if k == "pred" \
                else ((nr16, nc16), torch.int32)
            if tuple(t.shape) != want[0] or t.dtype != want[1] \
                    or not t.is_contiguous() or t.device != src.device:
                raise ValueError(f"inter_select: comp[{k!r}] must be "
                                 f"contiguous {want[1]} {want[0]}")
    from ..kernels.build import check_launch, cuda_fn, ptr, stream

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = cuda_fn("inter_select", "inter_select_launch",
                 (P, P, I, I, I, I, P, P, P, P, P, I, F, F, F, F, P, P, P, F)
                 + (P,) * 18)
    dev = src.device
    n_tab = _table_len(H, W)
    tab = _log2_table(n_tab, dev)
    shapes, qpar = _k8_consts(int(qindex), bd, dev)
    pens = selection_pens(qindex, bd)
    out = {k: torch.empty((nr16, nc16), dtype=torch.int32, device=dev)
           for k in SEL_KEYS}
    mvb = torch.empty((nr16, nc16), dtype=torch.float32, device=dev)
    sizes = [(H // h) * (W // w) for (w, h) in omd.INTER_SHAPES]
    cost = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    # no candidate: null pointers, and the kernel selects among K rows
    cptr = [ptr(comp[k]) if comp is not None else None
            for k in ("pred", "sad", "fwd_i", "bwd_i", "mv_r", "mv_c",
                      "mv1_r", "mv1_c")]
    err = fn(ptr(src), ptr(preds), src.element_size(), K, H, W, ptr(mvq_r),
             ptr(mvq_c), ptr(sb_r), ptr(sb_c), ptr(tab), n_tab,
             float(pens[0]), float(pens[1]), float(pens[2]), float(pens[3]),
             ptr(shapes), ptr(qpar), ptr(_dct_stack(dev)),
             float(np.float32(lam)), *cptr,
             *(ptr(out[k]) for k in SEL_KEYS), ptr(mvb), ptr(cost),
             stream(src))
    check_launch("inter_select", err)
    inter_select.launches += 1
    costs, off = {}, 0
    for (w, h), n in zip(omd.INTER_SHAPES, sizes):
        costs[(w, h)] = cost[off:off + n].reshape(H // h, W // w)
        off += n
    return out, mvb, costs


inter_select.launches = inter_select.calls = 0


def compound_joint(src, refs, preds, mvq_r, mvq_c, sb_r, sb_c, bwd_mask,
                   rel_dists, qindex: int, bd: int = 8) -> dict:
    """K9: the averaged-compound candidate of every 16x16 unit.  ``refs``
    [K, H, W] the reference planes, in the sample type of ``bd`` as
    ``src`` and ``preds`` (uint8 at 8 bits, int16 at 10); ``preds``,
    ``mvq_r/mvq_c`` and ``sb_r/sb_c`` as for ``inter_select``;
    ``bwd_mask[k]`` marks the backward references (at least one on each
    side); ``rel_dists[k]`` each reference's signed display distance.
    Returns {"pred": [H, W] the compound prediction in the sample type,
    "sad": its SAD, "mv_r", "mv_c" the forward and "mv1_r", "mv1_c" the
    backward arm's eighth-pel MV, "fwd_i", "bwd_i" the paired references},
    each but "pred" int32 [H/16, W/16].  CPU tensors take the plain
    version; CUDA tensors launch kernels/csrc/compound_joint.cu, its 8-bit
    or its 16-bit form."""
    K = preds.shape[0]
    bwd_mask = tuple(bool(b) for b in bwd_mask[:K])
    if len(rel_dists) != K or len(bwd_mask) != K \
            or all(bwd_mask) or not any(bwd_mask):
        raise ValueError("compound_joint needs one distance and direction "
                         "per reference, with references on both sides")
    if src.device.type == "cpu":
        return compound_joint_plain(src, refs, preds, mvq_r, mvq_c, sb_r,
                                    sb_c, bwd_mask, rel_dists, qindex, bd)
    compound_joint.calls += 1
    _, H, W = _check_unit_inputs("compound_joint", src, preds, mvq_r, mvq_c,
                                 sb_r, sb_c, bd)
    if refs.dtype != src.dtype or tuple(refs.shape) != tuple(preds.shape) \
            or not refs.is_contiguous() or refs.device != src.device:
        raise ValueError(f"compound_joint: refs must be contiguous {src.dtype}"
                         " [K, H, W] beside the predictions")
    if any(t.data_ptr() % 16 for t in (src, refs, preds)):
        raise ValueError("compound_joint: the kernel reads rows as 16-byte "
                         "words; planes must start on 16-byte boundaries")
    from ..kernels.build import check_launch, cuda_fn, ptr, stream

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = cuda_fn("compound_joint", "compound_joint_launch",
                 (P, P, P, I, I, I, I, P, P, P, P, P, I, F, I, I, I, I)
                 + (P,) * 9)
    dev = src.device
    n_tab = _table_len(H, W)
    rel = [int(d) for d in rel_dists] + [0] * (3 - K)
    mask = sum(1 << k for k in range(K) if bwd_mask[k])
    nr16, nc16 = H // 16, W // 16
    out = {k: torch.empty((nr16, nc16), dtype=torch.int32, device=dev)
           for k in COMP_KEYS if k != "pred"}
    out["pred"] = torch.empty((H, W), dtype=src.dtype, device=dev)
    err = fn(ptr(src), ptr(refs), ptr(preds), src.element_size(), K, H, W,
             ptr(mvq_r), ptr(mvq_c), ptr(sb_r), ptr(sb_c),
             ptr(_log2_table(n_tab, dev)), n_tab,
             float(selection_pens(qindex, bd)[3]), mask, *rel,
             *(ptr(out[k]) for k in COMP_KEYS), stream(src))
    check_launch("compound_joint", err)
    compound_joint.launches += 1
    return out


compound_joint.launches = compound_joint.calls = 0


# --------------------------------------------------------------------------
# The frame program
# --------------------------------------------------------------------------

def inter_frame_maps(src, refs, qindex, lam, mode_bits, bd=8,
                     bwd_mask=None, allow_compound=False, coarse_r=None,
                     rel_dists=None, row0=0, with_intra=True):
    """(intra, inter_cost_maps, sel_fields, mvbits16): the open-loop
    decision state of one inter frame against 1..3 references, as tensors
    on the device of ``src`` (a buf-aligned [H, W] plane in the sample type
    of ``bd``, ``device.SAMPLE_DTYPES``: uint8 at 8 bits, int16 at 10;
    ``refs`` a list of such planes).  CUDA planes run K5 -> K6 -> K7 per
    reference, K9 for the compound candidate, then K8, then one K1 launch
    for the intra maps of all omd.ALL_SHAPES, whose packed output
    ``intra`` is (``omd.unpack_decisions`` gives the maps); CPU planes
    run the plain versions.  MVs are quarter-pel (eighth-pel values,
    multiples of 2).

    Stripes: with ``row0`` > 0, ``src`` is a stripe of 64-row multiples
    starting at that global row, the references stay whole frames, and
    every output equals the same rows of the whole frame's run.  The
    intra maps need the stripe's halo rows, so a stripe's caller passes
    ``with_intra=False`` (intra_maps is then None); the compound
    candidate is not taken on stripes.

    ``bwd_mask[k]`` marks backward references and ``rel_dists[k]`` gives
    each reference's signed display distance (default -1 forward, +1
    backward); with ``allow_compound`` and references in both directions
    the averaged-compound candidate joins the selection as index K.
    ``sel_fields`` holds [H/16, W/16] maps: sel (0..K-1 single reference,
    K compound), mv_r/mv_c (the forward arm's MV for compound), mv1_r/
    mv1_c (the backward arm's MV, 0 elsewhere) and fwd_i/bwd_i (the
    references the compound candidate pairs, 0 without it)."""
    K = len(refs)
    if bwd_mask is None:
        bwd_mask = (False,) * K
    if rel_dists is None:
        rel_dists = tuple(1 if b else -1 for b in bwd_mask[:K])
    if coarse_r is None:
        coarse_r = bme.COARSE_R
    if not isinstance(coarse_r, (tuple, list)):
        coarse_r = (coarse_r,) * K
    do_comp = allow_compound and any(bwd_mask[:K]) and not all(bwd_mask[:K])
    if do_comp and row0:
        raise NotImplementedError("the compound candidate of a stripe (its "
                                  "joint search reads global positions)")
    if with_intra and row0:
        raise ValueError("the intra maps of a stripe need its halo rows "
                         "(omd.intra_decision's stripe mode): pass "
                         "with_intra=False")
    mvq_r, mvq_c, preds, sb_r, sb_c = [], [], [], [], []
    for k, ref in enumerate(refs):
        me = bme.frame_me(src, ref, coarse_r[k], ((16, 16), (64, 64)), row0)
        n_sby, n_sbx = me["grid"]
        mv_r16 = _nested_to_grid(me[(16, 16)][0], n_sby, n_sbx, 4, 4)
        mv_c16 = _nested_to_grid(me[(16, 16)][1], n_sby, n_sbx, 4, 4)
        r, c, pred = bme.subpel_refine16(src, ref, mv_r16, mv_c16, bd, row0)
        mvq_r.append(r)
        mvq_c.append(c)
        preds.append(pred)
        sb_r.append(me[(64, 64)][0].reshape(n_sby, n_sbx))
        sb_c.append(me[(64, 64)][1].reshape(n_sby, n_sbx))
    unit_args = (src, torch.stack(preds), torch.stack(mvq_r),
                 torch.stack(mvq_c), torch.stack(sb_r).contiguous(),
                 torch.stack(sb_c).contiguous())
    comp = None
    if do_comp:
        comp = compound_joint(unit_args[0], torch.stack(refs),
                              *unit_args[1:], bwd_mask, rel_dists, qindex,
                              bd)
    fields, mvb, inter_cost = inter_select(*unit_args, qindex, lam, bd,
                                           comp=comp)
    intra = None
    if with_intra:
        intra = omd.intra_decision_packed(src, qindex, lam, mode_bits, bd)
    return intra, inter_cost, fields, mvb


def inter_maps_dispatch(src, refs, buf_w, buf_h, qindex, lam, mode_bits,
                        bd, device, bwd_mask=None, allow_compound=False,
                        rel_dists=None):
    """Run inter_frame_maps on ``device`` and return numpy results.

    ``src`` and the entries of ``refs`` are buf-aligned host arrays or
    tensors of the sample type of ``bd`` already on ``device`` (the
    encoder uploads each coded picture's ME plane once).  Each reference's
    coarse reach follows its distance (bme.coarse_r_for_dist), and so do
    the compound candidate's mirrored seeds."""
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
        allow_compound=allow_compound, coarse_r=coarse_r,
        rel_dists=tuple(int(d) for d in rel_dists))
    intra = omd.unpack_decisions(to_host(intra).numpy(), omd.ALL_SHAPES,
                                 src_t.shape[1], src_t.shape[0])
    inter_cost = {s: to_host(c).numpy() for s, c in inter_cost.items()}
    sf = {k: to_host(v).numpy() for k, v in sf.items()}
    return intra, inter_cost, sf, to_host(mvb).numpy()
