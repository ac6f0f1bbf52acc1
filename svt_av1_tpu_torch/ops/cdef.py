"""CDEF: constrained directional enhancement filter (port of
svt_av1_tpu/ops/cdef.py; AV1 spec 7.15).

The constants, the nonskip map and the host preset pick of per-64x64
strength presets (``pick_cdef_presets``) are copies.  The codec runs only
the full-plane formulation, in two forms: plain PyTorch
(``find_dir_grid``, ``_PlaneCtx``, ``cdef_search_errs``,
``_cdef_apply_traced``, and for cdef_bits > 0 ``cdef_search_errs_fb_plain``
and ``cdef_frame_multi_plain``) and the CUDA kernels K3
``kernels/csrc/cdef_direction.cu`` (``cdef_direction``) and K4
``kernels/csrc/cdef_filter.cu`` (``cdef_search`` and ``cdef_apply``, and
their per-fb forms ``cdef_search_fb`` and ``cdef_apply_multi``).  The
reference's per-unit host filter (``cdef_frame``) and host strength
search belong to its host paths, which are not ported; its per-64x64
search and apply (``cdef_search_errs_fb``, ``cdef_frame_multi``) are host
numpy there and K4's per-fb forms here.

Notes of the reference module:

The reference filters 8x8 blocks one at a time inside a 64x64
filter-block loop with line/column buffers to preserve pre-CDEF
neighbors (EbCdef.c svt_cdef_filter_fb, svt_cdef_find_dir_c:133,
svt_cdef_filter_block_c:204; decoder loop EbDecCdef.c svt_cdef_block).
Because every filtered pixel depends only on *pre-CDEF* pixels, the whole
frame is a pure function of the deblocked frame, so the whole plane is
filtered at once with no sequential state.

Integer exactness: all math in int32 (the direction costs in int64),
bit-for-bit with the reference C.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..device import SAMPLE_DTYPES, to_device, to_host

CDEF_VERY_LARGE = 16384
CDEF_SEC_STRENGTHS = 4

# the full strength grid and the fast-preset subset (the reference's
# reduced cdef search at high presets, cdef_pick_method fast levels)
PRI_SET = (0, 1, 2, 4, 6, 8, 12, 15)
SEC_SET = (0, 1, 2, 3)
PRI_SET_FAST = (0, 2, 4, 8, 15)
SEC_SET_FAST = (0, 1, 2)

# cdef_directions as (row, col) offsets for taps k=0,1
# (EbCdef.c eb_cdef_directions, expressed stride-free)
DIRECTIONS = np.array([
    [[-1, 1], [-2, 2]],
    [[0, 1], [-1, 2]],
    [[0, 1], [0, 2]],
    [[0, 1], [1, 2]],
    [[1, 1], [2, 2]],
    [[1, 0], [2, 1]],
    [[1, 0], [2, 0]],
    [[1, 0], [2, -1]],
], np.int32)                 # [dir, k, (dy, dx)]


# --------------------------------------------------------------------------
# Direction search
# --------------------------------------------------------------------------

@functools.cache
def _dir_matrices():
    """One-hot [8, 15, 64] bin map M and [8, 15] cost weights W such that
    partial[d, b] = sum_p M[d,b,p] * (x[p] - 128) and
    cost[d] = sum_b W[d,b] * partial[d,b]^2 (svt_cdef_find_dir_c)."""
    M = np.zeros((8, 15, 64), np.int32)
    for i in range(8):
        for j in range(8):
            p = i * 8 + j
            M[0, i + j, p] += 1
            M[1, i + j // 2, p] += 1
            M[2, i, p] += 1
            M[3, 3 + i - j // 2, p] += 1
            M[4, 7 + i - j, p] += 1
            M[5, 3 - i // 2 + j, p] += 1
            M[6, j, p] += 1
            M[7, i // 2 + j, p] += 1
    div = [0, 840, 420, 280, 210, 168, 140, 120, 105]
    W = np.zeros((8, 15), np.int64)
    for d in (0, 4):
        for b in range(15):
            W[d, b] = div[min(b, 14 - b) + 1]
    for d in (2, 6):
        W[d, :8] = div[8]
    for d in (1, 3, 5, 7):
        for b in range(3):
            W[d, b] = div[2 * b + 2]
            W[d, 10 - b] = div[2 * (10 - (10 - b)) + 2]  # same table entry
        W[d, 3:8] = div[8]
    return M, W


# --------------------------------------------------------------------------
# Plain PyTorch version of the full-plane formulation (the JAX package's
# find_dir_grid / _PlaneCtx / cdef_search_errs / _cdef_apply_traced):
# every neighbor tap is a static slice of a CDEF_VERY_LARGE-padded plane,
# per-unit directions become 8 masked selects.  The direction cost runs
# in int64 (the digit arithmetic existed only because the TPU has none)
# and the strength-search SSEs are exact int64 sums.
# --------------------------------------------------------------------------

def _ceil_to(v: int, m: int) -> int:
    return -(-v // m) * m


def nonskip_grid(skips, mi_rows: int, mi_cols: int) -> np.ndarray:
    """[uh, uw] bool map of 8x8-luma units with any non-skip 4x4."""
    r1 = (mi_rows + 1) // 2
    c1 = (mi_cols + 1) // 2
    s = np.ones((r1 * 2, c1 * 2), bool)
    s[:mi_rows, :mi_cols] = skips[:mi_rows, :mi_cols] != 0
    unit_skip = s.reshape(r1, 2, c1, 2).all(axis=(1, 3))
    uh, uw = -(-mi_rows * 4 // 8), -(-mi_cols * 4 // 8)
    return ~unit_skip[:uh, :uw]


def _msb_int(x, nbits: int):
    """floor(log2(x)) for x >= 1 (0 for x < 1), exact via comparisons."""
    m = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for k in range(1, nbits):
        m = m + (x >= (1 << k)).to(torch.int32)
    return m


def _constrain_xp(diff, strength, damping: int):
    """Exact constrain() for per-pixel strengths."""
    s = strength.to(torch.int32)
    adiff = diff.abs()
    shift = (damping - _msb_int(s, 8)).clamp_min(0)
    mag = torch.minimum(adiff, (s - (adiff >> shift)).clamp_min(0))
    return torch.where(s > 0, diff.sign() * mag, 0).to(torch.int32)


def find_dir_grid(luma_units, coeff_shift: int):
    """Normative direction search over [uh, uw, 8, 8] unit blocks
    (svt_cdef_find_dir_c).  Returns (dirs [uh, uw] int32, var [uh, uw]
    int32); ties go to the first maximum."""
    M, W = _dir_matrices()
    dev = luma_units.device
    uh, uw = luma_units.shape[:2]
    x = (luma_units.reshape(uh, uw, 64).to(torch.int32) >> coeff_shift) \
        - 128
    # the one-hot bin sums are exact in float32 (|partial| < 2^18)
    mt = to_device(torch.as_tensor(
        M.reshape(8 * 15, 64).T.astype(np.float32)), dev)
    p = (x.to(torch.float32) @ mt).to(torch.int64).reshape(uh, uw, 8, 15)
    cost = (to_device(torch.as_tensor(W), dev) * p * p).sum(-1)   # [uh, uw, 8]
    best = torch.argmax(cost, dim=-1)
    alt = (best + 4) & 7
    var = (cost.gather(-1, best[..., None])
           - cost.gather(-1, alt[..., None]))[..., 0] >> 10
    return best.to(torch.int32), var.to(torch.int32)


def _units_of(plane_padded, fw: int, fh: int, bs: int):
    """[uh, uw, bs, bs] unit blocks of the VERY_LARGE-padded plane."""
    uh, uw = _ceil_to(fh, 8) // 8, _ceil_to(fw, 8) // 8
    inner = plane_padded[2:2 + uh * bs, 2:2 + uw * bs]
    return inner.reshape(uh, bs, uw, bs).transpose(1, 2)


def pad_very_large(plane, fw: int, fh: int, bs: int):
    """[H+4, W+4] plane with CDEF_VERY_LARGE outside the visible frame,
    H/W ceil-rounded so bs-sized units tile it exactly."""
    H = _ceil_to(fh, bs)
    Wd = _ceil_to(fw, bs)
    out = torch.full((H + 4, Wd + 4), CDEF_VERY_LARGE, dtype=torch.int32,
                     device=plane.device)
    out[2:2 + fh, 2:2 + fw] = plane[:fh, :fw].to(torch.int32)
    return out


def pad_halo(plane, fw: int, fh: int, bs: int, top=None, bottom=None):
    """``pad_very_large`` of a stripe of the frame, with the true rows of
    its neighbours where the frame continues: ``top`` [2, >= fw] the two
    rows above the stripe, ``bottom`` [2, >= fw] the two below it (None at
    the frame's top or bottom, which keeps CDEF_VERY_LARGE).  Columns
    outside [0, fw) stay CDEF_VERY_LARGE, corners included."""
    out = pad_very_large(plane, fw, fh, bs)
    if top is not None:
        out[0:2, 2:2 + fw] = top[:, :fw].to(torch.int32)
    if bottom is not None:
        out[2 + fh:4 + fh, 2:2 + fw] = bottom[:, :fw].to(torch.int32)
    return out


def _halo_pads(planes, fw: int, fh: int, halos):
    """Per plane, its ``pad_halo``: ``halos`` one (top, bottom) pair per
    plane (None entries, or None for all, give the plain frame pad)."""
    out = []
    for pli, plane in enumerate(planes):
        sub = 0 if pli == 0 else 1
        top, bottom = halos[pli] if halos is not None else (None, None)
        out.append(pad_halo(plane, fw >> sub, fh >> sub,
                            8 if pli == 0 else 4, top, bottom))
    return out


def _expand(unit_map, bs: int):
    return unit_map.repeat_interleave(bs, 0).repeat_interleave(bs, 1)


class _PlaneCtx:
    """Neighbor diffs / clamp bounds for one padded plane under a
    per-unit direction map."""

    def __init__(self, padded, dirs, bs: int):
        H, Wd = padded.shape[0] - 4, padded.shape[1] - 4
        x = padded[2:2 + H, 2:2 + Wd]
        self.x = x
        dmap = _expand(dirs, bs)
        masks = [(dmap == d) for d in range(8)]

        def tap(rot, k, sign):
            p = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
            for d in range(8):
                dy, dx = (int(v) for v in DIRECTIONS[(d + rot) & 7, k])
                dy, dx = sign * dy, sign * dx
                sl = padded[2 + dy:2 + dy + H, 2 + dx:2 + dx + Wd]
                p = torch.where(masks[d], sl, p)
            return p

        self.dp, self.ds = [], []
        mx, mn = x, x
        for k in range(2):
            for sign in (1, -1):
                p = tap(0, k, sign)
                mx = torch.maximum(mx, torch.where(p == CDEF_VERY_LARGE,
                                                   mx, p))
                mn = torch.minimum(mn, p)
                self.dp.append(p - x)
            for rot in (2, 6):
                for sign in (1, -1):
                    s = tap(rot, k, sign)
                    mx = torch.maximum(mx, torch.where(
                        s == CDEF_VERY_LARGE, mx, s))
                    mn = torch.minimum(mn, s)
                    self.ds.append(s - x)
        self.mx, self.mn = mx, mn

    def run(self, pri_map, sec_strength, damping: int, coeff_shift: int):
        """Filter with per-pixel primary strengths and a secondary
        strength (an int, or a per-pixel map); returns the filtered plane
        (call sites mask by eligibility)."""
        tap_idx = (pri_map >> coeff_shift) & 1
        pt0 = torch.where(tap_idx == 1, 3, 4)
        pt1 = torch.where(tap_idx == 1, 3, 2)
        sum_ = torch.zeros(self.x.shape, dtype=torch.int32,
                           device=self.x.device)
        for k, ptap in ((0, pt0), (1, pt1)):
            for sgn in range(2):
                sum_ = sum_ + ptap * _constrain_xp(self.dp[2 * k + sgn],
                                                   pri_map, damping)
        if torch.is_tensor(sec_strength) or sec_strength:
            sec = sec_strength if torch.is_tensor(sec_strength) \
                else torch.full_like(pri_map, sec_strength)
            for k, stap in ((0, 2), (1, 1)):
                for j in range(4):
                    sum_ = sum_ + stap * _constrain_xp(self.ds[4 * k + j],
                                                       sec, damping)
        y = self.x + ((8 + sum_ - (sum_ < 0).to(torch.int32)) >> 4)
        return torch.minimum(torch.maximum(y, self.mn), self.mx)


def _adjust_strength_xp(strength, var):
    """adjust_strength of a strength (an int, or a map shaped as var)."""
    v6 = var >> 6
    msb = _msb_int(v6, 26).clamp_max(12)
    out = (strength * (4 + msb) + 8) >> 4
    return torch.where(var > 0, out, 0).to(torch.int32)


def _strength_parts(strength: int, cs: int):
    """Coded pri*4+sec packing -> (pri, sec) in filter units (sec 3
    applies as 4)."""
    sec = strength % CDEF_SEC_STRENGTHS
    return ((strength // CDEF_SEC_STRENGTHS) << cs,
            (sec + (sec == 3)) << cs)


def _fb_sums(sq, fbpx: int, nvfb: int, nhfb: int):
    """[H, W] squared errors -> [nvfb, nhfb] sums per filter block of
    fbpx x fbpx samples."""
    H, W = sq.shape
    ph, pw = nvfb * fbpx, nhfb * fbpx
    sq = torch.nn.functional.pad(sq, (0, max(pw - W, 0), 0, max(ph - H, 0)))
    return sq[:ph, :pw].reshape(nvfb, fbpx, nhfb, fbpx).sum((1, 3))


def cdef_search_errs(source, recon, dirs, var, nonskip, fw: int, fh: int,
                     damping: int, bit_depth: int = 8,
                     pri_set=PRI_SET, sec_set=SEC_SET, padded_planes=None,
                     per_fb: bool = False):
    """SSE of every (pri, sec) strength combo over the in-frame non-skip
    pixels (plain PyTorch).  Returns (err_y, err_uv): exact int64
    [len(pri_set), len(sec_set)]; err_uv sums both chroma planes (None
    for luma alone).  ``padded_planes``: the planes already padded, one
    per plane of ``recon`` (a stripe's ``pad_halo``).  ``per_fb``: the
    sums per 64x64 filter block instead, [len(pri_set), len(sec_set),
    ceil(fh / 64), ceil(fw / 64)]."""
    cs = max(bit_depth - 8, 0)
    nonskip = nonskip.bool()
    nvfb, nhfb = -(-fh // 64), -(-fw // 64)
    errs = []
    for group in ((0,), (1, 2)):
        acc = None
        for pli in group:
            if pli >= len(recon):
                continue
            bs = 8 if pli == 0 else 4
            sub = 0 if pli == 0 else 1
            pw, ph = fw >> sub, fh >> sub
            padded = padded_planes[pli] if padded_planes is not None \
                else pad_very_large(recon[pli], pw, ph, bs)
            H, Wd = padded.shape[0] - 4, padded.shape[1] - 4
            keep = _expand(nonskip, bs)
            keep[ph:, :] = False
            keep[:, pw:] = False
            src = torch.zeros((H, Wd), dtype=torch.int32,
                              device=padded.device)
            src[:ph, :pw] = source[pli][:ph, :pw].to(torch.int32)
            ctx = {True: _PlaneCtx(padded, dirs, bs),
                   False: _PlaneCtx(padded, torch.zeros_like(dirs), bs)}
            dmp = damping + cs - (0 if pli == 0 else 1)
            e = []
            for pri in pri_set:
                p = pri << cs
                if pli == 0:
                    pri_map = _expand(_adjust_strength_xp(p, var), bs)
                else:
                    pri_map = torch.full((H, Wd), p, dtype=torch.int32,
                                         device=padded.device)
                c = ctx[bool(p)]
                for sec in sec_set:
                    s_ = (sec + (sec == 3)) << cs
                    filt = c.x if p == 0 and s_ == 0 else \
                        c.run(pri_map, s_, dmp, cs)
                    d = (filt - src).to(torch.int64)
                    e.append(_fb_sums(torch.where(keep, d * d, 0),
                                      64 >> sub, nvfb, nhfb) if per_fb
                             else (d * d)[keep].sum())
            plane_err = torch.stack(e).reshape(len(pri_set), len(sec_set),
                                               *e[0].shape)
            acc = plane_err if acc is None else acc + plane_err
        errs.append(acc)
    return errs[0], errs[1]


def cdef_apply_plain(planes, nonskip, dirs, var, y_strength: int,
                     uv_strength: int, damping: int, fw: int, fh: int,
                     bd: int, halos=None):
    """Normative CDEF apply given the (dirs, var) unit maps (plain
    PyTorch).  Returns full-size planes: the in-frame region filtered
    where its unit is non-skip, everything else copied.  ``halos``: per
    plane the (top, bottom) neighbour rows of a stripe (``pad_halo``)."""
    return _apply_padded(planes, _halo_pads(planes, fw, fh, halos), nonskip,
                         dirs, var, y_strength, uv_strength, damping, fw, fh,
                         bd)


def _apply_padded(planes, pads, nonskip, dirs, var, y_strength: int,
                  uv_strength: int, damping: int, fw: int, fh: int, bd: int):
    cs = max(bd - 8, 0)
    nonskip = nonskip.bool()
    out = []
    for pli, plane in enumerate(planes):
        bs = 8 if pli == 0 else 4
        sub = 0 if pli == 0 else 1
        pw, ph = fw >> sub, fh >> sub
        pri, sec = _strength_parts(y_strength if pli == 0 else uv_strength,
                                   cs)
        padded = pads[pli]
        ctx = _PlaneCtx(padded, dirs if pri > 0 else torch.zeros_like(dirs),
                        bs)
        if pli == 0:
            pri_map = _expand(_adjust_strength_xp(pri, var), bs)
        else:
            pri_map = torch.full(ctx.x.shape, pri, dtype=torch.int32,
                                 device=plane.device)
        filt = ctx.run(pri_map, sec, damping + cs - (0 if pli == 0 else 1),
                       cs)
        keep = _expand(nonskip, bs) & bool(pri > 0 or sec > 0)
        o = plane.to(torch.int32).clone()
        o[:ph, :pw] = torch.where(keep, filt, ctx.x)[:ph, :pw]
        out.append(o)
    return out


def _cdef_apply_traced(planes, nonskip, y_strength: int, uv_strength: int,
                       damping: int, fw: int, fh: int, bd: int,
                       padded_planes=None):
    """Direction search + apply (the reference's traced apply body);
    ``padded_planes`` as for ``cdef_search_errs``."""
    pads = padded_planes if padded_planes is not None \
        else _halo_pads(planes, fw, fh, None)
    dirs, var = find_dir_grid(_units_of(pads[0], fw, fh, 8), max(bd - 8, 0))
    return _apply_padded(planes, pads, nonskip, dirs, var, y_strength,
                         uv_strength, damping, fw, fh, bd)


def direction_plain(plane, fw: int, fh: int, coeff_shift: int = 0):
    """Plain version of K3: ``find_dir_grid`` of the frame's 8x8 units
    (a unit reads only its own samples)."""
    padded = pad_very_large(plane, fw, fh, 8)
    return find_dir_grid(_units_of(padded, fw, fh, 8), coeff_shift)


def search_plain(source, recon, dirs, var, nonskip, fw: int, fh: int,
                 damping: int, bit_depth: int = 8, pri_set=PRI_SET,
                 sec_set=SEC_SET, halos=None):
    """Plain version of K4's search: ``cdef_search_errs`` of the planes
    padded with the stripe's neighbour rows ``halos`` (see
    ``cdef_search``)."""
    return cdef_search_errs(source, recon, dirs, var, nonskip, fw, fh,
                            damping, bit_depth, pri_set, sec_set,
                            _halo_pads(recon, fw, fh, halos))


def cdef_search_errs_fb_plain(source, recon, dirs, var, nonskip, fw: int,
                              fh: int, damping: int, bit_depth: int = 8):
    """Plain version of K4's per-fb search (the reference's
    cdef_search_errs_fb): the squared error of every combination of the
    full grid per 64x64 filter block, exact int64 [32, ceil(fh / 64),
    ceil(fw / 64)] for luma and for the two chroma planes together (None
    for luma alone)."""
    err_y, err_uv = cdef_search_errs(source, recon, dirs, var, nonskip, fw,
                                     fh, damping, bit_depth, per_fb=True)
    flat = [None if e is None else e.reshape(-1, *e.shape[2:])
            for e in (err_y, err_uv)]
    return flat[0], flat[1]


def _unit_strengths(strengths, idx_units, cs: int):
    """Per 8x8 unit (pri, sec) in filter units: the coded strengths
    (pri*4+sec) of a preset list picked by the units' indices (sec 3
    applies as 4)."""
    s = to_device(torch.as_tensor(strengths, dtype=torch.int32),
                  idx_units.device)[idx_units]
    sec = s % CDEF_SEC_STRENGTHS
    return (s // CDEF_SEC_STRENGTHS) << cs, \
        (sec + (sec == 3).to(torch.int32)) << cs


def cdef_frame_multi_plain(planes, nonskip, dirs, var, y_list, uv_list,
                           idx_grid, damping: int, fw: int, fh: int,
                           bd: int):
    """Plain version of K4's per-fb apply (the reference's
    cdef_frame_multi, spec 7.15.1): normative CDEF of the int32 planes
    where each 64x64 filter block takes the strengths ``y_list[k]``,
    ``uv_list[k]`` of its index k in ``idx_grid`` [ceil(fh / 64),
    ceil(fw / 64)].  Each unit's direction is 0 where its coded primary
    is 0, and luma primaries are adjusted by the unit's variance, as the
    frame-level apply does.  Returns full-size planes: the in-frame
    region filtered where its unit is non-skip, everything else
    copied."""
    cs = max(bd - 8, 0)
    nonskip = nonskip.bool()
    uh, uw = nonskip.shape
    idx = to_device(torch.as_tensor(idx_grid), nonskip.device).long()
    idx_units = _expand(idx, 8)[:uh, :uw]
    pads = _halo_pads(planes, fw, fh, None)
    out = []
    for pli, plane in enumerate(planes):
        bs = 8 if pli == 0 else 4
        sub = 0 if pli == 0 else 1
        pw, ph = fw >> sub, fh >> sub
        pri, sec = _unit_strengths(y_list if pli == 0 else uv_list,
                                   idx_units, cs)
        ctx = _PlaneCtx(pads[pli], torch.where(pri > 0, dirs, 0), bs)
        pri_map = _expand(_adjust_strength_xp(pri, var) if pli == 0
                          else pri, bs)
        filt = ctx.run(pri_map, _expand(sec, bs),
                       damping + cs - (0 if pli == 0 else 1), cs)
        keep = _expand(nonskip & ((pri > 0) | (sec > 0)), bs)
        o = plane.to(torch.int32).clone()
        o[:ph, :pw] = torch.where(keep, filt, ctx.x)[:ph, :pw]
        out.append(o)
    return out


# --------------------------------------------------------------------------
# K3 / K4: the CUDA kernels and their wrappers
# --------------------------------------------------------------------------

def _check_plane(t, name, dtypes=(torch.int32,)):
    if t.dtype not in dtypes or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name}: contiguous [H, W] plane of {dtypes} "
                         f"expected, got {t.dtype} {tuple(t.shape)}")


def _check_units(dirs, var, nonskip, fw: int, fh: int):
    """The kernels index the unit maps by position: [ceil(fh/8),
    ceil(fw/8)] int32 dirs/var and a bool or uint8 nonskip map."""
    shape = (_ceil_to(fh, 8) // 8, _ceil_to(fw, 8) // 8)
    for t, name in ((dirs, "dirs"), (var, "var")):
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name}: contiguous int32 {shape} expected, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if tuple(nonskip.shape) != shape:
        raise ValueError(f"nonskip: {shape} expected, got "
                         f"{tuple(nonskip.shape)}")


_P, _I = ctypes.c_void_p, ctypes.c_int


def _nonskip_bytes(nonskip):
    """The nonskip map as the kernels read it, one byte per unit (a
    contiguous bool map is viewed, not copied)."""
    if nonskip.dtype == torch.bool and nonskip.is_contiguous():
        return nonskip.view(torch.uint8)
    return nonskip.to(torch.uint8).contiguous()


def cdef_direction(plane, fw: int, fh: int, coeff_shift: int = 0):
    """K3: CDEF direction and variance per 8x8 luma unit of the
    (deblocked) luma plane; samples outside [0, fh) x [0, fw) read as
    CDEF_VERY_LARGE.  Returns (dirs, var) int32 [ceil(fh/8), ceil(fw/8)].
    CPU tensors take find_dir_grid; CUDA tensors launch the kernel once
    (both maps are views of one allocation)."""
    if plane.device.type == "cpu":
        return direction_plain(plane, fw, fh, coeff_shift)
    cdef_direction.calls += 1
    if plane.device.type != "cuda":
        raise ValueError(f"unsupported device {plane.device}")
    _check_plane(plane, "cdef_direction")
    H, W = plane.shape
    if fh > H or fw > W:
        raise ValueError("frame exceeds the plane")
    from ..kernels.build import check_launch, cuda_fn, ptr, raw_stream

    fn = cuda_fn("cdef_direction", "cdef_direction_launch",
             (_P,) + (_I,) * 5 + (_P,) * 3)
    uh, uw = _ceil_to(fh, 8) // 8, _ceil_to(fw, 8) // 8
    dirs, var = torch.empty((2, uh, uw), dtype=torch.int32,
                            device=plane.device)
    err = fn(ptr(plane), H, W, fh, fw, coeff_shift, ptr(dirs), ptr(var),
             raw_stream(plane))
    check_launch("cdef_direction", err)
    cdef_direction.launches += 1
    return dirs, var


cdef_direction.launches = cdef_direction.calls = 0


def _pack(values, bits: int) -> int:
    out = 0
    for i, v in enumerate(values):
        assert 0 <= v < (1 << bits)
        out |= int(v) << (bits * i)
    return out


def _halo_ptrs(halos, pli, plane):
    """(top, bottom) device pointers of one plane's stripe rows (None
    where absent), after checking them: contiguous int32 [2, W] beside
    the plane."""
    from ..kernels.build import ptr

    pair = halos[pli] if halos is not None else (None, None)
    out = []
    for t in pair:
        if t is None:
            out.append(None)
            continue
        if t.dtype != torch.int32 or tuple(t.shape) != (2, plane.shape[1]) \
                or not t.is_contiguous() or t.device != plane.device:
            raise ValueError(f"CDEF halo rows must be contiguous int32 "
                             f"(2, {plane.shape[1]}) beside the plane")
        out.append(ptr(t))
    return out


def _arr(ctype, values):
    """A C array of the values."""
    return (ctype * len(values))(*values)


def cdef_search(source, recon, dirs, var, nonskip, fw: int, fh: int,
                damping: int, bit_depth: int = 8, pri_set=PRI_SET,
                sec_set=SEC_SET, halos=None):
    """K4 search: exact int64 SSE of every (pri, sec) combo of the grid
    for luma and for the two chroma planes together (source: narrow
    planes, uint8 at ``bit_depth`` 8 and int16 at 10
    (``device.SAMPLE_DTYPES``);
    recon: int32 planes, both full size; luma alone gives err_uv None).
    Samples lie in [0, 2^bit_depth).  ``halos``: per plane the (top,
    bottom) [2, W] int32 rows around a stripe of the frame, read where the
    frame continues (None:
    the frame's edge, CDEF_VERY_LARGE).  CPU tensors take search_plain;
    CUDA tensors launch the kernel once for all the planes."""
    if recon[0].device.type == "cpu":
        return search_plain(source, recon, dirs, var, nonskip, fw, fh,
                            damping, bit_depth, pri_set, sec_set, halos)
    cdef_search.calls += 1
    acc = _search_launch("cdef_search_launch", (), (),
                         2 * len(pri_set) * len(sec_set), source, recon,
                         dirs, var, nonskip, fw, fh, damping, bit_depth,
                         pri_set, sec_set, halos)
    cdef_search.launches += 1
    errs = acc.reshape(2, len(pri_set), len(sec_set))
    return errs[0], (errs[1] if len(recon) > 1 else None)


cdef_search.launches = cdef_search.calls = 0


def _search_launch(entry: str, extra_types: tuple, extra_args: tuple,
                   n_err: int, source, recon, dirs, var, nonskip, fw: int,
                   fh: int, damping: int, bit_depth: int, pri_set, sec_set,
                   halos):
    """Check the planes of a K4 search, launch its entry ``entry`` (the
    common arguments, then ``extra_args``) and return the int64
    accumulator of ``n_err`` totals it added to."""
    if recon[0].device.type != "cuda":
        raise ValueError(f"unsupported device {recon[0].device}")
    from ..kernels.build import check_launch, cuda_fn, ptr, raw_stream

    _check_units(dirs, var, nonskip, fw, fh)
    n = len(recon)
    if not 1 <= n <= 3 or len(source) < n:
        raise ValueError("cdef_search takes 1 to 3 planes and their sources")
    if len(pri_set) > 8 or len(sec_set) > 4:
        raise ValueError("cdef_search takes at most 8 x 4 strengths")
    src_dtype = SAMPLE_DTYPES.get(bit_depth)
    if src_dtype is None:
        # a warp's sum of 256 squared errors must stay below 2^32
        raise ValueError(f"cdef_search takes bit depths 8 and 10, not "
                         f"{bit_depth}")
    fn = cuda_fn("cdef_filter", entry,
             (_I, _P, _P, _I) + (_P,) * 6 + (_P,) * 3 + (_I,)
             + (ctypes.c_uint, _I, ctypes.c_uint, _I) + (_I,) * 2
             + extra_types + (_P,) * 2)
    cs = max(bit_depth - 8, 0)
    ns = _nonskip_bytes(nonskip)
    dims, halo = [], []
    for pli in range(n):
        rec, src = recon[pli], source[pli]
        _check_plane(rec, "cdef_search recon")
        _check_plane(src, "cdef_search source", (src_dtype,))
        if rec.shape != src.shape or rec.device != recon[0].device \
                or src.device != rec.device:
            raise ValueError("source and recon planes differ in shape or "
                             "device")
        sub = 0 if pli == 0 else 1
        dims.append((*rec.shape, fh >> sub, fw >> sub))
        halo.append(_halo_ptrs(halos, pli, rec))
    acc = torch.zeros(n_err, dtype=torch.int64, device=recon[0].device)

    err = fn(n, _arr(_P, [ptr(r) for r in recon[:n]]),
             _arr(_P, [ptr(s) for s in source[:n]]),
             source[0].element_size(),
             _arr(_P, [t for t, _ in halo]), _arr(_P, [b for _, b in halo]),
             *(_arr(_I, [d[i] for d in dims]) for i in range(4)),
             ptr(dirs), ptr(var), ptr(ns), ns.shape[1], _pack(pri_set, 4),
             len(pri_set), _pack(sec_set, 2), len(sec_set), damping + cs,
             cs, *extra_args, ptr(acc), raw_stream(recon[0]))
    check_launch(entry, err)
    return acc


def cdef_apply(planes, nonskip, dirs, var, y_strength: int,
               uv_strength: int, damping: int, fw: int, fh: int, bd: int,
               halos=None):
    """K4 apply: normative CDEF of the int32 planes at the coded
    strengths (pri*4+sec), given the (dirs, var) unit maps; ``halos`` as
    for ``cdef_search``.  Returns new full-size planes, the input left as
    it is.  CPU tensors take cdef_apply_plain; CUDA tensors launch the
    kernel once for all the planes.

    The kernel keeps the taps as 16-bit values: the planes must hold
    samples in [0, 2^bd), bd <= 12, as every reconstruction does."""
    if planes[0].device.type == "cpu":
        return cdef_apply_plain(planes, nonskip, dirs, var, y_strength,
                                uv_strength, damping, fw, fh, bd, halos)
    cdef_apply.calls += 1
    cs = max(bd - 8, 0)
    out = _apply_launch("cdef_apply_launch", (), (), planes, nonskip, dirs,
                        var, [_strength_parts(y_strength if p == 0
                                              else uv_strength, cs)
                              for p in range(len(planes))],
                        damping, fw, fh, bd, halos)
    cdef_apply.launches += 1
    return out


cdef_apply.launches = cdef_apply.calls = 0


def _apply_launch(entry: str, extra_types: tuple, extra_args: tuple, planes,
                  nonskip, dirs, var, strengths, damping: int, fw: int,
                  fh: int, bd: int, halos):
    """Check the planes of a K4 apply, launch its entry ``entry`` (the
    common arguments, then ``extra_args``) with each plane's (pri, sec)
    pair ``strengths`` and return the new planes."""
    if planes[0].device.type != "cuda":
        raise ValueError(f"unsupported device {planes[0].device}")
    from ..kernels.build import check_launch, cuda_fn, ptr, raw_stream

    _check_units(dirs, var, nonskip, fw, fh)
    n = len(planes)
    if not 1 <= n <= 3:
        raise ValueError("cdef_apply takes 1 to 3 planes")
    fn = cuda_fn("cdef_filter", entry,
             (_I, _P, _P) + (_P,) * 3 + (_I,) * 3 + extra_types + (_P,))
    cs = max(bd - 8, 0)
    ns = _nonskip_bytes(nonskip)
    # per plane: (in, out, top, bottom) and (H, W, ph, pw, pri, sec)
    ptrs, dims, out = [], [], []
    for pli, plane in enumerate(planes):
        _check_plane(plane, "cdef_apply")
        if plane.device != planes[0].device:
            raise ValueError("cdef_apply planes lie on different devices")
        o = torch.empty_like(plane)
        sub = int(pli > 0)
        ptrs += [plane.data_ptr(), o.data_ptr(),
                 *(_halo_ptrs(halos, pli, plane) if halos is not None
                   else (None, None))]
        dims += [*plane.shape, fh >> sub, fw >> sub, *strengths[pli]]
        out.append(o)
    err = fn(n, _arr(_P, ptrs), _arr(_I, dims), ptr(dirs), ptr(var),
             ptr(ns), ns.shape[1], damping + cs, cs, *extra_args,
             raw_stream(planes[0]))
    check_launch(entry, err)
    return out


# --------------------------------------------------------------------------
# Search + apply on the device (the fused chain's CDEF stage and the
# standalone encoder entries)
# --------------------------------------------------------------------------

def pick_strength(err, pri_set, sec_set) -> int:
    """First minimum of the [pri, sec] error grid, coded pri*4+sec."""
    i = int(to_host(torch.argmin(err.reshape(-1))))
    return pri_set[i // len(sec_set)] * CDEF_SEC_STRENGTHS \
        + sec_set[i % len(sec_set)]


def search_apply(source, planes, nonskip, fw: int, fh: int, damping: int,
                 bd: int, pri_set=PRI_SET, sec_set=SEC_SET):
    """Direction search, strength search and apply of the winners on
    the planes' device.  Returns (planes, y_strength, uv_strength)."""
    cs = max(bd - 8, 0)
    dirs, var = cdef_direction(planes[0], fw, fh, cs)
    err_y, err_uv = cdef_search(source, planes, dirs, var, nonskip, fw, fh,
                                damping, bd, pri_set, sec_set)
    ystr = pick_strength(err_y, pri_set, sec_set)
    uvstr = pick_strength(err_uv, pri_set, sec_set)
    out = cdef_apply(planes, nonskip, dirs, var, ystr, uvstr, damping, fw,
                     fh, bd)
    return out, ystr, uvstr


def _device_planes(planes, device):
    return [to_device(torch.from_numpy(np.ascontiguousarray(p, np.int32)),
                      device) for p in planes]


def cdef_search_apply_device(source, recon, skips, mi_rows, mi_cols,
                             damping, bit_depth=8, pri_set=PRI_SET,
                             sec_set=SEC_SET):
    """Strength search (full grid argmin) + normative apply on the
    device of ``source`` (narrow device planes).  Returns (int32 numpy
    planes, y_strength, uv_strength); None when nothing is filtered."""
    if len(recon) != 3:
        raise NotImplementedError("CDEF on the device needs 3 planes")
    ns = nonskip_grid(skips, mi_rows, mi_cols)
    if not ns.any():
        return None
    dev = source[0].device
    out, ystr, uvstr = search_apply(
        source, _device_planes(recon, dev),
        to_device(torch.from_numpy(ns), dev), mi_cols * 4, mi_rows * 4,
        damping, bit_depth, pri_set, sec_set)
    return [to_host(o).numpy() for o in out], ystr, uvstr


# --------------------------------------------------------------------------
# Per-64x64 strength presets (cdef_bits > 0): K4's per-fb search and apply,
# and the preset pick on the host (finish_cdef_search /
# joint_strength_search_dual, EbEncCdef.c:1140; copies of the reference's
# _search_one_dual, joint_strength_search_dual and pick_cdef_presets)
# --------------------------------------------------------------------------

CDEF_STRENGTH_BITS = 6


def cdef_search_fb(source, recon, dirs, var, nonskip, fw: int, fh: int,
                   damping: int, bit_depth: int = 8):
    """K4's per-fb search: exact int64 squared errors of every combination
    of the full grid (PRI_SET x SEC_SET) per 64x64 filter block, [32,
    ceil(fh / 64), ceil(fw / 64)] for luma and for the two chroma planes
    together (None for luma alone); the planes as for ``cdef_search``.
    CPU tensors take cdef_search_errs_fb_plain; CUDA tensors launch the
    kernel once for all the planes."""
    if recon[0].device.type == "cpu":
        return cdef_search_errs_fb_plain(source, recon, dirs, var, nonskip,
                                         fw, fh, damping, bit_depth)
    cdef_search_fb.calls += 1
    nvfb, nhfb = -(-fh // 64), -(-fw // 64)
    acc = _search_launch("cdef_search_fb_launch", (_I, _I), (nvfb, nhfb),
                         2 * len(PRI_SET) * len(SEC_SET) * nvfb * nhfb,
                         source, recon, dirs, var, nonskip, fw, fh, damping,
                         bit_depth, PRI_SET, SEC_SET, None)
    cdef_search_fb.launches += 1
    errs = acc.reshape(2, -1, nvfb, nhfb)
    return errs[0], (errs[1] if len(recon) > 1 else None)


cdef_search_fb.launches = cdef_search_fb.calls = 0


def _strength_pack(strengths) -> int:
    """A preset list of at most 8 coded strengths (pri*4+sec), 6 bits
    each, as the per-fb apply reads it."""
    if not 1 <= len(strengths) <= 8:
        raise ValueError("a CDEF preset list holds 1 to 8 strengths")
    return _pack(strengths, CDEF_STRENGTH_BITS)


# The per-fb apply's grid by value in the kernel's parameters: 3 bits per
# filter block, up to the 128 x 68 blocks of AV1's largest level-6.3
# picture (8192 x 4352; cdef_filter.cu kGridBlocks).  A larger grid goes to
# the card as a uint8 tensor.
FB_GRID_BLOCKS = 128 * 68
_GRID_WEIGHTS = (1 << np.arange(0, 30, 3)).astype(np.uint32)


def pack_fb_grid(idx: np.ndarray, n_presets: int) -> np.ndarray:
    """The filter blocks' preset indices as the per-fb apply reads them by
    value: 3 bits per block, row-major, 10 blocks to a uint32 word, block k
    at bits [3j, 3j + 3) of word k // 10, j = k % 10.  Raises ValueError
    for an index outside [0, n_presets) (n_presets <= 8)."""
    n = idx.size
    r = np.zeros(-(-n // 10) * 10, np.uint32)
    r[:n] = idx.reshape(-1)           # a negative index wraps past 8
    if r.max() >= n_presets:
        raise ValueError("idx_grid indexes past the preset lists")
    return r.reshape(-1, 10) @ _GRID_WEIGHTS


def cdef_apply_multi(planes, nonskip, dirs, var, y_list, uv_list, idx_grid,
                     damping: int, fw: int, fh: int, bd: int):
    """K4's per-fb apply: normative CDEF of the int32 planes with the
    strengths of each 64x64 filter block's index in ``idx_grid`` (a host
    array of ints [ceil(fh / 64), ceil(fw / 64)], entries < len(y_list))
    into the coded lists ``y_list`` and ``uv_list`` (at most 8 each), given
    the (dirs, var) unit maps.  Returns new full-size planes, the input left
    as it is.  CPU tensors take cdef_frame_multi_plain; CUDA tensors launch
    the kernel once for all the planes, the grid checked and packed on the
    host and passed by value (no copy to the card) up to FB_GRID_BLOCKS
    blocks, past them copied to the card.  Samples as for ``cdef_apply``."""
    if planes[0].device.type == "cpu":
        return cdef_frame_multi_plain(planes, nonskip, dirs, var, y_list,
                                      uv_list, idx_grid, damping, fw, fh,
                                      bd)
    cdef_apply_multi.calls += 1
    nvfb, nhfb = -(-fh // 64), -(-fw // 64)
    if len(y_list) != len(uv_list):
        raise ValueError("the luma and chroma preset lists differ in length")
    packs = (_strength_pack(y_list), _strength_pack(uv_list))
    idx = np.asarray(idx_grid)
    if idx.shape != (nvfb, nhfb):
        raise ValueError(f"idx_grid: {(nvfb, nhfb)} expected, got "
                         f"{idx.shape}")
    if idx.size <= FB_GRID_BLOCKS:
        grid = pack_fb_grid(idx, len(y_list))
        grid_ptr, idx_ptr = grid.ctypes.data, None
    else:
        if idx.min() < 0 or idx.max() >= len(y_list):
            raise ValueError("idx_grid indexes past the preset lists")
        dev_idx = to_device(torch.from_numpy(idx.astype(np.uint8)),
                            planes[0].device)
        grid_ptr, idx_ptr = None, dev_idx.data_ptr()
    out = _apply_launch("cdef_apply_multi_launch",
                        (ctypes.c_ulonglong, ctypes.c_ulonglong, _P, _P, _I,
                         _I),
                        (*packs, grid_ptr, idx_ptr, nvfb, nhfb), planes,
                        nonskip, dirs, var, [(0, 0)] * len(planes), damping,
                        fw, fh, bd, None)
    cdef_apply_multi.launches += 1
    return out


cdef_apply_multi.launches = cdef_apply_multi.calls = 0


def _search_one_dual(lev_y, lev_uv, i, my, muv):
    """Add strength pair i minimizing the total min-over-set mse
    (svt_search_one_dual_c, EbEncCdef.c:1070).  my/muv: [n_fb, NC]."""
    n_fb, nc = my.shape
    if i > 0:
        cur = np.min(my[:, lev_y[:i]] + muv[:, lev_uv[:i]], axis=1)
    else:
        cur = np.full(n_fb, np.inf, my.dtype)
    cand = my[:, :, None] + muv[:, None, :]              # [n_fb, NC, NC]
    tot = np.minimum(cur[:, None, None], cand).sum(0)    # [NC, NC]
    j = int(np.argmin(tot))
    lev_y[i], lev_uv[i] = j // nc, j % nc
    return float(tot.ravel()[j])


def joint_strength_search_dual(my, muv, nb_strengths: int):
    """Greedy + refinement set search (joint_strength_search_dual,
    EbEncCdef.c:1140).  Returns (lev_y, lev_uv, total_mse)."""
    lev_y = np.zeros(nb_strengths, np.int64)
    lev_uv = np.zeros(nb_strengths, np.int64)
    best = np.inf
    for i in range(nb_strengths):
        best = _search_one_dual(lev_y, lev_uv, i, my, muv)
    for _ in range(4 * nb_strengths):
        lev_y[:-1] = lev_y[1:]
        lev_uv[:-1] = lev_uv[1:]
        best = _search_one_dual(lev_y, lev_uv, nb_strengths - 1, my, muv)
    return lev_y, lev_uv, best


def pick_cdef_presets(mse_y, mse_uv, eligible, lambda_sse: int,
                      pri_set=(0, 1, 2, 4, 6, 8, 12, 15),
                      sec_set=(0, 1, 2, 3)):
    """finish_cdef_search port: choose cdef_bits (0..3), the strength
    lists and the per-fb indices minimizing mse + lambda * signalling.

    mse_y/mse_uv: [NC, nvfb, nhfb]; eligible: [nvfb, nhfb] bool (fbs
    with any non-skip unit).  Returns (cdef_bits, y_list, uv_list,
    idx_grid [nvfb, nhfb])."""
    combos = [(p, s) for p in pri_set for s in sec_set]
    nc = len(combos)
    el = np.asarray(eligible, bool)
    my = np.asarray(mse_y, np.float64).reshape(nc, -1).T[el.ravel()]
    muv = np.asarray(mse_uv, np.float64).reshape(nc, -1).T[el.ravel()]
    n_fb = my.shape[0]
    if n_fb == 0:
        return 0, (0,), (0,), np.zeros(el.shape, np.int32)

    best_cost = np.inf
    best = None
    for bits in range(4):
        nb = 1 << bits
        lev_y, lev_uv, tot = joint_strength_search_dual(my, muv, nb)
        total_bits = n_fb * bits + nb * CDEF_STRENGTH_BITS * 2
        rate = 512 * total_bits
        dist = int(tot) * 16
        cost = ((rate * lambda_sse + 256) >> 9) + (dist << 7)
        if cost < best_cost:
            best_cost = cost
            best = (bits, lev_y.copy(), lev_uv.copy())
    bits, lev_y, lev_uv = best
    y_list = tuple(combos[int(k)][0] * CDEF_SEC_STRENGTHS
                   + combos[int(k)][1] for k in lev_y)
    uv_list = tuple(combos[int(k)][0] * CDEF_SEC_STRENGTHS
                    + combos[int(k)][1] for k in lev_uv)
    sel = my[:, lev_y] + muv[:, lev_uv]                # [n_fb, nb]
    gi = np.argmin(sel, axis=1).astype(np.int32)
    idx_grid = np.zeros(el.shape, np.int32)
    idx_grid[el] = gi
    return bits, y_list, uv_list, idx_grid


def eligible_fbs(nonskip: np.ndarray, fw: int, fh: int) -> np.ndarray:
    """[ceil(fh / 64), ceil(fw / 64)] bool: the filter blocks with any
    non-skip 8x8 unit, the ones the preset search weighs."""
    uh, uw = nonskip.shape
    nvfb, nhfb = (fh + 63) // 64, (fw + 63) // 64
    el = np.zeros((nvfb * 8, nhfb * 8), bool)
    el[:uh, :uw] = nonskip
    return el.reshape(nvfb, 8, nhfb, 8).any(axis=(1, 3))


def search_apply_multi(source, planes, nonskip, fw: int, fh: int,
                       damping: int, bd: int, lambda_sse: int):
    """The per-64x64 preset search and apply on the planes' device: K3's
    directions, K4's per-fb search, the preset pick on the host (from the
    exact sums as float64) and K4's per-fb apply of the picks.  Returns
    (planes, cdef_bits, y_list, uv_list, idx_grid)."""
    dirs, var = cdef_direction(planes[0], fw, fh, max(bd - 8, 0))
    err_y, err_uv = cdef_search_fb(source, planes, dirs, var, nonskip, fw,
                                   fh, damping, bd)
    eligible = eligible_fbs(to_host(nonskip).numpy(), fw, fh)
    bits, y_list, uv_list, idx_grid = pick_cdef_presets(
        to_host(err_y).numpy(), to_host(err_uv).numpy(), eligible,
        lambda_sse)
    out = cdef_apply_multi(planes, nonskip, dirs, var, y_list, uv_list,
                           idx_grid, damping, fw, fh, bd)
    return out, bits, y_list, uv_list, idx_grid
