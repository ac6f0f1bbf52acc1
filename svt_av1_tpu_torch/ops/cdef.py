"""CDEF: constrained directional enhancement filter (port of
svt_av1_tpu/ops/cdef.py; AV1 spec 7.15).

The constants and the nonskip map are copies.  The encoder runs only
the full-plane formulation, in two forms: plain PyTorch
(``find_dir_grid``, ``_PlaneCtx``, ``cdef_search_errs``,
``_cdef_apply_traced``) and the CUDA kernels K3
``kernels/csrc/cdef_direction.cu`` (``cdef_direction``) and K4
``kernels/csrc/cdef_filter.cu`` (``cdef_search`` and ``cdef_apply``).
The reference's per-unit host filter (``cdef_frame``) and host strength
search belong to its decoder and host paths, which are not ported.

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
    mt = torch.as_tensor(M.reshape(8 * 15, 64).T.astype(np.float32),
                         device=dev)
    p = (x.to(torch.float32) @ mt).to(torch.int64).reshape(uh, uw, 8, 15)
    cost = (torch.as_tensor(W, device=dev) * p * p).sum(-1)   # [uh, uw, 8]
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

    def run(self, pri_map, sec_strength: int, damping: int,
            coeff_shift: int):
        """Filter with per-pixel primary strengths; returns the filtered
        plane (call sites mask by eligibility)."""
        tap_idx = (pri_map >> coeff_shift) & 1
        pt0 = torch.where(tap_idx == 1, 3, 4)
        pt1 = torch.where(tap_idx == 1, 3, 2)
        sum_ = torch.zeros(self.x.shape, dtype=torch.int32,
                           device=self.x.device)
        for k, ptap in ((0, pt0), (1, pt1)):
            for sgn in range(2):
                sum_ = sum_ + ptap * _constrain_xp(self.dp[2 * k + sgn],
                                                   pri_map, damping)
        if sec_strength:
            sec = torch.full_like(pri_map, sec_strength)
            for k, stap in ((0, 2), (1, 1)):
                for j in range(4):
                    sum_ = sum_ + stap * _constrain_xp(self.ds[4 * k + j],
                                                       sec, damping)
        y = self.x + ((8 + sum_ - (sum_ < 0).to(torch.int32)) >> 4)
        return torch.minimum(torch.maximum(y, self.mn), self.mx)


def _adjust_strength_xp(strength: int, var):
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


def cdef_search_errs(source, recon, dirs, var, nonskip, fw: int, fh: int,
                     damping: int, bit_depth: int = 8,
                     pri_set=PRI_SET, sec_set=SEC_SET, padded_planes=None):
    """SSE of every (pri, sec) strength combo over the in-frame non-skip
    pixels (plain PyTorch).  Returns (err_y, err_uv): exact int64
    [len(pri_set), len(sec_set)]; err_uv sums both chroma planes (None
    for luma alone).  ``padded_planes``: the planes already padded, one
    per plane of ``recon`` (a stripe's ``pad_halo``)."""
    cs = max(bit_depth - 8, 0)
    nonskip = nonskip.bool()
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
                    e.append((d * d)[keep].sum())
            plane_err = torch.stack(e).reshape(len(pri_set), len(sec_set))
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


def cdef_direction(plane, fw: int, fh: int, coeff_shift: int = 0):
    """K3: CDEF direction and variance per 8x8 luma unit of the
    (deblocked) luma plane; samples outside [0, fh) x [0, fw) read as
    CDEF_VERY_LARGE.  Returns (dirs, var) int32 [ceil(fh/8), ceil(fw/8)].
    CPU tensors take find_dir_grid; CUDA tensors launch the kernel."""
    if plane.device.type == "cpu":
        return direction_plain(plane, fw, fh, coeff_shift)
    if plane.device.type != "cuda":
        raise ValueError(f"unsupported device {plane.device}")
    _check_plane(plane, "cdef_direction")
    H, W = plane.shape
    if fh > H or fw > W:
        raise ValueError("frame exceeds the plane")
    from ..kernels.build import check_launch, cuda_lib, ptr, stream

    fn = cuda_lib("cdef_direction").cdef_direction_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p] * 3
    uh, uw = _ceil_to(fh, 8) // 8, _ceil_to(fw, 8) // 8
    dirs = torch.empty((uh, uw), dtype=torch.int32, device=plane.device)
    var = torch.empty((uh, uw), dtype=torch.int32, device=plane.device)
    err = fn(ptr(plane), H, W, fh, fw, coeff_shift, ptr(dirs), ptr(var),
             stream(plane))
    check_launch("cdef_direction", err)
    cdef_direction.launches += 1
    return dirs, var


cdef_direction.launches = 0


def _pack(values, bits: int) -> int:
    out = 0
    for i, v in enumerate(values):
        assert 0 <= v < (1 << bits)
        out |= int(v) << (bits * i)
    return out


def _filter_fn(name: str):
    from ..kernels.build import cuda_lib

    fn = getattr(cuda_lib("cdef_filter"), name)
    fn.restype = ctypes.c_int
    return fn


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


def cdef_search(source, recon, dirs, var, nonskip, fw: int, fh: int,
                damping: int, bit_depth: int = 8, pri_set=PRI_SET,
                sec_set=SEC_SET, halos=None):
    """K4 search: exact int64 SSE of every (pri, sec) combo of the grid
    for luma and for the two chroma planes together (source: narrow
    planes, recon: int32 planes, both full size; luma alone gives err_uv
    None).  ``halos``: per plane the (top, bottom) [2, W] int32 rows
    around a stripe of the frame, read where the frame continues (None:
    the frame's edge, CDEF_VERY_LARGE).  CPU tensors take search_plain;
    CUDA tensors launch the kernel once for all the planes."""
    if recon[0].device.type == "cpu":
        return search_plain(source, recon, dirs, var, nonskip, fw, fh,
                            damping, bit_depth, pri_set, sec_set, halos)
    if recon[0].device.type != "cuda":
        raise ValueError(f"unsupported device {recon[0].device}")
    from ..kernels.build import check_launch, ptr, stream

    _check_units(dirs, var, nonskip, fw, fh)
    n = len(recon)
    if not 1 <= n <= 3 or len(source) < n:
        raise ValueError("cdef_search takes 1 to 3 planes and their sources")
    if len(pri_set) > 8 or len(sec_set) > 4:
        raise ValueError("cdef_search takes at most 8 x 4 strengths")
    fn = _filter_fn("cdef_search_launch")
    P = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int] + [P] * 8 + [P] * 3 + [ctypes.c_int] \
        + [ctypes.c_uint, ctypes.c_int, ctypes.c_uint, ctypes.c_int] \
        + [ctypes.c_int] * 2 + [P] * 2
    cs = max(bit_depth - 8, 0)
    ns = nonskip.to(torch.uint8).contiguous()
    dims, halo = [], []
    for pli in range(n):
        rec, src = recon[pli], source[pli]
        _check_plane(rec, "cdef_search recon")
        _check_plane(src, "cdef_search source", (torch.uint8,))
        if rec.shape != src.shape or rec.device != recon[0].device \
                or src.device != rec.device:
            raise ValueError("source and recon planes differ in shape or "
                             "device")
        sub = 0 if pli == 0 else 1
        dims.append((*rec.shape, fh >> sub, fw >> sub))
        halo.append(_halo_ptrs(halos, pli, rec))
    combos = len(pri_set) * len(sec_set)
    acc = torch.zeros(2 * combos, dtype=torch.int64, device=recon[0].device)

    def arr(ctype, values):
        return (ctype * n)(*values)

    err = fn(n, arr(P, [ptr(r) for r in recon[:n]]),
             arr(P, [ptr(s) for s in source[:n]]),
             arr(P, [t for t, _ in halo]), arr(P, [b for _, b in halo]),
             *(arr(ctypes.c_int, [d[i] for d in dims]) for i in range(4)),
             ptr(dirs), ptr(var), ptr(ns), ns.shape[1], _pack(pri_set, 4),
             len(pri_set), _pack(sec_set, 2), len(sec_set), damping + cs,
             cs, ptr(acc), stream(recon[0]))
    check_launch("cdef_search", err)
    cdef_search.launches += 1
    errs = acc.reshape(2, len(pri_set), len(sec_set))
    return errs[0], (errs[1] if n > 1 else None)


cdef_search.launches = 0


def cdef_apply(planes, nonskip, dirs, var, y_strength: int,
               uv_strength: int, damping: int, fw: int, fh: int, bd: int,
               halos=None):
    """K4 apply: normative CDEF of the int32 planes at the coded
    strengths (pri*4+sec), given the (dirs, var) unit maps; ``halos`` as
    for ``cdef_search``.  Returns full-size planes.  CPU tensors take
    cdef_apply_plain; CUDA tensors launch the kernel once per plane."""
    if planes[0].device.type == "cpu":
        return cdef_apply_plain(planes, nonskip, dirs, var, y_strength,
                                uv_strength, damping, fw, fh, bd, halos)
    if planes[0].device.type != "cuda":
        raise ValueError(f"unsupported device {planes[0].device}")
    from ..kernels.build import check_launch, ptr, stream

    _check_units(dirs, var, nonskip, fw, fh)
    fn = _filter_fn("cdef_apply_launch")
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p] * 3
    cs = max(bd - 8, 0)
    ns = nonskip.to(torch.uint8).contiguous()
    out = []
    for pli, plane in enumerate(planes):
        sub = 0 if pli == 0 else 1
        _check_plane(plane, "cdef_apply")
        pri, sec = _strength_parts(y_strength if pli == 0 else uv_strength,
                                   cs)
        H, W = plane.shape
        top, bottom = _halo_ptrs(halos, pli, plane)
        o = torch.empty_like(plane)
        err = fn(ptr(plane), ptr(o), H, W, fh >> sub, fw >> sub, 3 - sub,
                 ptr(dirs), ptr(var), ptr(ns), ns.shape[1], int(pli == 0),
                 pri, sec, damping + cs - sub, cs, top, bottom,
                 stream(plane))
        check_launch("cdef_apply", err)
        cdef_apply.launches += 1
        out.append(o)
    return out


cdef_apply.launches = 0


# --------------------------------------------------------------------------
# Search + apply on the device (the fused chain's CDEF stage and the
# standalone encoder entries)
# --------------------------------------------------------------------------

def pick_strength(err, pri_set, sec_set) -> int:
    """First minimum of the [pri, sec] error grid, coded pri*4+sec."""
    i = int(torch.argmin(err.reshape(-1)))
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
    return [torch.from_numpy(np.ascontiguousarray(p, np.int32)).to(device)
            for p in planes]


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
        source, _device_planes(recon, dev), torch.from_numpy(ns).to(dev),
        mi_cols * 4, mi_rows * 4, damping, bit_depth, pri_set, sec_set)
    return [o.cpu().numpy() for o in out], ystr, uvstr
