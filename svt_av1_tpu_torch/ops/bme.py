"""Batched frame-level motion estimation (port of svt_av1_tpu/ops/bme.py).

The whole frame searches at once, per reference:

  1. SB-level coarse search on the /8 box-decimated pair: every offset of
     a (2r+1)^2 grid, SAD of each 64x64 superblock's 8x8 decimated tile
     plus a |dy|+|dx| centre bias, first minimum (``me_coarse``, K5);
  2. two 96x96 refinement windows per SB (around the coarse winner and
     around the zero MV), the 8x8 SAD pyramid over the window's 33x33
     full-pel offsets, aggregation into the decision shapes, argmin biased
     toward the SB's own 64x64 winner, and the merge of the two windows by
     raw SAD (``me_refine``, K6);
  3. quarter-pel refinement of each 16x16 unit through the exact REGULAR
     8-tap filter, 25 candidates (``subpel_refine16``, K7).

Each step has a plain PyTorch version (the numpy twin's loops, taken for
CPU tensors and used by the tests and chip_smoke.py as the reference)
and a wrapper that launches its hand-written CUDA kernel for CUDA
tensors.  MVs are (row, col): full-pel pixels out of steps 1 and 2,
eighth-pel units (multiples of 2) out of step 3.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..device import SAMPLE_DTYPES

SB = 64
COARSE_R = 8            # +-8 at /8 => +-64 full-pel
# full-res refinement reach around the coarse winner: the /8 coarse SAD
# only sees the dominant low-frequency layer, so a fine-textured layer
# moving differently needs a wide full-resolution search
REFINE_R = 16
MARGIN = 8              # keep MC windows (incl. chroma taps) in-frame
WIN = SB + 2 * REFINE_R
NPOS = 2 * REFINE_R + 1

ME_SHAPES = ((8, 8), (16, 16), (32, 32), (16, 8), (8, 16),
             (32, 16), (16, 32), (64, 64))

SUBPEL_DELTAS = (-4, -2, 0, 2, 4)       # quarter-pel grid in 1/8 units
SUBPEL_PAD = REFINE_R + 8               # full-pel range + tap context


def coarse_r_for_dist(dist: int) -> int:
    """/8-domain coarse reach by reference distance: +-64 px for near
    refs, growing to +-192 px at distance >= 8."""
    d = abs(int(dist))
    if d <= 2:
        return 8
    if d <= 4:
        return 12
    if d <= 8:
        return 16
    return 24


def _clamped(plane: torch.Tensor, y0: int, x0: int, h: int, w: int):
    """plane[y0:y0+h, x0:x0+w] with edge replication (np.pad "edge")."""
    H, W = plane.shape
    dev = plane.device
    ys = torch.arange(y0, y0 + h, device=dev).clamp(0, H - 1)
    xs = torch.arange(x0, x0 + w, device=dev).clamp(0, W - 1)
    return plane[ys][:, xs]


# --------------------------------------------------------------------------
# Plain PyTorch versions (the numpy twin's arithmetic and tie rules)
# --------------------------------------------------------------------------

def _decimate8(plane: torch.Tensor) -> torch.Tensor:
    """/8 box decimation: int32 [H/8, W/8] of (8x8 sum) >> 6."""
    H, W = plane.shape
    h8, w8 = H // 8, W // 8
    p = plane[:h8 * 8, :w8 * 8].to(torch.int32).reshape(h8, 8, w8, 8)
    return p.sum((1, 3), dtype=torch.int32) >> 6


def coarse_sb_search(src, ref, coarse_r: int = COARSE_R,
                     row0: int = 0) -> torch.Tensor:
    """SB-level full search on /8 planes: mv [n_sby, n_sbx, 2] int32
    (full-pel, (row, col)); strict < over offsets in raster order, the
    centre bias added before the compare.  ``src`` may be a stripe of the
    frame whose first row is global row ``row0`` while ``ref`` is the
    whole reference plane: the offsets then shift the stripe's rows by
    ``row0 // 8`` in the decimated reference."""
    s8 = _decimate8(src)
    r8 = _decimate8(ref)
    h8, w8 = s8.shape
    n_sby, n_sbx = h8 // 8, w8 // 8
    C = int(coarse_r)
    pad = _clamped(r8, row0 // 8 - C, -C, h8 + 2 * C, w8 + 2 * C)
    best = bdy = bdx = None
    for dy in range(-C, C + 1):
        for dx in range(-C, C + 1):
            sh = pad[C + dy:C + dy + h8, C + dx:C + dx + w8]
            d = (s8 - sh).abs()
            cost = d[:n_sby * 8, :n_sbx * 8] \
                .reshape(n_sby, 8, n_sbx, 8).sum((1, 3)) \
                + (abs(dy) + abs(dx))
            if best is None:
                best = cost
                bdy = torch.full_like(cost, dy)
                bdx = torch.full_like(cost, dx)
            else:
                take = cost < best
                best = torch.where(take, cost, best)
                bdy = torch.where(take, dy, bdy)
                bdx = torch.where(take, dx, bdx)
    return torch.stack([bdy * 8, bdx * 8], dim=-1).to(torch.int32)


def sb_windows(ref: torch.Tensor, origins: torch.Tensor) -> torch.Tensor:
    """[N, WIN, WIN] reference windows at per-SB origins [N, 2] (which may
    lie up to REFINE_R outside the plane: edge replication)."""
    H, W = ref.shape
    ar = torch.arange(WIN, device=ref.device)
    r = (origins[:, 0][:, None, None] + ar[None, :, None]).clamp(0, H - 1)
    c = (origins[:, 1][:, None, None] + ar[None, None, :]).clamp(0, W - 1)
    return ref[r, c]


def sad8_surfaces(src_sbs: torch.Tensor, windows: torch.Tensor):
    """8x8 SAD pyramid base: [N, 8, 8, NPOS, NPOS] int32 over the window's
    offsets (src_sbs [N, 64, 64], windows [N, WIN, WIN])."""
    n = src_sbs.shape[0]
    s = src_sbs.to(torch.int32)
    w = windows.to(torch.int32)
    rows = []
    for dy in range(NPOS):
        win = w[:, dy:dy + SB, :].unfold(2, SB, 1)     # [N, 64, NPOS, 64]
        d = (s[:, :, None, :] - win).abs()
        sad8 = d.reshape(n, 8, 8, NPOS, 8, 8).sum((2, 5), dtype=torch.int32)
        rows.append(sad8.permute(0, 1, 3, 2))          # [N, by, bx, dx]
    return torch.stack(rows, dim=-2)                    # [N, 8, 8, dy, dx]


def aggregate(sad8: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    """Sum the 8x8 grid into (8*fy)x(8*fx) block SADs:
    [N, 8//fy, 8//fx, ny, nx]."""
    n, gy, gx, ny, nx = sad8.shape
    return sad8.reshape(n, gy // fy, fy, gx // fx, fx, ny, nx).sum((2, 4))


def best_offsets(sads: torch.Tensor):
    """First argmin over the offset plane: (dy, dx, sad), offsets full-pel
    relative to the window centre."""
    shp = sads.shape[:-2]
    ny, nx = sads.shape[-2:]
    flat = sads.reshape(shp + (ny * nx,))
    idx = flat.argmin(dim=-1)        # first minimum (torch.argmin rule)
    sad = flat.gather(-1, idx[..., None])[..., 0]
    dy = (idx // nx).to(torch.int32) - REFINE_R
    dx = (idx % nx).to(torch.int32) - REFINE_R
    return dy, dx, sad


def _sb_geometry(src: torch.Tensor, row0: int = 0):
    """(n_sby, n_sbx, pos): the SB grid of ``src`` and each SB's global
    (row, col) origin, ``src`` starting at global row ``row0``."""
    n_sby, n_sbx = src.shape[0] // SB, src.shape[1] // SB
    dev = src.device
    gy, gx = torch.meshgrid(torch.arange(n_sby, device=dev) * SB + row0,
                            torch.arange(n_sbx, device=dev) * SB,
                            indexing="ij")
    pos = torch.stack([gy.reshape(-1), gx.reshape(-1)], dim=-1)
    return n_sby, n_sbx, pos.to(torch.int32)


def _window_origins(pos, cvec, H: int, W: int):
    """Window origins around ``cvec`` per SB, clipped so a window starts
    at most REFINE_R outside the plane."""
    return torch.stack([
        (pos[:, 0] + cvec[:, 0] - REFINE_R).clamp(-REFINE_R,
                                                  H - WIN + REFINE_R),
        (pos[:, 1] + cvec[:, 1] - REFINE_R).clamp(-REFINE_R,
                                                  W - WIN + REFINE_R),
    ], dim=-1)


def refine_plain(src, ref, coarse, shapes=ME_SHAPES, row0: int = 0) -> dict:
    """Step 2 of frame_me (plain): {(w, h): (mv_r, mv_c, sad) [N, oy, ox]
    int32} per requested shape, "win16" (the winning window per 16x16
    block) when (16, 16) is asked for, and "grid" (n_sby, n_sbx).  With
    ``row0``, ``src`` is a stripe at that global row of the whole
    reference ``ref``: window origins and their clamps are the frame's."""
    H, W = ref.shape
    n_sby, n_sbx, pos = _sb_geometry(src, row0)
    n = n_sby * n_sbx
    src_sbs = src.reshape(n_sby, SB, n_sbx, SB).permute(0, 2, 1, 3) \
        .reshape(n, SB, SB)
    cands = [coarse.reshape(-1, 2).to(torch.int32),
             torch.zeros((n, 2), dtype=torch.int32, device=src.device)]
    origins_l, sad8_l, sb_best = [], [], []
    for cvec in cands:
        origins = _window_origins(pos, cvec, H, W)
        sad8 = sad8_surfaces(src_sbs, sb_windows(ref, origins))
        origins_l.append(origins)
        sad8_l.append(sad8)
        d64y, d64x, _ = best_offsets(aggregate(sad8, 8, 8))
        sb_best.append((d64y, d64x))
    ramp = torch.arange(-REFINE_R, REFINE_R + 1, device=src.device)
    out = {"grid": (n_sby, n_sbx)}
    for (w, h) in shapes:
        fy, fx = h // 8, w // 8
        area = h * w
        best = None
        for k in range(len(cands)):
            agg = aggregate(sad8_l[k], fy, fx)
            d64y, d64x = sb_best[k]
            # d64y, d64x: [N, 1, 1]
            bias_y = (ramp[None, :, None] - d64y[..., None, None]).abs()
            bias_x = (ramp[None, None, :] - d64x[..., None, None]).abs()
            agg = agg + area * (bias_y + bias_x)
            dy, dx, sad = best_offsets(agg)
            # report the raw SAD (selection used the biased surface)
            sad = sad - area * ((dy - d64y).abs() + (dx - d64x).abs())
            mv_r = origins_l[k][:, 0][:, None, None] + REFINE_R + dy \
                - pos[:, 0][:, None, None]
            mv_c = origins_l[k][:, 1][:, None, None] + REFINE_R + dx \
                - pos[:, 1][:, None, None]
            if best is None:
                best = [mv_r, mv_c, sad, torch.zeros_like(sad)]
            else:
                take = sad < best[2]
                best = [torch.where(take, mv_r, best[0]),
                        torch.where(take, mv_c, best[1]),
                        torch.where(take, sad, best[2]),
                        torch.where(take, k, best[3])]
        out[(w, h)] = tuple(b.to(torch.int32) for b in best[:3])
        if (w, h) == (16, 16):
            out["win16"] = best[3].to(torch.int32)
    return out


def subpel_plain(src, ref, mv_r16, mv_c16, bd: int = 8, row0: int = 0):
    """Quarter-pel refinement per 16x16 unit (plain): returns (mvq8_r,
    mvq8_c) int32 [nr16, nc16] and the assembled best prediction [rows,
    W] in the planes' sample type (``device.SAMPLE_DTYPES[bd]``: uint8 at
    8 bits, int16 at 10) for the ``rows`` of ``src`` (a stripe at global
    row ``row0`` of the whole reference ``ref``, or the whole frame)."""
    from .inter import convolve_2d_sr_torch

    H, W = ref.shape
    dev = ref.device
    nr16, nc16 = src.shape[0] // 16, src.shape[1] // 16
    n16 = nr16 * nc16
    gy, gx = torch.meshgrid(torch.arange(nr16, device=dev) * 16,
                            torch.arange(nc16, device=dev) * 16,
                            indexing="ij")
    P = SUBPEL_PAD
    base_y = gy.reshape(-1) + row0 + mv_r16.reshape(-1)
    base_x = gx.reshape(-1) + mv_c16.reshape(-1)
    # patch origin in the edge-padded plane, clipped to the pad, then
    # read from the plane with clamped indices
    oy = (base_y - 4 + P).clamp(0, H + 2 * P - 25) - P
    ox = (base_x - 4 + P).clamp(0, W + 2 * P - 25) - P
    ar = torch.arange(25, device=dev)
    rows = (oy[:, None, None] + ar[None, :, None]).clamp(0, H - 1)
    cols = (ox[:, None, None] + ar[None, None, :]).clamp(0, W - 1)
    patch = ref.to(torch.int32)[rows, cols]             # [n16, 25, 25]
    src16 = src.reshape(nr16, 16, nc16, 16).permute(0, 2, 1, 3) \
        .reshape(n16, 16, 16).to(torch.int32)
    best_sad = best_dy = best_dx = best_pred = None
    for dy8 in SUBPEL_DELTAS:
        for dx8 in SUBPEL_DELTAS:
            sy = 4 + (dy8 >> 3)         # arithmetic shift: floor
            sx = 4 + (dx8 >> 3)
            p = convolve_2d_sr_torch(patch, sx, sy, 16, 16, (dx8 & 7) * 2,
                                     (dy8 & 7) * 2, bd)
            sad = (src16 - p).abs().sum((-1, -2)) \
                + 2 * (abs(dy8) + abs(dx8))
            if best_sad is None:
                best_sad, best_pred = sad, p
                best_dy = torch.full_like(sad, dy8)
                best_dx = torch.full_like(sad, dx8)
            else:
                take = sad < best_sad
                best_sad = torch.where(take, sad, best_sad)
                best_dy = torch.where(take, dy8, best_dy)
                best_dx = torch.where(take, dx8, best_dx)
                best_pred = torch.where(take[:, None, None], p, best_pred)
    mvq8_r = (mv_r16 * 8 + best_dy.reshape(nr16, nc16)).to(torch.int32)
    mvq8_c = (mv_c16 * 8 + best_dx.reshape(nr16, nc16)).to(torch.int32)
    pred = best_pred.reshape(nr16, nc16, 16, 16).permute(0, 2, 1, 3) \
        .reshape(nr16 * 16, nc16 * 16).to(SAMPLE_DTYPES[bd])
    return mvq8_r, mvq8_c, pred


def to_block_maps(me_out, buf_w: int, buf_h: int):
    """Reorder frame_me's per-SB-nested results into frame block grids:
    {(w, h): (mv_r [nr, nc], mv_c, sad)} as numpy arrays."""
    n_sby, n_sbx = me_out["grid"]
    maps = {}
    for key, val in me_out.items():
        if not isinstance(key, tuple):
            continue
        mv_r, mv_c, sad = (np.asarray(v.cpu() if isinstance(v, torch.Tensor)
                                      else v) for v in val)
        n, oy, ox = mv_r.shape
        nr, nc = n_sby * oy, n_sbx * ox

        def expand(a):
            return a.reshape(n_sby, n_sbx, oy, ox) \
                .transpose(0, 2, 1, 3).reshape(nr, nc)

        maps[key] = (expand(mv_r), expand(mv_c), expand(sad))
    return maps


# --------------------------------------------------------------------------
# K5, K6, K7: the CUDA kernels and their wrappers
# --------------------------------------------------------------------------

def _check_planes(name: str, src: torch.Tensor, ref: torch.Tensor,
                  row0: int) -> int:
    """The planes K5-K7 take: ``ref`` the whole [H, W] reference, ``src``
    the whole frame or a stripe of its rows starting at ``row0``, both
    contiguous on one CUDA device and of one sample type: uint8 (8-bit
    video, and MCTF's planes at any bit depth, which the reference
    narrows) or int16 holding 10-bit samples in [0, 1023]
    (``device.SAMPLE_DTYPES``); whole 64x64 superblocks (a plane of one SB
    row or column clamps its windows to one origin, as the numpy twin's
    clip does).  Returns the bytes per sample, which selects the kernel's
    form."""
    for t in (src, ref):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {t.device}")
        if t.dtype not in (torch.uint8, torch.int16) or t.dim() != 2 \
                or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous [H, W] uint8 or "
                             "int16 (10-bit) planes")
    if src.dtype != ref.dtype:
        raise ValueError(f"{name}: source {src.dtype} and reference "
                         f"{ref.dtype} differ")
    if src.device != ref.device:
        raise ValueError(f"{name}: planes on different devices")
    rows, w_src = src.shape
    H, W = ref.shape
    if w_src != W or row0 < 0 or row0 % SB or row0 + rows > H:
        raise ValueError(f"{name}: source {tuple(src.shape)} at row {row0} "
                         f"is not a 64-aligned stripe of the reference "
                         f"{tuple(ref.shape)}")
    if rows % SB or rows == 0 or H % SB or W % SB or W == 0:
        raise ValueError(f"{name}: planes must be whole 64x64 superblocks")
    return src.element_size()


_P, _I = ctypes.c_void_p, ctypes.c_int


def me_coarse(src: torch.Tensor, ref: torch.Tensor,
              coarse_r: int = COARSE_R, row0: int = 0) -> torch.Tensor:
    """K5: the SB-level coarse search, mv [n_sby, n_sbx, 2] int32, of
    ``src`` (the frame, or a stripe at global row ``row0``) against the
    whole reference ``ref``.  CPU tensors take the plain version; CUDA
    tensors launch kernels/csrc/me_coarse.cu once, its 8-bit form on
    uint8 planes and its 16-bit form on int16 ones."""
    if src.device.type == "cpu":
        return coarse_sb_search(src, ref, coarse_r, row0)
    me_coarse.calls += 1
    sample_bytes = _check_planes("me_coarse", src, ref, row0)
    if not 1 <= coarse_r <= 32:
        raise ValueError(f"me_coarse: coarse_r {coarse_r} outside 1..32")
    from ..kernels.build import check_launch, cuda_fn, ptr, raw_stream

    rows = src.shape[0]
    H, W = ref.shape
    out = torch.empty((rows // SB, W // SB, 2), dtype=torch.int32,
                      device=src.device)
    fn = cuda_fn("me_coarse", "me_coarse_launch", (_P, _P) + (_I,) * 6
             + (_P,) * 2)
    err = fn(ptr(src), ptr(ref), sample_bytes, rows, H, W, int(coarse_r),
             int(row0), ptr(out), raw_stream(src))
    check_launch("me_coarse", err)
    me_coarse.launches += 1
    return out


me_coarse.launches = me_coarse.calls = 0


def refine_spec(shapes):
    """What K6 is told of the requested shapes: (spec, counts) with spec
    the flat (h/8, w/8) pairs and counts the output blocks per shape in
    one SB.  Each shape of ME_SHAPES may be asked for once."""
    shapes = tuple(tuple(s) for s in shapes)
    if not shapes or len(set(shapes)) != len(shapes) \
            or any(s not in ME_SHAPES for s in shapes):
        raise ValueError(f"me_refine: shapes must come from {ME_SHAPES}, "
                         "each at most once")
    spec = [v for (w, h) in shapes for v in (h // 8, w // 8)]
    counts = [(SB // h) * (SB // w) for (w, h) in shapes]
    return spec, counts


def me_refine(src: torch.Tensor, ref: torch.Tensor, coarse: torch.Tensor,
              shapes=ME_SHAPES, row0: int = 0) -> dict:
    """K6: refinement around the coarse winner and the zero MV, the
    shapes' biased argmins and the window merge; the same dict as
    ``refine_plain``.  ``src`` is the frame or a stripe at global row
    ``row0`` of the whole reference ``ref``.  CPU tensors take the plain
    version; CUDA tensors launch kernels/csrc/me_refine.cu (its 8-bit
    form on uint8 planes, its 16-bit form on int16 ones)."""
    if src.device.type == "cpu":
        return refine_plain(src, ref, coarse, shapes, row0)
    me_refine.calls += 1
    sample_bytes = _check_planes("me_refine", src, ref, row0)
    spec, counts = refine_spec(shapes)
    shapes = tuple(tuple(s) for s in shapes)
    rows = src.shape[0]
    H, W = ref.shape
    n_sby, n_sbx = rows // SB, W // SB
    n = n_sby * n_sbx
    if coarse.dtype != torch.int32 or tuple(coarse.shape) != (
            n_sby, n_sbx, 2) or not coarse.is_contiguous() \
            or coarse.device != src.device:
        raise ValueError("me_refine: coarse must be the contiguous int32 "
                         "[n_sby, n_sbx, 2] output of me_coarse")
    from ..kernels.build import check_launch, cuda_fn, ptr, stream

    n_out = sum(counts)
    spec = (ctypes.c_int * len(spec))(*spec)
    res = torch.empty((n, n_out, 4), dtype=torch.int32, device=src.device)
    fn = cuda_fn("me_refine", "me_refine_launch",
             (_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P))
    err = fn(ptr(src), ptr(ref), sample_bytes, rows, H, W, int(row0),
             ptr(coarse), spec, len(shapes), ptr(res), stream(src))
    check_launch("me_refine", err)
    me_refine.launches += 1
    out = {"grid": (n_sby, n_sbx)}
    off = 0
    for (w, h), cnt in zip(shapes, counts):
        blk = res[:, off:off + cnt].reshape(n, SB // h, SB // w, 4)
        out[(w, h)] = (blk[..., 0], blk[..., 1], blk[..., 2])
        if (w, h) == (16, 16):
            out["win16"] = blk[..., 3]
        off += cnt
    return out


me_refine.launches = me_refine.calls = 0


def frame_me(src, ref, coarse_r: int = COARSE_R, shapes=ME_SHAPES,
             row0: int = 0) -> dict:
    """Single-reference ME of the frame, or of a stripe at global row
    ``row0`` against the whole reference: K5 then K6 (their plain
    versions for CPU tensors)."""
    return me_refine(src, ref, me_coarse(src, ref, coarse_r, row0), shapes,
                     row0)


@functools.cache
def _regular_taps(device: torch.device) -> torch.Tensor:
    from .inter import REGULAR, interp_kernel

    taps = np.stack([interp_kernel(REGULAR, q4, 16) for q4 in range(16)])
    return torch.from_numpy(taps.astype(np.int32)).to(device)


def subpel_refine16(src: torch.Tensor, ref: torch.Tensor,
                    mv_r16: torch.Tensor, mv_c16: torch.Tensor, bd: int = 8,
                    row0: int = 0):
    """K7: quarter-pel refinement of every 16x16 unit around its full-pel
    MV through the REGULAR 8-tap filter.  Returns (mvq8_r, mvq8_c) int32
    [rows/16, W/16] in eighth-pel and the winners' prediction plane [rows,
    W] in the planes' sample type, for ``src`` (the frame, or a stripe at
    global row ``row0`` of the whole reference ``ref``): uint8 planes at
    ``bd`` 8, int16 at ``bd`` 10 (``device.SAMPLE_DTYPES``).  CPU tensors
    take the plain version; CUDA tensors launch
    kernels/csrc/subpel_refine.cu, its 8-bit or its 16-bit form."""
    if src.device.type == "cpu":
        return subpel_plain(src, ref, mv_r16, mv_c16, bd, row0)
    subpel_refine16.calls += 1
    sample_bytes = _check_planes("subpel_refine16", src, ref, row0)
    if SAMPLE_DTYPES.get(bd) != src.dtype:
        raise ValueError(f"subpel_refine16 takes uint8 planes at bd 8 and "
                         f"int16 at bd 10, not {src.dtype} at bd {bd}")
    rows = src.shape[0]
    H, W = ref.shape
    for t in (mv_r16, mv_c16):
        if t.dtype != torch.int32 or tuple(t.shape) != (rows // 16, W // 16) \
                or not t.is_contiguous() or t.device != src.device:
            raise ValueError("subpel_refine16: MVs must be contiguous int32 "
                             "[rows/16, W/16] on the planes' device")
    from ..kernels.build import check_launch, cuda_fn, ptr, stream

    mvq_r = torch.empty_like(mv_r16)
    mvq_c = torch.empty_like(mv_c16)
    pred = torch.empty((rows, W), dtype=src.dtype, device=src.device)
    taps = _regular_taps(src.device)
    fn = cuda_fn("subpel_refine", "subpel_refine_launch",
             (_P, _P, _I, _I, _I, _I, _I) + (_P,) * 7)
    err = fn(ptr(src), ptr(ref), sample_bytes, rows, H, W, int(row0),
             ptr(mv_r16), ptr(mv_c16), ptr(taps), ptr(mvq_r), ptr(mvq_c),
             ptr(pred), stream(src))
    check_launch("subpel_refine16", err)
    subpel_refine16.launches += 1
    return mvq_r, mvq_c, pred


subpel_refine16.launches = subpel_refine16.calls = 0
