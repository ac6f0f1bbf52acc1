"""The models that the one-launch K4 apply (kernels/csrc/cdef_filter.cu)
and the two-lane K3 (kernels/csrc/cdef_direction.cu) rest on, run on the
CPU against the port's plain versions and the JAX package's numpy twins;
exact equality throughout.

K4's apply: a numpy model of the kernel (per-plane CTA ranges over each
plane's whole buffer, 64x32 tiles of int16 with a 2-row and 2-column
halo and 70 int16 per row, -CDEF_VERY_LARGE outside the frame so that
the clip bounds are a signed maximum and an unsigned minimum, the taps'
offsets from one table, |constrain| as one min-relu signed by its
weight, runs of 8 pixels per thread with their units read once, tiles
without a non-skip unit copied) equals cdef_apply_plain and
_cdef_apply_traced.

K3: a numpy model of the kernel (strips of 32 units with
CDEF_VERY_LARGE outside the frame, two lanes per unit, lane 1 reading
the unit turned by a quarter, the four families of bins i + j, i + j/2,
i and 3 + i - j/2, the costs swapped between the lanes, the first
maximum) equals direction_plain and find_dir_grid.
"""
import numpy as np
import pytest
import torch

from svt_av1_tpu.ops import cdef as ref
from svt_av1_tpu_torch.ops import cdef

VL = cdef.CDEF_VERY_LARGE

# -- K4's apply ---------------------------------------------------------------

TILE_W, TILE_H, STRIDE = 64, 32, 70


def _tap_offsets(stride):
    """[8, 12] tile offsets of each direction's taps (tap_offset): primary
    (k, sign) at 2k + sg, secondary (k, rotation 2 or 6, sign) at 4 + 4k +
    2ri + sg."""
    off = np.zeros((8, 12), np.int64)
    for d in range(8):
        for i in range(12):
            prim = i < 4
            k = i >> 1 if prim else (i - 4) >> 2
            ri = 0 if prim else ((i - 4) >> 1) & 1
            dd = d if prim else (d + (6 if ri else 2)) & 7
            dy, dx = (int(v) for v in cdef.DIRECTIONS[dd, k])
            off[d, i] = (-1 if i & 1 else 1) * (dy * stride + dx)
    return off


def _msb(x):
    return np.where(x >= 1, np.floor(np.log2(np.maximum(x, 1))), 0) \
        .astype(np.int64)


def _adjust(pri, var):
    m = np.minimum(_msb(var >> 6), 12)
    return np.where(var > 0, (pri * (4 + m) + 8) >> 4, 0)


def _damp_shift(s, damping):
    return np.maximum(damping - np.minimum(_msb(s), 7), 0)


def _mag(ad, s, shift):
    """__vimin_s32_relu(ad, s - (ad >> shift))."""
    return np.maximum(np.minimum(ad, s - (ad >> shift)), 0)


def _load_tile(plane, ph, pw, top, bottom, y0, x0):
    """The apply's tile: rows [y0 - 2, y0 + 34) and columns [x0 - 2, x0 +
    66) of the plane's surroundings as int16 (-CDEF_VERY_LARGE outside [0,
    pw) and outside the frame's rows, the neighbours' rows where
    given)."""
    tile = np.zeros((TILE_H + 4, STRIDE), np.int16)
    xs = np.arange(x0 - 2, x0 + TILE_W + 2)
    inside = (xs >= 0) & (xs < pw)
    for r in range(TILE_H + 4):
        y = y0 - 2 + r
        row = None
        if 0 <= y < ph:
            row = plane[y]
        elif -2 <= y < 0 and top is not None:
            row = top[y + 2]
        elif ph <= y < ph + 2 and bottom is not None:
            row = bottom[y - ph]
        vals = np.full(xs.shape, -VL, np.int64)
        if row is not None:
            vals[inside] = row[xs[inside]]
        tile[r, :TILE_W + 4] = vals.astype(np.int16)
    return tile.ravel().astype(np.int64)


def k4_apply_model(planes, nonskip, dirs, var, y_strength, uv_strength,
                   damping, fw, fh, bd, halos=None, stats=None):
    """cdef_apply_launch in numpy: int32 [H, W] planes (luma, then chroma),
    their outputs."""
    cs = max(bd - 8, 0)
    ns = nonskip.astype(np.int64).ravel()
    dirs, var = dirs.astype(np.int64).ravel(), var.astype(np.int64).ravel()
    uw = nonskip.shape[1]
    toff = _tap_offsets(STRIDE)
    plan, ctas = [], 0                  # (first CTA, tiles_x) per plane
    for p in planes:
        plan.append((ctas, -(-p.shape[1] // TILE_W)))
        ctas += plan[-1][1] * -(-p.shape[0] // TILE_H)
    out = [np.zeros_like(p) for p in planes]
    ty = np.arange(TILE_H)[:, None]     # a thread: row ty, 8 pixels from 8g
    g = np.arange(8)[None, :]
    for cta in range(ctas):
        pli = max(i for i, (c0, _) in enumerate(plan) if cta >= c0)
        plane = planes[pli]
        H, W = plane.shape
        c0, tiles_x = plan[pli]
        y0, x0 = ((cta - c0) // tiles_x) * TILE_H, ((cta - c0) % tiles_x) \
            * TILE_W
        luma, sub = pli == 0, int(pli > 0)
        ph, pw, bsl = fh >> sub, fw >> sub, 3 - sub
        pri, sec = cdef._strength_parts(y_strength if luma else uv_strength,
                                        cs)
        dmp = damping + cs - sub
        y, xs = y0 + ty, x0 + 8 * g
        # the units of each thread, read once
        nsu, du = np.zeros((2, TILE_H, 8), np.int64), \
            np.zeros((2, TILE_H, 8), np.int64)
        vr = np.zeros((TILE_H, 8), np.int64)
        for h2 in range(2):
            x = xs + 4 * h2
            ok = (pri > 0 or sec > 0) & (y < ph) & (x < pw) \
                & (h2 == 0 or not luma)
            u = np.where(ok, (y >> bsl) * uw + (x >> bsl), 0)
            nsu[h2] = np.where(ok, ns[u], 0)
            du[h2] = np.where(nsu[h2] > 0, dirs[u] if pri > 0 else 0, 0)
            if luma and h2 == 0:
                vr = np.where(nsu[0] > 0, var[u], 0)
        if luma:
            nsu[1], du[1] = nsu[0], du[0]
        # the thread's 8 samples (those inside the buffer)
        yy = np.clip(y0 + np.arange(TILE_H), 0, H - 1)
        xx = np.clip(x0 + np.arange(TILE_W), 0, W - 1)
        v = plane[yy][:, xx].astype(np.int64).reshape(TILE_H, 8, 8)
        if nsu.any():
            top, bottom = halos[pli] if halos is not None else (None, None)
            tile = _load_tile(plane, ph, pw, top, bottom, y0, x0)
            pa = _adjust(pri, vr) if luma else np.full(vr.shape, pri)
            psh = np.where(pa > 0, _damp_shift(pa, dmp), 0)
            ssh = _damp_shift(sec, dmp) if sec > 0 else 0
            odd = (pa >> cs) & 1
            at = (ty + 2) * STRIDE + 8 * g + 2
            for i in range(8):
                h2 = i // 4
                go = (nsu[h2] > 0) & (xs + i < pw)
                if stats is not None:
                    stats["filtered"] += int(go.sum())
                    stats["zero_pa"] += int((go & (pa == 0)
                                             & (du[h2] != 0)).sum())
                c = v[:, :, i]
                s_, mx, mn = np.zeros_like(c), c.copy(), c.copy()
                for t in range(12):
                    a = tile[at + i + toff[du[h2], t]]
                    d = a - c
                    w = ((np.where(odd, 3, 4) if t < 2 else
                          np.where(odd, 3, 2)) if t < 4 else
                         (2 if t < 8 else 1))
                    # |constrain| as one min-relu, signed by the weight
                    m = _mag(np.abs(d), pa, psh) if t < 4 \
                        else _mag(np.abs(d), sec, ssh)
                    s_ = s_ + np.where(d < 0, -w, w) * m
                    # -CDEF_VERY_LARGE: a signed max, an unsigned min
                    mx = np.maximum(mx, a)
                    mn = np.minimum(mn.astype(np.uint32),
                                    a.astype(np.uint32)).astype(np.int64)
                f = np.clip(c + ((8 + s_ - (s_ < 0)) >> 4), mn, mx)
                v[:, :, i] = np.where(go, f, c)
        elif stats is not None:
            stats["copy_tiles"] += 1
        hh, ww = min(TILE_H, H - y0), min(TILE_W, W - x0)
        out[pli][y0:y0 + hh, x0:x0 + ww] = v.reshape(TILE_H, TILE_W)[:hh,
                                                                      :ww]
    return out


def _noisy_plane(h, w, seed, bd=8, smooth=False):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    p = 120 + 70 * np.sin(xx / 9 + seed) + 45 * np.cos(yy / 6)
    p = p + rng.integers(-2, 3, (h, w)) if smooth \
        else p + rng.integers(-25, 26, (h, w))
    return (p.clip(0, 255).astype(np.int64) << (bd - 8)).astype(np.int32)


def _planes(fw, fh, bufs, seed, bd=8):
    """Luma and chroma int32 planes of buffer sizes bufs[i] (>= the
    frame's), the frame textured."""
    return [_noisy_plane(h, w, seed + i, bd) for i, (h, w) in enumerate(bufs)]


def _pads(planes, fw, fh, halos):
    """The JAX twin's padded_planes: pad_very_large with the neighbours'
    rows where given (the port's pad_halo)."""
    out = []
    for pli, p in enumerate(planes):
        sub = int(pli > 0)
        pw, ph = fw >> sub, fh >> sub
        pad = ref.pad_very_large(p, pw, ph, 8 >> sub, np)
        top, bottom = halos[pli] if halos is not None else (None, None)
        if top is not None:
            pad[0:2, 2:2 + pw] = top[:, :pw]
        if bottom is not None:
            pad[2 + ph:4 + ph, 2:2 + pw] = bottom[:, :pw]
        out.append(pad)
    return out


def _check_apply(planes, ns, fw, fh, ys, us, damping, bd, halos=None,
                 dirs=None, var=None, stats=None):
    """model == cdef_apply_plain (== the JAX twin where dirs, var are
    find_dir_grid's); returns the model's planes."""
    cs = max(bd - 8, 0)
    pads = _pads(planes, fw, fh, halos)
    jax_dirs = dirs is None
    if jax_dirs:
        dirs, var = ref.find_dir_grid(ref._units_of(pads[0], fw, fh, 8, np),
                                      cs, np)
    got = k4_apply_model(planes, ns, dirs, var, ys, us, damping, fw, fh, bd,
                         halos, stats)
    th = None if halos is None else [
        tuple(None if t is None else torch.from_numpy(t) for t in pair)
        for pair in halos]
    plain = cdef.cdef_apply_plain(
        [torch.from_numpy(p) for p in planes], torch.from_numpy(ns),
        torch.from_numpy(dirs), torch.from_numpy(var), ys, us, damping, fw,
        fh, bd, th)
    for pli, (g, p) in enumerate(zip(got, plain)):
        np.testing.assert_array_equal(g, p.numpy(), err_msg=f"plane {pli}")
    if jax_dirs:
        want = ref._cdef_apply_traced(planes, ns, ys, us, damping, fw, fh, bd,
                                      np, padded_planes=pads)
        for pli, (g, w) in enumerate(zip(got, want)):
            h, w_ = w.shape
            np.testing.assert_array_equal(g[:h, :w_], w,
                                          err_msg=f"plane {pli}")
            np.testing.assert_array_equal(g[h:], planes[pli][h:])
            np.testing.assert_array_equal(g[:, w_:], planes[pli][:, w_:])
    return got


def _ns(fw, fh, seed, frac=0.75):
    rng = np.random.default_rng(seed)
    return rng.random((-(-fh // 8), -(-fw // 8))) < frac


@pytest.mark.parametrize("n", [1, 3], ids=["luma", "three_planes"])
@pytest.mark.parametrize("strengths", [(33, 18), (63, 61), (14, 7)])
def test_k4_apply_model_planes(n, strengths):
    fw, fh = 200, 104                      # 4 x 4 luma tiles, ragged
    planes = _planes(fw, fh, [(104, 200), (52, 100), (52, 100)][:n], n)
    stats = {"filtered": 0, "zero_pa": 0, "copy_tiles": 0}
    got = _check_apply(planes, _ns(fw, fh, n), fw, fh, *strengths, 5, 8,
                       stats=stats)
    assert stats["filtered"] > 0
    for g, p in zip(got, planes):
        assert (g != p).any()


@pytest.mark.parametrize("halo", ["none", "top", "bottom", "both"])
def test_k4_apply_model_halo_modes(halo):
    """A 64-row stripe of a taller frame, each plane with its neighbours'
    two rows above and below where the mode has them."""
    fw, fh = 192, 64
    full = [_noisy_plane(68 >> s, fw >> s, 9 + s) for s in (0, 1, 1)]
    planes = [f[2:2 + (64 >> s)].copy() for f, s in zip(full, (0, 1, 1))]
    halos = [(f[:2].copy() if halo in ("top", "both") else None,
              f[-2:].copy() if halo in ("bottom", "both") else None)
             for f in full]
    got = _check_apply(planes, _ns(fw, fh, 4), fw, fh, 61, 22, 4, 8, halos)
    if halo != "none":
        # the neighbours' rows change the stripe's edge rows
        bare = _check_apply(planes, _ns(fw, fh, 4), fw, fh, 61, 22, 4, 8)
        assert any((g[[0, -1]] != b[[0, -1]]).any()
                   for g, b in zip(got, bare))


@pytest.mark.parametrize("frame", [(130, 98), (202, 134), (120, 88)],
                         ids=["130x98", "202x134", "120x88"])
def test_k4_apply_model_frames_smaller_than_buffers(frame):
    """The Decoder's planes: buffers larger than the frame (copied beyond
    it), and frames whose chroma widths are no multiple of 4."""
    fw, fh = frame
    bh, bw = -(-fh // 64) * 64 + 16, -(-fw // 64) * 64 + 8
    planes = _planes(fw, fh, [(bh, bw), (bh // 2, bw // 2),
                              (bh // 2, bw // 2)], fw)
    stats = {"filtered": 0, "zero_pa": 0, "copy_tiles": 0}
    _check_apply(planes, _ns(fw, fh, fh), fw, fh, 45, 29, 5, 8, stats=stats)
    assert stats["copy_tiles"] > 0         # tiles wholly outside the frame


@pytest.mark.parametrize("width", [66, 98, 134])
def test_k4_apply_model_widths_off_4(width):
    """Buffers whose rows are no multiple of 4 samples (the kernel's
    scalar path) at frames as wide as the buffer."""
    fw, fh = width, 48
    planes = _planes(fw, fh, [(48, width), (24, width // 2),
                              (24, width // 2)], width)
    _check_apply(planes, _ns(fw, fh, width), fw, fh, 37, 26, 3, 8)


def test_k4_apply_model_luma_units_with_adjusted_primary_0():
    """Coded primary 1: adjust_strength(1, var) is 0 for var < 1024, yet
    such a unit's taps, and so its clip bounds, follow dirs[u]."""
    fw, fh = 128, 64
    planes = _planes(fw, fh, [(64, 128)], 3)
    ns = _ns(fw, fh, 3, 1.0)
    stats = {"filtered": 0, "zero_pa": 0, "copy_tiles": 0}
    _check_apply(planes, ns, fw, fh, 1 * 4 + 2, 0, 5, 8, stats=stats)
    assert stats["zero_pa"] > 0
    # random maps too: directions everywhere, small and zero variances
    rng = np.random.default_rng(5)
    dirs = rng.integers(0, 8, ns.shape).astype(np.int32)
    var = rng.choice([0, 1, 63, 64, 700, 5000, 1 << 20], ns.shape) \
        .astype(np.int32)
    stats["zero_pa"] = 0
    for ys in (1 * 4 + 0, 1 * 4 + 3, 15 * 4 + 1):
        _check_apply(planes, ns, fw, fh, ys, 0, 6, 8, dirs=dirs, var=var,
                     stats=stats)
    assert stats["zero_pa"] > 0


@pytest.mark.parametrize("strengths", [(0, 0), (32, 0), (0, 20), (3, 3),
                                       (2, 1), (60, 3)],
                         ids=["zero", "pri_only", "uv_pri_only", "sec3",
                              "sec_only", "pri_sec3"])
def test_k4_apply_model_strengths(strengths):
    fw, fh = 136, 72
    planes = _planes(fw, fh, [(72, 136), (36, 68), (36, 68)], 8)
    stats = {"filtered": 0, "zero_pa": 0, "copy_tiles": 0}
    got = _check_apply(planes, _ns(fw, fh, 2), fw, fh, *strengths, 4, 8,
                       stats=stats)
    for pli, (g, p) in enumerate(zip(got, planes)):
        # a plane whose strengths are both 0 is copied
        assert (g != p).any() == bool(strengths[pli > 0])


def test_k4_apply_model_every_unit_skip_copies_every_tile():
    fw, fh = 136, 72
    planes = _planes(fw, fh, [(72, 136), (36, 68), (36, 68)], 6)
    stats = {"filtered": 0, "zero_pa": 0, "copy_tiles": 0}
    got = _check_apply(planes, _ns(fw, fh, 0, 0.0), fw, fh, 33, 18, 5, 8,
                       stats=stats)
    tiles = sum(-(-p.shape[0] // TILE_H) * -(-p.shape[1] // TILE_W)
                for p in planes)
    assert stats["filtered"] == 0 and stats["copy_tiles"] == tiles
    for g, p in zip(got, planes):
        np.testing.assert_array_equal(g, p)


@pytest.mark.parametrize("n", [1, 3])
def test_k4_apply_model_bd10(n):
    fw, fh = 136, 72
    planes = [_noisy_plane(h, w, 2 + i, 10) for i, (h, w) in
              enumerate([(72, 136), (36, 68), (36, 68)][:n])]
    for strengths in ((33, 18), (63, 7)):
        got = _check_apply(planes, _ns(fw, fh, 10), fw, fh, *strengths, 5,
                           10)
        assert (got[0] != planes[0]).any()


# -- K3 -----------------------------------------------------------------------

K3_UNITS = 32                          # units per CTA


def _families(v):
    """The four families of bins over views v [n, 8, 8]: i + j, i + j/2, i
    and 3 + i - j/2; their costs [n, 4] in int64."""
    n = v.shape[0]
    pd = np.zeros((n, 15), np.int64)
    po = np.zeros((n, 11), np.int64)
    pr = np.zeros((n, 8), np.int64)
    pa = np.zeros((n, 11), np.int64)
    for i in range(8):
        for m in range(4):
            x0, x1 = v[:, i, 2 * m], v[:, i, 2 * m + 1]
            pd[:, i + 2 * m] += x0
            pd[:, i + 2 * m + 1] += x1
            po[:, i + m] += x0 + x1
            pa[:, 3 + i - m] += x0 + x1
            pr[:, i] += x0 + x1
    _, W = cdef._dir_matrices()
    return np.stack([(W[0] * pd * pd).sum(1), (W[1, :11] * po * po).sum(1),
                     (W[2, :8] * pr * pr).sum(1),
                     (W[1, :11] * pa * pa).sum(1)], axis=1)


def k3_model(plane, fw, fh, cs):
    """cdef_direction_launch in numpy: (dirs, var) int32."""
    uh, uw = -(-fh // 8), -(-fw // 8)
    dirs = np.zeros((uh, uw), np.int32)
    var = np.zeros((uh, uw), np.int32)
    for by in range(uh):
        for bx0 in range(0, uw, K3_UNITS):
            # the strip: 8 rows of 8 * K3_UNITS samples
            ys = 8 * by + np.arange(8)[:, None]
            xs = 8 * bx0 + np.arange(8 * K3_UNITS)[None, :]
            inside = (ys < fh) & (xs < fw)
            s = np.full(inside.shape, VL, np.int64)
            s[inside] = plane[np.broadcast_to(ys, inside.shape)[inside],
                              np.broadcast_to(xs, inside.shape)[inside]]
            X = ((s >> cs) - 128).reshape(8, K3_UNITS, 8).transpose(1, 0, 2)
            # lane 0: X; lane 1: V[i][j] = X[j][7 - i]
            c0 = _families(X)
            c1 = _families(X.transpose(0, 2, 1)[:, ::-1, :])
            cost = np.concatenate([c0, c1], axis=1)        # directions 0..7
            best = np.argmax(cost, axis=1)                 # first maximum
            opp = cost[np.arange(K3_UNITS), best ^ 4]
            top = cost[np.arange(K3_UNITS), best]
            n = min(K3_UNITS, uw - bx0)
            dirs[by, bx0:bx0 + n] = best[:n]
            var[by, bx0:bx0 + n] = ((top - opp) >> 10)[:n].astype(np.int32)
    return dirs, var


def _check_k3(plane, fw, fh, cs):
    got = k3_model(plane, fw, fh, cs)
    d, v = cdef.direction_plain(torch.from_numpy(plane), fw, fh, cs)
    pad = ref.pad_very_large(plane, fw, fh, 8, np)
    want = ref.find_dir_grid(ref._units_of(pad, fw, fh, 8, np), cs, np)
    for g, p, w, name in zip(got, (d, v), want, ("dirs", "var")):
        np.testing.assert_array_equal(g, p.numpy(), err_msg=name)
        np.testing.assert_array_equal(g, w, err_msg=name)
    return got


def _pattern_units(n_side):
    """Units of periodic patterns x = f((a i + b j) mod p): flat units
    (every direction ties), stripes and lattices (several directions tie
    at the maximum), tiled n_side x n_side."""
    units = []
    for a in range(0, 4):
        for b in range(0, 4):
            for p in (2, 3, 4):
                for lo, hi in ((0, 255), (100, 140)):
                    i, j = np.mgrid[0:8, 0:8]
                    units.append(np.where((a * i + b * j) % p == 0, hi, lo))
    units = np.array(units[:n_side * n_side])
    return units.reshape(n_side, n_side, 8, 8).transpose(0, 2, 1, 3) \
        .reshape(n_side * 8, n_side * 8).astype(np.int32)


@pytest.mark.parametrize("cs", [0, 2])
def test_k3_model_ties_take_the_first_maximum(cs):
    plane = _pattern_units(9) << cs
    fw = fh = 72
    dirs, var = _check_k3(plane, fw, fh, cs)
    units = ((plane.astype(np.int64) >> cs) - 128).reshape(9, 8, 9, 8) \
        .transpose(0, 2, 1, 3).reshape(81, 8, 8)
    _, W = cdef._dir_matrices()
    M, _ = cdef._dir_matrices()
    p = units.reshape(81, 64) @ M.reshape(120, 64).T
    cost = (W * p.reshape(81, 8, 15) ** 2).sum(-1)
    ties = (cost == cost.max(1, keepdims=True)).sum(1)
    # flat units tie in all 8 directions (direction 0 wins); others tie
    # in some, with a winner past 0
    assert (ties == 8).any() and (dirs.ravel()[ties == 8] == 0).all()
    assert ((ties > 1) & (ties < 8) & (dirs.ravel() > 0)).any()


@pytest.mark.parametrize("frame", [(72, 40), (1100, 21), (530, 77)],
                         ids=["small", "wider_than_a_strip", "ragged"])
@pytest.mark.parametrize("cs", [0, 2])
def test_k3_model_edges_read_very_large(frame, cs):
    """Frames that end inside a unit (edge units read CDEF_VERY_LARGE),
    strips of 64 units and a last partial strip."""
    fw, fh = frame
    plane = _noisy_plane(-(-fh // 8) * 8 + 3, -(-fw // 8) * 8 + 5, fw, 8 + cs)
    dirs, var = _check_k3(plane, fw, fh, cs)
    if fw % 8 or fh % 8:
        # the edge units' costs reach past 2^31 (var wraps as in the C)
        assert np.abs(var[-1]).max() > 1000


def test_k3_model_random_units():
    rng = np.random.default_rng(11)
    plane = rng.integers(0, 256, (48, 560)).astype(np.int32)
    _check_k3(plane, 560, 48, 0)
