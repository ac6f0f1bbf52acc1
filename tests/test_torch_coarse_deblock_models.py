"""The models that the one-launch K5 (kernels/csrc/me_coarse.cu) and K2
(kernels/csrc/deblock.cu) rest on, run on the CPU against the port's
plain versions and the JAX package's numpy twins; exact equality
throughout.

K5: decimated samples fit a byte; a numpy model of the kernel's search
(byte-packed words, __byte_perm-shifted reference words, packed absolute
differences with accumulate, the offsets split over 256 threads in runs
of row offsets and a lexicographic (cost, raster index) reduction)
equals coarse_sb_search.

K2: a tiled torch form of the kernel (T x T output tiles, a 12-sample
halo, the vertical pass on every row of the region for the edges that
change the tile's columns, the horizontal pass on the tile's columns,
each pass writing the samples it changes into a second buffer with the
reference's merge rank) equals loop_filter_plane_full.
"""
import numpy as np
import pytest
import torch

from svt_av1_tpu.ops import bme as ref_bme
from svt_av1_tpu.ops import dlf as ref_dlf
from svt_av1_tpu_torch.ops import bme, dlf

# -- K5 ---------------------------------------------------------------------

K5_THREADS = 256
K5_ROW_WORDS = 21           # words per region row in shared memory


def _decimate_bytes(plane):
    """/8 box decimation as the kernel stores it: (8x8 sum) >> 6, uint8."""
    h8, w8 = plane.shape[0] // 8, plane.shape[1] // 8
    s = plane[:h8 * 8, :w8 * 8].astype(np.int64).reshape(h8, 8, w8, 8) \
        .sum((1, 3)) >> 6
    assert s.min() >= 0 and s.max() <= 255
    return s.astype(np.uint8)


def _words(rows_bytes):
    """[..., 4n] uint8 -> [..., n] little-endian 32-bit words (int64)."""
    b = rows_bytes.astype(np.int64).reshape(rows_bytes.shape[:-1] + (-1, 4))
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def _byte_perm(x, y, sel):
    """PTX prmt (default mode): byte i of the result is byte
    (sel >> 4i) & 7 of the 8 bytes y:x (x the low four)."""
    b = [(x >> (8 * i)) & 255 for i in range(4)] \
        + [(y >> (8 * i)) & 255 for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= b[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def _sad4(a, b, acc):
    """vabsdiff4.u32.u32.u32.add: acc + sum of the four byte |a - b|."""
    return acc + sum(np.abs(((a >> (8 * i)) & 255) - ((b >> (8 * i)) & 255))
                     for i in range(4))


def _k5_run(t, npos):
    """The row offsets thread t of the search takes (its column offset is
    t % npos): a run of ceil(npos / G) from (t // npos) times that, for
    the G = 256 // npos groups."""
    groups = K5_THREADS // npos
    run = -(-npos // groups)
    g = t // npos
    return range(g * run, min(g * run + run, npos)) if g < groups else ()


def k5_model(src, ref, R, row0=0):
    """me_coarse.cu's search in numpy: mv [rows/64, W/64, 2] int32."""
    s8, r8 = _decimate_bytes(src), _decimate_bytes(ref)
    hr8, w8 = r8.shape
    n_sby, n_sbx = src.shape[0] // 64, src.shape[1] // 64
    L, npos = 8 + 2 * R, 2 * R + 1
    # per SB: the tile as 16 words, the clamped region as rows of words
    sby, sbx = np.meshgrid(np.arange(n_sby), np.arange(n_sbx), indexing="ij")
    sby, sbx = sby.ravel(), sbx.ravel()
    tiles = np.stack([s8[y * 8:y * 8 + 8, x * 8:x * 8 + 8]
                      for y, x in zip(sby, sbx)])
    s = _words(tiles.reshape(-1, 8, 8)).reshape(-1, 16)
    ry = np.clip(row0 // 8 + sby[:, None] * 8 - R + np.arange(L), 0, hr8 - 1)
    rx = np.clip(sbx[:, None] * 8 - R + np.arange(L), 0, w8 - 1)
    region = np.zeros((len(sby), L, 4 * K5_ROW_WORDS), np.uint8)
    region[:, :, :L] = r8[ry[:, :, None], rx[:, None, :]]
    reg = _words(region)                                  # [n, L, 21]
    cost = np.zeros((len(sby), npos, npos), np.int64)     # [n, ay, ax]
    bias = np.abs(np.arange(npos) - R)
    for ax in range(npos):
        q, sel = ax >> 2, 0x3210 + 0x1111 * (ax & 3)
        lo = _byte_perm(reg[:, :, q], reg[:, :, q + 1], sel)      # [n, L]
        hi = _byte_perm(reg[:, :, q + 1], reg[:, :, q + 2], sel)
        acc = np.zeros((len(sby), npos), np.int64)
        for i in range(8):
            acc = _sad4(s[:, 2 * i, None], lo[:, i:i + npos], acc)
            acc = _sad4(s[:, 2 * i + 1, None], hi[:, i:i + npos], acc)
        cost[:, :, ax] = acc + bias + bias[ax]
    # thread t: column offset t % npos, a run of row offsets from
    # g = t // npos; each keeps its first strict minimum, then the
    # lexicographic (cost, raster index) minimum over the threads
    best = np.full((len(sby), 2), np.iinfo(np.int64).max)
    for t in range(K5_THREADS):
        ax = t % npos
        for ay in _k5_run(t, npos):
            c = cost[:, ay, ax]
            idx = ay * npos + ax
            take = (c < best[:, 0]) | ((c == best[:, 0]) & (idx < best[:, 1]))
            best[take] = np.stack([c, np.full_like(c, idx)], -1)[take]
    i = best[:, 1]
    mv = np.stack([(i // npos - R) * 8, (i % npos - R) * 8], -1)
    return mv.reshape(n_sby, n_sbx, 2).astype(np.int32)


def _planes(h, w, seed, step=(3, -5)):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ref = (120 + 70 * np.sin(xx / 13) + 50 * np.cos(yy / 9)
           + rng.integers(-20, 21, (h, w))).clip(0, 255).astype(np.uint8)
    src = np.roll(ref, step, axis=(0, 1)).astype(np.int32)
    src = (src + rng.integers(-3, 4, (h, w))).clip(0, 255).astype(np.uint8)
    return src, ref


def _twin(src, ref, R, row0=0):
    return ref_bme.coarse_sb_search(src.astype(np.int32),
                                    ref.astype(np.int32), np, row0=row0,
                                    coarse_r=R)


@pytest.mark.parametrize("kind", ["random", "white"])
def test_k5_decimated_samples_fit_a_byte(kind):
    rng = np.random.default_rng(1)
    plane = (rng.integers(0, 256, (128, 192)) if kind == "random"
             else np.full((128, 192), 255)).astype(np.uint8)
    got = _decimate_bytes(plane)
    np.testing.assert_array_equal(
        got, bme._decimate8(torch.from_numpy(plane)).numpy())
    np.testing.assert_array_equal(got, ref_bme._decimate8(plane, np))
    if kind == "white":
        assert (got == 255).all()


@pytest.mark.parametrize("R", [1, 8, 12, 16, 24, 32])
def test_k5_thread_split_covers_every_offset_once(R):
    npos = 2 * R + 1
    seen = np.zeros((npos, npos), int)
    for t in range(K5_THREADS):
        for ay in _k5_run(t, npos):
            seen[ay, t % npos] += 1
            # the window of 8 rows stays inside the (8 + 2R)-row region
            assert ay + 7 < 8 + 2 * R
    assert (seen == 1).all()


@pytest.mark.parametrize("R", [8, 12, 16, 24, 32])
def test_k5_packed_model_equals_the_twin(R):
    src, ref = _planes(192, 256, R, step=(4 * R % 29, -3 * R % 31))
    want = _twin(src, ref, R)
    got = k5_model(src, ref, R)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bme.coarse_sb_search(
        torch.from_numpy(src), torch.from_numpy(ref), R).numpy(), want)


@pytest.mark.parametrize("row0", [0, 64, 192])
@pytest.mark.parametrize("R", [8, 24])
def test_k5_packed_model_on_stripes(row0, R):
    src, ref = _planes(256, 256, row0 + R)
    stripe = np.ascontiguousarray(src[row0:row0 + 64])
    want = _twin(stripe, ref, R, row0)
    np.testing.assert_array_equal(k5_model(stripe, ref, R, row0), want)
    np.testing.assert_array_equal(bme.coarse_sb_search(
        torch.from_numpy(stripe), torch.from_numpy(ref), R, row0).numpy(),
        want)


@pytest.mark.parametrize("shape", [(64, 320), (256, 64)],
                         ids=["one_sb_row", "one_sb_column"])
@pytest.mark.parametrize("R", [8, 16, 32])
def test_k5_packed_model_where_the_clamp_decides(shape, R):
    src, ref = _planes(*shape, R, step=(5, 7))
    want = _twin(src, ref, R)
    np.testing.assert_array_equal(k5_model(src, ref, R), want)
    # flat planes: every offset ties on SAD, the centre bias decides
    flat = np.full(shape, 77, np.uint8)
    np.testing.assert_array_equal(k5_model(flat, flat, R),
                                  _twin(flat, flat, R))


# -- K2 ---------------------------------------------------------------------

HALO = 12


def _rank(side, k):
    """The reference merge's order of a sample's writers (_merge): p
    samples k < 3 of p6..p0 rank 3, the rest 1; q samples k < 4 of
    q0..q6 rank 2, the rest 4; the highest changed rank wins."""
    return (3 if k < 3 else 1) if side == "p" else (2 if k < 4 else 4)


def _pass(src, dst, rank, lines_ok, masks, edges, line_index, vertical,
          limit_out, lo, span, thr, shift, stats):
    """One direction on a tile: ``src`` [lines, n] holds the pass's input
    along each line (rows for vertical edges, columns for horizontal
    ones); edges at positions ``edges`` (global) with local index
    ``line_index``; changed samples of positions [lo, lo + span) below
    ``limit_out`` go to ``dst`` (local offset -lo) by rank."""
    apply_m, fsize = masks
    n_lines = src.shape[0]
    pos = torch.tensor(edges)
    e = pos // 4 - 1
    ok_e = (e >= 0) & (e < apply_m.shape[1] if vertical
                       else e < apply_m.shape[0])
    ec = e.clamp(0, (apply_m.shape[1] if vertical else apply_m.shape[0]) - 1)
    li = line_index.clamp(0, (apply_m.shape[0] if vertical
                              else apply_m.shape[1]) * 4 - 1) >> 2
    if vertical:
        am = apply_m[li[:, None], ec[None, :]].bool()
        fs = fsize[li[:, None], ec[None, :]].to(torch.int32)
    else:
        am = apply_m[ec[None, :], li[:, None]].bool()
        fs = fsize[ec[None, :], li[:, None]].to(torch.int32)
    am &= lines_ok[:, None] & ok_e[None, :]
    loc = pos - lo + HALO                   # edge position in ``src``
    k7 = torch.arange(7)
    p = src[:, (loc[:, None] - 7 + k7)]     # [lines, edges, 7]
    q = src[:, (loc[:, None] + k7)]
    fp, fq = dlf._edge_filter_batch(p, q, am, fs, *thr, shift)
    for side, f, o, off in (("p", fp, p, -7), ("q", fq, q, 0)):
        for k in range(7):
            r = _rank(side, k)
            at = pos + off + k                              # [edges]
            inside = (at >= lo) & (at < lo + span) & (at < limit_out)
            changed = (f[..., k] != o[..., k]) & inside[None, :]
            li_, ei_ = torch.nonzero(changed, as_tuple=True)
            col = at[ei_] - lo
            stats["writes"] += len(li_)
            stats["collisions"] += int((rank[li_, col] > 0).sum())
            win = r > rank[li_, col]
            dst[li_[win], col[win]] = f[li_[win], ei_[win], k]
            rank[li_[win], col[win]] = r
    return n_lines


def tiled_deblock(plane, apply_v, fsize_v, apply_h, fsize_h, width, height,
                  level_v, level_h, sharpness, bd=8, T=64, stats=None):
    """deblock.cu's form in torch: int32 [H, W] out of place."""
    stats = {"writes": 0, "collisions": 0} if stats is None else stats
    H, W = plane.shape
    x4max, y4max = (width + 3) >> 2, (height + 3) >> 2
    xv, yv = 4 * x4max, 4 * y4max
    shift = bd - 8
    masks_v = [torch.as_tensor(np.asarray(m)) for m in (apply_v, fsize_v)]
    masks_h = [torch.as_tensor(np.asarray(m)) for m in (apply_h, fsize_h)]
    RG = T + 2 * HALO
    padded = torch.zeros((H + T + 2 * HALO, W + T + 2 * HALO),
                         dtype=torch.int32)
    padded[HALO:HALO + H, HALO:HALO + W] = plane
    assert int(plane.min()) >= 0 and int(plane.max()) <= 32767   # int16
    out = torch.empty_like(plane)
    n_e = T // 4 + 3
    for y0 in range(0, H, T):
        for x0 in range(0, W, T):
            region = padded[y0:y0 + RG, x0:x0 + RG]
            b = region[:, HALO:HALO + T].clone()
            b_rank = torch.zeros_like(b)
            if level_v > 0 and x4max > 1:
                ys = torch.arange(RG) + y0 - HALO
                _pass(region, b, b_rank, (ys >= 0) & (ys < yv), masks_v,
                      [x0 - 4 + 4 * i for i in range(n_e)], ys, True, xv,
                      x0, T, dlf.thresholds(level_v, sharpness, shift),
                      shift, stats)
            c = b[HALO:HALO + T].clone()
            c_rank = torch.zeros_like(c)
            if level_h > 0 and y4max > 1:
                xs = torch.arange(T) + x0
                # lines are the tile's columns: b transposed
                ct, crt = c.t().contiguous(), c_rank.t().contiguous()
                _pass(b.t(), ct, crt, xs < xv, masks_h,
                      [y0 - 4 + 4 * i for i in range(n_e)], xs, False, yv,
                      y0, T, dlf.thresholds(level_h, sharpness, shift),
                      shift, stats)
                c = ct.t()
            h, w = min(T, H - y0), min(T, W - x0)
            out[y0:y0 + h, x0:x0 + w] = c[:h, :w]
    return out


def _smooth_plane(h, w, seed, bd=8, block=8):
    """Flat blocks with steps of a few levels between them and 0/1 noise:
    the 6-, 8- and 14-tap filters' flatness tests pass on most lines."""
    rng = np.random.default_rng(seed)
    rows = np.cumsum(rng.integers(-2, 3, h // block + 1))
    cols = np.cumsum(rng.integers(-2, 3, w // block + 1))
    base = 120 + rows[:, None] + cols[None, :]
    p = np.repeat(np.repeat(base, block, 0), block, 1)[:h, :w]
    p = p + rng.integers(0, 2, (h, w))
    return (p.clip(0, 255) << (bd - 8)).astype(np.int32)


def _random_masks(h, w, vw, vh, chroma, seed):
    rng = np.random.default_rng(seed)
    y4, x4 = h // 4, w // 4
    tx = rng.choice([4, 8, 16, 32], size=(y4, x4)).astype(np.int32)
    skip = rng.random((y4, x4)) < 0.2
    bex, bey = rng.random((y4, x4)) < 0.6, rng.random((y4, x4)) < 0.6
    return ref_dlf.edge_params(tx, tx, skip, bex, bey, vw, vh, chroma)


def _check(plane, prm, vw, vh, lv, lh, sharpness, bd, T=64, stats=None):
    """model == the port's plain version == the numpy twin."""
    want = ref_dlf.loop_filter_plane_full(plane, *prm, vw, vh, lv, lh,
                                          sharpness, bd, np)
    plain = dlf.loop_filter_plane_full(torch.from_numpy(plane), *prm, vw,
                                       vh, lv, lh, sharpness, bd)
    np.testing.assert_array_equal(plain.numpy(), want)
    got = tiled_deblock(torch.from_numpy(plane), *prm, vw, vh, lv, lh,
                        sharpness, bd, T, stats)
    np.testing.assert_array_equal(got.numpy(), want)
    return want


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
@pytest.mark.parametrize("T", [64, 32])
def test_k2_tiled_form_every_filter_size(chroma, T):
    h, w = 160, 224
    plane = _smooth_plane(h, w, 7 + chroma)
    prm = _random_masks(h, w, w, h, chroma, 3 + chroma)
    sizes = (4, 6) if chroma else (4, 8, 14)
    stats = {"writes": 0, "collisions": 0}
    _check(plane, prm, w, h, 20, 20, 0, 8, T, stats)
    # each filter size changes samples on its own
    for s in sizes:
        only = (prm[0] & (prm[1] == s), prm[1], prm[2] & (prm[3] == s),
                prm[3])
        got = _check(plane, only, w, h, 20, 20, 0, 8, T)
        assert (got != plane).any(), s
    # with random luma masks two edges change one sample and the rank
    # decides (chroma filters change at most two samples on each side of
    # an edge, so chroma edges 4 apart never meet)
    assert stats["writes"] > 0
    assert (stats["collisions"] > 0) != chroma


@pytest.mark.parametrize("d", [4, 8, 12])
@pytest.mark.parametrize("side", [-1, 1], ids=["before", "after"])
def test_k2_tiled_form_14_tap_edge_near_a_tile_boundary(d, side):
    h = w = 192
    plane = np.full((h, w), 100, np.int32)
    at = 64 + side * d                      # a 14-tap edge, vertical and
    plane[:, at:] += 16                     # horizontal, d from x/y = 64
    plane[at:, :] += 12
    x4, y4 = w // 4, h // 4
    apply_v = np.zeros((y4, x4 - 1), bool)
    apply_h = np.zeros((y4 - 1, x4), bool)
    apply_v[:, at // 4 - 1] = True
    apply_h[at // 4 - 1, :] = True
    fsize_v = np.full(apply_v.shape, 14, np.uint8)
    fsize_h = np.full(apply_h.shape, 14, np.uint8)
    prm = (apply_v, fsize_v, apply_h, fsize_h)
    got = _check(plane, prm, w, h, 30, 30, 0, 8)
    # the 14-tap filter ran: p5 and q5 moved
    assert got[10, at - 6] != plane[10, at - 6]
    assert got[at + 5, 10] != plane[at + 5, 10]


@pytest.mark.parametrize("vis", [(150, 101), (121, 90), (160, 112)])
def test_k2_tiled_form_visible_sizes(vis):
    vw, vh = vis
    h, w = 112, 160                          # the plane holds the visible
    plane = _smooth_plane(h, w, vw)
    prm = _random_masks(h, w, vw, vh, False, vh)
    _check(plane, prm, vw, vh, 40, 40, 0, 8)
    _check(plane, prm, vw, vh, 40, 40, 0, 8, T=32)


@pytest.mark.parametrize("case", ["chroma_levels", "one_level_0",
                                  "bd10", "bd10_chroma"])
def test_k2_tiled_form_levels_chroma_and_bd10(case):
    chroma = "chroma" in case
    bd = 10 if "bd10" in case else 8
    lv, lh = {"chroma_levels": (12, 40), "one_level_0": (0, 25),
              "bd10": (30, 18), "bd10_chroma": (22, 63)}[case]
    h, w, vw, vh = 96, 160, 150, 90
    plane = _smooth_plane(h, w, bd + lv, bd)
    prm = _random_masks(h, w, vw, vh, chroma, lh)
    got = _check(plane, prm, vw, vh, lv, lh, 3 if chroma else 0, bd)
    assert (got != plane).any()
    # and the other level 0
    if case == "one_level_0":
        _check(plane, prm, vw, vh, lh, 0, 0, bd)
