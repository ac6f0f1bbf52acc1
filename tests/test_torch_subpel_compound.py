"""The facts the Hopper forms of K7 (kernels/csrc/subpel_refine.cu) and K9
(kernels/csrc/compound_joint.cu) rest on, and their plain versions against
the JAX package's numpy twins where the first-minimum rule decides.

K7 shares its filter work across the 25 quarter-pel candidates: three
horizontal phases (q4 4, 8 and 12) kept as the 16-bit "both"
intermediates, vertical phases over them, and the copy.  The tests check
that the REGULAR taps of those phases fit signed bytes (dp4a, dp2a), that
every intermediate of 8-bit pixels fits 16 bits, that the x-only rounding
is an integer function of the intermediate, and that the shared form, as
the kernel computes it, gives the plain version's MVs and prediction.
Both plain versions are then held against the numpy twins on flat and
periodic planes, where many candidates tie."""
import numpy as np
import pytest
import torch

from svt_av1_tpu.ops import bme as ref_bme
from svt_av1_tpu.ops import inter as ref_inter
from svt_av1_tpu.pipeline import batched_inter as ref_bi
from svt_av1_tpu.pipeline.batched_md import default_mode_bits
from svt_av1_tpu.entropy.tables import FrameCdfs
from svt_av1_tpu_torch.ops import bme
from svt_av1_tpu_torch.pipeline import batched_inter as bi

PHASES = (4, 8, 12)          # the q4 phases of dx8, dy8 in {-4, -2, 2, 4}


def _taps(q4):
    return bme._regular_taps(torch.device("cpu"))[q4].numpy().astype(
        np.int64)


def _im(h):
    """The "both" intermediate of a horizontal tap sum h (convolve_2d_sr:
    2^14 offset, round_0 = 3)."""
    return (h + (1 << 14) + 4) >> 3


@pytest.mark.parametrize("q4", PHASES)
def test_regular_taps_of_the_three_phases_fit_signed_bytes(q4):
    t = _taps(q4)
    want = ref_inter.interp_kernel(ref_inter.REGULAR, q4, 16)
    np.testing.assert_array_equal(t, want)
    assert t[0] == 0 and t[7] == 0
    assert t.min() >= -128 and t.max() <= 127 and t.sum() == 128
    assert t.min() >= -14 and t.max() <= 110


@pytest.mark.parametrize("q4", PHASES)
def test_both_intermediates_of_8_bit_pixels_fit_16_bits(q4):
    """The extreme patches (255 under the positive taps and 0 under the
    negative ones, and the reverse) bound every intermediate; all lie in
    [1156, 7021], inside int16, and so do those of random patches."""
    t = _taps(q4)
    hi = _im(int((255 * (t > 0) * t).sum()))
    lo = _im(int((255 * (t < 0) * t).sum()))
    assert 1156 <= lo <= hi <= 7021 < (1 << 15)
    rng = np.random.default_rng(q4)
    pix = rng.integers(0, 256, (4096, 8))
    im = _im(pix @ t)
    assert lo <= im.min() and im.max() <= hi
    # the dp2a accumulation of 8 taps over intermediates, with the offset
    # bits, stays inside int32
    assert (1 << 19) + 1024 + 8 * 110 * hi < (1 << 31)


def test_x_only_rounding_is_a_function_of_the_intermediate():
    """x only: (((h + 4) >> 3) + 8) >> 4 equals (im - 2040) >> 4 for every
    horizontal sum 8-bit pixels can reach."""
    h = np.arange(-255 * 28, 255 * 156 + 1, dtype=np.int64)
    np.testing.assert_array_equal(((((h + 4) >> 3) + 8) >> 4),
                                  (_im(h) - 2040) >> 4)


def _shared_form(src, ref, mv_r, mv_c, row0=0):
    """K7's shared form in numpy, unit by unit as the kernel computes it:
    the 24x24 patch, the column tables (q4 8 over patch columns 3..19, 12
    over 3..18, the copy and q4 4 over 4..19, as 16-bit values), each
    candidate's vertical phase over 8 table rows, the first strict
    minimum of SAD + 2(|dy8| + |dx8|) in SUBPEL_DELTAS order."""
    H, W = ref.shape
    nr, nc = src.shape[0] // 16, W // 16
    taps = {q: _taps(q) for q in PHASES}
    out_r = np.zeros((nr, nc), np.int64)
    out_c = np.zeros((nr, nc), np.int64)
    pred = np.zeros(src.shape, np.uint8)
    ar = np.arange(24)
    for uy in range(nr):
        for ux in range(nc):
            mr, mc = int(mv_r[uy, ux]), int(mv_c[uy, ux])
            oy = min(max(uy * 16 + row0 + mr - 4 + 24, 0), H + 48 - 25) - 24
            ox = min(max(ux * 16 + mc - 4 + 24, 0), W + 48 - 25) - 24
            p = ref[np.clip(oy + ar, 0, H - 1)][:, np.clip(ox + ar, 0, W - 1)] \
                .astype(np.int64)

            def hcols(q, j0, n):          # columns j0 .. j0 + n - 1
                win = np.stack([p[:, j0 - 3 + t:j0 - 3 + t + n]
                                for t in range(8)], -1)
                v = _im(win @ taps[q])
                assert v.min() >= 0 and v.max() < (1 << 15)
                return v
            t8 = hcols(8, 3, 17)
            cols = [("both", t8[:, 0:16]), ("both", hcols(12, 3, 16)),
                    ("copy", p[:, 4:20]), ("both", hcols(4, 4, 16)),
                    ("both", t8[:, 1:17])]
            s = src[uy * 16:uy * 16 + 16, ux * 16:ux * 16 + 16] \
                .astype(np.int64)
            best = None
            for iy, (q, off) in enumerate(((8, 0), (12, 0), (0, 0), (4, 1),
                                           (8, 1))):
                for ix, (kind, tab) in enumerate(cols):
                    if q == 0:
                        v = tab[4:20]
                        if kind == "both":
                            v = (v - 2040) >> 4
                    else:
                        acc = sum(taps[q][t] * tab[off + t:off + t + 16]
                                  for t in range(8))
                        v = (acc + 64) >> 7 if kind == "copy" else \
                            ((acc + (1 << 19) + 1024) >> 11) - 384
                    v = np.clip(v, 0, 255)
                    cost = np.abs(s - v).sum() + 2 * (2 * abs(iy - 2)
                                                      + 2 * abs(ix - 2))
                    if best is None or cost < best[0]:
                        best = (cost, iy, ix, v)
            _, iy, ix, v = best
            out_r[uy, ux] = mr * 8 + (iy - 2) * 2
            out_c[uy, ux] = mc * 8 + (ix - 2) * 2
            pred[uy * 16:uy * 16 + 16, ux * 16:ux * 16 + 16] = v
    return out_r, out_c, pred


def _moving_pair(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ref = (120 + 60 * np.sin(xx / 9) + 40 * np.cos(yy / 7)
           + rng.integers(-10, 11, (h, w))).clip(0, 255).astype(np.uint8)
    # a saturated corner: the extreme intermediates on real patches
    ref[:16, :24] = np.where((xx[:16, :24] + yy[:16, :24]) % 2, 255, 0)
    a = np.roll(ref, (3, -5), axis=(0, 1)).astype(np.int32)
    b = np.roll(ref, (4, -5), axis=(0, 1)).astype(np.int32)
    src = ((a + b + 1) // 2 + rng.integers(-2, 3, (h, w))).clip(0, 255)
    return src.astype(np.uint8), ref


@pytest.mark.parametrize("row0", [0, 32])
def test_k7_shared_form_equals_the_plain_version(row0):
    """The shared form (what the kernel computes) against subpel_plain on
    a moving pair with a saturated corner, for the ME's MVs reaching into
    the frame and for MVs past every edge, on the frame and on a stripe."""
    src, ref = _moving_pair(64, 96, row0 + 1)
    rng = np.random.default_rng(row0)
    stripe = np.ascontiguousarray(src[row0:row0 + 32])
    for mv in (rng.integers(-3, 4, (2, 2, 6)),
               rng.integers(-40, 41, (2, 2, 6))):
        mv = mv.astype(np.int32)
        got = _shared_form(stripe, ref, mv[0], mv[1], row0)
        want = bme.subpel_plain(torch.from_numpy(stripe),
                                torch.from_numpy(ref),
                                torch.from_numpy(mv[0]),
                                torch.from_numpy(mv[1]), 8, row0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("name", ["me_coarse", "me_refine",
                                  "subpel_refine16"])
def test_cpu_tensors_count_no_wrapper_call_or_launch(name):
    """A wrapper counts a call where it takes its kernel's path and a
    launch where it launches the kernel: on CPU tensors K5-K7 take their
    plain versions and leave both counts as they were."""
    src, ref = (torch.from_numpy(p) for p in _moving_pair(64, 128, 7))
    fn = getattr(bme, name)
    before = (fn.calls, fn.launches)
    me = bme.frame_me(src, ref, 8, ((16, 16),))
    mv = [bi._nested_to_grid(me[(16, 16)][i], 1, 2, 4, 4) for i in (0, 1)]
    got = bme.subpel_refine16(src, ref, *mv)
    for g, w in zip(got, bme.subpel_plain(src, ref, *mv)):
        assert torch.equal(g, w)
    assert (fn.calls, fn.launches) == before


def _tie_planes(kind, h, w):
    """(src, ref): a flat pair (every candidate and offset ties on SAD) or
    a period-8 pattern moved by a whole number of pixels (ties every
    eighth offset)."""
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "flat":
        ref = np.full((h, w), 97, np.uint8)
        return ref.copy(), ref
    ref = (100 + 30 * (xx % 8) + 7 * (yy % 8)).astype(np.uint8)
    return np.roll(ref, (2, 3), axis=(0, 1)), ref


@pytest.mark.parametrize("kind", ["flat", "periodic"])
def test_subpel_plain_equals_the_twin_where_candidates_tie(kind):
    H, W = 64, 128
    src, ref = _tie_planes(kind, H, W)
    rng = np.random.default_rng(7)
    for mv in (np.zeros((2, H // 16, W // 16), np.int32),
               rng.integers(-40, 41, (2, H // 16, W // 16)).astype(
                   np.int32)):
        want = ref_bme.subpel_refine16(src.astype(np.int32),
                                       ref.astype(np.int32), mv[0], mv[1],
                                       W, H, 8, np)
        got = bme.subpel_plain(torch.from_numpy(src), torch.from_numpy(ref),
                               torch.from_numpy(mv[0]),
                               torch.from_numpy(mv[1]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("kind", ["flat", "periodic"])
def test_joint_arm_equals_the_twin_where_offsets_tie(kind):
    """One compound arm's 7x7 joint search (K9 step 3) against the twin's
    _joint_arm, with seeds that clip the window at every frame edge."""
    H, W = 64, 128
    src, ref = _tie_planes(kind, H, W)
    refs = np.stack([ref, np.roll(ref, (1, 1), axis=(0, 1))])
    nr, nc = H // 16, W // 16
    rng = np.random.default_rng(3)
    fixed = rng.integers(90, 105, (nr, nc, 16, 16)).astype(np.int32)
    if kind == "periodic":
        fixed = np.full((nr, nc, 16, 16), 115, np.int32)
    s16 = src.astype(np.int32).reshape(nr, 16, nc, 16).transpose(0, 2, 1, 3)
    arm_k = rng.integers(0, 2, (nr, nc)).astype(np.int32)
    seed_r, seed_c = (rng.integers(-900, 901, (2, nr, nc)) & ~1).astype(
        np.int32)
    refp = np.pad(refs.astype(np.int32), ((0, 0), (ref_bi.MC_PAD,) * 2,
                                          (ref_bi.MC_PAD,) * 2), mode="edge")
    gy, gx = np.meshgrid(np.arange(nr) * 16, np.arange(nc) * 16,
                         indexing="ij")
    want = ref_bi._joint_arm(refp, s16, fixed, arm_k, seed_r, seed_c,
                             gy.ravel(), gx.ravel(), np)
    t = torch.from_numpy
    got = bi._joint_arm(t(refs), t(np.ascontiguousarray(s16)), t(fixed),
                        t(arm_k), t(seed_r), t(seed_c))
    np.testing.assert_array_equal(got[0].numpy().reshape(want[0].shape),
                                  want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("kind", ["flat", "periodic"])
def test_compound_fields_equal_the_twin_where_picks_tie(kind):
    """The whole compound candidate (K9's plain version inside the port's
    plan) against the twin's inter_frame_maps on tie-heavy planes: the
    paired references, both arms' MVs and the selection are exact."""
    H, W = 128, 128
    src, ref = _tie_planes(kind, H, W)
    refs = [ref, np.roll(ref, (-1, 2), axis=(0, 1))]
    bwd, rel = (False, True), (-1, 1)
    qindex, lam = 60, 900.0
    mode_bits = default_mode_bits(FrameCdfs(qindex))
    want = ref_bi.inter_frame_maps(
        src, np.stack(refs), W, H, qindex, lam, mode_bits, 8, np,
        bwd_mask=bwd, allow_compound=True,
        rel_dists=np.asarray(rel, np.int32),
        coarse_r=tuple(ref_bi.bme.coarse_r_for_dist(d) for d in rel),
        pens=ref_bi.selection_pens(qindex, 8))
    got = bi.inter_maps_dispatch(src, refs, W, H, qindex, lam, mode_bits, 8,
                                 "cpu", bwd, True, rel)
    for key in bi.SEL_KEYS:
        np.testing.assert_array_equal(got[2][key], np.asarray(want[2][key]),
                                      key)
