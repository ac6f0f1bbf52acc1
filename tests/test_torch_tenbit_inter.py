"""10-bit 4:2:0 low-delay P in the port (svt_av1_tpu_torch) on the CPU,
against the JAX package.

The 16-bit forms of K5 (me_coarse.cu), K6 (me_refine.cu), K7
(subpel_refine.cu) and K8 (inter_select.cu) run only on the card; here
their plain versions, which the wrappers take for CPU tensors, are held
against the JAX package's numpy twins at bd 10, and the packings the
16-bit forms adopt are modelled in numpy:

* the inter frame program (``inter_maps_dispatch(..., 10, "cpu")``)
  against ``inter_frame_maps(..., 10, np)`` with one and three
  references: selection fields exact, MV bits within 1e-4, costs at the
  gates of tests/test_torch_batched_inter.py.  Before fault C6 was fixed
  the plain quarter-pel prediction wrapped every sample modulo 256, and
  these tests failed;
* K5's, K6's and K7's plain versions against the twins at bd 10;
* the 16-bit SADs as two absolute differences per word added in packed
  16-bit halves (K5, K6, K8), K5's and K6's 16-bit layouts (funnel
  shifts of 2-byte rows, 4-sample units), the width of K6's tables at
  the worst case (1023 against 0), and K7's "both" intermediate and
  roundings over every sum 10-bit samples reach, with its shared form at
  bd 10 against the plain version;
* C4's first site: the decider uploads a reference's recon with its
  samples above 255.

The slice's streams are in tests/test_torch_tenbit_inter_streams.py.
"""
import types

import numpy as np
import pytest
import torch

from svt_av1_tpu.entropy.tables import FrameCdfs
from svt_av1_tpu.ops import bme as ref_bme
from svt_av1_tpu.pipeline import batched_inter as ref_bi
from svt_av1_tpu.pipeline.batched_md import default_mode_bits
from svt_av1_tpu_torch.ops import bme, omd
from svt_av1_tpu_torch.pipeline import batched_inter as bi
from svt_av1_tpu_torch.pipeline.batched_md import TorchDecider
from svt_av1_tpu_torch.pipeline.frame_codec import REF_PAD

from test_torch_batched_inter import H, W, _clip

BD = 10
QINDEX, LAM = 60, 900.0 * 16          # rd_lambda scales by 4^(bd - 8)


def _clip10():
    """tests/test_torch_batched_inter.py's clip scaled to 10 bits: the
    source times 4 plus 3, the references times 4 plus 1."""
    src, refs = _clip()
    return (src.astype(np.uint16) * 4 + 3,
            [r.astype(np.uint16) * 4 + 1 for r in refs])


def _t16(a):
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int16))


# --------------------------------------------------------------------------
# the inter frame program at bd 10 (fault C6)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[1, 3], ids=["K1", "K3"])
def maps10(request):
    k = request.param
    src, refs = _clip10()
    mode_bits = default_mode_bits(FrameCdfs(QINDEX))
    want = ref_bi.inter_frame_maps(
        src, np.stack(refs[:k]), W, H, QINDEX, LAM, mode_bits, BD, np,
        bwd_mask=(False,) * k, pens=ref_bi.selection_pens(QINDEX, BD))
    got = bi.inter_maps_dispatch(src, refs[:k], W, H, QINDEX, LAM,
                                 mode_bits, BD, "cpu")
    return k, got, want


def test_selection_fields_are_exact_at_10_bits(maps10):
    k, (_, _, sf, mvb), (_, _, ref_sf, ref_mvb) = maps10
    for key in bi.SEL_KEYS:
        np.testing.assert_array_equal(sf[key], np.asarray(ref_sf[key]), key)
    np.testing.assert_allclose(mvb, np.asarray(ref_mvb), atol=1e-4)
    if k == 3:
        assert len(np.unique(sf["sel"])) > 1


def test_inter_costs_within_the_gate_at_10_bits(maps10):
    _, (_, cost, _, _), (_, ref_cost, _, _) = maps10
    for s in omd.INTER_SHAPES:
        close = np.isclose(cost[s], np.asarray(ref_cost[s]), rtol=2e-4,
                           atol=2.0).mean()
        assert close >= 0.99, (s, close)


def test_intra_maps_within_the_gate_at_10_bits(maps10):
    _, (intra, _, _, _), (ref_intra, _, _, _) = maps10
    for s in omd.ALL_SHAPES:
        assert (intra[s][0] == np.asarray(ref_intra[s][0])).mean() >= 0.97
        close = np.isclose(intra[s][1], np.asarray(ref_intra[s][1]),
                           rtol=2e-4, atol=2.0).mean()
        assert close >= 0.99, (s, close)


# --------------------------------------------------------------------------
# K5-K7's plain versions at bd 10 against the numpy twins
# --------------------------------------------------------------------------

@pytest.mark.parametrize("r,row0", [(8, 0), (24, 0), (8, 64)])
def test_coarse_search_at_10_bits_matches_twin(r, row0):
    src, refs = _clip10()
    stripe = src[row0:]
    got = bme.coarse_sb_search(_t16(stripe), _t16(refs[1]), r, row0)
    want = ref_bme.coarse_sb_search(stripe, refs[1], np, row0, r)
    np.testing.assert_array_equal(got.numpy(), want)


def test_refinement_at_10_bits_matches_twin():
    """frame_me's plain K5 + K6 at every ME shape, and the winning window
    per 16x16, equal to the twin's on 10-bit planes."""
    src, refs = _clip10()
    got = bme.frame_me(_t16(src), _t16(refs[2]), 8, bme.ME_SHAPES)
    want = ref_bme.frame_me(src, refs[2], np, 0, 8)
    for s in bme.ME_SHAPES:
        for g, w in zip(got[s], want[s]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), str(s))
    np.testing.assert_array_equal(got["win16"].numpy(), want["win16"])


def test_subpel_plain_at_10_bits_matches_twin():
    """The plain quarter-pel refinement keeps its prediction 16 bits wide
    (int16 holding [0, 1023]) and equals the twin's MVs and prediction."""
    src, refs = _clip10()
    me = ref_bme.frame_me(src, refs[1], np, 0, 8)
    grid = me["grid"]
    mvs = [bi._nested_to_grid(torch.from_numpy(np.asarray(
        me[(16, 16)][i]).astype(np.int32)), *grid, 4, 4) for i in (0, 1)]
    got = bme.subpel_plain(_t16(src), _t16(refs[1]), *mvs, BD)
    want = ref_bme.subpel_refine16(src, refs[1], mvs[0].numpy(),
                                   mvs[1].numpy(), W, H, bd=BD, xp=np)
    assert got[2].dtype == torch.int16
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2].max()) > 255


def test_compound_plain_keeps_16_bit_predictions():
    """C4's third site, the plain half: the compound candidate's
    prediction keeps the sample type at bd 10, and its fields equal the
    twin's under compound selection."""
    src, refs = _clip10()
    mode_bits = default_mode_bits(FrameCdfs(QINDEX))
    want = ref_bi.inter_frame_maps(
        src, np.stack(refs[:2]), W, H, QINDEX, LAM, mode_bits, BD, np,
        bwd_mask=(False, True), allow_compound=True,
        pens=ref_bi.selection_pens(QINDEX, BD))
    _, _, sf, mvb = bi.inter_maps_dispatch(src, refs[:2], W, H, QINDEX, LAM,
                                           mode_bits, BD, "cpu",
                                           (False, True), True)
    for key in bi.SEL_KEYS:
        np.testing.assert_array_equal(sf[key], np.asarray(want[2][key]), key)
    np.testing.assert_allclose(mvb, np.asarray(want[3]), atol=1e-4)
    src_t, refs_t = _t16(src), torch.stack([_t16(r) for r in refs[:2]])
    parts = []
    for r in refs_t:
        me = bme.frame_me(src_t, r, 8, ((16, 16), (64, 64)))
        a, b, p = bme.subpel_plain(
            src_t, r, bi._nested_to_grid(me[(16, 16)][0], 2, 4, 4, 4),
            bi._nested_to_grid(me[(16, 16)][1], 2, 4, 4, 4), BD)
        parts.append((p, a, b, me[(64, 64)][0].reshape(2, 4),
                      me[(64, 64)][1].reshape(2, 4)))
    comp = bi.compound_joint_plain(
        src_t, refs_t, *(torch.stack([q[i] for q in parts])
                         for i in range(5)), (False, True), (-1, 1), QINDEX,
        BD)
    assert comp["pred"].dtype == torch.int16
    assert int(comp["pred"].max()) > 255


# --------------------------------------------------------------------------
# numpy models of the 16-bit forms' packings
# --------------------------------------------------------------------------

def _words(a):
    """Two 16-bit samples to a 32-bit word, the lower column low."""
    a = np.asarray(a, np.uint64)
    return a[..., 0::2] | (a[..., 1::2] << np.uint64(16))


def _packed_sad(aw, bw):
    """What K5, K6 and K8's 16-bit forms compute (sad16.cuh): per word
    the 32-bit difference of the halves' maxima and minima (__vmaxu2 -
    __vminu2), added over the words modulo 2^32, then the two 16-bit
    halves of the sum added."""
    lo = lambda w: w & np.uint64(0xffff)                     # noqa: E731
    hi = lambda w: w >> np.uint64(16)                        # noqa: E731
    mx = np.maximum(lo(aw), lo(bw)) | (np.maximum(hi(aw), hi(bw))
                                       << np.uint64(16))
    mn = np.minimum(lo(aw), lo(bw)) | (np.minimum(hi(aw), hi(bw))
                                       << np.uint64(16))
    acc = ((mx - mn) % np.uint64(1 << 32)).sum(-1) % np.uint64(1 << 32)
    return ((acc & np.uint64(0xffff)) + (acc >> np.uint64(16))).astype(
        np.int64)


@pytest.mark.parametrize("kernel,n_words", [("K5", 32), ("K6", 32),
                                            ("K8", 16)])
def test_packed_pair_sads_equal_the_sads(kernel, n_words):
    """The words one packed accumulator takes (K5: an offset's 8x8
    decimated tile; K6: a 4-sample unit over 16 rows; K8: a thread's two
    16-sample rows) never carry from one half into the other: 1023
    against 0 everywhere gives n_words x 1023 < 2^16 per half, and random
    and extreme samples give the exact SAD."""
    rng = np.random.default_rng(n_words)
    a = rng.integers(0, 1024, (4096, 2 * n_words))
    b = rng.integers(0, 1024, (4096, 2 * n_words))
    a[:64], b[:64] = 1023, 0
    a[64:128] = np.where(rng.random((64, 2 * n_words)) < 0.5, 0, 1023)
    b[64:128] = 1023 - a[64:128]
    got = _packed_sad(_words(a), _words(b))
    np.testing.assert_array_equal(got, np.abs(a - b).sum(-1))
    assert n_words * 1023 < (1 << 16)
    assert int(got[:64].max()) == 2 * n_words * 1023


def _funnel(lo, hi, sh):
    return ((hi << np.uint64(32) | lo) >> np.uint64(sh)) & np.uint64(
        0xffffffff)


def _k5_model16(src, ref, r):
    """K5's 16-bit form in numpy: the decimated tile and region as 16-bit
    words, each offset's 8 rows of 4 words built by funnel shifts from the
    region's words, the packed SAD plus |dy| + |dx|, the first minimum in
    raster order."""
    def dec(p):
        h8, w8 = p.shape[0] // 8, p.shape[1] // 8
        return p[:h8 * 8, :w8 * 8].astype(np.int64).reshape(
            h8, 8, w8, 8).sum((1, 3)) >> 6

    s8, r8 = dec(src), dec(ref)
    hr8, w8 = r8.shape
    n_sby, n_sbx = s8.shape[0] // 8, s8.shape[1] // 8
    L, npos = 8 + 2 * r, 2 * r + 1
    out = np.zeros((n_sby, n_sbx, 2), np.int64)
    for sby in range(n_sby):
        for sbx in range(n_sbx):
            tile = _words(s8[sby * 8:sby * 8 + 8, sbx * 8:sbx * 8 + 8])
            ys = np.clip(sby * 8 - r + np.arange(L), 0, hr8 - 1)
            xs = np.clip(sbx * 8 - r + np.arange(L), 0, w8 - 1)
            reg = np.zeros((L, L + 4), np.int64)
            reg[:, :L] = r8[ys][:, xs]
            reg = _words(reg)
            best = None
            for ay in range(npos):
                for ax in range(npos):
                    q, sh = ax >> 1, (ax & 1) * 16
                    rows = reg[ay:ay + 8]
                    win = np.stack([_funnel(rows[:, q + k], rows[:, q + k + 1],
                                            sh) for k in range(4)], -1)
                    cost = int(_packed_sad(tile.reshape(1, -1),
                                           win.reshape(1, -1))[0]) \
                        + abs(ay - r) + abs(ax - r)
                    if best is None or cost < best[0]:
                        best = (cost, ay, ax)
            out[sby, sbx] = ((best[1] - r) * 8, (best[2] - r) * 8)
    return out


@pytest.mark.parametrize("r", [8, 12])
def test_k5_16bit_layout_equals_the_plain_search(r):
    """The 16-bit form's layout (numpy model) on 10-bit planes whose
    decimated samples pass 255 gives the plain version's MVs."""
    src, refs = _clip10()
    got = _k5_model16(src, refs[1], r)
    want = bme.coarse_sb_search(_t16(src), _t16(refs[1]), r)
    np.testing.assert_array_equal(got, want.numpy())


def _k6_tables16(src_sb, ref, origin):
    """K6's 16-bit SAD tables of one SB and window in numpy: the window's
    rows stored as 112 2-byte samples from the 8-sample floor of its first
    column, each (dx, unit) task's 4-sample unit over the rows of its band
    read by funnel shifts and summed in packed halves, then the 8x8 SAD of
    two units (fine table) and the 16x16 SAD of four over two bands
    (coarse table).  Returns ([8, 8, 33, 33], [4, 4, 33, 33])."""
    Hr, Wr = ref.shape
    oy, ox = origin
    oxa = ox - (ox & 7)
    rows = ref[np.clip(oy + np.arange(96), 0, Hr - 1)][
        :, np.clip(oxa + np.arange(116), 0, Wr - 1)].astype(np.int64)
    rows[:, 112:] = 0                       # past the stored row
    win = _words(rows)                      # [96, 58]
    srcw = _words(src_sb)                   # [64, 32]
    units = np.zeros((64, 16, 33, 33), np.int64)   # [row, unit, dy, dx]
    for dx in range(33):
        for u in range(16):
            x = (ox & 7) + u * 4 + dx
            q, sh = x >> 1, (x & 1) * 16
            lo = _funnel(win[:, q], win[:, q + 1], sh)
            hi = _funnel(win[:, q + 1], win[:, q + 2], sh)
            for dy in range(33):
                units[:, u, dy, dx] = _packed_sad(
                    np.stack([srcw[:, 2 * u], srcw[:, 2 * u + 1]], -1),
                    np.stack([lo[dy:dy + 64], hi[dy:dy + 64]], -1))
    fine = units.reshape(8, 8, 8, 2, 33, 33).sum((1, 3))
    coarse = units.reshape(4, 16, 4, 4, 33, 33).sum((1, 3))
    return fine, coarse


@pytest.mark.parametrize("kind", ["clip", "worst"])
def test_k6_16bit_tables_equal_the_sad_pyramid(kind):
    """The 16-bit form's tables (numpy model) against the plain SAD
    pyramid of a window at an origin off the 8-sample grid.  At the worst
    case (every sample 1023 against 0) each 8x8 entry is 65,472, which
    the fine table's uint16 holds, and each 16x16 entry 261,888, which
    needs the coarse table's 32-bit entries: uint16 would keep 261,888
    mod 65,536."""
    if kind == "clip":
        src, refs = _clip10()
        src_sb, ref = src[64:128, 64:128], refs[1]
    else:
        src_sb = np.full((64, 64), 1023, np.uint16)
        ref = np.zeros((128, 256), np.uint16)
    origin = (13, 37)
    fine, coarse = _k6_tables16(src_sb, ref, origin)
    windows = bme.sb_windows(_t16(ref), torch.tensor([origin]))
    sad8 = bme.sad8_surfaces(_t16(src_sb)[None], windows)[0].numpy()
    np.testing.assert_array_equal(fine, sad8)
    np.testing.assert_array_equal(
        coarse, sad8.reshape(4, 2, 4, 2, 33, 33).sum((1, 3)))
    if kind == "worst":
        assert int(fine.max()) == 64 * 1023 <= 0xffff
        assert int(coarse.max()) == 256 * 1023 > 0xffff
        assert (256 * 1023) & 0xffff != 256 * 1023


PHASES = (4, 8, 12)          # the q4 phases of dx8, dy8 in {-4, -2, 2, 4}


def _taps(q4):
    return bme._regular_taps(torch.device("cpu"))[q4].numpy().astype(
        np.int64)


def _im10(h):
    """The "both" intermediate at bd 10: (h + 2^16 + 4) >> 3."""
    return (h + (1 << 16) + 4) >> 3


def test_both_intermediates_of_10_bit_samples_fit_16_bits():
    """Every horizontal sum 10-bit samples reach under the three phases
    (each value from 1023 x the negative taps to 1023 x the positive
    ones) gives an intermediate in [4612, 28141], inside the int16 column
    tables and the signed 16-bit halves of the vertical dp2a; the x-only
    rounding (im - 8184) >> 4 equals convolve_2d_sr's for each of them;
    the vertical sums with their offset bits stay inside int32."""
    lo = min(int((1023 * (_taps(q) < 0) * _taps(q)).sum()) for q in PHASES)
    hi = max(int((1023 * (_taps(q) > 0) * _taps(q)).sum()) for q in PHASES)
    assert (lo, hi) == (-1023 * 28, 1023 * 156)
    h = np.arange(lo, hi + 1, dtype=np.int64)
    im = _im10(h)
    assert (int(im.min()), int(im.max())) == (4612, 28141)
    assert int(im.max()) < (1 << 15)
    np.testing.assert_array_equal((((h + 4) >> 3) + 8) >> 4,
                                  (im - ((1 << 13) - 8)) >> 4)
    for q in PHASES:
        t = _taps(q)
        top = (1 << 21) + 1024 + int((t * np.where(t > 0, 28141, 4612)).sum())
        bottom = (1 << 21) + 1024 + int((t * np.where(t > 0, 4612,
                                                      28141)).sum())
        assert 0 <= bottom and top < (1 << 31)


def _shared_form10(src, ref, mv_r, mv_c):
    """K7's shared form at bd 10 in numpy, unit by unit as the 16-bit
    form computes it (tests/test_torch_subpel_compound.py's model with
    bd's offsets, roundings and clamp)."""
    Hr, Wr = ref.shape
    nr, nc = src.shape[0] // 16, Wr // 16
    taps = {q: _taps(q) for q in PHASES}
    out_r = np.zeros((nr, nc), np.int64)
    out_c = np.zeros((nr, nc), np.int64)
    pred = np.zeros(src.shape, np.int16)
    ar = np.arange(24)
    for uy in range(nr):
        for ux in range(nc):
            mr, mc = int(mv_r[uy, ux]), int(mv_c[uy, ux])
            oy = min(max(uy * 16 + mr - 4 + 24, 0), Hr + 48 - 25) - 24
            ox = min(max(ux * 16 + mc - 4 + 24, 0), Wr + 48 - 25) - 24
            p = ref[np.clip(oy + ar, 0, Hr - 1)][
                :, np.clip(ox + ar, 0, Wr - 1)].astype(np.int64)

            def hcols(q, j0, n):
                win = np.stack([p[:, j0 - 3 + t:j0 - 3 + t + n]
                                for t in range(8)], -1)
                v = _im10(win @ taps[q])
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
                            v = (v - 8184) >> 4
                    else:
                        acc = sum(taps[q][t] * tab[off + t:off + t + 16]
                                  for t in range(8))
                        v = (acc + 64) >> 7 if kind == "copy" else \
                            ((acc + (1 << 21) + 1024) >> 11) - 1536
                    v = np.clip(v, 0, 1023)
                    cost = np.abs(s - v).sum() + 2 * (2 * abs(iy - 2)
                                                      + 2 * abs(ix - 2))
                    if best is None or cost < best[0]:
                        best = (cost, iy, ix, v)
            _, iy, ix, v = best
            out_r[uy, ux] = mr * 8 + (iy - 2) * 2
            out_c[uy, ux] = mc * 8 + (ix - 2) * 2
            pred[uy * 16:uy * 16 + 16, ux * 16:ux * 16 + 16] = v
    return out_r, out_c, pred


def test_k7_shared_form_at_10_bits_equals_the_plain_version():
    """The 16-bit form's shared filtering (numpy model) against
    subpel_plain at bd 10, on a 10-bit pair with a saturated corner (0
    and 1023 side by side: the extreme intermediates), for small MVs and
    MVs past every edge."""
    src, refs = _clip10()
    src, ref = src[:48, :96].copy(), refs[0][:64, :96].copy()
    yy, xx = np.mgrid[0:16, 0:24]
    ref[:16, :24] = np.where((xx + yy) % 2, 1023, 0)
    rng = np.random.default_rng(10)
    for mv in (rng.integers(-3, 4, (2, 3, 6)),
               rng.integers(-40, 41, (2, 3, 6))):
        mv = mv.astype(np.int32)
        got = _shared_form10(src, ref, mv[0], mv[1])
        want = bme.subpel_plain(_t16(src), _t16(ref),
                                torch.from_numpy(mv[0]),
                                torch.from_numpy(mv[1]), BD)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())


# --------------------------------------------------------------------------
# C4's first site: the decider's reference planes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bd", [8, 10])
def test_ref_plane_keeps_the_samples_of_the_recon(bd):
    """TorchDecider._ref_plane uploads a reference's recon in the sample
    type of the bit depth: at 10 bits every sample above 255 survives (it
    was narrowed to uint8, modulo 256, before C4's first site was
    fixed)."""
    rng = np.random.default_rng(bd)
    buf_h, buf_w = 128, 192
    luma = rng.integers(0, 1 << bd, (buf_h + 2 * REF_PAD,
                                     buf_w + 2 * REF_PAD)).astype(np.uint16)
    codec = types.SimpleNamespace(refs={1: [luma]}, buf_h=buf_h,
                                  buf_w=buf_w,
                                  seq=types.SimpleNamespace(bit_depth=bd))
    plane = TorchDecider("cpu")._ref_plane(codec, 1)
    want = luma[REF_PAD:REF_PAD + buf_h, REF_PAD:REF_PAD + buf_w]
    assert plane.dtype == (torch.int16 if bd == 10 else torch.uint8)
    np.testing.assert_array_equal(plane.numpy().astype(np.int64), want)
    if bd == 10:
        assert int(plane.max()) > 255
