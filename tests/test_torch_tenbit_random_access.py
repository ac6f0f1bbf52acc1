"""10-bit 4:2:0 random access in the port (svt_av1_tpu_torch) on the CPU,
against the JAX package.

What the 10-bit random-access slice adds to the 10-bit low-delay P one
(tests/test_torch_tenbit_inter.py) runs here through its plain versions,
which the wrappers take for CPU tensors, and the packings of the kernels'
16-bit forms, which run only on the card, are modelled in numpy:

* TPL (fault C4's second site): ``tpl_gop_flow`` uploads its window in the
  sample type of the bit depth, where it narrowed the planes to uint8
  (every sample above 255 wrapped modulo 256).  r0 against the JAX
  device path (``tpl_gop_flow(..., use_jax=True)``) to rtol 1e-6, since
  K10's fixed summation order differs from XLA's; ``_pair_stats``' SADs
  and MVs exactly; at full resolution (192x128) and at half resolution
  (a 256-row buffer);
* K10's plain version (``block_var16_plain``) at 10 bits against the JAX
  variance to rtol 1e-6, its [n, H, W] form bit-equal to n single-plane
  calls, and the exactness its header comment argues (mean and
  deviations exact in float32, each square rounded once) on samples 0
  and 1023;
* K9's 16-bit form (fault C4's third site): the packed-half rounded-up
  average over every pair of 10-bit samples, the packed SAD's bounds
  (8,184 per half, 16,368 per row partial), a numpy model of its joint
  search layout against the plain joint search, and the 10-bit frame
  program with the compound candidate against ``inter_frame_maps(...,
  10, np, allow_compound=True)``;
* MCTF's uint8 narrowing at 10 bits, the JAX device path's behaviour,
  pinned: the port matches that path, which differs from the JAX numpy
  path.
The slice's stream is in tests/test_torch_tenbit_random_access_stream.py.
"""
import numpy as np
import pytest
import torch

from svt_av1_tpu.entropy.tables import FrameCdfs
from svt_av1_tpu.pipeline import batched_inter as ref_bi
from svt_av1_tpu.pipeline import mctf as ref_mctf
from svt_av1_tpu.pipeline import tpl as ref_tpl
from svt_av1_tpu.pipeline.batched_md import default_mode_bits
from svt_av1_tpu_torch.ops import omd
from svt_av1_tpu_torch.pipeline import batched_inter as bi
from svt_av1_tpu_torch.pipeline import mctf, tpl

from tenbit_clips import moving_clip10
from test_torch_tenbit_inter import (_clip10, _funnel, _packed_sad, _t16,
                                     _words)

BD = 10
QINDEX, LAM = 60, 900.0 * 16          # rd_lambda scales by 4^(bd - 8)


def _lumas10(w, h, n=5, seed=7):
    return [f[0] for f in moving_clip10(w, h, n, seed)]


# --------------------------------------------------------------------------
# TPL on 16-bit planes (C4's second site) and K10's plain version
# --------------------------------------------------------------------------

# (width, height): 192x128 keeps full resolution (ds 1); a 256-row buffer
# is large enough for the 2x decimated statistics (ds 2)
TPL_SIZES = {"ds1": (192, 128), "ds2": (256, 256)}


@pytest.mark.parametrize("size", list(TPL_SIZES))
def test_tpl_flow_at_10_bits_matches_the_jax_device_path(size):
    """r0 of a 10-bit window (samples above 255) against the JAX device
    path to rtol 1e-6.  With the planes narrowed to uint8, as the port
    uploaded them before C4's second site was closed, r0 moves by more
    than 1e-2 on this window."""
    w, h = TPL_SIZES[size]
    ys = _lumas10(w, h)
    assert max(int(y.max()) for y in ys) > 255
    displays = [8, 9, 10, 11, 12]
    for first in (False, True):
        want = ref_tpl.tpl_gop_flow(ys, displays, w, h, BD, use_jax=True,
                                    include_first=first)
        got = tpl.tpl_gop_flow(ys, displays, w, h, BD, "cpu",
                               include_first=first)
        assert sorted(got) == sorted(want) == displays[0 if first else 1:]
        for d in want:
            assert abs(got[d] - want[d]) <= 1e-6 * want[d], (d, got[d],
                                                              want[d])


def test_tpl_pair_stats_at_10_bits_match_the_jax_device_path():
    """The 16x16 SADs and MVs of 10-bit pairs (K5/K6's plain versions on
    int16 planes) equal the JAX device path's; the variance agrees to
    rtol 1e-6."""
    w, h = TPL_SIZES["ds1"]
    ys = _lumas10(w, h)
    for i, j in ((1, 0), (2, 3)):
        want = ref_tpl._pair_stats(ys[i], ys[j], w, h, BD, True)
        src, ref = _t16(ys[i]), _t16(ys[j])
        got = tpl._pair_stats(src, ref)
        for g, r in zip(got, want[:3]):
            np.testing.assert_array_equal(g, r.astype(np.int32))
        var = tpl.block_var16(src).numpy()
        np.testing.assert_allclose(var, want[3], rtol=1e-6, atol=0)
    assert max(int(y.max()) for y in ys) > 255


def test_block_var16_plain_window_equals_single_planes():
    """The [n, H, W] form is bit-equal to n calls on [H, W] planes, in
    both sample types."""
    ys = _lumas10(192, 128)
    for dt, planes in ((torch.int16, np.stack(ys)),
                       (torch.uint8, np.stack(ys) >> 2)):
        t = torch.from_numpy(planes.astype(np.int32)).to(dt)
        whole = tpl.block_var16_plain(t)
        assert whole.shape == (5, 8, 12) and whole.dtype == torch.float32
        for k in range(5):
            assert torch.equal(whole[k], tpl.block_var16_plain(t[k]))


def _var16_fixed_order(block):
    """K10's arithmetic of one 16x16 block in numpy float32: the exact
    mean, the deviations, their squares, lane j of 8 adding runs of 8
    rows column by column, then the lanes folded (4, 2, 1)."""
    b = block.astype(np.int64)
    s = int(b.sum())
    mean = np.float32(s) * np.float32(1 / 256)
    d = b.astype(np.float32) - mean
    sq = (d * d).T.reshape(32, 8)
    acc = sq[0].copy()
    for q in range(1, 32):
        acc = acc + sq[q]
    for half in (4, 2, 1):
        acc = acc[:half] + acc[half:2 * half]
    return s, mean, d, acc[0]


@pytest.mark.parametrize("kind", ["zeros_and_1023", "random_extremes",
                                  "one_hot", "flat_1023"])
def test_block_var16_is_exact_where_it_claims_at_10_bits(kind):
    """On blocks of samples 0 and 1023: the block sum stays below 2^18,
    the float32 mean s / 256 and every deviation equal their exact values
    (float64), each square rounds once (it equals the float64 square
    rounded to float32), and the plain version equals the fixed-order
    numpy model to the bit."""
    rng = np.random.default_rng(1023)
    blocks = {
        "zeros_and_1023": np.where((np.add.outer(np.arange(16),
                                                 np.arange(16)) % 2) == 0,
                                   0, 1023),
        "random_extremes": np.where(rng.random((16, 16)) < 0.37, 1023, 0),
        "one_hot": np.pad(np.full((1, 1), 1023), ((5, 10), (9, 6))),
        "flat_1023": np.full((16, 16), 1023)}
    block = blocks[kind]
    s, mean, d, want = _var16_fixed_order(block)
    assert s <= 1023 * 256 < (1 << 18)
    assert float(mean) == s / 256
    exact = block.astype(np.float64) - s / 256
    np.testing.assert_array_equal(d.astype(np.float64), exact)
    np.testing.assert_array_equal(d * d, (exact * exact).astype(np.float32))
    plane = np.tile(block, (2, 3)).astype(np.int16)
    got = tpl.block_var16_plain(torch.from_numpy(plane)).numpy()
    assert (got == want).all()
    ref = ((exact - exact.mean()) ** 2).sum()
    assert abs(float(want) - ref) <= 1e-6 * max(ref, 1.0)


# --------------------------------------------------------------------------
# K9's 16-bit form: its packed arithmetic and layout in numpy
# --------------------------------------------------------------------------

def _avg16x2(a, b):
    """K9's packed-half rounded-up average of two words (uint64 holding
    32-bit words) as sm_90a runs __vavgu2 (LOP3, LOP3, SHF, IADD3): (a | b)
    - (((a ^ b) & 0xfffefffe) >> 1), modulo 2^32."""
    return ((a | b) - (((a ^ b) & np.uint64(0xfffefffe)) >> np.uint64(1))) \
        % np.uint64(1 << 32)


def test_packed_half_average_is_the_rounded_up_average():
    """Over every pair (a, b) in [0, 1023]^2, in the low half beside every
    other pair in the high half (the pair shifted by 517), the packed form
    gives (a + b + 1) >> 1 in each half: no half borrows from the other.
    So does the form with the mask after the shift, (a | b) - (((a ^ b)
    >> 1) & 0x7fff7fff)."""
    a, b = (x.ravel().astype(np.uint64) for x in np.meshgrid(
        np.arange(1024), np.arange(1024), indexing="ij"))
    a2, b2 = np.roll(a, 517), np.roll(b, 517 * 1024 + 3)
    aw, bw = a | (a2 << np.uint64(16)), b | (b2 << np.uint64(16))
    got = _avg16x2(aw, bw)
    np.testing.assert_array_equal(got & np.uint64(0xffff), (a + b + 1) >> 1)
    np.testing.assert_array_equal(got >> np.uint64(16), (a2 + b2 + 1) >> 1)
    other = ((aw | bw) - (((aw ^ bw) >> np.uint64(1))
                          & np.uint64(0x7fff7fff))) % np.uint64(1 << 32)
    np.testing.assert_array_equal(other, got)


def _win_words16(ref, oy, wx):
    """The 22 window rows of one arm as K9's 16-bit form stores them, 11
    words a row: inside the plane's columns 12 aligned words from the
    2-sample floor of the first column, funnel-shifted by 16 bits when it
    is odd; past an edge each sample clamped.  ref: int [H, W]."""
    H, W = ref.shape
    rows = np.clip(oy - 80 + np.arange(22), 0, H - 1)
    wa = wx & ~1
    if wx >= 0 and wa + 24 <= W:
        g = _words(ref[rows][:, wa:wa + 24])                 # [22, 12]
        sh = 16 * (wx & 1)
        return np.stack([_funnel(g[:, k], g[:, k + 1], sh)
                         for k in range(11)], -1)
    cols = np.clip(wx + np.arange(22), 0, W - 1)
    return _words(ref[rows][:, cols])


def _word16(w, o):
    """The word at sample offset o of a row of words (a half-word byte
    permutation of two words where o is odd)."""
    if o & 1:
        return (w[..., o >> 1] >> np.uint64(16)) \
            | ((w[..., (o >> 1) + 1] & np.uint64(0xffff)) << np.uint64(16))
    return w[..., o >> 1]


def _k9_arm_model16(refs, src, fixed, arm_k, seed_r, seed_c):
    """K9's 16-bit joint search of one arm per unit in numpy: the window
    words, for each row and offset 8 words of (source, average of the held
    prediction and the window) as packed halves, the row partial (halves
    added, in 16 bits), the 16 rows summed, the first minimum in raster
    order.  Returns (sad, mv_r, mv_c) per unit and the largest half
    accumulator and row partial seen."""
    K, H, W = refs.shape
    nr16, nc16 = H // 16, W // 16
    sad = np.zeros((nr16, nc16), np.int64)
    mvr, mvc = np.zeros_like(sad), np.zeros_like(sad)
    top_half = top_part = 0
    lo = np.uint64(0xffff)
    for uy in range(nr16):
        for ux in range(nc16):
            y0, x0 = uy * 16, ux * 16
            oy = min(max(y0 + (int(seed_r[uy, ux]) >> 3) - 3 + 80, 0),
                     H + 160 - 22)
            ox = min(max(x0 + (int(seed_c[uy, ux]) >> 3) - 3 + 80, 0),
                     W + 160 - 22)
            win = _win_words16(refs[int(arm_k[uy, ux])], oy, ox - 80)
            s = _words(src[y0:y0 + 16, x0:x0 + 16])           # [16, 8]
            h = _words(fixed[y0:y0 + 16, x0:x0 + 16])
            sums = []
            for dy in range(7):
                for dx in range(7):
                    wr = win[dy:dy + 16]
                    acc = np.zeros(16, np.uint64)
                    for i in range(8):
                        av = _avg16x2(h[:, i], _word16(wr, dx + 2 * i))
                        mx = np.maximum(s[:, i] & lo, av & lo) | (np.maximum(
                            s[:, i] >> np.uint64(16), av >> np.uint64(16))
                            << np.uint64(16))
                        mn = np.minimum(s[:, i] & lo, av & lo) | (np.minimum(
                            s[:, i] >> np.uint64(16), av >> np.uint64(16))
                            << np.uint64(16))
                        acc = (acc + (mx - mn)) % np.uint64(1 << 32)
                    top_half = max(top_half, int((acc & lo).max()),
                                   int((acc >> np.uint64(16)).max()))
                    part = (acc & lo) + (acc >> np.uint64(16))
                    top_part = max(top_part, int(part.max()))
                    sums.append(int((part & lo).sum()))
            best = int(np.argmin(sums))
            sad[uy, ux] = sums[best]
            mvr[uy, ux] = (oy - 80 + best // 7 - y0) * 8
            mvc[uy, ux] = (ox - 80 + best % 7 - x0) * 8
    return sad, mvr, mvc, top_half, top_part


def _units(a):
    nr, nc = a.shape[0] // 16, a.shape[1] // 16
    return torch.from_numpy(a.astype(np.int32)).reshape(
        nr, 16, nc, 16).permute(0, 2, 1, 3)


@pytest.mark.parametrize("seeds", ["near", "edges"])
def test_k9_16bit_layout_equals_the_plain_joint_search(seeds):
    """The 16-bit form's joint search (numpy model) against the plain
    ``_joint_arm`` on 10-bit planes, with seeds near the units and seeds
    that put the window past every edge (the origin clips to the pad,
    reads clamp, the aligned-load branch is left for the clamped one)."""
    src, refs = _clip10()
    refs = np.stack(refs[:2]).astype(np.int64)
    H, W = src.shape
    fixed = ((refs[0] + np.roll(refs[1], (1, -2), (0, 1)) + 1) >> 1)
    rng = np.random.default_rng(len(seeds))
    shape = (H // 16, W // 16)
    lim = (24, 24) if seeds == "near" else (8 * H + 900, 8 * W + 900)
    seed_r = rng.integers(-lim[0], lim[0] + 1, shape) & ~1
    seed_c = rng.integers(-lim[1], lim[1] + 1, shape) & ~1
    arm_k = rng.integers(0, 2, shape)
    sad, mvr, mvc, top_half, top_part = _k9_arm_model16(
        refs, src.astype(np.int64), fixed, arm_k, seed_r, seed_c)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(  # noqa
        np.int32))
    _, cr, cc, csad = bi._joint_arm(t(refs), _units(src), _units(fixed),
                                    t(arm_k), t(seed_r), t(seed_c))
    np.testing.assert_array_equal(sad, csad.numpy())
    np.testing.assert_array_equal(mvr, cr.numpy())
    np.testing.assert_array_equal(mvc, cc.numpy())
    assert top_half <= 8 * 1023 and top_part <= 16 * 1023


def test_k9_16bit_sad_bounds_are_reached_and_held():
    """1023 against 0 everywhere: each packed half of a row's accumulator
    reaches 8 x 1023 = 8,184 (no carry into the other half) and the row
    partial 16 x 1023 = 16,368, which the 16-bit partial slots hold; the
    SAD over 16 rows, 261,888, needs the 32-bit sums."""
    H, W = 64, 64
    src = np.full((H, W), 1023, np.int64)
    refs = np.zeros((2, H, W), np.int64)
    fixed = np.zeros((H, W), np.int64)
    z = np.zeros((H // 16, W // 16), np.int64)
    sad, _, _, top_half, top_part = _k9_arm_model16(refs, src, fixed, z, z,
                                                    z)
    assert top_half == 8 * 1023 == 8184
    assert top_part == 16 * 1023 == 16368 < (1 << 16)
    assert (sad == 256 * 1023).all() and 256 * 1023 > 0xffff
    words = _words(np.full((1, 16), 1023))
    assert int(_packed_sad(words, np.zeros_like(words))[0]) == 16368


def _crossfade10(h=128, w=256, seed=6):
    """Two 10-bit textures (the references) and a source that is their
    cross-fade, each texture moved: the averaged compound wins there."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    pats = [(440 + 240 * np.sin(xx / (9 + 4 * i) + i)
             + 160 * np.cos(yy / (7 + 3 * i))
             + rng.integers(-48, 49, (h, w))).clip(0, 1023).astype(np.int64)
            for i in range(2)]
    moved = [np.roll(p, sh, axis=(0, 1))
             for p, sh in zip(pats, ((2, -3), (-6, 5)))]
    src = (moved[0] + moved[1] + 1) // 2 + rng.integers(-8, 9, (h, w))
    return (src.clip(0, 1023).astype(np.uint16),
            [p.astype(np.uint16) for p in pats])


@pytest.fixture(scope="module")
def compound_maps10():
    """The 10-bit frame program with the compound candidate (two
    references, the second backward) on a cross-fade: the port's plain
    versions and the JAX package's numpy twin."""
    src, refs = _crossfade10()
    mode_bits = default_mode_bits(FrameCdfs(QINDEX))
    want = ref_bi.inter_frame_maps(
        src, np.stack(refs[:2]), src.shape[1], src.shape[0], QINDEX, LAM,
        mode_bits, BD, np, bwd_mask=(False, True), allow_compound=True,
        pens=ref_bi.selection_pens(QINDEX, BD))
    got = bi.inter_maps_dispatch(src, refs[:2], src.shape[1], src.shape[0],
                                 QINDEX, LAM, mode_bits, BD, "cpu",
                                 (False, True), True)
    return got, want


def test_compound_selection_fields_are_exact_at_10_bits(compound_maps10):
    (_, _, sf, mvb), (_, _, ref_sf, ref_mvb) = compound_maps10
    for key in bi.SEL_KEYS:
        np.testing.assert_array_equal(sf[key], np.asarray(ref_sf[key]), key)
    np.testing.assert_allclose(mvb, np.asarray(ref_mvb), atol=1e-4)
    assert bool((sf["sel"] == 2).any())


def test_compound_costs_within_the_gate_at_10_bits(compound_maps10):
    """Inter costs to rtol 2e-4 / atol 2 on >= 99% of every shape's
    blocks, the gate of tests/test_torch_batched_inter.py."""
    (_, cost, _, _), (_, ref_cost, _, _) = compound_maps10
    for s in omd.INTER_SHAPES:
        close = np.isclose(cost[s], np.asarray(ref_cost[s]), rtol=2e-4,
                           atol=2.0).mean()
        assert close >= 0.99, (s, close)


# --------------------------------------------------------------------------
# MCTF at 10 bits: the JAX device path's uint8 narrowing, pinned
# --------------------------------------------------------------------------

def test_mctf_at_10_bits_follows_the_jax_device_path(monkeypatch):
    """The port's temporal filter at bd 10 equals the JAX device path's
    (svt_av1_tpu/pipeline/mctf.py with SVT_TPU_DEVICE=1: ``_me32`` hands
    its jitted 32x32 ME the planes as uint8, each sample modulo 256) on
    every plane.  The JAX numpy path (SVT_TPU_DEVICE=0) searches the full
    10-bit samples: on the same input its MVs differ, so the port keeps
    the narrowing for byte identity with the device path."""
    frames = moving_clip10(192, 128, 3, seed=7)
    center, nb = frames[1], [frames[0], frames[2]]
    cy = center[0].astype(np.int32)
    monkeypatch.setenv("SVT_TPU_DEVICE", "1")
    dev_mvs = [ref_mctf._me32(cy, n[0].astype(np.int32)) for n in nb]
    want = ref_mctf.temporal_filter(center, nb, 40, BD)
    got = mctf.temporal_filter(center, nb, 40, BD, "cpu")
    for p, (g, r) in enumerate(zip(got, want)):
        assert g.dtype == r.dtype == np.uint16
        np.testing.assert_array_equal(g, r, err_msg=f"plane {p}")
    assert any(not np.array_equal(g, f) for g, f in zip(got, center))
    c_t = mctf._upload(cy, "cpu")
    for n, want_mv in zip(nb, dev_mvs):
        got_mv = mctf._me32(c_t, mctf._upload(n[0].astype(np.int32), "cpu"))
        for g, w in zip(got_mv, want_mv):
            np.testing.assert_array_equal(g, np.asarray(w))
    monkeypatch.setenv("SVT_TPU_DEVICE", "0")
    host_mvs = [ref_mctf._me32(cy, n[0].astype(np.int32)) for n in nb]
    assert any(not np.array_equal(np.asarray(a), np.asarray(b))
               for d, h in zip(dev_mvs, host_mvs) for a, b in zip(d, h))
