"""The port's inter frame program (svt_av1_tpu_torch/pipeline/
batched_inter.py, the plain versions of K5-K8 and K1 on CPU tensors)
against the JAX package's numpy twin (svt_av1_tpu/pipeline/
batched_inter.py with xp=np).

Integer selection fields must be exactly equal and the MV-bits proxy
within 1e-4; the float cost surfaces come out of float32 DCT products
summed in another order than numpy's, so they get the JAX suite's own
gate (tests/test_batched_inter_device.py): within rtol 2e-4 / atol 2 on
at least 99% of the blocks of every shape."""
import numpy as np
import pytest
import torch

from svt_av1_tpu.entropy.tables import FrameCdfs
from svt_av1_tpu.pipeline import batched_inter as ref_bi
from svt_av1_tpu.pipeline.batched_md import default_mode_bits
from svt_av1_tpu_torch.ops import omd
from svt_av1_tpu_torch.pipeline import batched_inter as bi

H, W = 128, 256


def _clip(seed=5):
    """Source and three past pictures: the source is the first moved by
    (3, -5), the others carry the same pattern moved further, so every
    reference wins somewhere."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = (100 + 60 * np.sin(xx / 13) + 40 * np.cos(yy / 9)
            + rng.integers(-12, 13, (H, W))).clip(0, 255)
    refs = [np.roll(base, (i, -2 * i), axis=(0, 1)) for i in range(3)]
    src = np.roll(base, (3, -5), axis=(0, 1))
    # the right third of the source is the second reference's content
    third = 2 * W // 3
    src[:, third:] = np.roll(refs[1], (1, 1), axis=(0, 1))[:, third:]
    src = (src + rng.integers(-2, 3, (H, W))).clip(0, 255)
    return src.astype(np.uint8), [r.astype(np.uint8) for r in refs]


@pytest.fixture(scope="module", params=[1, 3], ids=["K1", "K3"])
def both(request):
    k = request.param
    src, refs = _clip()
    qindex, lam = 60, 900.0
    mode_bits = default_mode_bits(FrameCdfs(qindex))
    want = ref_bi.inter_frame_maps(
        src, np.stack(refs[:k]), W, H, qindex, lam, mode_bits, 8, np,
        bwd_mask=(False,) * k, pens=ref_bi.selection_pens(qindex, 8))
    got = bi.inter_maps_dispatch(src, refs[:k], W, H, qindex, lam,
                                 mode_bits, 8, "cpu")
    return k, got, want


def test_selection_fields_are_exact(both):
    k, (_, _, sf, mvb), (_, _, ref_sf, ref_mvb) = both
    for key in bi.SEL_KEYS:
        assert isinstance(sf[key], np.ndarray)
        np.testing.assert_array_equal(sf[key], np.asarray(ref_sf[key]), key)
    np.testing.assert_allclose(mvb, np.asarray(ref_mvb), atol=1e-4)
    if k == 3:
        assert len(np.unique(sf["sel"])) > 1


def test_inter_costs_within_the_gate(both):
    _, (_, cost, _, _), (_, ref_cost, _, _) = both
    for s in omd.INTER_SHAPES:
        assert cost[s].shape == ref_cost[s].shape
        close = np.isclose(cost[s], np.asarray(ref_cost[s]), rtol=2e-4,
                           atol=2.0).mean()
        assert close >= 0.99, (s, close)


def test_intra_maps_within_the_gate(both):
    _, (intra, _, _, _), (ref_intra, _, _, _) = both
    for s in omd.ALL_SHAPES:
        assert (intra[s][0] == np.asarray(ref_intra[s][0])).mean() >= 0.97
        close = np.isclose(intra[s][1], np.asarray(ref_intra[s][1]),
                           rtol=2e-4, atol=2.0).mean()
        assert close >= 0.99, (s, close)


def test_selection_penalties_equal_the_reference():
    for q in (20, 60, 160, 255):
        np.testing.assert_array_equal(bi.selection_pens(q, 8),
                                      ref_bi.selection_pens(q, 8))


def test_mv_bits_table_equals_numpy_log2():
    """The MV-bits table both K8 and its plain version read is the numpy
    twin's float32 log2(1 + d/8), element by element."""
    d = np.random.default_rng(0).integers(0, 4000, (37, 53)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        bi._log2_table_np(4096)[d.astype(np.int64)],
        np.log2(1.0 + d / 8.0))


def test_compound_with_a_backward_reference():
    """With the second picture as a backward reference the averaged
    compound candidate joins the selection; the fields equal the twin's."""
    src, refs = _clip()
    qindex, lam = 60, 900.0
    mode_bits = default_mode_bits(FrameCdfs(qindex))
    want = ref_bi.inter_frame_maps(
        src, np.stack(refs[:2]), W, H, qindex, lam, mode_bits, 8, np,
        bwd_mask=(False, True), allow_compound=True,
        pens=ref_bi.selection_pens(qindex, 8))
    _, _, sf, mvb = bi.inter_maps_dispatch(src, refs[:2], W, H, qindex, lam,
                                           mode_bits, 8, "cpu",
                                           (False, True), True)
    for key in bi.SEL_KEYS:
        np.testing.assert_array_equal(sf[key], np.asarray(want[2][key]), key)
    np.testing.assert_allclose(mvb, np.asarray(want[3]), atol=1e-4)


@pytest.mark.parametrize("kind", ["textured", "noise", "offset"])
def test_mc_cost_maps_match_numpy_twin(kind):
    """The plain residual cost model (with its float64 decision of the
    near-boundary coefficients) against the JAX numpy twin's
    ``_mc_cost_maps`` at 128x128, at the gate of the cost maps: a smooth
    textured residual, uniform noise of 255 (high energy in every band)
    and a flat offset of 200 per 64x64 (all the energy in the DC, the
    64-point shapes' out-of-band part near zero)."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:128, 0:128]
    if kind == "textured":
        r = 30 * np.sin(xx / 7) * np.cos(yy / 5) + rng.integers(-6, 7,
                                                                 (128, 128))
    elif kind == "noise":
        r = rng.integers(-255, 256, (128, 128))
    else:
        r = np.where(((yy // 64) + (xx // 64)) % 2, 200, -200) \
            + rng.integers(-2, 3, (128, 128))
    r = r.astype(np.int32)
    for qindex, lam in ((60, 900.0), (160, 2500.0)):
        got = bi._mc_cost_maps(torch.from_numpy(r), 128, 128, qindex, lam, 8)
        want = ref_bi._mc_cost_maps(np.pad(r, omd.PAD), 128, 128, qindex,
                                    lam, 8, np)
        for s in omd.INTER_SHAPES:
            close = np.isclose(got[s].numpy(), np.asarray(want[s]),
                               rtol=2e-4, atol=2.0).mean()
            assert close >= 0.99, (kind, qindex, s, close)
