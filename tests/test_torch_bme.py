"""The port's frame motion estimation (svt_av1_tpu_torch/ops/bme.py, the
plain versions of K5, K6 and K7) against the JAX package's numpy twin
(svt_av1_tpu/ops/bme.py with xp=np): MVs, SADs and predictions must be
exactly equal."""
import numpy as np
import pytest
import torch

from svt_av1_tpu.ops import bme as ref_bme
from svt_av1_tpu.ops import inter as ref_inter
from svt_av1_tpu.pipeline.batched_inter import _nested_to_grid
from svt_av1_tpu_torch.ops import bme, inter

H, W = 128, 256


def _pair(seed):
    """(src, ref) uint8 [H, W]: the source is the reference moved by
    (3.5, -5) pixels (the average of two shifts) plus noise, so the
    quarter-pel stage has fractional motion to find."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    ref = (120 + 60 * np.sin(xx / 9) + 40 * np.cos(yy / 7)
           + rng.integers(-10, 11, (H, W))).clip(0, 255).astype(np.uint8)
    a = np.roll(ref, (3, -5), axis=(0, 1)).astype(np.int32)
    b = np.roll(ref, (4, -5), axis=(0, 1)).astype(np.int32)
    src = ((a + b + 1) // 2 + rng.integers(-2, 3, (H, W))).clip(0, 255)
    return src.astype(np.uint8), ref


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("r", [8, 12])
def test_coarse_search_equals_the_numpy_twin(r):
    src, ref = _pair(r)
    want = ref_bme.coarse_sb_search(src.astype(np.int32),
                                    ref.astype(np.int32), np, coarse_r=r)
    got = bme.me_coarse(_t(src), _t(ref), r)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bme.me_coarse.launches == 0        # CPU tensors: plain version


@pytest.mark.parametrize("r", [8, 12])
def test_frame_me_equals_the_numpy_twin(r):
    src, ref = _pair(r + 1)
    want = ref_bme.frame_me(src.astype(np.int32), ref.astype(np.int32), np,
                            coarse_r=r)
    got = bme.frame_me(_t(src), _t(ref), r)
    assert got["grid"] == want["grid"]
    for s in bme.ME_SHAPES:
        for g, w in zip(got[s], want[s]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), str(s))
    np.testing.assert_array_equal(got["win16"].numpy(), want["win16"])
    maps, ref_maps = (m.to_block_maps(o, W, H) for m, o in
                      ((bme, got), (ref_bme, want)))
    for s in bme.ME_SHAPES:
        for g, w in zip(maps[s], ref_maps[s]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("wild", [False, True], ids=["me", "edges"])
def test_subpel_refine_equals_the_numpy_twin(wild):
    src, ref = _pair(5)
    if wild:
        # MVs reaching past every edge of the plane
        rng = np.random.default_rng(1)
        mv_r, mv_c = rng.integers(-40, 41, (2, H // 16, W // 16)) \
            .astype(np.int32)
    else:
        me = ref_bme.frame_me(src.astype(np.int32), ref.astype(np.int32), np)
        n_sby, n_sbx = me["grid"]
        mv_r = _nested_to_grid(me[(16, 16)][0], n_sby, n_sbx, 4, 4, np)
        mv_c = _nested_to_grid(me[(16, 16)][1], n_sby, n_sbx, 4, 4, np)
    want = ref_bme.subpel_refine16(src.astype(np.int32),
                                   ref.astype(np.int32), mv_r, mv_c, W, H,
                                   8, np)
    got = bme.subpel_refine16(_t(src), _t(ref), _t(mv_r), _t(mv_c))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    if not wild:
        assert (got[0].numpy() % 8 != 0).any()


@pytest.mark.parametrize("q4", [(0, 0), (8, 0), (0, 4), (12, 8), (4, 12)],
                         ids=lambda q: f"x{q[0]}y{q[1]}")
def test_torch_convolve_equals_the_numpy_convolve(q4):
    rng = np.random.default_rng(sum(q4))
    patch = rng.integers(0, 256, (6, 25, 25)).astype(np.int32)
    for sx, sy in ((3, 3), (4, 4), (3, 4)):
        want = ref_inter.convolve_2d_sr(patch, sx, sy, 16, 16, q4[0], q4[1])
        got = inter.convolve_2d_sr_torch(_t(patch), sx, sy, 16, 16, *q4)
        np.testing.assert_array_equal(got.numpy(), want)


def test_constants_and_reach_equal_the_reference():
    for name in ("SB", "COARSE_R", "REFINE_R", "MARGIN", "ME_SHAPES",
                 "SUBPEL_DELTAS"):
        assert getattr(bme, name) == getattr(ref_bme, name), name
    for d in range(-12, 13):
        assert bme.coarse_r_for_dist(d) == ref_bme.coarse_r_for_dist(d)


def test_refine_spec_describes_the_requested_shapes():
    """K6's shape spec: (h/8, w/8) per shape in request order, the output
    blocks per SB, and each shape of ME_SHAPES at most once."""
    spec, counts = bme.refine_spec(((16, 16), (64, 64)))
    assert (spec, counts) == ([2, 2, 8, 8], [16, 1])
    assert bme.refine_spec(((8, 16), (32, 32))) == ([2, 1, 4, 4], [32, 4])
    spec, counts = bme.refine_spec(bme.ME_SHAPES)
    assert len(spec) == 2 * len(bme.ME_SHAPES) and sum(counts) == 165
    for bad in ((), ((16, 16), (16, 16)), ((24, 24),)):
        with pytest.raises(ValueError):
            bme.refine_spec(bad)


@pytest.mark.parametrize("kind", ["flat", "periodic"])
def test_refinement_ties_take_the_first_minimum(kind):
    """On a flat plane every offset ties, on a period-8 one every eighth
    does: the plain refinement (K6's reference) still equals the numpy
    twin's first-minimum argmin, window merge included."""
    if kind == "flat":
        src = np.full((H, W), 97, np.uint8)
        ref = src.copy()
    else:
        yy, xx = np.mgrid[0:H, 0:W]
        ref = (100 + 30 * (xx % 8) + 7 * (yy % 8)).astype(np.uint8)
        src = np.roll(ref, (2, 3), axis=(0, 1))
    coarse = bme.coarse_sb_search(_t(src), _t(ref))
    got = bme.refine_plain(_t(src), _t(ref), coarse)
    want = ref_bme.frame_me(src.astype(np.int32), ref.astype(np.int32),
                            xp=np)
    for s in bme.ME_SHAPES:
        for g, w in zip(got[s], want[s]):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=str(s))
    np.testing.assert_array_equal(got["win16"].numpy(), want["win16"])
