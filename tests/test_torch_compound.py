"""The port's averaged-compound candidate (svt_av1_tpu_torch/pipeline/
batched_inter.py: the plain versions of K9 and of K8's compound row on
CPU tensors) against the JAX package's numpy twin (svt_av1_tpu/pipeline/
batched_inter.py with xp=np, allow_compound=True).

The clip is the cross-fade of tests/test_batched_inter_device.py: the
source's left third follows the past reference, its right third the
future one and its middle the average of both, so single references and
the compound pair each win somewhere.  Integer selection fields must be
exactly equal, the MV-bits proxy within 1e-4, and the float cost
surfaces within the JAX suite's own gate (rtol 2e-4 / atol 2 on at
least 99% of the blocks of every shape: float32 DCT products summed in
another order)."""
import numpy as np
import pytest
import torch

from svt_av1_tpu.entropy.tables import FrameCdfs
from svt_av1_tpu.pipeline import batched_inter as ref_bi
from svt_av1_tpu.pipeline.batched_md import default_mode_bits
from svt_av1_tpu_torch.ops import omd
from svt_av1_tpu_torch.pipeline import batched_inter as bi

from test_batched_inter_device import _clip

QINDEX, LAM = 60, 900.0

# (buffer width, height, references, backward mask, signed distances)
CASES = {
    "K2": (128, 128, ("past", "fut"), (False, True), (-1, 1)),
    "K3": (192, 128, ("past", "fut", "fut2"), (False, True, True),
           (-2, 1, 3)),
    # the backward reference first, far distances: mirrored seeds of
    # negative MVs scaled by 3/2 and 2/3 (floor division of negatives)
    "far_backward_first": (192, 128, ("fut", "past"), (True, False),
                           (3, -2)),
}


def _refs(buf_w, buf_h, names):
    src, past, fut = _clip(buf_w, buf_h)
    # a second future picture, moved further (negative MVs onto it)
    fut2 = np.roll(fut, (5, -7), axis=(0, 1))
    planes = dict(past=past, fut=fut, fut2=fut2)
    return src, [planes[n] for n in names]


@pytest.fixture(scope="module", params=sorted(CASES))
def both(request):
    buf_w, buf_h, names, bwd, rel = CASES[request.param]
    src, refs = _refs(buf_w, buf_h, names)
    mode_bits = default_mode_bits(FrameCdfs(QINDEX))
    want = ref_bi.inter_frame_maps(
        src, np.stack(refs), buf_w, buf_h, QINDEX, LAM, mode_bits, 8, np,
        bwd_mask=bwd, allow_compound=True,
        rel_dists=np.asarray(rel, np.int32),
        coarse_r=tuple(ref_bi.bme.coarse_r_for_dist(d) for d in rel),
        pens=ref_bi.selection_pens(QINDEX, 8))
    got = bi.inter_maps_dispatch(src, refs, buf_w, buf_h, QINDEX, LAM,
                                 mode_bits, 8, "cpu", bwd, True, rel)
    return len(refs), got, want


def test_selection_fields_are_exact(both):
    k, (_, _, sf, mvb), (_, _, ref_sf, ref_mvb) = both
    for key in bi.SEL_KEYS:
        np.testing.assert_array_equal(sf[key], np.asarray(ref_sf[key]), key)
    np.testing.assert_allclose(mvb, np.asarray(ref_mvb), atol=1e-4)
    comp = sf["sel"] == k
    assert comp.any() and not comp.all()
    # compound units carry a backward arm; the pair's references lie on
    # the two sides
    assert (sf["mv1_r"][~comp] == 0).all()


def test_inter_costs_within_the_gate(both):
    _, (_, cost, _, _), (_, ref_cost, _, _) = both
    for s in omd.INTER_SHAPES:
        close = np.isclose(cost[s], np.asarray(ref_cost[s]), rtol=2e-4,
                           atol=2.0).mean()
        assert close >= 0.99, (s, close)


def test_mirror_floors_as_the_twin_divides():
    """The mirrored seed of every eighth-pel MV in +-600 over distance
    pairs up to 8, against the numpy twin's floor division."""
    mv = np.arange(-600, 601, 2, dtype=np.int32)
    for d_from in range(1, 9):
        for d_to in range(1, 9):
            q = mv >> 1
            want = np.clip(-((q * d_to * 2 + d_from) // (2 * d_from)) * 2,
                           -512, 512)
            got = bi._mirror(torch.from_numpy(mv),
                             torch.full((1,), d_from, dtype=torch.int32),
                             torch.full((1,), d_to, dtype=torch.int32))
            np.testing.assert_array_equal(got.numpy(), want)


def test_compound_joint_needs_references_on_both_sides():
    src, refs = _refs(128, 128, ("past", "fut"))
    t = torch.from_numpy(src)
    z = torch.zeros((2, 8, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        bi.compound_joint(t, torch.from_numpy(np.stack(refs)),
                          torch.from_numpy(np.stack(refs)), z, z,
                          torch.zeros((2, 2, 2), dtype=torch.int32),
                          torch.zeros((2, 2, 2), dtype=torch.int32),
                          (False, False), (-1, -2), QINDEX)
