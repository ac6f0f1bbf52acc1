"""Port of the batched intra decision (svt_av1_tpu_torch/ops/omd.py)
against the JAX package's numpy twin (ops/omd.py with xp=np).

Predictions are integer and must be bit-equal; the float32 cost model
sums in another order than numpy, so costs are held to rtol=1e-5 and the
chosen modes to the JAX suite's own gate (tests/test_omd.py: >= 97% of
blocks per shape).
"""
import numpy as np
import pytest
import torch

from svt_av1_tpu.ops import omd as ref
from svt_av1_tpu.ops import quant as ref_qz
from svt_av1_tpu_torch.ops import omd


def _textured(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return (120 + 80 * np.sin(xx / 11) + 40 * np.cos(yy / 7)
            + rng.integers(-12, 13, (h, w))).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", omd.ALL_SHAPES)
def test_predictors_bit_equal(shape):
    w, h = shape
    rng = np.random.default_rng(3)
    plane = rng.integers(0, 256, (96, 128)).astype(np.uint8)
    padded = ref.pad_plane(plane)
    above, left = ref.grid_edges(padded, w, h, 128, 96)
    tp = omd.pad_plane(torch.from_numpy(plane))
    np.testing.assert_array_equal(tp.numpy(), padded)
    ta, tl = omd.grid_edges(tp, w, h, 128, 96)
    np.testing.assert_array_equal(ta.numpy(), above)
    np.testing.assert_array_equal(tl.numpy(), left)
    np.testing.assert_array_equal(
        omd.grid_blocks(tp, w, h, 128, 96).numpy(),
        ref.grid_blocks(padded, w, h, 128, 96))
    for mode in ref.ALL_MODES:
        np.testing.assert_array_equal(
            omd.predict_mode(mode, ta, tl, w, h).numpy(),
            ref.predict_mode(mode, above, left, w, h, np),
            err_msg=f"{shape} {mode!r}")


@pytest.mark.parametrize("shape", omd.ALL_SHAPES)
def test_kernel_tap_tables_reproduce_directional_modes(shape):
    """K1 predicts the directional modes from packed two-tap tables;
    decoding the tables the kernel's way reproduces the reference's
    float32 matmul predictions exactly."""
    w, h = shape
    plane = _textured(96, 128, 4)
    padded = ref.pad_plane(plane)
    above, left = ref.grid_edges(padded, w, h, 128, 96)
    taps = omd._dir_taps(w, h)
    for mi, mode in enumerate(omd.DIR_MODES):
        t = taps[mi]
        from_left = (t & 1).astype(bool)
        i0, i1 = (t >> 1) & 127, (t >> 8) & 127
        w0, w1 = (t >> 15) & 63, (t >> 21) & 63
        e0 = np.where(from_left, left[..., i0], above[..., i0])
        e1 = np.where(from_left, left[..., i1], above[..., i1])
        pred = (w0 * e0 + w1 * e1 + 16) >> 5
        np.testing.assert_array_equal(
            pred.reshape(above.shape[:2] + (h, w)),
            ref.predict_mode(mode, above, left, w, h, np))


@pytest.mark.parametrize("qindex", [60, 160])
def test_quant_model_constants_equal(qindex):
    pq = ref_qz.build_quantizer(8)[0]
    for (w, h) in omd.ALL_SHAPES:
        for a, b in zip(omd._quant_maps(w, h, qindex, pq),
                        ref._quant_maps(w, h, qindex, pq, np)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("qindex", [60, 160])
def test_intra_decision_arrays_match_numpy_twin(qindex):
    plane = _textured(96, 128, 5)
    mb = tuple([2.0] * 13)
    want = ref.intra_decision_arrays(ref.pad_plane(plane), 128, 96, qindex,
                                     100.0, mb, 8, np)
    got = omd.intra_decision_arrays(omd.pad_plane(torch.from_numpy(plane)),
                                    128, 96, qindex, 100.0, mb, 8)
    for s in omd.ALL_SHAPES:
        mw, cw = want[s]
        mg, cg = (t.numpy() for t in got[s])
        assert mg.dtype == np.int32 and cg.dtype == np.float32
        assert (mg == mw).mean() >= 0.97, (s, (mg == mw).mean())
        close = np.isclose(cg, cw, rtol=1e-5).mean()
        assert close >= 0.99, (s, close)


def test_intra_decision_frame_cpu():
    """The frame entry on the CPU: buf-aligns the plane, runs the plain
    version per shape, returns host maps and launches nothing."""
    plane = _textured(90, 120, 6)
    before = omd.intra_decision.launches
    got = omd.intra_decision_frame(plane, 128, 96, 100, 300.0,
                                   tuple([1.5] * 13), device="cpu")
    assert omd.intra_decision.launches == before
    want = ref.intra_decision_frame(plane, 128, 96, 100, 300.0,
                                    tuple([1.5] * 13), use_jax=False)
    for s in omd.ALL_SHAPES:
        assert isinstance(got[s][0], np.ndarray)
        assert got[s][0].shape == want[s][0].shape
        assert (got[s][0] == want[s][0]).mean() >= 0.97


def test_wrapper_rejects_unsupported_input():
    with pytest.raises(ValueError):
        omd.intra_decision(torch.zeros((64, 64), dtype=torch.uint8,
                                       device="meta"), 8, 8, 100, 1.0,
                           (0.0,) * 13)
