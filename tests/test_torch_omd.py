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


def test_k1_taps_hold_every_shape_table_at_its_offset():
    """The one tap table K1 reads: each shape's _dir_taps, flat, at the
    offset the wrapper passes for that shape, with no gap or overlap."""
    table, offsets = omd._k1_taps()
    assert table.dtype == np.int32
    assert set(offsets) == set(omd.ALL_SHAPES)
    end = 0
    for (w, h) in omd.ALL_SHAPES:
        assert offsets[(w, h)] == end
        n = len(omd.DIR_MODES) * w * h
        np.testing.assert_array_equal(table[end:end + n],
                                      omd._dir_taps(w, h).reshape(-1))
        end += n
    assert end == table.size


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
    before = omd.intra_decision_packed.launches
    got = omd.intra_decision_frame(plane, 128, 96, 100, 300.0,
                                   tuple([1.5] * 13), device="cpu")
    assert omd.intra_decision_packed.launches == before
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


@pytest.mark.parametrize("size", omd.FRAG_SIZES)
def test_tf32_split_of_the_dct_matrices(size):
    """K1's 3xTF32 operands: big holds the DCT matrix rounded to TF32 (the
    low 13 mantissa bits clear, ties away from zero as cvt.rna.tf32.f32),
    small the exact rest, so big + small is the float32 matrix."""
    d = omd._dct_mat(size)
    big, small = omd.tf32_split(d)
    assert big.dtype == small.dtype == np.float32
    assert not (big.view(np.uint32) & np.uint32(0x1FFF)).any()
    np.testing.assert_array_equal(big + small, d)
    assert (np.abs(big - d) <= np.abs(d) * 2.0 ** -11).all()
    assert (np.abs(small) <= np.abs(d) * 2.0 ** -11).all()
    # ties go away from zero: 1 + 2^-11 lies halfway between two TF32s
    tie = np.float32(1 + 2.0 ** -11)
    assert omd.tf32_split(np.array([tie, -tie]))[0].tolist() == \
        [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


def test_k1_fragments_hold_the_split_transposed_dct():
    """Reading _k1_fragments back the way a lane of mma.sync m16n8k8
    reads its B fragment (b0 = B[8ks + t, 8nt + g], b1 = B[8ks + t + 4,
    8nt + g]) gives D^T's big and small halves for every size."""
    frags = omd._k1_fragments()
    assert frags.shape == (2 * sum(s * s for s in omd.FRAG_SIZES),)
    off = 0
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for s in omd.FRAG_SIZES:
        tiles = frags[off:off + 2 * s * s].reshape(s // 8, s // 8, 32, 4)
        off += 2 * s * s
        big, small = omd.tf32_split(omd._dct_mat(s).T)
        got_big = np.zeros((s, s), np.float32)
        got_small = np.zeros((s, s), np.float32)
        for ks in range(s // 8):
            for nt in range(s // 8):
                for k4, (ib, is_) in enumerate(((0, 2), (1, 3))):
                    rows, cols = 8 * ks + t + 4 * k4, 8 * nt + g
                    got_big[rows, cols] = tiles[ks, nt, :, ib]
                    got_small[rows, cols] = tiles[ks, nt, :, is_]
        np.testing.assert_array_equal(got_big, big)
        np.testing.assert_array_equal(got_small, small)
        np.testing.assert_array_equal(got_big + got_small,
                                      omd._dct_mat(s).T)


@pytest.mark.parametrize("stripe", [False, True])
def test_packed_decision_unpacks_to_the_plain_version(stripe):
    """K1's packed output form: the CPU path of intra_decision_packed
    (the plain version per shape, then pack_decisions) unpacks, as a
    tensor and as a host array, to exactly the plain version's maps."""
    plane = torch.from_numpy(_textured(64, 96, 7))
    mb = tuple(np.linspace(1.0, 6.0, 13).tolist())
    rows = {}
    if stripe:
        rows = dict(above_row=torch.from_numpy(_textured(1, 96, 8)[0]),
                    halo=torch.from_numpy(_textured(32, 96, 9)))
    shapes = omd.ALL_SHAPES[::-1]
    before = omd.intra_decision_packed.launches
    packed = omd.intra_decision_packed(plane, 120, 280.0, mb, 8,
                                       shapes=shapes, **rows)
    assert omd.intra_decision_packed.launches == before
    n = sum((64 // h) * (96 // w) for (w, h) in shapes)
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (2, n)
    for maps in (omd.unpack_decisions(packed, shapes, 96, 64),
                 omd.unpack_decisions(packed.numpy(), shapes, 96, 64)):
        for (w, h) in shapes:
            m, c = omd.intra_decision_plain(plane, w, h, 120, 280.0, mb, 8,
                                            **rows)
            gm, gc = maps[(w, h)]
            assert gm.dtype in (torch.int32, np.int32)
            assert gc.dtype in (torch.float32, np.float32)
            np.testing.assert_array_equal(np.asarray(gm), m.numpy())
            np.testing.assert_array_equal(np.asarray(gc), c.numpy())
    one = omd.intra_decision(plane, 16, 8, 120, 280.0, mb, 8, **rows)
    np.testing.assert_array_equal(one[1].numpy(),
                                  omd.unpack_decisions(packed, shapes, 96,
                                                       64)[(16, 8)][1])
    with pytest.raises(ValueError):
        omd.unpack_decisions(packed, shapes[1:], 96, 64)
