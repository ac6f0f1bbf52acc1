"""Port of the whole-plane deblocking (svt_av1_tpu_torch/ops/dlf.py)
against the JAX package's numpy twin (loop_filter_plane_full, xp=np)
and its sequential host filter: bit-equal planes."""
import copy

import numpy as np
import pytest
import torch

from svt_av1_tpu.ops import dlf as ref
from svt_av1_tpu_torch.ops import dlf

from test_filter_chain import _coded_frame


@pytest.fixture(scope="module")
def frame():
    return _coded_frame(128, 96, qidx=120, seed=3)


def _inputs(frame, plane, seed):
    """The coded frame's recon plane and tx geometry, with a random skip
    map so that the skip-dependent edge rules vary too."""
    rng = np.random.default_rng(seed)
    sub = 1 if plane else 0
    vw = (frame.fh.frame_width + sub) >> sub
    vh = (frame.fh.frame_height + sub) >> sub
    skip = rng.random(frame.skip_grid[plane].shape) < 0.4
    prm = ref.edge_params(frame.tx_w_grid[plane], frame.tx_h_grid[plane],
                          skip, frame.bedge_x[plane], frame.bedge_y[plane],
                          vw, vh, plane > 0)
    return frame.recon[plane].copy(), skip, prm, vw, vh


@pytest.mark.parametrize("plane", [0, 1])
@pytest.mark.parametrize("level", [1, 8, 32, 63])
@pytest.mark.parametrize("sharpness", [0, 3])
def test_loop_filter_plane_full_bit_equal(frame, plane, level, sharpness):
    rec, skip, prm, vw, vh = _inputs(frame, plane, 10 * level + sharpness)
    want = ref.loop_filter_plane_full(rec, *prm, vw, vh, level, level,
                                      sharpness, 8, np)
    got = dlf.loop_filter_plane_full(torch.from_numpy(rec), *prm, vw, vh,
                                     level, level, sharpness, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    # the sequential per-edge-line host filter agrees as well
    seq = rec.copy()
    ref.loop_filter_plane(seq, frame.tx_w_grid[plane],
                          frame.tx_h_grid[plane], skip,
                          frame.bedge_x[plane], frame.bedge_y[plane], vw,
                          vh, level, level, sharpness, plane > 0, 8)
    np.testing.assert_array_equal(got.numpy(), seq)


def test_deblock_wrapper_cpu_takes_plain_version(frame):
    rec, _, prm, vw, vh = _inputs(frame, 0, 1)
    before = dlf.deblock.launches
    got = dlf.deblock(torch.from_numpy(rec), *prm, vw, vh, 40, 40, 0, 8)
    assert dlf.deblock.launches == before
    np.testing.assert_array_equal(
        got.numpy(), ref.loop_filter_plane_full(rec, *prm, vw, vh, 40, 40,
                                                0, 8, np))


@pytest.mark.parametrize("base_level", [6, 30])
def test_level_search_matches_host_search(frame, base_level):
    """Searched level and filtered planes equal the reference FrameCodec's
    host level search (luma SSE over {L/2, L, 3L/2} and off)."""
    ref_codec = copy.deepcopy(frame)
    ref_codec.fh.filter_level = (base_level, base_level)
    ref_codec.fh.filter_level_uv = (base_level, base_level)
    ref_codec.apply_loop_filter()            # host path (SVT_TPU_DEVICE=0)
    fh = frame.fh
    grids = [(frame.tx_w_grid[p], frame.tx_h_grid[p], frame.skip_grid[p],
              frame.bedge_x[p], frame.bedge_y[p]) for p in range(3)]
    vis = [((fh.frame_width + (1 if p else 0)) >> (1 if p else 0),
            (fh.frame_height + (1 if p else 0)) >> (1 if p else 0))
           for p in range(3)]
    src_y = torch.from_numpy(frame.source[0].astype(np.uint8))
    out, level = dlf.dlf_search_apply_device(frame.recon[:3], src_y, grids,
                                             vis, base_level,
                                             fh.sharpness, 8)
    assert level == ref_codec.fh.filter_level[0]
    for p in range(3):
        np.testing.assert_array_equal(out[p], ref_codec.recon[p])
