"""The port's MCTF (svt_av1_tpu_torch/pipeline/mctf.py: the 32x32 frame
ME through K5/K6's plain versions on CPU tensors, the float64 host
weighting copied) against the JAX package's device path (svt_av1_tpu/
pipeline/mctf.py with SVT_TPU_DEVICE=1: _me32_jit on the CPU backend).

MVs are integers and the filtered planes come out of the same float64
arithmetic: both must be exactly equal.  Sizes: 192x128 (whole 64x64
superblocks) and 200x120 (the pad-and-crop path)."""
import numpy as np
import pytest
import torch

from svt_av1_tpu.pipeline import mctf as ref_mctf
from svt_av1_tpu_torch.pipeline import mctf

from test_e2e import synthetic_clip

SIZES = [(192, 128), (200, 120)]


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("SVT_TPU_DEVICE", "1")


def test_me32_matches_the_jitted_search():
    frames = synthetic_clip(192, 128, 3, seed=13)
    c, n = frames[1][0], frames[0][0]
    fn = ref_mctf._me32_jit(128, 192)
    want = [np.asarray(a) for a in fn(c, n)]
    got = mctf._me32(torch.from_numpy(c), torch.from_numpy(n))
    for g, w in zip(got, want):
        assert g.shape == (4, 6)
        np.testing.assert_array_equal(g, w)
    assert any(g.any() for g in got)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("neighbours", ["both", "past"])
def test_temporal_filter_matches_the_jax_device_path(size, neighbours):
    w, h = size
    frames = synthetic_clip(w, h, 3, seed=13)
    nb = [frames[0], frames[2]] if neighbours == "both" else [frames[0]]
    want = ref_mctf.temporal_filter(frames[1], nb, 40, 8)
    got = mctf.temporal_filter(frames[1], nb, 40, 8, "cpu")
    for p, (g, r) in enumerate(zip(got, want)):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r, err_msg=f"plane {p}")
    assert any(not np.array_equal(g, f) for g, f in zip(got, frames[1]))
