"""The port's MCTF (svt_av1_tpu_torch/pipeline/mctf.py: the 32x32 frame
ME through K5/K6's plain versions on CPU tensors, the float64 host
weighting copied) against the JAX package's device path (svt_av1_tpu/
pipeline/mctf.py with SVT_TPU_DEVICE=1: _me32_jit on the CPU backend).

MVs are integers and the filtered planes come out of the same float64
arithmetic: both must be exactly equal.  Sizes: 192x128 (whole 64x64
superblocks) and 200x120 (the pad-and-crop path)."""
import functools

import numpy as np
import pytest
import torch

import jax_refs
from svt_av1_tpu.pipeline import mctf as ref_mctf
from svt_av1_tpu_torch.pipeline import mctf

from test_e2e import synthetic_clip

SIZES = [(192, 128), (200, 120)]


def _me32_case():
    """The jitted 32x32 frame ME of frame 0 onto frame 1 (192x128)."""
    frames = synthetic_clip(192, 128, 3, seed=13)
    c, n = frames[1][0], frames[0][0]

    def produce():
        return jax_refs.pack_list(ref_mctf._me32_jit(128, 192)(c, n))

    return dict(center=c, neighbour=n, device="1"), produce


def _filter_case(size, neighbours):
    """The JAX device path's temporal filter of frame 1."""
    frames = synthetic_clip(*size, 3, seed=13)
    nb = [frames[0], frames[2]] if neighbours == "both" else [frames[0]]
    return (dict(center=frames[1], neighbours=nb, qp=40, bd=8, device="1"),
            lambda: jax_refs.pack_list(jax_refs.on_device(
                "1", ref_mctf.temporal_filter, frames[1], nb, 40, 8)))


ME32 = jax_refs.register("mctf.me32-192x128", _me32_case)
for _size in SIZES:
    for _nb in ("both", "past"):
        jax_refs.register(f"mctf.filter-{_size[0]}x{_size[1]}-{_nb}",
                          functools.partial(_filter_case, _size, _nb))


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("SVT_TPU_DEVICE", "1")


def test_me32_matches_the_jitted_search():
    frames = synthetic_clip(192, 128, 3, seed=13)
    c, n = frames[1][0], frames[0][0]
    want = jax_refs.unpack_list(jax_refs.reference(ME32, center=c,
                                                   neighbour=n))
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
    want = jax_refs.unpack_list(jax_refs.reference(
        f"mctf.filter-{w}x{h}-{neighbours}", center=frames[1],
        neighbours=nb))
    got = mctf.temporal_filter(frames[1], nb, 40, 8, "cpu")
    for p, (g, r) in enumerate(zip(got, want)):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r, err_msg=f"plane {p}")
    assert any(not np.array_equal(g, f) for g, f in zip(got, frames[1]))
