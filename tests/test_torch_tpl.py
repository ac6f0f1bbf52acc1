"""The port's TPL statistics and propagation (svt_av1_tpu_torch/pipeline/
tpl.py: K5/K6 at the single shape 16x16 and K10's plain version on CPU
tensors) against the JAX package's jitted device path (svt_av1_tpu/
pipeline/tpl.py with use_jax=True, on the CPU backend).

SADs and MVs are integers and must be equal.  The variance is a float32
sum of 256 rounded squares in both, in different orders (XLA's and the
port's fixed one), so it agrees to rtol 1e-6; r0 must agree to 1e-6 and
the qindex offsets exactly.  Sizes: 256x128 (statistics at full
resolution) and 512x256 (half resolution, ds=2)."""
import numpy as np
import pytest
import torch

from svt_av1_tpu.pipeline import tpl as ref_tpl
from svt_av1_tpu_torch.pipeline import tpl

from test_e2e import synthetic_clip

SIZES = [(256, 128), (512, 256)]


def _lumas(w, h):
    return [f[0] for f in synthetic_clip(w, h, 5, seed=13)]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pair_stats_match_the_jax_device_path(size):
    w, h = size
    ys = _lumas(w, h)
    for i, j in ((1, 0), (2, 3)):
        want = ref_tpl._pair_stats(ys[i], ys[j], w, h, 8, True)
        src, ref = (torch.from_numpy(ys[k]) for k in (i, j))
        got = tpl._pair_stats(src, ref)
        for g, r in zip(got, want[:3]):
            np.testing.assert_array_equal(g, r.astype(np.int32))
        var = tpl.block_var16(src).numpy()
        np.testing.assert_allclose(var, want[3], rtol=1e-6, atol=0)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_gop_flow_matches_the_jax_device_path(size):
    w, h = size
    ys = _lumas(w, h)
    displays = [16, 17, 18, 19, 20]
    for first in (False, True):
        want = ref_tpl.tpl_gop_flow(ys, displays, w, h, 8, use_jax=True,
                                    include_first=first)
        got = tpl.tpl_gop_flow(ys, displays, w, h, 8, "cpu",
                               include_first=first)
        assert sorted(got) == sorted(want) == displays[0 if first else 1:]
        for d in want:
            assert abs(got[d] - want[d]) <= 1e-6, (d, got[d], want[d])
    assert tpl.tpl_gop_offsets(ys, displays, w, h, 8, "cpu") == \
        ref_tpl.tpl_gop_offsets(ys, displays, w, h, 8, True)


def test_block_var16_plain_is_the_exact_variance_to_rtol_1e6():
    """Against the float64 sum of squared deviations (the numpy twin's)."""
    rng = np.random.default_rng(2)
    p = np.concatenate([rng.integers(0, 256, (32, 48)),
                        np.full((16, 48), 77),
                        rng.integers(120, 124, (16, 48))]).astype(np.uint8)
    b = p.astype(np.float64).reshape(4, 16, 3, 16).transpose(0, 2, 1, 3)
    want = ((b - b.mean(axis=(-1, -2), keepdims=True)) ** 2).sum((-1, -2))
    got = tpl.block_var16_plain(torch.from_numpy(p)).numpy()
    assert got.dtype == np.float32 and got.shape == (4, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[2] == 0).all()


def test_short_window_and_small_buffer_give_no_r0():
    ys = _lumas(256, 128)
    assert tpl.tpl_gop_flow(ys[:1], [0], 256, 128, 8, "cpu") == {}
    assert tpl.tpl_gop_flow([y[:96] for y in ys], list(range(5)), 256, 96,
                            8, "cpu") == {}
