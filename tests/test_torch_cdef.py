"""Port of the full-plane CDEF (svt_av1_tpu_torch/ops/cdef.py) against
the JAX package's numpy twins (find_dir_grid, cdef_search_errs,
_cdef_apply_traced with xp=np): bit-equal directions and planes, the
same strength argmin.  The port sums the search errors exactly in int64
where the twin sums float32, hence rtol=1e-6 on the values."""
import numpy as np
import pytest
import torch

from svt_av1_tpu.ops import cdef as ref
from svt_av1_tpu.ops.filter_chain import (PRI_SET, PRI_SET_FAST, SEC_SET,
                                          SEC_SET_FAST)
from svt_av1_tpu_torch.ops import cdef

from test_filter_chain import _coded_frame

SETS = {"full": (PRI_SET, SEC_SET), "fast": (PRI_SET_FAST, SEC_SET_FAST)}


@pytest.fixture(scope="module")
def frame():
    """A coded 128x96 frame with a random skip map, and a noisy source
    so that the strength errors are not trivially ordered."""
    codec = _coded_frame(128, 96, qidx=140, seed=5)
    rng = np.random.default_rng(7)
    skips = (rng.random(codec.skips.shape) < 0.35).astype(np.int32)
    src = [(p + rng.integers(-6, 7, p.shape)).clip(0, 255)
           for p in codec.source]
    return codec, skips, src


def _geom(codec, skips):
    fw, fh = codec.mi_cols * 4, codec.mi_rows * 4
    ns = ref.nonskip_grid(skips, codec.mi_rows, codec.mi_cols)
    return fw, fh, ns


def _ref_dirs(codec, fw, fh):
    padded = ref.pad_very_large(codec.recon[0], fw, fh, 8, np)
    return ref.find_dir_grid(ref._units_of(padded, fw, fh, 8, np), 0, np)


def test_nonskip_grid_equal(frame):
    codec, skips, _ = frame
    np.testing.assert_array_equal(
        cdef.nonskip_grid(skips, codec.mi_rows, codec.mi_cols),
        ref.nonskip_grid(skips, codec.mi_rows, codec.mi_cols))


def test_find_dir_grid_bit_equal(frame):
    codec, skips, _ = frame
    fw, fh, _ = _geom(codec, skips)
    dirs, var = _ref_dirs(codec, fw, fh)
    units = cdef._units_of(cdef.pad_very_large(
        torch.from_numpy(codec.recon[0]), fw, fh, 8), fw, fh, 8)
    d, v = cdef.find_dir_grid(units, 0)
    np.testing.assert_array_equal(d.numpy(), dirs)
    np.testing.assert_array_equal(v.numpy(), var)
    # the K3 wrapper on a CPU tensor takes the same plain version
    d2, v2 = cdef.cdef_direction(torch.from_numpy(codec.recon[0]), fw, fh)
    np.testing.assert_array_equal(d2.numpy(), dirs)
    np.testing.assert_array_equal(v2.numpy(), var)


def test_find_dir_random_units_bit_equal():
    rng = np.random.default_rng(11)
    units = rng.integers(0, 256, (6, 9, 8, 8)).astype(np.int32)
    dirs, var = ref.find_dir_grid(units, 0, np)
    d, v = cdef.find_dir_grid(torch.from_numpy(units), 0)
    np.testing.assert_array_equal(d.numpy(), dirs)
    np.testing.assert_array_equal(v.numpy(), var)


@pytest.mark.parametrize("sets", ["full", "fast"])
def test_search_errs_same_argmin(frame, sets):
    codec, skips, src = frame
    pri_set, sec_set = SETS[sets]
    fw, fh, ns = _geom(codec, skips)
    dirs, var = _ref_dirs(codec, fw, fh)
    want_y, want_uv = ref.cdef_search_errs(src, codec.recon, dirs, var, ns,
                                           fw, fh, 4, 8, pri_set, sec_set,
                                           np)
    got_y, got_uv = cdef.cdef_search(
        [torch.from_numpy(p.astype(np.uint8)) for p in src],
        [torch.from_numpy(p) for p in codec.recon],
        torch.from_numpy(dirs), torch.from_numpy(var), torch.from_numpy(ns),
        fw, fh, 4, 8, pri_set, sec_set)
    for got, want in ((got_y, want_y), (got_uv, want_uv)):
        assert got.dtype == torch.int64
        assert int(torch.argmin(got.reshape(-1))) == int(np.argmin(want))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert cdef.pick_strength(got_y, pri_set, sec_set) == \
        pri_set[int(np.argmin(want_y)) // len(sec_set)] * 4 \
        + sec_set[int(np.argmin(want_y)) % len(sec_set)]


@pytest.mark.parametrize("sets", ["full", "fast"])
def test_apply_bit_equal(frame, sets):
    codec, skips, _ = frame
    pri_set, sec_set = SETS[sets]
    fw, fh, ns = _geom(codec, skips)
    planes = [torch.from_numpy(p) for p in codec.recon]
    rng = np.random.default_rng(len(pri_set))
    strengths = [(p * 4 + s, q * 4 + t) for p, s, q, t in zip(
        rng.choice(pri_set, 4), rng.choice(sec_set, 4),
        rng.choice(pri_set, 4), rng.choice(sec_set, 4))]
    strengths += [(pri_set[-1] * 4 + sec_set[-1], 0),
                  (0, pri_set[1] * 4 + sec_set[1])]
    for ys, us in strengths:
        want = ref._cdef_apply_traced(codec.recon, ns, ys, us, 4, fw, fh, 8,
                                      np)
        got = cdef._cdef_apply_traced(planes, torch.from_numpy(ns), ys, us,
                                      4, fw, fh, 8)
        for p in range(3):
            h, w = want[p].shape
            np.testing.assert_array_equal(got[p].numpy()[:h, :w], want[p],
                                          err_msg=f"{ys} {us} p{p}")
            np.testing.assert_array_equal(got[p].numpy()[h:],
                                          codec.recon[p][h:])


def test_apply_matches_normative_host_cdef(frame):
    """The full-plane form equals the per-unit normative host CDEF
    (cdef_frame) the decoder side runs."""
    codec, skips, _ = frame
    fw, fh, ns = _geom(codec, skips)
    want = ref.cdef_frame(codec.recon, skips, codec.mi_rows, codec.mi_cols,
                          33, 22, 5, 8)
    got = cdef._cdef_apply_traced([torch.from_numpy(p) for p in codec.recon],
                                  torch.from_numpy(ns), 33, 22, 5, fw, fh, 8)
    for p in range(3):
        np.testing.assert_array_equal(got[p].numpy(), want[p])
