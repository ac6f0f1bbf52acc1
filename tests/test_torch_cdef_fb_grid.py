"""K4's per-fb apply takes the filter blocks' preset indices by value in
its launch's parameters, packed on the host (``cdef.pack_fb_grid``): 3 bits
per block, row-major, 10 blocks to a uint32 word.  Here the packing is
unpacked as the kernel reads it (``grid_index`` in cdef_filter.cu) at 1080p
and at the by-value capacity, and indices past the preset lists are
refused on the host."""
import numpy as np
import pytest

from svt_av1_tpu_torch.ops import cdef


def _unpack(words, n):
    """Block k's index as the kernel reads it: word k // 10, bits
    [3 (k % 10), 3 (k % 10) + 3)."""
    k = np.arange(n)
    return (words[k // 10] >> (3 * (k % 10)).astype(np.uint32)) & 7


@pytest.mark.parametrize("shape", [(17, 30), (68, 128)],
                         ids=["1080p", "capacity"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_packed_grid_unpacks_to_the_grid(shape, dtype):
    idx = np.random.default_rng(shape[1]).integers(0, 8, shape).astype(dtype)
    words = cdef.pack_fb_grid(idx, 8)
    assert words.dtype == np.uint32 and words.size == -(-idx.size // 10)
    np.testing.assert_array_equal(_unpack(words, idx.size), idx.ravel())
    assert not (words >> 30).any()                  # the unused top bits
    if shape == (68, 128):
        # AV1's largest level-6.3 picture, 8192 x 4352, fills the capacity
        assert idx.size == cdef.FB_GRID_BLOCKS and words.nbytes == 3484


@pytest.mark.parametrize("bad", [-1, 4, 8])
def test_packed_grid_refuses_indices_past_the_lists(bad):
    idx = np.zeros((17, 30), np.int32)
    idx[16, 29] = bad
    with pytest.raises(ValueError):
        cdef.pack_fb_grid(idx, 4)
    idx[16, 29] = 3
    np.testing.assert_array_equal(_unpack(cdef.pack_fb_grid(idx, 4), 510),
                                  idx.ravel())
