"""The titles: made from the seed, the same for the same seed, at the
configuration's bit depth."""
from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest

import clip
from helpers import ROOT

CONTENT = json.loads((ROOT / "benchmark" / "traffic" / "titles4.json")
                     .read_text())["content"]


# sha256 of the 10 pictures' y, u and v bytes of a 192x128 8-bit title,
# as the harness made them before it took a bit depth
TITLE8_SHA256 = {
    2**31 + 5:
        "6b54f5a75ace7c9b50de6f4b065247ca02370c4548f101bff3f7f78328c2d9ab",
    4011: "55bb1008cd803e7920131b92fd56dff23a7dc848654ffe5d6fa812ede8346af3",
}


def title(seed, n=10, w=192, h=128, **kw):
    return clip.make_title(w, h, n, seed, CONTENT, "cpu", chunk=4, **kw)


def test_a_seed_repeats_its_title():
    a, b = title(2**31 + 5), title(2**31 + 5)
    assert all(np.array_equal(x, y) for pa, pb in zip(a, b)
               for x, y in zip(pa, pb))


def test_other_seeds_and_channels_give_other_titles():
    a, b = title(7), title(8)
    assert not np.array_equal(a[0][0], b[0][0])
    assert clip.title_seed(7, 0) != clip.title_seed(7, 1)
    assert 0 <= clip.title_seed(2**33 + 1, 3) < 2**63


def test_shapes_types_and_motion():
    t = title(11, n=10)
    assert len(t) == 10
    y, u, v = t[3]
    assert y.shape == (128, 192) and u.shape == v.shape == (64, 96)
    assert y.dtype == u.dtype == np.uint8
    # the content moves: consecutive pictures differ well beyond the noise
    d = np.abs(t[4][0].astype(int) - t[3][0].astype(int)).mean()
    assert d > 5



@pytest.mark.parametrize("seed", sorted(TITLE8_SHA256))
def test_8bit_titles_are_the_ones_made_before_bit_depths(seed):
    h = hashlib.sha256()
    for pic in title(seed):
        for p in pic:
            assert p.dtype == np.uint8
            h.update(p.tobytes())
    assert h.hexdigest() == TITLE8_SHA256[seed]


@pytest.mark.parametrize("seed", sorted(TITLE8_SHA256))
def test_10bit_titles_fill_the_low_bits_of_the_8bit_title(seed):
    t8, t10 = title(seed), title(seed, bit_depth=10)
    low = total = 0
    for p8, p10 in zip(t8, t10):
        for a, b in zip(p8, p10):
            assert b.dtype == np.uint16 and b.shape == a.shape
            assert int(b.max()) <= 1023
            assert np.array_equal(b >> 2, a)
            low += int(np.count_nonzero(b & 3))
            total += b.size
    assert low >= total / 5
