"""The titles: made from the seed, the same for the same seed."""
from __future__ import annotations

import json

import numpy as np

import clip
from helpers import ROOT

CONTENT = json.loads((ROOT / "benchmark" / "traffic" / "titles4.json")
                     .read_text())["content"]


def title(seed, n=10, w=192, h=128):
    return clip.make_title(w, h, n, seed, CONTENT, "cpu", chunk=4)


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

