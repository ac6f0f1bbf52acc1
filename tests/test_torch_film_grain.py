"""Film grain on the CPU: low-delay P at preset 8 with
film_grain_denoise_strength 8, 3 frames at 192x128, through
svt_av1_tpu_torch (plain PyTorch versions of the kernels) against the
JAX package's device path.

The encoder fits a grain model to each frame on the host
(pipeline/noise_model.py: flat-block noise extraction, an AR fit, an
intensity-binned scaling curve, seed (7391 + 173 display) & 0xFFFF) and
signals it in the frame header; the Decoder applies the grain to its
output, not to the reference it keeps.  The streams must be
byte-identical; both Decoders' outputs, grain applied, must have equal
md5s; the port Decoder's pictures before the grain must equal the port
encoder's recon.
"""
import dataclasses

import numpy as np
import pytest

from svt_av1_tpu import api as ref_api
from svt_av1_tpu.pipeline import noise_model as ref_noise_model
from svt_av1_tpu_torch import api
from svt_av1_tpu_torch.pipeline import noise_model

from test_e2e import synthetic_clip
from test_torch_presets_7 import LD, encode_both, register_streams

W, H, N = 192, 128, 3
KW = dict(LD, film_grain_denoise_strength=8)
register_streams("film_grain", {
    "low-delay-p": (lambda: synthetic_clip(W, H, N, seed=13), W, H, KW)})


# the stream tests are ``slow``: the compile and encodes take about 100 s
# alone; the fit's test below stays in the quick tier
@pytest.fixture(scope="module", params=[
    pytest.param("low-delay-p", marks=pytest.mark.slow)])
def stream(request, tmp_path_factory):
    return encode_both(tmp_path_factory.mktemp("grain"),
                       synthetic_clip(W, H, N, seed=13), W, H, KW,
                       f"film_grain.{request.param}")


def test_stream_byte_identical_to_jax_device_path(stream):
    assert stream["port"] == stream["jax"]


def test_decoders_apply_the_grain_to_the_recon(stream, monkeypatch):
    before = []
    output = api.Decoder._output

    def recorded(self, planes, film_grain=None):
        before.append((planes, film_grain))
        return output(self, planes, film_grain)

    monkeypatch.setattr(api.Decoder, "_output", recorded)
    frames, md5 = api.decode_ivf(str(stream["path"]), device="cpu")
    ref_frames, ref_md5 = ref_api.decode_ivf(str(stream["path"]))
    assert md5 == ref_md5
    assert len(frames) == len(ref_frames) == len(before) == N
    for d, ((planes, grain), got, want) in enumerate(
            zip(before, frames, ref_frames)):
        assert grain is not None and grain.apply_grain, d
        assert grain.grain_seed == (7391 + 173 * d) & 0xFFFF
        for p in range(3):
            np.testing.assert_array_equal(planes[p], stream["recon"][d][p])
            np.testing.assert_array_equal(got[p], want[p])
        # the grain shows in the output, not in the reference
        assert not np.array_equal(got[0], stream["recon"][d][0])


def test_grain_fit_is_the_jax_package_fit():
    """fit_film_grain on the three planes of a noisy frame: the same
    parameters in both packages, at 8 and 10 bits."""
    rng = np.random.default_rng(5)
    y, u, v = synthetic_clip(W, H, 1, seed=21)[0]
    for bd, planes in ((8, (y, u, v)),
                       (10, tuple((p.astype(np.uint16) << 2)
                                  | rng.integers(0, 4, p.shape,
                                                 dtype=np.uint16)
                                  for p in (y, u, v)))):
        kw = dict(seed=1234, strength=8, bd=bd, u=planes[1], v=planes[2])
        got = noise_model.fit_film_grain(planes[0], **kw)
        want = ref_noise_model.fit_film_grain(planes[0], **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.apply_grain
