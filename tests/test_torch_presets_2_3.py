"""Presets 3 and 2 end to end on the CPU: 2 frames at 64x64 (a key frame,
then a P frame) through svt_av1_tpu_torch (plain PyTorch versions of the
kernels) against the JAX package's device path.  Preset 3 adds the
extended partitions (AB and 4-way shapes) to preset 4's partition RD
walk, preset 2 the 8x8 RD nodes and the larger candidate lists.  The
streams must be byte-identical and both Decoders must turn each into the
port encoder's recon with equal md5s.

Presets -2 to 1 derive the same signals and decider arguments as preset
2 (the JAX package's preset ladder stops changing at 2).
"""
import pytest

from svt_av1_tpu import api as ref_api
from svt_av1_tpu_torch import api

from test_e2e import synthetic_clip
from test_torch_presets_7 import (LD, _configs, decode_both, encode_both,
                                  register_streams)

W, H = 64, 64
STREAMS = {f"p{preset}": (lambda: synthetic_clip(W, H, 2, seed=13), W, H,
                          dict(LD, enc_mode=preset)) for preset in (3, 2)}
register_streams("presets_2_3", STREAMS)


# the streams are ``slow``: the two host RD walks and the JAX compile take
# about 100 s alone
@pytest.fixture(scope="module", params=[
    pytest.param(3, marks=pytest.mark.slow),
    pytest.param(2, marks=pytest.mark.slow)])
def stream(request, tmp_path_factory):
    kind = f"p{request.param}"
    clip, w, h, kw = STREAMS[kind]
    got = encode_both(tmp_path_factory.mktemp("p23"), clip(), w, h, kw,
                      f"presets_2_3.{kind}")
    got["preset"] = request.param
    return got


def test_stream_byte_identical_to_jax_device_path(stream):
    assert stream["port"] == stream["jax"]


def test_stream_decodes_to_the_recon_with_both_decoders(stream,
                                                        monkeypatch):
    decode_both(stream["path"], stream["recon"], monkeypatch)


def _decider_args(dec):
    return {k: v for k, v in vars(dec).items()
            if not k.startswith("_") and k not in ("replay_store", "prof")}


@pytest.mark.parametrize("preset", [-2, -1, 0, 1, 2, 3])
def test_decider_arguments_follow_the_jax_ladder(preset):
    """The port's decider at each preset takes the JAX encoder's
    arguments; presets -2 to 1 take preset 2's signals and arguments."""
    port_cfg, ref_cfg = _configs(W, H, dict(LD, enc_mode=preset))
    enc = api.Encoder(port_cfg, device="cpu")
    ref = ref_api.Encoder(ref_cfg)
    got = _decider_args(enc._decider())
    assert got == _decider_args(ref._decider())
    assert got["ext_shapes"] and got["min_rd_bsize"] == (8 if preset <= 2
                                                         else 16)
    if preset < 2:
        two = api.Encoder(_configs(W, H, dict(LD, enc_mode=2))[0],
                          device="cpu")
        assert got == _decider_args(two._decider())
        assert enc.sig == two.sig
        assert enc.stream_header() == two.stream_header()
