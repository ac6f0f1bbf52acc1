"""Presets 6 and 5 end to end on the CPU through svt_av1_tpu_torch (plain
PyTorch versions of the kernels) against the JAX package's device path
(its jitted programs on the CPU backend):

* preset 6 at 192x128: all-intra (2 frames of the two-textured clip of
  tests/test_cdef_multi.py), low-delay P (3 frames of a moving clip, so
  that the global-motion fit signals ROTZOOM) and random access (5
  frames, tf_level 1: MCTF over the full window, TPL);
* preset 6 at 10 bits, low-delay P, 3 frames (no global motion at 10
  bits): test_torch_presets_6_10bit.py;
* preset 5 at 8 bits, low-delay P, 3 frames of the two-textured clip at
  352x288, where warped and OBMC motion appear: test_torch_presets_5.py.

Those two files run this file's stream tests on their streams, so that
--dist loadfile gives each stream's compile and encodes a worker.

These presets take the host RD walk (RdoDecider), the per-64x64 CDEF
presets (K3, K4's per-fb search and apply), the loop-restoration search
and the second entropy pass that replays the first one's decisions.  The
streams must be byte-identical; the port's Decoder and the JAX Decoder
must turn each into the port encoder's recon with equal md5s; the
preset-6 and preset-5 streams must carry cdef_bits > 0 and loop
restoration.
"""
import pytest

from svt_av1_tpu_torch import api
from svt_av1_tpu_torch.pipeline.rdo import RdoDecider

from chip_smoke import stream_features
from test_cdef_multi import _hetero_clip
from test_e2e import synthetic_clip
from test_torch_presets_7 import (LD, RA, _configs, decode_both,
                                  encode_both, register_streams, tenbit)

STREAMS = {
    "p6-all-intra": (192, 128, lambda: _hetero_clip(192, 128, 2),
                     dict(intra_period_length=0, low_delay=True,
                          enc_mode=6)),
    "p6-low-delay-p": (192, 128, lambda: synthetic_clip(192, 128, 3,
                                                        seed=13),
                       dict(LD, enc_mode=6)),
    "p6-random-access": (192, 128, lambda: synthetic_clip(192, 128, 5,
                                                          seed=13),
                         dict(RA, enc_mode=6)),
    "p6-10bit-low-delay-p": (192, 128, lambda: tenbit(synthetic_clip(
        192, 128, 3, seed=13)), dict(LD, enc_mode=6, encoder_bit_depth=10)),
    "p5-low-delay-p-352x288": (352, 288, lambda: _hetero_clip(352, 288, 3),
                               dict(LD, enc_mode=5)),
}

register_streams("presets_5_6", {kind: (clip, w, h, kw)
                                 for kind, (w, h, clip, kw)
                                 in STREAMS.items()})

HERE = ("p6-all-intra", "p6-low-delay-p", "p6-random-access")


def make_stream(kind, tmp_path_factory):
    """The port's and the JAX device path's streams of STREAMS[kind], with
    the port stream's features."""
    w, h, clip, kw = STREAMS[kind]
    got = encode_both(tmp_path_factory.mktemp("p56"), clip(), w, h, kw,
                      f"presets_5_6.{kind}")
    got["kind"] = kind
    got["features"] = stream_features(got["path"])
    return got


@pytest.fixture(scope="module", params=HERE)
def stream(request, tmp_path_factory):
    return make_stream(request.param, tmp_path_factory)


def test_stream_byte_identical_to_jax_device_path(stream):
    assert len(stream["port"]) == len(stream["jax"])
    assert stream["port"] == stream["jax"]


def test_stream_decodes_to_the_recon_with_both_decoders(stream,
                                                        monkeypatch):
    modes = decode_both(stream["path"], stream["recon"], monkeypatch)
    if stream["kind"].startswith("p5"):
        # preset 5 switches motion modes: OBMC and warped blocks appear
        assert modes[1] > 0 and modes[2] > 0, modes
    else:
        assert set(modes) <= {0}


def test_stream_carries_cdef_presets_and_loop_restoration(stream):
    """cdef_bits > 0 in some frame and loop restoration in some frame;
    the 8-bit inter streams signal a ROTZOOM global motion against LAST
    in every inter frame, the 10-bit one none."""
    feats = stream["features"]
    assert any(f[1] > 0 for f in feats), feats
    assert any(any(f[2]) for f in feats), feats
    inter = [f for f in feats if f[0] == 1]
    if stream["kind"] == "p6-all-intra":
        assert not inter
    elif "10bit" in stream["kind"]:
        assert inter and not any(any(f[3]) for f in inter)
    else:
        assert inter and all(f[3][0] == 2 and not any(f[3][1:])
                             for f in inter), feats


@pytest.mark.parametrize("preset", [5, 6])
def test_rd_presets_take_the_rdo_decider_without_prefetch(preset):
    """Presets 5-6: the RD walk with the JAX package's arguments; neither
    prefetch exists, so the encoder keeps no picture in flight."""
    port_cfg, _ = _configs(192, 128, dict(intra_period_length=0,
                                          low_delay=True, enc_mode=preset))
    enc = api.Encoder(port_cfg, device="cpu")
    dec = enc._decider_cached()
    assert type(dec) is RdoDecider
    assert dec.n_full_rd == enc.sig.md_stage_nics[2]
    assert dec.try_cfl and dec.try_angle_delta == (preset <= 5)
    assert 12 in dec.modes and 9 in dec.uv_modes
    assert not hasattr(dec, "prefetch") and not enc._pipeline()
    enc._prefetch(0, synthetic_clip(192, 128, 1)[0][0])   # nothing to do
    assert enc.seq.enable_restoration and enc.sig.cdef_multi
