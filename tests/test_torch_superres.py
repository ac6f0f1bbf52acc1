"""Super-resolution on the CPU (all-intra, as in the JAX package): 2
frames at 176x144, preset 8, coded at the downscaled width and upscaled
in the loop, through svt_av1_tpu_torch (plain PyTorch versions of the
kernels) against the JAX package's device path.

Denominators 9 and 12 under LOW_DELAY_P with intra_period_length 0, and
(test_torch_superres_mctf.py, a file of its own so that --dist loadfile
gives its compile and encodes a worker) 16 under the default all-intra
configuration (MCTF) with loop restoration on, whose search compares in
the upscaled domain.  The key frames' intra plans are prefetched from the
full-width buffered pictures, as in the JAX encoder.  The streams must be byte-identical,
their headers must carry the denominator, and both Decoders must turn
each into the port encoder's (upscaled) recon with equal md5s.
"""
import pytest

from svt_av1_tpu_torch import api
from svt_av1_tpu_torch.bitstream.headers import parse_sequence_header
from svt_av1_tpu_torch.ops.superres import scaled_dim

from test_e2e import synthetic_clip
from test_torch_presets_7 import (_configs, decode_both, encode_both,
                                  register_streams)

W, H, N = 176, 144, 2
STREAMS = {
    "denom9": dict(superres_denom=9, intra_period_length=0,
                   low_delay=True),
    "denom12": dict(superres_denom=12, intra_period_length=0,
                    low_delay=True),
    "denom16-mctf-lr": dict(superres_denom=16, enable_restoration=1),
}
register_streams("superres", {
    kind: (lambda: synthetic_clip(W, H, N, seed=13), W, H,
           dict(kw, superres_mode=1)) for kind, kw in STREAMS.items()})
# ``slow``: each stream's compile and encodes take about 60 s alone
HERE = (pytest.param("denom9", marks=pytest.mark.slow),
        pytest.param("denom12", marks=pytest.mark.slow))


def make_stream(kind, tmp_path_factory):
    kw = dict(STREAMS[kind], superres_mode=1)
    got = encode_both(tmp_path_factory.mktemp("superres"),
                      synthetic_clip(W, H, N, seed=13), W, H, kw,
                      f"superres.{kind}")
    got["kind"], got["kw"] = kind, kw
    return got


@pytest.fixture(scope="module", params=HERE)
def stream(request, tmp_path_factory):
    return make_stream(request.param, tmp_path_factory)


def test_stream_byte_identical_to_jax_device_path(stream):
    assert stream["port"] == stream["jax"]


def test_stream_decodes_to_the_recon_with_both_decoders(stream,
                                                        monkeypatch):
    decode_both(stream["path"], stream["recon"], monkeypatch)
    assert all(r[0].shape == (H, W) for r in stream["recon"])


def test_frames_are_coded_at_the_downscaled_width(stream):
    """The sequence header enables superres; every frame header carries
    the denominator and the downscaled width (the Decoder's parse)."""
    from svt_av1_tpu_torch.bitstream.bits import BitReader
    from svt_av1_tpu_torch.bitstream.headers import (iter_obus,
                                                     parse_frame_header)
    from svt_av1_tpu_torch.constants import ObuType
    from svt_av1_tpu_torch.io import IvfReader

    denom = stream["kw"]["superres_denom"]
    seq, fhs = None, []
    for pkt, _ in IvfReader(str(stream["path"])):
        for obu_type, payload in iter_obus(pkt):
            if obu_type == ObuType.OBU_SEQUENCE_HEADER:
                seq = parse_sequence_header(payload)
            elif obu_type == ObuType.OBU_FRAME:
                fhs.append(parse_frame_header(BitReader(payload), seq,
                                              (0,) * 8, [None] * 8))
    assert seq.enable_superres and len(fhs) == N
    for fh in fhs:
        assert fh.superres_denom == denom
        assert fh.frame_width == scaled_dim(W, denom) < W
        assert fh.upscaled_width == W
    if "lr" in stream["kind"]:
        assert seq.enable_restoration


def test_superres_needs_all_intra_and_turns_intrabc_off():
    port, _ = _configs(W, H, dict(superres_mode=1, superres_denom=10,
                                  intra_period_length=0, low_delay=True,
                                  screen_content_mode=1))
    enc = api.Encoder(port, device="cpu")
    job = api.CodeJob("code", 0, is_key=True)
    fh = enc._make_frame_header(job, (0,) * 7, 100, 10)
    assert enc.sig.intrabc_level and not fh.allow_intrabc
    from svt_av1_tpu_torch.config import ConfigError

    with pytest.raises(ConfigError):
        _configs(W, H, dict(superres_mode=1, superres_denom=10,
                            intra_period_length=-1))
