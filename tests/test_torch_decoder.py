"""The port's Decoder (svt_av1_tpu_torch.api.Decoder) on the CPU: the host
tile walk, and the normative deblocking and CDEF through the plain
versions of K2-K4.

Every stream the port's encoder writes (64x64 all-intra, 192x128x6
low-delay P, 192x128x5 random access: the settings of
test_torch_encode.py and test_torch_random_access.py) decodes to the
encoder's recon, and to the planes and md5 of the JAX package's Decoder
on the same bytes.  Broken payloads raise ApiError with the JAX decoder's
code; a JAX stream with loop restoration decodes identically through the
port's host restoration; a stream with per-64x64 CDEF presets
(cdef_bits > 0) raises UNSUPPORTED_BITSTREAM.  The JAX encodes run its
host path (SVT_TPU_DEVICE=0), which takes seconds on the CPU.
"""
import functools

import numpy as np
import pytest

from svt_av1_tpu import api as ref_api
from svt_av1_tpu.config import EncoderConfig as RefConfig
from svt_av1_tpu.config import PredStructure as RefPred
from svt_av1_tpu_torch import api
from svt_av1_tpu_torch.config import EncoderConfig, PredStructure

from test_e2e import synthetic_clip

LD = PredStructure.LOW_DELAY_P
STREAMS = {
    "all-intra": (64, 64, 2, dict(intra_period_length=0, pred_structure=LD)),
    "low-delay-p": (192, 128, 6, dict(intra_period_length=-1,
                                      pred_structure=LD)),
    "random-access": (192, 128, 5, dict(intra_period_length=-1,
                                        hierarchical_levels=2)),
}


@functools.cache
def _port_stream(kind):
    w, h, n, kw = STREAMS[kind]
    enc = api.Encoder(EncoderConfig(source_width=w, source_height=h, qp=40,
                                    enc_mode=8, **kw), device="cpu")
    pkts = []
    for f in synthetic_clip(w, h, n, seed=13):
        pkts += enc.send_picture(f)
    pkts += enc.flush()
    return pkts, [enc.recon_by_display[d]
                  for d in sorted(enc.recon_by_display)]


def _decode(dec, pkts):
    got = [dec.decode_frame(p) for p in pkts]
    return [g for g in got if g is not None]


@pytest.mark.parametrize("kind", list(STREAMS))
def test_port_decoder_reproduces_the_recon_and_the_jax_decoder(kind):
    pkts, recon = _port_stream(kind)
    dec = api.Decoder(device="cpu")
    ref = ref_api.Decoder()
    got, want = _decode(dec, pkts), _decode(ref, pkts)
    assert len(got) == len(want) == len(recon) == STREAMS[kind][2]
    for d, (g, w, r) in enumerate(zip(got, want, recon)):
        for p in range(3):
            np.testing.assert_array_equal(g[p], r[p], f"display {d} plane {p}")
            np.testing.assert_array_equal(g[p], w[p], f"display {d} plane {p}")
    assert dec.md5.hexdigest() == ref.md5.hexdigest()
    assert dec.prof.calls["tile_walk"] == dec.frames_decoded
    assert dec.get_stream_info()["width"] == STREAMS[kind][0]


def _outcome(dec, payloads):
    try:
        for p in payloads:
            dec.decode_frame(p)
    except ref_api.ApiError as e:
        return ("ApiError", int(e.code))
    except api.ApiError as e:
        return ("ApiError", int(e.code))
    return "decoded"


@pytest.mark.parametrize("cut", [4, 8, 12, 24, None],
                         ids=["cut4", "cut8", "cut12", "cut24", "garbage"])
def test_broken_payloads_raise_the_jax_decoders_code(cut):
    pkts, _ = _port_stream("all-intra")
    if cut is None:
        rng = np.random.default_rng(0)
        payloads = [bytes(rng.integers(0, 256, 200, dtype=np.uint8))]
    else:
        payloads = [pkts[0][:cut]]
    want = _outcome(ref_api.Decoder(), payloads)
    assert want != "decoded"
    assert _outcome(api.Decoder(device="cpu"), payloads) == want
    assert int(api.ErrorCode.DECODE_ERROR) == want[1]


def _jax_stream(w, h, monkeypatch, **kw):
    monkeypatch.setenv("SVT_TPU_DEVICE", "0")
    enc = ref_api.Encoder(RefConfig(source_width=w, source_height=h, qp=40,
                                    intra_period_length=-1,
                                    pred_structure=RefPred.LOW_DELAY_P,
                                    **kw))
    pkts = []
    for f in synthetic_clip(w, h, 2, seed=13):
        pkts += enc.send_picture(f)
    return pkts + enc.flush()


def _frame_headers(pkts):
    from svt_av1_tpu_torch.bitstream.bits import BitReader
    from svt_av1_tpu_torch.bitstream.headers import (iter_obus,
                                                     parse_frame_header,
                                                     parse_sequence_header)
    from svt_av1_tpu_torch.constants import ObuType

    seq, out = None, []
    for pkt in pkts:
        for t, payload in iter_obus(pkt):
            if t == ObuType.OBU_SEQUENCE_HEADER:
                seq = parse_sequence_header(payload)
            elif t == ObuType.OBU_FRAME:
                out.append(parse_frame_header(BitReader(payload), seq))
    return out


def test_jax_stream_with_loop_restoration_decodes_identically(monkeypatch):
    pkts = _jax_stream(64, 64, monkeypatch, enc_mode=8,
                       enable_restoration=1)
    assert any(any(fh.lr_type) for fh in _frame_headers(pkts))
    dec, ref = api.Decoder(device="cpu"), ref_api.Decoder()
    got, want = _decode(dec, pkts), _decode(ref, pkts)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for p in range(3):
            np.testing.assert_array_equal(g[p], w[p])
    assert dec.md5.hexdigest() == ref.md5.hexdigest()


def test_per_64x64_cdef_presets_raise_unsupported(monkeypatch):
    pkts = _jax_stream(128, 128, monkeypatch, enc_mode=6)
    assert _frame_headers(pkts)[0].cdef_bits > 0
    with pytest.raises(api.ApiError) as info:
        _decode(api.Decoder(device="cpu"), pkts)
    assert info.value.code == api.ErrorCode.UNSUPPORTED_BITSTREAM
    assert "cdef_bits" in str(info.value)


def test_decode_ivf_returns_frames_and_md5(tmp_path):
    w, h, n, kw = STREAMS["all-intra"]
    path = tmp_path / "s.ivf"
    recon = api.encode_ivf(synthetic_clip(w, h, n, seed=13), EncoderConfig(
        source_width=w, source_height=h, qp=40, enc_mode=8, **kw),
        str(path), device="cpu")
    frames, md5 = api.decode_ivf(str(path), device="cpu")
    _, ref_md5 = ref_api.decode_ivf(str(path))
    assert md5 == ref_md5 and len(frames) == len(recon)
    for g, r in zip(frames, recon):
        for p in range(3):
            np.testing.assert_array_equal(g[p], r[p])
