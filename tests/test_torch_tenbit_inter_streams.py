"""10-bit low-delay P streams of the port (svt_av1_tpu_torch) on the CPU,
against the JAX package: 128x96x3 and 192x128x6 clips coded by the port,
byte-identical to the JAX device path's (SVT_TPU_DEVICE=1), and decoded
to the recon by both decoders.  The clip has real motion (chip_smoke.py's
synth_clip texture at 10 bits): with fault C6 put back, its streams differ
from the JAX path's, where those of test_e2e.py's ``tenbit_clip`` did not.

The slice's kernels' plain versions and packings are in
tests/test_torch_tenbit_inter.py.
"""
import functools

import numpy as np
import pytest

import jax_refs
from svt_av1_tpu import api as ref_api
from svt_av1_tpu.config import EncoderConfig as RefConfig
from svt_av1_tpu.config import PredStructure as RefPred
from svt_av1_tpu_torch import api
from svt_av1_tpu_torch.bitstream.bits import BitReader
from svt_av1_tpu_torch.bitstream.headers import (iter_obus,
                                                 parse_frame_header,
                                                 parse_sequence_header)
from svt_av1_tpu_torch.config import EncoderConfig, PredStructure
from svt_av1_tpu_torch.constants import ObuType
from svt_av1_tpu_torch.io import IvfReader

from tenbit_clips import moving_clip10

BD = 10


# --------------------------------------------------------------------------
# the slice end to end
# --------------------------------------------------------------------------

LOW_DELAY_P = dict(qp=40, enc_mode=8, intra_period_length=-1,
                   encoder_bit_depth=BD)
SIZES = {"128x96x3": (128, 96, 3), "192x128x6": (192, 128, 6)}


def _ref_cfg(w, h):
    return RefConfig(source_width=w, source_height=h,
                     pred_structure=RefPred.LOW_DELAY_P, **LOW_DELAY_P)


def _jax_case(size):
    w, h, n = SIZES[size]
    return jax_refs.encode_case(moving_clip10(w, h, n), _ref_cfg(w, h))


for _size in SIZES:
    jax_refs.register(f"tenbit_inter_streams.{_size}",
                      functools.partial(_jax_case, _size))


@pytest.fixture(scope="module", params=list(SIZES))
def streams(request, tmp_path_factory):
    """(port bytes, port recon, port IVF path, JAX device-path bytes,
    frames) of a 10-bit low-delay P clip."""
    w, h, n = SIZES[request.param]
    frames = moving_clip10(w, h, n)
    tmp = tmp_path_factory.mktemp(f"tenbit_ipp_{request.param}")
    cfg = EncoderConfig(source_width=w, source_height=h,
                        pred_structure=PredStructure.LOW_DELAY_P,
                        **LOW_DELAY_P)
    port = tmp / "port.ivf"
    recon = api.encode_ivf(frames, cfg, str(port), device="cpu")
    want = jax_refs.reference(f"tenbit_inter_streams.{request.param}",
                              frames=frames, cfg=_ref_cfg(w, h))
    return port.read_bytes(), recon, port, want, frames


# sets the fixture up: 147-164 s with the JAX side live (a stale store)
# in a 6-worker run
@pytest.mark.time_limit(330)
def test_ipp_stream_byte_identical_to_jax_device_path(streams):
    data, recon, _, want, frames = streams
    assert recon[0][0].dtype == np.uint16
    assert int(frames[1][0].max()) > 255
    assert len(data) == len(want)
    assert data == want


def test_ipp_decoders_reproduce_the_recon(streams):
    """The JAX decoder and the port's Decoder give the port encoder's
    recon; the sequence header says 10 bits; every frame after the first
    is an inter frame."""
    _, recon, path, _, _ = streams
    for frames in (ref_api.decode_ivf(str(path))[0],
                   api.decode_ivf(str(path), device="cpu")[0]):
        assert len(frames) == len(recon)
        for got, want in zip(frames, recon):
            for p in range(3):
                assert got[p].dtype == np.uint16
                np.testing.assert_array_equal(got[p], want[p])
    dec = api.Decoder(device="cpu")
    dec.decode_frame(next(iter(IvfReader(str(path))))[0])
    assert dec.get_stream_info()["bit_depth"] == BD
    seq, kinds = None, []
    for pkt, _ in IvfReader(str(path)):
        for obu_type, payload in iter_obus(pkt):
            if obu_type == ObuType.OBU_SEQUENCE_HEADER:
                seq = parse_sequence_header(payload)
            elif obu_type in (ObuType.OBU_FRAME, ObuType.OBU_FRAME_HEADER):
                kinds.append(int(parse_frame_header(BitReader(payload),
                                                    seq).frame_type))
    assert seq.bit_depth == BD
    assert kinds == [0] + [1] * (len(recon) - 1)
