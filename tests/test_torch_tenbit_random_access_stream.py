"""A 10-bit random-access stream of the port (svt_av1_tpu_torch) on the
CPU, against the JAX package: a 192x128x5 clip (hierarchical_levels 2: a
key frame, a mini-GOP with a temporally filtered base picture, compound
prediction and show_existing frames, a TPL lookahead) byte-identical to
the JAX device path's stream (SVT_TPU_DEVICE=1) and decoded to the port's
recon by both decoders.  Its clip (``moving_clip10``, seed 7) is one on
which the stream changes with either of fault C4's narrowings put back
(seed 3's did not change with the TPL narrowing).

TPL, K9's and K10's plain versions and the compound frame program at 10
bits are in tests/test_torch_tenbit_random_access.py.
"""
import numpy as np
import pytest

import jax_refs
from svt_av1_tpu import api as ref_api
from svt_av1_tpu.config import EncoderConfig as RefConfig
from svt_av1_tpu_torch import api
from svt_av1_tpu_torch.bitstream.headers import (iter_obus,
                                                 parse_sequence_header)
from svt_av1_tpu_torch.config import EncoderConfig
from svt_av1_tpu_torch.constants import ObuType
from svt_av1_tpu_torch.io import IvfReader
from svt_av1_tpu_torch.pipeline import batched_md, mctf, tpl

from tenbit_clips import moving_clip10

BD = 10


# --------------------------------------------------------------------------
# the slice end to end
# --------------------------------------------------------------------------

RA10 = dict(qp=40, enc_mode=8, intra_period_length=-1, hierarchical_levels=2,
            encoder_bit_depth=BD)
W, H, N = 192, 128, 5


def _frames():
    return moving_clip10(W, H, N, seed=7)


JAX_RA10 = jax_refs.register("tenbit_random_access.192x128x5", lambda: (
    jax_refs.encode_case(_frames(), RefConfig(source_width=W,
                                              source_height=H, **RA10))))


@pytest.fixture(scope="module")
def jax_ra10_stream():
    return jax_refs.reference(JAX_RA10)


@pytest.fixture(scope="module")
def port_ra10(tmp_path_factory):
    """The port's stream and recon, with what the encode did recorded:
    the jobs it ran, the pictures MCTF filtered, the TPL windows (their
    sample type and largest sample) and the compound share of each inter
    frame's plan."""
    seen = {"jobs": [], "tf": [], "tpl": [], "comp": {}}
    with pytest.MonkeyPatch.context() as mp:
        run_job = api.Encoder._run_job
        tf = mctf.temporal_filter
        flow = tpl.tpl_gop_flow
        plan = batched_md.TorchDecider._plan_inter

        def logged_job(self, job, nxt=None):
            seen["jobs"].append((job.kind, job.display, job.layer))
            return run_job(self, job, nxt)

        def logged_tf(center, neighbours, *a):
            seen["tf"].append(len(neighbours))
            return tf(center, neighbours, *a)

        def logged_flow(frames_y, displays, *a, **k):
            seen["tpl"].append((len(frames_y),
                                max(int(np.asarray(f).max())
                                    for f in frames_y), a[2]))
            return flow(frames_y, displays, *a, **k)

        def logged_plan(self, codec):
            plan(self, codec)
            seen["comp"][codec.fh.order_hint] = float(
                (self._sf["sel"] >= len(self._names)).mean())

        mp.setattr(api.Encoder, "_run_job", logged_job)
        mp.setattr(mctf, "temporal_filter", logged_tf)
        mp.setattr(tpl, "tpl_gop_flow", logged_flow)
        mp.setattr(batched_md.TorchDecider, "_plan_inter", logged_plan)
        path = tmp_path_factory.mktemp("port10") / "ra10.ivf"
        recon = api.encode_ivf(_frames(), EncoderConfig(
            source_width=W, source_height=H, **RA10), str(path),
            device="cpu")
    return path.read_bytes(), recon, path, seen


# 174-235 s with the JAX side live (a stale store) in 6-worker runs
@pytest.mark.time_limit(470)
def test_ra10_stream_byte_identical_to_jax_device_path(jax_ra10_stream,
                                                       port_ra10):
    data, recon, _, _ = port_ra10
    assert recon[0][0].dtype == np.uint16
    assert len(data) == len(jax_ra10_stream)
    assert data == jax_ra10_stream


def test_ra10_path_covers_the_slice(port_ra10):
    """Key frame, base picture, middle layer, leaves and show_existing;
    MCTF on the base picture; a TPL window of 10-bit samples above 255;
    compound on the frames with a backward reference; the sequence header
    declares 10 bits."""
    _, _, path, seen = port_ra10
    assert seen["jobs"] == [
        ("code", 0, 0), ("code", 4, 0), ("code", 2, 1), ("code", 1, 2),
        ("show_existing", 2, 0), ("code", 3, 2), ("show_existing", 4, 0)]
    assert seen["tf"] == [1]
    assert seen["tpl"] and all(n >= 2 and top > 255 and bd == BD
                               for n, top, bd in seen["tpl"])
    assert seen["comp"][4] == 0.0
    assert all(seen["comp"][d] > 0 for d in (1, 2, 3))
    seq = None
    for pkt, _ in IvfReader(str(path)):
        for obu_type, payload in iter_obus(pkt):
            if obu_type == ObuType.OBU_SEQUENCE_HEADER:
                seq = parse_sequence_header(payload)
    assert seq.bit_depth == BD


def test_ra10_decoders_reproduce_the_recon(port_ra10):
    _, recon, path, _ = port_ra10
    for frames in (ref_api.decode_ivf(str(path))[0],
                   api.decode_ivf(str(path), device="cpu")[0]):
        assert len(frames) == len(recon) == N
        for got, want in zip(frames, recon):
            for p in range(3):
                assert got[p].dtype == np.uint16
                np.testing.assert_array_equal(got[p], want[p])
