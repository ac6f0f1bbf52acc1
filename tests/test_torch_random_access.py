"""The random-access slice end to end on the CPU: a 192x128 clip of 5
frames with hierarchical_levels 2 (a key frame, then one 4-frame
mini-GOP: its base picture temporally filtered, compound prediction on
the frames with a backward reference, leaves, show_existing frames, a
TPL lookahead feeding the qindex ladder) through svt_av1_tpu_torch with
the plain versions of the kernels, against the JAX package's device
path (its jitted programs on the CPU backend).

The streams must be byte-identical, the JAX decoder must reproduce the
port's recon, and the plan prefetch must not change a byte.  The JAX
side compiles its programs on the CPU, which takes over a minute: this
file stands alone so that --dist loadfile gives it a worker of its own.
"""
import numpy as np
import pytest

import jax_refs
from svt_av1_tpu import api as ref_api
from svt_av1_tpu.config import EncoderConfig as RefConfig
from svt_av1_tpu_torch import api
from svt_av1_tpu_torch.config import EncoderConfig
from svt_av1_tpu_torch.pipeline import batched_md, mctf

from test_e2e import synthetic_clip

RA = dict(qp=40, enc_mode=8, intra_period_length=-1, hierarchical_levels=2)
W, H, N = 192, 128, 5


def _frames():
    return synthetic_clip(W, H, N, seed=13)


JAX_RA = jax_refs.register("random_access.192x128x5", lambda: (
    jax_refs.encode_case(_frames(), RefConfig(source_width=W,
                                              source_height=H, **RA))))


@pytest.fixture(scope="module")
def jax_ra_stream():
    return jax_refs.reference(JAX_RA)


def _port_encode(path):
    recon = api.encode_ivf(_frames(), EncoderConfig(
        source_width=W, source_height=H, **RA), str(path), device="cpu")
    return path.read_bytes(), recon


@pytest.fixture(scope="module")
def port_ra(tmp_path_factory):
    """The port's stream and recon, with what the encode did recorded:
    the jobs it ran, the pictures MCTF filtered and the compound share
    of each inter frame's plan."""
    seen = {"jobs": [], "tf": [], "comp": {}}
    with pytest.MonkeyPatch.context() as mp:
        run_job = api.Encoder._run_job
        tf = mctf.temporal_filter
        plan = batched_md.TorchDecider._plan_inter

        def logged_job(self, job, nxt=None):
            seen["jobs"].append((job.kind, job.display, job.layer))
            return run_job(self, job, nxt)

        def logged_tf(center, neighbours, *a):
            seen["tf"].append(len(neighbours))
            return tf(center, neighbours, *a)

        def logged_plan(self, codec):
            plan(self, codec)
            seen["comp"][codec.fh.order_hint] = float(
                (self._sf["sel"] >= len(self._names)).mean())

        mp.setattr(api.Encoder, "_run_job", logged_job)
        mp.setattr(mctf, "temporal_filter", logged_tf)
        mp.setattr(batched_md.TorchDecider, "_plan_inter", logged_plan)
        path = tmp_path_factory.mktemp("port") / "ra.ivf"
        data, recon = _port_encode(path)
    return data, recon, path, seen


# 190-306 s with the JAX side live (a stale store) in 6-worker runs
@pytest.mark.time_limit(620)
def test_ra_stream_byte_identical_to_jax_device_path(jax_ra_stream,
                                                     port_ra):
    data = port_ra[0]
    assert len(data) == len(jax_ra_stream)
    assert data == jax_ra_stream


def test_ra_path_covers_the_slice(port_ra):
    """Key frame, base picture, middle layer, leaves and show_existing;
    MCTF on the base picture (the key frame arrives alone, so it has no
    neighbour, as in the JAX encoder); compound on the frames with a
    backward reference."""
    _, _, _, seen = port_ra
    assert seen["jobs"] == [
        ("code", 0, 0), ("code", 4, 0), ("code", 2, 1), ("code", 1, 2),
        ("show_existing", 2, 0), ("code", 3, 2), ("show_existing", 4, 0)]
    assert seen["tf"] == [1]
    assert seen["comp"][4] == 0.0
    assert all(seen["comp"][d] > 0 for d in (1, 2, 3))


def test_reference_decoder_reproduces_ra_recon(port_ra):
    _, recon, path, _ = port_ra
    frames, _ = ref_api.decode_ivf(str(path))
    assert len(frames) == len(recon) == N
    for got, want in zip(frames, recon):
        for p in range(3):
            np.testing.assert_array_equal(got[p], want[p])


def test_ra_prefetch_does_not_change_the_stream(tmp_path, port_ra,
                                                monkeypatch):
    """With the next frame's plan prefetch off, every plan runs in line;
    with it on, it must have been taken at least once."""
    hits = []
    take = batched_md.TorchDecider._take_prefetched_inter

    def counted(self, codec, key):
        got = take(self, codec, key)
        hits.append(got is not None)
        return got

    monkeypatch.setattr(batched_md.TorchDecider, "_take_prefetched_inter",
                        counted)
    again, _ = _port_encode(tmp_path / "again.ivf")
    assert again == port_ra[0] and any(hits)
    monkeypatch.setattr(api.Encoder, "_maybe_prefetch_inter",
                        lambda self, job, nxt, fh, planes: None)
    inline, _ = _port_encode(tmp_path / "inline.ivf")
    assert inline == port_ra[0]


def test_python_replay_equals_the_native_walker(tmp_path, port_ra,
                                                monkeypatch):
    """The per-block Python replay (TorchDecider.decide_inter and its
    compound branch) codes the same bytes as the native C walker that
    the encoder takes when it can."""
    from svt_av1_tpu_torch.native import tile_coder

    calls = []
    compound = batched_md.TorchDecider._decide_compound

    def counted(self, *a):
        calls.append(1)
        return compound(self, *a)

    monkeypatch.setattr(tile_coder, "try_encode_tiles_native_inter",
                        lambda codec, decider: None)
    monkeypatch.setattr(batched_md.TorchDecider, "_decide_compound",
                        counted)
    replay, _ = _port_encode(tmp_path / "replay.ivf")
    assert replay == port_ra[0] and calls
