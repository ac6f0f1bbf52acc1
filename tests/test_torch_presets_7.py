"""Preset 7 end to end on the CPU: 192x128 low-delay P (4 frames) and
random access (5 frames, hierarchical_levels 2) through svt_av1_tpu_torch
(plain PyTorch versions of the kernels) against the JAX package's device
path (its jitted programs on the CPU backend).

At preset 7 key frames take K1's batched plan (TorchIntraDecider, the
counterpart of BatchedIntraDecider) and inter frames the base per-block
host walk in closed loop; paeth and smooth are in the candidate set.  The
streams must be byte-identical, and the port's Decoder and the JAX
Decoder must turn each into the port encoder's recon with equal md5s.

The helpers here serve test_torch_presets_5_6.py too.
"""
import collections
import functools

import numpy as np
import pytest

import jax_refs
from svt_av1_tpu import api as ref_api
from svt_av1_tpu.config import EncoderConfig as RefConfig
from svt_av1_tpu.config import PredStructure as RefPred
from svt_av1_tpu_torch import api
from svt_av1_tpu_torch.config import EncoderConfig, PredStructure
from svt_av1_tpu_torch.pipeline import batched_md
from svt_av1_tpu_torch.pipeline import frame_codec as port_fc

from chip_smoke import stream_features
from test_e2e import synthetic_clip

W, H = 192, 128
LD = dict(intra_period_length=-1, low_delay=True)
RA = dict(intra_period_length=-1, hierarchical_levels=2)


def _configs(w, h, kw):
    """(port config, JAX config) of the same settings, at qp 40 unless
    ``kw`` names another; ``low_delay`` picks LOW_DELAY_P."""
    kw = dict(kw)
    low_delay = kw.pop("low_delay", False)
    kw.setdefault("qp", 40)
    out = []
    for cls, pred in ((EncoderConfig, PredStructure),
                      (RefConfig, RefPred)):
        extra = dict(pred_structure=pred.LOW_DELAY_P) if low_delay else {}
        out.append(cls(source_width=w, source_height=h, **kw, **extra))
    return out


def tenbit(frames, seed=10):
    """8-bit frames as 10-bit ones: each sample times 4 plus low bits from
    a seeded generator."""
    rng = np.random.default_rng(seed)
    return [tuple((p.astype(np.uint16) << 2)
                  | rng.integers(0, 4, p.shape, dtype=np.uint16) for p in f)
            for f in frames]


def _stream_case(clip, w, h, kw):
    """(inputs, produce) of the JAX device path's stream of ``clip()``
    (tests/jax_refs.py)."""
    return jax_refs.encode_case(clip(), _configs(w, h, kw)[1])


def register_streams(prefix, cases):
    """Register the JAX stream of each case (kind -> (clip, w, h, kw),
    ``clip()`` the frames) as the entry ``<prefix>.<kind>``."""
    for kind, case in cases.items():
        jax_refs.register(f"{prefix}.{kind}",
                          functools.partial(_stream_case, *case))


def encode_both(tmp_dir, frames, w, h, kw, name):
    """The port's stream (plain versions on the CPU) and the JAX device
    path's on the same frames (entry ``name`` of tests/jax_refs.py):
    dict(port, jax, recon, path, seen) where seen counts the port
    encode's key-frame plans and per-block inter decisions."""
    port_cfg, ref_cfg = _configs(w, h, kw)
    jax = jax_refs.reference(name, frames=frames, cfg=ref_cfg)
    seen = collections.Counter()
    with pytest.MonkeyPatch.context() as mp:
        plan = batched_md.TorchIntraDecider._plan_frame
        inter = port_fc.ModeDecider.decide_inter

        def counted_plan(self, codec):
            seen["key_plans"] += 1
            return plan(self, codec)

        def counted_inter(self, *a, **k):
            seen["inter_decisions"] += 1
            return inter(self, *a, **k)

        mp.setattr(batched_md.TorchIntraDecider, "_plan_frame",
                   counted_plan)
        mp.setattr(port_fc.ModeDecider, "decide_inter", counted_inter)
        path = tmp_dir / "port.ivf"
        recon = api.encode_ivf(frames, port_cfg, str(path), device="cpu")
    return dict(port=path.read_bytes(), jax=jax, recon=recon, path=path,
                seen=seen)


def decode_both(path, recon, monkeypatch):
    """Decode the IVF with the port's Decoder and the JAX Decoder: both
    must give the encoder's recon and equal md5s.  Returns the motion
    modes the port's Decoder read ({0 simple, 1 OBMC, 2 warped: count})."""
    modes = collections.Counter()
    code = port_fc.FrameCodec._code_motion_mode

    def counted(self, *a):
        got = code(self, *a)
        modes[int(got)] += 1
        return got

    monkeypatch.setattr(port_fc.FrameCodec, "_code_motion_mode", counted)
    frames, md5 = api.decode_ivf(str(path), device="cpu")
    ref_frames, ref_md5 = ref_api.decode_ivf(str(path))
    assert md5 == ref_md5
    assert len(frames) == len(ref_frames) == len(recon)
    for d, (got, want, rec) in enumerate(zip(frames, ref_frames, recon)):
        for p in range(3):
            np.testing.assert_array_equal(got[p], rec[p], f"{d} {p}")
            np.testing.assert_array_equal(want[p], rec[p], f"{d} {p}")
    return modes


STREAMS = {kind: (functools.partial(synthetic_clip, W, H, n, seed=13), W,
                  H, dict(kw, enc_mode=7))
           for kind, (n, kw) in (("low-delay-p", (4, LD)),
                                 ("random-access", (5, RA)))}
register_streams("presets_7", STREAMS)


@pytest.fixture(scope="module", params=list(STREAMS))
def preset7(request, tmp_path_factory):
    clip, w, h, kw = STREAMS[request.param]
    got = encode_both(tmp_path_factory.mktemp("p7"), clip(), w, h, kw,
                      f"presets_7.{request.param}")
    got["kind"] = request.param
    return got


# sets the fixture up: 157 s with the JAX side live (a stale store) in a
# 6-worker run
@pytest.mark.time_limit(320)
def test_preset7_stream_byte_identical_to_jax_device_path(preset7):
    assert len(preset7["port"]) == len(preset7["jax"])
    assert preset7["port"] == preset7["jax"]


def test_preset7_stream_decodes_to_the_recon_with_both_decoders(
        preset7, monkeypatch):
    modes = decode_both(preset7["path"], preset7["recon"], monkeypatch)
    # motion modes are not switchable at preset 7: only simple motion
    assert set(modes) <= {0}


def test_preset7_plans_key_frames_and_walks_inter_frames(preset7):
    """One K1 plan per key frame; every inter frame through the per-block
    host walk; no CDEF presets or loop restoration at preset 7."""
    feats = stream_features(preset7["path"])
    assert [f[0] for f in feats] == [0] + [1] * (len(feats) - 1)
    assert preset7["seen"]["key_plans"] == 1
    assert preset7["seen"]["inter_decisions"] > 0
    assert all(f[1] == 0 and not any(f[2]) and not any(f[3])
               for f in feats)


def test_preset7_decider_is_the_intra_plan_without_an_inter_prefetch():
    port_cfg, _ = _configs(W, H, dict(LD, enc_mode=7))
    enc = api.Encoder(port_cfg, device="cpu")
    dec = enc._decider_cached()
    assert type(dec) is batched_md.TorchIntraDecider
    assert hasattr(dec, "prefetch") and not hasattr(dec, "prefetch_inter")
    assert enc.sig.enable_paeth and enc.sig.enable_smooth
    assert not enc.sig.open_loop_me and not enc.sig.cdef_multi
    # the key-frame prefetch runs; the inter one has nothing to call
    assert enc._pipeline()
