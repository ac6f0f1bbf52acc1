"""The ported slices end to end on the CPU: all-intra and low-delay P
(one key frame, then P frames) preset-8 encodes through svt_av1_tpu_torch
(plain PyTorch versions of the kernels) against the JAX package's device
path (its jitted programs on the CPU backend).

The streams must be byte-identical; the JAX decoder must reproduce the
port's recon exactly; the prefetch pipelines (the next key frame's intra
decision, the next P frame's open-loop ME plan) must not change a byte.
"""
import numpy as np
import pytest

from svt_av1_tpu import api as ref_api
from svt_av1_tpu.config import EncoderConfig as RefConfig
from svt_av1_tpu.config import PredStructure as RefPred
from svt_av1_tpu_torch import api
from svt_av1_tpu_torch.config import ConfigError, EncoderConfig, \
    PredStructure
from svt_av1_tpu_torch.pipeline.batched_md import TorchDecider

from test_e2e import synthetic_clip

SLICE = dict(qp=40, enc_mode=8, intra_period_length=0)


def _cfg(w, h, **kw):
    return EncoderConfig(source_width=w, source_height=h,
                         pred_structure=PredStructure.LOW_DELAY_P,
                         **{**SLICE, **kw})


def _port_encode(tmp_path, w, h, n, name="port.ivf", **kw):
    frames = synthetic_clip(w, h, n, seed=13)
    path = tmp_path / name
    recon = api.encode_ivf(frames, _cfg(w, h, **kw), str(path),
                           device="cpu")
    return path.read_bytes(), recon, path


@pytest.fixture(scope="module")
def jax_device_stream(tmp_path_factory):
    """The JAX package's device path (SVT_TPU_DEVICE=1: jitted decision
    and fused filter chain, CPU backend) on the 64x64 clip."""
    frames = synthetic_clip(64, 64, 2, seed=13)
    cfg = RefConfig(source_width=64, source_height=64,
                    pred_structure=RefPred.LOW_DELAY_P, **SLICE)
    path = tmp_path_factory.mktemp("ref") / "ref.ivf"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SVT_TPU_DEVICE", "1")
        ref_api.encode_ivf(frames, cfg, str(path))
    return path.read_bytes()


@pytest.fixture(scope="module")
def port_64(tmp_path_factory):
    return _port_encode(tmp_path_factory.mktemp("port"), 64, 64, 2)


IPP = dict(intra_period_length=-1)


@pytest.fixture(scope="module")
def jax_ipp_stream(tmp_path_factory):
    """The JAX package's device path on the 192x128 low-delay P clip (the
    smallest size whose buffer takes the batched inter plan)."""
    frames = synthetic_clip(192, 128, 6, seed=13)
    cfg = RefConfig(source_width=192, source_height=128,
                    pred_structure=RefPred.LOW_DELAY_P, **{**SLICE, **IPP})
    path = tmp_path_factory.mktemp("ref") / "ref_ipp.ivf"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SVT_TPU_DEVICE", "1")
        ref_api.encode_ivf(frames, cfg, str(path))
    return path.read_bytes()


@pytest.fixture(scope="module")
def port_ipp(tmp_path_factory):
    return _port_encode(tmp_path_factory.mktemp("port"), 192, 128, 6,
                        "ipp.ivf", **IPP)


def test_stream_byte_identical_to_jax_device_path(jax_device_stream,
                                                  port_64):
    data, _, _ = port_64
    assert len(data) == len(jax_device_stream)
    assert data == jax_device_stream


def test_ipp_stream_byte_identical_to_jax_device_path(jax_ipp_stream,
                                                      port_ipp):
    data, _, _ = port_ipp
    assert len(data) == len(jax_ipp_stream)
    assert data == jax_ipp_stream


@pytest.mark.parametrize("size", [(64, 64), (176, 144), "ipp"])
def test_reference_decoder_reproduces_recon(tmp_path, port_64, port_ipp,
                                            size):
    if size == (64, 64):
        _, recon, path = port_64
    elif size == "ipp":
        _, recon, path = port_ipp
    else:
        _, recon, path = _port_encode(tmp_path, *size, 1)
    frames, _ = ref_api.decode_ivf(str(path))
    assert len(frames) == len(recon)
    for got, want in zip(frames, recon):
        for p in range(3):
            assert got[p].shape == want[p].shape
            np.testing.assert_array_equal(got[p], want[p])


def test_prefetch_pipeline_does_not_change_the_stream(tmp_path, port_64):
    """pictures_in_flight=1 codes each picture as it arrives (no prefetch
    worker); the default keeps one picture in flight."""
    data, _, _ = port_64
    serial, _, _ = _port_encode(tmp_path, 64, 64, 2, "serial.ivf",
                                pictures_in_flight=1)
    assert serial == data


def test_ipp_prefetch_does_not_change_the_stream(tmp_path, port_ipp,
                                                monkeypatch):
    """With the next P frame's plan prefetch disabled, every plan runs in
    line."""
    monkeypatch.setattr(api.Encoder, "_maybe_prefetch_inter",
                        lambda self, job, nxt, fh, planes: None)
    data, _, _ = port_ipp
    inline, _, _ = _port_encode(tmp_path, 192, 128, 6, "inline.ivf", **IPP)
    assert inline == data


def test_ipp_prefetch_submits_and_hits(tmp_path, monkeypatch):
    hits = {"submit": 0, "hit": 0}
    orig_submit = TorchDecider.prefetch_inter
    orig_take = TorchDecider._take_prefetched_inter

    def submit(self, *a, **k):
        hits["submit"] += 1
        return orig_submit(self, *a, **k)

    def take(self, codec, key):
        got = orig_take(self, codec, key)
        hits["hit"] += got is not None
        return got

    monkeypatch.setattr(TorchDecider, "prefetch_inter", submit)
    monkeypatch.setattr(TorchDecider, "_take_prefetched_inter", take)
    _port_encode(tmp_path, 192, 128, 4, "hits.ivf", **IPP)
    assert hits["submit"] == 3 and hits["hit"] == 3


def test_closed_loop_plan_decodes(tmp_path, monkeypatch):
    """Without the references' source planes the P-frame plan searches
    their reconstructions (TorchDecider._ref_plane, one upload per coded
    picture); the stream still decodes to the port's recon."""
    monkeypatch.setattr(api.Encoder, "_store_me_src",
                        lambda self, display, plane: None)
    uploads = []
    orig = TorchDecider._ref_plane

    def ref_plane(self, codec, name):
        got = orig(self, codec, name)
        uploads.append(id(got))
        return got

    monkeypatch.setattr(TorchDecider, "_ref_plane", ref_plane)
    _, recon, path = _port_encode(tmp_path, 192, 128, 4, "closed.ivf",
                                  **IPP)
    # pictures 0, 1, 2 are each the reference of one P frame
    assert len(uploads) == 3 and len(set(uploads)) == 3
    frames, _ = ref_api.decode_ivf(str(path))
    assert len(frames) == len(recon) == 4
    for got, want in zip(frames, recon):
        for p in range(3):
            np.testing.assert_array_equal(got[p], want[p])


@pytest.mark.parametrize("kw", [
    dict(enc_mode=6),
    dict(film_grain_denoise_strength=10),
    # all-intra key frames under the random-access structure: MCTF of key
    # frames with the one-picture pipeline is not ported
    dict(pred_structure=PredStructure.RANDOM_ACCESS),
    # 10 bits are ported for all-intra and low-delay P: random access
    # (here bench.py's, TPL on) needs the 16-bit forms of K9 and K10
    dict(encoder_bit_depth=10, intra_period_length=33,
         pred_structure=PredStructure.RANDOM_ACCESS),
    dict(enable_restoration=1),
    dict(superres_mode=1),
    dict(intra_period_length=-1, pred_structure=PredStructure.RANDOM_ACCESS,
         compound_level=2),
    dict(encoder_bit_depth=10, intra_period_length=-1,
         pred_structure=PredStructure.RANDOM_ACCESS),
], ids=["preset6", "film_grain", "random_access", "10bit", "restoration",
        "superres", "masked_compound", "10bit_random_access"])
def test_unported_configuration_raises(kw):
    cfg = EncoderConfig(**{**dict(source_width=64, source_height=64,
                                  pred_structure=PredStructure.LOW_DELAY_P,
                                  **SLICE), **kw})
    with pytest.raises(NotImplementedError):
        api.Encoder(cfg, device="cpu")


def test_twelve_bit_raises():
    """12 bits: the configuration refuses them, and so does the encoder's
    slice check for a configuration that got past that."""
    kw = dict(source_width=64, source_height=64,
              pred_structure=PredStructure.LOW_DELAY_P, **SLICE)
    with pytest.raises(ConfigError):
        EncoderConfig(encoder_bit_depth=12, **kw)
    cfg = EncoderConfig(**kw)
    object.__setattr__(cfg, "encoder_bit_depth", 12)
    with pytest.raises(NotImplementedError):
        api.Encoder(cfg, device="cpu")


def test_bench_configuration_is_the_random_access_slice():
    """bench.py's settings: RANDOM_ACCESS, hierarchical_levels 4, TPL on
    and tf_level 2 stay at their defaults and the encoder takes them; it
    reorders pictures, so the zero-latency wrapper refuses it."""
    cfg = EncoderConfig(source_width=1920, source_height=1080, qp=40,
                        enc_mode=8, intra_period_length=33)
    assert cfg.pred_structure == PredStructure.RANDOM_ACCESS
    assert cfg.hierarchical_levels == 4 and cfg.enable_tpl_la
    enc = api.Encoder(cfg, device="cpu")
    assert enc.sig.tf_level == 2 and enc.sig.compound_level == 1
    assert enc.pd.gop == 16 and enc.pd.key_interval == 34
    with pytest.raises(ValueError):
        enc.encode_frame(synthetic_clip(64, 64, 1)[0])
