"""The ported slice end to end on the CPU: all-intra preset-8 encode
through svt_av1_tpu_torch (plain PyTorch versions of the kernels) against
the JAX package's device path (its jitted programs on the CPU backend).

The stream must be byte-identical; the JAX decoder must reproduce the
port's recon exactly; the one-picture prefetch pipeline must not change a
byte.
"""
import numpy as np
import pytest

from svt_av1_tpu import api as ref_api
from svt_av1_tpu.config import EncoderConfig as RefConfig
from svt_av1_tpu.config import PredStructure as RefPred
from svt_av1_tpu_torch import api
from svt_av1_tpu_torch.config import EncoderConfig, PredStructure

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


def test_stream_byte_identical_to_jax_device_path(jax_device_stream,
                                                  port_64):
    data, _, _ = port_64
    assert len(data) == len(jax_device_stream)
    assert data == jax_device_stream


@pytest.mark.parametrize("size", [(64, 64), (176, 144)])
def test_reference_decoder_reproduces_recon(tmp_path, port_64, size):
    w, h = size
    if size == (64, 64):
        _, recon, path = port_64
    else:
        _, recon, path = _port_encode(tmp_path, w, h, 1)
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


@pytest.mark.parametrize("kw", [
    dict(enc_mode=6),
    dict(intra_period_length=-1),
    dict(pred_structure=PredStructure.RANDOM_ACCESS),
    dict(encoder_bit_depth=10),
    dict(enable_restoration=1),
], ids=["preset6", "inter", "random_access", "10bit", "restoration"])
def test_unported_configuration_raises(kw):
    cfg = EncoderConfig(**{**dict(source_width=64, source_height=64,
                                  pred_structure=PredStructure.LOW_DELAY_P,
                                  **SLICE), **kw})
    with pytest.raises(NotImplementedError):
        api.Encoder(cfg, device="cpu")
