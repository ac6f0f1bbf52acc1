"""Preset-8 settings beyond the three configurations' defaults, each
coded on the CPU by the port (plain versions of the kernels) and by the
JAX package's device path (SVT_TPU_DEVICE=1, its jitted programs on the
CPU backend): the streams must be byte-identical.

Lossless, screen content (palette and IntraBC) and VBR run in the quick
tier; the other seven (odd sizes, 64x64 superblocks, two tile columns,
adaptive quantization, the warped-motion and OBMC switches, the loop
filters off) under ``slow``.
"""
import functools

import numpy as np
import pytest

import jax_refs
from svt_av1_tpu.config import EncoderConfig as RefConfig
from svt_av1_tpu.config import PredStructure as RefPred
from svt_av1_tpu.config import RateControlMode as RefRC
from svt_av1_tpu_torch import api
from svt_av1_tpu_torch.config import EncoderConfig, PredStructure
from svt_av1_tpu_torch.config import RateControlMode

from test_e2e import synthetic_clip

SLICE = dict(qp=40, enc_mode=8, intra_period_length=0)
IPP = dict(intra_period_length=-1)


def _screen_clip(w, h, n):
    """Screen-like frames: a few flat colours in text-like strokes and a
    tile that repeats across the picture (palette and IntraBC content)."""
    rng = np.random.default_rng(2)
    tile = rng.choice([16, 80, 200, 235], size=(16, 16)).astype(np.uint8)
    frames = []
    for i in range(n):
        y = np.tile(tile, (h // 16 + 1, w // 16 + 1))[:h, :w].copy()
        y[8 + i:12 + i, 4:w - 4] = 235
        u = np.full((h // 2, w // 2), 128, np.uint8)
        v = np.where(y[::2, ::2] > 128, 160, 96).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def _case(w, h, n, clip=synthetic_clip, rc=None, **kw):
    return dict(w=w, h=h, n=n, clip=clip, rc=rc, kw=kw)


CASES = {
    "lossless": _case(64, 64, 2, qp=0),
    "screen_content": _case(64, 64, 2, _screen_clip, screen_content_mode=1),
    "vbr": _case(192, 128, 4, rc="VBR", target_bit_rate=400_000, **IPP),
    "odd_all_intra": _case(130, 98, 2),
    "odd_ipp": _case(202, 134, 3, **IPP),
    "sb64": _case(128, 128, 2, super_block_size=64),
    "tile_columns": _case(256, 128, 2, tile_columns=1),
    "adaptive_quantization": _case(128, 128, 2,
                                   enable_adaptive_quantization=1),
    "warped_obmc": _case(192, 128, 3, enable_warped_motion=1, obmc_level=1,
                         **IPP),
    "filters_off": _case(64, 64, 2, disable_dlf=True, cdef_level=0),
}
QUICK = ("lossless", "screen_content", "vbr")


def _config(name, cfg_cls, pred, rc):
    """CASES[name] as ``cfg_cls`` (the port's or the JAX package's)."""
    c = CASES[name]
    kw = {**SLICE, **c["kw"]}
    if c["rc"] is not None:
        kw["rate_control_mode"] = rc[c["rc"]]
    return cfg_cls(source_width=c["w"], source_height=c["h"],
                   pred_structure=pred.LOW_DELAY_P, **kw)


def _jax_case(name):
    c = CASES[name]
    return jax_refs.encode_case(c["clip"](c["w"], c["h"], c["n"]),
                                _config(name, RefConfig, RefPred, RefRC))


for _name in CASES:
    jax_refs.register(f"settings.{_name}",
                      functools.partial(_jax_case, _name))


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=() if n in QUICK else pytest.mark.slow)
    for n in CASES])
def test_setting_byte_identical_to_jax_device_path(name, tmp_path):
    c = CASES[name]
    frames = c["clip"](c["w"], c["h"], c["n"])
    cfg = _config(name, EncoderConfig, PredStructure, RateControlMode)
    port_path = tmp_path / "port.ivf"
    api.encode_ivf(frames, cfg, str(port_path), device="cpu")
    want = jax_refs.reference(f"settings.{name}", frames=frames,
                              cfg=_config(name, RefConfig, RefPred, RefRC))
    got = port_path.read_bytes()
    assert len(got) == len(want), (name, len(got), len(want))
    assert got == want, name
