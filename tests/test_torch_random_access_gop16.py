"""The random-access slice at the main path's pyramid depth on the CPU:
bench.py's structure (hierarchical_levels 4, intra_period_length 33) on
a 192x128 clip of 17 frames, a key frame and one full 16-frame mini-GOP
(five temporal layers, ALTREF2 and the far references' wider coarse
reach, compound with distances up to 8, TPL over a 17-frame window, MCTF
on the base picture), through svt_av1_tpu_torch with the plain versions
of the kernels, against the JAX package's device path.

The streams must be byte-identical.  The JAX side compiles and runs its
programs on the CPU for about three minutes when its stored stream
(tests/jax_refs.py) does not match: this file stands alone so that
--dist loadfile gives it a worker of its own.
"""
import pytest

import jax_refs
from svt_av1_tpu.config import EncoderConfig as RefConfig
from svt_av1_tpu_torch import api
from svt_av1_tpu_torch.config import EncoderConfig

from test_e2e import synthetic_clip

CFG = dict(source_width=192, source_height=128, qp=40, enc_mode=8,
           intra_period_length=33)
JAX_GOP16 = jax_refs.register("random_access_gop16.192x128x17", lambda: (
    jax_refs.encode_case(synthetic_clip(192, 128, 17, seed=13),
                         RefConfig(**CFG))))


# 328-486 s with the JAX side live (a stale store) in 6-worker runs
@pytest.mark.time_limit(1000)
def test_gop16_stream_byte_identical_to_jax_device_path(tmp_path):
    frames = synthetic_clip(192, 128, 17, seed=13)
    api.encode_ivf(frames, EncoderConfig(**CFG), str(tmp_path / "port.ivf"),
                   device="cpu")
    port = (tmp_path / "port.ivf").read_bytes()
    ref = jax_refs.reference(JAX_GOP16, frames=frames, cfg=RefConfig(**CFG))
    assert len(port) == len(ref)
    assert port == ref
