"""Preset 6 at 10 bits end to end on the CPU: 3 frames of low-delay P at
192x128 through svt_av1_tpu_torch against the JAX package's device path:
the host RD walk, per-64x64 CDEF presets on 16-bit sources, loop
restoration (no global motion at 10 bits).  Byte-identical streams,
both Decoders to the recon.

The stream tests are test_torch_presets_5_6.py's, on this file's stream
(a file of its own, so that --dist loadfile gives its compile and
encodes a worker).
"""
import pytest

from test_torch_presets_5_6 import (  # noqa: F401
    make_stream, test_stream_byte_identical_to_jax_device_path,
    test_stream_carries_cdef_presets_and_loop_restoration,
    test_stream_decodes_to_the_recon_with_both_decoders)


@pytest.fixture(scope="module", params=["p6-10bit-low-delay-p"])
def stream(request, tmp_path_factory):
    return make_stream(request.param, tmp_path_factory)
