"""Preset 4 at 10 bits on the CPU: low-delay P, 128x96x2 at qp 45.  The
stream tests of test_torch_presets_4.py on this file's stream (a file of
its own, so that --dist loadfile gives its compile and encodes a
worker)."""
import pytest

from test_torch_presets_4 import (  # noqa: F401
    make_stream, test_stream_byte_identical_to_jax_device_path,
    test_stream_decodes_to_the_recon_with_both_decoders,
    test_stream_reads_tx_mode_select_and_the_rd_tools)


# ``slow``: the stream's compile and encodes take about 70 s alone
@pytest.fixture(scope="module", params=[
    pytest.param("p4-10bit-low-delay-p", marks=pytest.mark.slow)])
def stream(request, tmp_path_factory):
    return make_stream(request.param, tmp_path_factory)
