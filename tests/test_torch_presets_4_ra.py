"""Preset 4 random access on the CPU: 128x96, hierarchical_levels 1, 3
frames at qp 50, so that the B frame has two references; the unforced
searches pick wedge and diffwtd compound, inter-intra and filter intra.
The stream tests of test_torch_presets_4.py on this file's stream (a
file of its own, so that --dist loadfile gives its compile and encodes
a worker)."""
import pytest

from test_torch_presets_4 import (  # noqa: F401
    make_stream, test_stream_byte_identical_to_jax_device_path,
    test_stream_decodes_to_the_recon_with_both_decoders,
    test_stream_reads_tx_mode_select_and_the_rd_tools)


# ``slow``: the stream's encodes and decodes take about 110 s alone
@pytest.fixture(scope="module", params=[
    pytest.param("p4-random-access", marks=pytest.mark.slow)])
def stream(request, tmp_path_factory):
    return make_stream(request.param, tmp_path_factory)
