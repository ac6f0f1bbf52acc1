"""Super-resolution at denominator 16 under the default all-intra
configuration (MCTF on every key frame) with loop restoration on: the
stream tests of test_torch_superres.py on this file's stream (a file of
its own, so that --dist loadfile gives its compile and encodes a
worker)."""
import pytest

from test_torch_superres import (  # noqa: F401
    make_stream, test_frames_are_coded_at_the_downscaled_width,
    test_stream_byte_identical_to_jax_device_path,
    test_stream_decodes_to_the_recon_with_both_decoders)


# ``slow``: the stream's compile and encodes take about 60 s alone
@pytest.fixture(scope="module", params=[
    pytest.param("denom16-mctf-lr", marks=pytest.mark.slow)])
def stream(request, tmp_path_factory):
    return make_stream(request.param, tmp_path_factory)
