"""Preset 4 end to end on the CPU through svt_av1_tpu_torch (plain
PyTorch versions of the kernels) against the JAX package's device path
(its jitted programs on the CPU backend).

Preset 4 takes the host partition RD walk (PartitionRdoDecider: 16x16
to 64x64 RD, no extended shapes), TX_MODE_SELECT (intra tx_size syntax
on key frames, recursive txfm_split on inter frames), filter intra,
wedge and diffwtd masked compound and inter-intra, besides preset 5's
tools (per-64x64 CDEF presets, loop restoration and the second entropy
pass, global motion, warped and OBMC motion).  The streams:

* low-delay P, 128x96x3 at qp 45 (this file);
* random access, 128x96, hierarchical_levels 1, 3 frames at qp 50, so
  that the B frame has two references: test_torch_presets_4_ra.py;
* 10-bit low-delay P, 128x96x2 at qp 45: test_torch_presets_4_10bit.py.

Each file holds one stream, so that --dist loadfile gives its compile
and encodes a worker.  The streams must be byte-identical, both Decoders
must turn each into the port encoder's recon with equal md5s, and every
frame header must read TX_MODE_SELECT.  The tools the port's Decoder
counts in each stream (chip_smoke.block_tools) are printed (``-s``) and
held to what these clips show.
"""
import pytest

from svt_av1_tpu_torch import api
from svt_av1_tpu_torch.pipeline.rdo import PartitionRdoDecider

from chip_smoke import block_tools, stream_features, wave_clip
from test_e2e import synthetic_clip
from test_torch_presets_7 import (LD, RA, _configs, decode_both,
                                  encode_both, register_streams, tenbit)

W, H = 128, 96
STREAMS = {
    "p4-low-delay-p": (lambda: synthetic_clip(W, H, 3, seed=13),
                       dict(LD, enc_mode=4, qp=45)),
    "p4-random-access": (lambda: synthetic_clip(W, H, 3, seed=13),
                         dict(RA, hierarchical_levels=1, enc_mode=4,
                              qp=50)),
    "p4-10bit-low-delay-p": (lambda: tenbit(synthetic_clip(W, H, 2,
                                                           seed=13)),
                             dict(LD, enc_mode=4, qp=45,
                                  encoder_bit_depth=10)),
}
register_streams("presets_4", {kind: (clip, W, H, kw)
                               for kind, (clip, kw) in STREAMS.items()})
# the tools each clip shows (the port's Decoder's counts of the stream)
TOOLS = {
    "p4-low-delay-p": ("vartx", "interintra"),
    "p4-random-access": ("wedge", "diffwtd", "interintra",
                         "filter_intra"),
    "p4-10bit-low-delay-p": (),
}


def make_stream(kind, tmp_path_factory):
    clip, kw = STREAMS[kind]
    got = encode_both(tmp_path_factory.mktemp("p4"), clip(), W, H, kw,
                      f"presets_4.{kind}")
    got["kind"] = kind
    got["features"] = stream_features(got["path"])
    got["tools"], _, _ = block_tools(got["path"])
    print(kind, "tools:", got["tools"])
    return got


# ``slow``: the stream's two host RD walks and decodes take about 100 s
# alone
@pytest.fixture(scope="module", params=[
    pytest.param("p4-low-delay-p", marks=pytest.mark.slow)])
def stream(request, tmp_path_factory):
    return make_stream(request.param, tmp_path_factory)


def test_stream_byte_identical_to_jax_device_path(stream):
    assert len(stream["port"]) == len(stream["jax"])
    assert stream["port"] == stream["jax"]


def test_stream_decodes_to_the_recon_with_both_decoders(stream,
                                                        monkeypatch):
    decode_both(stream["path"], stream["recon"], monkeypatch)


def test_stream_reads_tx_mode_select_and_the_rd_tools(stream):
    feats = stream["features"]
    assert all(f[4] == 1 for f in feats), feats
    assert feats[0][0] == 0 and all(f[0] == 1 for f in feats[1:])
    tools = stream["tools"]
    missing = [k for k in TOOLS[stream["kind"]] if not tools.get(k)]
    assert not missing, (missing, tools)


def test_chip_smoke_codes_the_clip_of_these_tests():
    """chip_smoke.py's preset-4 random-access job codes this file's
    random-access clip (its own copy of the generator)."""
    for got, want in zip(wave_clip(W, H, 3), synthetic_clip(W, H, 3,
                                                            seed=13)):
        for p in range(3):
            assert (got[p] == want[p]).all()


@pytest.mark.parametrize("preset", [4, 3])
def test_rd_presets_take_the_partition_rdo_decider(preset):
    """Presets 4 and 3: the partition RD walk with the JAX package's
    arguments (16x16 RD at both, the extended shapes at 3); masked
    compound and inter-intra in the sequence header."""
    port_cfg, _ = _configs(W, H, dict(RA, enc_mode=preset))
    enc = api.Encoder(port_cfg, device="cpu")
    dec = enc._decider_cached()
    assert type(dec) is PartitionRdoDecider
    assert (dec.min_rd_bsize, dec.max_rd_bsize) == (16, 64)
    assert dec.ext_shapes == (preset <= 3)
    assert dec.n_full_rd == enc.sig.md_stage_nics[2]
    assert not hasattr(dec, "prefetch") and not enc._pipeline()
    seq = enc.seq
    assert seq.enable_masked_compound and seq.enable_interintra_compound
    assert seq.enable_filter_intra
