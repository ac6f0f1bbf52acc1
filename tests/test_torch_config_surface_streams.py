"""The settings of test_torch_config_surface.py as streams: each coded on
the CPU by the port (plain versions of the kernels) and by the JAX
package's device path (SVT_TPU_DEVICE=1, its jitted programs on the CPU
backend) must be byte-identical, and both Decoders must turn it into the
port encoder's recon.  Each stream also carries its setting (read back by
chip_smoke.stream_features: superblock size, tile counts, per-frame
base_q_idx; MCTF's neighbour counts and the coding order where the
setting does not reach the headers).

The clips are the smallest that reach each setting: tile rows and
columns (128x128x2, 64x64 superblocks), CVBR with vbv_bufsize and a qp
range (64x64x5, low-delay P), fixed qindex offsets with a key-frame
offset (random access, hierarchical_levels 2), MCTF's reach
(altref_nframes and look_ahead_distance under random access, and
look_ahead_distance 0 in the default all-intra configuration, where it
takes the next picture away), hierarchical_levels 0, 1, 3
and 5 (2, 3, 9 and 33 frames: the first mini-GOP reaches the top
layer), 64x64 superblocks under random access (128x128x5), the tool
toggles off together (low-delay P), a narrow search area with HME level
1 off at preset 6 (the host ME), and preset -2, whose stream equals
preset 2's on the same clip.

All ``slow``: each case compiles the JAX device path for its geometry
(30-90 s).  Run with ``python -m pytest -m slow
tests/test_torch_config_surface_streams.py``.
"""
import functools

import pytest

import jax_refs
from svt_av1_tpu_torch import api
from svt_av1_tpu_torch.bitstream.headers import QUANTIZER_TO_QINDEX
from svt_av1_tpu_torch.pipeline import mctf

from chip_smoke import stream_features, stream_headers
from test_e2e import synthetic_clip
from test_torch_config_surface import CVBR, LD, TOOLS_OFF, configs
from test_torch_presets_7 import decode_both

pytestmark = pytest.mark.slow

RA = dict(intra_period_length=-1)
OFFSETS = (0, 4, 8, 12)
CASES = {
    "tiles": (128, 128, 2, dict(LD, super_block_size=64, tile_rows=1,
                                tile_columns=1)),
    "cvbr": (64, 64, 5, dict(LD, **dict(CVBR, target_bit_rate=200_000),
                             vbv_bufsize=50_000, min_qp_allowed=20,
                             max_qp_allowed=55)),
    "qindex_offsets": (64, 64, 5, dict(RA, hierarchical_levels=2,
                                       use_fixed_qindex_offsets=True,
                                       qindex_offsets=OFFSETS,
                                       key_frame_qindex_offset=-8)),
    # tf_level 1 (the full window): at preset 8's tf_level 2 the window is
    # one picture either side whatever altref_nframes says
    "mctf_altref3_lad4": (64, 64, 9, dict(RA, hierarchical_levels=2,
                                          tf_level=1, altref_nframes=3,
                                          look_ahead_distance=4)),
    "mctf_altref7_lad1": (64, 64, 9, dict(RA, hierarchical_levels=2,
                                          tf_level=1, altref_nframes=7,
                                          look_ahead_distance=1)),
    # the default all-intra configuration filters each key frame against
    # the next buffered picture: look_ahead_distance 0 takes that away
    "mctf_allintra_lad0": (64, 64, 3, dict(intra_period_length=-2,
                                           look_ahead_distance=0)),
    "hierarchical_levels_0": (64, 64, 2, dict(RA, hierarchical_levels=0)),
    "hierarchical_levels_1": (64, 64, 3, dict(RA, hierarchical_levels=1)),
    "hierarchical_levels_3": (64, 64, 9, dict(RA, hierarchical_levels=3)),
    "hierarchical_levels_5": (64, 64, 33, dict(RA, hierarchical_levels=5)),
    "sb64_random_access": (128, 128, 5, dict(RA, hierarchical_levels=2,
                                             super_block_size=64)),
    "tools_off": (64, 64, 2, dict(LD, **TOOLS_OFF)),
    "host_me": (64, 64, 2, dict(LD, enc_mode=6, search_area_width=16,
                                search_area_height=16,
                                enable_hme_level1=0)),
    "preset_-2": (64, 64, 2, dict(LD, enc_mode=-2)),
}


def _jax_case(name):
    w, h, n, kw = CASES[name]
    return jax_refs.encode_case(synthetic_clip(w, h, n, seed=13),
                                configs(kw, kw.get("enc_mode", 8))[1])


for _name in CASES:
    jax_refs.register(f"config_surface_streams.{_name}",
                      functools.partial(_jax_case, _name))


def encode_both(tmp_path, name):
    """The port's stream of CASES[name] on the CPU and the JAX device
    path's, with the number of neighbours the port's MCTF took for each
    filtered picture."""
    w, h, n, kw = CASES[name]
    frames = synthetic_clip(w, h, n, seed=13)
    port_cfg, ref_cfg = configs(kw, kw.get("enc_mode", 8))
    path = tmp_path / "port.ivf"
    jax = jax_refs.reference(f"config_surface_streams.{name}",
                             frames=frames, cfg=ref_cfg)
    neighbours = []
    with pytest.MonkeyPatch.context() as mp:
        filt = mctf.temporal_filter

        def counted(center, neighbor_frames, *a):
            neighbours.append(len(neighbor_frames))
            return filt(center, neighbor_frames, *a)

        mp.setattr(mctf, "temporal_filter", counted)
        recon = api.encode_ivf(frames, port_cfg, str(path), device="cpu")
    return dict(port=path.read_bytes(), jax=jax, recon=recon, path=path,
                neighbours=neighbours, frames=frames)


def check_setting(name, got, n):
    """The stream (or the encode) carries the case's setting."""
    feats = stream_features(got["path"])
    heads = [h for h in stream_headers(got["path"]) if not h["show_existing"]]
    if name == "tiles":
        assert {f[5:8] for f in feats} == {(64, 2, 2)}, feats
    elif name == "sb64_random_access":
        assert {f[5] for f in feats} == {64}, feats
    elif name == "cvbr":
        q = [f[8] for f in feats]
        assert len(set(q)) > 1, q
        assert all(QUANTIZER_TO_QINDEX[20] <= v <= QUANTIZER_TO_QINDEX[55]
                   for v in q), q
    elif name == "qindex_offsets":
        base = QUANTIZER_TO_QINDEX[40]
        assert feats[0][8] == base - 8
        assert {f[8] for f in feats[1:]} <= {base + o for o in OFFSETS}
        assert len({f[8] for f in feats[1:]}) > 1, feats
    elif name.startswith("mctf"):
        # random access codes a mini-GOP as soon as its pictures arrive:
        # the key frame (coded on arrival) has no neighbour, displays 4 and
        # 8 the ones behind them, altref_nframes // 2 of them
        want = {"mctf_altref3_lad4": [1, 1], "mctf_altref7_lad1": [3, 3],
                "mctf_allintra_lad0": []}[name]
        assert got["neighbours"] == want, got["neighbours"]
    elif name == "hierarchical_levels_0":
        # one picture a mini-GOP: no order hints, every frame shown
        assert all(h["shown"] for h in heads), heads
        assert len(stream_headers(got["path"])) == n
    elif name.startswith("hierarchical_levels"):
        levels = int(name.rsplit("_", 1)[1])
        order = [h["display"] for h in heads]
        assert order[0] == 0 and len(order) == n
        assert order[1] == (1 << levels), order
    elif name == "preset_-2":
        assert all(f[4] for f in feats), feats
    assert len(heads) == n


@pytest.mark.parametrize("name", list(CASES))
def test_setting_stream_byte_identical_and_decoded(name, tmp_path,
                                                   monkeypatch):
    _, _, n, kw = CASES[name]
    got = encode_both(tmp_path, name)
    assert len(got["port"]) == len(got["jax"]), (len(got["port"]),
                                                  len(got["jax"]))
    assert got["port"] == got["jax"]
    decode_both(got["path"], got["recon"], monkeypatch)
    check_setting(name, got, n)
    if name == "preset_-2":
        two = tmp_path / "preset2.ivf"
        api.encode_ivf(got["frames"], configs(dict(kw, enc_mode=2), 2)[0],
                       str(two), device="cpu")
        assert two.read_bytes() == got["port"]

