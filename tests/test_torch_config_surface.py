"""The encoder's configuration surface, held against the JAX package on
the host (no device program runs, so the file costs seconds).

For each setting the JAX encoder reads (one non-default value of each
field, and the ten preset-8 settings of test_torch_settings.py) at
presets 8, 5, 2 and -2, the port's ``Encoder`` and the JAX ``Encoder``
derive the same signals, build the same decider with the same
arguments, write the same sequence header, schedule the same temporal
units and, job by job, the same frame header (qindex, filter levels,
tile counts, screen-content and IntraBC flags), and start the same rate
controller.  Every configuration the JAX ``validate_config`` refuses
raises ``ConfigError`` in the port with the same message, and the
port's ``Encoder`` refuses it again when a configuration was changed
after it was made.  The VBR and CVBR controllers, driven with the same
coded sizes (made from a seed) under low delay and random access, pick
the same qindex sequence.

The streams of these settings, byte for byte against the JAX device
path, are in test_torch_config_surface_streams.py (``slow``).
"""
import dataclasses
import enum
import pathlib
import tempfile

import numpy as np
import pytest

import jax_refs
from svt_av1_tpu import api as ref_api
from svt_av1_tpu import config as ref_config
from svt_av1_tpu_torch import api
from svt_av1_tpu_torch import config
from svt_av1_tpu_torch.bitstream.headers import QUANTIZER_TO_QINDEX

from chip_smoke import TOOLS_OFF

W, H = 256, 192
LD = dict(intra_period_length=-1,
          pred_structure=config.PredStructure.LOW_DELAY_P)
RA = dict(intra_period_length=-1, hierarchical_levels=2)
VBR = dict(rate_control_mode=config.RateControlMode.VBR,
           target_bit_rate=400_000)
CVBR = dict(rate_control_mode=config.RateControlMode.CVBR,
            target_bit_rate=400_000)

# one case per field and value: the structure it is read under, then the
# setting; (width, height) where the setting is the size
FIELDS = {
    "tile_rows": dict(LD, tile_rows=1),
    "tile_rows_sb64": dict(LD, tile_rows=2, tile_columns=1,
                           super_block_size=64),
    "fixed_qindex_offsets": dict(RA, use_fixed_qindex_offsets=True,
                                 qindex_offsets=(0, 4, 8, 12)),
    "key_frame_qindex_offset": dict(RA, use_fixed_qindex_offsets=True,
                                    qindex_offsets=(0, 4, 8, 12),
                                    key_frame_qindex_offset=-8),
    "fixed_qindex_offsets_empty": dict(RA, use_fixed_qindex_offsets=True,
                                       key_frame_qindex_offset=6),
    "cvbr": dict(LD, **CVBR),
    "cvbr_vbv_bufsize": dict(LD, **CVBR, vbv_bufsize=100_000),
    "cvbr_min_max_qp": dict(RA, **CVBR, min_qp_allowed=20,
                            max_qp_allowed=55),
    "max_qp_allowed": dict(LD, **VBR, max_qp_allowed=45),
    "min_qp_allowed": dict(LD, **VBR, min_qp_allowed=30),
    "under_shoot_pct": dict(LD, **VBR, under_shoot_pct=60),
    "over_shoot_pct": dict(RA, **VBR, over_shoot_pct=5),
    "look_ahead_distance": dict(RA, look_ahead_distance=4),
    "look_ahead_distance_0": dict(RA, look_ahead_distance=0, tf_level=1),
    "altref_nframes": dict(RA, altref_nframes=3, tf_level=1),
    "search_area_width": dict(LD, search_area_width=16),
    "search_area_height": dict(LD, search_area_height=24),
    "enable_hme_level1": dict(LD, enable_hme_level1=0),
    "enable_hme_level2": dict(LD, enable_hme_level2=1),
    "enable_cfl": dict(LD, enable_cfl=1),
    "intra_angle_delta": dict(LD, intra_angle_delta=1),
    "enable_intra_edge_filter": dict(LD, enable_intra_edge_filter=0),
    "filter_intra_level": dict(LD, filter_intra_level=1),
    "palette_level": dict(LD, palette_level=1),
    "intrabc_mode": dict(LD, intrabc_mode=1),
    "inter_intra_compound": dict(RA, inter_intra_compound=0),
    "rdoq_level": dict(LD, rdoq_level=0),
    "enable_mfmv": dict(RA, enable_mfmv=0),
    "frame_end_cdf_update": dict(LD, frame_end_cdf_update=0),
    "pic_based_rate_est": dict(LD, pic_based_rate_est=0),
    "enable_global_motion": dict(LD, enable_global_motion=False),
    "superres_qthres": dict(intra_period_length=0, superres_mode=1,
                            superres_denom=12, superres_qthres=30),
    "tools_off": dict(LD, **TOOLS_OFF),
    "hierarchical_levels_0": dict(intra_period_length=-1,
                                  hierarchical_levels=0),
    "hierarchical_levels_5": dict(intra_period_length=-1,
                                  hierarchical_levels=5),
    # the ten settings of test_torch_settings.py
    "lossless": dict(intra_period_length=0, qp=0),
    "screen_content": dict(intra_period_length=0, screen_content_mode=1),
    "vbr": dict(LD, **VBR),
    "odd_all_intra": dict(intra_period_length=0, size=(130, 98)),
    "odd_ipp": dict(LD, size=(202, 134)),
    "sb64": dict(intra_period_length=0, super_block_size=64),
    "tile_columns": dict(intra_period_length=0, tile_columns=1),
    "adaptive_quantization": dict(intra_period_length=0,
                                  enable_adaptive_quantization=1),
    "warped_obmc": dict(LD, enable_warped_motion=1, obmc_level=1),
    "filters_off": dict(intra_period_length=0, disable_dlf=True,
                        cdef_level=0),
}
PRESETS = (8, 5, 2, -2)
N_FRAMES = 17

# the port's names of the JAX deciders of the device paths
DECIDER_NAMES = {"BatchedDecider": "TorchDecider",
                 "BatchedIntraDecider": "TorchIntraDecider"}


def _ref_value(v):
    """A port enum as the JAX package's enum of the same name."""
    if isinstance(v, enum.Enum):
        return getattr(ref_config, type(v).__name__)[v.name]
    return v


def _settings(kw, preset):
    kw = dict(kw)
    w, h = kw.pop("size", (W, H))
    kw.setdefault("qp", 40)
    kw.setdefault("enc_mode", preset)
    return dict(source_width=w, source_height=h, **kw)


def port_config(kw, preset=8):
    """The port's configuration of ``kw`` at qp 40 unless it names
    another."""
    return config.EncoderConfig(**_settings(kw, preset))


def ref_config_of(kw, preset=8):
    """The JAX package's configuration of the same settings."""
    return ref_config.EncoderConfig(**{
        k: _ref_value(v) for k, v in _settings(kw, preset).items()})


def configs(kw, preset=8):
    """(port config, JAX config) of the same settings."""
    return port_config(kw, preset), ref_config_of(kw, preset)


def plain(obj):
    """A comparable form of an encoder's object: its public fields, enums
    as ints, dataclasses and containers recursed into."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return int(obj.value)
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(plain(v) for v in obj)
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def decider_args(dec):
    """The decider's kind (in the port's names) and its public arguments,
    without the device it runs on."""
    name = type(dec).__name__
    args = {k: v for k, v in vars(dec).items()
            if not k.startswith("_")
            and k not in ("replay_store", "prof", "device", "use_jax")}
    return DECIDER_NAMES.get(name, name), plain(args)


def schedule(enc, n=N_FRAMES):
    """The temporal units the encoder's picture decision emits for ``n``
    buffered frames at the end of the stream."""
    jobs, start = [], 0
    while start < n:
        got, consumed = enc.pd.schedule(start, n - start, True)
        jobs += got
        start += consumed
    return jobs


def rc_state(rc):
    return plain({k: v for k, v in vars(rc).items() if k != "cfg"})


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("field", list(FIELDS))
def test_setting_derives_what_the_jax_encoder_derives(field, preset):
    port_cfg, ref_cfg = configs(FIELDS[field], preset)
    enc = api.Encoder(port_cfg, device="cpu")
    ref = ref_api.Encoder(ref_cfg)
    assert plain(enc.sig) == plain(ref.sig)
    assert decider_args(enc._decider()) == decider_args(ref._decider())
    assert enc.stream_header() == ref.stream_header()
    assert rc_state(enc.rc) == rc_state(ref.rc)
    jobs = schedule(enc)
    assert plain(jobs) == plain(schedule(ref))
    refs_idx = (0,) * 7
    for job in jobs:
        if job.kind == "code":
            got = enc._frame_header(job, refs_idx)
            want = ref._frame_header(job, refs_idx)
            assert plain(got) == plain(want), (field, job)


def test_the_cases_reach_what_they_set():
    """The settings are live where the cases claim: the tile rows, the
    pinned qindex ladder, MCTF's reach and the screen-content flags differ
    from the defaults' at preset 8."""
    def headers(kw):
        enc = api.Encoder(configs(kw)[0], device="cpu")
        return [enc._frame_header(j, (0,) * 7) for j in schedule(enc)
                if j.kind == "code"]

    assert {fh.tile_rows_log2 for fh in headers(FIELDS["tile_rows_sb64"])} \
        == {2}
    assert {fh.tile_rows_log2 for fh in headers(FIELDS["tile_rows"])} \
        == {1}
    q = [fh.base_q_idx for fh in headers(FIELDS["key_frame_qindex_offset"])]
    assert q[0] == QUANTIZER_TO_QINDEX[40] - 8
    assert set(q[1:]) == {QUANTIZER_TO_QINDEX[40] + o for o in (0, 4, 8)}
    sc = headers(FIELDS["screen_content"])
    assert all(fh.allow_screen_content_tools and fh.allow_intrabc
               for fh in sc)
    assert not any(fh.allow_intrabc for fh in headers(FIELDS["sb64"]))


REFUSED = {
    "overlays": dict(enable_overlays=True),
    "cra": dict(intra_refresh_type=1),
    "channels": dict(active_channel_count=2),
    "yuv422": dict(encoder_color_format=config.ColorFormat.YUV422),
    "profile": dict(profile=1),
    "look_ahead_distance_high": dict(look_ahead_distance=121),
    "look_ahead_distance_low": dict(look_ahead_distance=-2),
    "search_area_width": dict(search_area_width=0),
    "search_area_height": dict(search_area_height=257),
    "partition_depth": dict(partition_depth=3),
    "inter_intra_compound": dict(inter_intra_compound=1),
    "enable_mfmv": dict(enable_mfmv=1),
    "pic_based_rate_est": dict(pic_based_rate_est=1),
    "rdoq_level": dict(rdoq_level=2),
    "palette_level": dict(palette_level=2),
    "intrabc_mode": dict(intrabc_mode=2),
    "screen_content_mode": dict(screen_content_mode=2),
    "fixed_offsets_vbr": dict(VBR, use_fixed_qindex_offsets=True),
    "fixed_offsets_range": dict(use_fixed_qindex_offsets=True,
                                qindex_offsets=(0, 256)),
    "key_offset_range": dict(use_fixed_qindex_offsets=True,
                             key_frame_qindex_offset=-256),
    "min_above_max_qp": dict(min_qp_allowed=50, max_qp_allowed=40),
    "superres_inter": dict(intra_period_length=-1, superres_mode=1,
                           superres_denom=12),
    "superres_denom": dict(intra_period_length=0, superres_mode=1,
                           superres_denom=17),
    "tiles": dict(tile_rows=7),
    "odd_width": dict(size=(129, 96)),
    "qp": dict(qp=64),
    "bit_depth": dict(encoder_bit_depth=12),
    "hierarchical_levels": dict(hierarchical_levels=6),
    "vbr_rate": dict(VBR, target_bit_rate=0),
    "preset": dict(enc_mode=9),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_configuration_raises_the_jax_message(name):
    kw = REFUSED[name]
    with pytest.raises(config.ConfigError) as got:
        port_config(kw)
    with pytest.raises(ref_config.ConfigError) as want:
        ref_config_of(kw)
    assert str(got.value) == str(want.value)
    # a configuration changed after it was made: the Encoder checks again
    if "size" not in kw:
        cfg = config.EncoderConfig(source_width=W, source_height=H, qp=40)
        for k, v in kw.items():
            object.__setattr__(cfg, k, v)
        with pytest.raises(config.ConfigError) as again:
            api.Encoder(cfg, device="cpu")
        assert str(again.value) == str(want.value)


# (structure, settings) of the rate-control cases
RC_CASES = {
    "vbr_ld": dict(LD, **VBR),
    "vbr_ra2": dict(RA, **VBR),
    "vbr_ra4": dict(intra_period_length=-1, hierarchical_levels=4, **VBR),
    "vbr_shoot": dict(LD, **VBR, under_shoot_pct=5, over_shoot_pct=60),
    "vbr_qp_range": dict(RA, **VBR, min_qp_allowed=25, max_qp_allowed=45),
    "cvbr_ld": dict(LD, **CVBR),
    "cvbr_vbv": dict(LD, **CVBR, vbv_bufsize=60_000),
    "cvbr_ra2_vbv_qp": dict(RA, **CVBR, vbv_bufsize=150_000,
                            min_qp_allowed=20, max_qp_allowed=55),
    "cvbr_ra4": dict(intra_period_length=-1, hierarchical_levels=4,
                     **CVBR, over_shoot_pct=10),
    "cvbr_ra4_shoot_qp": dict(intra_period_length=-1, hierarchical_levels=4,
                              **CVBR, under_shoot_pct=50, over_shoot_pct=50,
                              min_qp_allowed=10, max_qp_allowed=63),
    "cqp_offsets_ra2": dict(RA, use_fixed_qindex_offsets=True,
                            qindex_offsets=(0, 4, 8, 12),
                            key_frame_qindex_offset=-8),
}


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("case", list(RC_CASES))
def test_rate_control_picks_the_jax_qindex_sequence(case, seed):
    """Both encoders' controllers, fed the same coded sizes (a lognormal
    spread around 0.5-2x the target per frame, made from ``seed``) in the
    encoder's coding order over 33 frames, pick equal qindices."""
    port_cfg, ref_cfg = configs(RC_CASES[case])
    enc = api.Encoder(port_cfg, device="cpu")
    ref = ref_api.Encoder(ref_cfg)
    rng = np.random.default_rng(seed)
    target = port_cfg.target_bit_rate / float(port_cfg.frame_rate)
    scale = rng.uniform(0.5, 2.0)
    got, want = [], []
    for job in schedule(enc, 33):
        if job.kind != "code":
            continue
        bits = int(target * scale * rng.lognormal(0.0, 0.6)
                   * (4 if job.is_key else 1))
        for e, out in ((enc, got), (ref, want)):
            q = e._qindex_for(job)
            out.append(q)
            e.rc.update(job.is_key, job.layer, bits)
            e.rc.note_coded(job.display, q, job.layer, job.is_key)
    assert got == want
    assert rc_state(enc.rc) == rc_state(ref.rc)
    assert len(set(got)) > 1, got
    if case.startswith("cvbr") or case.startswith("vbr"):
        lo = QUANTIZER_TO_QINDEX[port_cfg.min_qp_allowed]
        hi = QUANTIZER_TO_QINDEX[port_cfg.max_qp_allowed]
        assert all(max(lo, 1) <= q <= hi for q in got), got


def test_stream_features_read_the_settings_back(tmp_path):
    """chip_smoke.stream_features and block_tools read the superblock size,
    the tile counts, per-frame base_q_idx, the screen-content, IntraBC,
    adaptive-quantization and CDF-update flags and the palette and IntraBC
    blocks back from streams the port codes on the CPU."""
    from chip_smoke import FEATURES, block_tools, stream_features
    from test_torch_settings import _screen_clip

    def read(kw, frames, name):
        cfg = port_config(kw)
        path = tmp_path / f"{name}.ivf"
        recon = api.encode_ivf(frames, cfg, str(path), device="cpu")
        feats = stream_features(path)
        assert all(len(f) == len(FEATURES) for f in feats)
        return recon, path, [dict(zip(FEATURES, f)) for f in feats]

    kw = dict(intra_period_length=0, super_block_size=64, tile_columns=1,
              tile_rows=1, screen_content_mode=1,
              enable_adaptive_quantization=1,
              size=(128, 128))
    recon, path, feats = read(kw, _screen_clip(128, 128, 1), "screen")
    (f,) = feats
    assert (f["sb"], f["tile_cols"], f["tile_rows"]) == (64, 2, 2)
    assert f["screen_content"] == f["intrabc"] == 1 and f["aq_segments"]
    assert f["qindex"] == QUANTIZER_TO_QINDEX[40]
    tools, shown, _ = block_tools(path)
    assert tools["palette"] + tools["intrabc"] > 0, tools
    assert (shown[0][0] == recon[0][0]).all()

    kw = dict(RA, hierarchical_levels=1, use_fixed_qindex_offsets=True,
              qindex_offsets=(0, 4), key_frame_qindex_offset=-8,
              frame_end_cdf_update=0, size=(64, 64))
    from test_e2e import synthetic_clip
    _, _, feats = read(kw, synthetic_clip(64, 64, 3), "offsets")
    base = QUANTIZER_TO_QINDEX[40]
    assert [f["qindex"] for f in feats] == [base - 8, base, base + 4]
    assert all(f["sb"] == 128 and f["no_cdf_update"] and not f["intrabc"]
               and (f["tile_cols"], f["tile_rows"]) == (1, 1)
               for f in feats)


LOSSLESS = dict(intra_period_length=0, qp=0, size=(64, 64))


def _lossless_case():
    """The JAX host path's qp-0 stream and recon (SVT_TPU_DEVICE=0)."""
    from test_e2e import synthetic_clip

    frames = synthetic_clip(64, 64, 1)
    ref_cfg = configs(LOSSLESS)[1]

    def produce():
        with tempfile.TemporaryDirectory() as tmp, \
                pytest.MonkeyPatch.context() as mp:
            mp.setenv("SVT_TPU_DEVICE", "0")
            path = pathlib.Path(tmp) / "jax.ivf"
            recon = ref_api.encode_ivf(frames, ref_cfg, str(path))
            out = {f"recon{d}_{p}": r[p] for d, r in enumerate(recon)
                   for p in range(3)}
            return dict(out, stream=np.frombuffer(path.read_bytes(),
                                                  np.uint8))

    return dict(frames=frames, cfg=ref_cfg, device="0"), produce


jax_refs.register("config_surface.lossless", _lossless_case)


def test_lossless_stream_follows_the_jax_encoder(tmp_path, monkeypatch):
    """qp 0 (base_q_idx 0, coded lossless): the JAX encoder codes the
    blocks with its lossy transforms, signals no transform type and no
    transform mode, and its recon is not the source; no decoder reads the
    stream back.  The port keeps that stream byte for byte (fault kept
    from the reference, ROADMAP.md section C): the same bytes, the same
    recon, and both Decoders refuse it alike."""
    from test_e2e import synthetic_clip

    frames = synthetic_clip(64, 64, 1)
    port_cfg, ref_cfg = configs(LOSSLESS)
    port_path, ref_path = tmp_path / "port.ivf", tmp_path / "jax.ivf"
    recon = api.encode_ivf(frames, port_cfg, str(port_path), device="cpu")
    monkeypatch.setenv("SVT_TPU_DEVICE", "0")
    entry = jax_refs.reference("config_surface.lossless", frames=frames,
                               cfg=ref_cfg)
    ref_path.write_bytes(entry["stream"].tobytes())
    ref_recon = [tuple(entry[f"recon{d}_{p}"] for p in range(3))
                 for d in range(sum(k.endswith("_0") for k in entry))]
    assert port_path.read_bytes() == ref_path.read_bytes()
    for got, want, src in zip(recon, ref_recon, frames):
        assert all((got[p] == want[p]).all() for p in range(3))
        assert not all((got[p] == src[p]).all() for p in range(3))
    with pytest.raises(TypeError) as port_err:
        api.decode_ivf(str(port_path), device="cpu")
    with pytest.raises(TypeError) as ref_err:
        ref_api.decode_ivf(str(ref_path))
    assert str(port_err.value) == str(ref_err.value)


def test_chip_smoke_codes_the_screen_clip_of_the_settings_tests():
    """chip_smoke.py's screen-content jobs code tests/test_torch_settings.py's
    screen clip (its own copy of the generator)."""
    from chip_smoke import screen_clip
    from test_torch_settings import _screen_clip

    for got, want in zip(screen_clip(64, 48, 2), _screen_clip(64, 48, 2)):
        assert all((g == w).all() for g, w in zip(got, want))
