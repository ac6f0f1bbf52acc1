"""The rest of the encoder's surface on the CPU, each against the JAX
package: two-pass rate control with a scene cut, a caller's decider
(``decider=``), ``get_recon`` and the command-line app
(``python -m svt_av1_tpu_torch.app enc|dec``, ``--device cpu``).

The app's two passes run on a 6-frame 64x64 y4m whose content changes at
frame 3, under random access (``--keyint -1``): pass 1 writes the same
statistics as the JAX app's, pass 2 cuts the mini-GOP there and codes a
key frame at display 3, and its stream is byte-identical to the JAX
app's (its device path); ``dec --md5`` prints the same md5 in both.
"""
import fractions
import pathlib
import tempfile

import numpy as np
import pytest

import jax_refs
from svt_av1_tpu import api as ref_api
from svt_av1_tpu import app as ref_app
from svt_av1_tpu.config import EncoderConfig as RefConfig
from svt_av1_tpu.pipeline.frame_codec import ModeDecider as RefModeDecider
from svt_av1_tpu_torch import api, app
from svt_av1_tpu_torch.config import EncoderConfig
from svt_av1_tpu_torch.io.y4m import VideoInfo, Y4MWriter
from svt_av1_tpu_torch.pipeline import first_pass
from svt_av1_tpu_torch.pipeline.frame_codec import ModeDecider

import chip_smoke
from chip_smoke import stream_headers
from test_e2e import synthetic_clip
from test_torch_presets_7 import decode_both

W, H, N, CUT = 64, 64, 6, 3


def cut_clip():
    """A scene cut at 3 (chip_smoke.cut_clip)."""
    return chip_smoke.cut_clip(W, H, N, CUT)


def test_scene_cut_is_detected_and_cuts_the_mini_gop():
    stats, prev = [], None
    for f in cut_clip():
        stats.append(first_pass.analyze_frame(f[0], prev))
        prev = f[0]
    assert first_pass.detect_scene_changes(stats) == [CUT]
    kw = dict(source_width=W, source_height=H, qp=40,
              intra_period_length=-1, hierarchical_levels=2)
    enc = api.Encoder(EncoderConfig(**kw), two_pass_stats=stats,
                      device="cpu")
    ref = ref_api.Encoder(RefConfig(**kw), two_pass_stats=stats)
    assert enc.pd.scene_changes == ref.pd.scene_changes == {CUT}
    assert enc.rc.weights == ref.rc.weights
    for start in range(N):
        for n in range(1, 5):
            for eos in (False, True):
                got = enc.pd.schedule(start, n, eos)
                want = ref.pd.schedule(start, n, eos)
                assert got[1] == want[1]
                assert [(j.kind, j.display, j.layer, j.is_key, j.show)
                        for j in got[0] or []] == \
                    [(j.kind, j.display, j.layer, j.is_key, j.show)
                     for j in want[0] or []]
    # all-intra ignores the cut: every picture is a key frame already
    ai = api.Encoder(EncoderConfig(**dict(kw, intra_period_length=-2)),
                     two_pass_stats=stats, device="cpu")
    assert ai.pd.scene_changes == set()


def test_get_recon(tmp_path):
    frames = synthetic_clip(W, H, 2, seed=13)
    kw = dict(source_width=W, source_height=H, qp=40, intra_period_length=0)
    enc = api.Encoder(EncoderConfig(**kw), device="cpu")
    enc.send_picture(frames[0])
    with pytest.raises(api.ApiError) as e:
        enc.get_recon(0)
    assert e.value.code == api.ErrorCode.BAD_PARAMETER
    enc = api.Encoder(EncoderConfig(**kw, recon_enabled=True),
                      device="cpu")
    for f in frames:
        enc.send_picture(f)
    with pytest.raises(api.ApiError) as e:
        enc.get_recon(5)
    assert e.value.code == api.ErrorCode.NO_OUTPUT
    enc.flush()
    for d in range(2):
        assert enc.get_recon(d) is enc.recon_by_display[d]


DECIDER_KW = dict(source_width=W, source_height=H, qp=40,
                  intra_period_length=0)


def _decider_case():
    """The JAX device path's stream with a caller's ``ModeDecider``."""
    frames = synthetic_clip(W, H, 2, seed=13)

    def produce():
        with tempfile.TemporaryDirectory() as tmp, \
                pytest.MonkeyPatch.context() as mp:
            mp.setenv("SVT_TPU_DEVICE", "1")
            path = pathlib.Path(tmp) / "jax.ivf"
            ref_api.encode_ivf(frames, RefConfig(**DECIDER_KW), str(path),
                               RefModeDecider())
            return path.read_bytes()

    return dict(frames=frames, cfg=RefConfig(**DECIDER_KW),
                decider="ModeDecider", device="1"), produce


jax_refs.register("surface.callers_decider", _decider_case)


@pytest.mark.slow      # the JAX device path's compile: about 40 s alone
def test_callers_decider_is_used(tmp_path, monkeypatch):
    """``decider=`` replaces the preset's decider in the port as in the
    JAX encoder: the base per-block decider at preset 8, byte-identical
    streams, both Decoders to the recon."""
    frames = synthetic_clip(W, H, 2, seed=13)
    kw = DECIDER_KW
    mine = ModeDecider()
    path = tmp_path / "port.ivf"
    recon = api.encode_ivf(frames, EncoderConfig(**kw), str(path),
                           decider=mine, device="cpu")
    monkeypatch.setenv("SVT_TPU_DEVICE", "1")
    assert path.read_bytes() == jax_refs.reference(
        "surface.callers_decider", frames=frames, cfg=RefConfig(**kw))
    enc = api.Encoder(EncoderConfig(**kw), mine, device="cpu")
    assert enc._decider_cached() is mine
    decode_both(path, recon, monkeypatch)


def _write_cut_y4m(y4m):
    w = Y4MWriter(str(y4m), VideoInfo(W, H, fractions.Fraction(30)))
    for f in cut_clip():
        w.write(f)
    w.close()


TWO_PASS_ARGS = ("-q", "40", "--keyint", "-1")


def _two_passes(main, tmp, name, y4m, extra=()):
    """``main``'s two passes on ``y4m``: (its IVF, its statistics file)."""
    ivf, stats = tmp / f"{name}.ivf", tmp / f"{name}.stats"
    common = ["enc", "-i", str(y4m), "-b", str(ivf), *TWO_PASS_ARGS,
              "--stats", str(stats), *extra]
    assert main(common + ["--pass", "1"]) == 0
    assert main(common + ["--pass", "2"]) == 0
    return ivf, stats


def _two_pass_case():
    """The JAX app's two passes on the cut clip's y4m (its device path)."""
    with tempfile.TemporaryDirectory() as tmp:
        y4m = pathlib.Path(tmp) / "cut.y4m"
        _write_cut_y4m(y4m)
        data = y4m.read_bytes()

    def produce():
        with tempfile.TemporaryDirectory() as tmp, \
                pytest.MonkeyPatch.context() as mp:
            mp.setenv("SVT_TPU_DEVICE", "1")
            tmp = pathlib.Path(tmp)
            (tmp / "cut.y4m").write_bytes(data)
            ivf, stats = _two_passes(ref_app.main, tmp, "jax",
                                     tmp / "cut.y4m")
            return {k: np.frombuffer(p.read_bytes(), np.uint8)
                    for k, p in (("ivf", ivf), ("stats", stats))}

    return dict(y4m=data, args=TWO_PASS_ARGS, device="1"), produce


jax_refs.register("surface.two_pass_app", _two_pass_case)


@pytest.fixture(scope="module")
def two_pass(tmp_path_factory):
    """Both apps' two passes and decodes on the cut clip; returns their
    files and printed lines."""
    tmp = tmp_path_factory.mktemp("app")
    y4m = tmp / "cut.y4m"
    _write_cut_y4m(y4m)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SVT_TPU_DEVICE", "1")
        ivf, stats = _two_passes(app.main, tmp, "port", y4m,
                                 ["--device", "cpu"])
        out["port"] = dict(ivf=ivf, stats=stats)
    got = jax_refs.reference("surface.two_pass_app", y4m=y4m.read_bytes())
    out["jax"] = {k: tmp / f"jax.{k}" for k in ("ivf", "stats")}
    for k, p in out["jax"].items():
        p.write_bytes(got[k].tobytes())
    return out


@pytest.mark.slow      # both apps' two passes take about 110 s alone
def test_two_pass_apps_agree_and_cut_at_the_scene_change(two_pass, capsys):
    port, ref = two_pass["port"], two_pass["jax"]
    assert port["stats"].read_text() == ref["stats"].read_text()
    assert port["ivf"].read_bytes() == ref["ivf"].read_bytes()
    heads = [h for h in stream_headers(port["ivf"])
             if not h["show_existing"]]
    assert sorted(h["display"] for h in heads) == list(range(N))
    keys = sorted(h["display"] for h in heads if h["type"] == 0)
    assert keys == [0, CUT]
    # the app's decoder: the same md5 on the CPU as the JAX app's
    assert app.main(["dec", "-i", str(port["ivf"]), "--md5", "--device",
                     "cpu"]) == 0
    assert ref_app.main(["dec", "-i", str(port["ivf"]), "--md5"]) == 0
    md5s = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("MD5:")]
    assert len(md5s) == 2 and md5s[0] == md5s[1]
