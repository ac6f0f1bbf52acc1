"""The default all-intra configuration on the CPU: the JAX CLI's defaults
(RANDOM_ACCESS structure, intra_period_length -2, preset 8, tf_level 2),
where every picture is a key frame that MCTF filters against its buffered
neighbours, through svt_av1_tpu_torch (plain PyTorch versions of the
kernels) against the JAX package's device path (its jitted programs on
the CPU backend).

Both calling styles: ``send_picture``/``flush``, whose one-picture
pipeline keeps the next picture buffered (MCTF sees it), and
``encode_frame``, which codes each picture on arrival (MCTF sees none).
The pictures each encoder held buffered when it filtered a key frame
must be the same, the streams byte-identical, and both Decoders must
turn the stream into the port encoder's recon with equal md5s.
"""
import functools
import types

import numpy as np
import pytest

import jax_refs
from svt_av1_tpu import api as ref_api
from svt_av1_tpu.config import EncoderConfig as RefConfig
from svt_av1_tpu_torch import api
from svt_av1_tpu_torch.config import EncoderConfig
from svt_av1_tpu_torch.io import IvfWriter
from svt_av1_tpu_torch.pipeline import batched_md

from test_interp_filter import moving_clip
from test_torch_presets_7 import decode_both

W, H, N = 64, 64, 4


def _recording(cls):
    """``cls`` with the displays it held buffered at each MCTF call."""

    class Recording(cls):
        def _tf_source(self, job, planes):
            self.seen.append((job.display, tuple(range(
                self._next_display,
                self._next_display + len(self._buffer)))))
            return super()._tf_source(job, planes)

    return Recording


def _encode(enc, frames, style):
    if style == "encode_frame":
        return [enc.encode_frame(f) for f in frames]
    out = []
    for f in frames:
        out += enc.send_picture(f)
    return out + enc.flush()


KW = dict(source_width=W, source_height=H, qp=40)


def _jax_case(style):
    """The JAX device path's packets and the displays its encoder held
    buffered at each MCTF call (tests/jax_refs.py)."""
    frames = moving_clip(W, H, N, seed=9)

    def produce():
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("SVT_TPU_DEVICE", "1")
            ref = _recording(ref_api.Encoder)(RefConfig(**KW))
            ref.seen = []
            pkts = _encode(ref, frames, style)
        return dict(jax_refs.pack_packets(pkts),
                    seen=[(d, b[0] if b else d, len(b)) for d, b in ref.seen])

    return dict(frames=frames, cfg=RefConfig(**KW), style=style,
                device="1"), produce


STYLES = ("send_flush", "encode_frame")
for _style in STYLES:
    jax_refs.register(f"allintra_mctf.{_style}",
                      functools.partial(_jax_case, _style))


def _seen(got):
    """``Recording.seen`` of the entry: (display, the buffered displays)."""
    return [(d, tuple(range(b, b + n))) for d, b, n in
            got["seen"].reshape(-1, 3).tolist()]


# encode_frame's stream is ``slow`` (about 25 s alone); send/flush's, the
# one that pins fault C7, stays in the quick tier
@pytest.fixture(scope="module", params=[
    "send_flush", pytest.param("encode_frame", marks=pytest.mark.slow)])
def streams(request, tmp_path_factory):
    style = request.param
    frames = moving_clip(W, H, N, seed=9)
    got = jax_refs.reference(f"allintra_mctf.{style}", frames=frames,
                             cfg=RefConfig(**KW))
    ref = types.SimpleNamespace(seen=_seen(got))
    ref_pkts = jax_refs.unpack_packets(got)
    port = _recording(api.Encoder)(EncoderConfig(**KW), device="cpu")
    port.seen = []
    pkts = _encode(port, frames, style)
    path = tmp_path_factory.mktemp("ai_mctf") / f"{style}.ivf"
    with IvfWriter(str(path), W, H, port.cfg.frame_rate) as w:
        for i, p in enumerate(pkts):
            w.write_frame(p, pts=i)
    recon = [port.recon_by_display[d] for d in range(N)]
    return dict(style=style, port=pkts, jax=ref_pkts, enc=port, ref=ref,
                path=path, recon=recon)


def test_the_defaults_are_all_intra_with_mctf(streams):
    enc = streams["enc"]
    assert enc.pd.key_interval == 1 and enc.pd.gop > 1
    assert enc.sig.tf_level == 2 and enc.cfg.enc_mode == 8


def test_mctf_sees_the_pictures_the_jax_encoder_buffered(streams):
    seen, ref_seen = streams["enc"].seen, streams["ref"].seen
    assert seen == ref_seen
    assert [d for d, _ in seen] == list(range(N))
    if streams["style"] == "send_flush":
        # the next picture is buffered for every picture but the last
        assert [b for _, b in seen] == [(d, d + 1) for d in range(N - 1)] \
            + [(N - 1,)]
    else:
        assert [b for _, b in seen] == [(d,) for d in range(N)]


def test_stream_byte_identical_to_jax_device_path(streams):
    assert streams["port"] == streams["jax"]


def test_stream_decodes_to_the_recon_with_both_decoders(streams,
                                                        monkeypatch):
    decode_both(streams["path"], streams["recon"], monkeypatch)


def test_prefetched_luma_serves_only_the_source_it_was_made_from():
    """The key-frame prefetch plans the buffered picture; where the frame
    codes another source (MCTF, super-resolution) its maps stand, as in
    the JAX encoder, but the filter searches must not take the prefetched
    upload for the coded source."""
    dec = batched_md.TorchIntraDecider("cpu")
    raw = moving_clip(W, H, 1, seed=9)[0][0]
    for coded, kept in ((raw, True), (raw ^ 1, False),
                        (raw[:, :48], False)):
        dec.prefetch(0, raw, W, H, 100, 8)
        buf = np.zeros((H, W), np.int32)
        buf[:, :coded.shape[1]] = coded
        codec = types.SimpleNamespace(
            fh=types.SimpleNamespace(order_hint=0, base_q_idx=100),
            source=[buf if coded.shape[1] == W else buf[:, :48]])
        maps, dev_y = dec._take_prefetched(codec)
        assert maps and (dev_y is not None) == kept
