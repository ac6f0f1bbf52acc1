"""Public encode API of the port (counterpart of svt_av1_tpu/api.py).

``Encoder(cfg, device=None)`` accepts frames and emits OBU packets; it
runs on CUDA unless the caller asks for another device.  Orchestration
mirrors the reference API at frame granularity: picture decision, DPB
bookkeeping, packetization.  This slice of the port covers all-intra
coding at preset 8, 8-bit: every other configuration raises
NotImplementedError instead of running host code in place of device
programs that are not ported yet.  Decoding stays with the JAX package's
``svt_av1_tpu.api.Decoder``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .bitstream.bits import BitWriter
from .bitstream.headers import (FrameHeader, temporal_delimiter_obu,
                                wrap_obu, write_frame_header,
                                write_sequence_header,
                                write_show_existing_header, SequenceHeader)
from .config import ColorFormat, EncoderConfig, PredStructure, \
    derive_signals
from .constants import FrameType, ObuType
from .device import resolve_device
from .pipeline.frame_codec import FrameCodec


def _assemble_tile_group(blobs: list, fh: FrameHeader) -> bytes:
    """Tile-group payload: with one tile, the raw blob; with more, the
    tile_start_and_end_present_flag(0) + alignment byte, then each tile
    except the last prefixed with tile_size_minus_1 (le tile_size_bytes)
    (spec 5.11.1)."""
    if len(blobs) == 1:
        return blobs[0]
    out = bytearray(b"\x00")
    for b in blobs[:-1]:
        out += (len(b) - 1).to_bytes(fh.tile_size_bytes, "little") + b
    out += blobs[-1]
    return bytes(out)


# --------------------------------------------------------------------------
# Prediction structure (picture decision)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CodeJob:
    """One temporal unit: either code a frame or re-show a coded one."""
    kind: str                  # "code" | "show_existing"
    display: int               # display index (absolute)
    layer: int = 0             # temporal layer (key = 0)
    is_key: bool = False
    show: bool = True
    n_deps: int = -1


class PictureDecision:
    """Buffers source frames and emits jobs.  The ported slice codes
    every picture as a key frame (key interval 1)."""

    def __init__(self, cfg: EncoderConfig):
        self.cfg = cfg
        self.gop = 1 << cfg.hierarchical_levels \
            if cfg.pred_structure == PredStructure.RANDOM_ACCESS else 1
        period = cfg.intra_period_length
        self.key_interval = None
        if period == -2:
            self.key_interval = 1        # all-intra (auto default)
        elif period >= 0:
            self.key_interval = period + 1

    def schedule(self, start: int, n_available: int, eos: bool):
        """Frames [start, start+n_available) are buffered: one key-frame
        job for ``start``."""
        return [CodeJob("code", start, 0, is_key=True)], 1


def check_slice(cfg: EncoderConfig, sig, pd: PictureDecision) -> None:
    """Raise NotImplementedError outside the ported slice."""
    why = None
    if cfg.enc_mode != 8:
        why = f"enc_mode {cfg.enc_mode} (only preset 8 is ported)"
    elif cfg.encoder_bit_depth != 8:
        why = "bit depths other than 8"
    elif cfg.encoder_color_format != ColorFormat.YUV420:
        why = "chroma formats other than 4:2:0"
    elif pd.key_interval != 1:
        why = "inter frames (only all-intra: intra_period_length 0)"
    elif sig.tf_level > 0 and pd.gop > 1:
        why = ("temporal filtering of key frames (MCTF); use "
               "pred_structure=LOW_DELAY_P")
    elif sig.cdef_multi or sig.enable_restoration:
        why = "per-64x64 CDEF presets and loop restoration"
    elif cfg.film_grain_denoise_strength > 0:
        why = "film grain synthesis"
    elif cfg.superres_mode:
        why = "super-resolution"
    if why is not None:
        raise NotImplementedError(f"svt_av1_tpu_torch does not port {why} "
                                  "yet")


# --------------------------------------------------------------------------
# Encoder
# --------------------------------------------------------------------------

class Encoder:
    """Streaming encoder: send_picture() -> ready packets; flush() ends."""

    def __init__(self, cfg: EncoderConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        sig = derive_signals(cfg)
        self.sig = sig
        self.pd = PictureDecision(cfg)
        check_slice(cfg, sig, self.pd)
        from .profiling import LOG, StageTimer
        self.prof = StageTimer()    # per-stage latency (EbTime.c analog)
        LOG.debug("config: %dx%d qp=%d preset=%d device=%s",
                  cfg.source_width, cfg.source_height, cfg.qp,
                  cfg.enc_mode, self.device)
        from .utils.levels import pick_seq_level_idx
        self.seq = SequenceHeader(
            max_frame_width=cfg.source_width,
            max_frame_height=cfg.source_height,
            seq_level_idx=pick_seq_level_idx(
                cfg.source_width, cfg.source_height,
                float(cfg.frame_rate)),
            use_128x128_superblock=cfg.super_block_size == 128,
            seq_tier=cfg.tier,
            force_screen_content_tools=2 if (sig.palette_level
                                             or sig.intrabc_level) else 0,
            bit_depth=cfg.encoder_bit_depth,
            enable_filter_intra=sig.enable_filter_intra,
            enable_warped_motion=sig.enable_warped_motion,
            enable_masked_compound=sig.compound_level >= 2,
            enable_interintra_compound=sig.interintra_level > 0,
            enable_intra_edge_filter=True,
            enable_order_hint=self.pd.gop > 1,
            enable_superres=False,
            enable_cdef=sig.cdef_level > 0 and cfg.qp > 0,
            enable_restoration=False,
            film_grain_params_present=False,
        )
        from .pipeline.rate_control import RateControl
        self.rc = RateControl(cfg, float(cfg.frame_rate), all_intra=True)
        self.rc.hierarchical_levels = max(self.pd.gop.bit_length() - 1, 1)
        self._buffer = []            # pending source frames (display order)
        self._next_display = 0       # display idx of _buffer[0]
        self._sent = 0
        self._wrote_seq_header = False
        self.frame_count = 0         # coded frames
        self.last_recon = None
        self.recon_by_display = {}

    # -- public surface --------------------------------------------------

    def stream_header(self) -> bytes:
        """Standalone sequence-header OBU."""
        return wrap_obu(ObuType.OBU_SEQUENCE_HEADER,
                        write_sequence_header(self.seq))

    def get_stream_info(self) -> dict:
        return dict(width=self.seq.max_frame_width,
                    height=self.seq.max_frame_height,
                    bit_depth=self.seq.bit_depth,
                    seq_level_idx=self.seq.seq_level_idx,
                    tier=0,
                    frames_coded=self.frame_count)

    def send_picture(self, planes) -> list[bytes]:
        self._buffer.append(planes)
        self._sent += 1
        return self._drain(eos=False)

    def _ai_pipeline(self) -> bool:
        """Keep one picture in flight: the device decision pass for the
        newest picture runs on a worker thread while the host packs its
        predecessor (bounded by ``pictures_in_flight``)."""
        if getattr(self, "_pipeline_off", False):
            return False
        pif = self.cfg.pictures_in_flight
        return not (0 <= pif < 2)

    def _buf_dims(self):
        cfg = self.cfg
        mi_c = 2 * ((cfg.source_width + 7) >> 3)
        mi_r = 2 * ((cfg.source_height + 7) >> 3)
        sb = self.seq.sb_size
        return -(-(mi_c * 4) // sb) * sb, -(-(mi_r * 4) // sb) * sb

    def _prefetch(self, display: int, plane) -> None:
        """Submit the device decisions of ``display`` to the worker."""
        dec = self._decider_cached()
        if dec._prefetch and display in dec._prefetch:
            return
        qindex = self.rc.peek_qindex(True, 0, display)
        if qindex is None:
            return
        buf_w, buf_h = self._buf_dims()
        dec.prefetch(display, np.asarray(plane), buf_w, buf_h, qindex,
                     self.cfg.encoder_bit_depth)

    def flush(self) -> list[bytes]:
        return self._drain(eos=True)

    def encode_frame(self, planes) -> bytes:
        """Zero-latency wrapper; disables the one-picture pipeline that
        send/flush runs."""
        self._pipeline_off = True
        try:
            out = self.send_picture(planes)
        finally:
            self._pipeline_off = False
        assert len(out) == 1
        return out[0]

    def perf_report(self) -> dict:
        """Per-stage latency report (see profiling.StageTimer)."""
        return self.prof.report(self.frame_count)

    # -- internals ---------------------------------------------------------

    def _drain(self, eos: bool) -> list[bytes]:
        packets = []
        while self._buffer:
            if not eos and len(self._buffer) == 1 and self._ai_pipeline():
                # kick the device decisions for the deferred picture
                self._prefetch(self._next_display, self._buffer[0][0])
                break
            jobs, consumed = self.pd.schedule(
                self._next_display, len(self._buffer), eos)
            for job in jobs:
                # while the host packs this frame, the device computes the
                # NEXT frame's decision maps on the worker thread
                nxt = job.display + 1 - self._next_display
                if nxt < len(self._buffer):
                    self._prefetch(job.display + 1, self._buffer[nxt][0])
                packets.append(self._encode_display(job))
            self._buffer = self._buffer[consumed:]
            self._next_display += consumed
        return packets

    def _decider_cached(self):
        """One decider per encoder (its state is keyed on the codec
        object, so the prefetch pipeline can hand results forward)."""
        if not hasattr(self, "_decider_obj"):
            from .pipeline.batched_md import TorchIntraDecider

            self._decider_obj = TorchIntraDecider(self.device)
            self._decider_obj.prof = self.prof
        return self._decider_obj

    def _frame_header(self, job: CodeJob) -> FrameHeader:
        from .ops.dlf import filter_levels_from_qindex

        qindex = self.rc.pick_qindex(job.is_key, job.layer, job.display,
                                     (), job.n_deps)
        lvl = 0 if self.cfg.disable_dlf else filter_levels_from_qindex(
            qindex, self.cfg.encoder_bit_depth)
        fh = FrameHeader(
            frame_type=FrameType.KEY_FRAME,
            show_frame=True,
            showable_frame=False,
            order_hint=job.display,
            ref_frame_idx=(0,) * 7,
            frame_width=self.cfg.source_width,
            frame_height=self.cfg.source_height,
            base_q_idx=qindex,
            filter_level=(lvl, lvl),
            filter_level_uv=(lvl, lvl),
            cdef_damping=min(3 + (qindex >> 6), 6),
            tx_mode_select=False,
            is_motion_mode_switchable=False,
            allow_warped_motion=False,
            allow_screen_content_tools=bool(self.sig.palette_level
                                            or self.sig.intrabc_level),
            allow_intrabc=bool(self.sig.intrabc_level),
            disable_frame_end_update_cdf=self.cfg.frame_end_cdf_update
            == 0,
        )
        from .bitstream.headers import tile_limits
        (_, _, min_lc, max_lc, max_lr, min_lt) = tile_limits(self.seq, fh)
        tcl = int(np.clip(self.cfg.tile_columns, min_lc, max_lc))
        trl = int(np.clip(self.cfg.tile_rows, max(min_lt - tcl, 0), max_lr))
        fh.tile_cols_log2 = tcl
        fh.tile_rows_log2 = trl
        return fh

    def _encode_display(self, job: CodeJob) -> bytes:
        if not job.is_key:
            raise NotImplementedError("inter frames are not ported")
        planes = self._buffer[job.display - self._next_display]
        fh = self._frame_header(job)
        fh.refresh_frame_flags = 0xFF
        aq_map = None
        if self.sig.enable_adaptive_quantization and fh.base_q_idx > 40:
            aq_map, fh.seg_qdeltas = _variance_aq(
                np.asarray(planes[0]), self.seq.sb_size, fh.base_q_idx)
        decider = self._decider_cached()
        decider.replay_store = {}
        codec = FrameCodec(self.seq, fh, source_planes=planes,
                           device=self.device)
        # frame-end CDF save reads the LAST tile (context_update_tile_id)
        fh.context_update_tile_id = len(codec.tile_rects()) - 1
        codec.rdoq_level = self.sig.rdoq_level
        # fast presets search the reduced CDEF strength subset
        codec.cdef_fast = self.sig.cdef_level <= 2
        codec.rdoq_layer = (job.layer, self.cfg.hierarchical_levels)
        codec.aq_map = aq_map
        with self.prof("encode_tiles"):
            tile_data = _assemble_tile_group(codec.encode_tiles(decider),
                                             fh)
        from .ops.filter_chain import dlf_cdef_chain
        with self.prof("dlf_cdef"):
            if fh.allow_intrabc:
                # spec forces DLF/CDEF/LR off on intrabc frames
                codec.apply_loop_filter()      # early-returns, saves state
            elif not dlf_cdef_chain(codec):
                codec.apply_loop_filter()
                codec.search_and_apply_cdef()
        codec.apply_superres()
        self.last_recon = codec.cropped_recon()
        self.recon_by_display[job.display] = self.last_recon

        # every frame is a shown key frame that refreshes all slots: no
        # later frame references this one, so no DPB state is kept, and
        # the header needs no reference order hints
        with self.prof("packetize"):
            w = BitWriter()
            write_frame_header(w, self.seq, fh)
            w.byte_align()
            frame_payload = w.bytes() + tile_data

        out = temporal_delimiter_obu()
        if not self._wrote_seq_header:
            out += wrap_obu(ObuType.OBU_SEQUENCE_HEADER,
                            write_sequence_header(self.seq))
            self._wrote_seq_header = True
        out += wrap_obu(ObuType.OBU_FRAME, frame_payload)
        self.rc.update(job.is_key, job.layer, 8 * len(out))
        self.rc.note_coded(job.display, fh.base_q_idx, job.layer,
                           job.is_key)
        self.frame_count += 1
        return out


def encode_ivf(frames, cfg: EncoderConfig, path: str,
               device=None) -> list:
    """Convenience: encode frames to an IVF file; returns recon frames in
    display order."""
    from .io import IvfWriter

    enc = Encoder(cfg, device)
    pts = 0
    with IvfWriter(path, cfg.source_width, cfg.source_height,
                   cfg.frame_rate) as w:
        for planes in frames:
            for payload in enc.send_picture(planes):
                w.write_frame(payload, pts=pts)
                pts += 1
        for payload in enc.flush():
            w.write_frame(payload, pts=pts)
            pts += 1
    return [enc.recon_by_display[d] for d in sorted(enc.recon_by_display)]


def _variance_aq(y_plane: np.ndarray, sb_size: int, base_q: int):
    """Variance-based adaptive quantization: per-superblock source
    variance quantiles map to 4 ALT_Q segments."""
    h, w = y_plane.shape
    rows = (h + sb_size - 1) // sb_size
    cols = (w + sb_size - 1) // sb_size
    pad = np.pad(y_plane.astype(np.float64),
                 ((0, rows * sb_size - h), (0, cols * sb_size - w)),
                 mode="edge")
    blocks = pad.reshape(rows, sb_size, cols, sb_size).transpose(0, 2, 1, 3)
    var = blocks.var(axis=(-1, -2))
    lv = np.log2(var + 1.0)
    qs = np.quantile(lv, [0.25, 0.5, 0.75])
    seg = np.digitize(lv, qs).astype(np.int8)      # 0..3
    # flat areas get finer quantization, textured coarser (masking)
    deltas = [-10, -4, 0, 6]
    deltas = [int(np.clip(d, 1 - base_q, 255 - base_q)) for d in deltas]
    return seg, (deltas[0], deltas[1], deltas[2], deltas[3], 0, 0, 0, 0)
