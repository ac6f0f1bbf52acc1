"""Public API of the port (counterpart of svt_av1_tpu/api.py).

``Encoder(cfg, device=None)`` accepts frames and emits OBU packets;
``Decoder(device=None)`` maps OBU payloads to pictures, and ``encode_ivf``
/ ``decode_ivf`` wrap both around IVF files.  Both run on CUDA unless the
caller asks for another device.  Orchestration mirrors the reference API
at frame granularity: picture decision, DPB bookkeeping, packetization.

The encoder covers preset 8, 8-bit 4:2:0, in three configurations:
all-intra, low-delay P (IPP: one key frame, then P frames predicted from
past pictures) and random access (dyadic mini-GOPs with show_existing
frames, MCTF on key and base-layer pictures, a TPL lookahead per mini-GOP
feeding the qindex ladder, and averaged compound prediction): every other
configuration raises NotImplementedError instead of running host code in
place of device programs that are not ported yet.

The decoder walks the tiles on the host (the conformant walker of
``FrameCodec``) and runs the normative deblocking and CDEF on the device
(the deblocking and CDEF kernels); loop restoration, super-resolution and
film grain run on the host.  Streams with per-64x64 CDEF strength presets
(``cdef_bits > 0``) raise ApiError(UNSUPPORTED_BITSTREAM).
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib

import numpy as np

from .bitstream.bits import BitReader, BitWriter
from .bitstream.headers import (FrameHeader, GM_IDENTITY_MAT,
                                PRIMARY_REF_NONE, SequenceHeader,
                                UnsupportedBitstream, iter_obus,
                                parse_frame_header, parse_sequence_header,
                                temporal_delimiter_obu, wrap_obu,
                                write_frame_header, write_sequence_header,
                                write_show_existing_header)
from .config import ColorFormat, EncoderConfig, PredStructure, \
    RateControlMode, derive_signals
from .constants import FrameType, ObuType
from .device import resolve_device
from .entropy.tables import FrameCdfs
from .pipeline.frame_codec import FrameCodec

LAST, LAST2, LAST3, GOLDEN, BWDREF, ALTREF2, ALTREF = range(1, 8)
# FrameCodec.search_refs' preference order of the named references
_SEARCH_ORDER = (LAST, BWDREF, ALTREF, GOLDEN, LAST2, LAST3, ALTREF2)


class ErrorCode(enum.IntEnum):
    """Library error surface (the EbSvtAv1ErrorCodes.h analog; raised as
    typed exceptions instead of returned codes)."""
    OK = 0
    BAD_PARAMETER = 0x80001005
    NO_OUTPUT = 0x80001006
    DECODE_ERROR = 0x80001010
    UNSUPPORTED_BITSTREAM = 0x80001011


class ApiError(RuntimeError):
    def __init__(self, code: ErrorCode, msg: str):
        super().__init__(f"[{code.name}] {msg}")
        self.code = code


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
    n_deps: int = -1           # frames that will reference this one
    #                            (-1 = unknown; 0 = pure leaf/tail)


def dyadic_order(lo: int, hi: int, layer: int = 1):
    """Coding order of the open interval (lo, hi): mid first, then
    halves."""
    if hi - lo <= 1:
        return []
    m = (lo + hi) // 2
    return [(m, layer)] + dyadic_order(lo, m, layer + 1) + \
        dyadic_order(m, hi, layer + 1)


def gop_schedule(anchor: int, g: int) -> list[CodeJob]:
    """Jobs for one mini-GOP covering displays (anchor, anchor+g]:
    decode order with show_existing interleaved at display time."""
    order = [(anchor + g, 0)] + [(anchor + d, l)
                                 for d, l in dyadic_order(0, g)]
    max_layer = max(l for _, l in order)
    jobs = []
    shown = anchor            # highest display index already output
    coded = set()
    for d, layer in order:
        is_leaf = layer == max_layer
        jobs.append(CodeJob("code", d, layer, show=is_leaf,
                            n_deps=0 if is_leaf and g > 1 else -1))
        coded.add(d)
        if is_leaf:
            assert d == shown + 1, (d, shown)
            shown = d
        while shown + 1 in coded:
            shown += 1
            jobs.append(CodeJob("show_existing", shown))
    return jobs


class PictureDecision:
    """Buffers source frames and emits job lists (the analog of
    picture_decision_kernel's reorder queue + mini-GOP split)."""

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

    def is_key(self, display: int) -> bool:
        if display == 0:
            return True
        return self.key_interval is not None and \
            self.key_interval > 0 and display % self.key_interval == 0

    def schedule(self, start: int, n_available: int, eos: bool):
        """Given frames [start, start+n_available) buffered (display
        order), return (jobs, consumed) or (None, 0) to wait for more."""
        if self.is_key(start):
            return [CodeJob("code", start, 0, is_key=True)], 1
        # GOP span is bounded by the next key frame
        g = self.gop
        if self.key_interval:
            next_key = ((start // self.key_interval) + 1) * self.key_interval
            g = min(g, next_key - start)
        if n_available < g:
            if not eos or n_available <= 0:
                return None, 0
            g = n_available
        # dyadic pyramid needs a power-of-two span; shrink for tails
        while g & (g - 1):
            g -= 1
        return gop_schedule(start - 1, g), g


# --------------------------------------------------------------------------
# DPB (picture manager analog)
# --------------------------------------------------------------------------

class Dpb:
    """8-slot decoded picture buffer of the encoder's decoder model."""

    def __init__(self):
        self.slots = [None] * 8    # {planes, order_hint, display, cdfs,
        #                            gm, qindex}

    def refresh(self, mask: int, planes, order_hint: int, display: int,
                cdfs=None, gm=None, qindex: int = 0):
        entry = dict(planes=planes, order_hint=order_hint, display=display,
                     cdfs=cdfs, gm=gm, qindex=qindex)
        for i in range(8):
            if mask & (1 << i):
                self.slots[i] = entry

    def slot_of_display(self, display: int):
        for i, s in enumerate(self.slots):
            if s is not None and s["display"] == display:
                return i
        return None

    @staticmethod
    def padded(entry):
        """REF_PAD-extended int32 planes for MC, padded once per coded
        picture and memoized in the slot entry."""
        if "padded" not in entry:
            entry["padded"] = [FrameCodec._pad_ref(p)
                               for p in entry["planes"]]
        return entry["padded"]

    def displays(self):
        return {s["display"] for s in self.slots if s is not None}


def _named_ref_displays(display: int, displays: set, anchor: int):
    """Map the 7 named refs to the DPB's display indices ``displays``
    (av1_generate_rps_info analog, simplified: nearest pasts, anchor as
    GOLDEN, futures; with no future picture the backward names alias
    LAST)."""
    avail = sorted(displays)
    past = [d for d in avail if d < display][::-1]
    future = [d for d in avail if d > display]
    if not past:
        past = [avail[0]]
    named = {}
    named[LAST] = past[0]
    named[LAST2] = past[1] if len(past) > 1 else past[0]
    named[LAST3] = past[2] if len(past) > 2 else named[LAST2]
    named[GOLDEN] = anchor if anchor in avail else past[-1]
    if future:
        named[BWDREF] = future[0]
        named[ALTREF2] = future[1] if len(future) > 1 else future[0]
        named[ALTREF] = future[-1]
    else:
        named[BWDREF] = named[ALTREF2] = named[ALTREF] = named[LAST]
    return named


def check_slice(cfg: EncoderConfig, sig, pd: PictureDecision) -> None:
    """Raise NotImplementedError outside the ported slice."""
    why = None
    if cfg.enc_mode != 8:
        why = f"enc_mode {cfg.enc_mode} (only preset 8 is ported)"
    elif cfg.encoder_bit_depth not in (8, 10):
        why = f"bit depth {cfg.encoder_bit_depth} (8 and 10 are ported)"
    elif cfg.encoder_bit_depth == 10 and pd.key_interval != 1 \
            and cfg.pred_structure != PredStructure.LOW_DELAY_P:
        why = ("10-bit inter frames outside low-delay P, such as random "
               "access (all-intra and low-delay P are ported at 10 bits; "
               "the rest needs the 16-bit forms of K9, the compound "
               "search, and K10, TPL's variance, and TPL on uint16 "
               "planes)")
    elif cfg.encoder_color_format != ColorFormat.YUV420:
        why = "chroma formats other than 4:2:0"
    elif sig.tf_level > 0 and pd.gop > 1 and pd.key_interval == 1:
        why = ("temporal filtering of all-intra key frames (MCTF); use "
               "pred_structure=LOW_DELAY_P")
    elif sig.compound_level >= 2:
        why = "masked compound prediction (compound_level 2)"
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
        LOG.debug("config: %dx%d qp=%d preset=%d keyint=%d device=%s",
                  cfg.source_width, cfg.source_height, cfg.qp,
                  cfg.enc_mode, cfg.intra_period_length, self.device)
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
        self.rc = RateControl(cfg, float(cfg.frame_rate),
                              all_intra=self.pd.key_interval == 1)
        self.rc.hierarchical_levels = max(self.pd.gop.bit_length() - 1, 1)
        self._buffer = []            # pending source frames (display order)
        self._me_src = {}            # display -> buf-aligned ME luma on
        #                              the device (open-loop plan refs)
        self._next_display = 0       # display idx of _buffer[0]
        self._tpl_seed = None        # last picture of the previous group
        self._sent = 0
        self.dpb = Dpb()
        self._anchor = 0             # most recent layer-0/key display
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

    def _pipeline(self) -> bool:
        """Keep one picture in flight: while the host codes a picture, the
        device plans the next one on a worker thread (its intra decision
        for a key frame, its open-loop ME plan for a P frame), bounded by
        ``pictures_in_flight``.  Random access holds nothing back: each
        mini-GOP is coded as soon as it is complete, so MCTF and TPL see
        the pictures the JAX encoder gives them (its plans prefetch
        within the mini-GOP)."""
        if getattr(self, "_pipeline_off", False):
            return False
        if self.pd.gop > 1 and self.pd.key_interval != 1:
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
        """Submit the device decisions of key frame ``display`` to the
        worker."""
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
        """Zero-latency wrapper (all-intra / low-delay); disables the
        one-picture pipeline that send/flush runs."""
        if self.pd.gop > 1 and self.pd.key_interval != 1:
            raise ValueError("random-access configurations reorder "
                             "pictures: use send_picture and flush")
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

    def _schedule(self, start: int, n_available: int, eos: bool):
        """pd.schedule with the dependency count of each base frame: the
        group's other frames plus the next group, which references it
        (tail bases at eos get small counts).  A low-delay picture counts
        its dependents as at its arrival: the one-picture pipeline only
        defers it."""
        jobs, consumed = self.pd.schedule(start, n_available, eos)
        if jobs is None:
            return None, 0
        future = self.pd.gop if (not eos or self.pd.gop == 1) \
            else n_available - consumed
        for job in jobs:
            if job.kind == "code" and job.layer == 0 and not job.is_key:
                job.n_deps = consumed - 1 + future
        return jobs, consumed

    def _drain(self, eos: bool) -> list[bytes]:
        packets = []
        while self._buffer:
            if not eos and len(self._buffer) == 1 and self._pipeline():
                if self.pd.is_key(self._next_display):
                    # kick the device decisions for the deferred picture
                    self._prefetch(self._next_display, self._buffer[0][0])
                break
            jobs, consumed = self._schedule(
                self._next_display, len(self._buffer), eos)
            if jobs is None:
                break
            with self.prof("tpl"):
                self._maybe_tpl(consumed)
            for ji, job in enumerate(jobs):
                nxt = next((j for j in jobs[ji + 1:] if j.kind == "code"),
                           None)
                if nxt is None and consumed < len(self._buffer):
                    # the next group's first job, for the plan prefetch
                    more, _ = self._schedule(
                        self._next_display + consumed,
                        len(self._buffer) - consumed, eos)
                    nxt = more[0] if more else None
                if nxt is not None and nxt.is_key \
                        and self.pd.key_interval == 1:
                    # while the host packs this frame, the device computes
                    # the NEXT key frame's decision maps
                    self._prefetch(nxt.display, self._buffer[
                        nxt.display - self._next_display][0])
                packets.append(self._run_job(job, nxt))
            # the last picture of the group seeds the next group's TPL
            self._tpl_seed = self._buffer[consumed - 1]
            self._buffer = self._buffer[consumed:]
            self._next_display += consumed
        return packets

    def _maybe_tpl(self, consumed: int) -> None:
        """TPL lookahead over the scheduled mini-GOP: per-frame r0 from the
        propagated dependency model feeds the kf/gf-boost qindex ladder
        (tpl_mc_flow -> generate_r0beta -> cqp_qindex_calc_tpl_la
        analog; ME statistics on the device, propagation on the host).
        The window is the previous group's last picture, then this
        group's pictures, all as they were buffered."""
        if (not self.cfg.enable_tpl_la
                or self.cfg.rate_control_mode != RateControlMode.CQP
                or self.pd.gop <= 1 or consumed < 2):
            return
        from .pipeline.tpl import tpl_gop_flow

        seed = self._tpl_seed
        window = ([seed] if seed is not None else []) \
            + self._buffer[:consumed]
        displays = list(range(self._next_display - (seed is not None),
                              self._next_display + consumed))
        buf_w, buf_h = self._buf_dims()
        r0s = tpl_gop_flow([np.asarray(f[0]) for f in window], displays,
                           buf_w, buf_h, self.cfg.encoder_bit_depth,
                           self.device, include_first=seed is None)
        self.rc.r0.update(r0s)
        self.rc.tpl_group_size = consumed

    def _decider_cached(self):
        """One decider per encoder (its state is keyed on the codec
        object, so the prefetch pipeline can hand results forward)."""
        if not hasattr(self, "_decider_obj"):
            from .pipeline.batched_md import TorchDecider

            self._decider_obj = TorchDecider(self.device)
            self._decider_obj.prof = self.prof
        return self._decider_obj

    def _me_plane(self, y):
        """Buf-aligned narrow luma plane for open-loop ME, uploaded to the
        encoder's device (the FrameCodec source padding's twin)."""
        from .ops.omd import upload_plane

        buf_w, buf_h = self._buf_dims()
        return upload_plane(np.asarray(y), buf_w, buf_h,
                            self.cfg.encoder_bit_depth, self.device)

    def _store_me_src(self, display: int, plane) -> None:
        if display in self._me_src:
            return
        while len(self._me_src) > 40:
            self._me_src.pop(next(iter(self._me_src)))
        self._me_src[display] = plane

    def _maybe_prefetch_inter(self, job: CodeJob, nxt, fh,
                              planes) -> None:
        """Cross-frame pipeline overlap for inter frames: with open-loop
        ME (plan refs = the coded pictures' SOURCES) the NEXT frame's
        device plan does not depend on this frame's reconstruction, so it
        runs on the worker thread while the host codes this frame.

        Called after this frame's header is final: the post-refresh DPB
        display set, this frame's qindex and its coded source are exact,
        so the prediction matches what _plan_inter derives at retrieval."""
        if nxt is None or nxt.kind != "code" or nxt.is_key:
            return
        if not self.sig.open_loop_me or self.pd.key_interval == 1:
            return
        # the next frame's plan source must be its buffered source, and
        # MCTF filters a base-layer picture when it is coded
        if nxt.layer == 0 and self.sig.tf_level > 0 and self.pd.gop > 1:
            return
        dec = self._decider_cached()
        # this frame's coded source is nxt's likeliest reference
        self._store_me_src(job.display, self._me_plane(planes[0]))
        # exact post-refresh display set (slot replacement = eviction)
        mask = fh.refresh_frame_flags
        displays = set()
        for i, s in enumerate(self.dpb.slots):
            if (mask >> i) & 1:
                displays.add(job.display)
            elif s is not None:
                displays.add(s["display"])
        anchor = job.display if (job.is_key or job.layer == 0) \
            else self._anchor
        if not displays:
            return
        # exact qindex chaining: record this frame's meta now (identical
        # to the note_coded call at the end of this frame)
        self.rc.note_coded(job.display, fh.base_q_idx, job.layer,
                           job.is_key)
        named = _named_ref_displays(nxt.display, displays, anchor)
        # the encoder's codec holds one reference list per name, so
        # FrameCodec.search_refs returns all seven names in its preference
        # order; the planner keeps one name per picture of the first three
        names = dec.plan_names(_SEARCH_ORDER, lambda n: named[n])
        me_refs, ref_disp = {}, []
        for n in names:
            got = self._me_src.get(named[n])
            if got is None:
                return
            me_refs[n] = got
            ref_disp.append(named[n])
        nidx = nxt.display - self._next_display
        if not (0 <= nidx < len(self._buffer)):
            return
        src = self._me_plane(self._buffer[nidx][0])
        rel = tuple(self._rel_dist(named[n], nxt.display) for n in names)
        qindex = self._qindex_for(nxt, (named[LAST], named[BWDREF]))
        ref_sel = any(self._rel_dist(named[n], nxt.display) > 0
                      for n in range(1, 8))
        buf_w, buf_h = self._buf_dims()
        dec.prefetch_inter(nxt.display, src, me_refs, names, rel,
                           tuple(ref_disp), qindex, ref_sel,
                           self.sig.compound_level, buf_w, buf_h,
                           self.cfg.encoder_bit_depth)

    def _run_job(self, job: CodeJob, nxt: CodeJob | None = None) -> bytes:
        if job.kind == "show_existing":
            w = BitWriter()
            write_show_existing_header(w, self.dpb.slot_of_display(
                job.display))
            w.trailing_bits()
            return temporal_delimiter_obu() + wrap_obu(
                ObuType.OBU_FRAME_HEADER, w.bytes())
        return self._encode_display(job, nxt)

    def _qindex_for(self, job: CodeJob, ref_displays: tuple = ()) -> int:
        return self.rc.pick_qindex(job.is_key, job.layer, job.display,
                                   ref_displays, job.n_deps)

    def _frame_header(self, job: CodeJob, refs_idx,
                      ref_displays: tuple = ()) -> FrameHeader:
        from .ops.dlf import filter_levels_from_qindex

        qindex = self._qindex_for(job, ref_displays)
        lvl = 0 if self.cfg.disable_dlf else filter_levels_from_qindex(
            qindex, self.cfg.encoder_bit_depth)
        fh = self._make_frame_header(job, refs_idx, qindex, lvl)
        from .bitstream.headers import tile_limits
        (_, _, min_lc, max_lc, max_lr, min_lt) = tile_limits(self.seq, fh)
        tcl = int(np.clip(self.cfg.tile_columns, min_lc, max_lc))
        trl = int(np.clip(self.cfg.tile_rows, max(min_lt - tcl, 0), max_lr))
        fh.tile_cols_log2 = tcl
        fh.tile_rows_log2 = trl
        return fh

    def _make_frame_header(self, job, refs_idx, qindex, lvl) -> FrameHeader:
        return FrameHeader(
            frame_type=FrameType.KEY_FRAME if job.is_key
            else FrameType.INTER_FRAME,
            show_frame=job.show or job.is_key,
            showable_frame=not (job.show or job.is_key),
            order_hint=job.display,
            ref_frame_idx=refs_idx,
            frame_width=self.cfg.source_width,
            frame_height=self.cfg.source_height,
            base_q_idx=qindex,
            filter_level=(lvl, lvl),
            filter_level_uv=(lvl, lvl),
            cdef_damping=min(3 + (qindex >> 6), 6),
            tx_mode_select=False,
            is_motion_mode_switchable=not job.is_key
            and self.sig.enable_warped_motion,
            allow_warped_motion=not job.is_key
            and self.sig.enable_warped_motion,
            # screen content tools: intra frames only
            allow_screen_content_tools=bool(self.sig.palette_level
                                            or self.sig.intrabc_level)
            and job.is_key,
            allow_intrabc=bool(self.sig.intrabc_level) and job.is_key,
            disable_frame_end_update_cdf=self.cfg.frame_end_cdf_update
            == 0,
        )

    def _refresh_mask(self, job: CodeJob) -> int:
        """Pick a slot for the coded picture: evict one whose picture no
        schedule step still needs (leaves keep nothing)."""
        if job.is_key:
            return 0xFF
        max_layer = self.pd.gop.bit_length() - 1
        if self.pd.gop > 1 and job.layer > max(max_layer - 1, 0):
            return 0                       # leaf: not a reference
        needed = {self._anchor, job.display}
        free = [i for i, s in enumerate(self.dpb.slots) if s is None]
        if free:
            return 1 << free[0]
        order = sorted(range(8), key=lambda i: self.dpb.slots[i]["display"])
        for i in order:
            if self.dpb.slots[i]["display"] not in needed:
                return 1 << i
        return 1 << order[0]

    def _tf_source(self, job: CodeJob, planes):
        """MCTF for key / base-layer pictures of random access: filter the
        source against its buffered neighbours, up to altref_nframes of
        them (mctf_frame analog); ``look_ahead_distance`` bounds the
        future reach.  The motion search runs on the encoder's device."""
        if self.sig.tf_level <= 0 or self.pd.gop <= 1:
            return planes
        if not (job.is_key or job.layer == 0):
            return planes
        from .pipeline.mctf import temporal_filter

        # tf_level 2 = the reference's small-window mode at fast presets
        half = 1 if self.sig.tf_level >= 2 \
            else max((self.cfg.altref_nframes - 1) // 2, 1)
        fwd = half
        lad = self.cfg.look_ahead_distance
        if lad >= 0:
            fwd = min(fwd, lad)
        neighbors = []
        for d in range(job.display - half, job.display + fwd + 1):
            idx = d - self._next_display
            if d == job.display or idx < 0 or idx >= len(self._buffer):
                continue
            neighbors.append(self._buffer[idx])
        if not neighbors:
            return planes
        return temporal_filter(planes, neighbors, self.cfg.qp,
                               self.cfg.encoder_bit_depth, self.device)

    def _encode_display(self, job: CodeJob, nxt: CodeJob | None = None
                        ) -> bytes:
        with self.prof("temporal_filter"):
            planes = self._tf_source(
                job, self._buffer[job.display - self._next_display])
        refs = None
        refs_idx = (0,) * 7
        sign_bias = [0] * 8
        if not job.is_key:
            named = _named_ref_displays(job.display, self.dpb.displays(),
                                        self._anchor)
            refs_idx = tuple(self.dpb.slot_of_display(named[n])
                             for n in range(1, 8))
            by_display = {}
            for n in range(1, 8):
                d = named[n]
                if d not in by_display:
                    by_display[d] = Dpb.padded(self.dpb.slots[
                        self.dpb.slot_of_display(d)])
            refs = {n: by_display[named[n]] for n in range(1, 8)}
            for n in range(1, 8):
                sign_bias[n] = int(self._rel_dist(named[n], job.display) > 0)

        ref_displays = () if job.is_key else (named[LAST], named[BWDREF])
        fh = self._frame_header(job, refs_idx, ref_displays)
        fh.refresh_frame_flags = self._refresh_mask(job)
        init_fc = None
        if not job.is_key and not fh.error_resilient_mode:
            # primary_ref_frame: chain this frame's CDFs from the named ref
            # whose saved state fits best (the quantizer-closest ref)
            best = None
            for n in range(1, 8):
                e = self.dpb.slots[self.dpb.slot_of_display(named[n])]
                if e.get("cdfs") is None:
                    continue
                score = (abs(e["qindex"] - fh.base_q_idx),
                         abs(e["display"] - job.display))
                if best is None or score < best[0]:
                    best = (score, n, e)
            if best is not None:
                fh.primary_ref_frame = best[1] - 1
                init_fc = best[2]["cdfs"]
                fh.prev_gm = best[2]["gm"] or ()
        if not job.is_key:
            # compound prediction once any backward reference exists
            fh.reference_select = any(
                self._rel_dist(named[n], job.display) > 0
                for n in range(1, 8))
        aq_map = None
        if (job.is_key and self.sig.enable_adaptive_quantization
                and fh.base_q_idx > 40):
            aq_map, fh.seg_qdeltas = _variance_aq(
                np.asarray(planes[0]), self.seq.sb_size, fh.base_q_idx)
        decider = self._decider_cached()
        decider.replay_store = {}
        codec = FrameCodec(self.seq, fh, source_planes=planes, refs=refs,
                           init_fc=init_fc, device=self.device)
        # frame-end CDF save reads the LAST tile (context_update_tile_id)
        fh.context_update_tile_id = len(codec.tile_rects()) - 1
        codec.sign_bias = sign_bias
        if not job.is_key:
            codec.ref_dists = {n: self._rel_dist(named[n], job.display)
                               for n in range(1, 8)}
        codec.rdoq_level = self.sig.rdoq_level
        # fast presets search the reduced CDEF strength subset
        codec.cdef_fast = self.sig.cdef_level <= 2
        codec.rdoq_layer = (job.layer, self.cfg.hierarchical_levels)
        codec.obmc_level = self.sig.obmc_level
        codec.compound_level = self.sig.compound_level
        codec.search_area = (
            48 if self.cfg.search_area_width == -1
            else self.cfg.search_area_width,
            48 if self.cfg.search_area_height == -1
            else self.cfg.search_area_height)
        codec.hme_controls = (self.cfg.enable_hme
                              and self.cfg.enable_hme_level0,
                              self.sig.enable_hme_level1,
                              self.sig.enable_hme_level2)
        codec.aq_map = aq_map
        if not job.is_key and self.sig.open_loop_me:
            # open-loop plan refs: the named refs' SOURCE planes (the
            # conformant replay still predicts against recon)
            me_refs = {}
            for n in range(1, 8):
                got = self._me_src.get(named[n])
                if got is None:
                    me_refs = None
                    break
                me_refs[n] = got
            if me_refs is not None:
                codec.me_refs = me_refs
                codec.me_ref_displays = {n: named[n] for n in range(1, 8)}
        if not fh.error_resilient_mode:
            # pipeline overlap: submit the NEXT frame's open-loop device
            # plan before the host starts this frame's coding pass
            self._maybe_prefetch_inter(job, nxt, fh, planes)
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
        if self.sig.open_loop_me and job.display not in self._me_src:
            # this picture's CODED source is the open-loop ME reference
            # of later frames; the planner already uploaded it
            dev = codec.dev_source
            self._store_me_src(
                job.display,
                dev[0] if dev is not None else self._me_plane(planes[0]))

        # header derivations use the decoder's view of the DPB, i.e.
        # BEFORE this frame's refresh
        ref_hints = self._slot_order_hints()
        if fh.refresh_frame_flags:
            ref_planes = [p.astype(np.int32) for p in self.last_recon]
            # SavedCdfs: the adapted end state of the frame's last tile;
            # SavedGmParams: this frame's matrices (identity here)
            gm_mats = tuple(
                (fh.global_motion[i][1] if i < len(fh.global_motion)
                 else GM_IDENTITY_MAT) for i in range(7))
            saved_fc = codec.fc.copy() \
                if not fh.disable_frame_end_update_cdf \
                else (init_fc.copy() if init_fc is not None
                      else FrameCdfs(fh.base_q_idx))
            saved_fc.zero_counters()
            self.dpb.refresh(fh.refresh_frame_flags, ref_planes,
                             job.display, job.display, cdfs=saved_fc,
                             gm=gm_mats, qindex=fh.base_q_idx)
        if job.is_key or job.layer == 0:
            self._anchor = job.display

        with self.prof("packetize"):
            w = BitWriter()
            write_frame_header(w, self.seq, fh, ref_hints)
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

    def _rel_dist(self, a: int, b: int) -> int:
        bits = self.seq.order_hint_bits
        if not self.seq.enable_order_hint:
            return 0
        diff = (a - b) & ((1 << bits) - 1)
        m = 1 << (bits - 1)
        return (diff & (m - 1)) - (diff & m)

    def _slot_order_hints(self):
        mask = (1 << self.seq.order_hint_bits) - 1
        return [0 if s is None else (s["order_hint"] & mask)
                for s in self.dpb.slots]


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


# --------------------------------------------------------------------------
# Decoder
# --------------------------------------------------------------------------

class Decoder:
    """Decoder: OBU payloads -> pictures (display order).  The tile walk
    runs on the host; the normative deblocking and CDEF run on ``device``
    (CUDA unless the caller asks for another device).  ``prof`` times
    the stages ``tile_walk`` and ``filters`` (the device filters, their
    copies included)."""

    def __init__(self, device=None):
        from .profiling import StageTimer

        self.device = resolve_device(device)
        self.seq: SequenceHeader | None = None
        self.md5 = hashlib.md5()
        self.dpb = Dpb()
        self.prof = StageTimer()
        self.frames_decoded = 0

    def get_stream_info(self) -> dict:
        if self.seq is None:
            raise ApiError(ErrorCode.NO_OUTPUT, "no sequence header seen")
        return dict(width=self.seq.max_frame_width,
                    height=self.seq.max_frame_height,
                    bit_depth=self.seq.bit_depth,
                    seq_level_idx=self.seq.seq_level_idx)

    def decode_frame(self, data: bytes):
        """Decode one temporal unit; returns (y, u, v) planes or None.

        Raises ApiError(UNSUPPORTED_BITSTREAM) for legal AV1 features
        outside this decoder's scope, ApiError(DECODE_ERROR) for
        malformed data."""
        try:
            return self._decode_frame(data)
        except ApiError:
            raise
        except UnsupportedBitstream as e:
            raise ApiError(ErrorCode.UNSUPPORTED_BITSTREAM, str(e)) from e
        except (AssertionError, IndexError, ValueError) as e:
            raise ApiError(ErrorCode.DECODE_ERROR, repr(e)) from e

    def _decode_frame(self, data: bytes):
        planes = None
        for obu_type, payload in iter_obus(data):
            if obu_type == ObuType.OBU_TEMPORAL_DELIMITER:
                continue
            if obu_type == ObuType.OBU_SEQUENCE_HEADER:
                self.seq = parse_sequence_header(payload)
            elif obu_type == ObuType.OBU_FRAME:
                planes = self._decode_frame_obu(payload)
            elif obu_type == ObuType.OBU_FRAME_HEADER:
                r = BitReader(payload)
                res = parse_frame_header(r, self.seq, self._hints())
                assert isinstance(res, int), "frame header without tiles"
                slot = self.dpb.slots[res]
                planes = tuple(np.asarray(p) for p in slot["planes"])
                planes = self._output(planes, slot.get("film_grain"))
        return planes

    def _output(self, planes, film_grain=None):
        dt = np.uint8 if self.seq.bit_depth == 8 else np.uint16
        out = tuple(p.astype(dt) for p in planes)
        if film_grain is not None and film_grain.apply_grain:
            from .ops.film_grain import apply_grain
            out = apply_grain(film_grain, out, self.seq.bit_depth)
        for p in out:
            self.md5.update(np.ascontiguousarray(p).tobytes())
        return out

    def _hints(self):
        if self.seq is None or not self.seq.enable_order_hint:
            return (0,) * 8
        mask = (1 << self.seq.order_hint_bits) - 1
        return [0 if s is None else (s["order_hint"] & mask)
                for s in self.dpb.slots]

    def _decode_frame_obu(self, payload: bytes):
        assert self.seq is not None, "no sequence header seen"
        r = BitReader(payload)
        saved_gm = [None if s is None else s.get("gm")
                    for s in self.dpb.slots]
        fh = parse_frame_header(r, self.seq, self._hints(), saved_gm)
        assert isinstance(fh, FrameHeader)
        tile_data = payload[r.byte_pos:]
        is_key = fh.frame_type == FrameType.KEY_FRAME
        refs = None
        init_fc = None
        if not is_key:
            refs = {n: Dpb.padded(self.dpb.slots[fh.ref_frame_idx[n - 1]])
                    for n in range(1, 8)}
            if fh.primary_ref_frame != PRIMARY_REF_NONE:
                slot = self.dpb.slots[
                    fh.ref_frame_idx[fh.primary_ref_frame]]
                init_fc = slot.get("cdfs")
                if init_fc is None:
                    raise ApiError(ErrorCode.UNSUPPORTED_BITSTREAM,
                                   "primary ref without saved CDFs")
        codec = FrameCodec(self.seq, fh, refs=refs, init_fc=init_fc,
                           device=self.device)
        if not is_key and self.seq.enable_order_hint:
            bits = self.seq.order_hint_bits

            def rel(a, b):
                diff = (a - b) & ((1 << bits) - 1)
                m = 1 << (bits - 1)
                return (diff & (m - 1)) - (diff & m)

            for n in range(1, 8):
                ref_oh = self.dpb.slots[fh.ref_frame_idx[n - 1]]["order_hint"]
                codec.sign_bias[n] = int(rel(ref_oh, fh.order_hint) > 0)
        rects = codec.tile_rects()
        with self.prof("tile_walk"):
            if len(rects) > 1:
                # tile group header: tile_start_and_end_present_flag (0)
                # + byte alignment = one zero byte, then sized tiles
                assert tile_data[0] == 0, "tile_start_and_end must be 0"
                off = 1
                blobs = []
                for _ in range(len(rects) - 1):
                    sz = int.from_bytes(
                        tile_data[off:off + fh.tile_size_bytes],
                        "little") + 1
                    off += fh.tile_size_bytes
                    blobs.append(tile_data[off:off + sz])
                    off += sz
                blobs.append(tile_data[off:])
                codec.decode_tiles(blobs)
            else:
                codec.decode_tile(tile_data)
        with self.prof("filters"):
            codec.apply_loop_filter()
            codec.apply_cdef()
        codec.apply_superres()
        codec.apply_lr()
        planes = codec.cropped_recon()
        self.frames_decoded += 1
        mask = 0xFF if is_key and fh.show_frame else fh.refresh_frame_flags
        if mask:
            gm_mats = tuple(
                (fh.global_motion[i][1] if i < len(fh.global_motion)
                 else GM_IDENTITY_MAT) for i in range(7))
            saved_fc = getattr(codec, "saved_fc", None) or codec.fc
            if fh.disable_frame_end_update_cdf:
                saved_fc = init_fc if init_fc is not None \
                    else FrameCdfs(fh.base_q_idx)
            saved_fc = saved_fc.copy()
            saved_fc.zero_counters()
            self.dpb.refresh(mask, [p.astype(np.int32) for p in planes],
                             fh.order_hint, fh.order_hint,
                             cdfs=saved_fc, gm=gm_mats,
                             qindex=fh.base_q_idx)
            for i in range(8):
                if mask & (1 << i):
                    self.dpb.slots[i]["film_grain"] = fh.film_grain
        if fh.show_frame:
            return self._output(planes, fh.film_grain)
        return None


def decode_ivf(path: str, device=None):
    """Decode an IVF file; returns (frames, md5hex) in display order."""
    from .io import IvfReader

    dec = Decoder(device)
    frames = []
    r = IvfReader(path)
    try:
        for payload, _pts in r:
            planes = dec.decode_frame(payload)
            if planes is not None:
                frames.append(planes)
    finally:
        r.close()
    return frames, dec.md5.hexdigest()


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
