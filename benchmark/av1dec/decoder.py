"""The decoder's entry point: OBU temporal units in, pictures out.  A copy
of ``svt_av1_tpu/api.py``'s ``Dpb`` and ``Decoder`` (its film grain
output, which no benchmark configuration codes, left out)."""
from __future__ import annotations

import numpy as np

from .bitstream.bits import BitReader
from .bitstream.headers import (PRIMARY_REF_NONE, GM_IDENTITY_MAT,
                                FrameHeader, iter_obus, parse_frame_header,
                                parse_sequence_header)
from .constants import FrameType, ObuType
from .entropy.tables import FrameCdfs
from .pipeline.frame_codec import FrameCodec


class Dpb:
    """The 8-slot decoded picture buffer."""

    def __init__(self):
        self.slots = [None] * 8

    def refresh(self, mask: int, planes, order_hint: int, cdfs=None,
                gm=None, qindex: int = 0):
        entry = dict(planes=planes, order_hint=order_hint, cdfs=cdfs,
                     gm=gm, qindex=qindex)
        for i in range(8):
            if mask & (1 << i):
                self.slots[i] = entry

    @staticmethod
    def padded(entry):
        """Border-extended int32 planes for motion compensation, made
        once per picture."""
        if "padded" not in entry:
            entry["padded"] = [FrameCodec._pad_ref(p)
                               for p in entry["planes"]]
        return entry["padded"]


class Decoder:
    """Decode one temporal unit at a time; ``decode_frame`` returns the
    shown picture's (y, u, v) or None, and leaves in ``last`` the picture
    the unit coded or showed, hidden ones too."""

    def __init__(self):
        self.seq = None
        self.dpb = Dpb()
        self.last = None

    def read_sequence_header(self, data: bytes) -> None:
        """Take the sequence header of a temporal unit, so that decoding
        can start at a later key frame."""
        for obu_type, payload in iter_obus(data):
            if obu_type == ObuType.OBU_SEQUENCE_HEADER:
                self.seq = parse_sequence_header(payload)

    def decode_frame(self, data: bytes):
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
                planes = self.last = self._output(slot["planes"])
        return planes

    def _output(self, planes):
        dt = np.uint8 if self.seq.bit_depth == 8 else np.uint16
        return tuple(np.asarray(p).astype(dt) for p in planes)

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
        refs = init_fc = None
        if not is_key:
            refs = {n: Dpb.padded(self.dpb.slots[fh.ref_frame_idx[n - 1]])
                    for n in range(1, 8)}
            if fh.primary_ref_frame != PRIMARY_REF_NONE:
                init_fc = self.dpb.slots[
                    fh.ref_frame_idx[fh.primary_ref_frame]]["cdfs"]
                assert init_fc is not None, "primary ref without CDFs"
        codec = FrameCodec(self.seq, fh, refs=refs, init_fc=init_fc)
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
        if len(rects) > 1:
            assert tile_data[0] == 0, "tile_start_and_end must be 0"
            off, blobs = 1, []
            for _ in range(len(rects) - 1):
                sz = int.from_bytes(
                    tile_data[off:off + fh.tile_size_bytes], "little") + 1
                off += fh.tile_size_bytes
                blobs.append(tile_data[off:off + sz])
                off += sz
            blobs.append(tile_data[off:])
            codec.decode_tiles(blobs)
        else:
            codec.decode_tile(tile_data)
        codec.apply_loop_filter()
        codec.apply_cdef()
        codec.apply_superres()
        codec.apply_lr()
        planes = codec.cropped_recon()
        self.last = self._output(planes)
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
                             fh.order_hint, cdfs=saved_fc, gm=gm_mats,
                             qindex=fh.base_q_idx)
        return self.last if fh.show_frame else None
