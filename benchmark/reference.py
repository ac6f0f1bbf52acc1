"""The plain reference that decides ``correct``, part one: plain Python
and NumPy.

It imports nothing of the program.  From the packets a channel's encoder
handed out and the reconstructions it reports, it checks what the
configuration states (``guarantees`` in ``configs/<config>.json``):

* the bitstream above the tile data, parsed here from the AV1
  specification (sections 5.3, 5.5 and 5.9): OBU framing and sizes, the
  sequence header against the configured format, and every frame header
  against the configured prediction structure, key frame period,
  quantizer and CDEF;
* each reconstruction against the source picture the benchmark made:
  the worst 64x64 luma block's and the worst frame's mean squared error,
  each under a limit set from readings (``PERF.md``).

Part two, ``decode_check.py``, decodes the tile data of a sample of the
packets with the benchmark's own decoder (``av1dec/``) and holds the
pictures bit-exact against the reconstructions.
"""
from __future__ import annotations

import numpy as np

OBU_SEQUENCE_HEADER, OBU_TEMPORAL_DELIMITER = 1, 2
OBU_FRAME_HEADER, OBU_FRAME = 3, 6
KEY_FRAME, INTER_FRAME, INTRA_ONLY_FRAME, SWITCH_FRAME = 0, 1, 2, 3
PRIMARY_REF_NONE = 7
SEG_FEATURE_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
SEG_FEATURE_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)


class SyntaxFault(ValueError):
    """A bitstream that breaks the AV1 syntax or the stated structure."""


def qindex_of_qp(qp: int) -> int:
    """AOM's quantizer_to_qindex: 4 * qp, and 255 at qp 63."""
    return 255 if qp >= 63 else 4 * qp


class Bits:
    """MSB-first bit reader (the specification's f(n))."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.pos >> 3
            if byte >= len(self.data):
                raise SyntaxFault("read past the end of an OBU")
            v = (v << 1) | ((self.data[byte] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def su(self, n: int) -> int:
        v = self.f(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v


def leb128(data: bytes, pos: int) -> tuple[int, int]:
    value = 0
    for i in range(8):
        if pos >= len(data):
            raise SyntaxFault("leb128 past the end of a packet")
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return value, pos
    raise SyntaxFault("leb128 longer than 8 bytes")


def split_obus(packet: bytes) -> list[tuple[int, bytes]]:
    """[(obu_type, payload)] of a temporal unit; every OBU has its size
    field and the sizes fill the packet exactly."""
    out, pos = [], 0
    while pos < len(packet):
        hdr = packet[pos]
        if hdr & 0x81:
            raise SyntaxFault("forbidden or reserved OBU header bit set")
        obu_type = (hdr >> 3) & 15
        pos += 2 if hdr & 4 else 1
        if not hdr & 2:
            raise SyntaxFault("OBU without obu_size")
        size, pos = leb128(packet, pos)
        if pos + size > len(packet):
            raise SyntaxFault("obu_size past the end of the packet")
        out.append((obu_type, packet[pos:pos + size]))
        pos += size
    return out


def parse_sequence_header(data: bytes) -> dict:
    r = Bits(data)
    s = {"profile": r.f(3), "still_picture": r.f(1)}
    if r.f(1):
        raise SyntaxFault("reduced_still_picture_header in a video stream")
    if r.f(1):
        raise SyntaxFault("timing_info_present: not a stated format")
    if r.f(1):
        raise SyntaxFault("initial_display_delay_present: not stated")
    for i in range(r.f(5) + 1):
        r.f(12)
        level = r.f(5)
        if i == 0:
            s["level"] = level
        if level > 7:
            r.f(1)
    wb, hb = r.f(4) + 1, r.f(4) + 1
    s["width"], s["height"] = r.f(wb) + 1, r.f(hb) + 1
    if r.f(1):
        raise SyntaxFault("frame_id_numbers_present: not stated")
    s["sb128"] = r.f(1)
    s["filter_intra"], s["intra_edge"] = r.f(1), r.f(1)
    s["interintra"], s["masked"], s["warped"] = r.f(1), r.f(1), r.f(1)
    s["dual_filter"] = r.f(1)
    s["order_hint"] = r.f(1)
    s["ref_frame_mvs"] = 0
    if s["order_hint"]:
        s["jnt_comp"] = r.f(1)
        s["ref_frame_mvs"] = r.f(1)
    s["force_sct"] = 2 if r.f(1) else r.f(1)
    s["force_int_mv"] = 2
    if s["force_sct"] > 0:
        s["force_int_mv"] = 2 if r.f(1) else r.f(1)
    s["order_hint_bits"] = r.f(3) + 1 if s["order_hint"] else 0
    s["superres"], s["cdef"], s["restoration"] = r.f(1), r.f(1), r.f(1)
    high = r.f(1)
    s["bit_depth"] = (12 if r.f(1) else 10) if s["profile"] == 2 and high \
        else (10 if high else 8)
    s["mono"] = 0 if s["profile"] == 1 else r.f(1)
    cp = tc = mc = 2
    if r.f(1):
        cp, tc, mc = r.f(8), r.f(8), r.f(8)
    s["subsampling"] = (1, 1)
    s["separate_uv_dq"] = 0
    if s["mono"]:
        r.f(1)
    elif cp == 1 and tc == 13 and mc == 0:
        s["subsampling"] = (0, 0)
    else:
        r.f(1)
        if s["profile"] == 1:
            s["subsampling"] = (0, 0)
        elif s["profile"] == 2:
            if s["bit_depth"] == 12:
                sx = r.f(1)
                s["subsampling"] = (sx, r.f(1) if sx else 0)
            else:
                s["subsampling"] = (1, 0)
        if s["subsampling"] == (1, 1):
            r.f(2)
        s["separate_uv_dq"] = r.f(1)
    s["film_grain"] = r.f(1)
    return s


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


class FrameHeaderReader:
    """The uncompressed header (5.9) of one stream, with the reference
    slots' order hints and frame types it needs across frames."""

    def __init__(self, seq: dict):
        self.seq = seq
        self.ref_hint = [0] * 8
        self.ref_type = [KEY_FRAME] * 8

    def read(self, data: bytes, obu_type: int) -> dict:
        s, r = self.seq, Bits(data)
        fh = {"show_existing": r.f(1)}
        if fh["show_existing"]:
            idx = r.f(3)
            fh.update(slot=idx, frame_type=self.ref_type[idx],
                      order_hint=self.ref_hint[idx], show=1,
                      refresh=0xFF if self.ref_type[idx] == KEY_FRAME else 0)
            if obu_type == OBU_FRAME:
                raise SyntaxFault("show_existing_frame in an OBU_FRAME")
            return fh
        ft = fh["frame_type"] = r.f(2)
        intra = ft in (KEY_FRAME, INTRA_ONLY_FRAME)
        fh["show"] = r.f(1)
        fh["showable"] = ft != KEY_FRAME if fh["show"] else r.f(1)
        er = 1 if ft == SWITCH_FRAME or (ft == KEY_FRAME and fh["show"]) \
            else r.f(1)
        fh["error_resilient"] = er
        fh["disable_cdf_update"] = r.f(1)
        sct = r.f(1) if s["force_sct"] == 2 else s["force_sct"]
        int_mv = 0
        if sct:
            int_mv = r.f(1) if s["force_int_mv"] == 2 else s["force_int_mv"]
        override = 1 if ft == SWITCH_FRAME else r.f(1)
        if override:
            raise SyntaxFault("frame_size_override_flag: size not stated")
        fh["order_hint"] = r.f(s["order_hint_bits"])
        primary = PRIMARY_REF_NONE if intra or er else r.f(3)
        fh["primary_ref_frame"] = primary
        refresh = 0xFF if ft == SWITCH_FRAME or (ft == KEY_FRAME
                                                 and fh["show"]) else r.f(8)
        fh["refresh"] = refresh
        if (not intra or refresh != 0xFF) and er and s["order_hint"]:
            for i in range(8):
                r.f(s["order_hint_bits"])
        fh["refs"] = ()
        if intra:
            self._frame_size(r)
            if sct:
                r.f(1)                     # allow_intrabc
        else:
            if s["order_hint"] and r.f(1):
                raise SyntaxFault("frame_refs_short_signaling: not stated")
            fh["refs"] = tuple(r.f(3) for _ in range(7))
            self._frame_size(r)
            if not int_mv:
                r.f(1)                     # allow_high_precision_mv
            if not r.f(1):                 # is_filter_switchable
                r.f(2)
            r.f(1)                         # is_motion_mode_switchable
            if not er and s["ref_frame_mvs"]:
                r.f(1)
        if not fh["disable_cdf_update"]:
            r.f(1)                         # disable_frame_end_update_cdf
        fh["tiles"] = self._tile_info(r)
        fh["base_q_idx"] = r.f(8)
        deltas = [self._delta_q(r)]
        if not s["mono"]:
            diff = r.f(1) if s["separate_uv_dq"] else 0
            deltas += [self._delta_q(r), self._delta_q(r)]
            if diff:
                deltas += [self._delta_q(r), self._delta_q(r)]
        if r.f(1):                         # using_qmatrix
            r.f(4)
            r.f(4)
            if s["separate_uv_dq"]:
                r.f(4)
        seg_q = self._segmentation(r, primary)
        fh["segmentation"] = seg_q is not None
        if fh["base_q_idx"] > 0 and r.f(1):     # delta_q_present
            r.f(2)
            if r.f(1):                     # delta_lf_present
                r.f(2)
                r.f(1)
        qs = [fh["base_q_idx"] + d for d in (seg_q or [0])]
        lossless = all(q <= 0 for q in qs) and not any(deltas)
        fh["filter_level"] = (0, 0)
        if not lossless:
            fh["filter_level"] = (r.f(6), r.f(6))
            if not s["mono"] and any(fh["filter_level"]):
                r.f(6)
                r.f(6)
            r.f(3)                         # sharpness
            if r.f(1) and r.f(1):          # loop_filter_delta_(enabled, update)
                for n in (8, 2):
                    for _ in range(n):
                        if r.f(1):
                            r.su(7)
        fh["cdef_strengths"] = None
        if not lossless and s["cdef"]:
            r.f(2)                         # cdef_damping_minus_3
            bits = r.f(2)
            fh["cdef_strengths"] = tuple(
                r.f(6 if s["mono"] else 12) for _ in range(1 << bits))
        fh["header_bits"] = r.pos
        if obu_type == OBU_FRAME:
            self._skip_rest(r, fh, lossless)
        return fh

    def refresh(self, fh: dict) -> None:
        for i in range(8):
            if (fh["refresh"] >> i) & 1:
                self.ref_hint[i] = fh["order_hint"]
                self.ref_type[i] = fh["frame_type"]

    def _frame_size(self, r: Bits) -> None:
        if self.seq["superres"] and r.f(1):
            raise SyntaxFault("superres in use: size not stated")
        if r.f(1):                         # render_and_frame_size_different
            raise SyntaxFault("render size differs from the frame size")

    def _tile_info(self, r: Bits) -> int:
        s = self.seq
        mi_cols = 2 * ((s["width"] + 7) >> 3)
        mi_rows = 2 * ((s["height"] + 7) >> 3)
        shift = 5 if s["sb128"] else 4
        sb_cols = (mi_cols + (1 << shift) - 1) >> shift
        sb_rows = (mi_rows + (1 << shift) - 1) >> shift
        sb_log2 = shift + 2
        max_w_sb = 4096 >> sb_log2
        max_area_sb = (4096 * 2304) >> (2 * sb_log2)
        min_lc = _tile_log2(max_w_sb, sb_cols)
        max_lc = _tile_log2(1, min(sb_cols, 64))
        max_lr = _tile_log2(1, min(sb_rows, 64))
        min_lt = max(min_lc, _tile_log2(max_area_sb, sb_rows * sb_cols))
        if not r.f(1):
            raise SyntaxFault("non-uniform tile spacing: not stated")
        lc = min_lc
        while lc < max_lc and r.f(1):
            lc += 1
        tw = (sb_cols + (1 << lc) - 1) >> lc
        cols = -(-sb_cols // tw)
        lr = max(min_lt - lc, 0)
        while lr < max_lr and r.f(1):
            lr += 1
        th = (sb_rows + (1 << lr) - 1) >> lr
        rows = -(-sb_rows // th)
        if lc or lr:
            r.f(lc + lr)                   # context_update_tile_id
            r.f(2)                         # tile_size_bytes_minus_1
        return cols * rows

    @staticmethod
    def _delta_q(r: Bits) -> int:
        return r.su(7) if r.f(1) else 0

    @staticmethod
    def _segmentation(r: Bits, primary: int):
        if not r.f(1):
            return None
        update = 1
        if primary != PRIMARY_REF_NONE:
            if r.f(1):
                r.f(1)
            update = r.f(1)
        q = [0] * 8
        if update:
            for i in range(8):
                for j in range(8):
                    if r.f(1):
                        bits = SEG_FEATURE_BITS[j]
                        v = r.su(1 + bits) if SEG_FEATURE_SIGNED[j] \
                            else r.f(bits)
                        if j == 0:
                            q[i] = v
        return q

    def _skip_rest(self, r, fh, lossless) -> None:
        """Read the rest of the header up to the global motion flags, for
        the tile group's start: lr_params, tx_mode, reference_select,
        skip_mode_present, allow_warped_motion, reduced_tx_set."""
        s, intra = self.seq, fh["frame_type"] in (KEY_FRAME,
                                                  INTRA_ONLY_FRAME)
        if s["restoration"] and not lossless:
            raise SyntaxFault("loop restoration: not stated at this preset")
        if not lossless:
            r.f(1)                         # tx_mode_select
        ref_select = 0 if intra else r.f(1)
        if ref_select and s["order_hint"] and self._skip_mode_allowed(fh):
            r.f(1)
        if not intra and not fh["error_resilient"] and s["warped"]:
            r.f(1)
        r.f(1)                             # reduced_tx_set
        if not intra:
            for _ in range(7):
                if r.f(1):
                    raise SyntaxFault("global motion: not stated at preset 8")
        fh["header_bits"] = r.pos

    def _skip_mode_allowed(self, fh: dict) -> bool:
        bits = self.seq["order_hint_bits"]

        def dist(a, b):
            d = (a - b) & ((1 << bits) - 1)
            m = 1 << (bits - 1)
            return (d & (m - 1)) - (d & m)

        cur = fh["order_hint"]
        fwd = bwd = None
        for idx in fh["refs"]:
            h = self.ref_hint[idx]
            if dist(h, cur) < 0 and (fwd is None or dist(h, fwd) > 0):
                fwd = h
            elif dist(h, cur) > 0 and (bwd is None or dist(h, bwd) < 0):
                bwd = h
        if fwd is None:
            return False
        if bwd is not None:
            return True
        return any(dist(self.ref_hint[i], fwd) < 0 for i in fh["refs"])


def check_stream(packets: list[bytes], guar: dict,
                 units: list | None = None) -> tuple[list, list]:
    """Parse a channel's packets (in output order) and hold them to the
    configuration's guarantees.  Returns (faults, shown): one line per
    fault, and per shown picture (display, bytes of the packets up to and
    including the one that shows it).  ``units``, where given, receives
    per packet parsed the display of the picture it codes or shows and
    whether that is a shown key frame."""
    faults, shown = [], []
    reader, hint_mask = None, 0
    slot_display = [0] * 8
    coded_hidden = set()
    total = 0
    for n, pkt in enumerate(packets):
        total += len(pkt)
        try:
            obus = split_obus(pkt)
            if not obus or obus[0] != (OBU_TEMPORAL_DELIMITER, b""):
                raise SyntaxFault("a packet that does not start with a "
                                  "temporal delimiter")
            frames = 0
            for obu_type, payload in obus[1:]:
                if obu_type == OBU_SEQUENCE_HEADER:
                    if reader is not None:
                        raise SyntaxFault("a second sequence header")
                    seq = parse_sequence_header(payload)
                    faults += _check_seq(seq, guar)
                    reader = FrameHeaderReader(seq)
                    hint_mask = (1 << seq["order_hint_bits"]) - 1
                    continue
                if obu_type not in (OBU_FRAME, OBU_FRAME_HEADER):
                    raise SyntaxFault(f"unexpected OBU type {obu_type}")
                if reader is None:
                    raise SyntaxFault("a frame before the sequence header")
                fh = reader.read(payload, obu_type)
                frames += 1
                display = len(shown)
                if fh["show_existing"]:
                    if slot_display[fh["slot"]] != display \
                            or display not in coded_hidden:
                        raise SyntaxFault(
                            f"show_existing of display "
                            f"{slot_display[fh['slot']]} where display "
                            f"{display} is due")
                    coded_hidden.discard(display)
                    shown.append((display, total))
                    if units is not None:
                        units.append(dict(display=display, key=False))
                    continue
                if fh["show"]:
                    target = display
                    shown.append((display, total))
                else:
                    # a hidden picture is a later display of this GOP
                    ahead = (fh["order_hint"] - display) & hint_mask
                    if not guar["reorder"] or not 0 < ahead < 64:
                        raise SyntaxFault(f"hidden picture of hint "
                                          f"{fh['order_hint']} at display "
                                          f"{display}")
                    target = display + ahead
                    coded_hidden.add(target)
                if fh["order_hint"] != target & hint_mask:
                    raise SyntaxFault(f"order hint {fh['order_hint']} of "
                                      f"display {target}")
                faults += _check_frame(fh, target, guar, slot_display,
                                       payload)
                if units is not None:
                    units.append(dict(display=target, key=bool(
                        fh["frame_type"] == KEY_FRAME and fh["show"])))
                for i in range(8):
                    if (fh["refresh"] >> i) & 1:
                        slot_display[i] = target
                reader.refresh(fh)
            if frames != 1:
                raise SyntaxFault(f"{frames} frames in one temporal unit")
        except SyntaxFault as e:
            faults.append(f"packet {n}: {e}")
            break
    return faults, shown


def _check_seq(seq: dict, guar: dict) -> list:
    want = {"profile": 0, "still_picture": 0, "width": guar["width"],
            "height": guar["height"], "bit_depth": guar["bit_depth"],
            "mono": 0, "subsampling": (1, 1), "sb128": guar["sb128"],
            "superres": 0, "cdef": 1, "restoration": 0, "film_grain": 0}
    if guar["reorder"]:
        want["order_hint"] = 1
    return [f"sequence header {k} {seq[k]}, stated {v}"
            for k, v in want.items() if seq[k] != v]


def _check_frame(fh: dict, display: int, guar: dict, slot_display: list,
                 payload: bytes) -> list:
    out = []
    where = f"display {display}" + ("" if fh["show"] else " (hidden)")
    key_every = guar["key_interval"]
    want_key = display % key_every == 0 if key_every else display == 0
    if (fh["frame_type"] == KEY_FRAME) != want_key:
        out.append(f"{where}: frame type {fh['frame_type']}, key stated "
                   f"{want_key}")
    if fh["frame_type"] not in (KEY_FRAME, INTER_FRAME):
        out.append(f"{where}: frame type {fh['frame_type']}")
    if not guar["reorder"]:
        for idx in set(fh["refs"]):
            if not slot_display[idx] < display:
                out.append(f"{where}: references display "
                           f"{slot_display[idx]}, not an earlier picture")
    q, qcap = fh["base_q_idx"], qindex_of_qp(guar["qp"])
    if not 0 < q <= qcap:
        out.append(f"{where}: base_q_idx {q} outside [1, {qcap}]")
    if fh["refresh"] == 0 and q != qcap:
        out.append(f"{where}: non-reference picture at base_q_idx {q}, "
                   f"stated {qcap}")
    if fh["segmentation"]:
        out.append(f"{where}: segmentation on")
    if fh["cdef_strengths"] is None:
        out.append(f"{where}: no CDEF parameters")
    if fh["tiles"] != 1:
        out.append(f"{where}: {fh['tiles']} tiles, stated 1")
    if len(payload) - ((fh["header_bits"] + 7) >> 3) < 1:
        out.append(f"{where}: empty tile data")
    return out


def block_mse(rec: np.ndarray, src: np.ndarray, blk: int) -> np.ndarray:
    """Mean squared error of every blk x blk block (edge blocks cut to the
    picture), float64 [rows, cols]."""
    d = rec.astype(np.int32) - src.astype(np.int32)
    d = d * d
    h, w = d.shape
    hb, wb = -(-h // blk), -(-w // blk)
    pad = np.zeros((hb * blk, wb * blk), np.int64)
    pad[:h, :w] = d
    cnt = np.zeros_like(pad)
    cnt[:h, :w] = 1
    s = pad.reshape(hb, blk, wb, blk).sum(axis=(1, 3))
    c = cnt.reshape(hb, blk, wb, blk).sum(axis=(1, 3))
    return s / c


def worst_mse(bit_depth: int) -> float:
    """The squared peak: the MSE given a reconstruction of the wrong
    shape, and the reading of a channel that checked none."""
    return float((1 << bit_depth) - 1) ** 2


def psnr(mse: float, bit_depth: int = 8) -> float:
    """Luma PSNR (chip_smoke.py:535's arithmetic, frozen) against the
    peak of ``bit_depth``-bit samples, 100 dB where the pictures are
    equal."""
    return 100.0 if mse == 0 else float(10 * np.log10(
        worst_mse(bit_depth) / mse))


def luma_mse(rec: np.ndarray, src: np.ndarray) -> float:
    return float(np.mean((rec.astype(np.float64)
                          - src.astype(np.float64)) ** 2))


def check_recon(recons: dict, sources, block: int, bit_depth: int) -> dict:
    """Hold each reconstruction {display: (y, u, v)} to its source picture
    ``sources(display)``: per frame the luma MSE, PSNR and worst block, in
    units of ``bit_depth``-bit samples."""
    frames = {}
    for d, rec in sorted(recons.items()):
        src = sources(d)
        if any(a.shape != b.shape for a, b in zip(rec, src)):
            worst = worst_mse(bit_depth)
            frames[d] = dict(mse=worst, block=worst, psnr=0.0)
            continue
        bm = block_mse(rec[0], src[0], block)
        mse = luma_mse(rec[0], src[0])
        cb = max(float(block_mse(r, s, block // 2).max())
                 for r, s in zip(rec[1:], src[1:]))
        frames[d] = dict(mse=mse, block=max(float(bm.max()), cb),
                         psnr=psnr(mse, bit_depth))
    return frames
