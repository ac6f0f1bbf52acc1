"""Rate control: picture-level qindex selection and bit-budget tracking.

The analog of the reference's rate_control_kernel
(EbRateControlProcess.c:7175): mode 0 CQP with a per-layer qindex ladder
(cqp path), mode 1/2 VBR/CVBR with a buffer model adapting qindex from
realized vs target bits (the reference uses libaom-style GF-group budgets,
pass2_strategy.c; here a single-pass leaky-bucket controller over
mini-GOPs with per-layer spread).

No bitstream coupling beyond base_q_idx: the controller runs entirely in
the host orchestration layer and consumes packet sizes as feedback, like
the reference's packetization -> RC feedback port (EbEncHandle.c:673).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from pathlib import Path

import numpy as np

from ..bitstream.headers import QUANTIZER_TO_QINDEX
from ..config import EncoderConfig, RateControlMode

# per-layer qindex offsets relative to the picture-type base (VBR path;
# the CQP path derives its ladder from kf/gf boosts below)
KEY_OFFSET = -12
LAYER_OFFSETS = (-8, 8, 14, 18, 22, 24)

# boost operating ranges (EbRateControlProcess.c:5271-5274)
KF_LOW, KF_HIGH = 400, 5000
GF_LOW_TPL, GF_HIGH_TPL = 300, 2400
DEFAULT_KF_BOOST = 2700
DEFAULT_GF_BOOST = 1350
MAX_GFUBOOST_FACTOR = 10.0


@functools.lru_cache(maxsize=1)
def _minq_tables():
    path = Path(__file__).parent / "data" / "rc_tables.npz"
    return dict(np.load(path))


def _minq(name: str, bit_depth: int) -> np.ndarray:
    return _minq_tables()[f"{name}_{10 if bit_depth > 8 else 8}"]


def _convert_qindex_to_q(qindex: int, bit_depth: int) -> float:
    """svt_av1_convert_qindex_to_q: quantizer step in pel units."""
    from ..ops.quant import ac_quant
    shift = {8: 2, 10: 4, 12: 6}[bit_depth]
    return float(ac_quant(int(qindex), 0, bit_depth)) / (1 << shift)


def compute_qdelta(qstart: float, qtarget: float, bit_depth: int) -> int:
    """Smallest qindex delta moving the quantizer step from qstart to
    (at most) qtarget (svt_av1_compute_qdelta)."""
    start_index, target_index = 255, 255
    for i in range(256):
        if _convert_qindex_to_q(i, bit_depth) >= qstart:
            start_index = i
            break
    for i in range(256):
        if _convert_qindex_to_q(i, bit_depth) >= qtarget:
            target_index = i
            break
    return target_index - start_index


def _active_quality(q: int, boost: int, low: int, high: int,
                    low_motion_minq: np.ndarray,
                    high_motion_minq: np.ndarray) -> int:
    """get_active_quality: interpolate the minq curves by boost."""
    if boost > high:
        return int(low_motion_minq[q])
    if boost < low:
        return int(high_motion_minq[q])
    gap = high - low
    offset = high - boost
    qdiff = int(high_motion_minq[q]) - int(low_motion_minq[q])
    adjustment = (offset * qdiff + (gap >> 1)) // gap
    return int(low_motion_minq[q]) + adjustment


def kf_boost_from_r0(r0: float) -> int:
    """get_cqp_kf_boost_from_r0 with frames_to_key unknown (1-pass)."""
    factor = (10.0 + 4.0) / 2
    return int(round(3 * (75.0 + 17.0 * factor) / 2 / max(r0, 1e-6)))


def gfu_boost_from_r0(min_factor: float, r0: float, frame_count: int) -> int:
    """get_gfu_boost_from_r0_lap."""
    factor = math.sqrt(float(frame_count))
    factor = min(max(factor, min_factor), MAX_GFUBOOST_FACTOR)
    return int(round((200.0 + 10.0 * factor) / max(r0, 1e-6)))


# per-layer quantizer-step scale when no TPL stats exist
# (cqp_qindex_calc's delta_rate_new, EbRateControlProcess.c:5760)
DELTA_RATE_NEW = (
    (1.0, 1.0, 1.0, 1.0, 1.0, 1.0),
    (0.6, 1.0, 1.0, 1.0, 1.0, 1.0),
    (0.6, 0.8, 1.0, 1.0, 1.0, 1.0),
    (0.6, 0.8, 0.9, 1.0, 1.0, 1.0),
    (0.35, 0.6, 0.8, 0.9, 1.0, 1.0),
    (0.35, 0.6, 0.8, 0.9, 0.95, 1.0),
)


def _qp_to_qindex(qp: float) -> int:
    qp = float(np.clip(qp, 0, 63))
    lo = int(qp)
    hi = min(lo + 1, 63)
    frac = qp - lo
    v = (1 - frac) * QUANTIZER_TO_QINDEX[lo] + frac * QUANTIZER_TO_QINDEX[hi]
    return int(np.clip(round(v), 1, 255))


@dataclasses.dataclass
class RcState:
    bits_spent: int = 0
    frames_done: int = 0
    qp: float = 32.0               # running operating point (qp domain)


class RateControl:
    """Picture-level rate controller."""

    def __init__(self, cfg: EncoderConfig, fps: float,
                 all_intra: bool = False):
        self.tpl_offsets = {}
        self.r0 = {}                  # display -> TPL r0 (intra/total cost)
        self.frame_meta = {}          # display -> (qindex, layer, is_key)
        self.hierarchical_levels = max(cfg.hierarchical_levels, 1)
        self.tpl_group_size = 16
        self.cfg = cfg
        self.mode = cfg.rate_control_mode
        self.all_intra = all_intra
        self.fps = max(fps, 1e-6)
        self.target_bpf = cfg.target_bit_rate / self.fps
        qp0 = float(cfg.qp if cfg.qp else 40)
        if self.mode != RateControlMode.CQP:
            # seed the operating point from bits-per-pixel (the analog of
            # the reference's active-worst-quality estimate)
            bpp = self.target_bpf / max(cfg.source_width *
                                        cfg.source_height, 1)
            qp0 = 32.5 - 5.0 * np.log2(max(bpp, 1e-4) / 0.1)
            qp0 = float(np.clip(qp0, cfg.min_qp_allowed, cfg.max_qp_allowed))
        self.state = RcState(qp=qp0)
        self.ema_bits = None           # recent realized bits/frame
        self.weights = None            # per-display 2-pass weights
        # leaky-bucket fullness in bits (positive = under budget)
        self.fullness = 0.0
        # CVBR runs a tighter (decoder-buffer) window; vbv_bufsize
        # overrides both (EbRateControlProcess.c buffer semantics)
        if cfg.vbv_bufsize > 0:
            self.buffer_size = cfg.vbv_bufsize
        elif self.mode == RateControlMode.CVBR:
            self.buffer_size = cfg.target_bit_rate // 2
        else:
            self.buffer_size = cfg.target_bit_rate      # ~1s window
        # allowed deviation band before corrective pressure ramps up
        shoot = max(cfg.under_shoot_pct, cfg.over_shoot_pct)
        self.band = max(self.buffer_size * shoot / 100.0, 1.0)

    # -- qindex selection ---------------------------------------------------

    tpl_offsets: dict

    def peek_qindex(self, is_key: bool, layer: int,
                    display: int | None = None):
        """Side-effect-free qindex prediction for pipeline prefetch;
        None when the mode's qindex depends on yet-unknown feedback."""
        if self.mode == RateControlMode.CQP:
            return self.pick_qindex(is_key, layer, display)
        return None

    def note_coded(self, display: int, qindex: int, layer: int,
                   is_key: bool) -> None:
        """Record a coded frame's quantizer for reference-chained qindex
        derivation (the reference's ref_pic_qp_array feedback)."""
        self.frame_meta[display] = (int(qindex), int(layer), bool(is_key))
        for store in (self.frame_meta, self.r0):
            for d in [d for d in store if d < display - 64]:
                del store[d]

    def _pick_qindex_cqp(self, is_key: bool, layer: int,
                         display: int | None,
                         ref_displays: tuple = (),
                         n_deps: int = -1) -> int:
        """cqp_qindex_calc(_tpl_la) analog: kf/gf boosts from the TPL r0
        plus reference-chained internal-ARF qindex
        (EbRateControlProcess.c:5589 / :5734)."""
        base = QUANTIZER_TO_QINDEX[self.cfg.qp]
        if self.cfg.use_fixed_qindex_offsets:
            # user-pinned per-layer ladder: bypass the boost machinery
            # entirely (reference use_fixed_qindex_offsets semantics)
            offs = self.cfg.qindex_offsets
            off = self.cfg.key_frame_qindex_offset if is_key else \
                (offs[min(layer, len(offs) - 1)] if offs else 0)
            return int(np.clip(base + off, 1 if base else 0, 255))
        if base == 0 or self.all_intra:
            return base
        bd = self.cfg.encoder_bit_depth
        levels = max(self.hierarchical_levels, 1)
        r0 = self.r0.get(display) if display is not None else None
        if is_key:
            boost = DEFAULT_KF_BOOST if r0 is None else kf_boost_from_r0(r0)
            if r0 is None:
                abq = _active_quality(base, boost, KF_LOW, KF_HIGH,
                                      _minq("kf_low_motion_minq_cqp", bd),
                                      _minq("kf_high_motion_minq_cqp", bd))
            else:
                abq = _active_quality(base, boost, KF_LOW, KF_HIGH,
                                      _minq("kf_low_motion_minq_cqp", bd),
                                      _minq("kf_high_motion_minq", bd))
            # (a key-boost floor at ~1/3 of the base step was measured
            # BD-negative on LD content: the key's extra quality does
            # feed the whole chain)
            return int(np.clip(abq, 1, base))
        refs = [self.frame_meta[d] for d in ref_displays
                if d in self.frame_meta]
        if layer == 0:
            # a base frame's boost is only worth what leans on it: tail
            # bases with no dependents code at the leaf operating point
            # (the reference's gfu boost scales with the GF group size)
            if n_deps == 0:
                return base
            small_group = 0 <= n_deps < (1 << levels)
            if r0 is None:
                gfu = DEFAULT_GF_BOOST
                if small_group:
                    gfu = int(gfu * math.sqrt((n_deps + 1.0)
                                              / (1 << levels)))
            elif small_group:
                gfu = min(gfu_boost_from_r0(1.0, r0, n_deps + 1),
                          DEFAULT_GF_BOOST * (n_deps + 1) // (1 << levels))
            else:
                group = self.tpl_group_size + (1 << levels)
                gfu = gfu_boost_from_r0(math.sqrt(1 << levels), r0, group)
            abq = _active_quality(base, gfu, GF_LOW_TPL, GF_HIGH_TPL,
                                  _minq("arfgf_low_motion_minq", bd),
                                  _minq("arfgf_high_motion_minq", bd))
            # arf_boost_factor: deepen the boost right after a key frame
            # whose r0 shows the scene got easier to predict
            factor = 1.0
            if refs and refs[0][2] and r0 is not None:
                ref_r0 = self.r0.get(ref_displays[0])
                if ref_r0 is not None and ref_r0 - r0 >= 0.08:
                    factor = 1.3
            min_boost = int(_minq("arfgf_high_motion_minq", bd)[base])
            abq = min_boost - int((min_boost - abq) * factor)
            aworst = (abq + 3 * base + 2) // 4
            return int(np.clip(abq, 1, max(aworst, 1)))
        if layer > 0 and n_deps == 0:
            # non-reference leaves code at the base operating point
            # (cqp_qindex_calc_tpl_la: is_intrl_arf_boost requires
            # is_used_as_reference_flag; otherwise
            # active_best_quality = cq_level)
            return base
        if layer < levels and refs:
            # internal ARF: chain from the references' coded qp, halving
            # toward the base per pyramid level crossed
            arf_q = max(((q >> 2) << 2) + 2 for q, _, _ in refs)
            ref_layer = max(l for _, l, _ in refs)
            abq = arf_q
            for _ in range(max(layer - ref_layer, 0)):
                abq = (abq + base + 1) // 2
            aworst = (abq + 3 * base + 2) // 4
            return int(np.clip(abq, 1, max(aworst, 1)))
        if layer < levels:
            # referenced frame without usable ref feedback (non-TPL
            # path): per-layer quantizer-step compression
            qv = _convert_qindex_to_q(base, bd)
            scale = DELTA_RATE_NEW[min(levels, 5)][min(layer, 5)]
            return int(np.clip(
                base + compute_qdelta(qv, qv * scale, bd), 1, 255))
        return base

    def pick_qindex(self, is_key: bool, layer: int,
                    display: int | None = None,
                    ref_displays: tuple = (),
                    n_deps: int = -1) -> int:
        if self.mode == RateControlMode.CQP:
            return self._pick_qindex_cqp(is_key, layer, display,
                                         ref_displays, n_deps)
        # VBR/CVBR: operating qp adjusted by buffer fullness; the
        # correction stays gentle inside the configured shoot band and
        # ramps up quadratically beyond it (under/over_shoot_pct
        # honored; the reference clamps per-frame deviation similarly)
        qp = self.state.qp
        err = -self.fullness
        band_err = err / self.band
        qp += 5.0 * band_err + 8.0 * np.sign(band_err) * max(
            abs(band_err) - 1.0, 0.0)
        qp = float(np.clip(qp, self.cfg.min_qp_allowed,
                           self.cfg.max_qp_allowed))
        base = _qp_to_qindex(qp)
        off = KEY_OFFSET * 2 if is_key else LAYER_OFFSETS[min(layer, 5)]
        if self.weights is not None and display is not None \
                and display < len(self.weights):
            # 2-pass GOP allocation: easy frames (weight < 1) ride at
            # higher q, hard frames get budget (pass2_strategy.c's
            # GF-group boost shape, folded into the qindex domain)
            off += int(np.clip(round(-10 * np.log2(
                max(self.weights[display], 1e-3))), -24, 24))
        lo = QUANTIZER_TO_QINDEX[self.cfg.min_qp_allowed]
        hi = QUANTIZER_TO_QINDEX[self.cfg.max_qp_allowed]
        return int(np.clip(base + off, max(lo, 1), max(hi, 1)))

    # -- feedback ------------------------------------------------------------

    def update(self, is_key: bool, layer: int, bits: int) -> None:
        if self.mode == RateControlMode.CQP:
            return
        st = self.state
        st.bits_spent += bits
        st.frames_done += 1
        self.fullness += self.target_bpf - bits
        self.fullness = float(np.clip(self.fullness, -self.buffer_size,
                                      self.buffer_size))
        # EMA of realized bits drives a log-ratio trim of the operating
        # point (keyframes/alt-refs intentionally overshoot; the EMA
        # absorbs the spread across a GOP)
        a = 0.3
        self.ema_bits = bits if self.ema_bits is None else \
            (1 - a) * self.ema_bits + a * bits
        ratio = self.ema_bits / max(self.target_bpf, 1.0)
        step = float(np.clip(1.8 * np.log2(max(ratio, 1e-3)), -3.5, 3.5))
        st.qp = float(np.clip(st.qp + step, self.cfg.min_qp_allowed,
                              self.cfg.max_qp_allowed))
