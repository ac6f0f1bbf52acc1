"""AV1 quantization / dequantization, batched.

Encoder quantize_b with zbin deadzone (behavioral parity:
svt_aom_quantize_b_c_ii, EbFullLoop.c:37) and the quantizer table
construction (svt_av1_build_quantizer,
EbModeDecisionConfigurationProcess.c:205).  All math fits int32 and is
fully elementwise over [..., H, W] coefficient planes — the reference's
serial scan pre-pass is an optimization with no effect on the result, so
the batched form is exact.

The dequantized coefficients produced here are the normative
reconstruction values (identical to the decoder's dequant for conformant
ranges), so encoder recon == decoder recon.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..constants import TxSize, TX_WIDTH, TX_HEIGHT
from ..entropy.tables import table

AOM_QM_BITS = 5


def tx_log_scale(tx_size: TxSize) -> int:
    """av1_get_tx_scale (EbCoefficients.h:2941): pixel-count based —
    (pels > 256) + (pels > 1024).  NOT max-dim based: TX_8X32 is 0,
    TX_16X64 is 1."""
    pels = TX_WIDTH[tx_size] * TX_HEIGHT[tx_size]
    return int(pels > 256) + int(pels > 1024)


def _qlookup(bit_depth: int, dc: bool) -> np.ndarray:
    kind = "dc" if dc else "ac"
    suffix = {8: "", 10: "_10", 12: "_12"}[bit_depth]
    return table(f"{kind}_qlookup{suffix}_q3").astype(np.int32)


def dc_quant(qindex, delta, bit_depth: int = 8):
    return _qlookup(bit_depth, True)[np.clip(qindex + delta, 0, 255)]


def ac_quant(qindex, delta, bit_depth: int = 8):
    return _qlookup(bit_depth, False)[np.clip(qindex + delta, 0, 255)]


def _invert_quant(d: np.ndarray):
    """Reciprocal encoding: quant such that x*q fixed-point-divides by d
    (parity: invert_quant, EbInvTransforms.c:3556)."""
    l = np.zeros_like(d)
    t = d.copy()
    while np.any(t > 1):
        step = t > 1
        t = np.where(step, t >> 1, t)
        l = np.where(step, l + 1, l)
    m = 1 + (1 << (16 + l)) // d
    quant = (m - (1 << 16)).astype(np.int16)
    shift = (1 << (16 - l)).astype(np.int16)
    return quant, shift


@dataclasses.dataclass(frozen=True)
class PlaneQuant:
    """Per-plane quantizer vectors over all 256 qindex values; column 0 is
    the DC entry, column 1 the AC entry."""

    zbin: np.ndarray          # [256, 2] int16
    round: np.ndarray         # [256, 2] int16
    quant: np.ndarray         # [256, 2] int16 (reciprocal low part)
    quant_shift: np.ndarray   # [256, 2] int16
    quant_fp: np.ndarray      # [256, 2] int16
    round_fp: np.ndarray      # [256, 2] int16
    dequant: np.ndarray       # [256, 2] int16 (qtx scale)


@functools.cache
def build_quantizer(bit_depth: int = 8, y_dc_delta_q: int = 0,
                    u_dc_delta_q: int = 0, u_ac_delta_q: int = 0,
                    v_dc_delta_q: int = 0, v_ac_delta_q: int = 0
                    ) -> tuple[PlaneQuant, PlaneQuant, PlaneQuant]:
    """Returns (y, u, v) PlaneQuant tables."""
    q = np.arange(256)
    dc_q3 = dc_quant(q, 0, bit_depth)
    zbin_thresh = {8: 148, 10: 592, 12: 2368}[bit_depth]
    qzbin_factor = np.where(q == 0, 64, np.where(dc_q3 < zbin_thresh, 84, 80))
    qrounding_factor = np.where(q == 0, 64, 48)

    def plane(dc_delta, ac_delta) -> PlaneQuant:
        dcq = dc_quant(q, dc_delta, bit_depth)
        acq = ac_quant(q, ac_delta, bit_depth)
        qtx = np.stack([dcq, acq], axis=1)                  # [256, 2]
        quant, shift = _invert_quant(qtx.astype(np.int64))
        return PlaneQuant(
            zbin=((qzbin_factor[:, None] * qtx + 64) >> 7).astype(np.int16),
            round=((qrounding_factor[:, None] * qtx) >> 7).astype(np.int16),
            quant=quant,
            quant_shift=shift,
            quant_fp=((1 << 16) // qtx).astype(np.int16),
            round_fp=((64 * qtx) >> 7).astype(np.int16),
            dequant=qtx.astype(np.int16),
        )

    return (plane(y_dc_delta_q, 0),
            plane(u_dc_delta_q, u_ac_delta_q),
            plane(v_dc_delta_q, v_ac_delta_q))


def _round_pow2(x, n):
    return (x + (1 << (n - 1))) >> n if n > 0 else x


@functools.lru_cache(maxsize=512)
def _qparams_cached(pq_id: int, qindex: int, tx_size: TxSize):
    """Broadcast dc/ac quantizer maps for one (plane-tables, q, size)."""
    pq = _PQ_REGISTRY[pq_id]
    log_scale = tx_log_scale(tx_size)
    h, w = TX_HEIGHT[tx_size], TX_WIDTH[tx_size]
    dc_mask = np.zeros((h, w), dtype=bool)
    dc_mask[0, 0] = True

    def dcac(vec):
        return np.where(dc_mask, np.int32(vec[0]), np.int32(vec[1]))

    return (_round_pow2(dcac(pq.zbin[qindex]), log_scale),
            _round_pow2(dcac(pq.round[qindex]), log_scale),
            dcac(pq.quant[qindex]), dcac(pq.quant_shift[qindex]),
            dcac(pq.dequant[qindex]), log_scale)


_PQ_REGISTRY: dict[int, "PlaneQuant"] = {}


def quantize_b(coeffs, qindex: int, pq: PlaneQuant, tx_size: TxSize, xp=np):
    """Quantize a [..., H, W] coefficient plane.

    Returns (qcoeff, dqcoeff) int32 arrays of the same shape.  The eob is
    derived later from the scan order by the coefficient coder.
    """
    _PQ_REGISTRY.setdefault(id(pq), pq)
    zbin, rnd, quant, shift, dequant, log_scale = _qparams_cached(
        id(pq), qindex, tx_size)
    if xp is not np:
        zbin, rnd, quant, shift, dequant = (
            xp.asarray(zbin), xp.asarray(rnd), xp.asarray(quant),
            xp.asarray(shift), xp.asarray(dequant))

    c = coeffs.astype(xp.int32)
    sign = xp.where(c < 0, -1, 1).astype(xp.int32)
    ac = xp.abs(c)
    live = ac >= zbin
    h, w = TX_HEIGHT[tx_size], TX_WIDTH[tx_size]
    if h > 32 or w > 32:
        # 64-dim transforms code only the top-left 32x32 coefficients
        # (av1_get_max_eob = 1024; the scan never visits the rest)
        keep = np.zeros((h, w), dtype=bool)
        keep[:32, :32] = True
        live = live & (xp.asarray(keep) if xp is not np else keep)
    tmp = xp.clip(ac + rnd, -32768, 32767)
    tmp32 = ((((tmp * quant) >> 16) + tmp) * shift) >> (16 - log_scale)
    qc = xp.where(live, sign * tmp32, 0).astype(xp.int32)
    dqc = xp.where(live, sign * ((tmp32 * dequant) >> log_scale), 0).astype(xp.int32)
    return qc, dqc


def dequant_block(qcoeff, qindex: int, pq: PlaneQuant, tx_size: TxSize, xp=np):
    """Normative dequantization of decoded levels (decoder path; parity:
    EbDecInverseQuantize.c inverse_quantize)."""
    log_scale = tx_log_scale(tx_size)
    h, w = TX_HEIGHT[tx_size], TX_WIDTH[tx_size]
    dc_mask = np.zeros((h, w), dtype=bool)
    dc_mask[0, 0] = True
    dequant = xp.where(dc_mask, int(pq.dequant[qindex][0]), int(pq.dequant[qindex][1]))
    q = qcoeff.astype(xp.int32)
    sign = xp.where(q < 0, -1, 1).astype(xp.int32)
    lvl = xp.abs(q)
    dq = (lvl * dequant) & 0xFFFFFF
    return (sign * (dq >> log_scale)).astype(xp.int32)


def quantize_fp(coeffs, qindex: int, pq: PlaneQuant, tx_size: TxSize,
                xp=np):
    """Fast-path quantizer (svt_av1_quantize_fp_c / quantize_fp_helper_c,
    EbFullLoop.c:314): no zbin dead-zone, fp round/quant tables.  The
    reference's speed presets use this in MD; same [..., H, W] batched
    layout as quantize_b."""
    log_scale = tx_log_scale(tx_size)
    h, w = TX_HEIGHT[tx_size], TX_WIDTH[tx_size]
    dc_mask = np.zeros((h, w), dtype=bool)
    dc_mask[0, 0] = True

    def dcac(vec):
        return np.where(dc_mask, np.int32(vec[0]), np.int32(vec[1]))

    quant = dcac(pq.quant_fp[qindex])
    rnd = _round_pow2(dcac(pq.round_fp[qindex]), log_scale)
    dequant = dcac(pq.dequant[qindex])
    if xp is not np:
        quant, rnd, dequant = (xp.asarray(quant), xp.asarray(rnd),
                               xp.asarray(dequant))

    c = coeffs.astype(xp.int32)
    sign = xp.where(c < 0, -1, 1).astype(xp.int32)
    ac = xp.abs(c)
    live = (ac << (1 + log_scale)) >= dequant
    if h > 32 or w > 32:
        keep = np.zeros((h, w), dtype=bool)
        keep[:32, :32] = True
        live = live & (xp.asarray(keep) if xp is not np else keep)
    acr = xp.clip(ac + rnd, -32768, 32767)
    tmp32 = (acr * quant) >> (16 - log_scale)
    qc = xp.where(live, sign * tmp32, 0).astype(xp.int32)
    dqc = xp.where(live & (tmp32 != 0),
                   sign * ((tmp32 * dequant) >> log_scale),
                   0).astype(xp.int32)
    return qc, dqc
