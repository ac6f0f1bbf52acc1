"""AV1 integer transforms, batched for TPU.

Bit-exact forward/inverse 2-D transforms (DCT/ADST/FLIPADST/IDTX over all
19 tx sizes).  The butterfly networks are *data* (ops/data/txfm_stages.npz,
extracted by tools/extract_txfm_stages.py from the spec-mandated integer
networks); this module is a vectorized interpreter over those stage
tables, operating on arrays shaped [..., H, W] — the batch dimensions map
naturally onto TPU lanes, one transform per (block) row.

Everything is int32 with C wraparound semantics, matching the reference
scalar code (behavioral parity: EbTransforms.c av1_tranform_two_d_core_c,
EbInvTransforms.c inv_txfm2d_add_c) for all conformant value ranges.  The
same code executes under numpy (host reference/tests) and jax.numpy
(jit/TPU) — pass ``xp=jnp`` or ``xp=np``.
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

from ..constants import TxSize, TxType, TX_WIDTH, TX_HEIGHT

_DATA = Path(__file__).parent / "data" / "txfm_stages.npz"

NEW_SQRT2_BITS = 12
NEW_SQRT2 = 5793      # 2^12 * sqrt(2)
NEW_INV_SQRT2 = 2896  # 2^12 / sqrt(2)

# 1-D transform kinds
DCT, ADST, FLIPADST, IDTX = 0, 1, 2, 3

_VTX = [DCT, ADST, DCT, ADST, FLIPADST, DCT, FLIPADST, ADST, FLIPADST,
        IDTX, DCT, IDTX, ADST, IDTX, FLIPADST, IDTX]
_HTX = [DCT, DCT, ADST, ADST, DCT, FLIPADST, FLIPADST, FLIPADST, ADST,
        IDTX, IDTX, DCT, IDTX, ADST, IDTX, FLIPADST]

# Per-size shift triples/pairs (reference: fwd_shift_* EbTransforms.h:26-44,
# inv_shift_* EbInvTransforms.h:51-70), indexed by TxSize.
_FWD_SHIFT = {
    TxSize.TX_4X4: (2, 0, 0), TxSize.TX_8X8: (2, -1, 0),
    TxSize.TX_16X16: (2, -2, 0), TxSize.TX_32X32: (2, -4, 0),
    TxSize.TX_64X64: (0, -2, -2), TxSize.TX_4X8: (2, -1, 0),
    TxSize.TX_8X4: (2, -1, 0), TxSize.TX_8X16: (2, -2, 0),
    TxSize.TX_16X8: (2, -2, 0), TxSize.TX_16X32: (2, -4, 0),
    TxSize.TX_32X16: (2, -4, 0), TxSize.TX_32X64: (0, -2, -2),
    TxSize.TX_64X32: (2, -4, -2), TxSize.TX_4X16: (2, -1, 0),
    TxSize.TX_16X4: (2, -1, 0), TxSize.TX_8X32: (2, -2, 0),
    TxSize.TX_32X8: (2, -2, 0), TxSize.TX_16X64: (0, -2, 0),
    TxSize.TX_64X16: (2, -4, 0),
}
_INV_SHIFT = {
    TxSize.TX_4X4: (0, -4), TxSize.TX_8X8: (-1, -4),
    TxSize.TX_16X16: (-2, -4), TxSize.TX_32X32: (-2, -4),
    TxSize.TX_64X64: (-2, -4), TxSize.TX_4X8: (0, -4),
    TxSize.TX_8X4: (0, -4), TxSize.TX_8X16: (-1, -4),
    TxSize.TX_16X8: (-1, -4), TxSize.TX_16X32: (-1, -4),
    TxSize.TX_32X16: (-1, -4), TxSize.TX_32X64: (-1, -4),
    TxSize.TX_64X32: (-1, -4), TxSize.TX_4X16: (-1, -4),
    TxSize.TX_16X4: (-1, -4), TxSize.TX_8X32: (-2, -4),
    TxSize.TX_32X8: (-2, -4), TxSize.TX_16X64: (-2, -4),
    TxSize.TX_64X16: (-2, -4),
}
# fwd cos bits [txw_idx][txh_idx] (EbTransforms.h:46-57); inverse is 12.
_FWD_COS_BIT_COL = [
    [13, 13, 13, 0, 0], [13, 13, 13, 12, 0], [13, 13, 13, 12, 13],
    [0, 13, 13, 12, 13], [0, 0, 13, 12, 13]]
_FWD_COS_BIT_ROW = [
    [13, 13, 12, 0, 0], [13, 13, 13, 12, 0], [13, 13, 12, 13, 12],
    [0, 12, 13, 12, 11], [0, 0, 12, 11, 10]]
INV_COS_BIT = 12


@functools.cache
def _tables() -> dict[str, np.ndarray]:
    with np.load(_DATA) as z:
        return {k: z[k] for k in z.files}


@functools.cache
def _cospi(bit: int) -> np.ndarray:
    return _tables()["cospi_arr_data"][bit - 10]


@functools.cache
def _sinpi(bit: int) -> np.ndarray:
    return _tables()["sinpi_arr_data"][bit - 10]


from ..kernels.build import load_c_extension

_tx_native = load_c_extension("tx_native")


class _Network:
    """Vectorized interpreter for one extracted butterfly network."""

    def __init__(self, name: str):
        t = _tables()
        stmts = t[f"{name}_stmts"]          # [n, 5]
        offs = t[f"{name}_offsets"]
        clamp = t[f"{name}_clamp"]
        self._stmts = np.ascontiguousarray(stmts, dtype=np.int32)
        self._offsets = np.ascontiguousarray(offs, dtype=np.int32)
        self._clamp_flat = np.ascontiguousarray(clamp, dtype=np.int8)
        self.stages = []
        for s in range(len(offs) - 1):
            rows = stmts[offs[s]:offs[s + 1]]
            crow = clamp[offs[s]:offs[s + 1]].astype(bool)
            self.stages.append((rows, crow))

    @functools.cache
    def _stage_consts(self, cos_bit: int):
        """Precompute per-stage constant vectors for a given cos_bit."""
        cospi = _cospi(cos_bit)
        out = []
        for rows, crow in self.stages:
            kind = rows[:, 0]
            wa = np.where(kind == 1,
                          np.sign(rows[:, 1]) * cospi[np.abs(rows[:, 1]) - 1],
                          rows[:, 1]).astype(np.int32)
            wb = np.where(kind == 1,
                          np.sign(rows[:, 3]) * cospi[np.maximum(np.abs(rows[:, 3]) - 1, 0)],
                          rows[:, 3]).astype(np.int32)
            ia = rows[:, 2].astype(np.int32)
            ib = rows[:, 4].astype(np.int32)
            rnd = (kind == 1).astype(np.int32) << (cos_bit - 1)
            shift = ((kind == 1) * cos_bit).astype(np.int32)
            out.append((ia, ib, wa, wb, rnd, shift, crow))
        return out

    def __call__(self, x, cos_bit: int, clamp_bit: int, xp=np):
        """Apply to int32 array [..., N]."""
        if xp is np and _tx_native is not None:
            xs = np.ascontiguousarray(x, dtype=np.int32)
            shape = xs.shape
            n = shape[-1]
            flat = xs.reshape(-1, n)
            out = _tx_native.apply_network(
                flat, self._stmts, self._offsets, self._clamp_flat,
                np.ascontiguousarray(_cospi(cos_bit), dtype=np.int32),
                cos_bit, clamp_bit, flat.shape[0], n)
            return out.reshape(shape[:-1] + (out.shape[-1],))
        consts = self._stage_consts(cos_bit)
        cb = max(clamp_bit, 1)
        cmax = np.int32((1 << (cb - 1)) - 1)
        cmin = np.int32(-(1 << (cb - 1)))
        for ia, ib, wa, wb, rnd, shift, crow in consts:
            a = x[..., ia]
            b = x[..., ib]
            v = (a * wa + b * wb + rnd) >> shift
            if clamp_bit > 0 and crow.any():
                v = xp.where(crow, xp.clip(v, cmin, cmax), v)
            x = v.astype(xp.int32) if hasattr(v, "astype") else v
        return x


@functools.cache
def _network(name: str) -> _Network:
    return _Network(name)


def _round_shift(x, bit: int, xp=np):
    if bit == 0:
        return x
    return (x + (1 << (bit - 1))) >> bit


def _round_shift_array(x, bit: int, xp=np):
    """svt_av1_round_shift_array semantics: bit>0 rounds right, bit<0
    multiplies left."""
    if bit == 0:
        return x
    if bit > 0:
        return (x + (1 << (bit - 1))) >> bit
    return x * (1 << -bit)


def _mul_sqrt2_round(x, mult: int, xp=np):
    """Exact (x * mult + 2^11) >> 12 without leaving int32 range:
    split x into (hi << 15) + lo, lo in [0, 2^15)."""
    hi = x >> 15
    lo = x - (hi << 15)
    return hi * mult * 8 + ((lo * mult + (1 << (NEW_SQRT2_BITS - 1))) >> NEW_SQRT2_BITS)


def _adst4(x, bit: int, inverse: bool, xp=np):
    """Sinpi-based 4-point ADST (reference: svt_av1_iadst4_new
    EbInvTransforms.c:707, svt_av1_fadst4_new EbTransforms.c:1445)."""
    sp = [int(v) for v in _sinpi(bit)]
    x0, x1, x2, x3 = (x[..., i] for i in range(4))
    if inverse:
        s0 = sp[1] * x0
        s1 = sp[2] * x0
        s2 = sp[3] * x1
        s3 = sp[4] * x2
        s4 = sp[1] * x2
        s5 = sp[2] * x3
        s6 = sp[4] * x3
        s7 = (x0 - x2) + x3
        s0 = s0 + s3
        s1 = s1 - s4
        s3 = s2
        s2 = sp[3] * s7
        s0 = s0 + s5
        s1 = s1 - s6
        o0 = s0 + s3
        o1 = s1 + s3
        o2 = s2
        o3 = (s0 + s1) - s3
    else:
        s0 = sp[1] * x0
        s1 = sp[4] * x0
        s2 = sp[2] * x1
        s3 = sp[1] * x1
        s4 = sp[3] * x2
        s5 = sp[4] * x3
        s6 = sp[2] * x3
        s7 = (x0 + x1) - x3
        t0 = (s0 + s2) + s5
        t1 = sp[3] * s7
        t2 = (s1 - s3) + s6
        t3 = s4
        o0 = t0 + t3
        o1 = t1
        o2 = t2 - t3
        o3 = (t2 - t0) + t3
    out = xp.stack([_round_shift(o, bit, xp) for o in (o0, o1, o2, o3)], axis=-1)
    return out.astype(xp.int32)


def _identity(x, n: int, inverse: bool, xp=np):
    if n == 4:
        return _mul_sqrt2_round(x, NEW_SQRT2, xp).astype(xp.int32)
    if n == 8:
        return (x * 2).astype(xp.int32)
    if n == 16:
        return _mul_sqrt2_round(x, 2 * NEW_SQRT2, xp).astype(xp.int32)
    if n == 32:
        return (x * 4).astype(xp.int32)
    if n == 64:
        return _mul_sqrt2_round(x, 4 * NEW_SQRT2, xp).astype(xp.int32)
    raise ValueError(n)


def _apply_1d(x, kind_1d: int, n: int, cos_bit: int, clamp_bit: int,
              inverse: bool, xp=np):
    """Apply a 1-D transform along the last axis (length n)."""
    prefix = "i" if inverse else "f"
    if kind_1d == IDTX:
        return _identity(x, n, inverse, xp)
    if kind_1d in (ADST, FLIPADST):
        if n == 4:
            return _adst4(x, cos_bit, inverse, xp)
        return _network(f"{prefix}adst{n}")(x, cos_bit, clamp_bit, xp)
    return _network(f"{prefix}dct{n}")(x, cos_bit, clamp_bit, xp)


def _clamp(x, bit: int, xp=np):
    return xp.clip(x, -(1 << (bit - 1)), (1 << (bit - 1)) - 1)


def _size_idx(n: int) -> int:
    return {4: 0, 8: 1, 16: 2, 32: 3, 64: 4}[n]


def _rect_log_ratio(w: int, h: int) -> int:
    import math
    return int(math.log2(w / h))


def fwd_txfm2d(residual, tx_type: TxType, tx_size: TxSize, bd: int = 8, xp=np):
    """Forward 2-D transform of residual [..., H, W] (int) -> coeffs
    [..., H, W] int32 (row-major, same layout as the bitstream's
    coefficient plane before scan)."""
    w, h = TX_WIDTH[tx_size], TX_HEIGHT[tx_size]
    s0, s1, s2 = _FWD_SHIFT[tx_size]
    vt, ht = _VTX[tx_type], _HTX[tx_type]
    cb_col = _FWD_COS_BIT_COL[_size_idx(w)][_size_idx(h)]
    cb_row = _FWD_COS_BIT_ROW[_size_idx(w)][_size_idx(h)]
    x = residual.astype(xp.int32)
    if vt == FLIPADST:
        x = x[..., ::-1, :]
    # column pass: move H to last axis
    x = xp.swapaxes(x, -1, -2)                       # [..., W, H]
    x = _round_shift_array(x, -s0, xp)
    x = _apply_1d(x, vt, h, cb_col, 0, False, xp)
    x = _round_shift_array(x, -s1, xp)
    x = xp.swapaxes(x, -1, -2)                       # [..., H, W]
    if ht == FLIPADST:
        x = x[..., :, ::-1]
    # row pass
    x = _apply_1d(x, ht, w, cb_row, 0, False, xp)
    x = _round_shift_array(x, -s2, xp)
    if abs(_rect_log_ratio(w, h)) == 1:
        x = _mul_sqrt2_round(x, NEW_SQRT2, xp)
    x = x.astype(xp.int32)
    # 64-point transforms only keep the top-left 32x32 coefficients
    if w == 64 or h == 64:
        mask = np.zeros((h, w), dtype=np.int32)
        mask[: min(h, 32), : min(w, 32)] = 1
        x = x * mask
    return x


def inv_txfm2d_add(coeffs, pred, tx_type: TxType, tx_size: TxSize,
                   bd: int = 8, xp=np):
    """Inverse 2-D transform of coeffs [..., H, W] int32 added to
    prediction [..., H, W] (uint), clipped to pixel range.  Normative
    recon path (parity: inv_txfm2d_add_c, EbInvTransforms.c:2455)."""
    w, h = TX_WIDTH[tx_size], TX_HEIGHT[tx_size]
    s0, s1 = _INV_SHIFT[tx_size]
    vt, ht = _VTX[tx_type], _HTX[tx_type]
    opt_row = 18 if bd == 10 else (20 if bd == 12 else 16)
    opt_col = 18 if bd == 12 else 16
    x = coeffs.astype(xp.int32)
    # row pass
    if abs(_rect_log_ratio(w, h)) == 1:
        x = _mul_sqrt2_round(x, NEW_INV_SQRT2, xp)
    x = _clamp(x, bd + 8, xp)
    x = _apply_1d(x, ht, w, INV_COS_BIT, opt_row, True, xp)
    x = _round_shift_array(x, -s0, xp)
    if ht == FLIPADST:
        x = x[..., :, ::-1]
    # column pass
    x = xp.swapaxes(x, -1, -2)                       # [..., W, H]
    x = _clamp(x, max(bd + 6, 16), xp)
    x = _apply_1d(x, vt, h, INV_COS_BIT, opt_col, True, xp)
    x = _round_shift_array(x, -s1, xp)
    x = xp.swapaxes(x, -1, -2)                       # [..., H, W]
    if vt == FLIPADST:
        x = x[..., ::-1, :]
    # residual clamp + add + pixel clip (highbd_clip_pixel_add)
    int_max = (1 << (7 + bd)) - 1 + (914 << (bd - 7))
    x = xp.clip(x, -int_max - 1, int_max)
    out = xp.clip(pred.astype(xp.int32) + x, 0, (1 << bd) - 1)
    return out
