"""Plan assembly for the fused native block-coding kernel.

Assembles the per-(tx_size, tx_type, qindex, plane-tables, bit-depth)
descriptor the C kernel (block_native.c) executes: the same extracted
butterfly stage tables, shift triples and quantizer vectors the Python
path uses — single source of truth, fused into one call per block.
"""
from __future__ import annotations

import functools

import numpy as np

from ..constants import TxSize, TxType, TX_WIDTH, TX_HEIGHT
from ..entropy import coeffs as cf
from ..ops import quant as qz
from ..kernels.build import load_c_extension
from ..ops import transforms as tf

_bn = load_c_extension("block_native")

KIND_NET, KIND_IDTX, KIND_ADST4 = 0, 1, 2

_DUMMY_I32 = np.zeros(2, np.int32)
_DUMMY_OFFS = np.zeros(2, np.int32)
_DUMMY_I8 = np.zeros(2, np.int8)


def available() -> bool:
    return _bn is not None


def _pass_net(kind1d: int, n: int, prefix: str):
    """(stmts, offs, clamp, cospi-placeholder, kind) for one 1-D pass."""
    if kind1d == tf.IDTX:
        return (_DUMMY_I32, _DUMMY_OFFS, _DUMMY_I8, KIND_IDTX)
    if kind1d in (tf.ADST, tf.FLIPADST) and n == 4:
        return (_DUMMY_I32, _DUMMY_OFFS, _DUMMY_I8, KIND_ADST4)
    name = f"{prefix}{'adst' if kind1d in (tf.ADST, tf.FLIPADST) else 'dct'}{n}"
    net = tf._network(name)
    return (net._stmts, net._offsets, net._clamp_flat, KIND_NET)


@functools.lru_cache(maxsize=4096)
def get_plan(pq_key: int, qindex: int, tx_size: TxSize, tx_type: TxType,
             bd: int):
    """Returns a plan capsule, or None when the fused C module is not
    built.  64-dim sizes run the same extracted stage tables
    (fdct64/idct64); the C core zero-masks coefficients beyond the
    coded 32x32 band like fwd_txfm2d."""
    if _bn is None:
        return None
    w, h = TX_WIDTH[tx_size], TX_HEIGHT[tx_size]
    pq = qz._PQ_REGISTRY[pq_key]
    vt, ht = tf._VTX[tx_type], tf._HTX[tx_type]
    s0, s1, s2 = tf._FWD_SHIFT[tx_size]
    i0, i1 = tf._INV_SHIFT[tx_size]
    cb_col = tf._FWD_COS_BIT_COL[tf._size_idx(w)][tf._size_idx(h)]
    cb_row = tf._FWD_COS_BIT_ROW[tf._size_idx(w)][tf._size_idx(h)]
    opt_row = 18 if bd == 10 else (20 if bd == 12 else 16)
    opt_col = 18 if bd == 12 else 16
    rect = 1 if abs(tf._rect_log_ratio(w, h)) == 1 else 0

    fcol = _pass_net(vt, h, "f")
    frow = _pass_net(ht, w, "f")
    irow = _pass_net(ht, w, "i")
    icol = _pass_net(vt, h, "i")

    ls = qz.tx_log_scale(tx_size)

    def qvec(name, shift_down=False):
        v = getattr(pq, name)[qindex].astype(np.int32)
        if shift_down and ls:
            v = (v + (1 << (ls - 1))) >> ls
        return np.ascontiguousarray(v)

    scan = np.ascontiguousarray(
        cf.scan_for(tx_size, tx_type).astype(np.int16))
    cw, ch = min(w, 32), min(h, 32)

    # sinpi tables for the adst4 passes (fwd bit is that pass's cos bit;
    # 4x4 is the only both-adst4 case and its col/row bits agree)
    fwd_bit = cb_col if h == 4 else cb_row
    sinpi_f = np.ascontiguousarray(tf._sinpi(fwd_bit).astype(np.int32))
    sinpi_i = np.ascontiguousarray(tf._sinpi(tf.INV_COS_BIT).astype(np.int32))

    def cospi(bit):
        return np.ascontiguousarray(tf._cospi(bit).astype(np.int32))

    ints = (w, h, bd, -s0, -s1, -s2, -i0, -i1,
            1 if vt == tf.FLIPADST else 0, 1 if ht == tf.FLIPADST else 0,
            rect, opt_row, opt_col,
            cb_col, fcol[3], cb_row, frow[3],
            tf.INV_COS_BIT, irow[3], tf.INV_COS_BIT, icol[3],
            ls, len(scan), cw, ch)
    arrays = (
        np.ascontiguousarray(fcol[0]), np.ascontiguousarray(fcol[1]),
        np.ascontiguousarray(fcol[2]), cospi(cb_col),
        np.ascontiguousarray(frow[0]), np.ascontiguousarray(frow[1]),
        np.ascontiguousarray(frow[2]), cospi(cb_row),
        np.ascontiguousarray(irow[0]), np.ascontiguousarray(irow[1]),
        np.ascontiguousarray(irow[2]), cospi(tf.INV_COS_BIT),
        np.ascontiguousarray(icol[0]), np.ascontiguousarray(icol[1]),
        np.ascontiguousarray(icol[2]), cospi(tf.INV_COS_BIT),
        sinpi_f, sinpi_i,
        qvec("zbin", True), qvec("round", True), qvec("quant"),
        qvec("quant_shift"), qvec("dequant"), scan,
        qvec("quant_fp"), qvec("round_fp", True),
    )
    return _bn.make_plan(ints, arrays)


def code_block(pq: qz.PlaneQuant, qindex: int, tx_size: TxSize,
               tx_type: TxType, bd: int, resid: np.ndarray,
               pred: np.ndarray, rdoq=None):
    """Fused fwd-TX + quantize + eob + [trellis] + inv-TX + recon for
    one block.  ``rdoq``: None, or the per-txb run descriptor from
    ops/rdoq-built tables: (tabs7, rdmult, tx_class, shape, use_fp)
    with tabs7 the ctx-sliced int32 arrays (see block_native.c).

    Returns (qcoeff [h, w] int32, eob, recon [h, w] int32) or None when
    the fused path is unavailable for this configuration."""
    qz._PQ_REGISTRY.setdefault(id(pq), pq)
    plan = get_plan(id(pq), qindex, tx_size, tx_type, bd)
    if plan is None:
        return None
    h, w = TX_HEIGHT[tx_size], TX_WIDTH[tx_size]
    r = np.ascontiguousarray(resid, np.int32)
    p = np.ascontiguousarray(pred, np.int32)
    qc = np.empty((h, w), np.int32)
    rec = np.empty((h, w), np.int32)
    if rdoq is None:
        eob = _bn.code_block(plan, r, p, qc, rec)
    else:
        tabs, rdmult, tx_class, shape, use_fp = rdoq
        eob = _bn.code_block_rdoq(plan, r, p, qc, rec, tabs,
                                  int(rdmult), int(tx_class), int(shape),
                                  int(use_fp))
    return qc, eob, rec
