"""AV1 transform-coefficient entropy coding (write + parse).

Bit-exact implementation of the residual coding syntax (AV1 spec 5.11.39
"Coefficients syntax" / 8.3.2): txb_skip, eob position + extra bits, base
levels with neighbor-sum contexts, level ranges (br), golomb tails, dc
sign.  Behavioral parity: encoder av1_write_coeffs_txb_1d
(SVT-AV1 Source/Lib/Encoder/Codec/EbEntropyCoding.c:548) and
context derivation (Encoder/C_DEFAULT/EncodeTxbRef_C.c, EbCommonUtils.h
get_br_ctx); decoder parse_coeffs (Decoder/Codec/EbDecParseBlock.c).

The per-symbol serial loops here are the host-side packing stage; the
batched TPU path computes levels/contexts/rate estimates in parallel and
feeds this packer (or its C++ twin) per tile.
"""
from __future__ import annotations

import functools

import numpy as np

from ..constants import TxSize, TxType, TX_WIDTH, TX_HEIGHT
from .ec import RangeDecoder, RangeEncoder
from .tables import FrameCdfs, scan_order

# TX classes (EbCabacContextModel.h:592 tx_type_to_class)
TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT = 0, 1, 2
TX_TYPE_TO_CLASS = [TX_CLASS_2D] * 10 + [
    TX_CLASS_VERT, TX_CLASS_HORIZ, TX_CLASS_VERT,
    TX_CLASS_HORIZ, TX_CLASS_VERT, TX_CLASS_HORIZ]

NUM_BASE_LEVELS = 2
COEFF_BASE_RANGE = 12
BR_CDF_SIZE = 4
COEFF_CONTEXT_BITS = 6
COEFF_CONTEXT_MASK = (1 << COEFF_CONTEXT_BITS) - 1
TX_PAD_HOR = 4

# eob grouping (EbCommonUtils.h:23)
K_EOB_GROUP_START = [0, 1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513]
K_EOB_OFFSET_BITS = [0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9]

_EOB_TO_POS_SMALL = [0, 1, 2, 3, 3, 4, 4, 4, 4] + [5] * 8 + [6] * 16
_EOB_TO_POS_LARGE = [6, 7, 8, 8, 9, 9, 9, 9] + [10] * 8 + [11]


def _sq_idx(n: int) -> int:
    return {4: 0, 8: 1, 16: 2, 32: 3, 64: 4}[n]


def txs_ctx(tx_size: TxSize) -> int:
    """(txsize_sqr_map + txsize_sqr_up_map + 1) >> 1"""
    w, h = TX_WIDTH[tx_size], TX_HEIGHT[tx_size]
    return (_sq_idx(min(w, h)) + _sq_idx(max(w, h)) + 1) >> 1


def eob_multi_size(tx_size: TxSize) -> int:
    """txsize_log2_minus4: log2(coded coeff count) - 4."""
    w, h = min(TX_WIDTH[tx_size], 32), min(TX_HEIGHT[tx_size], 32)
    return (w * h).bit_length() - 1 - 4


def get_eob_pos_token(eob: int) -> tuple[int, int]:
    if eob < 33:
        t = _EOB_TO_POS_SMALL[eob]
    else:
        t = _EOB_TO_POS_LARGE[min((eob - 1) >> 5, 16)]
    return t, eob - K_EOB_GROUP_START[t]


def scan_for(tx_size: TxSize, tx_type: TxType) -> np.ndarray:
    cls = TX_TYPE_TO_CLASS[tx_type]
    kind = {TX_CLASS_2D: "default", TX_CLASS_VERT: "mrow",
            TX_CLASS_HORIZ: "mcol"}[cls]
    return scan_order(TX_WIDTH[tx_size], TX_HEIGHT[tx_size], kind)


def _tx_shape(tx_size: TxSize) -> int:
    """0 square-rule, 1 tall (rows<2 -> +11), 2 wide (cols<2 -> +16).
    Decided by the TRUE tx dims even for 64-dim sizes whose coded
    region is clamped to 32x32 (eb_av1_nz_map_ctx_offset_32x64 et al,
    EbCoefficients.h:3099 differ from the square 32x32 table)."""
    w, h = TX_WIDTH[tx_size], TX_HEIGHT[tx_size]
    return 1 if w < h else (2 if w > h else 0)


@functools.cache
def _nz_ctx_offset_2d(width: int, height: int, shape: int | None = None
                      ) -> np.ndarray:
    """2D nz-map context offsets (generation rule documented at
    EncodeTxbRef_C.c:~380)."""
    if shape is None:
        shape = 1 if width < height else (2 if width > height else 0)
    rows = np.arange(height)[:, None]
    cols = np.arange(width)[None, :]
    off = np.full((height, width), 21, dtype=np.int32)
    off = np.where(rows + cols < 4, 6, off)
    off = np.where(rows + cols < 2, 1, off)
    if shape == 1:
        off = np.where(rows < 2, 11, off)
    elif shape == 2:
        off = np.where(cols < 2, 16, off)
    off[0, 0] = 0
    return off


def txb_levels(qcoeff: np.ndarray) -> np.ndarray:
    """Padded |level| buffer: [h + 2 pad bottom + pad..., stride w+4]
    laid out like av1_txb_init_levels (levels[row*stride + col])."""
    h, w = qcoeff.shape
    buf = np.zeros((h + 4, w + TX_PAD_HOR), dtype=np.int32)
    buf[:h, :w] = np.clip(np.abs(qcoeff), 0, 127)
    return buf


def _clip3(x):
    return min(int(x), 3)


def get_nz_map_ctx(levels: np.ndarray, pos: int, bwl: int, height: int,
                   scan_idx: int, is_eob: bool, width: int,
                   tx_class: int, shape: int | None = None) -> int:
    if is_eob:
        if scan_idx == 0:
            return 0
        if scan_idx <= (height << bwl) // 8:
            return 1
        if scan_idx <= (height << bwl) // 4:
            return 2
        return 3
    row, col = pos >> bwl, pos & ((1 << bwl) - 1)
    lv = levels
    mag = _clip3(lv[row, col + 1]) + _clip3(lv[row + 1, col])
    if tx_class == TX_CLASS_2D:
        mag += (_clip3(lv[row + 1, col + 1]) + _clip3(lv[row, col + 2])
                + _clip3(lv[row + 2, col]))
    elif tx_class == TX_CLASS_VERT:
        mag += (_clip3(lv[row + 2, col]) + _clip3(lv[row + 3, col])
                + _clip3(lv[row + 4, col]))
    else:
        mag += (_clip3(lv[row, col + 2]) + _clip3(lv[row, col + 3])
                + _clip3(lv[row, col + 4]))
    if (tx_class | pos) == 0:
        return 0
    ctx = min((mag + 1) >> 1, 4)
    if tx_class == TX_CLASS_2D:
        return ctx + int(_nz_ctx_offset_2d(1 << bwl, height,
                                           shape)[row, col])
    idx = col if tx_class == TX_CLASS_HORIZ else row
    return ctx + (26 if idx == 0 else (31 if idx == 1 else 36))


def get_br_ctx(levels: np.ndarray, pos: int, bwl: int, tx_class: int) -> int:
    row, col = pos >> bwl, pos & ((1 << bwl) - 1)
    lv = levels
    mag = int(lv[row, col + 1]) + int(lv[row + 1, col])
    if tx_class == TX_CLASS_2D:
        mag += int(lv[row + 1, col + 1])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        if row < 2 and col < 2:
            return mag + 7
    elif tx_class == TX_CLASS_HORIZ:
        mag += int(lv[row, col + 2])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        if col == 0:
            return mag + 7
    else:
        mag += int(lv[row + 2, col])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        if row == 0:
            return mag + 7
    return mag + 14


def nz_ctx_map(levels: np.ndarray, h: int, w: int, tx_class: int,
               shape: int | None = None) -> np.ndarray:
    """Vectorized base-level context for every position (non-eob path).
    ``levels`` is the padded |level| buffer from txb_levels."""
    c3 = np.minimum(levels, 3)
    if tx_class == TX_CLASS_2D:
        mag = (c3[:h, 1:w + 1] + c3[1:h + 1, :w] + c3[1:h + 1, 1:w + 1]
               + c3[:h, 2:w + 2] + c3[2:h + 2, :w])
        ctx = np.minimum((mag + 1) >> 1, 4) + _nz_ctx_offset_2d(w, h, shape)
        ctx[0, 0] = 0
        return ctx
    if tx_class == TX_CLASS_VERT:
        mag = (c3[:h, 1:w + 1] + c3[1:h + 1, :w] + c3[2:h + 2, :w]
               + c3[3:h + 3, :w] + c3[4:h + 4, :w])
        off = np.full((h, 1), 36, np.int32)
        off[0] = 26
        if h > 1:
            off[1] = 31
        return np.minimum((mag + 1) >> 1, 4) + off
    mag = (c3[:h, 1:w + 1] + c3[1:h + 1, :w] + c3[:h, 2:w + 2]
           + c3[:h, 3:w + 3] + c3[:h, 4:w + 4])
    off = np.full((1, w), 36, np.int32)
    off[0, 0] = 26
    if w > 1:
        off[0, 1] = 31
    return np.minimum((mag + 1) >> 1, 4) + off


def br_ctx_map(levels: np.ndarray, h: int, w: int, tx_class: int) -> np.ndarray:
    """Vectorized br context for every position."""
    lv = levels
    rows = np.arange(h)[:, None]
    cols = np.arange(w)[None, :]
    if tx_class == TX_CLASS_2D:
        mag = lv[:h, 1:w + 1] + lv[1:h + 1, :w] + lv[1:h + 1, 1:w + 1]
        mag = np.minimum((mag + 1) >> 1, 6)
        out = np.where((rows < 2) & (cols < 2), mag + 7, mag + 14)
        out[0, 0] = mag[0, 0]
        return out
    if tx_class == TX_CLASS_HORIZ:
        mag = lv[:h, 1:w + 1] + lv[1:h + 1, :w] + lv[:h, 2:w + 2]
        mag = np.minimum((mag + 1) >> 1, 6)
        out = np.where(cols == 0, mag + 7, mag + 14)
        out[0, 0] = mag[0, 0]
        return out
    mag = lv[:h, 1:w + 1] + lv[1:h + 1, :w] + lv[2:h + 2, :w]
    mag = np.minimum((mag + 1) >> 1, 6)
    out = np.where(rows == 0, mag + 7, mag + 14)
    out[0, 0] = mag[0, 0]
    return out


def _write_golomb(enc: RangeEncoder, level: int) -> None:
    x = level + 1
    length = x.bit_length()
    for _ in range(length - 1):
        enc.encode_bit(0)
    for i in range(length - 1, -1, -1):
        enc.encode_bit((x >> i) & 1)


def _read_golomb(dec: RangeDecoder) -> int:
    length = 0
    while dec.decode_bit() == 0:
        length += 1
        if length > 31:
            raise ValueError("bad golomb code")
    x = 1
    for _ in range(length):
        x = (x << 1) | dec.decode_bit()
    return x - 1


def compute_eob(qcoeff: np.ndarray, tx_size: TxSize, tx_type: TxType) -> int:
    scan = scan_for(tx_size, tx_type)
    flat = qcoeff.reshape(-1)[scan]
    nz = np.nonzero(flat)[0]
    return int(nz[-1] + 1) if len(nz) else 0


def set_dc_sign(cul_level: int, dc_val: int) -> int:
    if dc_val < 0:
        return cul_level | (1 << COEFF_CONTEXT_BITS)
    if dc_val > 0:
        return cul_level + (2 << COEFF_CONTEXT_BITS)
    return cul_level


def write_coeffs_txb(enc: RangeEncoder, fc: FrameCdfs, qcoeff: np.ndarray,
                     tx_size: TxSize, tx_type: TxType, plane_type: int,
                     txb_skip_ctx: int, dc_sign_ctx: int, eob: int,
                     tx_type_writer=None) -> int:
    """Write one transform block's coefficients.  qcoeff is the [h, w]
    (coded size, <=32 per dim) quantized level plane.  Returns cul_level
    for the dc-sign/level neighbor context.  ``tx_type_writer`` is
    invoked after txb_skip when eob > 0 (luma ext-tx signaling slot)."""
    ts_ctx = txs_ctx(tx_size)
    enc.encode_symbol(int(eob == 0), fc.txb_skip[ts_ctx][txb_skip_ctx], 2)
    if eob == 0:
        return 0
    if tx_type_writer is not None:
        tx_type_writer()

    h, w = qcoeff.shape
    bwl = w.bit_length() - 1
    tx_class = TX_TYPE_TO_CLASS[tx_type]
    scan = scan_for(tx_size, tx_type)
    levels = txb_levels(qcoeff)
    flat = qcoeff.reshape(-1)

    eob_pt, eob_extra = get_eob_pos_token(eob)
    eob_ctx = 0 if tx_class == TX_CLASS_2D else 1
    ems = eob_multi_size(tx_size)
    eob_cdf = fc.eob_flag(ems + 4)[plane_type][eob_ctx]
    enc.encode_symbol(eob_pt - 1, eob_cdf, ems + 5)

    offset_bits = K_EOB_OFFSET_BITS[eob_pt]
    if offset_bits > 0:
        bit = (eob_extra >> (offset_bits - 1)) & 1
        enc.encode_symbol(bit, fc.eob_extra[ts_ctx][plane_type][eob_pt], 2)
        for i in range(1, offset_bits):
            enc.encode_bit((eob_extra >> (offset_bits - 1 - i)) & 1)

    # vectorized context maps (positions' base/br contexts depend only on
    # the full |level| plane, so they batch; TPU path computes these maps
    # on device)
    shape = _tx_shape(tx_size)
    ctx_map = nz_ctx_map(levels, h, w, tx_class, shape).reshape(-1)
    brctx_map = br_ctx_map(levels, h, w, tx_class).reshape(-1)
    abs_flat = np.abs(flat)
    scan_eob = scan[:eob]
    lv_scan = abs_flat[scan_eob]
    base_cdf = fc.coeff_base[ts_ctx][plane_type]
    base_eob_cdf = fc.coeff_base_eob[ts_ctx][plane_type]
    br_cdf_set = fc.coeff_br[min(ts_ctx, 3)][plane_type]

    for c in range(eob - 1, -1, -1):
        pos = int(scan_eob[c])
        level = int(lv_scan[c])
        if c == eob - 1:
            ctx = get_nz_map_ctx(levels, pos, bwl, h, c, True, w,
                                 tx_class, shape)
            enc.encode_symbol(min(level, 3) - 1, base_eob_cdf[ctx], 3)
        else:
            enc.encode_symbol(min(level, 3), base_cdf[ctx_map[pos]], 4)
        if level > NUM_BASE_LEVELS:
            base_range = level - 1 - NUM_BASE_LEVELS
            br_cdf = br_cdf_set[brctx_map[pos]]
            for idx in range(0, COEFF_BASE_RANGE, BR_CDF_SIZE - 1):
                k = min(base_range - idx, BR_CDF_SIZE - 1)
                enc.encode_symbol(k, br_cdf, BR_CDF_SIZE)
                if k < BR_CDF_SIZE - 1:
                    break

    cul_level = 0
    for c in range(eob):
        pos = int(scan[c])
        v = int(flat[pos])
        level = abs(v)
        cul_level += level
        if level:
            if c == 0:
                enc.encode_symbol(int(v < 0),
                                  fc.dc_sign[plane_type][dc_sign_ctx], 2)
            else:
                enc.encode_bit(int(v < 0))
            if level > COEFF_BASE_RANGE + NUM_BASE_LEVELS:
                _write_golomb(enc, level - COEFF_BASE_RANGE - 1 - NUM_BASE_LEVELS)

    cul_level = min(COEFF_CONTEXT_MASK, cul_level)
    return set_dc_sign(cul_level, int(flat[0]))


def parse_coeffs_txb(dec: RangeDecoder, fc: FrameCdfs, tx_size: TxSize,
                     tx_type: TxType, plane_type: int, txb_skip_ctx: int,
                     dc_sign_ctx: int, tx_type_reader=None
                     ) -> tuple[np.ndarray, int, int, TxType]:
    """Parse one transform block.  Returns (qcoeff [h, w], eob,
    cul_level, tx_type).  ``tx_type_reader`` is invoked after a nonzero
    txb_skip to parse the luma ext-tx syntax; otherwise the passed
    tx_type is used."""
    h = min(TX_HEIGHT[tx_size], 32)
    w = min(TX_WIDTH[tx_size], 32)
    ts_ctx = txs_ctx(tx_size)
    all_zero = dec.decode_symbol(fc.txb_skip[ts_ctx][txb_skip_ctx], 2)
    qcoeff = np.zeros((h, w), dtype=np.int32)
    if all_zero:
        return qcoeff, 0, 0, TxType.DCT_DCT
    if tx_type_reader is not None:
        tx_type = tx_type_reader()

    bwl = w.bit_length() - 1
    tx_class = TX_TYPE_TO_CLASS[tx_type]
    scan = scan_for(tx_size, tx_type)

    eob_ctx = 0 if tx_class == TX_CLASS_2D else 1
    ems = eob_multi_size(tx_size)
    eob_pt = dec.decode_symbol(fc.eob_flag(ems + 4)[plane_type][eob_ctx],
                               ems + 5) + 1
    offset_bits = K_EOB_OFFSET_BITS[eob_pt]
    eob_extra = 0
    if offset_bits > 0:
        bit = dec.decode_symbol(fc.eob_extra[ts_ctx][plane_type][eob_pt], 2)
        eob_extra = bit << (offset_bits - 1)
        for i in range(1, offset_bits):
            eob_extra |= dec.decode_bit() << (offset_bits - 1 - i)
    eob = K_EOB_GROUP_START[eob_pt] + eob_extra

    levels = np.zeros((h + 4, w + TX_PAD_HOR), dtype=np.int32)
    flat = qcoeff.reshape(-1)

    for c in range(eob - 1, -1, -1):
        pos = int(scan[c])
        row, col = pos >> bwl, pos & (w - 1)
        ctx = get_nz_map_ctx(levels, pos, bwl, h, c, c == eob - 1, w,
                             tx_class, _tx_shape(tx_size))
        if c == eob - 1:
            level = dec.decode_symbol(
                fc.coeff_base_eob[ts_ctx][plane_type][ctx], 3) + 1
        else:
            level = dec.decode_symbol(
                fc.coeff_base[ts_ctx][plane_type][ctx], 4)
        if level > NUM_BASE_LEVELS:
            br_ctx = get_br_ctx(levels, pos, bwl, tx_class)
            br_cdf = fc.coeff_br[min(ts_ctx, 3)][plane_type][br_ctx]
            for idx in range(0, COEFF_BASE_RANGE, BR_CDF_SIZE - 1):
                k = dec.decode_symbol(br_cdf, BR_CDF_SIZE)
                level += k
                if k < BR_CDF_SIZE - 1:
                    break
        levels[row, col] = min(level, 127)
        flat[pos] = level

    cul_level = 0
    for c in range(eob):
        pos = int(scan[c])
        level = int(flat[pos])
        if level:
            if c == 0:
                sign = dec.decode_symbol(fc.dc_sign[plane_type][dc_sign_ctx], 2)
            else:
                sign = dec.decode_bit()
            if level > COEFF_BASE_RANGE + NUM_BASE_LEVELS:
                level += _read_golomb(dec)
                flat[pos] = level
            cul_level += level
            if sign:
                flat[pos] = -level

    cul_level = min(COEFF_CONTEXT_MASK, cul_level)
    return (qcoeff, eob,
            set_dc_sign(cul_level, int(flat[int(scan[0])] if eob else 0)),
            tx_type)
