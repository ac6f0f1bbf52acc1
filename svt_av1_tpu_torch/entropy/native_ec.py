"""Python-side adapter for the native range encoder.

Exposes the same method surface as entropy.ec.RangeEncoder so the codec
can swap implementations; write_coeffs_fast covers the whole
coefficient-block hot loop in C.
"""
from __future__ import annotations

import numpy as np

from ..constants import TxSize, TxType, TX_WIDTH, TX_HEIGHT
from ..native import EcEnc, HAVE_NATIVE_EC
from . import coeffs as cf
from .tables import FrameCdfs


class NativeRangeEncoder:
    """Drop-in RangeEncoder backed by the C extension."""

    def __init__(self):
        self._e = EcEnc()

    def encode_symbol(self, s: int, icdf: np.ndarray, nsyms: int,
                      adapt: bool = True) -> None:
        self._e.encode_symbol(int(s), icdf, nsyms, adapt)

    def encode_cdf(self, s: int, icdf: np.ndarray, nsyms: int) -> None:
        self._e.encode_symbol(int(s), icdf, nsyms, False)

    def encode_bool_prob8(self, bit: int, prob8: int) -> None:
        self._e.encode_bool_prob8(int(bit), prob8)

    def encode_bit(self, bit: int) -> None:
        self._e.encode_bool_prob8(int(bit), 128)

    def encode_literal(self, value: int, bits: int) -> None:
        self._e.encode_literal(int(value), bits)

    def tell_bits(self) -> int:
        return self._e.tell_bits()

    def done(self) -> bytes:
        return self._e.done()

    # -- fast coefficient path -------------------------------------------
    def write_coeffs_fast(self, fc: FrameCdfs, qcoeff: np.ndarray,
                          tx_size: TxSize, tx_type: TxType, plane_type: int,
                          txb_skip_ctx: int, dc_sign_ctx: int, eob: int,
                          tx_type_writer=None) -> int:
        ts_ctx = cf.txs_ctx(tx_size)
        self.encode_symbol(int(eob == 0), fc.txb_skip[ts_ctx][txb_skip_ctx], 2)
        if eob == 0:
            return 0
        if tx_type_writer is not None:
            tx_type_writer()
        h, w = qcoeff.shape
        tx_class = cf.TX_TYPE_TO_CLASS[tx_type]
        scan = np.ascontiguousarray(cf.scan_for(tx_size, tx_type),
                                    dtype=np.int16)
        ems = cf.eob_multi_size(tx_size)
        eob_ctx = 0 if tx_class == cf.TX_CLASS_2D else 1
        eob_cdf_row = fc.eob_flag(ems + 4)[plane_type][eob_ctx]
        eob_pt, _ = cf.get_eob_pos_token(eob)
        eob_extra_row = fc.eob_extra[ts_ctx][plane_type][eob_pt]
        base = fc.coeff_base[ts_ctx][plane_type]
        base_eob = fc.coeff_base_eob[ts_ctx][plane_type]
        br = fc.coeff_br[min(ts_ctx, 3)][plane_type]
        q = np.ascontiguousarray(qcoeff, dtype=np.int32).reshape(-1)
        return self._e.write_coeffs(
            q, scan, int(eob), int(w), int(h), int(tx_class),
            eob_cdf_row, eob_extra_row,
            base, int(base.shape[-1]),
            base_eob, int(base_eob.shape[-1]),
            br, int(br.shape[-1]),
            fc.dc_sign[plane_type][dc_sign_ctx],
            cf._tx_shape(tx_size))


def make_range_encoder():
    """Best available range encoder."""
    if HAVE_NATIVE_EC:
        return NativeRangeEncoder()
    from .ec import RangeEncoder
    return RangeEncoder()
