"""The symbol decoder and the coefficient syntax in C (``native/ecdec.c``),
bound with ctypes: the same API as ``ec.RangeDecoder``, and
``coeffs_txb`` for ``coeffs.parse_coeffs_txb``.  ``build()`` compiles the
library into ``build/bench_av1dec/`` of the checkout (a fixed path, the
name from the source's digest), once; ``make_range_decoder`` falls back
to the Python decoder when the library is not built."""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "native" / "ecdec.c"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "bench_av1dec"
CFLAGS = ["-O2", "-shared", "-fPIC", "-std=c99"]
ENABLED = True            # the CPU tests switch it off to compare

_lib = None


class _State(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("pos", ctypes.c_int64),
                ("end", ctypes.c_int64), ("dif", ctypes.c_uint64),
                ("rng", ctypes.c_uint32), ("cnt", ctypes.c_int32)]


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CFLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"ecdec-{digest}.so"


def build() -> Path:
    """Compile the library unless it is there; atomic, so that channels
    building at once agree."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        subprocess.run([os.environ.get("CC", "cc"), *CFLAGS, str(SRC),
                        "-o", str(tmp)], check=True)
        os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            return None
        lib = ctypes.CDLL(str(path))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ecd_init.argtypes = [P, P, ctypes.c_int64]
        lib.ecd_symbol.argtypes = [P, P, I, I]
        lib.ecd_bool_q15.argtypes = [P, I]
        lib.ecd_bool_prob8.argtypes = [P, I]
        lib.ecd_literal.argtypes = [P, I]
        lib.ecd_coeffs.argtypes = [P, I, I, I, I, P, I, P, P, I, P, I, P, I,
                                   P, I, P, P, P, P, P]
        _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> int:
    return a.__array_interface__["data"][0]


def make_range_decoder(data: bytes):
    lib = _load() if ENABLED else None
    if lib is None:
        from .ec import RangeDecoder
        return RangeDecoder(data)
    return NativeRangeDecoder(lib, data)


class NativeRangeDecoder:
    """``ec.RangeDecoder``'s API over the C decoder."""

    def __init__(self, lib, data: bytes):
        self.lib = lib
        self.data = bytes(data)
        self.state = _State()
        self.sp = ctypes.addressof(self.state)
        self._buf = ctypes.c_char_p(self.data)
        lib.ecd_init(self.sp, ctypes.cast(self._buf, ctypes.c_void_p),
                     len(self.data))
        self._out = np.zeros(2, np.int32)

    def decode_symbol(self, icdf: np.ndarray, nsyms: int,
                      adapt: bool = True) -> int:
        return self.lib.ecd_symbol(self.sp, _ptr(icdf), nsyms, int(adapt))

    def decode_cdf(self, icdf: np.ndarray, nsyms: int) -> int:
        return self.lib.ecd_symbol(self.sp, _ptr(icdf), nsyms, 0)

    def decode_bool_q15(self, f: int) -> int:
        return self.lib.ecd_bool_q15(self.sp, f)

    def decode_bool_prob8(self, prob8: int) -> int:
        return self.lib.ecd_bool_prob8(self.sp, prob8)

    def decode_bit(self) -> int:
        return self.lib.ecd_bool_prob8(self.sp, 128)

    def decode_literal(self, bits: int) -> int:
        return self.lib.ecd_literal(self.sp, bits)

    def coeffs_txb(self, fc, tx_size, tx_type, plane_type: int,
                   txb_skip_ctx: int, dc_sign_ctx: int,
                   tx_type_reader=None):
        """``coeffs.parse_coeffs_txb`` with its loops in C."""
        from . import coeffs as cf
        from ..constants import TX_HEIGHT, TX_WIDTH, TxType

        h = min(TX_HEIGHT[tx_size], 32)
        w = min(TX_WIDTH[tx_size], 32)
        ts_ctx = cf.txs_ctx(tx_size)
        all_zero = self.decode_symbol(fc.txb_skip[ts_ctx][txb_skip_ctx], 2)
        qcoeff = np.zeros((h, w), dtype=np.int32)
        if all_zero:
            return qcoeff, 0, 0, TxType.DCT_DCT
        if tx_type_reader is not None:
            tx_type = tx_type_reader()
        bwl = w.bit_length() - 1
        tx_class = cf.TX_TYPE_TO_CLASS[tx_type]
        scan = _scan32(tx_size, tx_type)
        ems = cf.eob_multi_size(tx_size)
        eob_ctx = 0 if tx_class == cf.TX_CLASS_2D else 1
        eob_cdf = fc.eob_flag(ems + 4)[plane_type][eob_ctx]
        eob_extra = fc.eob_extra[ts_ctx][plane_type]
        base_eob = fc.coeff_base_eob[ts_ctx][plane_type]
        base = fc.coeff_base[ts_ctx][plane_type]
        br = fc.coeff_br[min(ts_ctx, 3)][plane_type]
        dc_sign = fc.dc_sign[plane_type][dc_sign_ctx]
        for a in (eob_cdf, eob_extra, base_eob, base, br, dc_sign):
            assert a.flags.c_contiguous and a.dtype == np.uint16
        nz_off = _nz_off(w, h, cf._tx_shape(tx_size))
        levels = np.zeros((h + 4) * (w + 4), np.int32)
        out = self._out
        rc = self.lib.ecd_coeffs(
            self.sp, h, w, bwl, tx_class, _ptr(scan), ems, _ptr(eob_cdf),
            _ptr(eob_extra), eob_extra.shape[-1], _ptr(base_eob),
            base_eob.shape[-1], _ptr(base), base.shape[-1], _ptr(br),
            br.shape[-1], _ptr(dc_sign), _ptr(nz_off), _ptr(qcoeff),
            _ptr(levels), _ptr(out))
        if rc:
            raise ValueError("bad golomb code")
        return qcoeff, int(out[0]), int(out[1]), tx_type


_SCANS: dict = {}
_NZ_OFF: dict = {}


def _scan32(tx_size, tx_type) -> np.ndarray:
    key = (int(tx_size), int(tx_type))
    if key not in _SCANS:
        from .coeffs import scan_for
        _SCANS[key] = np.ascontiguousarray(scan_for(tx_size, tx_type),
                                           dtype=np.int32)
    return _SCANS[key]


def _nz_off(w: int, h: int, shape: int) -> np.ndarray:
    key = (w, h, shape)
    if key not in _NZ_OFF:
        from .coeffs import _nz_ctx_offset_2d
        _NZ_OFF[key] = np.ascontiguousarray(_nz_ctx_offset_2d(w, h, shape),
                                            dtype=np.int32)
    return _NZ_OFF[key]
