"""AV1 multi-symbol range (daala entropy) coder.

Bit-exact implementation of the AV1 arithmetic coding process (AV1 spec
sections 8.2 "Boolean decoding" / the od_ec coder).  Behavioral parity
references: encoder SVT-AV1 Source/Lib/Common/Codec/EbBitstreamUnit.c
(od_ec_encode_q15, od_ec_enc_normalize, svt_od_ec_enc_done), decoder
SVT-AV1 Source/Lib/Decoder/Codec/EbDecBitstreamUnit.h
(od_ec_decode_cdf_q15, od_ec_dec_normalize, od_ec_dec_refill).

Probability representation: AOM-style *inverse* CDFs ("icdf"): a uint16
array of ``nsyms + 1`` entries where ``icdf[s] = 32768 - cum_prob(<=s)``,
monotonically non-increasing with ``icdf[nsyms-1] == 0``, and
``icdf[nsyms]`` an adaptation counter.  All default CDF tables and the
adaptation rule use this layout.

The encoder/decoder here are the *serial bit-packing* stage, which is
inherently sequential (carry propagation) and runs per tile on the host;
TPU-side code computes symbol streams and bit-rate estimates in batch.
This Python version is the correctness reference; a C++ twin (see
``svt_av1_tpu_torch/native``) services production packing.
"""
from __future__ import annotations

import numpy as np

PROB_TOP = 1 << 15          # CDF_PROB_TOP
EC_PROB_SHIFT = 6
EC_MIN_PROB = 4
WINDOW = 32                 # OD_EC_WINDOW_SIZE
WINDOW_MASK = (1 << WINDOW) - 1
LOTS_OF_BITS = 0x4000

# CDF adaptation speed per alphabet size (AV1 spec update_cdf; nsyms -> extra
# rate).  Index 0/1 unused.
_NSYMBS2SPEED = (0, 0, 1, 1) + (2,) * 13


def cdf_to_icdf(probs_or_cum: list[int] | np.ndarray) -> np.ndarray:
    """Build an icdf array (without counter) from cumulative Q15 values
    ending at 32768."""
    cum = np.asarray(probs_or_cum, dtype=np.int64)
    assert cum[-1] == PROB_TOP
    return (PROB_TOP - cum).astype(np.uint16)


def icdf_with_counter(cum: list[int]) -> np.ndarray:
    """icdf array + trailing adaptation counter initialized to 0."""
    return np.concatenate([cdf_to_icdf(cum), np.zeros(1, np.uint16)])


def update_cdf(icdf: np.ndarray, val: int, nsymbs: int) -> None:
    """In-place CDF adaptation (AV1 spec 8.4; parity:
    EbCabacContextModel.h:523 update_cdf)."""
    count = int(icdf[nsymbs])
    rate = 3 + (count > 15) + (count > 31) + _NSYMBS2SPEED[nsymbs]
    tmp = PROB_TOP
    for i in range(nsymbs - 1):
        if i == val:
            tmp = 0
        c = int(icdf[i])
        if tmp < c:
            c -= (c - tmp) >> rate
        else:
            c += (tmp - c) >> rate
        icdf[i] = c
    if count < 32:
        icdf[nsymbs] = count + 1


class RangeEncoder:
    """od_ec encoder.  State: 32-bit ``low`` window, 15-bit ``rng``,
    bit-count ``cnt`` (starts at -9: one byte + one carry bit of slack),
    and a pre-carry buffer of 8-bit values + carry bits resolved at
    :meth:`done`."""

    def __init__(self):
        self.low = 0
        self.rng = 0x8000
        self.cnt = -9
        self.precarry: list[int] = []

    # -- core ------------------------------------------------------------
    def _normalize(self, low: int, rng: int) -> None:
        d = 16 - rng.bit_length()
        s = self.cnt + d
        if s >= 0:
            c = self.cnt + 16
            m = (1 << c) - 1
            if s >= 8:
                self.precarry.append((low >> c) & 0xFFFF)
                low &= m
                c -= 8
                m >>= 8
            self.precarry.append((low >> c) & 0xFFFF)
            s = c + d - 24
            low &= m
        self.low = (low << d) & WINDOW_MASK
        self.rng = rng << d
        self.cnt = s

    def encode_cdf(self, s: int, icdf: np.ndarray, nsyms: int) -> None:
        """Encode symbol ``s`` with inverse-CDF ``icdf`` (Q15)."""
        fl = int(icdf[s - 1]) if s > 0 else PROB_TOP
        fh = int(icdf[s])
        low = self.low
        r = self.rng
        n = nsyms - 1
        if fl < PROB_TOP:
            u = (((r >> 8) * (fl >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) \
                + EC_MIN_PROB * (n - (s - 1))
            v = (((r >> 8) * (fh >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) \
                + EC_MIN_PROB * (n - s)
            low = (low + (r - u)) & WINDOW_MASK
            r = u - v
        else:
            r -= (((r >> 8) * (fh >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) \
                + EC_MIN_PROB * (n - s)
        self._normalize(low, r)

    def encode_bool_q15(self, val: int, f: int) -> None:
        """Encode one bit; ``f`` = P(bit == 1) in Q15, 0 < f < 32768."""
        low = self.low
        r = self.rng
        v = (((r >> 8) * (f >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB
        if val:
            low = (low + (r - v)) & WINDOW_MASK
            r = v
        else:
            r -= v
        self._normalize(low, r)

    # -- convenience -----------------------------------------------------
    def encode_bit(self, bit: int) -> None:
        """Equiprobable bit (aom_write_bit semantics: prob 128/256)."""
        self.encode_bool_prob8(bit, 128)

    def encode_bool_prob8(self, bit: int, prob8: int) -> None:
        """Bit with 8-bit probability (aom_write semantics: daala p
        derivation (0x7FFFFF - (p8 << 15) + p8) >> 8)."""
        f = (0x7FFFFF - (prob8 << 15) + prob8) >> 8
        self.encode_bool_q15(bit, f)

    def encode_literal(self, value: int, bits: int) -> None:
        """MSB-first raw bits through the coder (aom_write_literal)."""
        for b in range(bits - 1, -1, -1):
            self.encode_bit((value >> b) & 1)

    def encode_symbol(self, s: int, icdf: np.ndarray, nsyms: int,
                      adapt: bool = True) -> None:
        """Encode + (optionally) adapt, the common in-frame path."""
        self.encode_cdf(s, icdf, nsyms)
        if adapt:
            update_cdf(icdf, s, nsyms)

    def tell_bits(self) -> int:
        """Upper bound of bits produced so far (od_ec_enc_tell parity)."""
        return 8 * len(self.precarry) + self.cnt + 10

    def done(self) -> bytes:
        """Flush and carry-propagate; returns the coded byte string."""
        low = self.low
        c = self.cnt
        s = 10 + c
        m = 0x3FFF
        e = ((low + m) & ~m) | (m + 1)
        out = list(self.precarry)
        while s > 0:
            n = (1 << (c + 16)) - 1
            out.append((e >> (c + 16)) & 0xFFFF)
            e &= n
            s -= 8
            c -= 8
        carry = 0
        data = bytearray(len(out))
        for i in range(len(out) - 1, -1, -1):
            carry += out[i]
            data[i] = carry & 0xFF
            carry >>= 8
        return bytes(data)


class RangeDecoder:
    """od_ec decoder over a byte buffer."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.dif = (1 << (WINDOW - 1)) - 1
        self.rng = 0x8000
        self.cnt = -15
        self._refill()

    def _refill(self) -> None:
        s = WINDOW - 9 - (self.cnt + 15)
        dif = self.dif
        cnt = self.cnt
        pos = self.pos
        end = len(self.data)
        while s >= 0 and pos < end:
            dif ^= self.data[pos] << s
            cnt += 8
            pos += 1
            s -= 8
        if pos >= end:
            cnt = LOTS_OF_BITS
        self.dif = dif
        self.cnt = cnt
        self.pos = pos

    def _normalize(self, dif: int, rng: int, ret: int) -> int:
        d = 16 - rng.bit_length()
        self.cnt -= d
        self.dif = (((dif + 1) << d) - 1) & WINDOW_MASK
        self.rng = rng << d
        if self.cnt < 0:
            self._refill()
        return ret

    def decode_cdf(self, icdf: np.ndarray, nsyms: int) -> int:
        dif = self.dif
        r = self.rng
        n = nsyms - 1
        c = dif >> (WINDOW - 16)
        v = r
        ret = -1
        while True:
            ret += 1
            u = v
            v = (((r >> 8) * (int(icdf[ret]) >> EC_PROB_SHIFT))
                 >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * (n - ret)
            if c >= v:
                break
        r = u - v
        dif -= v << (WINDOW - 16)
        return self._normalize(dif, r, ret)

    def decode_bool_q15(self, f: int) -> int:
        dif = self.dif
        r = self.rng
        v = (((r >> 8) * (f >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB
        vw = v << (WINDOW - 16)
        if dif >= vw:
            ret = 0
            r_new = r - v
            dif -= vw
        else:
            ret = 1
            r_new = v
        return self._normalize(dif, r_new, ret)

    def decode_bit(self) -> int:
        return self.decode_bool_prob8(128)

    def decode_bool_prob8(self, prob8: int) -> int:
        f = (0x7FFFFF - (prob8 << 15) + prob8) >> 8
        return self.decode_bool_q15(f)

    def decode_literal(self, bits: int) -> int:
        value = 0
        for _ in range(bits):
            value = (value << 1) | self.decode_bit()
        return value

    def decode_symbol(self, icdf: np.ndarray, nsyms: int,
                      adapt: bool = True) -> int:
        s = self.decode_cdf(icdf, nsyms)
        if adapt:
            update_cdf(icdf, s, nsyms)
        return s
