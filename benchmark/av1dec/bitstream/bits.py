"""Uncompressed-header bit I/O (AV1 spec section 4 descriptors).

Implements the spec's f(n), uvlc(), le(n), leb128(), su(n), ns(n) read and
write descriptors used by OBU and sequence/frame headers.  Parity
references: writer Source/Lib/Encoder/Codec/EbEntropyCoding.c (OBU
assembly), reader Source/Lib/Decoder/Codec/EbDecBitstream.c.
"""
from __future__ import annotations


class BitWriter:
    """MSB-first bit writer."""

    def __init__(self):
        self._bits: int = 0        # accumulated value
        self._nbits: int = 0

    def f(self, value: int, n: int) -> None:
        assert 0 <= value < (1 << n), (value, n)
        self._bits = (self._bits << n) | value
        self._nbits += n

    def flag(self, v) -> None:
        self.f(1 if v else 0, 1)

    def uvlc(self, value: int) -> None:
        shifted = value + 1
        leading = shifted.bit_length() - 1
        self.f(0, leading)          # leading zeros
        self.f(shifted, leading + 1)

    def su(self, value: int, n: int) -> None:
        """Signed integer in n+1 bits (value + sign bit layout per spec su)."""
        self.f(value & ((1 << n) - 1), n)

    def ns(self, value: int, n: int) -> None:
        """Non-symmetric encoding of value in [0, n)."""
        w = n.bit_length()
        m = (1 << w) - n
        if value < m:
            self.f(value, w - 1)
        else:
            extra = value - m
            self.f(m + (extra >> 1), w - 1)
            self.f(extra & 1, 1)

    def le(self, value: int, nbytes: int) -> None:
        for i in range(nbytes):
            self.f((value >> (8 * i)) & 0xFF, 8)

    def byte_align(self) -> None:
        pad = (-self._nbits) % 8
        if pad:
            self.f(0, pad)

    def trailing_bits(self) -> None:
        """trailing_bits(): a 1 then zeros to a byte boundary."""
        self.f(1, 1)
        self.byte_align()

    @property
    def bit_count(self) -> int:
        return self._nbits

    def bytes(self) -> bytes:
        assert self._nbits % 8 == 0, "call byte_align()/trailing_bits() first"
        return self._bits.to_bytes(self._nbits // 8, "big") if self._nbits else b""


class BitReader:
    """MSB-first bit reader."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0               # bit position

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def flag(self) -> bool:
        return bool(self.f(1))

    def uvlc(self) -> int:
        leading = 0
        while self.f(1) == 0:
            leading += 1
            if leading > 32:
                raise ValueError("bad uvlc")
        if leading == 0:
            return 0
        return (1 << leading) - 1 + self.f(leading)

    def su(self, n: int) -> int:
        v = self.f(n)
        sign_bit = 1 << (n - 1)
        return v - 2 * (v & sign_bit)

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.f(1)

    def le(self, nbytes: int) -> int:
        v = 0
        for i in range(nbytes):
            v |= self.f(8) << (8 * i)
        return v

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    @property
    def byte_pos(self) -> int:
        return (self.pos + 7) >> 3


def leb128_encode(value: int, fixed_size: int = 0) -> bytes:
    """Unsigned LEB128 (spec 4.10.5).  ``fixed_size`` pads to that many
    bytes (the reference writes obu_size with padding in some paths)."""
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value or (fixed_size and len(out) + 1 < fixed_size):
            out.append(byte | 0x80)
        else:
            out.append(byte)
            break
    while fixed_size and len(out) < fixed_size:
        out[-1] |= 0x80
        out.append(0)
    return bytes(out)


def leb128_decode(data: bytes, pos: int = 0) -> tuple[int, int]:
    """Returns (value, new_pos)."""
    value = 0
    for i in range(8):
        byte = data[pos + i]
        value |= (byte & 0x7F) << (7 * i)
        if not (byte & 0x80):
            return value, pos + i + 1
    raise ValueError("leb128 too long")
