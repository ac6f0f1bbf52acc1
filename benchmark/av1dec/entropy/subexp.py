"""Subexponential literal coding over the range coder's raw-bit path
(spec 4.10.6 su/ns, 5.9.x decode_signed_subexp_with_ref; decoder mirror
EbDecParseBlock.c decode_subexp_bool:2654).

Symmetric io style: each helper takes the codec's SymbolWriter/Reader
shim and returns the (en/de)coded value, so encoder and decoder share
one code path.
"""
from __future__ import annotations


def _recenter(r: int, val: int) -> int:
    if val > 2 * r:
        return val
    if val >= r:
        return 2 * (val - r)
    return 2 * (r - val) - 1


def _inverse_recenter(r: int, v: int) -> int:
    """spec inverse_recenter (EbDecUtils.c:311): odd codes go below r."""
    if v > 2 * r:
        return v
    if v & 1:
        return r - ((v + 1) >> 1)
    return r + (v >> 1)


def code_ns(io, value, n: int) -> int:
    """Non-symmetric literal in [0, n) (aom_read_ns_ae_:
    w = FloorLog2(n) + 1, short codes for the first m values)."""
    w = n.bit_length()
    m = (1 << w) - n
    if n == 1:
        return 0
    if io.is_decoder:
        v = io.literal(None, w - 1) if w > 1 else 0
        if v < m:
            return v
        ext = io.literal(None, 1)
        return (v << 1) - m + ext
    value = int(value)
    if value < m:
        if w > 1:
            io.literal(value, w - 1)
        return value
    v = (value + m) >> 1
    if w > 1:
        io.literal(v, w - 1)
    io.literal((value + m) & 1, 1)
    return value


def code_subexp(io, value, num_syms: int, k: int) -> int:
    i = 0
    mk = 0
    while True:
        b2 = (k + i - 1) if i else k
        a = 1 << b2
        if num_syms <= mk + 3 * a:
            return code_ns(io, None if value is None else value - mk,
                           num_syms - mk) + mk
        if io.is_decoder:
            more = io.literal(None, 1)
        else:
            more = int(value >= mk + a)
            io.literal(more, 1)
        if more:
            i += 1
            mk += a
        else:
            v = io.literal(None if value is None else value - mk, b2)
            return v + mk


def code_unsigned_subexp_ref(io, value, mx: int, k: int, r: int) -> int:
    if (r << 1) <= mx:
        v = code_subexp(io, None if value is None else _recenter(r, value),
                        mx, k)
        return _inverse_recenter(r, v)
    v = code_subexp(
        io, None if value is None else _recenter(mx - 1 - r, mx - 1 - value),
        mx, k)
    return mx - 1 - _inverse_recenter(mx - 1 - r, v)


def code_signed_subexp_ref(io, value, low: int, high: int, k: int,
                           r: int) -> int:
    x = code_unsigned_subexp_ref(
        io, None if value is None else value - low, high - low, k, r - low)
    return x + low
