"""Motion vector entropy coding (AV1 spec 5.11.31 mv(), 8.3.4).

Behavioral parity: encoder svt_av1_encode_mv / encode_mv_component
(EbEntropyCoding.c:1767), decoder read_mv / read_mv_component
(EbDecParseInterBlock.c:1337).  The NMV default CDFs are the spec values
(EbCabacContextModel.c:791 default_nmv_context), stored in the same
icdf+counter layout as every other context.
"""
from __future__ import annotations

import numpy as np

from .ec import RangeDecoder, RangeEncoder
from .ec import icdf_with_counter

MV_JOINTS = 4
MV_JOINT_ZERO, MV_JOINT_HNZVZ, MV_JOINT_HZVNZ, MV_JOINT_HNZVNZ = range(4)
MV_CLASSES = 11
CLASS0_BITS = 1
CLASS0_SIZE = 1 << CLASS0_BITS
MV_OFFSET_BITS = MV_CLASSES + CLASS0_BITS - 2    # 10
MV_FP_SIZE = 4

# subpel precision
MV_SUBPEL_NONE = -1
MV_SUBPEL_LOW_PRECISION = 0
MV_SUBPEL_HIGH_PRECISION = 1


def _cdf2(p):
    return icdf_with_counter([p, 32768])


def _cdf4(a, b, c):
    return icdf_with_counter([a, b, c, 32768])


class NmvComponent:
    def __init__(self):
        self.classes = icdf_with_counter(
            [28672, 30976, 31858, 32320, 32551, 32656, 32740, 32757, 32762,
             32767, 32768])
        self.class0_fp = np.stack([_cdf4(16384, 24576, 26624),
                                   _cdf4(12288, 21248, 24128)])
        self.fp = _cdf4(8192, 17408, 21248)
        self.sign = _cdf2(128 * 128)
        self.class0_hp = _cdf2(160 * 128)
        self.hp = _cdf2(128 * 128)
        self.class0 = _cdf2(216 * 128)
        self.bits = np.stack([_cdf2(128 * m) for m in
                              (136, 140, 148, 160, 176, 192, 224, 234, 234, 240)])


class NmvContext:
    """Adaptive MV coding context (joints + 2 components)."""

    def __init__(self):
        self.joints = _cdf4(4096, 11264, 19328)
        self.comps = [NmvComponent(), NmvComponent()]


def get_mv_class(z: int) -> tuple[int, int]:
    """(class, offset) for magnitude-1 value z (svt_av1_get_mv_class)."""
    if z >= CLASS0_SIZE * 4096:
        c = MV_CLASSES - 1
    else:
        c = max((z >> 3).bit_length() - 1, 0)
    base = 0 if c == 0 else CLASS0_SIZE << (c + 2)
    return c, z - base


def mv_joint(diff_row: int, diff_col: int) -> int:
    if diff_row == 0:
        return MV_JOINT_ZERO if diff_col == 0 else MV_JOINT_HNZVZ
    return MV_JOINT_HZVNZ if diff_col == 0 else MV_JOINT_HNZVNZ


def _encode_component(enc: RangeEncoder, comp: int, mvcomp: NmvComponent,
                      precision: int) -> None:
    sign = int(comp < 0)
    mag = -comp if sign else comp
    mv_class, offset = get_mv_class(mag - 1)
    d = offset >> 3
    fr = (offset >> 1) & 3
    hp = offset & 1
    enc.encode_symbol(sign, mvcomp.sign, 2)
    enc.encode_symbol(mv_class, mvcomp.classes, MV_CLASSES)
    if mv_class == 0:
        enc.encode_symbol(d, mvcomp.class0, CLASS0_SIZE)
    else:
        n = mv_class + CLASS0_BITS - 1
        for i in range(n):
            enc.encode_symbol((d >> i) & 1, mvcomp.bits[i], 2)
    if precision > MV_SUBPEL_NONE:
        cdf = mvcomp.class0_fp[d] if mv_class == 0 else mvcomp.fp
        enc.encode_symbol(fr, cdf, MV_FP_SIZE)
    if precision > MV_SUBPEL_LOW_PRECISION:
        cdf = mvcomp.class0_hp if mv_class == 0 else mvcomp.hp
        enc.encode_symbol(hp, cdf, 2)


def encode_mv(enc: RangeEncoder, mv_row: int, mv_col: int,
              ref_row: int, ref_col: int, ctx: NmvContext,
              precision: int) -> None:
    dr, dc = mv_row - ref_row, mv_col - ref_col
    j = mv_joint(dr, dc)
    enc.encode_symbol(j, ctx.joints, MV_JOINTS)
    if j in (MV_JOINT_HZVNZ, MV_JOINT_HNZVNZ):
        _encode_component(enc, dr, ctx.comps[0], precision)
    if j in (MV_JOINT_HNZVZ, MV_JOINT_HNZVNZ):
        _encode_component(enc, dc, ctx.comps[1], precision)


def _decode_component(dec: RangeDecoder, mvcomp: NmvComponent,
                      use_subpel: bool, use_hp: bool) -> int:
    sign = dec.decode_symbol(mvcomp.sign, 2)
    mv_class = dec.decode_symbol(mvcomp.classes, MV_CLASSES)
    class0 = mv_class == 0
    if class0:
        d = dec.decode_symbol(mvcomp.class0, CLASS0_SIZE)
        mag = 0
    else:
        d = 0
        for i in range(mv_class):
            d |= dec.decode_symbol(mvcomp.bits[i], 2) << i
        mag = CLASS0_SIZE << (mv_class + 2)
    fr = dec.decode_symbol(mvcomp.class0_fp[d] if class0 else mvcomp.fp,
                           MV_FP_SIZE) if use_subpel else 3
    hp = dec.decode_symbol(mvcomp.class0_hp if class0 else mvcomp.hp,
                           2) if use_hp else 1
    mag += ((d << 3) | (fr << 1) | hp) + 1
    return -mag if sign else mag


def decode_mv(dec: RangeDecoder, ref_row: int, ref_col: int,
              ctx: NmvContext, precision: int) -> tuple[int, int]:
    j = dec.decode_symbol(ctx.joints, MV_JOINTS)
    dr = dc = 0
    if j in (MV_JOINT_HZVNZ, MV_JOINT_HNZVNZ):
        dr = _decode_component(dec, ctx.comps[0],
                               precision > MV_SUBPEL_NONE,
                               precision > MV_SUBPEL_LOW_PRECISION)
    if j in (MV_JOINT_HNZVZ, MV_JOINT_HNZVNZ):
        dc = _decode_component(dec, ctx.comps[1],
                               precision > MV_SUBPEL_NONE,
                               precision > MV_SUBPEL_LOW_PRECISION)
    return ref_row + dr, ref_col + dc
