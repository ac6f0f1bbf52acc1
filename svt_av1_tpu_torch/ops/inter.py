"""Inter prediction: sub-pel convolution (single-reference path).

Normative AV1 convolve for motion compensation (behavioral parity:
svt_av1_convolve_2d_sr_c / _x_sr / _y_sr / _2d_copy,
SVT-AV1 Source/Lib/Common/Codec/convolve.c + EbInterPrediction.c
filter tables).  Formulated as batched separable filters over [..., H, W]
arrays: on TPU, the taps become small stacked multiply-adds on the VPU,
and the batch dimension (blocks) fills the lanes.

FILTER_BITS = 7; the 2D path rounds by round_0 (=3 for 8-bit) after the
horizontal pass and round_1 (=11 here) after the vertical, matching the
reference's ConvolveParams for the single-ref no-dist-wtd case.
"""
from __future__ import annotations

import functools

import numpy as np

from ..entropy.tables import table

FILTER_BITS = 7
ROUND0_BITS_8 = 3

# InterpFilter enum (spec): EIGHTTAP_REGULAR, EIGHTTAP_SMOOTH, MULTITAP_SHARP,
# BILINEAR
REGULAR, SMOOTH, SHARP, BILINEAR = 0, 1, 2, 3

_FILTER_TABLE = {
    (REGULAR, 8): "sub_pel_filters_8",
    (SMOOTH, 8): "sub_pel_filters_8smooth",
    (SHARP, 8): "sub_pel_filters_8sharp",
    (BILINEAR, 8): "bilinear_filters",
    (REGULAR, 4): "sub_pel_filters_4",
    (SMOOTH, 4): "sub_pel_filters_4smooth",
}


@functools.cache
def interp_kernel(filter_kind: int, subpel_q4: int, w: int = 8) -> np.ndarray:
    """8-tap kernel for a subpel phase (av1_get_interp_filter_subpel_kernel;
    the 4-tap variants are stored zero-padded to 8 taps, so all paths use
    the 8-tap math).  Blocks with w <= 4 use the 4-tap tables
    (av1_get_interp_filter_params_with_block_size)."""
    if w <= 4 and filter_kind in (REGULAR, SHARP):
        name = _FILTER_TABLE[(REGULAR, 4)]
    elif w <= 4 and filter_kind == SMOOTH:
        name = _FILTER_TABLE[(SMOOTH, 4)]
    else:
        name = _FILTER_TABLE[(filter_kind, 8)]
    return table(name)[subpel_q4 & 15].astype(np.int32)


def convolve_2d_sr(src, src_x: int, src_y: int, w: int, h: int,
                   subpel_x_q4: int, subpel_y_q4: int,
                   filter_x: int = REGULAR, filter_y: int = REGULAR,
                   bd: int = 8, xp=np):
    """Motion-compensated block fetch with sub-pel interpolation.

    src: padded reference plane; (src_x, src_y) the integer position of
    the block's top-left sample (sub-pel offsets separate).  Requires 3
    samples of margin above/left and 4 below/right within src.
    """
    # single-reference ConvolveParams (convolve.h:44): round_0 = 3,
    # round_1 = 2*FILTER_BITS - round_0 = 11, final shift bits = 0
    round_0 = ROUND0_BITS_8
    round_1 = 2 * FILTER_BITS - round_0

    has_x = subpel_x_q4 & 15
    has_y = subpel_y_q4 & 15
    if not has_x and not has_y:
        blk = src[..., src_y:src_y + h, src_x:src_x + w]
        return blk.astype(xp.int32)

    if has_x and has_y:
        xf = interp_kernel(filter_x, subpel_x_q4, w)
        yf = interp_kernel(filter_y, subpel_y_q4, h)
        im_h = h + 7
        rows = src[..., src_y - 3:src_y - 3 + im_h, src_x - 3:src_x + w + 4]
        rows = rows.astype(xp.int32)
        acc = xp.zeros(rows.shape[:-1] + (w,), dtype=xp.int32)
        acc = acc + (1 << (bd + FILTER_BITS - 1))
        for k in range(8):
            acc = acc + xf[k] * rows[..., :, k:k + w]
        im = (acc + (1 << (round_0 - 1))) >> round_0
        offset_bits = bd + 2 * FILTER_BITS - round_0
        acc2 = xp.full(im.shape[:-2] + (h, w), 1 << offset_bits, dtype=xp.int32)
        for k in range(8):
            acc2 = acc2 + yf[k] * im[..., k:k + h, :]
        res = ((acc2 + (1 << (round_1 - 1))) >> round_1) - (
            (1 << (offset_bits - round_1)) + (1 << (offset_bits - round_1 - 1)))
        return xp.clip(res, 0, (1 << bd) - 1)

    if has_x:
        xf = interp_kernel(filter_x, subpel_x_q4, w)
        rows = src[..., src_y:src_y + h, src_x - 3:src_x + w + 4].astype(xp.int32)
        acc = xp.zeros(rows.shape[:-1] + (w,), dtype=xp.int32)
        for k in range(8):
            acc = acc + xf[k] * rows[..., :, k:k + w]
        # x-only: round by FILTER_BITS - round_0 then round_0 total
        bits = FILTER_BITS - round_0
        acc = (acc + (1 << (round_0 - 1))) >> round_0
        out = (acc + (1 << (bits - 1))) >> bits
        return xp.clip(out, 0, (1 << bd) - 1)

    yf = interp_kernel(filter_y, subpel_y_q4, h)
    cols = src[..., src_y - 3:src_y + h + 4, src_x:src_x + w].astype(xp.int32)
    acc = xp.zeros(cols.shape[:-2] + (h, w), dtype=xp.int32)
    for k in range(8):
        acc = acc + yf[k] * cols[..., k:k + h, :]
    out = (acc + (1 << (FILTER_BITS - 1))) >> FILTER_BITS
    return xp.clip(out, 0, (1 << bd) - 1)


def convolve_2d_sr_torch(src, src_x: int, src_y: int, w: int, h: int,
                         subpel_x_q4: int, subpel_y_q4: int, bd: int = 8):
    """``convolve_2d_sr`` with REGULAR taps on a batch of torch patches
    ``src`` [..., H, W] (int32 result [..., h, w]): the same rounding,
    offset bits and clip, step for step.  The plain version of the
    quarter-pel refinement (ops/bme.py) runs it on the card's tensors."""
    import torch

    round_0 = ROUND0_BITS_8
    round_1 = 2 * FILTER_BITS - round_0
    has_x = subpel_x_q4 & 15
    has_y = subpel_y_q4 & 15
    src = src.to(torch.int32)
    if not has_x and not has_y:
        return src[..., src_y:src_y + h, src_x:src_x + w].clone()
    xf = [int(v) for v in interp_kernel(REGULAR, subpel_x_q4, w)]
    yf = [int(v) for v in interp_kernel(REGULAR, subpel_y_q4, h)]
    if has_x and has_y:
        rows = src[..., src_y - 3:src_y + h + 4, src_x - 3:src_x + w + 4]
        acc = torch.full(rows.shape[:-1] + (w,), 1 << (bd + FILTER_BITS - 1),
                         dtype=torch.int32, device=src.device)
        for k in range(8):
            acc = acc + xf[k] * rows[..., :, k:k + w]
        im = (acc + (1 << (round_0 - 1))) >> round_0
        offset_bits = bd + 2 * FILTER_BITS - round_0
        acc2 = torch.full(im.shape[:-2] + (h, w), 1 << offset_bits,
                          dtype=torch.int32, device=src.device)
        for k in range(8):
            acc2 = acc2 + yf[k] * im[..., k:k + h, :]
        res = ((acc2 + (1 << (round_1 - 1))) >> round_1) - (
            (1 << (offset_bits - round_1))
            + (1 << (offset_bits - round_1 - 1)))
        return res.clamp(0, (1 << bd) - 1)
    if has_x:
        rows = src[..., src_y:src_y + h, src_x - 3:src_x + w + 4]
        acc = torch.zeros(rows.shape[:-1] + (w,), dtype=torch.int32,
                          device=src.device)
        for k in range(8):
            acc = acc + xf[k] * rows[..., :, k:k + w]
        bits = FILTER_BITS - round_0
        acc = (acc + (1 << (round_0 - 1))) >> round_0
        return ((acc + (1 << (bits - 1))) >> bits).clamp(0, (1 << bd) - 1)
    cols = src[..., src_y - 3:src_y + h + 4, src_x:src_x + w]
    acc = torch.zeros(cols.shape[:-2] + (h, w), dtype=torch.int32,
                      device=src.device)
    for k in range(8):
        acc = acc + yf[k] * cols[..., k:k + h, :]
    out = (acc + (1 << (FILTER_BITS - 1))) >> FILTER_BITS
    return out.clamp(0, (1 << bd) - 1)


# --------------------------------------------------------------------------
# Compound (two-reference) path: jnt_convolve without dist weighting
# (svt_av1_jnt_convolve_{2d,x,y,2d_copy}_c, EbInterPrediction.c:552+,
#  use_jnt_comp_avg = 0 since the sequence signals enable_jnt_comp = 0)
# --------------------------------------------------------------------------

def _rpot(v, n, xp=np):
    return (v + (1 << (n - 1))) >> n


def jnt_round_offset(bd: int) -> int:
    offset_bits = bd + 2 * FILTER_BITS - ROUND0_BITS_8
    r1 = 7                       # COMPOUND_ROUND1_BITS
    return (1 << (offset_bits - r1)) + (1 << (offset_bits - r1 - 1))


def jnt_convolve(src, src_x: int, src_y: int, w: int, h: int,
                 subpel_x_q4: int, subpel_y_q4: int,
                 filter_x: int = REGULAR, filter_y: int = REGULAR,
                 bd: int = 8, xp=np):
    """One reference's contribution to a compound prediction: the
    intermediate CONV-domain block (int32, offset included)."""
    round_0, round_1 = ROUND0_BITS_8, 7
    offset_bits = bd + 2 * FILTER_BITS - round_0
    round_offset = jnt_round_offset(bd)
    has_x = subpel_x_q4 & 15
    has_y = subpel_y_q4 & 15

    if not has_x and not has_y:
        bits = 2 * FILTER_BITS - round_1 - round_0
        blk = src[..., src_y:src_y + h, src_x:src_x + w].astype(xp.int32)
        return (blk << bits) + round_offset

    if has_x and has_y:
        xf = interp_kernel(filter_x, subpel_x_q4, w)
        yf = interp_kernel(filter_y, subpel_y_q4, h)
        im_h = h + 7
        rows = src[..., src_y - 3:src_y - 3 + im_h,
                   src_x - 3:src_x + w + 4].astype(xp.int32)
        acc = xp.zeros(rows.shape[:-1] + (w,), dtype=xp.int32) \
            + (1 << (bd + FILTER_BITS - 1))
        for k in range(8):
            acc = acc + xf[k] * rows[..., :, k:k + w]
        im = _rpot(acc, round_0, xp)
        acc2 = xp.full(im.shape[:-2] + (h, w), 1 << offset_bits,
                       dtype=xp.int32)
        for k in range(8):
            acc2 = acc2 + yf[k] * im[..., k:k + h, :]
        return _rpot(acc2, round_1, xp)

    if has_x:
        bits = FILTER_BITS - round_1
        xf = interp_kernel(filter_x, subpel_x_q4, w)
        rows = src[..., src_y:src_y + h,
                   src_x - 3:src_x + w + 4].astype(xp.int32)
        acc = xp.zeros(rows.shape[:-1] + (w,), dtype=xp.int32)
        for k in range(8):
            acc = acc + xf[k] * rows[..., :, k:k + w]
        return (_rpot(acc, round_0, xp) << bits) + round_offset

    bits = FILTER_BITS - round_0
    yf = interp_kernel(filter_y, subpel_y_q4, h)
    cols = src[..., src_y - 3:src_y + h + 4, src_x:src_x + w].astype(xp.int32)
    acc = xp.zeros(cols.shape[:-2] + (h, w), dtype=xp.int32)
    for k in range(8):
        acc = acc + yf[k] * cols[..., k:k + h, :]
    return _rpot(acc << bits, round_1, xp) + round_offset


def jnt_average(buf0, buf1, bd: int = 8, xp=np):
    """COMPOUND_AVERAGE of two CONV-domain blocks -> pixels."""
    round_0, round_1 = ROUND0_BITS_8, 7
    round_bits = 2 * FILTER_BITS - round_0 - round_1
    tmp = ((buf0 + buf1) >> 1) - jnt_round_offset(bd)
    return xp.clip(_rpot(tmp, round_bits, xp), 0, (1 << bd) - 1)
