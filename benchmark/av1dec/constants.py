"""AV1 enums and geometry constants.

These mirror the normative constants of the AV1 bitstream specification
(block sizes, transform sizes/types, prediction modes).  The reference
encoder defines the same values in Source/Lib/Common/Codec/EbDefinitions.h;
they are fixed by the AV1 spec, not implementation choices.
"""
from __future__ import annotations

import enum


class BlockSize(enum.IntEnum):
    """AV1 BLOCK_SIZES_ALL (spec section 6.10.4)."""

    B4X4 = 0
    B4X8 = 1
    B8X4 = 2
    B8X8 = 3
    B8X16 = 4
    B16X8 = 5
    B16X16 = 6
    B16X32 = 7
    B32X16 = 8
    B32X32 = 9
    B32X64 = 10
    B64X32 = 11
    B64X64 = 12
    B64X128 = 13
    B128X64 = 14
    B128X128 = 15
    B4X16 = 16
    B16X4 = 17
    B8X32 = 18
    B32X8 = 19
    B16X64 = 20
    B64X16 = 21


BLOCK_WIDTH = {
    BlockSize.B4X4: 4, BlockSize.B4X8: 4, BlockSize.B8X4: 8,
    BlockSize.B8X8: 8, BlockSize.B8X16: 8, BlockSize.B16X8: 16,
    BlockSize.B16X16: 16, BlockSize.B16X32: 16, BlockSize.B32X16: 32,
    BlockSize.B32X32: 32, BlockSize.B32X64: 32, BlockSize.B64X32: 64,
    BlockSize.B64X64: 64, BlockSize.B64X128: 64, BlockSize.B128X64: 128,
    BlockSize.B128X128: 128, BlockSize.B4X16: 4, BlockSize.B16X4: 16,
    BlockSize.B8X32: 8, BlockSize.B32X8: 32, BlockSize.B16X64: 16,
    BlockSize.B64X16: 64,
}

BLOCK_HEIGHT = {
    BlockSize.B4X4: 4, BlockSize.B4X8: 8, BlockSize.B8X4: 4,
    BlockSize.B8X8: 8, BlockSize.B8X16: 16, BlockSize.B16X8: 8,
    BlockSize.B16X16: 16, BlockSize.B16X32: 32, BlockSize.B32X16: 16,
    BlockSize.B32X32: 32, BlockSize.B32X64: 64, BlockSize.B64X32: 32,
    BlockSize.B64X64: 64, BlockSize.B64X128: 128, BlockSize.B128X64: 64,
    BlockSize.B128X128: 128, BlockSize.B4X16: 16, BlockSize.B16X4: 4,
    BlockSize.B8X32: 32, BlockSize.B32X8: 8, BlockSize.B16X64: 64,
    BlockSize.B64X16: 16,
}


class TxSize(enum.IntEnum):
    """AV1 TX_SIZES_ALL (spec section 6.10.14)."""

    TX_4X4 = 0
    TX_8X8 = 1
    TX_16X16 = 2
    TX_32X32 = 3
    TX_64X64 = 4
    TX_4X8 = 5
    TX_8X4 = 6
    TX_8X16 = 7
    TX_16X8 = 8
    TX_16X32 = 9
    TX_32X16 = 10
    TX_32X64 = 11
    TX_64X32 = 12
    TX_4X16 = 13
    TX_16X4 = 14
    TX_8X32 = 15
    TX_32X8 = 16
    TX_16X64 = 17
    TX_64X16 = 18


TX_WIDTH = {
    TxSize.TX_4X4: 4, TxSize.TX_8X8: 8, TxSize.TX_16X16: 16,
    TxSize.TX_32X32: 32, TxSize.TX_64X64: 64, TxSize.TX_4X8: 4,
    TxSize.TX_8X4: 8, TxSize.TX_8X16: 8, TxSize.TX_16X8: 16,
    TxSize.TX_16X32: 16, TxSize.TX_32X16: 32, TxSize.TX_32X64: 32,
    TxSize.TX_64X32: 64, TxSize.TX_4X16: 4, TxSize.TX_16X4: 16,
    TxSize.TX_8X32: 8, TxSize.TX_32X8: 32, TxSize.TX_16X64: 16,
    TxSize.TX_64X16: 64,
}

TX_HEIGHT = {
    TxSize.TX_4X4: 4, TxSize.TX_8X8: 8, TxSize.TX_16X16: 16,
    TxSize.TX_32X32: 32, TxSize.TX_64X64: 64, TxSize.TX_4X8: 8,
    TxSize.TX_8X4: 4, TxSize.TX_8X16: 16, TxSize.TX_16X8: 8,
    TxSize.TX_16X32: 32, TxSize.TX_32X16: 16, TxSize.TX_32X64: 64,
    TxSize.TX_64X32: 32, TxSize.TX_4X16: 16, TxSize.TX_16X4: 4,
    TxSize.TX_8X32: 32, TxSize.TX_32X8: 8, TxSize.TX_16X64: 64,
    TxSize.TX_64X16: 16,
}


class TxType(enum.IntEnum):
    """AV1 transform types (spec section 6.10.14: TX_TYPES)."""

    DCT_DCT = 0
    ADST_DCT = 1
    DCT_ADST = 2
    ADST_ADST = 3
    FLIPADST_DCT = 4
    DCT_FLIPADST = 5
    FLIPADST_FLIPADST = 6
    ADST_FLIPADST = 7
    FLIPADST_ADST = 8
    IDTX = 9
    V_DCT = 10
    H_DCT = 11
    V_ADST = 12
    H_ADST = 13
    V_FLIPADST = 14
    H_FLIPADST = 15


class PredictionMode(enum.IntEnum):
    """AV1 intra (and inter) Y prediction modes (spec 6.10.17)."""

    DC_PRED = 0
    V_PRED = 1
    H_PRED = 2
    D45_PRED = 3
    D135_PRED = 4
    D113_PRED = 5
    D157_PRED = 6
    D203_PRED = 7
    D67_PRED = 8
    SMOOTH_PRED = 9
    SMOOTH_V_PRED = 10
    SMOOTH_H_PRED = 11
    PAETH_PRED = 12
    # Inter modes follow in the spec ordering.
    NEARESTMV = 13
    NEARMV = 14
    GLOBALMV = 15
    NEWMV = 16
    NEAREST_NEARESTMV = 17
    NEAR_NEARMV = 18
    NEAREST_NEWMV = 19
    NEW_NEARESTMV = 20
    NEAR_NEWMV = 21
    NEW_NEARMV = 22
    GLOBAL_GLOBALMV = 23
    NEW_NEWMV = 24


class UVPredictionMode(enum.IntEnum):
    """AV1 chroma modes: Y modes plus chroma-from-luma."""

    UV_DC_PRED = 0
    UV_V_PRED = 1
    UV_H_PRED = 2
    UV_D45_PRED = 3
    UV_D135_PRED = 4
    UV_D113_PRED = 5
    UV_D157_PRED = 6
    UV_D203_PRED = 7
    UV_D67_PRED = 8
    UV_SMOOTH_PRED = 9
    UV_SMOOTH_V_PRED = 10
    UV_SMOOTH_H_PRED = 11
    UV_PAETH_PRED = 12
    UV_CFL_PRED = 13


class PartitionType(enum.IntEnum):
    """AV1 partition types (spec 6.10.4)."""

    PARTITION_NONE = 0
    PARTITION_HORZ = 1
    PARTITION_VERT = 2
    PARTITION_SPLIT = 3
    PARTITION_HORZ_A = 4
    PARTITION_HORZ_B = 5
    PARTITION_VERT_A = 6
    PARTITION_VERT_B = 7
    PARTITION_HORZ_4 = 8
    PARTITION_VERT_4 = 9


class FrameType(enum.IntEnum):
    """AV1 frame types (spec 6.8.2)."""

    KEY_FRAME = 0
    INTER_FRAME = 1
    INTRA_ONLY_FRAME = 2
    SWITCH_FRAME = 3


class ObuType(enum.IntEnum):
    """AV1 OBU types (spec 6.2.2)."""

    OBU_SEQUENCE_HEADER = 1
    OBU_TEMPORAL_DELIMITER = 2
    OBU_FRAME_HEADER = 3
    OBU_TILE_GROUP = 4
    OBU_METADATA = 5
    OBU_FRAME = 6
    OBU_REDUNDANT_FRAME_HEADER = 7
    OBU_TILE_LIST = 8
    OBU_PADDING = 15


# Superblock geometry.
MAX_SB_SIZE = 128
SB_64 = 64
MI_SIZE = 4            # mode-info unit in pixels
MI_SIZE_LOG2 = 2
MAX_MIB_SIZE_LOG2 = 5  # 128/4 = 32 mi units

# Quantization.
MAX_QINDEX = 255
QINDEX_RANGE = 256

# Reference frames (spec 6.10.24).
NUM_REF_FRAMES = 8
REFS_PER_FRAME = 7
INTRA_FRAME = 0
LAST_FRAME = 1
LAST2_FRAME = 2
LAST3_FRAME = 3
GOLDEN_FRAME = 4
BWDREF_FRAME = 5
ALTREF2_FRAME = 6
ALTREF_FRAME = 7

PRIMARY_REF_NONE = 7
