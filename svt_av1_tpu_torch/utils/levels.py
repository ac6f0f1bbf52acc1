"""AV1 level selection (the reference's level.c constraint table,
spec A.3): pick the smallest seq_level_idx whose picture-size, dimension
and display-rate limits cover the configured stream."""
from __future__ import annotations

# (level_idx, max_picture_size, max_h_size, max_v_size, max_display_rate)
LEVELS = (
    (0, 147456, 2048, 1152, 4423680),          # 2.0
    (1, 278784, 2816, 1584, 8363520),          # 2.1
    (4, 665856, 4352, 2448, 19975680),         # 3.0
    (5, 1065024, 5504, 3096, 31950720),        # 3.1
    (8, 2359296, 6144, 3456, 70778880),        # 4.0
    (9, 2359296, 6144, 3456, 141557760),       # 4.1
    (12, 8912896, 8192, 4352, 267386880),      # 5.0
    (13, 8912896, 8192, 4352, 534773760),      # 5.1
    (14, 8912896, 8192, 4352, 1069547520),     # 5.2
    (16, 35651584, 16384, 8704, 1069547520),   # 6.0
    (17, 35651584, 16384, 8704, 2139095040),   # 6.1
    (18, 35651584, 16384, 8704, 4278190080),   # 6.2
)


def pick_seq_level_idx(width: int, height: int, fps: float) -> int:
    """Smallest level covering the stream; falls back to 6.2."""
    pic = width * height
    rate = pic * max(fps, 1.0)
    for idx, max_pic, max_h, max_v, max_rate in LEVELS:
        if pic <= max_pic and width <= max_h and height <= max_v \
                and rate <= max_rate:
            return idx
    return 18
