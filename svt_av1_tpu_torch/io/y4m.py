"""Y4M and raw-YUV frame I/O.

Behavioral parity with the reference app readers
(SVT-AV1 Source/App/EncApp/EbAppInputy4m.c and the raw-YUV path in
EbAppProcessCmd.c): YUV4MPEG2 header parsing (width/height/framerate/
interlacing/chroma tag), per-frame FRAME marker, 8/10-bit planar frames.

Frames are returned as numpy arrays shaped [H, W] per plane; 10-bit content
uses uint16 (little-endian, like the reference's unpacked 10-bit mode).
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import BinaryIO, Iterator

import numpy as np


@dataclasses.dataclass
class VideoInfo:
    width: int
    height: int
    frame_rate: Fraction
    bit_depth: int = 8
    chroma: str = "420"        # "400" | "420" | "422" | "444"
    interlace: str = "p"


def _chroma_dims(w: int, h: int, chroma: str) -> tuple[int, int]:
    if chroma == "420":
        return (w + 1) // 2, (h + 1) // 2
    if chroma == "422":
        return (w + 1) // 2, h
    if chroma == "444":
        return w, h
    if chroma == "400":
        return 0, 0
    raise ValueError(f"unsupported chroma {chroma}")


class Y4MReader:
    """Iterates (y, u, v) planes from a YUV4MPEG2 stream."""

    MAGIC = b"YUV4MPEG2"

    def __init__(self, f: BinaryIO | str):
        self._own = isinstance(f, str)
        self.f = open(f, "rb") if isinstance(f, str) else f
        self.info = self._parse_header()

    def _parse_header(self) -> VideoInfo:
        line = self.f.readline().rstrip(b"\n")
        if not line.startswith(self.MAGIC):
            raise ValueError("not a Y4M stream")
        width = height = 0
        rate = Fraction(30, 1)
        chroma, depth, interlace = "420", 8, "p"
        for tok in line.split(b" ")[1:]:
            if not tok:
                continue
            key, val = tok[:1], tok[1:].decode()
            if key == b"W":
                width = int(val)
            elif key == b"H":
                height = int(val)
            elif key == b"F":
                num, den = val.split(":")
                rate = Fraction(int(num), int(den))
            elif key == b"C":
                # e.g. 420jpeg, 420mpeg2, 420p10, 422p10, 444, mono
                if val.startswith("mono"):
                    chroma = "400"
                else:
                    chroma = val[:3]
                if "p10" in val:
                    depth = 10
                elif "p12" in val:
                    depth = 12
            elif key == b"I":
                interlace = val
        if not width or not height:
            raise ValueError("Y4M header missing dimensions")
        return VideoInfo(width, height, rate, depth, chroma, interlace)

    def __iter__(self) -> Iterator[tuple[np.ndarray, ...]]:
        return self

    def __next__(self):
        line = self.f.readline()
        if not line:
            raise StopIteration
        if not line.startswith(b"FRAME"):
            raise ValueError("bad Y4M frame marker")
        return read_planar_frame(self.f, self.info)

    def close(self):
        if self._own:
            self.f.close()


def read_planar_frame(f: BinaryIO, info: VideoInfo):
    dtype = np.uint8 if info.bit_depth == 8 else np.dtype("<u2")
    w, h = info.width, info.height
    cw, ch = _chroma_dims(w, h, info.chroma)

    def plane(pw, ph):
        nbytes = pw * ph * np.dtype(dtype).itemsize
        raw = f.read(nbytes)
        if len(raw) != nbytes:
            raise EOFError("truncated frame")
        return np.frombuffer(raw, dtype=dtype).reshape(ph, pw)

    y = plane(w, h)
    if info.chroma == "400":
        return (y,)
    u = plane(cw, ch)
    v = plane(cw, ch)
    return (y, u, v)


class Y4MWriter:
    def __init__(self, f: BinaryIO | str, info: VideoInfo):
        self._own = isinstance(f, str)
        self.f = open(f, "wb") if isinstance(f, str) else f
        self.info = info
        ctag = {8: info.chroma, 10: info.chroma + "p10"}[info.bit_depth]
        if info.chroma == "400":
            ctag = "mono" if info.bit_depth == 8 else "mono10"
        self.f.write(
            b"YUV4MPEG2 W%d H%d F%d:%d I%s A0:0 C%s\n"
            % (info.width, info.height, info.frame_rate.numerator,
               info.frame_rate.denominator, info.interlace.encode(),
               ctag.encode())
        )

    def write(self, planes):
        self.f.write(b"FRAME\n")
        for p in planes:
            self.f.write(np.ascontiguousarray(p).tobytes())

    def close(self):
        if self._own:
            self.f.close()


def read_yuv_frames(path: str, info: VideoInfo, n_frames: int = -1):
    """Raw planar YUV reader (the reference's default input path)."""
    frames = []
    with open(path, "rb") as f:
        while n_frames < 0 or len(frames) < n_frames:
            try:
                frames.append(read_planar_frame(f, info))
            except EOFError:
                break
    return frames
