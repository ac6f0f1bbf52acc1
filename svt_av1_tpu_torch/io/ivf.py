"""IVF container reader/writer.

Parity with the reference's stream I/O (writer: write_ivf_stream_header /
write_ivf_frame_header in SVT-AV1 Source/App/EncApp/EbAppProcessCmd.c;
reader: SVT-AV1 Source/App/DecApp/EbFileUtils.c).

IVF layout: 32-byte file header ("DKIF", version 0, header size 32, fourcc
"AV01", width/height, timebase, frame count), then per frame a 12-byte
header (payload size u32le, pts u64le) followed by the OBU payload.
"""
from __future__ import annotations

import struct
from fractions import Fraction
from typing import BinaryIO, Iterator


class IvfWriter:
    def __init__(self, f: BinaryIO | str, width: int, height: int,
                 frame_rate: Fraction = Fraction(30, 1), fourcc: bytes = b"AV01"):
        self._own = isinstance(f, str)
        self.f = open(f, "wb") if isinstance(f, str) else f
        self.frame_count = 0
        self._header_pos = self.f.tell()
        self.f.write(struct.pack(
            "<4sHH4sHHIII4x", b"DKIF", 0, 32, fourcc,
            width, height, frame_rate.numerator, frame_rate.denominator, 0))

    def write_frame(self, payload: bytes, pts: int):
        self.f.write(struct.pack("<IQ", len(payload), pts))
        self.f.write(payload)
        self.frame_count += 1

    def close(self):
        # Back-patch the frame count like the reference app does on EOS.
        if self.f.seekable():
            end = self.f.tell()
            self.f.seek(self._header_pos + 24)
            self.f.write(struct.pack("<I", self.frame_count))
            self.f.seek(end)
        if self._own:
            self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class IvfReader:
    def __init__(self, f: BinaryIO | str):
        self._own = isinstance(f, str)
        self.f = open(f, "rb") if isinstance(f, str) else f
        hdr = self.f.read(32)
        if len(hdr) != 32 or hdr[:4] != b"DKIF":
            raise ValueError("not an IVF file")
        (_, _, hdr_size, self.fourcc, self.width, self.height,
         tb_num, tb_den, self.frame_count) = struct.unpack("<4sHH4sHHIII", hdr[:28])
        self.time_base = Fraction(tb_num, tb_den) if tb_den else Fraction(30, 1)
        if hdr_size > 32:
            self.f.read(hdr_size - 32)

    def __iter__(self) -> Iterator[tuple[bytes, int]]:
        return self

    def __next__(self) -> tuple[bytes, int]:
        hdr = self.f.read(12)
        if len(hdr) < 12:
            raise StopIteration
        size, pts = struct.unpack("<IQ", hdr)
        payload = self.f.read(size)
        if len(payload) != size:
            raise ValueError("truncated IVF frame")
        return payload, pts

    def close(self):
        if self._own:
            self.f.close()
