"""The plain reference that decides ``correct``, part two: the tile data.

A sample of each channel's packets is decoded with the benchmark's own
AV1 decoder (``av1dec/``, plain Python and NumPy with its symbol decoder
in C; it imports nothing of the program) and every picture it codes or
shows, hidden ones too, is held bit-exact against the reconstruction the
encoder reports for that display.  That ties the reconstructions to the
bitstream: the entropy-coded modes, motion vectors, compound and
coefficients, the deblocking and CDEF the headers state.

The sample: ``decode_packets`` packets (the traffic file's) from a key
frame that the channel coded in its window, drawn from the seed among the
first three; where the channel coded no later key frame (low delay), from
the stream's first packet, so that the sample ends in the window.
"""
from __future__ import annotations

import numpy as np

KEYS_DRAWN_FROM = 3


def sample_start(units: list, first_window_display: int, count: int,
                 seed: int, channel: int) -> int:
    """The packet the decode starts at."""
    keys = [i for i, u in enumerate(units)
            if u["key"] and u["display"] >= first_window_display
            and i + count <= len(units)][:KEYS_DRAWN_FROM]
    if not keys:
        return 0
    return keys[(seed + channel) % len(keys)]


def first_difference(got, want) -> str | None:
    """Where two (y, u, v) pictures first differ, or None."""
    for p, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape:
            return f"plane {p} of shape {a.shape}, reconstruction {b.shape}"
        diff = np.argwhere(a != b)
        if len(diff):
            y, x = diff[0]
            return (f"plane {p}: {len(diff)} samples differ, first at "
                    f"({y}, {x}): {a[y, x]} against {b[y, x]}")
    return None


def decode_sample(packets: list, units: list, start: int, count: int,
                  recon) -> tuple[list, dict]:
    """Decode ``count`` packets from ``start`` and compare each picture
    with ``recon(display)``.  Returns (faults, {display: decoded
    picture}); a packet the decoder refuses ends the sample."""
    from av1dec.decoder import Decoder

    faults, pictures = [], {}
    dec = Decoder()
    dec.read_sequence_header(packets[0])
    end = min(start + count, len(units))
    if end - start < count:
        faults.append(f"{end - start} packets to decode, {count} due")
    for i in range(start, end):
        display = units[i]["display"]
        try:
            dec.decode_frame(packets[i])
        except Exception as e:                       # noqa: BLE001
            faults.append(f"packet {i} (display {display}): the decoder "
                          f"refused it ({type(e).__name__}: {e})")
            break
        want = recon(display)
        if want is None:
            faults.append(f"packet {i}: no reconstruction of display "
                          f"{display}")
            continue
        where = first_difference(dec.last, want)
        if where is not None:
            faults.append(f"packet {i} (display {display}): the decoded "
                          f"picture differs from the reconstruction, "
                          f"{where}")
        pictures[display] = dec.last
    return faults, pictures
