"""stream_kbps: the bits of each channel's packets for its first
``measure_pictures`` pictures (a fixed set, whole intra periods or
units), at the configuration's frame rate; the mean over the channels."""
from fractions import Fraction


def read(run):
    fps = float(Fraction(run["config"]["encoder"]["frame_rate"]))
    m = run["traffic"]["measure_pictures"]
    got = [r["stream_bytes"] for r in run["results"]]
    if any(b is None for b in got):
        return None
    return sum(8 * b * fps / m / 1e3 for b in got) / len(got)
