"""encode_fps: the sum over the channels of each channel's rate: every
picture it coded in its window over its window's whole time (the common
start to its last packet).  Every channel codes on until the last window
has closed, so each window runs under the same load."""
from stats import rate


def read(run):
    return sum(rate(r["frames"], run["start"], r["t_last"])
               for r in run["results"])
