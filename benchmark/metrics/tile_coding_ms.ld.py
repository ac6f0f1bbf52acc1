"""tile_coding_ms.ld: as tile_coding_ms.ra, in the low-delay cells."""
from stats import stage_per_frame


def read(run):
    return stage_per_frame(run, ("encode_tiles", "plan"))
