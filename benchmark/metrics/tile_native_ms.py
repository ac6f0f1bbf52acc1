"""tile_native_ms: StageTimer stage ``tile_native`` (the native tile coder's
C calls, one a tile, inside ``encode_tiles``), ms per picture coded in the
window, summed over the channels."""
from stats import stage_per_frame


def read(run):
    return stage_per_frame(run, ("tile_native",))
