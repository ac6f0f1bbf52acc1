"""tile_dry_run_ms: StageTimer stage ``tile_dry_run`` (the Python dry run of
the partition plan and its flattening into the native tile coder's
arguments, inside ``encode_tiles``), ms per picture coded in the window,
summed over the channels."""
from stats import stage_per_frame


def read(run):
    return stage_per_frame(run, ("tile_dry_run",))
