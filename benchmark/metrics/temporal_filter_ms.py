"""temporal_filter_ms: the encoder's StageTimer stage ``temporal_filter`` (MCTF,
``pipeline/mctf.py``) in ms per picture coded in the window, summed over
the channels."""
from stats import stage_per_frame


def read(run):
    return stage_per_frame(run, ("temporal_filter",))
