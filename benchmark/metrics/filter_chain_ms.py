"""filter_chain_ms: StageTimer stage ``dlf_cdef`` (``ops/filter_chain.py``: K2-K4), ms per
picture coded in the window."""
from stats import stage_per_frame


def read(run):
    return stage_per_frame(run, ("dlf_cdef",))
