"""tpl_ms: StageTimer stage ``tpl`` (``pipeline/tpl.py``), ms per picture coded
in the window, summed over the channels."""
from stats import stage_per_frame


def read(run):
    return stage_per_frame(run, ("tpl",))
