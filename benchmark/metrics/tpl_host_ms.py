"""tpl_host_ms: StageTimer stage ``tpl_host`` (TPL's host work: the
window's decimation and padding, the dependency propagation and the r0
of each picture, inside ``tpl``), ms per picture coded in the window,
summed over the channels."""
from stats import stage_per_frame


def read(run):
    return stage_per_frame(run, ("tpl_host",))
