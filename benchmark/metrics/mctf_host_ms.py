"""mctf_host_ms: StageTimer stage ``mctf_host`` (MCTF's host work: the
padding, block motion compensation, noise estimate, float64 weights,
accumulation and normalisation, inside ``temporal_filter``), ms per
picture coded in the window, summed over the channels."""
from stats import stage_per_frame


def read(run):
    return stage_per_frame(run, ("mctf_host",))
