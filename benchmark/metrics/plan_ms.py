"""plan_ms: StageTimer stage ``plan`` (the device plan of ``pipeline/batched_md.py``
and ``pipeline/batched_inter.py``, and the main thread's wait for a
prefetched one), ms per picture coded in the window."""
from stats import stage_per_frame


def read(run):
    return stage_per_frame(run, ("plan",))
