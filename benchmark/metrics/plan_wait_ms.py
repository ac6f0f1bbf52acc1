"""plan_wait_ms: StageTimer stage ``plan_wait`` (the main thread blocked on
the prefetch worker's plan of the picture it is about to code, inside
``plan``), ms per picture coded in the window, summed over the channels."""
from stats import stage_per_frame


def read(run):
    return stage_per_frame(run, ("plan_wait",))
