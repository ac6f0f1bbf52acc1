"""readback_ms: StageTimer stage ``readback`` (the main thread's
device-to-host copies through ``device.to_host``, each with its wait for
the work queued before it, in whatever stage they happen), ms per picture
coded in the window, summed over the channels."""
from stats import stage_per_frame


def read(run):
    return stage_per_frame(run, ("readback",))
