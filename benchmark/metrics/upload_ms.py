"""upload_ms: StageTimer stage ``upload`` (the main thread's host-to-device
copies through ``device.to_device``, in whatever stage they happen), ms
per picture coded in the window, summed over the channels."""
from stats import stage_per_frame


def read(run):
    return stage_per_frame(run, ("upload",))
