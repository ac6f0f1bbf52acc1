"""device_busy_pct: the share of the window in which the card ran any
channel's kernel or copy: the union of the channels' device intervals
from their profiler traces, on the clock the processes share, in %."""


def read(run):
    tr = run.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100 * tr["busy_s"] / tr["window_s"]
