"""k1_roofline: K1's least time at the 1080p shapes (stats.
k1_launch_bound_s) times its launches in the traced window, over its
device time in the channels' profiler traces, in %."""
from stats import buffer_dims, k1_launch_bound_s


def read(run):
    tr = run.get("trace")
    if not tr or not tr["k1_launches"] or tr["k1_s"] <= 0:
        return None
    enc = run["config"]["encoder"]
    bw, bh = buffer_dims(enc["source_width"], enc["source_height"],
                         enc["super_block_size"])
    return 100 * tr["k1_launches"] * k1_launch_bound_s(bw, bh) / tr["k1_s"]
