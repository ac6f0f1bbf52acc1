"""frame_latency_p95_ms: per picture sent in the window, from its
send_picture call to the return of the call that handed out its packet,
pooled over the channels; the 95th percentile (nearest rank)."""
from stats import p95


def read(run):
    lat = [x for r in run["results"] for x in r["latencies_ms"]]
    return p95(lat) if lat else None
