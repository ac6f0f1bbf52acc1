"""The traced run's reading of ``torch.profiler`` in a channel, and the
union of the channels' device timelines in ``run.py``.

Each channel marks the window's start with a ``record_function`` span and
takes ``time.monotonic()`` as it enters it; that span's start in the trace
puts the trace's events on the clock the processes share, so the
channels' device intervals can be joined into one timeline.
"""
from __future__ import annotations

import bisect
import time
import warnings


def short_name(name: str) -> str:
    """A device event's name without its parameter list (copies keep
    their direction)."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name
    name = name.split("(")[0]
    return name[5:] if name.startswith("void ") else name


def merge(intervals: list) -> list:
    """The union of [start, end] intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(busy: list, start: float, end: float) -> list:
    """[(gap start, gap length)] of the idle time in [start, end] between
    the disjoint sorted ``busy`` intervals."""
    out, t = [], start
    for s, e in busy:
        if e <= start:
            continue
        if s >= end:
            break
        if s > t:
            out.append((t, s - t))
        t = max(t, e)
    if t < end:
        out.append((t, end - t))
    return out


class Tracer:
    """torch.profiler over one channel's window (CPU and CUDA records)."""

    MARK = "bench_window"

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        warnings.filterwarnings("ignore", "Profiler clears events")
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.cpu = None

    def mark_start(self) -> None:
        from torch.profiler import record_function

        self.span = record_function(self.MARK)
        self.span.__enter__()
        self.mark_mono_ns = time.monotonic_ns()

    def finish(self, start: float, end: float, k1: str = "intra_decision"
               ) -> dict:
        """The channel's device intervals in [start, end] on the shared
        clock, its device seconds by kernel, and K1's launches and device
        seconds."""
        from torch.autograd import DeviceType

        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        mark = next(e for e in events if e.name() == self.MARK
                    and e.device_type() == DeviceType.CPU)
        offset = mark.start_ns() - self.mark_mono_ns
        busy, ops, cpu = [], {}, []
        k1_n, k1_s = 0, 0.0
        for e in events:
            s = (e.start_ns() - offset) * 1e-9
            d = e.duration_ns() * 1e-9
            if e.device_type() == DeviceType.CPU:
                cpu.append((s, s + d, e.name()))
                continue
            if e.is_user_annotation() or s + d <= start or s >= end:
                continue
            busy.append([max(s, start), min(s + d, end)])
            name = short_name(e.name())
            ops[name] = ops.get(name, 0.0) + d
            if k1 in name:
                k1_n += 1
                k1_s += d
        cpu.sort()
        self.cpu = cpu
        self.cpu_starts = [c[0] for c in cpu]
        return dict(busy=merge(busy), ops=ops, k1_launches=k1_n,
                    k1_s=k1_s, offset_ns=offset, n_events=len(events))

    def host_activity(self, t: float) -> str:
        """The host's activity at ``t`` as the profiler shows it: the
        innermost operation around it, else the last one before it (CUDA
        runtime calls, which end where the device's work ends, left
        out)."""
        i = bisect.bisect_right(self.cpu_starts, t)
        recent = [c for c in self.cpu[max(0, i - 4000):i]
                  if not c[2].startswith("cu") and c[2] != self.MARK]
        around = [c for c in recent if c[1] >= t]
        if around:
            return min(around, key=lambda c: c[1] - c[0])[2]
        if recent:
            last = max(recent, key=lambda c: c[1])
            return f"host code after {last[2]}"
        return "host code, no operation recorded"


def union(channels: list, start: float, end: float) -> dict:
    """Join the channels' traced summaries: busy seconds of the union of
    their device intervals in the window, device seconds by kernel summed
    over the channels, and the longest idle gaps with the channel whose
    device went idle at each gap's start."""
    allb = merge([[max(s, start), min(e, end)] for c in channels
                  for s, e in c["busy"] if e > start and s < end])
    busy_s = sum(e - s for s, e in allb)
    ops = {}
    for c in channels:
        for k, v in c["ops"].items():
            ops[k] = ops.get(k, 0.0) + v
    longest = sorted(gaps(allb, start, end), key=lambda g: -g[1])[:10]
    owners = []
    for t, _ in longest:
        best = None
        for i, c in enumerate(channels):
            ends = [e for s, e in c["busy"] if e <= t + 1e-9]
            if ends and (best is None or ends[-1] > best[1]):
                best = (i, ends[-1])
        owners.append(best[0] if best else 0)
    return dict(busy_s=busy_s, ops=ops, gaps=longest, owners=owners)
