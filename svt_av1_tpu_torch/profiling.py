"""Tracing, logging and per-stage latency profiling.

Behavioral parity targets:
  * SVT_LOG leveled logging (Source/Lib/Common/Codec/svt_log.c:15 —
    svt_log_init reads the SVT_LOG env var, levels fatal..debug, tagged
    "Svt[error]:"-style prefixes);
  * the EncApp performance/latency report (Source/App/EncApp/
    EbAppMain.c printing average speed + per-stage timing via
    EbTime.c) — here a per-stage wall-clock accumulator the Encoder
    threads through its pipeline stages, queryable as
    Encoder.perf_report() and printable by the CLI's
    --enable-stat-report.

The profiler is deliberately tiny: perf_counter deltas accumulated per
stage name.  Device stages measure HOST wall time (including the
blocking transfer), which is what end-to-end throughput sees.

While ``torch.profiler`` records, each span also opens a
``record_function`` named ``<stage> [<picture tag>]``, so the stages lie
in the same trace as the kernels and copies, on its clock.  The encoder
binds its timer and the picture it codes in context variables
(``bind``, ``picture``): code below the API (``span``, the transfer
helpers of ``device.py``) finds them there, and the prefetch worker
runs in a copy of the submitter's context, its stages prefixed
``worker.`` (``run_as_worker``).
"""
from __future__ import annotations

import contextvars
import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

from torch.autograd import profiler as _torch_profiler

# SVT_LOG levels (svt_log.h SvtLogLevel)
LOG_ALL, LOG_DEBUG, LOG_INFO, LOG_WARN, LOG_ERROR, LOG_FATAL = \
    -1, 0, 1, 2, 3, 4
_TAGS = {LOG_DEBUG: "Svt[debug]", LOG_INFO: "Svt[info]",
         LOG_WARN: "Svt[warn]", LOG_ERROR: "Svt[error]",
         LOG_FATAL: "Svt[fatal]"}


def _env_level() -> int:
    """svt_log_init: SVT_LOG env selects the minimum level (default
    info; -1 logs everything)."""
    try:
        return int(os.environ.get("SVT_LOG", LOG_INFO))
    except ValueError:
        return LOG_INFO


class SvtLog:
    """svt_log analog: leveled, tagged, env-controlled."""

    def __init__(self, level: int | None = None, stream=None):
        self.level = _env_level() if level is None else level
        self.stream = stream if stream is not None else sys.stderr

    def log(self, level: int, msg: str, *args) -> None:
        if level < self.level:
            return
        if args:
            msg = msg % args
        print(f"{_TAGS.get(level, 'Svt')}: {msg}", file=self.stream)

    def debug(self, msg, *args):
        self.log(LOG_DEBUG, msg, *args)

    def info(self, msg, *args):
        self.log(LOG_INFO, msg, *args)

    def warn(self, msg, *args):
        self.log(LOG_WARN, msg, *args)

    def error(self, msg, *args):
        self.log(LOG_ERROR, msg, *args)


LOG = SvtLog()


# the timer of the encoder whose call is running, and the picture it codes
_TIMER = contextvars.ContextVar("svt_stage_timer", default=None)
_PICTURE = contextvars.ContextVar("svt_picture", default=None)
_NO_SPAN = nullcontext()


class Picture:
    """The picture being coded: ``tag`` names it in span names (frame
    type, temporal layer, ``hidden``), ``args`` (display index, then
    qindex once the header has it) goes into the spans' profiler args."""

    __slots__ = ("tag", "args")

    def __init__(self, tag: str, args: str):
        self.tag = tag
        self.args = args


def _record(stage: str):
    """Open ``stage``'s record_function.  Spans call it only while
    torch.profiler records: ``_torch_profiler._is_profiler_enabled``, the
    flag the profiler sets on start and clears on stop, is the one read
    a span adds when it does not."""
    pic = _PICTURE.get()
    rf = _torch_profiler.record_function(
        stage if pic is None else f"{stage} [{pic.tag}]",
        None if pic is None else pic.args)
    rf.__enter__()
    return rf


class StageTimer:
    """Per-stage wall-clock accumulator (EbTime.c start/finish pairs).

    Usage: ``with prof("mode_decision"): ...``; nested stages simply
    accumulate under both names.  ``transfer`` times a host<->device copy
    as the stage ``upload`` or ``readback`` and counts its calls and bytes
    under the innermost open stage of its thread (``open``).  The prefetch
    worker records through ``worker``, every name prefixed ``worker.`` and
    its open stage kept apart, so the main thread and the worker never
    write one key: the float adds stay GIL-atomic, and ``report`` reads a
    snapshot."""

    def __init__(self):
        self.total_s = defaultdict(float)
        self.calls = defaultdict(int)
        # (direction, enclosing stage) -> [calls, bytes, seconds]
        self.transfers = defaultdict(lambda: [0, 0, 0.0])
        self._t0 = time.perf_counter()
        self.open = None            # the main thread's innermost stage
        self.worker = _Prefixed(self, "worker.")

    def __call__(self, stage: str):
        return _Span(self, self, stage)

    def transfer(self, direction: str):
        """A span over one copy; set its ``nbytes`` inside."""
        return _Transfer(self, self, direction)

    def add(self, stage: str, seconds: float) -> None:
        self.total_s[stage] += seconds
        self.calls[stage] += 1

    def report(self, n_frames: int = 0) -> dict:
        """{stage: {"ms_total", "calls", "ms_per_call"[, "ms_per_frame"]},
        plus "_transfers": {direction: {stage: {"calls", "bytes",
        "ms_total"}}} and "_wall": {"ms_total"[, "fps"]}}."""
        total, calls = dict(self.total_s), dict(self.calls)
        out = {}
        for stage in sorted(total, key=total.get, reverse=True):
            s = total[stage]
            c = calls.get(stage, 0)
            row = {"ms_total": round(s * 1e3, 3), "calls": c,
                   "ms_per_call": round(s / max(c, 1) * 1e3, 3)}
            if n_frames:
                row["ms_per_frame"] = round(s / n_frames * 1e3, 3)
            out[stage] = row
        moved = {}
        for (direction, stage), (c, nbytes, s) in sorted(
                dict(self.transfers).items(), key=lambda kv: str(kv[0])):
            moved.setdefault(direction, {})[stage or "-"] = {
                "calls": c, "bytes": nbytes, "ms_total": round(s * 1e3, 3)}
        out["_transfers"] = moved
        wall = time.perf_counter() - self._t0
        w = {"ms_total": round(wall * 1e3, 3)}
        if n_frames:
            w["fps"] = round(n_frames / wall, 3)
        out["_wall"] = w
        return out

    def format_report(self, n_frames: int = 0) -> str:
        """The EncApp --enable-stat-report latency table, then the
        transfers by direction and enclosing stage."""
        rep = self.report(n_frames)
        wall = rep.pop("_wall")
        moved = rep.pop("_transfers")
        lines = ["stage                        ms/frame    ms total   calls"]
        for stage, row in rep.items():
            per = row.get("ms_per_frame", row["ms_per_call"])
            lines.append(f"{stage:28s} {per:9.2f} {row['ms_total']:11.1f}"
                         f" {row['calls']:7d}")
        tail = f"wall {wall['ms_total']:.1f} ms"
        if "fps" in wall:
            tail += f", {wall['fps']} fps"
        lines.append(tail)
        if moved:
            lines.append("transfer          within                 calls"
                         "          MB    ms total")
            for direction, by_stage in moved.items():
                for stage, t in by_stage.items():
                    lines.append(f"{direction:17s} {stage:20s} "
                                 f"{t['calls']:7d} {t['bytes'] / 1e6:11.3f}"
                                 f" {t['ms_total']:11.1f}")
        return "\n".join(lines)


class _Prefixed:
    """A timer's view that records every stage and transfer under
    ``prefix`` (the prefetch worker's ``worker.``)."""

    __slots__ = ("timer", "prefix", "open")

    def __init__(self, timer: StageTimer, prefix: str):
        self.timer = timer
        self.prefix = prefix
        self.open = None            # the worker's innermost stage

    def __call__(self, stage: str):
        return _Span(self.timer, self, self.prefix + stage)

    def transfer(self, direction: str):
        return _Transfer(self.timer, self, self.prefix + direction)


class _Span:
    __slots__ = ("timer", "owner", "stage", "t0", "outer", "rf")

    def __init__(self, timer: StageTimer, owner, stage: str):
        self.timer = timer
        self.owner = owner          # the timer or view whose ``open`` it is
        self.stage = stage

    def __enter__(self):
        self.outer = self.owner.open
        self.owner.open = self.stage
        self.rf = _record(self.stage) \
            if _torch_profiler._is_profiler_enabled else None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        self.owner.open = self.outer
        self.timer.add(self.stage, dt)
        return False


class _Transfer:
    """One copy: timed as the stage ``direction`` and counted, with
    ``nbytes``, under the stage open around it."""

    __slots__ = ("timer", "owner", "direction", "within", "nbytes", "t0",
                 "rf")

    def __init__(self, timer: StageTimer, owner, direction: str):
        self.timer = timer
        self.owner = owner
        self.direction = direction
        self.nbytes = 0

    def __enter__(self):
        self.within = self.owner.open
        self.rf = _record(self.direction) \
            if _torch_profiler._is_profiler_enabled else None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        self.timer.add(self.direction, dt)
        row = self.timer.transfers[(self.direction, self.within)]
        row[0] += 1
        row[1] += self.nbytes
        row[2] += dt
        return False


def current_timer():
    """The timer of the encoder call running in this context, or None."""
    return _TIMER.get()


def span(stage: str):
    """A stage of the running encoder call's timer (nothing outside one)."""
    timer = _TIMER.get()
    return _NO_SPAN if timer is None else timer(stage)


@contextmanager
def bind(timer):
    """Run an encoder call with ``timer`` as the context's timer."""
    tok = _TIMER.set(timer)
    try:
        yield
    finally:
        _TIMER.reset(tok)


@contextmanager
def picture(timer, tag: str, display: int):
    """The span ``picture`` of one coded picture; the spans inside it
    carry its ``tag`` and args.  Yields the ``Picture``, whose ``args``
    the caller extends once the qindex is known."""
    pic = Picture(tag, f"display={display}")
    tok = _PICTURE.set(pic)
    try:
        with timer("picture"):
            yield pic
    finally:
        _PICTURE.reset(tok)


def run_as_worker(stage: str, fn, *args):
    """Run ``fn(*args)`` on a worker thread, inside the submitter's
    copied context, as the stage ``worker.<stage>`` of the submitter's
    timer; transfers inside count as ``worker.upload`` and
    ``worker.readback``."""
    timer = _TIMER.get()
    if timer is None:
        return fn(*args)
    tok = _TIMER.set(timer.worker)
    try:
        with timer.worker(stage):
            return fn(*args)
    finally:
        _TIMER.reset(tok)
