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
"""
from __future__ import annotations

import os
import sys
import time
from collections import defaultdict

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


class StageTimer:
    """Per-stage wall-clock accumulator (EbTime.c start/finish pairs).

    Usage: ``with prof("mode_decision"): ...``; nested stages simply
    accumulate under both names.  Thread-safe enough for the prefetch
    worker (GIL-atomic float adds on distinct keys)."""

    def __init__(self):
        self.total_s = defaultdict(float)
        self.calls = defaultdict(int)
        self._t0 = time.perf_counter()

    def __call__(self, stage: str):
        return _Span(self, stage)

    def add(self, stage: str, seconds: float) -> None:
        self.total_s[stage] += seconds
        self.calls[stage] += 1

    def report(self, n_frames: int = 0) -> dict:
        """{stage: {"ms_total", "calls", "ms_per_call"[, "ms_per_frame"]},
        plus "_wall": {"ms_total"[, "fps"]}}."""
        out = {}
        for stage in sorted(self.total_s, key=self.total_s.get,
                            reverse=True):
            s = self.total_s[stage]
            c = self.calls[stage]
            row = {"ms_total": round(s * 1e3, 3), "calls": c,
                   "ms_per_call": round(s / max(c, 1) * 1e3, 3)}
            if n_frames:
                row["ms_per_frame"] = round(s / n_frames * 1e3, 3)
            out[stage] = row
        wall = time.perf_counter() - self._t0
        w = {"ms_total": round(wall * 1e3, 3)}
        if n_frames:
            w["fps"] = round(n_frames / wall, 3)
        out["_wall"] = w
        return out

    def format_report(self, n_frames: int = 0) -> str:
        """The EncApp --enable-stat-report latency table."""
        rep = self.report(n_frames)
        wall = rep.pop("_wall")
        lines = ["stage                        ms/frame    ms total   calls"]
        for stage, row in rep.items():
            per = row.get("ms_per_frame", row["ms_per_call"])
            lines.append(f"{stage:28s} {per:9.2f} {row['ms_total']:11.1f}"
                         f" {row['calls']:7d}")
        tail = f"wall {wall['ms_total']:.1f} ms"
        if "fps" in wall:
            tail += f", {wall['fps']} fps"
        lines.append(tail)
        return "\n".join(lines)


class _Span:
    __slots__ = ("timer", "stage", "t0")

    def __init__(self, timer: StageTimer, stage: str):
        self.timer = timer
        self.stage = stage

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timer.add(self.stage, time.perf_counter() - self.t0)
        return False
