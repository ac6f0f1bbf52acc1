"""Helpers of the benchmark's CPU tests: a channel run at a small size on
the CPU (the port's plain versions), driven as ``run.py`` drives one."""
from __future__ import annotations

import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent


def small_job(cell: str, seed: int = 2**31 + 11, width: int = 192,
              height: int = 128, seconds: float = 2.0, measure: int = 6,
              overrides: dict | None = None) -> dict:
    """The job ``run.py`` would send a channel of ``cell``, cut to a size
    the CPU runs in seconds."""
    import run

    spec = run.load_cell(cell)
    spec["config"]["encoder"].update(source_width=width,
                                     source_height=height)
    spec["traffic"].update(title_pictures=24, measure_pictures=measure)
    return dict(config=spec["config"], traffic=spec["traffic"], seed=seed,
                seconds=seconds, trace=0, threads=2, limits=spec["limits"],
                overrides=overrides or {}, fault=None, device="cpu",
                channel=0)


def drive(job: dict, patch=None) -> tuple[dict, dict]:
    """Run one channel of ``job`` in this process, ``patch(channel)``
    applied to its encoder after the warm-up; returns the joined run and
    ``run.judge``'s checks."""
    import run
    from channel import Channel

    t0 = time.monotonic()
    ch = Channel(job)
    if patch is not None:
        patch(ch)
    start = time.monotonic()
    ch.window(start)
    res = ch.result()
    joined = dict(results=[res], start=start, end=res["t_last"],
                  setup_s=start - t0, config=job["config"],
                  traffic=job["traffic"], limits=job["limits"])
    return joined, run.judge(joined)


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())



def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())
