"""Helpers of the benchmark's CPU tests: a channel run at a small size on
the CPU (the port's plain versions), driven as ``run.py`` drives one."""
from __future__ import annotations

import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent


def small_job(cell: str, seed: int = 2**31 + 11, width: int = 192,
              height: int = 128, seconds: float = 2.0, measure: int = 6,
              overrides: dict | None = None, bit_depth: int = 8) -> dict:
    """The job ``run.py`` would send a channel of ``cell``, cut to a size
    the CPU runs in seconds.  ``bit_depth`` is stated in the
    configuration, as a cell of that depth would state it (not as a
    control's override), and the cell's MSE limits are carried into its
    units: a bd-bit sample is 2^(bd - 8) 8-bit steps, so an MSE reads
    4^(bd - 8) times higher."""
    import run

    spec = run.load_cell(cell)
    spec["config"]["encoder"].update(source_width=width,
                                     source_height=height,
                                     encoder_bit_depth=bit_depth)
    spec["traffic"].update(title_pictures=24, measure_pictures=measure)
    for name in ("frame_mse_worst", "block_mse_worst"):
        spec["limits"][name] *= 4 ** (bit_depth - 8)
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


def small_ra_job(bit_depth: int = 8, overrides: dict | None = None
                 ) -> dict:
    """A random-access channel whose window codes one intra period after
    the warm-up (pictures 17-50): its decode sample is the key frame 34,
    the hidden ALTREF 50 and the hidden pictures 42, 38 and 36."""
    job = small_job("ra1080p-p8.titles4", seconds=0.1, measure=17,
                    overrides=overrides, bit_depth=bit_depth)
    job["traffic"]["title_pictures"] = 17
    return job


def small_ld_job(bit_depth: int = 8, overrides: dict | None = None
                 ) -> dict:
    """A low-delay channel whose window codes a whole number of 7-picture
    units, at least one, however loaded the host: the measured set and
    the decode sample (packets 0-6) are always coded.  The unit is odd so
    that a fault that drops every other packet still leaves a call that
    returns one to close the window."""
    job = small_job("ld1080p-p8.streams4", seconds=0.1, measure=6,
                    overrides=overrides, bit_depth=bit_depth)
    job["traffic"]["unit_pictures"] = 7
    return job


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())
