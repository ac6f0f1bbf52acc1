"""The readers of the port's inner spans (plan_wait_ms, tile_dry_run_ms,
tile_native_ms, mctf_host_ms, tpl_host_ms, upload_ms, readback_ms) on
synthetic runs: each stage's window milliseconds summed over the
channels, per picture coded in the window; None where no channel
recorded the stage (a tree without the span)."""
from __future__ import annotations

import pytest

import run

READERS = {"plan_wait_ms": "plan_wait", "tile_dry_run_ms": "tile_dry_run",
           "tile_native_ms": "tile_native", "mctf_host_ms": "mctf_host",
           "tpl_host_ms": "tpl_host", "upload_ms": "upload",
           "readback_ms": "readback"}


def _run(*channels):
    return {"results": [dict(frames=f, stages=s) for f, s in channels]}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_sums_the_channels_per_picture(metric):
    stage = READERS[metric]
    got = run.reader(metric)(_run(
        (30, {stage: 120.0, "encode_tiles": 900.0, "worker." + stage: 7.0}),
        (10, {stage: 40.0, "plan": 5.0})))
    assert got == pytest.approx((120.0 + 40.0) / 40)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_is_silent_where_no_channel_recorded_the_stage(metric):
    parent = _run((30, {"encode_tiles": 900.0, "plan": 300.0,
                        "worker." + READERS[metric]: 7.0}),
                  (10, {"encode_tiles": 200.0}))
    assert run.reader(metric)(parent) is None


def test_one_channel_without_the_stage_counts_its_pictures():
    got = run.reader("tile_native_ms")(_run((20, {"tile_native": 100.0}),
                                             (20, {})))
    assert got == pytest.approx(100.0 / 40)
