"""The window's arithmetic: whole units, a rate as every frame over all
the time, the 95th percentile and its samples, the stage deltas, and K1's
bound."""
from __future__ import annotations

import pytest

import channel
import stats


class FakeEncoder:
    """Codes nothing until ``unit`` pictures are buffered, then all of
    them in one call that takes ``cost`` seconds of the fake clock."""

    def __init__(self, clock, unit: int, cost: float, hold: int = 0):
        self.clock, self.unit, self.cost, self.hold = clock, unit, cost, hold
        self.frame_count = 0
        self.buffered = 0

    def send_picture(self, planes):
        self.buffered += 1
        self.clock.t += 0.001
        ready = self.buffered - self.hold
        if ready < self.unit:
            return []
        self.clock.t += self.cost * ready
        self.frame_count += ready
        self.buffered -= ready
        return [b"p"] * ready


class Clock:
    t = 0.0

    def __call__(self):
        return self.t


def test_window_stops_at_the_first_whole_unit_after_the_deadline():
    clock = Clock()
    enc = FakeEncoder(clock, unit=16, cost=0.3)
    packets, frames, t_last, lat, sent = channel.run_window(
        enc, lambda i: None, first=0, start=0.0, seconds=10.0, clock=clock)
    # units of 16 pictures take 4.8 s (plus 16 sends): three units
    assert frames == 48 and sent == 48 and len(packets) == 48
    assert t_last >= 10.0 and frames % 16 == 0
    assert len(lat) == 48


def test_window_ends_on_whole_intra_periods():
    clock = Clock()
    # units of 16 pictures; the window closes on multiples of 48
    enc = FakeEncoder(clock, unit=16, cost=0.3)
    _, frames, t_last, _, _ = channel.run_window(
        enc, lambda i: None, first=0, start=0.0, seconds=10.0, unit=48,
        clock=clock)
    assert frames == 48 and t_last >= 10.0
    enc = FakeEncoder(clock, unit=16, cost=0.3)
    clock.t = 0.0
    _, frames, _, _, _ = channel.run_window(
        enc, lambda i: None, first=0, start=0.0, seconds=15.0, unit=48,
        clock=clock)
    assert frames == 96


def test_latency_counts_send_to_the_call_that_codes():
    clock = Clock()
    # one picture in flight: picture n is coded by the call that sends n+1
    enc = FakeEncoder(clock, unit=1, cost=0.25, hold=1)
    enc.buffered = 1            # one warm-up picture already held
    packets, frames, t_last, lat, sent = channel.run_window(
        enc, lambda i: None, first=1, start=0.0, seconds=2.0, clock=clock)
    # the warm-up picture is coded in the window, but has no latency
    assert frames == len(lat) + 1
    # two calls of 1 ms of send and 250 ms of coding each
    assert lat and all(x == pytest.approx(2 * 0.251) for x in lat)


def test_the_summary_counts_each_channels_latency_samples():
    import run

    ref_s = dict(recon=1.0, decode=2.0)
    got = run.summary({"results": [
        dict(channel=0, frames=9, sent=11, latencies_ms=[1.0] * 8,
             decoded=[0, 1], reference_s=ref_s, stages={"plan": 18.0}),
        dict(channel=1, frames=7, sent=9, latencies_ms=[], decoded=[],
             reference_s=ref_s, stages={"plan": 14.0})]})
    assert got["channel 0"] == dict(frames=9, sent=11, latencies=8,
                                    decoded=[0, 1], reference_s=ref_s)
    assert got["channel 1"]["latencies"] == 0
    # the host stages a picture, over the channels' window pictures
    assert got["stage ms a picture"] == {"plan": 2.0}


def test_rate_is_every_frame_over_the_whole_window():
    assert stats.rate(200, 10.0, 30.0) == 10.0


@pytest.mark.parametrize("n", [1, 19, 20, 100, 401])
def test_p95_nearest_rank(n):
    xs = list(range(1, n + 1))
    got = stats.p95(xs[::-1])
    assert got == xs[max(-(-95 * n // 100) - 1, 0)]
    # at least 5% of the samples lie at or above it
    assert sum(x >= got for x in xs) >= 0.05 * n


def test_p95_of_nothing_raises():
    with pytest.raises(ValueError):
        stats.p95([])


def test_stage_deltas_and_per_frame():
    before = {"encode_tiles": 100.0, "plan": 40.0}
    after = {"encode_tiles": 400.0, "plan": 100.0, "tpl": 30.0}
    d = stats.stage_deltas(before, after)
    assert d == {"encode_tiles": 300.0, "plan": 60.0, "tpl": 30.0}
    run = {"results": [dict(stages=d, frames=10),
                       dict(stages=d, frames=20)]}
    assert stats.stage_per_frame(run, ("encode_tiles", "plan")) == \
        pytest.approx(2 * 240.0 / 30)
    assert stats.stage_per_frame(run, ("tpl",)) == pytest.approx(2.0)
    assert stats.stage_per_frame(run, ("temporal_filter",)) is None


def test_channel_reads_the_stage_totals():
    rep = {"plan": {"ms_total": 5.0, "calls": 2}, "_wall": {"ms_total": 9}}
    assert channel.stage_ms(rep) == {"plan": 5.0}


def test_k1_bound_at_1080p():
    bw, bh = stats.buffer_dims(1920, 1080, 128)
    assert (bw, bh) == (1920, 1152)
    px = bw * bh
    flops = 13 * 2 * px * sum(w + h for w, h in stats.K1_SHAPES)
    # the DCT multiply-adds bound it, well above the bytes
    assert stats.k1_launch_bound_s(bw, bh) == pytest.approx(
        flops / stats.PEAK_FP32_FLOPS_S)
    assert 2.0e-4 < stats.k1_launch_bound_s(bw, bh) < 2.4e-4
