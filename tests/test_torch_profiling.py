"""The port's tracing (svt_av1_tpu_torch/profiling.py): StageTimer spans,
their nesting, the prefetch worker's ``worker.`` stages, the transfer
counters of device.py's helpers, the record_function spans that put the
stages into a torch.profiler trace, and a small low-delay encode whose
packets are the same with the profiler on and off."""
import contextvars
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from svt_av1_tpu_torch import profiling as pr
from svt_av1_tpu_torch.api import Encoder
from svt_av1_tpu_torch.config import EncoderConfig, PredStructure
from svt_av1_tpu_torch.device import to_device, to_host
from svt_av1_tpu_torch.pipeline import mctf, tpl


def _names(prof) -> list:
    """The recorded events' names (the raw kineto records: building
    ``prof.events()`` takes seconds for an encode)."""
    return [e.name() for e in prof.profiler.kineto_results.events()]


def test_nested_stages_accumulate_under_both_names():
    t = pr.StageTimer()
    with t("encode_tiles"):
        time.sleep(0.002)
        with t("tile_native"):
            time.sleep(0.002)
    with t("tile_native"):
        pass
    assert t.calls == {"encode_tiles": 1, "tile_native": 2}
    assert t.total_s["encode_tiles"] >= t.total_s["tile_native"] > 0
    rep = t.report(2)
    assert list(rep) == ["encode_tiles", "tile_native", "_transfers",
                         "_wall"]
    assert rep["tile_native"]["calls"] == 2
    assert rep["_transfers"] == {}
    table = t.format_report(2)
    assert "encode_tiles" in table and "tile_native" in table


def test_transfers_are_counted_under_the_enclosing_stage():
    t = pr.StageTimer()
    host = torch.zeros(1000, dtype=torch.uint8)
    # outside an encoder call, and between host tensors, nothing counts
    assert to_device(host, "meta").device.type == "meta"
    with pr.bind(t):
        with t("dlf_cdef"):
            up = to_device(host, torch.device("meta"), torch.int16)
            assert up.dtype == torch.int16 and up.device.type == "meta"
            assert to_device(host, "cpu") is host
            assert to_host(host) is host
            # a read-back, faked: the helper needs a device to copy from
            with t.transfer("readback") as tr:
                tr.nbytes = 6
        to_device(host, "meta")
    moved = t.report()["_transfers"]
    assert moved["upload"]["dlf_cdef"] == dict(
        calls=1, bytes=2000, ms_total=moved["upload"]["dlf_cdef"]["ms_total"])
    assert moved["upload"]["-"]["bytes"] == 1000
    assert moved["readback"]["dlf_cdef"]["calls"] == 1
    assert moved["readback"]["dlf_cdef"]["bytes"] == 6
    assert t.calls["upload"] == 2 and t.calls["readback"] == 1
    table = t.format_report()
    assert "readback" in table and "dlf_cdef" in table


def test_worker_stages_carry_the_prefix_and_the_submitters_timer():
    t, other = pr.StageTimer(), pr.StageTimer()

    def job(x):
        with pr.span("plan_inner"):
            to_device(torch.ones(4, dtype=torch.int32), "meta")
        return x + 1

    with pr.bind(t):
        ctx = contextvars.copy_context()
    got = []
    with pr.bind(other):          # the worker runs while another call is on
        th = threading.Thread(target=lambda: got.append(
            ctx.run(pr.run_as_worker, "plan", job, 1)))
        th.start()
        th.join(timeout=10)
    assert not th.is_alive() and got == [2]
    assert set(t.calls) == {"worker.plan", "worker.plan_inner",
                            "worker.upload"}
    assert t.report()["_transfers"]["worker.upload"]["worker.plan_inner"][
        "bytes"] == 16
    assert not other.calls
    # outside an encoder call the job runs untimed
    assert pr.run_as_worker("plan", job, 2) == 3


def test_report_is_safe_while_the_worker_adds_stages():
    t = pr.StageTimer()
    stop = threading.Event()
    done = []

    def worker():
        i = 0
        while not stop.is_set():
            with t.worker(f"s{i % 50}"):
                pass
            i += 1
        done.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        th = threading.Thread(target=worker)
        th.start()
        for _ in range(300):
            with t("main"):
                t.report()
        stop.set()
        th.join(timeout=10)
    finally:
        sys.setswitchinterval(old)
    assert not th.is_alive()
    assert t.calls["main"] == 300
    assert sum(c for k, c in t.calls.items() if k.startswith("worker.")) \
        == done[0]


def test_spans_enter_the_profiler_trace_with_the_picture_tag(monkeypatch):
    t = pr.StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pr.bind(t), pr.picture(t, "INTER L2 hidden", 7) as pic:
            pic.args += " qindex=160"
            with t("encode_tiles"):
                torch.ones(3).sum()
    names = _names(prof)
    assert "picture [INTER L2 hidden]" in names
    assert "encode_tiles [INTER L2 hidden]" in names
    assert not any(n.startswith("cu") for n in names
                   if n.endswith("]"))
    # with the profiler off no record_function is made
    def refuse(*a, **k):
        raise AssertionError("record_function opened while not profiling")

    monkeypatch.setattr(pr._torch_profiler, "record_function", refuse)
    with pr.bind(t), pr.picture(t, "KEY L0", 0):
        with t("plan"), pr.span("plan_wait"):
            pass
    assert t.calls["plan_wait"] == 1


def test_lookahead_host_spans_lie_inside_their_stages():
    rng = np.random.default_rng(3)
    y = [rng.integers(0, 256, (128, 128)).astype(np.uint8)
         for _ in range(3)]
    t = pr.StageTimer()
    with pr.bind(t):
        with t("tpl"):
            r0 = tpl.tpl_gop_flow(y, [0, 1, 2], 128, 128, 8, "cpu",
                                  include_first=True)
        planes = [(a[:64, :64], a[:32, :32].copy(), a[32:64, :32].copy())
                  for a in y]
        with t("temporal_filter"):
            out = mctf.temporal_filter(planes[0], planes[1:], 40, 8, "cpu")
    assert sorted(r0) == [0, 1, 2] and len(out) == 3
    assert 0 < t.total_s["tpl_host"] <= t.total_s["tpl"]
    assert 0 < t.total_s["mctf_host"] <= t.total_s["temporal_filter"]


def _ld_clip(n=4, w=128, h=64):
    rng = np.random.default_rng(1)
    base = rng.integers(0, 256, (h + 16, w + 16)).astype(np.uint8)
    return [(np.ascontiguousarray(base[i:i + h, i:i + w]),
             np.full((h // 2, w // 2), 128, np.uint8),
             np.full((h // 2, w // 2), 120, np.uint8)) for i in range(n)]


def _encode(frames):
    cfg = EncoderConfig(source_width=128, source_height=64,
                        intra_period_length=-1,
                        pred_structure=PredStructure.LOW_DELAY_P,
                        enc_mode=8, qp=40)
    enc = Encoder(cfg, device="cpu")
    packets = []
    for f in frames:
        packets += enc.send_picture(f)
    return packets + enc.flush(), enc.perf_report()


@pytest.fixture(scope="module")
def ld_runs():
    frames = _ld_clip()
    plain = _encode(frames)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _encode(frames)
    return plain, traced, _names(prof)


def test_encode_records_the_new_stages_within_the_old(ld_runs):
    (_, rep), _, _ = ld_runs
    for stage in ("picture", "plan", "plan_wait", "encode_tiles",
                  "tile_dry_run", "tile_native", "dlf_cdef", "worker.plan"):
        assert rep[stage]["calls"] > 0, stage
    ms = {k: v["ms_total"] for k, v in rep.items() if not k.startswith("_")}
    assert ms["plan_wait"] <= ms["plan"]
    assert ms["tile_dry_run"] + ms["tile_native"] \
        <= ms["encode_tiles"] - ms["plan"]
    assert ms["encode_tiles"] + ms["dlf_cdef"] <= ms["picture"]
    assert rep["picture"]["calls"] == 4
    # a CPU run copies between host tensors only: nothing is counted
    assert rep["_transfers"] == {}


def test_encode_is_the_same_with_the_profiler_on(ld_runs):
    (plain, _), (traced, rep), names = ld_runs
    assert traced == plain
    assert "picture [KEY L0]" in names
    assert "picture [INTER L0]" in names
    assert "tile_native [INTER L0]" in names
    # the profiler records the thread that started it: the prefetch
    # worker's stages are in the timer, not in the trace
    assert not any(n.startswith("worker.") for n in names)
    assert rep["picture"]["calls"] == 4
