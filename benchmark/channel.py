"""One channel of a cell: one ``svt_av1_tpu_torch.api.Encoder`` on the card
over its own title, started by ``run.py`` and driven over pipes.

Protocol, one JSON object per line.  stdin: the job; ``{"start": t}``,
the window's start on ``time.monotonic()``'s clock (shared by the
processes of one host); ``{"stop": t}`` once every channel's window has
closed, ``t`` the last one's close; with tracing, ``{"gaps": [t, ...]}``.
stdout: ``{"ready": ...}`` after set-up; ``{"closed": ...}`` when the
window has closed; the channel's result; with tracing,
``{"gap_names": [...]}``.  Between its window's close and the stop the
channel goes on coding, so that every window runs under the same load.
Anything else the process prints goes to stderr.
"""
from __future__ import annotations

import json
import os
import select
import sys
import time
from fractions import Fraction
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from stats import stage_deltas                              # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "svt_av1_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def encoder_config(fields: dict, overrides: dict | None = None):
    from svt_av1_tpu_torch.config import (EncoderConfig, PredStructure,
                                          RateControlMode)

    kw = dict(fields, **(overrides or {}))
    kw["pred_structure"] = PredStructure[kw["pred_structure"]]
    kw["rate_control_mode"] = RateControlMode[kw["rate_control_mode"]]
    kw["frame_rate"] = Fraction(kw["frame_rate"])
    return EncoderConfig(**kw)


def guarantees(fields: dict) -> dict:
    """What the reference holds the stream to, from the configuration as
    stated (never from the overrides a control run applies)."""
    period = fields["intra_period_length"]
    return dict(width=fields["source_width"],
                height=fields["source_height"],
                bit_depth=fields["encoder_bit_depth"],
                sb128=int(fields["super_block_size"] == 128),
                qp=fields["qp"],
                key_interval=period + 1 if period >= 0 else 0,
                reorder=fields["pred_structure"] == "RANDOM_ACCESS")


def run_window(enc, pictures, first: int, start: float, seconds: float,
               unit: int = 1, clock=time.monotonic):
    """The closed loop: send the next picture as soon as the call returns;
    stop at the first call after ``seconds`` after which the pictures
    coded in the window are a whole number of ``unit`` (in random access
    an intra period: the same mix of key, base and layer pictures in every
    window, whatever its phase).  Returns the packets, the pictures coded
    in the window, the last call's return time, each picture's latency
    (its send to the return of the call that coded it) for pictures sent
    in the window, and the pictures sent."""
    packets, latencies = [], []
    coded0 = coded = enc.frame_count
    # send times of the pictures not yet coded (None: sent before the window)
    pending = [None] * (first - coded)
    sent = first
    while True:
        t_send = clock()
        got = enc.send_picture(pictures(sent))
        t_ret = clock()
        pending.append(t_send)
        sent += 1
        now = enc.frame_count
        for t in pending[:now - coded]:
            if t is not None:
                latencies.append(t_ret - t)
        del pending[:now - coded]
        coded = now
        packets += got
        if got and t_ret - start >= seconds and (coded - coded0) % unit == 0:
            return packets, coded - coded0, t_ret, latencies, sent


def stage_ms(report: dict) -> dict:
    """Each stage's total milliseconds in ``Encoder.perf_report()``."""
    return {k: v["ms_total"] for k, v in report.items()
            if not k.startswith("_")}


class Channel:
    """One channel's encoder, title and window (``job`` as ``run.py``
    writes it; ``job["device"]`` "cpu" runs the plain versions, for the
    CPU tests)."""

    def __init__(self, job: dict):
        import torch

        sys.path.insert(0, str(HERE.parent))
        import clip
        from svt_av1_tpu_torch.api import Encoder

        self.job = job
        self.torch = torch
        torch.set_num_threads(job["threads"])
        self.dev = torch.device(job.get("device", "cuda"))
        self.cuda = self.dev.type == "cuda"
        fields, traffic = job["config"]["encoder"], job["traffic"]
        self.fields, self.traffic = fields, traffic
        # the bit depth as the configuration states it, never a control's
        self.bit_depth = fields["encoder_bit_depth"]
        if self.cuda:
            torch.cuda.init()
        self.pics = clip.make_title(
            fields["source_width"], fields["source_height"],
            traffic["title_pictures"],
            clip.title_seed(job["seed"], job["channel"]),
            traffic["content"], self.dev, bit_depth=self.bit_depth)
        self.sync()
        if self.cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.enc = Encoder(encoder_config(fields, job.get("overrides")),
                           device=self.dev)
        self.packets = []
        for i in range(traffic["warmup_pictures"]):
            self.packets += self.enc.send_picture(self.picture(i))
        self.sync()
        if job.get("fault"):
            import faults

            faults.FAULTS[job["fault"]](self.enc)
        self.prof = None
        if job["trace"]:
            import devtrace

            self.prof = devtrace.Tracer()

    def picture(self, i: int):
        return self.pics[i % len(self.pics)]

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def window(self, start: float) -> None:
        """Wait for ``start``, then run the window."""
        while time.monotonic() < start:
            time.sleep(min(0.01, max(start - time.monotonic(), 0)))
        rep0 = stage_ms(self.enc.perf_report())
        if self.prof is not None:
            self.prof.mark_start()
        got, self.frames, self.t_last, self.lat, self.sent = run_window(
            self.enc, self.picture, self.traffic["warmup_pictures"], start,
            self.job["seconds"], self.traffic["unit_pictures"])
        self.sync()
        rep1 = stage_ms(self.enc.perf_report())
        self.stages = stage_deltas(rep0, rep1)
        self.start = start
        self.packets += got
        self.peak = self.torch.cuda.max_memory_allocated() if self.cuda \
            else 0
        self.device = self.torch.cuda.get_device_name() if self.cuda \
            else "cpu"

    def keep_loading(self, stop) -> None:
        """Go on sending pictures, untimed, until ``stop()``."""
        while not stop():
            self.packets += self.enc.send_picture(self.picture(self.sent))
            self.sent += 1

    def result(self, end: float | None = None) -> dict:
        """The comparison, once the window has closed and the trace (up
        to ``end``, the last window's close) has been read; the encoder's
        state is freed first.  Every coded picture's reconstruction is
        held to its source, and a sample of the packets is decoded and
        held bit-exact to the reconstructions."""
        import numpy as np
        import decode_check
        import reference

        self.sync()
        self.traced = None
        if self.prof is not None:
            self.traced = self.prof.finish(self.start, end or self.t_last)
        enc, traffic = self.enc, self.traffic
        units = []
        faults, shown = reference.check_stream(
            self.packets, guarantees(self.fields), units)
        coded = enc.frame_count
        if len(shown) != coded:
            faults.append(f"{coded} pictures coded, {len(shown)} shown")
        recons = {}
        for d in range(coded):
            try:
                recons[d] = enc.get_recon(d)
            except Exception as e:                   # noqa: BLE001
                faults.append(f"display {d}: no reconstruction ({e})")
        self.enc = enc = None
        t0 = time.monotonic()
        bd = self.bit_depth
        q = reference.check_recon(recons, self.picture, traffic["block"], bd)
        t1 = time.monotonic()
        count = traffic["decode_packets"]
        first = decode_check.sample_start(units, traffic["warmup_pictures"],
                                          count, self.job["seed"],
                                          self.job["channel"])
        dfaults, decoded = decode_check.decode_sample(
            self.packets, units, first, count, recons.get)
        t2 = time.monotonic()
        measured = [reference.psnr(reference.luma_mse(
            decoded[d][0], self.picture(d)[0]), bd) for d in sorted(decoded)]
        m = traffic["measure_pictures"]
        if len(shown) < m:
            faults.append(f"the measured set of {m} pictures was not coded")
        lim = self.job["limits"]
        return dict(
            channel=self.job["channel"], frames=self.frames,
            t_last=self.t_last, sent=self.sent,
            latencies_ms=[1e3 * x for x in self.lat], stages=self.stages,
            memory_peak_bytes=self.peak, device=self.device,
            faults=(faults + dfaults)[:20], n_faults=len(faults),
            n_decode_faults=len(dfaults), checked=len(q),
            decoded=sorted(decoded), decode_from=units[first]["display"]
            if first < len(units) else None,
            reference_s=dict(recon=t1 - t0, decode=t2 - t1),
            failed=sum(1 for f in q.values()
                       if f["block"] > lim["block_mse_worst"]
                       or f["mse"] > lim["frame_mse_worst"]),
            frame_mse_worst=max((f["mse"] for f in q.values()),
                                default=reference.worst_mse(bd)),
            block_mse_worst=max((f["block"] for f in q.values()),
                                default=reference.worst_mse(bd)),
            stream_bytes=shown[m - 1][1] if len(shown) >= m else None,
            psnr_y_db=float(np.mean(measured)) if measured else None,
            forbidden=forbidden_modules(), trace=self.traced)


def main() -> int:
    proto = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    sys.stdout = sys.stderr

    def say(obj):
        proto.write(json.dumps(obj) + "\n")
        proto.flush()

    ch = Channel(json.loads(sys.stdin.readline()))
    say({"ready": True, "pid": os.getpid()})
    ch.window(json.loads(sys.stdin.readline())["start"])
    say({"closed": ch.t_last})
    ch.keep_loading(lambda: select.select([sys.stdin], [], [], 0)[0])
    say(ch.result(json.loads(sys.stdin.readline())["stop"]))
    if ch.prof is not None:
        gaps = json.loads(sys.stdin.readline())["gaps"]
        say({"gap_names": [ch.prof.host_activity(t) for t in gaps]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
