"""Run one cell of the benchmark of svt_av1_tpu_torch once.

    python3 benchmark/run.py --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

The cell's files are found by name: ``BENCHMARK.json`` at the root of the
checkout, ``benchmark/configs/<config>.json``, ``benchmark/traffic/
<traffic>.json``, ``benchmark/limits/<cell>.json`` and one reader
``benchmark/metrics/<metric>.py`` per metric.  Each channel of the
traffic is a process of its own (``channel.py``) with one encoder on the
card; the windows start at one instant.  The last line of standard output
is the result, one JSON object; the numbers compared with their limits
are the last lines of standard error and the result's last key.
"""
from __future__ import annotations

import time

T0 = time.monotonic()

import argparse                                             # noqa: E402
import importlib.util                                       # noqa: E402
import json                                                 # noqa: E402
import os                                                   # noqa: E402
import subprocess                                           # noqa: E402
import sys                                                  # noqa: E402
from pathlib import Path                                    # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

import devtrace                                             # noqa: E402
from channel import forbidden_modules                       # noqa: E402

START_DELAY_S = 0.25        # from "go" to the common start of the windows


def load_cell(name: str) -> dict:
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in manifest["workloads"] if w["name"] == name)
    return dict(
        cell=cell, manifest=manifest,
        config=json.loads((HERE / "configs" / f"{cell['config']}.json")
                          .read_text()),
        traffic=json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                           .read_text()),
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text()))


def metrics_of(spec: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics (trace 0) or per-layer ones (1)."""
    return [m for m in spec["manifest"]["per_layer" if trace
                                        else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def channel_env(threads: int) -> dict:
    env = dict(os.environ)
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        env[k] = str(threads)
    # every cache of a build stays in the checkout, at a fixed path
    env["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    env["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    return env


def build_program() -> float:
    """Build the port's CUDA kernels and host extensions once, before the
    channels start (they load what this builds)."""
    t = time.monotonic()
    sys.path.insert(0, str(ROOT))
    from svt_av1_tpu_torch.kernels import build

    build.build_all_cuda()
    for name in ("ec_native", "tx_native", "block_native", "coder_native"):
        build.load_c_extension(name)
    from av1dec.entropy import native_dec

    native_dec.build()                      # the reference decoder's C
    return time.monotonic() - t


def read_line(proc) -> dict:
    line = proc.stdout.readline()
    if not line:
        raise RuntimeError(f"channel process {proc.pid} ended "
                           f"(exit {proc.wait()})")
    return json.loads(line)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             control: dict | None = None) -> dict:
    """Run the cell's channels; returns the joined run (see ``judge``)."""
    n = spec["traffic"]["channels"]
    threads = max(1, (os.cpu_count() or 1) // n)
    print(f"channels {n}, os.cpu_count() {os.cpu_count()}, threads per "
          f"channel {threads}", file=sys.stderr, flush=True)
    built_s = build_program()
    print(f"build of the port's kernels and extensions {built_s:.3f} s",
          file=sys.stderr, flush=True)
    job = dict(config=spec["config"], traffic=spec["traffic"], seed=seed,
               seconds=seconds, trace=trace, threads=threads,
               limits=spec["limits"], **(control or {}))
    procs = []
    try:
        for k in range(n):
            p = subprocess.Popen([sys.executable, str(HERE / "channel.py")],
                                 stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, text=True,
                                 env=channel_env(threads), cwd=str(ROOT))
            procs.append(p)
            p.stdin.write(json.dumps(dict(job, channel=k)) + "\n")
            p.stdin.flush()
        for p in procs:
            read_line(p)
        start = time.monotonic() + START_DELAY_S
        for p in procs:
            p.stdin.write(json.dumps({"start": start}) + "\n")
            p.stdin.flush()
        end = max(read_line(p)["closed"] for p in procs)
        for p in procs:
            p.stdin.write(json.dumps({"stop": end}) + "\n")
            p.stdin.flush()
        results = [read_line(p) for p in procs]
        run = dict(results=results, start=start, end=end,
                   setup_s=start - T0, config=spec["config"],
                   traffic=spec["traffic"])
        if trace:
            run["trace"] = join_traces(procs, results, start, end)
        for p in procs:
            p.stdin.close()
            if p.wait(timeout=120) != 0:
                raise RuntimeError(f"channel process {p.pid} exit "
                                   f"{p.returncode}")
        return run
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def join_traces(procs, results, start: float, end: float) -> dict:
    traces = [r["trace"] for r in results]
    joined = devtrace.union(traces, start, end)
    names = []
    for p in procs:
        p.stdin.write(json.dumps({"gaps": [t for t, _ in joined["gaps"]]})
                      + "\n")
        p.stdin.flush()
        names.append(read_line(p)["gap_names"])
    joined["gap_names"] = [f"channel {c}: {names[c][i]}"
                           for i, c in enumerate(joined["owners"])]
    joined["k1_launches"] = sum(t["k1_launches"] for t in traces)
    joined["k1_s"] = sum(t["k1_s"] for t in traces)
    joined["window_s"] = end - start
    return joined


def judge(run: dict) -> dict:
    """The numbers compared, each with its value and its limit."""
    res, lim = run["results"], run["limits"]
    return {
        "stream_faults": dict(value=sum(r["n_faults"] for r in res),
                              limit=lim["stream_faults"]),
        "frame_mse_worst": dict(value=max(r["frame_mse_worst"]
                                          for r in res),
                                limit=lim["frame_mse_worst"]),
        "block_mse_worst": dict(value=max(r["block_mse_worst"]
                                          for r in res),
                                limit=lim["block_mse_worst"]),
        "decode_mismatch": dict(value=sum(r["n_decode_faults"]
                                          for r in res),
                                limit=lim["decode_mismatch"])}


def main(argv=None, control: dict | None = None) -> int:
    """One run; ``control`` ({"overrides": {...}} or {"fault": name}) is
    for control.py alone."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < spec["cell"]["chips"]:
        print(f"run.py: the cell needs {spec['cell']['chips']} CUDA "
              f"device(s)", file=sys.stderr)
        return 2
    run = run_cell(spec, args.seed, args.seconds, bool(args.trace), control)
    run["limits"] = spec["limits"]
    found = forbidden_modules()
    for r in run["results"]:
        if r["forbidden"]:
            found += r["forbidden"]
    if found:
        print(f"run.py: JAX or the JAX package loaded: {sorted(set(found))}",
              file=sys.stderr)
        return 3
    metrics = {}
    for m in metrics_of(spec, args.workload, bool(args.trace)):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    checks = judge(run)
    res = run["results"]
    out = dict(
        correct=all(c["value"] <= c["limit"] for c in checks.values()),
        attempted=sum(r["checked"] for r in res),
        failed=sum(r["failed"] for r in res)
        + checks["stream_faults"]["value"]
        + checks["decode_mismatch"]["value"],
        metrics=metrics,
        device=dict(platform="gpu", kind=res[0]["device"],
                    count=spec["cell"]["chips"],
                    memory_peak_bytes=sum(r["memory_peak_bytes"]
                                          for r in res)))
    if args.trace:
        tr = run["trace"]
        out["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = dict(
            device_ops=sorted(([k, v] for k, v in tr["ops"].items()),
                              key=lambda kv: -kv[1])[:10],
            idle_gaps=[[name, g[1]] for name, g in zip(tr["gap_names"],
                                                        tr["gaps"])])
    out["checks"] = checks
    for r in res:
        for f in r["faults"]:
            print(f"channel {r['channel']}: {f}", file=sys.stderr)
    print("pictures, latency samples, reference, stages",
          json.dumps(summary(run)), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


def summary(run: dict) -> dict:
    """Per channel: pictures coded in its window, sent in all, its
    latency samples, the displays decoded by the reference and the
    reference's seconds; and the host stages' ms a picture."""
    out = {f"channel {r['channel']}": dict(
        frames=r["frames"], sent=r["sent"],
        latencies=len(r["latencies_ms"]), decoded=r["decoded"],
        reference_s=r["reference_s"]) for r in run["results"]}
    stages = sorted({k for r in run["results"] for k in r["stages"]})
    frames = max(sum(r["frames"] for r in run["results"]), 1)
    out["stage ms a picture"] = {
        k: sum(r["stages"].get(k, 0.0) for r in run["results"]) / frames
        for k in stages}
    return out


if __name__ == "__main__":
    sys.exit(main())
