"""Where the host time of a K5 or K2 wrapper call goes, on the card.

    python3 tools/host_path.py [--root DIR]

Imports ``svt_av1_tpu_torch`` from DIR (default: this checkout).  Each
step of the wrappers' host path is run back to back ``REPS`` times on the
host clock, after a warm-up, and reported in microseconds per call: the
whole wrapper calls (K5 ``bme.me_coarse`` at r 8 on a 1920x1152 pair, K2
``dlf.deblock`` on a 1920x1152 int32 plane with its uint8 masks), and
their parts (the plane checks, the output allocation and its views, the
pointer and stream arguments, the ctypes call that launches the kernel),
beside a CUDA-event pair around nothing (what chip_smoke.cuda_ms adds).
The whole wrappers' kernels take less device time than their host path,
so their rate is the host's.  Prints one JSON line with the card's name
and power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
REPS = 2000


def per_call_us(torch, fn, reps=REPS):
    """Host microseconds per call of ``fn`` over ``reps`` calls."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def main() -> int:
    args = sys.argv[1:]
    root = Path(args[args.index("--root") + 1]).resolve() \
        if "--root" in args else HERE
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("host_path: no CUDA device", file=sys.stderr)
        return 2
    from svt_av1_tpu_torch.kernels import build
    from svt_av1_tpu_torch.ops import bme, dlf

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    H, W = 1152, 1920
    src, ref = (torch.from_numpy(rng.integers(0, 256, (H, W)).astype(
        np.uint8)).to(dev) for _ in range(2))
    plane = torch.from_numpy(rng.integers(0, 256, (H, W)).astype(
        np.int32)).to(dev)
    y4, x4 = H // 4, W // 4
    tx = rng.choice([4, 8, 16, 32], size=(y4, x4)).astype(np.int32)
    masks = [torch.from_numpy(np.ascontiguousarray(a, np.uint8)).to(dev)
             for a in dlf.edge_params(tx, tx, rng.random((y4, x4)) < 0.3,
                                      rng.random((y4, x4)) < 0.5,
                                      rng.random((y4, x4)) < 0.5, W, H,
                                      False)]
    n_out = (H // 64) * (W // 64) * 2
    out = torch.empty(n_out, dtype=torch.int32, device=dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def events():
        ev[0].record()
        ev[1].record()

    steps = {
        "K5 me_coarse r 8 (whole wrapper)":
            lambda: bme.me_coarse(src, ref, 8),
        "K2 deblock luma (whole wrapper)":
            lambda: dlf.deblock(plane, *masks, W, H, 28, 28, 0),
        "K5 plane checks": lambda: bme._check_planes("k5", src, ref, 0),
        "torch.empty on the card": lambda: torch.empty(
            n_out * 4, dtype=torch.uint8, device=dev),
        "torch.empty_like of the int32 plane":
            lambda: torch.empty_like(plane),
        "slice and two views": lambda: out[:n_out].view(torch.int32).view(
            H // 64, W // 64, 2),
        "build.ptr": lambda: build.ptr(src),
        "build.stream": lambda: build.stream(src),
        "build.raw_stream": (lambda: build.raw_stream(src))
        if hasattr(build, "raw_stream") else None,
        "torch.cuda.current_stream(device).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "tensor.device, .dtype, .is_contiguous()":
            lambda: (src.device, src.dtype, src.is_contiguous()),
        "K2 mask conversions (4 uint8 tensors)": lambda: [
            m.to(device=dev, dtype=torch.uint8).contiguous() for m in masks],
        "CUDA event pair, nothing between": events,
    }
    if hasattr(torch._C, "_cuda_getCurrentRawStream"):
        steps["torch._C._cuda_getCurrentRawStream(index)"] = \
            lambda: torch._C._cuda_getCurrentRawStream(0)
    if hasattr(build, "raw_stream"):
        fn = bme._fn("me_coarse", "me_coarse_launch", (bme._P, bme._P)
                     + (bme._I,) * 5 + (bme._P,) * 2)
        args5 = (build.ptr(src), build.ptr(ref), H, H, W, 8, 0,
                 build.ptr(out), build.raw_stream(src))
        steps["K5 ctypes call alone (launch)"] = lambda: fn(*args5)
    us = {k: per_call_us(torch, f) for k, f in steps.items() if f}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "root": str(root), "host_us": us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
