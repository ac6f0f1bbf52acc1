"""The window's arithmetic, the published peaks and K1's work counts: the
parts of the yardstick that take no card."""
from __future__ import annotations

import math

# published peaks of one NVIDIA H100 SXM (data sheet, dense rates at the
# 700 W limit): float32 outside the tensor cores, HBM3 bandwidth
PEAK_FP32_FLOPS_S = 67e12
PEAK_BYTES_S = 3.35e12

# K1's candidate block shapes (w, h): the squares, then the rectangular
# halves (svt_av1_tpu_torch/ops/omd.py ALL_SHAPES)
K1_SHAPES = ((8, 8), (16, 16), (32, 32), (16, 8), (8, 16), (32, 16),
             (16, 32))


def rate(frames: int, start: float, end: float) -> float:
    """Every frame coded over the whole window."""
    return frames / (end - start)


def p95(samples: list) -> float:
    """The nearest-rank 95th percentile."""
    if not samples:
        raise ValueError("no samples")
    xs = sorted(samples)
    return xs[max(math.ceil(0.95 * len(xs)) - 1, 0)]


def stage_deltas(before: dict, after: dict) -> dict:
    """Each stage's milliseconds spent between two reports."""
    return {k: after[k] - before.get(k, 0.0) for k in after}


def buffer_dims(width: int, height: int, sb: int) -> tuple[int, int]:
    """The codec's buffer: whole superblocks over the 8-aligned picture."""
    w = 8 * ((width + 7) >> 3)
    h = 8 * ((height + 7) >> 3)
    return -(-w // sb) * sb, -(-h // sb) * sb


def k1_launch_bound_s(buf_w: int, buf_h: int) -> float:
    """The least time of one K1 launch over a buf_w x buf_h 8-bit plane
    (chip_smoke.py:432 and kernels_phase's counts, frozen): its DCT
    multiply-adds, 13 modes x 2 FLOPs x (w + h) a pixel for each shape,
    at the float32 peak, against the plane read once and the packed
    int32 [2, blocks] decisions written once at the HBM rate."""
    px = buf_w * buf_h
    flops = sum(13 * 2 * px * (w + h) for w, h in K1_SHAPES)
    blocks = sum((buf_w // w) * (buf_h // h) for w, h in K1_SHAPES)
    n_bytes = px + 2 * 4 * blocks
    return max(flops / PEAK_FP32_FLOPS_S, n_bytes / PEAK_BYTES_S)


def stage_per_frame(run: dict, stages: tuple) -> float | None:
    """The first stage's milliseconds less the others' (a stage nested in
    it), summed over the channels, per picture coded in the window; None
    where no channel recorded the first stage."""
    res = run["results"]
    if not any(stages[0] in r["stages"] for r in res):
        return None
    frames = sum(r["frames"] for r in res)
    ms = sum(r["stages"].get(stages[0], 0.0)
             - sum(r["stages"].get(s, 0.0) for s in stages[1:])
             for r in res)
    return ms / frames
