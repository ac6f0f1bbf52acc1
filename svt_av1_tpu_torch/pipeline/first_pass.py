"""Two-pass rate control stats (the analog of the reference's
FIRSTPASS_STATS flow: firstpass.c output_stats:82 writes packed records
as the pass-1 "bitstream"; pass2_strategy.c consumes them).

Pass 1 here is a fast open-loop analysis: per frame, decimated spatial
energy (intra cost proxy), temporal SAD vs the previous frame (inter
cost proxy) and a scene-change flag from the SAD ratio.  Stats persist
as JSON lines — the only cross-run state the codec needs (encoding is
otherwise restart-from-keyframe by construction, SURVEY §5.4).
"""
from __future__ import annotations

import json

import numpy as np


def analyze_frame(y: np.ndarray, prev_y=None) -> dict:
    y = y.astype(np.int32)
    h, w = y.shape
    h2, w2 = h & ~1, w & ~1
    dec = y[:h2:2, :w2:2]
    # spatial energy: mean abs laplacian of the decimated plane
    lap = np.abs(4 * dec[1:-1, 1:-1] - dec[:-2, 1:-1] - dec[2:, 1:-1]
                 - dec[1:-1, :-2] - dec[1:-1, 2:])
    intra = float(lap.mean())
    inter = intra
    if prev_y is not None:
        diff = np.abs(dec - prev_y.astype(np.int32)[:h2:2, :w2:2])
        inter = float(diff.mean())
    return {"intra": round(intra, 3), "inter": round(inter, 3)}


def detect_scene_changes(stats: list) -> list:
    """Display indices that should start a new key frame: a temporal-cost
    SPIKE vs recent frames, with the cost near the intra ceiling (the
    reference's scene_transition_detector histogram analog)."""
    out = []
    for i, s in enumerate(stats):
        if i == 0:
            continue
        recent = [stats[j]["inter"] for j in range(max(1, i - 3), i)]
        base = float(np.median(recent)) if recent else 0.0
        spike = s["inter"] > max(2.5 * base, 6.0)
        if spike and s["inter"] > 0.7 * s["intra"]:
            out.append(i)
    return out


def write_stats(path: str, stats: list) -> None:
    with open(path, "w") as f:
        for s in stats:
            f.write(json.dumps(s) + "\n")


def read_stats(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def complexity_weights(stats: list) -> list:
    """Per-frame bit-allocation weights (mean 1.0) from inter cost."""
    if not stats:
        return []
    costs = np.array([max(s["inter"], 0.25) for s in stats], np.float64)
    costs = np.sqrt(costs)               # diminishing returns
    return list(costs / costs.mean())
