"""K1, K4's search, K6 and K8 kernel times and the encode fps of one
checkout, on chip_smoke.py's 1080p inputs.

    python3 tools/tree_times.py [--root DIR] [--kernels] [--fps]

Imports ``svt_av1_tpu_torch`` from DIR (default: this checkout), so that
two trees (a parent commit unpacked with ``git archive`` and the change)
can be run in turns on one card, in separate processes.  With neither
flag both parts run.

* ``--kernels``: CUDA-event medians of 20 calls after one warm-up
  (chip_smoke.cuda_ms).  K1: the decisions of all 7 block shapes of the
  first frame's 1920x1152 luma plane (one launch where the package has
  ``omd.intra_decision_packed``, else one launch per shape); K6: the
  path's shapes (16x16 and 64x64) on two frames of the moving clip at
  1920x1152, MCTF's 32x32 at 1920x1088 and TPL's 16x16 at 960x576;
  K8: the random-access path's call (two references, past and future,
  and K9's compound row) on three frames of the moving clip at
  1920x1152; K4's search: the 5x3 grid over the three planes of the
  first frame (a noisy recon against its source, 80% of the units
  non-skip).
* ``--fps``: the all-intra encode (three noise-like and three smooth
  frames), the low-delay P encode (6 frames of the moving clip) and the
  random-access encode (bench.py's configuration, 33 frames, fps over
  the last 16 after a 17-frame warm-up), chip_smoke.py's clips and
  configurations.

Prints one JSON line: the card's name and power limit, the root, and
what was measured.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def kernel_times(cs, np, torch):
    from svt_av1_tpu_torch.ops import bme, omd

    dev = torch.device("cuda")
    W, H = cs.WIDTH, cs.HEIGHT
    bw, bh = -(-W // 128) * 128, -(-H // 128) * 128
    clip = cs.synth_clip(W, H, 2)
    plane = omd.upload_plane(cs.synth_clip(W, H, 1)[0][0], bw, bh, 8, dev)
    qindex, lam = 160, 1400.0
    mb = tuple(np.linspace(1.0, 6.0, 13).tolist())
    if hasattr(omd, "intra_decision_packed"):
        def k1():
            return omd.intra_decision_packed(plane, qindex, lam, mb)
    else:
        def k1():
            return [omd.intra_decision(plane, w, h, qindex, lam, mb)
                    for (w, h) in omd.ALL_SHAPES]
    times = {"K1 7 shapes": cs.cuda_ms(k1, 20)}

    def k6_ms(src, ref, shapes):
        coarse = bme.me_coarse(src, ref, bme.COARSE_R)
        return cs.cuda_ms(lambda: bme.me_refine(src, ref, coarse, shapes), 20)

    src, ref = (omd.upload_plane(f[0], bw, bh, 8, dev) for f in clip[::-1])
    times["K6 path 16x16+64x64"] = k6_ms(src, ref, ((16, 16), (64, 64)))
    hm = -(-H // 64) * 64
    mctf = [torch.from_numpy(np.ascontiguousarray(np.pad(
        f[0], ((0, hm - H), (0, 0)), mode="edge"))).to(dev)
        for f in clip[::-1]]
    times["K6 MCTF 32x32"] = k6_ms(*mctf, ((32, 32),))
    half = [torch.from_numpy(cs._half_res(f[0], bw, bh)).to(dev)
            for f in clip[::-1]]
    times["K6 TPL 16x16"] = k6_ms(*half, ((16, 16),))
    times["K8 compound row"] = cs.cuda_ms(k8_call(cs, np, torch, dev), 20)
    times["K4 search 5x3"] = cs.cuda_ms(k4_search_call(cs, np, torch, dev),
                                        20)
    return times


def k8_call(cs, np, torch, dev):
    """K8 as the random-access path calls it: the middle of three frames
    against the outer two, with the compound row."""
    from svt_av1_tpu_torch.ops import bme, omd
    from svt_av1_tpu_torch.pipeline import batched_inter as bi

    W, H = -(-cs.WIDTH // 128) * 128, -(-cs.HEIGHT // 128) * 128
    clip = cs.synth_clip(cs.WIDTH, cs.HEIGHT, 3)
    src = omd.upload_plane(clip[1][0], W, H, 8, dev)
    refs = [omd.upload_plane(clip[k][0], W, H, 8, dev) for k in (0, 2)]
    ny, nx = H // 64, W // 64
    parts = []
    for k, ref in enumerate(refs):
        m = bme.frame_me(src, ref, bme.coarse_r_for_dist((-1, 1)[k]),
                         ((16, 16), (64, 64)))
        a, b, pr = bme.subpel_refine16(
            src, ref, bi._nested_to_grid(m[(16, 16)][0], ny, nx, 4, 4),
            bi._nested_to_grid(m[(16, 16)][1], ny, nx, 4, 4))
        parts.append((pr, a, b, m[(64, 64)][0].reshape(ny, nx),
                      m[(64, 64)][1].reshape(ny, nx)))
    preds, mvq_r, mvq_c, sb_r, sb_c = (
        torch.stack([p[i] for p in parts]).contiguous() for i in range(5))
    qindex, lam = 160, 2500.0
    comp = bi.compound_joint(src, torch.stack(refs).contiguous(), preds,
                             mvq_r, mvq_c, sb_r, sb_c, (False, True),
                             (-1, 1), qindex)
    args = (src, preds, mvq_r, mvq_c, sb_r, sb_c, qindex, lam)
    return lambda: bi.inter_select(*args, comp=comp)


def k4_search_call(cs, np, torch, dev):
    """K4's search over the three planes of the first frame at the fast
    5x3 grid, as chip_smoke.py's kernels phase calls it."""
    from svt_av1_tpu_torch.ops import cdef

    W, H = cs.WIDTH, cs.HEIGHT
    bh = -(-H // 128) * 128
    frame = cs.synth_clip(W, H, 1)[0]
    rng = np.random.default_rng(0)
    rec = [torch.from_numpy(np.ascontiguousarray(np.pad(
        p, ((0, (bh >> s) - (H >> s)), (0, 0)), mode="edge")).astype(
            np.int32)).to(dev) for s, p in zip((0, 1, 1), frame)]
    rec = [(r + torch.from_numpy(rng.integers(-6, 7, tuple(r.shape)).astype(
        np.int32)).to(dev)).clamp(0, 255) for r in rec]
    src = [(r + torch.randint(-4, 5, r.shape, device=dev)).clamp(0, 255)
           .to(torch.uint8) for r in rec]
    dirs, var = cdef.cdef_direction(rec[0], W, H, 0)
    ns = torch.from_numpy(rng.random(tuple(dirs.shape)) < 0.8).to(dev)
    return lambda: cdef.cdef_search(src, rec, dirs, var, ns, W, H, 5, 8,
                                    cdef.PRI_SET_FAST, cdef.SEC_SET_FAST)


def encode_fps(cs, torch):
    from svt_av1_tpu_torch.api import Encoder

    W, H = cs.WIDTH, cs.HEIGHT
    half = cs.N_FRAMES // 2
    ai = cs.synth_clip(W, H, half) + cs.synth_clip(
        W, H, cs.N_FRAMES - half, tex_sigma=cs.SMOOTH_SIGMA)
    moving = cs.synth_clip(W, H, cs.RA_FRAMES)

    def run(frames, cfg, warm=0):
        enc = Encoder(cfg)
        torch.cuda.synchronize()
        t0 = t_warm = time.perf_counter()
        for i, planes in enumerate(list(frames) + [None]):
            if i == warm:
                torch.cuda.synchronize()
                t_warm = time.perf_counter()
            enc.flush() if planes is None else enc.send_picture(planes)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        return (len(frames) - warm) / (t1 - t_warm), len(frames) / (t1 - t0)

    fps = {}
    fps["all_intra"] = run(ai, cs.slice_config(W, H))[1]
    fps["low_delay_p"] = run(moving[:cs.N_FRAMES],
                             cs.slice_config(W, H, -1))[1]
    fps["random_access_window"], fps["random_access"] = run(
        moving, cs.ra_config(W, H), cs.RA_WARM)
    return fps


def main() -> int:
    args = sys.argv[1:]
    root = Path(args[args.index("--root") + 1]).resolve() \
        if "--root" in args else HERE
    want_k, want_f = "--kernels" in args, "--fps" in args
    if not (want_k or want_f):
        want_k = want_f = True
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("tree_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import svt_av1_tpu_torch

    assert Path(svt_av1_tpu_torch.__file__).resolve().is_relative_to(root), \
        "the package must come from --root"
    out = {}
    if want_k:
        out["ms"] = kernel_times(cs, np, torch)
    if want_f:
        out["fps"] = encode_fps(cs, torch)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "root": str(root), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
