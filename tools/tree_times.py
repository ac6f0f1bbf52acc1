"""K1-K10 kernel times and the encode fps and stream md5s of one checkout,
on chip_smoke.py's 1080p inputs.

    python3 tools/tree_times.py [--root DIR]
                                [--kernels [--match TEXT[,TEXT...]]] [--fps]

Imports ``svt_av1_tpu_torch`` from DIR (default: this checkout), so that
two trees (a parent commit unpacked with ``git archive`` and the change)
can be run in turns on one card, in separate processes; the inputs and
timers are always this checkout's chip_smoke.py.  With neither flag both
parts run.

* ``--kernels``: CUDA-event medians of 20 calls after one warm-up
  (chip_smoke.cuda_ms; the events also take in the host work of the
  wrapper where the card waits for it), and beside them (``device_ms``)
  the device time per call: the kernels' and copies' own time from
  torch.profiler's CUDA records over 20 calls, without the host path
  (chip_smoke.device_ms).  K1: the decisions of all 7 block shapes of
  the first frame's 1920x1152 luma plane (one launch where the package
  has ``omd.intra_decision_packed``, else one launch per shape); K5: at
  each reach of the random-access path (chip_smoke.K5_PATH_RADII) on two
  frames of the moving clip at 1920x1152, and at reach 8 on TPL's
  960x576 half-resolution planes; K6: the path's shapes (16x16
  and 64x64) on two frames of the moving clip at 1920x1152, MCTF's 32x32
  at 1920x1088 and TPL's 16x16 at 960x576; K7: the path's call (one
  reference) on two frames of the moving clip at 1920x1152, after the
  path's K5/K6; K8: the random-access path's call (two references, past
  and future, and K9's compound row) on three frames of the moving clip
  at 1920x1152, and the low-delay P call (one reference, after the
  path's K5-K7) on two frames; K9: the random-access path's call on the
  same inputs (two references), and at 10 bits where the tree's K9 takes
  int16 planes; K2 on the kernels phase's luma plane at
  the path's level and on its first chroma plane, K3 on that luma plane, K4's
  search (the 5x3 grid) and apply over the three planes of the first
  frame; K10 on TPL's half-resolution plane and on a 17-plane TPL window
  (one call where the tree's K10 takes a window, else one per plane; at
  10 bits where it takes int16 planes); where the tree has the
  16-bit forms (device.py SAMPLE_DTYPES), K1 and K4's search also on the
  10-bit frame (synth_clip at bd 10, int16 planes), and where its K5
  takes int16 planes, K5 (every reach of the path), K6 (the path's
  shapes, and TPL's 16x16 alone on int16 planes at 960x576), K7 and K8's
  low-delay P call on two frames of the moving clip at 10 bits.  K3 and
  K4's apply also have a device time with the L2 cache flushed before
  each call (``device_ms_cold``: a 128 MB write between the calls, the
  kernels' own time alone): their 1080p inputs fit in the 50 MB L2, which the
  timing loop otherwise reuses.  K4's per-fb forms on the same three
  planes at 8 and 10 bits: the search over the full 8x4 grid, the apply
  with 8 presets on a random 17x30 index grid given as a host array.
  ``--match TEXT[,TEXT...]`` times only the calls whose name holds one
  of the TEXTs.
* ``--fps``: the all-intra encode (three noise-like and three smooth
  frames), the low-delay P encode (6 frames of the moving clip) and the
  random-access encode (bench.py's configuration, 33 frames, fps over
  the last 16 after a 17-frame warm-up), chip_smoke.py's clips and
  configurations, each also at 10 bits, and the encodes of
  chip_smoke.py's full-width 10-bit jobs (the 64x64-SB random access,
  the 1918x1078 low-delay P, the preset-6 key frame), with the md5 of
  each stream's packets, the stage times of each encode (host wall
  clock, ms per coded frame, the Encoder's StageTimer), and the md5s of
  chip_smoke.py's four small card streams (agreement_clips).

Prints one JSON line: the card's name and power limit, the root, and
what was measured.  Needs a CUDA card.
"""
from __future__ import annotations

import functools
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def kernel_times(cs, np, torch, match=None):
    from svt_av1_tpu_torch.ops import bme, omd
    from svt_av1_tpu_torch.pipeline import batched_inter as bi
    from svt_av1_tpu_torch.pipeline import tpl

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
    calls = {"K1 7 shapes": k1}

    def k6(src, ref, shapes):
        coarse = bme.me_coarse(src, ref, bme.COARSE_R)
        return lambda: bme.me_refine(src, ref, coarse, shapes)

    src, ref = (omd.upload_plane(f[0], bw, bh, 8, dev) for f in clip[::-1])
    for r in cs.K5_PATH_RADII:
        calls[f"K5 r{r} 1920x1152"] = functools.partial(bme.me_coarse, src,
                                                         ref, r)
    calls["K6 path 16x16+64x64"] = k6(src, ref, ((16, 16), (64, 64)))
    hm = -(-H // 64) * 64
    mctf = [torch.from_numpy(np.ascontiguousarray(np.pad(
        f[0], ((0, hm - H), (0, 0)), mode="edge"))).to(dev)
        for f in clip[::-1]]
    calls["K6 MCTF 32x32"] = k6(*mctf, ((32, 32),))
    half = [torch.from_numpy(cs._half_res(f[0], bw, bh)).to(dev)
            for f in clip[::-1]]
    calls["K6 TPL 16x16"] = k6(*half, ((16, 16),))
    calls["K5 TPL r8 960x576"] = lambda: bme.me_coarse(*half, 8)
    calls["K10 TPL 960x576"] = lambda: tpl.block_var16(half[1])
    calls.update(k10_window_calls(cs, np, torch, dev, tpl, bw, bh))
    me = bme.frame_me(src, ref, bme.COARSE_R, ((16, 16), (64, 64)))
    ny, nx = bh // 64, bw // 64
    mv = [bi._nested_to_grid(me[(16, 16)][i], ny, nx, 4, 4) for i in (0, 1)]
    calls["K7 path 1 ref"] = lambda: bme.subpel_refine16(src, ref, *mv)
    calls["K8 1 ref"] = k8_one_ref(bme, bi, src, ref, me, mv, ny, nx, 8,
                                   lam)
    calls["K8 compound row"], calls["K9 2 refs"] = ra_calls(cs, torch, dev)
    k9_10 = ra_calls(cs, torch, dev, bd=10)
    if k9_10 is not None:
        calls["K9 2 refs 10-bit"] = k9_10[1]
    calls["K4 search 5x3"] = k4_search_call(cs, np, torch, dev)
    from svt_av1_tpu_torch import device

    if hasattr(device, "SAMPLE_DTYPES"):    # the tree has the 16-bit forms
        p10 = omd.upload_plane(cs.synth_clip(W, H, 1, bd=10)[0][0], bw, bh,
                               10, dev)
        calls["K1 7 shapes 10-bit"] = lambda: omd.intra_decision_packed(
            p10, qindex, lam * 16, mb, 10)
        calls["K4 search 5x3 10-bit"] = k4_search_call(cs, np, torch, dev,
                                                       bd=10)
        s10, r10 = (omd.upload_plane(f[0], bw, bh, 10, dev)
                    for f in cs.synth_clip(W, H, 2, bd=10)[::-1])
        try:
            bme.me_coarse(s10, r10, bme.COARSE_R)
        except ValueError:          # a tree without K5-K8's 16-bit forms
            s10 = None
        if s10 is not None:
            for r in cs.K5_PATH_RADII:
                calls[f"K5 r{r} 1920x1152 10-bit"] = functools.partial(
                    bme.me_coarse, s10, r10, r)
            calls["K6 path 16x16+64x64 10-bit"] = k6(s10, r10,
                                                     ((16, 16), (64, 64)))
            half10 = [torch.from_numpy(cs._half_res(f[0], bw, bh, 10))
                      .to(dev) for f in cs.synth_clip(W, H, 2, bd=10)[::-1]]
            calls["K6 TPL 16x16 10-bit"] = k6(*half10, ((16, 16),))
            me10 = bme.frame_me(s10, r10, bme.COARSE_R,
                                ((16, 16), (64, 64)))
            mv10 = [bi._nested_to_grid(me10[(16, 16)][i], ny, nx, 4, 4)
                    for i in (0, 1)]
            calls["K7 path 1 ref 10-bit"] = lambda: bme.subpel_refine16(
                s10, r10, *mv10, 10)
            calls["K8 1 ref 10-bit"] = k8_one_ref(bme, bi, s10, r10, me10,
                                                  mv10, ny, nx, 10, lam * 16)
    calls.update(filter_calls(cs, np, torch, dev))
    calls.update(k4_fb_calls(cs, np, torch, dev))
    if match:
        calls = {k: f for k, f in calls.items()
                 if any(m in k for m in match.split(","))}
    cold = {k: device_ms_cold(torch, calls[k], name) for k, name in (
        ("K3 1080p luma", "cdef_direction_kernel"),
        ("K4 apply 3 planes", "cdef_apply_kernel")) if k in calls}
    return ({k: cs.cuda_ms(f, 20) for k, f in calls.items()},
            {k: cs.device_ms(f) for k, f in calls.items()}, cold)


def k8_one_ref(bme, bi, src, ref, me, mv, ny, nx, bd, lam):
    """K8's low-delay P call with one reference (the path's K7 output) at
    ``bd``, as a function of no arguments."""
    a, b, p = bme.subpel_refine16(src, ref, *mv, bd)
    sb = [me[(64, 64)][i].reshape(1, ny, nx).contiguous() for i in (0, 1)]
    args = (src, p[None].contiguous(), a[None].contiguous(),
            b[None].contiguous(), *sb, 160, lam)
    if bd == 8:
        return lambda: bi.inter_select(*args)
    return lambda: bi.inter_select(*args, bd)


def device_ms_cold(torch, fn, kernel, reps=20):
    """Device time per call of the CUDA kernels whose name holds
    ``kernel``, with the L2 cache flushed before each call (a 128 MB
    write, more than the H100's 50 MB L2), from torch.profiler's records
    over ``reps`` calls after one warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.fill_(1)
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and kernel in e.key)
    return us / reps / 1e3


def filter_calls(cs, np, torch, dev):
    """K2, K3 and K4's apply on chip_smoke.py's kernels-phase inputs: K2
    on the noisy luma recon at the path's level (all-intra qindex) and on
    the first chroma plane, K3 on the luma recon, K4's apply over it and
    the two padded chroma sources with 80% of the units non-skip."""
    from svt_av1_tpu_torch.ops import cdef, dlf
    from svt_av1_tpu_torch.pipeline.rate_control import RateControl

    W, H = cs.WIDTH, cs.HEIGHT
    bw, bh = -(-W // 128) * 128, -(-H // 128) * 128
    frame = cs.synth_clip(W, H, 1)[0]
    rng = np.random.default_rng(0)
    ry, prm, chroma, cprm = cs.deblock_inputs(dev, frame, rng, bw, bh)
    cfg = cs.slice_config(W, H)
    qindex = RateControl(cfg, float(cfg.frame_rate),
                         all_intra=True).peek_qindex(True, 0, 0)
    lvl = dlf.filter_levels_from_qindex(qindex)
    dirs, var = cdef.cdef_direction(ry, W, H, 0)
    ns = torch.from_numpy(rng.random(tuple(dirs.shape)) < 0.8).to(dev)
    rec = [ry] + [torch.from_numpy(np.ascontiguousarray(np.pad(
        p, ((0, bh // 2 - H // 2), (0, 0)), mode="edge")).astype(
            np.int32)).to(dev) for p in frame[1:]]
    return {f"K2 luma level {lvl}": lambda: dlf.deblock(
                ry, *prm, W, H, lvl, lvl, 0),
            "K2 chroma 960x576": lambda: dlf.deblock(
                chroma[0], *cprm, W // 2, H // 2, lvl, lvl, 0),
            "K3 1080p luma": lambda: cdef.cdef_direction(ry, W, H, 0),
            "K4 apply 3 planes": lambda: cdef.cdef_apply(
                rec, ns, dirs, var, 8 * 4 + 1, 4 * 4 + 2, 5, W, H, 8)}


def k10_window_calls(cs, np, torch, dev, tpl, bw, bh):
    """K10 on a 17-plane TPL window of half-resolution planes (the first 17
    frames of the moving clip): one call where the tree's K10 takes a
    window, else one call per plane; at 10 bits (int16 planes) only where
    it takes them."""
    clip = cs.synth_clip(cs.WIDTH, cs.HEIGHT, cs.RA_WARM)
    clip10 = cs.synth_clip(cs.WIDTH, cs.HEIGHT, cs.RA_WARM, bd=10)
    out = {}
    for name, frames, bd in (("K10 TPL window 17x960x576", clip, 8),
                             ("K10 TPL window 17x960x576 10-bit", clip10,
                              10)):
        win = torch.stack([torch.from_numpy(cs._half_res(f[0], bw, bh, bd))
                           for f in frames]).to(dev)
        try:
            tpl.block_var16(win)
            out[name] = functools.partial(tpl.block_var16, win)
        except ValueError:      # a tree whose K10 takes one uint8 plane
            if bd == 8:
                out[name] = lambda win=win: [tpl.block_var16(p) for p in win]
    return out


def ra_calls(cs, torch, dev, bd=8):
    """K8 and K9 as the random-access path calls them: the middle of three
    frames against the outer two (K8 with the compound row); at ``bd`` 10
    the moving clip at 10 bits, and None where the tree's K9 refuses it."""
    from svt_av1_tpu_torch.ops import bme, omd
    from svt_av1_tpu_torch.pipeline import batched_inter as bi

    W, H = -(-cs.WIDTH // 128) * 128, -(-cs.HEIGHT // 128) * 128
    clip = cs.synth_clip(cs.WIDTH, cs.HEIGHT, 3, bd=bd)
    src = omd.upload_plane(clip[1][0], W, H, bd, dev)
    refs = [omd.upload_plane(clip[k][0], W, H, bd, dev) for k in (0, 2)]
    ny, nx = H // 64, W // 64
    parts = []
    for k, ref in enumerate(refs):
        m = bme.frame_me(src, ref, bme.coarse_r_for_dist((-1, 1)[k]),
                         ((16, 16), (64, 64)))
        a, b, pr = bme.subpel_refine16(
            src, ref, bi._nested_to_grid(m[(16, 16)][0], ny, nx, 4, 4),
            bi._nested_to_grid(m[(16, 16)][1], ny, nx, 4, 4), bd)
        parts.append((pr, a, b, m[(64, 64)][0].reshape(ny, nx),
                      m[(64, 64)][1].reshape(ny, nx)))
    preds, mvq_r, mvq_c, sb_r, sb_c = (
        torch.stack([p[i] for p in parts]).contiguous() for i in range(5))
    qindex, lam = 160, 2500.0
    k9_args = (src, torch.stack(refs).contiguous(), preds, mvq_r, mvq_c,
               sb_r, sb_c, (False, True), (-1, 1), qindex) \
        + ((bd,) if bd != 8 else ())
    try:
        comp = bi.compound_joint(*k9_args)
    except ValueError:          # a tree whose K9 is 8-bit only
        return None
    args = (src, preds, mvq_r, mvq_c, sb_r, sb_c, qindex, lam) \
        + ((bd,) if bd != 8 else ())
    return (lambda: bi.inter_select(*args, comp=comp),
            lambda: bi.compound_joint(*k9_args))


def k4_inputs(cs, np, torch, dev, bd=8):
    """K4's inputs on the three planes of the first frame: (sources, recon
    planes, directions, variances, a nonskip map of 80% of the units); at
    ``bd`` 10 the 10-bit frame, int16 sources."""
    from svt_av1_tpu_torch.ops import cdef

    W, H = cs.WIDTH, cs.HEIGHT
    bh = -(-H // 128) * 128
    frame = cs.synth_clip(W, H, 1, bd=bd)[0]
    rng = np.random.default_rng(0)
    top, scale = (1 << bd) - 1, 1 << (bd - 8)
    rec = [torch.from_numpy(np.ascontiguousarray(np.pad(
        p, ((0, (bh >> s) - (H >> s)), (0, 0)), mode="edge")).astype(
            np.int32)).to(dev) for s, p in zip((0, 1, 1), frame)]
    rec = [(r + torch.from_numpy(rng.integers(-6, 7, tuple(r.shape)).astype(
        np.int32) * scale).to(dev)).clamp(0, top) for r in rec]
    src = [(r + torch.randint(-4, 5, r.shape, device=dev) * scale)
           .clamp(0, top).to(torch.uint8 if bd == 8 else torch.int16)
           for r in rec]
    dirs, var = cdef.cdef_direction(rec[0], W, H, bd - 8)
    ns = torch.from_numpy(rng.random(tuple(dirs.shape)) < 0.8).to(dev)
    return src, rec, dirs, var, ns


def k4_search_call(cs, np, torch, dev, bd=8):
    """K4's search over the three planes of the first frame at the fast
    5x3 grid, as chip_smoke.py's kernels phase calls it (at ``bd`` 10: the
    10-bit frame, int16 sources)."""
    from svt_av1_tpu_torch.ops import cdef

    src, rec, dirs, var, ns = k4_inputs(cs, np, torch, dev, bd)
    return lambda: cdef.cdef_search(src, rec, dirs, var, ns, cs.WIDTH,
                                    cs.HEIGHT, 5, bd, cdef.PRI_SET_FAST,
                                    cdef.SEC_SET_FAST)


def k4_fb_calls(cs, np, torch, dev):
    """K4's per-fb forms on the same planes at 8 and 10 bits: the search
    over the full 8x4 grid (its totals per 64x64 filter block), and the
    apply with 8 presets on a random index grid, handed over on the host
    as the codec hands it over."""
    from svt_av1_tpu_torch.ops import cdef

    W, H = cs.WIDTH, cs.HEIGHT
    rng = np.random.default_rng(1)
    ys = tuple(int(v) for v in rng.integers(1, 64, 8))
    us = tuple(int(v) for v in rng.integers(1, 64, 8))
    idx = rng.integers(0, 8, (-(-H // 64), -(-W // 64))).astype(np.int32)
    calls = {}
    for bd, sfx in ((8, ""), (10, " 10-bit")):
        src, rec, dirs, var, ns = k4_inputs(cs, np, torch, dev, bd)
        calls["K4 search fb 8x4" + sfx] = functools.partial(
            cdef.cdef_search_fb, src, rec, dirs, var, ns, W, H, 5, bd)
        calls[f"K4 apply multi 8 presets bd {bd}"] = functools.partial(
            cdef.cdef_apply_multi, rec, ns, dirs, var, ys, us, idx, 5, W, H,
            bd)
    return calls


def encode_fps(cs, torch):
    """fps, the md5 of the packets and the stage ms per frame of each
    1080p encode, and the md5s of the small card streams."""
    import hashlib
    import tempfile

    from svt_av1_tpu_torch.api import Encoder, encode_ivf

    W, H = cs.WIDTH, cs.HEIGHT
    half = cs.N_FRAMES // 2
    ai = cs.synth_clip(W, H, half) + cs.synth_clip(
        W, H, cs.N_FRAMES - half, tex_sigma=cs.SMOOTH_SIGMA)
    moving = cs.synth_clip(W, H, cs.RA_FRAMES)
    md5, stages = {}, {}

    def run(name, frames, cfg, warm=0):
        enc = Encoder(cfg)
        h = hashlib.md5()
        torch.cuda.synchronize()
        t0 = t_warm = time.perf_counter()
        for i, planes in enumerate(list(frames) + [None]):
            if i == warm:
                torch.cuda.synchronize()
                t_warm = time.perf_counter()
            for pkt in (enc.flush() if planes is None
                        else enc.send_picture(planes)):
                h.update(pkt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        md5[name] = h.hexdigest()
        stages[name] = {k: v.get("ms_per_frame")
                        for k, v in enc.perf_report().items() if k != "_wall"}
        return (len(frames) - warm) / (t1 - t_warm), len(frames) / (t1 - t0)

    fps = {}
    fps["all_intra"] = run("all_intra", ai, cs.slice_config(W, H))[1]
    fps["low_delay_p"] = run("low_delay_p", moving[:cs.N_FRAMES],
                             cs.slice_config(W, H, -1))[1]
    fps["random_access_window"], fps["random_access"] = run(
        "random_access", moving, cs.ra_config(W, H), cs.RA_WARM)
    # the 10-bit streams chip_smoke.py codes: its three 10-bit cells, and
    # the 10-bit settings and preset jobs (their encodes alone)
    ai10 = cs.synth_clip(W, H, half, bd=10) + cs.synth_clip(
        W, H, cs.N_FRAMES - half, tex_sigma=cs.SMOOTH_SIGMA, bd=10)
    moving10 = cs.synth_clip(W, H, cs.RA_FRAMES, bd=10)
    fps["all_intra_10bit"] = run("all_intra_10bit", ai10,
                                 cs.slice_config(W, H, bd=10))[1]
    fps["low_delay_p_10bit"] = run("low_delay_p_10bit",
                                   moving10[:cs.N_FRAMES],
                                   cs.slice_config(W, H, -1, 10))[1]
    fps["random_access_10bit_window"], fps["random_access_10bit"] = run(
        "random_access_10bit", moving10, cs.ra_config(
            W, H, encoder_bit_depth=10), cs.RA_WARM)
    jobs = [s for pair in cs.settings_specs() for s in pair] + list(
        cs.PRESET_JOBS)
    for spec in jobs:
        name, preset, w, h, n, structure, bd = spec[:7]
        if bd == 10 and not spec[8]:        # on the card, not card = CPU
            fps[name] = run(name, cs.preset_frames(spec), cs.preset_config(
                preset, w, h, structure, bd, **spec[9]))[1]
    with tempfile.TemporaryDirectory() as tmp:
        for k, (name, frames, cfg) in enumerate(cs.agreement_clips()):
            path = Path(tmp) / f"{k}.ivf"
            encode_ivf(frames, cfg, str(path), device="cuda")
            md5[name] = cs.stream_md5(path)
    return fps, md5, stages


def main() -> int:
    args = sys.argv[1:]
    root = Path(args[args.index("--root") + 1]).resolve() \
        if "--root" in args else HERE
    want_k, want_f = "--kernels" in args, "--fps" in args
    if not (want_k or want_f):
        want_k = want_f = True
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("tree_times: no CUDA device", file=sys.stderr)
        return 2
    # this checkout's inputs and timers, whatever the root holds
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import svt_av1_tpu_torch

    assert Path(svt_av1_tpu_torch.__file__).resolve().is_relative_to(root), \
        "the package must come from --root"
    out = {}
    if want_k:
        match = args[args.index("--match") + 1] if "--match" in args else None
        out["ms"], out["device_ms"], out["device_ms_cold"] = kernel_times(
            cs, np, torch, match)
    if want_f:
        out["fps"], out["md5"], out["stage_ms"] = encode_fps(cs, torch)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "root": str(root), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
