"""Smoke run of the PyTorch/CUDA port (svt_av1_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel of the slice from kernels/csrc/ (one nvcc per
   source, all at once) and the host C extensions, timed as set-up;
3. kernels: each kernel's wrapper on card tensors at the 1080p slice's
   shapes, held against its plain PyTorch version on the same inputs
   (integers exact; intra costs to rtol 1e-5 with >= 99% of the modes
   equal), with CUDA-event times of both;
4. encode: the port's Encoder on N_FRAMES synthetic 1920x1080 frames,
   all-intra preset 8 (LOW_DELAY_P, qp 40), with every launch counter set
   to 0 just before and read just after; every kernel must have launched;
   the IVF must hold every frame, the recon's PSNR must exceed
   PSNR_FLOOR_DB, and the frame headers read back from the stream must
   show a deblocking level above 0 on the smooth frames (the noise-like
   frames keep "no filter");
5. agreement: small clips coded on the card and with the plain versions
   on the CPU give byte-identical streams;
6. one JSON line listing every kernel, then the device line last.

``--trace DIR`` adds a phase before the last two lines: a second encode
of TRACE_FRAMES frames under torch.profiler, which prints the card's busy
share of the wall time and the device time by kernel, and writes the
Chrome trace into DIR (gzipped).

Needs the repository beside it (it imports the port, never jax or the
JAX package) and a CUDA device; without either it fails before any
result.
"""
from __future__ import annotations

import gzip
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

N_FRAMES = 6
WIDTH, HEIGHT = 1920, 1080
QP = 40
# the first half of the clip has a noise-like texture (sigma 12), where
# "no filter" wins the deblocking level search; the second half is smooth
# (sigma 2), where qp 40 leaves block edges that the searched level
# filters on all three planes
TEXTURE_SIGMA, SMOOTH_SIGMA = 12.0, 2.0
# the noise-like frames keep about 27.5 dB of luma PSNR at qp 40; a recon
# that is broken lands far below the floor
PSNR_FLOOR_DB = 25.0
KERNEL_REPS = 20
PLAIN_REPS = 5
TRACE_FRAMES = 3

# published peaks of one H100 SXM (NVIDIA's data sheet, dense rates):
# HBM bytes/s and float32 (non-tensor-core) operations/s; the integer
# kernels' 32-bit operations are counted against the same rate
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def synth_clip(w, h, n, seed=3, tex_sigma=TEXTURE_SIGMA):
    """Natural-ish synthetic content: moving textured fore/background,
    gradients, sharp edges, mild sensor noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    tex = rng.normal(0, tex_sigma, (h * 2, w * 2))
    frames = []
    for i in range(n):
        dx, dy = int(3.1 * i) % w, int(1.7 * i) % h
        bg = 90 + 50 * np.sin((xx + 2 * i) / 37) + 25 * np.cos(yy / 29)
        y = bg + tex[dy:dy + h, dx:dx + w]
        x0 = (40 + 5 * i) % (w - 80)
        y0 = (30 + 3 * i) % (h - 60)
        y[y0:y0 + 60, x0:x0 + 80] = 190 - (xx[:60, :80] % 17) * 4
        y = (y + rng.normal(0, 2, (h, w))).clip(0, 255).astype(np.uint8)
        u = (120 + 30 * np.sin((yy[:h // 2, :w // 2] + i) / 23)
             ).clip(0, 255).astype(np.uint8)
        v = (130 - 30 * np.cos((xx[:h // 2, :w // 2] + 2 * i) / 31)
             ).clip(0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def cuda_ms(fn, reps):
    """Median of ``reps`` CUDA-event-timed calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2
                                                             / mse))


# --------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the slice's shapes
# --------------------------------------------------------------------------

def slice_config(w, h):
    from svt_av1_tpu_torch.config import EncoderConfig, PredStructure

    return EncoderConfig(source_width=w, source_height=h, qp=QP,
                         enc_mode=8, intra_period_length=0,
                         pred_structure=PredStructure.LOW_DELAY_P)


def kernels_phase(dev, frame):
    from svt_av1_tpu_torch.entropy.tables import FrameCdfs
    from svt_av1_tpu_torch.ops import cdef, dlf, omd
    from svt_av1_tpu_torch.pipeline.batched_md import default_mode_bits
    from svt_av1_tpu_torch.pipeline.rate_control import RateControl
    from svt_av1_tpu_torch.pipeline.rdo import rd_lambda

    rng = np.random.default_rng(0)
    # the codec's buffer: whole 128x128 superblocks (1920x1152 at 1080p)
    buf_w, buf_h = -(-WIDTH // 128) * 128, -(-HEIGHT // 128) * 128
    results = {}

    # -- K1 intra decision: 7 shape grids of the buf-aligned luma plane
    cfg = slice_config(WIDTH, HEIGHT)
    qindex = RateControl(cfg, float(cfg.frame_rate),
                         all_intra=True).peek_qindex(True, 0, 0)
    lam = rd_lambda(qindex, 8)
    mb = default_mode_bits(FrameCdfs(qindex))
    plane = omd.upload_plane(frame[0], buf_w, buf_h, 8, dev)
    shapes = omd.ALL_SHAPES

    def k1():
        return [omd.intra_decision(plane, w, h, qindex, lam, mb)
                for (w, h) in shapes]

    def k1_plain():
        return [omd.intra_decision_plain(plane, w, h, qindex, lam, mb)
                for (w, h) in shapes]

    got, want = k1(), k1_plain()
    torch.cuda.synchronize()
    err = 0.0
    for (w, h), (m, c), (m2, c2) in zip(shapes, got, want):
        same = (m == m2).float().mean().item()
        close = torch.isclose(c, c2, rtol=1e-5).float().mean().item()
        err = max(err, (c - c2).abs().max().item())
        print(f"K1 intra_decision {w}x{h}: modes equal {same:.6f}, "
              f"costs within rtol 1e-5 {close:.6f}")
        assert same >= 0.99 and close >= 0.99, (w, h, same, close)
    flops = sum(13 * 2 * buf_w * buf_h * (w + h) for (w, h) in shapes)
    out_b = sum(nbytes(m, c) for m, c in got)
    results["intra_decision"] = dict(
        ms=cuda_ms(k1, KERNEL_REPS), plain_ms=cuda_ms(k1_plain, PLAIN_REPS),
        max_abs_err=err, bound=bound_ms(nbytes(plane) + out_b, flops),
        per_call=f"7 launches, one per block shape ({flops / 1e9:.2f} "
                 "GFLOP)")

    # -- K2 deblocking: one luma plane at one level, both directions
    src_y = torch.from_numpy(np.ascontiguousarray(
        np.pad(frame[0], ((0, buf_h - HEIGHT), (0, 0)), mode="edge")))
    rec_y = (src_y.to(torch.int32)
             + torch.from_numpy(rng.integers(-6, 7, (buf_h, buf_w))
                                .astype(np.int32))).clamp(0, 255)
    y4, x4 = buf_h // 4, buf_w // 4
    tx = rng.choice([4, 8, 16, 32], size=(y4, x4)).astype(np.int32)
    skip = rng.random((y4, x4)) < 0.3
    bex = rng.random((y4, x4)) < 0.5
    bey = rng.random((y4, x4)) < 0.5
    prm = [torch.from_numpy(np.ascontiguousarray(a, np.uint8)).to(dev)
           for a in dlf.edge_params(tx, tx, skip, bex, bey, WIDTH, HEIGHT,
                                    False)]
    ry = rec_y.to(dev)
    lvl = dlf.filter_levels_from_qindex(qindex)
    k2 = lambda: dlf.deblock(ry, *prm, WIDTH, HEIGHT, lvl, lvl, 0)  # noqa
    k2_plain = lambda: dlf.loop_filter_plane_full(  # noqa: E731
        ry, *prm, WIDTH, HEIGHT, lvl, lvl, 0)
    a, b = k2(), k2_plain()
    torch.cuda.synchronize()
    err = (a - b).abs().max().item()
    print(f"K2 deblock level {lvl}: max |kernel - plain| {err}, "
          f"{(a != ry).sum().item()} samples changed")
    assert err == 0
    # ... and both chroma planes at the main path's chroma shape, with
    # chroma edge masks (filters of at most 6 taps)
    cw, ch = WIDTH // 2, HEIGHT // 2
    c4y, c4x = buf_h // 8, buf_w // 8
    ctx = rng.choice([4, 8, 16, 32], size=(c4y, c4x)).astype(np.int32)
    cprm = [torch.from_numpy(np.ascontiguousarray(a, np.uint8)).to(dev)
            for a in dlf.edge_params(ctx, ctx, rng.random((c4y, c4x)) < 0.3,
                                     rng.random((c4y, c4x)) < 0.5,
                                     rng.random((c4y, c4x)) < 0.5, cw, ch,
                                     True)]
    for pli, p in ((1, frame[1]), (2, frame[2])):
        rc = (torch.from_numpy(np.ascontiguousarray(
            np.pad(p, ((0, buf_h // 2 - ch), (0, 0)), mode="edge"))
            .astype(np.int32)) + torch.from_numpy(
                rng.integers(-6, 7, (buf_h // 2, buf_w // 2))
                .astype(np.int32))).clamp(0, 255).to(dev)
        k2c = lambda: dlf.deblock(rc, *cprm, cw, ch, lvl, lvl, 0)  # noqa
        a_c = k2c()
        b_c = dlf.loop_filter_plane_full(rc, *cprm, cw, ch, lvl, lvl, 0)
        torch.cuda.synchronize()
        err_c = (a_c - b_c).abs().max().item()
        print(f"K2 deblock chroma plane {pli} ({rc.shape[1]}x{rc.shape[0]}) "
              f"level {lvl}: max |kernel - plain| {err_c}, "
              f"{(a_c != rc).sum().item()} samples changed, kernel "
              f"{cuda_ms(k2c, KERNEL_REPS):.4f} ms")
        assert err_c == 0 and bool((a_c != rc).any())
        err = max(err, err_c)
    results["deblock"] = dict(
        ms=cuda_ms(k2, KERNEL_REPS), plain_ms=cuda_ms(k2_plain, PLAIN_REPS),
        max_abs_err=err, bound=bound_ms(nbytes(ry, a, *prm), 0),
        per_call="2 launches (vertical, horizontal) on the luma plane")

    # -- K3 CDEF directions of the luma plane
    k3 = lambda: cdef.cdef_direction(ry, WIDTH, HEIGHT, 0)  # noqa: E731
    k3_plain = lambda: cdef.find_dir_grid(cdef._units_of(  # noqa: E731
        cdef.pad_very_large(ry, WIDTH, HEIGHT, 8), WIDTH, HEIGHT, 8), 0)
    (d1, v1), (d2, v2) = k3(), k3_plain()
    torch.cuda.synchronize()
    err = max((d1 - d2).abs().max().item(), (v1 - v2).abs().max().item())
    print(f"K3 cdef_direction: max |kernel - plain| {err}")
    assert err == 0
    n_units = d1.numel()
    # per unit: 8 direction sums of 64 samples, 15 squares and
    # multiply-adds each, argmax and the variance
    results["cdef_direction"] = dict(
        ms=cuda_ms(k3, KERNEL_REPS), plain_ms=cuda_ms(k3_plain, PLAIN_REPS),
        max_abs_err=err,
        bound=bound_ms(WIDTH * HEIGHT * 4 + nbytes(d1, v1),
                       n_units * (8 * 64 + 8 * 15 * 3 + 16)),
        per_call="1 launch")

    # -- K4 CDEF strength search and apply on the three planes
    ns = torch.from_numpy(rng.random(d1.shape) < 0.8).to(dev)
    chroma = [torch.from_numpy(np.ascontiguousarray(
        np.pad(p, ((0, buf_h // 2 - HEIGHT // 2), (0, 0)), mode="edge"))
        .astype(np.int32)).to(dev) for p in frame[1:]]
    rec = [ry] + chroma
    src = [(r + torch.randint(-4, 5, r.shape, device=dev)).clamp(0, 255)
           .to(torch.uint8) for r in rec]
    pri_set, sec_set = cdef.PRI_SET_FAST, cdef.SEC_SET_FAST
    damping = 5
    k4s = lambda: cdef.cdef_search(  # noqa: E731
        src, rec, d1, v1, ns, WIDTH, HEIGHT, damping, 8, pri_set, sec_set)
    k4s_plain = lambda: cdef.cdef_search_errs(  # noqa: E731
        src, rec, d1, v1, ns, WIDTH, HEIGHT, damping, 8, pri_set, sec_set)
    got, want = k4s(), k4s_plain()
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    print(f"K4 cdef_search ({len(pri_set)}x{len(sec_set)} grid): "
          f"max |kernel - plain| {err}")
    assert err == 0
    combos = len(pri_set) * len(sec_set)
    vis_px = WIDTH * HEIGHT + 2 * (WIDTH // 2) * (HEIGHT // 2)
    frac = ns.float().mean().item()
    # per filtered pixel and combination: 12 taps of constrain (7 ops)
    # and multiply-add (2), rounding and clip (5), squared error (3)
    ops_px = 12 * 9 + 5 + 3
    vis_bytes = vis_px * (4 + 1)            # int32 recon + uint8 source
    results["cdef_search"] = dict(
        ms=cuda_ms(k4s, KERNEL_REPS), plain_ms=cuda_ms(k4s_plain, PLAIN_REPS),
        max_abs_err=err,
        bound=bound_ms(vis_bytes + nbytes(d1, v1, ns),
                       vis_px * frac * combos * ops_px),
        per_call="3 launches, one per plane")
    ystr, uvstr = 8 * 4 + 1, 4 * 4 + 2
    k4a = lambda: cdef.cdef_apply(  # noqa: E731
        rec, ns, d1, v1, ystr, uvstr, damping, WIDTH, HEIGHT, 8)
    k4a_plain = lambda: cdef.cdef_apply_plain(  # noqa: E731
        rec, ns, d1, v1, ystr, uvstr, damping, WIDTH, HEIGHT, 8)
    got, want = k4a(), k4a_plain()
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    print(f"K4 cdef_apply (y {ystr}, uv {uvstr}): max |kernel - plain| "
          f"{err}")
    assert err == 0
    results["cdef_apply"] = dict(
        ms=cuda_ms(k4a, KERNEL_REPS), plain_ms=cuda_ms(k4a_plain, PLAIN_REPS),
        max_abs_err=err,
        bound=bound_ms(2 * nbytes(*rec) + nbytes(d1, v1, ns),
                       vis_px * frac * (ops_px - 3)),
        per_call="3 launches, one per plane")
    return results


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------

def stream_filter_params(path):
    """Per frame of the IVF at ``path``: (deblocking level, CDEF luma
    strength, CDEF chroma strength), read back from the frame headers."""
    from svt_av1_tpu_torch.bitstream.bits import BitReader
    from svt_av1_tpu_torch.bitstream.headers import (iter_obus,
                                                     parse_frame_header,
                                                     parse_sequence_header)
    from svt_av1_tpu_torch.constants import ObuType
    from svt_av1_tpu_torch.io import IvfReader

    seq, out = None, []
    for pkt, _ in IvfReader(str(path)):
        for obu_type, payload in iter_obus(pkt):
            if obu_type == ObuType.OBU_SEQUENCE_HEADER:
                seq = parse_sequence_header(payload)
            elif obu_type in (ObuType.OBU_FRAME, ObuType.OBU_FRAME_HEADER):
                fh = parse_frame_header(BitReader(payload), seq)
                out.append((max(fh.filter_level), fh.cdef_y_strengths[0],
                            fh.cdef_uv_strengths[0]))
    return out


def encode_phase(counters, frames, out_dir):
    from svt_av1_tpu_torch.api import Encoder
    from svt_av1_tpu_torch.io import IvfReader, IvfWriter

    cfg = slice_config(WIDTH, HEIGHT)
    enc = Encoder(cfg)                      # the default device: CUDA
    assert enc.device.type == "cuda"
    path = Path(out_dir) / "smoke_1080p.ivf"
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with IvfWriter(str(path), WIDTH, HEIGHT, cfg.frame_rate) as w:
        pts = 0
        for planes in frames:
            for pkt in enc.send_picture(planes):
                w.write_frame(pkt, pts=pts)
                pts += 1
        for pkt in enc.flush():
            w.write_frame(pkt, pts=pts)
            pts += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    print("main path launches:", json.dumps(launches))
    missing = [n for n, c in launches.items() if c == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"

    n_pkts = sum(1 for _ in IvfReader(str(path)))
    assert n_pkts == len(frames), (n_pkts, len(frames))
    recon = [enc.recon_by_display[d] for d in sorted(enc.recon_by_display)]
    assert len(recon) == len(frames)
    scores = []
    for src, rec in zip(frames, recon):
        for p in range(3):
            assert rec[p].shape == src[p].shape, (rec[p].shape, src[p].shape)
            assert np.isfinite(rec[p]).all()
        scores.append(psnr(src[0], rec[0]))
    print(f"recon luma PSNR per frame (dB): "
          f"{[round(s, 3) for s in scores]}")
    assert min(scores) > PSNR_FLOOR_DB, (min(scores), PSNR_FLOOR_DB)
    params = stream_filter_params(path)
    print("per frame (deblocking level, CDEF y, CDEF uv) from the stream:",
          json.dumps(params))
    assert len(params) == len(frames)
    assert any(lv > 0 for lv, _, _ in params), \
        "the level search chose no deblocking on any frame"
    rep = enc.perf_report()
    per_frame = {k: v.get("ms_per_frame") for k, v in rep.items()
                 if k != "_wall"}
    print(f"encode: {len(frames)} frames {WIDTH}x{HEIGHT} in {wall:.3f} s, "
          f"{len(frames) / wall:.4f} fps, {path.stat().st_size} bytes")
    print("stage ms/frame (host wall clock):", json.dumps(per_frame))
    return launches


# --------------------------------------------------------------------------
# phase 5: small clips, kernels on the card vs plain versions on the CPU
# --------------------------------------------------------------------------

def agreement_phase(out_dir):
    from svt_av1_tpu_torch.api import encode_ivf

    clip = synth_clip(176, 144, 2, seed=13)
    for (w, h) in ((64, 64), (176, 144)):
        frames = [tuple(np.ascontiguousarray(p[:h >> (i > 0), :w >> (i > 0)])
                        for i, p in enumerate(f)) for f in clip]
        cfg = slice_config(w, h)
        streams = {}
        for dev in ("cuda", "cpu"):
            p = Path(out_dir) / f"agree_{w}x{h}_{dev}.ivf"
            encode_ivf(frames, cfg, str(p), device=dev)
            streams[dev] = p.read_bytes()
        same = streams["cuda"] == streams["cpu"]
        print(f"{w}x{h}x{len(frames)}: card stream "
              f"{len(streams['cuda'])} bytes, CPU stream "
              f"{len(streams['cpu'])} bytes, identical {same}")
        assert same, (w, h)


# --------------------------------------------------------------------------
# optional: where the encode's time goes, from a profiler trace
# --------------------------------------------------------------------------

def trace_phase(frames, trace_dir):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from svt_av1_tpu_torch.api import Encoder

    enc = Encoder(slice_config(WIDTH, HEIGHT))
    enc.send_picture(frames[0])             # warm: worker thread, caches
    enc.flush()
    enc = Encoder(slice_config(WIDTH, HEIGHT))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for planes in frames:
            enc.send_picture(planes)
        enc.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels and copies); a host op's device
    # time repeats its children's
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) \
                + e.self_device_time_total
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(f"trace: {len(frames)} frames, wall {wall * 1e3:.3f} ms, device "
          f"busy {busy_ms:.3f} ms ({100 * busy_ms / (wall * 1e3):.3f}% of "
          f"the wall time)")
    print("trace device ms by kernel:", json.dumps(
        {k: round(v / 1e3, 4) for k, v in top}))
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "encode_1080p.json"))
    with open(out / "encode_1080p.json", "rb") as f, \
            gzip.open(out / "encode_1080p.json.gz", "wb") as g:
        g.write(f.read())
    (out / "encode_1080p.json").unlink()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from svt_av1_tpu_torch.kernels import build
    from svt_av1_tpu_torch.ops import cdef, dlf, omd

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print("python", sys.version.split()[0], "torch", torch.__version__,
          "cuda", torch.version.cuda)
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    took = build.build_all_cuda()
    for name in ("ec_native", "tx_native", "block_native", "coder_native"):
        build.load_c_extension(name)
    print(f"build: CUDA kernels {json.dumps(took)} s; all builds "
          f"{time.perf_counter() - t0:.3f} s")

    half = N_FRAMES // 2
    frames = synth_clip(WIDTH, HEIGHT, half) + synth_clip(
        WIDTH, HEIGHT, N_FRAMES - half, tex_sigma=SMOOTH_SIGMA)
    kres = kernels_phase(dev, frames[0])

    counters = {"intra_decision": omd.intra_decision,
                "deblock": dlf.deblock,
                "cdef_direction": cdef.cdef_direction,
                "cdef_search": cdef.cdef_search,
                "cdef_apply": cdef.cdef_apply}
    out_dir = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        launches = encode_phase(counters, frames, tmp)
        agreement_phase(tmp)
    if "--trace" in sys.argv:
        trace_phase(frames[:TRACE_FRAMES],
                    sys.argv[sys.argv.index("--trace") + 1])

    sources = {"intra_decision": ("intra_decision.cu",
                                  "svt_av1_tpu/ops/omd.py:346"),
               "deblock": ("deblock.cu", "svt_av1_tpu/ops/dlf.py:359"),
               "cdef_direction": ("cdef_direction.cu",
                                  "svt_av1_tpu/ops/cdef.py:444"),
               "cdef_search": ("cdef_filter.cu",
                               "svt_av1_tpu/ops/cdef.py:645"),
               "cdef_apply": ("cdef_filter.cu",
                              "svt_av1_tpu/ops/cdef.py:726")}
    rows = []
    for name, (src, replaces) in sources.items():
        r = kres[name]
        b_ms, b_by = r["bound"]
        rows.append(dict(
            name=name, route="cuda",
            source=f"svt_av1_tpu_torch/kernels/csrc/{src}",
            replaces=replaces, launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
        print(f"{name}: {r['per_call']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by}); "
              f"{launches[name] / N_FRAMES:g} launches per 1080p frame")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
