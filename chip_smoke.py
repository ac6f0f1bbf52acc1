"""Smoke run of the PyTorch/CUDA port (svt_av1_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel of the port from kernels/csrc/ (one nvcc per
   source, all at once) and the host C extensions, timed as set-up;
3. kernels: each kernel's wrapper on card tensors at the 1080p slices'
   shapes, held against its plain PyTorch version on the same inputs
   (integers exact; intra costs to rtol 1e-5 with >= 99% of the modes
   equal; inter costs to rtol 2e-4 / atol 2 on >= 99%; MV bits to
   1e-4), with CUDA-event times of both; K1 is timed as its one launch
   for the 7 shapes of a frame (and, for comparison, as 7 one-shape
   launches), K6 at the path's shapes (the 16x16 table) and at all 8
   shapes (the 8x8 table), each set held against the plain version, and
   both print their design ceilings (k1_ceiling, k6_ceiling) beside
   their bounds; K2 (one launch for both directions), K3, K4's apply
   (one launch for the three planes) and K5 (one launch) also print their
   profiler device times (device_ms), K2 on the luma and both chroma
   planes, K5 at each reach of the random-access path (K5_PATH_RADII at
   1920x1152, 8 at the MCTF and TPL geometries) with its bound per reach;
   ptxas's registers, spills and shared memory (nvcc's -Xptxas -v
   lines) are printed for K5 and K2 after the build, for K3 and K4
   beside their checks;
4. all-intra encode: the port's Encoder on N_FRAMES synthetic 1920x1080
   frames, preset 8 (LOW_DELAY_P, qp 40, intra_period_length 0), with
   every launch counter set to 0 just before and read just after; K1-K4
   must have launched; the IVF must hold every frame, the recon's PSNR
   must exceed PSNR_FLOOR_DB, and the frame headers read back from the
   stream must show a deblocking level above 0 on the smooth frames (the
   noise-like frames keep "no filter");
5. low-delay P encode: N_FRAMES frames of a moving 1920x1080 clip, one
   key frame then P frames (intra_period_length -1), counters as in 4;
   every kernel K1-K8 must have launched, the frame headers must show
   N_FRAMES - 1 inter frames, the plans must have chosen inter blocks
   with non-zero MVs, and every frame's PSNR must exceed the floor;
6. random access, the configuration of bench.py (1920x1080, preset 8,
   qp 40, RANDOM_ACCESS with hierarchical_levels 4, intra_period_length
   33, TPL on, tf_level 2, compound_level 1): RA_FRAMES frames of the
   moving clip, a key frame and two 16-frame mini-GOPs, counters as in
   4; every kernel K1-K10 must have launched; it prints the fps of the
   last 16 frames after a 17-frame warm-up (bench.py's window) and of
   the whole run, the stage times, K5's calls by reach and plane and
   K2's by plane and level, per frame the type, layer, qindex
   and show_existing flag from the stream, and the share of 16x16 units
   whose plan chose compound; the plans must have chosen compound and
   the stream must hold show_existing frames; every shown frame's PSNR
   must exceed the floor;
7. agreement: small clips (all-intra, low-delay P and random access)
   coded on the card and with the plain versions on the CPU give
   byte-identical streams (every encode prints the md5 of its packets,
   as tools/tree_times.py --fps does for a tree);
8. stripes (B14, ``parallel/``): ``dryrun_stripes`` at the JAX dryrun's
   geometry (4 stripes, 1280x256) and at full width (17 stripes,
   1920x1088), each on a P frame coded by the port's encoder, with every
   count set to 0 just before and read just after; every stripe output
   must equal the whole frame's run of the same kernels (MVs, selection,
   deblocking level, CDEF strength and plane exactly; intra modes and
   costs, inter costs at the JAX gates, measured shares printed); K1-K8
   and the step must have launched; the step's and the whole frame's
   wall ms and the launches per kernel are printed; at 1280x256 the
   plain versions' step on the card must give the same outputs; the
   closed-GOP half (8 frames of 128x64 as one stream and as two GOPs)
   must decode, with the port's Decoder, to identical pictures;
9. decode: the port's Decoder on the card decodes the 192x128x5
   random-access card stream of phase 7 and the first two temporal
   units (the key frame and a P frame) of the 1080p low-delay P stream
   of phase 5, counts as in 4;
   every shown frame must equal the encoder's recon; K2, K3 and K4's
   apply must have launched; md5 and ms per frame (host tile walk,
   card filters) printed;
10. one JSON line listing every kernel (wrapper calls and launches on
    the main paths: the random-access encode, the stripe dryruns and the
    decodes; every CUDA wrapper counts its calls on entry and its
    launches where it launches, once per call)
    and the stripe step (B14), then the
    device line last; K1's and K6's design
    ceilings are printed beside their bounds, not put in that line.  Phase 6 also prints the K1 and K6 launches of the
    random-access encode alone.

K1 and K8 decide a coefficient near a quantizer decision point from its
float64 value (ops/omd.py decide_near_boundary); the kernels phase prints
how many coefficients each kernel and its plain version recomputed on
its 1080p frame, beside the coefficients they code, and phase 6 the
kernels' recomputes over the random-access encode, per frame.  K8's
bound counts the DCT work of the coded band (416 multiply-adds per pixel
over the 10 shapes, against 576 for the whole products) and K4's
search's the distinct constrains and the combinations of its shared form
(about 580 operations per filtered pixel at preset 8, against 116 per
pixel and combination, 1740); each prints the bound of the larger count
beside.  K7's and K9's count their SADs and K7 its filter taps as packed
operations, as K6's does (k7_ops: 12,772 per 16x16 unit of its shared
form; k9_ops: 12,800), and print the bounds of the scalar counts beside
(K7 70,356 and, per candidate, 211,712; K9 102,912); the stripe step's
bound sums its kernels' bounds at the same counts.

The 10-bit phases: the kernels phase holds the 16-bit forms of K1 and
K4's search on a 1080p 10-bit key frame and those of K5-K8 on two frames
of the moving clip at 10 bits (K5 at every reach of the path, K6 at the
path's shapes and at all 8, K7, K8 with 1-3 references and with a
16-bit compound row), each printed beside its 8-bit form with ptxas's
lines of both instantiations; a 10-bit all-intra and a 10-bit low-delay
P encode at 1080p (N_FRAMES frames each, counts as in 4; the low-delay P
one must launch K1-K8 and neither K9 nor K10, and its stream must
declare 10 bits); the agreement phase adds 64x64x2 10-bit all-intra and
192x128x6 10-bit low-delay P clips, whose card streams the Decoder on
the card must turn into their recon.

10-bit random access: the kernels phase holds K9's 16-bit form at the
1080p 10-bit random-access shapes (three frames of the moving clip at
10 bits, one past and one future reference) exactly against its plain
version, with K8's 16-bit form taking its compound row, K10 in both
sample types on one 960x576 plane and on a 17-plane TPL window (one
launch, bit-equal, beside the library call ``torch.var`` of a float32
copy), and K5/K6's 16-bit forms at the TPL geometry (16x16 alone); each
16-bit form printed beside its 8-bit form with ptxas's lines of both
instantiations.  A 10-bit random-access phase codes bench.py's
configuration at 10 bits on RA_FRAMES frames of the moving clip at 10
bits, counts as in 4: every kernel K1-K10 must launch, K5's and K6's
calls are printed by sample type (uint8: MCTF's planes, narrowed as the
reference narrows them; int16: the plans' and TPL's), the sequence
header must declare 10 bits, the plans must choose compound, the stream
must hold show_existing frames and every shown frame's PSNR at peak 1023
must clear the floor; it prints the fps over bench.py's window and the
whole run and the stage times.  The agreement phase adds a 192x128x5
10-bit random-access clip (hierarchical_levels 2), whose card stream
the Decoder on the card decodes to its recon.  The kernels line has
``compound_joint_16bit`` and ``block_var16_16bit`` rows with the calls
and launches of the 10-bit random-access encode.

The kernels phase also holds K9, K8 with the compound row, K10 (one
960x576 plane and a 17-plane window, one launch for the window), and
K5/K6 at the MCTF (1088x1920, 32x32) and TPL (576x960, 16x16)
geometries against their plain versions, and the stripe modes: K5/K6/K7
at row0 64 of a 1280x256 reference (K6 at every ME shape and at the
step's shapes 16x16 and 64x64), K1 with true halo rows, K4's search
and apply with and without the neighbours' rows.

Presets 7, 6 and 5: the kernels phase holds K4's per-fb forms (B16, the
per-64x64 CDEF presets of cdef_bits > 0) at 1080p in both sample types:
the search's totals per 64x64 filter block over the full 8 x 4 grid and
the apply with 8 presets on a random index grid, each exactly equal to
its plain version, with event, device and plain times and the bound.  A
presets phase (after the decodes) runs PRESET_JOBS in worker processes,
since the host walks of these presets take most of their time: preset 7 low-delay P at 1080p (2 frames: the key frame on K1's
plan, the P frame on the per-block host walk, the filter chain on
K2-K4), preset 6 low-delay P at 1080p (2 frames: the host RD walk, DLF
on K2, the per-fb search and apply on K3/K4, the loop-restoration search
and the second entropy pass), preset 6 at 10 bits (one 1080p key
frame), preset 5 low-delay P at 352x288 (3 frames) and preset 6 random
access at 192x128 (5 frames), the last two also coded on the CPU, where
the streams must be identical.  In each worker every count is set to 0
just before its encode and read just after; each job's kernels must
launch, its PSNR clear the floor and its stream decode on the card to
its recon; the preset-6 and preset-5 streams must carry cdef_bits > 0
and loop restoration.  It prints each job's stage times per frame
(``lr_search`` and ``reencode`` among them), fps, PSNR, per frame the
cdef_bits, loop-restoration and global-motion types from the stream, and
the per-fb forms' launches per preset-6 frame; the kernels line has
``cdef_search_fb``, ``cdef_apply_multi``, ``cdef_search_fb_16bit`` and
``cdef_apply_multi_bd10`` rows with the calls and launches of the preset
jobs that run them.

Presets 4 to 2 and the rest of the encoder's surface: the kernels phase
also holds K1, K3 and K4's frame-level search and apply at the widths
super-resolution codes a 1080p frame at (9/8: 1707 in a 1728-wide
buffer; 16/8: 960), luma and chroma, one launch a call, against their
plain versions (superres_kernel_checks).  The worker pool starts right
after the build with the EARLY_JOBS longest preset jobs (a preset-4 key
frame at 1920x544, preset 4 low-delay P at 352x288x3), which run beside
the phases above; after the decodes the main process codes the default
all-intra configuration (RANDOM_ACCESS structure, intra_period_length
-2, tf_level 2: MCTF on every key frame, K1-K6) on N_FRAMES 1080p frames
with get_recon (mctf_phase); then the pool takes the other preset jobs
(preset 4 random access and preset 2 all-intra and low-delay P at
128x96, the small ones also coded on the CPU in tasks of their own) and
the surface jobs (super-resolution 9/8 and 16/8 at 1080p, decoded on the
card; film grain, whose card and CPU decodes must give equal md5s with
the grain applied; two passes through ``python -m svt_av1_tpu_torch.app``
on a 1080p y4m with a scene cut, which must code a key frame there).
The port's Decoder counts each preset stream's filter-intra, var-tx,
wedge, diffwtd and inter-intra blocks (block_tools); the preset-4 key
frame must read TX_MODE_SELECT, cdef_bits > 0 and filter intra, the
preset-4 random-access stream the tools its CPU test finds.  The
kernels line adds the launches of these paths; the script prints its
wall time before that line.

The configuration surface: the same pool runs SETTINGS_JOBS, preset 8
at the full width under each setting the JAX encoder reads: 64x64
superblocks (random access over 9 frames, hierarchical_levels 3, at 8
and 10 bits), CVBR with vbv_bufsize and a qp range, fixed qindex offsets
with a key-frame offset, MCTF's reach (altref_nframes, look_ahead_distance
at tf_level 1), all random access over 9 frames (K1-K10; CVBR runs no
TPL, so no K10); two tile
columns by one tile row (log2), 1918x1078 at 10 bits, warped motion and
OBMC, VBR and every tool toggle off, low-delay P (K1-K8); screen content
(1920x544), adaptive quantization, lossless (qp 0: K1 and no K2-K4) and
the loop filters off (K1 and no K2-K4), all-intra.  Each job is also
coded at the size the CPU tests hold against the JAX package, on the
card and with the plain versions on the CPU, where the streams must be
identical; PRESET_JOBS adds preset 3 and preset -2 at 128x96x2
low-delay P, and preset -2's stream must equal preset 2's.  Every
settings job must launch its kernels (and not the ones it must not), clear
the PSNR floor, carry its setting in the stream at both sizes
(stream_features: the superblock size, the tile counts, base_q_idx per
frame, the screen-content, IntraBC, segmentation, CDF-update and motion
mode flags; block_tools: palette, IntraBC, OBMC and warped blocks; the
MCTF neighbours per filtered picture) and decode on the card to its
recon (the first DECODE_TUS temporal units at the full width; the
lossless stream, the JAX encoder's and read by no decoder, is not
decoded).  The kernels line adds the settings jobs' launches.

``--trace DIR`` adds a phase before the last two lines: encodes under
torch.profiler (TRACE_FRAMES all-intra frames, TRACE_FRAMES P frames
after a warm-up, and the second 16-frame mini-GOP of the random-access
clip after the first), which print the card's busy share of the wall
time and the device time by kernel, and write the Chrome traces into
DIR (gzipped).

Needs the repository beside it (it imports the port, never jax or the
JAX package) and a CUDA device; without either it fails before any
result.
"""
from __future__ import annotations

import collections
import gzip
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
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
# the ME shapes of the inter plans and the stripe step (K6's 16x16 table)
PATH_ME_SHAPES = ((16, 16), (64, 64))
# K5's reaches on the random-access path (bme.coarse_r_for_dist)
K5_PATH_RADII = (8, 12, 16, 24)
PLAIN_REPS = 5
TRACE_FRAMES = 3
# random access: a key frame and two 16-frame mini-GOPs; bench.py times
# the last 16 after a 17-frame warm-up
RA_FRAMES, RA_WARM = 33, 17

# published peaks of one H100 SXM (NVIDIA's data sheet, dense rates):
# HBM bytes/s, and float32 (non-tensor-core) FLOP/s, which count a fused
# multiply-add as two; the same pipes issue at most 4 x 32
# lane-instructions an SM and clock (132 SMs at 1.98 GHz), half the FLOP
# rate, so that an integer or non-FMA operation (a min, max, abs, shift,
# add) is counted once against that rate
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS_S = 67e12
PEAK_LANE_INSTR_S = 132 * 128 * 1.98e9   # lane-instructions/s: 4 x 32 per SM
# what tools/int_pipes.py measures on the H100: each integer opcode it
# probes (VIMNMX.U16x2, IADD3, VABSDIFF4, PRMT, LOP3, SHF, IDP.2A, IMAD)
# issues 63-64 lanes an SM and clock, half of 4 x 32; VIMNMX.U16x2 and
# IADD3 or VABSDIFF4 share that pipe, and VIMNMX.U16x2 beside IDP.2A
# issues about 49 lanes each.  K6's and K9's rows also print their bound
# at this rate
PEAK_INT_PIPE_S = 132 * 64 * 1.98e9


def synth_clip(w, h, n, seed=3, tex_sigma=TEXTURE_SIGMA, bd=8):
    """Natural-ish synthetic content: moving textured fore/background,
    gradients, sharp edges, mild sensor noise.  At ``bd`` > 8 every
    8-bit plane is scaled to ``bd`` bits (uint16) with its low bits drawn
    from the same generator."""
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
        if bd > 8:
            y, u, v = ((p.astype(np.uint16) << (bd - 8))
                       | rng.integers(0, 1 << (bd - 8), p.shape,
                                      dtype=np.uint16) for p in (y, u, v))
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


def device_ms(fn, reps=KERNEL_REPS):
    """Device time per call of ``fn``: the CUDA records (kernels, copies)
    of torch.profiler over ``reps`` calls after one warm-up, in ms; the
    wrapper's host path is not in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / reps / 1e3


def bound_ms(n_bytes, n_ops, flops=0):
    """(ms, what bounds it): the larger of the bytes at the memory rate
    and the operations at the issue rate, ``n_ops`` lane-instructions
    (integer or non-FMA float operations) and ``flops`` float32 FLOPs of
    fused multiply-adds (two each: K1's and K8's DCTs)."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = (n_ops / PEAK_LANE_INSTR_S + flops / PEAK_FP32_FLOPS_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k8_dct_macs(shapes):
    """K8's DCT multiply-adds per pixel that the cost maps need: the first
    product's rows of the coded band (min(h, 32) of D_h), the second's
    band columns (min(w, 32) of D_w) on those rows; 416 over the 10
    INTER_SHAPES (576 for the whole products)."""
    return sum(min(h, 32) + min(h, 32) * min(w, 32) / h for (w, h) in shapes)


def k4_search_ops(pri_set, sec_set):
    """K4's search lane-instructions per filtered pixel, the least its
    function needs (below the kernels' own: the per-fb search's loop
    issues about 700 SASS instructions a pixel at the 8x4 grid).  Each tap
    of a tap set (the unit's direction: 4 primary taps where the grid has
    a nonzero pri, 8 secondary ones where it has a nonzero sec; direction
    0's 8 secondary ones for the zero primary) its |d|, signed weight and
    the bounds' max and min (4); each constrain (4 per nonzero pri, 8 per
    nonzero sec and tap set) its shift, subtract, min-relu and weighted
    add (4); each combination its parts' sum, the rounding (sign, add,
    shift), the add of v - s, the clamp (2) and the squared error's
    multiply-add (8; 7 where one part is zero, 1 at (0, 0)).  623 at the
    8x4 grid, 379 at the 5x3."""
    n_p = sum(1 for p in pri_set if p)
    n_s = sum(1 for s in sec_set if s)
    zero_pri = 0 in pri_set
    taps = 4 * (n_p > 0) + 8 * (n_s > 0) + 8 * (n_s > 0 and zero_pri)
    constrains = 4 * n_p + 8 * n_s * ((n_p > 0) + zero_pri)
    combos = sum(1 if not (p or s) else 8 if p and s else 7
                 for p in pri_set for s in sec_set)
    return 4 * taps + 4 * constrains + combos


def k4_apply_ops(ystr, uvstr, w, h):
    """K4's apply lane-instructions over every pixel of a w x h 4:2:0
    frame at coded strengths ``ystr`` (luma) and ``uvstr`` (chroma), pri
    * 4 + sec each: each tap of a nonzero part (4 primary, 8 secondary)
    its |d|, signed weight, the bounds' max and min, and its constrain's
    shift, subtract, min-relu and weighted add (8); then the rounding
    (sign, add, shift), the add of v and the clamp (6).  102 a pixel where
    both parts are nonzero, none at (0, 0) (a copy)."""
    def px_ops(st):
        taps = 4 * (st >> 2 > 0) + 8 * (st & 3 > 0)
        return 8 * taps + 6 if taps else 0
    return w * h * px_ops(ystr) + 2 * (w // 2) * (h // 2) * px_ops(uvstr)


def near_counts(name, kernel_call, plain_call):
    """Run ``kernel_call`` and ``plain_call`` on the card and return their
    results and (the kernel's near-boundary recomputes, the plain
    version's, the coefficients the plain version codes)."""
    from svt_av1_tpu_torch.ops import omd

    torch.cuda.synchronize()
    omd.near_recomputes(name)                       # reset
    before = dict(omd.NEAR_STATS)
    got, want = kernel_call(), plain_call()
    torch.cuda.synchronize()
    return got, want, (omd.near_recomputes(name),
                       omd.NEAR_STATS["near"] - before["near"],
                       omd.NEAR_STATS["coded"] - before["coded"])


def print_near(what, counts):
    n_k, n_p, coded = counts
    print(f"{what}: near-boundary float64 recomputes, kernel {n_k}, plain "
          f"version {n_p}, of {coded} coded coefficients "
          f"({100.0 * n_k / max(coded, 1):.4f}% / "
          f"{100.0 * n_p / max(coded, 1):.4f}%)")


# the design ceilings of the kernels redesigned for Hopper: the least
# time their own work takes at the card's published peaks, beside the
# bound of the function
PEAK_TF32_S = 495e12            # dense TF32 tensor-core FLOP/s


def k1_ceiling(px, shapes):
    """K1 (ms, what): its DCT products on the tensor cores, two TF32
    passes for the first (h multiply-adds per pixel) and three for the
    second (w), a dummy 14th mode where a side is 8, against its
    per-(pixel, mode) work on the float32/integer pipes (prediction,
    residual, the TF32 split, the dead-zone path of the quantizer model
    and the sums: about 20 operations); the larger of the two."""
    tc = sum((14 if 8 in s else 13) * px * 2 * (2 * s[1] + 3 * s[0])
             for s in shapes) / PEAK_TF32_S
    alu = sum(13 * px * 20 for _ in shapes) / PEAK_LANE_INSTR_S
    return (tc * 1e3, "tensor cores") if tc >= alu else (alu * 1e3,
                                                         "float32 pipes")


def k6_ops(n_sb, per_op=4):
    """K6's operations for ``n_sb`` SBs: per SB, window and offset the
    4096 absolute differences and their sum, as packed operations of
    ``per_op`` pixel pairs and their sum each (4 bytes at 8 bits, 2
    16-bit halves at 10: the card's widest form of the work; 3 scalar
    operations per pixel pair give a bound that the kernel beats)."""
    return n_sb * 2 * 1089 * 64 * 64 // per_op


def k5_ops(n_sb, r, n_px, packed=True, per_op=4):
    """K5's operations: the decimation's adds over the ``n_px`` samples of
    both planes and, per SB and offset of the (2r+1)^2, the 64 absolute
    differences of the decimated tile and their sum.  ``packed``, as
    k6_ops counts: ``per_op`` samples per dp4a (4) or dp2a (2, 16-bit
    samples) and pixel pairs per packed absolute difference; else 1 per
    sample and 3 per pixel pair."""
    n_off = n_sb * (2 * r + 1) ** 2
    return n_px // per_op + n_off * 64 // per_op if packed \
        else n_px + n_off * 64 * 3


def k6_ceiling(n_sb, per_8x8=16):
    """K6 (ms, what): the SAD instructions it issues on one integer pipe
    (per SB, window and offset 64 8x8 blocks of ``per_8x8``: 16 VABSDIFF4
    with accumulate in the 8-bit form; in the 16-bit form 32 words of one
    VIMNMX.U16x2 each, whose IDP.2A issue on the other pipe) at the 64
    lanes per SM and clock that tools/int_pipes.py measures."""
    return (n_sb * 2 * 1089 * 64 * per_8x8 / PEAK_INT_PIPE_S * 1e3,
            "SAD instructions on one integer pipe")


def k7_ops(n_units, packed=True, bd=8):
    """K7's operations in its shared form: per unit 3 horizontal phases
    (q4 4, 8, 12) over 49 patch columns and the 22 rows the vertical taps
    and the x-only rows read, 6 nonzero 8-bit taps each; 49 vertical
    outputs (q4 8 at 17 window offsets, 12 and 4 at 16) over each of 65
    columns (the three phases and the copy), 6 taps of 16-bit
    intermediates each; and 25 SADs of 256 pixels.  ``packed``, as
    k6_ops counts: 4 byte multiply-adds per dp4a, 2 16-bit ones per
    dp2a, 4 pixel pairs per packed absolute difference with accumulate
    (12,772 per unit); at ``bd`` 10 the horizontal taps of 16-bit samples
    take dp2a (2 per operation) and the SADs 2 pairs per operation
    (15,989); else 2 operations per multiply-add and 3 per pixel pair
    (70,356)."""
    h_macs, v_macs, pairs = 49 * 22 * 6, 65 * 49 * 6, 25 * 256
    per = 4 if bd == 8 else 2
    if packed:
        return n_units * (h_macs // per + v_macs // 2 + pairs // per)
    return n_units * (2 * h_macs + 2 * v_macs + 3 * pairs)


def k7_ops_per_candidate(n_units):
    """K7's operations counted per candidate, as the kernel first ran
    them: 16 candidates filtered both ways (16x23 + 16x16 pixels x 8
    taps), 4 one way, 25 SADs; 211,712 per unit."""
    return n_units * (16 * (16 * 23 + 16 * 16) * 8 * 2 + 8 * 256 * 8 * 2
                      + 25 * 256 * 3)


def k9_ops(n_units, packed=True, per_op=4):
    """K9's operations: per unit 2 arms x 49 offsets of 256 pixels and
    the plain average's 256, each averaged and compared with the source,
    and the 2 x 256 pixel pairs of the per-reference SADs.  ``packed``:
    ``per_op`` pixels per packed average and per packed absolute
    difference with accumulate (4 bytes at 8 bits: 12,800 per unit; 2
    16-bit halves at 10: 25,600); else add, shift, |diff|, accumulate per
    averaged pixel and 3 operations per pixel pair (102,912)."""
    averaged, pairs = 2 * 49 * 256 + 256, 2 * 256
    if packed:
        return n_units * (2 * averaged // per_op + pairs // per_op)
    return n_units * (4 * averaged + 3 * pairs)


def zero_counts(counters):
    """Set every wrapper's launch and call counts to 0."""
    for fn in counters.values():
        fn.launches = fn.calls = 0


def read_counts(counters):
    """({name: launches}, {name: wrapper calls})."""
    return ({name: fn.launches for name, fn in counters.items()},
            {name: fn.calls for name, fn in counters.items()})


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def psnr(a, b, peak=255.0):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(peak ** 2
                                                             / mse))


# --------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the slice's shapes
# --------------------------------------------------------------------------

def slice_config(w, h, intra_period=0, bd=8):
    """Preset 8, qp 40, LOW_DELAY_P: all-intra with intra_period 0, one
    key frame then P frames with -1; ``bd`` bits."""
    from svt_av1_tpu_torch.config import EncoderConfig, PredStructure

    return EncoderConfig(source_width=w, source_height=h, qp=QP,
                         enc_mode=8, intra_period_length=intra_period,
                         pred_structure=PredStructure.LOW_DELAY_P,
                         encoder_bit_depth=bd)


def ra_config(w, h, **kw):
    """bench.py's configuration: preset 8, qp 40, intra_period_length 33,
    and the defaults RANDOM_ACCESS, hierarchical_levels 4, TPL on,
    tf_level 2 and compound_level 1 at preset 8."""
    from svt_av1_tpu_torch.config import EncoderConfig

    return EncoderConfig(source_width=w, source_height=h, qp=QP, enc_mode=8,
                         intra_period_length=RA_FRAMES, **kw)


def deblock_inputs(dev, frame, rng, buf_w, buf_h, bd=8):
    """K2's inputs at the 1080p buffer: a noisy int32 recon of the luma
    plane and of both chroma planes of a ``bd``-bit frame, each with
    random edge masks (a 4x4 transform grid of 4..32-sample blocks;
    chroma masks filter at most 6 taps).  Returns (luma, masks, [chroma
    1, chroma 2], chroma masks)."""
    from svt_av1_tpu_torch.ops import dlf

    top, scale = (1 << bd) - 1, 1 << (bd - 8)
    src_y = torch.from_numpy(np.ascontiguousarray(
        np.pad(frame[0], ((0, buf_h - HEIGHT), (0, 0)), mode="edge")))
    rec_y = (src_y.to(torch.int32)
             + torch.from_numpy(rng.integers(-6, 7, (buf_h, buf_w))
                                .astype(np.int32) * scale)).clamp(0, top)
    y4, x4 = buf_h // 4, buf_w // 4
    tx = rng.choice([4, 8, 16, 32], size=(y4, x4)).astype(np.int32)
    skip = rng.random((y4, x4)) < 0.3
    bex = rng.random((y4, x4)) < 0.5
    bey = rng.random((y4, x4)) < 0.5
    prm = [torch.from_numpy(np.ascontiguousarray(a, np.uint8)).to(dev)
           for a in dlf.edge_params(tx, tx, skip, bex, bey, WIDTH, HEIGHT,
                                    False)]
    cw, ch = WIDTH // 2, HEIGHT // 2
    c4y, c4x = buf_h // 8, buf_w // 8
    ctx = rng.choice([4, 8, 16, 32], size=(c4y, c4x)).astype(np.int32)
    cprm = [torch.from_numpy(np.ascontiguousarray(a, np.uint8)).to(dev)
            for a in dlf.edge_params(ctx, ctx, rng.random((c4y, c4x)) < 0.3,
                                     rng.random((c4y, c4x)) < 0.5,
                                     rng.random((c4y, c4x)) < 0.5, cw, ch,
                                     True)]
    chroma = [(torch.from_numpy(np.ascontiguousarray(
        np.pad(p, ((0, buf_h // 2 - ch), (0, 0)), mode="edge"))
        .astype(np.int32)) + torch.from_numpy(
            rng.integers(-6, 7, (buf_h // 2, buf_w // 2))
            .astype(np.int32) * scale)).clamp(0, top).to(dev)
        for p in frame[1:]]
    return rec_y.to(dev), prm, chroma, cprm


def k1_agreement(packed, want, shapes, buf_w, buf_h, what):
    """Hold K1's packed output against the plain version's per-shape maps
    ``want``: modes equal and costs within rtol 1e-5 on >= 99% of each
    shape's blocks, printed per shape.  Returns the largest cost
    difference."""
    from svt_av1_tpu_torch.ops import omd

    got = omd.unpack_decisions(packed, shapes, buf_w, buf_h)
    err = 0.0
    for (w, h), (m2, c2) in zip(shapes, want):
        m, c = got[(w, h)]
        same = (m == m2).float().mean().item()
        close = torch.isclose(c, c2, rtol=1e-5).float().mean().item()
        err = max(err, (c - c2).abs().max().item())
        print(f"{what} intra_decision {w}x{h}: modes equal {same:.6f}, "
              f"costs within rtol 1e-5 {close:.6f}")
        assert same >= 0.99 and close >= 0.99, (w, h, same, close)
    return err


def per_fb_kernels(dev, src, rec, dirs, var, ns, bd, rng):
    """K4's per-fb forms (B16) on the 1080p planes: the search over the
    full 8 x 4 grid (its totals per 64x64 filter block) and the apply with
    8 presets (cdef_bits 3) on a random index grid, each exactly equal to
    its plain version, with event, device and plain times and the bound.
    Returns {"search": ..., "apply": ...}."""
    from svt_av1_tpu_torch.ops import cdef

    damping = 5
    k4f = lambda: cdef.cdef_search_fb(  # noqa: E731
        src, rec, dirs, var, ns, WIDTH, HEIGHT, damping, bd)
    k4f_plain = lambda: cdef.cdef_search_errs_fb_plain(  # noqa: E731
        src, rec, dirs, var, ns, WIDTH, HEIGHT, damping, bd)
    got, want = k4f(), k4f_plain()
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    print(f"K4 cdef_search_fb {src[0].dtype} (8x4 grid, "
          f"{tuple(got[0].shape[1:])} filter blocks): max |kernel - plain| "
          f"{err}")
    assert err == 0
    vis_px = WIDTH * HEIGHT + 2 * (WIDTH // 2) * (HEIGHT // 2)
    frac = ns.float().mean().item()
    ops = k4_search_ops(cdef.PRI_SET, cdef.SEC_SET)
    search = dict(
        ms=cuda_ms(k4f, KERNEL_REPS), plain_ms=cuda_ms(k4f_plain, PLAIN_REPS),
        device_ms=device_ms(k4f), max_abs_err=err,
        bound=bound_ms(vis_px * (4 + src[0].element_size())
                       + nbytes(dirs, var, ns, *got), vis_px * frac * ops),
        per_call=f"1 launch, three planes, 32 combinations ({ops} "
                 f"operations per filtered pixel)")
    nvfb, nhfb = got[0].shape[1:]
    ys = tuple(int(v) for v in rng.integers(1, 64, 8))
    us = tuple(int(v) for v in rng.integers(1, 64, 8))
    # the index grid on the host, as the codec hands it over
    idx = rng.integers(0, 8, (nvfb, nhfb)).astype(np.int32)
    k4m = lambda: cdef.cdef_apply_multi(  # noqa: E731
        rec, ns, dirs, var, ys, us, idx, damping, WIDTH, HEIGHT, bd)
    k4m_plain = lambda: cdef.cdef_frame_multi_plain(  # noqa: E731
        rec, ns, dirs, var, ys, us, idx, damping, WIDTH, HEIGHT, bd)
    got, want = k4m(), k4m_plain()
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    print(f"K4 cdef_apply_multi bd {bd} (8 presets y {ys}, uv {us}): max "
          f"|kernel - plain| {err}")
    assert err == 0
    apply = dict(
        ms=cuda_ms(k4m, KERNEL_REPS), plain_ms=cuda_ms(k4m_plain, PLAIN_REPS),
        device_ms=device_ms(k4m), max_abs_err=err,
        bound=bound_ms(2 * nbytes(*rec) + nbytes(dirs, var, ns) + idx.size,
                       frac * np.mean([k4_apply_ops(ys[k], us[k], WIDTH,
                                                    HEIGHT)
                                       for k in idx.reshape(-1)])),
        per_call="1 launch, three planes, 8 presets")
    return {"search": search, "apply": apply}


def superres_planes(frame, denom, sb=64):
    """``frame`` (a 1080p synth_clip frame) as super-resolution codes it
    at ``denom``: each plane downscaled to the coded width
    (ops/superres.py) and edge-padded to the codec's buffer (whole
    ``sb`` superblocks).  Returns (planes, coded width, 8-aligned width
    and height, buffer width and height)."""
    from svt_av1_tpu_torch.ops.superres import downscale_plane, scaled_dim

    fw = scaled_dim(frame[0].shape[1], denom)
    h = frame[0].shape[0]
    aw, ah = -(-fw // 8) * 8, -(-h // 8) * 8
    bw, bh = -(-aw // sb) * sb, -(-ah // sb) * sb
    planes = []
    for i, p in enumerate(frame):
        s = 1 if i else 0
        small = downscale_plane(np.asarray(p), (fw + s) >> s)
        tw, th = bw >> s, bh >> s
        out = np.empty((th, tw), np.uint8)
        out[:small.shape[0], :small.shape[1]] = small
        out[:small.shape[0], small.shape[1]:] = small[:, -1:]
        out[small.shape[0]:] = out[small.shape[0] - 1]
        planes.append(out)
    return planes, fw, aw, ah, bw, bh


def superres_kernel_checks(dev, frame, denom, qindex=120):
    """K1, K3 and K4's frame-level search and apply at the width that
    super-resolution codes ``frame`` at (``denom`` 9: 1707 of 1920, a
    1728-wide buffer; 16: 960), each call one launch, against its plain
    version on the same card tensors: K1's modes equal and costs within
    rtol 1e-5 on every block of every shape, K3 and K4 exactly.  Returns
    {kernel: (max |kernel - plain|, launches of its call)}."""
    from svt_av1_tpu_torch.ops import cdef, omd

    planes, fw, aw, ah, bw, bh = superres_planes(frame, denom)
    rng = np.random.default_rng(denom)
    mb = tuple(np.linspace(1.0, 6.0, 13).tolist())
    out = {}
    y = torch.from_numpy(planes[0]).to(dev)
    before = omd.intra_decision_packed.launches
    packed = omd.intra_decision_packed(y, qindex, 250.0, mb)
    n = omd.intra_decision_packed.launches - before
    got = omd.unpack_decisions(packed, omd.ALL_SHAPES, bw, bh)
    err = 0.0
    for s in omd.ALL_SHAPES:
        m, c = got[s]
        m2, c2 = omd.intra_decision_plain(y, *s, qindex, 250.0, mb)
        assert torch.equal(m, m2), (denom, s)
        assert bool(torch.isclose(c, c2, rtol=1e-5).all()), (denom, s)
        err = max(err, (c - c2).abs().max().item())
    out["intra_decision"] = (err, n)
    # the recon the filters see: the source with coding noise
    rec = [(torch.from_numpy(p.astype(np.int32))
            + torch.from_numpy(rng.integers(-6, 7, p.shape).astype(np.int32))
            ).clamp(0, 255).to(dev) for p in planes]
    src = [torch.from_numpy(p).to(dev) for p in planes]
    before = cdef.cdef_direction.launches
    d1, v1 = cdef.cdef_direction(rec[0], aw, ah, 0)
    n = cdef.cdef_direction.launches - before
    d2, v2 = cdef.find_dir_grid(cdef._units_of(
        cdef.pad_very_large(rec[0], aw, ah, 8), aw, ah, 8), 0)
    out["cdef_direction"] = (max((d1 - d2).abs().max().item(),
                                 (v1 - v2).abs().max().item()), n)
    ns = torch.from_numpy(rng.random(d1.shape) < 0.8).to(dev)
    err = 0
    for ps, ss in ((cdef.PRI_SET_FAST, cdef.SEC_SET_FAST),
                   (cdef.PRI_SET, cdef.SEC_SET)):
        before = cdef.cdef_search.launches
        got = cdef.cdef_search(src, rec, d1, v1, ns, aw, ah, 5, 8, ps, ss)
        n = cdef.cdef_search.launches - before
        want = cdef.cdef_search_errs(src, rec, d1, v1, ns, aw, ah, 5, 8, ps,
                                     ss)
        err = max([err] + [(g - w).abs().max().item()
                           for g, w in zip(got, want)])
    out["cdef_search"] = (err, n)
    err = 0
    for ys, us in ((33, 18), (63, 0), (9, 61)):
        before = cdef.cdef_apply.launches
        got = cdef.cdef_apply(rec, ns, d1, v1, ys, us, 5, aw, ah, 8)
        n = cdef.cdef_apply.launches - before
        want = cdef.cdef_apply_plain(rec, ns, d1, v1, ys, us, 5, aw, ah, 8)
        err = max([err] + [(g - w).abs().max().item()
                           for g, w in zip(got, want)])
    out["cdef_apply"] = (err, n)
    print(f"superres {denom}/8 ({fw}x{frame[0].shape[0]}, buffer {bw}x{bh}; "
          f"luma and chroma): max |kernel - plain| and launches per call: "
          f"{json.dumps(out)}")
    for name, (err, n) in out.items():
        assert n == 1 and (name == "intra_decision" or err == 0), \
            (denom, name, err, n)
    return out


def kernels_phase(dev, frame):
    from svt_av1_tpu_torch.entropy.tables import FrameCdfs
    from svt_av1_tpu_torch.kernels import build
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
        return omd.intra_decision_packed(plane, qindex, lam, mb)

    def k1_by_shape():
        return [omd.intra_decision(plane, w, h, qindex, lam, mb)
                for (w, h) in shapes]

    def k1_plain():
        return [omd.intra_decision_plain(plane, w, h, qindex, lam, mb)
                for (w, h) in shapes]

    packed, want, counts = near_counts("intra_decision", k1, k1_plain)
    print_near("K1 intra_decision on the 1080p key frame", counts)
    err = k1_agreement(packed, want, shapes, buf_w, buf_h, "K1")
    px = buf_w * buf_h
    flops = sum(13 * 2 * px * (w + h) for (w, h) in shapes)
    results["intra_decision"] = dict(
        ms=cuda_ms(k1, KERNEL_REPS), plain_ms=cuda_ms(k1_plain, PLAIN_REPS),
        device_ms=device_ms(k1), max_abs_err=err,
        bound=bound_ms(nbytes(plane, packed), 0, flops),
        ceiling=k1_ceiling(px, shapes),
        per_call=f"1 launch, 7 shapes ({flops / 1e9:.2f} GFLOP)")
    print(f"K1 intra_decision as 7 one-shape launches (the same kernel): "
          f"{cuda_ms(k1_by_shape, KERNEL_REPS):.4f} ms")

    # -- K2 deblocking: the luma plane at the path's level and both chroma
    # planes (chroma masks: filters of at most 6 taps), both directions
    # in one launch per plane
    ry, prm, chroma_rec, cprm = deblock_inputs(dev, frame, rng, buf_w,
                                               buf_h)
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
    cw, ch = WIDTH // 2, HEIGHT // 2
    for pli, rc in zip((1, 2), chroma_rec):
        k2c = lambda: dlf.deblock(rc, *cprm, cw, ch, lvl, lvl, 0)  # noqa
        a_c = k2c()
        b_c = dlf.loop_filter_plane_full(rc, *cprm, cw, ch, lvl, lvl, 0)
        torch.cuda.synchronize()
        err_c = (a_c - b_c).abs().max().item()
        print(f"K2 deblock chroma plane {pli} ({rc.shape[1]}x{rc.shape[0]}) "
              f"level {lvl}: max |kernel - plain| {err_c}, "
              f"{(a_c != rc).sum().item()} samples changed, kernel "
              f"{cuda_ms(k2c, KERNEL_REPS):.4f} ms, device "
              f"{device_ms(k2c):.5f} ms, bound "
              f"{bound_ms(nbytes(rc, a_c, *cprm), 0)[0]:.5f} ms (bytes)")
        assert err_c == 0 and bool((a_c != rc).any())
        err = max(err, err_c)
    results["deblock"] = dict(
        ms=cuda_ms(k2, KERNEL_REPS), plain_ms=cuda_ms(k2_plain, PLAIN_REPS),
        device_ms=device_ms(k2), max_abs_err=err,
        bound=bound_ms(nbytes(ry, a, *prm), 0),
        per_call="1 launch, both directions, on the luma plane")

    # -- K3 CDEF directions of the luma plane
    k3 = lambda: cdef.cdef_direction(ry, WIDTH, HEIGHT, 0)  # noqa: E731
    k3_plain = lambda: cdef.find_dir_grid(cdef._units_of(  # noqa: E731
        cdef.pad_very_large(ry, WIDTH, HEIGHT, 8), WIDTH, HEIGHT, 8), 0)
    (d1, v1), (d2, v2) = k3(), k3_plain()
    torch.cuda.synchronize()
    err = max((d1 - d2).abs().max().item(), (v1 - v2).abs().max().item())
    print(f"K3 cdef_direction: max |kernel - plain| {err}")
    assert err == 0
    for line in build.ptxas_report("cdef_direction"):
        print(f"ptxas cdef_direction: {line}")
    n_units = d1.numel()
    # per unit: 8 direction sums of 64 samples, 15 squares and
    # multiply-adds each, argmax and the variance
    results["cdef_direction"] = dict(
        ms=cuda_ms(k3, KERNEL_REPS), plain_ms=cuda_ms(k3_plain, PLAIN_REPS),
        device_ms=device_ms(k3), max_abs_err=err,
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
    # each combination filtered apart: the apply's 102 a pixel at
    # strength 5 (pri 1, sec 1), the subtract of s and the squared error's
    # multiply-add
    ops_px = k4_apply_ops(5, 0, 1, 1) + 2
    vis_bytes = vis_px * (4 + 1)            # int32 recon + uint8 source
    in_bytes = vis_bytes + nbytes(d1, v1, ns)
    old = bound_ms(in_bytes, vis_px * frac * combos * ops_px)
    results["cdef_search"] = dict(
        ms=cuda_ms(k4s, KERNEL_REPS), plain_ms=cuda_ms(k4s_plain, PLAIN_REPS),
        device_ms=device_ms(k4s), max_abs_err=err,
        bound=bound_ms(in_bytes,
                       vis_px * frac * k4_search_ops(pri_set, sec_set)),
        per_call=f"1 launch, three planes ({k4_search_ops(pri_set, sec_set)}"
                 f" operations per filtered pixel; the per-combination "
                 f"count, {combos * ops_px}, bounds it at {old[0]:.5f} ms)")
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
    for line in build.ptxas_report("cdef_filter"):
        print(f"ptxas cdef_filter: {line}")
    results["cdef_apply"] = dict(
        ms=cuda_ms(k4a, KERNEL_REPS), plain_ms=cuda_ms(k4a_plain, PLAIN_REPS),
        device_ms=device_ms(k4a), max_abs_err=err,
        bound=bound_ms(2 * nbytes(*rec) + nbytes(d1, v1, ns),
                       frac * k4_apply_ops(ystr, uvstr, WIDTH, HEIGHT)),
        per_call="1 launch, three planes")
    fb = per_fb_kernels(dev, src, rec, d1, v1, ns, 8, rng)
    results["cdef_search_fb"], results["cdef_apply_multi"] = \
        fb["search"], fb["apply"]
    return results


def tenbit_kernels_phase(dev, frame, results):
    """The 16-bit forms of K1 and of K4's search at the 1080p 10-bit
    shapes (``frame``: a 10-bit frame of synth_clip), each against its
    plain version on the same card tensors (K1 at the 8-bit gates, K4's
    search exactly), with CUDA-event, device and plain times and the
    bound (2-byte samples), printed beside the 8-bit forms' of
    ``results``; ptxas's lines of both instantiations; K2, K3 and K4's
    apply at bd 10 on the same frame, exactly equal to their plain
    versions.  Returns the 16-bit forms' results."""
    from svt_av1_tpu_torch.entropy.tables import FrameCdfs
    from svt_av1_tpu_torch.kernels import build
    from svt_av1_tpu_torch.ops import cdef, dlf, omd
    from svt_av1_tpu_torch.pipeline.batched_md import default_mode_bits
    from svt_av1_tpu_torch.pipeline.rate_control import RateControl
    from svt_av1_tpu_torch.pipeline.rdo import rd_lambda

    bd, cs = 10, 2
    rng = np.random.default_rng(10)
    buf_w, buf_h = -(-WIDTH // 128) * 128, -(-HEIGHT // 128) * 128
    out = {}

    # -- K1: the 7 shape grids of the buf-aligned int16 luma plane
    cfg = slice_config(WIDTH, HEIGHT, bd=bd)
    qindex = RateControl(cfg, float(cfg.frame_rate),
                         all_intra=True).peek_qindex(True, 0, 0)
    lam = rd_lambda(qindex, bd)
    mb = default_mode_bits(FrameCdfs(qindex))
    plane = omd.upload_plane(frame[0], buf_w, buf_h, bd, dev)
    assert plane.dtype == torch.int16
    shapes = omd.ALL_SHAPES

    def k1():
        return omd.intra_decision_packed(plane, qindex, lam, mb, bd)

    def k1_plain():
        return [omd.intra_decision_plain(plane, w, h, qindex, lam, mb, bd)
                for (w, h) in shapes]

    packed, want, counts = near_counts("intra_decision", k1, k1_plain)
    print_near("K1 intra_decision, 16-bit form, on the 1080p 10-bit key "
               "frame", counts)
    err = k1_agreement(packed, want, shapes, buf_w, buf_h, "K1 16-bit")
    px = buf_w * buf_h
    flops = sum(13 * 2 * px * (w + h) for (w, h) in shapes)
    out["intra_decision_16bit"] = dict(
        ms=cuda_ms(k1, KERNEL_REPS), plain_ms=cuda_ms(k1_plain, PLAIN_REPS),
        device_ms=device_ms(k1), max_abs_err=err,
        bound=bound_ms(nbytes(plane, packed), 0, flops),
        ceiling=k1_ceiling(px, shapes),
        per_call=f"1 launch, 7 shapes of a 10-bit plane ({flops / 1e9:.2f} "
                 f"GFLOP, 2-byte samples)")

    # -- K2 and K3 at bd 10 on a noisy recon of the frame
    ry, prm, chroma_rec, cprm = deblock_inputs(dev, frame, rng, buf_w,
                                               buf_h, bd)
    lvl = dlf.filter_levels_from_qindex(qindex)
    for name, p, m, vw, vh in (("luma", ry, prm, WIDTH, HEIGHT),
                               ("chroma", chroma_rec[0], cprm, WIDTH // 2,
                                HEIGHT // 2)):
        a = dlf.deblock(p, *m, vw, vh, lvl, lvl, 0, bd)
        b = dlf.loop_filter_plane_full(p, *m, vw, vh, lvl, lvl, 0, bd)
        torch.cuda.synchronize()
        e = (a - b).abs().max().item()
        print(f"K2 deblock bd 10 {name} level {lvl}: max |kernel - plain| "
              f"{e}, {(a != p).sum().item()} samples changed")
        assert e == 0 and bool((a != p).any())
    d1, v1 = cdef.cdef_direction(ry, WIDTH, HEIGHT, cs)
    d2, v2 = cdef.direction_plain(ry, WIDTH, HEIGHT, cs)
    torch.cuda.synchronize()
    e = max((d1 - d2).abs().max().item(), (v1 - v2).abs().max().item())
    print(f"K3 cdef_direction cs 2 on the 10-bit luma: max |kernel - plain| "
          f"{e}")
    assert e == 0

    # -- K4's search (16-bit sources) and apply (bd 10) on three planes
    ns = torch.from_numpy(rng.random(d1.shape) < 0.8).to(dev)
    rec = [ry] + chroma_rec
    src = [(r + torch.randint(-16, 17, r.shape, device=dev))
           .clamp(0, (1 << bd) - 1).to(torch.int16) for r in rec]
    pri_set, sec_set = cdef.PRI_SET_FAST, cdef.SEC_SET_FAST
    damping = 5
    k4s = lambda: cdef.cdef_search(  # noqa: E731
        src, rec, d1, v1, ns, WIDTH, HEIGHT, damping, bd, pri_set, sec_set)
    k4s_plain = lambda: cdef.search_plain(  # noqa: E731
        src, rec, d1, v1, ns, WIDTH, HEIGHT, damping, bd, pri_set, sec_set)
    got, want = k4s(), k4s_plain()
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    print(f"K4 cdef_search 16-bit ({len(pri_set)}x{len(sec_set)} grid): "
          f"max |kernel - plain| {err}")
    assert err == 0
    vis_px = WIDTH * HEIGHT + 2 * (WIDTH // 2) * (HEIGHT // 2)
    frac = ns.float().mean().item()
    in_bytes = vis_px * (4 + 2) + nbytes(d1, v1, ns)
    out["cdef_search_16bit"] = dict(
        ms=cuda_ms(k4s, KERNEL_REPS), plain_ms=cuda_ms(k4s_plain, PLAIN_REPS),
        device_ms=device_ms(k4s), max_abs_err=err,
        bound=bound_ms(in_bytes,
                       vis_px * frac * k4_search_ops(pri_set, sec_set)),
        per_call="1 launch, three planes of 10-bit sources (2-byte "
                 "samples)")
    ystr, uvstr = 8 * 4 + 1, 4 * 4 + 2
    a = cdef.cdef_apply(rec, ns, d1, v1, ystr, uvstr, damping, WIDTH, HEIGHT,
                        bd)
    b = cdef.cdef_apply_plain(rec, ns, d1, v1, ystr, uvstr, damping, WIDTH,
                              HEIGHT, bd)
    torch.cuda.synchronize()
    e = max((g - w).abs().max().item() for g, w in zip(a, b))
    print(f"K4 cdef_apply bd 10 (y {ystr}, uv {uvstr}): max |kernel - "
          f"plain| {e}")
    assert e == 0
    fb = per_fb_kernels(dev, src, rec, d1, v1, ns, bd, rng)
    out["cdef_search_fb_16bit"], out["cdef_apply_multi_bd10"] = \
        fb["search"], fb["apply"]

    for name in ("intra_decision", "cdef_filter"):
        for line in build.ptxas_report(name):
            print(f"ptxas {name}: {line}")
    for k8, k16 in (("intra_decision", "intra_decision_16bit"),
                    ("cdef_search", "cdef_search_16bit"),
                    ("cdef_search_fb", "cdef_search_fb_16bit"),
                    ("cdef_apply_multi", "cdef_apply_multi_bd10")):
        r8, r16 = results[k8], out[k16]
        print(f"{k16} vs the 8-bit form: events {r16['ms']:.4f} ms "
              f"({r8['ms']:.4f}), device {r16['device_ms']:.5f} ms "
              f"({r8['device_ms']:.5f}), bound {r16['bound'][0]:.5f} ms, "
              f"{r16['bound'][1]} ({r8['bound'][0]:.5f}), plain "
              f"{r16['plain_ms']:.4f} ms ({r8['plain_ms']:.4f})")
    return out


def inter_kernels_phase(dev, ref_frame, src_frame, bd=8):
    """K5-K8 on the luma planes of two consecutive frames of the moving
    clip at the 1080p buffer shape, against their plain versions.  At
    ``bd`` 10 (frames of the 10-bit clip, int16 planes) the 16-bit forms,
    whose results take the suffix "_16bit"; K8 there also with two
    references and with a 16-bit compound row (the plain compound
    search's: K9 is 8-bit only).  K8's one-reference call is also kept as
    "inter_select_1ref" (8 bits), which the 16-bit row is printed
    beside."""
    from svt_av1_tpu_torch.ops import bme, omd
    from svt_av1_tpu_torch.pipeline import batched_inter as bi
    from svt_av1_tpu_torch.pipeline.rate_control import RateControl
    from svt_av1_tpu_torch.pipeline.rdo import rd_lambda

    buf_w, buf_h = -(-WIDTH // 128) * 128, -(-HEIGHT // 128) * 128
    H, W = buf_h, buf_w
    n_sb = (H // 64) * (W // 64)
    src = omd.upload_plane(src_frame[0], W, H, bd, dev)
    ref = omd.upload_plane(ref_frame[0], W, H, bd, dev)
    sfx, form = ("", "") if bd == 8 else ("_16bit", " 16-bit")
    # samples (and pixel pairs) per packed integer operation
    per_op = 4 if bd == 8 else 2
    results = {}

    # -- K5 coarse search at each reach of the random-access path
    # (bme.coarse_r_for_dist), one launch per call.  The kernels line
    # keeps r 8, the reach of distances 1-2
    k5 = {}
    for r in K5_PATH_RADII:
        call = lambda: bme.me_coarse(src, ref, r)  # noqa: E731
        got, want = call(), bme.coarse_sb_search(src, ref, r)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        assert err == 0, (r, err)
        n_px = 2 * H * W
        row = dict(ms=cuda_ms(call, KERNEL_REPS), device_ms=device_ms(call),
                   max_abs_err=err,
                   bound=bound_ms(nbytes(src, ref, got),
                                  k5_ops(n_sb, r, n_px, per_op=per_op)),
                   scalar=bound_ms(nbytes(src, ref, got),
                                   k5_ops(n_sb, r, n_px, packed=False)))
        print(f"K5 me_coarse{form} r {r} ({(2 * r + 1) ** 2} offsets): max "
              f"|kernel - plain| {err}; kernel {row['ms']:.4f} ms, device "
              f"{row['device_ms']:.5f} ms, bound {row['bound'][0]:.5f} ms "
              f"({row['bound'][1]}; the scalar count's "
              f"{row['scalar'][0]:.5f} ms, {row['scalar'][1]})")
        k5[r] = row
    r = bme.coarse_r_for_dist(0)
    k5_plain = lambda: bme.coarse_sb_search(src, ref, r)  # noqa: E731
    coarse = bme.me_coarse(src, ref, r)
    results["me_coarse" + sfx] = dict(
        k5[r], plain_ms=cuda_ms(k5_plain, PLAIN_REPS),
        max_abs_err=max(v["max_abs_err"] for v in k5.values()),
        per_call="1 launch, r 8", by_r=k5)

    # -- K6 refinement: every ME shape once, the path's two shapes timed
    got = bme.me_refine(src, ref, coarse, bme.ME_SHAPES)
    want = bme.refine_plain(src, ref, coarse, bme.ME_SHAPES)
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() for s in bme.ME_SHAPES
              for g, w in zip(got[s], want[s]))
    err = max(err, (got["win16"] - want["win16"]).abs().max().item())
    print(f"K6 me_refine{form}, all {len(bme.ME_SHAPES)} ME shapes: max "
          f"|kernel - plain| {err}")
    assert err == 0
    k6_all = lambda: bme.me_refine(src, ref, coarse, bme.ME_SHAPES)  # noqa
    all_ms, all_dev = cuda_ms(k6_all, KERNEL_REPS), device_ms(k6_all)
    print(f"K6 me_refine{form}, all {len(bme.ME_SHAPES)} ME shapes (the 8x8 "
          f"table): {all_ms:.4f} ms, device {all_dev:.5f} ms")
    # the path's shapes (the 16x16 table, both windows at once): held
    # against the plain version on their own, since they run another
    # instantiation of the kernel than the 8x8 table above
    path = PATH_ME_SHAPES
    k6 = lambda: bme.me_refine(src, ref, coarse, path)  # noqa: E731
    k6_plain = lambda: bme.refine_plain(src, ref, coarse, path)  # noqa
    me, want = k6(), k6_plain()
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() for s in path
              for g, w in zip(me[s], want[s]))
    err = max(err, (me["win16"] - want["win16"]).abs().max().item())
    print(f"K6 me_refine{form}, the path's shapes 16x16 and 64x64 (the "
          f"16x16 table): max |kernel - plain| {err}")
    assert err == 0
    out_b = sum(nbytes(*me[s]) for s in path)
    results["me_refine" + sfx] = dict(
        ms=cuda_ms(k6, KERNEL_REPS), plain_ms=cuda_ms(k6_plain, PLAIN_REPS),
        device_ms=device_ms(k6), all_shapes=(all_ms, all_dev),
        max_abs_err=err,
        bound=bound_ms(nbytes(src, ref, coarse) + out_b,
                       k6_ops(n_sb, per_op)),
        int_bound_ms=k6_ops(n_sb, per_op) / PEAK_INT_PIPE_S * 1e3,
        ceiling=k6_ceiling(n_sb, 16 if bd == 8 else 32),
        per_call="1 launch, shapes 16x16 and 64x64")

    # -- K7 quarter-pel refinement of the 16x16 MVs
    ny, nx = H // 64, W // 64
    mv_r16 = bi._nested_to_grid(me[(16, 16)][0], ny, nx, 4, 4)
    mv_c16 = bi._nested_to_grid(me[(16, 16)][1], ny, nx, 4, 4)
    k7 = lambda: bme.subpel_refine16(src, ref, mv_r16, mv_c16, bd)  # noqa
    k7_plain = lambda: bme.subpel_plain(src, ref, mv_r16, mv_c16, bd)  # noqa
    sub, want = k7(), k7_plain()
    torch.cuda.synchronize()
    assert sub[2].dtype == want[2].dtype == src.dtype
    err = max((g.to(torch.int32) - w.to(torch.int32)).abs().max().item()
              for g, w in zip(sub, want))
    frac = ((sub[0] % 8 != 0) | (sub[1] % 8 != 0)).float().mean().item()
    print(f"K7 subpel_refine16{form}: max |kernel - plain| {err}, "
          f"fractional MVs {frac:.4f} of the units, prediction "
          f"{sub[2].dtype} up to {sub[2].max().item()}")
    assert err == 0
    k7_bytes = nbytes(src, ref, mv_r16, mv_c16, *sub)
    units = (H // 16) * (W // 16)
    scalar = bound_ms(k7_bytes, k7_ops(units, packed=False))
    old = bound_ms(k7_bytes, k7_ops_per_candidate(units))
    results["subpel_refine16" + sfx] = dict(
        ms=cuda_ms(k7, KERNEL_REPS), plain_ms=cuda_ms(k7_plain, PLAIN_REPS),
        device_ms=device_ms(k7), max_abs_err=err,
        bound=bound_ms(k7_bytes, k7_ops(units, bd=bd)),
        per_call=f"1 launch (the shared form's packed count; its scalar "
                 f"count bounds it at {scalar[0]:.5f} ms, the count per "
                 f"candidate at {old[0]:.5f} ms)")

    # -- K8 selection + cost maps: one reference (the main path's) timed,
    # three checked
    cfg = slice_config(WIDTH, HEIGHT, -1, bd)
    rc = RateControl(cfg, float(cfg.frame_rate))
    rc.hierarchical_levels = 1              # as the encoder sets it
    qindex = rc.pick_qindex(False, 0, 1, (0, 0), 1)
    lam = rd_lambda(qindex, bd)

    def sb(a):
        return a.reshape(1, ny, nx).contiguous()

    one = (src, sub[2][None].contiguous(), sub[0][None].contiguous(),
           sub[1][None].contiguous(), sb(me[(64, 64)][0]),
           sb(me[(64, 64)][1]), qindex, lam, bd)
    refs3 = [ref, torch.roll(ref, (2, -2), (0, 1)).contiguous(),
             torch.roll(ref, (-3, 1), (0, 1)).contiguous()]
    parts = []
    for rk in refs3:
        m = bme.frame_me(src, rk, r, path)
        a, b, pr = bme.subpel_refine16(
            src, rk, bi._nested_to_grid(m[(16, 16)][0], ny, nx, 4, 4),
            bi._nested_to_grid(m[(16, 16)][1], ny, nx, 4, 4), bd)
        parts.append((pr, a, b, m[(64, 64)][0].reshape(ny, nx),
                      m[(64, 64)][1].reshape(ny, nx)))

    def first(k):
        return (src,) + tuple(torch.stack([p[i] for p in parts[:k]])
                              .contiguous() for i in range(5)) + (
            qindex, lam, bd)

    cases = [("1 reference", one, None), ("3 references", first(3), None)]
    if bd != 8:
        # two references, then the second as a backward one with the plain
        # compound search's 16-bit row
        two = first(2)
        comp = bi.compound_joint_plain(
            src, torch.stack(refs3[:2]).contiguous(), *two[1:6],
            (False, True), (-1, 1), qindex, bd)
        assert comp["pred"].dtype == src.dtype
        cases[1:1] = [("2 references", two, None),
                      ("2 references and the compound row", two, comp)]
    err = 0.0
    for name, args, comp in cases:
        (f1, m1, c1), (f2, m2, c2), counts = near_counts(
            "inter_select", lambda: bi.inter_select(*args, comp=comp),
            lambda: bi.inter_select_plain(*args, comp=comp))
        print_near(f"K8 inter_select{form} on the 1080p P frame, {name}",
                   counts)
        bad = (f1["sel"] != f2["sel"]).sum().item()
        for key in bi.SEL_KEYS:
            assert torch.equal(f1[key], f2[key]), (name, key)
        mv_err = (m1 - m2).abs().max().item()
        assert mv_err <= 1e-4, mv_err
        worst = 1.0
        for s in omd.INTER_SHAPES:
            close = torch.isclose(c1[s], c2[s], rtol=2e-4, atol=2.0)
            worst = min(worst, close.float().mean().item())
            err = max(err, (c1[s] - c2[s]).abs().max().item())
        hist = torch.bincount(f1["sel"].flatten(), minlength=4).tolist()
        print(f"K8 inter_select{form}, {name}: selection disagreements {bad}, "
              f"units per reference {hist}, max |mvbits| diff {mv_err}, "
              f"costs within rtol 2e-4 / atol 2: worst shape {worst:.6f}")
        assert worst >= 0.99, (name, worst)
    k8 = lambda: bi.inter_select(*one)  # noqa: E731
    k8_plain = lambda: bi.inter_select_plain(*one)  # noqa: E731
    dct_flops = 2 * k8_dct_macs(omd.INTER_SHAPES) * H * W
    # per coefficient and shape: the quantizer / rate model, about 12
    # float operations; per pixel and reference: the SAD
    ops = 12 * len(omd.INTER_SHAPES) * H * W + 3 * H * W
    out_b = (H // 16) * (W // 16) * 16 + sum(
        (H // h) * (W // w) * 4 for (w, h) in omd.INTER_SHAPES)
    old = bound_ms(nbytes(*one[:6]) + out_b, ops, dct_flops + 2 * (
        576 - k8_dct_macs(omd.INTER_SHAPES)) * H * W)
    results["inter_select" + sfx] = dict(
        ms=cuda_ms(k8, KERNEL_REPS), plain_ms=cuda_ms(k8_plain, PLAIN_REPS),
        device_ms=device_ms(k8), max_abs_err=err,
        bound=bound_ms(nbytes(*one[:6]) + out_b, ops, dct_flops),
        per_call=f"1 launch, 1 reference ({dct_flops / 1e9:.2f} GFLOP of "
                 f"DCT; the whole products' count bounds it at "
                 f"{old[0]:.5f} ms)")
    if bd == 8:
        results["inter_select_1ref"] = results["inter_select"]
    return results


def tenbit_inter_report(results):
    """ptxas's lines for both instantiations of K5-K8, and each 16-bit
    form's times and bound beside its 8-bit form's (K5 at every reach of
    the path, K8's one-reference call)."""
    from svt_av1_tpu_torch.kernels import build

    for name in ("me_coarse", "me_refine", "subpel_refine", "inter_select"):
        for line in build.ptxas_report(name):
            print(f"ptxas {name}: {line}")
    for r, r16 in results["me_coarse_16bit"]["by_r"].items():
        r8 = results["me_coarse"]["by_r"][r]
        print(f"me_coarse_16bit r {r} vs the 8-bit form: events "
              f"{r16['ms']:.4f} ms ({r8['ms']:.4f}), device "
              f"{r16['device_ms']:.5f} ms ({r8['device_ms']:.5f}), bound "
              f"{r16['bound'][0]:.5f} ms, {r16['bound'][1]} "
              f"({r8['bound'][0]:.5f})")
    r16, r8 = results["me_refine_16bit"], results["me_refine"]
    print(f"me_refine_16bit bound at the measured integer rate "
          f"(PEAK_INT_PIPE_S): {r16['int_bound_ms']:.5f} ms "
          f"({r8['int_bound_ms']:.5f}); design ceiling "
          f"{r16['ceiling'][0]:.5f} ms ({r8['ceiling'][0]:.5f})")
    a16, a8 = (results[k]["all_shapes"] for k in ("me_refine_16bit",
                                                   "me_refine"))
    print(f"me_refine_16bit, all 8 ME shapes vs the 8-bit form: events "
          f"{a16[0]:.4f} ms ({a8[0]:.4f}), device {a16[1]:.5f} ms "
          f"({a8[1]:.5f})")
    for k8, k16 in (("me_coarse", "me_coarse_16bit"),
                    ("me_refine", "me_refine_16bit"),
                    ("subpel_refine16", "subpel_refine16_16bit"),
                    ("inter_select_1ref", "inter_select_16bit")):
        r8, r16 = results[k8], results[k16]
        print(f"{k16} vs the 8-bit form: events {r16['ms']:.4f} ms "
              f"({r8['ms']:.4f}), device {r16['device_ms']:.5f} ms "
              f"({r8['device_ms']:.5f}), bound {r16['bound'][0]:.5f} ms, "
              f"{r16['bound'][1]} ({r8['bound'][0]:.5f}), plain "
              f"{r16['plain_ms']:.4f} ms ({r8['plain_ms']:.4f})")


def _half_res(y, W, H, bd=8):
    """The TPL statistics' plane: the buf-aligned luma, 2x2-averaged (the
    rounding of tpl_gop_flow's bufal), uint8 at ``bd`` 8 and int16 at 10
    (the device sample types)."""
    a = np.pad(y, ((0, H - y.shape[0]), (0, W - y.shape[1])), mode="edge")
    a = a.astype(np.int32).reshape(H // 2, 2, W // 2, 2).sum((1, 3))
    return ((a + 2) >> 2).astype(np.uint8 if bd == 8 else np.int16)


def k10_check(dev, lumas, W, H, bd):
    """K10 at ``bd`` (uint8 or int16 planes) on one half-resolution TPL
    plane and on the window of all ``lumas`` (one launch), each bit-equal
    to its plain version, with CUDA-event, device and plain times, its
    bound (the input read once, the output written once) and the library
    call's time: ``torch.var`` of a float32 copy of the blocks, times 256
    (a conversion and one reduction, summed in another order; checked to
    rtol 1e-5).  Returns the window's results, the plane's under
    "one_plane"."""
    from svt_av1_tpu_torch.pipeline import tpl

    win = torch.stack([torch.from_numpy(_half_res(y, W, H, bd))
                       for y in lumas]).to(dev)
    n, hh, ww = win.shape
    rows = {}
    for what, x in (("one plane", win[0]), (f"{n}-plane window", win)):
        k10 = lambda: tpl.block_var16(x)  # noqa: E731
        k10_plain = lambda: tpl.block_var16_plain(x)  # noqa: E731
        lib = lambda: torch.var(  # noqa: E731
            x.view(-1, hh // 16, 16, ww // 16, 16).float(), dim=(2, 4),
            correction=0) * 256
        a, b, c = k10(), k10_plain(), lib()
        torch.cuda.synchronize()
        err = (a - b).abs().max().item()
        lib_rel = ((c.view(a.shape) - a).abs() / a.clamp_min(1.0)).max() \
            .item()
        assert torch.equal(a, b), (bd, what, err)
        assert lib_rel <= 1e-5, lib_rel
        rows[what] = dict(
            ms=cuda_ms(k10, KERNEL_REPS),
            plain_ms=cuda_ms(k10_plain, PLAIN_REPS), device_ms=device_ms(k10),
            library_ms=cuda_ms(lib, KERNEL_REPS),
            library_device_ms=device_ms(lib), max_abs_err=err,
            bound=bound_ms(nbytes(x, a), 5 * x.numel()),
            per_call=f"1 launch, {what} of {ww}x{hh} {x.dtype}")
        r = rows[what]
        print(f"K10 block_var16 {bd}-bit, {what} ({ww}x{hh}, {x.dtype}): "
              f"bit-equal to the plain version; kernel {r['ms']:.4f} ms, "
              f"device {r['device_ms']:.5f} ms, bound {r['bound'][0]:.5f} "
              f"ms ({r['bound'][1]}), plain {r['plain_ms']:.4f} ms; library "
              f"(torch.var of a float32 copy) {r['library_ms']:.4f} ms, "
              f"device {r['library_device_ms']:.5f} ms, max relative "
              f"difference {lib_rel:.3g}")
    out = rows[f"{n}-plane window"]
    out["one_plane"] = rows["one plane"]
    return out


def ra_kernels_phase(dev, clip, window, bd=8, results8=None):
    """K9, K8 with the compound row and K10 at the random-access path's
    shapes, and K5/K6 at the MCTF (8 bits only) and TPL geometries, each
    against its plain version on the same card tensors.  ``clip``: three
    consecutive frames of the moving clip; the middle one is predicted
    from the outer two (one past, one future reference).  ``window``: the
    lumas of a TPL window (17 frames), K10's input at half resolution.
    At ``bd`` 10 (frames of the 10-bit clip, int16 planes) the 16-bit
    forms, whose results take the suffix "_16bit": K9's bound counts
    2-byte samples and 2 pixel pairs per packed operation, K8's 16-bit
    form takes K9's 16-bit compound row, and each is printed beside the
    8-bit form of ``results8`` with ptxas's lines of both instantiations
    of K9 and K10."""
    from svt_av1_tpu_torch.kernels import build
    from svt_av1_tpu_torch.ops import bme, omd
    from svt_av1_tpu_torch.pipeline import batched_inter as bi
    from svt_av1_tpu_torch.pipeline.rate_control import RateControl
    from svt_av1_tpu_torch.pipeline.rdo import rd_lambda

    W, H = -(-WIDTH // 128) * 128, -(-HEIGHT // 128) * 128
    nr16, nc16 = H // 16, W // 16
    ny, nx = H // 64, W // 64
    sfx, form = ("", "") if bd == 8 else ("_16bit", " 16-bit")
    per_op = 4 if bd == 8 else 2
    src = omd.upload_plane(clip[1][0], W, H, bd, dev)
    refs = [omd.upload_plane(clip[k][0], W, H, bd, dev) for k in (0, 2)]
    bwd, rel = (False, True), (-1, 1)
    parts = []
    for k, ref in enumerate(refs):
        m = bme.frame_me(src, ref, bme.coarse_r_for_dist(rel[k]),
                         ((16, 16), (64, 64)))
        a, b, pr = bme.subpel_refine16(
            src, ref, bi._nested_to_grid(m[(16, 16)][0], ny, nx, 4, 4),
            bi._nested_to_grid(m[(16, 16)][1], ny, nx, 4, 4), bd)
        parts.append((pr, a, b, m[(64, 64)][0].reshape(ny, nx),
                      m[(64, 64)][1].reshape(ny, nx)))
    preds, mvq_r, mvq_c, sb_r, sb_c = (
        torch.stack([p[i] for p in parts]).contiguous() for i in range(5))
    ref_stack = torch.stack(refs).contiguous()
    cfg = ra_config(WIDTH, HEIGHT, encoder_bit_depth=bd)
    rc = RateControl(cfg, float(cfg.frame_rate))
    rc.hierarchical_levels = cfg.hierarchical_levels
    qindex = rc.pick_qindex(False, 1, 8, (0, 16), -1)
    lam = rd_lambda(qindex, bd)
    results = {}

    # -- K9 the compound candidate
    k9_args = (src, ref_stack, preds, mvq_r, mvq_c, sb_r, sb_c, bwd, rel,
               qindex, bd)
    k9 = lambda: bi.compound_joint(*k9_args)  # noqa: E731
    k9_plain = lambda: bi.compound_joint_plain(*k9_args)  # noqa: E731
    comp, want = k9(), k9_plain()
    torch.cuda.synchronize()
    assert comp["pred"].dtype == want["pred"].dtype == src.dtype
    err = max((comp[k].to(torch.int32) - want[k].to(torch.int32)).abs()
              .max().item() for k in bi.COMP_KEYS)
    refined = ((comp["mv1_r"] != mvq_r[1]) | (comp["mv1_c"] != mvq_c[1])
               | (comp["mv_r"] != mvq_r[0]) | (comp["mv_c"] != mvq_c[0]))
    print(f"K9 compound_joint{form}: max |kernel - plain| {err} over "
          f"{len(bi.COMP_KEYS)} outputs, units with a jointly refined arm "
          f"{refined.float().mean().item():.4f}, prediction "
          f"{comp['pred'].dtype} up to {comp['pred'].max().item()}")
    assert err == 0
    units = nr16 * nc16
    k9_bytes = nbytes(src, ref_stack, preds, mvq_r, mvq_c, sb_r, sb_c,
                      *comp.values())
    ops = k9_ops(units, per_op=per_op)
    old = bound_ms(k9_bytes, k9_ops(units, packed=False))
    results["compound_joint" + sfx] = dict(
        ms=cuda_ms(k9, KERNEL_REPS), plain_ms=cuda_ms(k9_plain, PLAIN_REPS),
        device_ms=device_ms(k9), max_abs_err=err,
        bound=bound_ms(k9_bytes, ops),
        int_bound_ms=ops / PEAK_INT_PIPE_S * 1e3,
        per_call=f"1 launch, 2 references, {units} units, {src.dtype} "
                 f"({ops / 1e9:.3f} G packed integer operations; the "
                 f"scalar count bounds it at {old[0]:.5f} ms)")

    # -- K8 with the compound row: the random-access path's call
    args = (src, preds, mvq_r, mvq_c, sb_r, sb_c, qindex, lam, bd)
    (f1, m1, c1), (f2, m2, c2), counts = near_counts(
        "inter_select", lambda: bi.inter_select(*args, comp=comp),
        lambda: bi.inter_select_plain(*args, comp=comp))
    print_near(f"K8 inter_select{form} with K9's compound row on the 1080p "
               f"{bd}-bit random-access frame", counts)
    for key in bi.SEL_KEYS:
        assert torch.equal(f1[key], f2[key]), ("compound row", key)
    mv_err = (m1 - m2).abs().max().item()
    assert mv_err <= 1e-4, mv_err
    worst, err = 1.0, 0.0
    for s in omd.INTER_SHAPES:
        close = torch.isclose(c1[s], c2[s], rtol=2e-4, atol=2.0)
        worst = min(worst, close.float().mean().item())
        err = max(err, (c1[s] - c2[s]).abs().max().item())
    hist = torch.bincount(f1["sel"].flatten(), minlength=3).tolist()
    print(f"K8 inter_select{form} with the compound row: selection fields "
          f"equal, units per candidate (past, future, compound) {hist}, "
          f"max |mvbits| diff {mv_err}, costs within rtol 2e-4 / atol 2: "
          f"worst shape {worst:.6f}")
    assert worst >= 0.99 and hist[2] > 0, (worst, hist)
    if bd == 8:
        k8 = lambda: bi.inter_select(*args, comp=comp)  # noqa: E731
        k8_plain = lambda: bi.inter_select_plain(*args, comp=comp)  # noqa
        dct_flops = 2 * k8_dct_macs(omd.INTER_SHAPES) * H * W
        ops = 12 * len(omd.INTER_SHAPES) * H * W + 3 * 3 * H * W
        out_b = units * 32 + sum((H // h) * (W // w) * 4
                                 for (w, h) in omd.INTER_SHAPES)
        in_b = nbytes(src, preds, mvq_r, mvq_c, sb_r, sb_c, *comp.values())
        old = bound_ms(in_b + out_b, ops, dct_flops + 2 * (
            576 - k8_dct_macs(omd.INTER_SHAPES)) * H * W)
        results["inter_select"] = dict(
            ms=cuda_ms(k8, KERNEL_REPS),
            plain_ms=cuda_ms(k8_plain, PLAIN_REPS), max_abs_err=err,
            bound=bound_ms(in_b + out_b, ops, dct_flops),
            per_call=f"1 launch, 2 references + the compound row "
                     f"({dct_flops / 1e9:.2f} GFLOP of DCT; the whole "
                     f"products' count bounds it at {old[0]:.5f} ms)")

    # -- K10 at the TPL geometry: one plane and a window of planes
    results["block_var16" + sfx] = k10_check(dev, window, W, H, bd)

    # -- K5/K6 at the MCTF geometry (32x32 alone; its planes stay uint8 at
    # every bit depth) and the TPL geometry (16x16 alone)
    half = [torch.from_numpy(_half_res(clip[k][0], W, H, bd)).to(dev)
            for k in (0, 1)]
    geometries = [("TPL", (half[1], half[0]), (16, 16))]
    if bd == 8:
        Hm = -(-HEIGHT // 64) * 64
        mctf = [torch.from_numpy(np.ascontiguousarray(np.pad(
            clip[k][0], ((0, Hm - HEIGHT), (0, 0)), mode="edge"))).to(dev)
            for k in (1, 0)]
        geometries.insert(0, ("MCTF", mctf, (32, 32)))
    r = bme.COARSE_R
    for what, (c, n), shape in geometries:
        got = bme.frame_me(c, n, shapes=(shape,))
        coarse = bme.coarse_sb_search(c, n)
        want = bme.refine_plain(c, n, coarse, (shape,))
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item()
                  for g, w in zip(got[shape], want[shape]))
        err = max(err, (bme.me_coarse(c, n) - coarse).abs().max().item())
        assert err == 0
        hh, ww = c.shape
        n_sb = (hh // 64) * (ww // 64)
        times = [cuda_ms(f, reps) for f, reps in (
            (lambda: bme.me_coarse(c, n), KERNEL_REPS),
            (lambda: bme.coarse_sb_search(c, n), PLAIN_REPS),
            (lambda: bme.me_refine(c, n, coarse, (shape,)), KERNEL_REPS),
            (lambda: bme.refine_plain(c, n, coarse, (shape,)), PLAIN_REPS))]
        k5_dev = device_ms(lambda: bme.me_coarse(c, n))
        k6_dev = device_ms(lambda: bme.me_refine(c, n, coarse, (shape,)))
        results[f"me_refine_{what}" + sfx] = dict(ms=times[2],
                                                  device_ms=k6_dev)
        # the bounds count as the K5 and K6 rows do
        b5 = bound_ms(nbytes(c, n, coarse),
                      k5_ops(n_sb, r, 2 * hh * ww, per_op=per_op))
        b6 = bound_ms(nbytes(c, n, coarse, *got[shape]),
                      k6_ops(n_sb, per_op))
        c6 = k6_ceiling(n_sb, 16 if bd == 8 else 32)
        print(f"K5/K6{form} at the {what} geometry {ww}x{hh} ({c.dtype}), "
              f"shape {shape[0]}x{shape[1]} alone: max |kernel - plain| "
              f"{err}; K5 {times[0]:.4f} ms (device {k5_dev:.5f} ms, plain "
              f"{times[1]:.4f} ms, bound {b5[0]:.5f} ms, {b5[1]}), K6 "
              f"{times[2]:.4f} ms (device {k6_dev:.5f} ms, plain "
              f"{times[3]:.4f} ms, bound {b6[0]:.5f} ms, {b6[1]}; design "
              f"ceiling {c6[0]:.5f} ms, {c6[1]})")

    if bd != 8:
        for name in ("compound_joint", "block_var16"):
            for line in build.ptxas_report(name):
                print(f"ptxas {name}: {line}")
        r8, r16 = results8["me_refine_TPL"], results["me_refine_TPL_16bit"]
        print(f"me_refine_16bit at the TPL geometry vs the 8-bit form: "
              f"events {r16['ms']:.4f} ms ({r8['ms']:.4f}), device "
              f"{r16['device_ms']:.5f} ms ({r8['device_ms']:.5f})")
        r8, r16 = results8["compound_joint"], results["compound_joint_16bit"]
        print(f"compound_joint_16bit bound at the measured integer rate "
              f"(PEAK_INT_PIPE_S): {r16['int_bound_ms']:.5f} ms "
              f"({r8['int_bound_ms']:.5f})")
        for k8, k16 in (("compound_joint", "compound_joint_16bit"),
                        ("block_var16", "block_var16_16bit")):
            r8, r16 = results8[k8], results[k16]
            print(f"{k16} vs the 8-bit form: events {r16['ms']:.4f} ms "
                  f"({r8['ms']:.4f}), device {r16['device_ms']:.5f} ms "
                  f"({r8['device_ms']:.5f}), bound {r16['bound'][0]:.5f} "
                  f"ms, {r16['bound'][1]} ({r8['bound'][0]:.5f}), plain "
                  f"{r16['plain_ms']:.4f} ms ({r8['plain_ms']:.4f})")
    return results


# --------------------------------------------------------------------------
# phases 4 and 5: the main paths
# --------------------------------------------------------------------------

def stream_frame_params(path):
    """Per coded frame of the IVF at ``path``: (frame type, deblocking
    level, CDEF luma strength, CDEF chroma strength), read back from the
    frame headers."""
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
                if isinstance(fh, int):         # show_existing_frame
                    continue
                out.append((int(fh.frame_type), max(fh.filter_level),
                            fh.cdef_y_strengths[0], fh.cdef_uv_strengths[0]))
    return out


def stream_md5(path):
    """md5 of the packets of the IVF at ``path``, in order (the stream's
    bytes without the IVF framing; tools/tree_times.py hashes the
    encoder's packets the same way)."""
    import hashlib

    from svt_av1_tpu_torch.io import IvfReader

    h = hashlib.md5()
    for pkt, _ in IvfReader(str(path)):
        h.update(pkt)
    return h.hexdigest()


def run_encode(counters, frames, cfg, path, on_packet=None):
    """Encode ``frames`` on the card into the IVF at ``path`` with every
    launch counter set to 0 just before; returns (launches, wall seconds,
    encoder, recon PSNR per frame).  ``on_packet(enc)`` runs after each
    packet the encoder hands out."""
    from svt_av1_tpu_torch.api import Encoder
    from svt_av1_tpu_torch.io import IvfReader, IvfWriter

    enc = Encoder(cfg)                      # the default device: CUDA
    assert enc.device.type == "cuda"
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with IvfWriter(str(path), cfg.source_width, cfg.source_height,
                   cfg.frame_rate) as w:
        pts = 0
        for planes in list(frames) + [None]:
            pkts = enc.flush() if planes is None else enc.send_picture(planes)
            for pkt in pkts:
                w.write_frame(pkt, pts=pts)
                pts += 1
                if on_packet is not None:
                    on_packet(enc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, _ = read_counts(counters)

    n_pkts = sum(1 for _ in IvfReader(str(path)))
    assert n_pkts == len(frames), (n_pkts, len(frames))
    recon = [enc.recon_by_display[d] for d in sorted(enc.recon_by_display)]
    assert len(recon) == len(frames)
    scores = []
    for src, rec in zip(frames, recon):
        for p in range(3):
            assert rec[p].shape == src[p].shape, (rec[p].shape, src[p].shape)
            assert np.isfinite(rec[p]).all()
        scores.append(psnr(src[0], rec[0], (1 << cfg.encoder_bit_depth) - 1))
    print(f"recon luma PSNR per frame (dB): "
          f"{[round(s, 3) for s in scores]}")
    assert min(scores) > PSNR_FLOOR_DB, (min(scores), PSNR_FLOOR_DB)
    rep = enc.perf_report()
    per_frame = {k: v.get("ms_per_frame") for k, v in rep.items()
                 if k != "_wall"}
    print(f"encode: {len(frames)} frames {WIDTH}x{HEIGHT} in {wall:.3f} s, "
          f"{len(frames) / wall:.4f} fps, {path.stat().st_size} bytes, "
          f"packets md5 {stream_md5(path)}")
    print("stage ms/frame (host wall clock):", json.dumps(per_frame))
    return launches, wall, enc, scores


def allintra_phase(counters, frames, out_dir):
    path = Path(out_dir) / "smoke_1080p.ivf"
    launches, _, _, _ = run_encode(counters, frames,
                                   slice_config(WIDTH, HEIGHT), path)
    print("all-intra main path launches:", json.dumps(launches))
    missing = [n for n in ALLINTRA_KERNELS if launches[n] == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
    params = stream_frame_params(path)
    print("per frame (frame type, deblocking level, CDEF y, CDEF uv) from "
          "the stream:", json.dumps(params))
    assert len(params) == len(frames)
    assert all(t == 0 for t, _, _, _ in params)
    assert any(lv > 0 for _, lv, _, _ in params), \
        "the level search chose no deblocking on any frame"
    return launches


def stream_bit_depth(path):
    """The bit depth the sequence header of the IVF at ``path`` declares
    (high_bitdepth set: 10, or 12 with twelve_bit)."""
    from svt_av1_tpu_torch.bitstream.headers import (iter_obus,
                                                     parse_sequence_header)
    from svt_av1_tpu_torch.constants import ObuType
    from svt_av1_tpu_torch.io import IvfReader

    for pkt, _ in IvfReader(str(path)):
        for obu_type, payload in iter_obus(pkt):
            if obu_type == ObuType.OBU_SEQUENCE_HEADER:
                return parse_sequence_header(payload).bit_depth
    raise AssertionError(f"no sequence header in {path}")


def tenbit_phase(counters, frames, out_dir):
    """10-bit all-intra at 1080p: the port's Encoder on ``frames`` (10-bit
    synth_clip), counts set to 0 just before and read just after; K1-K4
    must have launched, the sequence header must declare 10 bits and
    every frame's PSNR (peak 1023) clear the floor.  Returns (IVF path,
    recon per display, launches, wrapper calls)."""
    path = Path(out_dir) / "smoke_1080p_10bit.ivf"
    launches, _, enc, _ = run_encode(counters, frames,
                                     slice_config(WIDTH, HEIGHT, bd=10), path)
    _, calls = read_counts(counters)
    print("10-bit all-intra main path launches:", json.dumps(launches))
    print("10-bit all-intra main path wrapper calls:", json.dumps(calls))
    missing = [n for n in ALLINTRA_KERNELS if launches[n] == 0]
    assert not missing, f"kernels not launched on the 10-bit path: {missing}"
    bd = stream_bit_depth(path)
    print(f"10-bit all-intra: the sequence header declares {bd} bits "
          f"(high_bitdepth {int(bd > 8)})")
    assert bd == 10
    params = stream_frame_params(path)
    print("10-bit per frame (frame type, deblocking level, CDEF y, CDEF uv) "
          "from the stream:", json.dumps(params))
    assert len(params) == len(frames) and all(t == 0 for t, *_ in params)
    recon = [enc.recon_by_display[d] for d in sorted(enc.recon_by_display)]
    assert all(p.dtype == np.uint16 for r in recon for p in r)
    return path, recon, launches, calls


def ipp_phase(counters, frames, out_dir, bd=8):
    """Low-delay P at 1080p: the port's Encoder on ``frames``, counts set
    to 0 just before and read just after; K1-K8 must have launched, the
    stream must hold one key frame then P frames, and every P frame's plan
    must have chosen inter blocks with non-zero MVs.  At ``bd`` 10 K9 and
    K10 must not have launched and the sequence header must declare 10
    bits.  Returns (launches, wrapper calls, (IVF path, recon per
    display))."""
    what = "low-delay P" if bd == 8 else f"{bd}-bit low-delay P"
    path = Path(out_dir) / ("smoke_1080p_ipp.ivf" if bd == 8
                            else f"smoke_1080p_ipp_{bd}bit.ivf")
    plans = []

    def on_packet(enc):
        dec = enc._decider_obj
        if dec._inter is None:               # the key frame
            return
        inter = {s: float(m.mean()) for s, m in dec._inter.items()}
        sel = dec._sf["sel"]
        nz = float(((dec._sf["mv_r"] != 0) | (dec._sf["mv_c"] != 0)).mean())
        plans.append((inter, nz, len(dec._names), int(sel.max())))

    launches, _, enc, _ = run_encode(counters, frames,
                                     slice_config(WIDTH, HEIGHT, -1, bd),
                                     path, on_packet)
    _, calls = read_counts(counters)
    print(f"{what} main path launches:", json.dumps(launches))
    if bd != 8:
        print(f"{what} main path wrapper calls:", json.dumps(calls))
    missing = [n for n in IPP_KERNELS if launches[n] == 0]
    assert not missing, f"kernels not launched on the {what} path: {missing}"
    if bd != 8:
        assert launches["compound_joint"] == launches["block_var16"] == 0
        got_bd = stream_bit_depth(path)
        print(f"{what}: the sequence header declares {got_bd} bits")
        assert got_bd == bd
    params = stream_frame_params(path)
    print("per frame (frame type, deblocking level, CDEF y, CDEF uv) from "
          "the stream:", json.dumps(params))
    types = [t for t, _, _, _ in params]
    assert types == [0] + [1] * (len(frames) - 1), types
    assert len(plans) == len(frames) - 1
    for i, (inter, nz, n_refs, top) in enumerate(plans, 1):
        print(f"P frame {i}: inter share of the 16x16 / 64x64 blocks "
              f"{inter[(16, 16)]:.4f} / {inter[(64, 64)]:.4f}, units with "
              f"a non-zero MV {nz:.4f}, plan references {n_refs}")
        assert max(inter.values()) > 0 and nz > 0, (i, inter, nz)
    recon = [enc.recon_by_display[d] for d in sorted(enc.recon_by_display)]
    if bd != 8:
        assert all(p.dtype == np.uint16 for r in recon for p in r)
    return launches, calls, (path, recon)


def stream_headers(path):
    """Per temporal unit of the IVF at ``path``: dict(show_existing,
    display, type, qindex), read back from the frame headers (the
    reference slots' order hints tracked as a decoder tracks them)."""
    from svt_av1_tpu_torch.bitstream.bits import BitReader
    from svt_av1_tpu_torch.bitstream.headers import (iter_obus,
                                                     parse_frame_header,
                                                     parse_sequence_header)
    from svt_av1_tpu_torch.constants import ObuType
    from svt_av1_tpu_torch.io import IvfReader

    seq, hints, out = None, [0] * 8, []
    for pkt, _ in IvfReader(str(path)):
        for obu_type, payload in iter_obus(pkt):
            if obu_type == ObuType.OBU_SEQUENCE_HEADER:
                seq = parse_sequence_header(payload)
            elif obu_type in (ObuType.OBU_FRAME, ObuType.OBU_FRAME_HEADER):
                fh = parse_frame_header(BitReader(payload), seq, tuple(hints))
                if isinstance(fh, int):
                    out.append(dict(show_existing=True, display=hints[fh]))
                    continue
                out.append(dict(show_existing=False, display=fh.order_hint,
                                type=int(fh.frame_type),
                                qindex=fh.base_q_idx, shown=fh.show_frame))
                for i in range(8):
                    if (fh.refresh_frame_flags >> i) & 1:
                        hints[i] = fh.order_hint
    return out


class _Tally:
    """A kernel wrapper's stand-in in its module that counts its calls by
    ``key(*args)`` (under a lock: the plan prefetch calls from its own
    thread) and forwards its ``calls`` and ``launches``, which the wrapper
    updates through its module's name, to the wrapper ``fn``."""

    def __init__(self, fn, key):
        self.fn, self.key, self.by = fn, key, collections.Counter()
        self.lock = threading.Lock()

    def __call__(self, *args, **kw):
        with self.lock:
            self.by[self.key(*args, **kw)] += 1
        return self.fn(*args, **kw)

    def _forward(name):
        return property(lambda self: getattr(self.fn, name),
                        lambda self, v: setattr(self.fn, name, v))

    calls, launches = _forward("calls"), _forward("launches")
    del _forward


def ra_phase(counters, frames, out_dir, bd=8):
    """bench.py's configuration on RA_FRAMES frames of the moving clip at
    ``bd`` bits; returns the launches and the wrapper calls of the run.
    At 10 bits the sequence header must declare 10 bits, and K5's and
    K6's calls are printed by sample type: MCTF's uint8 (the reference's
    narrowing), the plans' and TPL's int16."""
    from svt_av1_tpu_torch.api import Encoder
    from svt_av1_tpu_torch.io import IvfWriter
    from svt_av1_tpu_torch.ops import bme, dlf, omd

    what = "random access" if bd == 8 else f"{bd}-bit random access"
    path = Path(out_dir) / ("smoke_1080p_ra.ivf" if bd == 8
                            else f"smoke_1080p_ra_{bd}bit.ivf")
    cfg = ra_config(WIDTH, HEIGHT, encoder_bit_depth=bd)
    enc = Encoder(cfg)                      # the default device: CUDA
    assert enc.device.type == "cuda"
    layers, comp = {}, []
    run_job = enc._run_job

    def logged(job, nxt=None):
        out = run_job(job, nxt)
        if job.kind == "code":
            layers[job.display] = job.layer
            if not job.is_key:
                dec = enc._decider_obj
                comp.append((job.display, float(
                    (dec._sf["sel"] >= len(dec._names)).mean())))
        return out

    enc._run_job = logged
    # the frame ME's calls by use: MCTF, TPL, and the rest (the plans)
    by_use = {"MCTF": 0, "TPL": 0}

    def counting(use, method):
        def run(*a, **k):
            before = counters["me_coarse"].calls
            out = method(*a, **k)
            by_use[use] += counters["me_coarse"].calls - before
            return out
        return run

    enc._tf_source = counting("MCTF", enc._tf_source)
    enc._maybe_tpl = counting("TPL", enc._maybe_tpl)
    # K5's calls by reach and plane, K2's by plane and level (the level
    # search's luma candidates, then the chroma planes at the winner)
    k5 = _Tally(bme.me_coarse, lambda src, ref, coarse_r=bme.COARSE_R, *a,
                **kw: f"r {coarse_r}, {src.shape[1]}x{src.shape[0]}, "
                f"{str(src.dtype)[6:]}")
    k6 = _Tally(bme.me_refine, lambda src, *a, **kw: str(src.dtype)[6:])
    k2 = _Tally(dlf.deblock, lambda plane, *a, **kw:
                f"{plane.shape[1]}x{plane.shape[0]}, levels {a[6]}/{a[7]}")
    bme.me_coarse, bme.me_refine, dlf.deblock = k5, k6, k2
    zero_counts(counters)
    torch.cuda.synchronize()
    for name in ("intra_decision", "inter_select"):
        omd.near_recomputes(name)                   # reset
    t0 = time.perf_counter()
    with IvfWriter(str(path), WIDTH, HEIGHT, cfg.frame_rate) as w:
        pts = 0
        for i, planes in enumerate(list(frames) + [None]):
            if i == RA_WARM:
                torch.cuda.synchronize()
                t_warm = time.perf_counter()
            pkts = enc.flush() if planes is None else enc.send_picture(planes)
            for pkt in pkts:
                w.write_frame(pkt, pts=pts)
                pts += 1
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    bme.me_coarse, bme.me_refine, dlf.deblock = k5.fn, k6.fn, k2.fn
    launches, calls = read_counts(counters)
    near = {name: omd.near_recomputes(name)
            for name in ("intra_decision", "inter_select")}
    n_timed = len(frames) - RA_WARM
    print(f"{what} (bench.py's configuration: RANDOM_ACCESS, "
          f"hierarchical_levels {cfg.hierarchical_levels}, "
          f"intra_period_length {cfg.intra_period_length}, qp {QP}, preset "
          f"8, TPL on, tf_level 2, compound_level 1, {bd} bits): "
          f"{len(frames)} frames "
          f"{WIDTH}x{HEIGHT}; last {n_timed} frames after a {RA_WARM}-frame "
          f"warm-up in {t1 - t_warm:.3f} s, {n_timed / (t1 - t_warm):.4f} "
          f"fps; whole run {t1 - t0:.3f} s, {len(frames) / (t1 - t0):.4f} "
          f"fps; {path.stat().st_size} bytes, packets md5 "
          f"{stream_md5(path)}")
    rep = enc.perf_report()
    print(f"{what} stage ms/frame (host wall clock):", json.dumps(
        {k: v.get("ms_per_frame") for k, v in rep.items() if k != "_wall"}))
    print(f"{what} main path launches:", json.dumps(launches))
    print(f"{what} main path wrapper calls:", json.dumps(calls))
    print(f"{what} near-boundary float64 recomputes: K1 "
          f"{near['intra_decision']} over {launches['intra_decision']} "
          f"frames ({near['intra_decision'] / max(launches['intra_decision'], 1):.1f}"
          f" per frame), K8 {near['inter_select']} over "
          f"{launches['inter_select']} inter frames "
          f"({near['inter_select'] / max(launches['inter_select'], 1):.1f} "
          f"per frame)")
    print(f"{what} encode alone: K1 intra_decision "
          f"{launches['intra_decision']} launches, K6 me_refine "
          f"{launches['me_refine']} launches")
    print(f"K5/K6 calls by use: MCTF {by_use['MCTF']}, TPL "
          f"{by_use['TPL']}, inter plans "
          f"{calls['me_coarse'] - by_use['MCTF'] - by_use['TPL']}")
    print("K5 calls by reach and source plane:",
          json.dumps(dict(sorted(k5.by.items()))))
    print("K2 calls by plane and level (vertical/horizontal):",
          json.dumps(dict(sorted(k2.by.items()))))
    by_dtype = {dt: (sum(v for k, v in k5.by.items() if k.endswith(dt)),
                     k6.by[dt]) for dt in ("uint8", "int16")}
    print("K5 / K6 calls (one launch each) by sample type: "
          + ", ".join(f"{dt} {a} / {b}" for dt, (a, b) in by_dtype.items())
          + " (uint8: MCTF's planes" + ("" if bd == 8 else
                                        ", narrowed as the reference does;"
                                        " int16: the plans' and TPL's")
          + ")")
    assert sum(k5.by.values()) == calls["me_coarse"] == launches["me_coarse"]
    assert sum(k6.by.values()) == calls["me_refine"] == launches["me_refine"]
    assert sum(k2.by.values()) == calls["deblock"]
    missing = [n for n in RA_KERNELS if launches[n] == 0]
    assert not missing, f"kernels not launched on the {what} path: {missing}"
    if bd != 8:
        assert by_dtype["uint8"] == (by_use["MCTF"],) * 2, by_dtype
        assert by_dtype["int16"][0] == by_dtype["int16"][1] \
            == calls["me_coarse"] - by_use["MCTF"] > 0, by_dtype
        got_bd = stream_bit_depth(path)
        print(f"{what}: the sequence header declares {got_bd} bits")
        assert got_bd == bd

    heads = stream_headers(path)
    for h in heads:
        if not h["show_existing"]:
            h["layer"] = layers[h["display"]]
    print("per temporal unit from the stream (display, type, layer, "
          "qindex, show_existing):", json.dumps(
              [(h["display"], h.get("type"), h.get("layer"), h.get("qindex"),
                h["show_existing"]) for h in heads]))
    shown = [h["display"] for h in heads
             if h["show_existing"] or h["shown"]]
    assert shown == list(range(len(frames))), shown
    assert any(h["show_existing"] for h in heads)
    coded = [h for h in heads if not h["show_existing"]]
    assert sorted(h["display"] for h in coded) == list(range(len(frames)))
    assert [h["type"] for h in coded].count(0) == 1
    print("compound share of the 16x16 units per inter frame (display, "
          "share):", json.dumps([(d, round(c, 4)) for d, c in comp]))
    assert max(c for _, c in comp) > 0, "no unit chose compound"

    scores = []
    for d, src in enumerate(frames):
        rec = enc.recon_by_display[d]
        for p in range(3):
            assert rec[p].shape == src[p].shape
            assert rec[p].dtype == (np.uint8 if bd == 8 else np.uint16)
        scores.append(psnr(src[0], rec[0], (1 << bd) - 1))
    print(f"{what} recon luma PSNR (peak {(1 << bd) - 1}) per shown frame "
          f"(dB): {[round(x, 3) for x in scores]}")
    assert min(scores) > PSNR_FLOOR_DB, (min(scores), PSNR_FLOOR_DB)
    return launches, calls


# --------------------------------------------------------------------------
# phase 6: small clips, kernels on the card vs plain versions on the CPU
# --------------------------------------------------------------------------

def agreement_clips():
    """The small clips coded on the card and on the CPU: (name, frames,
    config) of 64x64 and 176x144 all-intra, 192x128x6 low-delay P and
    192x128x5 random access (a key frame, then one 4-frame mini-GOP:
    MCTF on its base, compound, show_existing)."""
    clips = {0: synth_clip(176, 144, 2, seed=13),
             -1: synth_clip(192, 128, 6, seed=13)}
    kinds = {0: "all-intra", -1: "low-delay P", "ra": "random access"}
    for (w, h, n, kind) in ((64, 64, 2, 0), (176, 144, 2, 0),
                            (192, 128, 6, -1), (192, 128, 5, "ra")):
        frames = [tuple(np.ascontiguousarray(p[:h >> (i > 0), :w >> (i > 0)])
                        for i, p in enumerate(f))
                  for f in clips[-1 if kind == "ra" else kind][:n]]
        cfg = ra_config(w, h, hierarchical_levels=2) if kind == "ra" \
            else slice_config(w, h, kind)
        yield f"{w}x{h}x{n} {kinds[kind]}", frames, cfg


def tenbit_agreement_clips():
    """(name, frames, config) of the 64x64x2 10-bit all-intra clip (the
    corner of a 176x144 10-bit synth_clip, as agreement_clips cuts the
    8-bit one), of the 192x128x6 10-bit low-delay P clip (the moving
    synth_clip at 10 bits) and of the 192x128x5 10-bit random-access clip
    (its first 5 frames, hierarchical_levels 2: MCTF, TPL, compound,
    show_existing)."""
    frames = [tuple(np.ascontiguousarray(p[:64 >> (i > 0), :64 >> (i > 0)])
                    for i, p in enumerate(f))
              for f in synth_clip(176, 144, 2, seed=13, bd=10)]
    yield "64x64x2 10-bit all-intra", frames, slice_config(64, 64, bd=10)
    moving = synth_clip(192, 128, 6, seed=13, bd=10)
    yield ("192x128x6 10-bit low-delay P", moving,
           slice_config(192, 128, -1, bd=10))
    yield ("192x128x5 10-bit random access", moving[:5],
           ra_config(192, 128, hierarchical_levels=2, encoder_bit_depth=10))


def agreement_phase(out_dir):
    """Returns the random-access card stream and the 10-bit all-intra,
    low-delay P and random-access card streams, each (path, recon)."""
    from svt_av1_tpu_torch.api import encode_ivf

    clips = list(agreement_clips()) + list(tenbit_agreement_clips())
    for k, (name, frames, cfg) in enumerate(clips):
        streams, paths = {}, {}
        for dev in ("cuda", "cpu"):
            p = paths[dev] = Path(out_dir) / f"agree_{k}_{dev}.ivf"
            recon = encode_ivf(frames, cfg, str(p), device=dev)
            streams[dev] = p.read_bytes()
            if name == "192x128x5 random access" and dev == "cuda":
                ra_card = (p, recon)
            if "10-bit all-intra" in name and dev == "cuda":
                tenbit_card = (p, recon)
            if "10-bit low-delay P" in name and dev == "cuda":
                tenbit_ipp_card = (p, recon)
            if "10-bit random access" in name and dev == "cuda":
                tenbit_ra_card = (p, recon)
        same = streams["cuda"] == streams["cpu"]
        print(f"{name}: card stream {len(streams['cuda'])} bytes (packets "
              f"md5 {stream_md5(paths['cuda'])}), CPU stream "
              f"{len(streams['cpu'])} bytes, identical {same}")
        assert same, name
    return ra_card, tenbit_card, tenbit_ipp_card, tenbit_ra_card


# --------------------------------------------------------------------------
# the stripe modes of K1 and K4-K7 against their plain versions
# --------------------------------------------------------------------------

def stripe_kernels_phase(dev, ref_plane, src_plane, row0s):
    """At each of ``row0s`` (a middle stripe and the last one of the
    planes' height): K5/K6/K7 on the 64-row stripe against the whole
    reference, K1 in stripe mode with the true halo rows, K4's search and
    apply with every set of the neighbours' rows that exists there; each
    equal to its plain version on the same card tensors, and K1 and
    K5/K6/K7 to the whole plane's kernel run on the stripe's rows."""
    from svt_av1_tpu_torch.ops import bme, cdef, omd
    from svt_av1_tpu_torch.pipeline import batched_inter as bi

    H, W = ref_plane.shape
    ref = torch.from_numpy(np.ascontiguousarray(ref_plane)).to(dev)
    src = torch.from_numpy(np.ascontiguousarray(src_plane)).to(dev)
    whole_me = bme.frame_me(src, ref, 8, bme.ME_SHAPES)
    mb = tuple(np.linspace(1.0, 6.0, 13).tolist())
    whole_k1 = {(w, h): omd.intra_decision(src, w, h, 140, 250.0, mb)
                for (w, h) in omd.ALL_SHAPES}
    # K4's input: a noisy deblocked plane of the reference
    rng = np.random.default_rng(4)
    full = (ref.to(torch.int32) + torch.from_numpy(
        rng.integers(-6, 7, (H, W)).astype(np.int32)).to(dev)).clamp(0, 255)
    n_sbx = W // 64
    for row0 in row0s:
        stripe = src[row0:row0 + 64].contiguous()
        coarse = bme.me_coarse(stripe, ref, 8, row0)
        want_c = bme.coarse_sb_search(stripe, ref, 8, row0)
        # every ME shape (the 8x8 table) and the step's own shapes (the
        # 16x16 table: the other instantiation of K6)
        me = bme.me_refine(stripe, ref, coarse, bme.ME_SHAPES, row0)
        want_me = bme.refine_plain(stripe, ref, coarse, bme.ME_SHAPES, row0)
        me_p = bme.me_refine(stripe, ref, coarse, PATH_ME_SHAPES, row0)
        want_p = bme.refine_plain(stripe, ref, coarse, PATH_ME_SHAPES, row0)
        sbs = slice(row0 // 64 * n_sbx, (row0 // 64 + 1) * n_sbx)
        mv_r = bi._nested_to_grid(me[(16, 16)][0], 1, n_sbx, 4, 4)
        mv_c = bi._nested_to_grid(me[(16, 16)][1], 1, n_sbx, 4, 4)
        sub = bme.subpel_refine16(stripe, ref, mv_r, mv_c, 8, row0)
        want_sub = bme.subpel_plain(stripe, ref, mv_r, mv_c, 8, row0)
        torch.cuda.synchronize()
        err = (coarse - want_c).abs().max().item()
        for s in bme.ME_SHAPES:
            for g, w, a in zip(me[s], want_me[s], whole_me[s]):
                err = max(err, (g - w).abs().max().item(),
                          (g - a[sbs]).abs().max().item())
        for s in PATH_ME_SHAPES:
            for g, w, a in zip(me_p[s], want_p[s], whole_me[s]):
                err = max(err, (g - w).abs().max().item(),
                          (g - a[sbs]).abs().max().item())
        for got_me, w in ((me, want_me), (me_p, want_p)):
            err = max(err, (got_me["win16"] - w["win16"]).abs().max().item(),
                      (got_me["win16"] - whole_me["win16"][sbs]).abs().max()
                      .item())
        for g, w in zip(sub, want_sub):
            err = max(err, (g.to(torch.int32) - w.to(torch.int32)).abs()
                      .max().item())
        print(f"K5/K6/K7 at row0 {row0} of a {W}x{H} reference (stripe "
              f"{W}x64): max |kernel - plain| and |stripe - whole frame's "
              f"rows| {err}")
        assert err == 0

        # K1: true rows above and below; the last stripe's halo repeats
        # its own last row, which the whole plane's pad does too
        above = src[row0 - 1].contiguous()
        halo = src[row0 + 64:row0 + 96].contiguous() if row0 + 64 < H \
            else stripe[-1:].expand(32, W).contiguous()
        worst_m, worst_c, exact = 1.0, 1.0, True
        for (w, h) in omd.ALL_SHAPES:
            m, c = omd.intra_decision(stripe, w, h, 140, 250.0, mb, 8, above,
                                      halo)
            m2, c2 = omd.intra_decision_plain(stripe, w, h, 140, 250.0, mb,
                                              8, above, halo)
            mw, cw = whole_k1[(w, h)]
            worst_m = min(worst_m, (m == m2).float().mean().item())
            worst_c = min(worst_c, torch.isclose(c, c2, rtol=1e-5).float()
                          .mean().item())
            exact &= torch.equal(m, mw[row0 // h:(row0 + 64) // h]) \
                and torch.equal(c, cw[row0 // h:(row0 + 64) // h])
        print(f"K1 stripe mode, rows {row0}..{row0 + 63} of {W}x{H}: modes "
              f"equal to the plain version {worst_m:.6f} (worst shape), "
              f"costs within rtol 1e-5 {worst_c:.6f}; bit-equal to the "
              f"whole plane's rows {exact}")
        assert worst_m >= 0.99 and worst_c >= 0.99 and exact

        # K4: the neighbours' 2 rows where they exist
        d = full[row0:row0 + 64].contiguous()
        s8 = ref[row0:row0 + 64].contiguous()
        ns = torch.from_numpy(rng.random((8, W // 8)) < 0.8).to(dev)
        dirs, var = cdef.cdef_direction(d, W, 64)
        tops = (None, full[row0 - 2:row0].contiguous())
        bots = (None,) + ((full[row0 + 64:row0 + 66].contiguous(),)
                          if row0 + 64 < H else ())
        err = 0
        for top in tops:
            for bot in bots:
                halos = [(top, bot)]
                e = cdef.cdef_search([s8], [d], dirs, var, ns, W, 64, 3, 8,
                                     halos=halos)[0]
                e2 = cdef.search_plain([s8], [d], dirs, var, ns, W, 64, 3, 8,
                                       halos=halos)[0]
                ystr = cdef.pick_strength(e, cdef.PRI_SET, cdef.SEC_SET)
                a = cdef.cdef_apply([d], ns, dirs, var, ystr, 0, 3, W, 64, 8,
                                    halos)[0]
                b = cdef.cdef_apply_plain([d], ns, dirs, var, ystr, 0, 3, W,
                                          64, 8, halos)[0]
                torch.cuda.synchronize()
                err = max(err, (e - e2).abs().max().item(),
                          (a - b).abs().max().item())
                print(f"K4 at row0 {row0} of {W}x{H} with halo rows (above "
                      f"{top is not None}, below {bot is not None}): "
                      f"strength {ystr}, max |kernel - plain| {err}")
        assert err == 0


# --------------------------------------------------------------------------
# the stripe path (B14) and the decoder path
# --------------------------------------------------------------------------

def _median_ms(fn):
    """Median of 3 wall-clock runs of ``fn``, each after a synchronize."""
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def step_bound(rep):
    """Sum of the least times of the stripe step's kernel calls (the
    kernels phase's counts at each stripe's shapes): per stripe K5, K6,
    K7, K8 once, K1 once per shape, K2 once (both directions) per
    candidate level, K3 once, K4's search and apply once each.
    Returns (ms, the kind that bounds most of it)."""
    from svt_av1_tpu_torch.ops import bme, omd

    frame, stripes = rep["frame"], rep["stripes"]
    H, W = frame.ref.shape
    by = {"bytes": 0.0, "operations": 0.0}

    def add(n_bytes, n_ops, flops=0):
        t, kind = bound_ms(n_bytes, n_ops, flops)
        by[kind] += t

    for s in stripes:
        rows = s.src.shape[0]
        n_sb, units = (rows // 64) * (W // 64), (rows // 16) * (W // 16)
        px = rows * W
        r = frame.coarse_r
        add(px + H * W + n_sb * 8, k5_ops(n_sb, r, px + H * W))
        add(px + H * W + n_sb * 8 + n_sb * 17 * 16,
            k6_ops(n_sb))
        add(px + H * W + units * 16 + px, k7_ops(units))
        add(2 * px + units * 12 + units * 36 + sum(
            (rows // h) * (W // w) * 4 for (w, h) in omd.INTER_SHAPES),
            12 * len(omd.INTER_SHAPES) * px + 3 * px,
            2 * k8_dct_macs(omd.INTER_SHAPES) * px)
        add(px + 33 * W + sum(8 * (rows // h) * (W // w)
                              for (w, h) in omd.ALL_SHAPES),
            0, sum(13 * 2 * px * (w + h) for (w, h) in omd.ALL_SHAPES))
        ext = (rows + 32) * W
        for _ in frame.dlf_levels:
            add(2 * ext * 4 + nbytes(s.av, s.fv, s.ah, s.fh), 0)
        n_u = (rows // 8) * (W // 8)
        add(px * 4 + n_u * 8, n_u * (8 * 64 + 8 * 15 * 3 + 16))
        frac = s.nonskip.float().mean().item()
        add(px * 5 + 4 * W * 4 + n_u * 9,
            px * frac * k4_search_ops(frame.pri_set, frame.sec_set))
        add(2 * px * 4 + 4 * W * 4 + n_u * 9,
            frac * k4_apply_ops(rep["ystr"], 0, W, rows))
    return by["bytes"] + by["operations"], max(by, key=by.get)


STRIPE_GEOMETRIES = ((4, 1280), (17, 1920))


def stripes_phase(counters):
    """The stripe dryrun (B14) at the JAX geometry (4 stripes, 1280x256)
    and at full width (17 stripes, 1920x1088), each on a coded frame of
    the port's encoder with every count set to 0 just before and read
    just after; the plain versions' step on the card at both geometries;
    the closed-GOP half.  Returns the launches and the wrapper calls of
    both paths (the kernels' and the step's own count) and per stripe
    count the step's measurements."""
    from svt_av1_tpu_torch.parallel import dryrun, stripes

    counters = dict(counters, stripe_step=stripes.stripe_step)
    total = {name: 0 for name in counters}
    total_calls = dict(total)
    b14 = {}
    for n, width in STRIPE_GEOMETRIES:
        zero_counts(counters)
        torch.cuda.synchronize()
        rep = dryrun.dryrun_stripes(n, width=width)      # CUDA by default
        torch.cuda.synchronize()
        launches, calls = read_counts(counters)
        for k, v in launches.items():
            total[k] += v
            total_calls[k] += calls[k]
        missing = [k for k in STRIPE_KERNELS + ("stripe_step",)
                   if launches[k] == 0]
        assert not missing, f"kernels not launched on the stripe path: " \
                            f"{missing}"
        frame, parts = rep["frame"], rep["stripes"]
        comm = stripes.LocalStripes(n)
        zero_counts(counters)
        step_ms = _median_ms(lambda: stripes.stripe_step(frame, parts, comm))
        per_step = {k: fn.launches // 3 for k, fn in counters.items()
                    if fn.launches}
        whole_ms = _median_ms(lambda: dryrun.whole_frame(
            rep["state"], frame, frame.ref.device))
        b_ms, b_by = step_bound(rep)
        print(f"stripes {n} x {width}x64 ({width}x{64 * n}), qindex "
              f"{rep['qindex']}: step {rep['step_ms']:.3f} ms first run, "
              f"{step_ms:.3f} ms warm (median of 3, wall after a "
              f"synchronize); the whole frame's run of the same kernels "
              f"{rep['whole_ms']:.3f} ms first, {whole_ms:.3f} ms warm; "
              f"bound of the step's kernels {b_ms:.5f} ms ({b_by})")
        print(f"stripes {n}: agreement with the whole frame "
              f"{json.dumps(rep['agreement'])}, max |stripe - whole| of the "
              f"costs and MV bits {rep['max_abs_err']} (selection fields "
              f"with the MVs, deblocking level {rep['level']}, CDEF "
              f"strength {rep['ystr']}, SSE and error totals and the CDEF "
              f"plane equal); winner margins "
              f"{json.dumps(rep['margins'])}; SSE per candidate "
              f"{rep['whole']['dlf_sse'].tolist()}; CDEF errors "
              f"{rep['whole']['cdef_err'].min().item()}.."
              f"{rep['whole']['cdef_err'].max().item()} (below 2^24 "
              f"= {1 << 24} every float32 partial sum is exact)")
        print(f"stripes {n}: launches on the path (capture encode, step, "
              f"whole frame, GOP half): {json.dumps(launches)}; per step: "
              f"{json.dumps(per_step)}")
        if "gop" in rep:
            print(f"stripes {n}: closed-GOP half {json.dumps(rep['gop'])}: "
                  "the two GOPs decode, with the port's Decoder on the "
                  "card, to the single stream's pictures and its recon")
        # the plain versions' step on the same card tensors, held to the
        # kernels phase's gates: modes equal on more than 99% of every
        # shape's blocks, K1's costs within rtol 1e-5 and K8's within rtol
        # 2e-4, atol 2 on more than 99%, every integer output equal
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = stripes.stripe_step(frame, parts, comm, plain=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        agreement, err = dryrun.compare(rep["outs"], plain, comm.indices,
                                        modes=0.99, intra_tol=(1e-5, 1e-8))
        print(f"stripes {n}: the plain versions' step on the card gives "
              f"the same outputs ({json.dumps(agreement)}, max |kernel - "
              f"plain| {err}); plain step {plain_ms:.3f} ms")
        b14[n] = dict(ms=step_ms, plain_ms=plain_ms, max_abs_err=err,
                      bound=(b_ms, b_by))
    return total, total_calls, b14


DECODE_KERNELS = ("deblock", "cdef_direction", "cdef_apply")


def decode_phase(counters, streams):
    """The port's Decoder on the card, counts set to 0 just before and read
    just after: ``streams`` is a list of (name, IVF path, encoder recon per
    display, temporal units to decode); every shown frame must equal the
    recon of its display."""
    from svt_av1_tpu_torch.api import Decoder
    from svt_av1_tpu_torch.io import IvfReader

    zero_counts(counters)
    torch.cuda.synchronize()
    for name, path, recon, n_tu in streams:
        dec = Decoder()                         # the default device: CUDA
        assert dec.device.type == "cuda"
        pkts = [p for p, _ in IvfReader(str(path))][:n_tu]
        t0 = time.perf_counter()
        shown = [g for g in (dec.decode_frame(p) for p in pkts)
                 if g is not None]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for d, g in enumerate(shown):
            for p in range(3):
                assert np.array_equal(g[p], recon[d][p]), (name, d, p)
        rep = dec.prof.report(dec.frames_decoded)
        print(f"decode {name}: {len(pkts)} temporal units, "
              f"{dec.frames_decoded} coded frames, {len(shown)} shown, all "
              f"equal to the encoder's recon; md5 {dec.md5.hexdigest()}; "
              f"{wall * 1e3 / dec.frames_decoded:.3f} ms per coded frame: "
              f"tile walk (host) {rep['tile_walk']['ms_per_frame']} ms, "
              f"filters (card, copies included) "
              f"{rep['filters']['ms_per_frame']} ms")
    launches, calls = read_counts(counters)
    print("decode path launches:", json.dumps(launches))
    missing = [k for k in DECODE_KERNELS if launches[k] == 0]
    assert not missing, f"kernels not launched on the decode path: {missing}"
    return launches, calls


# --------------------------------------------------------------------------
# presets 7 to 2: the per-block host walk of inter frames (7), the host RD
# walk (6, 5), the partition RD walk (4 to 2: var-tx, extended partitions,
# filter intra, masked compound, inter-intra) with per-64x64 CDEF presets
# on K3/K4 (B16), loop restoration and its second entropy pass, and the
# global-motion fit
# --------------------------------------------------------------------------

# (name, preset, width, height, frames, structure, bit depth, clip, also
# coded on the CPU, further settings); structure "ld" (one key frame, then
# P frames), "ai" (every frame a key frame) or "ra" (hierarchical_levels
# 2 unless the settings say otherwise); each runs in a worker process of
# its own, since the host walks of these presets take most of their time,
# the longest first; the first EARLY_JOBS start right after the build
EARLY_JOBS = 2
PRESET_JOBS = (
    # the full width at half the height: the 1080p key frame's host walk
    # took 862 s in a worker (PERF.md), most of the script's time limit
    ("preset 4 key frame 1920x544", 4, WIDTH, 544, 1, "ld", 8, "moving",
     False, {}),
    ("preset 4 low-delay P 352x288", 4, 352, 288, 3, "ld", 8, "moving",
     True, {}),
    ("preset 6 low-delay P", 6, WIDTH, HEIGHT, 2, "ld", 8, "moving", False,
     {}),
    ("preset 7 low-delay P", 7, WIDTH, HEIGHT, 2, "ld", 8, "moving", False,
     {}),
    ("preset 5 low-delay P 352x288", 5, 352, 288, 3, "ld", 8, "hetero",
     True, {}),
    ("preset 6 10-bit key frame", 6, WIDTH, HEIGHT, 1, "ld", 10, "moving",
     False, {}),
    ("preset 2 all-intra 128x96", 2, 128, 96, 2, "ai", 8, "wave", True, {}),
    ("preset 2 low-delay P 128x96", 2, 128, 96, 2, "ld", 8, "wave", True,
     {}),
    ("preset 3 low-delay P 128x96", 3, 128, 96, 2, "ld", 8, "wave", True,
     {}),
    # presets -2 to 1 take preset 2's signals: the same stream
    ("preset -2 low-delay P 128x96", -2, 128, 96, 2, "ld", 8, "wave", True,
     {}),
    # the clip and settings of tests/test_torch_presets_4_ra.py
    ("preset 4 random access 128x96", 4, 128, 96, 3, "ra", 8, "wave", True,
     dict(qp=50, hierarchical_levels=1)),
    ("preset 6 random access 192x128", 6, 192, 128, 5, "ra", 8, "moving",
     True, {}),
)
# the kernels each job must launch: the fused chain (K2-K4) at preset 7,
# K2 and the per-fb forms of K4 at presets 6 to 2; K1 plans preset 7's
# key frame; MCTF and TPL run K5, K6 and K10 under random access
_PER_FB = ("deblock", "cdef_direction", "cdef_search_fb", "cdef_apply_multi")
PRESET_KERNELS = {
    7: ("intra_decision", "deblock", "cdef_direction", "cdef_search",
        "cdef_apply"),
    6: _PER_FB, 5: _PER_FB, 4: _PER_FB, 3: _PER_FB, 2: _PER_FB, -2: _PER_FB,
}
# the temporal units the presets and settings phase decodes at the full
# width (the Decoder's host walk takes seconds a 1080p frame)
DECODE_TUS = 2
# the tools tests/test_torch_presets_4_ra.py finds in the same stream
P4_RA_TOOLS = ("wedge", "diffwtd", "interintra", "filter_intra")
PRESET_RA_KERNELS = ("me_coarse", "me_refine", "block_var16")


def kernel_counters():
    """{name: wrapper} of every CUDA kernel wrapper with its counts."""
    from svt_av1_tpu_torch.ops import bme, cdef, dlf, omd
    from svt_av1_tpu_torch.pipeline import batched_inter as bi
    from svt_av1_tpu_torch.pipeline import tpl

    return {"intra_decision": omd.intra_decision_packed,
            "deblock": dlf.deblock,
            "cdef_direction": cdef.cdef_direction,
            "cdef_search": cdef.cdef_search,
            "cdef_apply": cdef.cdef_apply,
            "cdef_search_fb": cdef.cdef_search_fb,
            "cdef_apply_multi": cdef.cdef_apply_multi,
            "me_coarse": bme.me_coarse,
            "me_refine": bme.me_refine,
            "subpel_refine16": bme.subpel_refine16,
            "inter_select": bi.inter_select,
            "compound_joint": bi.compound_joint,
            "block_var16": tpl.block_var16}


def hetero_clip(w, h, n, seed=1):
    """Smooth gradient left, strong texture right, moving 2 pixels a frame
    (tests/test_cdef_multi.py's clip): the filter blocks' CDEF winners
    differ, so the preset search pays for cdef_bits > 0."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(n):
        y = (60 + xx // 3 + yy // 6).astype(np.int32)
        tex = (128 + 90 * np.sin(xx * 1.1) * np.cos(yy * 0.9)
               + rng.integers(-25, 26, (h, w))).astype(np.int32)
        y[:, w // 2:] = tex[:, w // 2:]
        y = np.roll(y, i * 2, axis=1)
        u = np.full((h // 2, w // 2), 120, np.uint8)
        v = np.full((h // 2, w // 2), 130, np.uint8)
        frames.append((np.clip(y, 0, 255).astype(np.uint8), u, v))
    return frames


def cut_clip(w, h, n, cut, seed=1):
    """Two scenes: a drifting sinusoid of one frequency and tint for
    frames [0, cut), another from ``cut`` on, each with mild noise; the
    two-pass statistics (pipeline/first_pass.py) put a scene change at
    ``cut``."""
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for scene, count in ((seed, cut), (seed + 1, n - cut)):
        rng = np.random.default_rng(scene)
        fx, fy, ph = rng.uniform(0.1, 0.4, 3)
        for i in range(count):
            y = 128 + 70 * np.sin((xx + i) * fx + ph) * np.cos(yy * fy) \
                + rng.integers(-2, 3, (h, w))
            u = np.full((h // 2, w // 2), 100 + 20 * scene, np.uint8)
            v = np.full((h // 2, w // 2), 140, np.uint8)
            frames.append((np.clip(y, 0, 255).astype(np.uint8), u, v))
    return frames


def wave_clip(w, h, n, seed=13):
    """Two drifting waves and sample noise in luma, static chroma waves
    (tests/test_e2e.py's synthetic_clip)."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        yy, xx = np.mgrid[0:h, 0:w]
        y = (110 + 70 * np.sin(xx / 17 + i * 0.5) + 50 * np.cos(yy / 23 + i)
             + rng.integers(-10, 11, (h, w))).clip(0, 255).astype(np.uint8)
        u = (128 + 40 * np.sin(yy[:h // 2, :w // 2] / 9)).clip(
            0, 255).astype(np.uint8)
        v = (128 - 40 * np.cos(xx[:h // 2, :w // 2] / 13)).clip(
            0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def screen_clip(w, h, n):
    """Screen-like frames: a few flat colours in text-like strokes and a
    tile that repeats across the picture, palette and IntraBC content
    (tests/test_torch_settings.py's _screen_clip)."""
    rng = np.random.default_rng(2)
    tile = rng.choice([16, 80, 200, 235], size=(16, 16)).astype(np.uint8)
    frames = []
    for i in range(n):
        y = np.tile(tile, (h // 16 + 1, w // 16 + 1))[:h, :w].copy()
        y[8 + i:12 + i, 4:w - 4] = 235
        u = np.full((h // 2, w // 2), 128, np.uint8)
        v = np.where(y[::2, ::2] > 128, 160, 96).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def preset_config(preset, w, h, structure, bd, **extra):
    """qp 40 at ``preset`` unless ``extra`` says otherwise: low-delay P (one
    key frame, then P frames), all-intra, or random access with
    hierarchical_levels 2 (MCTF at tf_level 1, TPL); ``extra`` names the
    rate-control mode by its name."""
    from svt_av1_tpu_torch.config import (EncoderConfig, PredStructure,
                                          RateControlMode)

    kw = dict(qp=QP, intra_period_length=-1)
    if structure == "ra":
        kw["hierarchical_levels"] = 2
    else:
        kw["pred_structure"] = PredStructure.LOW_DELAY_P
        if structure == "ai":
            kw["intra_period_length"] = 0
    kw.update(extra)
    if "rate_control_mode" in kw:           # by name: "VBR", "CVBR"
        kw["rate_control_mode"] = RateControlMode[kw["rate_control_mode"]]
    return EncoderConfig(source_width=w, source_height=h, enc_mode=preset,
                         encoder_bit_depth=bd, **kw)


FEATURES = ("type", "cdef_bits", "lr", "gm", "tx_mode_select", "sb",
            "tile_cols", "tile_rows", "qindex", "screen_content", "intrabc",
            "aq_segments", "no_cdf_update", "motion_switchable")


def stream_features(path):
    """Per coded frame of the IVF at ``path``: (frame type, cdef_bits, the
    three planes' loop-restoration types, the global-motion types of the
    seven references, TX_MODE_SELECT, the superblock size, the tile
    columns and rows, base_q_idx, allow_screen_content_tools,
    allow_intrabc, the segments with a qindex delta (adaptive
    quantization), disable_frame_end_update_cdf,
    is_motion_mode_switchable), read back from the sequence and frame
    headers with the reference slots' order hints and global-motion
    parameters tracked as a decoder tracks them.  FEATURES names the
    fields in order."""
    from svt_av1_tpu_torch.bitstream.bits import BitReader
    from svt_av1_tpu_torch.bitstream.headers import (GM_IDENTITY_MAT,
                                                     iter_obus,
                                                     parse_frame_header,
                                                     parse_sequence_header)
    from svt_av1_tpu_torch.constants import ObuType
    from svt_av1_tpu_torch.io import IvfReader

    def tiles(n_sb, log2):
        # uniform tile spacing (spec 5.9.15): tiles of ceil(n_sb / 2^log2)
        # superblocks, the last one shorter
        per = (n_sb + (1 << log2) - 1) >> log2
        return -(-n_sb // per)

    seq, hints, gms, out = None, [0] * 8, [None] * 8, []
    for pkt, _ in IvfReader(str(path)):
        for obu_type, payload in iter_obus(pkt):
            if obu_type == ObuType.OBU_SEQUENCE_HEADER:
                seq = parse_sequence_header(payload)
            elif obu_type == ObuType.OBU_FRAME:
                fh = parse_frame_header(BitReader(payload), seq,
                                        tuple(hints), gms)
                gm = tuple(fh.global_motion[i][0]
                           if i < len(fh.global_motion) else 0
                           for i in range(7))
                # superblocks over the mode-info grid (MiCols, MiRows)
                sb = seq.sb_size
                sb_cols = -(-8 * ((fh.frame_width + 7) >> 3) // sb)
                sb_rows = -(-8 * ((fh.frame_height + 7) >> 3) // sb)
                out.append((int(fh.frame_type), fh.cdef_bits,
                            tuple(fh.lr_type), gm, int(fh.tx_mode_select),
                            sb, tiles(sb_cols, fh.tile_cols_log2),
                            tiles(sb_rows, fh.tile_rows_log2),
                            fh.base_q_idx, int(fh.allow_screen_content_tools),
                            int(fh.allow_intrabc), len(fh.seg_qdeltas),
                            int(fh.disable_frame_end_update_cdf),
                            int(fh.is_motion_mode_switchable)))
                mats = tuple(fh.global_motion[i][1]
                             if i < len(fh.global_motion)
                             else GM_IDENTITY_MAT for i in range(7))
                mask = 0xFF if fh.frame_type == 0 and fh.show_frame \
                    else fh.refresh_frame_flags
                for i in range(8):
                    if (mask >> i) & 1:
                        hints[i], gms[i] = fh.order_hint, mats
    return out


def block_tools(path, device="cpu", n_tu=None):
    """Decode the IVF at ``path`` (its first ``n_tu`` temporal units, each
    ending with a shown frame, all by default) with the port's Decoder on
    ``device`` and count the coding
    tools its blocks use: filter intra (luma coding blocks), wedge and
    diffwtd compound, inter-intra, var-tx (inter blocks whose txfm_split
    tree splits), palette (luma) and IntraBC blocks, OBMC and warped
    motion.  Returns (counts, shown frames, decoder)."""
    from svt_av1_tpu_torch.api import Decoder
    from svt_av1_tpu_torch.io import IvfReader
    from svt_av1_tpu_torch.pipeline.frame_codec import FrameCodec

    counts = collections.Counter()
    fi_blocks = set()
    predict, tx_size = FrameCodec.predict, FrameCodec._code_block_tx_size
    record_mi, motion = FrameCodec._record_mi, FrameCodec._code_motion_mode

    def counted_predict(self, plane, mode, angle, px, py, pw, ph, ts,
                        filter_intra_mode=-1, blk=None):
        if plane == 0 and filter_intra_mode >= 0:
            fi_blocks.add((counts["frames"], blk or (px, py, pw, ph)))
        return predict(self, plane, mode, angle, px, py, pw, ph, ts,
                       filter_intra_mode, blk)

    def counted_tx_size(self, decision, skip, is_inter, *a):
        leaves = tx_size(self, decision, skip, is_inter, *a)
        if is_inter:
            ct = getattr(decision, "compound_type", 0)
            counts["wedge"] += ct == 1
            counts["diffwtd"] += ct == 2
            counts["interintra"] += bool(getattr(decision, "interintra",
                                                 False))
            counts["vartx"] += leaves is not None and len(leaves) > 1
        return leaves

    def counted_record_mi(self, mi_row, mi_col, w4, h4, decision, skip):
        # every coded block, intra and inter frames alike
        counts["palette"] += bool(getattr(decision, "palette_colors", ()))
        counts["intrabc"] += bool(getattr(decision, "use_intrabc", False))
        return record_mi(self, mi_row, mi_col, w4, h4, decision, skip)

    def counted_motion(self, *a):
        mode = motion(self, *a)
        counts["obmc"] += int(mode) == 1
        counts["warped"] += int(mode) == 2
        return mode

    dec = Decoder(device)
    shown = []
    FrameCodec.predict = counted_predict
    FrameCodec._code_block_tx_size = counted_tx_size
    FrameCodec._record_mi = counted_record_mi
    FrameCodec._code_motion_mode = counted_motion
    try:
        for pkt, _ in IvfReader(str(path)):
            n_dec = dec.frames_decoded
            got = dec.decode_frame(pkt)
            counts["frames"] += dec.frames_decoded - n_dec
            if got is not None:
                shown.append(got)
                if len(shown) == n_tu:
                    break
    finally:
        FrameCodec.predict, FrameCodec._code_block_tx_size = \
            predict, tx_size
        FrameCodec._record_mi, FrameCodec._code_motion_mode = \
            record_mi, motion
    counts["filter_intra"] = len(fi_blocks)
    return dict(counts), shown, dec


def preset_job(spec):
    """One job of PRESET_JOBS in a worker process: the port's Encoder on
    the card with every count set to 0 just before and read just after,
    the stream's features, the port's Decoder on the card (every shown
    frame must equal the encoder's recon) and, where asked, the same
    encode with the plain versions on the CPU (the streams must be
    byte-identical).  Returns what the main process prints and checks."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from svt_av1_tpu_torch.api import Encoder
    from svt_av1_tpu_torch.io import IvfWriter
    from svt_av1_tpu_torch.pipeline import mctf

    name, preset, w, h, n, structure, bd, clip, on_cpu, extra = spec
    frames, cfg = preset_frames(spec), preset_config(preset, w, h, structure,
                                                    bd, **extra)
    counters = kernel_counters()
    out = dict(name=name, preset=preset, frames=n, mctf_neighbours=[])
    filt = mctf.temporal_filter

    def counted_filter(center, neighbor_frames, *a):
        out["mctf_neighbours"].append(len(neighbor_frames))
        return filt(center, neighbor_frames, *a)

    with tempfile.TemporaryDirectory(
            dir=os.environ.get("TMPDIR") or tempfile.gettempdir()) as tmp:
        path = Path(tmp) / "card.ivf"
        enc = Encoder(cfg)                  # the default device: CUDA
        assert enc.device.type == "cuda"
        mctf.temporal_filter = counted_filter
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with IvfWriter(str(path), w, h, cfg.frame_rate) as wr:
                pts = 0
                for planes in list(frames) + [None]:
                    for pkt in (enc.flush() if planes is None
                                else enc.send_picture(planes)):
                        wr.write_frame(pkt, pts=pts)
                        pts += 1
            torch.cuda.synchronize()
        finally:
            mctf.temporal_filter = filt
        out["wall_s"] = time.perf_counter() - t0
        out["launches"], out["calls"] = read_counts(counters)
        recon = [enc.recon_by_display[d] for d in sorted(enc.recon_by_display)]
        assert len(recon) == n
        peak = (1 << bd) - 1
        out["psnr"] = [psnr(src[0], rec[0], peak)
                       for src, rec in zip(frames, recon)]
        out["stages"] = {k: v.get("ms_per_frame")
                         for k, v in enc.perf_report().items()
                         if k != "_wall"}
        out["bytes"] = path.stat().st_size
        out["md5"] = stream_md5(path)
        out["features"] = stream_features(path)
        out["params"] = stream_frame_params(path)
        out["bit_depth"] = stream_bit_depth(path)
        out["size"] = (recon[0][0].shape[1], recon[0][0].shape[0])
        if cfg.qp == 0:
            # the JAX encoder's lossless stream, which the port keeps byte
            # for byte, is one no decoder reads (ROADMAP.md, section C)
            out.update(tools={}, decoded=None, decode_md5=None,
                       decode_ms_per_frame=None)
            return out
        # the port's Decoder on the card, counting the blocks' tools; at
        # the full width the first DECODE_TUS temporal units (its host walk
        # takes seconds a frame)
        n_tu = DECODE_TUS if w == WIDTH else None
        t0 = time.perf_counter()
        out["tools"], shown, dec = block_tools(path, "cuda", n_tu)
        torch.cuda.synchronize()
        out["decode_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 \
            / dec.frames_decoded
        out["decoded"] = (len(shown), dec.frames_decoded)
        assert len(shown) == (n if n_tu is None else min(n, n_tu)), \
            (name, len(shown))
        for d, g in enumerate(shown):
            for p in range(3):
                assert np.array_equal(g[p], recon[d][p]), (name, d, p)
        out["decode_md5"] = dec.md5.hexdigest()
    return out


def preset_frames(spec):
    """The frames of a PRESET_JOBS entry."""
    name, preset, w, h, n, structure, bd, clip = spec[:8]
    if clip == "hetero":
        return hetero_clip(w, h, n)
    if clip == "wave":
        return wave_clip(w, h, n)
    if clip == "wave0":                     # tests/test_torch_settings.py's
        return wave_clip(w, h, n, seed=0)
    if clip == "screen":
        return screen_clip(w, h, n)
    return synth_clip(w, h, n, bd=bd) if (w, h) == (WIDTH, HEIGHT) \
        else synth_clip(w, h, n, seed=13, bd=bd)


def cpu_stream_job(spec):
    """The md5 of a PRESET_JOBS entry's stream coded with the plain versions
    on the CPU (a task of its own beside the card's encode)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from svt_av1_tpu_torch.api import encode_ivf

    name, preset, w, h, n, structure, bd, _, _, extra = spec
    with tempfile.TemporaryDirectory(
            dir=os.environ.get("TMPDIR") or tempfile.gettempdir()) as tmp:
        path = Path(tmp) / "cpu.ivf"
        encode_ivf(preset_frames(spec),
                   preset_config(preset, w, h, structure, bd, **extra),
                   str(path), device="cpu")
        return stream_md5(path)


# --------------------------------------------------------------------------
# the rest of the encoder's surface at 1080p: the default all-intra
# configuration (MCTF), super-resolution, film grain, two-pass through the
# command-line app, get_recon
# --------------------------------------------------------------------------

SUPERRES_DENOMS = (9, 16)
SURFACE_FRAMES = {"all-intra MCTF": N_FRAMES, "superres": 2, "film grain": 3,
                  "two-pass": N_FRAMES}
# in worker processes; the all-intra MCTF cell runs in the main process
# beside the other preset-8 cells (mctf_phase)
SURFACE_JOBS = ("film grain", "superres", "two-pass")
SURFACE_CUT = 3
# the kernels each surface job's encodes must launch: K1-K4 on key frames,
# K5/K6 through MCTF (all-intra) or the inter plans (film grain: low-delay
# P, K1-K8)
_K1_K4 = ("intra_decision", "deblock", "cdef_direction", "cdef_search",
          "cdef_apply")
SURFACE_KERNELS = {
    "all-intra MCTF": _K1_K4 + ("me_coarse", "me_refine"),
    "superres": _K1_K4,
    "film grain": _K1_K4 + ("me_coarse", "me_refine", "subpel_refine16",
                            "inter_select"),
    "two-pass": (),
}


def _count(counters, totals):
    """Add the counts since the last zeroing to ``totals`` (launches,
    calls)."""
    launches, calls = read_counts(counters)
    for k in counters:
        totals[0][k] += launches[k]
        totals[1][k] += calls[k]


def _decode_on_card(path, recon):
    """The port's Decoder on the card: every shown frame equals ``recon``
    (display order); returns (md5, ms per coded frame)."""
    from svt_av1_tpu_torch.api import Decoder
    from svt_av1_tpu_torch.io import IvfReader

    dec = Decoder()                         # the default device: CUDA
    t0 = time.perf_counter()
    shown = [g for g in (dec.decode_frame(p)
                         for p, _ in IvfReader(str(path))) if g is not None]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / dec.frames_decoded
    assert len(shown) == len(recon)
    for d, g in enumerate(shown):
        for p in range(3):
            assert np.array_equal(g[p], recon[d][p]), (d, p)
    return dec.md5.hexdigest(), ms


def mctf_phase(counters, tmp):
    """The JAX CLI's default configuration (RANDOM_ACCESS structure,
    intra_period_length -2, preset 8, tf_level 2: every picture a key
    frame that MCTF filters against the next buffered one) on N_FRAMES
    frames of the moving clip, with get_recon, counts set to 0 just
    before and read just after.  Returns (launches, calls, results)."""
    from svt_av1_tpu_torch.config import EncoderConfig

    frames = synth_clip(WIDTH, HEIGHT, SURFACE_FRAMES["all-intra MCTF"])
    cfg = EncoderConfig(source_width=WIDTH, source_height=HEIGHT, qp=QP,
                        enc_mode=8, intra_period_length=-2,
                        recon_enabled=True)
    path = Path(tmp) / "ai_mctf.ivf"
    print("the default all-intra configuration (MCTF):")
    launches, wall, enc, scores = run_encode(counters, frames, cfg, path)
    _, calls = read_counts(counters)
    print("the default all-intra configuration: launches",
          json.dumps(launches))
    missing = [k for k in SURFACE_KERNELS["all-intra MCTF"]
               if not launches[k]]
    assert not missing, f"all-intra MCTF: kernels not launched: {missing}"
    assert enc.pd.gop > 1 and enc.pd.key_interval == 1 \
        and enc.sig.tf_level == 2
    assert all(f[0] == 0 for f in stream_features(path))
    rep = enc.perf_report()
    assert rep["temporal_filter"]["ms_per_frame"] > 0
    for d in range(len(frames)):
        assert enc.get_recon(d) is enc.recon_by_display[d]
    print(f"get_recon: {len(frames)} pictures, each the encoder's "
          f"recon_by_display entry")
    return launches, calls, dict(fps=len(frames) / wall,
                                 md5=stream_md5(path), psnr=scores)


def _superres_job(counters, totals, tmp):
    """All-intra preset 8 at superres_denom 9 and 16: frames coded at the
    downscaled width (1707 and 960 of 1920), upscaled in the loop; PSNR in
    the upscaled domain; each stream decoded on the card to its recon."""
    from svt_av1_tpu_torch.config import EncoderConfig, PredStructure

    frames = synth_clip(WIDTH, HEIGHT, SURFACE_FRAMES["superres"])
    out = dict(launches={k: 0 for k in counters}, md5={}, psnr={})
    for denom in SUPERRES_DENOMS:
        cfg = EncoderConfig(source_width=WIDTH, source_height=HEIGHT,
                            qp=QP, enc_mode=8, intra_period_length=0,
                            pred_structure=PredStructure.LOW_DELAY_P,
                            superres_mode=1, superres_denom=denom)
        path = Path(tmp) / f"superres{denom}.ivf"
        print(f"superres {denom}/8:")
        launches, _, enc, scores = run_encode(counters, frames, cfg, path)
        _count(counters, totals)
        for k in counters:
            out["launches"][k] += launches[k]
        params = stream_frame_params(path)
        widths = superres_widths(path)
        print(f"superres {denom}/8: coded widths {widths}, upscaled "
              f"{WIDTH}; launches: {json.dumps(launches)}")
        assert all(w < WIDTH for w, _ in widths), widths
        assert all(d == denom for _, d in widths) and len(params) == 2
        md5, ms = _decode_on_card(path, [enc.recon_by_display[d]
                                         for d in range(len(frames))])
        print(f"superres {denom}/8: decoded on the card to the recon, md5 "
              f"{md5}, {ms:.3f} ms per frame")
        out["md5"][denom], out["psnr"][denom] = stream_md5(path), scores
    return out


def superres_widths(path):
    """(coded width, superres denominator) per frame of the IVF."""
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
            elif obu_type == ObuType.OBU_FRAME:
                fh = parse_frame_header(BitReader(payload), seq)
                out.append((fh.frame_width, fh.superres_denom))
    return out


def _film_grain_job(counters, totals, tmp):
    """Low-delay P preset 8 with film_grain_denoise_strength 8: every frame
    header carries grain parameters with apply_grain; the port's Decoder
    on the card and on the CPU give equal md5s with the grain applied,
    and the card's pictures before the grain equal the encoder's recon."""
    from svt_av1_tpu_torch.api import Decoder
    from svt_av1_tpu_torch.io import IvfReader

    frames = synth_clip(WIDTH, HEIGHT, SURFACE_FRAMES["film grain"])
    cfg = preset_config(8, WIDTH, HEIGHT, "ld", 8,
                        film_grain_denoise_strength=8)
    path = Path(tmp) / "grain.ivf"
    launches, wall, enc, scores = run_encode(counters, frames, cfg, path)
    _count(counters, totals)
    md5s, before = {}, []
    for device in ("cuda", "cpu"):
        dec = Decoder(device)
        if device == "cuda":
            output = dec._output

            def recorded(planes, film_grain=None):
                before.append((planes, film_grain))
                return output(planes, film_grain)

            dec._output = recorded
        t0 = time.perf_counter()
        for pkt, _ in IvfReader(str(path)):
            dec.decode_frame(pkt)
        md5s[device] = (dec.md5.hexdigest(),
                        (time.perf_counter() - t0) / dec.frames_decoded)
    assert len(before) == len(frames)
    for d, (planes, grain) in enumerate(before):
        assert grain is not None and grain.apply_grain, d
        for p in range(3):
            assert np.array_equal(planes[p], enc.recon_by_display[d][p])
    print(f"film grain: every frame carries grain parameters with "
          f"apply_grain (seeds {[g.grain_seed for _, g in before]}); "
          f"decoded md5 with the grain, card {md5s['cuda'][0]} "
          f"({md5s['cuda'][1]:.3f} s a frame), CPU {md5s['cpu'][0]} "
          f"({md5s['cpu'][1]:.3f} s a frame)")
    assert md5s["cuda"][0] == md5s["cpu"][0]
    return dict(launches=launches, fps=len(frames) / wall,
                md5=stream_md5(path), psnr=scores)


def _two_pass_job(counters, totals, tmp):
    """Both passes through ``python -m svt_av1_tpu_torch.app`` (random
    access, --keyint -1) on a 1080p y4m with a scene cut at SURFACE_CUT:
    the second pass must code a key frame there."""
    from fractions import Fraction

    from svt_av1_tpu_torch.io.y4m import VideoInfo, Y4MWriter

    n = SURFACE_FRAMES["two-pass"]
    y4m, ivf = Path(tmp) / "cut.y4m", Path(tmp) / "two_pass.ivf"
    w = Y4MWriter(str(y4m), VideoInfo(WIDTH, HEIGHT, Fraction(30)))
    for f in cut_clip(WIDTH, HEIGHT, n, SURFACE_CUT):
        w.write(f)
    w.close()
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    for p in (1, 2):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "svt_av1_tpu_torch.app", "enc", "-i",
             str(y4m), "-b", str(ivf), "-q", str(QP), "--keyint", "-1",
             "--pass", str(p)], cwd=root, env=env, capture_output=True,
            text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        print(f"two-pass: pass {p} in {time.perf_counter() - t0:.3f} s: "
              f"{r.stdout.strip().splitlines()[-1]}")
    heads = [h for h in stream_headers(ivf) if not h["show_existing"]]
    keys = sorted(h["display"] for h in heads if h["type"] == 0)
    print(f"two-pass: key frames at displays {keys} of {n}")
    assert sorted(h["display"] for h in heads) == list(range(n))
    assert keys == [0, SURFACE_CUT], keys
    return dict(launches={k: 0 for k in counters}, md5=stream_md5(ivf))


def surface_job(name):
    """One surface job in a worker process, its printed lines captured;
    returns its results and the worker's launches and calls of the
    in-process encodes."""
    import contextlib
    import io

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    counters = kernel_counters()
    totals = ({k: 0 for k in counters}, {k: 0 for k in counters})
    buf = io.StringIO()
    run = {"superres": _superres_job, "film grain": _film_grain_job,
           "two-pass": _two_pass_job}[name]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), tempfile.TemporaryDirectory(
            dir=os.environ.get("TMPDIR") or tempfile.gettempdir()) as tmp:
        out = run(counters, totals, tmp)
    out.update(name=name, log=buf.getvalue(), wall_s=time.perf_counter() - t0,
               all_launches=totals[0], all_calls=totals[1])
    return out


# --------------------------------------------------------------------------
# the encoder's configuration surface on the card: preset 8 at the full
# width under each setting the JAX encoder reads, and each setting again at
# the size the CPU tests hold against the JAX package, card = CPU
# --------------------------------------------------------------------------

_K1_K8 = _K1_K4 + ("me_coarse", "me_refine", "subpel_refine16",
                   "inter_select")
_K1_K10 = _K1_K8 + ("compound_joint", "block_var16")
_K2_K4 = ("deblock", "cdef_direction", "cdef_search", "cdef_apply")
# every tool toggle of the configuration off (tests/test_torch_config_
# surface.py's TOOLS_OFF)
TOOLS_OFF = dict(enable_cfl=0, intra_angle_delta=0,
                 enable_intra_edge_filter=0, filter_intra_level=0,
                 palette_level=0, intrabc_mode=0, inter_intra_compound=0,
                 rdoq_level=0, enable_mfmv=0, frame_end_cdf_update=0,
                 pic_based_rate_est=0, enable_global_motion=False)
QINDEX_OFFSETS = (0, 4, 8, 12)
_SB64 = dict(super_block_size=64)
_OFFSETS = dict(use_fixed_qindex_offsets=True, qindex_offsets=QINDEX_OFFSETS,
                key_frame_qindex_offset=-8)
# tf_level 1 (the full window): at preset 8's tf_level 2 the window is one
# picture either side whatever altref_nframes says
_REACH = dict(tf_level=1, altref_nframes=3, look_ahead_distance=4)
_QP_RANGE = dict(min_qp_allowed=20, max_qp_allowed=55)
_H3 = dict(hierarchical_levels=3)
# (name, structure, frames, width, height, bit depth, clip, settings, the
# kernels it must launch, the kernels it must not launch, its card = CPU
# job: (width, height, frames, clip, settings) with the structure and bit
# depth of the first, at the size the CPU tests hold against the JAX
# package, on their clip where it is 8-bit: tests/test_torch_settings.py
# ("wave0") or tests/test_torch_config_surface_streams.py ("wave"))
SETTINGS_JOBS = (
    ("sb64", "ra", 9, WIDTH, HEIGHT, 8, "moving", dict(_H3, **_SB64),
     _K1_K10, (), (128, 128, 5, "wave", _SB64)),
    ("sb64 10-bit", "ra", 9, WIDTH, HEIGHT, 10, "moving", dict(_H3, **_SB64),
     _K1_K10, (), (128, 128, 5, "moving", _SB64)),
    # TPL runs under CQP only (api.py _maybe_tpl): no K10
    ("CVBR", "ra", 9, WIDTH, HEIGHT, 8, "moving",
     dict(_H3, rate_control_mode="CVBR", target_bit_rate=6_000_000,
          vbv_bufsize=3_000_000, **_QP_RANGE), _K1_K8 + ("compound_joint",),
     ("block_var16",),
     (64, 64, 5, "wave", dict(rate_control_mode="CVBR",
                              target_bit_rate=200_000, vbv_bufsize=50_000,
                              **_QP_RANGE))),
    ("qindex offsets", "ra", 9, WIDTH, HEIGHT, 8, "moving",
     dict(_H3, **_OFFSETS), _K1_K10, (), (64, 64, 5, "wave", _OFFSETS)),
    ("MCTF reach", "ra", 9, WIDTH, HEIGHT, 8, "moving", dict(_H3, **_REACH),
     _K1_K10, (), (64, 64, 9, "wave", _REACH)),
    ("tiles", "ld", 3, WIDTH, HEIGHT, 8, "moving",
     dict(tile_columns=2, tile_rows=1), _K1_K8, (),
     (128, 128, 2, "wave", dict(_SB64, tile_columns=1, tile_rows=1))),
    ("odd size 10-bit", "ld", 3, 1918, 1078, 10, "moving", {}, _K1_K8, (),
     (202, 134, 3, "moving", {})),
    ("warped/OBMC", "ld", 3, WIDTH, HEIGHT, 8, "moving",
     dict(enable_warped_motion=1, obmc_level=1), _K1_K8, (),
     (192, 128, 3, "wave0", dict(enable_warped_motion=1, obmc_level=1))),
    ("VBR", "ld", 4, WIDTH, HEIGHT, 8, "moving",
     dict(rate_control_mode="VBR", target_bit_rate=6_000_000), _K1_K8, (),
     (192, 128, 4, "wave0", dict(rate_control_mode="VBR",
                                 target_bit_rate=400_000))),
    ("tools off", "ld", 3, WIDTH, HEIGHT, 8, "moving", TOOLS_OFF, _K1_K8, (),
     (64, 64, 2, "wave", TOOLS_OFF)),
    ("screen content", "ai", 2, WIDTH, 544, 8, "screen",
     dict(screen_content_mode=1), ("intra_decision",), (),
     (64, 64, 2, "screen", dict(screen_content_mode=1))),
    ("AQ", "ai", 2, WIDTH, HEIGHT, 8, "moving",
     dict(enable_adaptive_quantization=1), _K1_K4, (),
     (128, 128, 2, "wave0", dict(enable_adaptive_quantization=1))),
    ("lossless", "ai", 1, WIDTH, HEIGHT, 8, "moving", dict(qp=0),
     ("intra_decision",), _K2_K4, (64, 64, 2, "wave0", dict(qp=0))),
    ("filters off", "ai", 2, WIDTH, HEIGHT, 8, "moving",
     dict(disable_dlf=True, cdef_level=0), ("intra_decision",), _K2_K4,
     (64, 64, 2, "wave0", dict(disable_dlf=True, cdef_level=0))),
)

def settings_specs():
    """Each SETTINGS_JOBS entry as two PRESET_JOBS entries at preset 8: the
    full-width job on the card, and the card = CPU job."""
    out = []
    for (name, structure, n, w, h, bd, clip, extra, _, _,
         (sw, sh, sn, sclip, sextra)) in SETTINGS_JOBS:
        out.append(((name, 8, w, h, n, structure, bd, clip, False, extra),
                    (name + " card = CPU", 8, sw, sh, sn, structure, bd, sclip,
                     True, sextra)))
    return out


def feature(r, name):
    """One field of stream_features per coded frame of a job's stream."""
    return [f[FEATURES.index(name)] for f in r["features"]]


def settings_check(name, r):
    """The stream of the job ``name`` (full width or card = CPU) carries
    its setting; returns what was read, for the log."""
    from svt_av1_tpu_torch.bitstream.headers import QUANTIZER_TO_QINDEX

    q = feature(r, "qindex")
    key = [t == 0 for t in feature(r, "type")]
    base = QUANTIZER_TO_QINDEX[QP]
    if name.startswith("sb64"):
        assert set(feature(r, "sb")) == {64}, r["features"]
        got = "64x64 superblocks"
    elif name == "tiles":
        tiles = set(zip(feature(r, "tile_cols"), feature(r, "tile_rows")))
        assert all(c > 1 and n > 1 for c, n in tiles), tiles
        got = f"tiles (columns, rows) {sorted(tiles)}"
    elif name == "CVBR" or name == "VBR":
        assert len(set(q)) > 1, q
        if name == "CVBR":
            assert all(QUANTIZER_TO_QINDEX[20] <= v <= QUANTIZER_TO_QINDEX[55]
                       for v in q), q
        got = f"base_q_idx per coded frame {q}"
    elif name == "qindex offsets":
        assert all(v == base - 8 for v, k in zip(q, key) if k), q
        rest = {v for v, k in zip(q, key) if not k}
        assert len(rest) > 1 and rest <= {base + o for o in QINDEX_OFFSETS}
        got = f"base_q_idx per coded frame {q}"
    elif name == "MCTF reach":
        got = r["mctf_neighbours"]
        assert got and max(got) <= 2, got
        got = f"MCTF neighbours per filtered picture {got}"
    elif name == "odd size 10-bit":
        # sizes off the 8x8 grid: every kernel's padded edge
        assert r["bit_depth"] == 10 and all(v % 8 for v in r["size"])
        got = f"{r['size'][0]}x{r['size'][1]}, {r['bit_depth']} bits"
    elif name == "warped/OBMC":
        sw = feature(r, "motion_switchable")
        assert all(s for s, k in zip(sw, key) if not k) and not all(key)
        got = (f"is_motion_mode_switchable on every inter frame; OBMC "
               f"{r['tools'].get('obmc', 0)}, warped "
               f"{r['tools'].get('warped', 0)} blocks decoded")
    elif name == "tools off":
        assert all(feature(r, "no_cdf_update")) and not any(
            any(g) for g in feature(r, "gm"))
        got = "disable_frame_end_update_cdf on every frame"
    elif name == "screen content":
        assert all(feature(r, "screen_content")) and all(
            feature(r, "intrabc"))
        tools = r["tools"]
        assert tools.get("palette", 0) + tools.get("intrabc", 0) > 0, tools
        got = (f"screen content tools and IntraBC on every frame; "
               f"{tools.get('palette', 0)} palette, "
               f"{tools.get('intrabc', 0)} IntraBC blocks decoded")
    elif name == "AQ":
        seg = feature(r, "aq_segments")
        assert all(s > 0 for s in seg), seg
        got = f"segments with a qindex delta per frame {seg}"
    elif name == "lossless":
        assert set(q) == {0}, q
        got = "base_q_idx 0 on every frame"
    elif name == "filters off":
        assert all(lv == 0 and y == 0 and uv == 0
                   for _, lv, y, uv in r["params"]), r["params"]
        got = "deblocking level 0 and CDEF strength 0 on every frame"
    else:
        raise AssertionError(f"no check for the setting {name!r}")
    return got


def start_workers():
    """The worker pool of the presets and surface phase, at most one
    process a core, started right after the build with the EARLY_JOBS
    longest preset jobs (host walks of minutes on one core each), so that
    they run beside the earlier phases.  Returns (pool, their results)."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(
        min(os.cpu_count() or 8, 8))
    early = {spec[0]: pool.apply_async(preset_job, (spec,))
             for spec in PRESET_JOBS[:EARLY_JOBS]}
    early.update({("cpu", spec[0]): pool.apply_async(cpu_stream_job, (spec,))
                  for spec in PRESET_JOBS[:EARLY_JOBS] if spec[8]})
    return pool, early


def _report_job(spec, r):
    """Print a preset or settings job's results and check what every job
    must show: the PSNR floor and, where coded on the CPU too, the CPU's
    stream."""
    name, preset, w, h, n, structure, bd, _, on_cpu, _ = spec
    print(f"{name} ({w}x{h}, {n} frames, {bd} bits): {r['wall_s']:.3f} s, "
          f"{n / r['wall_s']:.4f} fps, {r['bytes']} bytes, packets md5 "
          f"{r['md5']}; luma PSNR (dB) "
          f"{[round(x, 3) for x in r['psnr']]}")
    print(f"{name}: stage ms/frame (host wall clock):",
          json.dumps(r["stages"]))
    print(f"{name}: per coded frame {FEATURES}:", json.dumps(r["features"]))
    print(f"{name}: launches:", json.dumps(r["launches"]))
    if r["decoded"] is None:
        print(f"{name}: not decoded: the JAX encoder's lossless stream "
              f"(base_q_idx 0), kept byte for byte, which no decoder reads")
    else:
        print(f"{name}: decoded on the card to the recon ({r['decoded'][0]} "
              f"shown, {r['decoded'][1]} coded frames), md5 "
              f"{r['decode_md5']}, {r['decode_ms_per_frame']:.3f} ms per "
              f"coded frame; block tools: {json.dumps(r['tools'])}")
    assert min(r["psnr"]) > PSNR_FLOOR_DB, (name, r["psnr"])
    if on_cpu:
        print(f"{name}: card stream identical to the CPU's: "
              f"{r['cpu_identical']}")
        assert r["cpu_identical"], name


def presets_phase(pool, early):
    """The rest of PRESET_JOBS, the surface jobs and the settings jobs in
    ``pool`` (each job's counts are its own process's), the longest
    first, then every result, ``early`` included; the pool is closed.
    Every preset and settings job's kernels must have launched (and a
    settings job's listed others not), its PSNR clear the floor, its
    stream decode on the card to its recon and, where coded on the CPU
    too, equal the CPU's stream; a settings job's stream must carry its
    setting (settings_check) at both sizes.  The preset streams at 6 and
    below must carry cdef_bits > 0 and loop restoration in at least one
    frame, those at 4 too; the preset-4 key frame TX_MODE_SELECT,
    cdef_bits > 0 and filter-intra blocks; the preset-4 random-access
    stream the tools its CPU test finds; preset -2's stream must equal
    preset 2's.  Returns (preset results by job name, surface results by
    job name, settings results by job name)."""
    t0 = time.perf_counter()
    settings = settings_specs()
    # the two 1080p preset jobs, then the surface jobs, then the full-width
    # settings jobs, then the rest and the CPU encodes of the jobs coded on
    # the CPU too
    jobs = dict(early)
    for spec in PRESET_JOBS[EARLY_JOBS:EARLY_JOBS + 2]:
        jobs[spec[0]] = pool.apply_async(preset_job, (spec,))
    surface = {name: pool.apply_async(surface_job, (name,))
               for name in SURFACE_JOBS}
    for spec, _ in settings:
        jobs[spec[0]] = pool.apply_async(preset_job, (spec,))
    for spec in PRESET_JOBS[EARLY_JOBS + 2:] + tuple(s for _, s in settings):
        jobs[spec[0]] = pool.apply_async(preset_job, (spec,))
    for spec in PRESET_JOBS[EARLY_JOBS:] + tuple(s for _, s in settings):
        if spec[8]:
            jobs[("cpu", spec[0])] = pool.apply_async(cpu_stream_job,
                                                      (spec,))
    surface = {name: f.get() for name, f in surface.items()}
    jobs = {k: f.get() for k, f in jobs.items()}
    pool.close()
    pool.join()
    for k, r in jobs.items():
        if not isinstance(k, tuple) and ("cpu", k) in jobs:
            r["cpu_identical"] = jobs[("cpu", k)] == r["md5"]
    print(f"presets, surface and settings phase: {len(PRESET_JOBS)} preset "
          f"jobs ({EARLY_JOBS} of them started after the build), "
          f"{len(surface)} surface jobs and {2 * len(settings)} settings "
          f"jobs, {time.perf_counter() - t0:.3f} s wall after the earlier "
          f"phases")
    for name, r in surface.items():
        print(r["log"], end="")
        print(f"surface {name}: {r['wall_s']:.3f} s in its worker; "
              f"launches: {json.dumps(r['launches'])}")
    by_name = {}
    for spec in PRESET_JOBS:
        name, preset, structure = spec[0], spec[1], spec[5]
        r = by_name[name] = jobs[name]
        _report_job(spec, r)
        need = PRESET_KERNELS[preset] + (PRESET_RA_KERNELS
                                         if structure == "ra" else ())
        missing = [k for k in need if r["launches"][k] == 0]
        assert not missing, f"{name}: kernels not launched: {missing}"
        if preset <= 4:
            assert all(f[4] for f in r["features"]), name
    results = list(by_name.values())
    for top in (6, 4):
        for what, key in (("cdef_bits > 0", 1), ("loop restoration", 2)):
            assert any(any(f[key]) if key == 2 else f[key] > 0
                       for r in results if r["preset"] <= top
                       for f in r["features"]), \
                f"no frame at presets <= {top} carries {what}"
    # the 1080p key frame's loop-restoration search runs (its planes may
    # keep RESTORE_NONE: the preset-4 streams above must carry some)
    key4 = by_name["preset 4 key frame 1920x544"]
    assert key4["features"][0][1] > 0 and key4["stages"]["lr_search"] > 0
    assert key4["tools"].get("filter_intra"), key4["tools"]
    ra4 = by_name["preset 4 random access 128x96"]["tools"]
    assert all(ra4.get(k) for k in P4_RA_TOOLS), ra4
    mr2 = by_name["preset -2 low-delay P 128x96"]["md5"]
    print(f"preset -2 low-delay P 128x96: stream identical to preset 2's: "
          f"{mr2 == by_name['preset 2 low-delay P 128x96']['md5']}")
    assert mr2 == by_name["preset 2 low-delay P 128x96"]["md5"]
    for name, r in surface.items():
        missing = [k for k in SURFACE_KERNELS[name] if not r["launches"][k]]
        assert not missing, f"{name}: kernels not launched: {missing}"
    by_setting = {}
    for (big, small), job in zip(settings, SETTINGS_JOBS):
        need, absent = job[8], job[9]
        for spec in (big, small):
            r = by_setting[spec[0]] = jobs[spec[0]]
            _report_job(spec, r)
            print(f"{spec[0]}: the setting in the stream: "
                  f"{settings_check(job[0], r)}")
        r = by_setting[big[0]]
        missing = [k for k in need if r["launches"][k] == 0]
        assert not missing, f"{big[0]}: kernels not launched: {missing}"
        extra = [k for k in absent if r["launches"][k]]
        assert not extra, f"{big[0]}: kernels launched: {extra}"
    return by_name, surface, by_setting


# --------------------------------------------------------------------------
# optional: where the encode's time goes, from a profiler trace
# --------------------------------------------------------------------------

def _profiled(enc, frames, flush=True):
    """Send ``frames`` (and flush) under the profiler: (profile, wall s)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for planes in frames:
            enc.send_picture(planes)
        if flush:
            enc.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def _short(name):
    """A device event's name without its parameter list (copies keep
    their direction)."""
    name = name.replace("(anonymous namespace)::", "")
    return name if name.startswith("Memcpy") else name.split("(")[0]


def _report_trace(prof, wall, what, out_file):
    from torch.autograd import DeviceType

    # device-side events only (kernels and copies); a host op's device
    # time repeats its children's
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            k = _short(e.key)
            by_name[k] = by_name.get(k, 0.0) + e.self_device_time_total
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:14]
    print(f"trace, {what}: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / (wall * 1e3):.3f}% of the "
          f"wall time)")
    print(f"trace device ms by kernel, {what}:", json.dumps(
        {k: round(v / 1e3, 4) for k, v in top}))
    prof.export_chrome_trace(str(out_file))
    with open(out_file, "rb") as f, \
            gzip.open(str(out_file) + ".gz", "wb") as g:
        g.write(f.read())
    Path(out_file).unlink()


def trace_phase(ai_frames, ipp_frames, ra_frames, trace_dir):
    from svt_av1_tpu_torch.api import Encoder

    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    enc = Encoder(slice_config(WIDTH, HEIGHT))
    enc.send_picture(ai_frames[0])          # warm: worker thread, caches
    enc.flush()
    enc = Encoder(slice_config(WIDTH, HEIGHT))
    prof, wall = _profiled(enc, ai_frames[:TRACE_FRAMES])
    _report_trace(prof, wall, f"{TRACE_FRAMES} all-intra frames",
                  out / "encode_1080p.json")
    # low-delay P: the key frame codes outside the window (when frame 1
    # arrives); the window codes P frames 1..TRACE_FRAMES
    enc = Encoder(slice_config(WIDTH, HEIGHT, -1))
    for planes in ipp_frames[:2]:
        enc.send_picture(planes)
    prof, wall = _profiled(enc, ipp_frames[2:TRACE_FRAMES + 1])
    assert enc.frame_count == TRACE_FRAMES + 1
    _report_trace(prof, wall, f"{TRACE_FRAMES} P frames",
                  out / "encode_1080p_ipp.json")
    # random access: the key frame and the first mini-GOP code outside the
    # window; the window sends the second mini-GOP and flushes
    enc = Encoder(ra_config(WIDTH, HEIGHT))
    for planes in ra_frames[:RA_WARM]:
        enc.send_picture(planes)
    prof, wall = _profiled(enc, ra_frames[RA_WARM:])
    assert enc.frame_count == len(ra_frames)
    _report_trace(prof, wall, f"the second random-access mini-GOP "
                  f"({len(ra_frames) - RA_WARM} frames)",
                  out / "encode_1080p_ra.json")


ALLINTRA_KERNELS = ("intra_decision", "deblock", "cdef_direction",
                    "cdef_search", "cdef_apply")
IPP_KERNELS = ALLINTRA_KERNELS + ("me_coarse", "me_refine",
                                  "subpel_refine16", "inter_select")
STRIPE_KERNELS = IPP_KERNELS
RA_KERNELS = IPP_KERNELS + ("compound_joint", "block_var16")


def main() -> int:
    script_t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from svt_av1_tpu_torch.kernels import build

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
    # the longest preset jobs run beside the phases below (the pool's
    # workers end with the script, on a failure too)
    pool, early = start_workers()
    # registers, spills (bytes per thread) and shared memory (bytes per
    # block) of the kernels redesigned last
    for name in ("me_coarse", "deblock"):
        for line in build.ptxas_report(name):
            print(f"ptxas {name}: {line}")

    half = N_FRAMES // 2
    frames = synth_clip(WIDTH, HEIGHT, half) + synth_clip(
        WIDTH, HEIGHT, N_FRAMES - half, tex_sigma=SMOOTH_SIGMA)
    # the moving clip of the low-delay P and random-access phases: texture
    # and rectangle move by (1.7, 3.1) and (3, 5) pixels per frame
    ra_frames = synth_clip(WIDTH, HEIGHT, RA_FRAMES)
    ipp_frames = ra_frames[:N_FRAMES]
    kres = kernels_phase(dev, frames[0])
    # K1, K3 and K4's frame-level forms at the widths super-resolution
    # codes a 1080p frame at
    for denom in SUPERRES_DENOMS:
        superres_kernel_checks(dev, frames[0], denom)
    # the 10-bit all-intra clip: synth_clip scaled to 10 bits
    frames10 = synth_clip(WIDTH, HEIGHT, half, bd=10) + synth_clip(
        WIDTH, HEIGHT, N_FRAMES - half, tex_sigma=SMOOTH_SIGMA, bd=10)
    kres.update(tenbit_kernels_phase(dev, frames10[0], kres))
    kres.update(inter_kernels_phase(dev, ipp_frames[0], ipp_frames[1]))
    # the 10-bit low-delay P and random-access clip: the moving clip at 10
    # bits (its first N_FRAMES frames are synth_clip's N_FRAMES)
    ra_frames10 = synth_clip(WIDTH, HEIGHT, RA_FRAMES, bd=10)
    ipp_frames10 = ra_frames10[:N_FRAMES]
    kres.update(inter_kernels_phase(dev, ipp_frames10[0], ipp_frames10[1],
                                    bd=10))
    tenbit_inter_report(kres)
    # a TPL window: the previous mini-GOP's last picture and 16 more
    kres.update(ra_kernels_phase(dev, ra_frames[:3],
                                 [f[0] for f in ra_frames[:RA_WARM]]))
    kres.update(ra_kernels_phase(
        dev, ra_frames10[:3], [f[0] for f in ra_frames10[:RA_WARM]], 10,
        kres))

    counters = kernel_counters()
    out_dir = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        ai_launches = allintra_phase(counters, frames, tmp)
        ipp_launches, _, ipp_stream = ipp_phase(counters, ipp_frames, tmp)
        ra_launches, ra_calls = ra_phase(counters, ra_frames, tmp)
        tb_path, tb_recon, tb_launches, tb_calls = tenbit_phase(
            counters, frames10, tmp)
        tbp_launches, tbp_calls, _ = ipp_phase(counters, ipp_frames10, tmp,
                                               bd=10)
        tbr_launches, tbr_calls = ra_phase(counters, ra_frames10, tmp, bd=10)
        ra_card, tenbit_card, tenbit_ipp_card, tenbit_ra_card = \
            agreement_phase(tmp)
        # the stripe modes against their plain versions, after the encodes
        # so that those run on the process state they ran on before: the
        # JAX geometry (1280x256, stripes at rows 64 and 192) and the full
        # width (1920x1088, the edge rows repeated below the 1080, stripes
        # at rows 512 and 1024)
        stripe_kernels_phase(dev, ra_frames[0][0][:256, :1280],
                             ra_frames[1][0][:256, :1280], (64, 192))
        tall = [np.pad(f[0], ((0, 1088 - HEIGHT), (0, 0)), mode="edge")
                for f in ra_frames[:2]]
        stripe_kernels_phase(dev, *tall, (512, 1024))
        stripe_launches, stripe_calls, b14 = stripes_phase(counters)
        dec_launches, dec_calls = decode_phase(counters, [
            ("192x128x5 random access (card stream)", *ra_card, 7),
            (f"{WIDTH}x{HEIGHT} low-delay P, first 2 temporal units",
             *ipp_stream, 2)])
        # the 10-bit streams: the small card streams of the agreement phase
        # and the first frame of the 1080p all-intra one (the 1080p
        # low-delay P stream is not decoded: the host walk takes about 20
        # s a frame)
        tb_dec_launches, tb_dec_calls = decode_phase(counters, [
            ("64x64x2 10-bit all-intra (card stream)", *tenbit_card, 2),
            ("192x128x6 10-bit low-delay P (card stream)", *tenbit_ipp_card,
             6),
            ("192x128x5 10-bit random access (card stream)",
             *tenbit_ra_card, 7),
            (f"{WIDTH}x{HEIGHT} 10-bit all-intra, first temporal unit",
             tb_path, tb_recon, 1)])
        mctf_launches, mctf_calls, _ = mctf_phase(counters, tmp)
    presets, surface, settings = presets_phase(pool, early)
    print("10-bit path launches (the 1080p all-intra encode + the 10-bit "
          "decodes):",
          json.dumps({k: tb_launches[k] + tb_dec_launches[k]
                      for k in counters}))
    print("10-bit path wrapper calls (the 1080p all-intra encode + the "
          "10-bit decodes):", json.dumps({k: tb_calls[k] + tb_dec_calls[k]
                                   for k in counters}))
    # the kernels line counts the launches of every main path: the
    # random-access encode, the two stripe dryruns, the decodes, the
    # all-intra MCTF encode, the surface jobs' encodes, the preset-4 to -2
    # jobs' encodes and the settings jobs' encodes (the per-fb rows count
    # every 8-bit preset job)
    new_jobs = [presets[spec[0]] for spec in PRESET_JOBS if spec[1] <= 4] \
        + list(settings.values())
    new_launches = {k: sum(r["all_launches"][k] for r in surface.values())
                    + sum(r["launches"][k] for r in new_jobs)
                    + mctf_launches[k] for k in counters}
    new_calls = {k: sum(r["all_calls"][k] for r in surface.values())
                 + sum(r["calls"][k] for r in new_jobs) + mctf_calls[k]
                 for k in counters}
    print("launches on the all-intra MCTF encode, the surface jobs' "
          "encodes, the preset-4 to -2 jobs and the settings jobs:",
          json.dumps(new_launches))
    print("launches on the settings jobs:", json.dumps(
        {k: sum(r["launches"][k] for r in settings.values())
         for k in counters}))
    launches = {k: ra_launches[k] + stripe_launches[k] + dec_launches[k]
                + new_launches[k] for k in counters}
    calls = {k: ra_calls[k] + stripe_calls[k] + dec_calls[k]
             + new_calls[k] for k in counters}
    if "--trace" in sys.argv:
        trace_phase(frames, ipp_frames, ra_frames,
                    sys.argv[sys.argv.index("--trace") + 1])

    sources = {"intra_decision": ("intra_decision.cu",
                                  "svt_av1_tpu/ops/omd.py:346"),
               "deblock": ("deblock.cu", "svt_av1_tpu/ops/dlf.py:359"),
               "cdef_direction": ("cdef_direction.cu",
                                  "svt_av1_tpu/ops/cdef.py:444"),
               "cdef_search": ("cdef_filter.cu",
                               "svt_av1_tpu/ops/cdef.py:645"),
               "cdef_apply": ("cdef_filter.cu",
                              "svt_av1_tpu/ops/cdef.py:726"),
               "me_coarse": ("me_coarse.cu", "svt_av1_tpu/ops/bme.py:42"),
               "me_refine": ("me_refine.cu", "svt_av1_tpu/ops/bme.py:207"),
               "subpel_refine16": ("subpel_refine.cu",
                                   "svt_av1_tpu/ops/bme.py:320"),
               "inter_select": ("inter_select.cu",
                                "svt_av1_tpu/pipeline/batched_inter.py:174"),
               "compound_joint": ("compound_joint.cu",
                                  "svt_av1_tpu/pipeline/batched_inter.py:119"),
               "block_var16": ("block_var16.cu",
                               "svt_av1_tpu/pipeline/tpl.py:28")}
    rows = []
    for name, (src, replaces) in sources.items():
        r = kres[name]
        b_ms, b_by = r["bound"]
        row = dict(
            name=name, route="cuda",
            source=f"svt_av1_tpu_torch/kernels/csrc/{src}",
            replaces=replaces, calls=calls[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, library_ms=r.get("library_ms"))
        # the design ceilings rest on assumed peaks, not on this run: they
        # are printed, not put in the kernels line
        ceiling = ""
        if "ceiling" in r:
            ceiling = (f", design ceiling {r['ceiling'][0]:.5f} ms "
                       f"({r['ceiling'][1]})")
        if "device_ms" in r:
            ceiling += f", device {r['device_ms']:.5f} ms"
        if r.get("library_ms") is not None:
            ceiling += f", library {r['library_ms']:.4f} ms"
        rows.append(row)
        print(f"{name}: {r['per_call']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by})"
              f"{ceiling}; "
              f"calls: {calls[name]} on the main paths ({ra_calls[name]} "
              f"on the random-access encode); "
              f"launches: {launches[name]} on the main paths = "
              f"{ra_launches[name]} on the {RA_FRAMES}-frame random-access "
              f"encode + {stripe_launches[name]} on the stripe dryruns + "
              f"{dec_launches[name]} on the decodes + {new_launches[name]} "
              f"on the surface, preset-4 to -2 and settings jobs; "
              f"{ipp_launches[name]} on "
              f"the {N_FRAMES}-frame low-delay P encode, {ai_launches[name]} "
              f"on the all-intra encode")
    # the 16-bit forms: their launches on the 10-bit encode that runs
    # them, K1's and K4's search's on the all-intra one, K5-K8's on the
    # low-delay P one
    ai10 = (tb_calls, tb_launches, f"{N_FRAMES}-frame 10-bit all-intra")
    ipp10 = (tbp_calls, tbp_launches, f"{N_FRAMES}-frame 10-bit low-delay P")
    ra10 = (tbr_calls, tbr_launches, f"{RA_FRAMES}-frame 10-bit random access")
    for name, base, (calls16, launches16, where) in (
            ("intra_decision_16bit", "intra_decision", ai10),
            ("cdef_search_16bit", "cdef_search", ai10),
            ("me_coarse_16bit", "me_coarse", ipp10),
            ("me_refine_16bit", "me_refine", ipp10),
            ("subpel_refine_16bit", "subpel_refine16", ipp10),
            ("inter_select_16bit", "inter_select", ipp10),
            ("compound_joint_16bit", "compound_joint", ra10),
            ("block_var16_16bit", "block_var16", ra10)):
        r = kres[base + "_16bit"]
        src, replaces = sources[base]
        b_ms, b_by = r["bound"]
        rows.append(dict(
            name=name, route="cuda",
            source=f"svt_av1_tpu_torch/kernels/csrc/{src}",
            replaces=replaces, calls=calls16[base],
            launches=launches16[base], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=b_ms, bound_by=b_by,
            library_ms=r.get("library_ms")))
        ceiling = (f", design ceiling {r['ceiling'][0]:.5f} ms "
                   f"({r['ceiling'][1]})") if "ceiling" in r else ""
        if r.get("library_ms") is not None:
            ceiling += f", library {r['library_ms']:.4f} ms"
        print(f"{name}: {r['per_call']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by})"
              f"{ceiling}, device {r['device_ms']:.5f} ms; calls / "
              f"launches on the {where} encode: "
              f"{calls16[base]} / {launches16[base]}")
        assert launches16[base] > 0, name
    # K4's per-fb forms (B16): their calls and launches on the preset jobs
    # that run them, the 8-bit forms on the 8-bit jobs, the 16-bit search
    # and the apply at bd 10 on the 10-bit preset-6 key frame
    for name, base, src, replaces, bd in (
            ("cdef_search_fb", "cdef_search_fb", "cdef_filter.cu",
             "svt_av1_tpu/ops/cdef.py:1004", 8),
            ("cdef_apply_multi", "cdef_apply_multi", "cdef_filter.cu",
             "svt_av1_tpu/ops/cdef.py:942", 8),
            ("cdef_search_fb_16bit", "cdef_search_fb", "cdef_filter.cu",
             "svt_av1_tpu/ops/cdef.py:1004", 10),
            ("cdef_apply_multi_bd10", "cdef_apply_multi", "cdef_filter.cu",
             "svt_av1_tpu/ops/cdef.py:942", 10)):
        r = kres[name]
        jobs = [(spec, presets[spec[0]]) for spec in PRESET_JOBS
                if spec[6] == bd]
        n_calls = sum(j["calls"][base] for _, j in jobs)
        n_launches = sum(j["launches"][base] for _, j in jobs)
        per_frame = {spec[0]: j["launches"][base] / spec[4]
                     for spec, j in jobs if spec[1] == 6}
        b_ms, b_by = r["bound"]
        rows.append(dict(
            name=name, route="cuda",
            source=f"svt_av1_tpu_torch/kernels/csrc/{src}",
            replaces=replaces, calls=n_calls, launches=n_launches,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
        print(f"{name}: {r['per_call']}: kernel {r['ms']:.4f} ms, device "
              f"{r['device_ms']:.5f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}); calls / launches on the {bd}-bit "
              f"preset jobs: {n_calls} / {n_launches}; launches per "
              f"preset-6 frame: {json.dumps(per_frame)}")
        assert n_launches > 0, name
    # the row's times are the JAX geometry's (4 stripes of 1280x64); its
    # error is the larger of both geometries' kernel - plain differences
    four = b14[4]
    b_ms, b_by = four["bound"]
    rows.append(dict(
        name="stripe_step", route="cuda",
        composed_of="composite: K1-K8 stripe modes",
        source="svt_av1_tpu_torch/parallel/stripes.py",
        replaces="__graft_entry__.py:74",
        calls=stripe_calls["stripe_step"],
        launches=stripe_launches["stripe_step"],
        max_abs_err=max(r["max_abs_err"] for r in b14.values()),
        ms=four["ms"], plain_ms=four["plain_ms"], bound_ms=b_ms,
        bound_by=b_by, library_ms=None))
    for n, r in b14.items():
        print(f"stripe_step: {n} stripes, the warm step's wall time "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, max |kernel "
              f"- plain| {r['max_abs_err']}, the sum of its kernels' bounds "
              f"{r['bound'][0]:.5f} ms ({r['bound'][1]})")
    print(f"stripe_step: {stripe_launches['stripe_step']} steps on the "
          f"stripe dryruns")
    print(f"chip_smoke.py wall time: {time.perf_counter() - script_t0:.3f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
