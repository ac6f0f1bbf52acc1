"""Command-line encoder/decoder app of the port (a copy of the JAX
package's app.py with one more option, ``--device``).

The analog of the reference's SvtAv1EncApp / SvtAv1DecApp
(Source/App/EncApp/EbAppMain.c, Source/App/DecApp/EbDecAppMain.c):

  python -m svt_av1_tpu_torch.app enc -i in.y4m -b out.ivf -q 40 [-n N] [--stat-report]
  python -m svt_av1_tpu_torch.app enc -i in.yuv -w 352 -h 288 --fps 30 -b out.ivf
  python -m svt_av1_tpu_torch.app enc -i in.y4m -b out.ivf --keyint -1 --pass 1
  python -m svt_av1_tpu_torch.app enc -i in.y4m -b out.ivf --keyint -1 --pass 2
  python -m svt_av1_tpu_torch.app dec -i in.ivf -o out.yuv [--md5]

Both run on CUDA unless ``--device cpu`` (or another torch device) is
given.
"""
from __future__ import annotations

import argparse
import sys
import time
from fractions import Fraction

import numpy as np

from .api import Decoder, Encoder
from .config import EncoderConfig, RateControlMode
from .io import IvfReader, IvfWriter, Y4MReader
from .io.y4m import VideoInfo, read_planar_frame
from .utils.metrics import frame_psnr, frame_ssim


def _enc(args) -> int:
    if args.input.endswith(".y4m"):
        reader = Y4MReader(args.input)
        info = reader.info
        frames = iter(reader)
    else:
        if not (args.width and args.height):
            print("raw yuv input needs -w/-h", file=sys.stderr)
            return 1
        info = VideoInfo(args.width, args.height,
                         Fraction(args.fps or 30), args.input_depth, "420")

        def yuv_iter():
            with open(args.input, "rb") as f:
                while True:
                    try:
                        yield read_planar_frame(f, info)
                    except EOFError:
                        return
        frames = yuv_iter()

    cfg = EncoderConfig(source_width=info.width, source_height=info.height,
                        qp=args.qp, frame_rate=info.frame_rate,
                        disable_dlf=args.no_dlf,
                        encoder_bit_depth=info.bit_depth,
                        intra_period_length=args.keyint,
                        enc_mode=args.preset,
                        rate_control_mode=RateControlMode(args.rc),
                        target_bit_rate=args.tbr,
                        tile_columns=args.tile_columns,
                        tile_rows=args.tile_rows)
    if args.enc_pass == 1:
        # first pass: open-loop analysis only (firstpass.c analog)
        from .pipeline.first_pass import analyze_frame, write_stats
        stats, prev = [], None
        n = 0
        t0 = time.time()
        for planes in frames:
            if args.frames and n >= args.frames:
                break
            stats.append(analyze_frame(planes[0], prev))
            prev = planes[0]
            n += 1
        write_stats(args.stats or (args.bitstream + ".stats"), stats)
        print(f"PASS1: analyzed {n} frames in {time.time() - t0:.2f}s -> "
              f"{args.stats or args.bitstream + '.stats'}")
        return 0

    two_pass_stats = None
    if args.enc_pass == 2:
        from .pipeline.first_pass import read_stats
        two_pass_stats = read_stats(args.stats or (args.bitstream + ".stats"))

    enc = Encoder(cfg, two_pass_stats=two_pass_stats, device=args.device)
    t0 = time.time()
    n = 0
    total_bytes = 0
    psnrs = []
    sources = []
    pts = 0
    with IvfWriter(args.bitstream, info.width, info.height,
                   info.frame_rate) as w:

        def emit(payloads):
            nonlocal pts, total_bytes
            for payload in payloads:
                w.write_frame(payload, pts=pts)
                total_bytes += len(payload)
                pts += 1

        for planes in frames:
            if args.frames and n >= args.frames:
                break
            sources.append(planes if args.stat_report else None)
            emit(enc.send_picture(planes))
            n += 1
        emit(enc.flush())
    ssims = []
    if args.stat_report:
        for d in sorted(enc.recon_by_display):
            p = frame_psnr(sources[d], enc.recon_by_display[d],
                           peak=(1 << info.bit_depth) - 1)
            s = frame_ssim(sources[d], enc.recon_by_display[d])
            psnrs.append(p)
            ssims.append(s)
            print(f"frame {d}: psnr Y {p[0]:.2f} U {p[1]:.2f} "
                  f"V {p[2]:.2f}  ssim {s:.4f}")
    dt = time.time() - t0
    fps = n / dt if dt else 0.0
    kbps = total_bytes * 8 * float(info.frame_rate) / max(n, 1) / 1000
    print(f"SUMMARY: {n} frames, {total_bytes} bytes ({kbps:.1f} kbps), "
          f"{dt:.2f}s, Average Speed: {fps:.3f} fps")
    if args.stat_report:
        # per-stage latency table (EncApp --enable-stat-report analog)
        print(enc.prof.format_report(n))
    if psnrs:
        avg = np.mean(np.array(psnrs), axis=0)
        print(f"Average PSNR Y {avg[0]:.3f}  U {avg[1]:.3f}  V {avg[2]:.3f}  "
              f"combined {avg[3]:.3f}  SSIM {np.mean(ssims):.4f}")
    return 0


def _dec(args) -> int:
    dec = Decoder(args.device)
    n = 0
    t0 = time.time()
    out = open(args.output, "wb") if args.output else None
    r = IvfReader(args.input)
    for payload, _pts in r:
        planes = dec.decode_frame(payload)
        if planes is None:
            continue
        if out:
            for p in planes:
                out.write(np.ascontiguousarray(p).tobytes())
        n += 1
    r.close()
    if out:
        out.close()
    dt = time.time() - t0
    print(f"SUMMARY: decoded {n} frames in {dt:.2f}s "
          f"({n / dt if dt else 0:.2f} fps)")
    if args.md5:
        print(f"MD5: {dec.md5.hexdigest()}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="svt_av1_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("enc", help="encode y4m/yuv -> ivf")
    e.add_argument("-i", "--input", required=True)
    e.add_argument("-b", "--bitstream", required=True)
    e.add_argument("-q", "--qp", type=int, default=50)
    e.add_argument("-n", "--frames", type=int, default=0)
    e.add_argument("-w", "--width", type=int, default=0)
    e.add_argument("--height", type=int, default=0)
    e.add_argument("--fps", type=int, default=0)
    e.add_argument("--no-dlf", action="store_true")
    e.add_argument("--stat-report", action="store_true")
    e.add_argument("--input-depth", type=int, default=8, choices=(8, 10),
                   help="raw-yuv input bit depth (y4m auto-detects)")
    e.add_argument("--keyint", type=int, default=-2,
                   help="intra period: -2 all-intra, -1 single key + IPP, "
                        "N = key frame every N+1 frames")
    e.add_argument("--rc", type=int, default=0, choices=(0, 1, 2),
                   help="0 CQP, 1 VBR, 2 CVBR")
    e.add_argument("--pass", dest="enc_pass", type=int, default=0,
                   choices=(0, 1, 2), help="2-pass: 1 analyze, 2 encode")
    e.add_argument("--stats", default="",
                   help="stats file for --pass 1/2")
    e.add_argument("--tbr", type=int, default=7_000_000,
                   help="target bitrate (bits/s) for --rc 1/2")
    e.add_argument("--tile-columns", type=int, default=0,
                   help="log2 tile columns")
    e.add_argument("--tile-rows", type=int, default=0,
                   help="log2 tile rows")
    e.add_argument("--preset", type=int, default=8,
                   help="enc-mode 0..13 (lower = slower/better)")
    e.add_argument("--device", default="cuda",
                   help="torch device of the kernels (cuda or cpu)")
    e.set_defaults(fn=_enc)

    d = sub.add_parser("dec", help="decode ivf -> yuv")
    d.add_argument("-i", "--input", required=True)
    d.add_argument("-o", "--output", default="")
    d.add_argument("--md5", action="store_true")
    d.add_argument("--device", default="cuda",
                   help="torch device of the kernels (cuda or cpu)")
    d.set_defaults(fn=_dec)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
