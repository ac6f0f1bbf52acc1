// K2 deblock: one direction of AV1 deblocking over a whole plane.
//
// Replaces the JAX package's whole-plane deblocking body
// (svt_av1_tpu/ops/dlf.py loop_filter_plane_full with _edge_filter_batch,
// _filter_line and _filter4; B8), run inside the fused filter chain
// (ops/filter_chain.py _jit_chain) and the standalone level search
// (ops/dlf.py _jit_search_apply; B13).
//
// What bounds it on the H100: memory traffic and latency.  A pass reads
// and writes each sample of a 1080p plane about once (a few MB) and does
// a few dozen integer operations per edge line; at 3.35 TB/s that is a
// few microseconds, so launch latency and the per-line branch on the
// filter size dominate.
//
// Design: out of place, one thread per 4-sample edge line (a row of one
// vertical edge, or a column of one horizontal edge).  The thread reads
// p6..p0 and q0..q6 from the plane the pass starts from (zero outside
// it, as the reference's 8-sample zero pad), applies the 4/6/8/14-tap
// filter its edge's apply/size masks select (edge_params, computed on
// the host), and writes to the output plane only the samples the filter
// changed.  Every edge thus reads un-filtered samples of its pass, and
// since the filters of neighbouring edges never modify the same sample,
// this equals the reference's "changed samples win" merge bit for bit.
// The output starts as a copy of the input (the wrapper clones it).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int sc(int x, int shift) {
  const int lo = -(128 << shift), hi = (128 << shift) - 1;
  return x < lo ? lo : (x > hi ? hi : x);
}

// p[0..6] = p6..p0 (p[6] is p0), q[0..6] = q0..q6; filters in place.
__device__ void filter4(int* p, int* q, bool mask, int thresh, int shift) {
  const int t80 = 128 << shift;
  const int p0 = p[6], p1 = p[5], q0 = q[0], q1 = q[1];
  const bool hev = abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
  const int ps1 = p1 - t80, ps0 = p0 - t80, qs0 = q0 - t80, qs1 = q1 - t80;
  int f = hev ? sc(ps1 - qs1, shift) : 0;
  f = mask ? sc(f + 3 * (qs0 - ps0), shift) : 0;
  const int f1 = sc(f + 4, shift) >> 3;
  const int f2 = sc(f + 3, shift) >> 3;
  const int oq0 = sc(qs0 - f1, shift) + t80;
  const int op0 = sc(ps0 + f2, shift) + t80;
  const int fo = !hev ? (f1 + 1) >> 1 : 0;
  const int oq1 = sc(qs1 - fo, shift) + t80;
  const int op1 = sc(ps1 + fo, shift) + t80;
  if (mask) {
    p[6] = op0;
    p[5] = op1;
    q[0] = oq0;
    q[1] = oq1;
  }
}

__device__ void filter_line(const int* p, const int* q, int* fp, int* fq,
                            int size, int blimit, int limit, int thresh,
                            int shift) {
  const int p0 = p[6], p1 = p[5], p2 = p[4], p3 = p[3];
  const int q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
  const bool edge = abs(p0 - q0) * 2 + abs(p1 - q1) / 2 <= blimit;
  if (size == 4) {
    const bool mask = abs(p1 - p0) <= limit && abs(q1 - q0) <= limit && edge;
    filter4(fp, fq, mask, thresh, shift);
    return;
  }
  const int fth = 1 << shift;
  if (size == 6) {
    const bool mask = abs(p2 - p1) <= limit && abs(p1 - p0) <= limit &&
                      abs(q1 - q0) <= limit && abs(q2 - q1) <= limit && edge;
    const bool flat = abs(p1 - p0) <= fth && abs(q1 - q0) <= fth &&
                      abs(p2 - p0) <= fth && abs(q2 - q0) <= fth;
    filter4(fp, fq, mask && !flat, thresh, shift);
    if (mask && flat) {
      fp[5] = (p2 * 3 + p1 * 2 + p0 * 2 + q0 + 4) >> 3;
      fp[6] = (p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + 4) >> 3;
      fq[0] = (p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + 4) >> 3;
      fq[1] = (p0 + q0 * 2 + q1 * 2 + q2 * 3 + 4) >> 3;
    }
    return;
  }
  const bool mask = abs(p3 - p2) <= limit && abs(p2 - p1) <= limit &&
                    abs(p1 - p0) <= limit && abs(q1 - q0) <= limit &&
                    abs(q2 - q1) <= limit && abs(q3 - q2) <= limit && edge;
  const bool flat = abs(p1 - p0) <= fth && abs(q1 - q0) <= fth &&
                    abs(p2 - p0) <= fth && abs(q2 - q0) <= fth &&
                    abs(p3 - p0) <= fth && abs(q3 - q0) <= fth;
  filter4(fp, fq, mask && !flat, thresh, shift);
  bool sel8 = mask && flat;
  if (size == 14) {
    const int p4 = p[2], p5 = p[1], p6 = p[0];
    const int q4 = q[4], q5 = q[5], q6 = q[6];
    const bool flat2 = abs(p6 - p0) <= fth && abs(p5 - p0) <= fth &&
                       abs(p4 - p0) <= fth && abs(q4 - q0) <= fth &&
                       abs(q5 - q0) <= fth && abs(q6 - q0) <= fth;
    if (sel8 && flat2) {
      fp[1] = (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0 + 8) >> 4;
      fp[2] = (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1 +
               8) >> 4;
      fp[3] = (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 +
               q2 + 8) >> 4;
      fp[4] = (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 +
               q2 + q3 + 8) >> 4;
      fp[5] = (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 +
               q2 + q3 + q4 + 8) >> 4;
      fp[6] = (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 +
               q3 + q4 + q5 + 8) >> 4;
      fq[0] = (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 +
               q4 + q5 + q6 + 8) >> 4;
      fq[1] = (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 +
               q5 + q6 * 2 + 8) >> 4;
      fq[2] = (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 +
               q6 * 3 + 8) >> 4;
      fq[3] = (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 +
               q6 * 4 + 8) >> 4;
      fq[4] = (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5 +
               8) >> 4;
      fq[5] = (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7 + 8) >> 4;
      return;
    }
  }
  if (sel8) {
    fp[4] = (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3;
    fp[5] = (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3;
    fp[6] = (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3;
    fq[0] = (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3;
    fq[1] = (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3;
    fq[2] = (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3;
  }
}

// vertical: lines are rows y < 4*y4max, edges e < x4max-1 at x = 4(e+1),
//   masks [y4max, x4max-1];
// horizontal: lines are columns x < 4*x4max, edges e < y4max-1 at
//   y = 4(e+1), masks [y4max-1, x4max].
__global__ void deblock_pass_kernel(const int* __restrict__ in,
                                    int* __restrict__ out,
                                    const uint8_t* __restrict__ apply,
                                    const uint8_t* __restrict__ fsize,
                                    int H, int W, int vertical, int x4max,
                                    int y4max, int blimit, int limit,
                                    int thresh, int shift) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  int line, e, n_lines, mi;
  if (vertical) {
    const int n_e = x4max - 1;
    n_lines = 4 * y4max;
    e = idx % n_e;
    line = idx / n_e;
    if (line >= n_lines) return;
    mi = (line >> 2) * n_e + e;
  } else {
    n_lines = 4 * x4max;
    line = idx % n_lines;
    e = idx / n_lines;
    if (e >= y4max - 1) return;
    mi = e * x4max + (line >> 2);
  }
  if (!apply[mi]) return;
  const int size = fsize[mi];
  if (size != 4 && size != 6 && size != 8 && size != 14) return;
  // sample k of the line runs 4e-3+k (p6..p0, k < 7) and 4e+4+k (q0..q6)
  const int base = 4 * e - 3;
  const int lim_pos = vertical ? W : H;
  const int lim_out = vertical ? 4 * x4max : 4 * y4max;
  int p[7], q[7], fp[7], fq[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const int pp = base + k, qp = 4 * e + 4 + k;
    const int pi = vertical ? line * W + pp : pp * W + line;
    const int qi = vertical ? line * W + qp : qp * W + line;
    p[k] = (pp >= 0 && pp < lim_pos) ? in[pi] : 0;
    q[k] = (qp < lim_pos) ? in[qi] : 0;
    fp[k] = p[k];
    fq[k] = q[k];
  }
  filter_line(p, q, fp, fq, size, blimit, limit, thresh, shift);
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const int pp = base + k, qp = 4 * e + 4 + k;
    if (fp[k] != p[k] && pp >= 0 && pp < lim_out)
      out[vertical ? line * W + pp : pp * W + line] = fp[k];
    if (fq[k] != q[k] && qp < lim_out)
      out[vertical ? line * W + qp : qp * W + line] = fq[k];
  }
}

}  // namespace

// in/out: int32 [H, W] (out a copy of in); apply/fsize: uint8 edge masks
// (see the kernel); thresholds already scaled by the bit depth.
extern "C" int deblock_pass_launch(const void* in, void* out,
                                   const void* apply, const void* fsize,
                                   int H, int W, int vertical, int x4max,
                                   int y4max, int blimit, int limit,
                                   int thresh, int shift, void* stream) {
  const long n = vertical ? (long)(x4max - 1) * 4 * y4max
                          : (long)(y4max - 1) * 4 * x4max;
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads);
  deblock_pass_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)in, (int*)out, (const uint8_t*)apply,
      (const uint8_t*)fsize, H, W, vertical, x4max, y4max, blimit, limit,
      thresh, shift);
  return (int)cudaGetLastError();
}
