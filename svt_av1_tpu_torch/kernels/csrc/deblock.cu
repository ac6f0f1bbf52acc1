// K2 deblock: AV1 deblocking of one plane, both directions in one launch.
//
// Replaces the JAX package's whole-plane deblocking body
// (svt_av1_tpu/ops/dlf.py loop_filter_plane_full with _edge_filter_batch,
// _filter_line and _filter4; B8), run inside the fused filter chain
// (ops/filter_chain.py _jit_chain) and the standalone level search
// (ops/dlf.py _jit_search_apply; B13).
//
// What bounds it on the H100: memory traffic.  The call reads the int32
// plane once and writes it once (17.7 MB at 1920x1152 luma, 5.3 us at
// 3.35 TB/s) and does a few dozen integer operations per edge line.
//
// Design: a block owns a 64x64 tile of the output.  It loads the tile
// with a halo of 12 samples on each side (zero outside the plane, as the
// reference's zero pad) into shared memory as 16-bit samples: a vertical
// edge at x reads x-7..x+6 and changes x-6..x+5, so the edges that change
// the tile's columns read at most 12 beyond it, and the same holds for
// rows.  The vertical pass runs on every row of the halo'd region for the
// edges that change the tile's columns (it is row-local); the horizontal
// pass reads its result on the tile's columns.  A warp takes 32 lines of
// one edge (rows of a vertical edge, columns of a horizontal one), so
// its lanes share the edge's column (row) and, within each 4-line group,
// its filter size; the vertical lanes read 8 aligned words of their row
// (an odd word stride keeps the 32 rows on distinct banks).
//
// Each pass reads one shared buffer and writes the samples its edges
// change into a second one, as (rank << 16 | value) with a shared
// atomicMax.  The rank is the reference's merge order ("changed samples
// win", dlf.py _merge): of the edges that can change sample 4u + r, the
// q side of edge u - 2 wins over the p side of edge u + 1, which wins
// over the q side of edge u - 1, which wins over the p side of edge u
// (an edge e sits at x = 4(e + 1)); so a p sample k of p6..p0 has rank 3
// for k < 3 and 1 otherwise, a q sample k of q0..q6 rank 2 for k < 4 and
// 4 otherwise.  Masks derived from whole transform blocks never let two
// edges change one sample; the rank makes the result the reference's for
// any masks.  Each output sample is written once, coalesced, from the
// second pass's buffer.  The input plane is not modified.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 64;                 // output tile
constexpr int HALO = 12;
constexpr int RG = T + 2 * HALO;      // region side, 88
constexpr int AS = RG + 2;            // int16 stride: 45 words, odd
constexpr int BS = T + 1;             // int32 stride of the vertical output
constexpr int NE = T / 4 + 3;         // edges that change the tile: 19
// line groups per thread when listing them
template <int kThreads>
constexpr int kItemsV = ((RG / 4) * NE + kThreads - 1) / kThreads;
template <int kThreads>
constexpr int kItemsH = (NE * (T / 4) + kThreads - 1) / kThreads;

struct Pass {
  const uint8_t* apply;
  const uint8_t* fsize;
  int on, blimit, limit, thresh;
};

struct Args {
  const int* in;
  int* out;
  int H, W, x4max, y4max, shift;
  int vec;  // 16-byte loads and stores: W % 4 == 0, both planes aligned
  Pass v, h;
};

__device__ __forceinline__ int sc(int x, int shift) {
  const int lo = -(128 << shift), hi = (128 << shift) - 1;
  return x < lo ? lo : (x > hi ? hi : x);
}

// p[0..6] = p6..p0 (p[6] is p0), q[0..6] = q0..q6; filters in place.
__device__ __forceinline__ void filter4(int* p, int* q, bool mask,
                                        int thresh, int shift) {
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

__device__ __forceinline__ void filter_line(const int* p, const int* q,
                                            int* fp, int* fq, int size,
                                            int blimit, int limit,
                                            int thresh, int shift) {
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
  const bool sel8 = mask && flat;
  if (size == 14 && sel8) {
    const int p4 = p[2], p5 = p[1], p6 = p[0];
    const int q4 = q[4], q5 = q[5], q6 = q[6];
    const bool flat2 = abs(p6 - p0) <= fth && abs(p5 - p0) <= fth &&
                       abs(p4 - p0) <= fth && abs(q4 - q0) <= fth &&
                       abs(q5 - q0) <= fth && abs(q6 - q0) <= fth;
    if (flat2) {
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

// the reference's merge order of the writers of a sample (see the top)
__device__ __forceinline__ int rank_p(int k) { return k < 3 ? 3 : 1; }
__device__ __forceinline__ int rank_q(int k) { return k < 4 ? 2 : 4; }

// one edge line of size class cls (filter size 4, 6, 8, 14): filter p
// (p6..p0) and q (q0..q6) and hand each changed sample k (0..13, p6
// first) to put(k, rank << 16 | value); only the samples the size can
// change are compared (p1..q1; p2..q2 for 8 taps; p5..q5 for 14)
template <typename Put>
__device__ __forceinline__ void edge_line(const int* p, const int* q,
                                          int cls, const Pass& ps,
                                          int shift, Put put) {
  int fp[7], fq[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    fp[k] = p[k];
    fq[k] = q[k];
  }
  const int size = cls == 0 ? 4 : cls == 1 ? 6 : cls == 2 ? 8 : 14;
  filter_line(p, q, fp, fq, size, ps.blimit, ps.limit, ps.thresh, shift);
  const int first = cls == 3 ? 1 : cls == 2 ? 4 : 5;  // p side, of 0..6
#pragma unroll
  for (int k = 1; k < 7; ++k) {
    if (k >= first && fp[k] != p[k]) put(k, (rank_p(k) << 16) | fp[k]);
    if (k - 1 < 7 - first && fq[k - 1] != q[k - 1])
      put(6 + k, (rank_q(k - 1) << 16) | fq[k - 1]);
  }
}

// the filter sizes' classes 0..3 (4, 6, 8, 14); -1 for no filter
__device__ __forceinline__ int size_class(int s) {
  return s == 4 ? 0 : s == 6 ? 1 : s == 8 ? 2 : s == 14 ? 3 : -1;
}

// kThreads 256 (5 blocks an SM, the 540 tiles of a 1920x1152 plane at
// once) or 512 for planes of fewer tiles than two an SM, where one
// block's critical path sets the time
template <int kThreads>
__global__ void __launch_bounds__(kThreads, 1280 / kThreads)
    deblock_kernel(const Args a) {
  constexpr int kWarps = kThreads / 32;
  // a: the input region (int16), later the horizontal pass's output c
  __shared__ __align__(16) int16_t a_buf[T * T * 2];
  __shared__ int b[RG * BS];          // the vertical pass's output
  // the applied line groups by filter size: (group | size class << 10)
  __shared__ uint16_t list_v[(RG / 4) * NE], list_h[NE * (T / 4)];
  __shared__ int count_v[4], count_h[4];
  uint32_t* region_w = reinterpret_cast<uint32_t*>(a_buf);
  int* c = reinterpret_cast<int*>(a_buf);
  const int x0 = blockIdx.x * T, y0 = blockIdx.y * T;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int xv = 4 * a.x4max, yv = 4 * a.y4max;  // the visible 4x4 grid
  if (t < 4) count_v[t] = count_h[t] = 0;
  __syncthreads();

  // the region as rows of 4-sample groups (x0 - HALO is a multiple of 4):
  // 16-byte loads where the group lies in the plane, several in flight
#pragma unroll 4
  for (int k = t; k < RG * (RG / 4); k += kThreads) {
    const int i = k / (RG / 4), q = k - i * (RG / 4);
    const int y = y0 - HALO + i, x = x0 - HALO + 4 * q;
    int4 v = make_int4(0, 0, 0, 0);
    if (y >= 0 && y < a.H) {
      const int* row = a.in + (size_t)y * a.W;
      if (a.vec && x >= 0 && x + 3 < a.W) {
        v = __ldg(reinterpret_cast<const int4*>(row + x));
      } else {
        if (x >= 0 && x < a.W) v.x = __ldg(row + x);
        if (x + 1 >= 0 && x + 1 < a.W) v.y = __ldg(row + x + 1);
        if (x + 2 >= 0 && x + 2 < a.W) v.z = __ldg(row + x + 2);
        if (x + 3 >= 0 && x + 3 < a.W) v.w = __ldg(row + x + 3);
      }
    }
    region_w[i * (AS / 2) + 2 * q] = (v.x & 0xffff) | ((uint32_t)v.y << 16);
    region_w[i * (AS / 2) + 2 * q + 1] =
        (v.z & 0xffff) | ((uint32_t)v.w << 16);
    if (4 * q >= HALO && 4 * q < HALO + T) {
      int* brow = b + i * BS + 4 * q - HALO;
      brow[0] = v.x;
      brow[1] = v.y;
      brow[2] = v.z;
      brow[3] = v.w;
    }
  }
  // the applied edge lines in groups of 4 (vertical: a 4-row group of the
  // region x an edge; horizontal: an edge x a 4-column group of the
  // tile), counted per filter size, then listed size by size so that a
  // warp's 8 groups share their size (but where one size's list ends)
  int item_v[kItemsV<kThreads>], item_h[kItemsH<kThreads>];
#pragma unroll
  for (int n = 0; n < kItemsV<kThreads>; ++n) {
    const int k = t + n * kThreads;
    const int i = k / NE, ei = k - i * NE;
    const int y4 = (y0 - HALO) / 4 + i, e = (x0 - 4 + 4 * ei) / 4 - 1;
    int size = 0;
    if (k < (RG / 4) * NE && a.v.on && y4 >= 0 && y4 < a.y4max && e >= 0 &&
        e < a.x4max - 1) {
      const int mi = y4 * (a.x4max - 1) + e;
      const int on = a.v.apply[mi], fs = a.v.fsize[mi];  // both in flight
      size = on ? fs : 0;
    }
    const int cls = size_class(size);
    item_v[n] = cls < 0 ? -1
                        : (k | cls << 10 | atomicAdd(&count_v[cls], 1) << 12);
  }
#pragma unroll
  for (int n = 0; n < kItemsH<kThreads>; ++n) {
    const int k = t + n * kThreads;
    const int ei = k / (T / 4), g = k - ei * (T / 4);
    const int e = (y0 - 4 + 4 * ei) / 4 - 1, x4 = x0 / 4 + g;
    int size = 0;
    if (k < NE * (T / 4) && a.h.on && x4 < a.x4max && e >= 0 &&
        e < a.y4max - 1) {
      const int mi = e * a.x4max + x4;
      const int on = a.h.apply[mi], fs = a.h.fsize[mi];
      size = on ? fs : 0;
    }
    const int cls = size_class(size);
    item_h[n] = cls < 0 ? -1
                        : (k | cls << 10 | atomicAdd(&count_h[cls], 1) << 12);
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < kItemsV<kThreads>; ++n)
    if (item_v[n] >= 0) {
      const int cls = item_v[n] >> 10 & 3;
      int at = item_v[n] >> 12;
      for (int j = 0; j < cls; ++j) at += count_v[j];
      list_v[at] = (uint16_t)(item_v[n] & 0xfff);
    }
#pragma unroll
  for (int n = 0; n < kItemsH<kThreads>; ++n)
    if (item_h[n] >= 0) {
      const int cls = item_h[n] >> 10 & 3;
      int at = item_h[n] >> 12;
      for (int j = 0; j < cls; ++j) at += count_h[j];
      list_h[at] = (uint16_t)(item_h[n] & 0xfff);
    }
  __syncthreads();
  const int n_v = count_v[0] + count_v[1] + count_v[2] + count_v[3];
  const int n_h = count_h[0] + count_h[1] + count_h[2] + count_h[3];

  // vertical pass: a lane takes row 4i + (lane & 3) of the region and
  // the edge x = x0 - 4 + 4 ei of its group
  for (int task = warp; task * 8 < n_v; task += kWarps) {
    const int at = task * 8 + (lane >> 2);
    if (at >= n_v) continue;
    const int it = list_v[at], cls = it >> 10;
    const int i = (it & 1023) / NE, ei = (it & 1023) - i * NE;
    const int r = 4 * i + (lane & 3), x = x0 - 4 + 4 * ei;
    // region columns x - 8 .. x + 7 as 8 aligned words
    const uint32_t* w = region_w + r * (AS / 2) + 2 * ei;
    int s[16];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t v = w[k];
      s[2 * k] = (int)(int16_t)(v & 0xffffu);
      s[2 * k + 1] = (int)(int16_t)(v >> 16);
    }
    int* brow = b + r * BS;
    edge_line(s + 1, s + 8, cls, a.v, a.shift, [&](int k, int pv) {
      const int col = x - 7 + k;          // p6 at x - 7, q0 at x
      if (col >= x0 && col < x0 + T && col < xv)
        atomicMax(brow + col - x0, pv);
    });
  }
  __syncthreads();
  for (int k = t; k < T * T; k += kThreads)
    c[k] = b[(k / T + HALO) * BS + k % T] & 0xffff;
  __syncthreads();

  // horizontal pass: a lane takes column 4g + (lane & 3) of the tile and
  // the edge y = y0 - 4 + 4 ei of its group, on the vertical pass's output
  for (int task = warp; task * 8 < n_h; task += kWarps) {
    const int at = task * 8 + (lane >> 2);
    if (at >= n_h) continue;
    const int it = list_h[at], cls = it >> 10;
    const int ei = (it & 1023) / (T / 4), g = (it & 1023) - ei * (T / 4);
    const int cc = 4 * g + (lane & 3), y = y0 - 4 + 4 * ei;
    const int* col = b + (y - y0 + HALO) * BS + cc;
    int p[7], q[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      p[k] = col[(k - 7) * BS] & 0xffff;
      q[k] = col[k * BS] & 0xffff;
    }
    edge_line(p, q, cls, a.h, a.shift, [&](int k, int pv) {
      const int row = y - 7 + k;
      if (row >= y0 && row < y0 + T && row < yv)
        atomicMax(c + (row - y0) * T + cc, pv);
    });
  }
  __syncthreads();
  if (a.vec && y0 + T <= a.H && x0 + T <= a.W) {
    for (int k = t; k < T * T / 4; k += kThreads) {
      const int i = k / (T / 4), q = k - i * (T / 4);
      const int* ck = c + i * T + 4 * q;
      *reinterpret_cast<int4*>(a.out + (size_t)(y0 + i) * a.W + x0 + 4 * q) =
          make_int4(ck[0] & 0xffff, ck[1] & 0xffff, ck[2] & 0xffff,
                    ck[3] & 0xffff);
    }
  } else {
    for (int k = t; k < T * T; k += kThreads) {
      const int y = y0 + k / T, x = x0 + k % T;
      if (y < a.H && x < a.W) a.out[(size_t)y * a.W + x] = c[k] & 0xffff;
    }
  }
}

}  // namespace

// in/out: int32 [H, W] planes, distinct (out takes every sample), samples
// in [0, 32767]; apply_*/fsize_*: uint8 edge masks of edge_params
// (vertical [y4max, x4max - 1], horizontal [y4max - 1, x4max]); *_on: 0
// skips that direction (level 0); thresholds already scaled by the bit
// depth, shift = bd - 8.  Returns the CUDA error of the launch.
extern "C" int deblock_launch(const void* in, void* out, const void* apply_v,
                              const void* fsize_v, const void* apply_h,
                              const void* fsize_h, int H, int W, int x4max,
                              int y4max, int v_on, int v_blimit, int v_limit,
                              int v_thresh, int h_on, int h_blimit,
                              int h_limit, int h_thresh, int shift,
                              void* stream) {
  if (H <= 0 || W <= 0 || 4 * x4max > W || 4 * y4max > H || shift < 0 ||
      shift > 4 || in == out)
    return (int)cudaErrorInvalidValue;
  const int vec = W % 4 == 0 && ((uintptr_t)in | (uintptr_t)out) % 16 == 0;
  Args a{(const int*)in, (int*)out, H, W, x4max, y4max, shift, vec,
         Pass{(const uint8_t*)apply_v, (const uint8_t*)fsize_v,
              v_on && x4max > 1, v_blimit, v_limit, v_thresh},
         Pass{(const uint8_t*)apply_h, (const uint8_t*)fsize_h,
              h_on && y4max > 1, h_blimit, h_limit, h_thresh}};
  const dim3 grid((W + T - 1) / T, (H + T - 1) / T);
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return (int)cudaErrorInvalidDevice;
  if (!sms[dev] && cudaDeviceGetAttribute(&sms[dev],
                                          cudaDevAttrMultiProcessorCount,
                                          dev) != cudaSuccess)
    return (int)cudaGetLastError();
  if ((int)(grid.x * grid.y) < 2 * sms[dev])
    deblock_kernel<512><<<grid, 512, 0, (cudaStream_t)stream>>>(a);
  else
    deblock_kernel<256><<<grid, 256, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
