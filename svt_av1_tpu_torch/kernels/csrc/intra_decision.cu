// K1 intra_decision: open-loop intra mode decision over the block grids of
// one plane, all requested shapes in one launch.
//
// Replaces the JAX package's jitted decision program
// (svt_av1_tpu/ops/omd.py:346 _jitted -> intra_decision_arrays): the 13
// batched intra predictors (grid_edges, predict_mode, _dir_matrices; B7)
// and the residual cost model (shape_costs :286, _quant_maps :268; B6
// intra).
//
// What bounds it on the H100: arithmetic.  Every mode of every block
// takes two DCT products (h*w*(h+w) multiply-adds), 14.7 GFLOP per
// 1920x1152 plane over the 7 shapes, against 2 MB of input (0.22 ms at
// the float32 rate; the products' TF32 passes below take 0.076 ms at the
// tensor cores' rate); and every coefficient (2.2 M pixels x 13 modes x
// 7 shapes, about 200 M) goes through the quantizer model.  Measured, the
// kernel is bound by neither: it is latency-bound, a chain of small
// dependent steps per mode (residuals, two products through shared
// memory, the quantizer, warp sums) with 16 warps per SM to hide it
// (PERF.md).
//
// Design:
// * One launch covers every shape of the plane.  A CTA of 4 warps takes
//   one shape; each warp takes 1024 pixels' worth of blocks of it (one
//   32x32 block, or sixteen 8x8 ones, ...), one block at a time, with no
//   CTA barrier after the start.  The output is packed: int32 [2, n],
//   row 0 the modes and row 1 the costs' float32 bits, shapes in the
//   order given and blocks in raster order within a shape, so the host
//   copies one tensor per frame.
// * The DCT matrices come split for 3xTF32 and in the tensor cores'
//   fragment order (one float4 per lane per 8x8 tile: big and small
//   halves of both rows; host-built, ops/omd.py _k1_fragments), 10.5 KB
//   that every lane reads as one 16-byte load through L1, where they
//   stay; shared memory holds the warps' buffers, the smooth weights and
//   a table of log2f(1 + q) for q < 256 (computed by log2f).
// * Per block a warp builds the above/left edges (edge replication =
//   clamped reads, as pad_plane's mode="edge"; in stripe mode the row
//   above the stripe and the halo rows below it are read where the whole
//   frame's plane would be, see sample()), then walks the 13 modes in
//   groups of G = 1 mode (G = 2 when a side is 8, so that every product
//   has 16-row tiles): the lanes predict their pixels, one pixel loop
//   per mode, all in integers (DC/V/H/Paeth/smooth directly; the six
//   directional modes through a per-(mode, shape) table of at most two
//   taps per pixel whose weights sum to 32, exactly the float32 matmul
//   the TPU ran, read through L1) and store the residuals;
//   the two DCT products run on the tensor cores, mma.sync m16n8k8 TF32,
//   with the stacked modes' rows as M, one 16-row m-tile at a time:
//     T^T = R^T . Dh^T   (M = G*w rows (mode, column), K = N = h): the
//       residuals are integers below 256 in magnitude, exact in TF32, so
//       two passes (R . big + R . small) give the float32 product;
//     C = T . Dw^T       (M = G*h rows (mode, row), K = N = w): 3xTF32,
//       T = big + small with cvt.rna.tf32.f32, small . big + big . small
//       + big . big, float32 accumulation.  TF32 itself stays off.
//   The second product's accumulators feed the quantizer model
//   (cost_model.cuh, shared with K8) in registers: a coefficient inside
//   the dead zone adds its square where it is, the others go to a
//   per-warp queue that the lanes share, so the division and log2 run
//   once per coded coefficient, not once per slot that any lane codes.
//   The SSE (and the log2 terms, where any were queued) are summed over
//   the warp by xor shuffles, a mode pair in one butterfly, the nonzero
//   count by ballots; every lane holds the block's cost and the argmin
//   stays in registers: a mode takes over only on a strictly smaller
//   cost, in mode order 0..12 (the reference's tie rule).
// * Near-boundary coefficients (cost_model.cuh near_margin; the rule of
//   ops/omd.py decide_near_boundary): the queue keeps each entry's
//   position beside its value (int16, in the transform rows that product
//   2 has read), and also takes the
//   coefficients within delta of the dead zone; the drain tests the coded
//   ones' quotients against the rounding points and moves the positions
//   of the near ones into the free transform buffer; the warp then
//   recomputes each such coefficient in float64 FMA from the residual,
//   predicted again pixel by pixel (integer, so exact), and the float32
//   DCT entries (big + small of the fragments), and decides it from that
//   value rounded to float32, as the plain version does.  That pass is
//   cold code (0.02% of the coded coefficients at qindex 160): one
//   function for every shape, out of line, so that neither the hot
//   path's registers nor its code size carry it.  delta comes from the
//   block's sum |R| (one warp reduction per mode).
// * Two instantiations on the sample type: uint8_t for 8-bit planes and
//   uint16_t for 10-bit ones (int16 tensors holding [0, 1024)).  The
//   arithmetic is the same: a 10-bit residual, |R| <= 1023, is still an
//   integer exact in TF32's 11-bit significand, so product 1 keeps its
//   two passes; the DC sum, the smooth weights and Paeth stay far inside
//   int32.  What differs is storage: the edges in shared memory take the
//   sample type (2 * kEdge bytes more per warp at 16 bits), and a lane
//   keeps its source pixels packed SrcPack<T>::kPer to a register (three
//   10-bit samples at 16 bits: the wrapper takes bd 10 only).
#include <cuda_runtime.h>
#include <stdint.h>

#include "cost_model.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxShapes = 7;
constexpr int kModes = 13;
constexpr int kSmw = 128;               // smooth weight table entries
constexpr int kEdge = 68;               // >= w + h + 1 at 32x32
constexpr int kRStride = 40;            // residual rows: conflict-free A loads
constexpr int kTStride = 36;            // transform rows: conflict-free A loads
constexpr int kRFloats = 32 * kRStride; // G*h <= 32 rows
constexpr int kTFloats = 32 * kTStride;
// the queue's positions (int16) live in the transform rows that product
// 2 has read: an m-tile's entries fill at most its own 16 rows
constexpr int kQPos = 1024;             // G*h*w <= 1024
// per warp: residuals, transform rows, then the above / left edges of
// samples of type T
template <typename T>
__host__ __device__ constexpr int warp_bytes() {
  return (4 * (kRFloats + kTFloats) + 2 * kEdge * (int)sizeof(T) + 15) / 16 *
         16;
}
template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(int) * (kSmw + cost_model::kLog2Table) +
         kWarps * warp_bytes<T>();
}

// A lane's source pixels, kPer to a 32-bit register at kBits each: four
// 8-bit samples, or three 10-bit ones from 16-bit words (the 16-bit form
// takes 10-bit video only, samples in [0, 1024)).  Two 16-bit samples per
// register would keep 16 registers live in the 32x32 shape against 8 at
// 8 bits, and ptxas spills 192 bytes more per thread for them; three
// 10-bit ones keep 11, and the 16-bit form spills about what the 8-bit
// form does (PERF.md).
template <typename T>
struct SrcPack;
template <>
struct SrcPack<uint8_t> {
  static constexpr int kPer = 4, kBits = 8;
};
template <>
struct SrcPack<uint16_t> {
  static constexpr int kPer = 3, kBits = 10;
};

// Per-launch shape set, passed by value.
struct Shapes {
  int n;                      // number of shapes
  int n_total;                // blocks over all shapes
  int w[kMaxShapes], h[kMaxShapes];
  int ncols[kMaxShapes], nblocks[kMaxShapes];
  int cta0[kMaxShapes + 1];   // first CTA of each shape
  int out0[kMaxShapes];       // first output slot of each shape
  int tap0[kMaxShapes];        // each shape's tap table in taps
  float zbin_dc[kMaxShapes], zbin_ac[kMaxShapes];
  float rnd_dc[kMaxShapes], rnd_ac[kMaxShapes];
  float step_dc[kMaxShapes], step_ac[kMaxShapes];
};

template <typename T>
struct Plane {
  const T* px;
  const T* above;                     // row above a stripe (or null)
  const T* halo;                      // rows below a stripe (or null)
  int buf_h, buf_w, n_halo;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Sample (r, c) of the plane as the prediction edges read it: the column
// clamped to [0, buf_w); row -1 from the row above the stripe when one
// is given (above), rows [buf_h, buf_h + n_halo) from the halo rows below
// it; every other row outside the plane repeats its nearest edge row.
template <typename T>
__device__ __forceinline__ int sample(const Plane<T>& p, int r, int c) {
  c = clampi(c, 0, p.buf_w - 1);
  if (r < 0) return (r == -1 && p.above) ? p.above[c] : p.px[c];
  if (r < p.buf_h) return p.px[r * p.buf_w + c];
  if (r < p.buf_h + p.n_halo) return p.halo[(r - p.buf_h) * p.buf_w + c];
  return p.px[(p.buf_h - 1) * p.buf_w + c];
}

__device__ __forceinline__ uint32_t tf32_big(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a . b on the tensor cores: A 16x8 (row), B 8x8 (col), TF32 in,
// float32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Sum of v[0..G) over the warp, left in every lane.  A pair goes through
// one butterfly: the first step swaps halves, so lanes 0-15 go on with
// v[0] and lanes 16-31 with v[1].
template <int G>
__device__ __forceinline__ void warp_sum(float (&v)[G], int lane) {
  if (G == 1) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], off));
    return;
  }
  const bool up = lane & 16;
  float keep = up ? v[G - 1] : v[0];
  keep = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, up ? v[0] : v[G - 1],
                                         16));
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    keep = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, keep, off));
  const float other = __shfl_xor_sync(0xffffffffu, keep, 16);
  v[0] = up ? other : keep;
  v[G - 1] = up ? keep : other;
}

__device__ __forceinline__ constexpr int frag_offset(int s) {
  return s == 8 ? 0 : (s == 16 ? 2 * 64 : 2 * (64 + 256));
}

__device__ __forceinline__ int paeth(int av, int lv, int tl) {
  const int base = av + lv - tl;
  const int pa = abs(base - av), pl = abs(base - lv), ptl = abs(base - tl);
  return (pa <= pl && pa <= ptl) ? av : (pl <= ptl ? lv : tl);
}

// Directional prediction of one pixel from its packed taps (ops/omd.py
// _dir_taps: sel | i0 << 1 | i1 << 8 | w0 << 15 | w1 << 21): at most two
// samples of one edge (sel 1 = left), weights summing to 32, exactly
// the float32 matmul of _dir_matrices that the TPU ran.
template <typename T>
__device__ __forceinline__ int dir_tap(int t, const T* above, const T* left) {
  const T* e = (t & 1) ? left : above;
  const int i0 = (t >> 1) & 127, i1 = (t >> 8) & 127;
  const int w0 = (t >> 15) & 63, w1 = (t >> 21) & 63;
  return (w0 * e[i0] + w1 * e[i1] + 16) >> 5;
}

// Residuals src - pred of mode m (kModes and above: zero) for this lane's
// pixels p = i * 32 + lane, into Rg[r][c]; one pixel loop per mode.
// taps: this shape's tap tables, [6, H*W] int32.
// Returns this lane's sum of |residual|.
template <int W, int H, typename T>
__device__ __forceinline__ int residuals(int m, float* Rg,
                                         const uint32_t* spk, int lane,
                                         int dc, const T* above, const T* left,
                                         const int* smw,
                                         const int* __restrict__ taps) {
  constexpr int NP = W * H / 32;
  constexpr int PER = SrcPack<T>::kPer, BITS = SrcPack<T>::kBits;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  int sabs = 0;
#define K1_PIXELS(PRED)                                                    \
  _Pragma("unroll") for (int i = 0; i < NP; ++i) {                         \
    const int p = i * 32 + lane, r = p / W, c = p % W;                     \
    const int src = (int)((spk[i / PER] >> ((i % PER) * BITS)) & MASK);    \
    const int rv = src - (PRED);                                           \
    Rg[r * kRStride + c] = (float)rv;                                      \
    sabs += abs(rv);                                                       \
  }
  switch (m) {
    case 0:
      K1_PIXELS(dc)
      break;
    case 1:
      K1_PIXELS(above[1 + c])
      break;
    case 2:
      K1_PIXELS(left[1 + r])
      break;
    case 3:                                 // D45 .. D67
    case 4:
    case 5:
    case 6:
    case 7:
    case 8: {
      const int* tm = taps + (m - 3) * (W * H);
      K1_PIXELS(dir_tap(__ldg(tm + p), above, left))
      break;
    }
    case 9: {                               // SMOOTH
      const int below = left[H], right = above[W];
      K1_PIXELS((above[1 + c] * smw[H + r] + below * (256 - smw[H + r]) +
                 left[1 + r] * smw[W + c] + right * (256 - smw[W + c]) +
                 256) >> 9)
      break;
    }
    case 10: {                              // SMOOTH_V
      const int below = left[H];
      K1_PIXELS((above[1 + c] * smw[H + r] + below * (256 - smw[H + r]) +
                 128) >> 8)
      break;
    }
    case 11: {                              // SMOOTH_H
      const int right = above[W];
      K1_PIXELS((left[1 + r] * smw[W + c] + right * (256 - smw[W + c]) +
                 128) >> 8)
      break;
    }
    case 12: {                              // PAETH
      const int tl = above[0];
      K1_PIXELS(paeth(above[1 + c], left[1 + r], tl))
      break;
    }
    default:
      K1_PIXELS(src)
      break;
  }
#undef K1_PIXELS
  return sabs;
}

// The quantizer's (dc, ac) scalars of a shape.
struct QuantDA {
  float zb_dc, zb_ac, rn_dc, rn_ac, st_dc, st_ac;
};

// What the near-boundary pass adds to a group's sums: e2 and mg on lane
// 0 (0 elsewhere), nz on every lane.
struct NearSums {
  float e2[2], mg[2];
  int nz[2];
};

// The prediction of pixel (r, c) of a w x h block by mode m < kModes, as
// residuals() computes it (one pixel; taps: the shape's tap tables).
template <typename T>
__device__ __forceinline__ int pred_pixel(int m, int r, int c, int w, int h,
                                          int dc, const T* above, const T* left,
                                          const int* smw,
                                          const int* __restrict__ taps) {
  switch (m) {
    case 0:
      return dc;
    case 1:
      return above[1 + c];
    case 2:
      return left[1 + r];
    case 9:
      return (above[1 + c] * smw[h + r] + left[h] * (256 - smw[h + r]) +
              left[1 + r] * smw[w + c] + above[w] * (256 - smw[w + c]) +
              256) >> 9;
    case 10:
      return (above[1 + c] * smw[h + r] + left[h] * (256 - smw[h + r]) +
              128) >> 8;
    case 11:
      return (left[1 + r] * smw[w + c] + above[w] * (256 - smw[w + c]) +
              128) >> 8;
    case 12:
      return paeth(above[1 + c], left[1 + r], above[0]);
    default:                                // D45 .. D67
      return dir_tap(__ldg(taps + (m - 3) * (w * h) + r * w + c), above,
                     left);
  }
}

// The near-boundary coefficients of one group of g modes of a w x h
// block at (y0, x0) (positions nlist[0, nn): gm << 12 | n << 6 | j): each
// recomputed in float64 FMA from the residual, predicted again pixel by
// pixel (integer, so exact), and the float32 DCT entries, and decided
// from that value rounded to float32.  Cold code: one copy, out of line,
// with the block size at run time.
template <typename T>
__device__ __noinline__ NearSums near_pass(
    int w, int h, int g, int grp, int nn, const int* nlist, Plane<T> pl,
    int y0, int x0, int lane, int dc, const T* above, const T* left,
    const int* smw, const int* __restrict__ taps,
    const float4* __restrict__ fh, const float4* __restrict__ fw,
    QuantDA q, const float* log2_1p) {
  NearSums out = {{0.f, 0.f}, {0.f, 0.f}, {0, 0}};
  // each lane takes column c = lane % w (w divides 32) of rows lane / w +
  // i * 32 / w, so D_w[j][c] is its one factor
  const int rpi = 32 / w, c = lane % w, r0 = lane / w;
  for (int e = 0; e < nn; ++e) {
    const int pos = nlist[e];
    const int gm = (pos >> 12) & 1, n = (pos >> 6) & 63, j = pos & 63;
    const int m = grp * g + gm;
    double a64 = 0.0;
    for (int r = r0; r < h; r += rpi) {
      const int rv = (int)pl.px[(y0 + r) * pl.buf_w + x0 + c] -
                     pred_pixel(m, r, c, w, h, dc, above, left, smw, taps);
      a64 = fma(cost_model::dct_at(fh, h, n, r), (double)rv, a64);
    }
    const double c64 =
        cost_model::warp_sum_f64(a64 * cost_model::dct_at(fw, w, j, c));
    const bool is_dc = n == 0 && j == 0;
    float ce2, cmg;
    int cnz;
    cost_model::coef_decided(__double2float_rn(fabs(c64)),
                             is_dc ? q.zb_dc : q.zb_ac,
                             is_dc ? q.rn_dc : q.rn_ac,
                             is_dc ? q.st_dc : q.st_ac, log2_1p, ce2, cnz,
                             cmg);
    if (lane == 0) {
      out.e2[gm] = __fadd_rn(out.e2[gm], ce2);
      out.mg[gm] = __fadd_rn(out.mg[gm], cmg);
    }
    out.nz[gm] += cnz;
  }
  if (lane == 0) cost_model::count_near(nn);
  return out;
}

// One warp's blocks of one shape.
template <int W, int H, typename S>
__device__ __forceinline__ void run_shape(
    const Plane<S>& pl, const Shapes& sh, int s, int wi,
    const float* __restrict__ mode_bits,
    float lam, int* __restrict__ out, const float4* __restrict__ frag,
    const int* __restrict__ taps, const int* smw, const float* log2_1p,
    float* R, float* T, S* above, S* left) {
  constexpr int G = (W == 8 || H == 8) ? 2 : 1;  // modes per group
  constexpr int NG = (kModes + G - 1) / G;
  constexpr int NP = W * H / 32;                  // pixels per lane
  constexpr int BPW = 1024 / (W * H);             // blocks per warp
  constexpr int L = W + H + 1;
  constexpr int PER = SrcPack<S>::kPer, BITS = SrcPack<S>::kBits;
  // product 1: M1 = G*W, K1 = N1 = H; product 2: M2 = G*H, K2 = N2 = W
  constexpr int MT1 = G * W / 16, KS1 = H / 8, NT1 = H / 8;
  constexpr int MT2 = G * H / 16, KS2 = W / 8, NT2 = W / 8;
  const float4* fh = frag + frag_offset(H) / 4;
  const float4* fw = frag + frag_offset(W) / 4;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int nblk = sh.nblocks[s], nc = sh.ncols[s];
  const float zb_dc = sh.zbin_dc[s], zb_ac = sh.zbin_ac[s];
  const float rn_dc = sh.rnd_dc[s], rn_ac = sh.rnd_ac[s];
  const float st_dc = sh.step_dc[s], st_ac = sh.step_ac[s];
  const float cdl = cost_model::near_margin(W, H);
  const int o0 = sh.out0[s];
  const int* tps = taps + sh.tap0[s];

  for (int bi = 0; bi < BPW; ++bi) {
    const int b = wi * BPW + bi;
    if (b >= nblk) break;                         // warp-uniform
    const int by = b / nc, bx = b - by * nc;
    const int y0 = by * H, x0 = bx * W;
    __syncwarp();
    for (int k = lane; k < L; k += 32) {
      above[k] = sample(pl, y0 - 1, x0 - 1 + k);
      left[k] = sample(pl, y0 - 1 + k, x0 - 1);
    }
    // this lane's source pixels p = i * 32 + lane, PER per register
    uint32_t spk[(NP + PER - 1) / PER];
#pragma unroll
    for (int i = 0; i < (NP + PER - 1) / PER; ++i) spk[i] = 0;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int p = i * 32 + lane, r = p / W, c = p % W;
      spk[i / PER] |= (uint32_t)pl.px[(y0 + r) * pl.buf_w + x0 + c]
                      << ((i % PER) * BITS);
    }
    __syncwarp();
    int sum = (lane < W ? above[1 + lane] : 0) + (lane < H ? left[1 + lane]
                                                           : 0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int dc = (sum + ((W + H) >> 1)) / (W + H);

    float best_cost = 0.f;
    int best_mode = 0;
    for (int grp = 0; grp < NG; ++grp) {
      float dlt[G], e2[G], mg[G];
      int nz[G], nq[G];
      uint16_t* qpos = reinterpret_cast<uint16_t*>(T);
      int* nlist = reinterpret_cast<int*>(R);
      int nn = 0;
      // residuals R[gm][r][c] of the group's modes, and each mode's
      // near-boundary margin from its sum |R|
#pragma unroll
      for (int gm = 0; gm < G; ++gm) {
        const int sa =
            residuals<W, H, S>(grp * G + gm, R + gm * H * kRStride, spk,
                               lane, dc, above, left, smw, tps);
        dlt[gm] = __fmul_rn(
            (float)__reduce_add_sync(0xffffffffu, (unsigned)sa), cdl);
      }
      __syncwarp();

      // product 1: T^T[(gm, c)][n] = sum_r R[gm][r][c] * Dh[n][r], one
      // m-tile of 16 rows (gm, c) at a time
#pragma unroll
      for (int mt = 0; mt < MT1; ++mt) {
        // rows mt*16 + g (+ 8): (gm, c) with row = gm * W + c
        const int gm_lo = W == 8 ? 2 * mt : (mt * 16) / W;
        const int gm_hi = W == 8 ? 2 * mt + 1 : gm_lo;
        const int c_lo = W == 8 ? g : (mt * 16) % W + g;
        const int c_hi = W == 8 ? g : c_lo + 8;
        float acc[NT1][4];
#pragma unroll
        for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS1; ++ks) {
          const int k_lo = ks * 8 + t, k_hi = k_lo + 4;
          const uint32_t a[4] = {
              __float_as_uint(R[(gm_lo * H + k_lo) * kRStride + c_lo]),
              __float_as_uint(R[(gm_hi * H + k_lo) * kRStride + c_hi]),
              __float_as_uint(R[(gm_lo * H + k_hi) * kRStride + c_lo]),
              __float_as_uint(R[(gm_hi * H + k_hi) * kRStride + c_hi])};
#pragma unroll
          for (int nt = 0; nt < NT1; ++nt) {
            const float4 bf = __ldg(fh + (ks * NT1 + nt) * 32 + lane);
            mma_tf32(acc[nt], a, __float_as_uint(bf.z),
                     __float_as_uint(bf.w));
            mma_tf32(acc[nt], a, __float_as_uint(bf.x),
                     __float_as_uint(bf.y));
          }
        }
        // T[gm][n][c]
#pragma unroll
        for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int gm = (i >> 1) ? gm_hi : gm_lo;
            const int c = (i >> 1) ? c_hi : c_lo;
            const int n = nt * 8 + 2 * t + (i & 1);
            T[(gm * H + n) * kTStride + c] = acc[nt][i];
          }
      }
      __syncwarp();

      // product 2 and the quantizer model: C[(gm, n)][j] =
      // sum_c T[gm][n][c] * Dw[j][c], one m-tile of 16 rows (gm, n) at a
      // time.  The dead-zone coefficients (most of them) add their square
      // where they are; the others go to a queue per mode in the free
      // residual buffer (mode 0 from its start, mode 1 from its end; the
      // DC coefficient's value negated), which the lanes then share, so
      // the division and log2f run once per coded coefficient instead of
      // once per slot that any lane codes.
#pragma unroll
      for (int gm = 0; gm < G; ++gm) {
        e2[gm] = 0.f;
        mg[gm] = 0.f;
        nz[gm] = 0;
        nq[gm] = 0;
      }
#pragma unroll
      for (int mt = 0; mt < MT2; ++mt) {
        float acc[NT2][4];
#pragma unroll
        for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
        const int r_lo = mt * 16 + g, r_hi = r_lo + 8;
#pragma unroll
        for (int ks = 0; ks < KS2; ++ks) {
          const int k_lo = ks * 8 + t, k_hi = k_lo + 4;
          const float x[4] = {T[r_lo * kTStride + k_lo],
                              T[r_hi * kTStride + k_lo],
                              T[r_lo * kTStride + k_hi],
                              T[r_hi * kTStride + k_hi]};
          uint32_t ab[4], as[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ab[i] = tf32_big(x[i]);
            as[i] = __float_as_uint(x[i] - __uint_as_float(ab[i]));
          }
#pragma unroll
          for (int nt = 0; nt < NT2; ++nt) {
            const float4 bf = __ldg(fw + (ks * NT2 + nt) * 32 + lane);
            const uint32_t bb0 = __float_as_uint(bf.x),
                           bb1 = __float_as_uint(bf.y);
            mma_tf32(acc[nt], as, bb0, bb1);
            mma_tf32(acc[nt], ab, __float_as_uint(bf.z),
                     __float_as_uint(bf.w));
            mma_tf32(acc[nt], ab, bb0, bb1);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int hi = i >> 1;
            const int gm = H == 8 ? 2 * mt + hi : (mt * 16) / H;
            const int n = H == 8 ? g : (mt * 16) % H + 8 * hi + g;
            const int j = nt * 8 + 2 * t + (i & 1);
            const float ac = fabsf(acc[nt][i]);
            const float zb = n == 0 && j == 0 ? zb_dc : zb_ac;
            const bool queued =
                ac >= zb || cost_model::near_zbin(ac, zb, dlt[gm]);
            const unsigned ball = __ballot_sync(0xffffffffu, queued);
            if (queued) {
              const int at = nq[gm] + __popc(ball & lanes_below);
              R[gm == 0 ? at : kRFloats - 1 - at] = ac;
              qpos[gm == 0 ? at : kQPos - 1 - at] = (uint16_t)((n << 6) | j);
            } else {
              e2[gm] = __fadd_rn(e2[gm], __fmul_rn(ac, ac));
            }
            nq[gm] += __popc(ball);
          }
      }
      // the coefficients outside the dead zone, shared out over the lanes;
      // their nonzero count is summed by ballots.  Near-boundary entries
      // move, as positions, to a list at the queue's start (compacted in
      // place: a slot is written only after it was read; the second
      // mode's queue, from R's end, lies beyond every slot written).
      __syncwarp();
#pragma unroll
      for (int gm = 0; gm < G; ++gm) {
        for (int k0 = 0; k0 < nq[gm]; k0 += 32) {     // warp-uniform
          const int k = k0 + lane;
          int cnz = 0;
          bool near = false;
          int pos = 0;
          if (k < nq[gm]) {
            const float v = R[gm == 0 ? k : kRFloats - 1 - k];
            pos = qpos[gm == 0 ? k : kQPos - 1 - k];
            const bool is_dc = pos == 0;
            const float st = is_dc ? st_dc : st_ac;
            const float zb = is_dc ? zb_dc : zb_ac;
            near = cost_model::near_zbin(v, zb, dlt[gm]);
            if (!near) {
              const float t =
                  cost_model::quotient(v, is_dc ? rn_dc : rn_ac, st);
              near = cost_model::near_round(t, st, dlt[gm]);
              if (!near) {
                float ce2, cmg;
                cost_model::coef_from_t(v, t, st, log2_1p, ce2, cnz, cmg);
                e2[gm] = __fadd_rn(e2[gm], ce2);
                mg[gm] = __fadd_rn(mg[gm], cmg);
              }
            }
          }
          const unsigned nb = __ballot_sync(0xffffffffu, near);
          if (near) nlist[nn + __popc(nb & lanes_below)] = (gm << 12) | pos;
          nz[gm] += __popc(__ballot_sync(0xffffffffu, cnz));
          nn += __popc(nb);
        }
      }
      if (nn > 0) {                 // warp-uniform; near ones are rare
        __syncwarp();               // the queue is read, the list written
        const NearSums ns = near_pass(
            W, H, G, grp, nn, nlist, pl, y0, x0, lane, dc, above, left, smw,
            tps, fh, fw, QuantDA{zb_dc, zb_ac, rn_dc, rn_ac, st_dc, st_ac},
            log2_1p);
#pragma unroll
        for (int gm = 0; gm < G; ++gm) {
          e2[gm] = __fadd_rn(e2[gm], ns.e2[gm]);
          mg[gm] = __fadd_rn(mg[gm], ns.mg[gm]);
          nz[gm] += ns.nz[gm];
        }
      }
      __syncwarp();                 // R and T may take the next group
      // SSE over the warp (both modes of a pair in one butterfly); the
      // log2 terms only where the warp queued a coefficient (elsewhere
      // every lane's sum is 0)
      warp_sum<G>(e2, lane);
      if (nq[0] > 0 || (G == 2 && nq[G - 1] > 0)) warp_sum<G>(mg, lane);
#pragma unroll
      for (int gm = 0; gm < G; ++gm) {
        const int m = grp * G + gm;
        if (m < kModes) {
          const float cost = cost_model::rd_cost(e2[gm], nz[gm], mg[gm],
                                                 __ldg(mode_bits + m), lam);
          if (m == 0 || cost < best_cost) {
            best_cost = cost;
            best_mode = m;
          }
        }
      }
    }
    if (lane == 0) {
      out[o0 + b] = best_mode;
      out[sh.n_total + o0 + b] = __float_as_int(best_cost);
    }
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads, 4) intra_decision_kernel(
    Plane<S> pl, Shapes sh, const int* __restrict__ taps,
    const int* __restrict__ sm_weights,
    const float4* __restrict__ frags, const float* __restrict__ mode_bits,
    float lam, int* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* smw = reinterpret_cast<int*>(smem);
  float* log2_1p = reinterpret_cast<float*>(smw + kSmw);
  const int warp = threadIdx.x >> 5;
  float* wbase = reinterpret_cast<float*>(
      smem + sizeof(int) * (kSmw + cost_model::kLog2Table) +
      warp * warp_bytes<S>());
  float* R = wbase;
  float* T = wbase + kRFloats;
  S* above = reinterpret_cast<S*>(wbase + kRFloats + kTFloats);
  S* left = above + kEdge;

  for (int k = threadIdx.x; k < kSmw; k += kThreads) smw[k] = sm_weights[k];
  for (int k = threadIdx.x; k < cost_model::kLog2Table; k += kThreads)
    log2_1p[k] = log2f(__fadd_rn(1.f, (float)k));
  int s = 0;
  while (s + 1 < sh.n && (int)blockIdx.x >= sh.cta0[s + 1]) ++s;
  __syncthreads();

  const int wi = ((int)blockIdx.x - sh.cta0[s]) * kWarps + warp;
  const int key = sh.w[s] * 100 + sh.h[s];
#define K1_SHAPE(W_, H_)                                                   \
  case W_ * 100 + H_:                                                      \
    run_shape<W_, H_>(pl, sh, s, wi, mode_bits, lam, out, frags, taps,     \
                      smw, log2_1p,                                        \
                      R, T, above, left);                                  \
    break;
  switch (key) {
    K1_SHAPE(8, 8)
    K1_SHAPE(16, 16)
    K1_SHAPE(32, 32)
    K1_SHAPE(16, 8)
    K1_SHAPE(8, 16)
    K1_SHAPE(32, 16)
    K1_SHAPE(16, 32)
    default:
      break;
  }
#undef K1_SHAPE
}

// One launch of the instantiation for samples of type S.
template <typename S>
int launch(const void* plane, const void* above_row, const void* halo,
           int buf_h, int buf_w, int n_halo, const Shapes& sh, int ctas,
           const void* taps, const void* sm_weights, const void* frags,
           const void* mode_bits, float lam, void* out, void* stream) {
  constexpr size_t kSmem = smem_bytes<S>();
  cudaError_t e = cudaFuncSetAttribute(
      intra_decision_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  Plane<S> pl{(const S*)plane, (const S*)above_row, (const S*)halo, buf_h,
              buf_w, halo ? n_halo : 0};
  intra_decision_kernel<S><<<ctas, kThreads, kSmem, (cudaStream_t)stream>>>(
      pl, sh, (const int*)taps, (const int*)sm_weights,
      (const float4*)frags, (const float*)mode_bits, lam, (int*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// The near-boundary recomputes since the last reset into *out (reset:
// set the count to 0 after reading).  Returns the CUDA error.
extern "C" int intra_decision_near_count(int reset,
                                         unsigned long long* out) {
  return cost_model::read_near_count(reset, out);
}

// plane: [buf_h, buf_w] samples of sample_bytes bytes each (1: uint8, 8-bit
// video; 2: 16-bit words holding 10-bit samples); above_row: [buf_w] and
// halo: [n_halo, buf_w] of the same type, the true neighbour rows of a
// stripe (both null for a whole plane); n_shapes shapes (w[i], h[i]),
// each tiling the plane; quant: float32 [n_shapes, 6] = (zbin, round,
// step) as (dc, ac) pairs; tap0: int32 [n_shapes] (host), the offset of
// each shape's [6, h*w] directional tap table in taps (ops/omd.py
// _k1_taps); sm_weights: int32 [128]; frags: float32 [2688], the split
// DCT fragments of sizes 8, 16, 32 (ops/omd.py _k1_fragments);
// mode_bits: float32 [13]; out: int32 [2, n_total] (modes; costs'
// float32 bits), shapes in order, blocks raster within a shape.  Returns
// the CUDA error of the launch.
extern "C" int intra_decision_launch(
    const void* plane, const void* above_row, const void* halo,
    int sample_bytes, int buf_h, int buf_w, int n_halo, int n_shapes,
    const int* w, const int* h,
    const float* quant, const int* tap0, const void* taps,
    const void* sm_weights,
    const void* frags, const void* mode_bits, float lam, void* out,
    void* stream) {
  if (n_shapes < 1 || n_shapes > kMaxShapes ||
      (above_row == nullptr) != (halo == nullptr) || n_halo < 0 ||
      buf_h < 1 || buf_w < 1 || (sample_bytes != 1 && sample_bytes != 2))
    return (int)cudaErrorInvalidValue;
  Shapes sh{};
  sh.n = n_shapes;
  int ctas = 0, outs = 0;
  for (int i = 0; i < n_shapes; ++i) {
    const int wi = w[i], hi = h[i];
    const bool known = (wi == 8 || wi == 16 || wi == 32) &&
                       (hi == 8 || hi == 16 || hi == 32) && wi * hi <= 1024 &&
                       wi * hi >= 64 && !(wi == 8 && hi == 32) &&
                       !(wi == 32 && hi == 8);
    if (!known || buf_h % hi || buf_w % wi) return (int)cudaErrorInvalidValue;
    sh.w[i] = wi;
    sh.h[i] = hi;
    sh.ncols[i] = buf_w / wi;
    sh.nblocks[i] = (buf_h / hi) * (buf_w / wi);
    sh.cta0[i] = ctas;
    sh.tap0[i] = tap0[i];
    sh.out0[i] = outs;
    const int bpw = 1024 / (wi * hi);
    const int warps = (sh.nblocks[i] + bpw - 1) / bpw;
    ctas += (warps + kWarps - 1) / kWarps;
    outs += sh.nblocks[i];
    sh.zbin_dc[i] = quant[i * 6 + 0];
    sh.zbin_ac[i] = quant[i * 6 + 1];
    sh.rnd_dc[i] = quant[i * 6 + 2];
    sh.rnd_ac[i] = quant[i * 6 + 3];
    sh.step_dc[i] = quant[i * 6 + 4];
    sh.step_ac[i] = quant[i * 6 + 5];
  }
  sh.cta0[n_shapes] = ctas;
  sh.n_total = outs;
  return sample_bytes == 1
             ? launch<uint8_t>(plane, above_row, halo, buf_h, buf_w, n_halo,
                               sh, ctas, taps, sm_weights, frags, mode_bits,
                               lam, out, stream)
             : launch<uint16_t>(plane, above_row, halo, buf_h, buf_w, n_halo,
                                sh, ctas, taps, sm_weights, frags, mode_bits,
                                lam, out, stream);
}
