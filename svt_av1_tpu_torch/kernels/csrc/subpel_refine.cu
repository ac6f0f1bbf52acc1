// K7 subpel_refine: quarter-pel refinement of every 16x16 unit.
//
// Replaces the JAX package's subpel_refine16 (svt_av1_tpu/ops/bme.py:320)
// and the exact REGULAR 8-tap interpolation it runs for each of 25
// candidates (convolve_2d_sr, svt_av1_tpu/ops/inter.py:54).
//
// What bounds it on the H100: integer multiply-adds.  In the shared form
// below a unit needs 3 horizontal phases over 49 patch columns and 22
// rows, 49 vertical outputs over each of 65 columns (6 nonzero taps,
// multiply and add) and 25 SADs of 256 pixels: about 70 k operations, at
// 1080p 0.6 G, under 10 microseconds at the card's integer rate.
//
// Design: one warp per 16x16 unit, four units per 128-thread block, no
// block barrier.  The candidates share their filter work: dx8 = -4 and +4
// both take the q4 = 8 phase one column apart, dy8 = -4 and +4 the same
// vertical phase one row apart, so 3 horizontal phases (q4 4, 8, 12) and
// the copy, each over the 24 patch rows, and 3 vertical phases over them
// cover all 25 candidates.
// (1) The warp reads the 24x24 patch at the clipped origin (bme.py:344-345;
//     the edge pad is clamped reads; the plain version's 25th row and
//     column are never filtered) into shared memory as bytes.
// (2) Lane i < 24 filters patch row i: each horizontal output is two
//     dp4a (signed taps by unsigned pixels) over byte windows built with
//     PRMT, and is kept as the "both" intermediate im = (h + 2^14 + 4) >> 3,
//     which lies in [1156, 7021] for 8-bit pixels and so fits 16 bits; the
//     x-only rounding is (im - 2040) >> 4, the same integer.  The copy
//     columns are kept as 16-bit pixels.  The four column tables are
//     stored column-major.
// (3) Lane (c, h) takes column c and rows 8h..8h+7 of the unit.  For each
//     of the 5 column variants it loads the column's 16 table rows with
//     two 16-byte loads, pairs neighbouring rows in 32-bit words (odd
//     pairs by PRMT), and runs each vertical phase as four dp2a (two
//     16-bit rows by two 8-bit taps); q4 = 8 is computed once for the
//     nine window offsets that dy8 = -4 and +4 read.  Each candidate is
//     rounded as its case of convolve_2d_sr does (copy, x only, y only,
//     or both with the offset bits), clamped, and its |diff| accumulated
//     in one of 25 registers.
// (4) Twenty-five warp reductions (redux.sync) give the SADs; every lane
//     adds 2(|dy8| + |dx8|) and takes the first strict minimum in the
//     order of SUBPEL_DELTAS (dy outer, dx inner).  The winner's
//     prediction is computed once more from the tables and written.
// The taps come from the wrapper's REGULAR table (q4 4, 8 and 12), packed
// into signed bytes: they lie in [-14, 110].  The source may be a stripe
// of the frame starting at global row row0: its units then sit row0 rows
// further down the whole reference, whose height bounds the patch origin.
// Signs: dy8 >> 3 is an arithmetic shift (floor), (dx8 & 7) * 2 the q4
// filter phase.
//
// The 16-bit form (uint16_t: int16 planes of 10-bit samples, bd 10).  The
// patch holds 2-byte samples, and a horizontal output is four dp2a (two
// 16-bit samples by two signed 8-bit taps each) over sample pairs built
// with funnel shifts, where the 8-bit form takes two dp4a.  The offsets
// follow bd as convolve_2d_sr's do: the "both" intermediate is
// im = (h + 2^(bd+6) + 4) >> 3, which lies in [4612, 28141] at 10 bits
// (the REGULAR phases' negative taps sum to at most 28, their positive
// ones to at most 156) and so still fits the 16-bit column tables and the
// vertical dp2a; the x-only rounding is (im - 2^(bd+3) + 8) >> 4, the
// "both" one ((v + 2^(bd+11) + 1024) >> 11) - 2^bd - 2^(bd-1), and every
// prediction is clamped to [0, 2^bd).  tests/test_torch_tenbit_inter.py
// holds these ranges over every reachable sum.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 25;            // the plain version's patch side
constexpr int kPad = 24;          // REFINE_R + 8
constexpr int kRows = 24;         // patch rows and columns filtered
constexpr int kWarps = 4;         // units per block
// column tables: q4 = 8 over patch columns 3..19, q4 = 12 over 3..18,
// the copy over 4..19, q4 = 4 over 4..19; kRows 16-bit rows each
constexpr int kT8 = 0, kT12 = 17, kCopy = 33, kT4 = 49, kCols = 65;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// signed taps (a) by unsigned pixels (b), four products and c
__device__ __forceinline__ int dp4a_su(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// the 4 bytes of the 24-byte row w starting at byte o (o static)
__device__ __forceinline__ uint32_t bytes4(const uint32_t (&w)[6], int o) {
  return (o & 3) ? __byte_perm(w[o >> 2], w[(o >> 2) + 1],
                               0x3210 + 0x1111 * (o & 3))
                 : w[o >> 2];
}

// sum of the 8 taps (t0 = taps 0..3, t1 = taps 4..7) over 8 consecutive
// 16-bit rows held as pairs in p[0..3]
__device__ __forceinline__ int vfilt(uint32_t p0, uint32_t p1, uint32_t p2,
                                     uint32_t p3, uint32_t t0, uint32_t t1,
                                     int acc) {
  acc = __dp2a_lo((int)p0, (int)t0, acc);
  acc = __dp2a_hi((int)p1, (int)t0, acc);
  acc = __dp2a_lo((int)p2, (int)t1, acc);
  return __dp2a_hi((int)p3, (int)t1, acc);
}

__device__ __forceinline__ int tap_of(uint32_t t0, uint32_t t1, int t) {
  return (int)(int8_t)(((t < 4 ? t0 : t1) >> (8 * (t & 3))) & 255);
}

// the pair of 16-bit samples o, o + 1 of the 24-sample row w (o static)
__device__ __forceinline__ uint32_t pair16(const uint32_t (&w)[12], int o) {
  return (o & 1) ? __funnelshift_r(w[o >> 1], w[(o >> 1) + 1], 16)
                 : w[o >> 1];
}

// T: uint8_t (8-bit video) or uint16_t (10-bit samples)
template <typename T>
__global__ void __launch_bounds__(32 * kWarps) subpel_refine_kernel(
    const T* __restrict__ src, const T* __restrict__ ref, int H, int W,
    int row0, int n_units, const int* __restrict__ mv_r16,
    const int* __restrict__ mv_c16, const int* __restrict__ taps,
    int* __restrict__ out_r, int* __restrict__ out_c, T* __restrict__ pred) {
  constexpr int kBd = sizeof(T) == 1 ? 8 : 10;
  constexpr int kMax = (1 << kBd) - 1;
  constexpr int kRowW = kRows * (int)sizeof(T) / 4;   // patch row words
  __shared__ __align__(16) uint32_t patch_w[kWarps][kRows * kRowW];
  __shared__ __align__(16) int16_t tab_s[kWarps][kCols * kRows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = blockIdx.x * kWarps + warp;
  if (u >= n_units) return;
  const int nc16 = W >> 4;
  const int uy = u / nc16, ux = u - uy * nc16;
  T* patch = reinterpret_cast<T*>(patch_w[warp]);
  int16_t* tab = tab_s[warp];

  // the taps of q4 = 4, 8, 12 as signed bytes: word 2k + half holds taps
  // 4 half .. 4 half + 3 of phase k
  uint32_t tw = 0;
  if (lane < 6) {
    const int* t = taps + (4 + 4 * (lane >> 1)) * 8 + 4 * (lane & 1);
    tw = (uint32_t)(t[0] & 255) | ((uint32_t)(t[1] & 255) << 8) |
         ((uint32_t)(t[2] & 255) << 16) | ((uint32_t)(t[3] & 255) << 24);
  }
  const uint32_t t4a = __shfl_sync(0xffffffffu, tw, 0);
  const uint32_t t4b = __shfl_sync(0xffffffffu, tw, 1);
  const uint32_t t8a = __shfl_sync(0xffffffffu, tw, 2);
  const uint32_t t8b = __shfl_sync(0xffffffffu, tw, 3);
  const uint32_t t12a = __shfl_sync(0xffffffffu, tw, 4);
  const uint32_t t12b = __shfl_sync(0xffffffffu, tw, 5);

  // (1) the patch
  const int mr = mv_r16[u], mc = mv_c16[u];
  const int oy =
      clampi(uy * 16 + row0 + mr - 4 + kPad, 0, H + 2 * kPad - kP) - kPad;
  const int ox = clampi(ux * 16 + mc - 4 + kPad, 0, W + 2 * kPad - kP) - kPad;
#pragma unroll
  for (int k = lane; k < kRows * kRows; k += 32) {
    const int i = k / kRows, j = k - (k / kRows) * kRows;
    patch[k] = ref[(size_t)clampi(oy + i, 0, H - 1) * W +
                   clampi(ox + j, 0, W - 1)];
  }
  const int c = lane & 15, r0 = (lane >> 4) * 8;
  int s[8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
    s[m] = src[(size_t)(uy * 16 + r0 + m) * W + ux * 16 + c];
  __syncwarp();

  // (2) the column tables, one patch row per lane
  if constexpr (sizeof(T) == 1) {
    if (lane < kRows) {
      uint32_t w[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) w[k] = patch_w[warp][lane * 6 + k];
      int16_t* row = tab + lane;
#pragma unroll
      for (int j = 3; j <= 19; ++j) {
        const uint32_t lo = bytes4(w, j - 3), hi = bytes4(w, j + 1);
        const int h8 = dp4a_su(t8a, lo, dp4a_su(t8b, hi, 0));
        row[(kT8 + j - 3) * kRows] = (int16_t)((h8 + (1 << 14) + 4) >> 3);
        if (j <= 18) {
          const int h12 = dp4a_su(t12a, lo, dp4a_su(t12b, hi, 0));
          row[(kT12 + j - 3) * kRows] =
              (int16_t)((h12 + (1 << 14) + 4) >> 3);
        }
        if (j >= 4) {
          const int h4 = dp4a_su(t4a, lo, dp4a_su(t4b, hi, 0));
          row[(kT4 + j - 4) * kRows] = (int16_t)((h4 + (1 << 14) + 4) >> 3);
          row[(kCopy + j - 4) * kRows] =
              (int16_t)((w[j >> 2] >> (8 * (j & 3))) & 255);
        }
      }
    }
  } else {
    // four dp2a per output over the pairs (j-3, j-2) .. (j+3, j+4)
    constexpr int kOff = 1 << (kBd + 6);
    if (lane < kRows) {
      uint32_t w[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) w[k] = patch_w[warp][lane * 12 + k];
      int16_t* row = tab + lane;
#pragma unroll
      for (int j = 3; j <= 19; ++j) {
        const uint32_t p0 = pair16(w, j - 3), p1 = pair16(w, j - 1);
        const uint32_t p2 = pair16(w, j + 1), p3 = pair16(w, j + 3);
        const int h8 = vfilt(p0, p1, p2, p3, t8a, t8b, 0);
        row[(kT8 + j - 3) * kRows] = (int16_t)((h8 + kOff + 4) >> 3);
        if (j <= 18) {
          const int h12 = vfilt(p0, p1, p2, p3, t12a, t12b, 0);
          row[(kT12 + j - 3) * kRows] = (int16_t)((h12 + kOff + 4) >> 3);
        }
        if (j >= 4) {
          const int h4 = vfilt(p0, p1, p2, p3, t4a, t4b, 0);
          row[(kT4 + j - 4) * kRows] = (int16_t)((h4 + kOff + 4) >> 3);
          row[(kCopy + j - 4) * kRows] =
              (int16_t)((w[j >> 1] >> (16 * (j & 1))) & 0xffff);
        }
      }
    }
  }
  __syncwarp();

  // (3) the 25 candidates' SADs over the lane's 8 pixels; sad[iy * 5 + ix]
  int sad[25];
#pragma unroll
  for (int k = 0; k < 25; ++k) sad[k] = 0;
#pragma unroll
  for (int ix = 0; ix < 5; ++ix) {
    // dx8 = -4, -2, 0, 2, 4: q4 8 at column 3 + c, 12 at 3 + c, the copy
    // at 4 + c, 4 at 4 + c, 8 at 4 + c
    const int col = ix == 0 ? kT8 + c : ix == 1 ? kT12 + c
                    : ix == 2 ? kCopy + c : ix == 3 ? kT4 + c : kT8 + c + 1;
    const uint4* cp =
        reinterpret_cast<const uint4*>(tab + col * kRows + r0);
    const uint4 a = cp[0], b = cp[1];
    // P[k]: rows r0 + 2k, r0 + 2k + 1; O[k]: rows r0 + 2k + 1, r0 + 2k + 2
    const uint32_t P[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    // (O[7] only completes the array: no window reads it)
    uint32_t O[8];
#pragma unroll
    for (int k = 0; k < 7; ++k) O[k] = __byte_perm(P[k], P[k + 1], 0x5432);
    O[7] = P[7] >> 16;
    const bool copy = ix == 2;
    // y-only (copy column) and both: the vertical sums' start values
    const int v0 = copy ? 64 : (1 << (kBd + 11)) + 1024;
    const int sh = copy ? 7 : 11;
    const int sub = copy ? 0 : (1 << kBd) + (1 << (kBd - 1));
    // window offset o (rows r0 + o .. r0 + o + 7) of a vertical phase
#define VF(o, ta, tb)                                                    \
  ((o) & 1 ? vfilt(O[(o) >> 1], O[((o) >> 1) + 1], O[((o) >> 1) + 2],    \
                   O[((o) >> 1) + 3], ta, tb, v0)                        \
           : vfilt(P[(o) >> 1], P[((o) >> 1) + 1], P[((o) >> 1) + 2],    \
                   P[((o) >> 1) + 3], ta, tb, v0))
    int v8[9];
#pragma unroll
    for (int o = 0; o < 9; ++o) v8[o] = VF(o, t8a, t8b);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      // dy8 = -4 (q4 8, window m), -2 (12, m), 0 (row m + 4), 2 (4,
      // m + 1), 4 (8, m + 1)
      const int mid = (int)(((m + 4) & 1 ? P[(m + 4) >> 1] >> 16
                                         : P[(m + 4) >> 1] & 0xffff));
      const int p0 = copy ? mid : (mid - ((1 << (kBd + 3)) - 8)) >> 4;
      const int p[5] = {(v8[m] >> sh) - sub, (VF(m, t12a, t12b) >> sh) - sub,
                        p0, (VF(m + 1, t4a, t4b) >> sh) - sub,
                        (v8[m + 1] >> sh) - sub};
#pragma unroll
      for (int iy = 0; iy < 5; ++iy)
        sad[iy * 5 + ix] = (int)__sad(s[m], clampi(p[iy], 0, kMax),
                                      (unsigned)sad[iy * 5 + ix]);
    }
#undef VF
  }

  // (4) the unit's SADs, the first strict minimum of cost, the winner
  int best_cost = 0, best = 0;
#pragma unroll
  for (int k = 0; k < 25; ++k) {
    const int iy = k / 5, ix = k - (k / 5) * 5;
    const int cost = (int)__reduce_add_sync(0xffffffffu, (unsigned)sad[k]) +
                     2 * (abs(iy - 2) * 2 + abs(ix - 2) * 2);
    if (k == 0 || cost < best_cost) {
      best_cost = cost;
      best = k;
    }
  }
  const int iy = best / 5, ix = best - (best / 5) * 5;
  const int col = ix == 0 ? kT8 + c : ix == 1 ? kT12 + c
                  : ix == 2 ? kCopy + c : ix == 3 ? kT4 + c : kT8 + c + 1;
  const int16_t* cv = tab + col * kRows + r0;
  // the vertical phase of dy8 and its window offset: 8 at 0, 12 at 0,
  // none, 4 at 1, 8 at 1
  const uint32_t ta = iy == 1 ? t12a : iy == 3 ? t4a : t8a;
  const uint32_t tb = iy == 1 ? t12b : iy == 3 ? t4b : t8b;
  const int off = iy >= 3 ? 1 : 0;
  T* prow = pred + (size_t)(uy * 16 + r0) * W + ux * 16 + c;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    int p;
    if (iy == 2) {
      p = cv[m + 4];
      if (ix != 2) p = (p - ((1 << (kBd + 3)) - 8)) >> 4;
    } else {
      int acc = 0;
#pragma unroll
      for (int t = 0; t < 8; ++t) acc += tap_of(ta, tb, t) * cv[m + off + t];
      p = ix == 2 ? (acc + 64) >> 7
                  : ((acc + (1 << (kBd + 11)) + 1024) >> 11) -
                        ((1 << kBd) + (1 << (kBd - 1)));
    }
    prow[(size_t)m * W] = (T)clampi(p, 0, kMax);
  }
  if (lane == 0) {
    out_r[u] = mr * 8 + (iy - 2) * 2;
    out_c[u] = mc * 8 + (ix - 2) * 2;
  }
}

template <typename T>
int launch(const void* src, const void* ref, int rows, int H, int W,
           int row0, const void* mv_r16, const void* mv_c16,
           const void* taps, void* out_r, void* out_c, void* pred,
           void* stream) {
  const int n_units = (rows / 16) * (W / 16);
  subpel_refine_kernel<T><<<(n_units + kWarps - 1) / kWarps, 32 * kWarps, 0,
                            (cudaStream_t)stream>>>(
      (const T*)src, (const T*)ref, H, W, row0, n_units, (const int*)mv_r16,
      (const int*)mv_c16, (const int*)taps, (int*)out_r, (int*)out_c,
      (T*)pred);
  return (int)cudaGetLastError();
}

}  // namespace

// src: [rows, W], the frame or a stripe starting at global row row0; ref:
// [H, W], the whole reference (rows, H, W multiples of 16, row0 + rows <=
// H); samples of sample_bytes bytes (1: uint8, 8-bit video; 2: 16-bit
// words of 10-bit samples, int16 planes holding [0, 1023], filtered at bd
// 10); mv_r16, mv_c16: int32 [rows/16, W/16] full-pel; taps: int32 [16,
// 8] REGULAR 8-tap kernels by q4 phase (phases 4, 8 and 12 are read, each
// tap in [-128, 127]); out_r, out_c: int32 [rows/16, W/16] eighth-pel
// MVs; pred: [rows, W] winning predictions in the planes' sample type.
// Returns the CUDA error of the launch.
extern "C" int subpel_refine_launch(const void* src, const void* ref,
                                    int sample_bytes, int rows, int H, int W,
                                    int row0, const void* mv_r16,
                                    const void* mv_c16, const void* taps,
                                    void* out_r, void* out_c, void* pred,
                                    void* stream) {
  if (rows < 16 || rows % 16 || H % 16 || W % 16 || H < kP || W < kP ||
      row0 < 0 || row0 + rows > H || (sample_bytes != 1 && sample_bytes != 2))
    return (int)cudaErrorInvalidValue;
  return sample_bytes == 1
             ? launch<uint8_t>(src, ref, rows, H, W, row0, mv_r16, mv_c16,
                               taps, out_r, out_c, pred, stream)
             : launch<uint16_t>(src, ref, rows, H, W, row0, mv_r16, mv_c16,
                                taps, out_r, out_c, pred, stream);
}
