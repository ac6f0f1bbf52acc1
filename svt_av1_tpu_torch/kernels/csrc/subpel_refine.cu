// K7 subpel_refine: quarter-pel refinement of every 16x16 unit.
//
// Replaces the JAX package's subpel_refine16 (svt_av1_tpu/ops/bme.py:320)
// and the exact REGULAR 8-tap interpolation it runs for each of 25
// candidates (convolve_2d_sr, svt_av1_tpu/ops/inter.py:54).
//
// What bounds it on the H100: integer multiply-adds.  Per reference at
// 1080p, 8640 units x 25 candidates x (16x23 horizontal + 16x16
// vertical) x 8 taps is about 1.1 G multiply-adds, 2.2 G operations,
// against 2 MB of planes: tens of microseconds at the card's integer
// rate.
//
// Design: one thread block per 16x16 unit, one thread per output pixel.
// The source may be a stripe of the frame starting at global row row0:
// its units then sit row0 rows further down the whole reference, whose
// height bounds the patch origin.
// The 25x25 reference patch at the clipped origin (bme.py:344-345; the
// edge pad is clamped reads) goes to shared memory.  The five horizontal
// phases (dx8 in -4..4 step 2) are filtered once over all 25 patch rows
// and kept as raw tap sums, since every candidate with the same dx8 reads
// the same rows; each candidate then rounds them the way its case of
// convolve_2d_sr does (copy, x only, y only, or both passes with the
// offset bits), so every prediction equals the plain version's bit for
// bit.  The unit's SAD plus 2(|dy8|+|dx8|) is reduced per candidate in
// the order of SUBPEL_DELTAS (dy outer, dx inner); only a strictly
// smaller cost replaces the running best, and each thread keeps its
// pixel of the winning prediction in a register.  Signs: dy8 >> 3 is an
// arithmetic shift (floor), (dx8 & 7) * 2 the q4 filter phase.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 25;
constexpr int kPad = 24;          // REFINE_R + 8

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void subpel_refine_kernel(
    const uint8_t* __restrict__ src, const uint8_t* __restrict__ ref, int H,
    int W, int row0, const int* __restrict__ mv_r16,
    const int* __restrict__ mv_c16,
    const int* __restrict__ taps, int* __restrict__ out_r,
    int* __restrict__ out_c, uint8_t* __restrict__ pred) {
  __shared__ int patch[kP * kP];
  __shared__ int hs[5][kP][16];        // raw horizontal tap sums per phase
  __shared__ int tp[16 * 8];
  __shared__ int red[8];
  const int ux = blockIdx.x, uy = blockIdx.y, nc16 = gridDim.x;
  const int u = uy * nc16 + ux;
  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  const int mr = mv_r16[u], mc = mv_c16[u];
  const int oy =
      clampi(uy * 16 + row0 + mr - 4 + kPad, 0, H + 2 * kPad - kP) - kPad;
  const int ox = clampi(ux * 16 + mc - 4 + kPad, 0, W + 2 * kPad - kP) - kPad;
  for (int k = tid; k < kP * kP; k += 256) {
    const int i = k / kP, j = k - (k / kP) * kP;
    patch[k] = ref[(size_t)clampi(oy + i, 0, H - 1) * W +
                   clampi(ox + j, 0, W - 1)];
  }
  if (tid < 128) tp[tid] = taps[tid];
  const int s = src[(size_t)(uy * 16 + r) * W + ux * 16 + c];
  __syncthreads();
  for (int k = tid; k < 5 * kP * 16; k += 256) {
    const int a = k / (kP * 16), rr = (k / 16) % kP, cc = k & 15;
    const int dx8 = (a - 2) * 2;
    const int q4 = (dx8 & 7) * 2;
    const int sx = 4 + (dx8 >> 3);
    int acc = 0;
    if (q4) {
      for (int t = 0; t < 8; ++t)
        acc += tp[q4 * 8 + t] * patch[rr * kP + sx - 3 + cc + t];
    }
    hs[a][rr][cc] = acc;
  }
  __syncthreads();

  int best_cost = 0, best_dy = 0, best_dx = 0, best_p = 0;
  for (int iy = 0; iy < 5; ++iy) {
    const int dy8 = (iy - 2) * 2;
    const int qy = (dy8 & 7) * 2;
    const int sy = 4 + (dy8 >> 3);
    for (int ix = 0; ix < 5; ++ix) {
      const int dx8 = (ix - 2) * 2;
      const int qx = (dx8 & 7) * 2;
      const int sx = 4 + (dx8 >> 3);
      int p;
      if (!qx && !qy) {
        p = patch[(sy + r) * kP + sx + c];
      } else if (!qy) {
        // x only: round by round_0 (3), then by FILTER_BITS - round_0 (4)
        p = (((hs[ix][sy + r][c] + 4) >> 3) + 8) >> 4;
      } else if (!qx) {
        int acc = 0;
        for (int t = 0; t < 8; ++t)
          acc += tp[qy * 8 + t] * patch[(sy - 3 + r + t) * kP + sx + c];
        p = (acc + 64) >> 7;
      } else {
        // both: im = (sum + 2^14 + 4) >> 3, then 2^19 + sum, >> 11 with
        // rounding, minus (2^8 + 2^7)
        int acc2 = 1 << 19;
        for (int t = 0; t < 8; ++t)
          acc2 += tp[qy * 8 + t] *
                  ((hs[ix][sy - 3 + r + t][c] + (1 << 14) + 4) >> 3);
        p = ((acc2 + 1024) >> 11) - 384;
      }
      p = clampi(p, 0, 255);
      int d = abs(s - p);
      for (int off = 16; off > 0; off >>= 1)
        d += __shfl_down_sync(0xffffffffu, d, off);
      if ((tid & 31) == 0) red[tid >> 5] = d;
      __syncthreads();
      int cost = 2 * (abs(dy8) + abs(dx8));
      for (int w = 0; w < 8; ++w) cost += red[w];
      __syncthreads();
      if ((iy == 0 && ix == 0) || cost < best_cost) {
        best_cost = cost;
        best_dy = dy8;
        best_dx = dx8;
        best_p = p;
      }
    }
  }
  pred[(size_t)(uy * 16 + r) * W + ux * 16 + c] = (uint8_t)best_p;
  if (tid == 0) {
    out_r[u] = mr * 8 + best_dy;
    out_c[u] = mc * 8 + best_dx;
  }
}

}  // namespace

// src: uint8 [rows, W], the frame or a stripe starting at global row
// row0; ref: uint8 [H, W], the whole reference (rows, H, W multiples of
// 16, row0 + rows <= H); mv_r16, mv_c16: int32 [rows/16, W/16] full-pel;
// taps: int32 [16, 8] REGULAR 8-tap kernels by q4 phase; out_r, out_c:
// int32 [rows/16, W/16] eighth-pel MVs; pred: uint8 [rows, W] winning
// predictions.  Returns the CUDA error of the launch.
extern "C" int subpel_refine_launch(const void* src, const void* ref,
                                    int rows, int H, int W, int row0,
                                    const void* mv_r16, const void* mv_c16,
                                    const void* taps, void* out_r,
                                    void* out_c, void* pred, void* stream) {
  if (rows < 16 || rows % 16 || H % 16 || W % 16 || H < kP || W < kP ||
      row0 < 0 || row0 + rows > H)
    return (int)cudaErrorInvalidValue;
  subpel_refine_kernel<<<dim3(W / 16, rows / 16), 256, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const uint8_t*)ref, H, W, row0,
      (const int*)mv_r16,
      (const int*)mv_c16, (const int*)taps, (int*)out_r, (int*)out_c,
      (uint8_t*)pred);
  return (int)cudaGetLastError();
}
