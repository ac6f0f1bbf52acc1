// K3 cdef_direction: CDEF direction and variance of every 8x8 luma unit.
//
// Replaces the JAX package's normative direction search
// (svt_av1_tpu/ops/cdef.py find_dir_grid; B9), which ran inside the fused
// filter chain and the standalone CDEF programs (B13) and, lacking int64
// on the TPU, squared its partial sums in base-2^9 digits.
//
// What bounds it on the H100: memory.  A 1080p frame has 32,400 units of
// 64 samples: 8.3 MB of int32 to read (2.5 us at 3.35 TB/s), 260 KB to
// write.  The arithmetic, about 1,000 integer operations per unit, is
// about a microsecond of the card's integer issue.
//
// Design:
// * A CTA of 64 threads takes a strip of 32 units of one unit row (8 rows
//   of 256 samples; 1,080 CTAs at 1080p, so that an SM that takes one
//   CTA more than the others waits about 10% longer), read with 16-byte
//   loads along the rows, each thread's 8 issued together
//   (CDEF_VERY_LARGE outside the frame, as pad_very_large), and kept in
//   shared memory as (sample >> cs) - 128, 9 words per unit row, so that
//   the 16 units of a warp read distinct banks.
// * Two lanes per unit.  The 8 directions are 4 families of lines in two
//   orientations: lane 0 reads the unit X as it is, lane 1 turned by a
//   quarter, V[i][j] = X[j][7 - i]; each sums its view into the bins
//   i + j, i + j/2, i and 3 + i - j/2, which are directions 0, 1, 2, 3 of
//   X (lane 0) and 4, 5, 6, 7 (lane 1; the last three with their bins in
//   reverse order, which their symmetric weights do not see).  Both lanes
//   run one code path with static bins, 45 partial sums in registers
//   instead of one thread's 8 x 15, and together the work of one thread
//   per unit.
// * Each direction's cost in int64 (svt_cdef_find_dir_c): a partial sum
//   of 8 samples at CDEF_VERY_LARGE reaches 8 x 16256, a cost about 10^14.
//   The lanes swap their 4 costs with one 64-bit shuffle each, take the
//   first maximum in direction order and var = (cost[best] -
//   cost[best ^ 4]) >> 10.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVeryLarge = 16384;
constexpr int kUnits = 32;                       // units per CTA
constexpr int kThreads = 2 * kUnits;
constexpr int kUnitStride = 9;                   // words per unit and row
constexpr int kRowStride = kUnits * kUnitStride;

// cost weights of the reference (ops/cdef.py _dir_matrices): the 15 bins
// i + j of directions 0 and 4, the 11 bins of the odd directions
// (directions 2 and 6: 105 on each of their 8 bins)
__device__ __forceinline__ int diag_weight(int b) {
  constexpr int kDiv[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
  return kDiv[(b < 14 - b ? b : 14 - b) + 1];
}

__device__ __forceinline__ int odd_weight(int b) {
  constexpr int kDiv[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
  if (b < 3) return kDiv[2 * b + 2];
  if (b < 8) return kDiv[8];
  return kDiv[2 * (10 - b) + 2];
}

__global__ void __launch_bounds__(kThreads) cdef_direction_kernel(
    const int* __restrict__ plane, int W, int fh, int fw, int cs, int vec,
    int* __restrict__ dirs, int* __restrict__ var) {
  __shared__ int strip[8 * kRowStride];
  const int uw = (fw + 7) >> 3;
  const int by = blockIdx.y, bx0 = blockIdx.x * kUnits;
  // 8 rows of 2 * kUnits groups of 4 samples: thread t takes group t of
  // every row, its 8 loads issued before any is used
  const int x = 8 * bx0 + 4 * threadIdx.x;
  const bool whole = vec && x + 3 < fw;
  int4 ld[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int y = 8 * by + r;
    const int* row = plane + y * W;
    if (whole && y < fh) {
      ld[r] = *reinterpret_cast<const int4*>(row + x);
    } else {
      ld[r].x = y < fh && x < fw ? row[x] : kVeryLarge;
      ld[r].y = y < fh && x + 1 < fw ? row[x + 1] : kVeryLarge;
      ld[r].z = y < fh && x + 2 < fw ? row[x + 2] : kVeryLarge;
      ld[r].w = y < fh && x + 3 < fw ? row[x + 3] : kVeryLarge;
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    int* s = strip + r * kRowStride + (threadIdx.x >> 1) * kUnitStride +
             4 * (threadIdx.x & 1);
    s[0] = (ld[r].x >> cs) - 128;
    s[1] = (ld[r].y >> cs) - 128;
    s[2] = (ld[r].z >> cs) - 128;
    s[3] = (ld[r].w >> cs) - 128;
  }
  __syncthreads();
  // lane 0 reads X[i][j], lane 1 V[i][j] = X[j][7 - i]; units past the
  // frame's right edge run on CDEF_VERY_LARGE and store nothing, so that
  // every lane takes part in the shuffles
  const int u = threadIdx.x >> 1, turned = threadIdx.x & 1;
  const int* o = strip + u * kUnitStride + (turned ? 7 : 0);
  const int si = turned ? -1 : kRowStride, sj = turned ? kRowStride : 1;
  int pd[15], po[11], pa[11], pr[8];
#pragma unroll
  for (int b = 0; b < 15; ++b) pd[b] = 0;
#pragma unroll
  for (int b = 0; b < 11; ++b) po[b] = pa[b] = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b) pr[b] = 0;
  // samples 2m and 2m + 1 of a row share their bins of i + j/2, 3 + i -
  // j/2 and i: their sum goes into each
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int x0 = o[i * si + 2 * m * sj], x1 = o[i * si + (2 * m + 1) * sj];
      pd[i + 2 * m] += x0;
      pd[i + 2 * m + 1] += x1;
      const int q2 = x0 + x1;
      po[i + m] += q2;
      pa[3 + i - m] += q2;
      pr[i] += q2;
    }
  // c[k]: the cost of direction 4 * turned + k; w * p stays below 2^31
  long long c[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 15; ++b)
    c[0] += (long long)(diag_weight(b) * pd[b]) * pd[b];
#pragma unroll
  for (int b = 0; b < 11; ++b) {
    c[1] += (long long)(odd_weight(b) * po[b]) * po[b];
    c[3] += (long long)(odd_weight(b) * pa[b]) * pa[b];
  }
#pragma unroll
  for (int b = 0; b < 8; ++b) c[2] += (long long)(105 * pr[b]) * pr[b];
  long long q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = __shfl_xor_sync(0xffffffffu, c[k], 1);
  // the cost of direction d: lane 0's c[d] for d < 4, lane 1's c[d - 4]
  auto cost = [&](int d) {
    return d < 4 ? (turned ? q[d] : c[d]) : (turned ? c[d - 4] : q[d - 4]);
  };
  int best = 0;
  long long top = cost(0), opp = cost(4);
#pragma unroll
  for (int d = 1; d < 8; ++d)
    if (cost(d) > top) {
      top = cost(d);
      opp = cost(d ^ 4);
      best = d;
    }
  const int bx = bx0 + u;
  if (!turned && bx < uw) {
    dirs[by * uw + bx] = best;
    var[by * uw + bx] = (int)((top - opp) >> 10);
  }
}

}  // namespace

// plane: int32 [H, W] luma (frame = [0, fh) x [0, fw)); dirs, var: int32
// [ceil(fh / 8), ceil(fw / 8)].
extern "C" int cdef_direction_launch(const void* plane, int H, int W, int fh,
                                     int fw, int cs, void* dirs, void* var,
                                     void* stream) {
  if (fh > H || fw > W) return (int)cudaErrorInvalidValue;
  const int uh = (fh + 7) >> 3, uw = (fw + 7) >> 3;
  if (uh <= 0 || uw <= 0) return 0;
  const int vec = W % 4 == 0 && ((uintptr_t)plane & 15) == 0;
  const dim3 grid((uw + kUnits - 1) / kUnits, uh);
  cdef_direction_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)plane, W, fh, fw, cs, vec, (int*)dirs, (int*)var);
  return (int)cudaGetLastError();
}
