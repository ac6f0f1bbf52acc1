// K3 cdef_direction: CDEF direction and variance of every 8x8 luma unit.
//
// Replaces the JAX package's normative direction search
// (svt_av1_tpu/ops/cdef.py find_dir_grid; B9), which ran inside the fused
// filter chain and the standalone CDEF programs (B13) and, lacking int64
// on the TPU, squared its partial sums in base-2^9 digits.
//
// What bounds it on the H100: latency.  A 1080p frame has 32,400 units of
// 64 samples (2 MB of int32 to read, 260 KB to write); the arithmetic is
// about 1,000 integer operations per unit, far below the card's rate.
//
// Design: one thread per unit.  The thread reads its 64 samples
// (CDEF_VERY_LARGE outside the frame, as pad_very_large), accumulates the
// 8 directions' 15 partial sums, forms each direction's cost in int64
// (svt_cdef_find_dir_c), takes the first maximum and returns
// var = (cost[best] - cost[(best + 4) & 7]) >> 10.  Later work: a warp
// per unit with coalesced row reads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVeryLarge = 16384;

// cost weights W[d][b] of the reference (ops/cdef.py _dir_matrices)
__constant__ int kDiv[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};

__device__ __forceinline__ long long weight(int d, int b) {
  if (d == 0 || d == 4) {
    const int m = b < 14 - b ? b : 14 - b;
    return kDiv[m + 1];
  }
  if (d == 2 || d == 6) return b < 8 ? kDiv[8] : 0;
  // odd directions: bins 0..2 and 8..10 taper, 3..7 full, 11..14 empty
  if (b < 3) return kDiv[2 * b + 2];
  if (b < 8) return kDiv[8];
  if (b < 11) return kDiv[2 * (10 - b) + 2];
  return 0;
}

__global__ void cdef_direction_kernel(const int* __restrict__ plane, int H,
                                      int W, int fh, int fw, int cs,
                                      int* __restrict__ dirs,
                                      int* __restrict__ var) {
  const int uw = (fw + 7) >> 3, uh = (fh + 7) >> 3;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= uh * uw) return;
  const int by = idx / uw, bx = idx - by * uw;
  int partial[8][15];
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int b = 0; b < 15; ++b) partial[d][b] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int y = 8 * by + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int x = 8 * bx + j;
      const int v = (y < fh && x < fw) ? plane[y * W + x] : kVeryLarge;
      const int xv = (v >> cs) - 128;
      partial[0][i + j] += xv;
      partial[1][i + j / 2] += xv;
      partial[2][i] += xv;
      partial[3][3 + i - j / 2] += xv;
      partial[4][7 + i - j] += xv;
      partial[5][3 - i / 2 + j] += xv;
      partial[6][j] += xv;
      partial[7][i / 2 + j] += xv;
    }
  }
  long long cost[8];
  int best = 0;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    long long s = 0;
#pragma unroll
    for (int b = 0; b < 15; ++b) {
      const long long p = partial[d][b];
      s += weight(d, b) * p * p;
    }
    cost[d] = s;
  }
#pragma unroll
  for (int d = 1; d < 8; ++d)
    if (cost[d] > cost[best]) best = d;
  dirs[idx] = best;
  var[idx] = (int)((cost[best] - cost[(best + 4) & 7]) >> 10);
}

}  // namespace

// plane: int32 [H, W] luma (frame = [0, fh) x [0, fw)); dirs, var: int32
// [ceil(fh / 8), ceil(fw / 8)].
extern "C" int cdef_direction_launch(const void* plane, int H, int W, int fh,
                                     int fw, int cs, void* dirs, void* var,
                                     void* stream) {
  const int n = ((fh + 7) >> 3) * ((fw + 7) >> 3);
  if (n <= 0) return 0;
  const int threads = 128;
  cdef_direction_kernel<<<(n + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
      (const int*)plane, H, W, fh, fw, cs, (int*)dirs, (int*)var);
  return (int)cudaGetLastError();
}
