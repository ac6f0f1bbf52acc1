// K10 block_var16: the variance sum of every 16x16 block of a plane.
//
// Replaces the variance half of the JAX package's TPL statistics
// (svt_av1_tpu/pipeline/tpl.py _block16_stats :28, lines 34-37, traced in
// _jitted_stats :44) (B11); the other half, the 16x16 frame ME, runs
// through K5/K6.
//
// What bounds it on the H100: bytes, and at the TPL geometry (576x960)
// launch latency: the plane is 0.55 MB and the output 8.6 KB, about 0.2
// microseconds of HBM traffic, while the arithmetic is 5 operations per
// sample.
//
// Design: 8 threads per block of 16x16, 4 blocks per warp.  Each thread
// first sums its 32 samples as integers and the 8 threads exchange their
// sums (exact), so the float32 mean sum / 256 is exact; each deviation
// b - mean is exact too, and its square rounds once (__fmul_rn: no
// multiply-add is contracted).  Thread j of the 8 owns lane j of the
// summation order the plain version fixes (tpl.block_var16_plain): the
// block read column by column in runs of 8 rows, run r added to lane
// r mod 8 in turn; the 8 lanes are then folded in halves with shuffles
// (4, 2, 1).  Kernel and plain version agree to the bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) block_var16_kernel(
    const uint8_t* __restrict__ plane, int H, int W,
    float* __restrict__ out) {
  const int nc = W / 16, n_blocks = (H / 16) * nc;
  const int g = blockIdx.x * (kThreads / 8) + (threadIdx.x >> 3);
  const int j = threadIdx.x & 7;
  // whole 8-lane groups stay in the shuffles; groups past the end read
  // block 0 and store nothing
  const int blk = g < n_blocks ? g : 0;
  const int by = (blk / nc) * 16, bx = (blk % nc) * 16;
  // run r (r = 0..31) is column r / 2, rows (r % 2) * 8 .. + 8; lane j
  // takes element j of every run
  int v[32];
  int s = 0;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    v[r] = plane[(size_t)(by + (r & 1) * 8 + j) * W + bx + (r >> 1)];
    s += v[r];
  }
  for (int off = 4; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off, 8);
  const float mean = __fmul_rn((float)s, 0.00390625f);   // exact: s / 256
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const float d = __fsub_rn((float)v[r], mean);
    const float sq = __fmul_rn(d, d);
    acc = r == 0 ? sq : __fadd_rn(acc, sq);
  }
  for (int half = 4; half > 0; half >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, half, 8));
  if (j == 0 && g < n_blocks) out[g] = acc;
}

}  // namespace

// plane: uint8 [H, W] (H, W multiples of 16); out: float32 [H/16, W/16].
// Returns the CUDA error of the launch.
extern "C" int block_var16_launch(const void* plane, int H, int W, void* out,
                                  void* stream) {
  if (H <= 0 || W <= 0 || H % 16 || W % 16)
    return (int)cudaErrorInvalidValue;
  const int n_blocks = (H / 16) * (W / 16);
  const int per = kThreads / 8;
  block_var16_kernel<<<(n_blocks + per - 1) / per, kThreads, 0,
                       (cudaStream_t)stream>>>((const uint8_t*)plane, H, W,
                                               (float*)out);
  return (int)cudaGetLastError();
}
