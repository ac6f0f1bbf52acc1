// K10 block_var16: the variance sum of every 16x16 block of a window of
// planes.
//
// Replaces the variance half of the JAX package's TPL statistics
// (svt_av1_tpu/pipeline/tpl.py _block16_stats :28, lines 34-37, traced in
// _jitted_stats :44/:57 on uint8 planes at bd 8 and uint16 planes at bd 10)
// (B11); the other half, the 16x16 frame ME, runs through K5/K6.
//
// What bounds it on the H100: bytes.  A TPL window of 17 half-resolution
// planes of 960x576 is 18.8 MB at 16 bits (9.4 MB at 8), about 5.6
// microseconds of HBM traffic; the arithmetic is about 5 operations per
// sample and the output 147 KB.  One launch takes the whole window, so
// the per-call host path is paid once per window, not once per plane.
//
// Design: one CTA of 128 threads per strip of 16 rows by a run of 16
// blocks (256 columns) of one plane; the grid is (runs, block rows,
// planes), 144 CTAs for one 960x576 plane and 2,448 for a 17-plane
// window.  The CTA copies its strip into shared memory with coalesced
// 16-byte loads (rows padded by 16 bytes, so that the 8 lanes of a block,
// which read 8 different rows at the same column, hit 8 different bank
// groups), then 8 lanes per block take it from there in the fixed order
// of the plain version (tpl.block_var16_plain): the block read column by
// column in runs of 8 rows, run q added to lane q mod 8, the 8 lanes then
// folded in halves (4, 2, 1) with shuffles.
//
// Exactness, samples in [0, 2^bd), bd <= 10: each lane sums its 32
// samples as integers and the 8 lanes exchange their sums, so the block
// sum s <= 1023 * 256 < 2^18 is exact and the float32 mean s / 256 is
// exact (a multiple of 2^-8 below 2^10: at most 18 significant bits).
// Each deviation b - mean is a multiple of 2^-8 of magnitude below 2^10,
// so it too has at most 18 significant bits and is exact in float32; its
// square rounds once (__fmul_rn), and every sum rounds once (__fadd_rn:
// nothing is contracted into a multiply-add).  Kernel and plain version
// therefore agree to the bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRunBlocks = kThreads / 8;   // 16 blocks of 16 columns
constexpr int kRunCols = kRunBlocks * 16;  // 256 samples

template <typename T>
struct Strip {
  // bytes per shared row: the run's samples and 16 bytes of padding
  static constexpr int kRowBytes = kRunCols * (int)sizeof(T) + 16;
  static constexpr int kRowVecs = kRunCols * (int)sizeof(T) / 16;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) block_var16_kernel(
    const T* __restrict__ planes, int H, int W, float* __restrict__ out) {
  __shared__ __align__(16) uint8_t strip[16 * Strip<T>::kRowBytes];
  const int nc = W / 16, nr = H / 16;
  const int run = blockIdx.x, by = blockIdx.y, p = blockIdx.z;
  const int b0 = run * kRunBlocks;
  const int n_blk = min(kRunBlocks, nc - b0);
  const T* base = planes + ((size_t)p * H + by * 16) * W + b0 * 16;
  // (1) the strip's 16 rows of n_blk * 16 samples, 16 bytes a thread
  const int vecs = n_blk * 16 * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < 16 * Strip<T>::kRowVecs; i += kThreads) {
    const int row = i / Strip<T>::kRowVecs, v = i % Strip<T>::kRowVecs;
    if (v < vecs)
      *reinterpret_cast<uint4*>(strip + row * Strip<T>::kRowBytes + v * 16) =
          reinterpret_cast<const uint4*>(base + (size_t)row * W)[v];
  }
  __syncthreads();
  // (2) lane j of block b: element j of every run of 8 rows, i.e. rows j
  // and j + 8 of the block's 16 columns, read as 16-byte words (run q is
  // column q / 2, rows (q % 2) * 8 .. + 8)
  const int b = threadIdx.x >> 3, j = threadIdx.x & 7;
  constexpr int kWords = 4 * (int)sizeof(T);      // 16 samples of a row
  uint32_t w[2][kWords];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4* rp = reinterpret_cast<const uint4*>(
        strip + (j + 8 * h) * Strip<T>::kRowBytes + b * 16 * sizeof(T));
#pragma unroll
    for (int k = 0; k < kWords / 4; ++k) {
      const uint4 x = rp[k];
      w[h][4 * k] = x.x;
      w[h][4 * k + 1] = x.y;
      w[h][4 * k + 2] = x.z;
      w[h][4 * k + 3] = x.w;
    }
  }
  int v[32];
  int s = 0;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const int c = q >> 1;
    v[q] = sizeof(T) == 1
               ? (int)((w[q & 1][c >> 2] >> (8 * (c & 3))) & 0xffu)
               : (int)((w[q & 1][c >> 1] >> (16 * (c & 1))) & 0xffffu);
    s += v[q];
  }
  for (int off = 4; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off, 8);
  const float mean = __fmul_rn((float)s, 0.00390625f);   // exact: s / 256
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const float d = __fsub_rn((float)v[q], mean);
    const float sq = __fmul_rn(d, d);
    acc = q == 0 ? sq : __fadd_rn(acc, sq);
  }
  for (int half = 4; half > 0; half >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, half, 8));
  // blocks past the plane's last column (a ragged last run) read stale
  // shared memory in whole 8-lane groups and store nothing
  if (j == 0 && b < n_blk) out[((size_t)p * nr + by) * nc + b0 + b] = acc;
}

}  // namespace

// planes: n planes of [H, W] samples of sample_bytes bytes each (1:
// uint8; 2: 16-bit samples in [0, 1024)), H and W multiples of 16, the
// first plane on a 16-byte boundary; out: float32 [n, H/16, W/16].
// Returns the CUDA error of the launch.
extern "C" int block_var16_launch(const void* planes, int n, int H, int W,
                                  int sample_bytes, void* out,
                                  void* stream) {
  if (n <= 0 || H <= 0 || W <= 0 || H % 16 || W % 16 || n > 65535 ||
      H / 16 > 65535 || (sample_bytes != 1 && sample_bytes != 2))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)planes % 16) return (int)cudaErrorMisalignedAddress;
  const dim3 grid((W / 16 + kRunBlocks - 1) / kRunBlocks, H / 16, n);
  if (sample_bytes == 1)
    block_var16_kernel<uint8_t><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)planes, H, W, (float*)out);
  else
    block_var16_kernel<uint16_t><<<grid, kThreads, 0,
                                   (cudaStream_t)stream>>>(
        (const uint16_t*)planes, H, W, (float*)out);
  return (int)cudaGetLastError();
}
