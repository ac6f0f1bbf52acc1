// K5 me_coarse: SB-level coarse motion search on /8 decimated planes.
//
// Replaces the JAX package's coarse_sb_search (svt_av1_tpu/ops/bme.py:42,
// with _decimate8 :34), traced inside _jitted_inter
// (svt_av1_tpu/pipeline/batched_inter.py:398) as a lax.scan over the
// (2r+1)^2 offsets of full-plane shifted absolute differences.
//
// What bounds it on the H100: almost nothing.  At 1080p the decimated
// planes are 144x240 int32 (138 KB each); 540 superblocks x 289..2401
// offsets x 64 absolute differences is 10-83 M integer operations, a few
// microseconds of the card's integer rate, and the bytes are smaller
// still.  The two launches and their latency set its time.
//
// Design: launch 1 decimates both planes (one thread per 8x8 box, sum
// >> 6), each by its own height: the source may be a stripe of the frame
// (rows starting at global row row0) searched against the whole
// reference.  Launch 2 runs one thread block per 64x64 superblock of the
// source: the SB's 8x8 decimated source tile and the (8+2r)^2 decimated
// reference region around its global position (row0 / 8 rows further
// down) go to shared memory, read with indices clamped to the
// reference (the JAX form's edge pad), and the block's threads loop over
// the offsets, each keeping its own first minimum of SAD + |dy| + |dx|.
// The block then reduces (cost, raster index) pairs lexicographically,
// which is the scan's strict-< first-minimum rule.  No state carries
// between blocks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxR = 32;
constexpr int kMaxReg = 8 + 2 * kMaxR;
constexpr int kThreads = 256;

// boxes [0, hs8 * w8) decimate the source, the rest the reference
__global__ void decimate8_kernel(const uint8_t* __restrict__ src,
                                 const uint8_t* __restrict__ ref, int W,
                                 int hs8, int hr8, int w8,
                                 int* __restrict__ s8,
                                 int* __restrict__ r8) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (hs8 + hr8) * w8) return;
  const bool is_src = i < hs8 * w8;
  if (!is_src) i -= hs8 * w8;
  const uint8_t* plane = is_src ? src : ref;
  const int y = i / w8, x = i - (i / w8) * w8;
  int sum = 0;
  for (int r = 0; r < 8; ++r) {
    const int o = (y * 8 + r) * W + x * 8;
    for (int c = 0; c < 8; ++c) sum += plane[o + c];
  }
  (is_src ? s8 : r8)[i] = sum >> 6;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// lexicographic (cost, index) minimum: equal costs keep the lower index
__device__ __forceinline__ void keep_min(int& c, int& i, int c2, int i2) {
  if (c2 < c || (c2 == c && i2 < i)) {
    c = c2;
    i = i2;
  }
}

// r8: the whole reference [hr8, w8]; row0_8: the source's first row in
// the decimated reference
__global__ void coarse_search_kernel(const int* __restrict__ s8,
                                     const int* __restrict__ r8, int hr8,
                                     int w8, int row0_8, int R,
                                     int* __restrict__ out) {
  __shared__ int tile[64];
  __shared__ int reg[kMaxReg * kMaxReg];
  __shared__ int red_c[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  const int sby = blockIdx.y, sbx = blockIdx.x;
  const int tid = threadIdx.x;
  const int L = 8 + 2 * R;
  if (tid < 64) tile[tid] = s8[(sby * 8 + tid / 8) * w8 + sbx * 8 + tid % 8];
  for (int k = tid; k < L * L; k += kThreads) {
    const int a = k / L, b = k - (k / L) * L;
    reg[k] = r8[clampi(row0_8 + sby * 8 - R + a, 0, hr8 - 1) * w8 +
                clampi(sbx * 8 - R + b, 0, w8 - 1)];
  }
  __syncthreads();
  const int npos = 2 * R + 1;
  int best_c = 0x7fffffff, best_i = 0x7fffffff;
  for (int o = tid; o < npos * npos; o += kThreads) {
    const int ay = o / npos, ax = o - (o / npos) * npos;  // dy + R, dx + R
    int cost = 0;
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 8; ++j)
        cost += abs(tile[i * 8 + j] - reg[(i + ay) * L + j + ax]);
    cost += abs(ay - R) + abs(ax - R);
    keep_min(best_c, best_i, cost, o);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int c2 = __shfl_down_sync(0xffffffffu, best_c, off);
    const int i2 = __shfl_down_sync(0xffffffffu, best_i, off);
    keep_min(best_c, best_i, c2, i2);
  }
  if ((tid & 31) == 0) {
    red_c[tid >> 5] = best_c;
    red_i[tid >> 5] = best_i;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kThreads / 32; ++w)
      keep_min(best_c, best_i, red_c[w], red_i[w]);
    const int o = (sby * gridDim.x + sbx) * 2;
    out[o] = (best_i / npos - R) * 8;
    out[o + 1] = (best_i % npos - R) * 8;
  }
}

}  // namespace

// src: uint8 [rows, W], the frame or a stripe starting at global row
// row0; ref: uint8 [H, W], the whole reference (rows, H, W, row0
// multiples of 64, row0 + rows <= H); s8: int32 scratch [rows/8, W/8];
// r8: int32 scratch [H/8, W/8]; out: int32 [rows/64, W/64, 2] full-pel
// (row, col) MVs.  Returns the CUDA error of the launches.
extern "C" int me_coarse_launch(const void* src, const void* ref, int rows,
                                int H, int W, int R, int row0, void* s8,
                                void* r8, void* out, void* stream) {
  if (R < 1 || R > kMaxR || rows < 64 || rows % 64 || H % 64 || W % 64 ||
      row0 < 0 || row0 % 64 || row0 + rows > H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int hs8 = rows / 8, hr8 = H / 8, w8 = W / 8;
  decimate8_kernel<<<((hs8 + hr8) * w8 + 255) / 256, 256, 0, st>>>(
      (const uint8_t*)src, (const uint8_t*)ref, W, hs8, hr8, w8, (int*)s8,
      (int*)r8);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  coarse_search_kernel<<<dim3(W / 64, rows / 64), kThreads, 0, st>>>(
      (const int*)s8, (const int*)r8, hr8, w8, row0 / 8, R, (int*)out);
  return (int)cudaGetLastError();
}
