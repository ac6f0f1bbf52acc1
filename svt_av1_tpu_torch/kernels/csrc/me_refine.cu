// K6 me_refine: full-pel refinement of the frame ME around two candidate
// origins per 64x64 superblock.
//
// Replaces the JAX package's refinement half of frame_me
// (svt_av1_tpu/ops/bme.py:207-314): sb_windows :117, the 8x8 SAD pyramid
// sad8_surfaces :127 (a lax.scan over the 33x33 offsets), aggregate :167,
// best_offsets :175 with the SB-coherence bias, and the merge of the two
// windows by raw SAD.
//
// What bounds it on the H100: integer work.  Per reference at 1080p,
// 540 SBs x 2 windows x 1089 offsets x 4096 pixels is 4.8 G absolute
// differences; the planes are 2 MB each.  Packed-byte sums
// (__vsadu4: four absolute differences and their sum in one
// instruction) bring that to 1.2 G SIMD operations.
//
// Design: one thread block per SB, 1024 threads, one window at a time.
// The source may be a stripe of the frame starting at global row row0:
// its SBs then sit row0 rows further down the whole reference, whose
// height bounds the window clamps.
// The 64x64 source SB (4 KB) and the 96x96 window (read with clamped
// indices: the JAX form's edge pad; rows padded to 100 bytes so every
// unaligned 8-byte run is two funnel shifts of three aligned words) sit
// in shared memory.  Thread t keeps 8x8 source block (t mod 64) in
// registers and produces that block's SAD for every 16th offset; the
// 8x8 SADs of all 1089 offsets (uint16, exact: at most 64 x 255) stay in
// shared memory (143 KB, rows of 66 halfwords so the reductions below
// read without bank conflicts).  The block then finds the unbiased
// 64x64 winner, and one warp per output block of the requested shapes
// sums its 8x8 SADs per offset, adds the bias area*(|dy-d64y|+|dx-d64x|)
// and keeps the lexicographic (cost, raster index) minimum: the
// first-minimum rule of argmin over the flattened 33x33 grid.  The raw
// SAD is restored from the biased minimum; the second window replaces
// the first only where its raw SAD is strictly smaller.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSB = 64;
constexpr int kR = 16;
constexpr int kWin = kSB + 2 * kR;      // 96
constexpr int kNpos = 2 * kR + 1;       // 33
constexpr int kNoff = kNpos * kNpos;    // 1089
constexpr int kRowWords = 25;           // 100-byte window rows
constexpr int kSadStride = 66;          // halfwords per offset row
constexpr int kThreads = 1024;
constexpr int kMaxOut = 165;            // all 8 ME shapes of one SB
constexpr int kMaxShapes = 8;

constexpr size_t kSadBytes = (size_t)kNoff * kSadStride * 2;   // 143748
constexpr size_t kSadBytesAligned = (kSadBytes + 15) / 16 * 16;
constexpr size_t kWinBytes = (size_t)kWin * kRowWords * 4;
constexpr size_t kSrcBytes = (size_t)kSB * kSB;
constexpr size_t kSmemBytes = kSadBytesAligned + kWinBytes + kSrcBytes;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void keep_min(int& c, int& i, int c2, int i2) {
  if (c2 < c || (c2 == c && i2 < i)) {
    c = c2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_min(int& c, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const int c2 = __shfl_down_sync(0xffffffffu, c, off);
    const int i2 = __shfl_down_sync(0xffffffffu, i, off);
    keep_min(c, i, c2, i2);
  }
}

__global__ void __launch_bounds__(kThreads, 1) me_refine_kernel(
    const uint8_t* __restrict__ src, const uint8_t* __restrict__ ref, int H,
    int W, int row0, const int* __restrict__ coarse,
    const int* __restrict__ spec, int n_shapes, int n_out,
    int* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* sad8 = reinterpret_cast<uint16_t*>(smem);
  uint32_t* win = reinterpret_cast<uint32_t*>(smem + kSadBytesAligned);
  uint32_t* sbw = reinterpret_cast<uint32_t*>(smem + kSadBytesAligned +
                                              kWinBytes);
  __shared__ int res0[kMaxOut * 3];
  __shared__ int red_c[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ int d64[2];
  __shared__ int shp[kMaxShapes * 2];

  const int n = blockIdx.x;
  const int n_sbx = W / kSB;
  // the SB's row in the source, and its global row in the reference
  const int src_y = (n / n_sbx) * kSB, pos_x = (n % n_sbx) * kSB;
  const int pos_y = src_y + row0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid < n_shapes * 2) shp[tid] = spec[tid];
  {
    const int r = tid >> 4, cw = tid & 15;     // 64 rows x 16 words
    sbw[tid] = *reinterpret_cast<const uint32_t*>(
        src + (size_t)(src_y + r) * W + pos_x + cw * 4);
  }

  for (int cand = 0; cand < 2; ++cand) {
    const int cy = cand == 0 ? coarse[n * 2] : 0;
    const int cx = cand == 0 ? coarse[n * 2 + 1] : 0;
    const int oy = clampi(pos_y + cy - kR, -kR, H - kWin + kR);
    const int ox = clampi(pos_x + cx - kR, -kR, W - kWin + kR);
    uint8_t* wb = reinterpret_cast<uint8_t*>(win);
    for (int k = tid; k < kWin * kRowWords * 4; k += kThreads) {
      const int i = k / (kRowWords * 4), j = k - i * (kRowWords * 4);
      wb[k] = ref[(size_t)clampi(oy + i, 0, H - 1) * W +
                  clampi(ox + j, 0, W - 1)];
    }
    __syncthreads();

    // 8x8 SADs: thread t owns source block b = t mod 64 for every 16th
    // offset
    {
      const int b = tid & 63, by = b >> 3, bx = b & 7;
      uint32_t s_lo[8], s_hi[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        s_lo[r] = sbw[(by * 8 + r) * 16 + bx * 2];
        s_hi[r] = sbw[(by * 8 + r) * 16 + bx * 2 + 1];
      }
      for (int o = tid >> 6; o < kNoff; o += kThreads / 64) {
        const int dy = o / kNpos, dx = o - dy * kNpos;
        const int x0 = bx * 8 + dx;
        const int sh = (x0 & 3) * 8;
        const uint32_t* row = win + (by * 8 + dy) * kRowWords + (x0 >> 2);
        unsigned acc = 0;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const uint32_t w0 = row[r * kRowWords];
          const uint32_t w1 = row[r * kRowWords + 1];
          const uint32_t w2 = row[r * kRowWords + 2];
          acc += __vsadu4(__funnelshift_r(w0, w1, sh), s_lo[r]);
          acc += __vsadu4(__funnelshift_r(w1, w2, sh), s_hi[r]);
        }
        sad8[o * kSadStride + b] = (uint16_t)acc;
      }
    }
    __syncthreads();

    // unbiased 64x64 winner of this window
    {
      int bc = 0x7fffffff, bi = 0x7fffffff;
      for (int o = tid; o < kNoff; o += kThreads) {
        int s = 0;
        for (int b = 0; b < 64; ++b) s += sad8[o * kSadStride + b];
        keep_min(bc, bi, s, o);
      }
      warp_min(bc, bi);
      if (lane == 0) {
        red_c[warp] = bc;
        red_i[warp] = bi;
      }
      __syncthreads();
      if (tid == 0) {
        for (int w = 1; w < kThreads / 32; ++w)
          keep_min(bc, bi, red_c[w], red_i[w]);
        d64[0] = bi / kNpos - kR;
        d64[1] = bi % kNpos - kR;
      }
      __syncthreads();
    }
    const int d64y = d64[0], d64x = d64[1];

    // one warp per output block of the requested shapes
    for (int j = warp; j < n_out; j += kThreads / 32) {
      int s = 0, base = 0, fy = 0, fx = 0, cnt = 0;
      for (; s < n_shapes; ++s) {
        fy = shp[2 * s];
        fx = shp[2 * s + 1];
        cnt = (8 / fy) * (8 / fx);
        if (j < base + cnt) break;
        base += cnt;
      }
      const int jj = j - base, nox = 8 / fx;
      const int oby = (jj / nox) * fy, obx = (jj % nox) * fx;
      const int area = 64 * fy * fx;
      int bc = 0x7fffffff, bi = 0x7fffffff;
      for (int o = lane; o < kNoff; o += 32) {
        const uint16_t* row = sad8 + o * kSadStride;
        int agg = 0;
        for (int yy = 0; yy < fy; ++yy)
          for (int xx = 0; xx < fx; ++xx)
            agg += row[(oby + yy) * 8 + obx + xx];
        const int dy = o / kNpos - kR, dx = o % kNpos - kR;
        agg += area * (abs(dy - d64y) + abs(dx - d64x));
        keep_min(bc, bi, agg, o);
      }
      warp_min(bc, bi);
      if (lane == 0) {
        const int dy = bi / kNpos - kR, dx = bi % kNpos - kR;
        const int raw = bc - area * (abs(dy - d64y) + abs(dx - d64x));
        const int mv_r = oy + kR + dy - pos_y;
        const int mv_c = ox + kR + dx - pos_x;
        if (cand == 0) {
          res0[j * 3] = mv_r;
          res0[j * 3 + 1] = mv_c;
          res0[j * 3 + 2] = raw;
        } else {
          int* o4 = out + ((size_t)n * n_out + j) * 4;
          const bool take = raw < res0[j * 3 + 2];
          o4[0] = take ? mv_r : res0[j * 3];
          o4[1] = take ? mv_c : res0[j * 3 + 1];
          o4[2] = take ? raw : res0[j * 3 + 2];
          o4[3] = take ? 1 : 0;
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// src: uint8 [rows, W], the frame or a stripe starting at global row
// row0; ref: uint8 [H, W], the whole reference (whole 64x64 SBs, row0 +
// rows <= H; below 96 samples a window's origin clamps to -16, where
// both clip bounds meet at 64); coarse: int32 [N, 2] full-pel coarse MVs per
// SB of the source (raster order); spec: int32
// [n_shapes, 2] (h/8, w/8) per shape; out: int32 [N, n_out, 4] = (mv_r,
// mv_c, raw SAD, winning window) per output block, shapes in spec order,
// blocks raster within each shape.  Returns the CUDA error of the launch.
extern "C" int me_refine_launch(const void* src, const void* ref, int rows,
                                int H, int W, int row0, const void* coarse,
                                const void* spec, int n_shapes, int n_out,
                                void* out, void* stream) {
  if (rows < kSB || rows % kSB || H % kSB || W < kSB || W % kSB ||
      row0 < 0 || row0 % kSB || row0 + rows > H ||
      n_shapes < 1 || n_shapes > kMaxShapes || n_out < 1 || n_out > kMaxOut)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      me_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int n = (rows / kSB) * (W / kSB);
  me_refine_kernel<<<n, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const uint8_t*)ref, H, W, row0,
      (const int*)coarse, (const int*)spec, n_shapes, n_out, (int*)out);
  return (int)cudaGetLastError();
}
