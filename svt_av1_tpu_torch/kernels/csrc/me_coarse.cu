// K5 me_coarse: SB-level coarse motion search on /8 decimated planes, in
// one launch per call.
//
// Replaces the JAX package's coarse_sb_search (svt_av1_tpu/ops/bme.py:42,
// with _decimate8 :34), traced inside _jitted_inter
// (svt_av1_tpu/pipeline/batched_inter.py:398) as a lax.scan over the
// (2r+1)^2 offsets of full-plane shifted absolute differences.
//
// What bounds it on the H100: almost nothing.  At 1080p the planes are
// 2.2 MB of bytes each and 540 superblocks x 289..2401 offsets x 64
// absolute differences is 10-83 M byte pairs, a few microseconds of the
// card's integer rate; the launch and its latency set the time.
//
// Design.  A decimated sample is the sum of an 8x8 box >> 6, at most 255,
// so the decimated planes are bytes: four to a 32-bit word.  The 8x8
// decimated source tile of an SB is 16 words in registers, and an
// offset's SAD is 16 VABSDIFF4 with accumulate (two chains); a reference
// row at a column offset that is not a multiple of 4 is built from
// aligned words with __byte_perm.  The (2r+1)^2 offsets are split over
// the block: thread t takes the column offset t % (2r+1) and a run of
// consecutive row offsets from t / (2r+1), sliding a window of 8 shifted
// rows in registers (one new row, two __byte_perm, per offset), and keeps
// its own first minimum of SAD + |dy| + |dx|; a lexicographic (cost,
// raster index) reduction over the block then gives the scan's strict-<
// first minimum.  The reference is read with its
// decimated indices clamped to the plane (the JAX form's edge pad).
//
// Each block decimates its own source tile and its (8+2r)^2-sample
// reference region straight from the uint8 planes into shared memory
// (8-byte loads where the planes are 8-byte aligned, dp4a sums), so the
// call is one launch.  Neighbouring blocks decimate the same reference
// boxes again: (8+2r)^2 / 64 times over, 9x at r = 8 and 49x at r = 24,
// read through L2.  (A cooperative launch that decimated the reference
// once, passed a grid barrier and then searched measured 1.3 us slower at
// r 8 and 1.2-3.8 us faster at r 16-24 on an H100; PERF.md §6.)
// The source may be a stripe of the frame (rows starting at global row
// row0) searched against the whole reference: its SBs then sit row0 / 8
// decimated rows further down.
//
// The 16-bit form (uint16_t: int16 planes of 10-bit samples, [0, 1023]).
// A decimated sample is then at most 1023, so the decimated planes are
// 16-bit words, two to a 32-bit word: the region rows take 2 bytes a
// sample, and box8 sums a box from 16-byte loads with __dp2a_lo (two
// 16-bit samples by byte weights of 1).  The SADs take two 16-bit
// absolute differences per word as packed halves (sad16.cuh): an
// offset's 32 words add at most 32 x 1023 = 32,736 to each half, so
// neither half carries into the other, and the two halves are summed
// once per offset.  The 8-row window of shifted rows would take 32
// registers here, more than the 48 that keep five blocks on an SM, so a
// thread reads each offset's rows (five words, four funnel shifts) and
// the source tile (a broadcast 16-byte load per row) from shared memory;
// the partition of the offsets and the reduction are the 8-bit form's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sad16.cuh"

namespace {

constexpr int kMaxR = 32;
constexpr int kMaxL = 8 + 2 * kMaxR;
// words per region row: kMaxL bytes and the word __byte_perm reads past
// the last column; odd, so that rows fall on different banks
constexpr int kRowWords = kMaxL / 4 + 3;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// blocks per SM: at most 48 registers a thread, so that the 540 SBs of a
// 1920x1152 plane fit the card's 132 SMs at once
constexpr int kBlocksPerSm = 5;

// the 16-bit form's words per region row: kMaxL samples, two to a word,
// and the word its funnel shifts read past the last column; odd
constexpr int kRowWords16 = kMaxL / 2 + 3;

template <typename T>
struct Shared;

template <>
struct Shared<uint8_t> {
  uint32_t reg[kMaxL * kRowWords];  // decimated reference region, bytes
  uint32_t tile[16];                // decimated source tile, 8 rows x 8
  int red_c[kWarps], red_i[kWarps];
};

template <>
struct Shared<uint16_t> {
  uint32_t reg[kMaxL * kRowWords16];  // the region, 16-bit samples
  uint32_t tile[32];                  // the source tile, 8 rows x 4 words
  int red_c[kWarps], red_i[kWarps];
};

template <typename T>
struct Args {
  const T* src;        // [rows, W]
  const T* ref;        // [H, W]
  int rows, H, W, R, row0_8;
  int aligned;         // both planes at 8-byte (16-bit: 16-byte) boundaries
  int* out;            // [rows/64, W/64, 2]
};

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

// acc + sum of |a - b| over the four byte pairs: one VABSDIFF4.U8.ACC
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b,
                                         uint32_t acc) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(acc));
  return d;
}

// (sum of the 8x8 box at p) >> 6: eight 8-byte loads and sixteen dp4a on
// planes at 8-byte boundaries (``aligned``), 64 byte loads otherwise
__device__ __forceinline__ uint32_t box8(const uint8_t* p, int W,
                                         bool aligned) {
  uint32_t s = 0;
  if (aligned) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint2 v =
          __ldg(reinterpret_cast<const uint2*>(p + (size_t)i * W));
      s = __dp4a(v.x, 0x01010101u, s);
      s = __dp4a(v.y, 0x01010101u, s);
    }
  } else {
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s += __ldg(p + (size_t)i * W + j);
  }
  return s >> 6;
}

// the 16-bit form: eight 16-byte loads and thirty-two dp2a on planes at
// 16-byte boundaries (``aligned``), 64 loads otherwise; at most 1023
__device__ __forceinline__ uint32_t box8(const uint16_t* p, int W,
                                         bool aligned) {
  uint32_t s = 0;
  if (aligned) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint4 v =
          __ldg(reinterpret_cast<const uint4*>(p + (size_t)i * W));
      s = __dp2a_lo(v.x, 0x0101u, s);
      s = __dp2a_lo(v.y, 0x0101u, s);
      s = __dp2a_lo(v.z, 0x0101u, s);
      s = __dp2a_lo(v.w, 0x0101u, s);
    }
  } else {
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s += __ldg(p + (size_t)i * W + j);
  }
  return s >> 6;
}

template <typename T>
__device__ __forceinline__ void set_sample(uint32_t* words, int i,
                                           uint32_t v) {
  reinterpret_cast<T*>(words)[i] = (T)v;
}

// the source tile of SB (sby, sbx), decimated straight from the plane
template <typename T>
__device__ __forceinline__ void load_tile(Shared<T>& sm, const Args<T>& a,
                                          int sby, int sbx) {
  const int t = threadIdx.x;
  if (t < 64)
    set_sample<T>(sm.tile, t,
                  box8(a.src + (size_t)(sby * 64 + (t >> 3) * 8) * a.W +
                           sbx * 64 + (t & 7) * 8,
                       a.W, a.aligned));
}

// the block's lexicographic (cost, raster index) minimum of the threads'
// own minima; thread 0 writes SB ``sb``'s MV
template <typename T>
__device__ __forceinline__ void reduce_write(Shared<T>& sm, const Args<T>& a,
                                             int sb, int best_c,
                                             int best_i) {
  const int R = a.R, npos = 2 * R + 1;
  const int t = threadIdx.x;
  for (int off = 16; off > 0; off >>= 1) {
    const int c2 = __shfl_down_sync(0xffffffffu, best_c, off);
    const int i2 = __shfl_down_sync(0xffffffffu, best_i, off);
    keep_min(best_c, best_i, c2, i2);
  }
  if ((t & 31) == 0) {
    sm.red_c[t >> 5] = best_c;
    sm.red_i[t >> 5] = best_i;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kWarps; ++w)
      keep_min(best_c, best_i, sm.red_c[w], sm.red_i[w]);
    a.out[sb * 2] = (best_i / npos - R) * 8;
    a.out[sb * 2 + 1] = (best_i % npos - R) * 8;
  }
}

// the shifted reference words of region row ``row`` at the thread's column
// offset: bytes ax .. ax + 3 and ax + 4 .. ax + 7 of the row
__device__ __forceinline__ void row_words(const Shared<uint8_t>& sm, int row,
                                          int q,
                                          uint32_t sel, uint32_t& lo,
                                          uint32_t& hi) {
  const uint32_t* w = sm.reg + row * kRowWords + q;
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
  lo = __byte_perm(w0, w1, sel);
  hi = __byte_perm(w1, w2, sel);
}

// the search of one SB over the region and tile in shared memory (both
// loaded, a barrier passed); thread 0 writes the MV.  Thread t takes the
// column offset ax = t % npos and a run of row offsets from t / npos;
// the 8 shifted rows of its window stay in registers, one new row per
// offset
__device__ void search(Shared<uint8_t>& sm, const Args<uint8_t>& a, int sb) {
  const int R = a.R, npos = 2 * R + 1;
  const int t = threadIdx.x;
  const int groups = kThreads / npos;  // >= 3 for R <= 32
  const int run = (npos + groups - 1) / groups;
  const int ax = t % npos, g = t / npos;
  const int ay0 = g * run, ay1 = min(ay0 + run, npos);
  int best_c = 0x7fffffff, best_i = 0x7fffffff;
  if (g < groups && ay0 < ay1) {
    uint32_t s[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) s[k] = sm.tile[k];
    const int q = ax >> 2;
    const uint32_t sel = 0x3210u + 0x1111u * (uint32_t)(ax & 3);
    const int bias_x = abs(ax - R);
    // slot (row - ay0) & 7 holds region row ``row``
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 7; ++i) row_words(sm, ay0 + i, q, sel, lo[i], hi[i]);
    for (int base = ay0; base < ay1; base += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ay = base + j;
        if (ay < ay1) {
          row_words(sm, ay + 7, q, sel, lo[(j + 7) & 7], hi[(j + 7) & 7]);
          uint32_t acc0 = 0, acc1 = 0;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc0 = sad4(s[2 * i], lo[(j + i) & 7], acc0);
            acc1 = sad4(s[2 * i + 1], hi[(j + i) & 7], acc1);
          }
          // this thread's offsets come in raster order: strict < keeps
          // the first of its own minima
          const int cost = (int)(acc0 + acc1) + abs(ay - R) + bias_x;
          if (cost < best_c) {
            best_c = cost;
            best_i = ay * npos + ax;
          }
        }
      }
    }
  }
  reduce_write(sm, a, sb, best_c, best_i);
}

// the 16-bit form's search: the 8-bit form's partition of the offsets,
// each offset's eight rows read from shared memory (see the head note)
__device__ void search16(Shared<uint16_t>& sm, const Args<uint16_t>& a,
                         int sb) {
  const int R = a.R, npos = 2 * R + 1;
  const int t = threadIdx.x;
  const int groups = kThreads / npos;
  const int run = (npos + groups - 1) / groups;
  const int ax = t % npos, g = t / npos;
  const int ay0 = g * run, ay1 = min(ay0 + run, npos);
  int best_c = 0x7fffffff, best_i = 0x7fffffff;
  if (g < groups && ay0 < ay1) {
    const int q = ax >> 1, sh = (ax & 1) * 16;
    const int bias_x = abs(ax - R);
    for (int ay = ay0; ay < ay1; ++ay) {
      uint32_t acc = 0;  // two packed 16-bit sums
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t* w = sm.reg + (ay + i) * kRowWords16 + q;
        const uint4 s = *reinterpret_cast<const uint4*>(sm.tile + 4 * i);
        const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3], w4 = w[4];
        acc = sad16x2(s.x, __funnelshift_r(w0, w1, sh), acc);
        acc = sad16x2(s.y, __funnelshift_r(w1, w2, sh), acc);
        acc = sad16x2(s.z, __funnelshift_r(w2, w3, sh), acc);
        acc = sad16x2(s.w, __funnelshift_r(w3, w4, sh), acc);
      }
      const int cost = (int)halves16(acc) + abs(ay - R) + bias_x;
      if (cost < best_c) {
        best_c = cost;
        best_i = ay * npos + ax;
      }
    }
  }
  reduce_write(sm, a, sb, best_c, best_i);
}

// one block per SB, decimating its own tile and region
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    me_coarse_kernel(const Args<T> a) {
  __shared__ __align__(16) Shared<T> sm;
  constexpr int kRowSamples =
      (sizeof(T) == 1 ? kRowWords : kRowWords16) * (4 / (int)sizeof(T));
  const int sby = blockIdx.y, sbx = blockIdx.x;
  const int L = 8 + 2 * a.R;
  const int hr8 = a.H >> 3, w8 = a.W >> 3;
  load_tile(sm, a, sby, sbx);
#pragma unroll 2
  for (int k = threadIdx.x; k < L * L; k += kThreads) {
    const int i = k / L, j = k - (k / L) * L;
    const int y = clampi(a.row0_8 + sby * 8 - a.R + i, 0, hr8 - 1);
    const int x = clampi(sbx * 8 - a.R + j, 0, w8 - 1);
    set_sample<T>(sm.reg, i * kRowSamples + j,
                  box8(a.ref + (size_t)y * 8 * a.W + x * 8, a.W, a.aligned));
  }
  __syncthreads();
  if constexpr (sizeof(T) == 1)
    search(sm, a, sby * gridDim.x + sbx);
  else
    search16(sm, a, sby * gridDim.x + sbx);
}

template <typename T>
int launch(const void* src, const void* ref, int rows, int H, int W, int R,
           int row0, void* out, void* stream) {
  const int align = 8 * (int)sizeof(T);
  Args<T> a{(const T*)src, (const T*)ref, rows, H, W, R, row0 / 8,
            ((uintptr_t)src | (uintptr_t)ref) % align == 0, (int*)out};
  me_coarse_kernel<T><<<dim3(W / 64, rows / 64), kThreads, 0,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// src: [rows, W], the frame or a stripe starting at global row row0; ref:
// [H, W], the whole reference (rows, H, W, row0 multiples of 64, row0 +
// rows <= H); samples of sample_bytes bytes (1: uint8; 2: 16-bit words of
// 10-bit samples, int16 planes holding [0, 1023]); out: int32 [rows/64,
// W/64, 2] full-pel (row, col) MVs.  Returns the CUDA error of the launch.
extern "C" int me_coarse_launch(const void* src, const void* ref,
                                int sample_bytes, int rows, int H, int W,
                                int R, int row0, void* out, void* stream) {
  if (R < 1 || R > kMaxR || rows < 64 || rows % 64 || H % 64 || W % 64 ||
      row0 < 0 || row0 % 64 || row0 + rows > H ||
      (sample_bytes != 1 && sample_bytes != 2))
    return (int)cudaErrorInvalidValue;
  return sample_bytes == 1
             ? launch<uint8_t>(src, ref, rows, H, W, R, row0, out, stream)
             : launch<uint16_t>(src, ref, rows, H, W, R, row0, out, stream);
}
