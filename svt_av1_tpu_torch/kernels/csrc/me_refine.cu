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
// differences; the planes are 2 MB each.  Packed-byte sums (four
// absolute differences and their sum per instruction, sad4() below)
// bring that to 1.2 G SIMD operations; the rest is loading window rows
// and aggregating.
//
// Design: one CTA per SB.  The source may be a stripe of the frame
// starting at global row row0: its SBs then sit row0 rows further down
// the whole reference, whose height bounds the window clamps.
// * Windows: 96x96 bytes at origins clamped at most 16 outside the plane,
//   each row stored as 112 bytes from the 16-byte boundary below the
//   window's first column.  A window inside the plane (and a 16-byte
//   aligned reference) loads with 16-byte cp.async; one that touches the
//   border reads bytes at clamped indices (the JAX form's edge pad; TMA
//   would fill zeros there).
// * SADs by a vertical sliding window: a thread owns one band of F 8x8
//   block rows (8F source rows, kept in registers), one block column bx
//   and one horizontal offset dx, and walks the window rows of its band
//   once: each window row is loaded once (three aligned words and two
//   funnel shifts) and compared with every source row it meets, adding
//   to the accumulator of that row pair's vertical offset dy (33
//   accumulators in registers).  A window row then costs 5 loads and
//   shifts per 16F SIMD SADs, where a row per offset costs 5 per 2.
// * Only the requested shapes' level is kept.  When a requested shape
//   has a side of 8 ("fine": 8x8, 16x8, 8x16), F = 1 and the 8x8 SADs of
//   all 1089 offsets go to shared memory (uint16, 140 KB), one window at
//   a time, one CTA per SM.  Otherwise ("coarse": the main path's 16x16
//   and 64x64, TPL's 16x16, MCTF's 32x32) F = 2, each thread's sums are
//   8x16 SADs, and one shuffle with the neighbouring column's lane
//   (bx ^ 1) makes them 16x16 SADs (uint16, exact: at most 256 x 255),
//   so both windows' tables (70 KB) fit one CTA and two CTAs fit an SM.
// * Aggregation: the 64x64 SAD of every offset is built once from the
//   table and gives the window's unbiased 64x64 winner (first minimum);
//   then one warp per output block of the requested shapes and window
//   sums its table entries per offset (the 64x64 shape reads the 64x64
//   sums), adds the bias area*(|dy-d64y|+|dx-d64x|) and keeps the
//   lexicographic (cost, raster index) minimum over its lanes and then
//   by warp shuffles: the first-minimum rule of argmin over the
//   flattened 33x33 grid.  The raw SAD is restored from the biased
//   minimum; the second window replaces the first only where its raw
//   SAD is strictly smaller.
//
// The 16-bit form (int16 planes of 10-bit samples, [0, 1023]) is a kernel
// of its own, me_refine16_kernel, shaped by what the card issues
// (tools/int_pipes.py): VIMNMX.U16x2, IADD3, VABSDIFF4, LOP3, SHF and PRMT
// all share one pipe of 64 lanes per SM and clock, and IDP.2A and IMAD
// another, so a VIMNMX.U16x2 and an IDP.2A together issue about 49 lanes
// each per clock where three VIMNMX/IADD3 take one slot each.
// * SADs by an identity, |a - b| = a + b - 2 min(a, b): per word of two
//   pixel pairs one VIMNMX.U16x2 (min) and one IDP.2A that adds -2 times
//   both halves to a 32-bit sum, where the packed max - min of sad16.cuh
//   takes three instructions of the first pipe.  The source's sum over
//   the unit's rows starts every sum; the window's sum over the rows of
//   offset dy is a difference of two prefix sums of the unit's window
//   rows (two IDP.2A a window row keep the prefix, one add at the
//   offset's first row and one at its last), so each sum ends as the
//   exact SAD.  A
//   thread's column unit is 4 samples (two words): two source words per
//   source row, three window words and two funnel shifts (by 0 or 16
//   bits) per window row; the two (fine) or four (coarse) lanes of an 8x8
//   or 16x16 block are summed by shuffles.
// * One window per CTA: the two CTAs of a cluster take an SB's two
//   windows at once (twice the grid of the 8-bit form, so fewer CTAs wait
//   for a last wave: 1,080 at 1920x1152, 270 at TPL's 960x576), and the
//   second writes its winners into the first's shared memory, which
//   merges them.  A window row is 104 samples (208 bytes) from the
//   8-sample (16-byte) floor of its first column, loaded by 16-byte
//   cp.async or clamped reads.
// * An 8x8 SAD is at most 64 x 1023 = 65,472: the fine table stays
//   uint16 (140 KB, one CTA per SM).  A 16x16 SAD reaches 256 x 1023 =
//   261,888, so the coarse table holds uint32 entries (70 KB; about 103 KB
//   in all, two CTAs per SM).
// * Aggregation: each offset's distance from the window's 64x64 winner is
//   kept in the window's buffer, free by then.  For the plans' and TPL's
//   shapes (16x16 and 64x64 from the coarse table) every thread keeps the
//   17 blocks' first minima over its offsets, then each warp (two REDUX:
//   the least cost, the least offset that reaches it) and the CTA; other
//   shapes take one warp per output block.  One warp per block spent a
//   fifth of the kernel's time in the per-block loops' serial chains.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sad16.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSB = 64;
constexpr int kR = 16;
constexpr int kWin = kSB + 2 * kR;      // 96
constexpr int kNpos = 2 * kR + 1;       // 33
constexpr int kNoff = kNpos * kNpos;    // 1089
constexpr int kTabStride = 1090;        // entries per table row
constexpr int kMaxShapes = 8;

// T: the sample type of the 8-bit form, uint8_t (the 16-bit form's is
// Cfg16 below)
template <typename T, bool kFine>
struct Cfg {
  // a window row from its 16-byte floor: 112 samples
  static constexpr int kRowBytes = 112 * (int)sizeof(T);
  static constexpr int kRowWords = kRowBytes / 4;
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kAlign = 16 / (int)sizeof(T);  // samples per 16 B
  static constexpr int kUnitPx = 8 / (int)sizeof(T);  // a thread's columns
  static constexpr int kUnits = 64 / kUnitPx;         // units per row
  static constexpr int kUnitsLog2 = 3;
  static constexpr int kBandTasks = kUnits * kNpos;   // (dx, unit) pairs
  static constexpr int F = kFine ? 1 : 2;            // block rows per band
  static constexpr int kBands = 8 / F;
  static constexpr int kEntries = kFine ? 64 : 16;   // table entries
  static constexpr int kWins = kFine ? 1 : 2;        // windows at once
  static constexpr int kTasks = kWins * kBands * kBandTasks;
  static constexpr int kThreads = kFine ? 704 : 352;
  static constexpr int kMinBlocks = kFine ? 1 : 2;
  static constexpr int kMaxOut = kFine ? 165 : 37;   // blocks of all shapes
  static constexpr size_t kSrcBytes = (size_t)kSB * kSB * sizeof(T);
  static constexpr size_t kWinBytes = (size_t)kWins * kWin * kRowBytes;
  using Tab = uint16_t;
  static constexpr size_t kTabBytes =
      (size_t)kWins * kEntries * kTabStride * sizeof(Tab);
  static constexpr size_t kS64Bytes = (size_t)kWins * kNoff * 4;
  static constexpr size_t kResBytes = (size_t)2 * kMaxOut * 3 * 4;
  static constexpr size_t kSmemBytes =
      kSrcBytes + kWinBytes + kTabBytes + kS64Bytes + kResBytes;
  static_assert(kTasks % kThreads == 0, "every lane takes whole tasks");
  static_assert(kThreads % 32 == 0, "whole warps");
  static_assert(kSmemBytes <= 232448, "one CTA's shared memory");
  static_assert(sizeof(T) == 1, "the 16-bit form is me_refine16_kernel");
};

struct Spec {
  int n_shapes, n_out;
  int fy[kMaxShapes], fx[kMaxShapes];   // shape in 8x8 units (h/8, w/8)
};

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

// acc + sum of |a - b| over the four byte pairs: one VABSDIFF4.U8.ACC on
// sm_90a with the accumulator as its third operand (__vsadu4(a, b) + acc
// compiles to the same instruction with a zero operand and an IADD3)
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b,
                                         uint32_t acc) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(acc));
  return d;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T, bool kFine>
__global__ void __launch_bounds__(Cfg<T, kFine>::kThreads,
                                  Cfg<T, kFine>::kMinBlocks)
me_refine_kernel(const T* __restrict__ src, const T* __restrict__ ref, int H,
                 int W, int row0, const int* __restrict__ coarse, Spec spec,
                 int* __restrict__ out) {
  using C = Cfg<T, kFine>;
  using Tab = typename C::Tab;
  constexpr int F = C::F;
  constexpr int kT = C::kThreads;
  constexpr int kNWarps = kT / 32;
  constexpr int kRowBytes = C::kRowBytes, kRowWords = C::kRowWords;
  constexpr int kChunks = C::kChunks, kBandTasks = C::kBandTasks;
  constexpr int kUnits = C::kUnits;
  constexpr int kSrcWords = kSB * (int)sizeof(T) / 4;   // per source row
  constexpr int kSrcLog2 = sizeof(T) == 1 ? 4 : 5;
  constexpr int kPerWord = 4 / (int)sizeof(T);          // samples a word
  constexpr int kPerWordLog2 = sizeof(T) == 1 ? 2 : 1;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* sbw = reinterpret_cast<uint32_t*>(smem);
  uint8_t* winb = smem + C::kSrcBytes;
  Tab* tab = reinterpret_cast<Tab*>(winb + C::kWinBytes);
  uint32_t* s64 = reinterpret_cast<uint32_t*>(smem + C::kSrcBytes +
                                              C::kWinBytes + C::kTabBytes);
  int* res = reinterpret_cast<int*>(s64 + C::kWins * kNoff);
  __shared__ int red_c[2][kNWarps];
  __shared__ int red_i[2][kNWarps];
  __shared__ int d64[2][2];

  const int n = blockIdx.x;
  const int n_sbx = W / kSB;
  // the SB's row in the source, and its global row in the reference
  const int src_y = (n / n_sbx) * kSB, pos_x = (n % n_sbx) * kSB;
  const int pos_y = src_y + row0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool ref_aligned = ((uintptr_t)ref & 15) == 0;

  for (int k = tid; k < kSB * kSrcWords; k += kT)     // 64 rows
    sbw[k] = *reinterpret_cast<const uint32_t*>(
        src + (size_t)(src_y + (k >> kSrcLog2)) * W + pos_x +
        (k & (kSrcWords - 1)) * kPerWord);

  for (int pass = 0; pass < 2 / C::kWins; ++pass) {
    // window origins of this pass: candidate 0 at the coarse winner,
    // candidate 1 at the zero MV, clipped so a window starts at most kR
    // outside the plane; oxa is the origin's 16-byte floor
    auto origin = [&](int wi) {
      const int cand = pass * C::kWins + wi;
      const int cy = cand == 0 ? coarse[n * 2] : 0;
      const int cx = cand == 0 ? coarse[n * 2 + 1] : 0;
      return make_int2(clampi(pos_y + cy - kR, -kR, H - kWin + kR),
                       clampi(pos_x + cx - kR, -kR, W - kWin + kR));
    };
#pragma unroll
    for (int wi = 0; wi < C::kWins; ++wi) {
      const int2 o = origin(wi);
      const int oxa = o.y - (o.y & (C::kAlign - 1));
      uint8_t* wb = winb + (size_t)wi * kWin * kRowBytes;
      constexpr int kRowPx = kRowBytes / (int)sizeof(T);
      const bool inside = ref_aligned && o.x >= 0 && o.x + kWin <= H &&
                          oxa >= 0 && oxa + kRowPx <= W;
      if (inside) {
        for (int k = tid; k < kWin * kChunks; k += kT) {
          const int i = k / kChunks, ch = k - i * kChunks;
          cp_async16(wb + i * kRowBytes + ch * 16,
                     ref + (size_t)(o.x + i) * W + oxa + ch * C::kAlign);
        }
      } else {
        T* wt = reinterpret_cast<T*>(wb);
        for (int k = tid; k < kWin * kRowPx; k += kT) {
          const int i = k / kRowPx, j = k - i * kRowPx;
          wt[k] = ref[(size_t)clampi(o.x + i, 0, H - 1) * W +
                      clampi(oxa + j, 0, W - 1)];
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // SADs: task = (window, band, dx, unit), the unit bx fastest
    for (int task = tid; task < C::kTasks; task += kT) {
      const int wi = task / (C::kBands * kBandTasks);
      const int rem = task - wi * (C::kBands * kBandTasks);
      const int band = rem / kBandTasks;
      const int q = rem - band * kBandTasks;
      const int dx = q >> C::kUnitsLog2, bx = q & (kUnits - 1);
      uint32_t s_lo[8 * F], s_hi[8 * F];
#pragma unroll
      for (int i = 0; i < 8 * F; ++i) {
        s_lo[i] = sbw[(band * 8 * F + i) * kSrcWords + bx * 2];
        s_hi[i] = sbw[(band * 8 * F + i) * kSrcWords + bx * 2 + 1];
      }
      // the unit's first window sample, its word and the shift within it
      const int x = (origin(wi).y & (C::kAlign - 1)) + bx * C::kUnitPx + dx;
      const int sh = (x & (kPerWord - 1)) * 8 * (int)sizeof(T);
      const uint32_t* wrow =
          reinterpret_cast<const uint32_t*>(winb + (size_t)wi * kWin *
                                                       kRowBytes) +
          band * 8 * F * kRowWords + (x >> kPerWordLog2);
      uint32_t acc[kNpos];
#pragma unroll
      for (int d = 0; d < kNpos; ++d) acc[d] = 0;
#pragma unroll
      for (int yy = 0; yy < 8 * F + kNpos - 1; ++yy) {
        const uint32_t w0 = wrow[yy * kRowWords];
        const uint32_t w1 = wrow[yy * kRowWords + 1];
        const uint32_t w2 = wrow[yy * kRowWords + 2];
        const uint32_t lo = __funnelshift_r(w0, w1, sh);
        const uint32_t hi = __funnelshift_r(w1, w2, sh);
#pragma unroll
        for (int i = 0; i < 8 * F; ++i) {
          const int dy = yy - i;
          if (dy >= 0 && dy < kNpos)
            acc[dy] = sad4(hi, s_hi[i], sad4(lo, s_lo[i], acc[dy]));
        }
      }
      if (kFine) {
        uint16_t* t = tab + (size_t)(band * 8 + bx) * kTabStride + dx;
#pragma unroll
        for (int d = 0; d < kNpos; ++d) t[d * kNpos] = (uint16_t)acc[d];
      } else {
        uint16_t* t = tab + (size_t)(wi * C::kEntries + band * 4 +
                                     (bx >> 1)) * kTabStride + dx;
#pragma unroll
        for (int d = 0; d < kNpos; ++d) {
          const uint32_t v =
              acc[d] + __shfl_xor_sync(0xffffffffu, acc[d], 1);
          if (!(bx & 1)) t[d * kNpos] = (uint16_t)v;
        }
      }
    }
    __syncthreads();

    // the 64x64 SAD of every offset and each window's unbiased winner
    {
      int bc[C::kWins], bi[C::kWins];
#pragma unroll
      for (int wi = 0; wi < C::kWins; ++wi) {
        bc[wi] = 0x7fffffff;
        bi[wi] = 0x7fffffff;
      }
      for (int o = tid; o < kNoff; o += kT) {
#pragma unroll
        for (int wi = 0; wi < C::kWins; ++wi) {
          const Tab* t = tab + (size_t)wi * C::kEntries * kTabStride + o;
          int s = 0;
#pragma unroll 16
          for (int e = 0; e < C::kEntries; ++e) s += t[e * kTabStride];
          s64[wi * kNoff + o] = s;
          keep_min(bc[wi], bi[wi], s, o);
        }
      }
#pragma unroll
      for (int wi = 0; wi < C::kWins; ++wi) {
        warp_min(bc[wi], bi[wi]);
        if (lane == 0) {
          red_c[wi][warp] = bc[wi];
          red_i[wi][warp] = bi[wi];
        }
      }
      __syncthreads();
      if (tid < C::kWins) {
        int c = red_c[tid][0], i = red_i[tid][0];
        for (int w = 1; w < kNWarps; ++w) keep_min(c, i, red_c[tid][w],
                                                    red_i[tid][w]);
        d64[tid][0] = i / kNpos - kR;
        d64[tid][1] = i % kNpos - kR;
      }
      __syncthreads();
    }

    // one warp per (window, output block) of the requested shapes
    for (int jw = warp; jw < C::kWins * spec.n_out; jw += kNWarps) {
      const int wi = jw / spec.n_out, j = jw - wi * spec.n_out;
      int s = 0, base = 0, fy = 0, fx = 0, cnt = 0;
      for (; s < spec.n_shapes; ++s) {
        fy = spec.fy[s];
        fx = spec.fx[s];
        cnt = (8 / fy) * (8 / fx);
        if (j < base + cnt) break;
        base += cnt;
      }
      const int jj = j - base, nox = 8 / fx;
      const int oby = (jj / nox) * fy, obx = (jj % nox) * fx;
      const int area = 64 * fy * fx;
      const int d64y = d64[wi][0], d64x = d64[wi][1];
      // table entries of the block: 8x8 units (fine) or 16x16 (coarse)
      const int u = kFine ? 1 : 2, tw = 8 / u;
      const int ey0 = oby / u, ex0 = obx / u, ny = fy / u, nx = fx / u;
      const Tab* t = tab + (size_t)wi * C::kEntries * kTabStride;
      const uint32_t* t64 = s64 + wi * kNoff;
      const bool whole = fy == 8 && fx == 8;
      int bc = 0x7fffffff, bi = 0x7fffffff;
      for (int o = lane; o < kNoff; o += 32) {
        int agg = 0;
        if (whole) {
          agg = t64[o];
        } else {
          for (int yy = 0; yy < ny; ++yy)
            for (int xx = 0; xx < nx; ++xx)
              agg += t[((ey0 + yy) * tw + ex0 + xx) * kTabStride + o];
        }
        const int dy = o / kNpos - kR, dx = o % kNpos - kR;
        agg += area * (abs(dy - d64y) + abs(dx - d64x));
        keep_min(bc, bi, agg, o);
      }
      warp_min(bc, bi);
      if (lane == 0) {
        const int dy = bi / kNpos - kR, dx = bi % kNpos - kR;
        int* r = res + ((pass * C::kWins + wi) * C::kMaxOut + j) * 3;
        const int2 og = origin(wi);
        r[0] = og.x + kR + dy - pos_y;
        r[1] = og.y + kR + dx - pos_x;
        r[2] = bc - area * (abs(dy - d64y) + abs(dx - d64x));
      }
    }
    __syncthreads();
  }

  // the second window replaces the first where its raw SAD is smaller
  for (int j = tid; j < spec.n_out; j += kT) {
    const int* r0 = res + j * 3;
    const int* r1 = res + (C::kMaxOut + j) * 3;
    int* o4 = out + ((size_t)n * spec.n_out + j) * 4;
    const bool take = r1[2] < r0[2];
    o4[0] = take ? r1[0] : r0[0];
    o4[1] = take ? r1[1] : r0[1];
    o4[2] = take ? r1[2] : r0[2];
    o4[3] = take ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// The 16-bit form: one window of one SB per CTA, the SADs by the identity
// (design notes at the top)
// ---------------------------------------------------------------------------

template <bool kFine>
struct Cfg16 {
  static constexpr int kRowPx = 104;                 // 7 + 96, rounded up
  static constexpr int kRowBytes = kRowPx * 2;       // a window row
  static constexpr int kRowWords = kRowBytes / 4;
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kUnits = 16;                  // 4-sample units a row
  static constexpr int kBandTasks = kUnits * kNpos;  // (dx, unit) pairs
  static constexpr int kRows = kFine ? 8 : 16;       // source rows a band
  static constexpr int kBands = kSB / kRows;
  static constexpr int kLanes = kRows / 4;           // units of a block
  static constexpr int kEntries = kFine ? 64 : 16;   // table entries
  static constexpr int kTasks = kBands * kBandTasks;
  static constexpr int kThreads = kFine ? 704 : 352;
  static constexpr int kMinBlocks = kFine ? 1 : 2;
  static constexpr int kMaxOut = kFine ? 165 : 37;   // blocks of all shapes
  using Tab = typename std::conditional<kFine, uint16_t, uint32_t>::type;
  static constexpr size_t kSrcBytes = (size_t)kSB * kSB * 2;
  static constexpr size_t kWinBytes = (size_t)kWin * kRowBytes;
  static constexpr size_t kTabBytes = (size_t)kEntries * kTabStride *
                                      sizeof(Tab);
  static constexpr size_t kS64Bytes = (size_t)kNoff * 4;
  // this window's winners, and in the first CTA the second's
  static constexpr size_t kResBytes = (size_t)2 * kMaxOut * 3 * 4;
  static constexpr size_t kSmemBytes =
      kSrcBytes + kWinBytes + kTabBytes + kS64Bytes + kResBytes;
  static_assert(kTasks % kThreads == 0, "every lane takes whole tasks");
  static_assert(kThreads % 32 == 0, "whole warps");
  static_assert(kSmemBytes <= 232448, "one CTA's shared memory");
};

template <bool kFine>
__global__ void __cluster_dims__(2, 1, 1)
    __launch_bounds__(Cfg16<kFine>::kThreads, Cfg16<kFine>::kMinBlocks)
    me_refine16_kernel(const uint16_t* __restrict__ src,
                       const uint16_t* __restrict__ ref, int H, int W,
                       int row0, const int* __restrict__ coarse, Spec spec,
                       int* __restrict__ out) {
  using C = Cfg16<kFine>;
  using Tab = typename C::Tab;
  constexpr int kT = C::kThreads, kNWarps = kT / 32;
  constexpr int kRows = C::kRows, kRowWords = C::kRowWords;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* sbw = reinterpret_cast<uint32_t*>(smem);   // 64 rows x 32 words
  uint8_t* winb = smem + C::kSrcBytes;
  Tab* tab = reinterpret_cast<Tab*>(winb + C::kWinBytes);
  int* s64 = reinterpret_cast<int*>(smem + C::kSrcBytes + C::kWinBytes +
                                    C::kTabBytes);
  int* res = s64 + kNoff;
  __shared__ int red_c[kNWarps];
  __shared__ int red_i[kNWarps];
  __shared__ int d64[2];

  // the cluster's first CTA searches around the coarse winner, the second
  // around the zero MV
  cg::cluster_group cluster = cg::this_cluster();
  const int wi = (int)cluster.block_rank();
  const int n = blockIdx.x >> 1;
  const int n_sbx = W / kSB;
  // the SB's row in the source, and its global row in the reference
  const int src_y = (n / n_sbx) * kSB, pos_x = (n % n_sbx) * kSB;
  const int pos_y = src_y + row0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int k = tid; k < kSB * 32; k += kT)
    sbw[k] = *reinterpret_cast<const uint32_t*>(
        src + (size_t)(src_y + (k >> 5)) * W + pos_x + (k & 31) * 2);

  // the window's origin, clipped so that it starts at most kR outside the
  // plane, and the 8-sample floor of its first column
  const int cy = wi == 0 ? coarse[n * 2] : 0;
  const int cx = wi == 0 ? coarse[n * 2 + 1] : 0;
  const int oy = clampi(pos_y + cy - kR, -kR, H - kWin + kR);
  const int ox = clampi(pos_x + cx - kR, -kR, W - kWin + kR);
  const int oxa = ox & ~7;
  if (((uintptr_t)ref & 15) == 0 && oy >= 0 && oy + kWin <= H &&
      oxa >= 0 && oxa + C::kRowPx <= W) {
    for (int k = tid; k < kWin * C::kChunks; k += kT) {
      const int i = k / C::kChunks, ch = k - i * C::kChunks;
      cp_async16(winb + i * C::kRowBytes + ch * 16,
                 ref + (size_t)(oy + i) * W + oxa + ch * 8);
    }
  } else {
    uint16_t* wt = reinterpret_cast<uint16_t*>(winb);
    for (int k = tid; k < kWin * C::kRowPx; k += kT) {
      const int i = k / C::kRowPx, j = k - i * C::kRowPx;
      wt[k] = ref[(size_t)clampi(oy + i, 0, H - 1) * W +
                  clampi(oxa + j, 0, W - 1)];
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // SADs: task = (band, dx, unit), the unit fastest.  sum[dy] runs from
  // the unit's source sum, adds -2 min per pixel pair and the window's
  // prefix sums p at the offset's last row (+) and before its first (-)
  for (int task = tid; task < C::kTasks; task += kT) {
    const int band = task / C::kBandTasks;
    const int q = task - band * C::kBandTasks;
    const int dx = q >> 4, bx = q & 15;
    uint32_t s_lo[kRows], s_hi[kRows];
    int sa = 0;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      s_lo[i] = sbw[(band * kRows + i) * 32 + bx * 2];
      s_hi[i] = sbw[(band * kRows + i) * 32 + bx * 2 + 1];
      sa = dp2_halves(s_lo[i], kTimes1, dp2_halves(s_hi[i], kTimes1, sa));
    }
    // the unit's first window sample, its word and the shift within it
    const int x = (ox & 7) + bx * 4 + dx;
    const int sh = (x & 1) * 16;
    const uint32_t* wrow = reinterpret_cast<const uint32_t*>(winb) +
                           band * kRows * kRowWords + (x >> 1);
    int sum[kNpos];
#pragma unroll
    for (int d = 0; d < kNpos; ++d) sum[d] = sa;
    int p = 0;
#pragma unroll
    for (int yy = 0; yy < kRows + kNpos - 1; ++yy) {
      const uint32_t w0 = wrow[yy * kRowWords];
      const uint32_t w1 = wrow[yy * kRowWords + 1];
      const uint32_t w2 = wrow[yy * kRowWords + 2];
      const uint32_t lo = __funnelshift_r(w0, w1, sh);
      const uint32_t hi = __funnelshift_r(w1, w2, sh);
      // the unit's window sum over rows 0..yy
      p = dp2_halves(lo, kTimes1, dp2_halves(hi, kTimes1, p));
      if (yy >= kRows - 1) sum[yy - (kRows - 1)] += p;
      if (yy + 1 < kNpos) sum[yy + 1] -= p;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int dy = yy - i;
        if (dy >= 0 && dy < kNpos)
          sum[dy] = dp2_halves(
              __vminu2(hi, s_hi[i]), kTimesMinus2,
              dp2_halves(__vminu2(lo, s_lo[i]), kTimesMinus2, sum[dy]));
      }
    }
    // the 8x8 (fine: two units) or 16x16 (coarse: four) block's SAD on
    // the lane of its first unit
    Tab* t = tab + (size_t)(kFine ? band * 8 + (bx >> 1)
                                  : band * 4 + (bx >> 2)) * kTabStride + dx;
#pragma unroll
    for (int d = 0; d < kNpos; ++d) {
      int v = sum[d] + __shfl_xor_sync(0xffffffffu, sum[d], 1);
      if (!kFine) v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (!(bx & (C::kLanes - 1))) t[d * kNpos] = (Tab)v;
    }
  }
  __syncthreads();

  // the 64x64 SAD of every offset and the window's unbiased winner
  {
    int bc = 0x7fffffff, bi = 0x7fffffff;
    for (int o = tid; o < kNoff; o += kT) {
      const Tab* t = tab + o;
      int s = 0;
#pragma unroll 16
      for (int e = 0; e < C::kEntries; ++e) s += t[e * kTabStride];
      s64[o] = s;
      keep_min(bc, bi, s, o);
    }
    warp_min(bc, bi);
    if (lane == 0) {
      red_c[warp] = bc;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      int c = red_c[0], i = red_i[0];
      for (int w = 1; w < kNWarps; ++w) keep_min(c, i, red_c[w], red_i[w]);
      d64[0] = i / kNpos - kR;
      d64[1] = i % kNpos - kR;
    }
    __syncthreads();
  }
  // each offset's distance from the 64x64 winner, the bias per unit of
  // area, in the window's buffer (free once the table is written)
  int* dist = reinterpret_cast<int*>(winb);
  for (int o = tid; o < kNoff; o += kT)
    dist[o] = abs(o / kNpos - kR - d64[0]) + abs(o % kNpos - kR - d64[1]);
  __syncthreads();

  // the second CTA writes its winners into the first CTA's shared memory
  int* res_w = (wi == 0 ? res : cluster.map_shared_rank(res, 0)) +
               wi * C::kMaxOut * 3;
  // the outputs of the plans' and TPL's shapes (16x16 and 64x64 from the
  // coarse table): every thread takes offsets and keeps each block's first
  // minimum, then each warp and the CTA theirs; other shapes: one warp
  // per output block
  int j16 = -1, j64 = -1;          // the outputs' first index, or -1
  bool fused = !kFine;
  for (int sh = 0, base = 0; sh < spec.n_shapes; ++sh) {
    const int fy = spec.fy[sh], fx = spec.fx[sh];
    if (fy == 2 && fx == 2)
      j16 = base;
    else if (fy == 8 && fx == 8)
      j64 = base;
    else
      fused = false;
    base += (8 / fy) * (8 / fx);
  }
  if constexpr (!kFine) {
    if (fused) {
      __shared__ int blk_c[17][kNWarps];
      __shared__ int blk_i[17][kNWarps];
      int bc[17], bi[17];        // the 16 16x16 blocks, then the 64x64
#pragma unroll
      for (int e = 0; e < 17; ++e) {
        bc[e] = 0x7fffffff;
        bi[e] = 0;
      }
      for (int o = tid; o < kNoff; o += kT) {
        const int d = dist[o];
#pragma unroll
        for (int e = 0; e < 17; ++e) {
          const int c = (e < 16 ? (int)tab[e * kTabStride + o] + 256 * d
                                : s64[o] + 4096 * d);
          if (c < bc[e]) {
            bc[e] = c;
            bi[e] = o;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 17; ++e) {
        const int m = __reduce_min_sync(0xffffffffu, bc[e]);
        const int i = __reduce_min_sync(0xffffffffu,
                                        bc[e] == m ? bi[e] : 0x7fffffff);
        if (lane == 0) {
          blk_c[e][warp] = m;
          blk_i[e][warp] = i;
        }
      }
      __syncthreads();
      if (tid < 17 && (tid < 16 ? j16 : j64) >= 0) {
        int c = blk_c[tid][0], i = blk_i[tid][0];
        for (int w = 1; w < kNWarps; ++w)
          keep_min(c, i, blk_c[tid][w], blk_i[tid][w]);
        const int area = tid < 16 ? 256 : 4096;
        int* r = res_w + (tid < 16 ? j16 + tid : j64) * 3;
        r[0] = oy + kR + i / kNpos - kR - pos_y;
        r[1] = ox + kR + i % kNpos - kR - pos_x;
        r[2] = c - area * dist[i];
      }
    }
  }
  if (!fused) {
    for (int j = warp; j < spec.n_out; j += kNWarps) {
      int s = 0, base = 0, fy = 0, fx = 0, cnt = 0;
      for (; s < spec.n_shapes; ++s) {
        fy = spec.fy[s];
        fx = spec.fx[s];
        cnt = (8 / fy) * (8 / fx);
        if (j < base + cnt) break;
        base += cnt;
      }
      const int jj = j - base, nox = 8 / fx;
      const int oby = (jj / nox) * fy, obx = (jj % nox) * fx;
      const int area = 64 * fy * fx;
      // table entries of the block: 8x8 units (fine) or 16x16 (coarse)
      const int u = kFine ? 1 : 2, tw = 8 / u;
      const int ey0 = oby / u, ex0 = obx / u, ny = fy / u, nx = fx / u;
      const bool whole = fy == 8 && fx == 8;
      // each lane's first minimum (its offsets grow), then the warp's: the
      // least cost, and the least offset of the lanes that reach it
      int bc = 0x7fffffff, bi = 0;
      for (int o = lane; o < kNoff; o += 32) {
        int agg = 0;
        if (whole) {
          agg = s64[o];
        } else {
          for (int yy = 0; yy < ny; ++yy)
            for (int xx = 0; xx < nx; ++xx)
              agg += tab[((ey0 + yy) * tw + ex0 + xx) * kTabStride + o];
        }
        agg += area * dist[o];
        if (agg < bc) {
          bc = agg;
          bi = o;
        }
      }
      const int m = __reduce_min_sync(0xffffffffu, bc);
      bi = __reduce_min_sync(0xffffffffu, bc == m ? bi : 0x7fffffff);
      if (lane == 0) {
        const int dy = bi / kNpos - kR, dx = bi % kNpos - kR;
        int* r = res_w + j * 3;
        r[0] = oy + kR + dy - pos_y;
        r[1] = ox + kR + dx - pos_x;
        r[2] = m - area * dist[bi];
      }
    }
  }
  cluster.sync();

  // the second window replaces the first where its raw SAD is smaller
  if (wi == 0) {
    for (int j = tid; j < spec.n_out; j += kT) {
      const int* r0 = res + j * 3;
      const int* r1 = res + (C::kMaxOut + j) * 3;
      int* o4 = out + ((size_t)n * spec.n_out + j) * 4;
      const bool take = r1[2] < r0[2];
      o4[0] = take ? r1[0] : r0[0];
      o4[1] = take ? r1[1] : r0[1];
      o4[2] = take ? r1[2] : r0[2];
      o4[3] = take ? 1 : 0;
    }
  }
}

template <bool kFine>
int launch16(const void* src, const void* ref, int rows, int H, int W,
             int row0, const void* coarse, const Spec& spec, void* out,
             void* stream) {
  using C = Cfg16<kFine>;
  if (spec.n_out > C::kMaxOut) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      me_refine16_kernel<kFine>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int n = (rows / kSB) * (W / kSB);
  me_refine16_kernel<kFine><<<2 * n, C::kThreads, C::kSmemBytes,
                              (cudaStream_t)stream>>>(
      (const uint16_t*)src, (const uint16_t*)ref, H, W, row0,
      (const int*)coarse, spec, (int*)out);
  return (int)cudaGetLastError();
}

template <typename T, bool kFine>
int launch(const void* src, const void* ref, int rows, int H, int W,
           int row0, const void* coarse, const Spec& spec, void* out,
           void* stream) {
  using C = Cfg<T, kFine>;
  if (spec.n_out > C::kMaxOut) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      me_refine_kernel<T, kFine>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int n = (rows / kSB) * (W / kSB);
  me_refine_kernel<T, kFine><<<n, C::kThreads, C::kSmemBytes,
                               (cudaStream_t)stream>>>(
      (const T*)src, (const T*)ref, H, W, row0, (const int*)coarse, spec,
      (int*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// src: [rows, W], the frame or a stripe starting at global row row0; ref:
// [H, W], the whole reference (whole 64x64 SBs, row0 + rows <= H; below
// 96 samples a window's origin clamps to -16, where both clip bounds meet
// at 64); samples of sample_bytes bytes (1: uint8; 2: 16-bit words of
// 10-bit samples, int16 planes holding [0, 1023]); coarse: int32 [N, 2]
// full-pel coarse MVs per SB of the source (raster order); spec: host
// int32 [n_shapes, 2] (h/8, w/8) per shape, each of the 8 ME shapes at
// most once; out: int32 [N, n_out, 4] = (mv_r, mv_c, raw SAD, winning
// window) per output block, shapes in spec order, blocks raster within
// each shape.  Returns the CUDA error of the launch.
extern "C" int me_refine_launch(const void* src, const void* ref,
                                int sample_bytes, int rows, int H, int W,
                                int row0, const void* coarse,
                                const int* spec, int n_shapes, void* out,
                                void* stream) {
  if (rows < kSB || rows % kSB || H % kSB || W < kSB || W % kSB ||
      row0 < 0 || row0 % kSB || row0 + rows > H || n_shapes < 1 ||
      n_shapes > kMaxShapes || (sample_bytes != 1 && sample_bytes != 2))
    return (int)cudaErrorInvalidValue;
  Spec sp{};
  sp.n_shapes = n_shapes;
  bool fine = false;
  for (int s = 0; s < n_shapes; ++s) {
    const int fy = spec[2 * s], fx = spec[2 * s + 1];
    const bool ok = (fy == 1 || fy == 2 || fy == 4 || fy == 8) &&
                    (fx == 1 || fx == 2 || fx == 4 || fx == 8) &&
                    fy * fx <= 64 && fy * 2 >= fx && fx * 2 >= fy &&
                    !(fy == 8 && fx != 8) && !(fx == 8 && fy != 8);
    if (!ok) return (int)cudaErrorInvalidValue;
    sp.fy[s] = fy;
    sp.fx[s] = fx;
    sp.n_out += (8 / fy) * (8 / fx);
    fine |= fy == 1 || fx == 1;
  }
  if (sample_bytes == 2)
    return fine ? launch16<true>(src, ref, rows, H, W, row0, coarse, sp, out,
                                 stream)
                : launch16<false>(src, ref, rows, H, W, row0, coarse, sp,
                                  out, stream);
  return fine ? launch<uint8_t, true>(src, ref, rows, H, W, row0, coarse, sp,
                                      out, stream)
              : launch<uint8_t, false>(src, ref, rows, H, W, row0, coarse, sp,
                                       out, stream);
}
