// K9 compound_joint: the averaged-compound candidate of every 16x16 unit of
// an inter frame, with the joint refinement of both arms.
//
// Replaces the compound block of the JAX package's inter_frame_maps
// (svt_av1_tpu/pipeline/batched_inter.py :265-335: the forward/backward
// argmins, _mirror :294, the two _joint_arm searches :119 and the 3-way
// pick), traced inside _jitted_inter (:398) (B4).
//
// What bounds it on the H100: integer work.  At 1080p, 8,640 units x 2
// arms x 49 offsets x 256 pixels of (average, difference, accumulate)
// are about 0.9 G operations against about 10 MB of planes and fields.
//
// Design: one warp per 16x16 unit, four units per 128-thread block (2,160
// blocks at 1920x1152, many resident per SM), no block barrier.  Lanes
// 0-15 take arm 0, lanes 16-31 arm 1, lane r & 15 row r of the unit; all
// pixel work is packed in 32-bit words: four 8-bit samples a word in the
// uint8_t form, two 16-bit samples (10-bit values) in the uint16_t form
// (the sample type is the kernel's template parameter; Px<T> below holds
// what differs).
// (1) Per reference, each lane's row SAD of the reference's quarter-pel
//     prediction (16-byte loads, one VABSDIFF4 with accumulate per word)
//     is summed over the 16 rows by shuffles; with the MV-bits proxy, in
//     the same float steps as K8 step (1), it gives the single-reference
//     score; the unit's forward (fi) and backward (bi) references are the
//     first minima over each side.
// (2) Each arm's seed is the other arm's MV mirrored through the frame and
//     scaled by the two distances (floor division, as the numpy twin's //
//     of negatives).
// (3) Each half-warp loads the 22x22 window of its searched reference into
//     shared memory (aligned words and a funnel shift where the window
//     lies inside the plane's columns, clamped bytes at the edges); the
//     window origin is clipped to an MC_PAD-sample edge pad that clamped
//     reads reproduce.  Lane r keeps its row of the source and of the held
//     arm's prediction in registers (4 + 4 words; 8 + 8 in the uint16_t
//     form) and, for each of the 7
//     window rows r + dy, builds the 7 column offsets' words with PRMT:
//     __vavgu4 is the reference's per-byte (held + win + 1) >> 1, and
//     VABSDIFF4 with accumulate scores it against the source.  The 49 row
//     partial SADs go to shared memory as 16-bit values; lane l sums
//     offsets l, l + 16, l + 32 and l + 48 over the 16 rows and a
//     half-warp reduction keeps the (SAD, raster index) minimum, i.e. the
//     first minimum.
// (4) The plain average of the two predictions, the refined backward arm
//     and the refined forward arm compete by SAD (first minimum); the
//     winner's prediction, SAD and MVs are written.
//
// The uint16_t form (B4 at bd 10, which the JAX package traces on uint16
// planes): a row of the unit is 8 words, the window row 22 samples in 11
// words (48-byte stride), an odd column offset a half-word PRMT of two
// words (10 a window row, shared by the odd offsets).
// * The window: each row's 64 bytes from the 16-byte floor of its first
//   column in 16-byte loads spread over the half-warp (4 rows a load
//   instruction), staged in the partials' shared memory and shifted into
//   place; a lane's own row in 4-byte loads took 12 load instructions
//   that each touched 16 rows.
// * The search scores twice each pixel's |avg - s|, avg = (h + w + 1) >>
//   1: with u = (h + 1 + w) & ~1 = 2 avg, |u - 2s| = u + 2s - 2 min(u,
//   2s).  Per word of two pixels: an add (h + 1 is held per lane, at most
//   1024 + 1023 a half, so no carry), a LOP3, one VIMNMX.U16x2 against
//   the held 2s, one IDP.2A that adds -2 min to a 32-bit sum which starts
//   at the row's sum of 2s (sad16.cuh's dp2_halves), and half an IADD3
//   that adds u to packed halves (at most 8 x 2046 a half; one more
//   IDP.2A adds them to the sum).  The add and the IDP.2A can issue on
//   another pipe than the rest (tools/int_pipes.py), where the rounded-up
//   average __vavgu2 (4 instructions: LOP3, LOP3, SHF, IADD3) and the
//   packed SAD (3: two VIMNMX.U16x2 and an IADD3) all took the first.
//   The row's partial SAD, the sum halved, is at most 16 x 1023 =
//   16,368, which the 16-bit partial slots hold; the sums over 16 rows (at
//   most 261,888) are taken in 32 bits.
// * The other SADs (step 1, the plain average) keep sad16.cuh's packed
//   max - min, over a row's 8 words at most 8 x 1023 = 8,184 a half, and
//   the average __vavgu2, which sm_90a runs as the identity (a | b) -
//   (((a ^ b) & 0xfffefffe) >> 1): per half (a + b + 1) >> 1, since a + b
//   = 2(a & b) + (a ^ b) and a | b = (a & b) + (a ^ b), with no borrow
//   across the halves, since a | b >= (a ^ b) >> 1 in each.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sad16.cuh"

namespace {

constexpr int kWarps = 4;             // units per block
constexpr int kMaxRefs = 3;
constexpr int kPad = 80;              // MC_PAD
constexpr int kR = 3;                 // JOINT_R
constexpr int kSide = 2 * kR + 1;     // 7
constexpr int kWin = 16 + 2 * kR;     // 22
constexpr int kNoff = kSide * kSide;  // 49
constexpr int kPartStride = 50;       // 16-bit partials per row (25 words)
constexpr float kMvBitScale = 2.0f;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float log2_1p8(const float* tab, int n_tab, int d) {
  return d < n_tab ? tab[d]
                   : log2f(__fadd_rn(1.f, __fdiv_rn((float)d, 8.f)));
}

// -((q * d_to * 2 + d_from) // (2 * d_from)) * 2 with q = mv >> 1 and
// floor division, clipped to +-512
__device__ __forceinline__ int mirror(int mv, int d_from, int d_to) {
  const int q = mv >> 1;
  const int num = q * d_to * 2 + d_from, den = 2 * d_from;
  const int fl = num >= 0 ? num / den : -((-num + den - 1) / den);
  return clampi(-fl * 2, -512, 512);
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

// the 4 bytes starting at byte o of consecutive words w[o >> 2], w[o >> 2
// + 1] (o static after unrolling)
__device__ __forceinline__ uint32_t bytes4(const uint32_t* w, int o) {
  return (o & 3) ? __byte_perm(w[o >> 2], w[(o >> 2) + 1],
                               0x3210 + 0x1111 * (o & 3))
                 : w[o >> 2];
}

// What differs between the sample types: words per row of the unit
// (kRow), the window's bytes per shared row (kWinStride), the words of a
// window row the 7 column offsets read (kWinWords), the words copied into
// a window row where it lies inside the plane (kStore, from kStore + 1
// aligned words), and per word the SAD with accumulate, the rounded-up
// average, and the word at sample offset o of a row of words: word() for
// o static after unrolling, pick() for o known at run time.
template <typename T>
struct Px;

template <>
struct Px<uint8_t> {
  static constexpr int kPerWord = 4, kRow = 4, kWinStride = 24,
                       kWinWords = 6, kStore = 6;
  static __device__ __forceinline__ uint32_t sad(uint32_t a, uint32_t b,
                                                 uint32_t acc) {
    return sad4(a, b, acc);
  }
  static __device__ __forceinline__ uint32_t total(uint32_t acc) {
    return acc;
  }
  static __device__ __forceinline__ uint32_t avg(uint32_t a, uint32_t b) {
    return __vavgu4(a, b);
  }
  static __device__ __forceinline__ uint32_t word(const uint32_t* w, int o) {
    return bytes4(w, o);
  }
  static __device__ __forceinline__ uint32_t pick(const uint32_t* w,
                                                  int o) {
    return __byte_perm(w[o >> 2], w[(o >> 2) + 1],
                       0x3210 + 0x1111 * (o & 3));
  }
};

template <>
struct Px<uint16_t> {
  static constexpr int kPerWord = 2, kRow = 8, kWinStride = 48,
                       kWinWords = 11, kStore = 11;
  static __device__ __forceinline__ uint32_t sad(uint32_t a, uint32_t b,
                                                 uint32_t acc) {
    return sad16x2(a, b, acc);
  }
  static __device__ __forceinline__ uint32_t total(uint32_t acc) {
    return halves16(acc);
  }
  static __device__ __forceinline__ uint32_t avg(uint32_t a, uint32_t b) {
    return __vavgu2(a, b);
  }
  static __device__ __forceinline__ uint32_t word(const uint32_t* w, int o) {
    return (o & 1) ? __byte_perm(w[o >> 1], w[(o >> 1) + 1], 0x5432)
                   : w[o >> 1];
  }
  static __device__ __forceinline__ uint32_t pick(const uint32_t* w,
                                                  int o) {
    return __byte_perm(w[o >> 1], w[(o + 1) >> 1],
                       0x3210 + 0x2222 * (o & 1));
  }
};

// a row of the unit: kRow words from 16-byte loads
template <typename T>
__device__ __forceinline__ void load_row(const T* p,
                                         uint32_t (&w)[Px<T>::kRow]) {
#pragma unroll
  for (int k = 0; k < Px<T>::kRow / 4; ++k) {
    const uint4 v = reinterpret_cast<const uint4*>(p)[k];
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
}

__device__ __forceinline__ int half_sum(int v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps) compound_joint_kernel(
    const T* __restrict__ src, const T* __restrict__ refs,
    const T* __restrict__ preds, int K, int H, int W, int n_units,
    const int* __restrict__ mvq_r, const int* __restrict__ mvq_c,
    const int* __restrict__ sb_r, const int* __restrict__ sb_c,
    const float* __restrict__ tab, int n_tab, float pen_mv, int bwd_mask,
    int rel0, int rel1, int rel2, T* __restrict__ out_pred,
    int* __restrict__ out_sad, int* __restrict__ out_mvr,
    int* __restrict__ out_mvc, int* __restrict__ out_mv1r,
    int* __restrict__ out_mv1c, int* __restrict__ out_fi,
    int* __restrict__ out_bi) {
  using X = Px<T>;
  constexpr int kRow = X::kRow, kStrideW = X::kWinStride / 4;
  __shared__ __align__(16) uint32_t win_s[kWarps][2][kWin * kStrideW];
  __shared__ __align__(16) uint16_t part_s[kWarps][32 * kPartStride];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = blockIdx.x * kWarps + warp;
  if (u >= n_units) return;
  const int nc16 = W >> 4, nr16 = H >> 4, n_sbx = W >> 6;
  const int uy = u / nc16, ux = u - uy * nc16;
  const int y0 = uy * 16, x0 = ux * 16;
  const int g = lane >> 4, r = lane & 15;
  const size_t plane = (size_t)H * W;
  const size_t row_off = (size_t)(y0 + r) * W + x0;
  const int rel[kMaxRefs] = {rel0, rel1, rel2};

  // (1) single-reference scores
  uint32_t s[kRow];
  load_row(src + row_off, s);
  float base[kMaxRefs];
#pragma unroll
  for (int k = 0; k < kMaxRefs; ++k) {
    if (k >= K) break;
    uint32_t pv[kRow];
    load_row(preds + k * plane + row_off, pv);
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < kRow; ++i) acc = X::sad(s[i], pv[i], acc);
    const int d = half_sum((int)X::total(acc));
    const int gk = (k * nr16 + uy) * nc16 + ux;
    const int sk = (k * (H >> 6) + (uy >> 2)) * n_sbx + (ux >> 2);
    const int dr = abs(mvq_r[gk] - sb_r[sk] * 8);
    const int dc = abs(mvq_c[gk] - sb_c[sk] * 8);
    const float m = __fmul_rn(
        kMvBitScale,
        __fadd_rn(log2_1p8(tab, n_tab, dr), log2_1p8(tab, n_tab, dc)));
    base[k] = __fadd_rn((float)d, __fmul_rn(pen_mv, m));
  }

  // (2) the paired references and the mirrored seeds
  int fi = -1, bi = -1, df = 1, db = 1;
  float fb = 0.f, bb = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxRefs; ++k) {
    if (k >= K) break;
    if ((bwd_mask >> k) & 1) {
      if (bi < 0 || base[k] < bb) {
        bi = k;
        bb = base[k];
        db = max(abs(rel[k]), 1);
      }
    } else if (fi < 0 || base[k] < fb) {
      fi = k;
      fb = base[k];
      df = max(abs(rel[k]), 1);
    }
  }
  const int gf = (fi * nr16 + uy) * nc16 + ux;
  const int gb = (bi * nr16 + uy) * nc16 + ux;
  // arm 0 searches the backward reference around the mirrored forward MV,
  // holding the forward prediction; arm 1 the forward reference around
  // the mirrored backward MV, holding the backward prediction
  const int held_k = g == 0 ? fi : bi, arm_k = g == 0 ? bi : fi;
  const int seed_r =
      g == 0 ? mirror(mvq_r[gf], df, db) : mirror(mvq_r[gb], db, df);
  const int seed_c =
      g == 0 ? mirror(mvq_c[gf], df, db) : mirror(mvq_c[gb], db, df);

  // (3) the window of this half-warp's arm, then the 7x7 joint search
  const int oy = clampi(y0 + (seed_r >> 3) - kR + kPad, 0,
                        H + 2 * kPad - kWin);
  const int ox = clampi(x0 + (seed_c >> 3) - kR + kPad, 0,
                        W + 2 * kPad - kWin);
  uint32_t* win = win_s[warp][g];
  const T* rp = refs + arm_k * plane;
  const int wx = ox - kPad, wa = wx & ~(X::kPerWord - 1);
  auto load_clamped = [&]() {
    T* wb = reinterpret_cast<T*>(win);
    for (int k = r; k < kWin * kWin; k += 16) {
      const int i = k / kWin, j = k - (k / kWin) * kWin;
      wb[i * (X::kWinStride / (int)sizeof(T)) + j] =
          rp[(size_t)clampi(oy - kPad + i, 0, H - 1) * W +
             clampi(wx + j, 0, W - 1)];
    }
  };
  if constexpr (sizeof(T) == 1) {
    if (wx >= 0 && wa + (X::kStore + 1) * X::kPerWord <= W) {
      // inside the plane's columns: kStore + 1 aligned words per row,
      // shifted
      for (int i = r; i < kWin; i += 16) {
        const uint32_t* gp = reinterpret_cast<const uint32_t*>(
            rp + (size_t)clampi(oy - kPad + i, 0, H - 1) * W + wa);
        uint32_t v[X::kStore + 1];
#pragma unroll
        for (int k = 0; k <= X::kStore; ++k) v[k] = gp[k];
        const int sh = 8 * (int)sizeof(T) * (wx & (X::kPerWord - 1));
#pragma unroll
        for (int k = 0; k < X::kStore; ++k)
          win[i * kStrideW + k] = __funnelshift_r(v[k], v[k + 1], sh);
      }
    } else {
      load_clamped();
    }
  } else {
    const int wf = wx & ~7;         // the 16-byte floor of the first column
    if (wx >= 0 && wf + 32 <= W) {
      // inside the plane's columns (notes at the top); the search fills
      // the partials' shared memory only after the window is in place
      static_assert(2 * kWin * 64 <= sizeof(part_s[0]), "the staging");
      uint4* stage = reinterpret_cast<uint4*>(part_s[warp]) + g * kWin * 4;
      for (int q = r; q < kWin * 4; q += 16)
        stage[q] = *reinterpret_cast<const uint4*>(
            rp + (size_t)clampi(oy - kPad + (q >> 2), 0, H - 1) * W + wf +
            (q & 3) * 8);
      __syncwarp(g ? 0xffff0000u : 0x0000ffffu);
      const int j0 = (wx - wf) >> 1, sh = 16 * ((wx - wf) & 1);
      for (int i = r; i < kWin; i += 16) {
        const uint32_t* sw =
            reinterpret_cast<const uint32_t*>(stage + i * 4) + j0;
#pragma unroll
        for (int k = 0; k < X::kStore; ++k)
          win[i * kStrideW + k] = __funnelshift_r(sw[k], sw[k + 1], sh);
      }
    } else {
      load_clamped();
    }
  }
  uint32_t h[kRow];
  load_row(preds + held_k * plane + row_off, h);
  __syncwarp();
  uint16_t* part = part_s[warp];
  if constexpr (sizeof(T) == 1) {
#pragma unroll
    for (int dy = 0; dy < kSide; ++dy) {
      const uint32_t* wr = win + (r + dy) * kStrideW;
      uint32_t w[X::kWinWords];
      const uint2* w2 = reinterpret_cast<const uint2*>(wr);
      const uint2 a = w2[0], b = w2[1], c = w2[2];
      w[0] = a.x;
      w[1] = a.y;
      w[2] = b.x;
      w[3] = b.y;
      w[4] = c.x;
      w[5] = c.y;
#pragma unroll
      for (int dx = 0; dx < kSide; ++dx) {
        uint32_t acc = 0;
#pragma unroll
        for (int i = 0; i < kRow; ++i)
          acc = X::sad(s[i], X::avg(h[i], X::word(w, dx + X::kPerWord * i)),
                       acc);
        part[lane * kPartStride + dy * kSide + dx] = (uint16_t)X::total(acc);
      }
    }
  } else {
    // twice |avg - s| per pixel by the min identity (notes at the top);
    // h and s hold h + 1 and 2s during the search
    int srow2 = 0;
#pragma unroll
    for (int i = 0; i < kRow; ++i) {
      h[i] += 0x00010001u;
      s[i] <<= 1;
      srow2 = dp2_halves(s[i], kTimes1, srow2);
    }
    // a loop over the window rows (unrolled, it took 7% longer)
#pragma unroll 1
    for (int dy = 0; dy < kSide; ++dy) {
      const uint32_t* wr = win + (r + dy) * kStrideW;
      uint32_t w[X::kWinWords];
      const uint4* w4 = reinterpret_cast<const uint4*>(wr);
      const uint4 a = w4[0], b = w4[1];
      const uint2 c = reinterpret_cast<const uint2*>(wr)[4];
      w[0] = a.x;
      w[1] = a.y;
      w[2] = a.z;
      w[3] = a.w;
      w[4] = b.x;
      w[5] = b.y;
      w[6] = b.z;
      w[7] = b.w;
      w[8] = c.x;
      w[9] = c.y;
      w[10] = wr[10];
#pragma unroll
      for (int dx = 0; dx < kSide; ++dx) {
        // the row's u as packed halves (at most 8 x 2046 a half), its
        // -2 min and 2s in a 32-bit sum
        uint32_t su = 0;
        int acc = srow2;
#pragma unroll
        for (int i = 0; i < kRow; i += 2) {
          const uint32_t u0 =
              (h[i] + X::word(w, dx + X::kPerWord * i)) & 0xfffefffeu;
          const uint32_t u1 =
              (h[i + 1] + X::word(w, dx + X::kPerWord * (i + 1))) &
              0xfffefffeu;
          su += u0 + u1;
          acc = dp2_halves(__vminu2(u1, s[i + 1]), kTimesMinus2,
                           dp2_halves(__vminu2(u0, s[i]), kTimesMinus2, acc));
        }
        acc = dp2_halves(su, kTimes1, acc);
        part[lane * kPartStride + dy * kSide + dx] = (uint16_t)(acc >> 1);
      }
    }
#pragma unroll
    for (int i = 0; i < kRow; ++i) {
      h[i] -= 0x00010001u;
      s[i] >>= 1;
    }
  }
  __syncwarp();
  int bc = 0x7fffffff, bo = 0x7fffffff;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int o = r + 16 * k;
    if (o < kNoff) {
      int sum = 0;
#pragma unroll
      for (int rr = 0; rr < 16; ++rr)
        sum += part[(g * 16 + rr) * kPartStride + o];
      if (sum < bc) {          // o grows: the first minimum of this lane
        bc = sum;
        bo = o;
      }
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    const int c2 = __shfl_xor_sync(0xffffffffu, bc, off);
    const int o2 = __shfl_xor_sync(0xffffffffu, bo, off);
    if (c2 < bc || (c2 == bc && o2 < bo)) {
      bc = c2;
      bo = o2;
    }
  }

  // (4) the plain average's SAD, the 3-way pick
  uint32_t avg[kRow];
  uint32_t d0 = 0;
#pragma unroll
  for (int i = 0; i < kRow; ++i) {
    // the other half-warp holds the other arm's prediction of this row
    avg[i] = X::avg(h[i], __shfl_xor_sync(0xffffffffu, h[i], 16));
    d0 = X::sad(s[i], avg[i], d0);
  }
  const int sad0 = half_sum((int)X::total(d0));
  const int c0 = __shfl_sync(0xffffffffu, bc, 0);
  const int c1 = __shfl_sync(0xffffffffu, bc, 16);
  int p = 0, ps = sad0;
  if (c0 < ps) {
    p = 1;
    ps = c0;
  }
  if (c1 < ps) {
    p = 2;
    ps = c1;
  }
  const int by = bo / kSide, bx = bo - (bo / kSide) * kSide;
  if (r == 0 && (p == 0 ? g == 0 : g == p - 1)) {
    int mvr = mvq_r[gf], mvc = mvq_c[gf], mv1r = mvq_r[gb], mv1c = mvq_c[gb];
    if (p > 0) {
      // the realized MV comes from the clipped window origin
      const int r8 = (oy - kPad + by - y0) * 8;
      const int c8 = (ox - kPad + bx - x0) * 8;
      if (p == 1) {
        mv1r = r8;
        mv1c = c8;
      } else {
        mvr = r8;
        mvc = c8;
      }
    }
    out_sad[u] = ps;
    out_mvr[u] = mvr;
    out_mvc[u] = mvc;
    out_mv1r[u] = mv1r;
    out_mv1c[u] = mv1c;
    out_fi[u] = fi;
    out_bi[u] = bi;
  }
  // the winner's prediction: row r from the half-warp of the winning arm
  // (the first half for the plain average)
  if (p == 0 ? g == 0 : g == p - 1) {
    uint32_t q[kRow];
    if (p == 0) {
#pragma unroll
      for (int i = 0; i < kRow; ++i) q[i] = avg[i];
    } else {
      const uint32_t* wr = win + (r + by) * kStrideW;
#pragma unroll
      for (int i = 0; i < kRow; ++i) {
        q[i] = X::avg(h[i], X::pick(wr, bx + X::kPerWord * i));
      }
    }
    uint4* op = reinterpret_cast<uint4*>(out_pred + row_off);
#pragma unroll
    for (int k = 0; k < kRow / 4; ++k)
      op[k] = make_uint4(q[4 * k], q[4 * k + 1], q[4 * k + 2], q[4 * k + 3]);
  }
}

}  // namespace

// src: [H, W]; refs, preds: [K, H, W] (K <= 3) the reference planes and
// their quarter-pel predictions, every plane of sample_bytes-byte samples
// (1: uint8; 2: 16-bit samples in [0, 1024)); mvq_r, mvq_c: int32 [K,
// H/16, W/16] eighth-pel; sb_r, sb_c: int32 [K, H/64, W/64] full-pel 64x64
// winners; tab: float32 [n_tab] log2(1 + d/8); pen_mv: the MV-bits
// weight; bwd_mask: bit k marks reference k backward (both sides must be
// present); rel0..rel2: the signed display distances.  Out: pred [H, W]
// in the sample type; sad, mv_r, mv_c (forward arm), mv1_r, mv1_c
// (backward arm), fwd_i, bwd_i int32 [H/16, W/16].  Every plane 16-byte
// aligned.  Returns the CUDA error of the launch.
extern "C" int compound_joint_launch(
    const void* src, const void* refs, const void* preds, int sample_bytes,
    int K, int H, int W, const void* mvq_r, const void* mvq_c,
    const void* sb_r, const void* sb_c, const void* tab, int n_tab,
    float pen_mv, int bwd_mask, int rel0, int rel1, int rel2, void* out_pred,
    void* out_sad, void* out_mvr, void* out_mvc, void* out_mv1r,
    void* out_mv1c, void* out_fi, void* out_bi, void* stream) {
  const int all = (1 << K) - 1;
  if (K < 2 || K > kMaxRefs || H % 64 || W % 64 || (bwd_mask & all) == 0 ||
      (bwd_mask & all) == all || (sample_bytes != 1 && sample_bytes != 2))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)src | (uintptr_t)refs | (uintptr_t)preds |
       (uintptr_t)out_pred) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int n_units = (H / 16) * (W / 16);
  const dim3 grid((n_units + kWarps - 1) / kWarps), block(32 * kWarps);
  const cudaStream_t st = (cudaStream_t)stream;
  if (sample_bytes == 1)
    compound_joint_kernel<uint8_t><<<grid, block, 0, st>>>(
        (const uint8_t*)src, (const uint8_t*)refs, (const uint8_t*)preds, K,
        H, W, n_units, (const int*)mvq_r, (const int*)mvq_c,
        (const int*)sb_r, (const int*)sb_c, (const float*)tab, n_tab, pen_mv,
        bwd_mask, rel0, rel1, rel2, (uint8_t*)out_pred, (int*)out_sad,
        (int*)out_mvr, (int*)out_mvc, (int*)out_mv1r, (int*)out_mv1c,
        (int*)out_fi, (int*)out_bi);
  else
    compound_joint_kernel<uint16_t><<<grid, block, 0, st>>>(
        (const uint16_t*)src, (const uint16_t*)refs, (const uint16_t*)preds,
        K, H, W, n_units, (const int*)mvq_r, (const int*)mvq_c,
        (const int*)sb_r, (const int*)sb_c, (const float*)tab, n_tab, pen_mv,
        bwd_mask, rel0, rel1, rel2, (uint16_t*)out_pred, (int*)out_sad,
        (int*)out_mvr, (int*)out_mvc, (int*)out_mv1r, (int*)out_mv1c,
        (int*)out_fi, (int*)out_bi);
  return (int)cudaGetLastError();
}
