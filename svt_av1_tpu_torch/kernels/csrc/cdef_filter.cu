// K4 cdef_filter: CDEF strength search and apply over whole planes.
//
// Replaces the JAX package's full-plane CDEF bodies
// (svt_av1_tpu/ops/cdef.py _PlaneCtx, cdef_search_errs and
// _cdef_apply_traced with _constrain_xp, _adjust_strength_xp and
// pad_very_large; B10), run inside the fused filter chain and the
// standalone CDEF programs (_jit_search_apply, _jit_search, _jit_apply;
// B13); and, in its per-fb forms, the reference's host numpy for
// per-64x64 strength presets (cdef_bits > 0; B16): cdef_search_errs_fb
// (the search's totals per 64x64 filter block over the full 8 x 4 grid)
// and cdef_frame_multi (the apply with each filter block's preset index).
//
// What bounds it on the H100: integer throughput in the search (each
// pixel evaluates 15 strength combinations at preset 8, up to 32); in the
// apply memory traffic (one read and one write of each int32 sample:
// 26.5 MB over the three planes of a 1920x1152 buffer, 7.9 us at 3.35
// TB/s) with the filter's integer work (about 130 operations per
// filtered pixel) close behind.
//
// Both read a sample and the 12 taps along its unit's direction (primary
// taps along the direction, secondary taps along the directions rotated
// by 2 and 6), CDEF_VERY_LARGE outside the frame; a stripe of the frame
// reads the two rows above and below it from its neighbours' halo rows
// where the frame continues (the JAX padded_planes); the clip bounds
// ignore CDEF_VERY_LARGE for the maximum as the reference does.
// Combinations with a zero primary strength use direction 0, as the
// reference's zero-direction context.
//
// Tiles, in both: one launch for all planes, luma tiles first, then each
// chroma plane's (a per-plane first CTA).  A CTA of 256 threads takes a
// 64x32 tile of one plane, held once in shared memory as int16 with its
// 2-row and 2-column halo (16-byte loads of 4 samples where the rows
// start on 16-byte boundaries, CDEF_VERY_LARGE outside the frame, the
// neighbours' rows in stripe mode); each thread takes 8 pixels of a row.
// A lane's direction differs from its neighbours', so the 12 taps' tile
// offsets come from a table in shared memory, and the clip maximum masks
// CDEF_VERY_LARGE to 0.
//
// Search:
// * Luma adds to err_y, both chroma planes to err_uv.
// * The filter's sum is a primary part, 4 constrains that depend only on
//   pri (luma: adjust_strength(pri, var), tap weights by its parity), plus
//   a secondary part, 8 constrains that depend only on sec.  So each
//   pixel computes the primary part once per nonzero pri, the secondary
//   part once per nonzero sec for both tap sets (its unit's direction,
//   and direction 0 for pri == 0), and then combines per (pri, sec): the
//   rounding and the clip to that tap set's bounds.  At preset 8 (the
//   5x3 grid) that is 48 constrains per pixel instead of 180.
// * The squared errors accumulate per thread and combination in uint32
//   registers, then one warp reduction and one int64 atomic per CTA and
//   combination (exact, order-free: the totals are deterministic).
// * Two sample types of the source: uint8 (8-bit video) and 16-bit words
//   (10-bit video, cdef_search_kernel's TS); the recon is int32 and the
//   tile int16 in both, so only the source read differs.  At 10 bits a
//   warp's 256 squared errors stay below 2^32 (256 * 1023^2).
// Apply (the winners only):
// * The tiles cover each plane's whole buffer [H, W].  Outside the frame
//   [ph, pw), in skip units and on a plane whose strengths are both 0 the
//   input is copied; a tile with no non-skip unit in the frame copies
//   without loading its halo tile.
// * A CTA issues all its reads of device memory at once, before it waits
//   on any: each thread's 8 samples (two 16-byte loads), its units'
//   direction, variance and skip flag (one 8x8 unit in luma, two 4x4 in
//   chroma, read once, not per pixel) and one item of the tile's halo.
//   The threads' own samples become the tile's middle, so the tile costs
//   only its halo beyond the copy.  Outputs leave as two 16-byte stores
//   per thread.  Where a row does not start on a 16-byte boundary (widths
//   that are no multiple of 4, views off 16-byte boundaries) the same
//   accesses are scalar.
// * The direction follows the plane's coded primary (direction 0 where it
//   is 0, even in a luma unit whose adjusted primary is 0); the primary
//   taps' weights follow the parity of the unit's adjusted primary.
// * The apply's tile holds -CDEF_VERY_LARGE outside the frame, so that
//   the clip bounds are a signed maximum and an unsigned minimum with no
//   mask; |constrain(d)| is one add-min-relu (DPX), min(|d|, max(0, s -
//   (|d| >> shift))), signed by its weight; the primary weights are set
//   once per unit.  About 14 SASS instructions per tap, whose issue bounds
//   the apply more than its bytes do.  (Two pixels per word with the 16x2
//   DPX operations took as many instructions and 18% more time on an
//   H100.)
// * Tile rows are 70 int16 apart (35 words, odd), so that the 4 rows of 8
//   threads that a warp filters fall in distinct banks.
// Per-fb forms (B16):
// * The search (cdef_search_fb_kernel) has a pixel loop of its own, cut to
//   the fewest instructions, its 32 sums in registers in both sample types.
// * The apply passes the filter blocks' preset indices by value in the
//   launch's parameters (FbGrid<1>; no copy to the card), and each thread
//   decodes its filter block's preset once and runs the frame-level code
//   path with it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVeryLarge = 16384;

// cdef_directions as (dy, dx) for taps k = 0, 1
__constant__ int kDir[8][2][2] = {
    {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}},
    {{0, 1}, {1, 2}},   {{1, 1}, {2, 2}},  {{1, 0}, {2, 1}},
    {{1, 0}, {2, 0}},   {{1, 0}, {2, -1}}};

__device__ __forceinline__ int msb(int x) {      // floor(log2 x), 0 if < 1
  return x >= 1 ? 31 - __clz(x) : 0;
}

__device__ __forceinline__ int adjust_strength(int strength, int var) {
  if (var <= 0) return 0;
  const int v6 = var >> 6;
  int m = v6 >= 1 ? msb(v6) : 0;
  m = m < 12 ? m : 12;
  return (strength * (4 + m) + 8) >> 4;
}

// The plane with its surroundings: rows [0, ph) of the plane, rows -2, -1
// from top[2, W] and rows ph, ph + 1 from bottom[2, W] where given;
// CDEF_VERY_LARGE elsewhere and at every column outside [0, pw).
struct Src {
  const int* plane;
  const int* top;
  const int* bottom;
  int W, ph, pw;
};

// Row y of the surroundings, or null where the whole row reads
// CDEF_VERY_LARGE.
__device__ __forceinline__ const int* src_row(const Src& p, int y) {
  if (y >= 0 && y < p.ph) return p.plane + y * p.W;
  if (y < 0 && y >= -2 && p.top) return p.top + (y + 2) * p.W;
  if (y >= p.ph && y < p.ph + 2 && p.bottom)
    return p.bottom + (y - p.ph) * p.W;
  return nullptr;
}

// A sample of the surroundings, Out (CDEF_VERY_LARGE, or the apply's
// -CDEF_VERY_LARGE) where it has none.
template <int Out = kVeryLarge>
__device__ __forceinline__ int sample(const Src& p, const int* row, int x) {
  return row && x >= 0 && x < p.pw ? row[x] : Out;
}

// The apply's tile and the per-fb search's hold -CDEF_VERY_LARGE outside
// the frame: a signed maximum and an unsigned minimum both pass over it,
// and its taps, like the reference's at CDEF_VERY_LARGE, add nothing
// (|d| >> shift exceeds every strength).
constexpr int kOutside = -kVeryLarge;

constexpr int kTileW = 64, kTileH = 32;
constexpr int kTileThreads = 256;         // 8 pixels of a tile row each
constexpr int kHaloH = kTileH + 4;
constexpr int kSearchStride = 72;         // int16 per tile row
constexpr int kApplyStride = 70;          // odd in words: see the header

constexpr int kGroups = kTileW / 4;       // groups of 4 middle columns

// Four samples of a row from column x >= 0: one 16-byte load where vec
// (every row of the plane and of its halo rows starts on a 16-byte
// boundary) and all four lie inside [0, pw).
template <int Out = kVeryLarge>
__device__ __forceinline__ int4 sample4(const Src& p, const int* row, int x,
                                        bool vec) {
  if (vec && row && x + 3 < p.pw)
    return *reinterpret_cast<const int4*>(row + x);
  return make_int4(sample<Out>(p, row, x), sample<Out>(p, row, x + 1),
                   sample<Out>(p, row, x + 2), sample<Out>(p, row, x + 3));
}

// Four samples as int16 at an even column of a tile row.
__device__ __forceinline__ void put4(int16_t* t, int c, int4 q) {
  uint32_t* w = reinterpret_cast<uint32_t*>(t + c);
  w[0] = ((uint32_t)q.x & 0xffffu) | ((uint32_t)q.y << 16);
  w[1] = ((uint32_t)q.z & 0xffffu) | ((uint32_t)q.w << 16);
}

// The tile of rows [y0 - 2, y0 + kTileH + 2) and columns [x0 - 2, x0 +
// kTileW + 2) of the surroundings, as int16, Stride (even) per row, from
// a 4-byte aligned base: each row's kGroups groups of middle columns
// (sample4) and its 4 edge columns; Out outside the frame.
template <int Stride, int Out = kVeryLarge>
__device__ void load_tile(int16_t* tile, const Src& p, int y0, int x0,
                          bool vec) {
  constexpr int kItems = kGroups + 4;
  for (int i = threadIdx.x; i < kHaloH * kItems; i += blockDim.x) {
    const int r = i / kItems, k = i - r * kItems;
    const int* row = src_row(p, y0 - 2 + r);
    int16_t* t = tile + r * Stride;
    if (k < kGroups) {
      put4(t, 2 + 4 * k, sample4<Out>(p, row, x0 + 4 * k, vec));
    } else {
      // columns 0, 1 and kTileW + 2, kTileW + 3
      const int c = k - kGroups + (k - kGroups < 2 ? 0 : kTileW);
      t[c] = (int16_t)sample<Out>(p, row, x0 - 2 + c);
    }
  }
}

constexpr int kMaxPri = 8, kMaxSec = 4;
constexpr int kSearchThreads = kTileThreads;

struct SearchPlane {
  const int* rec;
  const void* src;                // uint8 or 16-bit samples (TS)
  const int* top;                 // [2, W] above a stripe, or null
  const int* bottom;              // [2, W] below it, or null
  int W, ph, pw, bsl, is_luma, damping, grp, tiles_x, cta0, vec;
};

struct SearchArgs {
  SearchPlane pl[3];
  int n_planes;
  int pri[kMaxPri], n_pri;        // coded primaries (before << cs)
  int sec[kMaxSec], n_sec;        // secondaries in filter units
  int cs;
};

// |constrain(diff, s, damping)| for |diff| = ad at strength s > 0, with
// shift = max(0, damping - min(msb(s), 7)), and 0 at s = 0 whatever the
// shift; the caller applies the sign and the tap's weight.
__device__ __forceinline__ int cmag(int ad, int s, int shift) {
  return min(ad, max(0, s - (ad >> shift)));
}

__device__ __forceinline__ int damp_shift(int s, int damping) {
  const int m = msb(s) < 7 ? msb(s) : 7;
  return damping - m > 0 ? damping - m : 0;
}

// The tile offsets of direction d's 12 taps: primary (k, sign) at 2k +
// sg, then secondary (k, rotation 2 or 6, sign) at 4 + 4k + 2ri + sg.  A
// lane's direction differs from its neighbours', so the search reads
// this table from shared memory, where 8 directions' rows fall in
// distinct banks, not from constant memory, which serializes divergent
// reads.  Stride: the tile's int16 per row.
template <int Stride>
__device__ __forceinline__ int tap_offset(int d, int i) {
  const bool prim = i < 4;
  const int k = prim ? i >> 1 : (i - 4) >> 2;
  const int ri = prim ? 0 : ((i - 4) >> 1) & 1;
  const int sign = (i & 1) ? -1 : 1;
  const int dd = prim ? d : (d + (ri ? 6 : 2)) & 7;
  return sign * (kDir[dd][k][0] * Stride + kDir[dd][k][1]);
}

// The 12 taps of one direction around tile position at: |tap - v| and
// the signed weight (primary: the sign; secondary: 2 or 1 times it), and
// the clip bounds with v.  The maximum ignores CDEF_VERY_LARGE (1 << 14,
// above every sample): a & (CDEF_VERY_LARGE - 1) is the sample itself or
// 0, which no maximum of samples >= 0 takes.
__device__ __forceinline__ void tile_taps(const int16_t* tile, int at,
                                          const int* toff, int v,
                                          int (&ad)[12], int (&ws)[12],
                                          int& mx, int& mn) {
  mx = v;
  mn = v;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const int a = tile[at + toff[i]];
    const int d = a - v;
    ad[i] = abs(d);
    const int w = i < 4 ? 1 : (i < 8 ? 2 : 1);
    ws[i] = d < 0 ? -w : w;
    mx = max(mx, a & (kVeryLarge - 1));
    mn = min(mn, a);
  }
}

// The secondary part of one tap set at strength sec > 0.
__device__ __forceinline__ int sec_part(const int (&ad)[12],
                                        const int (&ws)[12], int sec,
                                        int shift) {
  int sum = 0;
#pragma unroll
  for (int i = 4; i < 12; ++i) sum += ws[i] * cmag(ad[i], sec, shift);
  return sum;
}

__device__ __forceinline__ int combine(int v, int sum, int mn, int mx) {
  const int y = v + ((8 + sum - (sum < 0)) >> 4);
  return min(max(y, mn), mx);
}

// Every plane's tiles in one launch; err: int64 [2, n_pri * n_sec] (luma,
// chroma) to add to.  NPRI x NSEC is the grid (EXACT: with a zero primary
// first and a zero secondary first, as both of the codec's grids) or
// bounds it.  TS: the source samples' type, uint8_t for 8-bit video,
// uint16_t for 10-bit (int16 planes holding [0, 1024)): a thread's 8
// squared errors and the warp's sum of 256 stay below 2^32 (256 * 1023^2
// < 2.7e8; the wrapper refuses deeper samples).
template <typename TS, int NPRI, int NSEC, bool EXACT>
__global__ void __launch_bounds__(kSearchThreads) cdef_search_kernel(
    SearchArgs a, const int* __restrict__ dirs, const int* __restrict__ var,
    const uint8_t* __restrict__ nonskip, int uw,
    unsigned long long* __restrict__ err) {
  __shared__ __align__(16) int16_t tile[kHaloH * kSearchStride];
  __shared__ uint32_t wsum[kSearchThreads / 32][NPRI * NSEC];
  __shared__ int toff[8][12];
  // this CTA's plane, copied by constant indices (no local-memory copy of
  // the parameter)
  SearchPlane P = a.pl[0];
  if (a.n_planes > 1 && (int)blockIdx.x >= a.pl[1].cta0) P = a.pl[1];
  if (a.n_planes > 2 && (int)blockIdx.x >= a.pl[2].cta0) P = a.pl[2];
  const int ti = (int)blockIdx.x - P.cta0;
  const int y0 = (ti / P.tiles_x) * kTileH, x0 = (ti % P.tiles_x) * kTileW;
  const Src sp = {P.rec, P.top, P.bottom, P.W, P.ph, P.pw};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 96)
    toff[tid / 12][tid % 12] = tap_offset<kSearchStride>(tid / 12, tid % 12);
  load_tile<kSearchStride>(tile, sp, y0, x0, P.vec);
  __syncthreads();

  const int n_pri = EXACT ? NPRI : a.n_pri, n_sec = EXACT ? NSEC : a.n_sec;
  const int cs = a.cs, damping = P.damping;
  // this thread's 8 pixels of one row; in luma they share one 8x8 unit,
  // whose variance sets the primaries' strengths
  const int y = y0 + (tid >> 3), xs = x0 + 8 * (tid & 7);
  // its units: one 8x8 in luma, two 4x4 in chroma (pixels 0-3, 4-7)
  int du[2] = {0, 0}, nsu[2] = {0, 0}, vr = 0;
  if (y < P.ph) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int x = xs + 4 * h2;
      if (x < P.pw && (h2 == 0 || !P.is_luma)) {
        const int u = (y >> P.bsl) * uw + (x >> P.bsl);
        du[h2] = dirs[u];
        nsu[h2] = nonskip[u];
        if (P.is_luma) vr = var[u];
      }
    }
    if (P.is_luma) {
      du[1] = du[0];
      nsu[1] = nsu[0];
    }
  }
  int pa[NPRI], psh[NPRI], sec_sh[NSEC];
#pragma unroll
  for (int pi = 0; pi < NPRI; ++pi) {
    const int p = a.pri[pi] << cs;
    pa[pi] = P.is_luma ? adjust_strength(p, vr) : p;
    psh[pi] = pa[pi] > 0 ? damp_shift(pa[pi], damping) : 0;
  }
#pragma unroll
  for (int si = 0; si < NSEC; ++si)
    sec_sh[si] = a.sec[si] > 0 ? damp_shift(a.sec[si], damping) : 0;
  uint32_t acc[NPRI][NSEC];
#pragma unroll
  for (int pi = 0; pi < NPRI; ++pi)
#pragma unroll
    for (int si = 0; si < NSEC; ++si) acc[pi][si] = 0;

  const int ly = (tid >> 3) + 2;
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    const int x = xs + i;
    if (y >= P.ph || x >= P.pw) break;
    if (!(i < 4 ? nsu[0] : nsu[1])) continue;
    const int at = ly * kSearchStride + x - x0 + 2;
    const int v = tile[at];
    const int s = static_cast<const TS*>(P.src)[y * P.W + x];
    int add[12], wsd[12], ad0[12], ws0[12], mxd, mnd, mx0, mn0;
    tile_taps(tile, at, toff[i < 4 ? du[0] : du[1]], v, add, wsd, mxd, mnd);
    tile_taps(tile, at, toff[0], v, ad0, ws0, mx0, mn0);
    int Sd[NSEC], S0[NSEC];
#pragma unroll
    for (int si = 0; si < NSEC; ++si) {
      Sd[si] = 0;
      S0[si] = 0;
      if ((EXACT || si < n_sec) && (EXACT ? si > 0 : a.sec[si] > 0)) {
        Sd[si] = sec_part(add, wsd, a.sec[si], sec_sh[si]);
        S0[si] = sec_part(ad0, ws0, a.sec[si], sec_sh[si]);
      }
    }
#pragma unroll
    for (int pi = 0; pi < NPRI; ++pi) {
      if (!EXACT && pi >= n_pri) continue;
      if (EXACT ? pi == 0 : a.pri[pi] == 0) {
#pragma unroll
        for (int si = 0; si < NSEC; ++si) {
          if (!EXACT && si >= n_sec) continue;
          const int f = (EXACT ? si > 0 : a.sec[si] > 0)
                            ? combine(v, S0[si], mn0, mx0) : v;
          acc[pi][si] += (uint32_t)((f - s) * (f - s));
        }
        continue;
      }
      int prim = 0;
      if (pa[pi] > 0) {
        const int odd = (pa[pi] >> cs) & 1, sh = psh[pi];
        prim = (odd ? 3 : 4) * (wsd[0] * cmag(add[0], pa[pi], sh) +
                                wsd[1] * cmag(add[1], pa[pi], sh)) +
               (odd ? 3 : 2) * (wsd[2] * cmag(add[2], pa[pi], sh) +
                                wsd[3] * cmag(add[3], pa[pi], sh));
      }
#pragma unroll
      for (int si = 0; si < NSEC; ++si) {
        if (!EXACT && si >= n_sec) continue;
        const int f = combine(v, prim + Sd[si], mnd, mxd);
        acc[pi][si] += (uint32_t)((f - s) * (f - s));
      }
    }
  }
  // per combination: one warp reduction, then the CTA's warps in int64
#pragma unroll
  for (int pi = 0; pi < NPRI; ++pi)
#pragma unroll
    for (int si = 0; si < NSEC; ++si) {
      if (!EXACT && (pi >= n_pri || si >= n_sec)) continue;
      uint32_t e = acc[pi][si];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        e += __shfl_xor_sync(0xffffffffu, e, off);
      if (lane == 0) wsum[warp][pi * n_sec + si] = e;
    }
  __syncthreads();
  const int n_combo = n_pri * n_sec;
  if (tid < n_combo) {
    unsigned long long tot = 0;
#pragma unroll
    for (int w = 0; w < kSearchThreads / 32; ++w) tot += wsum[w][tid];
    if (tot) atomicAdd(&err[P.grp * n_combo + tid], tot);
  }
}

// The per-fb search (cdef_bits > 0): the full grid's totals per 64x64
// filter block (32x32 in chroma), err int64 [2, 32, nvfb, nhfb].
//
// Its pixel loop is written for the fewest instructions (splitting the
// grid between two CTAs of a tile, 16 sums a thread and three CTAs an SM,
// ran slower: both halves read the unit's taps and their secondary parts):
// the tile holds kOutside beyond the frame (the clip bounds are a signed
// maximum and an unsigned minimum, no mask); each |constrain| is one
// min-relu (DPX) after its shift and subtract, with no branch on a zero
// strength (min-relu gives 0 there); each tap set is done with before the
// next (direction 0's taps, then the unit's); each combination is its
// error e = clamp(v - s + round(sum), mn - s, mx - s) and e * e.  A
// thread loads its 8 source samples at once (8 or 16 bytes) before its
// pixel loop and shifts the next one down each pixel.  The 32 running sums
// stay in registers: __launch_bounds__ caps both sample types at 128
// registers, two CTAs (16 warps) an SM.
//
// A luma tile (64x32 at a column that is a multiple of 64) lies in one
// filter block; a chroma tile's 64 columns span two, threads 0-3 of a row
// in the first and 4-7 in the second.  So each warp reduces its two halves
// apart (lanes 0 and 4 hold them), the CTA sums its warps per half, and
// adds one atomic per (filter block, combination).

// A thread's 8 source samples from column xs of row y: packed in q0 (and
// q1 for 16-bit samples), sample i at bits [i * 8 * sizeof(TS), ...); one
// 8- or 16-byte load where the run lies inside the row and the row starts
// on such a boundary.
template <typename TS>
__device__ __forceinline__ void load_src8(const TS* row, int xs, int W,
                                          int pw, bool vec,
                                          unsigned long long& q0,
                                          unsigned long long& q1) {
  q0 = q1 = 0;
  if (vec && xs + 8 <= W) {
    if constexpr (sizeof(TS) == 1) {
      q0 = *reinterpret_cast<const unsigned long long*>(row + xs);
    } else {
      const uint4 t = *reinterpret_cast<const uint4*>(row + xs);
      q0 = t.x | ((unsigned long long)t.y << 32);
      q1 = t.z | ((unsigned long long)t.w << 32);
    }
    return;
  }
  constexpr int kBits = 8 * sizeof(TS);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (xs + i >= pw) break;
    const unsigned long long v = row[xs + i];
    const int b = i * kBits;
    if (b < 64) q0 |= v << b;
    else q1 |= v << (b - 64);
  }
}

// The next sample of the run, shifted out of (q0, q1).
template <typename TS>
__device__ __forceinline__ int next_src(unsigned long long& q0,
                                        unsigned long long& q1) {
  constexpr int kBits = 8 * sizeof(TS);
  const int s = (int)(q0 & ((1u << kBits) - 1));
  q0 = (q0 >> kBits) | (q1 << (64 - kBits));
  q1 >>= kBits;
  return s;
}

// One tap set around tile position at (offsets off, sample v): |tap - v|
// and the signed weight of each tap (primary: the sign; secondary: 2 or 1
// times it), and the clip bounds over the taps and v (kOutside taps pass
// over both).
__device__ __forceinline__ void fb_taps(const int16_t* tile, int at,
                                        const int* off, int v,
                                        int (&ad)[12], int (&ws)[12],
                                        int& mx, int& mn) {
  mx = v;
  unsigned umn = v;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const int a = tile[at + off[i]];
    const int d = a - v;
    ad[i] = abs(d);
    const int w = i < 4 ? 1 : (i < 8 ? 2 : 1);
    ws[i] = d < 0 ? -w : w;
    mx = max(mx, a);
    umn = min(umn, (unsigned)a);
  }
  mn = (int)umn;
}

// The weighted constrains of taps [i0, i1) at strength st (shift sh): 0
// at st = 0.
template <int I0, int I1>
__device__ __forceinline__ int fb_part(const int (&ad)[12],
                                       const int (&ws)[12], int st, int sh) {
  int sum = 0;
#pragma unroll
  for (int i = I0; i < I1; ++i)
    sum += ws[i] * __vimin_s32_relu(ad[i], st - (ad[i] >> sh));
  return sum;
}

// The error of one combination: e = f - s with f the filtered value
// clamp(v + round(sum / 16), mn, mx), from vs = v - s and the bounds less s.
__device__ __forceinline__ int fb_err(int vs, int sum, int mns, int mxs) {
  const int e = vs + ((sum + 8 + (sum >> 31)) >> 4);
  return min(max(e, mns), mxs);
}

template <typename TS>
__global__ void __launch_bounds__(kSearchThreads, 2) cdef_search_fb_kernel(
    SearchArgs a, const int* __restrict__ dirs, const int* __restrict__ var,
    const uint8_t* __restrict__ nonskip, int uw,
    unsigned long long* __restrict__ err, int nvfb, int nhfb) {
  constexpr int kCombos = kMaxPri * kMaxSec;
  __shared__ __align__(16) int16_t tile[kHaloH * kSearchStride];
  __shared__ uint32_t wsum[kSearchThreads / 32][2][kCombos];
  __shared__ int toff[8][12];
  SearchPlane P = a.pl[0];
  if (a.n_planes > 1 && (int)blockIdx.x >= a.pl[1].cta0) P = a.pl[1];
  if (a.n_planes > 2 && (int)blockIdx.x >= a.pl[2].cta0) P = a.pl[2];
  const int ti = (int)blockIdx.x - P.cta0;
  const int y0 = (ti / P.tiles_x) * kTileH, x0 = (ti % P.tiles_x) * kTileW;
  const Src sp = {P.rec, P.top, P.bottom, P.W, P.ph, P.pw};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 96)
    toff[tid / 12][tid % 12] = tap_offset<kSearchStride>(tid / 12, tid % 12);
  load_tile<kSearchStride, kOutside>(tile, sp, y0, x0, P.vec);

  const int cs = a.cs, damping = P.damping;
  const int y = y0 + (tid >> 3), xs = x0 + 8 * (tid & 7);
  // its units: one 8x8 in luma, two 4x4 in chroma (pixels 0-3, 4-7)
  int du[2] = {0, 0}, nsu[2] = {0, 0}, vr = 0;
  unsigned long long q0 = 0, q1 = 0;
  if (y < P.ph) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int x = xs + 4 * h2;
      if (x < P.pw && (h2 == 0 || !P.is_luma)) {
        const int u = (y >> P.bsl) * uw + (x >> P.bsl);
        du[h2] = dirs[u];
        nsu[h2] = nonskip[u];
        if (P.is_luma) vr = var[u];
      }
    }
    if (P.is_luma) {
      du[1] = du[0];
      nsu[1] = nsu[0];
    }
    const TS* src = static_cast<const TS*>(P.src);
    const bool svec = P.W % 8 == 0 &&
                      ((uintptr_t)src & (8 * sizeof(TS) - 1)) == 0;
    load_src8<TS>(src + (size_t)y * P.W, xs, P.W, P.pw, svec, q0, q1);
  }
  // primaries 1-7 (0 is the zero primary) and secondaries 1-3
  int pa[kMaxPri], psh[kMaxPri], sec_sh[kMaxSec];
#pragma unroll
  for (int pi = 1; pi < kMaxPri; ++pi) {
    const int p = a.pri[pi] << cs;
    pa[pi] = P.is_luma ? adjust_strength(p, vr) : p;
    psh[pi] = damp_shift(pa[pi], damping);
  }
#pragma unroll
  for (int si = 1; si < kMaxSec; ++si)
    sec_sh[si] = damp_shift(a.sec[si], damping);
  uint32_t acc[kMaxPri][kMaxSec];
#pragma unroll
  for (int pi = 0; pi < kMaxPri; ++pi)
#pragma unroll
    for (int si = 0; si < kMaxSec; ++si) acc[pi][si] = 0;
  __syncthreads();

  const int ly = (tid >> 3) + 2;
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    const int s = next_src<TS>(q0, q1);
    const int x = xs + i;
    if (y >= P.ph || x >= P.pw) break;
    if (!(i < 4 ? nsu[0] : nsu[1])) continue;
    const int at = ly * kSearchStride + x - x0 + 2;
    const int v = tile[at], vs = v - s;
    int ad[12], ws[12], mx, mn;
    // the zero primary: direction 0's taps and bounds
    fb_taps(tile, at, toff[0], v, ad, ws, mx, mn);
    acc[0][0] += (uint32_t)(vs * vs);
#pragma unroll
    for (int si = 1; si < kMaxSec; ++si) {
      const int e = fb_err(vs, fb_part<4, 12>(ad, ws, a.sec[si], sec_sh[si]),
                           mn - s, mx - s);
      acc[0][si] += (uint32_t)(e * e);
    }
    // the other primaries: the unit's direction
    fb_taps(tile, at, toff[i < 4 ? du[0] : du[1]], v, ad, ws, mx, mn);
    const int mns = mn - s, mxs = mx - s;
    int sd[kMaxSec];
    sd[0] = 0;
#pragma unroll
    for (int si = 1; si < kMaxSec; ++si)
      sd[si] = fb_part<4, 12>(ad, ws, a.sec[si], sec_sh[si]);
#pragma unroll
    for (int pi = 1; pi < kMaxPri; ++pi) {
      const int odd = (pa[pi] >> cs) & 1;
      const int prim =
          (odd ? 3 : 4) * fb_part<0, 2>(ad, ws, pa[pi], psh[pi]) +
          (odd ? 3 : 2) * fb_part<2, 4>(ad, ws, pa[pi], psh[pi]);
#pragma unroll
      for (int si = 0; si < kMaxSec; ++si) {
        const int e = fb_err(vs, prim + sd[si], mns, mxs);
        acc[pi][si] += (uint32_t)(e * e);
      }
    }
  }
  // per combination one warp reduction of each half (lane 8r + c: xor 16,
  // 8 sum the rows, xor 2, 1 a half of a row), then the CTA's warps in
  // int64, one atomic per (filter block, combination)
#pragma unroll
  for (int pi = 0; pi < kMaxPri; ++pi)
#pragma unroll
    for (int si = 0; si < kMaxSec; ++si) {
      uint32_t e = acc[pi][si];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        if (off != 4) e += __shfl_xor_sync(0xffffffffu, e, off);
      if ((lane & ~4) == 0) wsum[warp][lane >> 2][pi * kMaxSec + si] = e;
    }
  __syncthreads();
  if (tid < 2 * kCombos) {
    const int h = tid / kCombos, c = tid - h * kCombos;
    unsigned long long tot = 0;
#pragma unroll
    for (int w = 0; w < kSearchThreads / 32; ++w) {
      tot += wsum[w][h][c];
      if (P.is_luma) tot += wsum[w][1][c];    // one filter block
    }
    const int fby = P.is_luma ? y0 >> 6 : y0 >> 5;
    const int fbx = P.is_luma ? x0 >> 6 : (x0 >> 5) + h;
    if (tot && fbx < nhfb && !(P.is_luma && h))
      atomicAdd(&err[((size_t)(P.grp * kCombos + c) * nvfb + fby) * nhfb +
                     fbx],
                tot);
  }
}

struct ApplyPlane {
  const int* in;
  int* out;
  const int* top;                 // [2, W] above a stripe, or null
  const int* bottom;              // [2, W] below it, or null
  int H, W, ph, pw, bsl, is_luma;
  int pri, sec, damping;          // filter units; the plane's damping
  int tiles_x, cta0, vec;
};

struct ApplyArgs {
  ApplyPlane pl[3];
  int n_planes, cs;
};

// A thread's run of 8 samples of a row from column x (x a multiple of 8;
// those inside [0, W)): two 16-byte accesses where vec and the run lies
// inside the row.
__device__ __forceinline__ void load_run(const int* row, int x, int W,
                                         bool vec, int (&v)[8]) {
  if (vec && x + 8 <= W) {
    const int4 a = *reinterpret_cast<const int4*>(row + x);
    const int4 b = *reinterpret_cast<const int4*>(row + x + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = x + i < W ? row[x + i] : 0;
  }
}

__device__ __forceinline__ void store_run(int* row, int x, int W, bool vec,
                                          const int (&v)[8]) {
  if (vec && x + 8 <= W) {
    *reinterpret_cast<int4*>(row + x) = make_int4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<int4*>(row + x + 4) = make_int4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (x + i < W) row[x + i] = v[i];
  }
}


// The filtered value of sample v at tile position at: its 12 taps at the
// tile offsets off, the primary part at strength pri (damping shift psh,
// weights w0 for k = 0, w1 for k = 1), the secondary part at sec (shift
// ssh, weights 2, 1), rounded and clipped to the taps' bounds.  Each
// |constrain| is one min-relu, min(|d|, max(0, s - (|d| >> shift))), 0 at
// s = 0, whose taps still bound the clip, as in the reference.
__device__ __forceinline__ int filter_px(const int16_t* tile, int at,
                                         const int (&off)[12], int v,
                                         int pri, int psh, int w0, int w1,
                                         int sec, int ssh) {
  int sum = 0, mx = v;
  unsigned mn = v;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const int a = tile[at + off[i]];
    const int d = a - v, ad = abs(d);
    const int m = i < 4 ? __vimin_s32_relu(ad, pri - (ad >> psh))
                        : __vimin_s32_relu(ad, sec - (ad >> ssh));
    const int w = i < 2 ? w0 : i < 4 ? w1 : (i < 8 ? 2 : 1);
    sum += (d < 0 ? -w : w) * m;
    mx = max(mx, a);
    mn = min(mn, (unsigned)a);
  }
  return combine(v, sum, (int)mn, mx);
}

// Pixels 4 * h2 .. 4 * h2 + 3 of a thread's run v (from column xs, tile
// position at), those inside [0, pw), filtered along the tap offsets of
// their unit's direction.
__device__ __forceinline__ void filter_run(const int16_t* tile, int at,
                                           const int* toff_d, int (&v)[8],
                                           int h2, int xs, int pw, int pa,
                                           int psh, int w0, int w1, int sec,
                                           int ssh) {
  int off[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) off[i] = toff_d[i];
#pragma unroll
  for (int i = 4 * h2; i < 4 * h2 + 4; ++i)
    if (xs + i < pw)
      v[i] = filter_px(tile, at + i, off, v[i], pa, psh, w0, w1, sec, ssh);
}

// The per-fb apply's presets: each list's coded strengths (pri * 4 + sec,
// 6 bits each, at most 8) and the filter block grid's size.
struct Presets {
  unsigned long long y, uv;
  int nvfb, nhfb;
};

// The filter blocks' preset indices by value in the launch's parameters:
// 3 bits per block, row-major, 10 blocks to a word, block k at bits [3j,
// 3j + 3) of word k / 10, j = k % 10 (the top 2 bits unused).  Capacity:
// the 128 x 68 blocks of AV1's largest level-6.3 picture (8192 x 4352),
// 3,484 bytes, inside the 4 KB of parameters with the rest of the
// launch's.  A larger grid takes the device-memory form.
constexpr int kGridBlocks = 128 * 68;
constexpr int kGridWords = (kGridBlocks + 9) / 10;

// The grid of an apply launch: none (MODE 0, the frame-level apply), the
// packed indices by value (MODE 1), or a uint8 [nvfb, nhfb] grid in device
// memory (MODE 2, past kGridBlocks).
template <int MODE>
struct FbGrid {
  int unused;
};
template <>
struct FbGrid<1> {
  uint32_t w[kGridWords];
};
template <>
struct FbGrid<2> {
  const uint8_t* idx;
};

__device__ __forceinline__ int grid_index(const FbGrid<1>& g, int k) {
  const int q = k / 10;
  return (int)(g.w[q] >> (3 * (k - 10 * q))) & 7;
}

__device__ __forceinline__ int grid_index(const FbGrid<2>& g, int k) {
  return g.idx[k];
}

// The per-fb apply's strengths of a thread (pri, sec in filter units) at
// tile (y0, x0), thread column tx: a luma tile (64x32 at a column that is
// a multiple of 64) lies in one filter block and a chroma tile's halves
// (threads 0-3 and 4-7 of a row) in two, so the thread decodes its half's
// preset once, the same value across the tile or the half.  Returns
// whether any unit of the tile may filter (a preset other than (0, 0)).
template <int MODE>
__device__ __forceinline__ bool fb_preset(const ApplyPlane& P,
                                          const Presets& m,
                                          const FbGrid<MODE>& g, int cs,
                                          int y0, int x0, int tx, int& pri,
                                          int& sec) {
  bool live = false;
  if (y0 >= P.ph) return false;
  const int sh = P.is_luma ? 6 : 5, mine = P.is_luma ? 0 : tx >> 5;
  const int at = (y0 >> sh) * m.nhfb + (x0 >> sh);
  const unsigned long long list = P.is_luma ? m.y : m.uv;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if ((h && P.is_luma) || x0 + 32 * h >= P.pw) break;
    const int c = (int)(list >> (6 * grid_index(g, at + h))) & 63;
    const int sc = c & 3, hp = (c >> 2) << cs, hs = (sc + (sc == 3)) << cs;
    live |= hp > 0 || hs > 0;
    if (h == mine) {
      pri = hp;
      sec = hs;
    }
  }
  return live;
}

// Every plane's tiles over its whole buffer in one launch.  MODE 0: every
// unit takes the plane's pri and sec.  MODE 1, 2 (per-fb): each thread
// the strengths of its filter block's index into the plane's preset list
// (fb_preset; the plane's pri and sec are not read), then the same code
// path; a tile whose presets are all (0, 0) copies without loading its
// halo.  Five CTAs an SM: 48 registers in every form.
template <int MODE>
__global__ void __launch_bounds__(kTileThreads, 5) cdef_apply_kernel(
    ApplyArgs a, Presets m, const __grid_constant__ FbGrid<MODE> g,
    const int* __restrict__ dirs, const int* __restrict__ var,
    const uint8_t* __restrict__ nonskip, int uw) {
  __shared__ __align__(16) int16_t tile[kHaloH * kApplyStride];
  __shared__ int toff[8][12];
  ApplyPlane P = a.pl[0];
  if (a.n_planes > 1 && (int)blockIdx.x >= a.pl[1].cta0) P = a.pl[1];
  if (a.n_planes > 2 && (int)blockIdx.x >= a.pl[2].cta0) P = a.pl[2];
  const int ti = (int)blockIdx.x - P.cta0;
  const int y0 = (ti / P.tiles_x) * kTileH, x0 = (ti % P.tiles_x) * kTileW;
  const int tid = threadIdx.x, ty = tid >> 3, tx = 8 * (tid & 7);
  const int y = y0 + ty, xs = x0 + tx;
  const Src sp = {P.in, P.top, P.bottom, P.W, P.ph, P.pw};
  // every global read of the CTA at once: the thread's 8 samples, its
  // units (one 8x8 in luma, two 4x4 in chroma: pixels 0-3, 4-7; filtered
  // inside the frame, on an active plane) and one item of the tile's halo
  int v[8];
  if (y < P.H) load_run(P.in + y * P.W, xs, P.W, P.vec, v);
  int du[2] = {0, 0}, nsu[2] = {0, 0}, vr = 0;
  // MODE 1, 2: the thread's strengths
  int upri = 0, usec = 0;
  bool live = true;
  if constexpr (MODE != 0)
    live = fb_preset<MODE>(P, m, g, a.cs, y0, x0, tx, upri, usec);
  const bool on = MODE == 0 ? P.pri > 0 || P.sec > 0 : upri > 0 || usec > 0;
  if (on && y < P.ph) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int x = xs + 4 * h2;
      if (x < P.pw && (h2 == 0 || !P.is_luma)) {
        const int u = (y >> P.bsl) * uw + (x >> P.bsl);
        nsu[h2] = nonskip[u];
        du[h2] = (MODE == 0 ? P.pri : upri) > 0 ? dirs[u] : 0;
        if (P.is_luma) vr = var[u];
      }
    }
    if (P.is_luma) {
      du[1] = du[0];
      nsu[1] = nsu[0];
    }
  }
  // the halo: items 0-63 the groups of rows 0, 1, kTileH + 2, kTileH + 3,
  // items 64-207 columns 0, 1, kTileW + 2, kTileW + 3 of every row
  int hr = -1, hc = 0;
  int4 hq = make_int4(0, 0, 0, 0);
  if (live && tid < 4 * kGroups) {
    const int r4 = tid / kGroups;
    hr = r4 < 2 ? r4 : kTileH + r4;
    hc = 2 + 4 * (tid % kGroups);
    hq = sample4<kOutside>(sp, src_row(sp, y0 - 2 + hr), x0 - 2 + hc, P.vec);
  } else if (live && tid < 4 * kGroups + 4 * kHaloH) {
    const int e = tid - 4 * kGroups;
    hr = e >> 2;
    hc = (e & 3) + ((e & 2) ? kTileW : 0);
    hq.x = sample<kOutside>(sp, src_row(sp, y0 - 2 + hr), x0 - 2 + hc);
  }
  const bool any = __syncthreads_or(nsu[0] | nsu[1]);
  if (any) {
    if (tid < 96)
      toff[tid / 12][tid % 12] = tap_offset<kApplyStride>(tid / 12, tid % 12);
    // the thread's samples as the tile's: inside the frame its own,
    // kOutside right of it, the surroundings below it
    int16_t* trow = tile + (ty + 2) * kApplyStride;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int x = xs + 4 * h2;
      int4 q;
      if (y < P.ph) {
        q = make_int4(x < P.pw ? v[4 * h2] : kOutside,
                      x + 1 < P.pw ? v[4 * h2 + 1] : kOutside,
                      x + 2 < P.pw ? v[4 * h2 + 2] : kOutside,
                      x + 3 < P.pw ? v[4 * h2 + 3] : kOutside);
      } else {
        q = sample4<kOutside>(sp, src_row(sp, y), x, P.vec);
      }
      put4(trow, tx + 2 + 4 * h2, q);
    }
    if (tid < 4 * kGroups)
      put4(tile + hr * kApplyStride, hc, hq);
    else if (hr >= 0)
      tile[hr * kApplyStride + hc] = (int16_t)hq.x;
    __syncthreads();
    const int at = (ty + 2) * kApplyStride + tx + 2;
    const int pri = MODE == 0 ? P.pri : upri, sec = MODE == 0 ? P.sec : usec;
    const int pa = P.is_luma ? adjust_strength(pri, vr) : pri;
    const int psh = pa > 0 ? damp_shift(pa, P.damping) : 0;
    const int ssh = sec > 0 ? damp_shift(sec, P.damping) : 0;
    // primary weights 4, 2, or 3, 3 for an odd adjusted strength >> cs
    const int odd = (pa >> a.cs) & 1, w0 = odd ? 3 : 4, w1 = odd ? 3 : 2;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      if (!nsu[h2]) continue;
      filter_run(tile, at, toff[du[h2]], v, h2, xs, P.pw, pa, psh, w0, w1,
                 sec, ssh);
    }
  }
  if (y < P.H) store_run(P.out + y * P.W, xs, P.W, P.vec, v);
}

// The search's launch for source samples of type TS: the fast grid of the
// high presets (5 x 3) and the full grid (8 x 4) with their counts known
// at compile time; any other set bounded by 8 x 4.  The per-fb form takes
// the full grid only.
template <typename TS>
void search_grid(int n_pri, int n_sec, bool zero_first, bool per_fb,
                 dim3 grid, dim3 block, cudaStream_t st, const SearchArgs& a,
                 const int* d, const int* vr, const uint8_t* ns, int uw,
                 unsigned long long* e, int nvfb, int nhfb) {
  if (per_fb)
    cdef_search_fb_kernel<TS><<<grid, block, 0, st>>>(a, d, vr, ns, uw, e,
                                                     nvfb, nhfb);
  else if (n_pri == 5 && n_sec == 3 && zero_first)
    cdef_search_kernel<TS, 5, 3, true><<<grid, block, 0, st>>>(a, d, vr, ns,
                                                               uw, e);
  else if (n_pri == kMaxPri && n_sec == kMaxSec && zero_first)
    cdef_search_kernel<TS, kMaxPri, kMaxSec, true><<<grid, block, 0, st>>>(
        a, d, vr, ns, uw, e);
  else
    cdef_search_kernel<TS, kMaxPri, kMaxSec, false><<<grid, block, 0, st>>>(
        a, d, vr, ns, uw, e);
}

// Both search entries: nvfb = 0 for the frame totals, else the per-fb
// totals of an nvfb x nhfb grid of filter blocks (the full grid only).
int search_launch(int n_planes, const void* const* rec,
                  const void* const* src, int src_bytes,
                  const void* const* top, const void* const* bottom,
                  const int* H, const int* W, const int* ph, const int* pw,
                  const void* dirs, const void* var, const void* nonskip,
                  int uw, unsigned pri_pack, int n_pri, unsigned sec_pack,
                  int n_sec, int damping, int cs, int nvfb, int nhfb,
                  void* err, void* stream) {
  if (n_planes < 1 || n_planes > 3 || n_pri < 1 || n_pri > kMaxPri ||
      n_sec < 1 || n_sec > kMaxSec || (src_bytes != 1 && src_bytes != 2))
    return (int)cudaErrorInvalidValue;
  SearchArgs a{};
  a.n_planes = n_planes;
  a.n_pri = n_pri;
  a.n_sec = n_sec;
  a.cs = cs;
  for (int i = 0; i < n_pri; ++i) a.pri[i] = (int)((pri_pack >> (4 * i)) & 15u);
  for (int i = 0; i < n_sec; ++i) {
    const int sc = (int)((sec_pack >> (2 * i)) & 3u);
    a.sec[i] = (sc + (sc == 3)) << cs;
  }
  int ctas = 0;
  for (int i = 0; i < n_planes; ++i) {
    if (ph[i] > H[i] || pw[i] > W[i] || ph[i] < 1 || pw[i] < 1)
      return (int)cudaErrorInvalidValue;
    SearchPlane& p = a.pl[i];
    p.rec = (const int*)rec[i];
    p.src = src[i];
    p.top = (const int*)top[i];
    p.bottom = (const int*)bottom[i];
    p.W = W[i];
    p.ph = ph[i];
    p.pw = pw[i];
    p.bsl = i == 0 ? 3 : 2;
    p.is_luma = i == 0;
    p.damping = damping - (i == 0 ? 0 : 1);
    p.grp = i == 0 ? 0 : 1;
    p.vec = W[i] % 4 == 0 &&
            (((uintptr_t)rec[i] | (uintptr_t)top[i] | (uintptr_t)bottom[i]) &
             15) == 0;
    p.tiles_x = (pw[i] + kTileW - 1) / kTileW;
    p.cta0 = ctas;
    ctas += p.tiles_x * ((ph[i] + kTileH - 1) / kTileH);
  }
  const dim3 grid(ctas), block(kSearchThreads);
  cudaStream_t st = (cudaStream_t)stream;
  const int* d = (const int*)dirs;
  const int* vr = (const int*)var;
  const uint8_t* ns = (const uint8_t*)nonskip;
  unsigned long long* e = (unsigned long long*)err;
  // a grid whose zero primary and zero secondary come first, each once
  bool zero_first = a.pri[0] == 0 && a.sec[0] == 0;
  for (int i = 1; i < n_pri; ++i) zero_first &= a.pri[i] > 0;
  for (int i = 1; i < n_sec; ++i) zero_first &= a.sec[i] > 0;
  const bool per_fb = nvfb > 0;
  if (per_fb && !(n_pri == kMaxPri && n_sec == kMaxSec && zero_first &&
                  nvfb * 64 >= ph[0] && nhfb * 64 >= pw[0]))
    return (int)cudaErrorInvalidValue;
  if (src_bytes == 1)
    search_grid<uint8_t>(n_pri, n_sec, zero_first, per_fb, grid, block, st, a,
                         d, vr, ns, uw, e, nvfb, nhfb);
  else
    search_grid<uint16_t>(n_pri, n_sec, zero_first, per_fb, grid, block, st,
                          a, d, vr, ns, uw, e, nvfb, nhfb);
  return (int)cudaGetLastError();
}

// Both apply entries: per plane i, ptrs[4i..4i+3] and dims[6i..6i+5] as
// for cdef_apply_launch; per_fb: the per-fb apply with m, its grid words
// gw (by value) or else its device grid idx.
int apply_launch(int n_planes, const void* const* ptrs, const int* dims,
                 const void* dirs, const void* var, const void* nonskip,
                 int uw, int damping, int cs, bool per_fb, const Presets& m,
                 const uint32_t* gw, const uint8_t* idx, void* stream) {
  if (n_planes < 1 || n_planes > 3) return (int)cudaErrorInvalidValue;
  ApplyArgs a{};
  a.n_planes = n_planes;
  a.cs = cs;
  int ctas = 0;
  for (int i = 0; i < n_planes; ++i) {
    const void* const* pp = ptrs + 4 * i;
    const int* d = dims + 6 * i;
    if (d[2] > d[0] || d[3] > d[1] || d[0] < 1 || d[1] < 1)
      return (int)cudaErrorInvalidValue;
    ApplyPlane& p = a.pl[i];
    p.in = (const int*)pp[0];
    p.out = (int*)pp[1];
    p.top = (const int*)pp[2];
    p.bottom = (const int*)pp[3];
    p.H = d[0];
    p.W = d[1];
    p.ph = d[2];
    p.pw = d[3];
    p.pri = d[4];
    p.sec = d[5];
    p.bsl = i == 0 ? 3 : 2;
    p.is_luma = i == 0;
    p.damping = damping - (i == 0 ? 0 : 1);
    p.vec = p.W % 4 == 0 &&
            (((uintptr_t)pp[0] | (uintptr_t)pp[1] | (uintptr_t)pp[2] |
              (uintptr_t)pp[3]) & 15) == 0;
    p.tiles_x = (p.W + kTileW - 1) / kTileW;
    p.cta0 = ctas;
    ctas += p.tiles_x * ((p.H + kTileH - 1) / kTileH);
  }
  const int* dr = (const int*)dirs;
  const int* vr = (const int*)var;
  const uint8_t* ns = (const uint8_t*)nonskip;
  cudaStream_t st = (cudaStream_t)stream;
  if (!per_fb) {
    cdef_apply_kernel<0><<<ctas, kTileThreads, 0, st>>>(
        a, m, FbGrid<0>{0}, dr, vr, ns, uw);
  } else {
    // the grid covers the luma frame
    if (m.nvfb < 1 || m.nhfb < 1 || m.nvfb * 64 < dims[2] ||
        m.nhfb * 64 < dims[3])
      return (int)cudaErrorInvalidValue;
    if (gw) {
      if (m.nvfb * m.nhfb > kGridBlocks) return (int)cudaErrorInvalidValue;
      FbGrid<1> g{};
      const int n = (m.nvfb * m.nhfb + 9) / 10;
      for (int i = 0; i < n; ++i) g.w[i] = gw[i];
      cdef_apply_kernel<1><<<ctas, kTileThreads, 0, st>>>(a, m, g, dr, vr,
                                                          ns, uw);
    } else {
      if (!idx) return (int)cudaErrorInvalidValue;
      cdef_apply_kernel<2><<<ctas, kTileThreads, 0, st>>>(
          a, m, FbGrid<2>{idx}, dr, vr, ns, uw);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One launch for the search of n_planes planes (luma, then chroma):
// rec[i]: int32 [H[i], W[i]]; src[i]: the source of the same shape,
// src_bytes 1 (uint8) or 2 (16-bit samples of 10-bit video); frame [0,
// ph[i]) x [0, pw[i]); top[i], bottom[i]: int32 [2, W[i]] rows above and
// below a stripe of the frame, or null at the frame's edges; dirs, var:
// int32 luma unit maps and nonskip uint8 [uh, uw] (8x8 luma units, 4x4 in
// chroma); pri_pack: 4-bit coded primaries, sec_pack: 2-bit coded
// secondaries; damping: the luma damping (chroma takes one less); err:
// int64 [2, n_pri * n_sec] totals (luma, chroma) to add to.
extern "C" int cdef_search_launch(int n_planes, const void* const* rec,
                                  const void* const* src, int src_bytes,
                                  const void* const* top,
                                  const void* const* bottom, const int* H,
                                  const int* W, const int* ph, const int* pw,
                                  const void* dirs, const void* var,
                                  const void* nonskip, int uw,
                                  unsigned pri_pack, int n_pri,
                                  unsigned sec_pack, int n_sec, int damping,
                                  int cs, void* err, void* stream) {
  return search_launch(n_planes, rec, src, src_bytes, top, bottom, H, W, ph,
                       pw, dirs, var, nonskip, uw, pri_pack, n_pri, sec_pack,
                       n_sec, damping, cs, 0, 0, err, stream);
}

// The per-fb search (cdef_bits > 0): the arguments of cdef_search_launch
// with the full grid (8 x 4, zero strengths first), and err int64 [2,
// 32, nvfb, nhfb], the totals per 64x64 filter block of the luma frame
// (32x32 in chroma) to add to.
extern "C" int cdef_search_fb_launch(
    int n_planes, const void* const* rec, const void* const* src,
    int src_bytes, const void* const* top, const void* const* bottom,
    const int* H, const int* W, const int* ph, const int* pw,
    const void* dirs, const void* var, const void* nonskip, int uw,
    unsigned pri_pack, int n_pri, unsigned sec_pack, int n_sec, int damping,
    int cs, int nvfb, int nhfb, void* err, void* stream) {
  if (nvfb < 1 || nhfb < 1) return (int)cudaErrorInvalidValue;
  return search_launch(n_planes, rec, src, src_bytes, top, bottom, H, W, ph,
                       pw, dirs, var, nonskip, uw, pri_pack, n_pri, sec_pack,
                       n_sec, damping, cs, nvfb, nhfb, err, stream);
}

// One launch for the apply of n_planes planes (luma, then chroma); per
// plane i, ptrs[4i..4i+3] = in, out, top, bottom and dims[6i..6i+5] = H,
// W, ph, pw, pri, sec: in and out int32 [H, W], out the filtered frame
// [0, ph) x [0, pw) and a copy of in elsewhere; top, bottom as for
// cdef_search_launch; pri, sec the plane's strengths in filter units (sec
// 3 already 4, both shifted by cs).  dirs, var, nonskip, uw and damping
// as for cdef_search_launch.
extern "C" int cdef_apply_launch(int n_planes, const void* const* ptrs,
                                 const int* dims, const void* dirs,
                                 const void* var, const void* nonskip,
                                 int uw, int damping, int cs, void* stream) {
  return apply_launch(n_planes, ptrs, dims, dirs, var, nonskip, uw, damping,
                      cs, false, Presets{0, 0, 0, 0}, nullptr, nullptr,
                      stream);
}

// The per-fb apply (cdef_bits > 0): the arguments of cdef_apply_launch
// (each plane's pri, sec unread); y_pack, uv_pack the coded strength
// lists (pri * 4 + sec, 6 bits
// each); the nvfb x nhfb filter blocks' indices into them (below the
// lists' length) either packed on the host, grid: uint32 words of 10
// blocks at 3 bits each, row-major (at most kGridBlocks blocks; see
// FbGrid<1>), passed by value in the launch's parameters; or, with grid
// null, idx:
// uint8 [nvfb, nhfb] in device memory.
extern "C" int cdef_apply_multi_launch(int n_planes, const void* const* ptrs,
                                       const int* dims, const void* dirs,
                                       const void* var, const void* nonskip,
                                       int uw, int damping, int cs,
                                       unsigned long long y_pack,
                                       unsigned long long uv_pack,
                                       const void* grid, const void* idx,
                                       int nvfb, int nhfb, void* stream) {
  return apply_launch(n_planes, ptrs, dims, dirs, var, nonskip, uw, damping,
                      cs, true, Presets{y_pack, uv_pack, nvfb, nhfb},
                      (const uint32_t*)grid, (const uint8_t*)idx, stream);
}
