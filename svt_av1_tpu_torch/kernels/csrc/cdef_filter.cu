// K4 cdef_filter: CDEF strength search and apply over whole planes.
//
// Replaces the JAX package's full-plane CDEF bodies
// (svt_av1_tpu/ops/cdef.py _PlaneCtx, cdef_search_errs and
// _cdef_apply_traced with _constrain_xp, _adjust_strength_xp and
// pad_very_large; B10), run inside the fused filter chain and the
// standalone CDEF programs (_jit_search_apply, _jit_search, _jit_apply;
// B13).
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
// (sample4) and its 4 edge columns.
template <int Stride>
__device__ void load_tile(int16_t* tile, const Src& p, int y0, int x0,
                          bool vec) {
  constexpr int kItems = kGroups + 4;
  for (int i = threadIdx.x; i < kHaloH * kItems; i += blockDim.x) {
    const int r = i / kItems, k = i - r * kItems;
    const int* row = src_row(p, y0 - 2 + r);
    int16_t* t = tile + r * Stride;
    if (k < kGroups) {
      put4(t, 2 + 4 * k, sample4(p, row, x0 + 4 * k, vec));
    } else {
      // columns 0, 1 and kTileW + 2, kTileW + 3
      const int c = k - kGroups + (k - kGroups < 2 ? 0 : kTileW);
      t[c] = (int16_t)sample(p, row, x0 - 2 + c);
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
// chroma) to add to.  NPRI x NSEC is the grid (EXACT: with a zero
// primary first and a zero secondary first, as both of the codec's
// grids) or bounds it.  TS: the source samples' type, uint8_t for 8-bit
// video, uint16_t for 10-bit (int16 planes holding [0, 1024)): a
// thread's 8 squared errors and the warp's sum of 256 stay below 2^32
// (256 * 1023^2 < 2.7e8; the wrapper refuses deeper samples).
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

// The apply's tile holds -CDEF_VERY_LARGE outside the frame: a signed
// maximum and an unsigned minimum both pass over it, and its taps, like
// the reference's at CDEF_VERY_LARGE, add nothing (|d| >> shift exceeds
// every strength).
constexpr int kOutside = -kVeryLarge;

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

// Every plane's tiles over its whole buffer in one launch.
__global__ void __launch_bounds__(kTileThreads) cdef_apply_kernel(
    ApplyArgs a, const int* __restrict__ dirs, const int* __restrict__ var,
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
  if ((P.pri > 0 || P.sec > 0) && y < P.ph) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int x = xs + 4 * h2;
      if (x < P.pw && (h2 == 0 || !P.is_luma)) {
        const int u = (y >> P.bsl) * uw + (x >> P.bsl);
        nsu[h2] = nonskip[u];
        du[h2] = P.pri > 0 ? dirs[u] : 0;
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
  if (tid < 4 * kGroups) {
    const int r4 = tid / kGroups;
    hr = r4 < 2 ? r4 : kTileH + r4;
    hc = 2 + 4 * (tid % kGroups);
    hq = sample4<kOutside>(sp, src_row(sp, y0 - 2 + hr), x0 - 2 + hc, P.vec);
  } else if (tid < 4 * kGroups + 4 * kHaloH) {
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
    const int pa = P.is_luma ? adjust_strength(P.pri, vr) : P.pri;
    const int psh = pa > 0 ? damp_shift(pa, P.damping) : 0;
    const int ssh = P.sec > 0 ? damp_shift(P.sec, P.damping) : 0;
    // primary weights 4, 2, or 3, 3 for an odd adjusted strength >> cs
    const int odd = (pa >> a.cs) & 1, w0 = odd ? 3 : 4, w1 = odd ? 3 : 2;
    const int at = (ty + 2) * kApplyStride + tx + 2;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      if (!nsu[h2]) continue;
      int off[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) off[i] = toff[du[h2]][i];
#pragma unroll
      for (int i = 4 * h2; i < 4 * h2 + 4; ++i)
        if (xs + i < P.pw)
          v[i] = filter_px(tile, at + i, off, v[i], pa, psh, w0, w1, P.sec,
                           ssh);
    }
  }
  if (y < P.H) store_run(P.out + y * P.W, xs, P.W, P.vec, v);
}

// The search's launch for source samples of type TS: the fast grid of the
// high presets (5 x 3) and the full grid (8 x 4) with their counts known
// at compile time; any other set bounded by 8 x 4.
template <typename TS>
void search_grid(int n_pri, int n_sec, bool zero_first, dim3 grid,
                 dim3 block, cudaStream_t st, const SearchArgs& a,
                 const int* d, const int* vr, const uint8_t* ns, int uw,
                 unsigned long long* e) {
  if (n_pri == 5 && n_sec == 3 && zero_first)
    cdef_search_kernel<TS, 5, 3, true><<<grid, block, 0, st>>>(a, d, vr, ns,
                                                               uw, e);
  else if (n_pri == kMaxPri && n_sec == kMaxSec && zero_first)
    cdef_search_kernel<TS, kMaxPri, kMaxSec, true><<<grid, block, 0, st>>>(
        a, d, vr, ns, uw, e);
  else
    cdef_search_kernel<TS, kMaxPri, kMaxSec, false><<<grid, block, 0, st>>>(
        a, d, vr, ns, uw, e);
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
  if (src_bytes == 1)
    search_grid<uint8_t>(n_pri, n_sec, zero_first, grid, block, st, a, d, vr,
                         ns, uw, e);
  else
    search_grid<uint16_t>(n_pri, n_sec, zero_first, grid, block, st, a, d, vr,
                          ns, uw, e);
  return (int)cudaGetLastError();
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
  cdef_apply_kernel<<<ctas, kTileThreads, 0, (cudaStream_t)stream>>>(
      a, (const int*)dirs, (const int*)var, (const uint8_t*)nonskip, uw);
  return (int)cudaGetLastError();
}
