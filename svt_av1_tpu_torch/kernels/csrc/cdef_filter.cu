// K4 cdef_filter: CDEF strength search and apply over a whole plane.
//
// Replaces the JAX package's full-plane CDEF bodies
// (svt_av1_tpu/ops/cdef.py _PlaneCtx, cdef_search_errs and
// _cdef_apply_traced with _constrain_xp, _adjust_strength_xp and
// pad_very_large; B10), run inside the fused filter chain and the
// standalone CDEF programs (_jit_search_apply, _jit_search, _jit_apply;
// B13).
//
// What bounds it on the H100: integer throughput in the search (each
// pixel evaluates 15 strength combinations at preset 8, up to 32), memory
// traffic in the apply (one read and one write of each sample).  Both
// are a few MB per 1080p frame.
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
// Search:
// * One launch for all three planes: luma tiles first, then each chroma
//   plane's; luma adds to err_y, both chroma planes to err_uv.
// * A CTA of 256 threads takes a 64x32 tile of one plane, loaded once into
//   shared memory as int16 with its 2-row and 2-column halo
//   (CDEF_VERY_LARGE outside the frame, the neighbours' rows in stripe
//   mode); each thread takes 8 pixels of a row.
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
// Apply: one thread per pixel, the winner only; pixels outside the frame
// are copied.
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

__device__ __forceinline__ int constrain(int diff, int s, int damping) {
  if (s <= 0) return 0;
  const int m = msb(s) < 7 ? msb(s) : 7;
  const int shift = damping - m > 0 ? damping - m : 0;
  const int ad = abs(diff);
  int mag = s - (ad >> shift);
  mag = mag > 0 ? mag : 0;
  mag = ad < mag ? ad : mag;
  return diff < 0 ? -mag : mag;
}

__device__ __forceinline__ int adjust_strength(int strength, int var) {
  if (var <= 0) return 0;
  const int v6 = var >> 6;
  int m = v6 >= 1 ? msb(v6) : 0;
  m = m < 12 ? m : 12;
  return (strength * (4 + m) + 8) >> 4;
}

struct Taps {
  int p[4];        // primary: k0+, k0-, k1+, k1-
  int s[8];        // secondary: k0: r2+, r2-, r6+, r6-; k1: ...
  int mx, mn;
};

// The plane with its surroundings: rows [0, ph) of the plane, rows -2, -1
// from top[2, W] and rows ph, ph + 1 from bottom[2, W] where given;
// CDEF_VERY_LARGE elsewhere and at every column outside [0, pw).
struct Src {
  const int* plane;
  const int* top;
  const int* bottom;
  int W, ph, pw;
};

__device__ __forceinline__ int sample(const Src& p, int y, int x) {
  if (x < 0 || x >= p.pw) return kVeryLarge;
  if (y >= 0 && y < p.ph) return p.plane[y * p.W + x];
  if (y < 0 && y >= -2 && p.top) return p.top[(y + 2) * p.W + x];
  if (y >= p.ph && y < p.ph + 2 && p.bottom)
    return p.bottom[(y - p.ph) * p.W + x];
  return kVeryLarge;
}

__device__ void gather(const Src& p, int y, int x, int v, int d,
                       Taps& t) {
  t.mx = v;
  t.mn = v;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int sg = 0; sg < 2; ++sg) {
      const int sign = sg ? -1 : 1;
      const int a =
          sample(p, y + sign * kDir[d][k][0], x + sign * kDir[d][k][1]);
      t.p[2 * k + sg] = a;
      if (a != kVeryLarge) t.mx = max(t.mx, a);
      t.mn = min(t.mn, a);
    }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int dr = (d + (ri ? 6 : 2)) & 7;
#pragma unroll
      for (int sg = 0; sg < 2; ++sg) {
        const int sign = sg ? -1 : 1;
        const int a = sample(p, y + sign * kDir[dr][k][0],
                             x + sign * kDir[dr][k][1]);
        t.s[4 * k + 2 * ri + sg] = a;
        if (a != kVeryLarge) t.mx = max(t.mx, a);
        t.mn = min(t.mn, a);
      }
    }
  }
}

__device__ __forceinline__ int filter(const Taps& t, int v, int pri,
                                      int sec, int damping, int cs) {
  const int tap_idx = (pri >> cs) & 1;
  const int pt[2] = {tap_idx ? 3 : 4, tap_idx ? 3 : 2};
  int sum = 0;
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int sg = 0; sg < 2; ++sg)
      sum += pt[k] * constrain(t.p[2 * k + sg] - v, pri, damping);
  if (sec) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sum += (k ? 1 : 2) * constrain(t.s[4 * k + j] - v, sec, damping);
  }
  const int y = v + ((8 + sum - (sum < 0)) >> 4);
  return min(max(y, t.mn), t.mx);
}

constexpr int kMaxPri = 8, kMaxSec = 4;
constexpr int kTileW = 64, kTileH = 32;
constexpr int kSearchThreads = 256;
constexpr int kHaloW = kTileW + 4, kHaloH = kTileH + 4;
constexpr int kTileStride = 72;           // int16 per tile row

struct SearchPlane {
  const int* rec;
  const uint8_t* src;
  const int* top;                 // [2, W] above a stripe, or null
  const int* bottom;              // [2, W] below it, or null
  int W, ph, pw, bsl, is_luma, damping, grp, tiles_x, cta0;
};

struct SearchArgs {
  SearchPlane pl[3];
  int n_planes;
  int pri[kMaxPri], n_pri;        // coded primaries (before << cs)
  int sec[kMaxSec], n_sec;        // secondaries in filter units
  int cs;
};

// |constrain(diff, s, damping)| for |diff| = ad at strength s > 0, with
// shift = max(0, damping - min(msb(s), 7)); the caller applies the sign
// and the tap's weight.
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
// reads.
__device__ __forceinline__ int tap_offset(int d, int i) {
  const bool prim = i < 4;
  const int k = prim ? i >> 1 : (i - 4) >> 2;
  const int ri = prim ? 0 : ((i - 4) >> 1) & 1;
  const int sign = (i & 1) ? -1 : 1;
  const int dd = prim ? d : (d + (ri ? 6 : 2)) & 7;
  return sign * (kDir[dd][k][0] * kTileStride + kDir[dd][k][1]);
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
// grids) or bounds it.
template <int NPRI, int NSEC, bool EXACT>
__global__ void __launch_bounds__(kSearchThreads) cdef_search_kernel(
    SearchArgs a, const int* __restrict__ dirs, const int* __restrict__ var,
    const uint8_t* __restrict__ nonskip, int uw,
    unsigned long long* __restrict__ err) {
  __shared__ int16_t tile[kHaloH * kTileStride];
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
  if (tid < 96) toff[tid / 12][tid % 12] = tap_offset(tid / 12, tid % 12);
  for (int i = tid; i < kHaloH * kHaloW; i += kSearchThreads) {
    const int r = i / kHaloW, c = i - r * kHaloW;
    tile[r * kTileStride + c] = (int16_t)sample(sp, y0 - 2 + r, x0 - 2 + c);
  }
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
    const int at = ly * kTileStride + x - x0 + 2;
    const int v = tile[at];
    const int s = P.src[y * P.W + x];
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

__global__ void cdef_apply_kernel(
    const int* __restrict__ rec, int* __restrict__ out, int H, int W,
    int ph, int pw, int bsl, const int* __restrict__ dirs,
    const int* __restrict__ var, const uint8_t* __restrict__ nonskip,
    int uw, int is_luma, int pri, int sec, int damping, int cs,
    const int* __restrict__ top, const int* __restrict__ bottom) {
  const Src sp = {rec, top, bottom, W, ph, pw};
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (y >= H || x >= W) return;
  const int v = rec[y * W + x];
  int o = v;
  if (y < ph && x < pw && (pri > 0 || sec > 0)) {
    const int u = (y >> bsl) * uw + (x >> bsl);
    if (nonskip[u]) {
      Taps t;
      gather(sp, y, x, v, pri > 0 ? dirs[u] : 0, t);
      o = filter(t, v, is_luma ? adjust_strength(pri, var[u]) : pri, sec,
                 damping, cs);
    }
  }
  out[y * W + x] = o;
}

}  // namespace

// One launch for the search of n_planes planes (luma, then chroma):
// rec[i]: int32 [H[i], W[i]]; src[i]: uint8 of the same shape; frame [0,
// ph[i]) x [0, pw[i]); top[i], bottom[i]: int32 [2, W[i]] rows above and
// below a stripe of the frame, or null at the frame's edges; dirs, var:
// int32 luma unit maps and nonskip uint8 [uh, uw] (8x8 luma units, 4x4 in
// chroma); pri_pack: 4-bit coded primaries, sec_pack: 2-bit coded
// secondaries; damping: the luma damping (chroma takes one less); err:
// int64 [2, n_pri * n_sec] totals (luma, chroma) to add to.
extern "C" int cdef_search_launch(int n_planes, const void* const* rec,
                                  const void* const* src,
                                  const void* const* top,
                                  const void* const* bottom, const int* H,
                                  const int* W, const int* ph, const int* pw,
                                  const void* dirs, const void* var,
                                  const void* nonskip, int uw,
                                  unsigned pri_pack, int n_pri,
                                  unsigned sec_pack, int n_sec, int damping,
                                  int cs, void* err, void* stream) {
  if (n_planes < 1 || n_planes > 3 || n_pri < 1 || n_pri > kMaxPri ||
      n_sec < 1 || n_sec > kMaxSec)
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
    p.src = (const uint8_t*)src[i];
    p.top = (const int*)top[i];
    p.bottom = (const int*)bottom[i];
    p.W = W[i];
    p.ph = ph[i];
    p.pw = pw[i];
    p.bsl = i == 0 ? 3 : 2;
    p.is_luma = i == 0;
    p.damping = damping - (i == 0 ? 0 : 1);
    p.grp = i == 0 ? 0 : 1;
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
  // the fast grid of the high presets (5 x 3) and the full grid (8 x 4)
  // with their counts known at compile time; any other set bounded by 8
  // x 4
  bool zero_first = a.pri[0] == 0 && a.sec[0] == 0;
  for (int i = 1; i < n_pri; ++i) zero_first &= a.pri[i] > 0;
  for (int i = 1; i < n_sec; ++i) zero_first &= a.sec[i] > 0;
  if (n_pri == 5 && n_sec == 3 && zero_first)
    cdef_search_kernel<5, 3, true><<<grid, block, 0, st>>>(a, d, vr, ns, uw, e);
  else if (n_pri == kMaxPri && n_sec == kMaxSec && zero_first)
    cdef_search_kernel<kMaxPri, kMaxSec, true><<<grid, block, 0, st>>>(
        a, d, vr, ns, uw, e);
  else
    cdef_search_kernel<kMaxPri, kMaxSec, false><<<grid, block, 0, st>>>(
        a, d, vr, ns, uw, e);
  return (int)cudaGetLastError();
}

// pri, sec: this plane's strengths in filter units (sec 3 already 4);
// top, bottom: as for cdef_search_launch; out: int32 [H, W], the filtered
// frame region and a copy elsewhere.
extern "C" int cdef_apply_launch(const void* rec, void* out, int H, int W,
                                 int ph, int pw, int bsl, const void* dirs,
                                 const void* var, const void* nonskip,
                                 int uw, int is_luma, int pri, int sec,
                                 int damping, int cs, const void* top,
                                 const void* bottom, void* stream) {
  if (ph > H || pw > W) return (int)cudaErrorInvalidValue;
  const dim3 threads(32, 8);
  const dim3 blocks((W + 31) / 32, (H + 7) / 8);
  cdef_apply_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)rec, (int*)out, H, W, ph, pw, bsl, (const int*)dirs,
      (const int*)var, (const uint8_t*)nonskip, uw, is_luma, pri, sec,
      damping, cs, (const int*)top, (const int*)bottom);
  return (int)cudaGetLastError();
}
