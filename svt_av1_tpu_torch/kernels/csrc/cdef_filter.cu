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
// pixel evaluates 15 strength combinations at preset 8, up to 32, over
// 12 taps), memory traffic in the apply (one read and one write of each
// sample).  Both are a few MB per 1080p frame.
//
// Design: one thread per pixel of the in-frame region.  The thread reads
// its sample and the 12 taps along its unit's direction (primary taps
// along the direction, secondary taps along the directions rotated by 2
// and 6), CDEF_VERY_LARGE outside the frame; a stripe of the frame reads
// the two rows above and below it from its neighbours' halo rows where
// the frame continues (the JAX padded_planes); the clip bounds ignore
// CDEF_VERY_LARGE for the maximum as the reference does.  Combinations
// with a zero primary strength use direction 0, as the reference's
// zero-direction context.  Search: every combination is evaluated from
// that one read; the squared errors of the non-skip pixels are reduced
// per warp, then per block in shared memory, then added to one exact
// int64 total per combination with an integer atomic (order-free, so the
// totals are deterministic).  Apply: the winner only; pixels outside the
// frame are copied.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVeryLarge = 16384;
constexpr int kMaxCombos = 32;

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

// One plane; bsl = log2 of the unit size in this plane (3 luma, 2 chroma).
__global__ void cdef_search_kernel(
    const int* __restrict__ rec, const uint8_t* __restrict__ src, int W,
    int ph, int pw, int bsl, const int* __restrict__ dirs,
    const int* __restrict__ var, const uint8_t* __restrict__ nonskip,
    int uw, int is_luma, unsigned pri_pack, int n_pri, unsigned sec_pack,
    int n_sec, int damping, int cs, const int* __restrict__ top,
    const int* __restrict__ bottom, unsigned long long* __restrict__ err) {
  const Src sp = {rec, top, bottom, W, ph, pw};
  __shared__ int blk[kMaxCombos];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_combo = n_pri * n_sec;
  if (tid < kMaxCombos) blk[tid] = 0;
  __syncthreads();
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  bool valid = y < ph && x < pw;
  int u = 0;
  if (valid) {
    u = (y >> bsl) * uw + (x >> bsl);
    valid = nonskip[u] != 0;
  }
  Taps td, t0;
  int v = 0, s = 0, d = 0, vr = 0;
  if (valid) {
    v = rec[y * W + x];
    s = src[y * W + x];
    d = dirs[u];
    vr = var[u];
    gather(sp, y, x, v, d, td);
    gather(sp, y, x, v, 0, t0);
  }
  const int lane = tid & 31;
  for (int pi = 0; pi < n_pri; ++pi) {
    const int p = (int)((pri_pack >> (4 * pi)) & 15u) << cs;
    const int pri = is_luma ? adjust_strength(p, vr) : p;
    const Taps& t = p ? td : t0;
    for (int si = 0; si < n_sec; ++si) {
      const int sc = (int)((sec_pack >> (2 * si)) & 3u);
      const int sec = (sc + (sc == 3)) << cs;
      int e = 0;
      if (valid) {
        const int f = (p == 0 && sec == 0) ? v : filter(t, v, pri, sec,
                                                         damping, cs);
        e = (f - s) * (f - s);
      }
      for (int off = 16; off > 0; off >>= 1)
        e += __shfl_down_sync(0xffffffffu, e, off);
      if (lane == 0 && e) atomicAdd(&blk[pi * n_sec + si], e);
    }
  }
  __syncthreads();
  if (tid < n_combo && blk[tid])
    atomicAdd(&err[tid], (unsigned long long)blk[tid]);
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

// rec: int32 [H, W]; src: uint8 [H, W]; frame [0, ph) x [0, pw); dirs,
// var: int32 unit maps and nonskip uint8 [uh, uw] (luma 8x8 units, 4x4
// in chroma); pri_pack: 4-bit coded primaries, sec_pack: 2-bit coded
// secondaries; top, bottom: int32 [2, W] rows above and below a stripe
// of the frame, or null at the frame's edges; err: int64 [n_pri * n_sec]
// totals to add to.
extern "C" int cdef_search_launch(const void* rec, const void* src, int H,
                                  int W, int ph, int pw, int bsl,
                                  const void* dirs, const void* var,
                                  const void* nonskip, int uw, int is_luma,
                                  unsigned pri_pack, int n_pri,
                                  unsigned sec_pack, int n_sec, int damping,
                                  int cs, const void* top,
                                  const void* bottom, void* err,
                                  void* stream) {
  if (n_pri * n_sec > kMaxCombos || n_pri * n_sec < 1 || ph > H || pw > W)
    return (int)cudaErrorInvalidValue;
  const dim3 threads(32, 8);
  const dim3 blocks((pw + 31) / 32, (ph + 7) / 8);
  cdef_search_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)rec, (const uint8_t*)src, W, ph, pw, bsl,
      (const int*)dirs, (const int*)var, (const uint8_t*)nonskip, uw,
      is_luma, pri_pack, n_pri, sec_pack, n_sec, damping, cs,
      (const int*)top, (const int*)bottom, (unsigned long long*)err);
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
