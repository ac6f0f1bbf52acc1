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
// Design: one thread block per 64x64 superblock, 1024 threads = 32 warps
// = 16 units x 2 arms.  (1) Per unit and reference: the SAD of the
// reference's quarter-pel prediction and the MV-bits proxy, in the same
// float steps as K8 step (1), give the single-reference score; the unit's
// forward (fi) and backward (bi) references are the first minima over
// each side.  (2) Each arm's seed is the other arm's MV mirrored through
// the frame and scaled by the two distances (floor division, as the
// numpy twin's // of negatives).  (3) Warp (unit, arm) loads the held
// arm's 16x16 prediction and the 22x22 window of the searched reference
// into shared memory; the window origin is clipped to an MC_PAD-sample
// edge pad that clamped reads reproduce.  Lane l scores offsets l and
// l + 32 of the 7x7 grid by the SAD of (held + window + 1) >> 1; a warp
// reduction keeps the (SAD, raster index) minimum, i.e. the first
// minimum.  (4) Per unit, the plain average of the two predictions, the
// refined backward arm and the refined forward arm compete by SAD (first
// minimum); the winner's prediction, SAD and MVs are written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxRefs = 3;
constexpr int kPad = 80;              // MC_PAD
constexpr int kR = 3;                 // JOINT_R
constexpr int kWin = 16 + 2 * kR;     // 22
constexpr int kNoff = (2 * kR + 1) * (2 * kR + 1);
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

__global__ void __launch_bounds__(kThreads) compound_joint_kernel(
    const uint8_t* __restrict__ src, const uint8_t* __restrict__ refs,
    const uint8_t* __restrict__ preds, int K, int H, int W,
    const int* __restrict__ mvq_r, const int* __restrict__ mvq_c,
    const int* __restrict__ sb_r, const int* __restrict__ sb_c,
    const float* __restrict__ tab, int n_tab, float pen_mv, int bwd_mask,
    int rel0, int rel1, int rel2, uint8_t* __restrict__ out_pred,
    int* __restrict__ out_sad, int* __restrict__ out_mvr,
    int* __restrict__ out_mvc, int* __restrict__ out_mv1r,
    int* __restrict__ out_mv1c, int* __restrict__ out_fi,
    int* __restrict__ out_bi) {
  __shared__ uint8_t ssb[64 * 64];             // the source SB
  __shared__ uint8_t held[32][256];             // per warp: the held arm
  __shared__ uint8_t win[32][kWin * kWin];      // per warp: the window
  __shared__ int part[kMaxRefs][32];
  __shared__ float base[kMaxRefs][16];
  __shared__ int ufi[16], ubi[16];
  __shared__ int seed[2][16][2];                // arm, unit, (r, c)
  __shared__ int org[2][16][2];                 // clipped window origins
  __shared__ int best[2][16][2];                // (SAD, offset index)
  __shared__ int pick[16];

  const int n_sbx = W / 64;
  const int sby = blockIdx.x / n_sbx, sbx = blockIdx.x % n_sbx;
  const int nr16 = H / 16, nc16 = W / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t plane = (size_t)H * W;
  const int rel[kMaxRefs] = {rel0, rel1, rel2};

  for (int k = tid; k < 64 * 64; k += kThreads)
    ssb[k] = src[(size_t)(sby * 64 + (k >> 6)) * W + sbx * 64 + (k & 63)];

  // (1) single-reference scores: thread t covers 4 pixels of unit t >> 6
  const int u = tid >> 6, uy = u >> 2, ux = u & 3;
  int pix[4], sv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = (tid & 63) * 4 + i;
    pix[i] = (sby * 64 + uy * 16 + (q >> 4)) * W + sbx * 64 + ux * 16 +
             (q & 15);
    sv[i] = src[pix[i]];
  }
  for (int k = 0; k < K; ++k) {
    int d = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      d += abs(sv[i] - (int)preds[k * plane + pix[i]]);
    for (int off = 16; off > 0; off >>= 1)
      d += __shfl_down_sync(0xffffffffu, d, off);
    if (lane == 0) part[k][warp] = d;
  }
  __syncthreads();
  if (tid < 16 * K) {
    const int k = tid / 16, v = tid % 16;
    const int gy = sby * 4 + (v >> 2), gx = sbx * 4 + (v & 3);
    const int g = (k * nr16 + gy) * nc16 + gx;
    const int s = (k * (H / 64) + sby) * n_sbx + sbx;
    const int dr = abs(mvq_r[g] - sb_r[s] * 8);
    const int dc = abs(mvq_c[g] - sb_c[s] * 8);
    const float m = __fmul_rn(
        kMvBitScale,
        __fadd_rn(log2_1p8(tab, n_tab, dr), log2_1p8(tab, n_tab, dc)));
    base[k][v] = __fadd_rn((float)(part[k][2 * v] + part[k][2 * v + 1]),
                           __fmul_rn(pen_mv, m));
  }
  __syncthreads();

  // (2) the paired references and the mirrored seeds
  if (tid < 16) {
    int fi = -1, bi = -1;
    for (int k = 0; k < K; ++k) {
      if ((bwd_mask >> k) & 1) {
        if (bi < 0 || base[k][tid] < base[bi][tid]) bi = k;
      } else {
        if (fi < 0 || base[k][tid] < base[fi][tid]) fi = k;
      }
    }
    ufi[tid] = fi;
    ubi[tid] = bi;
    const int gy = sby * 4 + (tid >> 2), gx = sbx * 4 + (tid & 3);
    const int gf = (fi * nr16 + gy) * nc16 + gx;
    const int gb = (bi * nr16 + gy) * nc16 + gx;
    const int df = max(abs(rel[fi]), 1), db = max(abs(rel[bi]), 1);
    // arm 0 searches the backward reference around the mirrored forward
    // MV; arm 1 the forward reference around the mirrored backward MV
    seed[0][tid][0] = mirror(mvq_r[gf], df, db);
    seed[0][tid][1] = mirror(mvq_c[gf], df, db);
    seed[1][tid][0] = mirror(mvq_r[gb], db, df);
    seed[1][tid][1] = mirror(mvq_c[gb], db, df);
  }
  __syncthreads();

  // (3) one warp per (unit, arm): the 7x7 joint search
  {
    const int wu = warp >> 1, arm = warp & 1;
    const int wy = sby * 64 + (wu >> 2) * 16, wx = sbx * 64 + (wu & 3) * 16;
    const int held_k = arm == 0 ? ufi[wu] : ubi[wu];
    const int arm_k = arm == 0 ? ubi[wu] : ufi[wu];
    for (int k = lane; k < 256; k += 32)
      held[warp][k] =
          preds[held_k * plane + (size_t)(wy + (k >> 4)) * W + wx + (k & 15)];
    const int oy = clampi(wy + (seed[arm][wu][0] >> 3) - kR + kPad, 0,
                          H + 2 * kPad - kWin);
    const int ox = clampi(wx + (seed[arm][wu][1] >> 3) - kR + kPad, 0,
                          W + 2 * kPad - kWin);
    const uint8_t* rp = refs + arm_k * plane;
    for (int k = lane; k < kWin * kWin; k += 32) {
      const int i = k / kWin, j = k - i * kWin;
      win[warp][k] = rp[(size_t)clampi(oy - kPad + i, 0, H - 1) * W +
                        clampi(ox - kPad + j, 0, W - 1)];
    }
    __syncwarp();
    const uint8_t* sblk = ssb + ((wu >> 2) * 16) * 64 + (wu & 3) * 16;
    int bc = 0x7fffffff, bo = 0x7fffffff;
    for (int o = lane; o < kNoff; o += 32) {
      const int dy = o / (2 * kR + 1), dx = o - dy * (2 * kR + 1);
      int sad = 0;
      for (int r = 0; r < 16; ++r) {
        const uint8_t* wr = win[warp] + (dy + r) * kWin + dx;
        const uint8_t* hr = held[warp] + r * 16;
        const uint8_t* sr = sblk + r * 64;
#pragma unroll
        for (int c = 0; c < 16; ++c)
          sad += abs((int)sr[c] - (((int)hr[c] + (int)wr[c] + 1) >> 1));
      }
      if (sad < bc) {        // o grows: the first minimum of this lane
        bc = sad;
        bo = o;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const int c2 = __shfl_down_sync(0xffffffffu, bc, off);
      const int o2 = __shfl_down_sync(0xffffffffu, bo, off);
      if (c2 < bc || (c2 == bc && o2 < bo)) {
        bc = c2;
        bo = o2;
      }
    }
    if (lane == 0) {
      best[arm][wu][0] = bc;
      best[arm][wu][1] = bo;
      org[arm][wu][0] = oy;
      org[arm][wu][1] = ox;
    }
  }
  __syncthreads();

  // (4) the plain average's SAD (threads as in (1)), the 3-way pick
  {
    const int pf = ufi[u], pb = ubi[u];
    int d = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a = preds[pf * plane + pix[i]], b = preds[pb * plane + pix[i]];
      d += abs(sv[i] - ((a + b + 1) >> 1));
    }
    for (int off = 16; off > 0; off >>= 1)
      d += __shfl_down_sync(0xffffffffu, d, off);
    if (lane == 0) part[0][warp] = d;
  }
  __syncthreads();
  if (tid < 16) {
    const int sad0 = part[0][2 * tid] + part[0][2 * tid + 1];
    int p = 0, ps = sad0;
    if (best[0][tid][0] < ps) {
      p = 1;
      ps = best[0][tid][0];
    }
    if (best[1][tid][0] < ps) {
      p = 2;
      ps = best[1][tid][0];
    }
    pick[tid] = p;
    const int gy = sby * 4 + (tid >> 2), gx = sbx * 4 + (tid & 3);
    const int o = gy * nc16 + gx;
    const int gf = (ufi[tid] * nr16 + gy) * nc16 + gx;
    const int gb = (ubi[tid] * nr16 + gy) * nc16 + gx;
    int mvr = mvq_r[gf], mvc = mvq_c[gf], mv1r = mvq_r[gb], mv1c = mvq_c[gb];
    if (p > 0) {
      const int a = p - 1;
      const int bo = best[a][tid][1];
      const int by = bo / (2 * kR + 1), bx = bo - by * (2 * kR + 1);
      // the realized MV comes from the clipped window origin
      const int r8 = (org[a][tid][0] - kPad + by - gy * 16) * 8;
      const int c8 = (org[a][tid][1] - kPad + bx - gx * 16) * 8;
      if (a == 0) {
        mv1r = r8;
        mv1c = c8;
      } else {
        mvr = r8;
        mvc = c8;
      }
    }
    out_sad[o] = ps;
    out_mvr[o] = mvr;
    out_mvc[o] = mvc;
    out_mv1r[o] = mv1r;
    out_mv1c[o] = mv1c;
    out_fi[o] = ufi[tid];
    out_bi[o] = ubi[tid];
  }
  __syncthreads();
  // the winner's prediction, 4 pixels per thread
  {
    const int p = pick[u];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = (tid & 63) * 4 + i, r = q >> 4, c = q & 15;
      int v;
      if (p == 0) {
        v = ((int)preds[ufi[u] * plane + pix[i]] +
             (int)preds[ubi[u] * plane + pix[i]] + 1) >> 1;
      } else {
        const int a = p - 1, wv = 2 * u + a;
        const int bo = best[a][u][1];
        const int by = bo / (2 * kR + 1), bx = bo - by * (2 * kR + 1);
        v = ((int)held[wv][r * 16 + c] +
             (int)win[wv][(by + r) * kWin + bx + c] + 1) >> 1;
      }
      out_pred[pix[i]] = (uint8_t)v;
    }
  }
}

}  // namespace

// src: uint8 [H, W]; refs, preds: uint8 [K, H, W] (K <= 3) the reference
// planes and their quarter-pel predictions; mvq_r, mvq_c: int32 [K, H/16,
// W/16] eighth-pel; sb_r, sb_c: int32 [K, H/64, W/64] full-pel 64x64
// winners; tab: float32 [n_tab] log2(1 + d/8); pen_mv: the MV-bits
// weight; bwd_mask: bit k marks reference k backward (both sides must be
// present); rel0..rel2: the signed display distances.  Out: pred uint8
// [H, W]; sad, mv_r, mv_c (forward arm), mv1_r, mv1_c (backward arm),
// fwd_i, bwd_i int32 [H/16, W/16].  Returns the CUDA error of the launch.
extern "C" int compound_joint_launch(
    const void* src, const void* refs, const void* preds, int K, int H, int W,
    const void* mvq_r, const void* mvq_c, const void* sb_r, const void* sb_c,
    const void* tab, int n_tab, float pen_mv, int bwd_mask, int rel0,
    int rel1, int rel2, void* out_pred, void* out_sad, void* out_mvr,
    void* out_mvc, void* out_mv1r, void* out_mv1c, void* out_fi,
    void* out_bi, void* stream) {
  const int all = (1 << K) - 1;
  if (K < 2 || K > kMaxRefs || H % 64 || W % 64 || (bwd_mask & all) == 0 ||
      (bwd_mask & all) == all)
    return (int)cudaErrorInvalidValue;
  compound_joint_kernel<<<(H / 64) * (W / 64), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const uint8_t*)refs, (const uint8_t*)preds, K, H,
      W, (const int*)mvq_r, (const int*)mvq_c, (const int*)sb_r,
      (const int*)sb_c, (const float*)tab, n_tab, pen_mv, bwd_mask, rel0,
      rel1, rel2, (uint8_t*)out_pred, (int*)out_sad, (int*)out_mvr,
      (int*)out_mvc, (int*)out_mv1r, (int*)out_mv1c, (int*)out_fi,
      (int*)out_bi);
  return (int)cudaGetLastError();
}
