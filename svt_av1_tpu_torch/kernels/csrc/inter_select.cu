// K8 inter_select: per-unit reference selection, prediction assembly and
// the residual cost maps of an inter frame.
//
// Replaces the selection, prediction-assembly and residual part of the
// JAX package's inter_frame_maps (svt_av1_tpu/pipeline/batched_inter.py
// :255-383, B5) and its residual RD model _mc_cost_maps (:71, B6 inter),
// traced inside _jitted_inter (:398), with the averaged-compound
// candidate that K9 (compound_joint.cu) builds as an optional (K+1)-th row.
//
// What bounds it on the H100: FP32 arithmetic.  The 10 INTER_SHAPES
// grids each take two DCT products per block, sum(w + h) = 576
// multiply-adds per pixel: about 2.5 GFLOP per 1080p frame, against
// about 2 MB per reference of planes and MV fields.
//
// Design: every INTER_SHAPES block lies inside one 64x64 superblock of
// the 64-aligned buffer, so one thread block per SB (1024 threads) does
// the whole step.  (1) Per unit of 16x16 and reference: the SAD of the
// reference's prediction (exact integers) and the MV-bits proxy
// MV_BIT_SCALE * (log2(1 + d_r/8) + log2(1 + d_c/8)), d in eighth-pel
// from the reference's 64x64 winner; log2 comes from a float32 table
// that the host builds with numpy (d takes few, discrete values), so the
// kernel and the plain version agree to the bit.  (2) base = sad +
// pens[3]*mvb; the compound row's base is its SAD + pens[3] * (mvb[fi] +
// mvb[bi]), the MV bits of both arms.  The SB score sums the 16 units in
// numpy's order (each row of 4 left to right, then the rows top to
// bottom), adds pens[0] to every reference but the first and pens[1] to
// the compound row, and takes the first minimum; each unit then takes the
// first minimum of base + pens[2] for leaving the SB's winner.  A
// compound unit reports the candidate's two MVs and MV bits; every unit
// reports the candidate's pair (fwd_i, bwd_i), 0 without it.  (3) The
// winning prediction is gathered and the residual kept in shared memory
// as float.  (4) For each shape the residual blocks go through
// the orthonormal DCT (D_h R D_w^T in float32, no TF32) and the float
// quantizer / rate model of K1 (cost_model.cuh); the 64-point shapes
// zero every coefficient outside the top-left 32x32 band.  Every float
// step rounds as the plain version does (no fast-math, IEEE intrinsics);
// only the orders of the DCT and block sums differ, hence the cost maps'
// tolerance.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cost_model.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxRefs = 3;
constexpr int kMaxCand = kMaxRefs + 1;   // + the compound row
constexpr int kShapes = 10;
constexpr float kMvBitScale = 2.0f;
constexpr float kInterModeBits = 3.0f;
constexpr size_t kSmemBytes = 4 * 4096 * sizeof(float);

__device__ __forceinline__ int dct_off(int n) {
  return n == 8 ? 0 : (n == 16 ? 64 : (n == 32 ? 320 : 1344));
}

__device__ __forceinline__ float log2_1p8(const float* tab, int n_tab, int d) {
  return d < n_tab ? tab[d]
                   : log2f(__fadd_rn(1.f, __fdiv_rn((float)d, 8.f)));
}

__global__ void __launch_bounds__(kThreads) inter_select_kernel(
    const uint8_t* __restrict__ src, const uint8_t* __restrict__ preds,
    int K, int H, int W, const int* __restrict__ mvq_r,
    const int* __restrict__ mvq_c, const int* __restrict__ sb_r,
    const int* __restrict__ sb_c, const float* __restrict__ tab, int n_tab,
    float pen_ref, float pen_comp, float pen_dev, float pen_mv,
    const int* __restrict__ shapes, const float* __restrict__ qpar,
    const float* __restrict__ dct, float lam,
    const uint8_t* __restrict__ cpred, const int* __restrict__ csad,
    const int* __restrict__ cfi, const int* __restrict__ cbi,
    const int* __restrict__ cmvr, const int* __restrict__ cmvc,
    const int* __restrict__ cmv1r, const int* __restrict__ cmv1c,
    int* __restrict__ out_sel, int* __restrict__ out_mvr,
    int* __restrict__ out_mvc, int* __restrict__ out_mv1r,
    int* __restrict__ out_mv1c, int* __restrict__ out_fwd,
    int* __restrict__ out_bwd, float* __restrict__ out_mvb,
    float* __restrict__ out_cost) {
  extern __shared__ __align__(16) float fsm[];
  float* resid = fsm;
  float* tmp = fsm + 4096;
  float* dh = fsm + 2 * 4096;
  float* dw = fsm + 3 * 4096;
  __shared__ int part[kMaxRefs][32];
  __shared__ float base[kMaxCand][16];
  __shared__ float mvb[kMaxCand][16];
  __shared__ int usel[16];
  __shared__ int sb_sel;
  __shared__ float red_e[64];       // one slot per lane segment (>= 16)
  __shared__ float red_m[64];
  __shared__ int red_n[64];

  const int n_sbx = W / 64;
  const int sby = blockIdx.x / n_sbx, sbx = blockIdx.x % n_sbx;
  const int nr16 = H / 16, nc16 = W / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t plane = (size_t)H * W;
  const bool has_comp = cpred != nullptr;
  const int NC = K + (has_comp ? 1 : 0);

  // (1) unit SADs: thread t covers 4 pixels of unit t >> 6
  const int u = tid >> 6, uy = u >> 2, ux = u & 3;
  int pix[4];
  int sv[4];
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
    const int sad = part[k][2 * v] + part[k][2 * v + 1];
    const int gy = sby * 4 + (v >> 2), gx = sbx * 4 + (v & 3);
    const int g = (k * nr16 + gy) * nc16 + gx;
    const int s = (k * (H / 64) + sby) * n_sbx + sbx;
    const int dr = abs(mvq_r[g] - sb_r[s] * 8);
    const int dc = abs(mvq_c[g] - sb_c[s] * 8);
    const float m = __fmul_rn(
        kMvBitScale,
        __fadd_rn(log2_1p8(tab, n_tab, dr), log2_1p8(tab, n_tab, dc)));
    mvb[k][v] = m;
    base[k][v] = __fadd_rn((float)sad, __fmul_rn(pen_mv, m));
  }
  __syncthreads();
  if (has_comp && tid < 16) {
    // the compound row: its SAD (from K9) and both arms' MV bits
    const int gy = sby * 4 + (tid >> 2), gx = sbx * 4 + (tid & 3);
    const int o = gy * nc16 + gx;
    const float m = __fadd_rn(mvb[cfi[o]][tid], mvb[cbi[o]][tid]);
    mvb[K][tid] = m;
    base[K][tid] = __fadd_rn((float)csad[o], __fmul_rn(pen_mv, m));
  }
  __syncthreads();
  // (2) SB winner, then the per-unit choice
  if (tid == 0) {
    float best = 0.f;
    int bk = 0;
    for (int k = 0; k < NC; ++k) {
      float tot = 0.f;
      for (int r = 0; r < 4; ++r) {
        float row = base[k][r * 4];
        for (int c = 1; c < 4; ++c) row = __fadd_rn(row, base[k][r * 4 + c]);
        tot = r == 0 ? row : __fadd_rn(tot, row);
      }
      const float sc =
          __fadd_rn(tot, k == K ? pen_comp : (k > 0 ? pen_ref : 0.f));
      if (k == 0 || sc < best) {
        best = sc;
        bk = k;
      }
    }
    sb_sel = bk;
  }
  __syncthreads();
  if (tid < 16) {
    float best = 0.f;
    int bk = 0;
    for (int k = 0; k < NC; ++k) {
      const float sc = __fadd_rn(base[k][tid], k != sb_sel ? pen_dev : 0.f);
      if (k == 0 || sc < best) {
        best = sc;
        bk = k;
      }
    }
    usel[tid] = bk;
    const int gy = sby * 4 + (tid >> 2), gx = sbx * 4 + (tid & 3);
    const int o = gy * nc16 + gx;
    out_sel[o] = bk;
    if (bk == K) {
      out_mvr[o] = cmvr[o];
      out_mvc[o] = cmvc[o];
      out_mv1r[o] = cmv1r[o];
      out_mv1c[o] = cmv1c[o];
    } else {
      out_mvr[o] = mvq_r[(bk * nr16 + gy) * nc16 + gx];
      out_mvc[o] = mvq_c[(bk * nr16 + gy) * nc16 + gx];
      out_mv1r[o] = 0;
      out_mv1c[o] = 0;
    }
    out_fwd[o] = has_comp ? cfi[o] : 0;
    out_bwd[o] = has_comp ? cbi[o] : 0;
    out_mvb[o] = mvb[bk][tid];
  }
  __syncthreads();
  // (3) residual of the winning prediction
  {
    const int k = usel[u];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = (tid & 63) * 4 + i;
      const int p = k == K ? cpred[pix[i]] : preds[k * plane + pix[i]];
      resid[(uy * 16 + (q >> 4)) * 64 + ux * 16 + (q & 15)] =
          (float)(sv[i] - p);
    }
  }

  // (4) cost grids of the 10 shapes
  int cost_off = 0;
  for (int s = 0; s < kShapes; ++s) {
    const int w = shapes[2 * s], h = shapes[2 * s + 1];
    const int nbx = 64 / w, nb = (64 / h) * nbx, n = w * h;
    __syncthreads();     // resid ready / previous shape done with smem
    for (int k = tid; k < h * h; k += kThreads) dh[k] = dct[dct_off(h) + k];
    for (int k = tid; k < w * w; k += kThreads) dw[k] = dct[dct_off(w) + k];
    __syncthreads();
    // tmp = D_h @ R per block (block-major coefficient order)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = tid * 4 + i, j = q / n, rc = q - j * n;
      const int r = rc / w, c = rc - r * w;
      const int oy = (j / nbx) * h, ox = (j % nbx) * w;
      float acc = 0.f;
      for (int a = 0; a < h; ++a)
        acc += dh[r * h + a] * resid[(oy + a) * 64 + ox + c];
      tmp[q] = acc;
    }
    __syncthreads();
    const float zd = qpar[6 * s], za = qpar[6 * s + 1];
    const float rd = qpar[6 * s + 2], ra = qpar[6 * s + 3];
    const float sd = qpar[6 * s + 4], sa = qpar[6 * s + 5];
    float e2s = 0.f, mgs = 0.f;
    int nzs = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = tid * 4 + i, j = q / n, rc = q - j * n;
      const int r = rc / w, c = rc - r * w;
      const float* trow = tmp + j * n + r * w;
      float cf = 0.f;
      for (int b = 0; b < w; ++b) cf += trow[b] * dw[c * w + b];
      const bool dc = rc == 0;
      float e2, mg;
      int nz;
      cost_model::coef(cf, dc ? zd : za, dc ? rd : ra, dc ? sd : sa,
                       r < 32 && c < 32, e2, nz, mg);
      e2s = __fadd_rn(e2s, e2);
      mgs = __fadd_rn(mgs, mg);
      nzs += nz;
    }
    // per-block sums: segments of min(32, n / 4) lanes, then in order
    const int tpb = n / 4, seg = tpb < 32 ? tpb : 32;
    for (int off = seg / 2; off > 0; off >>= 1) {
      e2s = __fadd_rn(e2s, __shfl_down_sync(0xffffffffu, e2s, off, seg));
      mgs = __fadd_rn(mgs, __shfl_down_sync(0xffffffffu, mgs, off, seg));
      nzs += __shfl_down_sync(0xffffffffu, nzs, off, seg);
    }
    if ((tid % seg) == 0) {
      red_e[tid / seg] = e2s;
      red_m[tid / seg] = mgs;
      red_n[tid / seg] = nzs;
    }
    __syncthreads();
    if (tid < nb) {
      const int per = tpb / seg;
      float sse = 0.f, mag = 0.f;
      int nnz = 0;
      for (int p = 0; p < per; ++p) {
        sse = __fadd_rn(sse, red_e[tid * per + p]);
        mag = __fadd_rn(mag, red_m[tid * per + p]);
        nnz += red_n[tid * per + p];
      }
      const int gy = sby * (64 / h) + tid / nbx;
      const int gx = sbx * nbx + tid % nbx;
      out_cost[cost_off + gy * (W / w) + gx] =
          cost_model::rd_cost(sse, nnz, mag, kInterModeBits, lam);
    }
    cost_off += (H / h) * (W / w);
  }
}

}  // namespace

// src: uint8 [H, W]; preds: uint8 [K, H, W] (K <= 3); mvq_r, mvq_c: int32
// [K, H/16, W/16] eighth-pel; sb_r, sb_c: int32 [K, H/64, W/64] full-pel
// 64x64 winners; tab: float32 [n_tab] log2(1 + d/8); pens: the ref,
// compound, unit deviation and MV-weight penalties; shapes: int32 [10, 2]
// (w, h); qpar: float32 [10, 6] (zbin, round, step) x (dc, ac) per shape;
// dct: float32 orthonormal DCT matrices of sizes 8, 16, 32, 64,
// concatenated.  The compound candidate (K9's outputs: prediction uint8
// [H, W]; SAD, fwd_i, bwd_i and the four MV fields int32 [H/16, W/16]) is
// optional: null pointers select among the K references only.  Out: sel,
// mv_r, mv_c, mv1_r, mv1_c, fwd_i, bwd_i int32 and mvb float32 [H/16,
// W/16]; cost float32, the shapes' [H/h, W/w] grids concatenated.
// Returns the CUDA error.
extern "C" int inter_select_launch(
    const void* src, const void* preds, int K, int H, int W,
    const void* mvq_r, const void* mvq_c, const void* sb_r, const void* sb_c,
    const void* tab, int n_tab, float pen_ref, float pen_comp, float pen_dev,
    float pen_mv, const void* shapes, const void* qpar, const void* dct,
    float lam, const void* cpred, const void* csad, const void* cfi,
    const void* cbi, const void* cmvr, const void* cmvc, const void* cmv1r,
    const void* cmv1c, void* out_sel, void* out_mvr, void* out_mvc,
    void* out_mv1r, void* out_mv1c, void* out_fwd, void* out_bwd,
    void* out_mvb, void* out_cost, void* stream) {
  const bool comp = cpred != nullptr;
  if (K < 1 || K > kMaxRefs || H % 64 || W % 64 ||
      (comp && !(csad && cfi && cbi && cmvr && cmvc && cmv1r && cmv1c)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      inter_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  inter_select_kernel<<<(H / 64) * (W / 64), kThreads, kSmemBytes,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const uint8_t*)preds, K, H, W,
      (const int*)mvq_r, (const int*)mvq_c, (const int*)sb_r,
      (const int*)sb_c, (const float*)tab, n_tab, pen_ref, pen_comp, pen_dev,
      pen_mv, (const int*)shapes, (const float*)qpar, (const float*)dct, lam,
      (const uint8_t*)cpred, (const int*)csad, (const int*)cfi,
      (const int*)cbi, (const int*)cmvr, (const int*)cmvc, (const int*)cmv1r,
      (const int*)cmv1c, (int*)out_sel, (int*)out_mvr, (int*)out_mvc,
      (int*)out_mv1r, (int*)out_mv1c, (int*)out_fwd, (int*)out_bwd,
      (float*)out_mvb, (float*)out_cost);
  return (int)cudaGetLastError();
}
