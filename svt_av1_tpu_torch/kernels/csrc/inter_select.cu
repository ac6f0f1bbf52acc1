// K8 inter_select: per-unit reference selection, prediction assembly and
// the residual cost maps of an inter frame.
//
// Replaces the selection, prediction-assembly and residual part of the
// JAX package's inter_frame_maps (svt_av1_tpu/pipeline/batched_inter.py
// :255-383, B5) and its residual RD model _mc_cost_maps (:71, B6 inter),
// traced inside _jitted_inter (:398), with the averaged-compound
// candidate that K9 (compound_joint.cu) builds as an optional (K+1)-th row.
//
// What bounds it on the H100: arithmetic.  The 10 INTER_SHAPES grids
// each take two DCT products per block; the coded 32x32 band of the
// 64-point shapes needs 416 multiply-adds per pixel over the 10 shapes
// (576 for the whole products): about 1.8 GFLOP per 1080p frame at the
// float32 rate, against about 2 MB per reference of planes and MV fields.
//
// Design:
// * One CTA of 4 warps per 64x64 SB, 55 KB of shared memory, so that
//   three SBs share an SM (launch bounds of 3 CTAs: up to 168 registers;
//   4 CTAs of 128 registers spilled and ran about 12% slower, PERF.md).
//   Every INTER_SHAPES block lies inside one SB of the 64-aligned buffer.
// * (1) Selection, as before and bit-equal to the plain version: per unit
//   of 16x16 and reference the SAD of the reference's prediction (packed
//   bytes, PTX vabsdiff4 with its accumulator: one VABSDIFF4.U8.ACC per
//   4 pixel pairs) and the MV-bits proxy MV_BIT_SCALE * (log2(1 + d_r/8)
//   + log2(1 + d_c/8)), d in eighth-pel from the reference's 64x64
//   winner, log2 from a float32 table that the host builds with numpy;
//   base = sad + pens[3]*mvb (the compound row: its SAD + pens[3] *
//   (mvb[fi] + mvb[bi])).  The SB score sums the 16 units in numpy's
//   order (each row of 4 left to right, then the rows), adds pens[0] to
//   every reference but the first and pens[1] to the compound row, and
//   takes the first minimum; each unit then takes the first minimum of
//   base + pens[2] for leaving the SB's winner.
// * (2) The winner's residual stays in shared memory as float, rows of 72
//   (conflict-free A-fragment loads), with the sum |R| of each 8x8.
// * (3) Per shape, both DCT products on the tensor cores, mma.sync
//   m16n8k8 TF32, the m-tiles of the SB shared out over the warps, a CTA
//   barrier after each product:
//     T^T = R^T . Dh^T per block (rows (block, column)): the residuals are
//       integers below 256 in magnitude, exact in TF32, so two passes
//       (R . big + R . small) give the float32 product; T goes to shared
//       memory in the block's own place, rows of 68;
//     C = T . Dw^T (rows (block, row)): 3xTF32 (big . big + big . small
//       + small . big), float32 accumulation.  TF32 stays off globally.
//   The B fragments are split and laid out on the host (ops/omd.py
//   _dct_fragments of sizes 8, 16, 32 and 64), read through L1.  The 64-point shapes run the
//   whole products: the energy outside the coded 32x32 band counts as
//   distortion, and a Parseval form (residual energy minus the band's)
//   would carry the float32 error of the large band coefficients (about
//   12 on a flat 64x64 block of residual 200, against a cost tolerance
//   of about 3), so those coefficients are computed and squared.
// * (4) The quantizer model (cost_model.cuh) per m-tile: a dead-zone
//   coefficient adds its square in place; the coded ones and those near
//   the dead zone go to a per-warp queue (value and position), which the
//   lanes then share, so the division and log2 run once per coded
//   coefficient; there the quotients are tested against the rounding
//   points.  Near-boundary coefficients (ops/omd.py
//   decide_near_boundary, delta from the block's sum |R|) are recomputed
//   by the warp in float64 FMA from the residual and the float32 DCT
//   entries and decided from that value rounded to float32, as the plain
//   version does.  Per-block sums go through shared memory in a fixed
//   order (deterministic), then the cost.  Every float step rounds as the
//   plain version does (no fast-math, IEEE intrinsics); only the orders
//   of the DCT and block sums differ, hence the cost maps' tolerance.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cost_model.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRefs = 3;
constexpr int kMaxCand = kMaxRefs + 1;   // + the compound row
constexpr int kShapes = 10;
constexpr float kMvBitScale = 2.0f;
constexpr float kInterModeBits = 3.0f;
constexpr int kRS = 72;                  // residual row stride (floats)
constexpr int kTS = 68;                  // transform row stride (floats)
constexpr int kQueue = 512;              // queue entries per warp
constexpr int kMaxMt = 32;               // m-tiles per product and SB
constexpr size_t kSmemBytes =
    sizeof(float) * (64 * kRS + 64 * kTS + cost_model::kLog2Table) +
    (sizeof(float) + sizeof(int)) * kWarps * kQueue;

// queue entry info: the coefficient's row n and column j in its block and
// the m-tile half (the second block where a side is 8)
constexpr int kInfoHi = 1 << 14;

__device__ __forceinline__ int frag_off(int n) {   // in float4
  return n == 8 ? 0 : (n == 16 ? 32 : (n == 32 ? 160 : 672));
}

__device__ __forceinline__ float log2_1p8(const float* tab, int n_tab, int d) {
  return d < n_tab ? tab[d]
                   : log2f(__fadd_rn(1.f, __fdiv_rn((float)d, 8.f)));
}

__device__ __forceinline__ uint32_t vabsdiff4_add(uint32_t a, uint32_t b,
                                                  uint32_t c) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d)
      : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t tf32_big(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a . b on the tensor cores: A 16x8 (row), B 8x8 (col), TF32 in,
// float32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Shared memory of one CTA besides the dynamic buffers.
struct Sums {
  float e2[kMaxMt][2], mg[kMaxMt][2];
  int nz[kMaxMt][2];
  int s8[64];                 // sum |R| per 8x8 of the SB
  float dl[64];               // per block of the shape: the margin delta
};

struct Quant {
  float zb_dc, zb_ac, rn_dc, rn_ac, st_dc, st_ac;
};

// The cost grid of one (W, H) shape over the SB.
template <int W, int H>
__device__ __forceinline__ void run_shape(
    const float* R, float* T, float* qv, int* qi, Sums& sm,
    const float* log2_1p, const float4* __restrict__ frag, const Quant& qp,
    float lam, int sby, int sbx, int frame_w, int cost_off,
    float* __restrict__ out_cost) {
  constexpr int NBX = 64 / W, NB = NBX * (64 / H);
  constexpr int MT1 = 256 / H, KS1 = H / 8, NT1 = H / 8;
  constexpr int MT2 = 256 / W, KS2 = W / 8, NT2 = W / 8;
  const float4* fh = frag + frag_off(H);
  const float4* fw = frag + frag_off(W);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const unsigned below = (1u << lane) - 1u;

  if (tid < NB) {            // the blocks' margins, read after a barrier
    const int by = tid / NBX, bx = tid % NBX;
    int s = 0;
    for (int y = 0; y < H / 8; ++y)
      for (int x = 0; x < W / 8; ++x)
        s += sm.s8[(by * (H / 8) + y) * 8 + bx * (W / 8) + x];
    sm.dl[tid] = __fmul_rn((float)s, cost_model::near_margin(W, H));
  }

  // product 1: T^T[(b, c)][n] = sum_r R_b[r][c] * Dh[n][r]
  for (int mt = warp; mt < MT1; mt += kWarps) {
    const int b_lo = W == 8 ? 2 * mt : (mt * 16) / W;
    const int b_hi = W == 8 ? 2 * mt + 1 : b_lo;
    const int c_lo = W == 8 ? g : (mt * 16) % W + g;
    const int c_hi = W == 8 ? g : c_lo + 8;
    const int o_lo = (b_lo / NBX) * H * kRS + (b_lo % NBX) * W + c_lo;
    const int o_hi = (b_hi / NBX) * H * kRS + (b_hi % NBX) * W + c_hi;
    float acc[NT1][4];
#pragma unroll
    for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS1; ++ks) {
      const int k_lo = ks * 8 + t, k_hi = k_lo + 4;
      const uint32_t a[4] = {__float_as_uint(R[o_lo + k_lo * kRS]),
                             __float_as_uint(R[o_hi + k_lo * kRS]),
                             __float_as_uint(R[o_lo + k_hi * kRS]),
                             __float_as_uint(R[o_hi + k_hi * kRS])};
#pragma unroll
      for (int nt = 0; nt < NT1; ++nt) {
        const float4 bf = __ldg(fh + (ks * NT1 + nt) * 32 + lane);
        mma_tf32(acc[nt], a, __float_as_uint(bf.z), __float_as_uint(bf.w));
        mma_tf32(acc[nt], a, __float_as_uint(bf.x), __float_as_uint(bf.y));
      }
    }
    // T_b[n][c] in the block's own place
    const int p_lo = (b_lo / NBX) * H * kTS + (b_lo % NBX) * W + c_lo;
    const int p_hi = (b_hi / NBX) * H * kTS + (b_hi % NBX) * W + c_hi;
#pragma unroll
    for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = nt * 8 + 2 * t + (i & 1);
        T[((i >> 1) ? p_hi : p_lo) + n * kTS] = acc[nt][i];
      }
  }
  __syncthreads();

  // product 2 and the quantizer model: C_b[n][j] = sum_c T_b[n][c] *
  // Dw[j][c], one m-tile of 16 rows (b, n) at a time
  for (int mt = warp; mt < MT2; mt += kWarps) {
    const int b_lo = H == 8 ? 2 * mt : (mt * 16) / H;
    const int b_hi = H == 8 ? 2 * mt + 1 : b_lo;
    const int n_lo = H == 8 ? g : (mt * 16) % H + g;
    const int n_hi = H == 8 ? g : n_lo + 8;
    const int o_lo = (b_lo / NBX) * H * kTS + (b_lo % NBX) * W + n_lo * kTS;
    const int o_hi = (b_hi / NBX) * H * kTS + (b_hi % NBX) * W + n_hi * kTS;
    // rows of a 64-row block past 32 lie outside the coded band
    const bool rows_in_band = H < 64 || (mt * 16) % H < 32;
    float acc[NT2][4];
#pragma unroll
    for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS2; ++ks) {
      const int k_lo = ks * 8 + t, k_hi = k_lo + 4;
      const float x[4] = {T[o_lo + k_lo], T[o_hi + k_lo], T[o_lo + k_hi],
                          T[o_hi + k_hi]};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ab[i] = tf32_big(x[i]);
        as[i] = __float_as_uint(x[i] - __uint_as_float(ab[i]));
      }
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt) {
        const float4 bf = __ldg(fw + (ks * NT2 + nt) * 32 + lane);
        const uint32_t bb0 = __float_as_uint(bf.x), bb1 = __float_as_uint(bf.y);
        mma_tf32(acc[nt], as, bb0, bb1);
        mma_tf32(acc[nt], ab, __float_as_uint(bf.z), __float_as_uint(bf.w));
        mma_tf32(acc[nt], ab, bb0, bb1);
      }
    }
    const float dl[2] = {sm.dl[b_lo], sm.dl[b_hi]};
    float e2[2] = {0.f, 0.f}, mg[2] = {0.f, 0.f};
    int nz[2] = {0, 0}, nq = 0;
    // a coefficient's terms into the half it belongs to (hi: the m-tile's
    // second block, only where a side is 8), without a run-time index
    auto take = [&](bool hi, float ce2, float cmg) {
      if (H == 8 && hi) {
        e2[1] = __fadd_rn(e2[1], ce2);
        mg[1] = __fadd_rn(mg[1], cmg);
      } else {
        e2[0] = __fadd_rn(e2[0], ce2);
        mg[0] = __fadd_rn(mg[0], cmg);
      }
    };
#pragma unroll
    for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hi = H == 8 ? (i >> 1) : 0;
        const int n = (i >> 1) ? n_hi : n_lo;
        const int j = nt * 8 + 2 * t + (i & 1);
        const float ac = fabsf(acc[nt][i]);
        // j < 32 is known at compile time; the row test per m-tile
        if (!(nt * 8 < 32 && rows_in_band)) {
          e2[hi] = __fadd_rn(e2[hi], __fmul_rn(ac, ac));
          continue;
        }
        const float zb = n == 0 && j == 0 ? qp.zb_dc : qp.zb_ac;
        const bool queued =
            ac >= zb ||
            cost_model::near_zbin(ac, zb, dl[(i >> 1) & (H == 8)]);
        const unsigned ball = __ballot_sync(0xffffffffu, queued);
        if (queued) {
          const int at = nq + __popc(ball & below);
          qv[at] = ac;
          qi[at] = ((i >> 1) ? kInfoHi : 0) | (n << 6) | j;
        } else {
          e2[hi] = __fadd_rn(e2[hi], __fmul_rn(ac, ac));
        }
        nq += __popc(ball);
      }
    __syncwarp();
    // the queued coefficients shared out over the lanes, each tested
    // against the decision points; the near ones compacted (in place: a
    // slot is written only after it was read) into the queue's front for
    // the warp's float64 pass
    int nn = 0;
    for (int k0 = 0; k0 < nq; k0 += 32) {             // warp-uniform
      const int k = k0 + lane;
      const int info = k < nq ? qi[k] : 0;
      const bool hi = H == 8 && (info & kInfoHi);
      bool near = false;
      int cnz = 0;
      if (k < nq) {
        const float ac = qv[k];
        const bool is_dc = (info & 0xfff) == 0;
        const float st = is_dc ? qp.st_dc : qp.st_ac;
        const float dlk = hi ? dl[1] : dl[0];
        near = cost_model::near_zbin(ac, is_dc ? qp.zb_dc : qp.zb_ac, dlk);
        if (!near) {
          const float t =
              cost_model::quotient(ac, is_dc ? qp.rn_dc : qp.rn_ac, st);
          near = cost_model::near_round(t, st, dlk);
          if (!near) {
            float ce2, cmg;
            cost_model::coef_from_t(ac, t, st, log2_1p, ce2, cnz, cmg);
            take(hi, ce2, cmg);
          }
        }
      }
      nz[0] += __popc(__ballot_sync(0xffffffffu, cnz && !hi));
      nz[1] += __popc(__ballot_sync(0xffffffffu, cnz && hi));
      const unsigned nb = __ballot_sync(0xffffffffu, near);
      if (near) qi[nn + __popc(nb & below)] = info;
      nn += __popc(nb);
    }
    if (nn > 0) {                                     // warp-uniform, rare
      __syncwarp();
      // each lane takes columns c0 + 32k (k < CPL) of rows r0 + i * RPI,
      // so the D_w[j][c] are its CPL factors
      constexpr int CPL = W > 32 ? W / 32 : 1;
      constexpr int RPI = W < 32 ? 32 / W : 1;
      const int c0 = W < 32 ? lane % W : lane, r0 = W < 32 ? lane / W : 0;
      for (int e = 0; e < nn; ++e) {
        const int info = qi[e];
        const bool hi = H == 8 && (info & kInfoHi);
        const int n = (info >> 6) & 63, j = info & 63;
        const int b = hi ? b_hi : b_lo;
        const float* Rb = R + (b / NBX) * H * kRS + (b % NBX) * W + c0;
        double a64[CPL];
#pragma unroll
        for (int k = 0; k < CPL; ++k) a64[k] = 0.0;
#pragma unroll 8
        for (int i = 0; i < H / RPI; ++i) {
          const int r = i * RPI + r0;
          const double d = cost_model::dct_at(fh, H, n, r);
#pragma unroll
          for (int k = 0; k < CPL; ++k)
            a64[k] = fma(d, (double)Rb[r * kRS + 32 * k], a64[k]);
        }
        double part = 0.0;
#pragma unroll
        for (int k = 0; k < CPL; ++k)
          part = fma(a64[k], cost_model::dct_at(fw, W, j, c0 + 32 * k), part);
        const double c64 = cost_model::warp_sum_f64(part);
        const bool is_dc = n == 0 && j == 0;
        float ce2, cmg;
        int cnz;
        cost_model::coef_decided(
            __double2float_rn(fabs(c64)), is_dc ? qp.zb_dc : qp.zb_ac,
            is_dc ? qp.rn_dc : qp.rn_ac, is_dc ? qp.st_dc : qp.st_ac, log2_1p,
            ce2, cnz, cmg);
        if (lane == 0) take(hi, ce2, cmg);
        if (hi) nz[1] += cnz; else nz[0] += cnz;
      }
      if (lane == 0) cost_model::count_near(nn);
    }
    __syncwarp();              // the queue is read: the next m-tile's
#pragma unroll
    for (int h2 = 0; h2 < (H == 8 ? 2 : 1); ++h2) {
      e2[h2] = warp_sum(e2[h2]);
      if (nq > 0) mg[h2] = warp_sum(mg[h2]);
    }
    if (lane == 0) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        sm.e2[mt][h2] = e2[h2];
        sm.mg[mt][h2] = mg[h2];
        sm.nz[mt][h2] = nz[h2];
      }
    }
  }
  __syncthreads();
  // per block: its m-tiles' sums in order, then the cost
  if (tid < NB) {
    float sse, mag;
    int nnz;
    if (H == 8) {
      sse = sm.e2[tid >> 1][tid & 1];
      mag = sm.mg[tid >> 1][tid & 1];
      nnz = sm.nz[tid >> 1][tid & 1];
    } else {
      constexpr int per = H / 16;
      sse = sm.e2[tid * per][0];
      mag = sm.mg[tid * per][0];
      nnz = sm.nz[tid * per][0];
      for (int p = 1; p < per; ++p) {
        sse = __fadd_rn(sse, sm.e2[tid * per + p][0]);
        mag = __fadd_rn(mag, sm.mg[tid * per + p][0]);
        nnz += sm.nz[tid * per + p][0];
      }
    }
    const int gy = sby * (64 / H) + tid / NBX;
    const int gx = sbx * NBX + tid % NBX;
    out_cost[cost_off + gy * (frame_w / W) + gx] =
        cost_model::rd_cost(sse, nnz, mag, kInterModeBits, lam);
  }
}

__global__ void __launch_bounds__(kThreads, 3) inter_select_kernel(
    const uint8_t* __restrict__ src, const uint8_t* __restrict__ preds,
    int K, int H, int W, const int* __restrict__ mvq_r,
    const int* __restrict__ mvq_c, const int* __restrict__ sb_r,
    const int* __restrict__ sb_c, const float* __restrict__ tab, int n_tab,
    float pen_ref, float pen_comp, float pen_dev, float pen_mv,
    const int* __restrict__ shapes, const float* __restrict__ qpar,
    const float4* __restrict__ frag, float lam,
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
  float* R = fsm;
  float* T = R + 64 * kRS;
  float* log2_1p = T + 64 * kTS;
  float* qv_all = log2_1p + cost_model::kLog2Table;
  int* qi_all = reinterpret_cast<int*>(qv_all + kWarps * kQueue);
  __shared__ Sums sm;
  __shared__ int sad[kMaxRefs][16];
  __shared__ float base[kMaxCand][16];
  __shared__ float mvb[kMaxCand][16];
  __shared__ int usel[16];
  __shared__ int sb_sel;

  const int n_sbx = W / 64;
  const int sby = blockIdx.x / n_sbx, sbx = blockIdx.x % n_sbx;
  const int nr16 = H / 16, nc16 = W / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t plane = (size_t)H * W;
  const bool has_comp = cpred != nullptr;
  const int NC = K + (has_comp ? 1 : 0);

  for (int k = tid; k < cost_model::kLog2Table; k += kThreads)
    log2_1p[k] = log2f(__fadd_rn(1.f, (float)k));

  // (1) unit SADs: thread t covers rows 2*(t&7), +1 of unit t >> 3, four
  // words of 4 pixels each row
  const int u = tid >> 3, sub = tid & 7, uy = u >> 2, ux = u & 3;
  uint32_t wrd[8], sv[8];            // word index (< 2^32) and source
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = sby * 64 + uy * 16 + 2 * sub + (i >> 2);
    wrd[i] = ((uint32_t)row * W + sbx * 64 + ux * 16 + 4 * (i & 3)) / 4;
    sv[i] = __ldg(reinterpret_cast<const uint32_t*>(src) + wrd[i]);
  }
  for (int k = 0; k < K; ++k) {
    const uint32_t* pw =
        reinterpret_cast<const uint32_t*>(preds + k * plane);
    uint32_t d = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) d = vabsdiff4_add(sv[i], __ldg(pw + wrd[i]), d);
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    if (sub == 0) sad[k][u] = (int)d;
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
    mvb[k][v] = m;
    base[k][v] = __fadd_rn((float)sad[k][v], __fmul_rn(pen_mv, m));
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
  // (3) the winning prediction's residual, and sum |R| per 8x8
  {
    const int k = usel[u];
    const uint32_t* pw = k == K
                             ? reinterpret_cast<const uint32_t*>(cpred)
                             : reinterpret_cast<const uint32_t*>(
                                   preds + k * plane);
    int sa[2] = {0, 0};                  // left and right 8 columns
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t p = __ldg(pw + wrd[i]);
      float* row = R + (uy * 16 + 2 * sub + (i >> 2)) * kRS + ux * 16 +
                   4 * (i & 3);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int rv = (int)((sv[i] >> (8 * b)) & 255u) -
                       (int)((p >> (8 * b)) & 255u);
        row[b] = (float)rv;
        sa[(i & 3) >> 1] += abs(rv);
      }
    }
    // rows 0-7 of the unit are threads sub 0-3, rows 8-15 sub 4-7
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sa[0] += __shfl_xor_sync(0xffffffffu, sa[0], off);
      sa[1] += __shfl_xor_sync(0xffffffffu, sa[1], off);
    }
    if ((sub & 3) == 0) {
      const int sy = uy * 2 + (sub >> 2);
      sm.s8[sy * 8 + ux * 2] = sa[0];
      sm.s8[sy * 8 + ux * 2 + 1] = sa[1];
    }
  }
  __syncthreads();

  // (4) cost grids of the 10 shapes
  float* qv = qv_all + warp * kQueue;
  int* qi = qi_all + warp * kQueue;
  int cost_off = 0;
  for (int s = 0; s < kShapes; ++s) {
    const int w = shapes[2 * s], h = shapes[2 * s + 1];
    Quant qp;
    qp.zb_dc = qpar[6 * s];
    qp.zb_ac = qpar[6 * s + 1];
    qp.rn_dc = qpar[6 * s + 2];
    qp.rn_ac = qpar[6 * s + 3];
    qp.st_dc = qpar[6 * s + 4];
    qp.st_ac = qpar[6 * s + 5];
#define K8_SHAPE(W_, H_)                                                   \
  case W_ * 100 + H_:                                                      \
    run_shape<W_, H_>(R, T, qv, qi, sm, log2_1p, frag, qp, lam, sby, sbx,  \
                      W, cost_off, out_cost);                              \
    break;
    switch (w * 100 + h) {
      K8_SHAPE(8, 8)
      K8_SHAPE(16, 16)
      K8_SHAPE(32, 32)
      K8_SHAPE(16, 8)
      K8_SHAPE(8, 16)
      K8_SHAPE(32, 16)
      K8_SHAPE(16, 32)
      K8_SHAPE(64, 64)
      K8_SHAPE(64, 32)
      K8_SHAPE(32, 64)
      default:
        break;
    }
#undef K8_SHAPE
    cost_off += (H / h) * (W / w);
  }
}

}  // namespace

// The near-boundary recomputes since the last reset into *out (reset:
// set the count to 0 after reading).  Returns the CUDA error.
extern "C" int inter_select_near_count(int reset, unsigned long long* out) {
  return cost_model::read_near_count(reset, out);
}

// src: uint8 [H, W]; preds: uint8 [K, H, W] (K <= 3); mvq_r, mvq_c: int32
// [K, H/16, W/16] eighth-pel; sb_r, sb_c: int32 [K, H/64, W/64] full-pel
// 64x64 winners; tab: float32 [n_tab] log2(1 + d/8); pens: the ref,
// compound, unit deviation and MV-weight penalties; shapes: int32 [10, 2]
// (w, h), each of INTER_SHAPES once; qpar: float32 [10, 6] (zbin, round,
// step) x (dc, ac) per shape; dct: the split DCT fragments of sizes 8,
// 16, 32 and 64 (ops/omd.py _dct_fragments, float32 [10880]).  The
// compound candidate (K9's outputs: prediction uint8 [H, W]; SAD, fwd_i,
// bwd_i and the four MV fields int32 [H/16, W/16]) is optional: null
// pointers select among the K references only.  Out: sel, mv_r, mv_c,
// mv1_r, mv1_c, fwd_i, bwd_i int32 and mvb float32 [H/16, W/16]; cost
// float32, the shapes' [H/h, W/w] grids concatenated.  Returns the CUDA
// error.
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
  if (K < 1 || K > kMaxRefs || H % 64 || W % 64 || H < 64 || W < 64 ||
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
      pen_mv, (const int*)shapes, (const float*)qpar, (const float4*)dct,
      lam, (const uint8_t*)cpred, (const int*)csad, (const int*)cfi,
      (const int*)cbi, (const int*)cmvr, (const int*)cmvc, (const int*)cmv1r,
      (const int*)cmv1c, (int*)out_sel, (int*)out_mvr, (int*)out_mvc,
      (int*)out_mv1r, (int*)out_mv1c, (int*)out_fwd, (int*)out_bwd,
      (float*)out_mvb, (float*)out_cost);
  return (int)cudaGetLastError();
}
