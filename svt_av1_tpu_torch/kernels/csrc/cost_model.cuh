// The open-loop residual cost model shared by K1 (intra_decision.cu) and
// K8 (inter_select.cu): the float model of quantize_b per coefficient of
// an orthonormal DCT and the rate proxy of a block
// (svt_av1_tpu/ops/omd.py shape_costs :286 and _quant_maps :268;
// svt_av1_tpu/pipeline/batched_inter.py _mc_cost_maps :71).
//
// The division and rounding steps use explicit IEEE round-to-nearest
// intrinsics so that no multiply-add is contracted where the float32
// reference rounds twice; build without fast-math.
//
// Near-boundary coefficients (ops/omd.py decide_near_boundary): the
// kernels sum their DCT products in another order than the plain
// versions, so both decide a coefficient that lies within delta of the
// dead zone or of a rounding point from its float64 value (recomputed
// from the integer residual and the float32 DCT matrices), rounded to
// float32.  delta = near_margin(w, h) * sum |R| of the block.
#pragma once

#include <cuda_runtime.h>

namespace cost_model {

// coefficient-rate proxy: bits ~ A*nnz + B*sum(log2(1+|q|)) + C*(nnz > 0)
constexpr float kRateNnz = 2.724f;
constexpr float kRateMag = 1.061f;
constexpr float kRateTxb = 36.242f;

// One coefficient: the squared quantization error (Parseval: pixel-domain
// SSE), whether it codes (nz) and its log2 magnitude term.  A coefficient
// inside the dead zone (most of them) quantizes to 0: its error is ac
// itself and its log2 term log2(1 + 0) = 0, so the kernels run the
// division and the logarithm only for the others, with the same results.
// Entries of an optional table of log2f(1 + q) for q = 0 .. kLog2Table-1:
constexpr int kLog2Table = 256;

// t = (ac + rnd) / step, the quantizer's quotient before the floor.
__device__ __forceinline__ float quotient(float ac, float rnd, float step) {
  return __fdiv_rn(__fadd_rn(ac, rnd), step);
}

// A coefficient of magnitude ac outside the dead zone, with its quotient
// t.  ``log2_1p``, when given, holds log2f(1 + q) for small q, computed
// by the same log2f.
__device__ __forceinline__ void coef_from_t(float ac, float t, float step,
                                            const float* log2_1p, float& e2,
                                            int& nz, float& mg) {
  const float q = fmaxf(floorf(t), 0.f);
  const float err = __fsub_rn(ac, __fmul_rn(q, step));
  e2 = __fmul_rn(err, err);
  nz = q > 0.f ? 1 : 0;
  mg = (log2_1p != nullptr && q < (float)kLog2Table)
           ? log2_1p[(int)q]
           : log2f(__fadd_rn(1.f, q));
}

__device__ __forceinline__ void coef_coded(float ac, float rnd, float step,
                                           const float* log2_1p, float& e2,
                                           int& nz, float& mg) {
  coef_from_t(ac, quotient(ac, rnd, step), step, log2_1p, e2, nz, mg);
}

// A coefficient decided from its magnitude (recomputed near a decision
// point): the dead zone as in coef, else coef_coded with the log2 table.
__device__ __forceinline__ void coef_decided(float ac, float zbin, float rnd,
                                             float step, const float* log2_1p,
                                             float& e2, int& nz, float& mg) {
  if (!(ac >= zbin)) {
    e2 = __fmul_rn(ac, ac);
    nz = 0;
    mg = 0.f;
    return;
  }
  coef_coded(ac, rnd, step, log2_1p, e2, nz, mg);
}

// delta per unit of sum |R| (the margin's derivation is in ops/omd.py):
// 4 * sqrt(w + h + 24) * 2^-24 * 2 / sqrt(w h), the same double
// expression in the same order as the host's near_margin, rounded to
// float32.
__device__ __forceinline__ float near_margin(int w, int h) {
  const double v =
      __ddiv_rn(4.0 * __dsqrt_rn((double)(w + h + 24)) * 0x1p-24 * 2.0,
                __dsqrt_rn((double)(w * h)));
  return __double2float_rn(v);
}

// Whether |cf| = ac lies within dl of the dead zone zbin (the kernels
// queue these beside the coded coefficients), and whether a coded one's
// quotient t lies within dl / step of an integer, a point where floor(t)
// changes (tested where the queue is drained).
__device__ __forceinline__ bool near_zbin(float ac, float zbin, float dl) {
  return fabsf(__fsub_rn(ac, zbin)) < dl;
}
__device__ __forceinline__ bool near_round(float t, float step, float dl) {
  return __fmul_rn(fabsf(__fsub_rn(t, rintf(t))), step) < dl;
}

// D_s[n][k] in float64 from the split fragments (ops/omd.py
// _dct_fragments: per 8x8 tile (k / 8, n / 8) and lane (n % 8) * 4 + k %
// 4 the float4 (big b0, big b1, small b0, small b1), b1 for k % 8 >= 4);
// big + small is the float32 entry exactly.
__device__ __forceinline__ double dct_at(const float4* f, int s, int n,
                                         int k) {
  const float4 v =
      __ldg(f + ((k >> 3) * (s >> 3) + (n >> 3)) * 32 + (n & 7) * 4 + (k & 3));
  return (double)((k & 4) ? __fadd_rn(v.y, v.w) : __fadd_rn(v.x, v.z));
}

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The near-boundary recomputes of this kernel library since the last
// reset (one count per library: this header is compiled into each).
static __device__ unsigned long long g_near_count = 0;

__device__ __forceinline__ void count_near(int n) {
  atomicAdd(&g_near_count, (unsigned long long)n);
}

inline int read_near_count(int reset, unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_near_count, sizeof(*out));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    e = cudaMemcpyToSymbol(g_near_count, &zero, sizeof(zero));
  }
  return (int)e;
}

// cost = sse + lam * (A*nnz + B*mag + C*(nnz > 0) + extra_bits)
__device__ __forceinline__ float rd_cost(float sse, int nnz, float mag,
                                         float extra_bits, float lam) {
  const float nnzf = (float)nnz;
  float bits = __fadd_rn(__fmul_rn(kRateNnz, nnzf), __fmul_rn(kRateMag, mag));
  bits = __fadd_rn(bits, __fmul_rn(kRateTxb, nnz > 0 ? 1.f : 0.f));
  bits = __fadd_rn(bits, extra_bits);
  return __fadd_rn(sse, __fmul_rn(lam, bits));
}

}  // namespace cost_model
