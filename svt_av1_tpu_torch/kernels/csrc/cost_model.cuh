// The open-loop residual cost model shared by K1 (intra_decision.cu) and
// K8 (inter_select.cu): the float model of quantize_b per coefficient of
// an orthonormal DCT and the rate proxy of a block
// (svt_av1_tpu/ops/omd.py shape_costs :286 and _quant_maps :268;
// svt_av1_tpu/pipeline/batched_inter.py _mc_cost_maps :71).
//
// The division and rounding steps use explicit IEEE round-to-nearest
// intrinsics so that no multiply-add is contracted where the float32
// reference rounds twice; build without fast-math.
#pragma once

#include <cuda_runtime.h>

namespace cost_model {

// coefficient-rate proxy: bits ~ A*nnz + B*sum(log2(1+|q|)) + C*(nnz > 0)
constexpr float kRateNnz = 2.724f;
constexpr float kRateMag = 1.061f;
constexpr float kRateTxb = 36.242f;

// One coefficient: the squared quantization error (Parseval: pixel-domain
// SSE), whether it codes (nz) and its log2 magnitude term.  ``coded``
// false models a coefficient outside the coded band of a 64-point
// transform: it quantizes to 0 and its energy counts as distortion.
// entries of an optional table of log2f(1 + q) for q = 0 .. kLog2Table-1
constexpr int kLog2Table = 256;

// A coefficient of magnitude ac outside the dead zone.  ``log2_1p``, when
// given, holds log2f(1 + q) for small q, computed by the same log2f.
__device__ __forceinline__ void coef_coded(float ac, float rnd, float step,
                                           const float* log2_1p, float& e2,
                                           int& nz, float& mg) {
  const float q = fmaxf(floorf(__fdiv_rn(__fadd_rn(ac, rnd), step)), 0.f);
  const float err = __fsub_rn(ac, __fmul_rn(q, step));
  e2 = __fmul_rn(err, err);
  nz = q > 0.f ? 1 : 0;
  mg = (log2_1p != nullptr && q < (float)kLog2Table)
           ? log2_1p[(int)q]
           : log2f(__fadd_rn(1.f, q));
}

// A coefficient inside the dead zone (most of them) quantizes to 0: its
// error is ac itself and its log2 term log2(1 + 0) = 0, so the division
// and the logarithm run only for the others, with the same results.
__device__ __forceinline__ void coef(float cf, float zbin, float rnd,
                                     float step, bool coded, float& e2,
                                     int& nz, float& mg) {
  const float ac = fabsf(cf);
  if (!(coded && ac >= zbin)) {
    e2 = __fmul_rn(ac, ac);
    nz = 0;
    mg = 0.f;
    return;
  }
  coef_coded(ac, rnd, step, nullptr, e2, nz, mg);
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
