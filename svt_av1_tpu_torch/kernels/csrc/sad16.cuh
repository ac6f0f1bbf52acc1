// The 16-bit forms' absolute differences of two 16-bit samples per word
// (K5 me_coarse.cu, K8 inter_select.cu), and the sums of the identity
// |a - b| = a + b - 2 min(a, b) (K6 me_refine.cu, K9 compound_joint.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// acc + |a - b| in each 16-bit half, the two sums kept packed: two
// VIMNMX.U16x2 and one IADD3 on sm_90a (__vabsdiffu2 takes nine
// instructions, two __sad on the halves six; tools/kernel_sass.py).  The
// maximum is at least the minimum in each half, so the 32-bit subtraction
// borrows nothing across the halves; the caller keeps each packed sum
// below 2^16 and adds the halves once (halves16).
__device__ __forceinline__ uint32_t sad16x2(uint32_t a, uint32_t b,
                                            uint32_t acc) {
  return acc + (__vmaxu2(a, b) - __vminu2(a, b));
}

// the two packed 16-bit sums of acc, added
__device__ __forceinline__ uint32_t halves16(uint32_t acc) {
  return (acc & 0xffffu) + (acc >> 16);
}

// c + f * (the sum of the two 16-bit halves of a), for a factor f of -2 or
// 1 known at compile time: one IDP.2A, which issues on another pipe than
// VIMNMX.U16x2, IADD3, LOP3 and SHF (tools/int_pipes.py: a VIMNMX.U16x2
// and an IDP.2A issue about 49 lanes each per SM and clock together,
// three of the first pipe 64 in all).  The halves are read as signed:
// samples of at most 15 bits.
constexpr int kTimes1 = 0x0101, kTimesMinus2 = 0xfefe;

__device__ __forceinline__ int dp2_halves(uint32_t a, int f, int c) {
  return __dp2a_lo((int)a, f, c);
}
