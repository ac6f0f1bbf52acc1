// The integer pipes of the card: how many lanes of one integer opcode an
// SM issues per clock when nothing waits on anything (tools/int_pipes.py).
//
// One block of 1024 threads per SM (its dynamic shared memory keeps a
// second block off the SM); each thread runs 8 chains, each step of a
// chain reads its neighbour's last value, so the 8 steps of a round are
// independent and 32 warps hide every latency.  The cycles are the SM's
// own clock64 between two block barriers, so a rate is per SM and clock
// whatever clock the card runs at.  The opcodes of each probe are checked
// in the SASS by tools/int_pipes.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kChains = 8;
constexpr int kRounds = 4;            // rounds per loop iteration

// each probe: one round, updating the 8 chains x with the loop-invariant
// y; op names in tools/int_pipes.py (OPS, same order)
template <int kOp>
__device__ __forceinline__ void probe_round(uint32_t (&x)[kChains],
                                            uint32_t y) {
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    uint32_t& a = x[k];
    const uint32_t b = x[(k + 1) % kChains];
    if constexpr (kOp == 0) {           // VIMNMX.U16x2
      a = __vminu2(a, b);
    } else if constexpr (kOp == 1) {    // IADD3
      asm volatile("{ .reg .u32 t; add.u32 t, %0, %1; add.u32 %0, t, %2; }"
                   : "+r"(a) : "r"(b), "r"(y));
    } else if constexpr (kOp == 2) {    // VABSDIFF4 with accumulate
      asm volatile("vabsdiff4.u32.u32.u32.add %0, %1, %2, %0;"
                   : "+r"(a) : "r"(b), "r"(y));
    } else if constexpr (kOp == 3) {    // PRMT
      asm volatile("prmt.b32 %0, %0, %1, %2;" : "+r"(a) : "r"(b), "r"(y));
    } else if constexpr (kOp == 4) {    // LOP3
      asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;"
                   : "+r"(a) : "r"(b), "r"(y));
    } else if constexpr (kOp == 5) {    // SHF, the amount in a register
      asm volatile("shf.r.wrap.b32 %0, %0, %1, %2;"
                   : "+r"(a) : "r"(b), "r"(y));
    } else if constexpr (kOp == 6) {    // IDP.2A
      asm volatile("dp2a.lo.u32.u32 %0, %1, %2, %0;"
                   : "+r"(a) : "r"(b), "r"(y));
    } else if constexpr (kOp == 7) {    // IMAD
      asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(a) : "r"(y), "r"(b));
    }
  }
  if constexpr (kOp == 8) {
    // two VIMNMX.U16x2 and one IADD3 (the sum of two words' minima)
    uint32_t m[kChains];
#pragma unroll
    for (int k = 0; k < kChains; ++k)
      m[k] = __vminu2(x[k], x[(k + 1) % kChains]);
#pragma unroll
    for (int j = 0; j < kChains; j += 2)
      asm volatile("{ .reg .u32 t; add.u32 t, %0, %1; add.u32 %0, t, %2; }"
                   : "+r"(x[j]) : "r"(m[j]), "r"(m[j + 1]));
  } else if constexpr (kOp == 9) {
    // one VIMNMX.U16x2 and one IDP.2A (a word's minima added to a sum)
    uint32_t m[kChains];
#pragma unroll
    for (int k = 0; k < kChains; ++k)
      m[k] = __vminu2(x[k], x[(k + 1) % kChains]);
#pragma unroll
    for (int k = 0; k < kChains; ++k)
      asm volatile("dp2a.lo.u32.u32 %0, %1, %2, %0;"
                   : "+r"(x[k]) : "r"(m[k]), "r"(y));
  } else if constexpr (kOp == 10) {
    // one VIMNMX.U16x2 and one VABSDIFF4 with accumulate, interleaved
#pragma unroll
    for (int k = 0; k < kChains; k += 2) {
      x[k] = __vminu2(x[k], x[k + 1]);
      asm volatile("vabsdiff4.u32.u32.u32.add %0, %1, %2, %0;"
                   : "+r"(x[k + 1]) : "r"(x[(k + 2) % kChains]), "r"(y));
    }
  }
}

template <int kOp>
__global__ void __launch_bounds__(kThreads, 1)
    int_pipe_probe(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   long long* __restrict__ cycles, int iters) {
  extern __shared__ uint32_t keep_off[];   // only its size matters
  uint32_t x[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k)
    x[k] = in[(threadIdx.x * kChains + k) & 4095];
  const uint32_t y = in[4096 + (threadIdx.x & 31)];
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) probe_round<kOp>(x, y);
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < kChains; ++k) s ^= x[k];
  out[blockIdx.x * kThreads + threadIdx.x] = s;
  if (threadIdx.x == 0) {
    cycles[blockIdx.x] = t1 - t0;
    keep_off[0] = s;
  }
}

template <int kOp>
int run(const void* in, void* out, void* cycles, int iters, int n_blocks,
        int smem, float* ms) {
  cudaError_t e = cudaFuncSetAttribute(
      int_pipe_probe<kOp>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  int_pipe_probe<kOp><<<n_blocks, kThreads, smem>>>(
      (const uint32_t*)in, (uint32_t*)out, (long long*)cycles, iters);
  cudaEventRecord(b);
  e = cudaEventSynchronize(b);
  if (e == cudaSuccess) e = cudaGetLastError();
  cudaEventElapsedTime(ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return (int)e;
}

}  // namespace

// Runs probe op (0-10) once on n_blocks blocks of 1024 threads, each with
// smem bytes of dynamic shared memory and iters loop iterations of 4
// rounds; in: uint32 [4128], out: uint32 [n_blocks * 1024], cycles: int64
// [n_blocks] (each block's clock64 span); *ms the launch's event time.
// Returns the CUDA error.
extern "C" int int_pipes_run(int op, const void* in, void* out, void* cycles,
                             int iters, int n_blocks, int smem, float* ms) {
  switch (op) {
    case 0: return run<0>(in, out, cycles, iters, n_blocks, smem, ms);
    case 1: return run<1>(in, out, cycles, iters, n_blocks, smem, ms);
    case 2: return run<2>(in, out, cycles, iters, n_blocks, smem, ms);
    case 3: return run<3>(in, out, cycles, iters, n_blocks, smem, ms);
    case 4: return run<4>(in, out, cycles, iters, n_blocks, smem, ms);
    case 5: return run<5>(in, out, cycles, iters, n_blocks, smem, ms);
    case 6: return run<6>(in, out, cycles, iters, n_blocks, smem, ms);
    case 7: return run<7>(in, out, cycles, iters, n_blocks, smem, ms);
    case 8: return run<8>(in, out, cycles, iters, n_blocks, smem, ms);
    case 9: return run<9>(in, out, cycles, iters, n_blocks, smem, ms);
    case 10: return run<10>(in, out, cycles, iters, n_blocks, smem, ms);
    default: return (int)cudaErrorInvalidValue;
  }
}
