// K1 intra_decision: open-loop intra mode decision over one block grid.
//
// Replaces the JAX package's jitted decision program
// (svt_av1_tpu/ops/omd.py _jitted -> intra_decision_arrays): the 13
// batched intra predictors (grid_edges, predict_mode, _dir_matrices; B7)
// and the residual cost model (shape_costs, _quant_maps; B6 intra).
//
// What bounds it on the H100: FP32 arithmetic.  Every mode of every block
// takes two small DCT products (h*w*(h+w) multiply-adds each way), about
// 15 GFLOP per 1080p luma frame over the 7 shapes against a few MB of
// input; the bytes are negligible.
//
// Design: one thread block per prediction block, one thread per pixel.
// The block builds its above/left edge vectors once in shared memory
// (edge replication = clamped reads, as pad_plane's mode="edge"; in
// stripe mode the row above the stripe and the halo rows below it are
// read where the whole frame's plane would be, see sample()), loads
// the two DCT matrices, then loops over the 13 modes: predict the pixel
// directly (DC/V/H/Paeth/smooth in integers; the six directional modes
// through a per-(mode, shape) table of at most two taps per pixel whose
// weights sum to 32, exactly the float32 matmul the TPU ran), write the
// residual to shared memory, apply the two DCT products there in float32
// (no TF32), model quantize_b per coefficient and reduce SSE, nonzero
// count and log2 magnitude over the block (cost_model.cuh, shared with
// K8).  Thread 0 keeps the running argmin: only a strictly smaller cost
// takes over (the reference's tie rule).  Later work: several blocks per
// thread block for the 8-pixel shapes, tensor-core DCTs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cost_model.cuh"

namespace {

constexpr int kMaxEdge = 65;            // w + h + 1 at 32x32

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Sample (r, c) of the plane as the prediction edges read it: the column
// clamped to [0, buf_w); row -1 from the row above the stripe when one
// is given (above), rows [buf_h, buf_h + n_halo) from the halo rows below
// it; every other row outside the plane repeats its nearest edge row.
__device__ __forceinline__ int sample(const uint8_t* __restrict__ plane,
                                      const uint8_t* __restrict__ above,
                                      const uint8_t* __restrict__ halo,
                                      int buf_h, int buf_w, int n_halo,
                                      int r, int c) {
  c = clampi(c, 0, buf_w - 1);
  if (r < 0) return (r == -1 && above) ? above[c] : plane[c];
  if (r < buf_h) return plane[r * buf_w + c];
  if (r < buf_h + n_halo) return halo[(r - buf_h) * buf_w + c];
  return plane[(buf_h - 1) * buf_w + c];
}

__global__ void intra_decision_kernel(
    const uint8_t* __restrict__ plane, const uint8_t* __restrict__ above_row,
    const uint8_t* __restrict__ halo, int buf_h, int buf_w, int n_halo,
    int w, int h,
    const int* __restrict__ dir_taps, const int* __restrict__ sm_weights,
    const float* __restrict__ dct_h, const float* __restrict__ dct_wt,
    float zbin_dc, float zbin_ac, float rnd_dc, float rnd_ac,
    float step_dc, float step_ac, float lam,
    const float* __restrict__ mode_bits, int* __restrict__ out_mode,
    float* __restrict__ out_cost) {
  __shared__ int above[kMaxEdge];
  __shared__ int left[kMaxEdge];
  __shared__ float resid[1024];
  __shared__ float tmp[1024];
  __shared__ float dh[1024];
  __shared__ float dwt[1024];
  __shared__ float red_sse[32];
  __shared__ float red_mag[32];
  __shared__ int red_nnz[32];
  __shared__ int dc_val;

  const int n = w * h;
  const int tid = threadIdx.x;
  const int r = tid / w;
  const int c = tid - r * w;
  const int y0 = blockIdx.y * h;
  const int x0 = blockIdx.x * w;
  const int L = w + h + 1;

  for (int k = tid; k < L; k += n) {
    above[k] = sample(plane, above_row, halo, buf_h, buf_w, n_halo, y0 - 1,
                      x0 - 1 + k);
    left[k] = sample(plane, above_row, halo, buf_h, buf_w, n_halo,
                     y0 - 1 + k, x0 - 1);
  }
  for (int k = tid; k < h * h; k += n) dh[k] = dct_h[k];
  for (int k = tid; k < w * w; k += n) dwt[k] = dct_wt[k];
  const int src = plane[(y0 + r) * buf_w + x0 + c];
  __syncthreads();
  if (tid == 0) {
    int s = 0;
    for (int k = 1; k <= w; ++k) s += above[k];
    for (int k = 1; k <= h; ++k) s += left[k];
    dc_val = (s + ((w + h) >> 1)) / (w + h);
  }
  __syncthreads();

  const bool is_dc = tid == 0;
  const float zbin = is_dc ? zbin_dc : zbin_ac;
  const float rnd = is_dc ? rnd_dc : rnd_ac;
  const float step = is_dc ? step_dc : step_ac;
  const int av = above[1 + c];
  const int lv = left[1 + r];
  const int tl = above[0];
  const int wh = sm_weights[h + r];
  const int ww = sm_weights[w + c];
  const int below = left[h];
  const int right = above[w];
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = n >> 5;

  float best_cost = 0.f;
  int best_mode = 0;
  for (int m = 0; m < 13; ++m) {
    int pred;
    if (m == 0) {
      pred = dc_val;
    } else if (m == 1) {
      pred = av;
    } else if (m == 2) {
      pred = lv;
    } else if (m <= 8) {
      const int t = dir_taps[(m - 3) * n + tid];
      const int* e = (t & 1) ? left : above;
      const int i0 = (t >> 1) & 127, i1 = (t >> 8) & 127;
      const int w0 = (t >> 15) & 63, w1 = (t >> 21) & 63;
      pred = (w0 * e[i0] + w1 * e[i1] + 16) >> 5;
    } else if (m == 9) {
      pred = (av * wh + below * (256 - wh) + lv * ww + right * (256 - ww)
              + 256) >> 9;
    } else if (m == 10) {
      pred = (av * wh + below * (256 - wh) + 128) >> 8;
    } else if (m == 11) {
      pred = (lv * ww + right * (256 - ww) + 128) >> 8;
    } else {
      const int base = av + lv - tl;
      const int pa = abs(base - av), pl = abs(base - lv),
                ptl = abs(base - tl);
      pred = (pa <= pl && pa <= ptl) ? av : (pl <= ptl ? lv : tl);
    }
    resid[tid] = (float)(src - pred);
    __syncthreads();
    // tmp = dh @ resid (row r of dh, column c of resid)
    float acc = 0.f;
    for (int a = 0; a < h; ++a) acc += dh[r * h + a] * resid[a * w + c];
    tmp[tid] = acc;
    __syncthreads();
    // coefficient (r, c) = tmp[r, :] @ dwt[:, c]
    float cf = 0.f;
    for (int b = 0; b < w; ++b) cf += tmp[r * w + b] * dwt[b * w + c];
    float e2, mg;
    int nz;
    cost_model::coef(cf, zbin, rnd, step, true, e2, nz, mg);
    for (int off = 16; off > 0; off >>= 1) {
      e2 = __fadd_rn(e2, __shfl_down_sync(0xffffffffu, e2, off));
      nz += __shfl_down_sync(0xffffffffu, nz, off);
      mg = __fadd_rn(mg, __shfl_down_sync(0xffffffffu, mg, off));
    }
    if (lane == 0) {
      red_sse[warp] = e2;
      red_nnz[warp] = nz;
      red_mag[warp] = mg;
    }
    __syncthreads();
    if (tid == 0) {
      float sse = 0.f, mag = 0.f;
      int nnz = 0;
      for (int i = 0; i < n_warps; ++i) {
        sse = __fadd_rn(sse, red_sse[i]);
        mag = __fadd_rn(mag, red_mag[i]);
        nnz += red_nnz[i];
      }
      const float cost = cost_model::rd_cost(sse, nnz, mag, mode_bits[m],
                                             lam);
      if (m == 0 || cost < best_cost) {
        best_cost = cost;
        best_mode = m;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    const int o = blockIdx.y * gridDim.x + blockIdx.x;
    out_mode[o] = best_mode;
    out_cost[o] = best_cost;
  }
}

}  // namespace

// plane: uint8 [buf_h, buf_w]; above_row: uint8 [buf_w] and halo: uint8
// [n_halo, buf_w], the true neighbour rows of a stripe (both null for a
// whole plane); dir_taps: int32 [6, h*w] (see
// ops/omd.py _dir_taps); sm_weights: int32 smooth weight table;
// dct_h: float32 [h, h]; dct_wt: float32 [w, w] (transposed DCT);
// mode_bits: float32 [13]; out_mode int32 / out_cost float32
// [buf_h / h, buf_w / w].  Returns the CUDA error of the launch.
extern "C" int intra_decision_launch(
    const void* plane, const void* above_row, const void* halo, int buf_h,
    int buf_w, int n_halo, int w, int h,
    const void* dir_taps, const void* sm_weights, const void* dct_h,
    const void* dct_wt, float zbin_dc, float zbin_ac, float rnd_dc,
    float rnd_ac, float step_dc, float step_ac, float lam,
    const void* mode_bits, void* out_mode, void* out_cost, void* stream) {
  if (w * h > 1024 || (w * h) % 32 != 0 || w + h + 1 > kMaxEdge ||
      (above_row == nullptr) != (halo == nullptr) || n_halo < 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(buf_w / w, buf_h / h);
  intra_decision_kernel<<<grid, w * h, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)plane, (const uint8_t*)above_row,
      (const uint8_t*)halo, buf_h, buf_w, halo ? n_halo : 0, w, h,
      (const int*)dir_taps,
      (const int*)sm_weights, (const float*)dct_h, (const float*)dct_wt,
      zbin_dc, zbin_ac, rnd_dc, rnd_ac, step_dc, step_ac, lam,
      (const float*)mode_bits, (int*)out_mode, (float*)out_cost);
  return (int)cudaGetLastError();
}
