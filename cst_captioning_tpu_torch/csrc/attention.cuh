// Device code shared by the additive-attention kernel (attention.cu) and
// stage (a) of the decode-cell kernel (decode_cell.cu): one batch row of
//
//   w   = softmax_t( sum_a tanh(proj_mem[t, a] + q[a]) * v[a] )
//   ctx = sum_t w[t] * memory[t, :]
//
// all in float32, as elementwise work plus block reductions (the TPU kernel
// deliberately avoided matrix-unit dots for the same sums).  One thread
// block owns one row; the caller passes T + 2*A floats of shared memory.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

// 32 warps: every time step of a 29-step memory gets its own warp, so the
// score loads of a row are in flight together instead of in rounds.
constexpr int kAttnThreads = 1024;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// q (A,), pm (T, A), mem (T, H), v (A,) -> ctx (H,), w_out (T,) or nullptr.
// smem holds q, v and the T scores.  Every sum runs in a fixed order, so a
// row's result does not depend on the batch it is computed in.
__device__ __forceinline__ void attend_row(
    const float* __restrict__ q, const float* __restrict__ pm,
    const float* __restrict__ mem, const float* __restrict__ v,
    float* __restrict__ ctx, float* __restrict__ w_out, float* smem,
    int T, int A, int H) {
  float* qs = smem;            // (A,)
  float* vs = smem + A;        // (A,)
  float* scores = smem + 2 * A;  // (T,)
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    qs[a] = q[a];
    vs[a] = v[a];
  }
  __syncthreads();

  // Scores: one warp per time step, lanes stride over A (coalesced reads of
  // proj_mem), then a warp reduction.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int t = warp; t < T; t += nwarps) {
    const float* row = pm + (size_t)t * A;
    float s = 0.f;
#pragma unroll 16
    for (int a = lane; a < A; a += 32) s += tanhf(row[a] + qs[a]) * vs[a];
    s = warp_sum(s);
    if (lane == 0) scores[t] = s;
  }
  __syncthreads();

  // Softmax over T in warp 0: exp(s - max) / sum, as jax.nn.softmax.
  if (warp == 0) {
    float m = -FLT_MAX;
    for (int t = lane; t < T; t += 32) m = fmaxf(m, scores[t]);
    m = warp_max(m);
    float sum = 0.f;
    for (int t = lane; t < T; t += 32) {
      const float e = expf(scores[t] - m);
      scores[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int t = lane; t < T; t += 32) {
      const float wt = scores[t] / sum;
      scores[t] = wt;
      if (w_out != nullptr) w_out[t] = wt;
    }
  }
  __syncthreads();

  // Context: threads stride over H (coalesced reads of memory), each sums
  // over T in order.
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float acc = 0.f;
    // Unrolled so several loads of memory are in flight at once; the
    // sum still runs in order over t.
#pragma unroll 16
    for (int t = 0; t < T; ++t) acc += scores[t] * mem[(size_t)t * H + h];
    ctx[h] = acc;
  }
}

// Shared memory attend_row needs; above 48 KB the kernel must opt in.
inline size_t attend_smem_bytes(int T, int A) {
  return (size_t)(2 * A + T) * sizeof(float);
}
