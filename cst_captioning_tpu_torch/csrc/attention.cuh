// Device code shared by the additive-attention kernel (attention.cu) and
// stage (a) of the decode-cell kernel (decode_cell.cu): one batch row of
//
//   w   = softmax_t( sum_a tanh(proj_mem[t, a] + q[a]) * v[a] )
//   ctx = sum_t w[t] * memory[t, :]
//
// all in float32, as elementwise work plus warp reductions (the TPU kernel
// deliberately avoided matrix-unit dots for the same sums).
//
// Storage type S: float, or __nv_bfloat16 (the reference's bf16 storage
// under --use_bfloat16).  q, proj_mem and memory are read, and ctx and w
// written, in S; v stays float32; every sum is float32.  A 16-byte copy
// carries 16 / sizeof(S) values (4 or 8), so bfloat16 needs A % 8 == 0 and
// H % (8 * kAttnCluster) == 0.  The float32 instantiation is the float32
// kernel op for op.
//
// Design.  A row is latency-bound (59 KB of proj_mem and 59 KB of memory
// at T = 29, A = H = 512), so it is split over a cluster of kAttnCluster
// blocks.  Block j of a row's cluster owns a contiguous share of the time
// steps (for the scores) and the j-th quarter of H (for the context).  At
// its start it asks for both of its operands at once with 16-byte
// cp.async copies into shared memory: q, v and its proj_mem rows in one
// group, its memory columns in a second, so the context operand is in
// flight while the scores and the softmax run.  Each block writes its
// scores into every block's shared memory (distributed shared memory),
// one cluster barrier makes them visible, and each takes the softmax of
// all T in the same fixed order (so all four hold the same bits), then
// writes its slice of ctx and its share of w.  Sums run in fixed orders
// (lanes over a ascending then warp_sum within a time step, ascending t
// for the context), so a row's result does not depend on the batch it is
// in.
#pragma once

#include <cfloat>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mutex>

constexpr int kAttnCluster = 4;    // blocks per batch row
constexpr int kAttnThreads = 256;  // 8 warps: one time step each

// A storage value as float32, and a float32 value in storage type S
// (bfloat16: round to nearest even).
__device__ __forceinline__ float load_f(float x) { return x; }
__device__ __forceinline__ float load_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename S>
__device__ __forceinline__ S store_as(float x);
template <>
__device__ __forceinline__ float store_as<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Values of storage type S that one 16-byte copy carries.
template <typename S>
__host__ __device__ constexpr int per_copy() {
  return 16 / (int)sizeof(S);
}

// Start of part j when n items are cut into `parts` contiguous parts
// (sizes differ by at most one).  The wrappers' geometry functions use the
// same formula.
__host__ __device__ __forceinline__ int share_lo(int n, int j, int parts) {
  return (int)((long long)n * j / parts);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 16-byte asynchronous copy, device memory -> shared memory (L1 bypassed).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The cluster barrier in two halves, so that independent work can run
// between a block's arrival and its wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Programmatic dependent launch: let the next kernel of the stream start
// (a no-op unless it was launched with programmatic stream serialisation).
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Block until the previous kernel of the stream has finished and its
// writes are visible (returns at once for a kernel launched without PDL).
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Let `kernel` take `bytes` of dynamic shared memory, on SMs set to their
// largest shared-memory share (so a gate block and an attention block fit
// on one SM together).  *opted keeps the largest size granted so far: a
// launch within it calls nothing.
static inline cudaError_t opt_in_shared(const void* kernel, size_t bytes,
                                        size_t* opted) {
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  if (bytes <= *opted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *opted = bytes;
  return err;
}

// Shared memory of one attention block: q (A, in S), v (A, float32), its
// proj_mem rows (at most ceil(T / kAttnCluster) of A) and its memory
// columns (T x H / kAttnCluster), both in S, and the T scores, then
// weights (float32).
template <typename S>
inline size_t attention_smem_bytes(int T, int A, int H) {
  const int ts_max = (T + kAttnCluster - 1) / kAttnCluster;
  return (size_t)(A + ts_max * A + T * (H / kAttnCluster)) * sizeof(S) +
         (size_t)(A + T) * sizeof(float);
}

// One row.  q (A,), pm (T, A), mem (T, H) in S, v (A,) float32 -> ctx
// (H,), w_out (T,) or nullptr, in S.  Needs A % per_copy<S>() == 0, H %
// (per_copy<S>() * kAttnCluster) == 0 and 16-byte aligned q, pm, mem, v
// (the wrappers check).
template <typename S>
__device__ __forceinline__ void attend_row(
    const S* __restrict__ q, const S* __restrict__ pm,
    const S* __restrict__ mem, const float* __restrict__ v,
    S* __restrict__ ctx, S* __restrict__ w_out, float* smem, int T, int A,
    int H) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int j = (int)cluster.block_rank();
  const int t_lo = share_lo(T, j, kAttnCluster);
  const int t_hi = share_lo(T, j + 1, kAttnCluster);
  const int ts_max = (T + kAttnCluster - 1) / kAttnCluster;
  const int hs = H / kAttnCluster;
  const int h_lo = j * hs;
  constexpr int kPer = per_copy<S>();
  S* qs = reinterpret_cast<S*>(smem);             // (A,)
  float* vs = reinterpret_cast<float*>(qs + A);   // (A,)
  S* pms = reinterpret_cast<S*>(vs + A);  // (ts_max, A): rows t_lo .. t_hi
  S* mems = pms + ts_max * A;    // (T, hs): columns h_lo .. h_lo + hs
  float* wts = reinterpret_cast<float*>(mems + T * hs);  // (T,): scores

  // Group 0: q, v and this block's proj_mem rows (contiguous in pm).
  const int aq = A / kPer;  // 16-byte copies of q, and of a proj_mem row
  const int a4 = A / 4;     // of v
  const int n0 = aq + a4 + (t_hi - t_lo) * aq;
  for (int i = threadIdx.x; i < n0; i += blockDim.x) {
    if (i < aq) {
      cp_async16(qs + kPer * i, q + kPer * i);
    } else if (i < aq + a4) {
      cp_async16(vs + 4 * (i - aq), v + 4 * (i - aq));
    } else {
      const int k = i - aq - a4;
      cp_async16(pms + kPer * k, pm + (size_t)t_lo * A + kPer * k);
    }
  }
  cp_async_commit();
  // Group 1: this block's columns of memory, every time step.
  const int h4 = hs / kPer;
  for (int i = threadIdx.x; i < T * h4; i += blockDim.x) {
    const int t = i / h4;
    const int c = i - t * h4;
    cp_async16(mems + t * hs + kPer * c,
               mem + (size_t)t * H + h_lo + kPer * c);
  }
  cp_async_commit();
  griddep_launch_dependents();

  cp_async_wait<1>();
  __syncthreads();
  // Scores of the owned time steps: one warp per step, lanes stride over
  // A, then a warp reduction; lane r writes the score into block r.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int t = t_lo + warp; t < t_hi; t += nwarps) {
    const S* row = pms + (t - t_lo) * A;
    float s = 0.f;
#pragma unroll 4
    for (int a = lane; a < A; a += 32)
      s += tanhf(load_f(row[a]) + load_f(qs[a])) * vs[a];
    s = warp_sum(s);
    if (lane < kAttnCluster) *cluster.map_shared_rank(wts + t, lane) = s;
  }
  cluster_arrive();
  cluster_wait();  // all T scores are in this block's wts

  // Softmax over T in warp 0: exp(s - max) / sum, as jax.nn.softmax.
  if (warp == 0) {
    float m = -FLT_MAX;
    for (int t = lane; t < T; t += 32) m = fmaxf(m, wts[t]);
    m = warp_max(m);
    float sum = 0.f;
    for (int t = lane; t < T; t += 32) {
      const float e = expf(wts[t] - m);
      wts[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int t = lane; t < T; t += 32) {
      const float wt = wts[t] / sum;
      wts[t] = wt;
      if (w_out != nullptr && t >= t_lo && t < t_hi) w_out[t] = store_as<S>(wt);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Context slice: thread per column, ascending t.
  for (int h = threadIdx.x; h < hs; h += blockDim.x) {
    float acc = 0.f;
#pragma unroll 8
    for (int t = 0; t < T; ++t) acc += wts[t] * load_f(mems[t * hs + h]);
    ctx[h_lo + h] = store_as<S>(acc);
  }
}

// Grid (kAttnCluster, B): one cluster per batch row.  w_out may be null.
template <typename S>
__global__ void __cluster_dims__(kAttnCluster, 1, 1)
    __launch_bounds__(kAttnThreads)
    attention_kernel(const S* __restrict__ q, const S* __restrict__ pm,
                     const S* __restrict__ mem, const float* __restrict__ v,
                     S* __restrict__ ctx, S* __restrict__ w_out, int T, int A,
                     int H) {
  extern __shared__ __align__(16) float smem[];
  const size_t b = blockIdx.y;
  attend_row<S>(q + b * A, pm + b * T * A, mem + b * T * H, v, ctx + b * H,
                w_out == nullptr ? nullptr : w_out + b * T, smem, T, A, H);
}

// Launch the attention on `stream`.  smem_bytes is what the wrapper's
// geometry computed; a disagreement with attention_smem_bytes is refused.
template <typename S>
static inline cudaError_t launch_attention(
    const S* q, const S* pm, const S* mem, const float* v, S* ctx, S* w_out,
    int B, int T, int A, int H, size_t smem_bytes, cudaStream_t stream) {
  if (smem_bytes != attention_smem_bytes<S>(T, A, H))
    return cudaErrorInvalidValue;
  static size_t opted = 0;
  const cudaError_t err =
      opt_in_shared((const void*)attention_kernel<S>, smem_bytes, &opted);
  if (err != cudaSuccess) return err;
  attention_kernel<S><<<dim3(kAttnCluster, B), kAttnThreads, smem_bytes,
                        stream>>>(q, pm, mem, v, ctx, w_out, T, A, H);
  return cudaGetLastError();
}
