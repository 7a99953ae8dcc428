// K1: fused additive attention, forward.
//
// Replaces: cst_captioning_tpu/ops/pallas_attention.py, _attention_kernel
// (launched by _forward through fused_additive_attention).
//
// What bounds it on an H100: device-memory bytes.  Per row it reads
// proj_mem (T*A) and memory (T*H) once and does ~4 flops per element, far
// below the card's ~20 flops/byte float32 balance point.  At B=40, T=29,
// A=H=512 that is ~4.75 MB, ~1.4 us at 3.35 TB/s.
//
// Design: one block of 32 warps per batch row (attention.cuh).  Warps
// stride over T and lanes over A, so proj_mem is read in coalesced
// 128-byte rows exactly once, with a row's loads in flight together; the
// T scores and the softmax stay in shared memory and the (T, A) tanh
// tensor never reaches device memory.  The context sum reads memory once,
// coalesced over H.  A batch of 1..40 rows launches 1..40 blocks, so at
// serving sizes the kernel waits on load latency, not on bandwidth, and
// most SMs idle: the next step is to split a row over several blocks
// along T, or to fold this into the caller's kernel, as decode_cell.cu
// does.
#include "attention.cuh"

__global__ void __launch_bounds__(kAttnThreads)
additive_attention_kernel(const float* __restrict__ q,
                          const float* __restrict__ pm,
                          const float* __restrict__ mem,
                          const float* __restrict__ v,
                          float* __restrict__ ctx, float* __restrict__ w,
                          int T, int A, int H) {
  extern __shared__ float smem[];
  const size_t b = blockIdx.x;
  attend_row(q + b * A, pm + b * T * A, mem + b * T * H, v, ctx + b * H,
             w + b * T, smem, T, A, H);
}

extern "C" int additive_attention_forward(const float* q, const float* pm,
                                          const float* mem, const float* v,
                                          float* ctx, float* w, int B, int T,
                                          int A, int H, void* stream) {
  const size_t smem = attend_smem_bytes(T, A);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        additive_attention_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  additive_attention_kernel<<<B, kAttnThreads, smem,
                              (cudaStream_t)stream>>>(q, pm, mem, v, ctx, w,
                                                      T, A, H);
  return (int)cudaGetLastError();
}
