// K1: fused additive attention, forward.
//
// Replaces: cst_captioning_tpu/ops/pallas_attention.py, _attention_kernel
// (launched by _forward through fused_additive_attention).
//
// What bounds it on an H100: device-memory bytes.  Per row it reads
// proj_mem (T*A) and memory (T*H) once and does ~4 flops per element, far
// below the card's ~20 flops/byte float32 balance point.  At B=40, T=29,
// A=H=512 that is ~4.75 MB, ~1.4 us at 3.35 TB/s.  At the serving sizes
// (1-40 rows) it is latency that bounds it: a row is a chain of load,
// score, softmax and context.
//
// Design (attention.cuh): one cluster of four 256-thread blocks per row.
// Each block prefetches its share of BOTH operands into shared memory at
// once (its proj_mem rows for the scores, its quarter of memory's columns
// for the context), the blocks trade the T scores through distributed
// shared memory, and each writes its quarter of ctx and its share of w.
// The (T, A) tanh tensor and the scores never reach device memory.
//
// Two storage types, one template (attention.cuh): float32, and bfloat16
// as the reference kernel runs under --use_bfloat16 (q, proj_mem, memory
// read and ctx, w written in bfloat16; v float32; float32 math).  In
// bfloat16 the row's bytes halve (~2.4 MB at B = 40) and the kernel stays
// bound by device-memory bytes, or at 1-40 rows by its latency.
#include "attention.cuh"

extern "C" int additive_attention_forward(const float* q, const float* pm,
                                          const float* mem, const float* v,
                                          float* ctx, float* w, int B, int T,
                                          int A, int H, int smem_bytes,
                                          void* stream) {
  return (int)launch_attention<float>(q, pm, mem, v, ctx, w, B, T, A, H,
                                      (size_t)smem_bytes,
                                      (cudaStream_t)stream);
}

extern "C" int additive_attention_forward_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* pm,
    const __nv_bfloat16* mem, const float* v, __nv_bfloat16* ctx,
    __nv_bfloat16* w, int B, int T, int A, int H, int smem_bytes,
    void* stream) {
  return (int)launch_attention<__nv_bfloat16>(q, pm, mem, v, ctx, w, B, T, A,
                                              H, (size_t)smem_bytes,
                                              (cudaStream_t)stream);
}
