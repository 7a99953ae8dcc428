// K2: the attention-LSTM decode cell, forward (one autoregressive step).
//
// Replaces: cst_captioning_tpu/ops/pallas_decode_cell.py, _decode_cell_kernel
// (launched by fused_decode_cell, bound into a step by
// make_pallas_decode_step).
//
//   ctx      = additive attention of q over (proj_mem, memory)   [stage a]
//   gates    = [x, ctx, h] @ [W_i; W_h] + b     (i | f | g | o)  [stage b]
//   c'       = sigmoid(f) * c + sigmoid(i) * tanh(g)             [stage c]
//   h'       = sigmoid(o) * tanh(c')
//
// What bounds it on an H100: device-memory bytes.  The gate weights are
// (E + 2H) x 4H float32 — 12.6 MB at E = H = 512 — and every step reads
// all of them for at most 40 rows (2 flops per weight per row, far below
// the ~20 flops/byte float32 balance point): ~3.8 us at 3.35 TB/s.  The
// weights fit in the 50 MB L2 cache, so back-to-back steps can run faster
// than that HBM bound.
//
// Design.  The TPU kernel kept both weight matrices in on-chip memory per
// batch block; a Hopper block has 227 KB of shared memory, so the cell is
// two launches instead:
//   (a) decode_attend_kernel — the attention of attention.cuh, one block
//       per row, writing only ctx (B, H) to a scratch buffer;
//   (b) lstm_cell_kernel — a tiled float32 GEMM of the virtual row
//       [x, ctx, h] (B, E + 2H) against [W_i; W_h], with the LSTM update
//       as its epilogue.  Each block owns kTJ hidden units for ALL FOUR
//       gates and up to kRows batch rows, so the gate pre-activations of
//       a (row, unit) never leave the block; it writes only c' and h'.
//       A block's loop is a chain of tile loads whose latency the few FMAs
//       of a small batch cannot hide, so the block splits K over kSplits
//       groups of threads that walk their slices side by side (a chain
//       kSplits times shorter); the groups' partial sums meet in shared
//       memory, where one group adds them in slice order, adds the bias
//       and applies the gate nonlinearities.  Weight and input tiles are
//       prefetched into registers one tile ahead.
// Every output sums its K products in one fixed order, so a row's result
// does not depend on the batch it is computed in.  Tensor cores (wgmma),
// TMA and persistent blocks are later work.
#include "attention.cuh"

constexpr int kTJ = 4;        // hidden units per block (x 4 gates = 16 cols)
constexpr int kRows = 16;     // batch rows per block
constexpr int kSplits = 4;    // K slices per block, one thread group each
constexpr int kKT = 64;       // K tile
constexpr int kGroupThreads = kTJ * kRows;            // 64: one (unit, row)
constexpr int kCellThreads = kSplits * kGroupThreads;  // 256
constexpr int kWPer = kKT * 4 / kGroupThreads;   // float4 weight loads a
                                                 // thread brings per tile (4)
constexpr int kXPer = kRows * kKT / kGroupThreads;  // input values (16)

static_assert(kWPer * kGroupThreads == kKT * 4,
              "a group brings its weight tile in equal float4 shares");
static_assert(kXPer * kGroupThreads == kRows * kKT,
              "a group brings its input tile in equal shares");

__global__ void __launch_bounds__(kAttnThreads)
decode_attend_kernel(const float* __restrict__ q,
                     const float* __restrict__ pm,
                     const float* __restrict__ mem,
                     const float* __restrict__ v, float* __restrict__ ctx,
                     int T, int A, int H) {
  extern __shared__ float smem[];
  const size_t b = blockIdx.x;
  attend_row(q + b * A, pm + b * T * A, mem + b * T * H, v, ctx + b * H,
             nullptr, smem, T, A, H);
}

// Weight tile loader of one thread group: its thread t brings, for
// i < kWPer, row (k0 + (t + i * 64) / 4) of gate ((t + i * 64) % 4), the
// kTJ == 4 consecutive columns [g * H + j0, g * H + j0 + 4); zeros at and
// past k_end.
__device__ __forceinline__ void load_w_tile(float4 (&out)[kWPer],
                                            const float* __restrict__ w,
                                            int t, int k0, int k_end, int H,
                                            int j0) {
#pragma unroll
  for (int i = 0; i < kWPer; ++i) {
    const int idx = t + i * kGroupThreads;
    const int k = k0 + (idx >> 2);
    const int g = idx & 3;
    out[i] = k < k_end ? *reinterpret_cast<const float4*>(
                             w + (size_t)k * 4 * H + g * H + j0)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Input tile loader of one thread group: the virtual row [x, ctx, h] of
// each of the block's rows, elements k0 .. k0 + kKT; thread t brings
// elements t, t + 64, ... (coalesced along k), 0 past the last row or at
// and past k_end.
__device__ __forceinline__ void load_x_tile(
    float (&out)[kXPer], const float* __restrict__ x,
    const float* __restrict__ ctx, const float* __restrict__ h, int t,
    int r0, int rows, int k0, int k_end, int E, int H) {
#pragma unroll
  for (int i = 0; i < kXPer; ++i) {
    const int idx = t + i * kGroupThreads;
    const int rr = idx / kKT;
    const int k = k0 + idx % kKT;
    const size_t b = r0 + rr;
    float val = 0.f;
    if (rr < rows && k < k_end) {
      if (k < E) val = x[b * E + k];
      else if (k < E + H) val = ctx[b * H + (k - E)];
      else val = h[b * H + (k - E - H)];
    }
    out[i] = val;
  }
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

// Block (blockIdx.x, blockIdx.y): hidden units [4 x, 4 x + 4) of rows
// [16 y, 16 y + 16).  Thread group s (threads 64 s .. 64 s + 63) walks K
// slice s, tiles_per_split tiles of kKT; every group runs the same number
// of tiles (zeros past the end of K) so the block's barriers line up.
__global__ void __launch_bounds__(kCellThreads)
lstm_cell_kernel(const float* __restrict__ x, const float* __restrict__ ctx,
                 const float* __restrict__ h, const float* __restrict__ w,
                 const float* __restrict__ bias, const float* __restrict__ c,
                 float* __restrict__ c_out, float* __restrict__ h_out, int B,
                 int E, int H, int tiles_per_split) {
  __shared__ __align__(16) float ws[kSplits][kKT][4 * kTJ];  // [k][g*kTJ+u]
  __shared__ float xs[kSplits][kRows][kKT + 1];    // +1: rows in distinct banks
  __shared__ float red[kSplits][kRows][4 * kTJ];   // partial gate sums

  const int s = threadIdx.x / kGroupThreads;  // K slice of this thread
  const int t = threadIdx.x % kGroupThreads;
  const int j = t % kTJ;                      // hidden unit within the block
  const int r = t / kTJ;                      // batch row within the block
  const int j0 = blockIdx.x * kTJ;
  const int r0 = blockIdx.y * kRows;
  const int rows = min(kRows, B - r0);
  const int k_total = E + 2 * H;
  const int k_begin = s * tiles_per_split * kKT;
  const int k_end = min(k_total, k_begin + tiles_per_split * kKT);

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float4 wnext[kWPer];
  float xnext[kXPer];
  load_w_tile(wnext, w, t, k_begin, k_end, H, j0);
  load_x_tile(xnext, x, ctx, h, t, r0, rows, k_begin, k_end, E, H);
  for (int it = 0; it < tiles_per_split; ++it) {
    const int k0 = k_begin + it * kKT;
#pragma unroll
    for (int i = 0; i < kWPer; ++i) {
      const int idx = t + i * kGroupThreads;
      *reinterpret_cast<float4*>(&ws[s][idx >> 2][(idx & 3) * kTJ]) =
          wnext[i];
    }
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const int idx = t + i * kGroupThreads;
      xs[s][idx / kKT][idx % kKT] = xnext[i];
    }
    __syncthreads();
    if (it + 1 < tiles_per_split) {
      load_w_tile(wnext, w, t, k0 + kKT, k_end, H, j0);
      load_x_tile(xnext, x, ctx, h, t, r0, rows, k0 + kKT, k_end, E, H);
    }
    if (r < rows) {
#pragma unroll 8
      for (int kk = 0; kk < kKT; ++kk) {
        const float a = xs[s][r][kk];
        acc[0] = fmaf(a, ws[s][kk][0 * kTJ + j], acc[0]);
        acc[1] = fmaf(a, ws[s][kk][1 * kTJ + j], acc[1]);
        acc[2] = fmaf(a, ws[s][kk][2 * kTJ + j], acc[2]);
        acc[3] = fmaf(a, ws[s][kk][3 * kTJ + j], acc[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < 4; ++g) red[s][r][g * kTJ + j] = acc[g];
  __syncthreads();
  if (s != 0 || r >= rows) return;

  // gates = sum of the slices in order + bias; then the flax
  // OptimizedLSTMCell update.
  const int u = j0 + j;
  float gate[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float sum = 0.f;
#pragma unroll
    for (int z = 0; z < kSplits; ++z) sum += red[z][r][g * kTJ + j];
    gate[g] = sum + bias[g * H + u];
  }
  const size_t idx = (size_t)(r0 + r) * H + u;
  const float cn = sigmoidf_(gate[1]) * c[idx]
                   + sigmoidf_(gate[0]) * tanhf(gate[2]);
  c_out[idx] = cn;
  h_out[idx] = sigmoidf_(gate[3]) * tanhf(cn);
}

// ctx (B, H) is scratch the caller allocates.
extern "C" int decode_cell_forward(const float* x, const float* c,
                                   const float* h, const float* q,
                                   const float* pm, const float* mem,
                                   const float* v, const float* w,
                                   const float* bias, float* ctx,
                                   float* c_out, float* h_out, int B, int T,
                                   int E, int A, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = attend_smem_bytes(T, A);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_attend_kernel<<<B, kAttnThreads, smem, s>>>(q, pm, mem, v, ctx, T,
                                                     A, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // Slices of whole K tiles, so only the last one has a ragged end.
  const int k_tiles = (E + 2 * H + kKT - 1) / kKT;
  const int tiles_per_split = (k_tiles + kSplits - 1) / kSplits;
  const dim3 grid(H / kTJ, (B + kRows - 1) / kRows);
  lstm_cell_kernel<<<grid, kCellThreads, 0, s>>>(
      x, ctx, h, w, bias, c, c_out, h_out, B, E, H, tiles_per_split);
  return (int)cudaGetLastError();
}
