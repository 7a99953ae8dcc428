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
// two launches:
//   (a) attention_kernel (attention.cuh): a cluster of 4 blocks per row,
//       writing only ctx (B, H) to a scratch buffer.  It lets the gate
//       launch start early (programmatic dependent launch).
//   (b) gate_kernel: a weight stream over all SMs.  A column tile is 8
//       hidden units x 4 gates = 32 output columns, so every weight row a
//       block reads is four whole 32-byte sectors.  Each of the H / 8
//       tiles is one cluster of kGateCluster = 2 blocks that split K: rank
//       r takes the r-th half of each of the x, h and ctx segments of K
//       (768 rows at E = H = 512).  At block start every lane issues
//       16-byte cp.async copies of all the weights it will read — 96 KB a
//       block, 12.6 MB across the 128 blocks, read once per step whatever
//       B is — from w as it lies, in three groups, one per segment (x, h,
//       ctx).  Warps run the x and h rows as they land, and wait on the
//       attention launch (griddepcontrol.wait) only before they read ctx.
//       Rows of the batch go through in groups of kGateRows with the
//       weights already in shared memory, the next group's inputs arriving
//       (cp.async) while the current one runs.  A warp's lanes take four
//       rows of K at a time (a quarter-warp per gate, 4 rows x 2 lanes of 4
//       units); their sums meet by shuffles, the warps' in shared memory
//       (added in warp order), and the pair's through distributed shared
//       memory: each block writes the sums of the units its peer owns into
//       the peer's shared memory, one cluster barrier per kChunkRows rows,
//       and rank r adds the two blocks' sums of its 4 units in rank order,
//       adds the bias and applies the flax OptimizedLSTMCell update.  Only
//       c' and h' reach device memory.  Two-block clusters are what keeps
//       every tile in one wave: a cluster takes two SMs (one TPC), and the
//       card holds all 64, where it holds only 15 of 16 eight-block
//       clusters (PERF.md).  (TMA boxes of the same slice were slower:
//       a tile's rows are 32 bytes wide, PERF.md.)
// Every output sums its K products in one fixed order (per lane: its x
// rows, h rows, ctx rows ascending; then the four lanes of a column by a
// shuffle butterfly; then warps; then ranks), so a row's result does not
// depend on B or on the rows it shares a group with.  Tensor cores stay
// out: the float32 contract forbids TF32.
#include "attention.cuh"

constexpr int kGateCluster = 2;                  // K slices = blocks a tile
constexpr int kGateUnits = 8;                    // hidden units a tile
constexpr int kGateCols = 4 * kGateUnits;        // 32: i | f | g | o
constexpr int kGateSub = 4;                      // rows of K a warp step
constexpr int kGateWarps = 8;
constexpr int kGateThreads = 32 * kGateWarps;
constexpr int kGateRows = 8;                     // batch rows a group
constexpr int kChunkRows = 64;                   // batch rows a pair exchange
constexpr int kUnitsPerRank = kGateUnits / kGateCluster;  // 4
constexpr int kRankCols = 4 * kUnitsPerRank;     // 16: a rank's columns

static_assert(kUnitsPerRank * kGateCluster == kGateUnits,
              "the ranks share the tile's units evenly");
static_assert(kChunkRows * kUnitsPerRank <= kGateThreads,
              "one thread per (row, unit) of a rank's update");
static_assert(kChunkRows % kGateRows == 0, "a chunk is whole row groups");

// Rank r's rows of K: [x_lo, x_lo + nx) of the x segment, [h_lo, h_lo +
// nh) of the h segment and of the ctx segment.  A block holds them as
// local rows: x rows, then h rows, then ctx rows.  With E and H multiples
// of 8 every share is whole 16-byte pieces and whole warp steps.
struct GateSlice {
  int x_lo, nx, h_lo, nh;
};

__host__ __device__ __forceinline__ GateSlice gate_slice(int E, int H,
                                                         int r) {
  GateSlice s;
  s.x_lo = share_lo(E, r, kGateCluster);
  s.nx = share_lo(E, r + 1, kGateCluster) - s.x_lo;
  s.h_lo = share_lo(H, r, kGateCluster);
  s.nh = share_lo(H, r + 1, kGateCluster) - s.h_lo;
  return s;
}

// The most local rows any rank holds.
inline int gate_slice_rows(int E, int H) {
  int n = 0;
  for (int r = 0; r < kGateCluster; ++r) {
    const GateSlice s = gate_slice(E, H, r);
    n = s.nx + 2 * s.nh > n ? s.nx + 2 * s.nh : n;
  }
  return n;
}

// Shared memory of a gate block: the warps' partial sums (kGateWarps x
// kGateRows x kGateCols), the weight slice (4 gate planes of n x
// kGateUnits), two row groups' inputs (2 x kGateRows x n: one in use, one
// arriving) and the block sums the pair sends this rank (kGateCluster x
// kChunkRows x kRankCols).
inline size_t gate_smem_bytes(int E, int H) {
  const size_t n = gate_slice_rows(E, H);
  return (kGateWarps * kGateRows * kGateCols + n * kGateCols +
          2 * kGateRows * n + kGateCluster * kChunkRows * kRankCols) *
         sizeof(float);
}

// Block-wide cp.async copies of `len` inputs of batch rows r0 .. r0 + rows
// (src row stride ld, from column src_lo) to local rows kb .. kb + len of
// xs[row][kk] (row stride n).  Not committed.  Rows of the group past the
// batch are left as they are: their sums are never stored.
__device__ __forceinline__ void issue_inputs(
    float* xs, const float* __restrict__ src, int ld, int src_lo, int kb,
    int len, int r0, int rows, int n) {
  const int chunks = len / 4;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    cp_async16(xs + r * n + kb + 4 * c,
               src + (size_t)(r0 + r) * ld + src_lo + 4 * c);
  }
}

// All three inputs (x, h, ctx) of batch rows r0 .. r0 + rows into xs,
// committed as one group.
__device__ __forceinline__ void issue_all_inputs(
    float* xs, const float* __restrict__ x, const float* __restrict__ h,
    const float* __restrict__ ctx, const GateSlice& s, int r0, int rows,
    int n, int E, int H) {
  issue_inputs(xs, x, E, s.x_lo, 0, s.nx, r0, rows, n);
  issue_inputs(xs, h, H, s.h_lo, s.nx, s.nh, r0, rows, n);
  issue_inputs(xs, ctx, H, s.h_lo, s.nx + s.nh, s.nh, r0, rows, n);
  cp_async_commit();
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 w) {
  acc[0] = fmaf(a, w.x, acc[0]);
  acc[1] = fmaf(a, w.y, acc[1]);
  acc[2] = fmaf(a, w.z, acc[2]);
  acc[3] = fmaf(a, w.w, acc[3]);
}

// A warp's steps are groups of kGateSub local rows: step i covers rows
// kGateSub * i .. + kGateSub, and warp w takes steps w, w + kGateWarps, ...
// Lane l works on gate l / 8, row kGateSub * i + (l / 2) % 4 and units
// 4 (l % 2) .. + 4; a quarter-warp reads 4 whole rows of one gate plane.

// This warp's first step at or after ib.
__device__ __forceinline__ int first_step(int ib) {
  const int warp = threadIdx.x >> 5;
  return ib + ((warp - ib) % kGateWarps + kGateWarps) % kGateWarps;
}

// Issue the cp.async copies of the weights this lane reads in its steps of
// [ib, ie) — w rows w_lo + (local row - kk_lo) — into ws[gate][kk][unit],
// and commit them as one group.
__device__ __forceinline__ void issue_weights(
    float* ws, const float* __restrict__ w, int n, int ib, int ie,
    int kk_lo, int w_lo, int lane, int H, int j0) {
  const int g = lane >> 3;
  const int u4 = (lane & 1) * 4;
  const int sub = (lane >> 1) & 3;
  for (int i = first_step(ib); i < ie; i += kGateWarps) {
    const int kk = kGateSub * i + sub;
    cp_async16(ws + (g * n + kk) * kGateUnits + u4,
               w + (size_t)(w_lo + kk - kk_lo) * 4 * H + g * H + j0 + u4);
  }
  cp_async_commit();
}

// acc[row][unit] += xs[row][kk] * ws[gate][kk][unit] over this lane's rows
// of its steps in [ib, ie), for the first RP batch rows, in step order.
template <int RP>
__device__ __forceinline__ void fma_span(float (&acc)[kGateRows][4],
                                         const float* ws, const float* xs,
                                         int n, int ib, int ie, int lane) {
  const int i0 = first_step(ib);
  const float* wl = ws + (lane >> 3) * n * kGateUnits + (lane & 1) * 4;
  const int sub = (lane >> 1) & 3;
#pragma unroll 2
  for (int i = i0; i < ie; i += kGateWarps) {
    const int kk = kGateSub * i + sub;
    const float4 wv = *reinterpret_cast<const float4*>(wl + kk * kGateUnits);
#pragma unroll
    for (int r = 0; r < RP; ++r) fma4(acc[r], xs[r * n + kk], wv);
  }
}

// The same for a group of `rows` live rows: the narrowest span that holds
// them (each row's sum is the same chain whatever the span).
__device__ __forceinline__ void fma_rows(float (&acc)[kGateRows][4],
                                         const float* ws, const float* xs,
                                         int n, int ib, int ie, int rows,
                                         int lane) {
  if (rows <= 4) fma_span<4>(acc, ws, xs, n, ib, ie, lane);
  else fma_span<kGateRows>(acc, ws, xs, n, ib, ie, lane);
}

// The four lanes of a column (lanes l, l ^ 2, l ^ 4, l ^ 6) add their sums
// by a butterfly; every one of them ends with the same bits.
template <int RP>
__device__ __forceinline__ void sum_lanes(float (&acc)[kGateRows][4]) {
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 2);
      acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 4);
    }
}

__device__ __forceinline__ void sum_lanes_rows(float (&acc)[kGateRows][4],
                                               int rows) {
  if (rows <= 4) sum_lanes<4>(acc);
  else sum_lanes<kGateRows>(acc);
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

// Grid: kGateCluster blocks for each of the H / kGateUnits column tiles.
// n_rows is gate_slice_rows(E, H) (the shared-memory layout's row count).
// Needs E % 8 == 0, H % 8 == 0 and 16-byte aligned x, h, w (the wrapper
// checks).
__global__ void __cluster_dims__(kGateCluster, 1, 1)
    __launch_bounds__(kGateThreads, 1)
    gate_kernel(const float* __restrict__ x, const float* __restrict__ ctx,
                const float* __restrict__ h, const float* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ c,
                float* __restrict__ c_out, float* __restrict__ h_out, int B,
                int E, int H, int n_rows) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float gate_smem[];
  float* red = gate_smem;                                 // [warp][row][col]
  float* ws = red + kGateWarps * kGateRows * kGateCols;   // [gate][kk][unit]
  float* xbuf = ws + n_rows * kGateCols;         // 2 x [row][kk], stride n
  float* part = xbuf + 2 * kGateRows * n_rows;   // [src rank][row][col]

  const int rank = (int)cluster.block_rank();
  const int j0 = (blockIdx.x / kGateCluster) * kGateUnits;
  const GateSlice s = gate_slice(E, H, rank);
  const int n = s.nx + 2 * s.nh;
  const int x_steps = s.nx / kGateSub;
  const int xh_steps = (s.nx + s.nh) / kGateSub;
  const int n_steps = n / kGateSub;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // cp.async groups, oldest first: the first row group's x and h inputs,
  // then this lane's weights of the x, h and ctx segments.
  const int rows0 = min(kGateRows, B);
  issue_inputs(xbuf, x, E, s.x_lo, 0, s.nx, 0, rows0, n);
  issue_inputs(xbuf, h, H, s.h_lo, s.nx, s.nh, 0, rows0, n);
  cp_async_commit();
  issue_weights(ws, w, n, 0, x_steps, 0, s.x_lo, lane, H, j0);
  issue_weights(ws, w, n, x_steps, xh_steps, s.nx, E + H + s.h_lo, lane, H,
                j0);
  issue_weights(ws, w, n, xh_steps, n_steps, s.nx + s.nh, E + s.h_lo, lane,
                H, j0);

  for (int r0 = 0; r0 < B; r0 += kGateRows) {
    const int rows = min(kGateRows, B - r0);
    const int grp = r0 / kGateRows;
    float* xs = xbuf + (grp & 1) * kGateRows * n;
    float* xs_next = xbuf + ((grp + 1) & 1) * kGateRows * n;
    const bool more = r0 + kGateRows < B;
    float acc[kGateRows][4];
#pragma unroll
    for (int r = 0; r < kGateRows; ++r)
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

    if (grp == 0) {
      // The x and h rows run while the attention launch may still run.
      cp_async_wait<2>();  // the inputs and this lane's x weights
      __syncthreads();
      fma_rows(acc, ws, xs, n, 0, x_steps, rows, lane);
      cp_async_wait<1>();  // this lane's h weights
      fma_rows(acc, ws, xs, n, x_steps, xh_steps, rows, lane);
      griddep_wait();  // ctx comes from the attention launch
      issue_inputs(xs, ctx, H, s.h_lo, s.nx + s.nh, s.nh, 0, rows, n);
      cp_async_commit();
      if (more) {
        issue_all_inputs(xs_next, x, h, ctx, s, r0 + kGateRows,
                         min(kGateRows, B - r0 - kGateRows), n, E, H);
        cp_async_wait<1>();  // all but the next group's inputs
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      fma_rows(acc, ws, xs, n, xh_steps, n_steps, rows, lane);
    } else {
      // This group's inputs were issued during the last group; the next
      // group's go into the buffer the last group read.
      if (more) {
        issue_all_inputs(xs_next, x, h, ctx, s, r0 + kGateRows,
                         min(kGateRows, B - r0 - kGateRows), n, E, H);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      fma_rows(acc, ws, xs, n, 0, xh_steps, rows, lane);
      fma_rows(acc, ws, xs, n, xh_steps, n_steps, rows, lane);
    }
    sum_lanes_rows(acc, rows);

    // The warps' sums, added in warp order, go to the rank that owns their
    // units: part[this rank][row in chunk][gate * 4 + unit % 4] of the
    // owner's shared memory.
    if ((lane & 6) == 0) {
      const int col = (lane >> 3) * kGateUnits + (lane & 1) * 4;
#pragma unroll
      for (int r = 0; r < kGateRows; ++r)
        *reinterpret_cast<float4*>(red + (warp * kGateRows + r) * kGateCols +
                                   col) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    __syncthreads();
    const int chunk_row0 = r0 % kChunkRows;
    if (chunk_row0 == 0 && r0 > 0) cluster_wait();  // the last chunk is read
    for (int e = threadIdx.x; e < rows * kGateCols; e += kGateThreads) {
      float sum = red[e];
#pragma unroll
      for (int q = 1; q < kGateWarps; ++q)
        sum += red[q * kGateRows * kGateCols + e];
      const int r = e / kGateCols;
      const int col = e % kGateCols;             // gate * kGateUnits + unit
      const int unit = col % kGateUnits;
      float* dst = cluster.map_shared_rank(part, unit / kUnitsPerRank);
      dst[(rank * kChunkRows + chunk_row0 + r) * kRankCols +
          (col / kGateUnits) * kUnitsPerRank + unit % kUnitsPerRank] = sum;
    }

    // At a chunk's end: both ranks' sums are in; rank r finishes units
    // [4 r, 4 r + 4) of the tile for the chunk's rows (ranks added in
    // order, the bias, the update).
    const int chunk_rows = chunk_row0 + rows;
    if (chunk_rows == kChunkRows || !more) {
      // The bias and the cell state load while the pair meets.
      const bool owner = threadIdx.x < chunk_rows * kUnitsPerRank;
      const int rr = threadIdx.x / kUnitsPerRank;
      const int uu = threadIdx.x % kUnitsPerRank;
      const int u = rank * kUnitsPerRank + uu;
      const size_t idx = (size_t)(r0 + rows - chunk_rows + rr) * H + j0 + u;
      float b4[4], c_old = 0.f;
      if (owner) {
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) b4[gi] = bias[gi * H + j0 + u];
        c_old = c[idx];
      }
      cluster_arrive();
      cluster_wait();
      if (owner) {
        float gate[4];
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) {
          float sum = 0.f;
#pragma unroll
          for (int q = 0; q < kGateCluster; ++q)
            sum += part[(q * kChunkRows + rr) * kRankCols +
                        gi * kUnitsPerRank + uu];
          gate[gi] = sum + b4[gi];
        }
        const float cn = sigmoidf_(gate[1]) * c_old +
                         sigmoidf_(gate[0]) * tanhf(gate[2]);
        c_out[idx] = cn;
        h_out[idx] = sigmoidf_(gate[3]) * tanhf(cn);
      }
      if (more) cluster_arrive();  // this rank is done with its sums
    }
  }
}

static cudaError_t prepare_gate(size_t smem_bytes) {
  static size_t opted = 0;
  return opt_in_shared((const void*)gate_kernel, smem_bytes, &opted);
}

static cudaLaunchConfig_t gate_config(int H, size_t smem_bytes,
                                      cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kGateCluster * (H / kGateUnits));
  cfg.blockDim = dim3(kGateThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  return cfg;
}

// ctx (B, H) is scratch the caller allocates.  attn_smem and gate_smem are
// the shared-memory sizes the wrapper's geometry computed; a disagreement
// with this file's layout is refused (cudaErrorInvalidValue).
extern "C" int decode_cell_forward(
    const float* x, const float* c, const float* h, const float* q,
    const float* pm, const float* mem, const float* v, const float* w,
    const float* bias, float* ctx, float* c_out, float* h_out, int B, int T,
    int E, int A, int H, int attn_smem, int gate_smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (E % 8 != 0 || H % 8 != 0 ||
      (size_t)gate_smem != gate_smem_bytes(E, H))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_gate((size_t)gate_smem);
  if (err != cudaSuccess) return (int)err;
  err = launch_attention(q, pm, mem, v, ctx, nullptr, B, T, A, H,
                         (size_t)attn_smem, st);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = gate_config(H, (size_t)gate_smem, st);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gate_kernel, x, (const float*)ctx, h, w,
                           bias, c, c_out, h_out, B, E, H,
                           gate_slice_rows(E, H));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many gate clusters the card can hold at once (all H / kGateUnits of
// them in one wave is the design's premise); -> CUDA error code.
extern "C" int decode_cell_gate_max_clusters(int E, int H, int* out) {
  const size_t smem = gate_smem_bytes(E, H);
  cudaError_t err = prepare_gate(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = gate_config(H, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out, gate_kernel, &cfg);
}
