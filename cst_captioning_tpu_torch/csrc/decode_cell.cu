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
//
// bfloat16 storage (the reference kernel under --use_bfloat16): one
// template, storage type S.  x, c, h, the attention operands, W and b are
// bfloat16 (v float32), the weight slice is 48 KB a block (6.3 MB in all)
// and a 16-byte copy carries 8 values: one copy is a whole 8-unit row of
// a gate plane, issued by the even lane of the pair that reads it (a
// __syncwarp makes it visible to the odd one), and each share of a K
// segment is a multiple of 8 rows (E, H multiples of 16).  The lanes read
// 4 bfloat16 values at a time and sum in float32 in the float32 kernel's
// order, but keep TWO sums, the h side and the input side (x, ctx): the
// reference rounds each product to bfloat16 on its own.  The update then
// rounds where the reference's ops round: each product, + b, gh + gi,
// each activation (the sigmoid as XLA's 1 / (1 + exp(-x)), three
// roundings), f*c, i*g, c', tanh(c'), h'.  The float32 instantiation is
// the float32 kernel op for op.  Its bound: 6.3 MB of weights, ~2 us at
// 3.35 TB/s for B <= 40; at the rollout's 1344 rows the bfloat16 product
// belongs on the tensor cores, which this CUDA-core loop leaves idle
// (PERF.md: 1.2 ms there, ROADMAP Queue 2).
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

// Sums a gate block keeps apart for each output: float32 one (the whole
// K product), bfloat16 two (part 0 the input side x, ctx; part 1 the h
// side), since the reference rounds each side's product on its own.
template <typename S>
__host__ __device__ constexpr int gate_parts() {
  return sizeof(S) == 2 ? 2 : 1;
}

// Rows of K in one share of a segment: whole warp steps of kGateSub rows
// and whole 16-byte copies.
template <typename S>
__host__ __device__ constexpr int gate_share_step() {
  return per_copy<S>() > kGateSub ? per_copy<S>() : kGateSub;
}

// Rank r's rows of K: [x_lo, x_lo + nx) of the x segment, [h_lo, h_lo +
// nh) of the h segment and of the ctx segment.  A block holds them as
// local rows: x rows, then h rows, then ctx rows.  With E and H multiples
// of kGateCluster * gate_share_step<S>() every share is whole 16-byte
// pieces and whole warp steps.
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

// Shared memory of a gate block: the warps' partial sums (per part,
// kGateWarps x kGateRows x kGateCols, float32), the weight slice (4 gate
// planes of n x kGateUnits, in S), two row groups' inputs (2 x kGateRows x
// n in S: one in use, one arriving) and the block sums the pair sends this
// rank (per part, kGateCluster x kChunkRows x kRankCols, float32).
template <typename S>
inline size_t gate_smem_bytes(int E, int H) {
  const size_t n = gate_slice_rows(E, H);
  return (size_t)gate_parts<S>() *
             (kGateWarps * kGateRows * kGateCols +
              kGateCluster * kChunkRows * kRankCols) *
             sizeof(float) +
         (n * kGateCols + 2 * kGateRows * n) * sizeof(S);
}

// Block-wide cp.async copies of `len` inputs of batch rows r0 .. r0 + rows
// (src row stride ld, from column src_lo) to local rows kb .. kb + len of
// xs[row][kk] (row stride n).  Not committed.  Rows of the group past the
// batch are left as they are: their sums are never stored.
template <typename S>
__device__ __forceinline__ void issue_inputs(
    S* xs, const S* __restrict__ src, int ld, int src_lo, int kb, int len,
    int r0, int rows, int n) {
  constexpr int kPer = per_copy<S>();
  const int chunks = len / kPer;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    cp_async16(xs + r * n + kb + kPer * c,
               src + (size_t)(r0 + r) * ld + src_lo + kPer * c);
  }
}

// All three inputs (x, h, ctx) of batch rows r0 .. r0 + rows into xs,
// committed as one group.
template <typename S>
__device__ __forceinline__ void issue_all_inputs(
    S* xs, const S* __restrict__ x, const S* __restrict__ h,
    const S* __restrict__ ctx, const GateSlice& s, int r0, int rows, int n,
    int E, int H) {
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

// Four consecutive weights of a gate-plane row as float32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
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

// Issue the cp.async copies of the weights this lane's pair reads in its
// steps of [ib, ie) — w rows w_lo + (local row - kk_lo) — into
// ws[gate][kk][unit], and commit them as one group.  float32: each lane
// copies the 4 units it reads; bfloat16: the even lane of a pair copies
// the row's 8 units, read by both.
template <typename S>
__device__ __forceinline__ void issue_weights(
    S* ws, const S* __restrict__ w, int n, int ib, int ie, int kk_lo,
    int w_lo, int lane, int H, int j0) {
  constexpr bool kPairCopy = per_copy<S>() == kGateUnits;
  const int g = lane >> 3;
  const int u4 = kPairCopy ? 0 : (lane & 1) * 4;
  const int sub = (lane >> 1) & 3;
  if (!kPairCopy || (lane & 1) == 0) {
    for (int i = first_step(ib); i < ie; i += kGateWarps) {
      const int kk = kGateSub * i + sub;
      cp_async16(ws + (g * n + kk) * kGateUnits + u4,
                 w + (size_t)(w_lo + kk - kk_lo) * 4 * H + g * H + j0 + u4);
    }
  }
  cp_async_commit();
}

// After a wait on this lane's own weight copies: in bfloat16 the pair's
// even lane copied them, so the warp meets first.
template <typename S>
__device__ __forceinline__ void pair_copies_visible() {
  if (per_copy<S>() == kGateUnits) __syncwarp();
}

// acc[row][unit] += xs[row][kk] * ws[gate][kk][unit] over this lane's rows
// of its steps in [ib, ie), for the first RP batch rows, in step order.
template <int RP, typename S>
__device__ __forceinline__ void fma_span(float (&acc)[kGateRows][4],
                                         const S* ws, const S* xs, int n,
                                         int ib, int ie, int lane) {
  const int i0 = first_step(ib);
  const S* wl = ws + (lane >> 3) * n * kGateUnits + (lane & 1) * 4;
  const int sub = (lane >> 1) & 3;
#pragma unroll 2
  for (int i = i0; i < ie; i += kGateWarps) {
    const int kk = kGateSub * i + sub;
    const float4 wv = load4(wl + kk * kGateUnits);
#pragma unroll
    for (int r = 0; r < RP; ++r) fma4(acc[r], load_f(xs[r * n + kk]), wv);
  }
}

// The same for a group of `rows` live rows: the narrowest span that holds
// them (each row's sum is the same chain whatever the span).
template <typename S>
__device__ __forceinline__ void fma_rows(float (&acc)[kGateRows][4],
                                         const S* ws, const S* xs, int n,
                                         int ib, int ie, int rows, int lane) {
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

// x rounded to bfloat16 and back: where a bfloat16 op of the reference
// rounds.
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// jax.nn.sigmoid in bfloat16 as XLA runs it: 1 / (1 + exp(-x)), each op
// rounded to bfloat16.
__device__ __forceinline__ float sigmoid_bf16(float x) {
  return rbf(1.f / rbf(1.f + rbf(expf(-x))));
}

// Grid: kGateCluster blocks for each of the H / kGateUnits column tiles.
// n_rows is gate_slice_rows(E, H) (the shared-memory layout's row count).
// Needs E and H multiples of kGateCluster * gate_share_step<S>() and
// 16-byte aligned x, h, w (the wrapper checks).
template <typename S>
__global__ void __cluster_dims__(kGateCluster, 1, 1)
    __launch_bounds__(kGateThreads, 1)
    gate_kernel(const S* __restrict__ x, const S* __restrict__ ctx,
                const S* __restrict__ h, const S* __restrict__ w,
                const S* __restrict__ bias, const S* __restrict__ c,
                S* __restrict__ c_out, S* __restrict__ h_out, int B, int E,
                int H, int n_rows) {
  namespace cg = cooperative_groups;
  constexpr int kParts = gate_parts<S>();
  constexpr int kHSide = kParts - 1;  // the part the h rows sum into
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float gate_smem[];
  float* red = gate_smem;                       // [part][warp][row][col]
  S* ws = reinterpret_cast<S*>(                 // [gate][kk][unit]
      red + kParts * kGateWarps * kGateRows * kGateCols);
  S* xbuf = ws + n_rows * kGateCols;            // 2 x [row][kk], stride n
  float* part = reinterpret_cast<float*>(       // [part][src rank][row][col]
      xbuf + 2 * kGateRows * n_rows);

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
    S* xs = xbuf + (grp & 1) * kGateRows * n;
    S* xs_next = xbuf + ((grp + 1) & 1) * kGateRows * n;
    const bool more = r0 + kGateRows < B;
    float acc[kParts][kGateRows][4];
#pragma unroll
    for (int p = 0; p < kParts; ++p)
#pragma unroll
      for (int r = 0; r < kGateRows; ++r)
        acc[p][r][0] = acc[p][r][1] = acc[p][r][2] = acc[p][r][3] = 0.f;

    if (grp == 0) {
      // The x and h rows run while the attention launch may still run.
      cp_async_wait<2>();  // the inputs and this lane's x weights
      __syncthreads();
      fma_rows(acc[0], ws, xs, n, 0, x_steps, rows, lane);
      cp_async_wait<1>();  // this lane's h weights
      pair_copies_visible<S>();
      fma_rows(acc[kHSide], ws, xs, n, x_steps, xh_steps, rows, lane);
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
      fma_rows(acc[0], ws, xs, n, xh_steps, n_steps, rows, lane);
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
      if (kParts == 1) {
        fma_rows(acc[0], ws, xs, n, 0, xh_steps, rows, lane);
      } else {
        fma_rows(acc[0], ws, xs, n, 0, x_steps, rows, lane);
        fma_rows(acc[kHSide], ws, xs, n, x_steps, xh_steps, rows, lane);
      }
      fma_rows(acc[0], ws, xs, n, xh_steps, n_steps, rows, lane);
    }
#pragma unroll
    for (int p = 0; p < kParts; ++p) sum_lanes_rows(acc[p], rows);

    // The warps' sums, added in warp order, go to the rank that owns their
    // units: part[part][this rank][row in chunk][gate * 4 + unit % 4] of
    // the owner's shared memory.
    if ((lane & 6) == 0) {
      const int col = (lane >> 3) * kGateUnits + (lane & 1) * 4;
#pragma unroll
      for (int p = 0; p < kParts; ++p)
#pragma unroll
        for (int r = 0; r < kGateRows; ++r)
          *reinterpret_cast<float4*>(
              red + ((p * kGateWarps + warp) * kGateRows + r) * kGateCols +
              col) = make_float4(acc[p][r][0], acc[p][r][1], acc[p][r][2],
                                 acc[p][r][3]);
    }
    __syncthreads();
    const int chunk_row0 = r0 % kChunkRows;
    if (chunk_row0 == 0 && r0 > 0) cluster_wait();  // the last chunk is read
    const int part_elems = rows * kGateCols;
    for (int e = threadIdx.x; e < kParts * part_elems; e += kGateThreads) {
      const int p = kParts == 1 ? 0 : e / part_elems;
      const int pe = e - p * part_elems;
      const float* rp = red + p * kGateWarps * kGateRows * kGateCols;
      float sum = rp[pe];
#pragma unroll
      for (int q = 1; q < kGateWarps; ++q)
        sum += rp[q * kGateRows * kGateCols + pe];
      const int r = pe / kGateCols;
      const int col = pe % kGateCols;            // gate * kGateUnits + unit
      const int unit = col % kGateUnits;
      float* dst = cluster.map_shared_rank(part, unit / kUnitsPerRank);
      dst[((p * kGateCluster + rank) * kChunkRows + chunk_row0 + r) *
              kRankCols +
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
        for (int gi = 0; gi < 4; ++gi) b4[gi] = load_f(bias[gi * H + j0 + u]);
        c_old = load_f(c[idx]);
      }
      cluster_arrive();
      cluster_wait();
      if (owner) {
        float gate[kParts][4];
#pragma unroll
        for (int p = 0; p < kParts; ++p)
#pragma unroll
          for (int gi = 0; gi < 4; ++gi) {
            float sum = 0.f;
#pragma unroll
            for (int q = 0; q < kGateCluster; ++q)
              sum += part[((p * kGateCluster + q) * kChunkRows + rr) *
                              kRankCols +
                          gi * kUnitsPerRank + uu];
            gate[p][gi] = kParts == 1 ? sum + b4[gi] : sum;
          }
        if (kParts == 1) {
          const float cn = sigmoidf_(gate[0][1]) * c_old +
                           sigmoidf_(gate[0][0]) * tanhf(gate[0][2]);
          c_out[idx] = store_as<S>(cn);
          h_out[idx] = store_as<S>(sigmoidf_(gate[0][3]) * tanhf(cn));
        } else {
          // gh = dot(h, W_h) + b, gi = dot([x, ctx], W_i), each rounded.
          float g[4];
#pragma unroll
          for (int gi = 0; gi < 4; ++gi)
            g[gi] = rbf(rbf(rbf(gate[kHSide][gi]) + b4[gi]) +
                        rbf(gate[0][gi]));
          const float ig = sigmoid_bf16(g[0]);
          const float fg = sigmoid_bf16(g[1]);
          const float gg = rbf(tanhf(g[2]));
          const float og = sigmoid_bf16(g[3]);
          const float cn = rbf(rbf(fg * c_old) + rbf(ig * gg));
          c_out[idx] = store_as<S>(cn);
          h_out[idx] = store_as<S>(og * rbf(tanhf(cn)));
        }
      }
      if (more) cluster_arrive();  // this rank is done with its sums
    }
  }
}

template <typename S>
static cudaError_t prepare_gate(size_t smem_bytes) {
  static size_t opted = 0;
  return opt_in_shared((const void*)gate_kernel<S>, smem_bytes, &opted);
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
template <typename S>
static int decode_cell_launch(const S* x, const S* c, const S* h, const S* q,
                              const S* pm, const S* mem, const float* v,
                              const S* w, const S* bias, S* ctx, S* c_out,
                              S* h_out, int B, int T, int E, int A, int H,
                              int attn_smem, int gate_smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  constexpr int kStep = kGateCluster * gate_share_step<S>();
  if (E % kStep != 0 || H % kStep != 0 ||
      (size_t)gate_smem != gate_smem_bytes<S>(E, H))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_gate<S>((size_t)gate_smem);
  if (err != cudaSuccess) return (int)err;
  err = launch_attention<S>(q, pm, mem, v, ctx, nullptr, B, T, A, H,
                            (size_t)attn_smem, st);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = gate_config(H, (size_t)gate_smem, st);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gate_kernel<S>, x, (const S*)ctx, h, w,
                           bias, c, c_out, h_out, B, E, H,
                           gate_slice_rows(E, H));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int decode_cell_forward(
    const float* x, const float* c, const float* h, const float* q,
    const float* pm, const float* mem, const float* v, const float* w,
    const float* bias, float* ctx, float* c_out, float* h_out, int B, int T,
    int E, int A, int H, int attn_smem, int gate_smem, void* stream) {
  return decode_cell_launch<float>(x, c, h, q, pm, mem, v, w, bias, ctx,
                                   c_out, h_out, B, T, E, A, H, attn_smem,
                                   gate_smem, stream);
}

extern "C" int decode_cell_forward_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* c, const __nv_bfloat16* h,
    const __nv_bfloat16* q, const __nv_bfloat16* pm,
    const __nv_bfloat16* mem, const float* v, const __nv_bfloat16* w,
    const __nv_bfloat16* bias, __nv_bfloat16* ctx, __nv_bfloat16* c_out,
    __nv_bfloat16* h_out, int B, int T, int E, int A, int H, int attn_smem,
    int gate_smem, void* stream) {
  return decode_cell_launch<__nv_bfloat16>(x, c, h, q, pm, mem, v, w, bias,
                                           ctx, c_out, h_out, B, T, E, A, H,
                                           attn_smem, gate_smem, stream);
}

// How many gate clusters the card can hold at once (all H / kGateUnits of
// them in one wave is the design's premise) for storage of elem_bytes (4
// float32, 2 bfloat16); -> CUDA error code.
template <typename S>
static int gate_max_clusters(int E, int H, int* out) {
  const size_t smem = gate_smem_bytes<S>(E, H);
  cudaError_t err = prepare_gate<S>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = gate_config(H, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out, gate_kernel<S>, &cfg);
}

extern "C" int decode_cell_gate_max_clusters(int E, int H, int elem_bytes,
                                             int* out) {
  if (elem_bytes == 2) return gate_max_clusters<__nv_bfloat16>(E, H, out);
  if (elem_bytes == 4) return gate_max_clusters<float>(E, H, out);
  return (int)cudaErrorInvalidValue;
}
