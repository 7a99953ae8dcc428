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
// Two launches: (a) attention_kernel (attention.cuh), a cluster of 4
// blocks per row writing only ctx (B, H) to a scratch buffer, and (b) one
// gate kernel, started early by programmatic dependent launch: it reads
// the h and x rows of K while the attention may still run and waits
// (griddepcontrol.wait) only before it reads ctx.  A gate kernel owns
// tiles of batch rows x U hidden units x all four gates (w's columns
// g * H + j0 .. + U for each gate g: four strips), streams K through
// shared memory in tiles of 32 rows with 16-byte cp.async copies and
// finishes the LSTM update of its units itself, so only c' and h' reach
// device memory.
//
// What bounds it on an H100 depends on B.  The gate weights are (E + 2H) x
// 4H: 12.6 MB in float32, 6.3 MB in bfloat16 at E = H = 512, so a serving
// step (B <= 40) is bound by reading them (~3.8 / ~1.9 us at 3.35 TB/s;
// back-to-back steps find them in the 50 MB L2, whose delivery to the SMs
// is the practical limit).  The CST rollout (B = 1344) does 8.5 GFLOP a
// step: operations bound, 126 us on the CUDA cores in float32, 8.5 us on
// the tensor cores in bfloat16.  The wrapper's gate_geometry picks, for
// (B, E, H, storage):
//
//   gate_kernel<S> (float32 and bfloat16, B <= 128): the weight stream.  A
//     cluster of 2 blocks (bfloat16: 4) covers 8 units (16) x 8 rows (16,
//     an m16 tile), so 128 blocks read every weight once a step in 32-byte
//     gate strips.  Rank r computes chunks r, r + 2, ... (r, r + 4) of the
//     summation tree (below), a group of 64 threads a chunk with 3 (4) of
//     its tiles in flight (float32: a thread per column and 4 rows, fmaf
//     chains; bfloat16: mma.sync, a warp per 8 units), and writes each
//     chunk sum through distributed shared memory to the rank that
//     finishes that unit (4 units a rank).  After one cluster barrier (the
//     bias and the cell state loaded while it runs) every rank adds its
//     outputs' 8 chunk sums in order and updates.
//   gate_tile_kernel<Rows> (float32, B > 128): 32 (B <= 640) or 64 rows x
//     32 units (128 columns) a block of 128 or 256 threads, each a
//     register tile of 4 rows x 2 units x 4
//     gates (rows, not K, across the lanes: an input value loaded from
//     shared memory feeds 8 products, a weight value 4), four tiles in
//     flight.  No TF32: the float32 contract forbids it.
//   gate_mma_kernel (bfloat16, B > 128): the tensor cores, mma.sync
//     m16n8k16 bf16 -> f32 fed by ldmatrix; 128 rows x 16 units a block of
//     8 warps, a warp 32 rows x 8 units x 4 gates (one n8 tile a gate), so
//     each thread ends with all four gates of its outputs in registers;
//     three tiles in flight.  The h side's running sums wait in shared
//     memory while the input side's stay in registers.
//
// One summation tree for every B.  K's tiles of kChunk = 32 rows (E and H
// multiples of 32) go in one order: the h rows, the x rows, the ctx rows.
// float32 sums them as one side of nt tiles; bfloat16 as two, the h side
// (nh tiles) and the input side (x then ctx), each rounded to bfloat16 on
// its own as the reference rounds them.  A side of n tiles is cut into c
// contiguous chunks (float32: c = 8; bfloat16: the h side gets round(8 nh
// / nt) of the 8, the input side the rest): chunk j holds tiles [n j / c,
// n (j + 1) / c).  A chunk's sum starts from zero and runs over its tiles
// in order: float32 an fmaf chain over the rows, bfloat16 mma.sync over
// the 16-row steps (a tensor-core product's row depends only on that
// row's operands).  A side's sum adds its non-empty chunks' sums in chunk
// order from zero with __fadd_rn.  Every kernel runs exactly these
// operations: the tile kernels over the tiles in order, adding a chunk's
// sums where it ends, the stream a chunk a group.  Nothing depends on B,
// on a row's index or on the rows it shares a tile with (rows past B are
// zero-filled and never stored), so a row's outputs have the same bits in
// every batch, in every kernel the wrapper may pick for it.
//
// The update rounds where the reference's ops round: float32 with the
// products and adds pinned (fmaf, __fmul_rn); bfloat16 at each side's sum,
// + b, gh + gi, each activation (the sigmoid as XLA's 1 / (1 + exp(-x)),
// three roundings), f*c, i*g, c', tanh(c'), h'.
#include "attention.cuh"

constexpr int kChunk = 32;            // rows of K a tile
constexpr int kTreeChunks = 8;        // chunks of the summation tree
// gate_kernel<S>: the weight stream.  A cluster of blocks a column tile
// (hidden units), a group of kStreamGroup threads a chunk of the tree;
// float32, then bfloat16.
constexpr int kStreamGroup = 64;
constexpr int kStreamUnitsF32 = 8;    // a gate strip of a row: 32 bytes
constexpr int kStreamClusterF32 = 2;
constexpr int kStreamRowsF32 = 8;
constexpr int kStreamSlotsF32 = 3;    // tiles in flight a group
constexpr int kStreamUnitsBf16 = 16;  // 32 bytes
constexpr int kStreamClusterBf16 = 4;
constexpr int kStreamRowsBf16 = 16;   // an m16 tile
constexpr int kStreamSlotsBf16 = 4;
// gate_tile_kernel<Rows> (float32, large B): 64 rows a block, or 32 for
// middling B (more blocks to fill the card).
constexpr int kTileRows = 64;
constexpr int kTileRowsMid = 32;
constexpr int kTileUnits = 32;
constexpr int kTileStages = 4;        // tiles in flight (64 rows)
constexpr int kTileStagesMid = 2;     // (32 rows: four blocks an SM)
constexpr int kTileMinBlocks = 2;     // blocks an SM the registers allow
constexpr int kTilePitch = 36;        // floats a row of a tile's inputs
// gate_mma_kernel (bfloat16, large B): warps over rows and over units, m16
// tiles a warp, tiles in flight.
constexpr int kMmaPad = 8;            // bf16 a shared-memory row is padded by
constexpr int kMmaWarpsM = 4;
constexpr int kMmaWarpsN = 2;
constexpr int kMmaMt = 2;
constexpr int kMmaStages = 3;

constexpr int kTileCols = 4 * kTileUnits;
// A thread per 4 rows x 2 units; floats a stage (a tile's inputs and
// weights).
template <int ROWS>
struct TileShape {
  static constexpr int kThreads = (ROWS / 4) * (kTileUnits / 2);
  static constexpr int kStages = ROWS == kTileRows ? kTileStages
                                                   : kTileStagesMid;
  static constexpr int kStage = ROWS * kTilePitch + kChunk * kTileCols;
};

static_assert(kTileUnits == 32, "16 threads a row group, 2 units each");
static_assert(kTilePitch % 4 == 0 && kTilePitch >= kChunk,
              "16-byte rows of a tile's inputs");

// Tile t of K's order (the h rows, the x rows, the ctx rows): its inputs
// (src, row stride ld, first column col), the first row of w it
// multiplies, and whether it is a ctx tile.
template <typename S>
struct KTile {
  const S* src;
  int ld, col, w_row;
  bool ctx;
};

template <typename S>
__device__ __forceinline__ KTile<S> k_tile(int t, const S* x, const S* h,
                                           const S* ctx, int E, int H) {
  const int nh = H / kChunk;
  const int nx = E / kChunk;
  if (t < nh) return {h, H, t * kChunk, E + H + t * kChunk, false};
  if (t < nh + nx) {
    t -= nh;
    return {x, E, t * kChunk, t * kChunk, false};
  }
  t -= nh + nx;
  return {ctx, H, t * kChunk, E + t * kChunk, true};
}

// The summation tree's sides: float32 one (every tile); bfloat16 the h side
// (tiles [0, nh)) and the input side (tiles [nh, nt)).  A side is n tiles
// from `first` cut into c contiguous chunks.
struct TreeSide {
  int first, n, c;
};

// bfloat16: the h side's share of the kTreeChunks chunks, round(8 nh / nt)
// within [1, 7].
__host__ __device__ __forceinline__ int tree_h_chunks(int nh, int nt) {
  const int c = (2 * kTreeChunks * nh + nt) / (2 * nt);
  return c < 1 ? 1 : (c > kTreeChunks - 1 ? kTreeChunks - 1 : c);
}

template <bool kBf16>
__host__ __device__ __forceinline__ TreeSide tree_side(int side, int E,
                                                       int H) {
  const int nh = H / kChunk;
  const int nt = (E + 2 * H) / kChunk;
  if (!kBf16) return {0, nt, kTreeChunks};
  const int ch = tree_h_chunks(nh, nt);
  return side == 0 ? TreeSide{0, nh, ch}
                   : TreeSide{nh, nt - nh, kTreeChunks - ch};
}

// The first tile (global index) of chunk j of a side: chunk j holds tiles
// [chunk_lo(s, j), chunk_lo(s, j + 1)), empty when n < c leaves it none.
__host__ __device__ __forceinline__ int chunk_lo(const TreeSide& s, int j) {
  return s.first + s.n * j / s.c;
}

// Walks a side's tiles in order and says which tile ends a (non-empty)
// chunk; a division only where a chunk ends.
struct ChunkWalk {
  TreeSide s;
  int j, end;  // end: the first chunk boundary past the tiles walked
  __device__ __forceinline__ explicit ChunkWalk(const TreeSide& side)
      : s(side), j(0), end(side.first) {
    pass(side.first);
  }
  __device__ __forceinline__ void pass(int t) {
    while (j < s.c && end <= t) end = chunk_lo(s, ++j);
  }
  // Tile t, the next of the side in order: does it end its chunk?
  __device__ __forceinline__ bool last(int t) {
    const bool l = t + 1 == end;
    if (l) pass(t + 1);
    return l;
  }
};

// 16-byte copy that writes zeros when !valid (a row past B): gmem must
// still be a valid address.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

// Rows [0, n_rows) of a tile's inputs into xs[row][kk] (row pitch pitch),
// rows at or past `rows` (past the batch) zero-filled, by `threads`
// threads.  Not committed.
template <typename S>
__device__ __forceinline__ void issue_inputs(S* xs, const KTile<S>& k,
                                             int r0, int rows, int n_rows,
                                             int pitch, int tid,
                                             int threads) {
  constexpr int kPer = per_copy<S>();
  constexpr int kCopies = kChunk / kPer;  // copies a row
  for (int q = tid; q < n_rows * kCopies; q += threads) {
    const int r = q / kCopies, p = q % kCopies;
    const bool live = r < rows;
    cp_async16_zfill(xs + r * pitch + kPer * p,
                     k.src + (size_t)(r0 + (live ? r : 0)) * k.ld + k.col +
                         kPer * p,
                     live);
  }
}

// A tile's weights for `units` units from unit j0: ws[kk][gate * units +
// unit] (row pitch pitch).  Not committed.
template <typename S>
__device__ __forceinline__ void issue_weights(S* ws, const S* __restrict__ w,
                                              const KTile<S>& k, int j0,
                                              int units, int pitch, int H,
                                              int tid, int threads) {
  constexpr int kPer = per_copy<S>();
  const int gate_copies = units / kPer;
  const int row_copies = 4 * gate_copies;
  for (int q = tid; q < kChunk * row_copies; q += threads) {
    const int kk = q / row_copies, rest = q % row_copies;
    const int g = rest / gate_copies, p = rest % gate_copies;
    cp_async16(ws + kk * pitch + g * units + kPer * p,
               w + (size_t)(k.w_row + kk) * 4 * H + g * H + j0 + kPer * p);
  }
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

// The float32 update from the gates (i, f, g, o; bias added).
__device__ __forceinline__ void lstm_f32(const float (&g)[4], float c_old,
                                         float* c_out, float* h_out) {
  const float cn = fmaf(sigmoidf_(g[1]), c_old,
                        __fmul_rn(sigmoidf_(g[0]), tanhf(g[2])));
  *c_out = cn;
  *h_out = __fmul_rn(sigmoidf_(g[3]), tanhf(cn));
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

// The bfloat16 update: gh = dot(h, W_h) + b, gi = dot([x, ctx], W_i), each
// rounded; then the reference's chain of roundings.
__device__ __forceinline__ void lstm_bf16(const float (&gin)[4],
                                          const float (&gh)[4],
                                          const float (&b)[4], float c_old,
                                          __nv_bfloat16* c_out,
                                          __nv_bfloat16* h_out) {
  float g[4];
#pragma unroll
  for (int gi = 0; gi < 4; ++gi)
    g[gi] = rbf(rbf(rbf(gh[gi]) + b[gi]) + rbf(gin[gi]));
  const float ig = sigmoid_bf16(g[0]);
  const float fg = sigmoid_bf16(g[1]);
  const float gg = rbf(tanhf(g[2]));
  const float og = sigmoid_bf16(g[3]);
  const float cn = rbf(rbf(fg * c_old) + rbf(ig * gg));
  *c_out = __float2bfloat16_rn(cn);
  *h_out = __float2bfloat16_rn(og * rbf(tanhf(cn)));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragments of one 16-row step for the 8 units at column `unit0` of
// each gate strip (strips `units` apart): bf[gate][0..1].
__device__ __forceinline__ void load_b_frags(uint32_t (&bf)[4][2],
                                             const __nv_bfloat16* ws,
                                             int pitch_w, int units,
                                             int unit0, int ks, int lane) {
#pragma unroll
  for (int gp = 0; gp < 4; gp += 2) {
    // Matrices: (k 0-7, gate gp), (k 8-15, gp), (k 0-7, gp + 1), (k 8-15,
    // gp + 1).
    uint32_t r[4];
    ldmatrix_x4_trans(r, ws + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  pitch_w +
                             (gp + (lane >> 4)) * units + unit0);
    bf[gp][0] = r[0];
    bf[gp][1] = r[1];
    bf[gp + 1][0] = r[2];
    bf[gp + 1][1] = r[3];
  }
}

// The A fragment of one 16-row step: rows row0 .. row0 + 16 of as.
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4],
                                            const __nv_bfloat16* as,
                                            int pitch_a, int row0, int ks,
                                            int lane) {
  ldmatrix_x4(a, as + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch_a +
                     ks + (lane >> 4) * 8);
}

// ---------------------------------------------------------------------------
// gate_kernel<S>: the weight stream, small B.  Grid (H / Units * Cluster,
// ceil(B / Rows)), clusters of Cluster blocks: rank r computes the tree's
// chunks r, r + Cluster, ..., one group of 64 threads a chunk.

template <typename S>
struct StreamShape {
  static constexpr bool kBf16 = sizeof(S) == 2;
  static constexpr int kUnits = kBf16 ? kStreamUnitsBf16 : kStreamUnitsF32;
  static constexpr int kCluster = kBf16 ? kStreamClusterBf16
                                        : kStreamClusterF32;
  static constexpr int kRows = kBf16 ? kStreamRowsBf16 : kStreamRowsF32;
  static constexpr int kSlots = kBf16 ? kStreamSlotsBf16 : kStreamSlotsF32;
  static constexpr int kGroups = kTreeChunks / kCluster;  // chunks a rank
  static constexpr int kThreads = kGroups * kStreamGroup;
  static constexpr int kCols = 4 * kUnits;
  static constexpr int kOwned = kUnits / kCluster;  // units a rank finishes
  static constexpr int kPartCols = 4 * kOwned;
  static constexpr int kPitchW = kBf16 ? kCols + kMmaPad : kCols;
  static constexpr int kPitchA = kBf16 ? kChunk + kMmaPad : kChunk;
  static constexpr int kSlot = kChunk * kPitchW + kRows * kPitchA;
  // float32: a thread per column and kRowsPer rows of a group's chunk;
  // bfloat16: a warp per 8 units.
  static constexpr int kRowsPer = kRows * kCols / kStreamGroup;
  static_assert((kSlot * sizeof(S)) % 16 == 0, "16-byte slots");
  static_assert(kOwned * kCluster == kUnits, "ranks share units evenly");
  static_assert(!kBf16 || (kRows == 16 && kUnits == 8 * (kStreamGroup / 32)),
                "bfloat16: one m16 tile, a warp per 8 units");
  static_assert(kBf16 || kRowsPer * kStreamGroup == kRows * kCols,
                "float32: whole rows a thread");
};

template <typename S>
inline size_t stream_smem_bytes() {
  using Sh = StreamShape<S>;
  return sizeof(S) * (size_t)Sh::kGroups * Sh::kSlots * Sh::kSlot +
         sizeof(float) * kTreeChunks * Sh::kRows * Sh::kPartCols;
}

// A barrier of one group's kStreamGroup threads (named barrier 1 + g).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "n"(kStreamGroup)
               : "memory");
}

// Wait until at most n of this thread's cp.async groups are in flight
// (n clamped to 7: waiting for more is still correct).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n < 7 ? n : 7) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

template <typename S>
__global__ void __launch_bounds__(StreamShape<S>::kThreads)
    gate_kernel(const S* __restrict__ x, const S* __restrict__ ctx,
                const S* __restrict__ h, const S* __restrict__ w,
                const S* __restrict__ bias, const S* __restrict__ c,
                S* __restrict__ c_out, S* __restrict__ h_out, int B, int E,
                int H) {
  using Sh = StreamShape<S>;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float gate_smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid / kStreamGroup;   // this thread's group: one chunk
  const int gt = tid % kStreamGroup;  // its index in the group
  S* slots = reinterpret_cast<S*>(gate_smem) + g * Sh::kSlots * Sh::kSlot;
  float* part = reinterpret_cast<float*>(  // [chunk][row][gate][owned unit]
      reinterpret_cast<S*>(gate_smem) + Sh::kGroups * Sh::kSlots * Sh::kSlot);
  const int rank = (int)cluster.block_rank();
  const int j0 = (blockIdx.x / Sh::kCluster) * Sh::kUnits;
  const int r0 = blockIdx.y * Sh::kRows;
  const int rows = min(Sh::kRows, B - r0);
  // The group's chunk q of the tree: chunk j of `side` (bfloat16: the h
  // side's chunks first).
  const int q = rank + Sh::kCluster * g;
  const TreeSide first = tree_side<Sh::kBf16>(0, E, H);
  const bool on_first = !Sh::kBf16 || q < first.c;
  const TreeSide side = on_first ? first : tree_side<Sh::kBf16>(1, E, H);
  const int j = on_first ? q : q - first.c;
  const int lo = chunk_lo(side, j);
  const int mine = chunk_lo(side, j + 1) - lo;
  cluster_arrive();  // this block runs: its peers may write to it

  auto tile_of = [&](int m) {
    return k_tile(lo + m, x, h, ctx, E, H);
  };
  auto slot_w = [&](int m) { return slots + (m % Sh::kSlots) * Sh::kSlot; };
  auto slot_x = [&](int m) { return slot_w(m) + kChunk * Sh::kPitchW; };
  bool ctx_ready = false;  // the attention launch is done (group-uniform)
  // Tile m of the chunk into slot m % Slots; a ctx tile's inputs wait for
  // the attention.  Not committed.
  auto issue = [&](int m) {
    const KTile<S> k = tile_of(m);
    issue_weights(slot_w(m), w, k, j0, Sh::kUnits, Sh::kPitchW, H, gt,
                  kStreamGroup);
    if (!k.ctx || ctx_ready)
      issue_inputs(slot_x(m), k, r0, rows, Sh::kRows, Sh::kPitchA, gt,
                   kStreamGroup);
  };

  for (int m = 0; m < min(mine, Sh::kSlots); ++m) {
    issue(m);
    cp_async_commit();
  }
  // The chunk's sums, from zero, over its tiles in order: float32 a thread
  // per column and kRowsPer rows (accf[row]); bfloat16 warp gt / 32's 8
  // units, all four gates (accb[gate][fragment]).
  const int col = gt % Sh::kCols;
  const int rq = (gt / Sh::kCols) * Sh::kRowsPer;
  float accf[Sh::kBf16 ? 1 : Sh::kRowsPer], accb[4][4];
#pragma unroll
  for (int r = 0; r < (Sh::kBf16 ? 1 : Sh::kRowsPer); ++r) accf[r] = 0.f;
#pragma unroll
  for (int gi = 0; gi < 4; ++gi)
    accb[gi][0] = accb[gi][1] = accb[gi][2] = accb[gi][3] = 0.f;
  for (int m = 0; m < mine; ++m) {
    const int issued = min(mine, m + Sh::kSlots);  // tiles issued so far
    if (tile_of(m).ctx && !ctx_ready) {
      // The first ctx tile: the weights of this and the later issued
      // tiles are in flight; their inputs come from the attention launch.
      griddep_wait();
      ctx_ready = true;
      for (int n = m; n < issued; ++n)
        issue_inputs(slot_x(n), tile_of(n), r0, rows, Sh::kRows, Sh::kPitchA,
                     gt, kStreamGroup);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      cp_async_wait_n(issued - m - 1);  // tile m
    }
    group_sync(g);
    if constexpr (!Sh::kBf16) {
      const float* ws = slot_w(m);
      const float* xs = slot_x(m);
#pragma unroll 2
      for (int kk = 0; kk < kChunk; kk += 4) {
        float wv[4];
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) wv[qq] = ws[(kk + qq) * Sh::kPitchW + col];
#pragma unroll
        for (int r = 0; r < Sh::kRowsPer; ++r) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + (rq + r) * kChunk + kk);
          accf[r] = fmaf(xv.x, wv[0], accf[r]);
          accf[r] = fmaf(xv.y, wv[1], accf[r]);
          accf[r] = fmaf(xv.z, wv[2], accf[r]);
          accf[r] = fmaf(xv.w, wv[3], accf[r]);
        }
      }
    } else {
      const __nv_bfloat16* ws = slot_w(m);
      const __nv_bfloat16* xs = slot_x(m);
#pragma unroll
      for (int ks = 0; ks < kChunk; ks += 16) {
        uint32_t bf[4][2], a[4];
        load_b_frags(bf, ws, Sh::kPitchW, Sh::kUnits, (gt / 32) * 8, ks, lane);
        load_a_frag(a, xs, Sh::kPitchA, 0, ks, lane);
#pragma unroll
        for (int gi = 0; gi < 4; ++gi)
          mma_bf16(accb[gi], a, bf[gi][0], bf[gi][1]);
      }
    }
    group_sync(g);  // the slot is read: refill it
    if (m + Sh::kSlots < mine) {
      issue(m + Sh::kSlots);
      cp_async_commit();
    }
  }

  // The update's threads (row, owned unit) load the bias and the cell
  // state while the cluster meets.
  const bool owner = tid < Sh::kRows * Sh::kOwned;
  const int ur = tid / Sh::kOwned, uo = tid % Sh::kOwned;
  const int jj = j0 + rank * Sh::kOwned + uo;
  const size_t idx = (size_t)(r0 + ur) * H + jj;
  const bool live = owner && ur < rows;
  float b[4], c_old = 0.f;
#pragma unroll
  for (int gi = 0; gi < 4; ++gi) b[gi] = live ? load_f(bias[gi * H + jj]) : 0.f;
  if (live) c_old = load_f(c[idx]);

  cluster_wait();  // every peer runs
  if (mine > 0) {
    // The chunk's sums to the ranks that finish their units.
    if constexpr (!Sh::kBf16) {
      const int gi = col / Sh::kUnits, u = col % Sh::kUnits;
      float* dst = cluster.map_shared_rank(part, u / Sh::kOwned);
#pragma unroll
      for (int r = 0; r < Sh::kRowsPer; ++r)
        dst[(q * Sh::kRows + rq + r) * Sh::kPartCols + gi * Sh::kOwned +
            u % Sh::kOwned] = accf[r];
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int unit = (gt / 32) * 8 + 2 * (lane & 3) + u;
        float* dst = cluster.map_shared_rank(part, unit / Sh::kOwned);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int gi = 0; gi < 4; ++gi)
            dst[(q * Sh::kRows + (lane >> 2) + 8 * half) * Sh::kPartCols +
                gi * Sh::kOwned + unit % Sh::kOwned] = accb[gi][2 * half + u];
      }
    }
  }
  cluster_arrive();
  cluster_wait();  // every chunk sum is in its owner's shared memory

  // The update: each side's non-empty chunk sums in chunk order.
  if (live) {
    const float* pr = part + ur * Sh::kPartCols + uo;
    constexpr int kStride = Sh::kRows * Sh::kPartCols;  // a chunk's sums
    float sums[2][4];  // the first side's, the second's (bfloat16)
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) sums[0][gi] = sums[1][gi] = 0.f;
    for (int qq = 0; qq < first.c; ++qq) {
      if (chunk_lo(first, qq + 1) == chunk_lo(first, qq)) continue;
#pragma unroll
      for (int gi = 0; gi < 4; ++gi)
        sums[0][gi] =
            __fadd_rn(sums[0][gi], pr[qq * kStride + gi * Sh::kOwned]);
    }
    if constexpr (!Sh::kBf16) {
      float gs[4];
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) gs[gi] = __fadd_rn(sums[0][gi], b[gi]);
      lstm_f32(gs, c_old, c_out + idx, h_out + idx);
    } else {
      const TreeSide second = tree_side<true>(1, E, H);
      for (int qq = first.c; qq < kTreeChunks; ++qq) {
        if (chunk_lo(second, qq - first.c + 1) ==
            chunk_lo(second, qq - first.c))
          continue;
#pragma unroll
        for (int gi = 0; gi < 4; ++gi)
          sums[1][gi] =
              __fadd_rn(sums[1][gi], pr[qq * kStride + gi * Sh::kOwned]);
      }
      lstm_bf16(sums[1], sums[0], b, c_old, c_out + idx, h_out + idx);
    }
  }
}

// ---------------------------------------------------------------------------
// gate_tile_kernel<Rows>: float32, large B.  Grid (H / kTileUnits,
// ceil(B / Rows)), TileShape<Rows>::kThreads threads.

template <int ROWS>
inline size_t tile_smem_bytes() {
  return sizeof(float) * (size_t)TileShape<ROWS>::kStages *
         TileShape<ROWS>::kStage;
}

template <int ROWS>
__global__ void __launch_bounds__(TileShape<ROWS>::kThreads, kTileMinBlocks)
    gate_tile_kernel(const float* __restrict__ x,
                     const float* __restrict__ ctx,
                     const float* __restrict__ h, const float* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ c, float* __restrict__ c_out,
                     float* __restrict__ h_out, int B, int E, int H) {
  using Sh = TileShape<ROWS>;
  extern __shared__ __align__(16) float gate_smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int j0 = blockIdx.x * kTileUnits;
  const int r0 = blockIdx.y * ROWS;
  const int rows = min(ROWS, B - r0);
  const TreeSide side = tree_side<false>(0, E, H);
  const int tc = lane & 15;                     // units 2 tc, 2 tc + 1
  const int tr = (tid >> 5) * 2 + (lane >> 4);  // rows 4 tr .. 4 tr + 3

  // Tile p into stage p % Stages: the inputs
  // xs[row][kk] (row pitch kTilePitch), the weights ws[kk][gate *
  // kTileUnits + unit].
  auto issue = [&](int p) {
    const KTile<float> k = k_tile(p, x, h, ctx, E, H);
    if (k.ctx) griddep_wait();  // ctx comes from the attention launch
    float* xs = gate_smem + (p % Sh::kStages) * Sh::kStage;
    issue_inputs(xs, k, r0, rows, ROWS, kTilePitch, tid, Sh::kThreads);
    issue_weights(xs + ROWS * kTilePitch, w, k, j0, kTileUnits, kTileCols,
                  H, tid, Sh::kThreads);
  };

  float total[4][2][4], acc[4][2][4];  // [row][unit][gate]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int g = 0; g < 4; ++g) total[i][u][g] = acc[i][u][g] = 0.f;

  ChunkWalk walk(side);
  for (int s = 0; s < Sh::kStages - 1; ++s) {
    if (s < side.n) issue(s);
    cp_async_commit();
  }
  for (int p = 0; p < side.n; ++p) {
    cp_async_wait<Sh::kStages - 2>();  // tile p
    __syncthreads();                   // and every thread is past p - 1
    if (p + Sh::kStages - 1 < side.n) issue(p + Sh::kStages - 1);
    cp_async_commit();
    const float* xs = gate_smem + (p % Sh::kStages) * Sh::kStage;
    const float* ws = xs + ROWS * kTilePitch;
#pragma unroll 2
    for (int kk = 0; kk < kChunk; kk += 4) {
      float4 xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xv[i] = *reinterpret_cast<const float4*>(
            xs + (4 * tr + i) * kTilePitch + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float2 wv[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          wv[g] = *reinterpret_cast<const float2*>(
              ws + (kk + q) * kTileCols + g * kTileUnits + 2 * tc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xq = q == 0   ? xv[i].x
                           : q == 1 ? xv[i].y
                           : q == 2 ? xv[i].z
                                    : xv[i].w;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            acc[i][0][g] = fmaf(xq, wv[g].x, acc[i][0][g]);
            acc[i][1][g] = fmaf(xq, wv[g].y, acc[i][1][g]);
          }
        }
      }
    }
    if (walk.last(p)) {  // the chunk's sums into the running sums, from zero
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            total[i][u][g] = __fadd_rn(total[i][u][g], acc[i][u][g]);
            acc[i][u][g] = 0.f;
          }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * tr + i;
    if (r >= rows) continue;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + 2 * tc + u;
      float g[4];
#pragma unroll
      for (int gi = 0; gi < 4; ++gi)
        g[gi] = __fadd_rn(total[i][u][gi], bias[gi * H + j]);
      const size_t idx = (size_t)(r0 + r) * H + j;
      lstm_f32(g, c[idx], c_out + idx, h_out + idx);
    }
  }
}

// ---------------------------------------------------------------------------
// gate_mma_kernel: bfloat16, large B, the tensor cores.  Grid (H / Units,
// ceil(B / Rows)), 32 * WM * WN threads.

template <int WM, int WN, int MT, int STAGES>
struct MmaShape {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kRows = 16 * MT * WM;     // batch rows a block
  static constexpr int kUnits = 8 * WN;          // hidden units a block
  static constexpr int kCols = 4 * kUnits;
  static constexpr int kPitchA = kChunk + kMmaPad;  // bf16 a row of inputs
  static constexpr int kPitchW = kCols + kMmaPad;   // bf16 a row of weights
  static constexpr int kStage = kRows * kPitchA + kChunk * kPitchW;
  static constexpr int kOut = MT * 4 * 4;  // a thread's fragment values
  // The stages (bf16), then the h side's running sums (float32,
  // [value][thread]).
  static constexpr size_t kSmem =
      2 * (size_t)STAGES * kStage + 4 * (size_t)kOut * kThreads;
  static_assert((kPitchA * 2) % 16 == 0 && (kPitchW * 2) % 16 == 0 &&
                    (kStage * 2) % 16 == 0,
                "16-byte rows and stages");
};

using MmaTile = MmaShape<kMmaWarpsM, kMmaWarpsN, kMmaMt, kMmaStages>;

template <int WM, int WN, int MT, int STAGES>
__global__ void __launch_bounds__(32 * WM * WN, 2)
    gate_mma_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ ctx,
                    const __nv_bfloat16* __restrict__ h,
                    const __nv_bfloat16* __restrict__ w,
                    const __nv_bfloat16* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ c,
                    __nv_bfloat16* __restrict__ c_out,
                    __nv_bfloat16* __restrict__ h_out, int B, int E, int H) {
  using Sh = MmaShape<WM, WN, MT, STAGES>;
  extern __shared__ __align__(16) float gate_smem[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(gate_smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int j0 = blockIdx.x * Sh::kUnits;
  const int r0 = blockIdx.y * Sh::kRows;
  const int rows = min(Sh::kRows, B - r0);
  const TreeSide hs = tree_side<true>(0, E, H);  // the h side
  const TreeSide is = tree_side<true>(1, E, H);  // the input side
  const int n = hs.n + is.n;
  const int wrow = wm * 16 * MT;  // the warp's first row of the tile
  // The h side's running sums: tot_h[(mt * 4 + gate) * 4 + e][thread].
  float* tot_h = reinterpret_cast<float*>(smem + STAGES * Sh::kStage);
  for (int o = 0; o < Sh::kOut; ++o) tot_h[o * Sh::kThreads + tid] = 0.f;

  // Tile p into stage p % STAGES: the inputs as[row][kk] and the weights
  // ws[kk][gate * Units + unit], each row padded by kMmaPad.
  auto issue = [&](int p) {
    const KTile<__nv_bfloat16> k = k_tile(p, x, h, ctx, E, H);
    if (k.ctx) griddep_wait();  // ctx comes from the attention launch
    __nv_bfloat16* as = smem + (p % STAGES) * Sh::kStage;
    issue_inputs(as, k, r0, rows, Sh::kRows, Sh::kPitchA, tid, Sh::kThreads);
    issue_weights(as + Sh::kRows * Sh::kPitchA, w, k, j0, Sh::kUnits,
                  Sh::kPitchW, H, tid, Sh::kThreads);
  };

  float acc[MT][4][4];  // the current chunk's sums, from zero
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      acc[mt][g][0] = acc[mt][g][1] = acc[mt][g][2] = acc[mt][g][3] = 0.f;

  float tot_in[MT][4][4];  // the input side's running sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      tot_in[mt][g][0] = tot_in[mt][g][1] = tot_in[mt][g][2] =
          tot_in[mt][g][3] = 0.f;

  // One tile: the pipeline step, this warp's products into acc, and at a
  // chunk's end acc into its side's running sums.
  auto run = [&](int p, ChunkWalk& walk, bool h_side) {
    cp_async_wait<STAGES - 2>();  // position p
    __syncthreads();              // and every thread is past p - 1
    if (p + STAGES - 1 < n) issue(p + STAGES - 1);
    cp_async_commit();
    if (wrow >= rows) return;  // warp-uniform: every row past B
    const __nv_bfloat16* as = smem + (p % STAGES) * Sh::kStage;
    const __nv_bfloat16* ws = as + Sh::kRows * Sh::kPitchA;
#pragma unroll
    for (int ks = 0; ks < kChunk; ks += 16) {
      uint32_t bf[4][2];
      load_b_frags(bf, ws, Sh::kPitchW, Sh::kUnits, wn * 8, ks, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (wrow + 16 * mt >= rows) break;  // warp-uniform
        uint32_t a[4];
        load_a_frag(a, as, Sh::kPitchA, wrow + 16 * mt, ks, lane);
#pragma unroll
        for (int g = 0; g < 4; ++g)
          mma_bf16(acc[mt][g], a, bf[g][0], bf[g][1]);
      }
    }
    if (walk.last(p)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (h_side) {
              float* t = tot_h + ((mt * 4 + g) * 4 + e) * Sh::kThreads + tid;
              *t = __fadd_rn(*t, acc[mt][g][e]);
            } else {
              tot_in[mt][g][e] = __fadd_rn(tot_in[mt][g][e], acc[mt][g][e]);
            }
            acc[mt][g][e] = 0.f;
          }
    }
  };

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) issue(s);
    cp_async_commit();
  }
  ChunkWalk h_walk(hs), in_walk(is);
  for (int p = 0; p < hs.n; ++p) run(p, h_walk, true);
  for (int p = hs.n; p < n; ++p) run(p, in_walk, false);

  // A thread holds rows lane / 4 and lane / 4 + 8 of each m16 tile, units
  // 2 (lane % 4) and + 1 of the warp's 8, all four gates.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wrow + 16 * mt + (lane >> 2) + 8 * half;
      if (r >= rows) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + wn * 8 + 2 * (lane & 3) + u;
        float gin[4], gh[4], b[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          gin[g] = tot_in[mt][g][2 * half + u];
          gh[g] = tot_h[((mt * 4 + g) * 4 + 2 * half + u) * Sh::kThreads +
                        tid];
          b[g] = __bfloat162float(bias[g * H + j]);
        }
        const size_t idx = (size_t)(r0 + r) * H + j;
        lstm_bf16(gin, gh, b, __bfloat162float(c[idx]), c_out + idx,
                  h_out + idx);
      }
    }
}

// ---------------------------------------------------------------------------
// Launching.  The wrapper's gate_geometry picks the variant: 0 =
// gate_kernel<S> (the stream), 1 = gate_tile_kernel<64> (float32) or
// gate_mma_kernel (bfloat16), 2 = gate_tile_kernel<32> (float32).

struct GateLaunch {
  const void* kernel;
  int units, rows, threads, cluster;
  size_t smem;
};

template <typename S>
static bool gate_launch_shape(int variant, int E, int H, GateLaunch* out);

template <>
bool gate_launch_shape<float>(int variant, int, int, GateLaunch* out) {
  if (variant == 0) {
    using Sh = StreamShape<float>;
    *out = {(const void*)gate_kernel<float>, Sh::kUnits, Sh::kRows,
            Sh::kThreads, Sh::kCluster, stream_smem_bytes<float>()};
    return true;
  }
  if (variant == 1) {
    *out = {(const void*)gate_tile_kernel<kTileRows>, kTileUnits,
            kTileRows, TileShape<kTileRows>::kThreads, 1,
            tile_smem_bytes<kTileRows>()};
    return true;
  }
  if (variant == 2) {
    *out = {(const void*)gate_tile_kernel<kTileRowsMid>, kTileUnits,
            kTileRowsMid, TileShape<kTileRowsMid>::kThreads, 1,
            tile_smem_bytes<kTileRowsMid>()};
    return true;
  }
  return false;
}

template <>
bool gate_launch_shape<__nv_bfloat16>(int variant, int, int,
                                      GateLaunch* out) {
  if (variant == 0) {
    using Sh = StreamShape<__nv_bfloat16>;
    *out = {(const void*)gate_kernel<__nv_bfloat16>, Sh::kUnits, Sh::kRows,
            Sh::kThreads, Sh::kCluster, stream_smem_bytes<__nv_bfloat16>()};
    return true;
  }
  if (variant == 1) {
    *out = {(const void*)gate_mma_kernel<kMmaWarpsM, kMmaWarpsN, kMmaMt,
                                         kMmaStages>,
            MmaTile::kUnits, MmaTile::kRows, MmaTile::kThreads, 1,
            MmaTile::kSmem};
    return true;
  }
  return false;
}

// Let a gate kernel take `bytes` of dynamic shared memory (once per kernel
// and size).
static cudaError_t prepare_gate(const void* kernel, size_t bytes) {
  static std::mutex mu;
  static const void* kernels[8] = {};
  static size_t opted[8] = {};
  std::lock_guard<std::mutex> lock(mu);
  int i = 0;
  while (i < 8 && kernels[i] != nullptr && kernels[i] != kernel) ++i;
  if (i == 8) return cudaErrorInvalidValue;
  kernels[i] = kernel;
  size_t granted = opted[i];
  const cudaError_t err = opt_in_shared(kernel, bytes, &granted);
  opted[i] = granted;
  return err;
}

// The launch configuration of gate kernel g for B rows at width H: its
// grid, its cluster (the stream's) and, with pdl, programmatic dependent
// launch on the attention launch before it.  attr holds the attributes.
static cudaLaunchConfig_t gate_config(const GateLaunch& g, int B, int H,
                                      cudaStream_t st, bool pdl,
                                      cudaLaunchAttribute (&attr)[2]) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H / g.units * g.cluster, (B + g.rows - 1) / g.rows);
  cfg.blockDim = dim3(g.threads);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = st;
  int n = 0;
  if (g.cluster > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = g.cluster;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  if (pdl) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return cfg;
}

// ctx (B, H) is scratch the caller allocates.  attn_smem, gate_variant and
// gate_smem are what the wrapper's geometry computed; a variant that does
// not exist or a shared-memory size that disagrees with this file's layout
// is refused (cudaErrorInvalidValue).
template <typename S>
static int decode_cell_launch(const S* x, const S* c, const S* h, const S* q,
                              const S* pm, const S* mem, const float* v,
                              const S* w, const S* bias, S* ctx, S* c_out,
                              S* h_out, int B, int T, int E, int A, int H,
                              int attn_smem, int gate_variant, int gate_smem,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  GateLaunch g;
  if (E % kChunk != 0 || H % kChunk != 0 ||
      !gate_launch_shape<S>(gate_variant, E, H, &g) ||
      (size_t)gate_smem != g.smem || H % g.units != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_gate(g.kernel, g.smem);
  if (err != cudaSuccess) return (int)err;
  err = launch_attention<S>(q, pm, mem, v, ctx, nullptr, B, T, A, H,
                            (size_t)attn_smem, st);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = gate_config(g, B, H, st, true, attr);
  const S* ctx_in = ctx;
  void* args[] = {(void*)&x,    (void*)&ctx_in, (void*)&h,     (void*)&w,
                  (void*)&bias, (void*)&c,      (void*)&c_out, (void*)&h_out,
                  (void*)&B,    (void*)&E,      (void*)&H};
  err = cudaLaunchKernelExC(&cfg, g.kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int decode_cell_forward(
    const float* x, const float* c, const float* h, const float* q,
    const float* pm, const float* mem, const float* v, const float* w,
    const float* bias, float* ctx, float* c_out, float* h_out, int B, int T,
    int E, int A, int H, int attn_smem, int gate_variant, int gate_smem,
    void* stream) {
  return decode_cell_launch<float>(x, c, h, q, pm, mem, v, w, bias, ctx,
                                   c_out, h_out, B, T, E, A, H, attn_smem,
                                   gate_variant, gate_smem, stream);
}

extern "C" int decode_cell_forward_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* c, const __nv_bfloat16* h,
    const __nv_bfloat16* q, const __nv_bfloat16* pm,
    const __nv_bfloat16* mem, const float* v, const __nv_bfloat16* w,
    const __nv_bfloat16* bias, __nv_bfloat16* ctx, __nv_bfloat16* c_out,
    __nv_bfloat16* h_out, int B, int T, int E, int A, int H, int attn_smem,
    int gate_variant, int gate_smem, void* stream) {
  return decode_cell_launch<__nv_bfloat16>(
      x, c, h, q, pm, mem, v, w, bias, ctx, c_out, h_out, B, T, E, A, H,
      attn_smem, gate_variant, gate_smem, stream);
}

// How many clusters of gate variant `variant` (the stream, 0) the card
// holds at once, for storage of elem_bytes (4 float32, 2 bfloat16) at
// widths E, H; -> CUDA error code.
extern "C" int decode_cell_gate_max_clusters(int E, int H, int elem_bytes,
                                             int variant, int* out) {
  GateLaunch g;
  const bool ok = elem_bytes == 4
                      ? gate_launch_shape<float>(variant, E, H, &g)
                      : elem_bytes == 2 && gate_launch_shape<__nv_bfloat16>(
                                               variant, E, H, &g);
  if (!ok || g.cluster == 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_gate(g.kernel, g.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = gate_config(g, 8, H, nullptr, false, attr);
  return (int)cudaOccupancyMaxActiveClusters(out, g.kernel, &cfg);
}
