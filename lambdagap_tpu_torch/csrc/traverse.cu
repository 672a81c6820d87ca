// Compiled-forest prediction for Hopper (sm_90a): one serve dispatch is ONE
// launch of `predict_kernel` (K3's walk with the forest-order accumulation
// fused into its epilogue). K3 alone (`traverse_kernel`) serves pred_leaf;
// the accumulation alone (`accumulate_kernel`) stays as the public
// function over a carry and as the yardstick of the two-launch dispatch.
//
// K3 replaces lambdagap_tpu/infer/engine.py `_traverse_kernel` (:68-119),
// the Pallas kernel that `_traverse_block` launches once per node block and
// `_traverse_all` runs over every block of a compiled artifact. For every
// row r and every structure group g the node carry starts at the group's
// root and steps through the group's nodes until it reaches a leaf; each
// step applies the reference's decision rules (NaN -> 0 unless the node is
// NaN-missing; missing values follow default-left; a categorical value goes
// left iff its bit is set). The result is `~leaf` for each (row, group),
// written group-major: out[g * rows + r], int32.
//
// The accumulation (A) replaces the XLA work around that kernel in the
// same file: `_leaf_values` (:159) and the `lax.scan` of `_accumulate`
// (:181-219). Tree t's leaf value leaf_value[t * L + ~carry[r, g(t)]] is
// added into out[tree_class[t] * rows + r] in forest order, one f32 add
// per tree, with the early-stop replay: after tree i with (i + 1) % freq
// == 0 a row stops when its margin (2|score| for one class, top-1 minus
// top-2 for more) exceeds the margin; a stopped row still adds, +0.0.
//
// What bounds them on this card. Bytes would allow K3 ~0.003 ms at 4,096
// rows x 500 groups (the rows, the artifact's node tables and the carry
// once: 10 MB), but each decision step is a scattered 16-byte load: the
// lanes of a warp sit at different nodes after the first levels, so a
// load costs about one L1 wavefront per lane, and the SMs' L1 wavefront
// rate bounds the walk (12.5 M steps / 132 SMs ~ 48 us at ~2 GHz; PERF.md
// section 6). At a few rows the walk is bound by latency instead: every
// step waits on L2. A alone must read the carry and the leaf table once
// and write the scores (8.7 MB, ~0.003 ms), but was bound by latency: its
// dependent gathers (group id -> carry -> leaf value), a row's serial add
// chain, and, around it, a second launch and the carry's round trip
// through memory.
//
// What the design does about it:
//  - K3's nodes are 16-byte records, re-laid at upload so each group's
//    nodes are contiguous (lambdagap_tpu_torch/infer/engine.py
//    `node_records`): the f32 threshold (decoded from the palette; a
//    categorical node's bitset row instead), feature << 4 | flags, left,
//    right. One aligned 16-byte load per step replaces six narrow gathers
//    and the dependent palette read;
//  - the grid is (row tile) x (group tile): a block takes kBlockGroups
//    groups, so each record it reads serves its rows from L1. The records
//    are not staged in shared memory: that saved ~3 us of device time at a
//    few rows and nothing in a dispatch's wall (PERF.md section 6). The
//    block stages its rows' features (row stride odd, so lanes reading one
//    feature of different rows hit different banks);
//  - the lanes of a warp take different rows of ONE group, so the first
//    steps broadcast one root record; each thread walks kRowsPerThread rows
//    as independent chains, their loads in flight together; the numeric
//    decision has no branches;
//  - K3 alone writes the carry group-major, so a warp's stores (and A
//    alone's loads) are 128-byte coalesced; A alone gives a row to one
//    lane of warp 0 of its block, which adds into it in forest order
//    while the other warps gather the next chunk of leaf values;
//  - the fused kernel's epilogue turns each finished (row, group) into
//    its trees' leaf values at once (the group's trees from a CSR built at
//    upload, `group_tree_lo` / `group_tree`) and stores them into a
//    [trees, rows rounded up to 32] workspace, a warp's stores 128-byte
//    coalesced; the carry never goes to memory;
//  - a row tile's walk blocks arrive on a counter (threadfence, then one
//    atomicAdd); 8 accumulation blocks of 32 rows, which draw their
//    tickets after every walk block has drawn its own, wait for their
//    tile's count and add its rows over every tree in forest order,
//    reading the workspace through L2 (__ldcg: a line another block wrote
//    is never read from a stale L1). All 8 warps stage chunks of it into
//    shared memory, the next chunk's loads in flight in registers, while
//    a lane of warp 0 per row adds the current one in batches without a
//    branch, so only the adds form a chain. The order of the sum is the
//    forest's whichever block runs when: the scores are the scan oracle's
//    bits on every run. The last accumulation block of a tile resets its
//    counters and the last block to draw a ticket the ticket, so the
//    counters (zeroed once at allocation) need no clearing launch;
//  - one class's score lives in a register; more classes' scores live in
//    shared memory;
//  - built WITHOUT --use_fast_math, so the NaN test and the |v| <= 1e-35
//    zero-missing test survive compilation; float -> int uses
//    __float2int_rz, which saturates like XLA's convert (1e10 -> INT_MAX).
//
// The packed mode of the fused kernel replaces the JAX package's
// `_predict_packed` (lambdagap_tpu/infer/engine.py:241-266): many models'
// forests merged into one set of tables (`pack_buffers` in engine.py) and
// one mixed batch, each row of one member (row_model[r]) and each
// structure group of one member (group_model[g]). The JAX package walks
// every (row, group) and masks the foreign trees' leaf values to +0.0
// before one forest-order scan; here a (row, group) of two members does
// not walk at all: its carry is set to 0 (not ~leaf), so the epilogue
// writes +0.0 for each of the group's trees, every workspace row is still
// written, and the accumulation adds in forest order as before. The running
// sums start at +0.0, so those adds are exact: a row's scores are its
// member's served alone, bit for bit. The test is per (row, group), since a
// block's 8 groups and 256 rows may straddle members. A warp whose rows all
// belong elsewhere skips the walk (no live chain), paying only the stores.
// Null maps give the unpacked launch, unchanged.
//
// The linear mode of the fused kernel (piece-wise linear leaves,
// linear_tree) replaces the JAX package's linear `_leaf_values`
// (lambdagap_tpu/infer/engine.py:159-180, ops/linear.py
// `linear_leaf_values`), XLA work around the Pallas kernel. It is chosen
// at launch (non-null linear tables: a template parameter, no branch per
// element) and changes only the walk's epilogue: for each (tree, row) of a
// finished (row, group) it writes lin = leaf_const[leaf], then for each
// slot j of the leaf in order lin = lin + coeff[leaf, j] * x[feat[leaf,
// j]], or leaf_value[leaf] when a real slot reads NaN. The product and the
// sum are rounded each on their own (__fmul_rn / __fadd_rn: nvcc would
// contract them into an FMA), as the plain torch version rounds them, so
// the two are torch.equal. The slots are packed from slot 0, so the loop
// stops at a leaf's first -1 slot (a padding slot adds +0.0 in the plain
// version: only the sign of a zero can differ). The row's features come
// from the row tile staged in shared memory, else from global memory. The
// accumulation, the early-stop replay and the packed mode are unchanged:
// a packed constant member carries leaf_const == leaf_value and no slots.
// What bounds it: each (tree, row) adds the leaf's FL scattered loads of
// feature id and coefficient (lanes of a warp sit at different leaves) and
// a shared-memory read of the row's value; see PERF.md section 6.
//
// Plain C interface for ctypes (no PyTorch headers): the wrappers are
// `predict_forest`, `traverse_forest` and `accumulate_forest` in
// lambdagap_tpu_torch/infer/engine.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFlagDefaultLeft = 1;
constexpr int kFlagMtShift = 1;
constexpr int kFlagCategorical = 8;
constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;
constexpr float kZeroThreshold = 1e-35f;

// ---- K3 --------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;
constexpr int kBlockRows = 256;
constexpr int kRowSets = kBlockRows / (32 * kRowsPerThread);
static_assert(kRowSets * 32 * kRowsPerThread == kBlockRows,
              "a row tile is whole warps of kRowsPerThread rows");
// a row tile's features are staged when they fit this many bytes (HIGGS
// width: 256 rows x 29 words = 29,696)
constexpr int kRowSmemBytes = 30 * 1024;
// groups of a block
constexpr int kBlockGroups = 8;

__host__ __device__ constexpr int row_stride(int width) { return width | 1; }

struct TraverseArgs {
  const float* x;
  int64_t rows;
  int64_t x_stride;
  int width;
  const int4* recs;
  const int32_t* group_node_lo;  // [groups + 1]
  const int32_t* group_root;     // 0, or ~leaf for a stump
  const int32_t* group_steps;
  int groups;
  const uint32_t* cat_tab;
  int cat_words;
  const int32_t* row_model;      // packed mode: [rows] member of each row,
  const int32_t* group_model;    //   [groups] of each group; else null
  int32_t* out;                  // [groups, rows]
};

// The reference's decision at one node record for the row value v. The
// numeric rule is computed without branches (a warp's chains take
// different nodes); a categorical node reads its bitset word.
__device__ __forceinline__ bool go_left(const int4 rec, const float v,
                                        const uint32_t* __restrict__ cat_tab,
                                        const int cat_words) {
  const int fl = rec.y & 15;
  const bool nan = v != v;  // isnan; exact without fast-math
  if (fl & kFlagCategorical) {
    const int32_t cat = nan ? -1 : __float2int_rz(v);
    if (cat < 0 || cat >= cat_words * 32) return false;
    const uint32_t word =
        __ldg(cat_tab + (uint32_t)rec.x * (uint32_t)cat_words + (cat >> 5));
    return ((word >> (cat & 31)) & 1u) != 0u;
  }
  const int mt = (fl >> kFlagMtShift) & 3;
  // NaN converted to 0 unless NaN-missing (reference: tree.h
  // NumericalDecision)
  const float v0 = (nan & (mt != kMissingNan)) ? 0.0f : v;
  const bool missing = ((mt == kMissingNan) & nan) |
                       ((mt == kMissingZero) & (fabsf(v0) <= kZeroThreshold));
  const bool dl = (fl & kFlagDefaultLeft) != 0;
  return (missing & dl) | (!missing & (v0 <= __int_as_float(rec.x)));
}

// The row value of feature f for the tile's row r: staged in shared
// memory, or from global memory (a row past the batch reads the last one,
// unused).
template <bool kSmemRows>
__device__ __forceinline__ float row_value(const TraverseArgs& a,
                                           const float* s_x, int64_t row0,
                                           int r, uint32_t f) {
  if constexpr (kSmemRows) {
    return s_x[(uint32_t)(r * row_stride(a.width)) + f];
  } else {
    const int64_t row = row0 + r < a.rows ? row0 + r : a.rows - 1;
    return __ldg(a.x + row * a.x_stride + f);
  }
}

// Walk groups [g0, g1) for the block's rows. A warp takes one (group, row
// set) at a time: its lanes take different rows of the group,
// kRowsPerThread each, as independent chains whose loads are in flight
// together; `done(g, row0, r, node)` then takes the finished carries
// (row0 + r[i] < rows are live): K3 stores them, the fused kernel turns
// them into leaf values. In packed mode a row of another member than the
// group's does not walk and carries 0.
template <bool kSmemRows, typename Done>
__device__ __forceinline__ void walk_groups(const TraverseArgs a, int g0,
                                            int g1, const float* s_x,
                                            int64_t row0, const Done& done) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int items = kRowSets * (g1 - g0);
  for (int it = warp; it < items; it += kWarps) {
    const int g = g0 + it / kRowSets;
    const int set = it - (it / kRowSets) * kRowSets;
    const int4* recs = a.recs + a.group_node_lo[g];
    const int steps = a.group_steps[g];
    const int32_t root = a.group_root[g];
    const int32_t member = a.row_model ? __ldg(a.group_model + g) : 0;
    int r[kRowsPerThread];  // rows of the tile
    int32_t node[kRowsPerThread];
    bool own[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      r[i] = set * (32 * kRowsPerThread) + i * 32 + lane;
      const int64_t row = row0 + r[i];
      own[i] = a.row_model == nullptr ||
               (row < a.rows && __ldg(a.row_model + row) == member);
      node[i] = row < a.rows && own[i] ? root : -1;
    }
    for (int d = 0; d < steps; ++d) {
      bool live = false;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) live |= node[i] >= 0;
      if (!live) break;
      // a finished chain reads record 0 and a valid feature, unused
      int4 rec[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const uint32_t n = node[i] < 0 ? 0u : (uint32_t)node[i];
        rec[i] = __ldg(recs + n);
      }
      float v[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        v[i] = row_value<kSmemRows>(a, s_x, row0, r[i],
                                    (uint32_t)rec[i].y >> 4);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int32_t next = go_left(rec[i], v[i], a.cat_tab, a.cat_words)
                                 ? rec[i].z
                                 : rec[i].w;
        node[i] = node[i] < 0 ? node[i] : next;
      }
    }
    // a foreign (row, group) carries 0, not ~leaf: +0.0 for its trees
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      if (!own[i]) node[i] = 0;
    done(g, row0, r, node);
  }
}

// K3's epilogue: the carries, 128-byte coalesced stores.
struct StoreCarry {
  int32_t* out;  // [groups, rows]
  int64_t rows;
  __device__ __forceinline__ void operator()(
      int g, int64_t row0, const int (&r)[kRowsPerThread],
      const int32_t (&node)[kRowsPerThread]) const {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      if (row0 + r[i] < rows) out[(int64_t)g * rows + row0 + r[i]] = node[i];
    }
  }
};

// Stage the row tile's features in shared memory (row stride odd).
__device__ __forceinline__ void stage_rows(const TraverseArgs& a,
                                           int64_t row0, float* s_x) {
  const int w = a.width;
  const int stride = row_stride(w);
  const int live_rows = (int)min((int64_t)kBlockRows, a.rows - row0);
  for (int i = threadIdx.x; i < live_rows * w; i += kThreads) {
    const int r = i / w;
    const int c = i - r * w;
    s_x[r * stride + c] = __ldg(a.x + (row0 + r) * a.x_stride + c);
  }
  __syncthreads();
}

template <bool kSmemRows>
__global__ void __launch_bounds__(kThreads)
    traverse_kernel(const TraverseArgs args) {
  extern __shared__ float s_x[];
  const TraverseArgs a = args;  // a local copy, as in accumulate_kernel
  const int g0 = blockIdx.y * kBlockGroups;
  const int g1 = min(g0 + kBlockGroups, a.groups);
  const int64_t row0 = (int64_t)blockIdx.x * kBlockRows;
  if (kSmemRows) stage_rows(a, row0, s_x);
  walk_groups<kSmemRows>(a, g0, g1, s_x, row0, StoreCarry{a.out, a.rows});
}

// ---- the accumulation ----------------------------------------------------
constexpr int kAccThreads = 512;
constexpr int kAccWarps = kAccThreads / 32;
constexpr int kAccRows = 32;  // a block's rows: one per lane of warp 0
constexpr int kChunk = 256;   // trees gathered per step
constexpr int kGatherWarps = kAccWarps - 1;
constexpr int kPer = (kChunk + kGatherWarps - 1) / kGatherWarps;

struct AccArgs {
  const int32_t* carry;
  int64_t rows;
  int64_t stride_r;
  int64_t stride_g;
  const int32_t* group_of_tree;
  const float* leaf_value;
  int64_t leaves;
  const int32_t* tree_class;
  int64_t trees;
  int num_class;
  int es_freq;
  float es_margin;
  float* out;  // [num_class, rows]
};

// NaN ranks above every number, as in torch.topk
__device__ __forceinline__ bool ranks_above(float v, float t) {
  return v > t || (v != v && t == t);
}

__device__ __forceinline__ void push_top2(float v, float& t1, float& t2) {
  if (ranks_above(v, t1)) {
    t2 = t1;
    t1 = v;
  } else if (ranks_above(v, t2)) {
    t2 = v;
  }
}

// Class scores of one row: one class in a register; more in shared
// memory, strided by the rows a block adds at once (this thread's class k
// at a[k * kStride], its row threadIdx.x % kStride).
template <bool kOneClass, int kStride>
struct Scores;

template <int kStride>
struct Scores<true, kStride> {
  float a;
  __device__ __forceinline__ void init(float*, int) { a = 0.0f; }
  __device__ __forceinline__ void add(int, float v) { a += v; }
  __device__ __forceinline__ float margin(int) const {
    return 2.0f * fabsf(a);
  }
  __device__ __forceinline__ void store(float* out, int64_t, int64_t r,
                                        int) const {
    out[r] = a;
  }
};

template <int kStride>
struct Scores<false, kStride> {
  float* a;
  __device__ __forceinline__ void init(float* s, int K) {
    a = s + threadIdx.x % kStride;
    for (int j = 0; j < K; ++j) a[j * kStride] = 0.0f;
  }
  __device__ __forceinline__ void add(int k, float v) {
    a[k * kStride] += v;
  }
  __device__ __forceinline__ float margin(int K) const {
    float t1 = __int_as_float(0xff800000), t2 = t1;  // -inf
    for (int j = 0; j < K; ++j) push_top2(a[j * kStride], t1, t2);
    return t1 - t2;
  }
  __device__ __forceinline__ void store(float* out, int64_t rows, int64_t r,
                                        int K) const {
    for (int j = 0; j < K; ++j) out[j * rows + r] = a[j * kStride];
  }
};

// A gather warp's trees of chunk c: warp-1, warp-1 + kGatherWarps, ...
// (tl < n). Their group ids and classes are loaded a chunk ahead
// (load_maps), so a chunk's gather is two dependent loads: the carry, then
// the leaf value.
struct Maps {
  int32_t g[kPer];
  int32_t k[kPer];
};

__device__ __forceinline__ int chunk_trees(const AccArgs& a, int64_t c) {
  const int64_t left = a.trees - c * kChunk;
  return left < kChunk ? (int)left : kChunk;
}

__device__ __forceinline__ void load_maps(const AccArgs& a, int64_t c,
                                          int warp, Maps& m) {
  const int64_t t0 = c * kChunk;
  const int n = chunk_trees(a, c);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int tl = warp - 1 + j * kGatherWarps;
    m.g[j] = tl < n ? __ldg(a.group_of_tree + t0 + tl) : 0;
    m.k[j] = tl < n ? __ldg(a.tree_class + t0 + tl) : 0;
  }
}

__device__ __forceinline__ void gather_chunk(const AccArgs& a, int64_t c,
                                             const Maps& m, int64_t rowc,
                                             int warp, int lane,
                                             float (*s_val)[kAccRows],
                                             int32_t* s_cls) {
  const int64_t t0 = c * kChunk;
  const int n = chunk_trees(a, c);
  int32_t cv[kPer];
  float v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int tl = warp - 1 + j * kGatherWarps;
    cv[j] = tl < n ? __ldg(a.carry + rowc * a.stride_r + m.g[j] * a.stride_g)
                   : 0;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int tl = warp - 1 + j * kGatherWarps;
    // a carry that is not ~leaf adds +0.0, as the plain where(done, v, 0)
    v[j] = tl < n && cv[j] < 0
               ? __ldg(a.leaf_value + (t0 + tl) * a.leaves + ~cv[j])
               : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int tl = warp - 1 + j * kGatherWarps;
    if (tl < n) {
      s_val[tl][lane] = v[j];
      if (lane == 0) s_cls[tl] = m.k[j];
    }
  }
}

// dynamic shared memory of the accumulation: two chunks of gathered leaf
// values, their classes, and (more than one class) the class scores
__host__ __device__ constexpr size_t acc_smem_bytes(int num_class) {
  return sizeof(float) * 2 * kChunk * kAccRows + sizeof(int32_t) * 2 * kChunk +
         (num_class > 1 ? sizeof(float) * num_class * kAccRows : 0);
}

template <bool kOneClass>
__global__ void __launch_bounds__(kAccThreads)
    accumulate_kernel(const AccArgs args) {
  extern __shared__ float acc_smem[];
  float(*s_val)[kChunk][kAccRows] =
      reinterpret_cast<float(*)[kChunk][kAccRows]>(acc_smem);
  int32_t(*s_cls)[kChunk] =
      reinterpret_cast<int32_t(*)[kChunk]>(acc_smem + 2 * kChunk * kAccRows);
  float* s_scores = acc_smem + 2 * kChunk * (kAccRows + 1);
  const AccArgs a = args;  // a local copy: references to it stay in registers
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kAccRows + lane;
  const int64_t rowc = row < a.rows ? row : a.rows - 1;
  const int64_t chunks = (a.trees + kChunk - 1) / kChunk;
  Scores<kOneClass, kAccRows> sc;
  Maps m;
  if (warp == 0) {
    sc.init(s_scores, a.num_class);
  } else if (chunks > 0) {
    load_maps(a, 0, warp, m);
    gather_chunk(a, 0, m, rowc, warp, lane, s_val[0], s_cls[0]);
    if (chunks > 1) load_maps(a, 1, warp, m);
  }
  __syncthreads();
  bool stopped = false;
  int until = a.es_freq;
  for (int64_t c = 0; c < chunks; ++c) {
    const int buf = (int)(c & 1);
    if (warp == 0) {
      const int n = chunk_trees(a, c);
#pragma unroll 8
      for (int tl = 0; tl < n; ++tl) {
        const float v = s_val[buf][tl][lane];
        const int k = kOneClass ? 0 : s_cls[buf][tl];
        // never skipped: a stopped row adds +0.0, as the plain version
        sc.add(k, stopped ? 0.0f : v);
        if (a.es_freq > 0 && --until == 0) {
          until = a.es_freq;
          stopped = stopped || sc.margin(a.num_class) > a.es_margin;
        }
      }
    } else if (c + 1 < chunks) {
      gather_chunk(a, c + 1, m, rowc, warp, lane, s_val[buf ^ 1],
                   s_cls[buf ^ 1]);
      if (c + 2 < chunks) load_maps(a, c + 2, warp, m);
    }
    __syncthreads();
  }
  if (warp == 0 && row < a.rows) sc.store(a.out, a.rows, row, a.num_class);
}

// ---- the fused kernel: K3's walk, leaf values, the accumulation -----------
// A row tile is group_tiles walk blocks and kAccBlocks accumulation blocks
// of 32 rows. Each block draws a ticket (an atomic counter) when it starts
// and takes the ticket's work: first every walk block, then every
// accumulation block. An accumulation block waits until its tile's walk
// blocks have all arrived; they drew smaller tickets, so they are already
// running and never wait: the wait cannot deadlock, whatever order the
// hardware starts blocks in, and no block waits while a walk still needs
// its slot. It then adds its rows, a lane of warp 0 a row, in forest
// order, while all 8 warps stage chunks of the workspace into shared
// memory, the next chunk in flight in registers. A tile's 256 rows are
// thus added on 8 SMs at once (one block adding them all measured 3x
// slower at 4,096 rows: its SM's loads and instructions bound it).
constexpr int kAccRowsFused = 32;  // rows of an accumulation block
constexpr int kAccBlocks = kBlockRows / kAccRowsFused;
constexpr int kAccChunk = 64;      // trees a chunk
constexpr int kAccLoads = kAccChunk / kWarps;
constexpr int kAddBatch = 8;       // shared loads issued ahead of their adds
// a wait longer than this many polls (a 64 ns sleep and an L2 round trip
// each: a second or more in all) gives up rather than hang the card; the
// scores are then wrong, and the tests and chip_smoke.py compare every
// score with the plain version's
constexpr long long kMaxPolls = 1LL << 22;
static_assert(kAccChunk * kAccRowsFused == kThreads * kAccLoads,
              "a chunk is kAccLoads values a thread");

struct PredictArgs {
  TraverseArgs t;                 // the walk (t.out unused)
  const int32_t* group_tree_lo;   // [groups + 1] CSR: a group's trees
  const int32_t* group_tree;      // [trees], forest order within a group
  const float* leaf_value;        // [trees, leaves]
  int64_t leaves;
  const float* leaf_const;        // linear mode: [trees, leaves]
  const int32_t* leaf_feat;       //   [trees, leaves, feats], -1 padding
  const float* leaf_coeff;        //   [trees, leaves, feats]; else null
  int feats;
  const int32_t* tree_class;      // [trees]
  int64_t trees;
  int num_class;
  int es_freq;
  float es_margin;
  int group_tiles;
  float* ws;                      // [trees, ws_stride] leaf values
  int64_t ws_stride;              // rows rounded up to 32: a tree's 32
  //                                 rows of an accumulation block are one
  //                                 aligned 128-byte line
  int32_t* counters;              // 0 between launches: the ticket,
  //                                 then arrivals [row tiles], then the
  //                                 finished accumulation blocks [row tiles]
  float* out;                     // [num_class, rows]
};

// The fused epilogue: each finished (row, group) writes its group's trees'
// leaf values (+0.0 for a carry that is not ~leaf, as the plain
// where(done, v, 0)); for each tree the warp's 32 x kRowsPerThread stores
// are 128-byte coalesced, and its kRowsPerThread leaf loads in flight
// together.
struct StoreLeafValues {
  const int32_t* group_tree_lo;
  const int32_t* group_tree;
  const float* leaf_value;
  int64_t leaves;
  float* ws;
  int64_t ws_stride;
  int64_t rows;
  __device__ __forceinline__ void operator()(
      int g, int64_t row0, const int (&r)[kRowsPerThread],
      const int32_t (&node)[kRowsPerThread]) const {
    const int lo = __ldg(group_tree_lo + g);
    const int hi = __ldg(group_tree_lo + g + 1);
    for (int j = lo; j < hi; ++j) {
      const int64_t t = __ldg(group_tree + j);
      const float* lv = leaf_value + t * leaves;
      float* w = ws + t * ws_stride + row0;
      float v[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        v[i] = node[i] < 0 ? __ldg(lv + ~node[i]) : 0.0f;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        if (row0 + r[i] < rows) __stcg(w + r[i], v[i]);
    }
  }
};

// The linear epilogue: as StoreLeafValues, each value the leaf's linear
// model over the row (the plain version is ops/linear.linear_leaf_values).
// For each tree the warp's kRowsPerThread chains walk their leaves' slots
// together, until each has reached its leaf's first padding slot.
template <bool kSmemRows>
struct StoreLinearValues {
  TraverseArgs t;
  const float* s_x;
  const int32_t* group_tree_lo;
  const int32_t* group_tree;
  const float* leaf_value;
  const float* leaf_const;
  const int32_t* leaf_feat;
  const float* leaf_coeff;
  int64_t leaves;
  int feats;
  float* ws;
  int64_t ws_stride;
  __device__ __forceinline__ void operator()(
      int g, int64_t row0, const int (&r)[kRowsPerThread],
      const int32_t (&node)[kRowsPerThread]) const {
    const int lo = __ldg(group_tree_lo + g);
    const int hi = __ldg(group_tree_lo + g + 1);
    for (int j = lo; j < hi; ++j) {
      const int64_t tr = __ldg(group_tree + j);
      float lin[kRowsPerThread];
      bool nan[kRowsPerThread];
      bool live[kRowsPerThread];
      int64_t li[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        live[i] = node[i] < 0;
        li[i] = tr * leaves + (live[i] ? ~node[i] : 0);
        lin[i] = live[i] ? __ldg(leaf_const + li[i]) : 0.0f;
        nan[i] = false;
      }
      for (int s = 0; s < feats; ++s) {
        bool any = false;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          if (!live[i]) continue;
          const int32_t f = __ldg(leaf_feat + li[i] * feats + s);
          if (f < 0) {
            live[i] = false;
            continue;
          }
          const float xv = row_value<kSmemRows>(t, s_x, row0, r[i],
                                                (uint32_t)f);
          nan[i] |= xv != xv;  // isnan; exact without fast-math
          lin[i] = __fadd_rn(
              lin[i], __fmul_rn(__ldg(leaf_coeff + li[i] * feats + s), xv));
          any = true;
        }
        if (!any) break;
      }
      float* w = ws + tr * ws_stride + row0;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float v = node[i] >= 0 ? 0.0f
                        : nan[i]     ? __ldg(leaf_value + li[i])
                                     : lin[i];
        if (row0 + r[i] < t.rows) __stcg(w + r[i], v);
      }
    }
  }
};

// The rows of one accumulation block: rows [rowa, rowa + nra), nra <= 32,
// every tree added in forest order by lane r of warp 0 into row rowa + r,
// the early-stop replay included (a stopped row adds +0.0, as the plain
// version). With the rows rounded up to np = 1 << shift, a chunk is
// kAccChunk x 32 / np trees (64 at 32 rows, 2,048 at one row), its value
// (tree t, row r) at s_val[t * np + r]: thread i stages values i + 256 j,
// row i % np of trees i / np + j * (256 / np).
template <bool kOneClass>
__device__ __forceinline__ void accumulate_rows(const PredictArgs& a,
                                                int64_t rowa, int nra,
                                                float* smem) {
  constexpr int kStage = kAccChunk * kAccRowsFused;  // values a chunk
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int shift = 0;
  while ((1 << shift) < nra) ++shift;
  const int per = kStage >> shift;  // trees a chunk
  const int rr = threadIdx.x & ((1 << shift) - 1);
  const int tt = threadIdx.x >> shift;
  const int step = kThreads >> shift;
  const bool loads = rr < nra;
  const int64_t T = a.trees;
  const int64_t chunks = (T + per - 1) / per;
  float* s_val = smem;  // [2][kStage]
  const float* src = a.ws + rowa + rr;
  float v[kAccLoads];
  auto load = [&](int64_t c) {
    const int64_t t0 = c * per + tt;
#pragma unroll
    for (int j = 0; j < kAccLoads; ++j) {
      const int64_t t = t0 + j * step;
      if (loads && t < T) v[j] = __ldcg(src + t * a.ws_stride);
    }
  };
  auto stage = [&](int64_t c) {
    float* dst = s_val + (c & 1) * kStage + threadIdx.x;
#pragma unroll
    for (int j = 0; j < kAccLoads; ++j)
      if (loads) dst[j * kThreads] = v[j];
  };
  Scores<kOneClass, kAccRowsFused> sc;
  if (warp == 0) sc.init(smem + 2 * kStage, a.num_class);
  bool stopped = false;
  int until = a.es_freq;
  load(0);
  stage(0);
  __syncthreads();
  if (chunks > 1) load(1);
  for (int64_t c = 0; c < chunks; ++c) {
    if (warp == 0 && lane < nra) {
      const float* sv = s_val + (c & 1) * kStage + lane;
      const int64_t t0 = c * per;
      const int n = T - t0 < per ? (int)(T - t0) : per;
      // the adds between two early-stop checks run without a branch, their
      // shared loads issued kAddBatch at a time ahead of them
      for (int tl = 0; tl < n;) {
        int seg = n - tl;
        if (a.es_freq > 0 && until < seg) seg = until;
        int j = tl;
        for (; j + kAddBatch <= tl + seg; j += kAddBatch) {
          float x[kAddBatch];
#pragma unroll
          for (int i = 0; i < kAddBatch; ++i) x[i] = sv[(j + i) << shift];
#pragma unroll
          for (int i = 0; i < kAddBatch; ++i)
            sc.add(kOneClass ? 0 : __ldg(a.tree_class + t0 + j + i),
                   stopped ? 0.0f : x[i]);
        }
        for (; j < tl + seg; ++j)
          sc.add(kOneClass ? 0 : __ldg(a.tree_class + t0 + j),
                 stopped ? 0.0f : sv[j << shift]);
        tl += seg;
        if (a.es_freq > 0 && (until -= seg) == 0) {
          until = a.es_freq;
          stopped = stopped || sc.margin(a.num_class) > a.es_margin;
        }
      }
    }
    if (c + 1 < chunks) {
      stage(c + 1);
      if (c + 2 < chunks) load(c + 2);
    }
    __syncthreads();
  }
  if (warp == 0 && lane < nra)
    sc.store(a.out, a.t.rows, rowa + lane, a.num_class);
}

// dynamic shared memory of the fused kernel: a walk block's row tile
// features, or an accumulation block's two chunks and (more than one
// class) its class scores
__host__ __device__ constexpr size_t tail_smem_bytes(int num_class) {
  return sizeof(float) *
         (2 * kAccChunk * kAccRowsFused +
          (num_class > 1 ? (size_t)num_class * kAccRowsFused : 0));
}

template <bool kSmemRows, bool kOneClass, bool kLinear>
__global__ void __launch_bounds__(kThreads)
    predict_kernel(const PredictArgs args) {
  extern __shared__ float smem[];
  __shared__ int s_ticket;
  const PredictArgs a = args;  // a local copy, as in accumulate_kernel
  int32_t* ticket = a.counters;
  if (threadIdx.x == 0) {
    const int mine = atomicAdd(ticket, 1);
    // every block has drawn its ticket: ready for the next launch
    if (mine == (int)gridDim.x - 1) atomicExch(ticket, 0);
    s_ticket = mine;
  }
  __syncthreads();
  // tickets: every walk block (row tile by row tile), then every
  // accumulation block
  const int64_t row_tiles = (a.t.rows + kBlockRows - 1) / kBlockRows;
  const int64_t walks = row_tiles * a.group_tiles;
  int64_t tile;
  int item;  // < group_tiles: a group tile; else an accumulation block
  if (s_ticket < walks) {
    tile = s_ticket / a.group_tiles;
    item = (int)(s_ticket - tile * a.group_tiles);
  } else {
    tile = (s_ticket - walks) / kAccBlocks;
    item = a.group_tiles + (int)(s_ticket - walks - tile * kAccBlocks);
  }
  int32_t* arrivals = a.counters + 1 + tile;
  int32_t* finished = a.counters + 1 + row_tiles + tile;
  const int64_t row0 = tile * kBlockRows;
  if (item < a.group_tiles) {  // a walk block
    const int g0 = item * kBlockGroups;
    const int g1 = min(g0 + kBlockGroups, a.t.groups);
    if (kSmemRows) stage_rows(a.t, row0, smem);
    if constexpr (kLinear) {
      walk_groups<kSmemRows>(
          a.t, g0, g1, smem, row0,
          StoreLinearValues<kSmemRows>{
              a.t, smem, a.group_tree_lo, a.group_tree, a.leaf_value,
              a.leaf_const, a.leaf_feat, a.leaf_coeff, a.leaves, a.feats,
              a.ws, a.ws_stride});
    } else {
      walk_groups<kSmemRows>(
          a.t, g0, g1, smem, row0,
          StoreLeafValues{a.group_tree_lo, a.group_tree, a.leaf_value,
                          a.leaves, a.ws, a.ws_stride, a.t.rows});
    }
    // every thread's workspace stores reach L2 before the block arrives
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicAdd(arrivals, 1);
    return;
  }
  // an accumulation block: rows [rowa, rowa + nra) of the tile
  const int64_t rowa = row0 + (int64_t)(item - a.group_tiles) * kAccRowsFused;
  const int64_t left = a.t.rows - rowa;
  const int nra = left <= 0 ? 0 : (left < kAccRowsFused ? (int)left : kAccRowsFused);
  if (nra > 0) {
    if (threadIdx.x == 0) {
      for (long long polls = 0;
           atomicAdd(arrivals, 0) < a.group_tiles && polls < kMaxPolls;
           ++polls)
        __nanosleep(64);
      __threadfence();
    }
    __syncthreads();
    accumulate_rows<kOneClass>(a, rowa, nra, smem);
  }
  if (threadIdx.x == 0) {
    // the tile's last accumulation block to finish resets its counters
    if (atomicAdd(finished, 1) == kAccBlocks - 1) {
      atomicExch(arrivals, 0);
      atomicExch(finished, 0);
    }
  }
}

// Let the kernel take up to the device's opt-in shared memory. No carveout
// preference: the CUDA runtime sizes shared memory to the launch, so K3,
// which asks for at most kRowSmemBytes, keeps the rest of the SM's 256 KB
// as L1 for its record reads.
template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, int max_smem) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              max_smem - (int)attr.sharedSizeBytes);
}

}  // namespace

// Raise the accumulation's and the fused kernels' dynamic shared-memory
// limit to the device's opt-in maximum (less their static shared memory;
// K3 stays under the default 48 KB); once per device, before the first
// launch. Returns that maximum (bytes), or minus the cudaError_t.
extern "C" int lg_traverse_setup(void) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = raise_smem_limit(accumulate_kernel<true>, max_smem);
  if (err == cudaSuccess)
    err = raise_smem_limit(accumulate_kernel<false>, max_smem);
  if (err == cudaSuccess)
    err = raise_smem_limit(predict_kernel<true, true, false>, max_smem);
  if (err == cudaSuccess)
    err = raise_smem_limit(predict_kernel<true, false, false>, max_smem);
  if (err == cudaSuccess)
    err = raise_smem_limit(predict_kernel<false, true, false>, max_smem);
  if (err == cudaSuccess)
    err = raise_smem_limit(predict_kernel<false, false, false>, max_smem);
  if (err == cudaSuccess)
    err = raise_smem_limit(predict_kernel<true, true, true>, max_smem);
  if (err == cudaSuccess)
    err = raise_smem_limit(predict_kernel<true, false, true>, max_smem);
  if (err == cudaSuccess)
    err = raise_smem_limit(predict_kernel<false, true, true>, max_smem);
  if (err == cudaSuccess)
    err = raise_smem_limit(predict_kernel<false, false, true>, max_smem);
  return err == cudaSuccess ? max_smem : -(int)err;
}

// K3 over every group in one launch, kBlockGroups groups a block; out is
// [groups, rows]. Returns 0 on success, otherwise the cudaError_t of the
// launch.
extern "C" int lg_traverse_forest(
    const float* x, int64_t rows, int64_t x_stride, int width,
    const void* recs, const int32_t* group_node_lo, const int32_t* group_root,
    const int32_t* group_steps, int64_t groups, const uint32_t* cat_tab,
    int cat_words, int32_t* out, void* stream) {
  if (rows == 0 || groups == 0) return 0;
  const int64_t row_tiles = (rows + kBlockRows - 1) / kBlockRows;
  const int64_t group_tiles = (groups + kBlockGroups - 1) / kBlockGroups;
  if (row_tiles > 0x7fffffffLL || group_tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const int64_t row_bytes =
      (int64_t)kBlockRows * row_stride(width) * (int64_t)sizeof(float);
  const bool smem_rows = row_bytes <= kRowSmemBytes;
  const size_t smem = smem_rows ? (size_t)row_bytes : 0;
  TraverseArgs a;
  a.x = x;
  a.rows = rows;
  a.x_stride = x_stride;
  a.width = width;
  a.recs = static_cast<const int4*>(recs);
  a.group_node_lo = group_node_lo;
  a.group_root = group_root;
  a.group_steps = group_steps;
  a.groups = (int)groups;
  a.cat_tab = cat_tab;
  a.cat_words = cat_words;
  a.row_model = nullptr;
  a.group_model = nullptr;
  a.out = out;
  const dim3 grid((unsigned)row_tiles, (unsigned)group_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem_rows)
    traverse_kernel<true><<<grid, kThreads, smem, s>>>(a);
  else
    traverse_kernel<false><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The accumulation over every row in one launch: carry[r * stride_r + g *
// stride_g], out [num_class, rows]. Returns 0 on success, otherwise the
// cudaError_t of the launch.
extern "C" int lg_accumulate_forest(
    const int32_t* carry, int64_t rows, int64_t stride_r, int64_t stride_g,
    const int32_t* group_of_tree, const float* leaf_value, int64_t leaves,
    const int32_t* tree_class, int64_t trees, int num_class, int es_freq,
    float es_margin, float* out, void* stream) {
  if (rows == 0) return 0;
  const int64_t blocks = (rows + kAccRows - 1) / kAccRows;
  if (blocks > 0x7fffffffLL || num_class < 1)
    return (int)cudaErrorInvalidConfiguration;
  AccArgs a;
  a.carry = carry;
  a.rows = rows;
  a.stride_r = stride_r;
  a.stride_g = stride_g;
  a.group_of_tree = group_of_tree;
  a.leaf_value = leaf_value;
  a.leaves = leaves;
  a.tree_class = tree_class;
  a.trees = trees;
  a.num_class = num_class;
  a.es_freq = es_freq;
  a.es_margin = es_margin;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)blocks;
  if (num_class == 1)
    accumulate_kernel<true><<<grid, kAccThreads, acc_smem_bytes(1), s>>>(a);
  else
    accumulate_kernel<false>
        <<<grid, kAccThreads, acc_smem_bytes(num_class), s>>>(a);
  return (int)cudaGetLastError();
}

// One dispatch in one launch: K3's walk over every group, the leaf values
// into ws [trees, ws_stride] (ws_stride: rows rounded up to 32), and the
// forest-order accumulation into out [num_class, rows] by each row tile's
// accumulation blocks. counters holds at least 1 + 2 ceil(rows / 256)
// zeros and is left zeroed; no other launch may use it at the same time.
// Packed mode: row_model [rows] and group_model [groups], both or neither
// (null: the unpacked launch); no early stop there. Linear mode:
// leaf_const [trees, leaves], leaf_feat and leaf_coeff [trees, leaves,
// feats], all three or none (null: constant leaves); every feature id
// below width. Returns 0 on success, otherwise the cudaError_t of the
// launch.
extern "C" int lg_predict_forest(
    const float* x, int64_t rows, int64_t x_stride, int width,
    const void* recs, const int32_t* group_node_lo, const int32_t* group_root,
    const int32_t* group_steps, int64_t groups, const uint32_t* cat_tab,
    int cat_words, const int32_t* group_tree_lo, const int32_t* group_tree,
    const float* leaf_value, int64_t leaves, const float* leaf_const,
    const int32_t* leaf_feat, const float* leaf_coeff, int feats,
    const int32_t* tree_class, int64_t trees, int num_class, int es_freq,
    float es_margin, const int32_t* row_model, const int32_t* group_model,
    float* ws, int64_t ws_stride, int32_t* counters, float* out,
    void* stream) {
  if (rows == 0) return 0;
  const bool linear = leaf_const != nullptr;
  if (groups == 0 || trees == 0 || num_class < 1 || ws_stride < rows ||
      ws_stride % 32 != 0 ||
      (row_model == nullptr) != (group_model == nullptr) ||
      (row_model != nullptr && es_freq > 0) ||
      linear != (leaf_feat != nullptr) || linear != (leaf_coeff != nullptr) ||
      (linear && feats < 1))
    return (int)cudaErrorInvalidValue;
  const int64_t row_tiles = (rows + kBlockRows - 1) / kBlockRows;
  const int64_t group_tiles = (groups + kBlockGroups - 1) / kBlockGroups;
  if (row_tiles * (group_tiles + kAccBlocks) > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  const int64_t row_bytes =
      (int64_t)kBlockRows * row_stride(width) * (int64_t)sizeof(float);
  const bool smem_rows = row_bytes <= kRowSmemBytes;
  const size_t tail = tail_smem_bytes(num_class);
  const size_t smem =
      smem_rows && (size_t)row_bytes > tail ? (size_t)row_bytes : tail;
  PredictArgs a;
  a.t.x = x;
  a.t.rows = rows;
  a.t.x_stride = x_stride;
  a.t.width = width;
  a.t.recs = static_cast<const int4*>(recs);
  a.t.group_node_lo = group_node_lo;
  a.t.group_root = group_root;
  a.t.group_steps = group_steps;
  a.t.groups = (int)groups;
  a.t.cat_tab = cat_tab;
  a.t.cat_words = cat_words;
  a.t.row_model = row_model;
  a.t.group_model = group_model;
  a.t.out = nullptr;
  a.group_tree_lo = group_tree_lo;
  a.group_tree = group_tree;
  a.leaf_value = leaf_value;
  a.leaves = leaves;
  a.leaf_const = leaf_const;
  a.leaf_feat = leaf_feat;
  a.leaf_coeff = leaf_coeff;
  a.feats = feats;
  a.tree_class = tree_class;
  a.trees = trees;
  a.num_class = num_class;
  a.es_freq = es_freq;
  a.es_margin = es_margin;
  a.group_tiles = (int)group_tiles;
  a.ws = ws;
  a.ws_stride = ws_stride;
  a.counters = counters;
  a.out = out;
  const unsigned grid = (unsigned)(row_tiles * (group_tiles + kAccBlocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the variant: rows staged, one class, linear leaves
  switch ((smem_rows ? 4 : 0) | (num_class == 1 ? 2 : 0) | (linear ? 1 : 0)) {
    case 7:
      predict_kernel<true, true, true><<<grid, kThreads, smem, s>>>(a);
      break;
    case 6:
      predict_kernel<true, true, false><<<grid, kThreads, smem, s>>>(a);
      break;
    case 5:
      predict_kernel<true, false, true><<<grid, kThreads, smem, s>>>(a);
      break;
    case 4:
      predict_kernel<true, false, false><<<grid, kThreads, smem, s>>>(a);
      break;
    case 3:
      predict_kernel<false, true, true><<<grid, kThreads, smem, s>>>(a);
      break;
    case 2:
      predict_kernel<false, true, false><<<grid, kThreads, smem, s>>>(a);
      break;
    case 1:
      predict_kernel<false, false, true><<<grid, kThreads, smem, s>>>(a);
      break;
    default:
      predict_kernel<false, false, false><<<grid, kThreads, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}
