// Compiled-forest traversal (K3) and forest-order accumulation for Hopper
// (sm_90a): the two launches of one serve dispatch.
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
// The accumulation replaces the XLA work around that kernel in the same
// file: `_leaf_values` (:159) and the `lax.scan` of `_accumulate`
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
// step waits on L2. The accumulation must read the carry and the leaf
// table once and write the scores (8.7 MB, ~0.003 ms); it is bound by the
// latency of its dependent gathers (group id -> carry -> leaf value) and
// of a row's serial add chain.
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
//  - the carry is written group-major, so a warp's stores (and the
//    accumulation's loads) are 128-byte coalesced;
//  - the accumulation gives a row to one lane of warp 0 of its block, which
//    alone adds into it, in forest order, so the order is the plain
//    version's on every run. The other warps gather the next chunk of
//    kChunk trees' leaf values (carry -> leaf, the chunk's group ids loaded
//    a chunk ahead) into a second shared buffer meanwhile;
//  - one class's score lives in a register; more classes' scores live in
//    shared memory;
//  - built WITHOUT --use_fast_math, so the NaN test and the |v| <= 1e-35
//    zero-missing test survive compilation; float -> int uses
//    __float2int_rz, which saturates like XLA's convert (1e10 -> INT_MAX).
//
// Plain C interface for ctypes (no PyTorch headers): the wrappers are
// `traverse_forest` and `accumulate_forest` in
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

// Walk groups [g0, g1) for the block's rows. A warp takes one (group, row
// set) at a time: its lanes take different rows of the group,
// kRowsPerThread each, as independent chains whose loads are in flight
// together; the carries are stored together, 128-byte coalesced.
template <bool kSmemRows>
__device__ __forceinline__ void walk_groups(const TraverseArgs a, int g0,
                                            int g1, const float* s_x,
                                            int64_t row0) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int stride = row_stride(a.width);
  const int items = kRowSets * (g1 - g0);
  for (int it = warp; it < items; it += kWarps) {
    const int g = g0 + it / kRowSets;
    const int set = it - (it / kRowSets) * kRowSets;
    const int4* recs = a.recs + a.group_node_lo[g];
    const int steps = a.group_steps[g];
    const int32_t root = a.group_root[g];
    int r[kRowsPerThread];  // rows of the tile
    int32_t node[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      r[i] = set * (32 * kRowsPerThread) + i * 32 + lane;
      node[i] = row0 + r[i] < a.rows ? root : -1;
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
      for (int i = 0; i < kRowsPerThread; ++i) {
        const uint32_t f = (uint32_t)rec[i].y >> 4;
        if constexpr (kSmemRows) {
          v[i] = s_x[(uint32_t)(r[i] * stride) + f];
        } else {
          const int64_t row = row0 + r[i] < a.rows ? row0 + r[i] : a.rows - 1;
          v[i] = __ldg(a.x + row * a.x_stride + f);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int32_t next = go_left(rec[i], v[i], a.cat_tab, a.cat_words)
                                 ? rec[i].z
                                 : rec[i].w;
        node[i] = node[i] < 0 ? node[i] : next;
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      if (row0 + r[i] < a.rows) a.out[(int64_t)g * a.rows + row0 + r[i]] = node[i];
    }
  }
}

template <bool kSmemRows>
__global__ void __launch_bounds__(kThreads)
    traverse_kernel(const TraverseArgs args) {
  extern __shared__ float s_x[];
  const TraverseArgs a = args;  // a local copy, as in accumulate_kernel
  const int g0 = blockIdx.y * kBlockGroups;
  const int g1 = min(g0 + kBlockGroups, a.groups);
  const int64_t row0 = (int64_t)blockIdx.x * kBlockRows;
  if (kSmemRows) {
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
  walk_groups<kSmemRows>(a, g0, g1, s_x, row0);
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
// memory, lane-strided (this lane's class k at a[k * kAccRows]).
template <bool kOneClass>
struct Scores;

template <>
struct Scores<true> {
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

template <>
struct Scores<false> {
  float* a;
  __device__ __forceinline__ void init(float* s, int K) {
    a = s + (threadIdx.x & 31);
    for (int j = 0; j < K; ++j) a[j * kAccRows] = 0.0f;
  }
  __device__ __forceinline__ void add(int k, float v) {
    a[k * kAccRows] += v;
  }
  __device__ __forceinline__ float margin(int K) const {
    float t1 = __int_as_float(0xff800000), t2 = t1;  // -inf
    for (int j = 0; j < K; ++j) push_top2(a[j * kAccRows], t1, t2);
    return t1 - t2;
  }
  __device__ __forceinline__ void store(float* out, int64_t rows, int64_t r,
                                        int K) const {
    for (int j = 0; j < K; ++j) out[j * rows + r] = a[j * kAccRows];
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
  Scores<kOneClass> sc;
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

// Raise the accumulation kernels' dynamic shared-memory limit to the
// device's opt-in maximum (less their static shared memory; K3 stays under
// the default 48 KB); once per device, before the first launch. Returns
// that maximum (bytes), or minus the cudaError_t.
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
