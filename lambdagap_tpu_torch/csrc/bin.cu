// Row binning kernel (B) for Hopper (sm_90a).
//
// Replaces: no TPU kernel. The JAX package bins a dataset's numerical
// columns in host C++ (`lg_bin_matrix`, lambdagap_tpu/native/binner.cpp:172,
// semantics at :9-15; called from lambdagap_tpu/data/dataset.py:353,372).
// Host work on a path that runs on the card becomes a kernel here, as the
// TreeSHAP host loop became S.
//
// What it computes: for every row r and every numerical feature f of a
// list, out[r][dst[f]] = the bin of x = rows[r][col[f]], exactly the
// port's BinMapper.values_to_bins (data/binning.py):
//   - a NaN becomes bin nan_bin[f] when the feature's missing type is NaN
//     (nan_bin[f] >= 0), else it is read as 0.0;
//   - bin = lower_bound(bounds_f, x): the number of the feature's float64
//     upper bounds (without their NaN sentinel) below x, which is numpy's
//     searchsorted with side 'left';
//   - clipped to len(bounds_f) - 1.
// Output is u8 or u16 [n, U] row-major; columns not in the list (the
// categorical ones, which stay with the mapper on the host) are not
// written.
//
// What bounds it on this card: bytes. Each input value is read once and
// each bin written once: at 10.5 M x 28 float32 rows that is ~1.2 GB in and
// ~0.3 GB out, ~0.44 ms at 3.35 TB/s. Each value's search costs ~8
// dependent shared-memory loads and ~4 instructions a level, so in practice
// the search's shared-memory wavefronts and integer instructions hold it
// above that (PERF.md section 6 has the measured split).
//
// The design:
//  - Float32 rows search a float32 table (ops/bin_cuda.py builds it): each
//    float64 bound b becomes RD32(b), the largest float32 not above b. For
//    a float32 x, x <= b exactly when x <= RD32(b), so the count of bounds
//    below x is the same in both tables for every float32 input (zeros,
//    subnormals, infinities and bounds beyond FLT_MAX included). The
//    comparison is in float32, with no fast-math or flush-to-zero, so
//    subnormal rows compare as they are. Float64 rows search the float64
//    table. MSLR's 136 x 255 float32 table is ~139 KB, so it fits one
//    block's shared memory and the rows are read in one pass.
//  - Each feature's bounds, padded with +inf to 2^D - 1, are laid out as an
//    implicit breadth-first (Eytzinger) tree at [1, 2^D): the search
//    k = 2k + (tree[k] < x), D times, ends at k - 2^D = the count of bounds
//    below x. The nodes of one level are contiguous, so the 32 lanes of a
//    warp searching one feature read one word (a broadcast) at the first
//    level and at most 32 consecutive words through the sixth. Features of
//    up to 255 bounds share one depth, so a tile's warps run one loop.
//  - Features are cut into tiles (blockIdx.y) whose trees, staged once in
//    shared memory, fit beside the row buffers; in the main path there is
//    one tile. A feature whose tree does not fit alone is a tile of its own
//    searched in device memory.
//  - A block runs row groups of 256 threads over its staged trees. Each
//    group walks row tiles of R rows grid-stride with its own two buffers
//    and its own barrier: the next tile's copy (cp.async, a pair of values
//    at a time when the rows are exactly the tile's columns) is in flight
//    while this one is searched, and one group's barriers and stores
//    overlap another's searches. The staged row pitch is 2 mod 4 values, so
//    a lane reads its row's pair of values at once and the 32 lanes reading
//    a pair of columns of 32 consecutive rows hit distinct banks.
//  - A task is a feature pair and a 32-row slice, described once a block in
//    shared memory (offsets, tree addresses, clips, NaN bins); a warp takes
//    two tasks at a time, so each lane runs four independent searches level
//    by level and their dependent loads overlap. Index arithmetic inside a
//    tile is 32-bit.
//  - The bins go to a shared tile [R, features], a pair at a time, and leave
//    it as 16-byte words when the table covers every output column and
//    `out` is 16-byte aligned (the tile's rows are then contiguous bytes of
//    `out`); otherwise each bin is stored to its own column, leaving the
//    others untouched.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 256;       // threads of a row group
constexpr int kMaxThreads = 1024;
constexpr int kSlots = 4;         // searches in flight a lane

// One task of a tile: a feature pair (2q, 2q + 1) and a 32-row slice (32
// bytes, staged in shared memory once a block, read by a warp as one
// broadcast).
struct Task {
  uint32_t x;         // byte offset of (the slice's row 0, feature 2q) in a
                      // row buffer
  uint32_t o;         // byte offset of the same in the bins tile
  uint32_t lo[2];     // each feature's tree: shared address, or byte offset
                      // from the tile's trees in device memory
  uint32_t last;      // the clips: feature 2q's low 16 bits, 2q + 1's high
  int32_t nan_bin[2];
  uint32_t meta;      // bits 0-15: the slice's first row; 16-20, 21-25: the
                      // two trees' depths; 31: no feature 2q + 1
};

struct Args {
  const void* x;
  int64_t n, ld;
  const int32_t* col;     // [Fn] source column
  const int32_t* dst;     // [Fn] output column
  const int32_t* nan_bin; // [Fn]
  const int32_t* last;    // [Fn]
  const int32_t* depth;   // [Fn]
  const int64_t* toff;    // [Fn + 1] tree offsets into `tree`
  const void* tree;       // the rows' type, [toff[Fn]]
  const int32_t* tiles;   // [n_tiles + 1] feature ranges
  const uint8_t* staged;  // [n_tiles] 1: the tile's trees in shared memory
  int rows;               // R, a multiple of 32
  int dense_out;          // 1: one tile over every output column, aligned
  void* out;
  int64_t U;
};

__host__ __device__ __forceinline__ int align16(int64_t b) {
  return static_cast<int>((b + 15) & ~int64_t(15));
}

// The staged row pitch, in values, of a tile of tf features: tf rounded up
// to even, plus 2 when that is a multiple of 4. A pitch of 2 mod 4 keeps
// value pairs 8-byte aligned (16 for doubles), and the 32 lanes reading one
// pair of columns of 32 consecutive rows hit distinct banks.
__host__ __device__ __forceinline__ int row_pitch(int tf) {
  const int even = tf + (tf & 1);
  return even + ((even & 3) == 0 ? 2 : 0);
}

// Tasks of a tile: feature pairs times 32-row slices.
__host__ __device__ __forceinline__ int tile_tasks(int tf, int R) {
  return ((tf + 1) >> 1) * ((R + 31) >> 5);
}

// Shared bytes of a tile of tf features whose trees hold `words` elements
// (staged or not), R rows a row tile, G row groups (ops/bin_cuda.py
// mirrors it): the trees, the features' columns, output columns and tasks
// once, then each group's two row buffers and bins.
struct Layout {
  int tree, col, dst, task, buf, out, group, total;
  __host__ __device__ Layout(int tf, int64_t words, bool staged, int R,
                             int es, int ob, int G) {
    tree = staged ? align16(words * es) : 0;
    col = align16(int64_t(tf) * 4);
    dst = align16(int64_t(tf) * 4);
    task = align16(int64_t(tile_tasks(tf, R)) * sizeof(Task));
    buf = align16(int64_t(R) * row_pitch(tf) * es);
    out = align16(int64_t(R) * tf * ob);
    group = 2 * buf + out;
    total = tree + col + dst + task + G * group;
  }
};

template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(smem), "l"(gmem), "n"(kBytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one of this thread's copy groups is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The barrier of row group g alone (barrier 0 is the block's).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(g + 1), "n"(kGroup) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A node of a staged tree at shared address `a` (no memory clobber: the
// trees do not change once staged, so the compiler may schedule freely).
template <typename T>
__device__ __forceinline__ T ld_shared(uint32_t a);
template <>
__device__ __forceinline__ float ld_shared<float>(uint32_t a) {
  float v;
  asm("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}
template <>
__device__ __forceinline__ double ld_shared<double>(uint32_t a) {
  double v;
  asm("ld.shared.f64 %0, [%1];" : "=d"(v) : "r"(a));
  return v;
}

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// Row tile of `rows` rows from row `row0` into the buffer at shared
// address `buf` ([R, P] values) by the group's threads (gt its thread):
// value (r, j) from x[(row0 + r) ld + col_j], by cp.async. `pairs`: the
// block's columns are every column of the rows in order, tf is even and x
// is aligned to a pair, so the tile is one run of rows * tf values copied
// a pair at a time; otherwise one value at a time.
template <typename T>
__device__ __forceinline__ void load_tile(uint32_t buf, const T* x,
                                          int64_t ld, int64_t row0,
                                          int rows, int tf, int P,
                                          const int32_t* s_col, bool pairs,
                                          int gt) {
  constexpr int es = sizeof(T);
  if (pairs) {
    const int half = tf >> 1;
    const int E = rows * half;
    const T* src = x + row0 * ld;
    int r = gt / half, j = gt - r * half;
    const int dr = kGroup / half, dj = kGroup - dr * half;
    for (int e = gt; e < E; e += kGroup) {
      cp_async<2 * es>(buf + (r * P + 2 * j) * es, src + 2 * e);
      r += dr;
      j += dj;
      if (j >= half) {
        j -= half;
        ++r;
      }
    }
    return;
  }
  const int E = rows * tf;
  int r = gt / tf, j = gt - r * tf;
  const int dr = kGroup / tf, dj = kGroup - dr * tf;
  for (int e = gt; e < E; e += kGroup) {
    cp_async<es>(buf + (r * P + j) * es, x + (row0 + r) * ld + s_col[j]);
    r += dr;
    j += dj;
    if (j >= tf) {
      j -= tf;
      ++r;
    }
  }
}

// The tree node at a: a staged tree's at shared address a, the others' at
// byte offset a of `gtree`.
template <typename T, bool kStaged>
__device__ __forceinline__ T node_at(uint32_t a, const unsigned char* gtree) {
  return kStaged ? ld_shared<T>(a)
                 : __ldg(reinterpret_cast<const T*>(gtree + a));
}

// kSlots descents of kD levels (kD = 0: D levels), level by level: each
// a = lo + es k (node k of a tree at lo) becomes lo + es (2k + (tree[k] <
// v)) = 2a + c0, plus es when tree[k] < v (c0 = -lo).
template <typename T, bool kStaged, int kD>
__device__ __forceinline__ void descend(uint32_t (&a)[kSlots],
                                        const uint32_t (&c0)[kSlots],
                                        const T (&v)[kSlots],
                                        const unsigned char* gtree, int D) {
  constexpr uint32_t es = sizeof(T);
#pragma unroll
  for (int l = 0; l < (kD ? kD : D); ++l) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const T node = node_at<T, kStaged>(a[s], gtree);
      a[s] = 2 * a[s] + c0[s];
      if (node < v[s]) a[s] += es;
    }
  }
}

// Search one row tile by the group's warps (gt: the group's thread). A
// warp takes kSlots / 2 tasks (s_task) at a time (a dead task repeats the
// first and writes nothing); each lane reads its row's pair of values at
// once and runs four searches level by level. D > 0: every tree of the
// tile has depth D (one loop for the four); D = 0: each slot descends its
// own depth (a table past 255 bounds a feature mixes depths). Bins into
// s_out [R, tf], a pair at a time when tf is even.
template <typename T, typename OutT, bool kStaged>
__device__ __forceinline__ void bin_tile(const T* buf, OutT* s_out, int P,
                                         int rows, int tf, int tasks, int D,
                                         const Task* s_task,
                                         const unsigned char* gtree,
                                         int gt) {
  using T2 = typename Pair<T>::type;
  constexpr uint32_t es = sizeof(T);
  constexpr int kTasks = kSlots / 2;
  constexpr int warps = kGroup / 32;
  const int lane = gt & 31;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(buf) +
                            lane * P * es;
  unsigned char* ob = reinterpret_cast<unsigned char*>(s_out) +
                      lane * tf * sizeof(OutT);
  for (int t0 = (gt >> 5) * kTasks; t0 < tasks; t0 += warps * kTasks) {
    T v[kSlots];
    uint32_t a[kSlots], c0[kSlots];
    int depth[kSlots];
    bool nan[kSlots];
    Task d[kTasks];
#pragma unroll
    for (int u = 0; u < kTasks; ++u) {
      d[u] = s_task[t0 + u < tasks ? t0 + u : t0];
      const T2 x2 = *reinterpret_cast<const T2*>(xb + d[u].x);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = 2 * u + h;
        const T x = h ? x2.y : x2.x;
        nan[s] = isnan(x);
        v[s] = nan[s] ? T(0) : x;
        c0[s] = 0u - d[u].lo[h];
        a[s] = d[u].lo[h] + es;           // node 1, the root
        depth[s] = D ? D : (d[u].meta >> (16 + 5 * h)) & 31;
      }
    }
    if (D == 8) {
      descend<T, kStaged, 8>(a, c0, v, gtree, D);
    } else if (D) {
      descend<T, kStaged, 0>(a, c0, v, gtree, D);
    } else {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        for (int l = 0; l < depth[s]; ++l) {
          const T node = node_at<T, kStaged>(a[s], gtree);
          a[s] = 2 * a[s] + c0[s];
          if (node < v[s]) a[s] += es;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kTasks; ++u) {
      const int row = static_cast<int>(d[u].meta & 0xffffu) + lane;
      if (t0 + u >= tasks || row >= rows) continue;
      uint32_t bin[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = 2 * u + h;
        const uint32_t last = h ? d[u].last >> 16 : d[u].last & 0xffffu;
        uint32_t b = (a[s] + c0[s]) / es - (1u << depth[s]);
        b = b < last ? b : last;
        if (nan[s] && d[u].nan_bin[h] >= 0) b = d[u].nan_bin[h];
        bin[h] = b;
      }
      OutT* o = reinterpret_cast<OutT*>(ob + d[u].o);
      if ((tf & 1) == 0) {
        using O2 = typename std::conditional<sizeof(OutT) == 1, uint16_t,
                                             uint32_t>::type;
        *reinterpret_cast<O2*>(o) = static_cast<O2>(
            bin[0] | (bin[1] << (8 * sizeof(OutT))));
      } else {
        o[0] = static_cast<OutT>(bin[0]);
        if (!(d[u].meta >> 31)) o[1] = static_cast<OutT>(bin[1]);
      }
    }
  }
}

// A block stages the trees of its feature tile once and runs
// blockDim.x / kGroup row groups over them; each group walks row tiles
// grid-stride with its own buffers and barrier, so one group's copies,
// barriers and stores overlap another's searches.
template <typename T, typename OutT>
__global__ void __launch_bounds__(kMaxThreads) bin_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.y;
  const int f0 = a.tiles[tile];
  const int tf = a.tiles[tile + 1] - f0;
  const bool staged = a.staged[tile] != 0;
  const int64_t g0 = a.toff[f0];
  const int64_t words = a.toff[f0 + tf] - g0;
  const int R = a.rows;
  const int P = row_pitch(tf);
  const int G = blockDim.x / kGroup;
  const int g = threadIdx.x / kGroup, gt = threadIdx.x % kGroup;
  const Layout lay(tf, words, staged, R, sizeof(T), sizeof(OutT), G);
  unsigned char* p = smem;
  T* s_tree = reinterpret_cast<T*>(p);
  p += lay.tree;
  int32_t* s_col = reinterpret_cast<int32_t*>(p);
  p += lay.col;
  int32_t* s_dst = reinterpret_cast<int32_t*>(p);
  p += lay.dst;
  Task* s_task = reinterpret_cast<Task*>(p);
  p += lay.task + g * lay.group;
  unsigned char* const s_bufs = p;
  OutT* s_out = reinterpret_cast<OutT*>(p + 2 * lay.buf);

  // the columns first: the first row tile's copy starts before the trees
  // are staged
  int whole = 1;
  for (int i = threadIdx.x; i < tf; i += blockDim.x) {
    const int c = a.col[f0 + i];
    s_col[i] = c;
    s_dst[i] = a.dst[f0 + i];
    whole &= (c == i);
  }
  const T* x = static_cast<const T*>(a.x);
  // copies by pairs: the rows are exactly the block's columns, in order,
  // an even number of them, and x is aligned to a pair
  const bool pairs = __syncthreads_and(whole) && tf == a.ld &&
                     (tf & 1) == 0 &&
                     reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0;
  const int64_t n = a.n;
  const int64_t row_tiles = (n + R - 1) / R;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * G;
  const uint32_t bufs = smem_addr(s_bufs);
  int64_t t = static_cast<int64_t>(blockIdx.x) * G + g;
  // the first row tile's copy starts before the trees are staged
  if (t < row_tiles) {
    const int rows = static_cast<int>(n - t * R < R ? n - t * R : R);
    load_tile(bufs, x, a.ld, t * R, rows, tf, P, s_col, pairs, gt);
  }
  cp_async_commit();

  const T* tree = static_cast<const T*>(a.tree) + g0;
  if (staged) {
    for (int64_t i = threadIdx.x; i < words; i += blockDim.x)
      s_tree[i] = tree[i];
  }
  // the tasks, pair-major (an odd tf's last pair searches its last feature
  // twice and writes it once)
  const int lg_slices = 31 - __clz(R >> 5);
  const int tasks = tile_tasks(tf, R);
  const uint32_t tree_lo = staged ? smem_addr(s_tree) : 0u;
  constexpr uint32_t es = sizeof(T), ob = sizeof(OutT);
  for (int i = threadIdx.x; i < tasks; i += blockDim.x) {
    const int q = i >> lg_slices, r0 = (i & ((1 << lg_slices) - 1)) << 5;
    const int f = f0 + 2 * q, f2 = 2 * q + 1 < tf ? f + 1 : f;
    Task k;
    k.x = (r0 * P + 2 * q) * es;
    k.o = (r0 * tf + 2 * q) * ob;
    k.lo[0] = tree_lo + es * static_cast<uint32_t>(a.toff[f] - g0);
    k.lo[1] = tree_lo + es * static_cast<uint32_t>(a.toff[f2] - g0);
    k.last = static_cast<uint32_t>(a.last[f]) |
             (static_cast<uint32_t>(a.last[f2]) << 16);
    k.nan_bin[0] = a.nan_bin[f];
    k.nan_bin[1] = a.nan_bin[f2];
    k.meta = r0 | (static_cast<uint32_t>(a.depth[f]) << 16) |
             (static_cast<uint32_t>(a.depth[f2]) << 21) |
             (f2 == f ? 0x80000000u : 0u);
    s_task[i] = k;
  }
  // D: the tile's one tree depth, or 0 where depths differ
  int same = 1;
  for (int i = threadIdx.x; i < tf; i += blockDim.x)
    same &= a.depth[f0 + i] == a.depth[f0];
  const int D = __syncthreads_and(same) ? a.depth[f0] : 0;

  const unsigned char* gtree = reinterpret_cast<const unsigned char*>(tree);
  OutT* out = static_cast<OutT*>(a.out);
  // double-buffered: tile t in buffer `cur`, the next one into the other
  for (int cur = 0; t < row_tiles; t += stride, cur ^= 1) {
    const int64_t next = t + stride;
    if (next < row_tiles) {
      const int rows = static_cast<int>(
          n - next * R < R ? n - next * R : R);
      load_tile(bufs + (cur ^ 1) * lay.buf, x, a.ld, next * R, rows, tf, P,
                s_col, pairs, gt);
    }
    cp_async_commit();
    cp_async_wait_one();
    group_sync(g);
    const int rows = static_cast<int>(n - t * R < R ? n - t * R : R);
    const T* buf = reinterpret_cast<const T*>(s_bufs + cur * lay.buf);
    if (staged)
      bin_tile<T, OutT, true>(buf, s_out, P, rows, tf, tasks, D, s_task,
                              gtree, gt);
    else
      bin_tile<T, OutT, false>(buf, s_out, P, rows, tf, tasks, D, s_task,
                               gtree, gt);
    group_sync(g);
    if (a.dense_out) {
      // rows [tR, tR + rows) of `out` are rows * U contiguous bins
      const int bytes = rows * tf * static_cast<int>(sizeof(OutT));
      unsigned char* o = reinterpret_cast<unsigned char*>(out + t * R * a.U);
      const unsigned char* so = reinterpret_cast<const unsigned char*>(s_out);
      const int words16 = bytes >> 4;
      for (int w = gt; w < words16; w += kGroup)
        reinterpret_cast<int4*>(o)[w] = reinterpret_cast<const int4*>(so)[w];
      for (int b = (words16 << 4) + gt; b < bytes; b += kGroup)
        o[b] = so[b];
    } else {
      const int lane = gt & 31;
      for (int r = gt >> 5; r < rows; r += kGroup / 32) {
        OutT* orow = out + (t * R + r) * a.U;
        for (int j = lane; j < tf; j += 32)
          orow[s_dst[j]] = s_out[r * tf + j];
      }
    }
  }
}

template <typename T, typename OutT>
cudaError_t allow_smem(int bytes) {
  return cudaFuncSetAttribute(bin_kernel<T, OutT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// The kernel instantiation for (input bytes, output bytes); null for an
// unsupported pair.
const void* kernel_of(int in_bytes, int out_bytes) {
  if (in_bytes == 4 && out_bytes == 1)
    return reinterpret_cast<const void*>(bin_kernel<float, uint8_t>);
  if (in_bytes == 4 && out_bytes == 2)
    return reinterpret_cast<const void*>(bin_kernel<float, uint16_t>);
  if (in_bytes == 8 && out_bytes == 1)
    return reinterpret_cast<const void*>(bin_kernel<double, uint8_t>);
  if (in_bytes == 8 && out_bytes == 2)
    return reinterpret_cast<const void*>(bin_kernel<double, uint16_t>);
  return nullptr;
}

}  // namespace

// Raise every instantiation's dynamic shared-memory limit to the card's
// opt-in maximum, once per device; returns that maximum in bytes, or the
// negated cudaError_t.
extern "C" int lg_bin_setup(void) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = allow_smem<float, uint8_t>(max_smem);
  if (err == cudaSuccess) err = allow_smem<float, uint16_t>(max_smem);
  if (err == cudaSuccess) err = allow_smem<double, uint8_t>(max_smem);
  if (err == cudaSuccess) err = allow_smem<double, uint16_t>(max_smem);
  return err == cudaSuccess ? max_smem : -static_cast<int>(err);
}

// Resident blocks per SM of `threads` threads at `smem` bytes of dynamic
// shared memory (after lg_bin_setup); negative: the cudaError_t, or -1 for
// an unsupported width.
extern "C" int lg_bin_occupancy(int in_bytes, int out_bytes, int threads,
                                int smem) {
  const void* k = kernel_of(in_bytes, out_bytes);
  if (k == nullptr) return -1;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, k, threads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// The compiled kernel's registers a thread and local (spill) bytes a
// thread, into attrs[0..1]; 0, or the negated cudaError_t / -1.
extern "C" int lg_bin_attributes(int in_bytes, int out_bytes, int* attrs) {
  const void* k = kernel_of(in_bytes, out_bytes);
  if (k == nullptr) return -1;
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return -static_cast<int>(err);
  attrs[0] = fa.numRegs;
  attrs[1] = static_cast<int>(fa.localSizeBytes);
  return 0;
}

// x: float32 (in_bytes 4) or float64 (8) [n, ld] row-major, 4- / 8-byte
// aligned; col, dst, nan_bin, last, depth: int32 [Fn] per numerical
// feature; toff: int64 [Fn + 1], feature f's tree (the rows' type) at
// tree[toff[f] .. toff[f + 1]); tiles: int32 [n_tiles + 1] feature ranges;
// staged: u8 [n_tiles]; rows: R a row tile (a multiple of 32); dense_out:
// 1 when one tile covers every output
// column in order and `out` is 16-byte aligned; smem: dynamic shared bytes
// of the largest tile; nblk x n_tiles blocks of `threads` threads (row
// groups of 256); out: u8 (out_bytes 1) or u16 (2) [n, U].
// Returns 0 on success, -1 for an unsupported width, otherwise the
// cudaError_t of the launch.
extern "C" int lg_bin_rows(const void* x, int in_bytes, int64_t n, int64_t ld,
                           const int32_t* col, const int32_t* dst,
                           const int32_t* nan_bin, const int32_t* last,
                           const int32_t* depth, const int64_t* toff,
                           const void* tree, const int32_t* tiles,
                           const uint8_t* staged, int n_tiles, int rows,
                           int dense_out, int smem, int nblk, int threads,
                           void* out, int out_bytes, int64_t U,
                           void* stream) {
  const void* k = kernel_of(in_bytes, out_bytes);
  if (k == nullptr) return -1;
  Args a{x, n, ld, col, dst, nan_bin, last, depth, toff, tree, tiles,
         staged, rows, dense_out, out, U};
  void* params[] = {&a};
  const cudaError_t err = cudaLaunchKernel(
      k, dim3(nblk, n_tiles), dim3(threads), params, smem,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}
