// Compiled-forest traversal kernel (K3) for Hopper (sm_90a).
//
// Replaces: lambdagap_tpu/infer/engine.py `_traverse_kernel` (:68-119), the
// Pallas kernel that `_traverse_block` launches once per node block and
// `_traverse_all` runs over every block of a compiled artifact.
//
// What it computes: for every row r and every structure group g of the
// artifact, the node carry starts at the group's root and takes `depth`
// breadth-first steps through the group's node block; each step decodes the
// node's palette codes (feature id, threshold code, flags, category-bitset
// row) and applies the reference's decision rules (NaN -> 0 unless the node
// is NaN-missing; missing values follow default-left; a categorical value
// goes left iff its bit is set). The result is `~leaf` for each (row,
// group): out[r * groups + g], int32.
//
// What bounds it on this card: bytes. Per call the kernel must read the
// rows (R x F x 4 B) and the node tables once, and write the carry
// (R x G x 4 B); the carry dominates at serving batch sizes (4096 rows x
// 500 groups = 8 MB against 0.46 MB of rows and under 2 MB of node
// tables). The arithmetic is one f32 compare and a few integer ops per
// step, far below the f32 rate. In practice each step is a chain of
// dependent loads (node record -> feature value -> threshold palette),
// so the kernel is latency-bound until enough threads are in flight.
//
// What the design does about it:
//  - one thread per (row, group), group index fastest: the carry writes
//    of a warp are contiguous (coalesced), and a warp reads one row, so
//    the row's feature values come from L1 after the first step;
//  - the node tables stay in device memory and are read through L1/L2:
//    the whole forest's tables (under 2 MB for 500 trees of 255 leaves)
//    fit the 50 MB L2, so after the first touch every node read is an L2
//    hit. Staging a node block in shared memory is later work: the
//    artifact's default block of 512 KB (kept so the artifact bytes equal
//    the JAX package's) exceeds the 227 KB a block may use;
//  - ONE launch covers every node block: the host gives each group its
//    block's node offset and depth (`gbase`, `gdepth`), where the JAX
//    package launches once per block;
//  - palette codes are read at their artifact width (u8/u16/u32 through a
//    template switch) — the artifact is never widened;
//  - the ragged edge is masked in-kernel (no row padding);
//  - built WITHOUT --use_fast_math, so the NaN test and the |v| <= 1e-35
//    zero-missing test survive compilation; float -> int uses
//    __float2int_rz, which saturates like XLA's convert (1e10 -> INT_MAX).
//
// Plain C interface for ctypes (no PyTorch headers): the wrapper is
// `traverse_forest` in lambdagap_tpu_torch/infer/engine.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFlagDefaultLeft = 1;
constexpr int kFlagMtShift = 1;
constexpr int kFlagCategorical = 8;
constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;
constexpr float kZeroThreshold = 1e-35f;
constexpr int kThreads = 256;

template <typename FeatT, typename ThrT, typename CatT>
__global__ void traverse_kernel(
    const float* __restrict__ x, int64_t rows, int64_t x_stride,
    const FeatT* __restrict__ feat, const ThrT* __restrict__ thr,
    const uint8_t* __restrict__ flags, const CatT* __restrict__ catc,
    const int32_t* __restrict__ left, const int32_t* __restrict__ right,
    const float* __restrict__ thr_tab, const uint32_t* __restrict__ cat_tab,
    int cat_words, const int32_t* __restrict__ root,
    const int32_t* __restrict__ gbase, const int32_t* __restrict__ gdepth,
    int64_t groups, int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * groups) return;
  const int64_t r = i / groups;
  const int64_t g = i - r * groups;
  const float* xr = x + r * x_stride;
  const int32_t base = gbase[g];
  const int32_t depth = gdepth[g];
  const int32_t nbits = cat_words * 32;
  int32_t node = root[g];
  for (int32_t d = 0; d < depth && node >= 0; ++d) {
    const int64_t n = static_cast<int64_t>(base) + node;
    const int fl = flags[n];
    const float v = xr[static_cast<int64_t>(feat[n])];
    const bool nan = v != v;  // isnan; exact without fast-math
    bool go;
    if (fl & kFlagCategorical) {
      const int32_t cat = nan ? -1 : __float2int_rz(v);
      go = false;
      if (cat >= 0 && cat < nbits) {
        const uint32_t word =
            cat_tab[static_cast<int64_t>(catc[n]) * cat_words + (cat >> 5)];
        go = ((word >> (cat & 31)) & 1u) != 0u;
      }
    } else {
      const int mt = (fl >> kFlagMtShift) & 3;
      // NaN converted to 0 unless NaN-missing (reference: tree.h
      // NumericalDecision)
      const float v0 = (nan && mt != kMissingNan) ? 0.0f : v;
      const bool missing = (mt == kMissingNan && nan) ||
                           (mt == kMissingZero && fabsf(v0) <= kZeroThreshold);
      go = missing ? ((fl & kFlagDefaultLeft) != 0)
                   : (v0 <= thr_tab[static_cast<int64_t>(thr[n])]);
    }
    node = go ? left[n] : right[n];
  }
  out[i] = node;
}

template <typename FeatT, typename ThrT, typename CatT>
int launch(const float* x, int64_t rows, int64_t x_stride, const void* feat,
           const void* thr, const uint8_t* flags, const void* catc,
           const int32_t* left, const int32_t* right, const float* thr_tab,
           const uint32_t* cat_tab, int cat_words, const int32_t* root,
           const int32_t* gbase, const int32_t* gdepth, int64_t groups,
           int32_t* out, cudaStream_t stream) {
  const int64_t total = rows * groups;
  if (total == 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  traverse_kernel<FeatT, ThrT, CatT><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, rows, x_stride, static_cast<const FeatT*>(feat),
      static_cast<const ThrT*>(thr), flags, static_cast<const CatT*>(catc),
      left, right, thr_tab, cat_tab, cat_words, root, gbase, gdepth, groups,
      out);
  return static_cast<int>(cudaGetLastError());
}

template <typename FeatT, typename ThrT>
int dispatch_cat(int cat_bytes, const float* x, int64_t rows, int64_t x_stride,
                 const void* feat, const void* thr, const uint8_t* flags,
                 const void* catc, const int32_t* left, const int32_t* right,
                 const float* thr_tab, const uint32_t* cat_tab, int cat_words,
                 const int32_t* root, const int32_t* gbase,
                 const int32_t* gdepth, int64_t groups, int32_t* out,
                 cudaStream_t stream) {
  switch (cat_bytes) {
    case 1:
      return launch<FeatT, ThrT, uint8_t>(x, rows, x_stride, feat, thr, flags, catc, left, right,
                                          thr_tab, cat_tab, cat_words, root, gbase, gdepth,
                                          groups, out, stream);
    case 2:
      return launch<FeatT, ThrT, uint16_t>(x, rows, x_stride, feat, thr, flags, catc, left, right,
                                           thr_tab, cat_tab, cat_words, root, gbase, gdepth,
                                           groups, out, stream);
    case 4:
      return launch<FeatT, ThrT, uint32_t>(x, rows, x_stride, feat, thr, flags, catc, left, right,
                                           thr_tab, cat_tab, cat_words, root, gbase, gdepth,
                                           groups, out, stream);
    default:
      return -1;
  }
}

template <typename FeatT>
int dispatch_thr(int thr_bytes, int cat_bytes, const float* x, int64_t rows,
                 int64_t x_stride, const void* feat, const void* thr,
                 const uint8_t* flags, const void* catc, const int32_t* left,
                 const int32_t* right, const float* thr_tab,
                 const uint32_t* cat_tab, int cat_words, const int32_t* root,
                 const int32_t* gbase, const int32_t* gdepth, int64_t groups,
                 int32_t* out, cudaStream_t stream) {
  switch (thr_bytes) {
    case 1:
      return dispatch_cat<FeatT, uint8_t>(cat_bytes, x, rows, x_stride, feat, thr, flags, catc,
                                          left, right, thr_tab, cat_tab, cat_words, root, gbase,
                                          gdepth, groups, out, stream);
    case 2:
      return dispatch_cat<FeatT, uint16_t>(cat_bytes, x, rows, x_stride, feat, thr, flags, catc,
                                           left, right, thr_tab, cat_tab, cat_words, root, gbase,
                                           gdepth, groups, out, stream);
    case 4:
      return dispatch_cat<FeatT, uint32_t>(cat_bytes, x, rows, x_stride, feat, thr, flags, catc,
                                           left, right, thr_tab, cat_tab, cat_words, root, gbase,
                                           gdepth, groups, out, stream);
    default:
      return -1;
  }
}

}  // namespace

// Returns 0 on success, -1 for an unsupported code width, otherwise the
// cudaError_t of the launch.
extern "C" int lg_traverse_forest(
    const float* x, int64_t rows, int64_t x_stride, const void* feat,
    int feat_bytes, const void* thr, int thr_bytes, const uint8_t* flags,
    const void* catc, int cat_bytes, const int32_t* left,
    const int32_t* right, const float* thr_tab, const uint32_t* cat_tab,
    int cat_words, const int32_t* root, const int32_t* gbase,
    const int32_t* gdepth, int64_t groups, int32_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat_bytes) {
    case 2:
      return dispatch_thr<uint16_t>(thr_bytes, cat_bytes, x, rows, x_stride, feat, thr, flags,
                                    catc, left, right, thr_tab, cat_tab, cat_words, root, gbase,
                                    gdepth, groups, out, s);
    case 4:
      return dispatch_thr<uint32_t>(thr_bytes, cat_bytes, x, rows, x_stride, feat, thr, flags,
                                    catc, left, right, thr_tab, cat_tab, cat_words, root, gbase,
                                    gdepth, groups, out, s);
    default:
      return -1;
  }
}
