// Shared pieces of the two leaf histogram kernels (hist.cu: K1, hist_q.cu:
// K2): the block's row range sized by the live count, the double-buffered
// row staging, and the lane mapping of the shared-memory adds.
//
// A block takes one contiguous range of a leaf's live positions and walks
// it in tiles of kTile rows, one row per thread. While the block adds tile
// k into its shared histogram, tile k+1 is already on its way: the bin
// bytes by cp.async straight into the other staging buffer (16-byte copies
// of the whole tile where the rows are contiguous and all features are in
// the block, 4-byte words of each gathered row otherwise), the row's
// per-row channels by plain loads into registers that are written to
// shared memory after the adds.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lg_hist {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;   // rows staged per step: one per thread

__host__ __device__ constexpr int align_up(int v, int a) {
  return (v + a - 1) / a * a;
}

// bytes of one staged row of a feature tile in shared memory: 4-byte
// aligned so gathered rows can be copied in words
__host__ __device__ constexpr int row_stride(int f_tile, int bin_bytes) {
  return align_up(f_tile * bin_bytes, 4);
}

// Shared histogram layout. Features are taken in slabs of W; slab s holds
// its W features' B bins as [B][W] words, padded by one word when W = 1:
//  - W = 1 is one padded row of B + 1 words per feature, so the features'
//    same bin falls in different banks;
//  - W = slab_width(f_tile) (min(32, the next power of two >= f_tile))
//    puts every bin of feature f in bank f % W, so the lanes of one add,
//    which take different features of a row (Lanes below), never share a
//    bank whatever the bins.
// Both give the same sums. Each kernel fixes its layout at compile time
// (kBankLayout: bank by feature in hist.cu, padded in hist_q.cu), the
// faster of the two for it on the H100 (PERF.md section 6, PR 4).
__host__ __device__ constexpr int slab_width(int f_tile) {
  return f_tile > 16 ? 32 : f_tile > 8 ? 16 : f_tile > 4 ? 8
         : f_tile > 2 ? 4 : f_tile > 1 ? 2 : 1;
}

// the slab width of the bank (true) or padded (false) layout
__host__ __device__ constexpr int layout_slab(bool bank, int f_tile) {
  return bank ? slab_width(f_tile) : 1;
}

// words of one slab
__host__ __device__ constexpr int slab_words(int W, int num_bins) {
  return num_bins * W + (W == 1 ? 1 : 0);
}

// 32-bit words of one shared histogram array of an f_tile-feature block
__host__ __device__ constexpr int hist_words(int f_tile, int W,
                                             int num_bins) {
  return (f_tile + W - 1) / W * slab_words(W, num_bins);
}

// the word of (feature f, bin 0); bin b is W words further on per bin
__device__ __forceinline__ int hist_base(int f, int W, int num_bins) {
  return (f / W) * slab_words(W, num_bins) + f % W;
}

// (feature, bin) of word j, for the flushes; false for a padding word
__device__ __forceinline__ bool hist_coords(int j, int W, int num_bins,
                                           int nf, int* f, int* b) {
  const int sw = slab_words(W, num_bins);
  const int slab = j / sw;
  const int r = j - slab * sw;
  *b = r / W;
  *f = slab * W + (r - *b * W);
  return *b < num_bins && *f < nf;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The block's contiguous range [r0, r1) of the live positions; false when
// it has none. count (read on the device when count_ptr is set) is clamped
// to the positions that exist; each block takes `per` positions, at least
// min_rows and a multiple of kTile, so the blocks that get work are
// ceil(count / per) and the rest exit before touching shared memory.
__device__ __forceinline__ bool block_range(const int32_t* count_ptr,
                                            int64_t count_const,
                                            int64_t avail, int min_rows,
                                            int64_t* r0, int64_t* r1) {
  int64_t count = count_ptr != nullptr ? (int64_t)(*count_ptr) : count_const;
  count = count < 0 ? 0 : (count > avail ? avail : count);
  const int64_t nblk = gridDim.x;
  int64_t per = (count + nblk - 1) / nblk;
  per = per < min_rows ? min_rows : per;
  per = (per + kTile - 1) / kTile * kTile;
  const int64_t lo = (int64_t)blockIdx.x * per;
  if (lo >= count) return false;
  *r0 = lo;
  *r1 = (lo + per) < count ? (lo + per) : count;
  return true;
}

// How a block stages the bin bytes of its feature tile [f0, f0 + nf).
enum StageMode { kLinear = 0, kWords = 1, kBytes = 2 };

template <typename BinT>
__device__ __forceinline__ int stage_mode(const BinT* bins, int64_t F,
                                          int64_t f0, int nf,
                                          const int32_t* rows) {
  const int esz = (int)sizeof(BinT);
  const uintptr_t base = reinterpret_cast<uintptr_t>(bins);
  if (rows == nullptr && nf == F && (base & 15u) == 0 &&
      (F * esz) == row_stride(nf, esz))
    return kLinear;
  if ((base & 3u) == 0 && ((F * esz) & 3) == 0 && ((f0 * esz) & 3) == 0)
    return kWords;
  return kBytes;
}

// Start the copy of the bin bytes of tile rows [0, n) into `dst` (row
// stride row_stride(nf)). rid is this thread's row id (row tid of the
// tile; unused when tid >= n). kLinear and kWords copy asynchronously
// (cp.async, committed by the caller); kBytes stores directly.
template <typename BinT>
__device__ __forceinline__ void stage_bins(const BinT* __restrict__ bins,
                                           int64_t F, int64_t f0, int nf,
                                           int mode, int64_t t0, int n,
                                           int32_t rid, unsigned char* dst) {
  const int tid = threadIdx.x;
  const int esz = (int)sizeof(BinT);
  const int rs = row_stride(nf, esz);
  if (mode == kLinear) {
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(bins) + t0 * F * esz;
    const int nbytes = n * (int)F * esz;
    const int nvec = nbytes >> 4;
    for (int i = tid; i < nvec; i += kThreads)
      cp_async16(dst + i * 16, src + i * 16);
    for (int i = (nvec << 4) + tid; i < nbytes; i += kThreads) dst[i] = src[i];
    return;
  }
  if (mode == kWords) {
    if (tid < n) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          bins + (int64_t)rid * F + f0);
      const int nw = rs >> 2;
      for (int w = 0; w < nw; ++w)
        cp_async4(dst + tid * rs + w * 4, src + w * 4);
    }
    return;
  }
  if (tid < n) {
    BinT* d = reinterpret_cast<BinT*>(dst + tid * rs);
    const BinT* s = bins + (int64_t)rid * F + f0;
    for (int f = 0; f < nf; ++f) d[f] = s[f];
  }
}

// The lane mapping of the adds: a warp covers fw features of rps rows at
// once (fw = min(nf, 32), rps = 32 / fw), so the lanes of one add hit
// different features' histograms — one bin hit by every row (a skewed
// feature) is never the same address twice within an instruction.
struct Lanes {
  int fw, rps, sub, fl;
  bool active;
  __device__ __forceinline__ explicit Lanes(int nf) {
    const int lane = threadIdx.x & 31;
    fw = nf < 32 ? nf : 32;
    rps = 32 / fw;
    sub = lane / fw;
    fl = lane - sub * fw;
    active = sub < rps;
  }
};

}  // namespace lg_hist
