// Quantized-gradient leaf histogram kernel (K2) for Hopper (sm_90a).
//
// Replaces: lambdagap_tpu/ops/hist_pallas.py `_hist_kernel_q` (:207-232),
// the Pallas kernel that `hist_pallas_q` launches (:258) for every leaf
// histogram of `use_quantized_grad=true`: an int8 one-hot matmul on the
// TPU's matrix unit with exact int32 accumulation.
//
// What it computes: for the first `count` positions p of a leaf (a row
// list, position p is row `rows[offset + p]`; or, with no list, a window
// of a leaf-ordered copy, tree_layout=sorted: row `offset + p` of bins,
// gq, hq and mask alike), the sums of the row's int8 gradient levels
// (g_q, h_q) and of 1 into the bin of every feature, skipping rows an
// optional in-bag mask (u8 [N]) leaves out: out[f][b] = (sum g_q, sum
// h_q, in-bag count), int32 [F, B, 3]. Positions at or past `count` are
// never read; `count` and `offset` may live in device memory. The caller keeps every sum below 2^31 (the JAX
// package's exact_accum_limit("pallas"): rows x num_grad_quant_bins
// < 2^31 - 1) and the levels in the quantizer's range: g_q in [-128, 127],
// h_q in [0, 127]. The kernel does not check h_q: word B takes it as 8
// unsigned bits, so a negative level gives undefined sums (the wrapper
// refuses one on the CPU, where the check costs no host read).
//
// What bounds it on this card: the rate of shared-memory atomics. The
// floor is bytes: each live row is read once (F bin bytes, 2 level bytes,
// 1 mask byte, 4 B of row id with a list) and the [F, B, 3] result is
// written once — at the HIGGS root (10.5M rows x 28 u8 features, no row
// list) ~326 MB, ~0.097 ms at 3.35 TB/s. But each in-bag (row, feature)
// costs two shared-memory atomics, ~0.47G at the masked root, and at
// ~1.0T lane-adds/s those take ~5x the byte floor (PERF.md section 6,
// PR 4). At a small leaf the bound is each block's fixed cost.
//
// What the design does about it: integer sums do not depend on the order
// of the adds, so the kernel is bit-identical from run to run with plain
// atomics, and
//  - each (row, feature) costs TWO shared-memory 32-bit atomicAdds instead
//    of one per channel. A single packed 64-bit word would need a 64-bit
//    shared atomicAdd, which is not native on sm_90a (it compiles to a
//    compare-and-swap loop, ATOMS.CAST.SPIN.64), so the packing takes two
//    native 32-bit words:
//        word A = sum of g_q                (int32)
//        word B = (sum of h_q << 13) + count (unsigned; count in bits
//                 0..12, h in bits 13..31)
//    A row adds g_q to A and (h_q << 13) + 1 to B, nothing out of the bag.
//    Word A is exact for the whole launch under the caller's bound. Word
//    B's fields never carry into each other as long as a block adds at
//    most kFlushRows = 4,096 rows between flushes: count <= 4,096 < 2^13
//    and 4,096 x 127 = 520,192 < 2^19;
//  - every kFlushRows rows a block unpacks its non-empty B words, adds
//    h and count into the output with global int32 atomics and zeroes
//    them; at its end it adds word A the same way;
//  - the row staging (cp.async, double-buffered, 16-byte copies at the
//    root and 4-byte words of gathered rows), the lane mapping, the grid
//    sized by the card and the live rows, and the once-per-device shared
//    memory setup are K1's. Its shared histogram is the padded layout
//    (hist_common.cuh: one row of B + 1 words per feature), not K1's bank
//    by feature, which made K2 slower on the H100 (PERF.md section 6,
//    PR 4). The two words take 8 B per (feature, bin), ~57 KB at HIGGS
//    width, so two blocks fit an SM.

#include "hist_common.cuh"

using namespace lg_hist;

namespace {

constexpr int kFlushRows = 4096;
constexpr int kFlushTiles = kFlushRows / kTile;
constexpr int kCountBits = 13;
constexpr unsigned kCountMask = (1u << kCountBits) - 1u;
// one padded row per feature: K2 is faster so on the H100. The kernel
// takes the slab width W (1) as an argument: with W a compile-time 1, the
// code nvcc made was 11-15% slower at the HIGGS root (PERF.md section 6,
// PR 4)
constexpr bool kBankLayout = false;

// Shared layout of one block (f_tile features, B bins), each histogram
// array in the padded layout (hist_common.cuh; kBankLayout):
//   s_a   int32 hist_words               word A: sum of g_q
//   s_b   u32 hist_words                 word B: (sum of h_q << 13) + count
//   s_w   uint2 [2, kTile]               staged (A, B) row words
//   s_bin [2, kTile, row_stride]         staged bin bytes
__host__ __device__ inline int smem_bytes(int bin_bytes, int f_tile,
                                          int num_bins) {
  const int W = layout_slab(kBankLayout, f_tile);
  return align_up(hist_words(f_tile, W, num_bins) * 8, 16) + 2 * kTile * 8 +
         2 * kTile * row_stride(f_tile, bin_bytes);
}

// Add the block's non-empty B words (and, at the end, its A words) into
// out and zero them.
__device__ __forceinline__ void flush(const int* s_a, unsigned* s_b, int nf,
                                      int B, int W, int used, int64_t f0,
                                      bool last, int32_t* __restrict__ out) {
  __syncthreads();
  for (int j = threadIdx.x; j < used; j += kThreads) {
    int f, b;
    if (!hist_coords(j, W, B, nf, &f, &b)) continue;
    int32_t* o = out + ((f0 + f) * B + b) * 3;
    const unsigned w = s_b[j];
    if (w != 0u) {
      s_b[j] = 0u;
      const int hq = (int)(w >> kCountBits);
      if (hq != 0) atomicAdd(o + 1, hq);
      atomicAdd(o + 2, (int)(w & kCountMask));
    }
    if (last && s_a[j] != 0) atomicAdd(o + 0, s_a[j]);
  }
  __syncthreads();
}

template <typename BinT>
__global__ void __launch_bounds__(kThreads)
hist_q_kernel(const BinT* __restrict__ bins, int64_t F,
              const int8_t* __restrict__ gq, const int8_t* __restrict__ hq,
              const uint8_t* __restrict__ mask,
              const int32_t* __restrict__ rows,
              const int32_t* __restrict__ offset_ptr, int64_t P,
              const int32_t* __restrict__ count_ptr, int64_t count_const,
              int num_bins, int f_tile, int W, int min_rows,
              int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = num_bins;
  const int64_t f0 = (int64_t)blockIdx.y * f_tile;
  const int nf = (int)((F - f0) < f_tile ? (F - f0) : f_tile);
  const int used = hist_words(nf, W, B);   // words this block touches
  const int rs = row_stride(nf, (int)sizeof(BinT));

  const int64_t off = offset_ptr != nullptr ? (int64_t)(*offset_ptr) : 0;
  int64_t r0, r1;
  if (!block_range(count_ptr, count_const, P - off, min_rows, &r0, &r1))
    return;
  const int32_t* rw = rows != nullptr ? rows + off : nullptr;
  if (rows == nullptr) {   // a window: every per-row array from `off` on
    bins += off * F;
    gq += off;
    hq += off;
    if (mask != nullptr) mask += off;
  }

  const int words = hist_words(f_tile, W, B);
  int* s_a = reinterpret_cast<int*>(smem);
  unsigned* s_b = reinterpret_cast<unsigned*>(s_a + words);
  uint2* s_w = reinterpret_cast<uint2*>(smem + align_up(words * 8, 16));
  unsigned char* s_bin = reinterpret_cast<unsigned char*>(s_w + 2 * kTile);
  const int stage_stride = kTile * row_stride(f_tile, (int)sizeof(BinT));

  const int tid = threadIdx.x;
  for (int i = tid; i < used; i += kThreads) {
    s_a[i] = 0;
    s_b[i] = 0u;
  }
  const int mode = stage_mode(bins, F, f0, nf, rw);

  int32_t rid = 0;
  int8_t g = 0, h = 0;
  uint8_t m = 0;
  auto load_row = [&](int64_t t, int n) {
    if (tid < n) {
      const int64_t p = t + tid;
      rid = rw != nullptr ? rw[p] : (int32_t)p;
      m = mask != nullptr ? mask[rid] : (uint8_t)1;
      g = gq[rid];
      h = hq[rid];
    }
  };
  auto store_row = [&](int buf, int n) {
    if (tid < n) {
      s_w[buf * kTile + tid] =
          m != 0 ? make_uint2((unsigned)(int)g,
                              ((unsigned)(uint8_t)h << kCountBits) + 1u)
                 : make_uint2(0u, 0u);
    }
  };

  int n = (int)((r1 - r0) < kTile ? (r1 - r0) : kTile);
  load_row(r0, n);
  stage_bins(bins, F, f0, nf, mode, r0, n, rid, s_bin);
  cp_async_commit();
  store_row(0, n);

  const Lanes L(nf);
  const int warp = tid >> 5;
  int buf = 0;
  int tiles = 0;
  for (int64_t t = r0; t < r1; t += kTile, buf ^= 1) {
    n = (int)((r1 - t) < kTile ? (r1 - t) : kTile);
    const int64_t tn = t + kTile;
    const int nn = tn < r1 ? (int)((r1 - tn) < kTile ? (r1 - tn) : kTile) : 0;
    if (nn > 0) {
      load_row(tn, nn);
      stage_bins(bins, F, f0, nf, mode, tn, nn, rid,
                 s_bin + (buf ^ 1) * stage_stride);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (tiles == kFlushTiles) {
      flush(s_a, s_b, nf, B, W, used, f0, false, out);
      tiles = 0;
    }

    const unsigned char* sb = s_bin + buf * stage_stride;
    const uint2* w = s_w + buf * kTile;
    for (int fb = 0; fb < nf; fb += L.fw) {
      const int f = fb + L.fl;
      if (!L.active || f >= nf) continue;
      const int base = hist_base(f, W, B);
      int* ha = s_a + base;
      unsigned* hb = s_b + base;
      for (int i = warp * L.rps + L.sub; i < n; i += kWarps * L.rps) {
        const uint2 wi = w[i];
        if (wi.y == 0u) continue;
        const int b = (int)reinterpret_cast<const BinT*>(sb + i * rs)[f];
        if (b >= B) continue;
        if (wi.x != 0u) atomicAdd(ha + b * W, (int)wi.x);
        atomicAdd(hb + b * W, wi.y);
      }
    }
    ++tiles;
    if (nn > 0) store_row(buf ^ 1, nn);
    __syncthreads();
  }
  flush(s_a, s_b, nf, B, W, used, f0, true, out);
}

template <typename BinT>
int launch(const void* bins, int64_t F, const int8_t* gq, const int8_t* hq,
           const uint8_t* mask, const int32_t* rows, const int32_t* offset_ptr,
           int64_t P, const int32_t* count_ptr, int64_t count_const,
           int num_bins, int nblk, int f_tile, int min_rows,
           int32_t* out, cudaStream_t stream) {
  const int smem = smem_bytes((int)sizeof(BinT), f_tile, num_bins);
  const dim3 grid((unsigned)nblk, (unsigned)((F + f_tile - 1) / f_tile));
  hist_q_kernel<BinT><<<grid, kThreads, smem, stream>>>(
      static_cast<const BinT*>(bins), F, gq, hq, mask, rows, offset_ptr, P,
      count_ptr, count_const, num_bins, f_tile,
      layout_slab(kBankLayout, f_tile), min_rows, out);
  return (int)cudaGetLastError();
}

template <typename Kernel>
cudaError_t max_shared(Kernel kernel, int max_smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (err != cudaSuccess) return err;
  // the largest shared-memory carveout, so the resident blocks the
  // occupancy query counts are the ones that run side by side
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Raise both instantiations' dynamic shared-memory limit to the device's
// opt-in maximum and prefer the largest shared carveout; once per device,
// before the first launch. Returns that maximum (bytes), or minus the
// cudaError_t.
extern "C" int lg_hist_q_setup(void) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = max_shared(hist_q_kernel<uint8_t>, max_smem);
  if (err == cudaSuccess) err = max_shared(hist_q_kernel<uint16_t>, max_smem);
  return err == cudaSuccess ? max_smem : -(int)err;
}

// Shared memory one block needs (bytes) at feature tile f_tile in the
// kernel's layout, for the wrapper's tile choice.
extern "C" int lg_hist_q_smem_bytes(int bin_bytes, int f_tile,
                                    int num_bins) {
  return smem_bytes(bin_bytes, f_tile, num_bins);
}

// Resident blocks per SM (after lg_hist_q_setup); negative: the
// cudaError_t of the query.
extern "C" int lg_hist_q_occupancy(int bin_bytes, int f_tile,
                                   int num_bins) {
  int blocks = 0;
  const int smem = smem_bytes(bin_bytes, f_tile, num_bins);
  const cudaError_t err =
      bin_bytes == 1
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, hist_q_kernel<uint8_t>, kThreads, smem)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, hist_q_kernel<uint16_t>, kThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// bins: u8/u16 [N, F] row-major; gq, hq: int8 [N]; mask: u8 [N] or null
// (every row in the bag); rows: int32 [P] or null (P = N: a window, position
// p is row offset + p); offset_ptr: one int32 on the device or null (0),
// position p reads rows[offset + p] (or row offset + p); count: *count_ptr when non-null, else count_const;
// out: int32 [F, num_bins, 3], zeroed by the caller. Returns 0 on success,
// -1 for an unsupported bin width, otherwise the cudaError_t of the launch.
extern "C" int lg_hist_rows_q(const void* bins, int bin_bytes, int64_t F,
                              const int8_t* gq, const int8_t* hq,
                              const uint8_t* mask, const int32_t* rows,
                              const int32_t* offset_ptr, int64_t P,
                              const int32_t* count_ptr, int64_t count_const,
                              int num_bins, int nblk, int f_tile,
                              int min_rows, int32_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1) {
    return launch<uint8_t>(bins, F, gq, hq, mask, rows, offset_ptr, P,
                           count_ptr, count_const, num_bins, nblk, f_tile,
                           min_rows, out, s);
  }
  if (bin_bytes == 2) {
    return launch<uint16_t>(bins, F, gq, hq, mask, rows, offset_ptr, P,
                            count_ptr, count_const, num_bins, nblk, f_tile,
                            min_rows, out, s);
  }
  return -1;
}
