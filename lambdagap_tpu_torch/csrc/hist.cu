// Leaf histogram kernel (K1) for Hopper (sm_90a).
//
// Replaces: lambdagap_tpu/ops/hist_pallas.py `_hist_kernel` (:79-110), the
// Pallas kernel that `hist_pallas` launches (:167) for every leaf
// histogram of the fused tree learner.
//
// What it computes: for the first `count` positions p of a leaf's row list
// (`rows[offset + p]`, or p itself when there is no list), the sums of
// (grad, hess, 1) into the bin of every feature: out[f][b][c], f32
// [F, B, 3]. Positions at or past `count` may hold anything (another
// leaf's rows) and are never dereferenced. `count` and `offset` may live in
// device memory, so a launch needs no host read. An optional in-bag mask
// (u8 [N], the bagging/GOSS sample) leaves out-of-bag rows out of all
// three channels, the count included.
//
// The sums are exact integers. grad and hess are taken in fixed point at
// a power-of-two scale 2^k (one k per channel, from `scale`): each value
// becomes v = round_half_even(double(x) * 2^k), an int64 — the product is
// exact in float64, so that rounding is the only approximation — and is
// added with integer adds, whose result does not depend on their order.
// The wrapper picks k from max|x| < 2^e over the N rows (a max, never a
// float sum) and the row count as k = 62 - max(n, 24) - e, where N < 2^n:
// so |v| <= 2^38 and no partial or final sum can reach 2^62. The f32
// result is float(double(S) * 2^-k): reruns are bit-identical and the
// CPU's plain version, which forms the same integers, gives the same bits.
// Error bound: each value is off by at most 2^-(k+1), so a sum of m values
// by at most m * 2^-(k+1) — at 10.5M rows (n = 24) with max|g| < 1 (e = 0)
// that is ~1.9e-5 absolute in the worst case, with independent rounding
// errors typically far less.
//
// What bounds it on this card: the rate of shared-memory atomics. The
// floor is bytes: each live row is read once (F bin bytes, 8 B of
// grad/hess, 4 B of row id with a list, 1 mask byte) and the [F, B, 3]
// result is written once — at the HIGGS root (10.5M rows x 28 u8
// features) ~378 MB, ~0.11 ms at 3.35 TB/s. But each (row, feature) costs
// up to five shared-memory atomics (four 32-bit words and the count), 1.47G
// at the root, and at ~1.3T lane-adds/s those take ~10x the byte floor
// (PERF.md section 6, PR 4). At a small leaf the bound is each block's
// fixed cost, zeroing and flushing its shared histogram.
//
// What the design does about it:
//  - shared-memory atomics into an exact histogram. A 64-bit shared
//    atomicAdd is not native on sm_90a (it compiles to a compare-and-swap
//    loop, ATOMS.CAST.SPIN.64), so each value is split into two 32-bit
//    words, v = hi * 2^20 + lo with lo = v & (2^20 - 1) unsigned and
//    hi = v >> 20 signed (|hi| <= 2^18), each added with a native 32-bit
//    ATOMS.ADD. A block adds at most kWindowRows = 4,096 rows into its
//    words between flushes: 4,096 x (2^20 - 1) < 2^32 keeps the lo sum
//    exact and 4,096 x 2^18 = 2^30 < 2^31 the hi sum, so the window's sum
//    is exactly hi_sum * 2^20 + lo_sum. The count is one 32-bit increment
//    (ATOMS.POPC.INC), flushed once. Per (feature, bin) that is 5 words,
//    20 B: 160 KB at HIGGS width (28 features in a 32-wide slab x 256
//    bins), one feature tile, so every row's id, grad, hess and mask are
//    read once. The lanes of a warp take different features of a row, and
//    each feature's bins sit in a bank of their own (hist_common.cuh), so
//    random bins cost no bank conflicts and a bin that most rows fall into
//    no same-address serialisation;
//  - rows are staged with cp.async in 16-byte copies where they are
//    contiguous (the root) and in 4-byte words of each gathered row at
//    leaves, double-buffered under the adds of the tile before;
//  - the grid is sized by the card (SMs x resident blocks) and by the
//    parent's positions; each block takes at least `min_rows` live rows
//    and blocks past `count` exit before touching shared memory, so a
//    small leaf runs on few blocks;
//  - at each window's end a block adds its non-zero window sums into a
//    persistent int64 workspace with native global 64-bit reductions
//    (REDG.E.ADD.64; no per-block partials, no serial reduction pass); a
//    small second kernel converts the workspace to f32 and zeroes it again
//    for the next launch. The wrapper keeps one workspace per device and
//    stream and enqueues both launches under one lock, so two host threads
//    on one stream never interleave them;
//  - the dynamic shared-memory limit is raised once per device
//    (lg_hist_setup), not on every launch.

#include "hist_common.cuh"

using namespace lg_hist;

namespace {

typedef unsigned long long ull;

// 2^k as a double, built from its bits: exact on every device
__device__ __forceinline__ double exp2i(int k) {
  return __longlong_as_double((long long)(k + 1023) << 52);
}

constexpr int kWindowRows = 4096;
constexpr int kWindowTiles = kWindowRows / kTile;
constexpr int kLoBits = 20;
// each feature's bins in a bank of their own: K1 is faster so on the H100.
// The kernel takes the slab width W as an argument, not as a constant: the
// code nvcc made for K2 with W known at compile time was 11-15% slower at
// the HIGGS root (PERF.md section 6, PR 4), and both kernels keep one form
constexpr bool kBankLayout = true;

// Shared layout of one block (f_tile features, B bins), 32-bit words, each
// histogram array laid out bank by feature (hist_common.cuh; kBankLayout):
//   s_lg, s_hg, s_lh, s_hh  hist_words        the window's lo/hi g and h
//   s_c                     hist_words        the block's counts
//   s_row  uint4 [2, kTile]                   staged (lo_g, hi_g, lo_h, hi_h)
//   s_live u8 [2, kTile]                      staged in-bag flags
//   s_bin  [2, kTile, row_stride]             staged bin bytes
__host__ __device__ inline int smem_bytes(int bin_bytes, int f_tile,
                                          int num_bins) {
  const int W = layout_slab(kBankLayout, f_tile);
  return align_up(5 * hist_words(f_tile, W, num_bins) * 4, 16) +
         2 * kTile * 16 + 2 * kTile +
         2 * kTile * row_stride(f_tile, bin_bytes);
}

// Add the window's non-zero sums into acc (and, at the end, the counts)
// and zero the window's words.
__device__ __forceinline__ void flush(unsigned* s_lg, int* s_hg,
                                      unsigned* s_lh, int* s_hh,
                                      const int* s_c, int nf, int B, int W,
                                      int used, int64_t f0, bool last,
                                      ull* __restrict__ acc) {
  __syncthreads();
  for (int j = threadIdx.x; j < used; j += kThreads) {
    int f, b;
    if (!hist_coords(j, W, B, nf, &f, &b)) continue;
    ull* o = acc + ((f0 + f) * B + b) * 3;
    const long long pg = (long long)s_hg[j] * (1ll << kLoBits) + s_lg[j];
    const long long ph = (long long)s_hh[j] * (1ll << kLoBits) + s_lh[j];
    if (pg != 0) atomicAdd(o + 0, (ull)pg);
    if (ph != 0) atomicAdd(o + 1, (ull)ph);
    s_lg[j] = 0u;
    s_hg[j] = 0;
    s_lh[j] = 0u;
    s_hh[j] = 0;
    if (last && s_c[j] != 0) atomicAdd(o + 2, (ull)s_c[j]);
  }
  __syncthreads();
}

template <typename BinT>
__global__ void __launch_bounds__(kThreads, 1)
hist_kernel(const BinT* __restrict__ bins, int64_t F,
            const float* __restrict__ grad, const float* __restrict__ hess,
            const uint8_t* __restrict__ mask,
            const int32_t* __restrict__ rows,
            const int32_t* __restrict__ offset_ptr, int64_t P,
            const int32_t* __restrict__ count_ptr, int64_t count_const,
            const int32_t* __restrict__ scale_ptr, int num_bins, int f_tile,
            int W, int min_rows, ull* __restrict__ acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = num_bins;
  const int64_t f0 = (int64_t)blockIdx.y * f_tile;
  const int nf = (int)((F - f0) < f_tile ? (F - f0) : f_tile);
  const int used = hist_words(nf, W, B);   // words this block touches
  const int rs = row_stride(nf, (int)sizeof(BinT));

  const int64_t off =
      (rows != nullptr && offset_ptr != nullptr) ? (int64_t)(*offset_ptr) : 0;
  int64_t r0, r1;
  if (!block_range(count_ptr, count_const, P - off, min_rows, &r0, &r1))
    return;
  const int32_t* rw = rows != nullptr ? rows + off : nullptr;

  const int words = hist_words(f_tile, W, B);
  unsigned* s_lg = reinterpret_cast<unsigned*>(smem);
  int* s_hg = reinterpret_cast<int*>(s_lg + words);
  unsigned* s_lh = reinterpret_cast<unsigned*>(s_hg + words);
  int* s_hh = reinterpret_cast<int*>(s_lh + words);
  int* s_c = s_hh + words;
  uint4* s_row =
      reinterpret_cast<uint4*>(smem + align_up(5 * words * 4, 16));
  unsigned char* s_live = reinterpret_cast<unsigned char*>(s_row + 2 * kTile);
  unsigned char* s_bin = s_live + 2 * kTile;
  const int stage_stride = kTile * row_stride(f_tile, (int)sizeof(BinT));

  const int tid = threadIdx.x;
  for (int i = tid; i < used; i += kThreads) {
    s_lg[i] = 0u;
    s_hg[i] = 0;
    s_lh[i] = 0u;
    s_hh[i] = 0;
    s_c[i] = 0;
  }
  const double sg = exp2i(scale_ptr[0]);
  const double sh = exp2i(scale_ptr[1]);
  const int mode = stage_mode(bins, F, f0, nf, rw);

  // this thread's row of the next tile, held in registers across the adds
  int32_t rid = 0;
  float g = 0.0f, h = 0.0f;
  uint8_t m = 0;
  auto load_row = [&](int64_t t, int n) {
    if (tid < n) {
      const int64_t p = t + tid;
      rid = rw != nullptr ? rw[p] : (int32_t)p;
      m = mask != nullptr ? mask[rid] : (uint8_t)1;
      g = grad[rid];
      h = hess[rid];
    }
  };
  auto store_row = [&](int buf, int n) {
    if (tid < n) {
      const bool live = m != 0;
      const long long vg = live ? __double2ll_rn((double)g * sg) : 0ll;
      const long long vh = live ? __double2ll_rn((double)h * sh) : 0ll;
      const unsigned lo_mask = (1u << kLoBits) - 1u;
      s_row[buf * kTile + tid] = make_uint4(
          (unsigned)vg & lo_mask, (unsigned)(int)(vg >> kLoBits),
          (unsigned)vh & lo_mask, (unsigned)(int)(vh >> kLoBits));
      s_live[buf * kTile + tid] = live ? 1 : 0;
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
    if (tiles == kWindowTiles) {
      flush(s_lg, s_hg, s_lh, s_hh, s_c, nf, B, W, used, f0, false, acc);
      tiles = 0;
    }

    const unsigned char* sb = s_bin + buf * stage_stride;
    const uint4* rv = s_row + buf * kTile;
    const unsigned char* lv = s_live + buf * kTile;
    for (int fb = 0; fb < nf; fb += L.fw) {
      const int f = fb + L.fl;
      if (!L.active || f >= nf) continue;
      const int base = hist_base(f, W, B);
      unsigned* lg = s_lg + base;
      int* hg = s_hg + base;
      unsigned* lh = s_lh + base;
      int* hh = s_hh + base;
      int* hc = s_c + base;
      for (int i = warp * L.rps + L.sub; i < n; i += kWarps * L.rps) {
        if (!lv[i]) continue;
        const int b = (int)reinterpret_cast<const BinT*>(sb + i * rs)[f];
        if (b >= B) continue;
        const uint4 v = rv[i];
        const int at = b * W;
        atomicAdd(lg + at, v.x);
        if (v.y != 0u) atomicAdd(hg + at, (int)v.y);
        atomicAdd(lh + at, v.z);
        if (v.w != 0u) atomicAdd(hh + at, (int)v.w);
        atomicAdd(hc + at, 1);
      }
    }
    ++tiles;
    if (nn > 0) store_row(buf ^ 1, nn);
    __syncthreads();
  }
  flush(s_lg, s_hg, s_lh, s_hh, s_c, nf, B, W, used, f0, true, acc);
}

// out[i] = float(double(acc[i]) * 2^-k of its channel); acc[i] = 0
__global__ void hist_finish_kernel(ull* __restrict__ acc, int64_t total,
                                   const int32_t* __restrict__ scale_ptr,
                                   float* __restrict__ out) {
  const double inv_g = exp2i(-scale_ptr[0]);
  const double inv_h = exp2i(-scale_ptr[1]);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const double v = (double)(long long)acc[i];
    acc[i] = 0ull;
    const int c = (int)(i % 3);
    out[i] = (float)(c == 2 ? v : v * (c == 0 ? inv_g : inv_h));
  }
}

template <typename BinT>
int launch(const void* bins, int64_t F, const float* grad, const float* hess,
           const uint8_t* mask, const int32_t* rows, const int32_t* offset_ptr,
           int64_t P, const int32_t* count_ptr, int64_t count_const,
           const int32_t* scale_ptr, int num_bins, int nblk, int f_tile,
           int min_rows, ull* acc, cudaStream_t stream) {
  const int smem = smem_bytes((int)sizeof(BinT), f_tile, num_bins);
  const dim3 grid((unsigned)nblk, (unsigned)((F + f_tile - 1) / f_tile));
  hist_kernel<BinT><<<grid, kThreads, smem, stream>>>(
      static_cast<const BinT*>(bins), F, grad, hess, mask, rows, offset_ptr,
      P, count_ptr, count_const, scale_ptr, num_bins, f_tile,
      layout_slab(kBankLayout, f_tile), min_rows, acc);
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
extern "C" int lg_hist_setup(void) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = max_shared(hist_kernel<uint8_t>, max_smem);
  if (err == cudaSuccess) err = max_shared(hist_kernel<uint16_t>, max_smem);
  return err == cudaSuccess ? max_smem : -(int)err;
}

// Shared memory one block needs (bytes) at feature tile f_tile in the
// kernel's layout, for the wrapper's tile choice.
extern "C" int lg_hist_smem_bytes(int bin_bytes, int f_tile,
                                  int num_bins) {
  return smem_bytes(bin_bytes, f_tile, num_bins);
}

// Resident blocks per SM (after lg_hist_setup); negative: the cudaError_t
// of the query.
extern "C" int lg_hist_occupancy(int bin_bytes, int f_tile,
                                 int num_bins) {
  int blocks = 0;
  const int smem = smem_bytes(bin_bytes, f_tile, num_bins);
  const cudaError_t err =
      bin_bytes == 1
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, hist_kernel<uint8_t>, kThreads, smem)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, hist_kernel<uint16_t>, kThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// bins: u8/u16 [N, F] row-major; grad, hess: f32 [N]; mask: u8 [N] or null
// (every row in the bag); rows: int32 [P] or null (positions are rows);
// offset_ptr: one int32 on the device or null (0), position p reads
// rows[offset + p]; count: *count_ptr when non-null, else count_const;
// scale_ptr: int32 [2] on the device, the fixed-point exponents (k_g, k_h);
// acc: int64 [F, num_bins, 3] workspace, all zero on entry and left all
// zero; out: f32 [F, num_bins, 3]. Returns 0 on success, -1 for an
// unsupported bin width, otherwise the cudaError_t of the launches.
extern "C" int lg_hist_rows(const void* bins, int bin_bytes, int64_t F,
                            const float* grad, const float* hess,
                            const uint8_t* mask, const int32_t* rows,
                            const int32_t* offset_ptr, int64_t P,
                            const int32_t* count_ptr, int64_t count_const,
                            const int32_t* scale_ptr, int num_bins, int nblk,
                            int f_tile, int min_rows, long long* acc,
                            float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ull* a = reinterpret_cast<ull*>(acc);
  int rc;
  if (bin_bytes == 1) {
    rc = launch<uint8_t>(bins, F, grad, hess, mask, rows, offset_ptr, P,
                         count_ptr, count_const, scale_ptr, num_bins, nblk,
                         f_tile, min_rows, a, s);
  } else if (bin_bytes == 2) {
    rc = launch<uint16_t>(bins, F, grad, hess, mask, rows, offset_ptr, P,
                          count_ptr, count_const, scale_ptr, num_bins, nblk,
                          f_tile, min_rows, a, s);
  } else {
    return -1;
  }
  if (rc != 0) return rc;
  const int64_t total = F * (int64_t)num_bins * 3;
  const int64_t want = (total + 255) / 256;
  const unsigned blocks = (unsigned)(want < 264 ? want : 264);
  hist_finish_kernel<<<blocks, 256, 0, s>>>(a, total, scale_ptr, out);
  return (int)cudaGetLastError();
}
