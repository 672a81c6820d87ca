// Quantized-gradient leaf histogram kernel (K2) for Hopper (sm_90a).
//
// Replaces: lambdagap_tpu/ops/hist_pallas.py `_hist_kernel_q` (:207-232),
// the Pallas kernel that `hist_pallas_q` launches (:258) for every leaf
// histogram of `use_quantized_grad=true`: an int8 one-hot matmul on the
// TPU's matrix unit with exact int32 accumulation.
//
// What it computes: for the first `count` positions p of a leaf's row list
// (`rows[p]`, or p itself when there is no list), the sums of the row's
// int8 gradient levels (g_q, h_q) and of 1 into the bin of every feature,
// skipping rows an optional in-bag mask (u8 [N]) leaves out:
// out[f][b] = (sum g_q, sum h_q, in-bag count), int32 [F, B, 3]. Positions
// past `count` are never dereferenced; `count` may live in device memory.
// The caller keeps every sum below 2^31 (the JAX package's
// exact_accum_limit("pallas"): rows x num_grad_quant_bins < 2^31 - 1).
//
// What bounds it on this card: bytes. Each live row is read once (F bin
// bytes, 2 level bytes, 1 mask byte, 4 B of row id) and the [F, B, 3]
// result is written once; three integer adds per (row, feature). At the
// HIGGS root (10.5M rows x 28 u8 features, no row list) that is ~326 MB,
// ~0.097 ms at 3.35 TB/s.
//
// What the design does about it, and about determinism: integer sums do
// not depend on the order of the adds, so the kernel is bit-identical from
// run to run with plain atomics —
//  - the grid is (row blocks, feature tiles); a block stages a tile of 256
//    rows in shared memory (row ids, levels, in-bag flags, then the tile's
//    bin bytes, read row-contiguously), so each row is fetched from device
//    memory once however many features it feeds;
//  - every (row, feature) pair of the tile adds its levels into the
//    block's shared int32 histogram with shared-memory atomicAdd;
//  - each block then adds its non-zero bins into the output with one
//    global atomicAdd per bin and channel (the wrapper zeroes the output).
// Warp-aggregated adds, packed (g, h) words, TMA staging and wgmma are
// later work; this kernel is the simple, exact first port.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;   // rows staged per step

template <typename BinT>
__global__ void __launch_bounds__(kThreads)
hist_q_kernel(const BinT* __restrict__ bins, int64_t F,
              const int8_t* __restrict__ gq, const int8_t* __restrict__ hq,
              const uint8_t* __restrict__ mask,
              const int32_t* __restrict__ rows, int64_t P,
              const int32_t* __restrict__ count_ptr, int64_t count_const,
              int num_bins, int f_tile, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = num_bins;
  int32_t* s_hist = reinterpret_cast<int32_t*>(smem);      // [f_tile, B, 3]
  int32_t* s_row = s_hist + (int64_t)f_tile * B * 3;       // [kTile]
  int32_t* s_g = s_row + kTile;                            // [kTile]
  int32_t* s_h = s_g + kTile;                              // [kTile]
  int32_t* s_live = s_h + kTile;                           // [kTile]
  BinT* s_bin = reinterpret_cast<BinT*>(s_live + kTile);   // [kTile, f_tile]

  const int tid = threadIdx.x;
  const int64_t f0 = (int64_t)blockIdx.y * f_tile;
  const int nf = (int)((F - f0) < f_tile ? (F - f0) : f_tile);

  for (int i = tid; i < nf * B * 3; i += kThreads) s_hist[i] = 0;

  int64_t count = count_ptr != nullptr ? (int64_t)(*count_ptr) : count_const;
  count = count < 0 ? 0 : (count > P ? P : count);
  const int64_t nblk = gridDim.x;
  const int64_t per = (count + nblk - 1) / nblk;
  int64_t r0 = (int64_t)blockIdx.x * per;
  r0 = r0 < count ? r0 : count;
  const int64_t r1 = (r0 + per) < count ? (r0 + per) : count;
  __syncthreads();

  for (int64_t t0 = r0; t0 < r1; t0 += kTile) {
    const int n = (int)((r1 - t0) < kTile ? (r1 - t0) : kTile);
    for (int i = tid; i < n; i += kThreads) {
      const int64_t p = t0 + i;
      const int32_t r = rows != nullptr ? rows[p] : (int32_t)p;
      s_row[i] = r;
      s_g[i] = (int32_t)gq[r];
      s_h[i] = (int32_t)hq[r];
      s_live[i] = (mask == nullptr || mask[r] != 0) ? 1 : 0;
    }
    __syncthreads();
    for (int i = tid; i < n * nf; i += kThreads) {
      const int ri = i / nf;
      const int fj = i - ri * nf;
      s_bin[ri * f_tile + fj] = bins[(int64_t)s_row[ri] * F + f0 + fj];
    }
    __syncthreads();
    for (int i = tid; i < n * nf; i += kThreads) {
      const int ri = i / nf;
      if (s_live[ri] == 0) continue;
      const int fj = i - ri * nf;
      const int b = (int)s_bin[ri * f_tile + fj];
      if (b >= B) continue;
      int32_t* h = s_hist + ((int64_t)fj * B + b) * 3;
      atomicAdd(h + 0, s_g[ri]);
      atomicAdd(h + 1, s_h[ri]);
      atomicAdd(h + 2, 1);
    }
    __syncthreads();
  }

  int32_t* o = out + f0 * B * 3;
  for (int i = tid; i < nf * B * 3; i += kThreads) {
    const int32_t v = s_hist[i];
    if (v != 0) atomicAdd(o + i, v);
  }
}

int smem_bytes(int bin_bytes, int f_tile, int num_bins) {
  return f_tile * num_bins * 3 * 4 + 4 * kTile * 4 +
         kTile * f_tile * bin_bytes;
}

template <typename BinT>
int launch(const void* bins, int64_t F, const int8_t* gq, const int8_t* hq,
           const uint8_t* mask, const int32_t* rows, int64_t P,
           const int32_t* count_ptr, int64_t count_const, int num_bins,
           int nblk, int f_tile, int32_t* out, cudaStream_t stream) {
  const int smem = smem_bytes((int)sizeof(BinT), f_tile, num_bins);
  cudaError_t err = cudaFuncSetAttribute(
      hist_q_kernel<BinT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)nblk, (unsigned)((F + f_tile - 1) / f_tile));
  hist_q_kernel<BinT><<<grid, kThreads, smem, stream>>>(
      static_cast<const BinT*>(bins), F, gq, hq, mask, rows, P, count_ptr,
      count_const, num_bins, f_tile, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one block needs (bytes), for the wrapper's tile choice.
extern "C" int lg_hist_q_smem_bytes(int bin_bytes, int f_tile,
                                    int num_bins) {
  return smem_bytes(bin_bytes, f_tile, num_bins);
}

// bins: u8/u16 [N, F] row-major; gq, hq: int8 [N]; mask: u8 [N] or null
// (every row in the bag); rows: int32 [P] or null (positions are rows);
// count: *count_ptr when non-null, else count_const; out: int32
// [F, num_bins, 3], zeroed by the caller. Returns 0 on success, -1 for an
// unsupported bin width, otherwise the cudaError_t of the launch.
extern "C" int lg_hist_rows_q(const void* bins, int bin_bytes, int64_t F,
                              const int8_t* gq, const int8_t* hq,
                              const uint8_t* mask, const int32_t* rows,
                              int64_t P, const int32_t* count_ptr,
                              int64_t count_const, int num_bins, int nblk,
                              int f_tile, int32_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1) {
    return launch<uint8_t>(bins, F, gq, hq, mask, rows, P, count_ptr,
                           count_const, num_bins, nblk, f_tile, out, s);
  }
  if (bin_bytes == 2) {
    return launch<uint16_t>(bins, F, gq, hq, mask, rows, P, count_ptr,
                            count_const, num_bins, nblk, f_tile, out, s);
  }
  return -1;
}
