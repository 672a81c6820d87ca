// Leaf histogram kernel (K1) for Hopper (sm_90a).
//
// Replaces: lambdagap_tpu/ops/hist_pallas.py `_hist_kernel` (:79-110), the
// Pallas kernel that `hist_pallas` launches (:167) for every leaf
// histogram of the fused tree learner.
//
// What it computes: for the first `count` positions p of a leaf's row list
// (`rows[p]`, or p itself when there is no list), the sums of (grad, hess,
// 1) into the bin of every feature: out[f][b][c], f32 [F, B, 3]. Positions
// past `count` may hold anything (another leaf's rows under the gather
// layout) and are never dereferenced. `count` may live in device memory,
// so a launch needs no host read. An optional in-bag mask (u8 [N], the
// bagging/GOSS sample) leaves out-of-bag rows out of all three channels,
// the count included, as the JAX package's `valid & row_mask[rows]` does.
//
// What bounds it on this card: bytes. Each live row is read once (F bin
// bytes, 8 B of grad/hess, 4 B of row id) and the [F, B, 3] result is
// written once; the arithmetic is three f32 adds per (row, feature), far
// below the card's f32 rate. At the HIGGS root (10.5M rows x 28 u8
// features) that is ~420 MB, ~0.13 ms at 3.35 TB/s (one more byte a row
// with a mask). The float64 adds stay far below the card's float64 rate.
//
// What the design does about it, about determinism (two launches on the
// same inputs give bit-identical sums — no float atomics anywhere) and
// about agreeing with the CPU (the sums are taken in float64 and rounded
// to float32 once, as the plain version rounds its float64 sums, so the
// card's histograms equal the CPU's to the bit unless a float64 sum lands
// within its own rounding error of a float32 rounding boundary; GOSS and
// bagging turn a 1-ulp difference in a histogram into other samples):
//  - the grid is (row blocks, feature tiles); row block k takes the fixed
//    contiguous range [k*per, (k+1)*per) of the live positions, where per
//    is ceil(count / row blocks), so the split of the work depends only on
//    the inputs;
//  - a block stages a tile of 256 rows in shared memory (row ids, grad,
//    hess, then the tile's bin bytes, read row-contiguously), so each row
//    is fetched from device memory once however many features it feeds;
//  - each warp owns whole features of the tile: their B x 3 float64
//    sub-histograms in shared memory are written by that warp alone. Lanes
//    holding the same bin are grouped with __match_any_sync; the group's
//    leader sums the group's values in ascending lane order and adds the
//    sum — a fixed order, with no atomics;
//  - each block writes its float64 partial [F, B, 3] to a scratch tensor
//    the wrapper allocates, and a second kernel sums the partials in block
//    order and rounds each sum to float32 once.
// TMA staging, warp specialisation and a shared-memory layout without bank
// conflicts are later work; this kernel is the simple, exact first port.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;   // rows staged per step

template <typename BinT>
__global__ void __launch_bounds__(kThreads)
hist_partial_kernel(const BinT* __restrict__ bins, int64_t F,
                    const float* __restrict__ grad,
                    const float* __restrict__ hess,
                    const uint8_t* __restrict__ mask,
                    const int32_t* __restrict__ rows, int64_t P,
                    const int32_t* __restrict__ count_ptr,
                    int64_t count_const, int num_bins, int f_tile,
                    double* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = num_bins;
  double* s_hist = reinterpret_cast<double*>(smem);        // [f_tile, B, 3]
  float* s_g = reinterpret_cast<float*>(s_hist + (int64_t)f_tile * B * 3);
  float* s_h = s_g + kTile;                                // [kTile]
  float* s_stage = s_h + kTile;                            // [kWarps, 64]
  int32_t* s_row = reinterpret_cast<int32_t*>(s_stage + kWarps * 64);
  int32_t* s_live = s_row + kTile;                         // [kTile]
  BinT* s_bin = reinterpret_cast<BinT*>(s_live + kTile);   // [kTile, f_tile]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t f0 = (int64_t)blockIdx.y * f_tile;
  const int nf = (int)((F - f0) < f_tile ? (F - f0) : f_tile);

  for (int i = tid; i < nf * B * 3; i += kThreads) s_hist[i] = 0.0;

  int64_t count = count_ptr != nullptr ? (int64_t)(*count_ptr) : count_const;
  count = count < 0 ? 0 : (count > P ? P : count);
  const int64_t nblk = gridDim.x;
  const int64_t per = (count + nblk - 1) / nblk;
  int64_t r0 = (int64_t)blockIdx.x * per;
  r0 = r0 < count ? r0 : count;
  const int64_t r1 = (r0 + per) < count ? (r0 + per) : count;
  float* stage = s_stage + warp * 64;
  __syncthreads();

  for (int64_t t0 = r0; t0 < r1; t0 += kTile) {
    const int n = (int)((r1 - t0) < kTile ? (r1 - t0) : kTile);
    for (int i = tid; i < n; i += kThreads) {
      const int64_t p = t0 + i;
      const int32_t r = rows != nullptr ? rows[p] : (int32_t)p;
      s_row[i] = r;
      // an out-of-bag row's bins are still staged below; s_live keeps it
      // out of every channel
      const bool in_bag = mask == nullptr || mask[r] != 0;
      s_g[i] = in_bag ? grad[r] : 0.0f;
      s_h[i] = in_bag ? hess[r] : 0.0f;
      s_live[i] = in_bag ? 1 : 0;
    }
    __syncthreads();
    for (int i = tid; i < n * nf; i += kThreads) {
      const int ri = i / nf;
      const int fj = i - ri * nf;
      s_bin[ri * f_tile + fj] = bins[(int64_t)s_row[ri] * F + f0 + fj];
    }
    __syncthreads();
    for (int fj = warp; fj < nf; fj += kWarps) {
      double* h = s_hist + (int64_t)fj * B * 3;
      for (int base = 0; base < n; base += 32) {
        const int ri = base + lane;
        const bool live = ri < n && s_live[ri] != 0;
        const int key = live ? (int)s_bin[ri * f_tile + fj] : -1;
        stage[lane] = live ? s_g[ri] : 0.0f;
        stage[32 + lane] = live ? s_h[ri] : 0.0f;
        __syncwarp();
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        if (live && lane == __ffs(peers) - 1 && key < B) {
          double sg = 0.0, sh = 0.0;
          for (unsigned m = peers; m != 0u; m &= m - 1u) {
            const int l = __ffs(m) - 1;
            sg += (double)stage[l];
            sh += (double)stage[32 + l];
          }
          h[key * 3 + 0] += sg;
          h[key * 3 + 1] += sh;
          h[key * 3 + 2] += (double)__popc(peers);
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }

  double* out = partial + ((int64_t)blockIdx.x * F + f0) * B * 3;
  for (int i = tid; i < nf * B * 3; i += kThreads) out[i] = s_hist[i];
}

// out[i] = the float32 rounding of the sum over row blocks k, in block
// order, of partial[k][i]
__global__ void hist_reduce_kernel(const double* __restrict__ partial,
                                   int64_t nblk, int64_t total,
                                   float* __restrict__ out) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    double s = 0.0;
    for (int64_t k = 0; k < nblk; ++k) s += partial[k * total + i];
    out[i] = (float)s;
  }
}

int smem_bytes(int bin_bytes, int f_tile, int num_bins) {
  return f_tile * num_bins * 3 * 8 + (2 * kTile + kWarps * 64) * 4 +
         kTile * 8 + kTile * f_tile * bin_bytes;
}

template <typename BinT>
int launch_partial(const void* bins, int64_t F, const float* grad,
                   const float* hess, const uint8_t* mask,
                   const int32_t* rows, int64_t P,
                   const int32_t* count_ptr, int64_t count_const,
                   int num_bins, int nblk, int f_tile, double* partial,
                   cudaStream_t stream) {
  const int smem = smem_bytes((int)sizeof(BinT), f_tile, num_bins);
  cudaError_t err = cudaFuncSetAttribute(
      hist_partial_kernel<BinT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)nblk, (unsigned)((F + f_tile - 1) / f_tile));
  hist_partial_kernel<BinT><<<grid, kThreads, smem, stream>>>(
      static_cast<const BinT*>(bins), F, grad, hess, mask, rows, P,
      count_ptr, count_const, num_bins, f_tile, partial);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one block needs (bytes), for the wrapper's tile choice.
extern "C" int lg_hist_smem_bytes(int bin_bytes, int f_tile, int num_bins) {
  return smem_bytes(bin_bytes, f_tile, num_bins);
}

// bins: u8/u16 [N, F] row-major; mask: u8 [N] or null (every row in the
// bag); rows: int32 [P] or null (positions are rows); count: *count_ptr
// when non-null, else count_const. `partial` is scratch of
// nblk * F * num_bins * 3 doubles.
// Returns 0 on success, -1 for an unsupported bin width, otherwise the
// cudaError_t of the launches.
extern "C" int lg_hist_rows(const void* bins, int bin_bytes, int64_t F,
                            const float* grad, const float* hess,
                            const uint8_t* mask, const int32_t* rows,
                            int64_t P,
                            const int32_t* count_ptr, int64_t count_const,
                            int num_bins, int nblk, int f_tile,
                            double* partial, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (bin_bytes == 1) {
    rc = launch_partial<uint8_t>(bins, F, grad, hess, mask, rows, P,
                                 count_ptr, count_const, num_bins, nblk,
                                 f_tile, partial, s);
  } else if (bin_bytes == 2) {
    rc = launch_partial<uint16_t>(bins, F, grad, hess, mask, rows, P,
                                  count_ptr, count_const, num_bins, nblk,
                                  f_tile, partial, s);
  } else {
    return -1;
  }
  if (rc != 0) return rc;
  const int64_t total = F * (int64_t)num_bins * 3;
  const int64_t want = (total + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < 1024 ? want : 1024);
  hist_reduce_kernel<<<blocks, kThreads, 0, s>>>(partial, nblk, total, out);
  return (int)cudaGetLastError();
}
