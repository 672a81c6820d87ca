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
//   - x is read in its own type (float32 or float64) and widened to double;
//   - a NaN becomes bin nan_bin[f] when the feature's missing type is NaN
//     (nan_bin[f] >= 0), else it is read as 0.0;
//   - bin = lower_bound(bounds_f, x): the first i with bounds_f[i] >= x
//     (numpy's searchsorted, side='left'), over the feature's upper bounds
//     without their NaN sentinel, float64, compared exactly;
//   - clipped to len(bounds_f) - 1.
// Output is u8 or u16 [n, U] row-major; columns not in the list (the
// categorical ones, which stay with the mapper on the host) are not
// written.
//
// What bounds it on this card: bytes. Each input value is read once and
// each bin written once: at T3's 11M x 28 float32 rows that is ~1.2 GB in
// and ~0.3 GB out, ~0.44 ms at 3.35 TB/s. A value costs ~8 dependent
// shared-memory loads of its binary search, which the card hides across
// resident warps.
//
// What the design does about it (a first design, right before fast):
//  - the upper bounds travel as one concatenated float64 table with
//    per-feature offsets; the features are cut into tiles whose bounds fit
//    the staging cap the wrapper picks, and each block stages one tile's
//    bounds, offsets, columns and NaN bins in shared memory once, then
//    walks row chunks grid-stride, so the staging is paid once a block and
//    not once a row chunk (a tile whose single feature is too large for
//    the cap searches its bounds in device memory instead);
//  - thread t of a chunk takes pair (row t / tile_features, feature t %
//    tile_features): neighbouring lanes read neighbouring columns of a row
//    and write neighbouring bins;
//  - the lower_bound is the host binner's branchless form, so the two give
//    the same index for every input, infinities included.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t lower_idx(const double* b, int64_t nb,
                                             double v) {
  const double* base = b;
  int64_t len = nb;
  while (len > 1) {
    const int64_t half = len >> 1;
    base = (base[half - 1] < v) ? base + half : base;
    len -= half;
  }
  return (base - b) + (base[0] < v ? 1 : 0);
}

// Shared layout of one block (tile of tf features, nb_tile bounds):
//   s_bounds  double [nb_tile]   (only when staged)
//   s_off     int64  [tf + 1]    tile-local offsets into the bounds
//   s_col     int32  [tf]        source column of each feature
//   s_dst     int32  [tf]        output column
//   s_nan     int32  [tf]        NaN bin, or -1 (NaN reads as 0.0)
template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads)
bin_kernel(const T* __restrict__ x, int64_t n, int64_t ld,
           const int32_t* __restrict__ col, const int32_t* __restrict__ dst,
           const int32_t* __restrict__ nan_bin,
           const double* __restrict__ bounds, const int64_t* __restrict__ off,
           const int32_t* __restrict__ tiles, const uint8_t* __restrict__ staged,
           int64_t chunk_rows, OutT* __restrict__ out, int64_t U) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.y;
  const int f0 = tiles[tile];
  const int tf = tiles[tile + 1] - f0;
  const int64_t b0 = off[f0];
  const int64_t nb_tile = off[f0 + tf] - b0;
  const bool stage = staged[tile] != 0;

  double* s_bounds = reinterpret_cast<double*>(smem);
  int64_t* s_off = reinterpret_cast<int64_t*>(
      smem + (stage ? nb_tile : 0) * sizeof(double));
  int32_t* s_col = reinterpret_cast<int32_t*>(s_off + tf + 1);
  int32_t* s_dst = s_col + tf;
  int32_t* s_nan = s_dst + tf;

  if (stage) {
    for (int64_t i = threadIdx.x; i < nb_tile; i += blockDim.x)
      s_bounds[i] = bounds[b0 + i];
  }
  for (int i = threadIdx.x; i <= tf; i += blockDim.x) s_off[i] = off[f0 + i] - b0;
  for (int i = threadIdx.x; i < tf; i += blockDim.x) {
    s_col[i] = col[f0 + i];
    s_dst[i] = dst[f0 + i];
    s_nan[i] = nan_bin[f0 + i];
  }
  __syncthreads();
  const double* tb = stage ? s_bounds : bounds + b0;

  const int64_t pairs = chunk_rows * tf;
  for (int64_t r0 = blockIdx.x * chunk_rows; r0 < n;
       r0 += static_cast<int64_t>(gridDim.x) * chunk_rows) {
    const int64_t rows = (n - r0) < chunk_rows ? (n - r0) : chunk_rows;
    const int64_t live = rows * tf;
    for (int64_t p = threadIdx.x; p < pairs; p += blockDim.x) {
      if (p >= live) break;
      const int64_t r = r0 + p / tf;
      const int f = static_cast<int>(p % tf);
      double v = static_cast<double>(x[r * ld + s_col[f]]);
      const int64_t lo = s_off[f];
      const int64_t nb = s_off[f + 1] - lo;
      int64_t idx;
      if (isnan(v) && s_nan[f] >= 0) {
        idx = s_nan[f];
      } else {
        if (isnan(v)) v = 0.0;
        idx = lower_idx(tb + lo, nb, v);
        if (idx >= nb) idx = nb - 1;
      }
      out[r * U + s_dst[f]] = static_cast<OutT>(idx);
    }
  }
}

template <typename T, typename OutT>
cudaError_t allow_smem(int bytes) {
  return cudaFuncSetAttribute(bin_kernel<T, OutT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, typename OutT>
int launch(const void* x, int64_t n, int64_t ld, const int32_t* col,
           const int32_t* dst, const int32_t* nan_bin, const double* bounds,
           const int64_t* off, const int32_t* tiles, const uint8_t* staged,
           int n_tiles, int smem, int nblk, int64_t chunk_rows, void* out,
           int64_t U, cudaStream_t s) {
  dim3 grid(nblk, n_tiles);
  bin_kernel<T, OutT><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), n, ld, col, dst, nan_bin, bounds, off, tiles,
      staged, chunk_rows, static_cast<OutT*>(out), U);
  return static_cast<int>(cudaGetLastError());
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

// Resident blocks per SM at `smem` bytes of dynamic shared memory (after
// lg_bin_setup); negative: the cudaError_t of the query.
extern "C" int lg_bin_occupancy(int in_bytes, int out_bytes, int smem) {
  int blocks = 0;
  cudaError_t err;
  if (in_bytes == 4 && out_bytes == 1)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, bin_kernel<float, uint8_t>, kThreads, smem);
  else if (in_bytes == 4)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, bin_kernel<float, uint16_t>, kThreads, smem);
  else if (out_bytes == 1)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, bin_kernel<double, uint8_t>, kThreads, smem);
  else
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, bin_kernel<double, uint16_t>, kThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// x: float32 (in_bytes 4) or float64 (8) [n, ld] row-major; col, dst,
// nan_bin: int32 [Fn] per numerical feature; bounds: float64, feature f's
// upper bounds at [off[f], off[f + 1]); tiles: int32 [n_tiles + 1] feature
// ranges; staged: u8 [n_tiles], 1 where the tile's bounds go to shared
// memory; smem: dynamic shared bytes of the largest tile; nblk row-chunk
// blocks of chunk_rows rows each walk the rows grid-stride; out: u8
// (out_bytes 1) or u16 (2) [n, U]. Returns 0 on success, -1 for an
// unsupported width, otherwise the cudaError_t of the launch.
extern "C" int lg_bin_rows(const void* x, int in_bytes, int64_t n, int64_t ld,
                           const int32_t* col, const int32_t* dst,
                           const int32_t* nan_bin, const double* bounds,
                           const int64_t* off, const int32_t* tiles,
                           const uint8_t* staged, int n_tiles, int smem,
                           int nblk, int64_t chunk_rows, void* out,
                           int out_bytes, int64_t U, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bytes == 4 && out_bytes == 1)
    return launch<float, uint8_t>(x, n, ld, col, dst, nan_bin, bounds, off,
                                  tiles, staged, n_tiles, smem, nblk,
                                  chunk_rows, out, U, s);
  if (in_bytes == 4 && out_bytes == 2)
    return launch<float, uint16_t>(x, n, ld, col, dst, nan_bin, bounds, off,
                                   tiles, staged, n_tiles, smem, nblk,
                                   chunk_rows, out, U, s);
  if (in_bytes == 8 && out_bytes == 1)
    return launch<double, uint8_t>(x, n, ld, col, dst, nan_bin, bounds, off,
                                   tiles, staged, n_tiles, smem, nblk,
                                   chunk_rows, out, U, s);
  if (in_bytes == 8 && out_bytes == 2)
    return launch<double, uint16_t>(x, n, ld, col, dst, nan_bin, bounds, off,
                                    tiles, staged, n_tiles, smem, nblk,
                                    chunk_rows, out, U, s);
  return -1;
}
