// Band bucketing shared by the binning kernels K1 (`bev_bin.cu`) and K1z
// (`voxel_bin.cu`), for Hopper (sm_90a).
//
// Both kernels bin the points of B tiles onto a [height, width] grid whose
// every (row, column) holds `depth` cells (depth 1 for the BEV image, Z for
// the z-fold voxel grid), and write one value per cell and value column.
// The TPU kernel did this per band of 8 rows held in fast memory, after an
// XLA sort of the points by band (`tests/pallas_reference_bev.py:79-106`).
// The Hopper form of that idea, in four passes on one stream, no host sync:
//
//   (A) band_hist_kernel: one thread per point applies the mask, the range
//       test and the cell index (the caller's Binner), derives its band and
//       counts it in a shared-memory histogram of the tile's bands; one
//       global atomic per (CTA, band) follows.
//   (B) band_scan_kernel: one CTA scans the band counts into segment
//       offsets (exclusive; the total at the end) and the scatter cursors.
//   (C) band_scatter_kernel: the same points again, kept in registers; each
//       CTA reserves its run of slots in each band with one global atomic,
//       sorts its points by band in shared memory, and copies the sorted
//       records out, so that a warp's stores fill consecutive slots.
//   (D) in the kernel's own file: one CTA per band accumulates its segment
//       in shared memory and writes every output element of the band once.
//
// A band is `rows_per_band` rows by `x_chunk` columns of one tile, and
// either spans whole rows (x_chunk == width) or one row (rows_per_band ==
// 1), so its cells are one contiguous stretch of a row-major output.
// `kernels/bin_bands.py::band_plan` chooses the split from the shapes and
// a shared-memory budget; this file only follows it.  Segments are sized
// exactly from the counts, so no point is ever dropped (the TPU kernel's
// `capacity` dropped overflow).  Slot order within a band, and with it the
// float sum order of (D), varies from run to run; counts are exact.
//
// A Binner supplies, for point i: `load(i)`, the columns a pass needs and
// the mask, loaded together (16 bytes at once only where the caller found
// the points 16-byte aligned); `cell(point, row, col, sub)`, false for a
// masked or out-of-range point; `record(point, i, local, dst)`, the `rec`
// floats that (D) reads back.  Every kernel here expects the CTA's tile in
// blockIdx.x / ctas_per_tile, BLOCK threads and PPT points per thread.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bins {

constexpr int BLOCK = 256;  // threads per CTA of passes (A) and (C)
constexpr int PPT = 16;     // points per thread of passes (A) and (C)
constexpr int POINTS_PER_CTA = BLOCK * PPT;
constexpr int SCAN_BLOCK = 1024;

struct BandGeom {
  int height, width, depth;  // grid rows, columns, cells per (row, column)
  int rows_per_band, x_chunk, n_xchunks, bands_per_tile;

  __device__ __forceinline__ int band(int row, int col) const {
    return (row / rows_per_band) * n_xchunks + col / x_chunk;
  }
  // index of the cell within its band's stretch; with x_chunk < width the
  // band holds one row, so row % rows_per_band is 0
  __device__ __forceinline__ int local(int row, int col, int sub) const {
    return ((row % rows_per_band) * x_chunk + col % x_chunk) * depth + sub;
  }
  // band k of a tile: first row, rows, first column, columns
  __device__ __forceinline__ void rect(int k, int& r0, int& rows, int& x0,
                                       int& cols) const {
    r0 = (k / n_xchunks) * rows_per_band;
    rows = min(rows_per_band, height - r0);
    x0 = (k % n_xchunks) * x_chunk;
    cols = min(x_chunk, width - x0);
  }
};

// In-place exclusive scan of s[0..n) by a CTA of BLOCK threads, each
// taking a run of consecutive entries; returns the total.
__device__ __forceinline__ int block_exclusive_scan(int* s, int n,
                                                    int* s_warp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + BLOCK - 1) / BLOCK;
  const int lo = min(tid * per, n), hi = min(lo + per, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += s[i];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < BLOCK / 32 ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += t;
    }
    if (lane < BLOCK / 32) s_warp[lane] = w;
  }
  __syncthreads();
  int run = incl - sum + (warp ? s_warp[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int v = s[i];
    s[i] = run;
    run += v;
  }
  const int total = s_warp[BLOCK / 32 - 1];
  __syncthreads();
  return total;
}

// (A) band counts.  band_count [B * bands_per_tile] must be zero on entry.
template <class Binner>
__global__ void __launch_bounds__(BLOCK)
band_hist_kernel(Binner bn, BandGeom g, int n_points, int ctas_per_tile,
                 int* __restrict__ band_count) {
  extern __shared__ int s_hist[];  // [bands_per_tile]
  const int tile = blockIdx.x / ctas_per_tile;
  const int start = (blockIdx.x % ctas_per_tile) * POINTS_PER_CTA;
  for (int k = threadIdx.x; k < g.bands_per_tile; k += BLOCK) s_hist[k] = 0;
  __syncthreads();
  const long long base = (long long)tile * n_points;
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = start + j * BLOCK + threadIdx.x;
    int row, col, sub;
    if (p < n_points && bn.cell(bn.load(base + p), row, col, sub))
      atomicAdd(&s_hist[g.band(row, col)], 1);
  }
  __syncthreads();
  int* count = band_count + (long long)tile * g.bands_per_tile;
  for (int k = threadIdx.x; k < g.bands_per_tile; k += BLOCK)
    if (s_hist[k]) atomicAdd(count + k, s_hist[k]);
}

// (B) band_off [n + 1] = exclusive scan of band_count [n], total last;
// band_cursor [n] = band_off [:n].  One CTA of SCAN_BLOCK threads walks the
// counts 4 * SCAN_BLOCK at a time, 4 consecutive counts a thread.
__global__ void __launch_bounds__(SCAN_BLOCK)
band_scan_kernel(const int* __restrict__ band_count, int n,
                 int* __restrict__ band_off, int* __restrict__ band_cursor) {
  __shared__ int s_warp[SCAN_BLOCK / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int carry = 0;  // the total of the tiles before this one
  for (int tile0 = 0; tile0 < n; tile0 += 4 * SCAN_BLOCK) {
    const int i0 = tile0 + 4 * tid;
    int v[4], sum = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = i0 + j < n ? band_count[i0 + j] : 0;
      sum += v[j];
    }
    int incl = sum;  // inclusive scan of the thread sums within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warp totals
      int w = s_warp[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += t;
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    int run = carry + incl - sum + (warp ? s_warp[warp - 1] : 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i0 + j < n) {
        band_off[i0 + j] = run;
        band_cursor[i0 + j] = run;
      }
      run += v[j];
    }
    carry += s_warp[SCAN_BLOCK / 32 - 1];
    __syncthreads();  // s_warp is rewritten by the next tile
  }
  if (tid == 0) band_off[n] = carry;
}

// (C) record scatter into slot_rec [slots * rec], through a shared-memory
// sort of the CTA's points by band: records [POINTS_PER_CTA * rec] and
// their bands [POINTS_PER_CTA], then per band its count, its first global
// slot and its first sorted position.
template <class Binner>
__global__ void __launch_bounds__(BLOCK)
band_scatter_kernel(Binner bn, BandGeom g, int n_points, int ctas_per_tile,
                    int* __restrict__ band_cursor,
                    float* __restrict__ slot_rec) {
  extern __shared__ float4 s_mem4[];
  const int rec = bn.rec;
  float* s_rec = reinterpret_cast<float*>(s_mem4);
  int* s_band = reinterpret_cast<int*>(s_rec + POINTS_PER_CTA * rec);
  int* s_cnt = s_band + POINTS_PER_CTA;
  int* s_base = s_cnt + g.bands_per_tile;
  int* s_off = s_base + g.bands_per_tile;
  __shared__ int s_warp[BLOCK / 32];
  const int tile = blockIdx.x / ctas_per_tile;
  const int start = (blockIdx.x % ctas_per_tile) * POINTS_PER_CTA;
  for (int k = threadIdx.x; k < g.bands_per_tile; k += BLOCK) s_cnt[k] = 0;
  __syncthreads();
  const long long base = (long long)tile * n_points;
  typename Binner::Point pt[PPT];
  int band[PPT], rank[PPT], local[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = start + j * BLOCK + threadIdx.x;
    int row, col, sub;
    band[j] = -1;
    if (p < n_points) {
      pt[j] = bn.load(base + p);
      if (bn.cell(pt[j], row, col, sub)) {
        band[j] = g.band(row, col);
        local[j] = g.local(row, col, sub);
        rank[j] = atomicAdd(&s_cnt[band[j]], 1);
      }
    }
  }
  __syncthreads();
  int* cursor = band_cursor + (long long)tile * g.bands_per_tile;
  for (int k = threadIdx.x; k < g.bands_per_tile; k += BLOCK) {
    const int n = s_cnt[k];
    s_off[k] = n;
    if (n) s_base[k] = atomicAdd(cursor + k, n);
  }
  __syncthreads();
  const int total = block_exclusive_scan(s_off, g.bands_per_tile, s_warp);
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    if (band[j] < 0) continue;
    const int t = s_off[band[j]] + rank[j];
    bn.record(pt[j], base + start + j * BLOCK + threadIdx.x, local[j],
              s_rec + t * rec);
    s_band[t] = band[j];
  }
  __syncthreads();
  // consecutive sorted positions of one band go to consecutive slots
  for (int t = threadIdx.x; t < total; t += BLOCK) {
    const int b = s_band[t];
    float* dst = slot_rec + (long long)(s_base[b] + t - s_off[b]) * rec;
    const float* src = s_rec + t * rec;
    if ((rec & 3) == 0) {
      for (int c = 0; c < rec; c += 4)
        *reinterpret_cast<float4*>(dst + c) =
            *reinterpret_cast<const float4*>(src + c);
    } else {
      for (int c = 0; c < rec; c += 2)
        *reinterpret_cast<float2*>(dst + c) =
            *reinterpret_cast<const float2*>(src + c);
    }
  }
}

// Shared-memory bytes above the 48 KB default need the opt-in attribute.
// It is set once per kernel and device, and again only for a larger size.
template <auto Kernel>
inline cudaError_t allow_smem(size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  constexpr int kDevices = 64;
  static size_t granted[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && granted[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < kDevices) granted[dev] = bytes;
  return err;
}

// Passes (A)-(C) on `stream`.  Scratch: band_count, band_cursor [n_bands],
// band_off [n_bands + 1], slot_rec [B * n_points * rec].  Returns the first
// CUDA error.
template <class Binner>
cudaError_t bucket_points(const Binner& bn, const BandGeom& g, int n_tiles,
                          int n_points, int* band_count, int* band_off,
                          int* band_cursor, float* slot_rec,
                          cudaStream_t stream) {
  const int n_bands = n_tiles * g.bands_per_tile;
  const int ctas_per_tile = (n_points + POINTS_PER_CTA - 1) / POINTS_PER_CTA;
  const unsigned grid = (unsigned)n_tiles * ctas_per_tile;
  const size_t hist_smem = sizeof(int) * (size_t)g.bands_per_tile;
  const size_t scatter_smem =
      sizeof(float) * (size_t)POINTS_PER_CTA * (bn.rec + 1) + 3 * hist_smem;
  cudaError_t err = cudaMemsetAsync(band_count, 0,
                                    sizeof(int) * (size_t)n_bands, stream);
  if (err != cudaSuccess) return err;
  if (grid > 0) {
    err = allow_smem<band_hist_kernel<Binner>>(hist_smem);
    if (err != cudaSuccess) return err;
    band_hist_kernel<Binner><<<grid, BLOCK, hist_smem, stream>>>(
        bn, g, n_points, ctas_per_tile, band_count);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  band_scan_kernel<<<1, SCAN_BLOCK, 0, stream>>>(band_count, n_bands,
                                                 band_off, band_cursor);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (grid > 0) {
    err = allow_smem<band_scatter_kernel<Binner>>(scatter_smem);
    if (err != cudaSuccess) return err;
    band_scatter_kernel<Binner><<<grid, BLOCK, scatter_smem, stream>>>(
        bn, g, n_points, ctas_per_tile, band_cursor, slot_rec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Zero n floats of shared memory (16-byte aligned), 16 bytes a store.
__device__ __forceinline__ void zero_shared(float* s, int n) {
  float4* s4 = reinterpret_cast<float4*>(s);
  for (int i = threadIdx.x; i < (n >> 2); i += blockDim.x)
    s4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = (n & ~3) + threadIdx.x; i < n; i += blockDim.x) s[i] = 0.f;
}

}  // namespace bins
