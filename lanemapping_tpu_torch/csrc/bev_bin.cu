// K1: point -> BEV grid binning, per-cell (mean, count) of one value
// column, for Hopper (sm_90a).
//
// Replaces the TPU kernel `tests/pallas_reference_bev.py::bev_bin_sums`
// (body `_bin_kernel`) and its wrapper `rasterize_bev_intensity_pallas`,
// which recast binning as one-hot MXU contractions over 8-row bands held in
// VMEM because the TPU has no scatter atomics, and their production twin,
// the XLA scatter-add of `lanemapping_tpu/ops/voxelize.py::
// rasterize_bev_intensity`.
//
// Design (passes (A)-(C) in `bin_bands.cuh`): the points are bucketed by
// band, a band being a few rows of one tile (`kernels/bin_bands.py::
// band_plan`; 4 rows of 1152 cells, 36.9 KB of shared memory, on the
// flagship grid).  A point's record is its value and its cell's index
// within the band, 8 bytes.  Pass (D), here: one CTA per band zeroes its
// shared sums and counts, accumulates its segment with shared-memory
// atomics and writes the band's mean sum / max(count, 1) and count, one
// contiguous stretch of each [B, img, img] output, in 16-byte stores, empty
// cells included.  Every output byte is written once: no zero fill, no
// read-modify-write of device memory, no separate mean pass.  About 15% of
// a survey's returns are road paint on a few thousand cells; their atomics
// now meet in shared memory.
//
// Fused in (A) and (C): the range test against pc_range, the point mask,
// the cell index floor((p - lo) / size), the `flip_rows` row (applied before
// the band is formed) and the value column.  `lo` and `size = (hi - lo) /
// img` arrive as float32 computed on the host exactly as the JAX package
// computes them, and this file is compiled WITHOUT --use_fast_math, so the
// division is IEEE and a point on a cell border lands in the same cell as in
// JAX.  The range test is made on the float quotient (0 <= q < img), which
// for finite q equals JAX's test on floor(q) and rejects NaN.
//
// What bounds it: bytes.  The function must read the points and the mask
// once and write the two [B, img, img] float32 images once.  The bucketing
// adds a second read of the points and a write and a read of the 8-byte
// records.
//
// Shared-memory atomics add in a different order on every run: counts are
// exact, means are not bit-reproducible.

#include "bin_bands.cuh"

namespace {

struct BevBinner {
  const float* __restrict__ points;
  const uint8_t* __restrict__ mask;
  int n_cols;
  bool vec4;  // 4 columns, 16-byte aligned: one float4 load a point
  float lo_x, lo_y, size_x, size_y;
  int img, value_col, flip_rows;
  static constexpr int rec = 2;  // [value, cell index within the band]

  struct Point {
    float x, y, v;  // v: the value column
    bool valid;     // the mask
  };

  __device__ __forceinline__ Point load(long long i) const {
    const float* p = points + i * n_cols;
    Point q;
    if (vec4) {
      const float4 f = *reinterpret_cast<const float4*>(p);
      q.x = f.x, q.y = f.y;
      q.v = value_col == 3 ? f.w : value_col == 2 ? f.z
                                 : value_col == 1 ? f.y : f.x;
    } else {
      q.x = p[0], q.y = p[1], q.v = p[value_col];
    }
    q.valid = mask[i] != 0;
    return q;
  }

  __device__ __forceinline__ bool cell(const Point& q, int& row, int& col,
                                       int& sub) const {
    if (!q.valid) return false;
    const float qx = (q.x - lo_x) / size_x;
    const float qy = (q.y - lo_y) / size_y;
    const float fimg = (float)img;
    if (!(qx >= 0.0f && qx < fimg && qy >= 0.0f && qy < fimg)) return false;
    col = (int)floorf(qx);
    const int iy = (int)floorf(qy);
    row = flip_rows ? (img - 1 - iy) : iy;
    sub = 0;
    return true;
  }

  __device__ __forceinline__ void record(const Point& q, long long, int local,
                                         float* dst) const {
    *reinterpret_cast<float2*>(dst) = make_float2(q.v, __int_as_float(local));
  }
};

__device__ __forceinline__ float mean_of(float sum, float n) {
  return n > 1.0f ? sum / n : sum;
}

// (D) one CTA per band: shared sums [cells], padded to 16 bytes, then
// counts [cells].
__global__ void bev_mean_kernel(bins::BandGeom g,
                                const int* __restrict__ band_off,
                                const float2* __restrict__ slot_rec,
                                float* __restrict__ mean,
                                float* __restrict__ cnt) {
  extern __shared__ float4 s_mem4[];
  float* s_sum = reinterpret_cast<float*>(s_mem4);
  const int band = blockIdx.x;
  const int tile = band / g.bands_per_tile;
  int r0, rows, x0, cols;
  g.rect(band % g.bands_per_tile, r0, rows, x0, cols);
  const int cells = rows * cols;
  const int max_cells = g.rows_per_band * g.x_chunk;
  float* s_cnt = s_sum + ((max_cells + 3) & ~3);  // 16-byte aligned
  bins::zero_shared(s_sum, ((max_cells + 3) & ~3) + max_cells);
  __syncthreads();

  const int seg_end = band_off[band + 1];
  for (int s = band_off[band] + threadIdx.x; s < seg_end; s += blockDim.x) {
    const float2 r = slot_rec[s];
    const int l = __float_as_int(r.y);
    atomicAdd(s_sum + l, r.x);
    atomicAdd(s_cnt + l, 1.0f);
  }
  __syncthreads();

  // the band's cells: one stretch of each [B, img, img] output;
  // sum / max(count, 1) is the sum itself where the count is 0 or 1
  const long long out_off = ((long long)tile * g.height + r0) * g.width + x0;
  int vec_end = 0;
  if ((out_off & 3) == 0) {
    float4* mean4 = reinterpret_cast<float4*>(mean + out_off);
    float4* cnt4 = reinterpret_cast<float4*>(cnt + out_off);
    const float4* c4 = reinterpret_cast<const float4*>(s_cnt);
    vec_end = cells & ~3;
    for (int q = threadIdx.x; q < (cells >> 2); q += blockDim.x) {
      const float4 s = s_mem4[q];
      const float4 n = c4[q];
      mean4[q] = make_float4(mean_of(s.x, n.x), mean_of(s.y, n.y),
                             mean_of(s.z, n.z), mean_of(s.w, n.w));
      cnt4[q] = n;
    }
  }
  for (int e = vec_end + threadIdx.x; e < cells; e += blockDim.x) {
    mean[out_off + e] = mean_of(s_sum[e], s_cnt[e]);
    cnt[out_off + e] = s_cnt[e];
  }
}

constexpr int MEAN_BLOCK = 256;

}  // namespace

// Plan (`kernels/bin_bands.py::band_plan`): rows_per_band, x_chunk,
// n_xchunks, bands_per_tile, smem_bytes of (D), rec floats per record (2).
extern "C" int lm_bev_bin_mean(
    const float* points, const uint8_t* mask, int n_tiles, int n_points,
    int n_cols, float lo_x, float lo_y, float size_x, float size_y, int img,
    int value_col, int flip_rows, int rows_per_band, int x_chunk,
    int n_xchunks, int bands_per_tile, int smem_bytes, int rec,
    int* band_count, int* band_off, int* band_cursor, float* slot_rec,
    float* mean, float* cnt, void* stream_ptr) {
  if (rec != BevBinner::rec) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  const bins::BandGeom g{img, img, 1, rows_per_band, x_chunk, n_xchunks,
                         bands_per_tile};
  const bool vec4 = n_cols == 4 && ((uintptr_t)points & 15) == 0;
  const BevBinner bn{points, mask, n_cols, vec4, lo_x, lo_y, size_x,
                     size_y, img, value_col, flip_rows};
  cudaError_t err = bins::bucket_points(bn, g, n_tiles, n_points, band_count,
                                        band_off, band_cursor, slot_rec,
                                        stream);
  if (err != cudaSuccess) return (int)err;
  const unsigned n_bands = (unsigned)n_tiles * bands_per_tile;
  if (n_bands > 0) {
    err = bins::allow_smem<bev_mean_kernel>((size_t)smem_bytes);
    if (err != cudaSuccess) return (int)err;
    bev_mean_kernel<<<n_bands, MEAN_BLOCK, smem_bytes, stream>>>(
        g, band_off, reinterpret_cast<const float2*>(slot_rec), mean, cnt);
    err = cudaGetLastError();
  }
  return (int)err;
}
