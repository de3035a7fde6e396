// K1z: point -> 3-D voxel binning in the z-fold layout, per-voxel mean of
// every point feature, for Hopper (sm_90a).
//
// Replaces the TPU kernel `tests/pallas_reference_bev.py::bev_bin_sums`
// (body `_bin_kernel`) in its z-fold use, the wrapper
// `voxelize_bev_zfold_pallas`, which returns the mean: there the TPU folded
// z into the row axis, ran one one-hot MXU contraction pass per feature over
// bands of rows held in VMEM, and transposed [C, Z, Y, X] -> [Y, X, Z*C].
// It also replaces the production twin, the XLA scatter-add of
// `lanemapping_tpu/ops/voxelize.py::voxelize_mean`.
//
// Design (passes (A)-(C) in `bin_bands.cuh`): the points are bucketed by
// band, a band being one y row of one tile, cut into x-chunks
// (`kernels/bin_bands.py::band_plan`; 192 x at 576 x 576 x 10 with C = 4,
// 38.4 KB of shared memory).  A point's record is the point itself, 16
// bytes at C = 4, up to C = 8 (pass (C) sorts 4,096 records in shared
// memory, 32 bytes each at most).  A wider point's record is (cell index
// within the band, point index), 8 bytes, and pass (D) reads the point's C
// columns from the input: K1z takes any C whose band fits the card's
// shared memory, as the TPU kernel, one pass per column, took any C.
// Pass (D), here: one CTA per band zeroes its shared sums
// [cells, C] and counts [cells], finds each record's voxel again with the
// same arithmetic, accumulates with shared-memory atomics and writes
// sum / max(count, 1) for the band's
// X-chunk * Z * C outputs, which are one contiguous stretch of the z-fold
// layout [B, Y, X, Z*C], in 16-byte stores, zeros of empty voxels included.
// Every output byte is written once: there is no zero fill, no read-modify-
// write of device memory and no separate mean pass.
//
// Fused in (A) and (C): the point mask, the range test against pc_range and
// the voxel index floor((p - lo) * inv) in x, y and z.  `lo` and `inv = 1 /
// ((hi - lo) / [X, Y, Z])` arrive as float32 computed on the host as the
// JAX package's jitted programs compute them (`point_voxel_ids`; XLA turns
// the division by the constant voxel size into a product with its float32
// reciprocal), and this file is compiled WITHOUT --use_fast_math, so a point
// on a voxel border lands in the same voxel as in JAX.  The range test is
// made on the float voxel coordinate (0 <= q < dim), which for finite q
// equals JAX's test on floor(q) and rejects NaN.
//
// What bounds it: bytes.  The function must read the points (4 * C bytes
// each) and the mask once and write the mean once (425 MB at B = 8 on the
// 576 x 576 x 10 grid with C = 4).  The bucketing adds a second read of the
// points and a write and a read of each binned point.  Beyond 8 columns
// pass (D) gathers each binned point's C columns from the input again and
// adds C shared-memory atomics a point into bands of up to 196 KB.
//
// Shared-memory atomics add in a different order on every run: counts are
// exact, means are not bit-reproducible.

#include "bin_bands.cuh"

namespace {

// kIndexed: the record is (cell index, point index), for C > 8.  A
// template argument, not a runtime test: a live cell index costs the
// scatter pass of the C <= 8 records registers it does not need.
template <bool kIndexed>
struct VoxelBinner {
  const float* __restrict__ points;
  const uint8_t* __restrict__ mask;
  int n_vals;  // C: every column of a point is averaged
  int rec;     // floats per record: C rounded up to a power of two, or
               // 2 for (cell index, point index) where C > 8
  bool vec4;   // C == 4, 16-byte aligned: one float4 load a point
  float lo_x, lo_y, lo_z, inv_x, inv_y, inv_z;
  int gx, gy, gz;

  struct Point {
    float x, y, z, w;  // the first four columns (w 0 where C == 3)
    bool valid;        // the mask
  };

  __device__ __forceinline__ Point load(long long i) const {
    const float* p = points + i * n_vals;
    Point q;
    if (vec4) {
      const float4 f = *reinterpret_cast<const float4*>(p);
      q.x = f.x, q.y = f.y, q.z = f.z, q.w = f.w;
    } else {
      q.x = p[0], q.y = p[1], q.z = p[2], q.w = n_vals > 3 ? p[3] : 0.0f;
    }
    q.valid = mask[i] != 0;
    return q;
  }

  // row = y voxel, col = x voxel, sub = z voxel; false out of range
  __device__ __forceinline__ bool voxel(float x, float y, float z, int& row,
                                        int& col, int& sub) const {
    const float qx = (x - lo_x) * inv_x;
    const float qy = (y - lo_y) * inv_y;
    const float qz = (z - lo_z) * inv_z;
    if (!(qx >= 0.0f && qx < (float)gx && qy >= 0.0f && qy < (float)gy &&
          qz >= 0.0f && qz < (float)gz))
      return false;
    col = (int)floorf(qx);
    row = (int)floorf(qy);
    sub = (int)floorf(qz);
    return true;
  }

  __device__ __forceinline__ bool cell(const Point& q, int& row, int& col,
                                       int& sub) const {
    return q.valid && voxel(q.x, q.y, q.z, row, col, sub);
  }

  // the cell index within the band and the point index where kIndexed
  // (`band_plan` keeps B * N * 2 within int32); else the point itself,
  // zero-padded to rec floats: (D) finds its voxel again from x, y, z
  // with the same arithmetic
  __device__ __forceinline__ void record(const Point& q, long long i,
                                         int local, float* dst) const {
    if constexpr (kIndexed) {
      *reinterpret_cast<float2*>(dst) =
          make_float2(__int_as_float(local), __int_as_float((int)i));
      return;
    }
    if (n_vals == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(q.x, q.y, q.z, q.w);
      return;
    }
    const float* p = points + i * n_vals;
    for (int c = 0; c < rec; ++c) dst[c] = c < n_vals ? p[c] : 0.0f;
  }
};

// (D) one CTA per band: shared sums [cells * C], padded to 16 bytes, then
// counts [cells].
template <bool kIndexed>
__global__ void voxel_mean_kernel(VoxelBinner<kIndexed> bn, bins::BandGeom g,
                                  const int* __restrict__ band_off,
                                  const float* __restrict__ slot_rec,
                                  float* __restrict__ out) {
  extern __shared__ float4 s_mem4[];
  float* s_sum = reinterpret_cast<float*>(s_mem4);
  const int C = bn.n_vals;
  const int band = blockIdx.x;
  const int tile = band / g.bands_per_tile;
  int r0, rows, x0, cols;
  g.rect(band % g.bands_per_tile, r0, rows, x0, cols);
  const int cells = rows * cols * g.depth;
  const int max_cells = g.rows_per_band * g.x_chunk * g.depth;
  const int n_sum = (max_cells * C + 3) & ~3;  // s_cnt 16-byte aligned
  float* s_cnt = s_sum + n_sum;
  bins::zero_shared(s_sum, n_sum + max_cells);
  __syncthreads();

  const int seg_end = band_off[band + 1];
  if constexpr (kIndexed) {
    for (int s = band_off[band] + threadIdx.x; s < seg_end;
         s += blockDim.x) {
      const float2 r = reinterpret_cast<const float2*>(slot_rec)[s];
      const int l = __float_as_int(r.x);
      const float* p = bn.points + (long long)__float_as_int(r.y) * C;
      float* dst = s_sum + l * C;
      for (int c = 0; c < C; ++c) atomicAdd(dst + c, p[c]);
      atomicAdd(s_cnt + l, 1.0f);
    }
  } else {
    for (int s = band_off[band] + threadIdx.x; s < seg_end;
         s += blockDim.x) {
      const float* r = slot_rec + (long long)s * bn.rec;
      float4 f;
      if (C == 4) {
        f = *reinterpret_cast<const float4*>(r);
      } else {
        f = make_float4(r[0], r[1], r[2], 0.0f);
      }
      int row, col, sub;
      if (!bn.voxel(f.x, f.y, f.z, row, col, sub))
        continue;  // never: binned
      const int l = g.local(row, col, sub);
      float* dst = s_sum + l * C;
      if (C == 4) {
        atomicAdd(dst + 0, f.x);
        atomicAdd(dst + 1, f.y);
        atomicAdd(dst + 2, f.z);
        atomicAdd(dst + 3, f.w);
      } else {
        for (int c = 0; c < C; ++c) atomicAdd(dst + c, r[c]);
      }
      atomicAdd(s_cnt + l, 1.0f);
    }
  }
  __syncthreads();

  // the band's outputs: one stretch of n_out floats of the z-fold layout;
  // sum / max(count, 1) is the sum itself where the count is 0 or 1
  const long long out_off =
      (((long long)tile * g.height + r0) * g.width + x0) * g.depth * C;
  const int n_out = cells * C;
  int vec_end = 0;
  if ((out_off & 3) == 0) {
    float4* out4 = reinterpret_cast<float4*>(out + out_off);
    vec_end = n_out & ~3;
    for (int q = threadIdx.x; q < (n_out >> 2); q += blockDim.x) {
      float4 m = s_mem4[q];
      if (C == 4) {  // one voxel per float4
        const float n = s_cnt[q];
        if (n > 1.0f) m = make_float4(m.x / n, m.y / n, m.z / n, m.w / n);
      } else {
        const int e = q << 2;
        float n;
        if ((n = s_cnt[e / C]) > 1.0f) m.x /= n;
        if ((n = s_cnt[(e + 1) / C]) > 1.0f) m.y /= n;
        if ((n = s_cnt[(e + 2) / C]) > 1.0f) m.z /= n;
        if ((n = s_cnt[(e + 3) / C]) > 1.0f) m.w /= n;
      }
      out4[q] = m;
    }
  }
  for (int e = vec_end + threadIdx.x; e < n_out; e += blockDim.x) {
    const float n = s_cnt[e / C];
    out[out_off + e] = n > 1.0f ? s_sum[e] / n : s_sum[e];
  }
}

constexpr int MEAN_BLOCK = 256;
// (C > 8) a band of up to 196 KB leaves one CTA an SM, whose threads wait
// on the gathers of their points' columns: four times the threads
constexpr int WIDE_MEAN_BLOCK = 1024;

template <bool kIndexed>
cudaError_t bin_mean(const VoxelBinner<kIndexed>& bn,
                     const bins::BandGeom& g, int n_tiles, int n_points,
                     int smem_bytes, int* band_count, int* band_off,
                     int* band_cursor, float* slot_rec, float* out,
                     cudaStream_t stream) {
  cudaError_t err = bins::bucket_points(bn, g, n_tiles, n_points, band_count,
                                        band_off, band_cursor, slot_rec,
                                        stream);
  if (err != cudaSuccess) return err;
  const unsigned n_bands = (unsigned)n_tiles * g.bands_per_tile;
  if (n_bands > 0) {
    err = bins::allow_smem<voxel_mean_kernel<kIndexed>>((size_t)smem_bytes);
    if (err != cudaSuccess) return err;
    constexpr int block = kIndexed ? WIDE_MEAN_BLOCK : MEAN_BLOCK;
    voxel_mean_kernel<kIndexed><<<n_bands, block, smem_bytes, stream>>>(
        bn, g, band_off, slot_rec, out);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// Plan (`kernels/bin_bands.py::band_plan`): rows_per_band, x_chunk,
// n_xchunks, bands_per_tile, smem_bytes of (D), rec floats per record
// (`kernels/voxel_bin.py::record_floats`: a point of 3 or more columns
// takes 4 or more, so 2 floats are a (cell index, point index) record).
extern "C" int lm_voxel_bin_mean(
    const float* points, const uint8_t* mask, int n_tiles, int n_points,
    int n_cols, float lo_x, float lo_y, float lo_z, float inv_x,
    float inv_y, float inv_z, int gx, int gy, int gz, int rows_per_band,
    int x_chunk, int n_xchunks, int bands_per_tile, int smem_bytes, int rec,
    int* band_count, int* band_off, int* band_cursor, float* slot_rec,
    float* out, void* stream_ptr) {
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  const bins::BandGeom g{gy, gx, gz, rows_per_band, x_chunk, n_xchunks,
                         bands_per_tile};
  const bool vec4 = n_cols == 4 && ((uintptr_t)points & 15) == 0;
  if (rec == 2) {
    const VoxelBinner<true> bn{points, mask, n_cols, rec, vec4, lo_x, lo_y,
                               lo_z, inv_x, inv_y, inv_z, gx, gy, gz};
    return (int)bin_mean(bn, g, n_tiles, n_points, smem_bytes, band_count,
                         band_off, band_cursor, slot_rec, out, stream);
  }
  const VoxelBinner<false> bn{points, mask, n_cols, rec, vec4, lo_x, lo_y,
                              lo_z, inv_x, inv_y, inv_z, gx, gy, gz};
  return (int)bin_mean(bn, g, n_tiles, n_points, smem_bytes, band_count,
                       band_off, band_cursor, slot_rec, out, stream);
}
