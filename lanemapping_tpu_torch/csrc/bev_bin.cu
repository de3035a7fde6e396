// K1: point -> BEV grid binning, per-cell (sum, count), for Hopper (sm_90a).
//
// Replaces the TPU kernel `tests/pallas_reference_bev.py::bev_bin_sums`
// (body `_bin_kernel`), which recast binning as one-hot MXU contractions
// over 8-row bands because the TPU has no scatter atomics, and its
// production twin, the XLA scatter-add of
// `lanemapping_tpu/ops/voxelize.py::rasterize_bev_intensity`.  On Hopper the
// work has its natural shape: one thread per (tile, point) computes the
// point's cell and does two float atomicAdds, (value, 1), into the tile's
// [H, W] sums and counts.  The mean sum / max(count, 1) is taken by the
// caller (`ops/voxelize.py::rasterize_bev_intensity`).
//
// Fused in the kernel: the range test against pc_range, the point mask,
// the cell index floor((p - lo) / size), the `flip_rows` row and the
// intensity column.  `lo` and `size = (hi - lo) / img` arrive as float32
// computed on the host exactly as the JAX package computes them, and this
// file is compiled WITHOUT --use_fast_math, so the division is IEEE and a
// point on a cell border lands in the same cell as in JAX.  The range test
// is made on the float quotient (0 <= q < img), which for finite q equals
// JAX's test on floor(q) and rejects NaN.
//
// What bounds it: bytes.  Each point is read once (16 B for [x, y, z, i])
// plus its mask byte, and each output cell is written once (the wrapper's
// zero fill) and then hit by atomics that resolve in L2.  The other limit
// is same-address contention: about 15% of a survey's returns are road
// paint packed onto a few thousand cells, and atomics to one address
// serialise.  This first version does nothing about that; shared-memory
// privatisation, warp aggregation or a sort are later work.
//
// Float atomics add in a different order on every run: counts are exact,
// sums are not bit-reproducible.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void bev_bin_kernel(const float* __restrict__ points,
                               const uint8_t* __restrict__ mask,
                               long long n_total, int n_points, int n_cols,
                               float lo_x, float lo_y, float size_x,
                               float size_y, int img, int intensity_col,
                               int flip_rows, float* __restrict__ sums,
                               float* __restrict__ cnts) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_total; i += stride) {
    if (!mask[i]) continue;
    const float* p = points + i * n_cols;
    const float qx = (p[0] - lo_x) / size_x;
    const float qy = (p[1] - lo_y) / size_y;
    const float fimg = (float)img;
    if (!(qx >= 0.0f && qx < fimg && qy >= 0.0f && qy < fimg)) continue;
    const int col = (int)floorf(qx);
    const int iy = (int)floorf(qy);
    const int row = flip_rows ? (img - 1 - iy) : iy;
    const long long tile = i / n_points;
    const long long cell = tile * (long long)img * img +
                           (long long)row * img + col;
    atomicAdd(sums + cell, p[intensity_col]);
    atomicAdd(cnts + cell, 1.0f);
  }
}

}  // namespace

extern "C" int lm_bev_bin_sums(const float* points, const uint8_t* mask,
                               int n_tiles, int n_points, int n_cols,
                               float lo_x, float lo_y, float size_x,
                               float size_y, int img, int intensity_col,
                               int flip_rows, float* sums, float* cnts,
                               void* stream) {
  const long long n_total = (long long)n_tiles * n_points;
  if (n_total == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (n_total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  bev_bin_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      points, mask, n_total, n_points, n_cols, lo_x, lo_y, size_x, size_y,
      img, intensity_col, flip_rows, sums, cnts);
  return (int)cudaGetLastError();
}
