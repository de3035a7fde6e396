// K1z: point -> 3-D voxel binning in the z-fold layout, per-voxel (sums of
// every point feature, count), for Hopper (sm_90a).
//
// Replaces the TPU kernel `tests/pallas_reference_bev.py::bev_bin_sums`
// (body `_bin_kernel`) in its z-fold use, the wrapper
// `voxelize_bev_zfold_pallas`: there the TPU folded z into the row axis and
// ran one one-hot MXU contraction pass per feature (a vmap over C), then
// transposed [C, Z, Y, X] -> [Y, X, Z*C].  It also replaces the production
// twin, the XLA scatter-add of
// `lanemapping_tpu/ops/voxelize.py::voxelize_mean`.  On Hopper the work has
// its natural shape: one thread per (tile, point) computes the point's
// voxel (ix, iy, iz) and does C + 1 float atomicAdds, (features, 1), straight
// into sums [B, Y, X, Z, C] and counts [B, Y, X, Z].  That IS the z-fold
// layout [B, Y, X, Z*C], so no transpose pass follows.  The mean
// sum / max(count, 1) is taken by the caller
// (`ops/voxelize.py::voxelize_bev_zfold`).
//
// Fused in the kernel: the point mask, the range test against pc_range and
// the voxel index floor((p - lo) / size) in x, y and z.  `lo` and
// `size = (hi - lo) / [X, Y, Z]` arrive as float32 computed on the host
// exactly as the JAX package computes them (`point_voxel_ids`), and this
// file is compiled WITHOUT --use_fast_math, so the division is IEEE and a
// point on a voxel border lands in the same voxel as in JAX.  The range test
// is made on the float quotient (0 <= q < dim), which for finite q equals
// JAX's test on floor(q) and rejects NaN.
//
// What bounds it: bytes.  Each point is read once (4 * C bytes) plus its
// mask byte, and each output voxel is written once (the wrapper's zero fill:
// 531 MB at B=8 on the 576 x 576 x 10 grid with C=4, ten times the points)
// and then hit by atomics; the outputs do not fit in L2, so an atomic on a
// voxel that no other point touched is a read-modify-write of device memory.
// Paint returns pile onto a few thousand voxels of one z slab, where the
// same-address atomics serialise.  This first version does nothing about
// either; a sparse output (sort or hash), shared-memory privatisation, or a
// fused mean are later work.
//
// Float atomics add in a different order on every run: counts are exact,
// sums are not bit-reproducible.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void voxel_bin_kernel(const float* __restrict__ points,
                                 const uint8_t* __restrict__ mask,
                                 long long n_total, int n_points, int n_cols,
                                 float lo_x, float lo_y, float lo_z,
                                 float size_x, float size_y, float size_z,
                                 int gx, int gy, int gz,
                                 float* __restrict__ sums,
                                 float* __restrict__ cnts) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_total; i += stride) {
    if (!mask[i]) continue;
    const float* p = points + i * n_cols;
    const float qx = (p[0] - lo_x) / size_x;
    const float qy = (p[1] - lo_y) / size_y;
    const float qz = (p[2] - lo_z) / size_z;
    if (!(qx >= 0.0f && qx < (float)gx && qy >= 0.0f && qy < (float)gy &&
          qz >= 0.0f && qz < (float)gz))
      continue;
    const long long ix = (long long)floorf(qx);
    const long long iy = (long long)floorf(qy);
    const long long iz = (long long)floorf(qz);
    const long long tile = i / n_points;
    const long long voxel = ((tile * gy + iy) * gx + ix) * gz + iz;
    float* s = sums + voxel * n_cols;
    for (int c = 0; c < n_cols; ++c) atomicAdd(s + c, p[c]);
    atomicAdd(cnts + voxel, 1.0f);
  }
}

}  // namespace

extern "C" int lm_voxel_bin_sums(const float* points, const uint8_t* mask,
                                 int n_tiles, int n_points, int n_cols,
                                 float lo_x, float lo_y, float lo_z,
                                 float size_x, float size_y, float size_z,
                                 int gx, int gy, int gz, float* sums,
                                 float* cnts, void* stream) {
  const long long n_total = (long long)n_tiles * n_points;
  if (n_total == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (n_total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  voxel_bin_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      points, mask, n_total, n_points, n_cols, lo_x, lo_y, lo_z, size_x,
      size_y, size_z, gx, gy, gz, sums, cnts);
  return (int)cudaGetLastError();
}
