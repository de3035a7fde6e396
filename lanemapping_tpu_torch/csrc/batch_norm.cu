// K2: training BatchNorm of a bf16 or fp16 activation in one mixed-precision
// pass each way, for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fuses flax's BatchNorm into the
// ops around it.  Added for the flagship's bf16 training step, whose 36
// BatchNorms (1.207e9 elements a step at batch 8) went through float32
// copies and cuDNN, and then PyTorch's mixed-precision kernels, whose
// statistics pass reads at 15-19% of the card's 3.35 TB/s (PERF.md).  Bound
// by device memory: 6 bytes an element forward, 10 backward, nothing else.
// The design streams 16-byte loads, four rows in flight a thread, as many
// CTAs as fit on the SMs at once (one wave), and meets the CTAs' sums in a
// small second launch instead of atomics.
//
// The activation is read as [M, C] rows with the channels innermost (a
// channels-last [N, C, H, W] tensor, or [N, C]); C is a multiple of 8, so a
// thread moves 8 channels of a row in one 16-byte load.  Statistics, weight,
// bias and every per-channel figure are float32 (float64 where partial sums
// meet); the activation's dtype goes in and out, and nothing float32 of its
// size is written.
//
// Forward (`lm_bn_forward`), three launches:
//   reduce_rows   each CTA sums u = x - s and u * (x - s) over its rows per
//                 channel, s being the first row (a shift that keeps the
//                 float32 sums of a channel far from zero from cancelling);
//                 one float32 pair per channel and CTA;
//   finalize_stats  per channel, the CTAs' pairs summed in float64: mean,
//                 biased variance, invstd = 1 / sqrt(var + eps), scale =
//                 invstd * w; the running statistics move toward the mean
//                 and the biased variance (unless frozen: null pointers);
//   affine_rows   y = (x - mean) * scale + b.
// Backward (`lm_bn_backward`), the same three shapes:
//   reduce_rows   sum(dy) and sum(dy * (x - mean)) per channel and CTA;
//   finalize_grads  db, dw = invstd * sum(dy * (x - mean)), and dx's
//                 coefficients;
//   affine_rows   dx = dy * w * invstd + (x - mean) * k2 + k3, with k2 =
//                 -w * invstd^3 * mean(dy * (x - mean)), k3 = -w * invstd *
//                 mean(dy).
// Bytes an element: 2 + 4 forward, 4 + 6 backward.  The summation order is
// fixed (no atomics), so a launch gives the same bits every time.

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;      // elements of one 16-byte load
constexpr int UNROLL = 4;   // rows a thread loads before it adds
constexpr int FIN_CH = 8;   // channels a finalize CTA covers
constexpr int FIN_LANES = THREADS / FIN_CH;

__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f(float v) {
  return __float2half_rn(v);
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&f)[VEC]) {
  union { uint4 raw; T e[VEC]; } u;
  u.raw = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = to_f(u.e[i]);
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&f)[VEC]) {
  union { uint4 raw; T e[VEC]; } u;
#pragma unroll
  for (int i = 0; i < VEC; ++i) u.e[i] = from_f<T>(f[i]);
  *reinterpret_cast<uint4*>(p) = u.raw;
}

// Thread t of a CTA takes the 8-channel group v = t % V of rows lane, lane +
// lanes, ... (V = C / 8, lanes = THREADS / V); threads past lanes * V idle.
struct Rows {
  long long M;
  int C, V, lanes;
  long long per_cta;
};

// part[cta][0][c] = sum u, part[cta][1][c] = sum u * (p - s) over the CTA's
// rows, u = q if HAS_Q else p - s; s = center, or p's first row if center
// is null.
template <typename T, bool HAS_Q>
__global__ void __launch_bounds__(THREADS)
reduce_rows(const T* __restrict__ p, const T* __restrict__ q,
            const float* __restrict__ center, Rows r,
            float* __restrict__ part) {
  __shared__ float sh[2][THREADS * VEC];
  const int t = threadIdx.x, v = t % r.V, lane = t / r.V;
  const bool active = lane < r.lanes;
  float s1[VEC], s2[VEC], c0[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
  if (active) {
    if (center != nullptr) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) c0[i] = center[v * VEC + i];
    } else {
      load8(p + v * VEC, c0);
    }
    const long long r0 = (long long)blockIdx.x * r.per_cta;
    const long long r1 = min(r.M, r0 + r.per_cta);
    for (long long row = r0 + lane; row < r1;
         row += (long long)r.lanes * UNROLL) {
      float pv[UNROLL][VEC], qv[UNROLL][VEC];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const long long rk = row + (long long)k * r.lanes;
        if (rk < r1) {
          load8(p + rk * r.C + v * VEC, pv[k]);
          if (HAS_Q) load8(q + rk * r.C + v * VEC, qv[k]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) pv[k][i] = c0[i], qv[k][i] = 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = pv[k][i] - c0[i];
          const float u = HAS_Q ? qv[k][i] : d;
          s1[i] += u;
          s2[i] = fmaf(u, d, s2[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sh[0][t * VEC + i] = s1[i];   // = lane * C + v * VEC + i
    sh[1][t * VEC + i] = s2[i];
  }
  __syncthreads();
  for (int c = t; c < r.C; c += THREADS) {
    double a = 0.0, b = 0.0;
    for (int l = 0; l < r.lanes; ++l) {
      a += sh[0][l * r.C + c];
      b += sh[1][l * r.C + c];
    }
    part[(2LL * blockIdx.x) * r.C + c] = (float)a;
    part[(2LL * blockIdx.x + 1) * r.C + c] = (float)b;
  }
}

// The CTAs' pairs of channel c summed in float64 (FIN_LANES threads a
// channel, then the lanes in a fixed order): the two sums through (a, b).
__device__ __forceinline__ bool channel_sums(const float* __restrict__ part,
                                             int ctas, int C, double& a,
                                             double& b) {
  __shared__ double sa[FIN_LANES][FIN_CH], sb[FIN_LANES][FIN_CH];
  const int cl = threadIdx.x % FIN_CH, gl = threadIdx.x / FIN_CH;
  const int c = blockIdx.x * FIN_CH + cl;
  a = 0.0;
  b = 0.0;
  if (c < C) {
    for (int g = gl; g < ctas; g += FIN_LANES) {
      a += part[(2LL * g) * C + c];
      b += part[(2LL * g + 1) * C + c];
    }
  }
  sa[gl][cl] = a;
  sb[gl][cl] = b;
  __syncthreads();
  if (gl != 0 || c >= C) return false;
  for (int k = 1; k < FIN_LANES; ++k) {
    a += sa[k][cl];
    b += sb[k][cl];
  }
  return true;
}

// stats = [mean | invstd | scale | bias], each [C] float32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
finalize_stats(const float* __restrict__ part, int ctas, const T* __restrict__ x,
               Rows r, const float* __restrict__ w,
               const float* __restrict__ bias, float eps, float momentum,
               float* __restrict__ running_mean,
               float* __restrict__ running_var, float* __restrict__ stats) {
  double a, b;
  if (!channel_sums(part, ctas, r.C, a, b)) return;
  const int C = r.C, c = blockIdx.x * FIN_CH + threadIdx.x % FIN_CH;
  const double n = (double)r.M, d = a / n;
  double var = b / n - d * d;
  if (var < 0.0) var = 0.0;
  const double mean = (double)to_f(x[c]) + d;
  const double invstd = 1.0 / sqrt(var + (double)eps);
  stats[c] = (float)mean;
  stats[C + c] = (float)invstd;
  stats[2 * C + c] = (float)(invstd * (double)w[c]);
  stats[3 * C + c] = bias[c];
  if (running_mean != nullptr) {
    const double m = (double)momentum;
    running_mean[c] = (float)((1.0 - m) * running_mean[c] + m * mean);
    running_var[c] = (float)((1.0 - m) * running_var[c] + m * var);
  }
}

// coef = [k_dy | k_xc | k_c], each [C] float32; dw, db [C] float32.
__global__ void __launch_bounds__(THREADS)
finalize_grads(const float* __restrict__ part, int ctas, Rows r,
               const float* __restrict__ w, const float* __restrict__ stats,
               float* __restrict__ dw, float* __restrict__ db,
               float* __restrict__ coef) {
  double a, b;
  if (!channel_sums(part, ctas, r.C, a, b)) return;
  const int C = r.C, c = blockIdx.x * FIN_CH + threadIdx.x % FIN_CH;
  const double n = (double)r.M, invstd = (double)stats[C + c];
  const double k = (double)w[c] * invstd;
  db[c] = (float)a;
  dw[c] = (float)(b * invstd);
  coef[c] = (float)k;
  coef[C + c] = (float)(-k * invstd * invstd * (b / n));
  coef[2 * C + c] = (float)(-k * (a / n));
}

// out = (p - center) * kp + q * kq + kc per channel (q, kq only if HAS_Q).
template <typename T, bool HAS_Q>
__global__ void __launch_bounds__(THREADS)
affine_rows(const T* __restrict__ p, const T* __restrict__ q,
            const float* __restrict__ center, const float* __restrict__ kp,
            const float* __restrict__ kq, const float* __restrict__ kc,
            Rows r, T* __restrict__ out) {
  const int t = threadIdx.x, v = t % r.V, lane = t / r.V;
  if (lane >= r.lanes) return;
  float c0[VEC], a[VEC], g[VEC], k[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = v * VEC + i;
    c0[i] = center[c];
    a[i] = kp[c];
    g[i] = HAS_Q ? kq[c] : 0.f;
    k[i] = kc[c];
  }
  const long long r0 = (long long)blockIdx.x * r.per_cta;
  const long long r1 = min(r.M, r0 + r.per_cta);
  for (long long row = r0 + lane; row < r1;
       row += (long long)r.lanes * UNROLL) {
    float pv[UNROLL][VEC], qv[UNROLL][VEC];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const long long rj = row + (long long)j * r.lanes;
      if (rj < r1) {
        load8(p + rj * r.C + v * VEC, pv[j]);
        if (HAS_Q) load8(q + rj * r.C + v * VEC, qv[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const long long rj = row + (long long)j * r.lanes;
      if (rj < r1) {
        float o[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          o[i] = fmaf(pv[j][i] - c0[i], a[i], k[i]);
          if (HAS_Q) o[i] = fmaf(qv[j][i], g[i], o[i]);
        }
        store8(out + rj * r.C + v * VEC, o);
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// CTAs of `kernel` that one SM holds at once.
template <typename K>
int per_sm(K kernel) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, 0);
  return n > 0 ? n : 1;
}

// Rows of the CTAs: at most `limit` CTAs, each >= one pass of its lanes.
Rows plan(long long M, int C, long long limit, int* ctas) {
  Rows r;
  r.M = M;
  r.C = C;
  r.V = C / VEC;
  r.lanes = THREADS / r.V;
  long long per = (M + limit - 1) / limit;
  if (per < r.lanes) per = r.lanes;
  r.per_cta = per;
  *ctas = (int)((M + per - 1) / per);
  return r;
}

bool bad_shape(long long M, int C, int max_ctas) {
  return M <= 0 || C <= 0 || C % VEC != 0 || C / VEC > THREADS ||
         max_ctas <= 0;
}

template <typename T>
int forward(const void* x, long long M, int C, const float* w,
            const float* b, float eps, float momentum, float* running_mean,
            float* running_var, float* part, int max_ctas, float* stats,
            void* y, cudaStream_t s) {
  static const int red = per_sm(reduce_rows<T, false>);
  static const int aff = per_sm(affine_rows<T, false>);
  int ctas, ctas_a;
  const Rows r = plan(M, C, std::min(max_ctas, red * sm_count()), &ctas);
  const Rows ra = plan(M, C, aff * sm_count(), &ctas_a);
  const T* xt = static_cast<const T*>(x);
  reduce_rows<T, false><<<ctas, THREADS, 0, s>>>(xt, nullptr, nullptr, r,
                                                  part);
  finalize_stats<T><<<(C + FIN_CH - 1) / FIN_CH, THREADS, 0, s>>>(
      part, ctas, xt, r, w, b, eps, momentum, running_mean, running_var,
      stats);
  affine_rows<T, false><<<ctas_a, THREADS, 0, s>>>(
      xt, nullptr, stats, stats + 2 * C, nullptr, stats + 3 * C, ra,
      static_cast<T*>(y));
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* dy, const void* x, long long M, int C,
             const float* w, const float* stats, float* part, int max_ctas,
             float* coef, float* dw, float* db, void* dx, cudaStream_t s) {
  static const int red = per_sm(reduce_rows<T, true>);
  static const int aff = per_sm(affine_rows<T, true>);
  int ctas, ctas_a;
  const Rows r = plan(M, C, std::min(max_ctas, red * sm_count()), &ctas);
  const Rows ra = plan(M, C, aff * sm_count(), &ctas_a);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dy);
  reduce_rows<T, true><<<ctas, THREADS, 0, s>>>(xt, gt, stats, r, part);
  finalize_grads<<<(C + FIN_CH - 1) / FIN_CH, THREADS, 0, s>>>(
      part, ctas, r, w, stats, dw, db, coef);
  affine_rows<T, true><<<ctas_a, THREADS, 0, s>>>(
      xt, gt, stats, coef + C, coef, coef + 2 * C, ra, static_cast<T*>(dx));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 bf16, 1 fp16.  part: [max_ctas, 2, C] float32 scratch; stats:
// [4, C] float32 out (mean, invstd, scale, bias); running_mean and
// running_var null leave the running statistics alone.
extern "C" int lm_bn_forward(const void* x, long long M, int C, int dtype,
                             const float* w, const float* b, float eps,
                             float momentum, float* running_mean,
                             float* running_var, float* part, int max_ctas,
                             float* stats, void* y, void* stream) {
  if (bad_shape(M, C, max_ctas)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return forward<__nv_bfloat16>(x, M, C, w, b, eps, momentum, running_mean,
                                  running_var, part, max_ctas, stats, y, s);
  if (dtype == 1)
    return forward<__half>(x, M, C, w, b, eps, momentum, running_mean,
                           running_var, part, max_ctas, stats, y, s);
  return (int)cudaErrorInvalidValue;
}

// stats: the forward's; coef: [3, C] float32 scratch; dw, db: [C] float32.
extern "C" int lm_bn_backward(const void* dy, const void* x, long long M,
                              int C, int dtype, const float* w,
                              const float* stats, float* part, int max_ctas,
                              float* coef, float* dw, float* db, void* dx,
                              void* stream) {
  if (bad_shape(M, C, max_ctas)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return backward<__nv_bfloat16>(dy, x, M, C, w, stats, part, max_ctas,
                                   coef, dw, db, dx, s);
  if (dtype == 1)
    return backward<__half>(dy, x, M, C, w, stats, part, max_ctas, coef, dw,
                            db, dx, s);
  return (int)cudaErrorInvalidValue;
}
