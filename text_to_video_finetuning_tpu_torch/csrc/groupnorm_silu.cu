// Fused GroupNorm(+SiLU), forward and backward, for Hopper (sm_90a), bound
// through plain C entry points and loaded with ctypes (ops/groupnorm.py;
// ops/kernel_build.py builds it with nvcc).
//
// Replaces: text_to_video_finetuning_tpu/ops/groupnorm.py::_fwd_kernel (K4)
// and ::_bwd_kernel (K5), the Pallas TPU kernels.  They compute what K4 and
// K5 compute, in the port's NCHW layout, where one (sample, group) is one
// contiguous slab of C/G * H*W elements:
//
//   K4: y = silu((x - mean) * rstd * gamma + beta) (SiLU optional) in x's
//       dtype, plus mean and rstd as (N, G) fp32;
//   K5: dx = rstd * (dxh - mean_g(dxh) - xh * mean_g(dxh * xh)), with
//       xh = (x - mean) * rstd, dz = dy * silu'(xh * gamma + beta) and
//       dxh = dz * gamma; optionally the per-(n, c) partials of dgamma
//       (sum dz * xh) and dbeta (sum dz), summed over N by the caller.
//
// They are not block-by-block copies.  The TPU kernels held a whole sample
// (H, W, C) in VMEM, reduced channel sums through a (C, G) 0/1 matmul
// because Mosaic cannot reshape the lane axis, and took E[x^2] - mean^2 as
// the variance; a VMEM budget capped them at H*W*C <= 512K elements per
// sample.  Here one CTA owns one (n, g) slab and loops over it, so every
// size the UNet produces runs on the kernel (the 256 px up-block concats and
// the 576x320 level-0 norms included).  The statistics are Chan/Welford
// merges: each thread folds 16-byte chunks (their own two-pass mean and M2)
// into its running (count, mean, M2), and the CTA merges the threads' in a
// fixed tree.  That does not cancel on slabs of 30-90K elements the way
// E[x^2] - mean^2 does, and it is deterministic.  dgamma/dbeta partials go
// to an (N, C) fp32 scratch with one writer per element: no atomics.
//
// What bounds them on the H100: bytes.  K4 does ~10 flops per element and
// must read x and write y (4 bytes per bf16 element); K5 ~20 flops and must
// read x and dy and write dx (6 bytes): far below the ~295 flop/byte ridge.
// So the design moves each element as few times as the algorithm allows and
// in 16-byte accesses: K4 reads x twice (statistics, then the normalised
// write) and K5 reads x and dy twice (the two group sums, then dx); the
// second read of a slab (<= ~180 KB in bf16) mostly hits the 50 MB L2, as
// the card runs at most a few hundred slabs at once.  The per-channel
// dgamma/dbeta loop (a third read) runs only when the caller asks for them;
// the frozen-base training step does not.  It is deliberately simple: one
// CTA per slab, no cluster split of large slabs, no persistent CTAs.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC consecutive elements, loaded and stored as one access (16 bytes when
// VEC * sizeof(T) == 16)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

struct Stats {
  float n, mean, m2;
};

__device__ __forceinline__ Stats merge(Stats a, Stats b) {
  const float n = a.n + b.n;
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float d = b.mean - a.mean;
  const float fb = b.n / n;
  return {n, a.mean + d * fb, a.m2 + b.m2 + d * d * a.n * fb};
}

// Chan merge of every thread's Stats, in a fixed order; every thread gets
// the result
__device__ Stats block_stats(Stats s) {
  __shared__ Stats warp_stats[NWARPS];
  for (int off = 16; off > 0; off >>= 1) {
    Stats o{__shfl_down_sync(0xffffffffu, s.n, off),
            __shfl_down_sync(0xffffffffu, s.mean, off),
            __shfl_down_sync(0xffffffffu, s.m2, off)};
    s = merge(s, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_stats[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < NWARPS ? warp_stats[lane] : Stats{0.f, 0.f, 0.f};
    for (int off = 16; off > 0; off >>= 1) {
      Stats o{__shfl_down_sync(0xffffffffu, s.n, off),
              __shfl_down_sync(0xffffffffu, s.mean, off),
              __shfl_down_sync(0xffffffffu, s.m2, off)};
      s = merge(s, o);
    }
    if (lane == 0) warp_stats[0] = s;
  }
  __syncthreads();
  s = warp_stats[0];
  __syncthreads();  // the next call may overwrite warp_stats
  return s;
}

// sums of a and b over the CTA, in a fixed order; every thread gets them
__device__ void block_sum2(float& a, float& b) {
  __shared__ float warp_sums[NWARPS][2];
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    warp_sums[warp][0] = a;
    warp_sums[warp][1] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < NWARPS ? warp_sums[lane][0] : 0.f;
    b = lane < NWARPS ? warp_sums[lane][1] : 0.f;
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      b += __shfl_down_sync(0xffffffffu, b, off);
    }
    if (lane == 0) {
      warp_sums[0][0] = a;
      warp_sums[0][1] = b;
    }
  }
  __syncthreads();
  a = warp_sums[0][0];
  b = warp_sums[0][1];
  __syncthreads();
}

__device__ __forceinline__ float sigmoid(float z) { return 1.f / (1.f + expf(-z)); }

struct FwdParams {
  const void* x;
  const void* gamma;
  const void* beta;
  void* y;
  float* mean;  // (N, G)
  float* rstd;  // (N, G)
  int G, cg, hw;
  float eps;
  int silu;
};

template <typename T, typename P, int VEC>
__global__ void __launch_bounds__(NTHREADS) gn_silu_fwd_kernel(FwdParams p) {
  const long long ng = blockIdx.x;  // n * G + g
  const int g = static_cast<int>(ng % p.G);
  const int slab = p.cg * p.hw;
  const int nvec = slab / VEC;
  const Pack<T, VEC>* x =
      reinterpret_cast<const Pack<T, VEC>*>(static_cast<const T*>(p.x) + ng * slab);
  Pack<T, VEC>* y = reinterpret_cast<Pack<T, VEC>*>(static_cast<T*>(p.y) + ng * slab);
  const P* gamma = static_cast<const P*>(p.gamma);
  const P* beta = static_cast<const P*>(p.beta);

  Stats st{0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < nvec; i += NTHREADS) {
    const Pack<T, VEC> pk = x[i];
    float v[VEC], sum = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      v[j] = to_f(pk.v[j]);
      sum += v[j];
    }
    const float cm = sum / VEC;
    float cm2 = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) cm2 += (v[j] - cm) * (v[j] - cm);
    st = merge(st, Stats{static_cast<float>(VEC), cm, cm2});
  }
  st = block_stats(st);
  const float mean = st.mean;
  const float rstd = 1.f / sqrtf(fmaxf(st.m2 / static_cast<float>(slab), 0.f) + p.eps);

  for (int i = threadIdx.x; i < nvec; i += NTHREADS) {
    const int c = g * p.cg + (i * VEC) / p.hw;  // VEC divides hw
    const float a = to_f(gamma[c]) * rstd, b = to_f(beta[c]);
    const Pack<T, VEC> pk = x[i];
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float z = (to_f(pk.v[j]) - mean) * a + b;
      if (p.silu) z = z * sigmoid(z);
      out.v[j] = from_f<T>(z);
    }
    y[i] = out;
  }
  if (threadIdx.x == 0) {
    p.mean[ng] = mean;
    p.rstd[ng] = rstd;
  }
}

struct BwdParams {
  const void* x;
  const void* gamma;
  const void* beta;
  const float* mean;
  const float* rstd;
  const void* dy;
  void* dx;
  float* dgamma;  // (N, C) partials, or null
  float* dbeta;   // (N, C) partials, or null
  int G, cg, hw;
  int silu;
};

// dz (the gradient at the GroupNorm's affine output) and xh at one element
__device__ __forceinline__ void grad_at(float xv, float dyv, float mean, float rstd,
                                        float gam, float bet, int silu, float& xh,
                                        float& dz) {
  xh = (xv - mean) * rstd;
  dz = dyv;
  if (silu) {
    const float z = xh * gam + bet;
    const float s = sigmoid(z);
    dz = dyv * s * (1.f + z * (1.f - s));
  }
}

template <typename T, typename P, int VEC>
__global__ void __launch_bounds__(NTHREADS) gn_silu_bwd_kernel(BwdParams p) {
  const long long ng = blockIdx.x;
  const int g = static_cast<int>(ng % p.G);
  const int slab = p.cg * p.hw;
  const int nvec = slab / VEC;
  const T* xs = static_cast<const T*>(p.x) + ng * slab;
  const T* dys = static_cast<const T*>(p.dy) + ng * slab;
  const Pack<T, VEC>* x = reinterpret_cast<const Pack<T, VEC>*>(xs);
  const Pack<T, VEC>* dy = reinterpret_cast<const Pack<T, VEC>*>(dys);
  Pack<T, VEC>* dx = reinterpret_cast<Pack<T, VEC>*>(static_cast<T*>(p.dx) + ng * slab);
  const P* gamma = static_cast<const P*>(p.gamma);
  const P* beta = static_cast<const P*>(p.beta);
  const float mean = p.mean[ng], rstd = p.rstd[ng];

  float s_d = 0.f, s_dx = 0.f;
  for (int i = threadIdx.x; i < nvec; i += NTHREADS) {
    const int c = g * p.cg + (i * VEC) / p.hw;
    const float gam = to_f(gamma[c]), bet = to_f(beta[c]);
    const Pack<T, VEC> px = x[i], pd = dy[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float xh, dz;
      grad_at(to_f(px.v[j]), to_f(pd.v[j]), mean, rstd, gam, bet, p.silu, xh, dz);
      const float dxh = dz * gam;
      s_d += dxh;
      s_dx += dxh * xh;
    }
  }
  block_sum2(s_d, s_dx);
  const float m1 = s_d / static_cast<float>(slab);
  const float m2 = s_dx / static_cast<float>(slab);

  for (int i = threadIdx.x; i < nvec; i += NTHREADS) {
    const int c = g * p.cg + (i * VEC) / p.hw;
    const float gam = to_f(gamma[c]), bet = to_f(beta[c]);
    const Pack<T, VEC> px = x[i], pd = dy[i];
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float xh, dz;
      grad_at(to_f(px.v[j]), to_f(pd.v[j]), mean, rstd, gam, bet, p.silu, xh, dz);
      out.v[j] = from_f<T>(rstd * (dz * gam - m1 - xh * m2));
    }
    dx[i] = out;
  }

  if (p.dgamma == nullptr) return;
  // per-channel partials, one channel at a time, one writer per element
  for (int cl = 0; cl < p.cg; ++cl) {
    const int c = g * p.cg + cl;
    const float gam = to_f(gamma[c]), bet = to_f(beta[c]);
    float a = 0.f, b = 0.f;
    for (int k = threadIdx.x; k < p.hw; k += NTHREADS) {
      float xh, dz;
      const int e = cl * p.hw + k;
      grad_at(to_f(xs[e]), to_f(dys[e]), mean, rstd, gam, bet, p.silu, xh, dz);
      a += dz * xh;
      b += dz;
    }
    block_sum2(a, b);
    if (threadIdx.x == 0) {
      p.dgamma[ng * p.cg + cl] = a;  // n * C + g * cg + cl
      p.dbeta[ng * p.cg + cl] = b;
    }
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

template <typename T, typename P>
cudaError_t launch_fwd(const FwdParams& p, long long n_ctas, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (p.hw % VEC == 0 && aligned16(p.x) && aligned16(p.y))
    gn_silu_fwd_kernel<T, P, VEC><<<static_cast<unsigned>(n_ctas), NTHREADS, 0, s>>>(p);
  else
    gn_silu_fwd_kernel<T, P, 1><<<static_cast<unsigned>(n_ctas), NTHREADS, 0, s>>>(p);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t launch_bwd(const BwdParams& p, long long n_ctas, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (p.hw % VEC == 0 && aligned16(p.x) && aligned16(p.dy) && aligned16(p.dx))
    gn_silu_bwd_kernel<T, P, VEC><<<static_cast<unsigned>(n_ctas), NTHREADS, 0, s>>>(p);
  else
    gn_silu_bwd_kernel<T, P, 1><<<static_cast<unsigned>(n_ctas), NTHREADS, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = float16, 2 = bfloat16; the parameters'
// dtype is float32 or x's own
#define T2V_GN_DISPATCH(LAUNCH, params)                                             \
  do {                                                                               \
    if (param_dtype != 0 && param_dtype != dtype) return cudaErrorInvalidValue;      \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                              \
    cudaError_t err;                                                                 \
    switch (dtype * 3 + (param_dtype == 0 ? 0 : 1)) {                                \
      case 0: err = LAUNCH<float, float>(params, n_ctas, s); break;                  \
      case 3: err = LAUNCH<__half, float>(params, n_ctas, s); break;                 \
      case 4: err = LAUNCH<__half, __half>(params, n_ctas, s); break;                \
      case 6: err = LAUNCH<__nv_bfloat16, float>(params, n_ctas, s); break;          \
      case 7: err = LAUNCH<__nv_bfloat16, __nv_bfloat16>(params, n_ctas, s); break;  \
      default: err = cudaErrorInvalidValue;                                          \
    }                                                                                \
    return static_cast<int>(err);                                                    \
  } while (0)

// x, y: (N, C, HW) contiguous in dtype; gamma, beta: (C,) in param_dtype;
// mean, rstd: (N, G) fp32 out.  C % G == 0 and C / G * HW < 2^31 are the
// caller's to check.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int t2v_group_norm_silu_fwd(int dtype, int param_dtype, const void* x,
                                       const void* gamma, const void* beta, void* y,
                                       float* mean, float* rstd, int N, int C, int G,
                                       int HW, float eps, int silu, void* stream) {
  if (N <= 0 || C <= 0 || G <= 0 || HW <= 0 || C % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_ctas = static_cast<long long>(N) * G;
  if (n_ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  FwdParams p{x, gamma, beta, y, mean, rstd, G, C / G, HW, eps, silu};
  T2V_GN_DISPATCH(launch_fwd, p);
}

// dy, dx like x; dgamma / dbeta: (N, C) fp32 partials, or both null to skip
// them.
extern "C" int t2v_group_norm_silu_bwd(int dtype, int param_dtype, const void* x,
                                       const void* gamma, const void* beta,
                                       const float* mean, const float* rstd,
                                       const void* dy, void* dx, float* dgamma,
                                       float* dbeta, int N, int C, int G, int HW,
                                       int silu, void* stream) {
  if (N <= 0 || C <= 0 || G <= 0 || HW <= 0 || C % G != 0 ||
      (dgamma == nullptr) != (dbeta == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_ctas = static_cast<long long>(N) * G;
  if (n_ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  BwdParams p{x, gamma, beta, mean, rstd, dy, dx, dgamma, dbeta, G, C / G, HW, silu};
  T2V_GN_DISPATCH(launch_bwd, p);
}

extern "C" const char* t2v_group_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
