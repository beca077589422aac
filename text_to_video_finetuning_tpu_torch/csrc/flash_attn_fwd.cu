// Flash-attention forward for Hopper (sm_90a), bound through a plain C entry
// point and loaded with ctypes (ops/flash_attention.py builds it with nvcc).
//
// Replaces: text_to_video_finetuning_tpu/ops/flash_attention.py::_fwd_kernel
// (the Pallas TPU kernel K1).  It computes what K1 computes --
// o = softmax(q k^T * scale) v with an online softmax over KV tiles, fp32
// running max / sum / accumulator, o in the input dtype and the fp32
// logsumexp -- but is not a block-by-block copy of it: the TPU kernel carried
// its running state across a sequential grid axis in VMEM scratch and padded
// sequences to 128-multiples; here one CTA owns a (batch*head, 64-row Q tile)
// and loops over KV tiles itself, with ragged Sq / Sk bounds-checked in the
// loads and a -inf column mask, and q/k/v/o read and written in BSHD through
// their strides (no head transpose copy).
//
// What bounds it on the H100: at the serving shape (Sq = Sk = 1024, D = 64)
// attention does ~Sk/2 FLOPs per byte of q/k/v/o, far above the card's
// ~295 FLOP/byte bf16 ridge, so a good kernel is tensor-core bound.  The
// plain PyTorch version is instead bound by HBM traffic of the fp32
// (Sq x Sk) logits and probabilities (~0.67 GB each per call at B*H = 160).
// This kernel never writes S or P to device memory: the scores and
// probabilities of one 64x64 tile live in shared memory, the two products run
// on the tensor cores through WMMA (bf16/fp16 in, fp32 accumulate), and only
// q, k, v, o and the lse cross HBM.  It is deliberately simple: the softmax is
// scalar fp32 in shared memory, the O accumulator round-trips through shared
// memory every tile, and there is no TMA / wgmma / producer-consumer
// pipelining -- those are the next steps for speed.
//
// fp32 inputs take a scalar-FMA path (WMMA's tf32 would not meet the fp32
// error bound); head_dim up to 128 (padded to a multiple of 32 in shared
// memory, zero-filled).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int BM = 64;  // query rows per CTA: 4 warps x 16 rows
constexpr int BN = 64;  // key / value rows per shared-memory tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Sq) contiguous
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int B, H, Sq, Sk, D;
  int n_qtiles;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Shared-memory geometry for one instantiation.  16-bit tiles keep WMMA's
// ldm rule (a multiple of 8 elements) and 32-byte fragment alignment; the
// fp32 path pads rows by one element to spread banks.
template <typename T, int DP>
struct Geometry {
  static constexpr bool kWmma = !std::is_same<T, float>::value;
  static constexpr int kPad = kWmma ? 8 : 1;
  static constexpr int LDQ = DP + kPad;  // rows of sQ, sK, sV
  static constexpr int LDS = BN + 4;     // rows of sS (fp32 scores)
  static constexpr int LDP = BN + kPad;  // rows of sP (probabilities, T)
  static constexpr int LDO = DP + 4;     // rows of sO (fp32 accumulator)

  static constexpr size_t align(size_t bytes) { return (bytes + 127) / 128 * 128; }
  static constexpr size_t kQ = align(sizeof(T) * BM * LDQ);
  static constexpr size_t kKV = align(sizeof(T) * BN * LDQ);
  static constexpr size_t kS = align(sizeof(float) * BM * LDS);
  static constexpr size_t kP = align(sizeof(T) * BM * LDP);
  static constexpr size_t kO = align(sizeof(float) * BM * LDO);
  static constexpr size_t kBytes = kQ + 2 * kKV + kS + kP + kO;
};

// S[16 x BN] = Q[16 x DP] . K[BN x DP]^T for this warp's 16 query rows.
template <typename T, int DP>
__device__ __forceinline__ void warp_scores(const T* sQ, const T* sK,
                                            float* sS, int warp, int lane) {
  using G = Geometry<T, DP>;
  if constexpr (G::kWmma) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[DP / 16];
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wmma::load_matrix_sync(a[kk], sQ + warp * 16 * G::LDQ + kk * 16, G::LDQ);
#pragma unroll
    for (int n = 0; n < BN / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        // K^T as a col-major B operand: element (d, j) at sK[j * LDQ + d]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
        wmma::load_matrix_sync(b, sK + n * 16 * G::LDQ + kk * 16, G::LDQ);
        wmma::mma_sync(acc, a[kk], b, acc);
      }
      wmma::store_matrix_sync(sS + warp * 16 * G::LDS + n * 16, acc, G::LDS,
                              wmma::mem_row_major);
    }
  } else {
    for (int idx = lane; idx < 16 * BN; idx += 32) {
      const int r = warp * 16 + idx / BN;
      const int c = idx % BN;
      const T* qr = sQ + r * G::LDQ;
      const T* kr = sK + c * G::LDQ;
      float acc = 0.0f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) acc = fmaf(to_f(qr[d]), to_f(kr[d]), acc);
      sS[r * G::LDS + c] = acc;
    }
  }
}

// O[16 x DP] += P[16 x BN] . V[BN x DP] for this warp's 16 query rows.
template <typename T, int DP>
__device__ __forceinline__ void warp_pv(const T* sP, const T* sV, float* sO,
                                        int warp, int lane) {
  using G = Geometry<T, DP>;
  if constexpr (G::kWmma) {
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* o_tile = sO + warp * 16 * G::LDO + j * 16;
      wmma::load_matrix_sync(acc, o_tile, G::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
        wmma::load_matrix_sync(a, sP + warp * 16 * G::LDP + kk * 16, G::LDP);
        wmma::load_matrix_sync(b, sV + kk * 16 * G::LDQ + j * 16, G::LDQ);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(o_tile, acc, G::LDO, wmma::mem_row_major);
    }
  } else {
    for (int idx = lane; idx < 16 * DP; idx += 32) {
      const int r = warp * 16 + idx / DP;
      const int c = idx % DP;
      const T* pr = sP + r * G::LDP;
      float acc = sO[r * G::LDO + c];
#pragma unroll 8
      for (int j = 0; j < BN; ++j)
        acc = fmaf(to_f(pr[j]), to_f(sV[j * G::LDQ + c]), acc);
      sO[r * G::LDO + c] = acc;
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(Params p) {
  using G = Geometry<T, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = reinterpret_cast<T*>(smem + G::kQ);
  T* sV = reinterpret_cast<T*>(smem + G::kQ + G::kKV);
  float* sS = reinterpret_cast<float*>(smem + G::kQ + 2 * G::kKV);
  T* sP = reinterpret_cast<T*>(smem + G::kQ + 2 * G::kKV + G::kS);
  float* sO = reinterpret_cast<float*>(smem + G::kQ + 2 * G::kKV + G::kS + G::kP);

  const int qtile = blockIdx.x % p.n_qtiles;
  const int bh = blockIdx.x / p.n_qtiles;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = qtile * BM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T zero = from_f<T>(0.0f);

  for (int i = tid; i < BM * DP; i += NTHREADS) {
    const int r = i / DP, c = i % DP, s = q0 + r;
    sQ[r * G::LDQ + c] = (s < p.Sq && c < p.D) ? qg[s * p.q_ss + c] : zero;
    sO[r * G::LDO + c] = 0.0f;
  }

  // two lanes per query row; each owns half of the row's columns
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  float m_run = -INFINITY;
  float l_run = 0.0f;
  __syncthreads();

  for (int k0 = 0; k0 < p.Sk; k0 += BN) {
    for (int i = tid; i < BN * DP; i += NTHREADS) {
      const int r = i / DP, c = i % DP, s = k0 + r;
      const bool ok = s < p.Sk && c < p.D;
      sK[r * G::LDQ + c] = ok ? kg[s * p.k_ss + c] : zero;
      sV[r * G::LDQ + c] = ok ? vg[s * p.v_ss + c] : zero;
    }
    __syncthreads();

    warp_scores<T, DP>(sQ, sK, sS, warp, lane);
    __syncwarp();

    // online softmax over this tile (columns past Sk are -inf)
    float* srow = sS + row * G::LDS + half * (BN / 2);
    float mx = -INFINITY;
    for (int j = 0; j < BN / 2; ++j) {
      const int col = k0 + half * (BN / 2) + j;
      const float s = col < p.Sk ? srow[j] * p.scale : -INFINITY;
      srow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);  // finite: every tile has a column < Sk
    const float corr = expf(m_run - m_new);
    float sum = 0.0f;
    T* prow = sP + row * G::LDP + half * (BN / 2);
    for (int j = 0; j < BN / 2; ++j) {
      const float e = expf(srow[j] - m_new);
      sum += e;
      prow[j] = from_f<T>(e);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * corr + sum;
    m_run = m_new;
    float* orow = sO + row * G::LDO + half * (DP / 2);
    for (int j = 0; j < DP / 2; ++j) orow[j] *= corr;
    __syncwarp();

    warp_pv<T, DP>(sP, sV, sO, warp, lane);
    __syncthreads();  // sK / sV are reloaded by every warp next tile
  }

  const int s = q0 + row;
  if (s < p.Sq) {
    const float inv_l = 1.0f / l_run;
    const float* orow = sO + row * G::LDO;
    for (int j = 0; j < DP / 2; ++j) {
      const int c = half * (DP / 2) + j;
      if (c < p.D) og[s * p.o_ss + c] = from_f<T>(orow[c] * inv_l);
    }
    if (half == 0) p.lse[static_cast<long long>(bh) * p.Sq + s] = m_run + logf(l_run);
  }
}

template <typename T, int DP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = Geometry<T, DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long n_ctas = static_cast<long long>(p.n_qtiles) * p.B * p.H;
  if (n_ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd_kernel<T, DP><<<static_cast<unsigned>(n_ctas), NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 32>(p, stream);
  if (p.D <= 64) return launch<T, 64>(p, stream);
  if (p.D <= 96) return launch<T, 96>(p, stream);
  if (p.D <= 128) return launch<T, 128>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  Strides are in elements;
// the last (head_dim) stride of q, k, v and o must be 1.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int t2v_flash_attn_fwd(int dtype, const void* q, const void* k,
                                  const void* v, void* o, float* lse, int B,
                                  int H, int Sq, int Sk, int D,
                                  long long q_sb, long long q_ss, long long q_sh,
                                  long long k_sb, long long k_ss, long long k_sh,
                                  long long v_sb, long long v_ss, long long v_sh,
                                  long long o_sb, long long o_ss, long long o_sh,
                                  float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k,    v,    o,    lse,  q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
           v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, B,    H,    Sq,   Sk,   D,
           (Sq + BM - 1) / BM, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_dtype<float>(p, s); break;
    case 1: err = launch_dtype<__half>(p, s); break;
    case 2: err = launch_dtype<__nv_bfloat16>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* t2v_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
