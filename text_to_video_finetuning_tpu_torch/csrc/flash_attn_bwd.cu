// Flash-attention backward for Hopper (sm_90a): K2 (dK, dV) and K3 (dQ),
// bound through plain C entry points and loaded with ctypes
// (ops/flash_attention.py builds every csrc/*.cu with nvcc).
//
// Replaces: text_to_video_finetuning_tpu/ops/flash_attention.py
//   ::_bwd_dkv_kernel (K2) and ::_bwd_dq_kernel (K3), both launched by
//   _flash_bwd.  They compute what those compute -- P = exp(S * scale - lse)
//   recomputed from the forward's logsumexp, dS = P o (dO V^T - delta) *
//   scale with delta = rowsum(O o dO) computed outside (in PyTorch, as
//   _flash_bwd does), dV = P^T dO, dK = dS^T Q, dQ = dS K -- but not block by
//   block: the TPU kernels carried dk_acc / dv_acc / dq_acc across a
//   sequential grid axis in VMEM.  Here one CTA owns a tile and loops itself:
//   * K2: one CTA per (batch*head, 64-row KV tile) loops over the Q tiles;
//     each of its 4 warps keeps 16 rows of dK and dV in fp32 WMMA
//     accumulator fragments for the whole loop (the backward has no online
//     rescale, so nothing forces them through shared memory);
//   * K3: one CTA per (batch*head, 64-row Q tile) loops over the KV tiles and
//     keeps 16 rows of dQ per warp the same way.
// Two kernels and no atomics: every output element is written by one CTA,
// so the result is deterministic.
//
// Transposed products: K2 needs P^T dO and dS^T Q.  Rather than transposing
// a tile, it computes the transposed scores S^T = K Q^T and dP^T = V dO^T
// directly (Q and dO read as col-major WMMA B operands from their row-major
// shared tiles), so P^T and dS^T land row-major in shared memory as the A
// operand of the next product.  Nothing is transposed in device memory.
//
// Ragged edges: loads are bounds-checked with zero fill, and P (hence dS) is
// set to 0 explicitly for KV columns >= Sk and for Q rows >= Sq; those rows
// have no valid lse, so exp(S - lse) is never evaluated for them.
//
// Precision: bf16 / fp16 inputs feed P and dS to the tensor cores in the
// input dtype with fp32 accumulation (the TPU kernel ran its dK / dV products
// in fp32, and cast dS to the storage dtype for dQ).  fp32 inputs take a
// scalar-FMA path with P and dS kept in fp32 (TF32 would miss 1e-4).
//
// What bounds it on the H100: at the training shape (B*F = 16, H = 5,
// S = 1024, D = 64) each S x S x D product is 2*B*H*S^2*D = 10.7 GFLOP.  K2
// runs four of them (S^T, dP^T, dV, dK): 42.9 GFLOP, 43 us at 989 TFLOP/s
// dense bf16.  K3 runs three (S, dP, dQ): 32.2 GFLOP, 33 us.  Their bytes
// (q, k, v, dO, lse, delta in; dK and dV, or dQ, out: 64 MB for K2, 53 MB
// for K3) take 19 us and 16 us at 3.35 TB/s, so both are compute-bound.
// This first version is plain WMMA with scalar softmax arithmetic in shared
// memory and no TMA / wgmma / pipelining; those are the next steps for
// speed.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int TILE = 64;  // rows of the CTA's own tile and of each loop tile
constexpr int NWARPS = 4;  // 16 rows of the CTA's tile per warp
constexpr int NTHREADS = NWARPS * 32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, Sq) contiguous
  const float* delta;  // (B, H, Sq) contiguous
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int B, H, Sq, Sk, D;
  int n_tiles;  // tiles of the CTA-owned axis (Sk for K2, Sq for K3)
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

// Shared-memory geometry: four (TILE x DP) input tiles in T, one (TILE x
// TILE) tile of P or dS in T, two fp32 (TILE x max(TILE, DP)) score tiles
// (also the output staging area), and 2 x TILE fp32 of lse / delta.
template <typename T, int DP>
struct Geometry {
  static constexpr bool kWmma = !std::is_same<T, float>::value;
  static constexpr int kPad = kWmma ? 8 : 1;
  static constexpr int LDT = DP + kPad;                      // input tiles
  static constexpr int LDP = TILE + kPad;                    // sP
  static constexpr int LDS = (TILE > DP ? TILE : DP) + 4;    // fp32 tiles
  static constexpr int kAcc = 16 * DP / 32;  // scalar-path values per lane

  static constexpr size_t align(size_t bytes) { return (bytes + 127) / 128 * 128; }
  static constexpr size_t kT = align(sizeof(T) * TILE * LDT);
  static constexpr size_t kP = align(sizeof(T) * TILE * LDP);
  static constexpr size_t kS = align(sizeof(float) * TILE * LDS);
  static constexpr size_t kRow = align(sizeof(float) * TILE);
  static constexpr size_t kBytes = 4 * kT + kP + 2 * kS + 2 * kRow;
};

template <typename T, int DP>
struct Smem {
  T *a, *b, *c, *d;  // input tiles (role per kernel)
  T* p;              // P^T / dS^T (K2) or dS (K3)
  float* s;          // fp32 scores
  float* dp;         // fp32 dP (then dS in the scalar path)
  float* lse;
  float* delta;
  __device__ explicit Smem(unsigned char* base) {
    using G = Geometry<T, DP>;
    a = reinterpret_cast<T*>(base);
    b = reinterpret_cast<T*>(base + G::kT);
    c = reinterpret_cast<T*>(base + 2 * G::kT);
    d = reinterpret_cast<T*>(base + 3 * G::kT);
    p = reinterpret_cast<T*>(base + 4 * G::kT);
    s = reinterpret_cast<float*>(base + 4 * G::kT + G::kP);
    dp = reinterpret_cast<float*>(base + 4 * G::kT + G::kP + G::kS);
    lse = reinterpret_cast<float*>(base + 4 * G::kT + G::kP + 2 * G::kS);
    delta = lse + G::kRow / sizeof(float);
  }
};

// Load rows [s0, s0 + TILE) of one (batch, head) slice into a shared tile,
// zero-filling rows >= n and columns >= D.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row_stride, int s0, int n,
                                          int D, int tid) {
  using G = Geometry<T, DP>;
  const T zero = from_f<T>(0.0f);
  for (int i = tid; i < TILE * DP; i += NTHREADS) {
    const int r = i / DP, c = i % DP, s = s0 + r;
    dst[r * G::LDT + c] = (s < n && c < D) ? src[s * row_stride + c] : zero;
  }
}

// out[16 x TILE] (fp32, this warp's rows) = A[16 x DP] . B[TILE x DP]^T,
// A = rows warp*16.. of sA, B = all TILE rows of sB (both ld LDT).
template <typename T, int DP>
__device__ __forceinline__ void warp_abt(const T* sA, const T* sB, float* out,
                                         int warp, int lane) {
  using G = Geometry<T, DP>;
  if constexpr (G::kWmma) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[DP / 16];
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wmma::load_matrix_sync(a[kk], sA + warp * 16 * G::LDT + kk * 16, G::LDT);
#pragma unroll
    for (int n = 0; n < TILE / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        // B^T as a col-major operand: element (d, j) at sB[j * LDT + d]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
        wmma::load_matrix_sync(b, sB + n * 16 * G::LDT + kk * 16, G::LDT);
        wmma::mma_sync(acc, a[kk], b, acc);
      }
      wmma::store_matrix_sync(out + warp * 16 * G::LDS + n * 16, acc, G::LDS,
                              wmma::mem_row_major);
    }
  } else {
    for (int idx = lane; idx < 16 * TILE; idx += 32) {
      const int r = warp * 16 + idx / TILE;
      const int c = idx % TILE;
      const T* ar = sA + r * G::LDT;
      const T* br = sB + c * G::LDT;
      float acc = 0.0f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) acc = fmaf(to_f(ar[d]), to_f(br[d]), acc);
      out[r * G::LDS + c] = acc;
    }
  }
}

// Accumulators of one warp's 16 x DP output rows, kept across the loop.
template <typename T, int DP, bool kWmma = Geometry<T, DP>::kWmma>
struct Acc;

template <typename T, int DP>
struct Acc<T, DP, true> {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[DP / 16];
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) wmma::fill_fragment(f[j], 0.0f);
  }
  // f += sP[16 x TILE] (this warp's rows, ld LDP) . sB[TILE x DP] (ld LDT)
  __device__ void add_pb(const T* sP, const T* sB, int warp, int) {
    using G = Geometry<T, DP>;
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::load_matrix_sync(a, sP + warp * 16 * G::LDP + kk * 16, G::LDP);
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
        wmma::load_matrix_sync(b, sB + kk * 16 * G::LDT + j * 16, G::LDT);
        wmma::mma_sync(f[j], a, b, f[j]);
      }
    }
  }
  // write rows [s0 + warp*16, +16) to device memory through fp32 staging
  __device__ void store(T* dst, long long row_stride, int s0, int n, int D,
                        float* stage, int warp, int lane) {
    using G = Geometry<T, DP>;
#pragma unroll
    for (int j = 0; j < DP / 16; ++j)
      wmma::store_matrix_sync(stage + warp * 16 * G::LDS + j * 16, f[j],
                              G::LDS, wmma::mem_row_major);
    __syncwarp();
    for (int idx = lane; idx < 16 * DP; idx += 32) {
      const int r = warp * 16 + idx / DP, c = idx % DP, s = s0 + r;
      if (s < n && c < D) dst[s * row_stride + c] = from_f<T>(stage[r * G::LDS + c]);
    }
    __syncwarp();
  }
};

template <typename T, int DP>
struct Acc<T, DP, false> {
  float v[Geometry<T, DP>::kAcc];  // lane owns idx = lane + 32 * i
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < Geometry<T, DP>::kAcc; ++i) v[i] = 0.0f;
  }
  __device__ void add_pb(const T* sP, const T* sB, int warp, int lane) {
    using G = Geometry<T, DP>;
#pragma unroll
    for (int i = 0; i < G::kAcc; ++i) {
      const int idx = lane + 32 * i;
      const int r = warp * 16 + idx / DP, c = idx % DP;
      const T* pr = sP + r * G::LDP;
      float acc = v[i];
#pragma unroll 8
      for (int j = 0; j < TILE; ++j)
        acc = fmaf(to_f(pr[j]), to_f(sB[j * G::LDT + c]), acc);
      v[i] = acc;
    }
  }
  __device__ void store(T* dst, long long row_stride, int s0, int n, int D,
                        float*, int warp, int lane) {
#pragma unroll
    for (int i = 0; i < Geometry<T, DP>::kAcc; ++i) {
      const int idx = lane + 32 * i;
      const int r = warp * 16 + idx / DP, c = idx % DP, s = s0 + r;
      if (s < n && c < D) dst[s * row_stride + c] = from_f<T>(v[i]);
    }
  }
};

// K2: dK and dV for one 64-row KV tile of one (batch, head).
template <typename T, int DP>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(Params p) {
  using G = Geometry<T, DP>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<T, DP> sm(smem_raw);
  T* sK = sm.a;
  T* sV = sm.b;
  T* sQ = sm.c;
  T* sdO = sm.d;

  const int ktile = blockIdx.x % p.n_tiles;
  const int bh = blockIdx.x / p.n_tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = ktile * TILE;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.Sq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.Sq;

  load_tile<T, DP>(sK, kg, p.k_ss, k0, p.Sk, p.D, tid);
  load_tile<T, DP>(sV, vg, p.v_ss, k0, p.Sk, p.D, tid);

  Acc<T, DP> dk, dv;
  dk.zero();
  dv.zero();
  // two lanes per KV row of this warp; each owns half of the Q columns
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const bool kv_ok = k0 + row < p.Sk;

  for (int q0 = 0; q0 < p.Sq; q0 += TILE) {
    __syncthreads();  // every warp is done with the previous sQ / sdO
    load_tile<T, DP>(sQ, qg, p.q_ss, q0, p.Sq, p.D, tid);
    load_tile<T, DP>(sdO, dog, p.do_ss, q0, p.Sq, p.D, tid);
    for (int i = tid; i < TILE; i += NTHREADS) {
      const bool ok = q0 + i < p.Sq;
      sm.lse[i] = ok ? lse[q0 + i] : 0.0f;
      sm.delta[i] = ok ? delta[q0 + i] : 0.0f;
    }
    __syncthreads();

    warp_abt<T, DP>(sK, sQ, sm.s, warp, lane);    // S^T  = K . Q^T
    warp_abt<T, DP>(sV, sdO, sm.dp, warp, lane);  // dP^T = V . dO^T
    __syncwarp();
    float* srow = sm.s + row * G::LDS + half * (TILE / 2);
    float* dprow = sm.dp + row * G::LDS + half * (TILE / 2);
    T* prow = sm.p + row * G::LDP + half * (TILE / 2);
    for (int j = 0; j < TILE / 2; ++j) {
      const int col = half * (TILE / 2) + j;
      float pv = 0.0f, ds = 0.0f;
      if (kv_ok && q0 + col < p.Sq) {  // padded rows / columns stay 0
        pv = expf(srow[j] * p.scale - sm.lse[col]);
        ds = pv * (dprow[j] - sm.delta[col]) * p.scale;
      }
      prow[j] = from_f<T>(pv);
      dprow[j] = ds;
    }
    __syncwarp();
    dv.add_pb(sm.p, sdO, warp, lane);  // dV += P^T . dO
    __syncwarp();
    for (int j = 0; j < TILE / 2; ++j) prow[j] = from_f<T>(dprow[j]);
    __syncwarp();
    dk.add_pb(sm.p, sQ, warp, lane);  // dK += dS^T . Q
    __syncwarp();
  }

  T* dkg = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvg = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  dk.store(dkg, p.dk_ss, k0, p.Sk, p.D, sm.s, warp, lane);
  dv.store(dvg, p.dv_ss, k0, p.Sk, p.D, sm.s, warp, lane);
}

// K3: dQ for one 64-row Q tile of one (batch, head).
template <typename T, int DP>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(Params p) {
  using G = Geometry<T, DP>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<T, DP> sm(smem_raw);
  T* sQ = sm.a;
  T* sdO = sm.b;
  T* sK = sm.c;
  T* sV = sm.d;

  const int qtile = blockIdx.x % p.n_tiles;
  const int bh = blockIdx.x / p.n_tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qtile * TILE;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.Sq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.Sq;

  load_tile<T, DP>(sQ, qg, p.q_ss, q0, p.Sq, p.D, tid);
  load_tile<T, DP>(sdO, dog, p.do_ss, q0, p.Sq, p.D, tid);
  for (int i = tid; i < TILE; i += NTHREADS) {
    const bool ok = q0 + i < p.Sq;
    sm.lse[i] = ok ? lse[q0 + i] : 0.0f;
    sm.delta[i] = ok ? delta[q0 + i] : 0.0f;
  }

  Acc<T, DP> dq;
  dq.zero();
  // two lanes per Q row of this warp; each owns half of the KV columns
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const bool q_ok = q0 + row < p.Sq;

  for (int k0 = 0; k0 < p.Sk; k0 += TILE) {
    __syncthreads();  // every warp is done with the previous sK / sV
    load_tile<T, DP>(sK, kg, p.k_ss, k0, p.Sk, p.D, tid);
    load_tile<T, DP>(sV, vg, p.v_ss, k0, p.Sk, p.D, tid);
    __syncthreads();

    warp_abt<T, DP>(sQ, sK, sm.s, warp, lane);   // S  = Q . K^T
    warp_abt<T, DP>(sdO, sV, sm.dp, warp, lane); // dP = dO . V^T
    __syncwarp();
    const float* srow = sm.s + row * G::LDS + half * (TILE / 2);
    const float* dprow = sm.dp + row * G::LDS + half * (TILE / 2);
    T* prow = sm.p + row * G::LDP + half * (TILE / 2);
    const float row_lse = sm.lse[row], row_delta = sm.delta[row];
    for (int j = 0; j < TILE / 2; ++j) {
      const int col = half * (TILE / 2) + j;
      float ds = 0.0f;
      if (q_ok && k0 + col < p.Sk) {  // padded rows / columns stay 0
        const float pv = expf(srow[j] * p.scale - row_lse);
        ds = pv * (dprow[j] - row_delta) * p.scale;
      }
      prow[j] = from_f<T>(ds);  // dS in the storage dtype, as _bwd_dq_kernel
    }
    __syncwarp();
    dq.add_pb(sm.p, sK, warp, lane);  // dQ += dS . K
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  dq.store(dqg, p.dq_ss, q0, p.Sq, p.D, sm.s, warp, lane);
}

template <typename T, int DP, bool kDkv>
cudaError_t launch(Params p, cudaStream_t stream) {
  const size_t smem = Geometry<T, DP>::kBytes;
  auto kernel = kDkv ? flash_bwd_dkv_kernel<T, DP> : flash_bwd_dq_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  p.n_tiles = ((kDkv ? p.Sk : p.Sq) + TILE - 1) / TILE;
  const long long n_ctas = static_cast<long long>(p.n_tiles) * p.B * p.H;
  if (n_ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(n_ctas), NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool kDkv>
cudaError_t launch_dtype(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 32, kDkv>(p, stream);
  if (p.D <= 64) return launch<T, 64, kDkv>(p, stream);
  if (p.D <= 96) return launch<T, 96, kDkv>(p, stream);
  if (p.D <= 128) return launch<T, 128, kDkv>(p, stream);
  return cudaErrorInvalidValue;
}

template <bool kDkv>
int dispatch(int dtype, const Params& p, void* stream) {
  if (p.B <= 0 || p.H <= 0 || p.Sq <= 0 || p.Sk <= 0 || p.D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_dtype<float, kDkv>(p, s); break;
    case 1: err = launch_dtype<__half, kDkv>(p, s); break;
    case 2: err = launch_dtype<__nv_bfloat16, kDkv>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   int B, int H, int Sq, int Sk, int D, const long long* st,
                   float scale) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
  p.q_sb = st[0]; p.q_ss = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_ss = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_ss = st[7]; p.v_sh = st[8];
  p.do_sb = st[9]; p.do_ss = st[10]; p.do_sh = st[11];
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk; p.D = D; p.scale = scale;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  All tensors BSHD with
// head_dim stride 1; `in_strides` holds (batch, seq, head) strides in
// elements for q, k, v and dO (12 values), `out_strides` those of the
// outputs (dK then dV: 6 values; dQ: 3).  lse and delta are (B, H, Sq)
// contiguous fp32.  Each returns the CUDA error code of its launch.
extern "C" int t2v_flash_attn_bwd_dkv(int dtype, const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dk, void* dv, int B, int H, int Sq,
                                      int Sk, int D, const long long* in_strides,
                                      const long long* out_strides, float scale,
                                      void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, B, H, Sq, Sk, D,
                         in_strides, scale);
  p.dk = dk; p.dv = dv;
  p.dk_sb = out_strides[0]; p.dk_ss = out_strides[1]; p.dk_sh = out_strides[2];
  p.dv_sb = out_strides[3]; p.dv_ss = out_strides[4]; p.dv_sh = out_strides[5];
  return dispatch<true>(dtype, p, stream);
}

extern "C" int t2v_flash_attn_bwd_dq(int dtype, const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dq, int B, int H, int Sq, int Sk,
                                     int D, const long long* in_strides,
                                     const long long* out_strides, float scale,
                                     void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, B, H, Sq, Sk, D,
                         in_strides, scale);
  p.dq = dq;
  p.dq_sb = out_strides[0]; p.dq_ss = out_strides[1]; p.dq_sh = out_strides[2];
  return dispatch<false>(dtype, p, stream);
}

extern "C" const char* t2v_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
