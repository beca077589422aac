// Flash-attention dK / dV for Hopper (sm_90a) at head_dim 64, bf16 / fp16:
// K3's TMA ring and wgmma with the roles of the two axes swapped (the CTA
// owns KV rows and streams Q and dO), with P, dS and both accumulators in
// registers.  Bound through a plain C entry point and loaded with ctypes
// (ops/kernel_build.py builds every csrc/*.cu with nvcc).
//
// Replaces: text_to_video_finetuning_tpu/ops/flash_attention.py
// ::_bwd_dkv_kernel (the Pallas TPU kernel K2, `pallas_call` :243) on the
// `sm90` route of ops/flash_attention.py; fp32 and other head dims keep
// flash_attn_bwd.cu::flash_bwd_dkv_kernel (the `wmma` route).  It computes
// what K2 computes: P = exp(S * scale - lse) from the forward's logsumexp,
// dV = P^T.dO, dS = P o (dO.V^T - delta) * scale with delta = rowsum(O o dO)
// computed outside (in PyTorch, as _flash_bwd does), dK = dS^T.Q.  P and dS
// go to the tensor cores in the storage dtype; dK and dV are accumulated in
// fp32 and written once in k's / v's dtype.
//
// What bounds it on the H100: at the training shape (B*H = 80, S = 1024,
// D = 64) its four products (S, dP, dV, dK) are 42.9 GFLOP, 43 us at 989
// TFLOP/s, against 19 us for its 64 MB of inputs and outputs at 3.35 TB/s:
// the tensor cores bound it.  The first design (flash_attn_bwd.cu) loaded
// tiles synchronously and passed S and dP through fp32 shared memory, with a
// scalar softmax and WMMA fragments, at ~3.5 % of that bound.  Here
// (flash_sm90.cuh has the geometry):
// * one CTA per (batch*head, 128 KV rows), two consumer warpgroups of 64
//   rows and one producer warp; K and V are loaded once by TMA;
// * Q and dO stream through a two-stage ring of 64-row tiles, each stage
//   guarded by a full and an empty mbarrier.  The producer warp also stages
//   the tile's lse (times log2(e)) and delta in shared memory with plain
//   loads: their (B, H, Sq) rows are 16-byte aligned only when Sq % 4 == 0,
//   so neither TMA nor a bulk copy can read them;
// * the scores are computed transposed, so nothing is transposed in memory:
//   S^T = K.Q^T and dP^T = V.dO^T are shared-memory wgmma m64n64k16 chains
//   (K and V as A, Q and dO as B, all K-major), committed together.  A
//   thread's accumulator columns are then Q rows: it reads their lse and
//   delta from the stage;
// * P = exp2(S * scale * log2(e) - lse * log2(e)) and dS = P o (dP -
//   delta) * scale in registers, each packed in place into A fragments;
//   dV += P.dO and dK += dS.Q are register-sourced wgmma chains committed
//   together, with dO and Q read MN-major from the stage tiles.  (Issuing
//   dV before computing dS, to overlap the two, made ptxas spill and
//   serialize every wgmma of the kernel for want of registers; this order
//   does neither.)
// * dK and dV stay in fp32 registers over the whole Q loop and are written
//   once.
// No atomics: one CTA writes each dK / dV row, so the result is
// deterministic.  Ragged edges: Q / dO rows >= Sq are zero-filled by TMA and
// get lse = +inf, so their P and dS are 0.  K / V rows >= Sk are
// zero-filled; their P = exp(-lse) is not 0, but a row of dK / dV depends
// only on its own row of P^T and dS^T, and rows >= Sk are never written.

#include "flash_sm90.cuh"

namespace {

using namespace t2v_sm90;

constexpr int kBlockN = 64;  // Q rows per ring stage
constexpr int kStages = 2;
constexpr int kKvBytes = kBlockM * kRowBytes;  // 16 KB each for K and V
constexpr int kQBytes = kBlockN * kRowBytes;   // 8 KB each for Q and dO
constexpr int kProducerThreads = kThreads - kConsumerThreads;

struct Smem {
  uint8_t k[kKvBytes];
  uint8_t v[kKvBytes];
  uint8_t q[kStages][kQBytes];
  uint8_t dout[kStages][kQBytes];
  float lse[kStages][kBlockN];    // lse * log2(e); +inf for rows >= Sq
  float delta[kStages][kBlockN];  // 0 for rows >= Sq
  uint64_t kv_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + alignment slack

struct Params {
  CUtensorMap q, k, v, dout;
  const float* lse;    // (B, H, Sq) contiguous
  const float* delta;  // (B, H, Sq) contiguous
  void* dk;
  void* dv;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int H, Sq, Sk, n_ktiles;
  float scale, scale_log2;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_sm90_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align1024(smem_raw));

  const int ktile = blockIdx.x % p.n_ktiles;
  const int bh = blockIdx.x / p.n_ktiles;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = ktile * kBlockM;
  const int n_q = (p.Sq + kBlockN - 1) / kBlockN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread's arrival with the byte count, then one from every
      // producer thread once its lse / delta values are in place
      mbar_init(&sm.full[s], 1 + kProducerThreads);
      mbar_init(&sm.empty[s], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {  // the producer warp; lane 0 issues TMA
    const int lane = tid - kConsumerThreads;
    const float* lse = p.lse + static_cast<long long>(bh) * p.Sq;
    const float* delta = p.delta + static_cast<long long>(bh) * p.Sq;
    if (lane == 0) {
      mbar_expect_tx(&sm.kv_full, 2 * kKvBytes);
      tma_load_rows(sm.k, &p.k, &sm.kv_full, h, k0, b);
      tma_load_rows(sm.v, &p.v, &sm.kv_full, h, k0, b);
    }
    for (int t = 0; t < n_q; ++t) {
      const int s = t % kStages;
      // the stage's previous tile (t - kStages) must be released first
      if (t >= kStages) mbar_wait(&sm.empty[s], ((t / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&sm.full[s], 2 * kQBytes);
        tma_load_rows(sm.q[s], &p.q, &sm.full[s], h, t * kBlockN, b);
        tma_load_rows(sm.dout[s], &p.dout, &sm.full[s], h, t * kBlockN, b);
      }
      for (int i = lane; i < kBlockN; i += kProducerThreads) {
        const int row = t * kBlockN + i;
        sm.lse[s][i] = row < p.Sq ? lse[row] * kLog2e : INFINITY;
        sm.delta[s][i] = row < p.Sq ? delta[row] : 0.0f;
      }
      mbar_arrive(&sm.full[s]);
    }
    return;
  }

  // consumers: warpgroup wg owns KV rows k0 + 64 wg .. + 63; this thread
  // holds rows r and r + 8 of them and, in each 8-column slice i of a tile,
  // the Q rows 8i + cq and 8i + cq + 1
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const float sl2 = p.scale_log2;

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.0f;
  const uint64_t desc_k = kmajor_desc(sm.k + wg * kWgRows * kRowBytes);
  const uint64_t desc_v = kmajor_desc(sm.v + wg * kWgRows * kRowBytes);

  mbar_wait(&sm.kv_full, 0);
  for (int t = 0; t < n_q; ++t) {
    const int s = t % kStages;
    mbar_wait(&sm.full[s], (t / kStages) & 1);

    // S^T = K . Q^T and dP^T = V . dO^T (64 KV x 64 Q rows per warpgroup)
    float sc[32], dp[32];
    const uint64_t desc_q = kmajor_desc(sm.q[s]);
    const uint64_t desc_do = kmajor_desc(sm.dout[s]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk)
      wgmma_ss_n64<T>(sc, desc_k + kk * kDescKStep, desc_q + kk * kDescKStep,
                      kk > 0);
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk)
      wgmma_ss_n64<T>(dp, desc_v + kk * kDescKStep, desc_do + kk * kDescKStep,
                      kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // P over S^T in place; column 8i + cq + (j & 1) is a Q row of the tile
    const float* lse = sm.lse[s];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 l = *reinterpret_cast<const float2*>(lse + 8 * i + cq);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sc[4 * i + j] = exp2f(fmaf(sc[4 * i + j], sl2, (j & 1) ? -l.y : -l.x));
    }

    // P into A fragments, then dS = P o (dP - delta) * scale over dP^T
    uint32_t pa[4][4];
    to_a_fragments<T, 32>(sc, pa);
    const float* delta = sm.delta[s];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * i + cq);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dp[4 * i + j] = sc[4 * i + j] *
                        (dp[4 * i + j] - ((j & 1) ? dl.y : dl.x)) * p.scale;
    }
    // dV += P . dO and dK += dS . Q with P and dS in registers in the
    // storage dtype (dO and Q MN-major)
    uint32_t da[4][4];
    to_a_fragments<T, 32>(dp, da);
    const uint64_t desc_dot = mnmajor_desc(sm.dout[s]);
    const uint64_t desc_qt = mnmajor_desc(sm.q[s]);
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
      wgmma_rs_n64_t<T>(dv, pa[kk], desc_dot + kk * kDescRowStep, 1);
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
      wgmma_rs_n64_t<T>(dk, da[kk], desc_qt + kk * kDescRowStep, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    mbar_arrive(&sm.empty[s]);  // this thread is done with the stage
  }

  const int row0 = k0 + wg * kWgRows + r;
  T* dkg = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvg = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_rows<T>(dkg, p.dk_ss, row0, p.Sk, cq, dk, 1.0f, 1.0f);
  store_rows<T>(dvg, p.dv_ss, row0, p.Sk, cq, dv, 1.0f, 1.0f);
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_sm90_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const long long n_ctas = static_cast<long long>(p.n_ktiles) * B * p.H;
  if (n_ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_dkv_sm90_kernel<T>
      <<<static_cast<unsigned>(n_ctas), kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 1 = float16, 2 = bfloat16; D must be 64.  `in_strides` holds the
// (batch, seq, head) strides in elements of q, k, v and dO (12 values, each a
// multiple of 8), `out_strides` those of dK then dV (6); lse and delta are
// (B, H, Sq) contiguous fp32; base addresses 16-byte aligned.  Returns 0, a
// CUDA error code, or a negative code of flash_sm90.cuh.
extern "C" int t2v_flash_attn_dkv_sm90(int dtype, const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       void* dk, void* dv, int B, int H,
                                       int Sq, int Sk, int D,
                                       const long long* in_strides,
                                       const long long* out_strides,
                                       float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D != kHeadDim ||
      (dtype != 1 && dtype != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* st = in_strides;
  Params p{};
  int err = make_bshd_map(&p.q, dtype, q, B, Sq, H, st[0], st[1], st[2],
                          kBlockN);
  if (err == 0)
    err = make_bshd_map(&p.k, dtype, k, B, Sk, H, st[3], st[4], st[5],
                        kBlockM);
  if (err == 0)
    err = make_bshd_map(&p.v, dtype, v, B, Sk, H, st[6], st[7], st[8],
                        kBlockM);
  if (err == 0)
    err = make_bshd_map(&p.dout, dtype, dout, B, Sq, H, st[9], st[10],
                        st[11], kBlockN);
  if (err != 0) return err;
  p.lse = lse;
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  p.dk_sb = out_strides[0];
  p.dk_ss = out_strides[1];
  p.dk_sh = out_strides[2];
  p.dv_sb = out_strides[3];
  p.dv_ss = out_strides[4];
  p.dv_sh = out_strides[5];
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.n_ktiles = (Sk + kBlockM - 1) / kBlockM;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 2 ? launch<__nv_bfloat16>(p, B, s)
                                     : launch<__half>(p, B, s));
}

extern "C" const char* t2v_flash_dkv_sm90_error_string(int err) {
  return error_string(err);
}
