// Flash-attention dQ for Hopper (sm_90a) at head_dim 64, bf16 / fp16:
// K1's TMA-fed K/V ring and wgmma, with P, dS and the dQ accumulator in
// registers.  Bound through a plain C entry point and loaded with ctypes
// (ops/kernel_build.py builds every csrc/*.cu with nvcc).
//
// Replaces: text_to_video_finetuning_tpu/ops/flash_attention.py
// ::_bwd_dq_kernel (the Pallas TPU kernel K3, `pallas_call` :281) on the
// `sm90` route of ops/flash_attention.py; fp32 and other head dims keep
// flash_attn_bwd.cu::flash_bwd_dq_kernel (the `wmma` route), and K2 (dK,
// dV) stays there.  It computes what K3 computes: P = exp(S * scale - lse)
// from the forward's logsumexp, dS = P o (dO.V^T - delta) * scale with
// delta = rowsum(O o dO) computed outside (in PyTorch, as _flash_bwd does),
// dS cast to the storage dtype, dQ = dS.K accumulated in fp32 and written
// once in q's dtype.
//
// What bounds it on the H100: at the training shape (B*H = 80, S = 1024,
// D = 64) its three products (S, dP, dQ) are 32.2 GFLOP, 33 us at 989
// TFLOP/s, against 16 us for its 53 MB of inputs and output at 3.35 TB/s:
// the tensor cores bound it.  The first design loaded tiles synchronously
// and passed S and dP through fp32 shared memory with a scalar dS.  Here
// (flash_sm90.cuh has the geometry):
// * one CTA per (batch*head, 128 query rows), two consumer warpgroups of 64
//   rows and one producer warp; Q and dO are loaded once by TMA, the lse
//   and delta of the thread's two rows go into registers;
// * K and V stream through a two-stage ring of 64-row tiles (64 rows keep
//   S, dP and the dQ accumulator in registers without spilling);
// * S = Q.K^T and dP = dO.V^T are shared-memory wgmma m64n64k16 chains
//   (K and V K-major), committed together;
// * P = exp2(S * scale * log2(e) - lse * log2(e)) and dS in registers; dS is
//   packed in place into A fragments and dQ += dS.K is a register-sourced
//   wgmma with K read MN-major from the same swizzled tile.
// No atomics: one CTA writes each dQ row, so the result is deterministic.
// Ragged edges: K/V rows >= Sk are zero-filled by TMA and their P is set to
// 0; query rows >= Sq get P = 0 (lse = +inf) and are never written.

#include "flash_sm90.cuh"

namespace {

using namespace t2v_sm90;

constexpr int kBlockN = 64;  // KV rows per ring stage
constexpr int kStages = 2;
constexpr int kQBytes = kBlockM * kRowBytes;   // 16 KB each for Q and dO
constexpr int kKvBytes = kBlockN * kRowBytes;  // 8 KB each for K and V

struct Smem {
  uint8_t q[kQBytes];
  uint8_t dout[kQBytes];
  uint8_t k[kStages][kKvBytes];
  uint8_t v[kStages][kKvBytes];
  uint64_t q_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + alignment slack

struct Params {
  CUtensorMap q, k, v, dout;
  const float* lse;    // (B, H, Sq) contiguous
  const float* delta;  // (B, H, Sq) contiguous
  void* dq;
  long long dq_sb, dq_ss, dq_sh;
  int H, Sq, Sk, n_qtiles;
  float scale, scale_log2;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_sm90_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align1024(smem_raw));

  const int qtile = blockIdx.x % p.n_qtiles;
  const int bh = blockIdx.x / p.n_qtiles;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qtile * kBlockM;
  const int n_kv = (p.Sk + kBlockN - 1) / kBlockN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {  // the producer warp: one thread issues TMA
    if (tid == kConsumerThreads) {
      mbar_expect_tx(&sm.q_full, 2 * kQBytes);
      tma_load_rows(sm.q, &p.q, &sm.q_full, h, q0, b);
      tma_load_rows(sm.dout, &p.dout, &sm.q_full, h, q0, b);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&sm.empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kKvBytes);
        tma_load_rows(sm.k[s], &p.k, &sm.full[s], h, t * kBlockN, b);
        tma_load_rows(sm.v[s], &p.v, &sm.full[s], h, t * kBlockN, b);
      }
    }
    return;
  }

  // consumers: as in K1, rows r and r + 8 of the warpgroup's 64, columns
  // 8i + cq and 8i + cq + 1 of each 8-column slice
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int row0 = q0 + wg * kWgRows + r;
  const float sl2 = p.scale_log2;
  const float* lse = p.lse + static_cast<long long>(bh) * p.Sq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.Sq;
  // lse * log2(e) and delta of the two rows; rows >= Sq get P = 0
  const float lse0 = row0 < p.Sq ? lse[row0] * kLog2e : INFINITY;
  const float lse1 = row0 + 8 < p.Sq ? lse[row0 + 8] * kLog2e : INFINITY;
  const float dl0 = row0 < p.Sq ? delta[row0] : 0.0f;
  const float dl1 = row0 + 8 < p.Sq ? delta[row0 + 8] : 0.0f;

  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.0f;
  const uint64_t desc_q = kmajor_desc(sm.q + wg * kWgRows * kRowBytes);
  const uint64_t desc_do = kmajor_desc(sm.dout + wg * kWgRows * kRowBytes);

  mbar_wait(&sm.q_full, 0);
  for (int t = 0; t < n_kv; ++t) {
    const int s = t % kStages;
    mbar_wait(&sm.full[s], (t / kStages) & 1);

    // S = Q . K^T and dP = dO . V^T (64 x 64 per warpgroup each)
    float sc[32], dp[32];
    const uint64_t desc_k = kmajor_desc(sm.k[s]);
    const uint64_t desc_kt = mnmajor_desc(sm.k[s]);
    const uint64_t desc_v = kmajor_desc(sm.v[s]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk)
      wgmma_ss_n64<T>(sc, desc_q + kk * kDescKStep, desc_k + kk * kDescKStep,
                      kk > 0);
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk)
      wgmma_ss_n64<T>(dp, desc_do + kk * kDescKStep, desc_v + kk * kDescKStep,
                      kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // dS = P o (dP - delta) * scale, written over S; columns >= Sk get P = 0
    const int col0 = t * kBlockN;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float row_lse = j < 2 ? lse0 : lse1;
        const float row_delta = j < 2 ? dl0 : dl1;
        const bool valid = col0 + 8 * i + cq + (j & 1) < p.Sk;
        const float pv =
            valid ? exp2f(fmaf(sc[4 * i + j], sl2, -row_lse)) : 0.0f;
        sc[4 * i + j] = pv * (dp[4 * i + j] - row_delta) * p.scale;
      }

    // dQ += dS . K with dS in registers in the storage dtype (K MN-major)
    uint32_t da[4][4];
    to_a_fragments<T, 32>(sc, da);
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
      wgmma_rs_n64_t<T>(dq, da[kk], desc_kt + kk * kDescRowStep, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
    fence_regs(da);
    mbar_arrive(&sm.empty[s]);  // this thread is done with the stage
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_rows<T>(dqg, p.dq_ss, row0, p.Sq, cq, dq, 1.0f, 1.0f);
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_sm90_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const long long n_ctas = static_cast<long long>(p.n_qtiles) * B * p.H;
  if (n_ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_dq_sm90_kernel<T>
      <<<static_cast<unsigned>(n_ctas), kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 1 = float16, 2 = bfloat16; D must be 64.  `in_strides` holds the
// (batch, seq, head) strides in elements of q, k, v and dO (12 values, each a
// multiple of 8), `out_strides` those of dQ (3); lse and delta are (B, H,
// Sq) contiguous fp32; base addresses 16-byte aligned.  Returns 0, a CUDA
// error code, or a negative code of flash_sm90.cuh.
extern "C" int t2v_flash_attn_dq_sm90(int dtype, const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dq, int B, int H, int Sq, int Sk,
                                      int D, const long long* in_strides,
                                      const long long* out_strides,
                                      float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D != kHeadDim ||
      (dtype != 1 && dtype != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* st = in_strides;
  Params p{};
  int err = make_bshd_map(&p.q, dtype, q, B, Sq, H, st[0], st[1], st[2],
                          kBlockM);
  if (err == 0)
    err = make_bshd_map(&p.k, dtype, k, B, Sk, H, st[3], st[4], st[5],
                        kBlockN);
  if (err == 0)
    err = make_bshd_map(&p.v, dtype, v, B, Sk, H, st[6], st[7], st[8],
                        kBlockN);
  if (err == 0)
    err = make_bshd_map(&p.dout, dtype, dout, B, Sq, H, st[9], st[10],
                        st[11], kBlockM);
  if (err != 0) return err;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dq_sb = out_strides[0];
  p.dq_ss = out_strides[1];
  p.dq_sh = out_strides[2];
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.n_qtiles = (Sq + kBlockM - 1) / kBlockM;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 2 ? launch<__nv_bfloat16>(p, B, s)
                                     : launch<__half>(p, B, s));
}

extern "C" const char* t2v_flash_dq_sm90_error_string(int err) {
  return error_string(err);
}
