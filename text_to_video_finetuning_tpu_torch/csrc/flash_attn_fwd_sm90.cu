// Flash-attention forward for Hopper (sm_90a) at head_dim 40, 64 and 80,
// bf16 / fp16: TMA-fed K/V ring, wgmma, softmax and accumulators in
// registers.  Bound through a plain C entry point and loaded with ctypes
// (ops/kernel_build.py builds every csrc/*.cu with nvcc).
//
// Replaces: text_to_video_finetuning_tpu/ops/flash_attention.py::_fwd_kernel
// (the Pallas TPU kernel K1, `pallas_call` :117) on the `sm90` route of
// ops/flash_attention.py; fp32 and other head dims keep the first design,
// flash_attn_fwd.cu (the `wmma` route).  It computes what K1 computes --
// o = softmax(q k^T * scale) v with an online softmax over KV tiles, fp32
// running max / sum / accumulator, o in the input dtype, and the fp32
// logsumexp that K2 and K3 read.
//
// What bounds it on the H100: at the serving shape (B*H = 160, Sq = Sk =
// 1024, D = 64) the two products are 42.9 GFLOP, 43 us at 989 TFLOP/s
// dense bf16, against 2.4 us for q, k, v and o at 3.35 TB/s: the tensor
// cores bound it.  The first design (flash_attn_fwd.cu) ran WMMA through
// fp32 shared tiles, with a scalar softmax, an O accumulator rewritten in
// shared memory every tile and synchronous element loads, at ~3 % of that
// bound.  Here (see flash_sm90.cuh for the geometry):
// * one CTA per (batch*head, 128 query rows): two consumer warpgroups of 64
//   rows and one producer warp;
// * the producer loads Q once and streams K and V through a two-stage ring
//   of 128-row tiles with TMA (128-byte swizzle), each stage guarded by a
//   full and an empty mbarrier, so the next tile's loads overlap this
//   tile's products;
// * S = Q.K^T is a wgmma m64n128k16 chain with both operands in shared
//   memory; the fp32 scores stay in registers, where the softmax runs: a
//   row lives on one thread quad (two shuffles per reduction), exp2 with
//   scale * log2(e) folded into one FMA, per-thread partial row sums;
// * P is packed in place into bf16 / fp16 A fragments and O += P.V is a
//   register-sourced wgmma m64n64k16 chain, V read MN-major from the same
//   swizzled tile; the O accumulator, running max and sum stay in registers
//   for the whole KV loop;
// * the epilogue divides by the row sum, writes o through its strides and
//   the lse = m + log(l) of rows < Sq.
// Head_dim is a template parameter (AnimateDiff's SD 1.5 UNet has 8 heads
// at every level: head_dim 40 at 4,096 tokens, 80 at 1,024).  A row is
// read as ceil(D / 64) column blocks of 64, each its own 128-byte-swizzled
// tile loaded by one TMA box, which zero-fills the columns past D.  S takes
// ceil(D / 16) k-slices (3 at 40, the zero columns 40..47 adding nothing; 5
// at 80, the fifth on the second block); O is one m64n64 accumulator per
// block (columns past D come out zero and are not written).  What bounds
// it at head_dim 40: a score costs 4 * 40 = 160 FLOP of products (S runs
// 48 deep and P.V 64 wide, so the tensor cores do 224), against the same
// softmax per score as at 64 (the exp2, the FMA, the max and sum
// reductions, the P packing), and nothing overlaps the softmax with the
// wgmmas.  So the softmax, not the 160 FLOP, sets its time, and its share
// of the roofline falls below head_dim 64's: 25 % at AnimateDiff's level 0
// and 33 % at 80, against 30-37 % at 64 (PERF.md's kernel table).
// Ragged edges: TMA zero-fills K/V rows >= Sk, whose scores would be 0, so
// those columns are set to -inf; query rows >= Sq are zero-filled and never
// written.  q, k, v are read BSHD through 4-D tensor maps over their
// strides (16-byte aligned: the wrapper checks), o is written BSHD.

#include "flash_sm90.cuh"

namespace {

using namespace t2v_sm90;

constexpr int kBlockN = 128;  // KV rows per ring stage
constexpr int kStages = 2;
constexpr int kQBytes = kBlockM * kRowBytes;   // 16 KB a column block
constexpr int kKvBytes = kBlockN * kRowBytes;  // 16 KB a block of K or V

// 64-column blocks of a head_dim-D row
template <int D>
constexpr int kBlocks = (D + kBoxCols - 1) / kBoxCols;

// the columns of block C that hold head_dim (a multiple of 8)
template <int D, int C>
constexpr int kBlockCols =
    D - C * kBoxCols < kBoxCols ? D - C * kBoxCols : kBoxCols;

template <int D>
struct Smem {
  uint8_t q[kBlocks<D>][kQBytes];
  uint8_t k[kStages][kBlocks<D>][kKvBytes];
  uint8_t v[kStages][kBlocks<D>][kKvBytes];
  uint64_t q_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
template <int D>
constexpr size_t kSmemBytes = sizeof(Smem<D>) + 1024;  // + alignment slack

struct Params {
  CUtensorMap q, k, v;
  void* o;
  float* lse;  // (B, H, Sq) contiguous
  long long o_sb, o_ss, o_sh;
  int H, Sq, Sk, n_qtiles;
  float scale_log2;  // scale * log2(e)
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ Params p) {
  static_assert(D % 8 == 0 && kBlocks<D> <= 2, "head_dim 8, 16, .. 128");
  constexpr int kNB = kBlocks<D>;
  extern __shared__ uint8_t smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(align1024(smem_raw));

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
      mbar_expect_tx(&sm.q_full, kNB * kQBytes);
#pragma unroll
      for (int c = 0; c < kNB; ++c)
        tma_load_rows(sm.q[c], &p.q, &sm.q_full, h, q0, b, c * kBoxCols);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % kStages;
        // the stage's previous tile (t - kStages) must be released first
        if (t >= kStages) mbar_wait(&sm.empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kNB * kKvBytes);
#pragma unroll
        for (int c = 0; c < kNB; ++c) {
          tma_load_rows(sm.k[s][c], &p.k, &sm.full[s], h, t * kBlockN, b,
                        c * kBoxCols);
          tma_load_rows(sm.v[s][c], &p.v, &sm.full[s], h, t * kBlockN, b,
                        c * kBoxCols);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; this thread
  // holds rows r and r + 8 of them and columns 8i + cq, 8i + cq + 1
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r = warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const float sl2 = p.scale_log2;

  float o[kNB][32];  // one m64n64 accumulator per column block
#pragma unroll
  for (int c = 0; c < kNB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of score * sl2
  float l0 = 0.0f, l1 = 0.0f;            // this thread's partial row sums
  uint64_t desc_q[kNB];
#pragma unroll
  for (int c = 0; c < kNB; ++c)
    desc_q[c] = kmajor_desc(sm.q[c] + wg * kWgRows * kRowBytes);

  mbar_wait(&sm.q_full, 0);
  for (int t = 0; t < n_kv; ++t) {
    const int s = t % kStages;
    mbar_wait(&sm.full[s], (t / kStages) & 1);

    // S = Q . K^T (64 x 128 per warpgroup), fp32 in registers: k-slice kk
    // is slice kk % 4 of column block kk / 4
    float sc[64];
    uint64_t desc_k[kNB];
#pragma unroll
    for (int c = 0; c < kNB; ++c) desc_k[c] = kmajor_desc(sm.k[s][c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < (D + 15) / 16; ++kk)
      wgmma_ss_n128<T>(sc, desc_q[kk / 4] + (kk % 4) * kDescKStep,
                       desc_k[kk / 4] + (kk % 4) * kDescKStep, kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const int col0 = t * kBlockN;
    if (col0 + kBlockN > p.Sk) {  // the last tile: columns >= Sk are -inf
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col0 + 8 * i + cq + (j & 1) >= p.Sk) sc[4 * i + j] = -INFINITY;
    }

    // online softmax: every tile has a column < Sk, so the max is finite
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
#pragma unroll
    for (int d = 1; d <= 2; d *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
    }
    const float n0 = fmaxf(m0, mx0 * sl2), n1 = fmaxf(m1, mx1 * sl2);
    const float c0 = exp2f(m0 - n0), c1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      sc[4 * i + 0] = exp2f(fmaf(sc[4 * i + 0], sl2, -n0));
      sc[4 * i + 1] = exp2f(fmaf(sc[4 * i + 1], sl2, -n0));
      sc[4 * i + 2] = exp2f(fmaf(sc[4 * i + 2], sl2, -n1));
      sc[4 * i + 3] = exp2f(fmaf(sc[4 * i + 3], sl2, -n1));
      s0 += sc[4 * i + 0] + sc[4 * i + 1];
      s1 += sc[4 * i + 2] + sc[4 * i + 3];
    }
    l0 = l0 * c0 + s0;
    l1 = l1 * c1 + s1;
#pragma unroll
    for (int c = 0; c < kNB; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o[c][4 * i + 0] *= c0;
        o[c][4 * i + 1] *= c0;
        o[c][4 * i + 2] *= c1;
        o[c][4 * i + 3] *= c1;
      }

    // O += P . V with P in registers (V MN-major), one chain per block
    uint32_t pa[8][4];
    to_a_fragments<T, 64>(sc, pa);
#pragma unroll
    for (int c = 0; c < kNB; ++c) fence_regs(o[c]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kNB; ++c) {
      const uint64_t desc_v = mnmajor_desc(sm.v[s][c]);
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_rs_n64_t<T>(o[c], pa[kk], desc_v + kk * kDescRowStep, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < kNB; ++c) fence_regs(o[c]);
    fence_regs(pa);
    mbar_arrive(&sm.empty[s]);  // this thread is done with the stage
  }

#pragma unroll
  for (int d = 1; d <= 2; d *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, d);
    l1 += __shfl_xor_sync(0xffffffffu, l1, d);
  }
  const int row0 = q0 + wg * kWgRows + r;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  store_rows<T, kBlockCols<D, 0>>(og, p.o_ss, row0, p.Sq, cq, o[0],
                                  1.0f / l0, 1.0f / l1);
  if constexpr (kNB > 1)
    store_rows<T, kBlockCols<D, 1>>(og, p.o_ss, row0, p.Sq, kBoxCols + cq,
                                    o[1], 1.0f / l0, 1.0f / l1);
  if (lane % 4 == 0) {
    float* lse = p.lse + static_cast<long long>(bh) * p.Sq;
    if (row0 < p.Sq) lse[row0] = (m0 + log2f(l0)) * kLn2;
    if (row0 + 8 < p.Sq) lse[row0 + 8] = (m1 + log2f(l1)) * kLn2;
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes<D>));
  if (err != cudaSuccess) return err;
  const long long n_ctas = static_cast<long long>(p.n_qtiles) * B * p.H;
  if (n_ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd_sm90_kernel<T, D>
      <<<static_cast<unsigned>(n_ctas), kThreads, kSmemBytes<D>, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(int dtype, const Params& p, int B,
                         cudaStream_t stream) {
  return dtype == 2 ? launch<__nv_bfloat16, D>(p, B, stream)
                    : launch<__half, D>(p, B, stream);
}

}  // namespace

// dtype: 1 = float16, 2 = bfloat16; D is 40, 64 or 80.  Strides are in
// elements, each a multiple of 8 (16 bytes), the last (head_dim) stride 1;
// base addresses 16-byte aligned.  Returns 0, a CUDA error code, or one of
// the negative codes of flash_sm90.cuh (t2v_flash_fwd_sm90_error_string).
extern "C" int t2v_flash_attn_fwd_sm90(
    int dtype, const void* q, const void* k, const void* v, void* o,
    float* lse, int B, int H, int Sq, int Sk, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale,
    void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 ||
      (D != 40 && D != 64 && D != 80) || (dtype != 1 && dtype != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  int err =
      make_bshd_map(&p.q, dtype, q, B, Sq, H, q_sb, q_ss, q_sh, D, kBlockM);
  if (err == 0)
    err = make_bshd_map(&p.k, dtype, k, B, Sk, H, k_sb, k_ss, k_sh, D,
                        kBlockN);
  if (err == 0)
    err = make_bshd_map(&p.v, dtype, v, B, Sk, H, v_sb, v_ss, v_sh, D,
                        kBlockN);
  if (err != 0) return err;
  p.o = o;
  p.lse = lse;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.o_sh = o_sh;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.n_qtiles = (Sq + kBlockM - 1) / kBlockM;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t launched = D == 40   ? launch_dtype<40>(dtype, p, B, s)
                               : D == 80 ? launch_dtype<80>(dtype, p, B, s)
                                         : launch_dtype<64>(dtype, p, B, s);
  return static_cast<int>(launched);
}

extern "C" const char* t2v_flash_fwd_sm90_error_string(int err) {
  return error_string(err);
}
