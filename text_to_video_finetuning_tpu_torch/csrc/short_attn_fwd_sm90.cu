// Short-key attention forward for Hopper (sm_90a) at head_dim 64, bf16 /
// fp16, at most 256 keys: the attentions of inference that fall below the
// flash kernel's threshold (ops/attention.py's `auto` rule).  Bound through
// a plain C entry point and loaded with ctypes (ops/kernel_build.py builds
// every csrc/*.cu with nvcc).
//
// Replaces no TPU kernel: the JAX package runs these attentions as XLA's
// einsum-softmax-einsum (`_xla_attention`), and the port's plain twin of
// that (`plain_attention`) moved each call's q, k and v through fp32 copies,
// permutes and a separate softmax.  This kernel computes what
// `plain_attention` computes -- logits q.k^T * scale and their softmax in
// fp32, the weights normalised in fp32 and rounded to v's dtype, the second
// product accumulated in fp32 and rounded once to q's dtype -- in one pass
// that reads q, k and v once and writes o once.
//
// What bounds it on the H100: at head_dim 64 a call does 4 Sq Sk 64 FLOPs
// on (2 Sq + 2 Sk) 128 bytes, at most Sk FLOPs a byte (128 at 256 keys, 77
// at 77, 8 at 16 frames), against the card's ~295 bf16 FLOPs a byte of HBM:
// every shape it takes is bound by the bytes of q, k, v and o at
// 3.35 TB/s.  So:
// * q, k and v are read through their BSHD strides (the views `to_q`,
//   `to_k`, `to_v` return) with 16-byte cp.async loads, o is written with
//   16-byte stores; no fp32 tensor and no logsumexp reach device memory;
// * a CTA keeps the whole K and V of each (batch, head) it serves resident
//   in shared memory, padded to a multiple of 16 rows with zeros (77 keys
//   become 80); the scores of the padding are set to -inf, so the single-
//   pass softmax needs no running rescale;
// * each warp owns 16-query tiles: S = Q.K^T and O = P.V run on the tensor
//   cores as mma.sync m16n8k16 with fp32 accumulators; the whole 16 x Sk
//   score tile stays in registers (NK = Sk / 16 rounded up to a compiled
//   bucket is a template argument, so the tile is a fixed register array),
//   where the softmax runs (a row lives on one lane quad), and it turns
//   into the A fragments of P.V in place;
// * short queries (temporal attention: 16 frames, 16 keys) pack several
//   (batch, head) problems into a CTA, one warp each, so the CTA's loads
//   are whole rows of consecutive heads; long queries (cross-attention over
//   77 tokens at 1,024 queries) split a problem's query tiles over CTAs of
//   8 warps, each warp double-buffering its next q tile behind the current
//   one's products;
// * a warp's q tile is also where its o tile is assembled before the
//   16-byte stores.  Shared rows are 128 bytes, XOR-swizzled by 16-byte
//   chunk (chunk ^ row % 8) so that ldmatrix and the 4-byte o stores are
//   free of bank conflicts.
// Ragged edges: key rows >= Sk and query rows >= Sq are zero-filled by the
// cp.async source size; padded keys are masked, padded queries never
// written.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kRowBytes = kHeadDim * 2;  // one bf16 / fp16 row: 128 bytes
constexpr int kChunks = kRowBytes / 16;  // 16-byte chunks a row
constexpr int kTileRows = 16;            // a warp's query tile
constexpr int kTileBytes = kTileRows * kRowBytes;
constexpr int kMaxWarps = 8;
constexpr int kMaxKeys = 256;
constexpr int kErrBadArgs = -1;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int BH, H, Sq, Sk;
  int n_qtiles;     // query tiles of a problem
  int group;        // (batch, head) problems a CTA serves
  int qsplit;       // CTAs a problem's query tiles are split over
  int qt_per_cta;   // query tiles of a problem in one CTA
  int qbufs;        // q tile buffers a warp (2: double-buffered)
  float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kRowBytes + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; a source size of 0 zero-fills the chunk
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// NK: keys padded to 16 * NK in shared memory and registers
template <int NK, typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
    t2v_short_attn_fwd_sm90(const __grid_constant__ Params p) {
  constexpr int kKvRows = 16 * NK;
  constexpr int kKvBytes = kKvRows * kRowBytes;
  extern __shared__ __align__(128) uint8_t smem[];

  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh0 = (blockIdx.x / p.qsplit) * p.group;
  const int qt0 = (blockIdx.x % p.qsplit) * p.qt_per_cta;
  const int n_prob = min(p.group, p.BH - bh0);
  const int n_qt = min(p.qt_per_cta, p.n_qtiles - qt0);
  const int n_tiles = n_prob * n_qt;
  uint8_t* qbuf = smem + p.group * 2 * kKvBytes +
                  warp * p.qbufs * kTileBytes;
  const T* qg = static_cast<const T*>(p.q);

  // K and V of the CTA's problems, chunk-major so that neighbouring threads
  // read neighbouring 16 bytes of a row
  const int kv_units = n_prob * 2 * kKvRows * kChunks;
  for (int u = threadIdx.x; u < kv_units; u += blockDim.x) {
    const int ch = u % kChunks;
    const int row = (u / kChunks) % kKvRows;
    const int which = (u / (kChunks * kKvRows)) % 2;
    const int prob = u / (kChunks * kKvRows * 2);
    const int bh = bh0 + prob, b = bh / p.H, h = bh % p.H;
    const bool valid = row < p.Sk;
    const T* src;
    if (which == 0)
      src = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh +
            (valid ? row * p.k_ss : 0) + ch * 8;
    else
      src = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh +
            (valid ? row * p.v_ss : 0) + ch * 8;
    cp_async16(smem + (prob * 2 + which) * kKvBytes + swz(row, ch), src,
               valid);
  }

  // a warp's query tile t: 16 rows x 8 chunks, 4 chunks a lane
  auto load_q = [&](int t, int buf) {
    const int bh = bh0 + t / n_qt, b = bh / p.H, h = bh % p.H;
    const int q_row0 = (qt0 + t % n_qt) * kTileRows;
    uint8_t* dst = qbuf + buf * kTileBytes;
#pragma unroll
    for (int i = 0; i < kTileRows * kChunks / 32; ++i) {
      const int u = i * 32 + lane, row = u / kChunks, ch = u % kChunks;
      const bool valid = q_row0 + row < p.Sq;
      cp_async16(dst + swz(row, ch),
                 qg + b * p.q_sb + h * p.q_sh +
                     (valid ? (q_row0 + row) * p.q_ss : 0) + ch * 8,
                 valid);
    }
  };

  int t = warp;
  if (t < n_tiles) load_q(t, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this lane's rows r, r + 8 of a tile and columns c, c + 1 of each
  // 8-column slice of the accumulators
  const int r = lane / 4, c = 2 * (lane % 4);
  const float sl2 = p.scale_log2;
  T* og = static_cast<T*>(p.o);

  for (int i = 0; t < n_tiles; ++i, t += nwarps) {
    const int buf = p.qbufs == 2 ? (i & 1) : 0;
    if (p.qbufs == 2 && t + nwarps < n_tiles) load_q(t + nwarps, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t's own group has landed
    __syncwarp();

    const int prob = t / n_qt;
    const int q_row0 = (qt0 + t % n_qt) * kTileRows;
    const uint8_t* ks = smem + prob * 2 * kKvBytes;
    const uint8_t* vs = ks + kKvBytes;
    uint8_t* qs = qbuf + buf * kTileBytes;

    // S = Q . K^T, 16 x 16NK in fp32
    uint32_t qa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldmatrix_x4(qa[kk], qs + swz(lane % 16, 2 * kk + lane / 16));
    float s[2 * NK][4];
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int j2 = 0; j2 < NK; ++j2)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + swz(16 * j2 + (lane / 16) * 8 + lane % 8,
                                 2 * kk + (lane / 8) % 2));
        Mma<T>::run(s[2 * j2], qa[kk], kb[0], kb[1]);
        Mma<T>::run(s[2 * j2 + 1], qa[kk], kb[2], kb[3]);
      }

    // the softmax of rows r and r + 8 over Sk keys, in fp32, on the
    // logits times log2(e)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= sl2;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * j + c + e >= p.Sk) s[j][e] = s[j][2 + e] = -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int d = 1; d <= 2; d *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
    }
    float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j) {
      s[j][0] = exp2f(s[j][0] - mx0);
      s[j][1] = exp2f(s[j][1] - mx0);
      s[j][2] = exp2f(s[j][2] - mx1);
      s[j][3] = exp2f(s[j][3] - mx1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int d = 1; d <= 2; d *= 2) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, d);
      l1 += __shfl_xor_sync(0xffffffffu, l1, d);
    }
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;

    // the weights normalised in fp32, rounded to v's dtype: the A fragments
    // of O = P . V (keys 16kk .. 16kk + 15 are score slices 2kk, 2kk + 1)
    uint32_t pa[NK][4];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      pa[kk][0] = Mma<T>::pack(s[2 * kk][0] * inv0, s[2 * kk][1] * inv0);
      pa[kk][1] = Mma<T>::pack(s[2 * kk][2] * inv1, s[2 * kk][3] * inv1);
      pa[kk][2] =
          Mma<T>::pack(s[2 * kk + 1][0] * inv0, s[2 * kk + 1][1] * inv0);
      pa[kk][3] =
          Mma<T>::pack(s[2 * kk + 1][2] * inv1, s[2 * kk + 1][3] * inv1);
    }

    // O = P . V, 16 x 64 in fp32, V read transposed by ldmatrix
    float o[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + swz(16 * kk + ((lane / 8) % 2) * 8 +
                                           lane % 8,
                                       2 * np + lane / 16));
        Mma<T>::run(o[2 * np], pa[kk], vb[0], vb[1]);
        Mma<T>::run(o[2 * np + 1], pa[kk], vb[2], vb[3]);
      }

    // o rounded once to q's dtype, assembled in the q tile's buffer (its
    // fragments are in registers), then written 16 bytes a lane
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(qs + swz(r, n) + 2 * c) =
          Mma<T>::pack(o[n][0], o[n][1]);
      *reinterpret_cast<uint32_t*>(qs + swz(r + 8, n) + 2 * c) =
          Mma<T>::pack(o[n][2], o[n][3]);
    }
    __syncwarp();
    const int bh = bh0 + prob, b = bh / p.H, h = bh % p.H;
#pragma unroll
    for (int j = 0; j < kTileRows * kChunks / 32; ++j) {
      const int u = j * 32 + lane, row = u / kChunks, ch = u % kChunks;
      if (q_row0 + row < p.Sq)
        *reinterpret_cast<uint4*>(og + b * p.o_sb + h * p.o_sh +
                                  (q_row0 + row) * p.o_ss + ch * 8) =
            *reinterpret_cast<const uint4*>(qs + swz(row, ch));
    }
    __syncwarp();  // the buffer is free for the load after next
  }
}

template <int NK, typename T>
cudaError_t launch(const Params& p, int ctas, int threads, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      t2v_short_attn_fwd_sm90<NK, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  t2v_short_attn_fwd_sm90<NK, T><<<ctas, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_nk(int nk, const Params& p, int ctas, int threads,
                      size_t smem, cudaStream_t s) {
  switch (nk) {
    case 1: return launch<1, T>(p, ctas, threads, smem, s);
    case 2: return launch<2, T>(p, ctas, threads, smem, s);
    case 3: return launch<3, T>(p, ctas, threads, smem, s);
    case 4: return launch<4, T>(p, ctas, threads, smem, s);
    case 5: return launch<5, T>(p, ctas, threads, smem, s);
    case 6: return launch<6, T>(p, ctas, threads, smem, s);
    case 8: return launch<8, T>(p, ctas, threads, smem, s);
    case 12: return launch<12, T>(p, ctas, threads, smem, s);
    case 16: return launch<16, T>(p, ctas, threads, smem, s);
  }
  return cudaErrorInvalidValue;
}

// the compiled key buckets: the smallest NK with 16 NK >= Sk
int key_bucket(int Sk) {
  static const int kBuckets[] = {1, 2, 3, 4, 5, 6, 8, 12, 16};
  for (int nk : kBuckets)
    if (16 * nk >= Sk) return nk;
  return 0;
}

}  // namespace

// dtype: 1 = float16, 2 = bfloat16; D must be 64 and 1 <= Sk <= 256.
// Strides are in elements, each a multiple of 8 (16 bytes), the last
// (head_dim) stride 1; base addresses 16-byte aligned (the wrapper checks).
// Returns 0, a CUDA error code, or kErrBadArgs
// (t2v_short_attn_error_string).
extern "C" int t2v_short_attn_fwd_sm90(
    int dtype, const void* q, const void* k, const void* v, void* o, int B,
    int H, int Sq, int Sk, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, void* stream) {
  const int nk = Sk >= 1 && Sk <= kMaxKeys ? key_bucket(Sk) : 0;
  if (B <= 0 || H <= 0 || Sq <= 0 || nk == 0 || D != kHeadDim ||
      (dtype != 1 && dtype != 2) ||
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return kErrBadArgs;
  Params p{q, k, v, o, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
           v_sh, o_sb, o_ss, o_sh};
  p.BH = B * H;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.n_qtiles = (Sq + kTileRows - 1) / kTileRows;
  // a CTA holds at most 64 KB of K and V and gives each of its <= 8 warps
  // up to two query tiles: long queries split over CTAs, short ones pack
  // problems into one
  const int kv_bytes = 2 * 16 * nk * kRowBytes;
  p.qt_per_cta = p.n_qtiles < 2 * kMaxWarps ? p.n_qtiles : 2 * kMaxWarps;
  p.qsplit = (p.n_qtiles + p.qt_per_cta - 1) / p.qt_per_cta;
  p.group = 1;
  if (p.qsplit == 1) {
    const int by_warps = kMaxWarps / p.n_qtiles;
    const int by_smem = (64 << 10) / kv_bytes;
    p.group = by_warps < by_smem ? by_warps : by_smem;
    if (p.group < 1) p.group = 1;
  }
  const int tiles = p.group * p.qt_per_cta;
  const int warps = tiles < kMaxWarps ? tiles : kMaxWarps;
  p.qbufs = tiles > warps ? 2 : 1;
  p.scale_log2 = scale * 1.4426950408889634f;
  const long long ctas =
      static_cast<long long>((p.BH + p.group - 1) / p.group) * p.qsplit;
  if (ctas > 0x7fffffffLL) return kErrBadArgs;
  const size_t smem = static_cast<size_t>(p.group) * kv_bytes +
                      static_cast<size_t>(warps) * p.qbufs * kTileBytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 2 ? launch_nk<__nv_bfloat16>(nk, p, static_cast<int>(ctas),
                                            warps * 32, smem, s)
                 : launch_nk<__half>(nk, p, static_cast<int>(ctas),
                                     warps * 32, smem, s);
  return static_cast<int>(err);
}

extern "C" const char* t2v_short_attn_error_string(int err) {
  if (err == kErrBadArgs)
    return "unsupported arguments (dtype, head_dim 64, 1 <= Sk <= 256, "
           "non-empty q)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
