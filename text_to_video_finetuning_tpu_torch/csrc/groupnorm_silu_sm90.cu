// Fused GroupNorm(+SiLU), forward (K4) and backward (K5), designed for
// Hopper (sm_90a): the `sm90` route of ops/groupnorm.py.  Plain C entry
// points, loaded with ctypes; ops/kernel_build.py builds it with nvcc.
//
// Replaces: text_to_video_finetuning_tpu/ops/groupnorm.py::_fwd_kernel (K4)
// and ::_bwd_kernel (K5), the Pallas TPU kernels, as csrc/groupnorm_silu.cu
// (the `simt` route, kept for the shapes this design does not take) does.
// The function is the same: in the port's NCHW layout one (sample, group) is
// one contiguous slab of C/G * H*W elements;
//   K4: y = silu((x - mean) * rstd * gamma + beta) (SiLU optional) in x's
//       dtype, mean and rstd (N, G) fp32;
//   K5: dx = rstd * (dxh - mean_g(dxh) - xh * mean_g(dxh * xh)) with
//       xh = (x - mean) * rstd, dz = dy * silu'(xh * gamma + beta),
//       dxh = dz * gamma; optionally the (N, C) fp32 partials of dgamma
//       (sum dz * xh) and dbeta (sum dz).
//
// What bounds them on the H100: bytes.  K4 must read x and write y, K5 read
// x and dy and write dx (4 and 6 bytes an element in bf16), at ~10 and ~30
// fp32 operations an element: far below the card's ridge.  The TPU kernels
// read each element from HBM once, because a whole sample sat in VMEM.
// The `simt` kernels keep nothing on chip: they read x (and dy) twice, each
// thread folds 16-byte loads into a serial merge chain, and a CTA keeps only
// a few KB in flight.
//
// The design: "read once, keep it on chip".
// * A CTA's share of a slab lives in dynamic shared memory.  Thread 0 brings
//   it in with the 1-D bulk async copy (cp.async.bulk ... mbarrier::
//   complete_tx), in chunks of `chunk_bytes`, each completing on its own
//   mbarrier, so the whole share is in flight at once and the first pass
//   over chunk i runs while later chunks land.  Each element of x (and dy)
//   crosses HBM once; the second pass (the normalised write) and K5's
//   dgamma / dbeta partials read shared memory.
// * A slab too large for one CTA's budget is split over a thread-block
//   cluster of k in {1, 2, 4, 8} CTAs, launched with cudaLaunchKernelEx (a
//   lone CTA takes a plain launch); rank r holds 16-byte units
//   [r*U/k, (r+1)*U/k) of the slab's U.  The CTAs' partials (count, mean,
//   M2 for K4; the two sums for K5; the per-channel dgamma / dbeta
//   partials) are merged through distributed shared memory in rank order,
//   so a result does not depend on which CTA finished first: bitwise
//   deterministic.
// * K5 keeps dxh = dz * gamma of its share in fp32 in shared memory (8
//   bytes an element in bf16, with x and dy), so its second pass is three
//   FMAs an element, not a second SiLU'.
// * The plan (k, threads, chunk bytes, shared bytes per CTA) is made by
//   ops/groupnorm.py::gn_plan, a pure function; the entry points check it
//   and refuse one they cannot run.  k is the smallest that fits the share
//   in 227 KB with room for two CTAs on an SM (one CTA's write pass then
//   overlaps another's loads; a cluster costs a barrier round trip and
//   launches slower, so no larger k).  bf16 at (16, 960, 32, 32), 61,440-byte
//   slabs: K4 k = 1 (3 CTAs an SM: 396 slots for 512 CTAs, 1.29 waves), K5
//   k = 4 (60 KB CTAs, 3 an SM); at (16, 960, 40, 72), 172,800-byte slabs:
//   K4 k = 2 (85 KB, 2 an SM), K5 k = 8 (85 KB, 2 an SM).  fp32 doubles the
//   bytes: K4 k = 2 / 4, K5 k = 4 / 8 (at 576x320 one 127 KB CTA an SM).
//   A share of at most 8 KB (the 4x4 and 8x8 levels) takes 128 threads; one
//   of at most a unit a thread is loaded straight into registers (one
//   16-byte load each), since there the launch's latency sets the time.
// * The statistics are those of the simt kernels: Chan/Welford merges in fp32 (each thread
//   folds 16-byte vectors into its running (count, mean, M2), the CTA and
//   the cluster merge in a fixed tree / order), y and dx in x's dtype,
//   gamma / beta in fp32 or x's dtype.  The channel of a vector is walked,
//   not divided for: H*W need not be a multiple of the vector width (the
//   576x320 step has 10x18 and 5x9 levels), so a vector may straddle two
//   channels, whose gamma / beta come from a per-CTA table in shared memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxChunks = 64;
constexpr int kMaxSmem = 232448;  // a CTA's dynamic shared memory, 227 KB
// shared layout: [kMaxChunks mbarriers][reduction scratch][channel table]
// [x share][dy share (K5)]
constexpr int kBarBytes = kMaxChunks * 8;
constexpr int kScratchBytes = 256;
constexpr int kHeaderBytes = kBarBytes + kScratchBytes;

// Error codes of the entry points beyond CUDA's own (which are >= 0).
constexpr int kErrLayout = -1;   // slab not whole 16-byte units, H*W < VEC,
                                 // an unaligned pointer or a bad shape
constexpr int kErrCluster = -2;  // cluster size
constexpr int kErrThreads = -3;  // threads per CTA
constexpr int kErrChunk = -4;    // chunk bytes / count
constexpr int kErrSmem = -5;     // shared bytes below the plan's need or
                                 // above 227 KB
constexpr int kErrDtype = -6;

// -- 16-byte vectors ----------------------------------------------------------

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float at(const float* p, int i) { return p[i]; }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float at(const __nv_bfloat16* p, int i) {
    return __bfloat162float(p[i]);
  }
};

template <>
struct Vec16<__half> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __half2 h = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float at(const __half* p, int i) { return __half2float(p[i]); }
};

__device__ __forceinline__ float param(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float param(const __half* p, int i) {
  return __half2float(p[i]);
}
__device__ __forceinline__ float param(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

// -- mbarriers, the bulk copy, the cluster barrier ------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for a chunk.  ~10 s of SM clock means a copy that never lands: trap,
// so that the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  if (mbar_try_wait(bar, 0)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, 0))
    if (clock64() - start > (1LL << 34)) __trap();
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// -- statistics -----------------------------------------------------------------

struct Stats {
  float n, mean, m2;
};

__device__ __forceinline__ Stats shfl(Stats s, int src) {
  return {__shfl_sync(0xffffffffu, s.n, src), __shfl_sync(0xffffffffu, s.mean, src),
          __shfl_sync(0xffffffffu, s.m2, src)};
}

__device__ __forceinline__ float2 shfl(float2 v, int src) {
  return make_float2(__shfl_sync(0xffffffffu, v.x, src), __shfl_sync(0xffffffffu, v.y, src));
}

__device__ __forceinline__ Stats merge(Stats a, Stats b) {
  const float n = a.n + b.n;
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float d = b.mean - a.mean;
  const float fb = b.n / n;
  return {n, a.mean + d * fb, a.m2 + b.m2 + d * d * a.n * fb};
}

// Fold one vector of VEC values into a thread's running statistics: the
// vector's own mean and M2, then a Chan merge whose weight VEC / n needs no
// branch (a first vector gets weight 1).
template <int VEC>
__device__ __forceinline__ void fold(Stats& s, const float* v) {
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) sum += v[j];
  const float cm = sum * (1.f / VEC);
  float cm2 = 0.f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) cm2 += (v[j] - cm) * (v[j] - cm);
  const float n = s.n + VEC;
  const float fb = __fdividef(static_cast<float>(VEC), n);
  const float d = cm - s.mean;
  s.m2 += cm2 + d * d * s.n * fb;
  s.mean += d * fb;
  s.n = n;
}

struct Scratch {
  Stats warp_stats[kMaxWarps + 1];
  float2 warp_sums[kMaxWarps + 1];
  Stats part;        // this CTA's statistics, read by the cluster (K4)
  Stats total;       // the cluster's
  float2 part_sums;  // this CTA's two sums, read by the cluster (K5)
  float2 total_sums;
};
static_assert(sizeof(Scratch) <= kScratchBytes, "scratch");

// Chan merge of every thread's Stats in a fixed tree; every thread gets it
__device__ Stats block_stats(Stats s, Scratch* sc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int off = 16; off > 0; off >>= 1) {
    const Stats o{__shfl_down_sync(0xffffffffu, s.n, off),
                  __shfl_down_sync(0xffffffffu, s.mean, off),
                  __shfl_down_sync(0xffffffffu, s.m2, off)};
    s = merge(s, o);
  }
  if (lane == 0) sc->warp_stats[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < static_cast<int>(blockDim.x / 32) ? sc->warp_stats[lane]
                                                 : Stats{0.f, 0.f, 0.f};
    for (int off = 16; off > 0; off >>= 1) {
      const Stats o{__shfl_down_sync(0xffffffffu, s.n, off),
                    __shfl_down_sync(0xffffffffu, s.mean, off),
                    __shfl_down_sync(0xffffffffu, s.m2, off)};
      s = merge(s, o);
    }
    if (lane == 0) sc->warp_stats[kMaxWarps] = s;
  }
  __syncthreads();
  return sc->warp_stats[kMaxWarps];
}

// sums of a and b over the CTA in a fixed tree; every thread gets them
__device__ float2 block_sum2(float a, float b, Scratch* sc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  if (lane == 0) sc->warp_sums[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < static_cast<int>(blockDim.x / 32);
    a = live ? sc->warp_sums[lane].x : 0.f;
    b = live ? sc->warp_sums[lane].y : 0.f;
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      b += __shfl_down_sync(0xffffffffu, b, off);
    }
    if (lane == 0) sc->warp_sums[kMaxWarps] = make_float2(a, b);
  }
  __syncthreads();
  return sc->warp_sums[kMaxWarps];
}

// 1 / (1 + e^-z) by the fast exponent and reciprocal (two MUFU operations;
// relative error ~1e-6 for the UNet's |z| < 20; e^-z = inf gives 0)
// The cluster's partials, rank order: lane r of warp 0 reads rank r's
// partial (one distributed-shared-memory round trip for all ranks), every
// lane merges them in rank order, lane 0 leaves the result in `*out`.
template <typename U, typename Merge>
__device__ __forceinline__ void gather_ranks(U* part, int cluster, U zero, U* out,
                                             Merge merge_fn) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const U mine = lane < cluster ? *cg::this_cluster().map_shared_rank(part, lane) : zero;
  U m = zero;
  for (int r = 0; r < cluster; ++r) m = merge_fn(m, shfl(mine, r));
  if (lane == 0) *out = m;
}

__device__ __forceinline__ float sigmoid(float z) {
  return __fdividef(1.f, 1.f + __expf(-z));
}

template <bool SILU>
__device__ __forceinline__ float act(float z) {
  return SILU ? __fdividef(z, 1.f + __expf(-z)) : z;
}

// -- the CTA's share and its channels --------------------------------------------

struct Share {
  int rank;     // in the cluster
  int ng;       // slab: n * G + g
  int u0, u1;   // 16-byte units of the slab this CTA holds
  int c_first;  // first channel of the slab the share touches
  int nch;      // channels it touches
};

// The share of this CTA, in 32-bit arithmetic (a slab holds < 2^28 units
// and a cluster <= 8 CTAs): the first load's address waits on it.
template <int VEC>
__device__ __forceinline__ Share make_share(int cluster, int units, int hw) {
  Share s;
  if (cluster > 1) {
    s.rank = static_cast<int>(cg::this_cluster().block_rank());
    s.ng = static_cast<int>(blockIdx.x) / cluster;
    s.u0 = static_cast<int>(static_cast<unsigned>(s.rank) * static_cast<unsigned>(units) /
                            static_cast<unsigned>(cluster));
    s.u1 = static_cast<int>(static_cast<unsigned>(s.rank + 1) *
                            static_cast<unsigned>(units) / static_cast<unsigned>(cluster));
  } else {
    s.rank = 0;
    s.ng = static_cast<int>(blockIdx.x);
    s.u0 = 0;
    s.u1 = units;
  }
  s.c_first = s.u0 * VEC / hw;
  s.nch = (s.u1 * VEC - 1) / hw - s.c_first + 1;
  return s;
}

// The channel of a thread's current vector, walked as the thread strides
// `stride` elements at a time; H*W >= VEC, so a vector touches at most two
// channels: `split` elements of channel c, then channel c + 1.
struct ChannelWalk {
  int c, r, sc, sr, hw;
  __device__ ChannelWalk(int e, int stride, int hw_)
      : c(e / hw_), r(e % hw_), sc(stride / hw_), sr(stride % hw_), hw(hw_) {}
  __device__ __forceinline__ int split() const { return hw - r; }
  __device__ __forceinline__ void next() {
    c += sc;
    r += sr;
    if (r >= hw) {
      r -= hw;
      ++c;
    }
  }
};

// Thread 0 initialises the chunks' mbarriers and issues the bulk copies of
// x and, for K5, dy (chunk i of both completes on barrier i); the CTA
// barrier then publishes the mbarriers to the threads that wait on them.
template <int NTENSORS>
__device__ __forceinline__ void start_loads(uint64_t* bars, uint8_t* dst0, uint8_t* dst1,
                                            const uint8_t* src0, const uint8_t* src1,
                                            int nunits, int chunk_units) {
  const int nchunks = (nunits + chunk_units - 1) / chunk_units;
  if (threadIdx.x == 0) {
    for (int i = 0; i < nchunks; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < nchunks; ++i) {
      const int off = i * chunk_units * 16;
      const uint32_t bytes = static_cast<uint32_t>(min(chunk_units, nunits - i * chunk_units)) * 16u;
      mbar_expect_tx(&bars[i], bytes * NTENSORS);
      bulk_load(dst0 + off, src0 + off, bytes, &bars[i]);
      if (NTENSORS == 2) bulk_load(dst1 + off, src1 + off, bytes, &bars[i]);
    }
  }
  __syncthreads();
}

// gamma / beta of the share's channels into the table, as fp32 pairs
template <typename P>
__device__ __forceinline__ void load_table(float2* table, const P* gamma, const P* beta,
                                           int c0, int nch) {
  for (int i = threadIdx.x; i < nch; i += blockDim.x)
    table[i] = make_float2(param(gamma, c0 + i), param(beta, c0 + i));
}

// -- K4 ---------------------------------------------------------------------------

struct FwdParams {
  const void* x;
  const void* gamma;
  const void* beta;
  void* y;
  float* mean;  // (N, G)
  float* rstd;  // (N, G)
  int G, cg, hw, units, cluster, chunk_units, table_bytes;
  float eps;
};

template <typename T, typename P, bool SILU>
__global__ void __launch_bounds__(kMaxThreads, 4) gn_silu_fwd_sm90_kernel(const FwdParams p) {
  using V = Vec16<T>;
  constexpr int VEC = V::N;
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  Scratch* sc = reinterpret_cast<Scratch*>(smem + kBarBytes);
  float2* table = reinterpret_cast<float2*>(smem + kHeaderBytes);
  uint8_t* xs = smem + kHeaderBytes + p.table_bytes;

  const Share sh = make_share<VEC>(p.cluster, p.units, p.hw);
  const int g = sh.ng % p.G;
  const int nunits = sh.u1 - sh.u0;
  const long long base = (static_cast<long long>(sh.ng) * p.units + sh.u0) * 16;  // bytes
  const uint4* gx = reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(p.x) + base);
  // a share of at most one unit a thread stays in registers: one 16-byte
  // load each, no copy latency on the launch floor
  const bool in_regs = nunits <= static_cast<int>(blockDim.x);
  uint4 mine = make_uint4(0u, 0u, 0u, 0u);
  if (!in_regs)
    start_loads<1>(bars, xs, nullptr, reinterpret_cast<const uint8_t*>(gx), nullptr, nunits,
                   p.chunk_units);
  else if (static_cast<int>(threadIdx.x) < nunits)
    mine = __ldg(gx + threadIdx.x);
  load_table(table, static_cast<const P*>(p.gamma) + g * p.cg,
             static_cast<const P*>(p.beta) + g * p.cg, sh.c_first, sh.nch);
  // pass 2's channel walk, while the loads are in flight
  ChannelWalk w((sh.u0 + threadIdx.x) * VEC, blockDim.x * VEC, p.hw);

  // pass 1: statistics, chunk by chunk as they land
  const uint4* xv = reinterpret_cast<const uint4*>(xs);
  Stats st{0.f, 0.f, 0.f};
  if (in_regs) {
    if (static_cast<int>(threadIdx.x) < nunits) {
      float v[VEC];
      V::unpack(mine, v);
      fold<VEC>(st, v);
    }
  } else {
    for (int c0 = 0, i = 0; c0 < nunits; c0 += p.chunk_units, ++i) {
      mbar_wait(&bars[i]);
      const int end = min(c0 + p.chunk_units, nunits);
      for (int u = c0 + threadIdx.x; u < end; u += blockDim.x) {
        float v[VEC];
        V::unpack(xv[u], v);
        fold<VEC>(st, v);
      }
    }
  }
  st = block_stats(st, sc);  // also publishes the table
  if (p.cluster > 1) {
    if (threadIdx.x == 0) sc->part = st;
    cluster_arrive();
    cluster_wait();
    gather_ranks(&sc->part, p.cluster, Stats{0.f, 0.f, 0.f}, &sc->total, merge);
    cluster_arrive();  // this CTA is done reading the others' shared memory
    __syncthreads();
    st = sc->total;
  }
  const float mean = st.mean;
  const float rstd =
      1.f / sqrtf(fmaxf(st.m2 / static_cast<float>(p.units * VEC), 0.f) + p.eps);
  if (sh.rank == 0 && threadIdx.x == 0) {
    p.mean[sh.ng] = mean;
    p.rstd[sh.ng] = rstd;
  }

  // pass 2: y from shared memory
  uint4* y = reinterpret_cast<uint4*>(static_cast<uint8_t*>(p.y) + base);
  for (int u = threadIdx.x; u < nunits; u += blockDim.x, w.next()) {
    const int lc = w.c - sh.c_first, split = w.split();
    const float2 t0 = table[lc];
    float v[VEC];
    V::unpack(in_regs ? mine : xv[u], v);
    if (split >= VEC) {  // one channel: every vector when VEC divides H*W
      const float a = t0.x * rstd;
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = act<SILU>((v[j] - mean) * a + t0.y);
    } else {
      const float2 t1 = table[lc + 1];
      const float a0 = t0.x * rstd, a1 = t1.x * rstd;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const bool first = j < split;
        v[j] = act<SILU>((v[j] - mean) * (first ? a0 : a1) + (first ? t0.y : t1.y));
      }
    }
    y[u] = V::pack(v);
  }
  if (p.cluster > 1) cluster_wait();  // no CTA leaves while another reads it
}

// -- K5 ---------------------------------------------------------------------------

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
  int G, cg, hw, units, cluster, chunk_units, table_bytes, share_bytes;
  int nch_cap;  // channels a share may touch: the table's pairs
};

// xh and dz (the gradient at the GroupNorm's affine output) at one element
template <bool SILU>
__device__ __forceinline__ void grad_at(float xv, float dyv, float mean, float rstd,
                                        float gam, float bet, float& xh, float& dz) {
  xh = (xv - mean) * rstd;
  dz = dyv;
  if (SILU) {
    const float z = xh * gam + bet;
    const float s = sigmoid(z);
    dz = dyv * s * (1.f + z * (1.f - s));
  }
}

// K5 pass 1 at one vector: dxh = dz * gamma into `out` (fp32, kept in
// shared memory for pass 2), its sums into s_d and s_dx
template <int VEC, bool SILU>
__device__ __forceinline__ void bwd_vector(const float* xf, const float* df, float mean,
                                           float rstd, float2 t0, float2 t1, int split,
                                           float* out, float& s_d, float& s_dx) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float2 t = j < split ? t0 : t1;
    float xh, dz;
    grad_at<SILU>(xf[j], df[j], mean, rstd, t.x, t.y, xh, dz);
    out[j] = dz * t.x;
    s_d += out[j];
    s_dx += out[j] * xh;
  }
}

template <typename T, typename P, bool SILU>
__global__ void __launch_bounds__(kMaxThreads, 4) gn_silu_bwd_sm90_kernel(const BwdParams p) {
  using V = Vec16<T>;
  constexpr int VEC = V::N;
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  Scratch* sc = reinterpret_cast<Scratch*>(smem + kBarBytes);
  float2* table = reinterpret_cast<float2*>(smem + kHeaderBytes);  // gamma, beta
  uint8_t* xs = smem + kHeaderBytes + p.table_bytes;
  uint8_t* dys = xs + p.share_bytes;
  // dxh in VEC / 4 planes of one float4 a unit (conflict-free)
  float4* dxh = reinterpret_cast<float4*>(dys + p.share_bytes);
  const int plane = p.share_bytes / 16;

  const Share sh = make_share<VEC>(p.cluster, p.units, p.hw);
  const int g = sh.ng % p.G;
  const int nunits = sh.u1 - sh.u0;
  const long long base = (static_cast<long long>(sh.ng) * p.units + sh.u0) * 16;
  const uint4* gx = reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(p.x) + base);
  const uint4* gdy = reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(p.dy) + base);
  const bool in_regs = nunits <= static_cast<int>(blockDim.x);  // as in K4
  const bool has_unit = static_cast<int>(threadIdx.x) < nunits;
  uint4 mx = make_uint4(0u, 0u, 0u, 0u), md = mx;
  if (!in_regs)
    start_loads<2>(bars, xs, dys, reinterpret_cast<const uint8_t*>(gx),
                   reinterpret_cast<const uint8_t*>(gdy), nunits, p.chunk_units);
  else if (has_unit) {
    mx = __ldg(gx + threadIdx.x);
    md = __ldg(gdy + threadIdx.x);
  }
  load_table(table, static_cast<const P*>(p.gamma) + g * p.cg,
             static_cast<const P*>(p.beta) + g * p.cg, sh.c_first, sh.nch);
  const float mean = p.mean[sh.ng], rstd = p.rstd[sh.ng];
  __syncthreads();  // the table

  // pass 1: the two group sums, chunk by chunk as they land
  const uint4* xv = reinterpret_cast<const uint4*>(xs);
  const uint4* dyv = reinterpret_cast<const uint4*>(dys);
  float s_d = 0.f, s_dx = 0.f;
  float gr[VEC];  // dxh of the thread's unit on the register path
  if (in_regs) {
    if (has_unit) {
      const ChannelWalk w((sh.u0 + threadIdx.x) * VEC, blockDim.x * VEC, p.hw);
      const int lc = w.c - sh.c_first, split = w.split();
      float xf[VEC], df[VEC];
      V::unpack(mx, xf);
      V::unpack(md, df);
      bwd_vector<VEC, SILU>(xf, df, mean, rstd, table[lc],
                            split >= VEC ? table[lc] : table[lc + 1],
                            split >= VEC ? VEC : split, gr, s_d, s_dx);
    }
  } else {
    ChannelWalk w((sh.u0 + threadIdx.x) * VEC, blockDim.x * VEC, p.hw);
    for (int c0 = 0, i = 0; c0 < nunits; c0 += p.chunk_units, ++i) {
      mbar_wait(&bars[i]);
      const int end = min(c0 + p.chunk_units, nunits);
      for (int u = c0 + threadIdx.x; u < end; u += blockDim.x, w.next()) {
        const int lc = w.c - sh.c_first, split = w.split();
        const float2 t0 = table[lc];
        float xf[VEC], df[VEC], g[VEC];
        V::unpack(xv[u], xf);
        V::unpack(dyv[u], df);
        if (split >= VEC)
          bwd_vector<VEC, SILU>(xf, df, mean, rstd, t0, t0, VEC, g, s_d, s_dx);
        else
          bwd_vector<VEC, SILU>(xf, df, mean, rstd, t0, table[lc + 1], split, g, s_d,
                                s_dx);
#pragma unroll
        for (int j = 0; j < VEC / 4; ++j)
          dxh[j * plane + u] = make_float4(g[4 * j], g[4 * j + 1], g[4 * j + 2],
                                           g[4 * j + 3]);
      }
    }
  }
  float2 sums = block_sum2(s_d, s_dx, sc);
  if (p.cluster > 1) {
    if (threadIdx.x == 0) sc->part_sums = sums;
    cluster_arrive();
    cluster_wait();
    gather_ranks(&sc->part_sums, p.cluster, make_float2(0.f, 0.f), &sc->total_sums,
                 [](float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); });
    cluster_arrive();
    __syncthreads();
    sums = sc->total_sums;
  }
  const float inv = 1.f / static_cast<float>(p.units * VEC);
  const float m1 = sums.x * inv, m2 = sums.y * inv;

  // pass 2: dx = rstd * (dxh - m1 - xh * m2) from shared memory, as
  // rstd * dxh + b * (x - mean) + c
  const float b = -rstd * rstd * m2, c = -rstd * m1;
  uint4* dx = reinterpret_cast<uint4*>(static_cast<uint8_t*>(p.dx) + base);
  for (int u = threadIdx.x; u < nunits; u += blockDim.x) {
    float xf[VEC];
    V::unpack(in_regs ? mx : xv[u], xf);
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) {
      const float4 g = in_regs ? make_float4(gr[4 * j], gr[4 * j + 1], gr[4 * j + 2],
                                             gr[4 * j + 3])
                               : dxh[j * plane + u];
      xf[4 * j] = rstd * g.x + (b * (xf[4 * j] - mean) + c);
      xf[4 * j + 1] = rstd * g.y + (b * (xf[4 * j + 1] - mean) + c);
      xf[4 * j + 2] = rstd * g.z + (b * (xf[4 * j + 2] - mean) + c);
      xf[4 * j + 3] = rstd * g.w + (b * (xf[4 * j + 3] - mean) + c);
    }
    dx[u] = V::pack(xf);
  }
  if (p.cluster > 1) cluster_wait();
  if (p.dgamma == nullptr) return;

  // dgamma / dbeta partials, one warp per channel of the share, from shared
  // memory (the register path puts its units there first); then one writer
  // per (n, c): rank 0 adds the ranks' partials of a channel in rank order
  if (in_regs) {
    if (has_unit) {
      reinterpret_cast<uint4*>(xs)[threadIdx.x] = mx;
      reinterpret_cast<uint4*>(dys)[threadIdx.x] = md;
    }
    __syncthreads();
  }
  float2* part = table + p.nch_cap;  // the same offset in every rank
  const T* xe = reinterpret_cast<const T*>(xs);
  const T* de = reinterpret_cast<const T*>(dys);
  const int e0 = sh.u0 * VEC, e1 = sh.u1 * VEC;
  const int lane = threadIdx.x % 32;
  for (int lc = threadIdx.x / 32; lc < sh.nch; lc += blockDim.x / 32) {
    const int c = sh.c_first + lc;
    const int lo = max(c * p.hw, e0) - e0, hi = min((c + 1) * p.hw, e1) - e0;
    const float2 t = table[lc];
    float a = 0.f, b = 0.f;
    for (int i = lo + lane; i < hi; i += 32) {
      float xh, dz;
      grad_at<SILU>(V::at(xe, i), V::at(de, i), mean, rstd, t.x, t.y, xh, dz);
      a += dz * xh;
      b += dz;
    }
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      b += __shfl_down_sync(0xffffffffu, b, off);
    }
    if (lane == 0) part[lc] = make_float2(a, b);
  }
  float* dg = p.dgamma + static_cast<long long>(sh.ng) * p.cg;  // n * C + g * cg
  float* db = p.dbeta + static_cast<long long>(sh.ng) * p.cg;
  if (p.cluster == 1) {
    __syncthreads();
    for (int c = threadIdx.x; c < p.cg; c += blockDim.x) {
      dg[c] = part[c].x;
      db[c] = part[c].y;
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();
  cluster_wait();
  if (sh.rank == 0) {
    for (int c = threadIdx.x; c < p.cg; c += blockDim.x) {
      float a = 0.f, b = 0.f;
      for (int r = 0; r < p.cluster; ++r) {
        const int ru0 = static_cast<int>(static_cast<long long>(r) * p.units / p.cluster);
        const int ru1 = static_cast<int>(static_cast<long long>(r + 1) * p.units / p.cluster);
        const int cf = ru0 * VEC / p.hw, cl = (ru1 * VEC - 1) / p.hw;
        if (c < cf || c > cl) continue;
        const float2 o = *cluster.map_shared_rank(&part[c - cf], r);
        a += o.x;
        b += o.y;
      }
      dg[c] = a;
      db[c] = b;
    }
  }
  cluster_arrive();
  cluster_wait();
}

// -- the plan -----------------------------------------------------------------------

// The geometry a plan implies; ops/groupnorm.py::gn_plan computes the same.
struct Geometry {
  int units;  // 16-byte units of a slab
  int chunk_units;
  int table_bytes;
  int share_bytes;  // bytes of one tensor's share: the most one CTA holds
  int nch_cap;      // channels a share may touch
};

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

// 0 or a kErr* code
int check_plan(bool bwd, int item, int C, int G, int HW, int cluster, int threads,
               int chunk_bytes, int smem_bytes, Geometry* geo) {
  if (C <= 0 || G <= 0 || HW <= 0 || C % G != 0) return kErrLayout;
  const int vec = 16 / item;
  const long long slab = static_cast<long long>(C / G) * HW;
  if (slab * item % 16 != 0 || HW < vec || slab > (1LL << 30)) return kErrLayout;
  const long long units = slab * item / 16;
  if ((cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) || cluster > units)
    return kErrCluster;
  if (threads != 64 && threads != 128 && threads != 256) return kErrThreads;
  if (chunk_bytes <= 0 || chunk_bytes % 16 != 0 || (chunk_bytes / 16) % threads != 0)
    return kErrChunk;
  const int share_units = static_cast<int>((units + cluster - 1) / cluster);
  const int chunk_units = chunk_bytes / 16;
  if ((share_units + chunk_units - 1) / chunk_units > kMaxChunks) return kErrChunk;
  const long long share_elems = static_cast<long long>(share_units) * vec;
  const long long nch = std::min(static_cast<long long>(C / G), (share_elems + HW - 1) / HW + 1);
  const long long table = (nch * (bwd ? 2 : 1) * 8 + 15) / 16 * 16;
  // K5 also keeps dxh in fp32: 4 bytes an element
  const long long need = kHeaderBytes + table +
                         static_cast<long long>(share_units) * (bwd ? 32 + 4 * vec : 16);
  if (need > kMaxSmem || smem_bytes < need || smem_bytes > kMaxSmem) return kErrSmem;
  *geo = Geometry{static_cast<int>(units), chunk_units, static_cast<int>(table),
                  share_units * 16, static_cast<int>(nch)};
  return 0;
}

// Let `fn` take up to 227 KB of dynamic shared memory and prefer the
// largest shared-memory carveout (the kernels barely use L1), once per kernel.
cudaError_t allow_smem(const void* fn) {
  static const void* done[16];
  static int n_done = 0;
  for (int i = 0; i < n_done; ++i)
    if (done[i] == fn) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err == cudaSuccess && n_done < 16) done[n_done++] = fn;
  return err;
}

template <typename Params>
cudaError_t launch(void (*kernel)(Params), const Params& p, long long n_slabs,
                   int cluster, int threads, int smem_bytes, cudaStream_t s) {
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_slabs * cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // a CTA alone needs no cluster launch
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

// the kernel of (dtype, param dtype); dtype codes 0 = float32, 1 = float16,
// 2 = bfloat16, the parameters' dtype float32 or x's own
#define T2V_GN_CASE(KERNEL, PARAMS, T, P)                                   \
  {                                                                           \
    void (*f)(PARAMS) = KERNEL<T, P, true>;                                   \
    if (!silu) f = KERNEL<T, P, false>;                                       \
    return reinterpret_cast<void*>(f);                                        \
  }
#define T2V_GN_PICK(KERNEL, PARAMS)                                            \
  do {                                                                         \
    if (param_dtype != 0 && param_dtype != dtype) return nullptr;              \
    switch (dtype * 3 + (param_dtype == 0 ? 0 : 1)) {                          \
      case 0: T2V_GN_CASE(KERNEL, PARAMS, float, float)                        \
      case 3: T2V_GN_CASE(KERNEL, PARAMS, __half, float)                       \
      case 4: T2V_GN_CASE(KERNEL, PARAMS, __half, __half)                      \
      case 6: T2V_GN_CASE(KERNEL, PARAMS, __nv_bfloat16, float)                \
      case 7: T2V_GN_CASE(KERNEL, PARAMS, __nv_bfloat16, __nv_bfloat16)        \
      default: return nullptr;                                                 \
    }                                                                          \
  } while (0)

void* fwd_kernel(int dtype, int param_dtype, bool silu) {
  T2V_GN_PICK(gn_silu_fwd_sm90_kernel, FwdParams);
}
void* bwd_kernel(int dtype, int param_dtype, bool silu) {
  T2V_GN_PICK(gn_silu_bwd_sm90_kernel, BwdParams);
}

int item_size(int dtype) { return dtype == 0 ? 4 : (dtype == 1 || dtype == 2) ? 2 : 0; }

}  // namespace

// x, y: (N, C, HW) contiguous in dtype, 16-byte aligned; gamma, beta: (C,) in
// param_dtype; mean, rstd: (N, G) fp32 out.  (cluster, threads, chunk_bytes,
// smem_bytes) is gn_plan's plan; a plan the kernel cannot run returns a
// negative code (t2v_group_norm_sm90_error_string).  Returns 0 on success or
// the CUDA error of the launch.
extern "C" int t2v_group_norm_silu_fwd_sm90(int dtype, int param_dtype, const void* x,
                                            const void* gamma, const void* beta, void* y,
                                            float* mean, float* rstd, int N, int C, int G,
                                            int HW, float eps, int silu, int cluster,
                                            int threads, int chunk_bytes, int smem_bytes,
                                            void* stream) {
  const int item = item_size(dtype);
  void* fn = fwd_kernel(dtype, param_dtype, silu != 0);
  if (item == 0 || fn == nullptr) return kErrDtype;
  if (N <= 0 || !aligned16(x) || !aligned16(y)) return kErrLayout;
  Geometry geo;
  const int bad = check_plan(false, item, C, G, HW, cluster, threads, chunk_bytes,
                             smem_bytes, &geo);
  if (bad != 0) return bad;
  const long long n_slabs = static_cast<long long>(N) * G;
  if (n_slabs * cluster > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  FwdParams p{x, gamma, beta, y, mean, rstd, G, C / G, HW, geo.units, cluster,
              geo.chunk_units, geo.table_bytes, eps};
  return static_cast<int>(launch(reinterpret_cast<void (*)(FwdParams)>(fn), p, n_slabs,
                                 cluster, threads, smem_bytes,
                                 static_cast<cudaStream_t>(stream)));
}

// dy, dx like x; dgamma / dbeta: (N, C) fp32 partials, or both null to skip
// them.
extern "C" int t2v_group_norm_silu_bwd_sm90(int dtype, int param_dtype, const void* x,
                                            const void* gamma, const void* beta,
                                            const float* mean, const float* rstd,
                                            const void* dy, void* dx, float* dgamma,
                                            float* dbeta, int N, int C, int G, int HW,
                                            int silu, int cluster, int threads,
                                            int chunk_bytes, int smem_bytes, void* stream) {
  const int item = item_size(dtype);
  void* fn = bwd_kernel(dtype, param_dtype, silu != 0);
  if (item == 0 || fn == nullptr) return kErrDtype;
  if (N <= 0 || !aligned16(x) || !aligned16(dy) || !aligned16(dx) ||
      (dgamma == nullptr) != (dbeta == nullptr))
    return kErrLayout;
  Geometry geo;
  const int bad = check_plan(true, item, C, G, HW, cluster, threads, chunk_bytes,
                             smem_bytes, &geo);
  if (bad != 0) return bad;
  const long long n_slabs = static_cast<long long>(N) * G;
  if (n_slabs * cluster > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  BwdParams p{x, gamma, beta, mean, rstd, dy, dx, dgamma, dbeta, G, C / G, HW,
              geo.units, cluster, geo.chunk_units, geo.table_bytes, geo.share_bytes, geo.nch_cap};
  return static_cast<int>(launch(reinterpret_cast<void (*)(BwdParams)>(fn), p, n_slabs,
                                 cluster, threads, smem_bytes,
                                 static_cast<cudaStream_t>(stream)));
}

// How many clusters of a plan the card holds at once
// (cudaOccupancyMaxActiveClusters), into *clusters; `bwd` picks K5.
extern "C" int t2v_group_norm_sm90_max_active_clusters(int bwd, int dtype, int param_dtype,
                                                       int cluster, int threads,
                                                       int smem_bytes, int* clusters) {
  void* fn = bwd ? bwd_kernel(dtype, param_dtype, true) : fwd_kernel(dtype, param_dtype, true);
  if (fn == nullptr) return kErrDtype;
  const cudaError_t err = allow_smem(fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster * 132));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, fn, &cfg));
}

extern "C" const char* t2v_group_norm_sm90_error_string(int err) {
  switch (err) {
    case kErrLayout:
      return "sm90 GroupNorm: the slab is not whole 16-byte units, H*W is below the "
             "vector width, a pointer is not 16-byte aligned, or the shape is bad";
    case kErrCluster: return "sm90 GroupNorm plan refused: cluster size not 1/2/4/8 "
                             "or above the slab's 16-byte units";
    case kErrThreads: return "sm90 GroupNorm plan refused: threads not 64/128/256";
    case kErrChunk: return "sm90 GroupNorm plan refused: chunk bytes not a multiple of "
                           "16 * threads, or more than 64 chunks";
    case kErrSmem: return "sm90 GroupNorm plan refused: shared bytes below what the "
                          "layout needs or above 232448";
    case kErrDtype: return "sm90 GroupNorm: unsupported dtype pair";
    default: return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}
