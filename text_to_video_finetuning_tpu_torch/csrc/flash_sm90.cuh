// Shared pieces of the Hopper (sm_90a) flash-attention kernels
// flash_attn_fwd_sm90.cu (K1), flash_attn_dkv_sm90.cu (K2) and
// flash_attn_dq_sm90.cu (K3): the CTA geometry, TMA tensor maps over BSHD
// tensors, mbarriers, wgmma descriptors and instructions, and the
// register-fragment helpers.
//
// Geometry.  A CTA owns 128 rows of one (batch, head) along its own axis --
// query rows in K1 and K3, KV rows in K2: two consumer warpgroups of 64 rows
// each issue the wgmma products and keep their softmax state and
// accumulators in registers; one producer warp issues the TMA loads.
// Head_dim is 64, so one bf16/fp16 row is 128 bytes: exactly the TMA box
// width and the 128-byte swizzle atom that wgmma reads, and an 8-row group
// is 1024 bytes.  Every tile is 1024-byte aligned in shared
// memory so that the swizzle TMA writes is the one wgmma's descriptor names.
//
// Operands in shared memory (all 128-byte swizzled, rows of 128 bytes):
// * K-major (the reduction runs along the 64 head_dim elements of a row):
//   Q and dO as A, K and V as B of S = Q.K^T and dP = dO.V^T (K1, K3); K
//   and V as A, Q and dO as B of the transposed S^T = K.Q^T and dP^T =
//   V.dO^T (K2).  The k-th 16-element slice starts 32 bytes further into
//   the row.
// * MN-major (the reduction runs down the rows): V as B of O += P.V, K as B
//   of dQ += dS.K, dO and Q as B of dV += P^T.dO and dK += dS^T.Q, with the
//   transpose flag.  The k-th 16-row slice starts 16 rows (2048 bytes)
//   further down.
// The descriptor's stride offset is 1024 bytes (the next 8-row group); at
// head_dim 64 no operand spans a second 128-byte column of atoms.
//
// Registers.  The fp32 accumulator of an m64nN wgmma gives thread t of the
// warpgroup, for each 8-column slice i, the values d[4i + 0..1] at row
// 16 * warp + lane / 4 and d[4i + 2..3] eight rows below, at columns
// 8i + 2 * (lane % 4) + 0..1.  The A fragment of a register-sourced wgmma
// has the same shape for each 16-column slice, so a score tile turns into
// the next product's A operand by packing pairs in place (`pack2`).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace t2v_sm90 {

constexpr int kHeadDim = 64;
constexpr int kRowBytes = kHeadDim * 2;  // bf16 / fp16
constexpr int kWgRows = 64;  // rows of one warpgroup on the CTA's own axis
constexpr int kConsumerWarpgroups = 2;
constexpr int kConsumerThreads = 128 * kConsumerWarpgroups;
constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
// rows a CTA owns: query rows in K1 and K3, KV rows in K2
constexpr int kBlockM = kWgRows * kConsumerWarpgroups;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Error codes of the C entry points beyond CUDA's own (which are >= 0).
constexpr int kErrNoEncoder = -1;  // no cuTensorMapEncodeTiled in libcuda
constexpr int kErrTensorMap = -2;  // it refused a map

inline const char* error_string(int err) {
  if (err == kErrNoEncoder)
    return "libcuda does not provide cuTensorMapEncodeTiled";
  if (err == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a BSHD tensor map (strides or "
           "base address not 16-byte aligned?)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// -- host: TMA tensor maps ----------------------------------------------------

// cuTensorMapEncodeTiled lives in libcuda; the library links only the CUDA
// runtime, so the entry point is looked up once at run time.
using EncodeFn = decltype(&cuTensorMapEncodeTiled);

inline EncodeFn encoder() {
  static const EncodeFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeFn>(ptr)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over a BSHD tensor read through its strides (elements): dims
// (D, H, S, B) innermost first, a box of `rows` sequence rows of one (batch,
// head), 128-byte swizzle.  Rows past S read as zeros.
inline int make_bshd_map(CUtensorMap* map, int dtype, const void* ptr, int B,
                         int S, int H, long long sb, long long ss,
                         long long sh, int rows) {
  const EncodeFn encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kHeadDim),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kHeadDim), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// -- device: shared memory, mbarriers, TMA ---------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared-memory base rounded up to 1024 bytes (the launch asks
// for 1024 bytes more than the layout needs).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
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

// Wait until the phase of parity `parity` has completed.  A wait that lasts
// ~10 s of SM clock means a broken pipeline: trap, so that the launch fails
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1LL << 34)) __trap();
}

// TMA: `rows` x 64 elements of (batch, head) starting at sequence row `row`
// into `dst`, completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int head,
                                              int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(0),
      "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// -- device: wgmma ------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand tile at `p` (1024-byte aligned
// tile, rows of 128 bytes): start address, leading and stride byte offsets,
// swizzle mode 1 (128 B).  The stride offset is 1024 bytes (the next 8-row
// group) for both majors.  The leading offset is 16 bytes for a K-major
// operand (the two 8-element halves of a 16-element slice) and, for an
// MN-major one, the step to the next 64-element column of atoms, which a
// 64-wide operand never takes.  Adding n to a descriptor moves its start
// 16 * n bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* p,
                                               uint32_t lead_bytes) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(lead_bytes >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  return sw128_desc(p, 16);
}
__device__ __forceinline__ uint64_t mnmajor_desc(const void* p) {
  return sw128_desc(p, 1024);
}
constexpr uint64_t kDescKStep = 32 >> 4;                // 16 elements along a row
constexpr uint64_t kDescRowStep = (16 * kRowBytes) >> 4;  // 16 rows down

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of a register across the
// asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// A register-sourced wgmma reads its A fragments asynchronously: fencing
// them after the wait keeps their registers from being reused before it.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

// d[64] (+)= A(64x16, shared, K-major) . B(16x128, shared, K-major)
#define T2V_WGMMA_SS_N128(TY)                                                 \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
      "%57, %58, %59, %60, %61, %62, %63}, "                                  \
      "%64, %65, p, 1, 1, 0, 0;\n}\n"                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),      \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),      \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),      \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),      \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),      \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),      \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "l"(da), "l"(db), "r"(scale_d))

// d[32] (+)= A(64x16, shared, K-major) . B(16x64, shared, K-major)
#define T2V_WGMMA_SS_N64(TY)                                                  \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
      "%29, %30, %31}, "                                                      \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31])                                              \
      : "l"(da), "l"(db), "r"(scale_d))

// d[32] (+)= A(64x16, registers) . B(16x64, shared, MN-major: transposed)
#define T2V_WGMMA_RS_N64_T(TY)                                                \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
      "%29, %30, %31}, "                                                      \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31])                                              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

// scale_d = 0 overwrites d, 1 accumulates into it.
template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  if constexpr (kIsBf16<T>) {
    T2V_WGMMA_SS_N128("bf16");
  } else {
    T2V_WGMMA_SS_N128("f16");
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (kIsBf16<T>) {
    T2V_WGMMA_SS_N64("bf16");
  } else {
    T2V_WGMMA_SS_N64("f16");
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_rs_n64_t(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  if constexpr (kIsBf16<T>) {
    T2V_WGMMA_RS_N64_T("bf16");
  } else {
    T2V_WGMMA_RS_N64_T("f16");
  }
}

#undef T2V_WGMMA_SS_N128
#undef T2V_WGMMA_SS_N64
#undef T2V_WGMMA_RS_N64_T

// -- device: register fragments ---------------------------------------------

// Two fp32 values rounded to T and packed low-first into one register.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  if constexpr (kIsBf16<T>) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&v);
  }
  return r;
}

// The A fragments of a register-sourced wgmma over the K = 4 * N columns of
// an m64nN accumulator: slice kk holds columns 16kk .. 16kk + 15.
template <typename T, int N>
__device__ __forceinline__ void to_a_fragments(const float (&acc)[N],
                                               uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    a[kk][0] = pack2<T>(acc[8 * kk + 0], acc[8 * kk + 1]);
    a[kk][1] = pack2<T>(acc[8 * kk + 2], acc[8 * kk + 3]);
    a[kk][2] = pack2<T>(acc[8 * kk + 4], acc[8 * kk + 5]);
    a[kk][3] = pack2<T>(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}

// Store this thread's rows of an m64n64 fp32 accumulator times `mul0` /
// `mul1` (its upper and lower row) as T, through the output's sequence
// stride; rows >= n are not written.
template <typename T>
__device__ __forceinline__ void store_rows(T* out, long long row_stride,
                                           int row0, int n, int col,
                                           const float (&acc)[32], float mul0,
                                           float mul1) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= n) continue;
    const float mul = half ? mul1 : mul0;
    T* dst = out + static_cast<long long>(row) * row_stride + col;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<uint32_t*>(dst + 8 * i) = pack2<T>(
          acc[4 * i + 2 * half] * mul, acc[4 * i + 2 * half + 1] * mul);
  }
}

}  // namespace t2v_sm90
