// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_fwd.cuh, flash_bwd.cuh): mbarriers, TMA tile and cp.async
// copies and their tensor maps, and warpgroup matrix products (wgmma) with
// bf16 operands and fp32 accumulators. The BIAS tile's staging is
// philox.cuh's.
//
// Shared-memory tiles are TMA boxes of 64 bf16 columns (128 bytes) by some
// rows, 128-byte swizzled, each starting on 1024 bytes (the swizzle's
// repeat); a d = 128 operand is two such 64-column halves placed one after
// the other. Two operand forms read them:
//   * K-major (`gemm_ss`): the tile's rows are the product's M or N index
//     and its columns the reduction index, as Q and K are in Q.K^T;
//   * MN-major (`gemm_rs`, B only, with the transpose bit): the tile's rows
//     are the reduction index and its columns N, as V is in P.V.
// An accumulator fragment of a 64 x N product holds, in thread (warp w of
// the warpgroup, lane l), rows 16w + l/4 and +8 and columns 8j + 2(l%4) +
// {0,1} as d[4j + 2hr + e]; rounded to bf16 pairs, chunk c of 16 columns
// (d[8c .. 8c+7]) is the register A fragment of a product that reduces
// over those columns, so P and dS never go through shared memory.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {
namespace sm90 {

constexpr int ROWB = 128;           // bytes of one swizzled 64-column row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after `raw` (dynamic shared memory
// holds 1 KB of slack for it)
__device__ __forceinline__ uint8_t* align1024(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the phase of parity `parity`; trap after
// ~2^26 polls (a second or more) rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// one 4-byte asynchronous copy from device to shared memory
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src)
               : "memory");
}

// an arrival on `bar` once this thread's earlier cp.async copies have
// landed, counted against the barrier's expected arrivals (noinc)
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (K-major: unused, 16; MN-major: the next 64-column atom) and
// stride byte offset (the next group of 8 rows: 1024), all >> 4.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// an accumulator is read only after its wgmma group completed: tie every
// register to this point so the compiler cannot move a read above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, fp32) (+)= A (64 x 16, smem) . B (16 x 128, smem), both
// operands K-major (no transpose); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 in registers) . B (16 x 64,
// smem, MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 in registers) . B (16 x 128,
// smem, MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) (+)= A (64 x 16, smem) . B (16 x 64, smem), both
// operands K-major (no transpose); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64)
    wgmma_ss_n64(d, da, db, scale_d);
  else
    wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

// D (64 x N) = A (64 x K) . B^T (N x K), fp32, with A and B K-major tiles
// in shared memory whose 64-column halves hold AROWS and BROWS rows (the
// warpgroup's 64 rows of A start at `a`); K / 16 steps, the first
// overwriting D. Issued, not committed.
template <int K, int N, int AROWS, int BROWS>
__device__ __forceinline__ void gemm_ss(float (&d)[N / 2], uint32_t a,
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss<N>(d, desc(a + (kk >> 2) * AROWS * ROWB + off, 16, 1024),
                desc(b + (kk >> 2) * BROWS * ROWB + off, 16, 1024), kk > 0);
  }
}

// D (64 x N) += A (64 x K) . B (K x N), fp32, with A as bf16 register
// fragments (one per 16-wide chunk of K) and B an MN-major tile of K rows
// in shared memory. Issued, not committed.
template <int N, int K>
__device__ __forceinline__ void gemm_rs(float (&d)[N / 2],
                                        const uint32_t (&a)[K / 16][4],
                                        uint32_t b) {
#pragma unroll
  for (int c = 0; c < K / 16; ++c)
    wgmma_rs<N>(d, a[c], desc(b + c * 16 * ROWB, K * ROWB, 1024));
}

// an accumulator fragment (64 x K per warpgroup) rounded to bf16 as the
// register A operand of a product that reduces over its K columns
template <int K>
__device__ __forceinline__ void to_a_frags(const float (&s)[K / 2],
                                           uint32_t (&a)[K / 16][4]) {
#pragma unroll
  for (int c = 0; c < K / 16; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[c][r] = pack_bf16(s[8 * c + 2 * r], s[8 * c + 2 * r + 1]);
}

// Segment ids: a CTA keeps a 1024-bit set of its own rows' (B, S) int32
// ids, hashed by their low 10 bits, in BLOOM words of shared memory, and
// skips a tile of the other side when none of the tile's ids is in the
// set. A miss proves that no pair of the tile shares a segment; a hash
// collision only costs a tile that the masks then zero, so the skip is
// exact for any int32 ids.
constexpr int BLOOM = 32;

__device__ __forceinline__ bool in_set(const uint32_t* bloom, int id) {
  return (bloom[(id >> 5) & (BLOOM - 1)] >> (id & 31)) & 1u;
}

// adds the (B, S) ids of rows r0 .. r0 + N - 1 (those below S) to the
// set; one warp, N a multiple of 32
template <int N>
__device__ __forceinline__ void fill_set(uint32_t* bloom, const int* seg,
                                         int b, int r0, int S, int lane) {
#pragma unroll
  for (int i = 0; i < N / 32; ++i) {
    const int row = r0 + lane + 32 * i;
    if (row < S) {
      const int id = seg[(size_t)b * S + row];
      atomicOr(&bloom[(id >> 5) & (BLOOM - 1)], 1u << (id & 31));
    }
  }
  __syncwarp();
}

// the ids of rows r0 .. r0 + N - 1 (INT_MIN past S) into `ids`; whether
// any of them is in the set (the warp's vote)
template <int N>
__device__ __forceinline__ bool tile_hits(int (&ids)[N / 32],
                                          const uint32_t* bloom,
                                          const int* seg, int b, int r0,
                                          int S, int lane) {
  bool hit = false;
#pragma unroll
  for (int i = 0; i < N / 32; ++i) {
    const int row = r0 + lane + 32 * i;
    ids[i] = row < S ? seg[(size_t)b * S + row] : INT_MIN;
    hit |= row < S && in_set(bloom, ids[i]);
  }
  return __any_sync(0xffffffffu, hit);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over one bf16 operand: {width columns, S rows `rs` elements
// apart, batch}, box {64, rows, 1}, 128-byte swizzle, out-of-bounds rows
// read as zeros. TMA needs a 16-byte-aligned base and 16-byte strides.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int width,
                            int S, int batch, int rs, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || ((size_t)rs * 2) % 16)
    return cudaErrorMisalignedAddress;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)S,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)rs * 2,
                                 (cuuint64_t)rs * 2 * (cuuint64_t)S};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace
