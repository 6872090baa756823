// Flash attention forward for Hopper, sm_90a: two bodies, chosen by dtype,
// behind two entry points.
//
//   K-PACK `flash_attention_fwd_packed` replaces the Pallas TPU kernel
//          paddle_tpu/ops/pallas/flash_attention_packed.py `_fwd_kernel`
//          (launched by `_fwd_call`): causal or full attention over the
//          packed (B, S, NH*D) layout, the training forward. Full attention
//          takes Sq != Sk (ring attention's off-diagonal blocks); causal
//          needs Sq == Sk.
//   K-SEG  `flash_attention_fwd_packed_seg` replaces
//          paddle_tpu/ops/pallas/flash_attention_packed.py `_fwd_kernel_seg`
//          (launched by `_fwd_call_seg`): causal attention over the same
//          layout where a pair is visible only when its query and key carry
//          the same (B, S) int32 segment id (pad id -1 attends only to pad);
//          serving's `prefill_packed` and the packed-sequence trainer.
//   K-BSHD replaces paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel`
//          (launched by `_flash_call`): causal attention over (B, S, H, D),
//          serving's `prefill_batch` and the nn-API forward. A (B, S, H, D)
//          tensor whose last two dims are dense is (B, S, H*D) with a row
//          stride, so K-BSHD is the K-PACK entry and the TPU's (B*H, S, D)
//          transpose is not needed.
//
// q, k and v are read in place with a row stride each (3*NH*D for column
// slices of the fused qkv and for the `unbind` views of (B, S, 3, H, D)); a
// batch is its rows back to back. All entries write a dense `o`
// (B, Sq, H*D) in q's dtype and a natural-log `lse` (B, Sq, H) fp32,
// lse = (m + log2 l) / log2 e with m in log2 units; a row that sees no key
// writes o = 0.
//
// What bounds it on the H100: ~4*d FLOPs per visible (query, key) pair
// (two products of 2*d each) against 2-byte q, k, v, o read or written
// once. At the training shape (8, 1024, 16*64), causal: 17.2 GFLOP against
// 67.6 MB, ~254 FLOP/byte, just under the bf16 ridge of 989 TFLOP/s /
// 3.35 TB/s = ~295: the two bounds are within 15% of each other (0.0174 ms
// of tensor-core time, 0.0202 ms of bytes), and the FLOPs grow with S while
// the bytes do not. So the products have to run on the tensor cores (989
// TFLOP/s bf16, against 67 on the CUDA cores in fp32) to get near either
// bound. Beside them, the softmax's exp2 runs on the SFUs at 16 per clock
// per SM: a 128 x 128 tile's 16,384 exponentials take ~1,024 clocks, as
// long as its two d = 64 products on the tensor cores (4.2 MFLOP at ~4,096
// FLOP per clock per SM), so the two consumer warpgroups of a CTA
// alternate: one's exponentials overlap the other's products.
//
// bf16 (`flash_fwd_kernel_sm90`, the Hopper body):
//   * one CTA per (128-row q-block, head, batch), the heaviest causal
//     q-blocks launched first; 288 threads: two consumer warpgroups of 64
//     query rows each, and one producer warp;
//   * both products on the tensor cores: S = Q.K^T is wgmma m64nBKk16
//     (BK = 128 keys at d = 64, 64 at d = 128) with Q and K K-major in
//     shared memory; O += P.V is wgmma m64nDk16 with P as the register A
//     operand -- S's fp32 accumulator, rounded to bf16 pairs, already has
//     the A-fragment layout for each 16-key chunk, so P never goes through
//     shared memory -- and V the shared-memory B operand with the transpose
//     bit (V's rows are keys). A warpgroup waits for each product before
//     the next step; its exponentials overlap the other warpgroup's
//     products, not its own;
//   * asynchronous copies: the producer warp loads Q once and K/V tiles
//     through a 2-stage ring by TMA (3-D tensor maps {H*D columns, S rows
//     at the row stride, B}, box {64, BK, 1}, 128-byte swizzle, encoded on
//     the host per launch), each stage with an mbarrier that the copy
//     completes (full) and one the consumers release (empty), so tile j+1
//     arrives while tile j is multiplied. Rows past S are zero-filled by
//     the hardware and never cross into the next batch. d = 128 is two
//     64-column boxes per tile, placed one after the other. The producer
//     hands each stage's tile index (and key ids) to the consumers beside
//     the data, and an index of -1 ends the loop;
//   * online softmax in registers on the accumulator fragment (warp w of a
//     warpgroup holds rows 16w + lane/4 and +8, columns 8j + 2(lane%4) +
//     {0,1}): scale * log2 e applied to S in fp32, masks applied
//     elementwise only on tiles that need them (the causal diagonal, the
//     ragged tail key < Sk, segment equality), row max and sum over the
//     quad by shuffles, p = 0 on every masked entry so a fully masked tile
//     adds nothing while m is still the -1e30 sentinel;
//   * causal k-tiles above the diagonal are never visited; with segment
//     ids the producer skips a k-tile before loading it when no key of the
//     tile has an id that any row of the q-block has (a 1024-bit set of
//     the q-block's ids, hashed by their low 10 bits, built once per CTA):
//     a miss proves that no pair shares a segment, a hash collision only
//     costs a tile that the mask then zeroes, so the result is exact for
//     any int32 ids;
//   * a wait on an mbarrier that never completes traps after ~2^26 polls
//     (seconds), so a fault shows as a launch failure, not a hung card.
// Tried and measured on the card (see PERF.md), not kept: 3 or 4 ring
// stages; overlapping a warpgroup's softmax with its own previous P.V
// (needs ~190 registers at d = 128, and ptxas held the consumers to the
// launch's 168 even after `setmaxnreg`); one consumer warpgroup per CTA
// with two CTAs per SM (128 registers: spills). None was faster.
// `-Xptxas -v` (nvcc 12.9, sm_90a): 154 registers (K-PACK) and 168 (K-SEG)
// at d = 64, 138 and 147 at d = 128, 0 bytes of spill in all four; the
// launch caps 288 threads at 168. Dynamic shared memory per CTA: 84,144
// bytes at d = 64 and 100,016 at d = 128 (1 KB of it alignment slack).
//
// fp32 (`flash_fwd_kernel`, the CUDA-core body): the port's correctness
// mode, held to the CPU at 1e-4 on the card; TF32 wgmma keeps ~3 decimal
// digits and would not meet that. 64 x 64 fp32 tiles in shared memory (rows
// padded by one word), 256 threads each computing a 4 x 4 block of scores
// and a 4 x d/16 block of the output, scale * log2 e folded into Q, k-tiles
// with no shared segment skipped by a block vote. The dtype picks the body;
// a bf16 call never reaches it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;

// -- fp32: the CUDA-core body ------------------------------------------------

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

template <int D> __host__ __device__ constexpr int q_pitch() { return D + 1; }
template <int D> __host__ __device__ constexpr int k_pitch() { return D + 1; }
__host__ __device__ constexpr int p_pitch() { return BK + 1; }

template <int D> constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * q_pitch<D>() + (size_t)BK * k_pitch<D>() +
                          (size_t)BK * D + (size_t)BQ * p_pitch()) +
         sizeof(int) * (BQ + BK);
}

// q, k, v rows are `qs`, `ks`, `vs` elements apart and a batch is its
// rows back to back; o is dense. SEG needs Sq == Sk.
template <int D, bool SEG>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ seg,
                 float* __restrict__ o, float* __restrict__ lse, int Sq,
                 int Sk, int H, int qs, int ks, int vs, float scale2,
                 int causal) {
  constexpr int QP = q_pitch<D>();
  constexpr int KP = k_pitch<D>();
  constexpr int PP = p_pitch();
  constexpr int DC = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QP;
  float* Vs = Ks + BK * KP;
  float* Ps = Vs + BK * D;
  int* segq = reinterpret_cast<int*>(Ps + BQ * PP);
  int* segk = segq + BQ;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;       // 16 row groups of 4 rows
  const int tx = tid & 15;       // 16 column lanes
  const int nqb = (Sq + BQ - 1) / BQ;
  const int qb = nqb - 1 - (int)blockIdx.x;   // heavy causal blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qb * BQ;
  const size_t os = (size_t)H * D;            // o's row stride, elements
  const float* qp = q + (size_t)b * Sq * qs + (size_t)h * D;
  const float* kp = k + (size_t)b * Sk * ks + (size_t)h * D;
  const float* vp = v + (size_t)b * Sk * vs + (size_t)h * D;
  float* op = o + (size_t)b * Sq * os + (size_t)h * D;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int row = q0 + r;
    Qs[r * QP + c] =
        row < Sq ? qp[(size_t)row * qs + c] * scale2 : 0.f;
  }
  if (SEG && tid < BQ)
    segq[tid] = (q0 + tid < Sq) ? seg[(size_t)b * Sq + q0 + tid] : INT_MIN;
  __syncthreads();

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int kend = causal ? min(Sk, q0 + BQ) : Sk;
  const int nkb = (kend + BK - 1) / BK;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    if (SEG) {
      if (tid < BK)
        segk[tid] = (k0 + tid < Sk) ? seg[(size_t)b * Sk + k0 + tid] : INT_MIN;
      __syncthreads();
      int any = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kc = tx + 16 * c;
          const int row = q0 + r, key = k0 + kc;
          any |= (row < Sq && key < Sk && (!causal || key <= row) &&
                  segq[r] == segk[kc]);
        }
      }
      if (!__syncthreads_or(any)) continue;   // no pair shares a segment
    }
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      const int key = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < Sk) {
        kv = kp[(size_t)key * ks + c];
        vv = vp[(size_t)key * vs + c];
      }
      Ks[r * KP + c] = kv;
      Vs[r * D + c] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * QP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) bk[c] = Ks[(tx + 16 * c) * KP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(a[i], bk[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int row = q0 + r;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kc = tx + 16 * c;
        const int key = k0 + kc;
        ok[c] = row < Sq && key < Sk && (!causal || key <= row) &&
                (!SEG || segq[r] == segk[kc]);
        s[i][c] = ok[c] ? s[i][c] : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)     // the row's 16 lanes
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = exp2f(m_i[i] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? exp2f(s[i][c] - m_new) : 0.f;
        Ps[r * PP + tx + 16 * c] = p;
        ls += p;
      }
      l_i[i] = l_i[i] * corr + ls;     // this lane's share of the row sum
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
      m_i[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * PP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
    __syncthreads();     // the next tile overwrites K, V, P and segk
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_i[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    const int row = q0 + ty * 4 + i;
    const float l_safe = l == 0.f ? 1.f : l;
    if (row < Sq) {
      float* orow = op + (size_t)row * os;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        orow[tx + 16 * c] = acc[i][c] / l_safe;
      if (tx == 0)
        lse[((size_t)b * Sq + row) * H + h] =
            (m_i[i] + log2f(l_safe)) / kLog2e;
    }
  }
}

template <int D, bool SEG>
cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                        const void* seg, void* o, void* lse, int batch,
                        int Sq, int Sk, int H, int qs, int ks, int vs,
                        float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, batch);
  flash_fwd_kernel<D, SEG><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(seg),
      static_cast<float*>(o), static_cast<float*>(lse), Sq, Sk, H, qs, ks,
      vs, scale * kLog2e, causal);
  return cudaGetLastError();
}

// -- bf16: the Hopper body ---------------------------------------------------

namespace sm90 {

constexpr int BQ = 128;             // query rows per CTA
constexpr int STAGES = 2;           // K/V ring depth
constexpr int NCONS = 256;          // two consumer warpgroups, 64 rows each
constexpr int NT = NCONS + 32;      // and one producer warp
constexpr int ROWB = 128;           // bytes of one swizzled 64-column row
constexpr int BLOOM = 32;           // words of the q-block's id set

// keys per K/V tile: the score fragment is 64 x BK per warpgroup
// (64 x 128 at d = 64; 64 x 64 at d = 128, whose output fragment is twice
// as large, so that a consumer thread's fragments fit in its registers)
template <int D> __host__ __device__ constexpr int bk() {
  return D == 64 ? 128 : 64;
}

// Byte offsets in dynamic shared memory; every tile starts on 1024 bytes,
// the 128-byte swizzle's repeat. d = 128 tiles are two 64-column halves.
template <int D> struct Smem {
  static constexpr int BK = bk<D>();
  static constexpr int q_tile = (D / 64) * BQ * ROWB;
  static constexpr int kv_tile = (D / 64) * BK * ROWB;
  static constexpr int k_off = q_tile;
  static constexpr int v_off = k_off + STAGES * kv_tile;
  // q_full, full[STAGES], empty[STAGES]
  static constexpr int bar_off = v_off + STAGES * kv_tile;
  static constexpr int idx_off = bar_off + 8 * (1 + 2 * STAGES);
  static constexpr int segk_off = idx_off + 4 * STAGES;
  static constexpr int bloom_off = segk_off + 4 * STAGES * BK;
  static constexpr int bytes = bloom_off + 4 * BLOOM + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// S = Q . K^T for one warpgroup's 64 rows and one K tile, started and
// committed (scale_d 0 on the first step overwrites S); D/16 steps of 16
// columns (two 64-column halves at d = 128)
template <int D>
__device__ __forceinline__ void mma_qk(float (&s)[bk<D>() / 2],
                                       uint32_t q_base, uint32_t k_base) {
  constexpr int BK = bk<D>();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss<BK>(s, desc(q_base + (kk >> 2) * BQ * ROWB + off, 16, 1024),
                 desc(k_base + (kk >> 2) * BK * ROWB + off, 16, 1024),
                 kk > 0);
  }
  wgmma_commit();
}

// O += P . V, P the register A operand (one 16-key chunk per step), V
// MN-major (its rows are keys); started and committed
template <int D>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 2],
                                       const uint32_t (&pa)[bk<D>() / 16][4],
                                       uint32_t v_base) {
  constexpr int BK = bk<D>();
#pragma unroll
  for (int c = 0; c < BK / 16; ++c)
    wgmma_rs<D>(acc, pa[c], desc(v_base + c * 16 * ROWB, BK * ROWB, 1024));
  wgmma_commit();
}

template <int D, bool SEG>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const int* __restrict__ seg,
                      __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int Sq, int Sk, int H,
                      float scale2, int causal) {
  using L = Smem<D>;
  constexpr int BK = L::BK;
  constexpr int NO = D / 2;          // output accumulator floats per thread
  constexpr int NS = BK / 2;         // score accumulator floats per thread
  constexpr uint32_t KV_BYTES = 2u * BK * D * 2;   // one K and one V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t q_full = base + L::bar_off;
  auto full = [&](int s) { return q_full + 8 * (1 + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + STAGES + s); };
  volatile int* tile_idx = reinterpret_cast<volatile int*>(smem + L::idx_off);
  int* segk = reinterpret_cast<int*>(smem + L::segk_off);
  uint32_t* bloom = reinterpret_cast<uint32_t*>(smem + L::bloom_off);

  const int tid = threadIdx.x;
  // the warpgroup index, broadcast so the compiler sees it is uniform
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int lane = tid & 31;
  const int nqb = (Sq + BQ - 1) / BQ;
  const int q0 = (nqb - 1 - (int)blockIdx.x) * BQ;   // heavy blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 32);          // the producer warp's lanes
      mbar_init(empty(s), NCONS);      // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (SEG && tid < BLOOM) bloom[tid] = 0;
  __syncthreads();

  if (wg == NCONS / 128) {
    // -- producer warp: Q once, then the K/V ring --
    const int kend = causal ? min(Sk, q0 + BQ) : Sk;
    const int nkb = (kend + BK - 1) / BK;
    if (lane == 0) {
      mbar_arrive_tx(q_full, BQ * D * 2);
#pragma unroll
      for (int hf = 0; hf < D / 64; ++hf)
        tma_load(base + hf * BQ * ROWB, &tq, q_full, h * D + 64 * hf, q0, b);
    }
    if (SEG) {
#pragma unroll
      for (int i = 0; i < BQ / 32; ++i) {
        const int row = q0 + lane + 32 * i;
        if (row < Sq) {
          const int id = seg[(size_t)b * Sq + row];
          atomicOr(&bloom[(id >> 5) & (BLOOM - 1)], 1u << (id & 31));
        }
      }
      __syncwarp();
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int kb = 0; kb < nkb; ++kb) {
      const int k0 = kb * BK;
      int ids[BK / 32];
      if (SEG) {
        bool hit = false;
#pragma unroll
        for (int i = 0; i < BK / 32; ++i) {
          const int key = k0 + lane + 32 * i;
          ids[i] = key < Sk ? seg[(size_t)b * Sk + key] : INT_MIN;
          hit |= key < Sk && ((bloom[(ids[i] >> 5) & (BLOOM - 1)] >>
                               (ids[i] & 31)) & 1u);
        }
        if (!__any_sync(0xffffffffu, hit)) continue;  // no shared segment
      }
      mbar_wait(empty(stage), phase ^ 1);
      if (SEG) {
#pragma unroll
        for (int i = 0; i < BK / 32; ++i)
          segk[stage * BK + lane + 32 * i] = ids[i];
      }
      if (lane == 0) {
        tile_idx[stage] = kb;
        mbar_arrive_tx(full(stage), KV_BYTES);
#pragma unroll
        for (int hf = 0; hf < D / 64; ++hf) {
          const int c0 = h * D + 64 * hf;
          const uint32_t dst = stage * L::kv_tile + hf * BK * ROWB;
          tma_load(base + L::k_off + dst, &tk, full(stage), c0, k0, b);
          tma_load(base + L::v_off + dst, &tv, full(stage), c0, k0, b);
        }
      } else {
        mbar_arrive(full(stage));
      }
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    mbar_wait(empty(stage), phase ^ 1);   // the end marker
    if (lane == 0) tile_idx[stage] = -1;
    mbar_arrive(full(stage));
  } else {
    // -- consumer warpgroups: 64 query rows each --
    const int t = lane & 3;
    const int wg_row0 = q0 + wg * 64;
    const int row0 = wg_row0 + ((tid / 32) & 3) * 16 + (lane >> 2);  // +8
    int sq_id[2] = {0, 0};
    if (SEG) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row0 + 8 * hr;
        sq_id[hr] = row < Sq ? seg[(size_t)b * Sq + row] : INT_MIN;
      }
    }
    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
    const uint32_t q_base = base + wg * 64 * ROWB;

    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      mbar_wait(full(stage), phase);
      const int kb = __shfl_sync(0xffffffffu, tile_idx[stage], 0);
      if (kb < 0) break;
      const int k0 = kb * BK;

      // S = Q . K^T, fp32
      float s[NS];
      wgmma_fence();
      mma_qk<D>(s, q_base, base + L::k_off + stage * L::kv_tile);
      wgmma_wait0();
      fence_regs(s);

      // scale to log2 units; mask only where the tile can hold a masked
      // pair (the causal diagonal, the ragged tail, segment ids)
      if (SEG || k0 + BK > Sk || (causal && k0 + BK - 1 > wg_row0)) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * t + e;
            const int key = k0 + col;
            const int kid = SEG ? segk[stage * BK + col] : 0;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const bool ok = key < Sk && (!causal || key <= row0 + 8 * hr) &&
                              (!SEG || kid == sq_id[hr]);
              float& x = s[4 * j + 2 * hr + e];
              x = ok ? x * scale2 : kNegInf;
            }
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < NS; ++i) s[i] *= scale2;
      }

      // online softmax over the two rows this thread holds (a quad each)
      float corr[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_i[hr], mx);
        corr[hr] = exp2f(m_i[hr] - m_new);
        // with no visible key yet, m is the sentinel: subtract 0 so every
        // (masked) entry still gives exp2(-1e30) = 0
        const float m_use = m_new == kNegInf ? 0.f : m_new;
        float ls = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * hr + e];
            x = exp2f(x - m_use);
            ls += x;
          }
        }
        l_i[hr] = l_i[hr] * corr[hr] + ls;  // this thread's share of the sum
        m_i[hr] = m_new;
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] *= corr[(i >> 1) & 1];

      // P as bf16 A fragments: chunk c of 16 keys is s[8c .. 8c + 7]
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int c = 0; c < BK / 16; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[c][r] = pack_bf16(s[8 * c + 2 * r], s[8 * c + 2 * r + 1]);

      // O += P . V
      wgmma_fence();
      mma_pv<D>(acc, pa, base + L::v_off + stage * L::kv_tile);
      wgmma_wait0();
      fence_regs(acc);
      mbar_arrive(empty(stage));
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: o = acc / l in bf16, lse in natural-log units
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float l = l_i[hr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float l_safe = l == 0.f ? 1.f : l;
      const int row = row0 + 8 * hr;
      if (row < Sq) {
        __nv_bfloat16* orow = o + ((size_t)b * Sq + row) * H * D + h * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
              __floats2bfloat162_rn(acc[4 * j + 2 * hr] / l_safe,
                                    acc[4 * j + 2 * hr + 1] / l_safe);
        if (t == 0)
          lse[((size_t)b * Sq + row) * H + h] =
              (m_i[hr] + log2f(l_safe)) / kLog2e;
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
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
cudaError_t make_map(CUtensorMap* map, const void* ptr, int width, int S,
                     int batch, int rs, int rows) {
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

template <int D, bool SEG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* seg, void* o, void* lse, int batch, int Sq,
                   int Sk, int H, int qs, int ks, int vs, float scale,
                   int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map(&mq, q, H * D, Sq, batch, qs, BQ);
  if (err == cudaSuccess) err = make_map(&mk, k, H * D, Sk, batch, ks, bk<D>());
  if (err == cudaSuccess) err = make_map(&mv, v, H * D, Sk, batch, vs, bk<D>());
  if (err != cudaSuccess) return err;
  constexpr int smem = Smem<D>::bytes;
  err = cudaFuncSetAttribute(flash_fwd_kernel_sm90<D, SEG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, batch);
  flash_fwd_kernel_sm90<D, SEG><<<grid, NT, smem, stream>>>(
      mq, mk, mv, static_cast<const int*>(seg),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), Sq, Sk, H,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace sm90

template <bool SEG>
int dispatch(const void* q, const void* k, const void* v, const void* seg,
             void* o, void* lse, int batch, int Sq, int Sk, int H, int D,
             int qs, int ks, int vs, float scale, int causal, int dtype,
             void* stream) {
  if (batch <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Sk <= 0 || (causal && Sq != Sk) || (SEG && Sq != Sk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_LAUNCH(FN, DD)                                                 \
  return (int)FN<DD, SEG>(q, k, v, seg, o, lse, batch, Sq, Sk, H, qs, ks, \
                          vs, scale, causal, s)
  if (dtype == 0 && D == 64) PTT_LAUNCH(launch_fp32, 64);
  if (dtype == 0 && D == 128) PTT_LAUNCH(launch_fp32, 128);
  if (dtype == 1 && D == 64) PTT_LAUNCH(sm90::launch, 64);
  if (dtype == 1 && D == 128) PTT_LAUNCH(sm90::launch, 128);
#undef PTT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
// q_rs, k_rs, v_rs: row strides in elements (NH*D when contiguous, 3*NH*D
// for column slices of a fused qkv).
extern "C" int flash_attention_fwd_packed(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int batch, int sq, int sk,
                                          int heads, int head_dim, int q_rs,
                                          int k_rs, int v_rs, float scale,
                                          int causal, int dtype,
                                          void* stream) {
  return dispatch<false>(q, k, v, nullptr, o, lse, batch, sq, sk, heads,
                         head_dim, q_rs, k_rs, v_rs, scale, causal, dtype,
                         stream);
}

// The K-SEG entry with a row stride per operand; causal self-attention.
extern "C" int flash_attention_fwd_packed_seg(const void* q, const void* k,
                                              const void* v, const void* seg,
                                              void* o, void* lse, int batch,
                                              int seqlen, int heads,
                                              int head_dim, int q_rs,
                                              int k_rs, int v_rs, float scale,
                                              int dtype, void* stream) {
  return dispatch<true>(q, k, v, seg, o, lse, batch, seqlen, seqlen, heads,
                        head_dim, q_rs, k_rs, v_rs, scale, 1, dtype, stream);
}
