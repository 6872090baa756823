// Flash attention forward for Hopper, sm_90a: two bodies, chosen by dtype,
// each a template over the segment ids (SEG) and the two optional features
// of philox.cuh (DROP: attention dropout, BIAS: an additive mask), behind
// the entry points of flash_attention_fwd.cu (K-PACK, K-SEG, K-BSHD) and
// flash_attention_fwd_ext.cu (the same kernels with DROP or BIAS).
//
//   K-PACK `flash_attention_fwd_packed` replaces the Pallas TPU kernel
//          paddle_tpu/ops/pallas/flash_attention_packed.py `_fwd_kernel`
//          (launched by `_fwd_call`): causal or full attention over the
//          packed (B, S, NH*D) layout, the training forward. Full attention
//          takes Sq != Sk (ring attention's off-diagonal blocks); causal
//          needs Sq == Sk.
//   K-SEG  `flash_attention_fwd_packed_seg` replaces
//          paddle_tpu/ops/pallas/flash_attention_packed.py `_fwd_kernel_seg`
//          (launched by `_fwd_call_seg`): attention over the same layout
//          where a pair is visible only when the query's (B, Sq) int32
//          segment id equals the key's (B, Sk) one (pad id -1 attends only
//          to pad). Causal self-attention (one id array, Sq == Sk) is
//          serving's `prefill_packed` and the packed-sequence trainer; full
//          attention takes distinct key-side ids and Sq != Sk (varlen
//          attention over two `cu_seqlens`, BERT's padding mask: query ids
//          0, key ids 0 or -1). Causal with distinct key ids is refused by
//          the wrapper, as the TPU kernel refuses it.
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
// writes o = 0 and lse = -1e30 / log2 e, as the Pallas kernel does.
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
//     the q-block's ids, hashed by their low 10 bits, built once per CTA
//     from the query-side ids and tested against the key-side ones):
//     a miss proves that no pair shares a segment, a hash collision only
//     costs a tile that the mask then zeroes, so the result is exact for
//     any int32 ids;
//   * a wait on an mbarrier that never completes traps after ~2^26 polls
//     (seconds), so a fault shows as a launch failure, not a hung card.
// The TMA, mbarrier, descriptor, wgmma and tensor-map helpers live in
// sm90.cuh, shared with the backward kernels (flash_bwd.cuh).
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
//
// DROP and BIAS (philox.cuh; the JAX package computes both densely, no TPU
// kernel does): in both bodies, BIAS adds each entry's bias to its scaled
// score before the row max, so every tile takes the elementwise path;
// DROP zeroes a dropped p after the row sums (lse stays the undropped
// softmax's) and scales o by 1 / (1 - p) in the epilogue. What bounds the
// DROP variants: beside the base kernel's work, 10 Philox rounds of two
// 32-bit wide multiplies and two 3-input XORs per call, ~10 integer
// instructions an entry against ~9 for the rest of the softmax, so the
// bf16 body is bound by issue slots, not by the bytes or the tensor cores
// (PERF.md). It makes one call per four entries (philox.cuh's counter
// layout: the four are a thread's rows r, r + 8 at one column of two
// adjacent 8-column blocks), 16 a thread per 128-key tile at d = 64,
// drawn after the commit of S = Q.K^T and before its wait, every column
// block and branch-free, so the integer pipe works while the tensor cores
// do, into 64 bits a thread that selects apply after the softmax. The
// fp32 body makes one call per entry and reads the bias from device
// memory entry by entry. The bf16 body reads it from shared memory: the
// producer warp stages each K/V tile's bias tile (128 queries by BK keys,
// fp32, rows BK + 8 floats apart so that the consumers' float2 reads of
// their fragment hit 32 distinct banks; one row at a row pitch of 0 when
// the mask broadcasts over queries) by TMA or cp.async on the tile's own
// full barrier (philox.cuh `BiasTile`), 68 KB a stage at d = 64 and 36 KB
// at d = 128. Before, each entry's read went to device memory after the
// wait of S and stalled every warp; the +bias+drop bits were then drawn
// after the softmax to fill those stalls (PERF.md). The
// instantiations without DROP and BIAS keep their code (the feature code
// sits in `if constexpr` branches), SASS for SASS.
// `-Xptxas -v` with DROP or BIAS (nvcc 12.9, sm_90a; d = 64 / 128): +drop
// 166 / 163 registers, +bias 155 / 140, +bias+drop 168 / 168, K-SEG +drop
// 166 / 166; +bias+drop at d = 64 spills 32 bytes (its bits under S hold
// 64 bits and the Philox chains beside S's 64 accumulators; drawn after
// the softmax it spilled none and ran 1.04x slower; PERF.md), 0 in the
// other seven.
// Dynamic shared memory with BIAS: 224,256 bytes at d = 64 and 174,080 at
// d = 128 (at a row pitch of 0, one 1 KB row a stage: 87,040 and
// 102,400).

#pragma once

#include <limits.h>

#include "philox.cuh"
#include "sm90.cuh"

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
// rows back to back; o is dense. SEG: segq (B, Sq) and segk (B, Sk) ids.
// DROP, BIAS: philox.cuh, from `ex`.
template <int D, bool SEG, bool DROP, bool BIAS>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_k, float* __restrict__ o, float* __restrict__ lse, int Sq,
                 int Sk, int H, int qs, int ks, int vs, float scale2,
                 int causal, const AttnExtra ex) {
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
  const uint32_t bh = (uint32_t)b * H + h;    // DROP's counter word 2
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
    segq[tid] = (q0 + tid < Sq) ? seg_q[(size_t)b * Sq + q0 + tid] : INT_MIN;
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
        segk[tid] = (k0 + tid < Sk) ? seg_k[(size_t)b * Sk + k0 + tid] : INT_MIN;
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
        if (BIAS && ok[c]) s[i][c] += bias2(ex, b, h, row, key);
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
        // the row sum is the undropped one; P.V takes the kept p
        Ps[r * PP + tx + 16 * c] =
            DROP && !keep1(ex, bh, row, k0 + tx + 16 * c) ? 0.f : p;
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
        orow[tx + 16 * c] = DROP ? acc[i][c] * (ex.rdrop / l_safe)
                                 : acc[i][c] / l_safe;
      if (tx == 0)
        lse[((size_t)b * Sq + row) * H + h] =
            (m_i[i] + log2f(l_safe)) / kLog2e;
    }
  }
}

template <int D, bool SEG, bool DROP, bool BIAS>
cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                        const void* seg_q, const void* seg_k, void* o,
                        void* lse, int batch,
                        int Sq, int Sk, int H, int qs, int ks, int vs,
                        float scale, int causal, const AttnExtra& ex,
                        cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, SEG, DROP, BIAS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, batch);
  flash_fwd_kernel<D, SEG, DROP, BIAS><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_k), static_cast<float*>(o),
      static_cast<float*>(lse), Sq, Sk, H, qs, ks,
      vs, scale * kLog2e, causal, ex);
  return cudaGetLastError();
}

// -- bf16: the Hopper body ---------------------------------------------------

namespace sm90 {

constexpr int BQ = 128;             // query rows per CTA
constexpr int STAGES = 2;           // K/V ring depth
constexpr int NCONS = 256;          // two consumer warpgroups, 64 rows each
constexpr int NT = NCONS + 32;      // and one producer warp

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
  // BIAS: a stage's bias tile, 128 queries by BK keys (philox.cuh), after
  // the rest on 1024 bytes: 68 KB a stage at d = 64, 36 KB at d = 128
  using Bias = BiasTile<BQ, BK, BK + 8>;
  static constexpr int stages = STAGES;
  static constexpr int bias_off = (bloom_off + 4 * BLOOM + 1023) / 1024 * 1024;
  static constexpr int bias_bytes = bias_off + STAGES * Bias::bytes + 1024;
};

template <int D, bool SEG, bool DROP, bool BIAS>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const int* __restrict__ seg_q,
                      const int* __restrict__ seg_k,
                      __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int Sq, int Sk, int H,
                      float scale2, int causal, const AttnExtra ex,
                      const __grid_constant__ CUtensorMap tb) {
  using L = Smem<D>;
  using BT = typename L::Bias;
  constexpr int BK = L::BK;
  constexpr int NO = D / 2;          // output accumulator floats per thread
  constexpr int NS = BK / 2;         // score accumulator floats per thread
  constexpr uint32_t KV_BYTES = 2u * BK * D * 2;   // one K and one V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
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
      mbar_init(full(s), full_count<BIAS>(ex));  // the producer warp's lanes
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
    if (SEG) fill_set<BQ>(bloom, seg_q, b, q0, Sq, lane);
    int stage = 0;
    uint32_t phase = 0;
    for (int kb = 0; kb < nkb; ++kb) {
      const int k0 = kb * BK;
      int ids[BK / 32];
      if (SEG && !tile_hits<BK>(ids, bloom, seg_k, b, k0, Sk, lane))
        continue;                      // no key shares a segment
      mbar_wait(empty(stage), phase ^ 1);
      if (SEG) {
#pragma unroll
        for (int i = 0; i < BK / 32; ++i)
          segk[stage * BK + lane + 32 * i] = ids[i];
      }
      if (lane == 0) {
        tile_idx[stage] = kb;
        mbar_arrive_tx(full(stage),
                       KV_BYTES + (BIAS && ex.bias_tma ? bias_tx_bytes<BT>(ex)
                                                       : 0u));
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
      // BIAS: the tile's bias beside its K and V, on the same barrier
      if constexpr (BIAS)
        stage_bias<BT>(base + L::bias_off + stage * bias_stage_bytes<BT>(ex),
                       &tb, full(stage), ex, b, h, q0, k0, Sq, Sk, lane);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    mbar_wait(empty(stage), phase ^ 1);   // the end marker
    if (lane == 0) tile_idx[stage] = -1;
    end_arrive<BIAS>(full(stage), ex);
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
        sq_id[hr] = row < Sq ? seg_q[(size_t)b * Sq + row] : INT_MIN;
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
      gemm_ss<D, BK, BQ, BK>(s, q_base, base + L::k_off + stage * L::kv_tile);
      wgmma_commit();
      // DROP: the tile's keep bits while S is in flight, on the integer
      // pipe beside the tensor cores, every column block (skipping those
      // past the causal diagonal cost more than it saved; PERF.md), with
      // BIAS too: its tile waits in shared memory, so no warp stalls on
      // device memory after the wait.
      [[maybe_unused]] FragKeep<BK> kept;
      if constexpr (DROP) {
        kept = frag_keep<BK, false>(ex, (uint32_t)b * H + h, row0, k0, t);
        fence_keep(kept);
      }
      wgmma_wait0();
      fence_regs(s);

      // scale to log2 units; mask only where the tile can hold a masked
      // pair (the causal diagonal, the ragged tail, segment ids). BIAS
      // (never with SEG): every tile, each entry plus its bias from the
      // stage's tile (a float2 per two adjacent keys). The instantiations
      // without it compile the branches below as before.
      if constexpr (BIAS) {
        const int bp = ex.sq ? BT::pitch : 0;
        const float* brow = bias_tile<BT>(smem + L::bias_off, stage, ex) +
                            (row0 - q0) * bp + 2 * t;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = row0 + 8 * hr;
            const float2 bv =
                *reinterpret_cast<const float2*>(brow + 8 * hr * bp + 8 * j);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = k0 + 8 * j + 2 * t + e;
              const bool ok = key < Sk && row < Sq && (!causal || key <= row);
              float& x = s[4 * j + 2 * hr + e];
              x = ok ? fmaf(x, scale2, bias_log2(e ? bv.y : bv.x)) : kNegInf;
            }
          }
        }
      } else if (SEG || k0 + BK > Sk || (causal && k0 + BK - 1 > wg_row0)) {
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

      // DROP: P.V takes the kept p (the row sums above are undropped)
      if constexpr (DROP) {
#pragma unroll
        for (int i = 0; i < NS; ++i)
          if (!kept[i]) s[i] = 0.f;
      }

      // P as bf16 A fragments: chunk c of 16 keys is s[8c .. 8c + 7]
      uint32_t pa[BK / 16][4];
      to_a_frags<BK>(s, pa);

      // O += P . V
      wgmma_fence();
      gemm_rs<D, BK>(acc, pa, base + L::v_off + stage * L::kv_tile);
      wgmma_commit();
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
        if constexpr (DROP) {   // the kept p were not scaled
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
                __floats2bfloat162_rn(
                    acc[4 * j + 2 * hr] * (ex.rdrop / l_safe),
                    acc[4 * j + 2 * hr + 1] * (ex.rdrop / l_safe));
        } else {
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
                __floats2bfloat162_rn(acc[4 * j + 2 * hr] / l_safe,
                                      acc[4 * j + 2 * hr + 1] / l_safe);
        }
        if (t == 0)
          lse[((size_t)b * Sq + row) * H + h] =
              (m_i[hr] + log2f(l_safe)) / kLog2e;
      }
    }
  }
}

template <int D, bool SEG, bool DROP, bool BIAS>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* seg_q, const void* seg_k, void* o, void* lse,
                   int batch, int Sq,
                   int Sk, int H, int qs, int ks, int vs, float scale,
                   int causal, const AttnExtra& ex, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mb;
  cudaError_t err = make_map(&mq, q, H * D, Sq, batch, qs, BQ);
  if (err == cudaSuccess) err = make_map(&mk, k, H * D, Sk, batch, ks, bk<D>());
  if (err == cudaSuccess) err = make_map(&mv, v, H * D, Sk, batch, vs, bk<D>());
  if (err == cudaSuccess)
    err = bias_map<BIAS, typename Smem<D>::Bias>(&mb, ex, batch, H, Sq, Sk);
  if (err != cudaSuccess) return err;
  using L = Smem<D>;
  const int smem = launch_smem<L, BIAS>(ex);
  err = cudaFuncSetAttribute(flash_fwd_kernel_sm90<D, SEG, DROP, BIAS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BIAS ? L::bias_bytes : L::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, batch);
  flash_fwd_kernel_sm90<D, SEG, DROP, BIAS><<<grid, NT, smem, stream>>>(
      mq, mk, mv, static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_k), static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), Sq, Sk, H,
      scale * kLog2e, causal, ex, mb);
  return cudaGetLastError();
}

}  // namespace sm90

template <bool SEG, bool DROP, bool BIAS>
int dispatch(const void* q, const void* k, const void* v, const void* seg_q,
             const void* seg_k, void* o, void* lse, int batch, int Sq,
             int Sk, int H, int D, int qs, int ks, int vs, float scale,
             int causal, int dtype, const AttnExtra& ex, void* stream) {
  if (batch <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Sk <= 0 || (causal && Sq != Sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_LAUNCH(FN, DD)                                                 \
  return (int)FN<DD, SEG, DROP, BIAS>(q, k, v, seg_q, seg_k, o, lse, batch, \
                                      Sq, Sk, H, qs, ks, vs, scale, causal, \
                                      ex, s)
  if (dtype == 0 && D == 64) PTT_LAUNCH(launch_fp32, 64);
  if (dtype == 0 && D == 128) PTT_LAUNCH(launch_fp32, 128);
  if (dtype == 1 && D == 64) PTT_LAUNCH(sm90::launch, 64);
  if (dtype == 1 && D == 128) PTT_LAUNCH(sm90::launch, 128);
#undef PTT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace
