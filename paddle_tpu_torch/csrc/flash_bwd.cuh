// Flash attention backward for Hopper, sm_90a, over the packed (B, S, NH*D)
// layout: a dQ kernel and a dK/dV kernel, each with a segment-id variant
// (SEG), the two optional features of philox.cuh (DROP: attention dropout,
// BIAS: an additive mask) and two bodies chosen by dtype, behind the four
// entry points of flash_attention_bwd.cu and, with DROP or BIAS, those of
// flash_attention_bwd_dq_ext.cu and flash_attention_bwd_dkv_ext.cu.
//
//   K-DQ  `flash_attention_bwd_dq`  replaces the Pallas TPU kernel
//         paddle_tpu/ops/pallas/flash_attention_packed.py `_dq_kernel`
//         (launched by `_dq_call`): dQ from q, k, v, dO, the forward's
//         natural-log lse and delta = rowsum(dO * O), both (B, Sq, NH) fp32.
//   K-DKV `flash_attention_bwd_dkv` replaces `_dkv_kernel` (launched by
//         `_dkv_call`): dK and dV from the same inputs. The TPU kernel took
//         lse and delta transposed to (B, NH, S) for its (bk, bq) tiles; a
//         block here reads its rows of lse and delta straight from
//         (B, Sq, NH), so no transpose is made.
//   K-BDQ, K-BDKV: the same two entries replace
//         paddle_tpu/ops/pallas/flash_attention.py `_dq_kernel` and
//         `_dkv_kernel` (launched by `_flash_bwd_call`): a (B, S, H, D)
//         tensor whose last two dims are dense is (B, S, H*D) with a row
//         stride, so the TPU's (B*H, S, D) transpose is not needed.
//   K-SDQ `flash_attention_bwd_dq_seg` and K-SDKV
//         `flash_attention_bwd_dkv_seg` replace `_dq_kernel_seg` and
//         `_dkv_kernel_seg` (launched by `_dq_call_seg`, `_dkv_call_seg`):
//         attention where a pair is visible only when the query's (B, Sq)
//         int32 segment id equals the key's (B, Sk) one (pad -1 attends
//         only to pad): causal self-attention (one id array, Sq == Sk), or
//         full attention with distinct key-side ids and Sq != Sk (varlen
//         attention, BERT's padding mask). A query row that sees no key
//         has lse = -1e30 / log2 e from the forward and adds nothing.
//
// Per visible (query, key) pair, in natural units:
//   s = scale * q.k,  p = exp(s - lse),  dp = dO.v,  ds = p * (dp - delta),
//   dQ += scale * ds * k,  dK += scale * ds * q,  dV += p * dO.
// BIAS adds the pair's bias to s. DROP (FlashAttention-2's backward) takes
// the forward's keep bit z of the pair, regenerated from the same Philox
// counter: dV += z * p / (1 - p_drop) * dO and ds = p * (z * dp /
// (1 - p_drop) - delta), with delta = rowsum(dO * O) over the dropped
// output.
// Causal means key <= query (top-left, Sq == Sk); full attention takes
// Sq != Sk. q, k, v and dO rows are `*_rs` elements apart (3*NH*D for
// column slices of the fused qkv projection and for the `unbind` views of
// (B, S, 3, H, D)), a batch is its rows back to back, and dQ, dK, dV are
// written dense (B, S, NH*D) in q's dtype.
//
// What bounds them on the H100: 6*d (dQ: q.k, dO.v, ds.k) and 8*d (dK/dV:
// k.q, v.dO, p.dO, ds.q) FLOPs per visible pair against q, k, v, dO read
// once and the gradients written once. At the training shape
// (8, 1024, 16*64), causal: 25.8 GFLOP for dQ against 85 MB, ~304
// FLOP/byte, and 34.4 GFLOP for dK/dV against 102 MB, ~338: both at or
// above the bf16 ridge of 989 TFLOP/s / 3.35 TB/s = ~295, so the products
// have to run on the tensor cores. With segment ids the visible pairs
// shrink and the bound can become bytes. Beside the products, each visible
// pair costs one exp2 on the SFUs (16 per clock per SM), as in the forward.
//
// bf16 (`flash_dq_kernel_sm90`, `flash_dkv_kernel_sm90`, the Hopper
// bodies; the TMA, mbarrier and wgmma helpers are sm90.cuh's, shared with
// the forward):
//   * both kernels: 160 threads, ONE consumer warpgroup and one producer
//     warp, and a 2-stage TMA ring (3-D tensor maps {H*D columns, S rows
//     at the row stride, B}, 64-column boxes, 128-byte swizzle, encoded on
//     the host per launch; mbarriers full and empty per stage, as in the
//     forward);
//   * dQ: one CTA per (64-row q-block, head, batch), heaviest causal
//     q-blocks first. The producer loads Q and dO once and 64-key K/V
//     tiles up to the diagonal. Per tile the warpgroup runs S = Q.K^T and
//     dP = dO.V^T (both wgmma m64n64k16, A and B K-major in shared
//     memory), forms p = exp2(S * scale * log2 e - lse * log2 e) and
//     dS = p * (dP - delta) on the accumulator fragments with the causal,
//     tail and segment masks applied there, rounds dS to bf16 A fragments
//     and runs dQ += dS.K (m64nDk16, K's tile read MN-major with the
//     transpose bit, as the forward reads V). A CTA owns its rows, so no
//     atomics;
//   * dK/dV in the transposed space of the TPU kernel: one CTA per
//     (64-key block, head, batch), heaviest causal key blocks (the first)
//     first. The producer loads the block's K and V once and walks
//     64-query Q/dO tiles from the diagonal to the end. S^T = K.Q^T and
//     dP^T = V.dO^T are both the Q.K^T form, so P^T and dS^T come out as
//     accumulator fragments with keys as rows, and dV += P^T.dO and
//     dK += dS^T.Q take them as register A operands against dO's and Q's
//     tiles read MN-major: nothing goes through shared memory. lse and
//     delta are per column here: each ring stage also carries the tile's
//     64 values of lse * log2 e and delta, which TMA cannot copy (one fp32
//     at a stride of NH), so the producer's lanes load them before they
//     wait for a free stage and store them before they arrive on its
//     barrier;
//   * why one consumer warpgroup: dK/dV holds S^T, dP^T, dK and dV in a
//     thread (4 x 32 fp32 at d = 64, 2 x 32 + 2 x 64 at d = 128) plus the
//     bf16 fragments of P^T and dS^T: 154 registers at d = 64 and 220 at
//     d = 128, the latter above the 168 that a 288-thread CTA of two
//     warpgroups allows. At 160 threads an SM holds three dQ CTAs (124
//     registers) or two dK/dV CTAs at d = 64, whose warpgroups overlap
//     one another's exponentials and products. Measured on the card (see
//     PERF.md): two consumer warpgroups a CTA were slower for both
//     kernels at the training shape;
//   * segments: a producer skips a tile before copying it when no id of
//     the tile (key-side ids in dQ, query-side in dK/dV) is in the CTA's
//     1024-bit set of its own rows' ids (hashed by
//     their low 10 bits, built once per CTA), the forward's method. A miss
//     proves that no pair of the tile shares a segment, a collision only
//     costs a tile that the mask zeroes, so the result is exact for any
//     int32 ids. The producer hands each stage's ids to the consumers;
//   * rows past S are zero-filled by TMA and never cross into the next
//     batch (3-D maps {H*D, S, B}); the masks zero p on ragged tails, so a
//     masked pair adds nothing; P and dS are rounded to bf16 before their
//     products (the plain version keeps them in fp32);
//   * a wait on an mbarrier that never completes traps after ~2^26 polls,
//     so a fault shows as a launch failure, not a hung card.
// `-Xptxas -v` (nvcc 12.9, sm_90a): flash_dq_kernel_sm90 122 registers
// (K-DQ) and 124 (K-SDQ) at d = 64, 155 and 156 at d = 128;
// flash_dkv_kernel_sm90 154 and 155 at d = 64, 220 and 220 at d = 128;
// 0 bytes of spill in all eight.
//
// DROP and BIAS (philox.cuh): the forward's bias is added to each
// recomputed score and its Philox bits regenerated from the same logical
// (b, h, i, j) counters, so p, dropped or kept, is the forward's. One
// Philox call gives four entries that a thread holds in either fragment
// layout (philox.cuh). Both kernels make 8 calls a thread per 64-wide
// tile, every column block, branch-free, and draw the next tile's bits
// after the commit of the tile's last products and before their wait, so
// the integer pipe works while the tensor cores do: dQ under dQ += dS.K
// (S and dP are dead there), dK/dV under its dV and dK products (the first
// tile's bits, and a tile's after one skipped for its segment ids, before
// its score products are issued). Skipping blocks past the causal
// diagonal, each call in a branch of its own, cost dQ more under its
// product than the calls it saved (PERF.md). Under the score products, whose accumulators hold 64 more registers, the
// draw made the d = 64 dK/dV kernel spill at two CTAs an SM. With DROP,
// dK/dV tests the masks only on tiles that can hold a masked pair and
// applies 1 / (1 - p_drop) to dK and dV in the epilogue; at d = 64 it runs
// two CTAs an SM (`__launch_bounds__(160, 2)`, at most 168 registers; left
// to 212 registers it ran one, 1.2-1.5x slower), with BIAS too since the
// bias's reads went to shared memory (at 168 registers it spills 4 bytes;
// at one CTA an SM with reads of device memory it took 1.5x as long;
// PERF.md).
// BIAS: the producer warp stages each ring stage's bias tile beside the
// K/V (dQ) or Q/dO (dK/dV) tile, fp32, query-major (philox.cuh
// `BiasTile`, `stage_bias`; by TMA or by cp.async on the stage's full
// barrier), and the consumers read their entries from it: dQ a float2 per
// two adjacent keys, rows 72 floats apart; dK/dV a float per entry, rows
// (queries) 68 floats apart, so that a warp's reads meet 32 distinct banks
// in both layouts. 18 and 17 KB a stage; at a row pitch of 0 (a mask
// broadcast over queries) one 1 KB row, so dQ with a padding mask keeps
// three CTAs an SM at d = 64. dK/dV with BIAS alone reads a padding
// mask's two values a thread before its score products are issued.
// `-Xptxas -v` with DROP or BIAS (nvcc 12.9, sm_90a; d = 64 / 128):
// flash_dq_kernel_sm90 +drop 126 / 158 registers, +bias 126 / 158,
// +bias+drop 128 / 160, K-SDQ +drop 128 / 160; flash_dkv_kernel_sm90 +drop
// 168 / 249, +bias 164 / 230, +bias+drop 168 / 255, K-SDKV +drop 168 /
// 226; 0 bytes of spill but dK/dV +bias+drop's 4 at d = 64. The
// instantiations without DROP and BIAS keep their code (the feature code
// sits in `if constexpr` branches), SASS for SASS.
//
// fp32 (`flash_dq_kernel`, `flash_dkv_kernel`, the CUDA-core bodies): the
// port's correctness mode, held to the CPU at 1e-4 on the card; TF32 wgmma
// keeps ~3 decimal digits and would not meet that. The dtype picks the
// body; a bf16 call never reaches it.
//   * dQ: grid (q-block, head, batch); each 64-row q-block owns its dQ rows
//     and loops over k-tiles up to the diagonal, so no atomics are needed.
//     The heaviest causal q-blocks (the last) are launched first.
//   * dK/dV: grid (k-block, head, batch); each 64-row k-block owns its dK,
//     dV rows and loops over q-tiles from the diagonal to the end; the
//     heaviest causal k-blocks (the first) are launched first. Its tiles
//     are held transposed, (key, query), so the two accumulations read
//     P^T and dS^T rows as they were written.
//   * 256 threads, each a 4 x 4 block of scores (s and dp in the same
//     d-loop) and a 4 x d/16 block of the output, so every shared-memory
//     value read feeds four FMAs; fp32 tiles padded by one word per row
//     against bank conflicts;
//   * the scale is folded in once: dQ keeps q * scale * log2(e) in shared
//     memory, dK/dV keeps k * scale * log2(e), and p = exp2(s2 - lse2);
//   * ragged tails (S not a multiple of 64) are masked in the kernel, p is
//     zeroed on every masked entry, and with segment ids a 64 x 64 tile in
//     which no pair shares a segment is skipped by a block vote before its
//     operands are loaded.

#pragma once

#include <limits.h>

#include "philox.cuh"
#include "sm90.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float kLog2e = 1.4426950408889634f;

template <int D> __host__ __device__ constexpr int pitch() { return D + 1; }
__host__ __device__ constexpr int t_pitch() { return BK + 1; }

// Q, dO, K, V tiles + one (64 x 64) score tile + lse2 and delta rows +
// the rows' and the tile's segment ids
template <int D> constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * (size_t)BQ * pitch<D>() +
                          (size_t)BQ * t_pitch() + 2 * BQ) +
         sizeof(int) * (BQ + BK);
}

// K, V, Q, dO tiles + P^T and dS^T tiles + lse2 and delta rows + segment
// ids
template <int D> constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * (size_t)BK * pitch<D>() +
                          2 * (size_t)BK * t_pitch() + 2 * BQ) +
         sizeof(int) * (BQ + BK);
}

// Whether any (query, key) pair of the 64 x 64 tile at (q0, k0) is
// visible; every thread tests its 4 x 4 share (rows ty*4+i, columns
// tx+16c of `rows` x `cols`) and the block votes. `segr` and `segc` hold
// the tile's row and column ids; with `keys_by_row` the rows are keys.
__device__ __forceinline__ bool tile_visible(const int* segr,
                                             const int* segc, int r0,
                                             int c0, int Sq, int Sk,
                                             int causal, bool keys_by_row) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  int any = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cc = tx + 16 * c;
      const int row = keys_by_row ? c0 + cc : r0 + r;   // query
      const int key = keys_by_row ? r0 + r : c0 + cc;
      any |= (row < Sq && key < Sk && (!causal || key <= row) &&
              segr[r] == segc[cc]);
    }
  }
  return __syncthreads_or(any) != 0;
}

// The (B, S) segment ids of rows r0 .. r0+63 of batch b; rows at or past
// `n` read INT_MIN, which no real or pad id equals.
__device__ __forceinline__ void load_seg(int* dst, const int* seg, int b,
                                         int r0, int n) {
  if (threadIdx.x < 64) {
    const int row = r0 + threadIdx.x;
    dst[threadIdx.x] = row < n ? seg[(size_t)b * n + row] : INT_MIN;
  }
}

// Loads a 64-row tile of a (rows, *) matrix with row stride `rs` into
// shared memory as fp32 times `mul`; rows at or past `n` read as zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0,
                                          int n, int rs, float mul) {
  constexpr int P = pitch<D>();
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int row = r0 + r;
    dst[r * P + c] = row < n ? src[(size_t)row * rs + c] * mul : 0.f;
  }
}

// SEG: a pair is visible only where seg_q[query] == seg_k[key]. DROP,
// BIAS: philox.cuh, from `ex`.
template <int D, bool SEG, bool DROP, bool BIAS>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                float* __restrict__ dq, int Sq, int Sk, int H, int qs, int ks,
                int vs, int dos, float scale, int causal,
                const AttnExtra ex) {
  constexpr int P = pitch<D>();
  constexpr int TP = t_pitch();
  constexpr int DC = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // q * scale * log2(e)
  float* dOs = Qs + BQ * P;
  float* Ks = dOs + BQ * P;
  float* Vs = Ks + BK * P;
  float* dSs = Vs + BK * P;      // (query, key)
  float* lse2 = dSs + BQ * TP;   // lse * log2(e)
  float* dlt = lse2 + BQ;
  int* segq = reinterpret_cast<int*>(dlt + BQ);
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
  const float scale2 = scale * kLog2e;
  const float* qp = q + (size_t)b * Sq * qs + (size_t)h * D;
  const float* dop = dout + (size_t)b * Sq * dos + (size_t)h * D;
  const float* kp = k + (size_t)b * Sk * ks + (size_t)h * D;
  const float* vp = v + (size_t)b * Sk * vs + (size_t)h * D;
  const size_t os = (size_t)H * D;
  float* dqp = dq + (size_t)b * Sq * os + (size_t)h * D;

  load_tile<D>(Qs, qp, q0, Sq, qs, scale2);
  load_tile<D>(dOs, dop, q0, Sq, dos, 1.f);
  if (tid < BQ) {
    const int row = q0 + tid;
    const size_t at = ((size_t)b * Sq + row) * H + h;
    lse2[tid] = row < Sq ? lse[at] * kLog2e : 0.f;
    dlt[tid] = row < Sq ? delta[at] : 0.f;
  }
  if (SEG) load_seg(segq, seg_q, b, q0, Sq);

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int kend = causal ? min(Sk, q0 + BQ) : Sk;
  const int nkb = (kend + BK - 1) / BK;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    if (SEG) {
      load_seg(segk, seg_k, b, k0, Sk);
      __syncthreads();
      // no pair shares a segment: skip (the vote is also the barrier
      // before the next tile overwrites segk)
      if (!tile_visible(segq, segk, q0, k0, Sq, Sk, causal, false)) continue;
    }
    load_tile<D>(Ks, kp, k0, Sk, ks, 1.f);
    load_tile<D>(Vs, vp, k0, Sk, vs, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty * 4 + i) * P + d];
        g[i] = dOs[(ty * 4 + i) * P + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        bk[c] = Ks[(tx + 16 * c) * P + d];
        bv[c] = Vs[(tx + 16 * c) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(a[i], bk[c], s[i][c]);
          dp[i][c] = fmaf(g[i], bv[c], dp[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int row = q0 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kc = tx + 16 * c;
        const int key = k0 + kc;
        const bool ok = row < Sq && key < Sk && (!causal || key <= row) &&
                        (!SEG || segq[r] == segk[kc]);
        float x = s[i][c];
        if (BIAS && ok) x += bias2(ex, b, h, row, key);
        const float p = ok ? exp2f(x - lse2[r]) : 0.f;
        const float dpz =
            !DROP ? dp[i][c]
                  : (ok && keep1(ex, bh, row, key) ? dp[i][c] * ex.rdrop : 0.f);
        dSs[r * TP + kc] = p * (dpz - dlt[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float ds[4], kk[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty * 4 + i) * TP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kk[c] = Ks[j * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(ds[i], kk[c], acc[i][c]);
    }
    __syncthreads();     // the next tile overwrites K, V, dS and segk
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < Sq) {
      float* out = dqp + (size_t)row * os;
#pragma unroll
      for (int c = 0; c < DC; ++c) out[tx + 16 * c] = acc[i][c] * scale;
    }
  }
}

template <int D, bool SEG, bool DROP, bool BIAS>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                 float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
                 int H, int qs, int ks, int vs, int dos, float scale,
                 int causal, const AttnExtra ex) {
  constexpr int P = pitch<D>();
  constexpr int TP = t_pitch();
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;              // k * scale * log2(e)
  float* Vs = Ks + BK * P;
  float* Qs = Vs + BK * P;
  float* dOs = Qs + BQ * P;
  float* Pt = dOs + BQ * P;      // (key, query)
  float* dSt = Pt + BK * TP;     // (key, query)
  float* lse2 = dSt + BK * TP;
  float* dlt = lse2 + BQ;
  int* segk = reinterpret_cast<int*>(dlt + BQ);
  int* segq = segk + BK;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;       // 16 key groups of 4 keys
  const int tx = tid & 15;       // 16 lanes: query columns, then d columns
  const int kb = blockIdx.x;     // heavy causal blocks (the first) first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const uint32_t bh = (uint32_t)b * H + h;    // DROP's counter word 2
  const int k0 = kb * BK;
  const float scale2 = scale * kLog2e;
  const float* qp = q + (size_t)b * Sq * qs + (size_t)h * D;
  const float* dop = dout + (size_t)b * Sq * dos + (size_t)h * D;
  const float* kp = k + (size_t)b * Sk * ks + (size_t)h * D;
  const float* vp = v + (size_t)b * Sk * vs + (size_t)h * D;
  const size_t os = (size_t)H * D;
  float* dkp = dk + (size_t)b * Sk * os + (size_t)h * D;
  float* dvp = dv + (size_t)b * Sk * os + (size_t)h * D;

  load_tile<D>(Ks, kp, k0, Sk, ks, scale2);
  load_tile<D>(Vs, vp, k0, Sk, vs, 1.f);
  if (SEG) load_seg(segk, seg_k, b, k0, Sk);

  float adk[4][DC], adv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) adk[i][c] = adv[i][c] = 0.f;

  const int nqb = (Sq + BQ - 1) / BQ;
  const int qstart = causal ? k0 / BQ : 0;
  for (int qb = qstart; qb < nqb; ++qb) {
    const int q0 = qb * BQ;
    if (SEG) {
      load_seg(segq, seg_q, b, q0, Sq);
      __syncthreads();
      if (!tile_visible(segk, segq, k0, q0, Sq, Sk, causal, true)) continue;
    }
    load_tile<D>(Qs, qp, q0, Sq, qs, 1.f);
    load_tile<D>(dOs, dop, q0, Sq, dos, 1.f);
    if (tid < BQ) {
      const int row = q0 + tid;
      const size_t at = ((size_t)b * Sq + row) * H + h;
      lse2[tid] = row < Sq ? lse[at] * kLog2e : 0.f;
      dlt[tid] = row < Sq ? delta[at] : 0.f;
    }
    __syncthreads();

    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[i][c] = dpt[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], av[4], bq[4], bo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Ks[(ty * 4 + i) * P + d];
        av[i] = Vs[(ty * 4 + i) * P + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        bq[c] = Qs[(tx + 16 * c) * P + d];
        bo[c] = dOs[(tx + 16 * c) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          st[i][c] = fmaf(a[i], bq[c], st[i][c]);
          dpt[i][c] = fmaf(av[i], bo[c], dpt[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = ty * 4 + i;
      const int key = k0 + kr;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qc = tx + 16 * c;
        const int row = q0 + qc;
        const bool ok = row < Sq && key < Sk && (!causal || key <= row) &&
                        (!SEG || segk[kr] == segq[qc]);
        float x = st[i][c];
        if (BIAS && ok) x += bias2(ex, b, h, row, key);
        const float p = ok ? exp2f(x - lse2[qc]) : 0.f;
        const bool z = !DROP || (ok && keep1(ex, bh, row, key));
        Pt[kr * TP + qc] = !DROP ? p : (z ? p * ex.rdrop : 0.f);
        dSt[kr * TP + qc] =
            p * ((!DROP ? dpt[i][c] : (z ? dpt[i][c] * ex.rdrop : 0.f)) -
                 dlt[qc]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BQ; ++j) {
      float p[4], ds[4], o[DC], qq[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Pt[(ty * 4 + i) * TP + j];
        ds[i] = dSt[(ty * 4 + i) * TP + j];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        o[c] = dOs[j * P + tx + 16 * c];
        qq[c] = Qs[j * P + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          adv[i][c] = fmaf(p[i], o[c], adv[i][c]);
          adk[i][c] = fmaf(ds[i], qq[c], adk[i][c]);
        }
    }
    __syncthreads();     // the next tile overwrites Q, dO, P^T, dS^T, segq
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key < Sk) {
      float* dko = dkp + (size_t)key * os;
      float* dvo = dvp + (size_t)key * os;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dko[tx + 16 * c] = adk[i][c] * scale;
        dvo[tx + 16 * c] = adv[i][c];
      }
    }
  }
}


template <int D, bool SEG, bool DROP, bool BIAS>
cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        const void* seg_q, const void* seg_k,
                        void* dq_or_dk, void* dv, int batch, int Sq, int Sk,
                        int H, int qs, int ks, int vs, int dos, float scale,
                        int causal, const AttnExtra& ex,
                        cudaStream_t stream) {
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_k);
  if (dv == nullptr) {
    const size_t smem = dq_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_dq_kernel<D, SEG, DROP, BIAS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + BQ - 1) / BQ, H, batch);
    flash_dq_kernel<D, SEG, DROP, BIAS><<<grid, NT, smem, stream>>>(
        qp, kp, vp, dop, lp, dp, sq, sk, static_cast<float*>(dq_or_dk), Sq,
        Sk, H, qs, ks, vs, dos, scale, causal, ex);
  } else {
    const size_t smem = dkv_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_dkv_kernel<D, SEG, DROP, BIAS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sk + BK - 1) / BK, H, batch);
    flash_dkv_kernel<D, SEG, DROP, BIAS><<<grid, NT, smem, stream>>>(
        qp, kp, vp, dop, lp, dp, sq, sk, static_cast<float*>(dq_or_dk),
        static_cast<float*>(dv), Sq, Sk, H, qs, ks, vs, dos, scale, causal,
        ex);
  }
  return cudaGetLastError();
}

// -- bf16: the Hopper bodies -------------------------------------------------

namespace sm90 {

constexpr int STAGES = 2;          // ring depth

// Both kernels: one consumer warpgroup (128 threads) and one producer warp
constexpr int NCONS = 128;
constexpr int NT = NCONS + 32;
// dQ: 64 query rows per CTA, 64-key K/V tiles
constexpr int DQ_ROWS = 64;
constexpr int DQ_KT = 64;
// dK/dV: 64 keys per CTA, 64-query Q/dO tiles
constexpr int DKV_KEYS = 64;
constexpr int DKV_QT = 64;

// Byte offsets in dynamic shared memory; every tile starts on 1024 bytes.
template <int D> struct DqSmem {
  static constexpr int rows_tile = (D / 64) * DQ_ROWS * ROWB;
  static constexpr int kv_tile = (D / 64) * DQ_KT * ROWB;
  static constexpr int q_off = 0;
  static constexpr int do_off = rows_tile;
  static constexpr int k_off = 2 * rows_tile;
  static constexpr int v_off = k_off + STAGES * kv_tile;
  // rows_full, full[STAGES], empty[STAGES]
  static constexpr int bar_off = v_off + STAGES * kv_tile;
  static constexpr int idx_off = bar_off + 8 * (1 + 2 * STAGES);
  static constexpr int segk_off = idx_off + 4 * STAGES;
  static constexpr int bloom_off = segk_off + 4 * STAGES * DQ_KT;
  static constexpr int bytes = bloom_off + 4 * BLOOM + 1024;  // + alignment
  // BIAS: a stage's bias tile, 64 queries by 64 keys (philox.cuh), 18 KB
  using Bias = BiasTile<DQ_ROWS, DQ_KT, DQ_KT + 8>;
  static constexpr int stages = STAGES;
  static constexpr int bias_off = (bloom_off + 4 * BLOOM + 1023) / 1024 * 1024;
  static constexpr int bias_bytes = bias_off + STAGES * Bias::bytes + 1024;
};

template <int D> struct DkvSmem {
  static constexpr int keys_tile = (D / 64) * DKV_KEYS * ROWB;
  static constexpr int q_tile = (D / 64) * DKV_QT * ROWB;
  static constexpr int k_off = 0;
  static constexpr int v_off = keys_tile;
  static constexpr int q_off = 2 * keys_tile;
  static constexpr int do_off = q_off + STAGES * q_tile;
  // keys_full, full[STAGES], empty[STAGES]
  static constexpr int bar_off = do_off + STAGES * q_tile;
  static constexpr int idx_off = bar_off + 8 * (1 + 2 * STAGES);
  // per stage: the tile's lse * log2 e, delta and segment ids
  static constexpr int lse_off = idx_off + 4 * STAGES;
  static constexpr int dlt_off = lse_off + 4 * STAGES * DKV_QT;
  static constexpr int segq_off = dlt_off + 4 * STAGES * DKV_QT;
  static constexpr int bloom_off = segq_off + 4 * STAGES * DKV_QT;
  static constexpr int bytes = bloom_off + 4 * BLOOM + 1024;
  // BIAS: a stage's bias tile, 64 queries by the CTA's 64 keys
  // (philox.cuh), 17 KB
  using Bias = BiasTile<DKV_QT, DKV_KEYS, DKV_KEYS + 4>;
  static constexpr int stages = STAGES;
  static constexpr int bias_off = (bloom_off + 4 * BLOOM + 1023) / 1024 * 1024;
  static constexpr int bias_bytes = bias_off + STAGES * Bias::bytes + 1024;
};

template <int D, bool SEG, bool DROP, bool BIAS>
__global__ void __launch_bounds__(NT, 1)
flash_dq_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ seg_q,
                     const int* __restrict__ seg_k,
                     __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H,
                     float scale, int causal, const AttnExtra ex,
                     const __grid_constant__ CUtensorMap tb) {
  using L = DqSmem<D>;
  using BT = typename L::Bias;
  constexpr int KT = DQ_KT;
  constexpr int NS = KT / 2;         // S and dP accumulator floats a thread
  constexpr int NO = D / 2;          // dQ accumulator floats a thread
  constexpr uint32_t KV_BYTES = 2u * KT * D * 2;   // one K and one V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t rows_full = base + L::bar_off;
  auto full = [&](int s) { return rows_full + 8 * (1 + s); };
  auto empty = [&](int s) { return rows_full + 8 * (1 + STAGES + s); };
  volatile int* tile_idx = reinterpret_cast<volatile int*>(smem + L::idx_off);
  int* segk = reinterpret_cast<int*>(smem + L::segk_off);
  uint32_t* bloom = reinterpret_cast<uint32_t*>(smem + L::bloom_off);

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int lane = tid & 31;
  const int nqb = (Sq + DQ_ROWS - 1) / DQ_ROWS;
  const int q0 = (nqb - 1 - (int)blockIdx.x) * DQ_ROWS;   // heavy first
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  if (tid == 0) {
    mbar_init(rows_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), full_count<BIAS>(ex));  // the producer warp's lanes
      mbar_init(empty(s), NCONS);      // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (SEG && tid < BLOOM) bloom[tid] = 0;
  __syncthreads();

  if (wg == 1) {
    // -- producer warp: Q and dO once, then the K/V ring --
    const int kend = causal ? min(Sk, q0 + DQ_ROWS) : Sk;
    const int nkb = (kend + KT - 1) / KT;
    if (lane == 0) {
      mbar_arrive_tx(rows_full, 2u * DQ_ROWS * D * 2);
#pragma unroll
      for (int hf = 0; hf < D / 64; ++hf) {
        const uint32_t dst = hf * DQ_ROWS * ROWB;
        tma_load(base + L::q_off + dst, &tq, rows_full, h * D + 64 * hf, q0,
                 b);
        tma_load(base + L::do_off + dst, &tdo, rows_full, h * D + 64 * hf,
                 q0, b);
      }
    }
    if (SEG) fill_set<DQ_ROWS>(bloom, seg_q, b, q0, Sq, lane);
    int stage = 0;
    uint32_t phase = 0;
    for (int kb = 0; kb < nkb; ++kb) {
      const int k0 = kb * KT;
      int ids[KT / 32];
      if (SEG && !tile_hits<KT>(ids, bloom, seg_k, b, k0, Sk, lane))
        continue;                      // no key shares a segment
      mbar_wait(empty(stage), phase ^ 1);
      if (SEG) {
#pragma unroll
        for (int i = 0; i < KT / 32; ++i)
          segk[stage * KT + lane + 32 * i] = ids[i];
      }
      if (lane == 0) {
        tile_idx[stage] = kb;
        mbar_arrive_tx(full(stage),
                       KV_BYTES + (BIAS && ex.bias_tma ? bias_tx_bytes<BT>(ex)
                                                       : 0u));
#pragma unroll
        for (int hf = 0; hf < D / 64; ++hf) {
          const int c0 = h * D + 64 * hf;
          const uint32_t dst = stage * L::kv_tile + hf * KT * ROWB;
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
    // -- the consumer warpgroup: 64 query rows --
    const int t = lane & 3;
    const int row0 = q0 + (tid / 32) * 16 + (lane >> 2);   // and +8
    const float scale2 = scale * kLog2e;
    float lse2[2], dlt[2];
    int sq_id[2] = {0, 0};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      const size_t at = ((size_t)b * Sq + row) * H + h;
      lse2[hr] = row < Sq ? lse[at] * kLog2e : 0.f;
      dlt[hr] = row < Sq ? delta[at] : 0.f;
      if (SEG) sq_id[hr] = row < Sq ? seg_q[(size_t)b * Sq + row] : INT_MIN;
    }
    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    const uint32_t q_base = base + L::q_off;
    const uint32_t do_base = base + L::do_off;

    // DROP: the keep bits of key tile `kept_k0` (kept[i] is dp[i]'s bit,
    // philox.cuh), drawn while the previous tile's dQ product runs (below)
    [[maybe_unused]] FragKeep<KT> kept;
    [[maybe_unused]] int kept_k0 = -1;
    mbar_wait(rows_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      mbar_wait(full(stage), phase);
      const int kb = __shfl_sync(0xffffffffu, tile_idx[stage], 0);
      if (kb < 0) break;
      const int k0 = kb * KT;
      const uint32_t k_base = base + L::k_off + stage * L::kv_tile;
      const uint32_t v_base = base + L::v_off + stage * L::kv_tile;
      // the first tile's bits, or a tile's after one skipped for its
      // segment ids: drawn before the score products hold their registers
      if constexpr (DROP) {
        if (k0 != kept_k0)
          kept = frag_keep<KT, false>(ex, (uint32_t)b * H + h, row0, k0, t);
      }

      // S = Q . K^T and dP = dO . V^T, fp32
      float s[NS], dp[NS];
      wgmma_fence();
      gemm_ss<D, KT, DQ_ROWS, KT>(s, q_base, k_base);
      gemm_ss<D, KT, DQ_ROWS, KT>(dp, do_base, v_base);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      fence_regs(dp);

      // dS = p * (dP - delta) in place of dP, masked only where the tile
      // can hold a masked pair (the causal diagonal, the ragged tail,
      // segment ids). With DROP or BIAS (never both BIAS and SEG), every
      // tile: p from the scores plus the bias (from the stage's tile, a
      // float2 per two adjacent keys), dP of a dropped pair 0 and of a
      // kept one scaled by 1 / (1 - p_drop); the instantiations without
      // them compile the loop after it as before.
      if constexpr (DROP || BIAS) {
        [[maybe_unused]] const int bp = ex.sq ? BT::pitch : 0;
        [[maybe_unused]] const float* brow =
            bias_tile<BT>(smem + L::bias_off, stage, ex) + (row0 - q0) * bp +
            2 * t;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = row0 + 8 * hr;
            [[maybe_unused]] float2 bv;
            if constexpr (BIAS)
              bv = *reinterpret_cast<const float2*>(brow + 8 * hr * bp +
                                                    8 * j);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * j + 2 * t + e;
              const int key = k0 + col;
              const int kid = SEG ? segk[stage * KT + col] : 0;
              const bool ok = key < Sk && row < Sq &&
                              (!causal || key <= row) &&
                              (!SEG || kid == sq_id[hr]);
              const int i = 4 * j + 2 * hr + e;
              float x = s[i] * scale2;
              if constexpr (BIAS)
                x = fmaf(s[i], scale2, bias_log2(e ? bv.y : bv.x));
              const float p = ok ? exp2f(x - lse2[hr]) : 0.f;
              const float dpz = !DROP    ? dp[i]
                                : kept[i] ? dp[i] * ex.rdrop
                                          : 0.f;
              dp[i] = p * (dpz - dlt[hr]);
            }
          }
        }
      } else {
      const bool edge =
          SEG || k0 + KT > Sk || (causal && k0 + KT - 1 > q0);
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;
          const int key = k0 + col;
          const int kid = SEG ? segk[stage * KT + col] : 0;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const bool ok =
                !edge || (key < Sk && (!causal || key <= row0 + 8 * hr) &&
                          (!SEG || kid == sq_id[hr]));
            const int i = 4 * j + 2 * hr + e;
            const float p = ok ? exp2f(fmaf(s[i], scale2, -lse2[hr])) : 0.f;
            dp[i] = p * (dp[i] - dlt[hr]);
          }
        }
      }
      }
      uint32_t da[KT / 16][4];
      to_a_frags<KT>(dp, da);

      // dQ += dS . K, K's tile read MN-major
      wgmma_fence();
      gemm_rs<D, KT>(acc, da, k_base);
      wgmma_commit();
      // DROP: the next key tile's keep bits while the product is in
      // flight, on the integer pipe beside the tensor cores (S and dP are
      // dead, so the draw holds no accumulator registers), every column
      // block and branch-free (with a skip of blocks past the causal
      // diagonal or Sk, each call in a branch of its own, +drop ran 1.1x
      // and K-SDQ +drop 1.35x slower; PERF.md); a tile that follows a
      // skipped one is drawn at its turn, above
      if constexpr (DROP) {
        kept_k0 = k0 + KT;
        if (kept_k0 < (causal ? min(Sk, q0 + DQ_ROWS) : Sk)) {
          kept = frag_keep<KT, false>(ex, (uint32_t)b * H + h, row0, kept_k0,
                                      t);
          fence_keep(kept);
        }
      }
      wgmma_wait0();
      fence_regs(acc);
      mbar_arrive(empty(stage));
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      if (row < Sq) {
        __nv_bfloat16* out = dq + ((size_t)b * Sq + row) * H * D + h * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * t) =
              __floats2bfloat162_rn(acc[4 * j + 2 * hr] * scale,
                                    acc[4 * j + 2 * hr + 1] * scale);
      }
    }
  }
}

// dK/dV's DROP step on one tile's fragments (flash_dkv_kernel_sm90, keys
// as rows): P^T the kept p and dS^T = p * (z dP^T - delta * (1 - p_drop)),
// p from the scores plus the bias (BIAS: the stage's tile, `bias_t` at the
// thread's first key, `bp` floats between queries). MASKED tests the
// causal, tail and segment masks, for a tile that can hold a masked pair;
// the interior runs without them (a loop that tests a uniform flag per
// entry kept the 32 tests' results in a register, bit by bit).
template <int QT, bool SEG, bool BIAS, bool MASKED>
__device__ __forceinline__ void dkv_drop_tile(
    float (&st)[QT / 2], float (&dpt)[QT / 2], const FragKeep<QT>& kept,
    const float* lse_t, const float* dlt_t, const int* segq_t, int q0,
    int key0, int t, int Sq, int Sk, int causal, const int (&sk_id)[2],
    float scale2, float keep_p, const float* bias_t, int bp) {
#pragma unroll
  for (int j = 0; j < QT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * t + e;
      const int q = q0 + col;
      const float l2 = lse_t[col];
      const float dl = dlt_t[col] * keep_p;
      const int qid = SEG ? segq_t[col] : 0;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int key = key0 + 8 * hr;
        const bool ok = !MASKED || (q < Sq && key < Sk &&
                                    (!causal || key <= q) &&
                                    (!SEG || qid == sk_id[hr]));
        const int i = 4 * j + 2 * hr + e;
        const float x =
            BIAS ? fmaf(st[i], scale2, bias_log2(bias_t[col * bp + 8 * hr]))
                 : st[i] * scale2;
        const float p = ok ? exp2f(x - l2) : 0.f;
        st[i] = kept[i] ? p : 0.f;
        dpt[i] = p * ((kept[i] ? dpt[i] : 0.f) - dl);
      }
    }
  }
}

template <int D, bool SEG, bool DROP, bool BIAS>
__global__ void __launch_bounds__(NT, DROP && D == 64 ? 2 : 1)
flash_dkv_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ seg_q,
                      const int* __restrict__ seg_k,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H,
                      float scale, int causal, const AttnExtra ex,
                      const __grid_constant__ CUtensorMap tb) {
  using L = DkvSmem<D>;
  using BT = typename L::Bias;
  constexpr int QT = DKV_QT;
  constexpr int NS = QT / 2;         // S^T and dP^T floats a thread
  constexpr int NO = D / 2;          // dK and dV floats a thread, each
  constexpr uint32_t QDO_BYTES = 2u * QT * D * 2;  // one Q and one dO tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t keys_full = base + L::bar_off;
  auto full = [&](int s) { return keys_full + 8 * (1 + s); };
  auto empty = [&](int s) { return keys_full + 8 * (1 + STAGES + s); };
  volatile int* tile_idx = reinterpret_cast<volatile int*>(smem + L::idx_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* dlt_s = reinterpret_cast<float*>(smem + L::dlt_off);
  int* segq = reinterpret_cast<int*>(smem + L::segq_off);
  uint32_t* bloom = reinterpret_cast<uint32_t*>(smem + L::bloom_off);

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int lane = tid & 31;
  const int k0 = blockIdx.x * DKV_KEYS;   // heavy causal blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  if (tid == 0) {
    mbar_init(keys_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), full_count<BIAS>(ex));
      mbar_init(empty(s), NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (SEG && tid < BLOOM) bloom[tid] = 0;
  __syncthreads();

  if (wg == 1) {
    // -- producer warp: K and V once, then the Q/dO ring with lse, delta
    // and ids beside each tile --
    const int nqb = (Sq + QT - 1) / QT;
    const int qstart = causal ? k0 / QT : 0;
    if (lane == 0) {
      mbar_arrive_tx(keys_full, 2u * DKV_KEYS * D * 2);
#pragma unroll
      for (int hf = 0; hf < D / 64; ++hf) {
        const uint32_t dst = hf * DKV_KEYS * ROWB;
        tma_load(base + L::k_off + dst, &tk, keys_full, h * D + 64 * hf, k0,
                 b);
        tma_load(base + L::v_off + dst, &tv, keys_full, h * D + 64 * hf, k0,
                 b);
      }
    }
    if (SEG) fill_set<DKV_KEYS>(bloom, seg_k, b, k0, Sk, lane);
    int stage = 0;
    uint32_t phase = 0;
    for (int qb = qstart; qb < nqb; ++qb) {
      const int q0 = qb * QT;
      int ids[QT / 32];
      if (SEG && !tile_hits<QT>(ids, bloom, seg_q, b, q0, Sq, lane))
        continue;                      // no query shares a segment
      // the tile's lse and delta (one fp32 NH apart each) are read before
      // the wait for a free stage, so their latency overlaps it
      float l2[QT / 32], dl[QT / 32];
#pragma unroll
      for (int i = 0; i < QT / 32; ++i) {
        const int q = q0 + lane + 32 * i;
        const size_t at = ((size_t)b * Sq + q) * H + h;
        l2[i] = q < Sq ? lse[at] * kLog2e : 0.f;
        dl[i] = q < Sq ? delta[at] : 0.f;
      }
      mbar_wait(empty(stage), phase ^ 1);
#pragma unroll
      for (int i = 0; i < QT / 32; ++i) {
        const int c = stage * QT + lane + 32 * i;
        lse_s[c] = l2[i];
        dlt_s[c] = dl[i];
        if (SEG) segq[c] = ids[i];
      }
      if (lane == 0) {
        tile_idx[stage] = qb;
        mbar_arrive_tx(full(stage),
                       QDO_BYTES + (BIAS && ex.bias_tma
                                        ? bias_tx_bytes<BT>(ex)
                                        : 0u));
#pragma unroll
        for (int hf = 0; hf < D / 64; ++hf) {
          const int c0 = h * D + 64 * hf;
          const uint32_t dst = stage * L::q_tile + hf * QT * ROWB;
          tma_load(base + L::q_off + dst, &tq, full(stage), c0, q0, b);
          tma_load(base + L::do_off + dst, &tdo, full(stage), c0, q0, b);
        }
      } else {
        mbar_arrive(full(stage));
      }
      // BIAS: the tile's bias (its queries by the CTA's keys) beside its Q
      // and dO, on the same barrier
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
    // -- the consumer warpgroup: 64 keys, rows of S^T --
    const int t = lane & 3;
    const int key0 = k0 + (tid / 32) * 16 + (lane >> 2);   // and +8
    const float scale2 = scale * kLog2e;
    int sk_id[2] = {0, 0};
    if (SEG) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int key = key0 + 8 * hr;
        sk_id[hr] = key < Sk ? seg_k[(size_t)b * Sk + key] : INT_MIN;
      }
    }
    float adk[NO], adv[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) adk[i] = adv[i] = 0.f;
    const uint32_t k_base = base + L::k_off;
    const uint32_t v_base = base + L::v_off;

    // DROP: the keep bits of query tile `kept_q0`, drawn while the
    // previous tile's dV and dK products run (below)
    [[maybe_unused]] FragKeep<QT> kept;
    [[maybe_unused]] int kept_q0 = -1;
    mbar_wait(keys_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      mbar_wait(full(stage), phase);
      const int qb = __shfl_sync(0xffffffffu, tile_idx[stage], 0);
      if (qb < 0) break;
      const int q0 = qb * QT;
      const uint32_t q_base = base + L::q_off + stage * L::q_tile;
      const uint32_t do_base = base + L::do_off + stage * L::q_tile;
      // the first tile's bits, or a tile's after one skipped for its
      // segment ids: drawn before the score products hold their registers
      if constexpr (DROP) {
        if (q0 != kept_q0)
          kept = frag_keep<QT, true>(ex, (uint32_t)b * H + h, key0, q0, t);
      }
      // BIAS: the stage's tile at (query q0, key key0), `bp` floats from
      // one query to the next. BIAS alone, a bias broadcast over queries
      // (a padding mask): the thread's two keys' values, read before the
      // score products are issued (read after their wait, the 32 reads
      // of the same two words made the tile 1.2x slower than reads of
      // device memory, which stay in flight across the wait; PERF.md)
      [[maybe_unused]] const int bp = ex.sq ? BT::pitch : 0;
      [[maybe_unused]] const float* bias_t =
          bias_tile<BT>(smem + L::bias_off, stage, ex) + (key0 - k0);
      [[maybe_unused]] float bkey[2];
      if constexpr (BIAS && !DROP) {
        if (bp == 0) {
          bkey[0] = bias_log2(bias_t[0]);
          bkey[1] = bias_log2(bias_t[8]);
        }
      }

      // S^T = K . Q^T and dP^T = V . dO^T, fp32
      float st[NS], dpt[NS];
      wgmma_fence();
      gemm_ss<D, QT, DKV_KEYS, QT>(st, k_base, q_base);
      gemm_ss<D, QT, DKV_KEYS, QT>(dpt, v_base, do_base);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(st);
      fence_regs(dpt);

      // P^T in place of S^T, dS^T = P^T * (dP^T - delta) in place of dP^T;
      // lse and delta belong to the columns (queries). With DROP or BIAS
      // (never both BIAS and SEG): p from the scores plus the bias. DROP:
      // dV's P^T the kept p and dS^T = p * (z dP^T - delta * (1 -
      // p_drop)), so that 1 / (1 - p_drop) scales dK and dV once, in the
      // epilogue; only tiles that can hold a masked pair test the masks,
      // as below. BIAS alone: every tile. The instantiations without them
      // compile the loop after it as before.
      if constexpr (DROP) {
        const float keep_p = 1.f / ex.rdrop;
        const float* lse_t = lse_s + stage * QT;
        const float* dlt_t = dlt_s + stage * QT;
        const int* segq_t = segq + stage * QT;
        if (SEG || q0 + QT > Sq || (causal && k0 + DKV_KEYS - 1 > q0))
          dkv_drop_tile<QT, SEG, BIAS, true>(
              st, dpt, kept, lse_t, dlt_t, segq_t, q0, key0, t, Sq, Sk,
              causal, sk_id, scale2, keep_p, bias_t, bp);
        else
          dkv_drop_tile<QT, SEG, BIAS, false>(
              st, dpt, kept, lse_t, dlt_t, segq_t, q0, key0, t, Sq, Sk,
              causal, sk_id, scale2, keep_p, bias_t, bp);
      } else if constexpr (BIAS) {
        // the loop over the tile, with the bias of (column, row) from
        // `bias_of`
        auto tile = [&](auto bias_of) {
#pragma unroll
          for (int j = 0; j < QT / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * j + 2 * t + e;
              const int q = q0 + col;
              const float l2 = lse_s[stage * QT + col];
              const float dl = dlt_s[stage * QT + col];
#pragma unroll
              for (int hr = 0; hr < 2; ++hr) {
                const int key = key0 + 8 * hr;
                const bool ok = q < Sq && key < Sk && (!causal || key <= q);
                const int i = 4 * j + 2 * hr + e;
                const float x = fmaf(st[i], scale2, bias_of(col, hr));
                const float p = ok ? exp2f(x - l2) : 0.f;
                st[i] = p;
                dpt[i] = p * (dpt[i] - dl);
              }
            }
          }
        };
        if (bp == 0)
          tile([&](int, int hr) { return bkey[hr]; });
        else
          tile([&](int col, int hr) {
            return bias_log2(bias_t[col * bp + 8 * hr]);
          });
      } else {
      const bool edge =
          SEG || q0 + QT > Sq || (causal && k0 + DKV_KEYS - 1 > q0);
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;
          const int q = q0 + col;
          const float l2 = lse_s[stage * QT + col];
          const float dl = dlt_s[stage * QT + col];
          const int qid = SEG ? segq[stage * QT + col] : 0;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const bool ok =
                !edge || (q < Sq && (!causal || key0 + 8 * hr <= q) &&
                          (!SEG || qid == sk_id[hr]));
            const int i = 4 * j + 2 * hr + e;
            const float p = ok ? exp2f(fmaf(st[i], scale2, -l2)) : 0.f;
            st[i] = p;
            dpt[i] = p * (dpt[i] - dl);
          }
        }
      }
      }
      uint32_t pa[QT / 16][4], da[QT / 16][4];
      to_a_frags<QT>(st, pa);
      to_a_frags<QT>(dpt, da);

      // dV += P^T . dO and dK += dS^T . Q, dO's and Q's tiles MN-major
      wgmma_fence();
      gemm_rs<D, QT>(adv, pa, do_base);
      gemm_rs<D, QT>(adk, da, q_base);
      wgmma_commit();
      // DROP: the next query tile's keep bits while both products are in
      // flight, on the integer pipe beside the tensor cores; every column
      // block is drawn (skipping those before the causal diagonal cost
      // more than it saved). Drawn here rather than under the score
      // products, whose accumulators hold 64 more registers, the kernel
      // fits two CTAs an SM at d = 64 without spilling (PERF.md).
      if constexpr (DROP) {
        kept_q0 = q0 + QT;
        if (kept_q0 < Sq) {
          kept = frag_keep<QT, true>(ex, (uint32_t)b * H + h, key0, kept_q0,
                                     t);
          fence_keep(kept);
        }
      }
      wgmma_wait0();
      fence_regs(adv);
      fence_regs(adk);
      mbar_arrive(empty(stage));
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    if constexpr (DROP) {   // the kept p and dS were not scaled
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        adk[i] *= ex.rdrop;
        adv[i] *= ex.rdrop;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int key = key0 + 8 * hr;
      if (key < Sk) {
        const size_t at = ((size_t)b * Sk + key) * H * D + h * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int c = 8 * j + 2 * t;
          *reinterpret_cast<__nv_bfloat162*>(dk + at + c) =
              __floats2bfloat162_rn(adk[4 * j + 2 * hr] * scale,
                                    adk[4 * j + 2 * hr + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + at + c) =
              __floats2bfloat162_rn(adv[4 * j + 2 * hr],
                                    adv[4 * j + 2 * hr + 1]);
        }
      }
    }
  }
}

// One launch of either kernel, as launch_fp32. Every operand needs a
// 16-byte-aligned base and row stride (TMA); a map that cannot be encoded
// returns its error and nothing is launched.
template <int D, bool SEG, bool DROP, bool BIAS>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* seg_q, const void* seg_k, void* dq_or_dk,
                   void* dv, int batch, int Sq, int Sk, int H, int qs, int ks,
                   int vs, int dos, float scale, int causal,
                   const AttnExtra& ex, cudaStream_t stream) {
  const size_t out_bytes =
      (size_t)batch * (dv == nullptr ? Sq : Sk) * H * D * 2;
  if ((dv == nullptr ? Sk : Sq) == 0) {   // nothing to attend: zeros
    cudaError_t err = cudaMemsetAsync(dq_or_dk, 0, out_bytes, stream);
    if (err == cudaSuccess && dv != nullptr)
      err = cudaMemsetAsync(dv, 0, out_bytes, stream);
    return err;
  }
  const int qrows = dv == nullptr ? DQ_ROWS : DKV_QT;
  const int krows = dv == nullptr ? DQ_KT : DKV_KEYS;
  CUtensorMap mq, mk, mv, mdo, mb;
  cudaError_t err = make_map(&mq, q, H * D, Sq, batch, qs, qrows);
  if (err == cudaSuccess) err = make_map(&mdo, dout, H * D, Sq, batch, dos,
                                         qrows);
  if (err == cudaSuccess) err = make_map(&mk, k, H * D, Sk, batch, ks, krows);
  if (err == cudaSuccess) err = make_map(&mv, v, H * D, Sk, batch, vs, krows);
  if (err == cudaSuccess)
    err = dv == nullptr
              ? bias_map<BIAS, typename DqSmem<D>::Bias>(&mb, ex, batch, H,
                                                         Sq, Sk)
              : bias_map<BIAS, typename DkvSmem<D>::Bias>(&mb, ex, batch, H,
                                                          Sq, Sk);
  if (err != cudaSuccess) return err;
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_k);
  if (dv == nullptr) {
    using L = DqSmem<D>;
    const int smem = launch_smem<L, BIAS>(ex);
    err = cudaFuncSetAttribute(flash_dq_kernel_sm90<D, SEG, DROP, BIAS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BIAS ? L::bias_bytes : L::bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + DQ_ROWS - 1) / DQ_ROWS, H, batch);
    flash_dq_kernel_sm90<D, SEG, DROP, BIAS><<<grid, NT, smem, stream>>>(
        mq, mk, mv, mdo, lp, dp, sq, sk,
        static_cast<__nv_bfloat16*>(dq_or_dk), Sq, Sk, H, scale, causal, ex,
        mb);
  } else {
    using L = DkvSmem<D>;
    const int smem = launch_smem<L, BIAS>(ex);
    err = cudaFuncSetAttribute(flash_dkv_kernel_sm90<D, SEG, DROP, BIAS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BIAS ? L::bias_bytes : L::bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sk + DKV_KEYS - 1) / DKV_KEYS, H, batch);
    flash_dkv_kernel_sm90<D, SEG, DROP, BIAS><<<grid, NT, smem, stream>>>(
        mq, mk, mv, mdo, lp, dp, sq, sk,
        static_cast<__nv_bfloat16*>(dq_or_dk),
        static_cast<__nv_bfloat16*>(dv), Sq, Sk, H, scale, causal, ex, mb);
  }
  return cudaGetLastError();
}

}  // namespace sm90

template <bool SEG, bool DROP, bool BIAS>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, const void* seg_q,
             const void* seg_k, void* dq_or_dk, void* dv, int batch, int Sq,
             int Sk, int H, int D, int qs, int ks, int vs, int dos,
             float scale, int causal, int dtype, const AttnExtra& ex,
             void* stream) {
  if (batch < 0 || Sq < 0 || Sk < 0 || H < 0 || (causal && Sq != Sk))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || H == 0 || (dv == nullptr ? Sq : Sk) == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_LAUNCH(FN, DD)                                                  \
  return (int)FN<DD, SEG, DROP, BIAS>(q, k, v, dout, lse, delta, seg_q,     \
                                      seg_k, dq_or_dk, dv, batch, Sq, Sk, H, \
                                      qs, ks, vs, dos, scale, causal, ex, s)
  if (dtype == 0 && D == 64) PTT_LAUNCH(launch_fp32, 64);
  if (dtype == 0 && D == 128) PTT_LAUNCH(launch_fp32, 128);
  if (dtype == 1 && D == 64) PTT_LAUNCH(sm90::launch, 64);
  if (dtype == 1 && D == 128) PTT_LAUNCH(sm90::launch, 128);
#undef PTT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace
