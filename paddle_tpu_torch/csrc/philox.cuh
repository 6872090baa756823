// The flash kernels' two optional features (flash_fwd.cuh, flash_bwd.cuh),
// compiled in only where a template asks for them:
//
//   DROP  attention dropout on the probabilities, the JAX package's
//         `_sdpa_ref` / `xla_segment_attention` semantics: p' = keep * p /
//         (1 - dropout_p), with lse that of the undropped softmax. The keep
//         bits come from Philox4x32-10 (Salmon et al., SC'11), keyed by the
//         call's (seed, offset) and counted by the element's logical
//         (b, h, i, j) index, so they do not depend on the tiling and the
//         backward kernels regenerate exactly the forward's bits. With
//         x' = ((x >> 4) << 3) | (x & 7) (x without its bit 3) and
//         bit(x) = (x >> 3) & 1:
//           key     (seed mod 2^32, (seed >> 32) xor (offset >> 32))
//           counter (j', i', b * H + h, offset mod 2^32)
//         and element (b, h, i, j) is kept when word 2 * bit(i) + bit(j)
//         of the result is below floor((1 - dropout_p) * 2^32). One call
//         thus gives the four entries {a, a + 8} x {c, c + 8} (a, c with
//         bit 3 clear): exactly four entries that one thread holds in a
//         wgmma accumulator fragment (rows r and r + 8, one column of two
//         adjacent 8-column blocks; sm90.cuh), whether its rows are queries
//         (the forward, dQ) or keys (dK/dV), since every tile's first row
//         and column are multiples of 16. `frag_keep` draws a fragment's
//         bits at one call per four entries. ops/kernels/philox.py
//         computes the same bits in plain PyTorch.
//   BIAS  an additive fp32 bias (B, H, Sq, Sk) read at four element
//         strides (0 on a broadcast dimension, and on a dimension of size
//         1), added to the scaled scores in log2 units: s * scale * log2 e
//         + bias * log2 e. A bias below -1e29 in log2 units counts as
//         -1e29, above the kernels' -1e30 sentinel: a row masked
//         everywhere stays uniform (as in the JAX package's dense softmax)
//         and a masked entry beside a visible one gets exactly 0. The fp32
//         bodies read each entry from device memory (`bias2`). The bf16
//         Hopper bodies read it from shared memory: the producer warp
//         stages each ring stage's bias tile beside the K/V (or Q/dO) tile
//         it belongs to (`BiasTile`, below), by TMA where the layout allows
//         it and by cp.async otherwise, and arrives on the same `full`
//         barrier; the consumers read their fragment entries from the tile.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// What a launch passes for DROP and BIAS (ignored by the instantiations
// without them).
struct AttnExtra {
  const float* bias;         // BIAS: (B, H, Sq, Sk) fp32
  int sb, sh, sq, sk;        // its element strides
  uint32_t k0, k1, off;      // DROP: Philox key and counter word 3
  uint32_t thresh;           // keep where the word is below this
  float rdrop;               // 1 / (1 - dropout_p)
  int bias_tma;              // BIAS, bf16: the tile comes by TMA (else
                             // cp.async); the host's `bias_route` decides
};

constexpr float kBiasLog2e = 1.4426950408889634f;
constexpr float kBiasFloor = -1e29f;   // log2 units

// a bias value in log2 units, floored at kBiasFloor
__device__ __forceinline__ float bias_log2(float v) {
  return fmaxf(v * kBiasLog2e, kBiasFloor);
}

// the bias of (b, h, i, j) in log2 units from device memory (fp32 bodies)
__device__ __forceinline__ float bias2(const AttnExtra& x, int b, int h,
                                       int i, int j) {
  return bias_log2(x.bias[(long long)b * x.sb + (long long)h * x.sh +
                          (long long)i * x.sq + (long long)j * x.sk]);
}

namespace sm90 {

// The bf16 bodies' BIAS tile: per ring stage, the bias of ROWS queries by
// COLS keys, fp32, query-major: entry (query q0 + r, key k0 + c) at float
// r * pitch + c, where the pitch is PITCH, or 0 when the bias broadcasts
// over queries (sq == 0: one row is staged and every query reads it).
// The tile's rows are queries in all three kernels; the forward's and
// dQ's fragments hold queries as rows, dK/dV's keys as rows.
//   Bank conflicts against the fragment's reads (thread (warp w, lane l)
//   of a warpgroup holds columns 8j + 2(l%4) + {0,1} of rows l/4 and
//   l/4 + 8):
//   * forward and dQ (keys are the tile's columns): a thread reads the
//     float2 of its two adjacent columns; a half-warp's 16 float2 lie in
//     rows l/4 = 0..3 at columns 2t, so PITCH = COLS + 8 (= 8 mod 32
//     words) puts the four rows 8 words apart and the 16 float2 on 32
//     distinct banks;
//   * dK/dV (queries are the tile's rows, keys its columns): a thread reads
//     single floats at rows 2t + e (queries) and columns l/4 (keys), so
//     PITCH = COLS + 4 puts rows 2t at 8t mod 32 words and a warp's 32
//     reads on 32 distinct banks;
//   * at pitch 0 the lanes that share a column read one word (broadcast).
// TMA copies a box of PITCH columns by ROWS rows (1 at pitch 0) into the
// tile as it lies (no swizzle; the columns past COLS are read and not
// used, those past Sk are zero-filled); the cp.async route copies the
// ROWS x COLS entries one float each, skipping those past Sq or Sk (which
// the consumers mask).
template <int ROWS, int COLS, int PITCH> struct BiasTile {
  static constexpr int rows = ROWS;
  static constexpr int cols = COLS;
  static constexpr int pitch = PITCH;
  static constexpr int bytes = ROWS * PITCH * 4;   // a stage's tile
  static_assert(bytes % 1024 == 0, "stages start on 1024 bytes");
};

// a stage's bytes of shared memory: the tile, or 1 KB for its one row at
// pitch 0 (a launch then asks for that much less, which lets a dQ CTA
// with a padding mask share an SM three ways, as without a bias)
template <typename BT>
__host__ __device__ __forceinline__ int bias_stage_bytes(const AttnExtra& x) {
  static_assert(BT::pitch * 4 <= 1024, "a row fits 1 KB");
  return x.sq ? BT::bytes : 1024;
}

// a launch's dynamic shared memory for layout L (flash_fwd.cuh's Smem,
// flash_bwd.cuh's DqSmem, DkvSmem): with BIAS, the bias region after the
// rest at this launch's stage size
template <typename L, bool BIAS>
inline int launch_smem(const AttnExtra& x) {
  return BIAS ? L::bias_off +
                    L::stages * bias_stage_bytes<typename L::Bias>(x) + 1024
              : L::bytes;
}

// stage `stage`'s tile in the bias region at `region`
template <typename BT>
__device__ __forceinline__ const float* bias_tile(const uint8_t* region,
                                                  int stage,
                                                  const AttnExtra& x) {
  return reinterpret_cast<const float*>(region +
                                        stage * bias_stage_bytes<BT>(x));
}

// the bytes a stage's TMA box brings (the full box: TMA counts the
// zero-filled part too)
template <typename BT>
__device__ __forceinline__ uint32_t bias_tx_bytes(const AttnExtra& x) {
  return (uint32_t)BT::pitch * (x.sq ? BT::rows : 1) * 4u;
}

// The producer warp's share of a stage's bias tile at (q0, k0) of (b, h)
// into shared memory at `dst` (every lane calls it). TMA: lane 0 issues
// the box, completing on `bar` (whose expected bytes the caller counts:
// bias_tx_bytes); cp.async: the lanes copy the entries, queries fastest
// when queries are the contiguous dimension (a transposed mask), else
// keys fastest, and each lane then arrives on `bar` when its copies have
// landed (cp.async.mbarrier.arrive.noinc: the barrier counts these 32
// arrivals beside the lanes' own).
template <typename BT>
__device__ __forceinline__ void stage_bias(uint32_t dst, const CUtensorMap* tb,
                                           uint32_t bar, const AttnExtra& x,
                                           int b, int h, int q0, int k0,
                                           int Sq, int Sk, int lane) {
  if (x.bias_tma) {
    if (lane == 0)
      tma_load4(dst, tb, bar, k0, x.sq ? q0 : 0, x.sh ? h : 0, x.sb ? b : 0);
    return;
  }
  const float* src = x.bias + (long long)b * x.sb + (long long)h * x.sh +
                     (long long)q0 * x.sq + (long long)k0 * x.sk;
  const int rows = x.sq ? min(BT::rows, Sq - q0) : 1;
  const int cols = min(BT::cols, Sk - k0);
  if (x.sq == 1 && x.sk != 1) {
    for (int c = 0; c < cols; ++c)
      for (int r = lane; r < rows; r += 32)
        cp_async4(dst + 4u * (r * BT::pitch + c),
                  src + (long long)r * x.sq + (long long)c * x.sk);
  } else {
    for (int r = 0; r < rows; ++r)
      for (int c = lane; c < cols; c += 32)
        cp_async4(dst + 4u * (r * BT::pitch + c),
                  src + (long long)r * x.sq + (long long)c * x.sk);
  }
  cp_async_arrive_noinc(bar);
}

// a full barrier's arrival count: the producer warp's 32 lanes, and with
// the cp.async route their 32 cp.async arrivals
template <bool BIAS>
__device__ __forceinline__ uint32_t full_count(const AttnExtra& x) {
  return BIAS && !x.bias_tma ? 64u : 32u;
}

// a producer lane's arrival on the end marker's full barrier: twice where
// the barrier also counts the cp.async arrivals (no copy comes with it)
template <bool BIAS>
__device__ __forceinline__ void end_arrive(uint32_t bar, const AttnExtra& x) {
  mbar_arrive(bar);
  if (BIAS && !x.bias_tma) mbar_arrive(bar);
}

// The TMA map of a bias (B, H, Sq, Sk) at its element strides: 4-D {Sk,
// Sq, H, B} with box {PITCH, ROWS or 1, 1, 1}, no swizzle; a dimension of
// stride 0 has size 1 (the kernel reads coordinate 0 there) and a stride
// that no read uses. Only for the layouts `bias_route` sends to TMA: key
// stride 1, 16-byte-aligned base, the other strides multiples of 4.
template <typename BT>
inline cudaError_t make_bias_map(CUtensorMap* map, const AttnExtra& x,
                                 int batch, int H, int Sq, int Sk) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  if (x.sk != 1 || reinterpret_cast<uintptr_t>(x.bias) % 16 || x.sq % 4 ||
      x.sh % 4 || x.sb % 4)
    return cudaErrorMisalignedAddress;
  const cuuint64_t dims[4] = {(cuuint64_t)Sk, x.sq ? (cuuint64_t)Sq : 1,
                              x.sh ? (cuuint64_t)H : 1,
                              x.sb ? (cuuint64_t)batch : 1};
  // bytes; a broadcast dimension takes the extent of those inside it
  cuuint64_t strides[3];
  const long long given[3] = {x.sq, x.sh, x.sb};
  cuuint64_t extent = ((cuuint64_t)Sk * 4 + 15) / 16 * 16;
  for (int i = 0; i < 3; ++i) {
    strides[i] = given[i] ? (cuuint64_t)given[i] * 4 : extent;
    extent = strides[i] * dims[i + 1] > extent ? strides[i] * dims[i + 1]
                                               : extent;
  }
  const cuuint32_t box[4] = {(cuuint32_t)BT::pitch,
                             x.sq ? (cuuint32_t)BT::rows : 1u, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x.bias),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a launch's bias map: encoded for a BIAS instantiation on the TMA route,
// else left zero (the kernel never reads it)
template <bool BIAS, typename BT>
inline cudaError_t bias_map(CUtensorMap* map, const AttnExtra& x, int batch,
                            int H, int Sq, int Sk) {
  *map = CUtensorMap{};
  return BIAS && x.bias_tma ? make_bias_map<BT>(map, x, batch, H, Sq, Sk)
                            : cudaSuccess;
}

}  // namespace sm90

// Philox4x32-10: counter (c.x, c.y, c.z, c.w), key (k0, k1)
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// x without its bit 3: the counter word of a query or key index
__device__ __forceinline__ uint32_t drop_bit3(int x) {
  return (((uint32_t)x >> 4) << 3) | ((uint32_t)x & 7u);
}

// Philox of the block {i, i + 8} x {j, j + 8} (bit 3 of i and j clear):
// words x (i, j), y (i, j + 8), z (i + 8, j), w (i + 8, j + 8)
__device__ __forceinline__ uint4 philox_at(const AttnExtra& x, uint32_t bh,
                                           int i, int j) {
  return philox4x32_10(make_uint4(drop_bit3(j), drop_bit3(i), bh, x.off),
                       x.k0, x.k1);
}

__device__ __forceinline__ uint32_t word(const uint4& r, int w) {
  return w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
}

// whether element (bh, i, j) is kept: a call per element (the fp32 bodies)
__device__ __forceinline__ bool keep1(const AttnExtra& x, uint32_t bh, int i,
                                      int j) {
  return word(philox_at(x, bh, i, j), ((i >> 2) & 2) | ((j >> 3) & 1)) <
         x.thresh;
}

// A thread's keep bits for its accumulator fragment of a 64 x N score
// tile: bit n of word n / 32 for d[n].
template <int N> struct FragKeep {
  uint32_t w[(N / 2 + 31) / 32];
  __device__ __forceinline__ bool operator[](int n) const {
    return (w[n >> 5] >> (n & 31)) & 1u;
  }
};

// The keep bits of a thread's accumulator fragment of a 64 x N score tile
// (sm90.cuh: d[4j + 2hr + e] is row r0 + 8hr, column c0 + 8j + 2t + e);
// r0 and c0 have bit 3 clear. Rows are queries (the forward, dQ) or keys
// (dK/dV: KEYS_BY_ROW). One Philox call per 16-column block u and e gives
// the four entries {r0, r0 + 8} x {c, c + 8}, c = c0 + 16u + 2t + e: 2
// calls a block instead of 4 (forward, dQ), or of 8 (dK/dV, whose two
// rows are keys 8 apart). Every column block is drawn, branch-free, also
// past the causal diagonal or Sk: a skip put each call in a branch of its
// own and cost more than the calls it saved in all three kernels
// (PERF.md). The bits depend on nothing but the entries' (b, h, i, j), so
// a kernel can draw them while its products are in flight.
template <int N, bool KEYS_BY_ROW>
__device__ __forceinline__ FragKeep<N> frag_keep(const AttnExtra& x,
                                                 uint32_t bh, int r0, int c0,
                                                 int t) {
  // word y is element (i, j + 8): with queries as rows the next 8-column
  // block (d + 4), with keys as rows the next row (d + 2)
  constexpr int YO = KEYS_BY_ROW ? 2 : 4;
  FragKeep<N> m;
#pragma unroll
  for (int k = 0; k < (N / 2 + 31) / 32; ++k) m.w[k] = 0;
#pragma unroll
  for (int u = 0; u < N / 16; ++u) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + 16 * u + 2 * t + e;
      const uint4 r = KEYS_BY_ROW ? philox_at(x, bh, c, r0)
                                  : philox_at(x, bh, r0, c);
      // d[8u + e .. 8u + e + 6] lie in one word
      const int n = (8 * u + e) & 31;
      m.w[(8 * u) >> 5] |= (uint32_t)(r.x < x.thresh) << n |
                           (uint32_t)(r.y < x.thresh) << (n + YO) |
                           (uint32_t)(r.z < x.thresh) << (n + 6 - YO) |
                           (uint32_t)(r.w < x.thresh) << (n + 6);
    }
  }
  return m;
}

// ties a fragment's keep bits to this point of the program: drawn before
// the wgmma wait that follows
template <int N>
__device__ __forceinline__ void fence_keep(FragKeep<N>& m) {
#pragma unroll
  for (int k = 0; k < (N / 2 + 31) / 32; ++k) asm volatile("" : "+r"(m.w[k]));
}

// The host side of a launch: the key and threshold from (seed, offset,
// dropout_p), and the bias pointer, strides and copy route.
inline AttnExtra make_extra(const void* bias, int sb, int sh, int sq, int sk,
                            int bias_tma, float dropout_p,
                            unsigned long long seed,
                            unsigned long long offset) {
  AttnExtra x;
  x.bias = static_cast<const float*>(bias);
  x.sb = sb;
  x.sh = sh;
  x.sq = sq;
  x.sk = sk;
  x.bias_tma = bias_tma;
  x.k0 = (uint32_t)seed;
  x.k1 = (uint32_t)(seed >> 32) ^ (uint32_t)(offset >> 32);
  x.off = (uint32_t)offset;
  const double keep = 1.0 - (double)dropout_p;
  x.thresh = keep >= 1.0 ? 0xFFFFFFFFu : (uint32_t)(keep * 4294967296.0);
  x.rdrop = 1.0f / (1.0f - dropout_p);
  return x;
}

}  // namespace
