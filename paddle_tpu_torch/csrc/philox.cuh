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
//         strides (0 on a broadcast dimension), added to the scaled scores
//         in log2 units: s * scale * log2 e + bias * log2 e. A bias below
//         -1e29 in log2 units counts as -1e29, above the kernels' -1e30
//         sentinel: a row masked everywhere stays uniform (as in the JAX
//         package's dense softmax) and a masked entry beside a visible one
//         gets exactly 0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// What a launch passes for DROP and BIAS (ignored by the instantiations
// without them).
struct AttnExtra {
  const float* bias;         // BIAS: (B, H, Sq, Sk) fp32
  int sb, sh, sq, sk;        // its element strides
  uint32_t k0, k1, off;      // DROP: Philox key and counter word 3
  uint32_t thresh;           // keep where the word is below this
  float rdrop;               // 1 / (1 - dropout_p)
};

constexpr float kBiasLog2e = 1.4426950408889634f;
constexpr float kBiasFloor = -1e29f;   // log2 units

// the bias of (b, h, i, j) in log2 units, floored at kBiasFloor
__device__ __forceinline__ float bias2(const AttnExtra& x, int b, int h,
                                       int i, int j) {
  const float v = x.bias[(long long)b * x.sb + (long long)h * x.sh +
                         (long long)i * x.sq + (long long)j * x.sk];
  return fmaxf(v * kBiasLog2e, kBiasFloor);
}

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

// every column block of a tile is drawn (frag_keep's default)
struct AllLive {
  __device__ __forceinline__ bool operator()(int) const { return true; }
};

// The keep bits of a thread's accumulator fragment of a 64 x N score tile
// (sm90.cuh: d[4j + 2hr + e] is row r0 + 8hr, column c0 + 8j + 2t + e);
// r0 and c0 have bit 3 clear. Rows are queries (the forward, dQ) or keys
// (dK/dV: KEYS_BY_ROW). One Philox call per 16-column block u and e gives
// the four entries {r0, r0 + 8} x {c, c + 8}, c = c0 + 16u + 2t + e: 2
// calls a block instead of 4 (forward, dQ), or of 8 (dK/dV, whose two
// rows are keys 8 apart). Where `live(c)` is false the four entries are
// masked anyway: no call, bits 0; each call then sits in a branch of its
// own, which keeps the compiler from interleaving the calls' chains of
// dependent rounds (and so from spending registers on them). With the
// default `live` the calls are branch-free. The bits depend on nothing
// but the entries' (b, h, i, j), so a kernel can draw them while its
// score product is in flight.
template <int N, bool KEYS_BY_ROW, typename Live = AllLive>
__device__ __forceinline__ FragKeep<N> frag_keep(const AttnExtra& x,
                                                 uint32_t bh, int r0, int c0,
                                                 int t, Live live = {}) {
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
      if (!live(c)) continue;
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
// dropout_p), and the bias pointer and strides.
inline AttnExtra make_extra(const void* bias, int sb, int sh, int sq, int sk,
                            float dropout_p, unsigned long long seed,
                            unsigned long long offset) {
  AttnExtra x;
  x.bias = static_cast<const float*>(bias);
  x.sb = sb;
  x.sh = sh;
  x.sq = sq;
  x.sk = sk;
  x.k0 = (uint32_t)seed;
  x.k1 = (uint32_t)(seed >> 32) ^ (uint32_t)(offset >> 32);
  x.off = (uint32_t)offset;
  const double keep = 1.0 - (double)dropout_p;
  x.thresh = keep >= 1.0 ? 0xFFFFFFFFu : (uint32_t)(keep * 4294967296.0);
  x.rdrop = 1.0f / (1.0f - dropout_p);
  return x;
}

}  // namespace
