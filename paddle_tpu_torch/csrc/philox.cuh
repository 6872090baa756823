// The flash kernels' two optional features (flash_fwd.cuh, flash_bwd.cuh),
// compiled in only where a template asks for them:
//
//   DROP  attention dropout on the probabilities, the JAX package's
//         `_sdpa_ref` / `xla_segment_attention` semantics: p' = keep * p /
//         (1 - dropout_p), with lse that of the undropped softmax. The keep
//         bits come from Philox4x32-10 (Salmon et al., SC'11), keyed by the
//         call's (seed, offset) and counted by the element's logical
//         (b, h, i, j) index, so they do not depend on the tiling and the
//         backward kernels regenerate exactly the forward's bits:
//           key     (seed mod 2^32, (seed >> 32) xor (offset >> 32))
//           counter (j / 4, i, b * H + h, offset mod 2^32)
//         and element (b, h, i, j) is kept when word j mod 4 of the result
//         is below floor((1 - dropout_p) * 2^32). ops/kernels/philox.py
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

__device__ __forceinline__ uint4 philox_at(const AttnExtra& x, uint32_t bh,
                                           int i, int j) {
  return philox4x32_10(make_uint4((uint32_t)j >> 2, (uint32_t)i, bh, x.off),
                       x.k0, x.k1);
}

__device__ __forceinline__ uint32_t word(const uint4& r, int w) {
  return w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
}

// whether element (bh, i, j) is kept
__device__ __forceinline__ bool keep1(const AttnExtra& x, uint32_t bh, int i,
                                      int j) {
  return word(philox_at(x, bh, i, j), j & 3) < x.thresh;
}

// elements (bh, i, j) and (bh, i, j + 1) for an even j: one Philox call
__device__ __forceinline__ void keep2(const AttnExtra& x, uint32_t bh, int i,
                                      int j, bool& k_a, bool& k_b) {
  const uint4 r = philox_at(x, bh, i, j);
  const bool hi = j & 2;
  k_a = (hi ? r.z : r.x) < x.thresh;
  k_b = (hi ? r.w : r.y) < x.thresh;
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
