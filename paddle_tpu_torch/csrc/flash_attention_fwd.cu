// The forward entries without dropout or a bias (flash_fwd.cuh holds the
// kernels and their notes): K-PACK and K-BSHD `flash_attention_fwd_packed`,
// K-SEG `flash_attention_fwd_packed_seg`.

#include "flash_fwd.cuh"

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
  return dispatch<false, false, false>(
      q, k, v, nullptr, nullptr, o, lse, batch, sq, sk, heads, head_dim,
      q_rs, k_rs, v_rs, scale, causal, dtype, AttnExtra{}, stream);
}

// The K-SEG entry with a row stride per operand: seg_q (B, sq) and seg_k
// (B, sk) int32 (the same pointer for self-attention); causal needs
// sq == sk.
extern "C" int flash_attention_fwd_packed_seg(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* seg_k, void* o, void* lse, int batch, int sq, int sk,
    int heads, int head_dim, int q_rs, int k_rs, int v_rs, float scale,
    int causal, int dtype, void* stream) {
  return dispatch<true, false, false>(
      q, k, v, seg_q, seg_k, o, lse, batch, sq, sk, heads, head_dim, q_rs,
      k_rs, v_rs, scale, causal, dtype, AttnExtra{}, stream);
}
