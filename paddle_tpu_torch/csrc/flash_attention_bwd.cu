// The backward entries without dropout or a bias (flash_bwd.cuh holds the
// kernels and their notes): K-DQ and K-BDQ `flash_attention_bwd_dq`, K-DKV
// and K-BDKV `flash_attention_bwd_dkv`, K-SDQ `flash_attention_bwd_dq_seg`,
// K-SDKV `flash_attention_bwd_dkv_seg`.

#include "flash_bwd.cuh"

// dtype: 0 = float32, 1 = bfloat16. q_rs, k_rs, v_rs, do_rs: row strides in
// elements. lse, delta: (B, Sq, NH) fp32. Returns a cudaError_t (0 =
// launched).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int batch, int sq, int sk,
                                      int heads, int head_dim, int q_rs,
                                      int k_rs, int v_rs, int do_rs,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  return dispatch<false, false, false>(
      q, k, v, dout, lse, delta, nullptr, nullptr, dq, nullptr, batch, sq,
      sk, heads, head_dim, q_rs, k_rs, v_rs, do_rs, scale, causal, dtype,
      AttnExtra{}, stream);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int batch, int sq,
                                       int sk, int heads, int head_dim,
                                       int q_rs, int k_rs, int v_rs,
                                       int do_rs, float scale, int causal,
                                       int dtype, void* stream) {
  if (dv == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<false, false, false>(
      q, k, v, dout, lse, delta, nullptr, nullptr, dk, dv, batch, sq, sk,
      heads, head_dim, q_rs, k_rs, v_rs, do_rs, scale, causal, dtype,
      AttnExtra{}, stream);
}

// Within segments: seg_q (B, sq) and seg_k (B, sk) int32 (the same pointer
// for self-attention); causal needs sq == sk.
extern "C" int flash_attention_bwd_dq_seg(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* seg_k,
    void* dq, int batch, int sq, int sk, int heads, int head_dim, int q_rs,
    int k_rs, int v_rs, int do_rs, float scale, int causal, int dtype,
    void* stream) {
  return dispatch<true, false, false>(
      q, k, v, dout, lse, delta, seg_q, seg_k, dq, nullptr, batch, sq, sk,
      heads, head_dim, q_rs, k_rs, v_rs, do_rs, scale, causal, dtype,
      AttnExtra{}, stream);
}

extern "C" int flash_attention_bwd_dkv_seg(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* seg_k,
    void* dk, void* dv, int batch, int sq, int sk, int heads, int head_dim,
    int q_rs, int k_rs, int v_rs, int do_rs, float scale, int causal,
    int dtype, void* stream) {
  if (dv == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<true, false, false>(
      q, k, v, dout, lse, delta, seg_q, seg_k, dk, dv, batch, sq, sk, heads,
      head_dim, q_rs, k_rs, v_rs, do_rs, scale, causal, dtype, AttnExtra{},
      stream);
}
