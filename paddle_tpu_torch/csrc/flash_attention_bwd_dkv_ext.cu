// The dkv entry with dropout or a bias (philox.cuh; the kernels and
// their notes are flash_bwd.cuh's): K-BDKV, K-DKV and K-SDKV
// instantiated with DROP and BIAS. A file of its own so that nvcc builds
// these instantiations beside the others, not after them.

#include "flash_bwd.cuh"

// The segmented entry's arguments (seg_q, seg_k null: no segment ids),
// plus bias (B, H, sq, sk) fp32 at element strides bias_sb .. bias_sk
// (0 where it broadcasts; null: no bias) and bias_tma (its bf16 tile by
// TMA, else by cp.async: the caller's `bias_route`), dropout_p in [0, 1)
// and the forward's Philox (seed, offset). At least one of dropout_p > 0
// and a bias; segment ids take no bias.
extern "C" int flash_attention_bwd_dkv_ext(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* seg_k,
    const void* bias, void* dk, void* dv, int batch, int sq, int sk,
    int heads, int head_dim, int q_rs, int k_rs, int v_rs, int do_rs,
    int bias_sb, int bias_sh, int bias_sq, int bias_sk, int bias_tma,
    float scale, int causal, float dropout_p, unsigned long long seed,
    unsigned long long offset, int dtype, void* stream) {
  if (dv == nullptr) return (int)cudaErrorInvalidValue;
  const bool seg = seg_q != nullptr, drop = dropout_p > 0.f;
  if (!(dropout_p >= 0.f && dropout_p < 1.f) || (seg && bias != nullptr) ||
      (!drop && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  const AttnExtra ex = make_extra(bias, bias_sb, bias_sh, bias_sq, bias_sk,
                                  bias_tma, dropout_p, seed, offset);
#define PTT_DISPATCH(S, DR, BI)                                       \
  return dispatch<S, DR, BI>(q, k, v, dout, lse, delta, seg_q, seg_k, \
                             dk, dv, batch, sq, sk, heads, head_dim,  \
                             q_rs, k_rs, v_rs, do_rs, scale, causal,  \
                             dtype, ex, stream)
  if (seg) PTT_DISPATCH(true, true, false);
  if (drop && bias != nullptr) PTT_DISPATCH(false, true, true);
  if (drop) PTT_DISPATCH(false, true, false);
  PTT_DISPATCH(false, false, true);
#undef PTT_DISPATCH
}
