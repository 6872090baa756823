// Paged attention for Hopper, sm_90a: decode (K-DEC, K-DEC8) and the
// speculative-decoding verify window (K-MQ, K-MQ8).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/paged_attention.py:
//   * `_decode_kernel` (launched by `_paged_call`): one query token per
//     request against K/V history scattered over the pages of a shared
//     pool; with `quantized=True` the pools are int8 and a per-page scale
//     pool rides the page table (K-DEC8);
//   * `_mq_kernel` (launched by `paged_multiquery_attention`): a window of
//     qlen query tokens per request, causal within the window (K-MQ, and
//     K-MQ8 over int8 pools).
//
//   q          (B, qlen, nh, d)      fp32 or bf16 (decode: qlen 1, (B, nh, d))
//   k/v_pages  (P, page_size, nh_kv * d)   q's dtype, or int8 with scales
//   scales     (P, 2, nh_kv) fp32    [0] K, [1] V per page and kv head
//   page_table (B, max_pages) int32, seq_lens (B,) int32
//   out        (B, qlen, nh, d)      q's dtype
//
// Row i of a window sees key positions < seq_len - qlen + i + 1, so a
// window row computes what a decode at that length would (qlen 1 is the
// decode). seq_len 0 writes zeros.
//
// What bounds it on the H100: the bytes of K/V it reads, about
// sum_b seq_len_b * 2 * nh_kv * d * elem per layer (elem 1 for int8),
// against ~4 * qlen * d FLOPs per KV row and head; tensor cores cannot
// help a handful of query rows.
// What the design does about it:
//   * one CTA per (request, query head), 4 warps; each warp walks its
//     own tokens (4 at a time, K and V rows loaded before any arithmetic
//     so eight row loads are in flight per warp), each lane owning d/32
//     contiguous elements, so a K/V row is one coalesced warp load (an
//     int8 row of d 64 is one 2-byte load per lane);
//   * every K/V row is read ONCE for all qlen window rows: each warp keeps
//     qlen sets of (m, l, acc) in registers, as the TPU kernel read each
//     page once per grid step for all rows;
//   * the loop runs only over the request's own tokens: pages past
//     ceil(seq_len / page_size) are never touched (the TPU kernel had to
//     fetch and mask every page of the table);
//   * int8: the dequant is fused as on the TPU, never a fp32 copy of the
//     cache: s = (q . k_i8) * (scale * log2 e * k_scale) and
//     acc += (p * v_scale) * v_i8, the page's two scales read beside the
//     page id;
//   * fp32 online softmax in base 2 (log2 e folded into the scale), merged
//     across warps in shared memory at the end;
//   * a padding row with seq_len 1 and page 0 reads one slot of the
//     reserved garbage page like any other row.
// GQA maps query head h to kv head h / (nh / nh_kv).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kUnroll = 4;
constexpr int kMaxQlen = 8;        // the widest verify window K-MQ takes
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// E contiguous elements (E = d / 32 = 2 or 4) as one vector load.
template <typename T, int E> struct Vec;
template <> struct Vec<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  }
};
template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* o) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = f.x; o[1] = f.y;
  }
};
template <> struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* o) {
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
    const float2 a = __bfloat1622float2(p2[0]);
    const float2 b = __bfloat1622float2(p2[1]);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
};
template <> struct Vec<int8_t, 2> {
  static __device__ __forceinline__ void load(const int8_t* p, float* o) {
    const char2 v = *reinterpret_cast<const char2*>(p);
    o[0] = static_cast<float>(v.x); o[1] = static_cast<float>(v.y);
  }
};
template <> struct Vec<int8_t, 4> {
  static __device__ __forceinline__ void load(const int8_t* p, float* o) {
    const char4 v = *reinterpret_cast<const char4*>(p);
    o[0] = static_cast<float>(v.x); o[1] = static_cast<float>(v.y);
    o[2] = static_cast<float>(v.z); o[3] = static_cast<float>(v.w);
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// T: q and out; KV: the pools (T, or int8 with `scales`); QMAX: 1 for the
// decode instantiations, kMaxQlen for the verify window (qlen <= QMAX).
template <typename T, typename KV, int D, int QMAX>
__global__ void __launch_bounds__(kWarps * 32)
paged_kernel(const T* __restrict__ q, const KV* __restrict__ k_pages,
             const KV* __restrict__ v_pages,
             const float* __restrict__ scales,
             const int* __restrict__ page_table,
             const int* __restrict__ seq_lens, T* __restrict__ out, int qlen,
             int nh, int nh_kv, int page_size, int max_pages, float scale2) {
  constexpr int E = D / 32;
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hp = nh_kv * D;
  const int kvh = h / (nh / nh_kv);
  const int seq_len = seq_lens[b];
  // a length past the table's reach reads nothing beyond it
  const int len = min(seq_len, max_pages * page_size);
  const size_t row_stride = (size_t)nh * D;           // one window row
  const size_t base_qo = (size_t)b * qlen * row_stride + (size_t)h * D;
  if (len <= 0) {
    for (int i = threadIdx.x; i < qlen * D; i += blockDim.x)
      out[base_qo + (i / D) * row_stride + i % D] = from_f<T>(0.f);
    return;
  }

  // window row r sees key positions < lim[r]
  int lim[QMAX];
  float qv[QMAX][E];
#pragma unroll
  for (int r = 0; r < QMAX; ++r) {
    lim[r] = min(len, seq_len - qlen + r + 1);
    if (r < qlen) {
      Vec<T, E>::load(q + base_qo + r * row_stride + lane * E, qv[r]);
#pragma unroll
      for (int e = 0; e < E; ++e) qv[r][e] *= scale2;
    }
  }
  const int* pt = page_table + (size_t)b * max_pages;
  const size_t col = (size_t)kvh * D + lane * E;

  float m[QMAX], l[QMAX], acc[QMAX][E];
#pragma unroll
  for (int r = 0; r < QMAX; ++r) {
    m[r] = kNegInf; l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  for (int base = warp * kUnroll; base < len; base += kWarps * kUnroll) {
    float kk[kUnroll][E], vv[kUnroll][E];
    float ks[kUnroll], vs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u;
      ks[u] = 1.f; vs[u] = 1.f;
      if (t < len) {
        const int page = pt[t / page_size];
        const size_t row =
            ((size_t)page * page_size + (t % page_size)) * hp + col;
        Vec<KV, E>::load(k_pages + row, kk[u]);
        Vec<KV, E>::load(v_pages + row, vv[u]);
        if (kQuant) {
          ks[u] = scales[((size_t)page * 2) * nh_kv + kvh];
          vs[u] = scales[((size_t)page * 2 + 1) * nh_kv + kvh];
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) { kk[u][e] = 0.f; vv[u][e] = 0.f; }
      }
    }
#pragma unroll
    for (int r = 0; r < QMAX; ++r) {
      if (r >= qlen) continue;              // warp-uniform
      float s[kUnroll];
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part = fmaf(qv[r][e], kk[u][e], part);
        part = warp_sum(part) * ks[u];      // t is warp-uniform
        s[u] = (base + u < lim[r]) ? part : kNegInf;
        mx = fmaxf(mx, s[u]);
      }
      const float corr = exp2f(m[r] - mx);
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= corr;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = (base + u < lim[r]) ? exp2f(s[u] - mx) : 0.f;
        l[r] += p;
        const float pv = p * vs[u];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(pv, vv[u][e], acc[r][e]);
      }
      m[r] = mx;
    }
  }

  // merge the warps' partial softmax states, row by row
  __shared__ float sm_m[kWarps][QMAX], sm_l[kWarps][QMAX];
  __shared__ float sm_acc[kWarps][QMAX][D];
#pragma unroll
  for (int r = 0; r < QMAX; ++r) {
    if (r >= qlen) continue;
    if (lane == 0) { sm_m[warp][r] = m[r]; sm_l[warp][r] = l[r]; }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][r][lane * E + e] = acc[r][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < qlen * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][r]);
    float ll = 0.f, oo = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float cw = exp2f(sm_m[w][r] - mm);  // 0 for a warp with no token
      ll = fmaf(sm_l[w][r], cw, ll);
      oo = fmaf(sm_acc[w][r][c], cw, oo);
    }
    out[base_qo + r * row_stride + c] = from_f<T>(ll > 0.f ? oo / ll : 0.f);
  }
}

template <typename T, typename KV, int D, int QMAX>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* scales, const void* page_table,
                   const void* seq_lens, void* out, int batch, int qlen,
                   int nh, int nh_kv, int page_size, int max_pages,
                   float scale, cudaStream_t stream) {
  const dim3 grid(batch, nh);
  paged_kernel<T, KV, D, QMAX><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pages),
      static_cast<const KV*>(v_pages), static_cast<const float*>(scales),
      static_cast<const int*>(page_table), static_cast<const int*>(seq_lens),
      static_cast<T*>(out), qlen, nh, nh_kv, page_size, max_pages,
      scale * kLog2e);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (q and out); scales == nullptr: pools
// in q's dtype, else int8 pools.
template <int QMAX>
int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const void* scales, const void* page_table,
             const void* seq_lens, void* out, int batch, int qlen, int nh,
             int nh_kv, int head_dim, int page_size, int max_pages,
             float scale, int dtype, void* stream) {
  if (batch <= 0) return 0;
  if (nh_kv <= 0 || nh % nh_kv || page_size <= 0 || max_pages <= 0 ||
      qlen < 1 || qlen > QMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool i8 = scales != nullptr;
#define PTT_LAUNCH(T, KV, D)                                                 \
  return (int)launch<T, KV, D, QMAX>(q, k_pages, v_pages, scales,           \
                                     page_table, seq_lens, out, batch, qlen,  \
                                     nh, nh_kv, page_size, max_pages, scale,  \
                                     s)
  if (dtype == 0 && !i8 && head_dim == 64) PTT_LAUNCH(float, float, 64);
  if (dtype == 0 && !i8 && head_dim == 128) PTT_LAUNCH(float, float, 128);
  if (dtype == 1 && !i8 && head_dim == 64)
    PTT_LAUNCH(__nv_bfloat16, __nv_bfloat16, 64);
  if (dtype == 1 && !i8 && head_dim == 128)
    PTT_LAUNCH(__nv_bfloat16, __nv_bfloat16, 128);
  if (dtype == 0 && i8 && head_dim == 64) PTT_LAUNCH(float, int8_t, 64);
  if (dtype == 0 && i8 && head_dim == 128) PTT_LAUNCH(float, int8_t, 128);
  if (dtype == 1 && i8 && head_dim == 64)
    PTT_LAUNCH(__nv_bfloat16, int8_t, 64);
  if (dtype == 1 && i8 && head_dim == 128)
    PTT_LAUNCH(__nv_bfloat16, int8_t, 128);
#undef PTT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns a cudaError_t (0 = launched). q, out (B, nh, d).
extern "C" int paged_attention_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* scales, const void* page_table, const void* seq_lens,
    void* out, int batch, int nh, int nh_kv, int head_dim, int page_size,
    int max_pages, float scale, int dtype, void* stream) {
  return dispatch<1>(q, k_pages, v_pages, scales, page_table, seq_lens, out,
                     batch, 1, nh, nh_kv, head_dim, page_size, max_pages,
                     scale, dtype, stream);
}

// q, out (B, qlen, nh, d), 1 <= qlen <= 8.
extern "C" int paged_attention_multiquery(
    const void* q, const void* k_pages, const void* v_pages,
    const void* scales, const void* page_table, const void* seq_lens,
    void* out, int batch, int qlen, int nh, int nh_kv, int head_dim,
    int page_size, int max_pages, float scale, int dtype, void* stream) {
  return dispatch<kMaxQlen>(q, k_pages, v_pages, scales, page_table,
                            seq_lens, out, batch, qlen, nh, nh_kv, head_dim,
                            page_size, max_pages, scale, dtype, stream);
}

extern "C" const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
