// Paged decode attention (K-DEC) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// `_decode_kernel` (launched by `_paged_call`): one query token per
// request against K/V history scattered over the pages of a shared pool.
//
//   q          (B, nh, d)                    fp32 or bf16
//   k/v_pages  (P, page_size, nh_kv * d)     same dtype as q
//   page_table (B, max_pages) int32, seq_lens (B,) int32
//   out        (B, nh, d)                    q's dtype
//
// What bounds it on the H100: the bytes of K/V it reads, about
// sum_b seq_len_b * 2 * nh_kv * d * elem per layer, against ~0.3 KFLOP of
// arithmetic per KV row; tensor cores cannot help a single query row.
// What the design does about it:
//   * one CTA per (request, query head), 4 warps; each warp walks its
//     own tokens (4 at a time, K and V rows loaded before any arithmetic
//     so eight row loads are in flight per warp), each lane owning d/32
//     contiguous elements, so a K/V row is one coalesced warp load;
//   * the loop runs only over the request's own tokens: pages past
//     ceil(seq_len / page_size) are never touched (the TPU kernel had to
//     fetch and mask every page of the table);
//   * fp32 online softmax in base 2 (log2 e folded into the scale), one
//     (m, l, acc) per warp, merged across warps in shared memory at the
//     end;
//   * seq_len 0 writes zeros; a padding row with seq_len 1 and page 0
//     reads one slot of the reserved garbage page like any other row.
// GQA maps query head h to kv head h / (nh / nh_kv).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kUnroll = 4;
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    int nh, int nh_kv, int page_size, int max_pages,
                    float scale2) {
  constexpr int E = D / 32;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hp = nh_kv * D;
  const int kvh = h / (nh / nh_kv);
  // a length past the table's reach reads nothing beyond it
  const int len = min(seq_lens[b], max_pages * page_size);
  T* o = out + ((size_t)b * nh + h) * D;
  if (len <= 0) {
    for (int i = threadIdx.x; i < D; i += blockDim.x) o[i] = from_f<T>(0.f);
    return;
  }

  float qv[E];
  Vec<T, E>::load(q + ((size_t)b * nh + h) * D + lane * E, qv);
#pragma unroll
  for (int e = 0; e < E; ++e) qv[e] *= scale2;
  const int* pt = page_table + (size_t)b * max_pages;
  const size_t col = (size_t)kvh * D + lane * E;

  float m = kNegInf, l = 0.f;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  for (int base = warp * kUnroll; base < len; base += kWarps * kUnroll) {
    float kk[kUnroll][E], vv[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u;
      if (t < len) {
        const int page = pt[t / page_size];
        const size_t row =
            ((size_t)page * page_size + (t % page_size)) * hp + col;
        Vec<T, E>::load(k_pages + row, kk[u]);
        Vec<T, E>::load(v_pages + row, vv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) { kk[u][e] = 0.f; vv[u][e] = 0.f; }
      }
    }
    float s[kUnroll];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) part = fmaf(qv[e], kk[u][e], part);
      part = warp_sum(part);               // t is warp-uniform
      s[u] = (base + u < len) ? part : kNegInf;
      mx = fmaxf(mx, s[u]);
    }
    const float corr = exp2f(m - mx);
    l *= corr;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = (base + u < len) ? exp2f(s[u] - mx) : 0.f;
      l += p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vv[u][e], acc[e]);
    }
    m = mx;
  }

  // merge the warps' partial softmax states
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
  if (lane == 0) { sm_m[warp] = m; sm_l[warp] = l; }
#pragma unroll
  for (int e = 0; e < E; ++e) sm_acc[warp][lane * E + e] = acc[e];
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w]);
    float ll = 0.f, oo = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(sm_m[w] - mm);   // 0 for a warp with no token
      ll = fmaf(sm_l[w], c, ll);
      oo = fmaf(sm_acc[w][i], c, oo);
    }
    o[i] = from_f<T>(ll > 0.f ? oo / ll : 0.f);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* page_table, const void* seq_lens, void* out,
                   int batch, int nh, int nh_kv, int page_size, int max_pages,
                   float scale, cudaStream_t stream) {
  const dim3 grid(batch, nh);
  paged_decode_kernel<T, D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(seq_lens), static_cast<T*>(out), nh, nh_kv,
      page_size, max_pages, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int paged_attention_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* seq_lens, void* out, int batch,
    int nh, int nh_kv, int head_dim, int page_size, int max_pages,
    float scale, int dtype, void* stream) {
  if (batch <= 0) return 0;
  if (nh_kv <= 0 || nh % nh_kv || page_size <= 0 || max_pages <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_LAUNCH(T, D)                                                     \
  return (int)launch<T, D>(q, k_pages, v_pages, page_table, seq_lens, out,   \
                           batch, nh, nh_kv, page_size, max_pages, scale, s)
  if (dtype == 0 && head_dim == 64) PTT_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) PTT_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) PTT_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) PTT_LAUNCH(__nv_bfloat16, 128);
#undef PTT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
