// Flash attention forward for Hopper, sm_90a: one templated kernel, two
// entry points.
//
//   K-SEG  `flash_attention_fwd_packed_seg` replaces the Pallas TPU kernel
//          paddle_tpu/ops/pallas/flash_attention_packed.py `_fwd_kernel_seg`
//          (launched by `_fwd_call_seg`): causal attention over the packed
//          (B, S, NH*D) layout with a per-token segment-equality mask (pad
//          id -1 attends only to pad), serving's `prefill_packed` and the
//          packed-sequence trainer's forward. It takes a row stride per
//          operand, so the trainer's q, k, v are read in place as column
//          slices of the fused qkv projection.
//   K-PACK `flash_attention_fwd_packed` replaces
//          paddle_tpu/ops/pallas/flash_attention_packed.py `_fwd_kernel`
//          (launched by `_fwd_call`): causal or full attention over the
//          packed (B, S, NH*D) layout, the training forward. q, k and v
//          may be column slices of the fused qkv projection: each has its
//          own row stride (3*NH*D there), so no copy is made. Full
//          attention takes Sq != Sk (ring attention's off-diagonal
//          blocks); causal needs Sq == Sk.
//   K-BSHD replaces paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel`
//          (launched by `_flash_call`): causal attention over (B, S, H, D),
//          serving's `prefill_batch` and the nn-API training forward. A
//          (B, S, H, D) tensor whose last two dims are dense is
//          (B, S, H*D) with a row stride, so K-BSHD is the K-PACK entry
//          (on dense tensors, or on the `unbind` views of the fused qkv),
//          and the TPU's (B*H, S, D) transpose is not needed.
//
// All write a dense `o` (B, Sq, H*D) in q's dtype and a natural-log `lse`
// (B, Sq, H) fp32:
// lse = (m + log2 l) / log2 e; a row with l == 0 writes zeros.
//
// What bounds it on the H100: at serving's prefill shapes (T = 2048,
// nh = 16, d = 64) the work is ~4 * d FLOPs per visible (query, key) pair
// against 2-byte inputs read once: operations, not bytes. This first
// kernel runs those operations on the CUDA cores in fp32 (no wgmma yet),
// so it sits far from the tensor-core bound; what the design does:
//   * grid (q-block, head, batch) with 64-row q-blocks: with B = 1 the
//     heads and q-blocks alone give 32 x 16 = 512 CTAs for 132 SMs; the
//     heaviest (last) causal q-blocks are launched first;
//   * 64 x 64 tiles of Q, K, V and P in shared memory (fp32, rows padded
//     by one word against bank conflicts), 256 threads each computing a
//     4 x 4 block of scores and a 4 x d/16 block of the output, so every
//     shared-memory value read feeds four FMAs;
//   * causal k-tiles above the diagonal are never visited; with segment
//     ids, a k-tile in which no (row, key) pair shares a segment is
//     skipped before its K/V is even loaded, so a packed batch of many
//     short requests costs close to the sum of their own triangles;
//   * ragged tails (S not a multiple of 64) are masked in the kernel;
//   * after exp2, p is zeroed on every masked entry, so a fully masked
//     block adds nothing to l while m is still the -1e30 sentinel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

template <int D> __host__ __device__ constexpr int q_pitch() { return D + 1; }
template <int D> __host__ __device__ constexpr int k_pitch() { return D + 1; }
__host__ __device__ constexpr int p_pitch() { return BK + 1; }

template <int D> constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * q_pitch<D>() + (size_t)BK * k_pitch<D>() +
                          (size_t)BK * D + (size_t)BQ * p_pitch()) +
         sizeof(int) * (BQ + BK);
}

// q, k, v rows are `qs`, `ks`, `vs` elements apart and a batch is its
// rows back to back; o is dense. SEG needs Sq == Sk.
template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seg,
                 T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk,
                 int H, int qs, int ks, int vs, float scale2, int causal) {
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
  const int q0 = qb * BQ;
  const size_t os = (size_t)H * D;            // o's row stride, elements
  const T* qp = q + (size_t)b * Sq * qs + (size_t)h * D;
  const T* kp = k + (size_t)b * Sk * ks + (size_t)h * D;
  const T* vp = v + (size_t)b * Sk * vs + (size_t)h * D;
  T* op = o + (size_t)b * Sq * os + (size_t)h * D;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int row = q0 + r;
    Qs[r * QP + c] =
        row < Sq ? to_f(qp[(size_t)row * qs + c]) * scale2 : 0.f;
  }
  if (SEG && tid < BQ)
    segq[tid] = (q0 + tid < Sq) ? seg[(size_t)b * Sq + q0 + tid] : INT_MIN;
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
        segk[tid] = (k0 + tid < Sk) ? seg[(size_t)b * Sk + k0 + tid] : INT_MIN;
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
        kv = to_f(kp[(size_t)key * ks + c]);
        vv = to_f(vp[(size_t)key * vs + c]);
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
        Ps[r * PP + tx + 16 * c] = p;
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
      T* orow = op + (size_t)row * os;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        orow[tx + 16 * c] = from_f<T>(acc[i][c] / l_safe);
      if (tx == 0)
        lse[((size_t)b * Sq + row) * H + h] =
            (m_i[i] + log2f(l_safe)) / kLog2e;
    }
  }
}

template <typename T, int D, bool SEG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* seg, void* o, void* lse, int batch, int Sq,
                   int Sk, int H, int qs, int ks, int vs, float scale,
                   int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, SEG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, batch);
  flash_fwd_kernel<T, D, SEG><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(seg),
      static_cast<T*>(o), static_cast<float*>(lse), Sq, Sk, H, qs, ks, vs,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

template <bool SEG>
int dispatch(const void* q, const void* k, const void* v, const void* seg,
             void* o, void* lse, int batch, int Sq, int Sk, int H, int D,
             int qs, int ks, int vs, float scale, int causal, int dtype,
             void* stream) {
  if (batch <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Sk <= 0 || (causal && Sq != Sk) || (SEG && Sq != Sk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_LAUNCH(T, DD)                                                  \
  return (int)launch<T, DD, SEG>(q, k, v, seg, o, lse, batch, Sq, Sk, H,  \
                                 qs, ks, vs, scale, causal, s)
  if (dtype == 0 && D == 64) PTT_LAUNCH(float, 64);
  if (dtype == 0 && D == 128) PTT_LAUNCH(float, 128);
  if (dtype == 1 && D == 64) PTT_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) PTT_LAUNCH(__nv_bfloat16, 128);
#undef PTT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

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
  return dispatch<false>(q, k, v, nullptr, o, lse, batch, sq, sk, heads,
                         head_dim, q_rs, k_rs, v_rs, scale, causal, dtype,
                         stream);
}

// The K-SEG entry with a row stride per operand; causal self-attention.
extern "C" int flash_attention_fwd_packed_seg(const void* q, const void* k,
                                              const void* v, const void* seg,
                                              void* o, void* lse, int batch,
                                              int seqlen, int heads,
                                              int head_dim, int q_rs,
                                              int k_rs, int v_rs, float scale,
                                              int dtype, void* stream) {
  return dispatch<true>(q, k, v, seg, o, lse, batch, seqlen, seqlen, heads,
                        head_dim, q_rs, k_rs, v_rs, scale, 1, dtype, stream);
}
