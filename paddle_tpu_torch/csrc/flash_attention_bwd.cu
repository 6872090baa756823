// Flash attention backward for Hopper, sm_90a, over the packed (B, S, NH*D)
// layout: two templated kernels (dQ and dK/dV), each with a segment-id
// variant (SEG), behind four entry points.
//
//   K-DQ  `flash_attention_bwd_dq`  replaces the Pallas TPU kernel
//         paddle_tpu/ops/pallas/flash_attention_packed.py `_dq_kernel`
//         (launched by `_dq_call`): dQ from q, k, v, dO, the forward's
//         natural-log lse and delta = rowsum(dO * O), both (B, Sq, NH) fp32.
//   K-DKV `flash_attention_bwd_dkv` replaces `_dkv_kernel` (launched by
//         `_dkv_call`): dK and dV from the same inputs. The TPU kernel took
//         lse and delta transposed to (B, NH, S) for its (bk, bq) tiles; a
//         block here reads its 64 rows of lse and delta straight from
//         (B, Sq, NH), so no transpose is made.
//   K-BDQ, K-BDKV: the same two entries replace
//         paddle_tpu/ops/pallas/flash_attention.py `_dq_kernel` and
//         `_dkv_kernel` (launched by `_flash_bwd_call`): a (B, S, H, D)
//         tensor whose last two dims are dense is (B, S, H*D) with a row
//         stride, so the TPU's (B*H, S, D) transpose is not needed.
//   K-SDQ `flash_attention_bwd_dq_seg` and K-SDKV
//         `flash_attention_bwd_dkv_seg` replace `_dq_kernel_seg` and
//         `_dkv_kernel_seg` (launched by `_dq_call_seg`, `_dkv_call_seg`):
//         causal self-attention where a pair is visible only when its
//         query and key carry the same (B, S) int32 segment id (pad -1
//         attends only to pad). Each block holds its own rows' ids and the
//         current tile's in shared memory, and a tile in which no (row,
//         key) pair shares a segment is skipped before its operands are
//         loaded, so the causal tiles of a packed row that lie between
//         documents cost an id load and a vote, not a tile of math.
//
// Per visible (query, key) pair, in natural units:
//   s = scale * q.k,  p = exp(s - lse),  dp = dO.v,  ds = p * (dp - delta),
//   dQ += scale * ds * k,  dK += scale * ds * q,  dV += p * dO.
// Causal means key <= query (top-left, Sq == Sk); full attention takes
// Sq != Sk. q, k, v and dO rows are `*_rs` elements apart (3*NH*D for
// column slices of the fused qkv projection), a batch is its rows back to
// back, and dQ, dK, dV are written dense (B, S, NH*D) in q's dtype.
//
// What bounds them on the H100: ~6*d (dQ) and ~8*d (dK/dV) FLOPs per
// visible pair against inputs read once: operations, not bytes (with
// segment ids the visible pairs shrink, and the bound can be bytes). These
// first kernels run the math on the CUDA cores in fp32 from shared-memory
// tiles (no wgmma yet), so they sit far from the tensor-core bound. What
// the design does:
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
//   * ragged tails (S not a multiple of 64) are masked in the kernel, and
//     p is zeroed on every masked entry, so a masked pair adds nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float kLog2e = 1.4426950408889634f;

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
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n, int rs, float mul) {
  constexpr int P = pitch<D>();
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int row = r0 + r;
    dst[r * P + c] = row < n ? to_f(src[(size_t)row * rs + c]) * mul : 0.f;
  }
}

// SEG: a pair is visible only within one segment id (needs Sq == Sk).
template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ seg,
                T* __restrict__ dq, int Sq, int Sk, int H, int qs, int ks,
                int vs, int dos, float scale, int causal) {
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
  const int q0 = qb * BQ;
  const float scale2 = scale * kLog2e;
  const T* qp = q + (size_t)b * Sq * qs + (size_t)h * D;
  const T* dop = dout + (size_t)b * Sq * dos + (size_t)h * D;
  const T* kp = k + (size_t)b * Sk * ks + (size_t)h * D;
  const T* vp = v + (size_t)b * Sk * vs + (size_t)h * D;
  const size_t os = (size_t)H * D;
  T* dqp = dq + (size_t)b * Sq * os + (size_t)h * D;

  load_tile<T, D>(Qs, qp, q0, Sq, qs, scale2);
  load_tile<T, D>(dOs, dop, q0, Sq, dos, 1.f);
  if (tid < BQ) {
    const int row = q0 + tid;
    const size_t at = ((size_t)b * Sq + row) * H + h;
    lse2[tid] = row < Sq ? lse[at] * kLog2e : 0.f;
    dlt[tid] = row < Sq ? delta[at] : 0.f;
  }
  if (SEG) load_seg(segq, seg, b, q0, Sq);

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
      load_seg(segk, seg, b, k0, Sk);
      __syncthreads();
      // no pair shares a segment: skip (the vote is also the barrier
      // before the next tile overwrites segk)
      if (!tile_visible(segq, segk, q0, k0, Sq, Sk, causal, false)) continue;
    }
    load_tile<T, D>(Ks, kp, k0, Sk, ks, 1.f);
    load_tile<T, D>(Vs, vp, k0, Sk, vs, 1.f);
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
        const float p = ok ? exp2f(s[i][c] - lse2[r]) : 0.f;
        dSs[r * TP + kc] = p * (dp[i][c] - dlt[r]);
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
      T* out = dqp + (size_t)row * os;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        out[tx + 16 * c] = from_f<T>(acc[i][c] * scale);
    }
  }
}

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, const int* __restrict__ seg,
                 T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk,
                 int H, int qs, int ks, int vs, int dos, float scale,
                 int causal) {
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
  const int k0 = kb * BK;
  const float scale2 = scale * kLog2e;
  const T* qp = q + (size_t)b * Sq * qs + (size_t)h * D;
  const T* dop = dout + (size_t)b * Sq * dos + (size_t)h * D;
  const T* kp = k + (size_t)b * Sk * ks + (size_t)h * D;
  const T* vp = v + (size_t)b * Sk * vs + (size_t)h * D;
  const size_t os = (size_t)H * D;
  T* dkp = dk + (size_t)b * Sk * os + (size_t)h * D;
  T* dvp = dv + (size_t)b * Sk * os + (size_t)h * D;

  load_tile<T, D>(Ks, kp, k0, Sk, ks, scale2);
  load_tile<T, D>(Vs, vp, k0, Sk, vs, 1.f);
  if (SEG) load_seg(segk, seg, b, k0, Sk);

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
      load_seg(segq, seg, b, q0, Sq);
      __syncthreads();
      if (!tile_visible(segk, segq, k0, q0, Sq, Sk, causal, true)) continue;
    }
    load_tile<T, D>(Qs, qp, q0, Sq, qs, 1.f);
    load_tile<T, D>(dOs, dop, q0, Sq, dos, 1.f);
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
        const float p = ok ? exp2f(st[i][c] - lse2[qc]) : 0.f;
        Pt[kr * TP + qc] = p;
        dSt[kr * TP + qc] = p * (dpt[i][c] - dlt[qc]);
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
      T* dko = dkp + (size_t)key * os;
      T* dvo = dvp + (size_t)key * os;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dko[tx + 16 * c] = from_f<T>(adk[i][c] * scale);
        dvo[tx + 16 * c] = from_f<T>(adv[i][c]);
      }
    }
  }
}

// One launch of either kernel: dk == nullptr launches dQ into `dq_or_dk`,
// otherwise dK/dV into `dq_or_dk` and `dv`.
template <typename T, int D, bool SEG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* seg, void* dq_or_dk, void* dv, int batch,
                   int Sq, int Sk, int H, int qs, int ks, int vs, int dos,
                   float scale, int causal, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  const int* sp = static_cast<const int*>(seg);
  if (dv == nullptr) {
    const size_t smem = dq_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_dq_kernel<T, D, SEG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + BQ - 1) / BQ, H, batch);
    flash_dq_kernel<T, D, SEG><<<grid, NT, smem, stream>>>(
        qp, kp, vp, dop, lp, dp, sp, static_cast<T*>(dq_or_dk), Sq, Sk, H,
        qs, ks, vs, dos, scale, causal);
  } else {
    const size_t smem = dkv_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_dkv_kernel<T, D, SEG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sk + BK - 1) / BK, H, batch);
    flash_dkv_kernel<T, D, SEG><<<grid, NT, smem, stream>>>(
        qp, kp, vp, dop, lp, dp, sp, static_cast<T*>(dq_or_dk),
        static_cast<T*>(dv), Sq, Sk, H, qs, ks, vs, dos, scale, causal);
  }
  return cudaGetLastError();
}

template <bool SEG>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, const void* seg,
             void* dq_or_dk, void* dv, int batch, int Sq, int Sk, int H,
             int D, int qs, int ks, int vs, int dos, float scale, int causal,
             int dtype, void* stream) {
  if (batch < 0 || Sq < 0 || Sk < 0 || H < 0 || (causal && Sq != Sk) ||
      (SEG && Sq != Sk))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || H == 0 || (dv == nullptr ? Sq : Sk) == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_LAUNCH(T, DD)                                                 \
  return (int)launch<T, DD, SEG>(q, k, v, dout, lse, delta, seg, dq_or_dk, \
                                 dv, batch, Sq, Sk, H, qs, ks, vs, dos,    \
                                 scale, causal, s)
  if (dtype == 0 && D == 64) PTT_LAUNCH(float, 64);
  if (dtype == 0 && D == 128) PTT_LAUNCH(float, 128);
  if (dtype == 1 && D == 64) PTT_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) PTT_LAUNCH(__nv_bfloat16, 128);
#undef PTT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

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
  return dispatch<false>(q, k, v, dout, lse, delta, nullptr, dq, nullptr,
                         batch, sq, sk, heads, head_dim, q_rs, k_rs, v_rs,
                         do_rs, scale, causal, dtype, stream);
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
  return dispatch<false>(q, k, v, dout, lse, delta, nullptr, dk, dv, batch,
                         sq, sk, heads, head_dim, q_rs, k_rs, v_rs, do_rs,
                         scale, causal, dtype, stream);
}

// Causal self-attention within segments: seg is (B, S) int32.
extern "C" int flash_attention_bwd_dq_seg(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          const void* seg, void* dq,
                                          int batch, int seqlen, int heads,
                                          int head_dim, int q_rs, int k_rs,
                                          int v_rs, int do_rs, float scale,
                                          int dtype, void* stream) {
  return dispatch<true>(q, k, v, dout, lse, delta, seg, dq, nullptr, batch,
                        seqlen, seqlen, heads, head_dim, q_rs, k_rs, v_rs,
                        do_rs, scale, 1, dtype, stream);
}

extern "C" int flash_attention_bwd_dkv_seg(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse,
                                           const void* delta, const void* seg,
                                           void* dk, void* dv, int batch,
                                           int seqlen, int heads,
                                           int head_dim, int q_rs, int k_rs,
                                           int v_rs, int do_rs, float scale,
                                           int dtype, void* stream) {
  if (dv == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<true>(q, k, v, dout, lse, delta, seg, dk, dv, batch,
                        seqlen, seqlen, heads, head_dim, q_rs, k_rs, v_rs,
                        do_rs, scale, 1, dtype, stream);
}
