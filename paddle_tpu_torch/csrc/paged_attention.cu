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
//   workspace  (n_chunks, B, qlen, nh, d + 2) fp32 when n_chunks > 1
//
// Row i of a window sees key positions < seq_len - qlen + i + 1, so a
// window row computes what a decode at that length would (qlen 1 is the
// decode). seq_len 0 writes zeros; a length past the table is clamped to
// it; a row that sees no key writes zeros.
//
// What bounds it on the H100: the bytes of K/V it reads, about
// sum_b seq_len_b * 2 * nh_kv * d * elem per layer (elem 1 for int8),
// against ~4 * qlen * (nh / nh_kv) * d FLOPs per K/V row: a handful of
// query rows per byte, far below the tensor cores' ridge.
// What the design does about it (flash-decoding):
//   * the context is split over CTAs: the grid is (n_chunks x row tiles,
//     B, nh_kv), a chunk being a fixed number of whole pages (about 256
//     tokens). The grid comes from max_pages, never from seq_lens, so the
//     host never reads a length; a CTA whose chunk starts at or past its
//     request's length exits at once. A 1024-token request is four CTAs
//     of 256 tokens, not one CTA of 1024;
//   * one CTA per kv head serves every row that reads it: the window rows
//     of all query heads of the GQA group, so each K/V byte leaves device
//     memory once (more rows than a CTA takes go to the next CTA of the
//     grid, launched beside it, whose read finds the chunk in L2);
//   * the CTA loads its chunk's page ids (and int8 scales) into shared
//     memory once, then streams the pages' K and V rows through a ring of
//     stages with 16-byte cp.async.cg copies, one commit group a stage;
//     tokens past the end are zero-filled;
//   * two bodies, chosen by the wrapper from the query's dtype and the
//     rows a kv head has (`launch_plan`):
//     - CUDA cores (fp32, and bf16 with fewer than 4 rows, the MHA decode):
//       up to 8 rows a CTA (4 at d 128), a 4-stage ring of 32 tokens; a
//       token's q.k split over 8 lanes (3 shuffles), four tokens a warp at
//       once, each lane holding d/8 elements of its token's K and V row;
//       int8 widened by byte permutes, not conversion instructions;
//     - tensor cores (a bf16 query with 4 rows or more: the verify window,
//       GQA): the rows padded to one m16 tile, a 3-stage ring of 64 tokens
//       whose rows are XOR-swizzled for ldmatrix, each warp taking 16
//       tokens: S = Q.K^T by mma.sync.m16n8k16, the softmax on the
//       fragments, O += P.V with P as a bf16 hi + lo pair (P keeps ~16
//       bits; V is exact in bf16). int8 rows are widened exactly to bf16
//       into the warp's staging tile first;
//   * the fp32 online softmax runs in base 2 (log2 e folded into the
//     scale), the int8 dequant fused as on the TPU:
//     s = (q . k_i8) * (scale * log2 e) * k_scale, acc += (p * v_scale) v_i8;
//   * each live CTA merges its warps' states and writes its rows'
//     unnormalised acc and (m, l) to the workspace; `paged_merge_kernel`
//     combines the live chunks in base 2 and writes `out`. With one chunk
//     the first kernel writes `out` itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerTok = 8;               // lanes sharing one token's dot
constexpr int kGroups = 32 / kLanesPerTok;    // tokens a warp holds at once
constexpr int kMaxQlen = 8;                   // the widest verify window
constexpr int kMaxChunkPages = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;

// KIND: 0 fp32 q and pools, 1 bf16 q and pools, 2 fp32 q over int8 pools,
// 3 bf16 q over int8 pools (ints, so the ptxas and profiler names read
// `paged_split_kernel<KIND, D, RT>`).
template <int KIND> struct Kind;
template <> struct Kind<0> { using T = float; using KV = float; };
template <> struct Kind<1> { using T = __nv_bfloat16; using KV = __nv_bfloat16; };
template <> struct Kind<2> { using T = float; using KV = int8_t; };
template <> struct Kind<3> { using T = __nv_bfloat16; using KV = int8_t; };

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The shapes one instantiation works with. RT 16 is the tensor-core body
// (a bf16 query over bf16 or int8 pools): one m16 tile of rows, S = Q.K^T
// and O += P.V by mma.sync.m16n8k16, 16 tokens a warp per step, int8 rows
// widened exactly to bf16 first; RT 1-8 the CUDA-core body.
template <int KIND, int D, int RT> struct Geo {
  using T = typename Kind<KIND>::T;
  using KV = typename Kind<KIND>::KV;
  static constexpr bool kQuant = KIND >= 2;
  static constexpr bool kMma = RT == 16;
  static constexpr int kElem = sizeof(KV);
  static constexpr int kRowBytes = D * kElem;       // one token, one kv head
  static constexpr int kCopies = kRowBytes / 16;    // 16-byte copies a row
  static constexpr int kE = D / kLanesPerTok;       // elements a lane holds
  // a lane's elements come in pieces of <= 16 bytes, piece p of lane j at
  // element (j + 8 p) * kPieceElems, so 8 lanes read 8 adjacent pieces
  static constexpr int kPieceBytes = cmin(16, kRowBytes / kLanesPerTok);
  static constexpr int kPieceElems = kPieceBytes / kElem;
  static constexpr int kPieces = kE / kPieceElems;
  static constexpr int kU = D == 64 ? 2 : 1;        // tokens a lane group
                                                    // takes per step
  static constexpr int kStepTok = kMma ? kWarps * 16 : kWarps * kGroups * kU;
  static constexpr int kStageTok = kMma ? 64 : 32;  // tokens a ring stage
  static constexpr int kSteps = kStageTok / kStepTok;
  static constexpr int kStages = kMma ? 3 : 4;      // ring stages
  static constexpr int kTokPerPass = kThreads / kCopies;  // copy rows a pass
  static constexpr bool kQReg = !kMma && RT * kE <= 32;  // q in registers
  // shared memory: the ring (reused by the final merge), per-token int8
  // scales, the query rows (fp32 pre-scaled, or bf16 for the tensor cores),
  // the chunk's page ids and scales
  static constexpr int kRingBytes = kStages * 2 * kStageTok * kRowBytes;
  static constexpr int kMergeBytes = kWarps * RT * (D + 2) * 4;
  static constexpr int kOffTokScale = cmax(kRingBytes, kMergeBytes);
  static constexpr int kOffQ = kOffTokScale + kStages * kStageTok * 8;
  static constexpr int kOffPages = kOffQ + RT * D * 4;
  static constexpr int kOffPageScale = kOffPages + kMaxChunkPages * 4;
  // the tensor-core body over int8 pools: each warp's 16 tokens of K and
  // V widened to bf16
  static constexpr int kOffStaging = kOffPageScale + kMaxChunkPages * 8;
  static constexpr int kStagingBytes =
      kMma && kQuant ? kWarps * 2 * 16 * D * 2 : 0;
  static constexpr int kSmem = kOffStaging + kStagingBytes;
  static_assert(kRowBytes % 16 == 0, "rows of whole 16-byte copies");
  static_assert(kE % kPieceElems == 0, "whole pieces a lane");
  static_assert(kStageTok % kStepTok == 0, "whole steps a stage");
  static_assert(kStageTok % kTokPerPass == 0, "whole copy passes a stage");
  static_assert(!kMma || KIND == 1 || KIND == 3, "tensor cores: bf16 q");
};

struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* scales;
  const int* page_table;
  const int* seq_lens;
  void* out;
  float* ws;
  int batch, qlen, nh, nh_kv, page_size, max_pages, chunk_pages, n_chunks,
      row_tiles;
  int page_shift;                                   // log2 page_size, or -1
  float scale2;                                     // scale * log2 e
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
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

// One piece of a K or V row in shared memory, widened to fp32.
template <typename KV, int N> struct Piece;
template <> struct Piece<float, 4> {
  static __device__ __forceinline__ void load(const unsigned char* p,
                                              float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
__device__ __forceinline__ void bf16x2(uint32_t w, float* o) {
  o[0] = __uint_as_float(w << 16);
  o[1] = __uint_as_float(w & 0xffff0000u);
}
template <> struct Piece<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const unsigned char* p,
                                              float* o) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    bf16x2(v.x, o); bf16x2(v.y, o + 2); bf16x2(v.z, o + 4); bf16x2(v.w, o + 6);
  }
};
// int8 -> fp32 exactly: x ^ 0x80 is x + 128 as an unsigned byte; placed in
// the mantissa of 2^23 it reads 2^23 + 128 + x.
__device__ __forceinline__ void i8x4(uint32_t w, float* o) {
  w ^= 0x80808080u;
  o[0] = __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7540)) - 8388736.f;
  o[1] = __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7541)) - 8388736.f;
  o[2] = __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7542)) - 8388736.f;
  o[3] = __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7543)) - 8388736.f;
}
template <> struct Piece<int8_t, 8> {
  static __device__ __forceinline__ void load(const unsigned char* p,
                                              float* o) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    i8x4(v.x, o); i8x4(v.y, o + 4);
  }
};
template <> struct Piece<int8_t, 16> {
  static __device__ __forceinline__ void load(const unsigned char* p,
                                              float* o) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    i8x4(v.x, o); i8x4(v.y, o + 4); i8x4(v.z, o + 8); i8x4(v.w, o + 12);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;                     // 0: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// four 8x8 bf16 matrices from shared memory, plain or transposed
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c += a (16x16 bf16, row) . b (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One CTA: chunk `blockIdx.x / row_tiles` of request `blockIdx.y`, kv head
// `blockIdx.z`, rows [tile * RT, tile * RT + RT) of the qlen * group rows
// that read the head (row rho: window row rho / group, query head
// kvh * group + rho % group).
template <int KIND, int D, int RT>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const Params p) {
  using G = Geo<KIND, D, RT>;
  using T = typename G::T;
  using KV = typename G::KV;
  constexpr int E = G::kE, PE = G::kPieceElems, U = G::kU;
  constexpr int kStages = G::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float2* tok_scale = reinterpret_cast<float2*>(smem + G::kOffTokScale);
  float* q_s = reinterpret_cast<float*>(smem + G::kOffQ);
  int* pages_s = reinterpret_cast<int*>(smem + G::kOffPages);
  float2* page_scale = reinterpret_cast<float2*>(smem + G::kOffPageScale);

  const int chunk = blockIdx.x / p.row_tiles;
  const int tile = blockIdx.x % p.row_tiles;
  const int b = blockIdx.y;
  const int kvh = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / kLanesPerTok, j = lane % kLanesPerTok;
  const int group = p.nh / p.nh_kv;
  const int rows = p.qlen * group;
  const int row0 = tile * RT;
  const int nrows = min(RT, rows - row0);
  const int seq_len = p.seq_lens[b];
  // a length past the table's reach reads nothing beyond it
  const int len = min(seq_len, p.max_pages * p.page_size);
  const int chunk_tok = p.chunk_pages * p.page_size;
  const int c0 = chunk * chunk_tok;
  const size_t row_stride = (size_t)p.nh * D;      // one window row
  T* out = static_cast<T*>(p.out);

  auto row_base = [&](int r) {                     // q/out offset of row r
    const int rho = row0 + r;
    const int qi = rho / group, h = kvh * group + rho % group;
    return ((size_t)b * p.qlen + qi) * row_stride + (size_t)h * D;
  };
  // row r sees positions < row_lim(r); a padding row (r >= nrows) none
  auto row_lim = [&](int r) {
    return r < nrows ? min(len, seq_len - p.qlen + (row0 + r) / group + 1)
                     : 0;
  };
  if (c0 >= len) {
    // a dead chunk; with a single chunk there is no merge, so it writes
    // the zeros of a seq_len 0 row itself
    if (p.n_chunks == 1)
      for (int i = tid; i < nrows * D; i += kThreads)
        out[row_base(i / D) + i % D] = from_f<T>(0.f);
    return;
  }
  // the chunk's tokens run [c0, end): no row sees past end
  int end = c0;
  for (int r = 0; r < nrows; ++r) end = max(end, row_lim(r));
  end = min(end, c0 + chunk_tok);

  // the chunk's page ids (and int8 scales), and the query rows
  const int first_page = chunk * p.chunk_pages;
  const int npg = end > c0 ? (end - 1) / p.page_size - first_page + 1 : 0;
  const int* pt = p.page_table + (size_t)b * p.max_pages + first_page;
  for (int i = tid; i < npg; i += kThreads) {
    const int page = pt[i];
    pages_s[i] = page;
    if (G::kQuant)
      page_scale[i] = make_float2(
          p.scales[((size_t)page * 2) * p.nh_kv + kvh],
          p.scales[((size_t)page * 2 + 1) * p.nh_kv + kvh]);
  }
  const T* q = static_cast<const T*>(p.q);
  if constexpr (G::kMma) {
    // bf16 as given, [16][D], padding rows zero; the scale goes on S
    __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(q_s);
    for (int i = tid; i < RT * D; i += kThreads) {
      const int r = i / D;
      qb[i] = r < nrows ? q[row_base(r) + i % D] : __float2bfloat16(0.f);
    }
  } else {
    for (int i = tid; i < RT * D; i += kThreads) {
      const int r = i / D;
      q_s[i] = r < nrows ? to_f<T>(q[row_base(r) + i % D]) * p.scale2 : 0.f;
    }
  }
  __syncthreads();

  const unsigned char* kpool = static_cast<const unsigned char*>(p.k_pages);
  const unsigned char* vpool = static_cast<const unsigned char*>(p.v_pages);
  const size_t pool_row = (size_t)p.nh_kv * G::kRowBytes;  // one token
  const int n_stages = (end - c0 + G::kStageTok - 1) / G::kStageTok;

  auto load_stage = [&](int s) {                   // stage s's copies
    const int buf = s % kStages;
    unsigned char* kdst =
        ring + (size_t)buf * 2 * G::kStageTok * G::kRowBytes;
    unsigned char* vdst = kdst + G::kStageTok * G::kRowBytes;
    const int tok0 = c0 + s * G::kStageTok;
    const int cpy = tid % G::kCopies;
    // each thread copies one 16-byte piece of K and of V for a few tokens
#pragma unroll
    for (int tt = tid / G::kCopies; tt < G::kStageTok; tt += G::kTokPerPass) {
      const int rel = tok0 + tt - c0;
      const bool valid = tok0 + tt < end;
      size_t off = 0;                              // any mapped address
      float2 sc = make_float2(0.f, 0.f);
      if (valid) {
        const int slot = p.page_shift >= 0 ? rel >> p.page_shift
                                           : rel / p.page_size;
        const int row = rel - slot * p.page_size;
        off = ((size_t)pages_s[slot] * p.page_size + row) * pool_row +
              (size_t)kvh * G::kRowBytes + cpy * 16;
        if (G::kQuant) sc = page_scale[slot];
      }
      // the tensor-core body reads 8 rows at one column with ldmatrix: a
      // row's 16-byte pieces are XOR-swizzled by the row, conflict-free
      const int piece = G::kMma && !G::kQuant ? cpy ^ (tt & 7) : cpy;
      const size_t dst = (size_t)tt * G::kRowBytes + piece * 16;
      cp_async16(kdst + dst, kpool + off, valid);
      cp_async16(vdst + dst, vpool + off, valid);
      if (G::kQuant && cpy == 0) tok_scale[buf * G::kStageTok + tt] = sc;
    }
  };

  // CUDA-core state: a lane group's (m, l) and d/8 columns of acc per row
  constexpr int RC = G::kMma ? 1 : RT;
  float m[RC], l[RC], acc[RC][G::kMma ? 1 : E];
  int lim[RC];
  // tensor-core state: a warp's O (16 x D) fragments, rows g and g + 8
  constexpr int NT = G::kMma ? D / 8 : 1;
  float o[NT][4];
  float mr[2] = {kNegInf, kNegInf}, lr[2] = {0.f, 0.f};
  uint32_t qa[G::kMma ? D / 16 : 1][4];
  int lim2[2] = {0, 0};
  const int g = lane / 4, qd = lane % 4;
  // with few rows the lane keeps its q elements in registers
  float qreg[G::kQReg ? RT : 1][G::kQReg ? E : 1];
  if constexpr (G::kMma) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(q_s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {        // the A fragments of Q
      const int c = kk * 8 + qd;                   // 32-bit column
      qa[kk][0] = qw[g * (D / 2) + c];
      qa[kk][1] = qw[(g + 8) * (D / 2) + c];
      qa[kk][2] = qw[g * (D / 2) + c + 4];
      qa[kk][3] = qw[(g + 8) * (D / 2) + c + 4];
    }
    lim2[0] = min(row_lim(g), end);
    lim2[1] = min(row_lim(g + 8), end);
  } else {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      m[r] = kNegInf; l[r] = 0.f;
      lim[r] = min(row_lim(r), end);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
    }
    if constexpr (G::kQReg) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int pc = 0; pc < G::kPieces; ++pc)
#pragma unroll
          for (int e = 0; e < PE; ++e)
            qreg[r][pc * PE + e] =
                q_s[r * D + (j + kLanesPerTok * pc) * PE + e];
    }
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load_stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();                  // stage s has landed
    __syncthreads();    // ... for every thread, and stage s - 1 is consumed
    if (s + kStages - 1 < n_stages) load_stage(s + kStages - 1);
    cp_async_commit();
    const int buf = s % kStages;
    const unsigned char* kbuf =
        ring + (size_t)buf * 2 * G::kStageTok * G::kRowBytes;
    const unsigned char* vbuf = kbuf + G::kStageTok * G::kRowBytes;
    if constexpr (G::kMma) {
      // this warp's 16 tokens, as bf16 rows of D * 2 bytes: the ring's
      // own, or int8 ones widened into the warp's staging tile
      const int tw = warp * 16;
      const unsigned char* kmat = kbuf + tw * G::kRowBytes;
      const unsigned char* vmat = vbuf + tw * G::kRowBytes;
      if constexpr (G::kQuant) {
        constexpr int CH = D / 16;                 // int8 pieces a row
        unsigned char* stg =
            smem + G::kOffStaging + warp * 2 * 16 * D * 2;
        __syncwarp();                    // the last stage's reads are done
#pragma unroll
        for (int i = lane; i < 2 * 16 * CH; i += 32) {
          const int kv = i / (16 * CH), tl = (i / CH) % 16, c = i % CH;
          const uint4 w = *reinterpret_cast<const uint4*>(
              (kv ? vbuf : kbuf) + (tw + tl) * D + c * 16);
          float f[16];
          i8x4(w.x, f); i8x4(w.y, f + 4); i8x4(w.z, f + 8);
          i8x4(w.w, f + 12);
          const uint4 lo = make_uint4(pack_bf16(f[0], f[1]),
                                      pack_bf16(f[2], f[3]),
                                      pack_bf16(f[4], f[5]),
                                      pack_bf16(f[6], f[7]));
          const uint4 hi = make_uint4(pack_bf16(f[8], f[9]),
                                      pack_bf16(f[10], f[11]),
                                      pack_bf16(f[12], f[13]),
                                      pack_bf16(f[14], f[15]));
          unsigned char* row = stg + (kv * 16 + tl) * D * 2;
          *reinterpret_cast<uint4*>(row + ((2 * c) ^ (tl & 7)) * 16) = lo;
          *reinterpret_cast<uint4*>(row + ((2 * c + 1) ^ (tl & 7)) * 16) =
              hi;
        }
        __syncwarp();
        kmat = stg;
        vmat = stg + 16 * D * 2;
      }
      // S (16 rows x 16 tokens) = Q . K^T, two n8 tiles
      const int mi = lane / 8, ri = lane % 8;      // ldmatrix's row owner
      float sacc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kb[4];
        const int tok = (mi / 2) * 8 + ri;
        const int piece = (kk * 2 + mi % 2) ^ (tok & 7);
        ldsm_x4(kb, kmat + tok * D * 2 + piece * 16);
        mma_bf16(sacc[0], qa[kk], kb[0], kb[1]);
        mma_bf16(sacc[1], qa[kk], kb[2], kb[3]);
      }
      // online softmax on the fragments: rows g (h 0) and g + 8 (h 1),
      // tokens 8 nt + 2 qd + e; a row's 16 tokens live in one quad
      const int t0 = c0 + s * G::kStageTok + tw;
      float ks[2][2], vs[2][2];                    // int8 scales, by token
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 sc = G::kQuant
              ? tok_scale[buf * G::kStageTok + tw + nt * 8 + qd * 2 + e]
              : make_float2(1.f, 1.f);
          ks[nt][e] = sc.x * p.scale2;
          vs[nt][e] = sc.y;
        }
      float pr[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = t0 + nt * 8 + qd * 2 + e;
            const float sv = t < lim2[h] ? sacc[nt][2 * h + e] * ks[nt][e]
                                         : kNegInf;
            sacc[nt][2 * h + e] = sv;
            mx = fmaxf(mx, sv);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mnew = fmaxf(mr[h], mx);
        const float corr = exp2f(mr[h] - mnew);
        mr[h] = mnew;
        float ls = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = t0 + nt * 8 + qd * 2 + e;
            const float pv = t < lim2[h] ? exp2f(sacc[nt][2 * h + e] - mnew)
                                         : 0.f;
            pr[nt][2 * h + e] = pv * vs[nt][e];
            ls += pv;
          }
        lr[h] = fmaf(lr[h], corr, ls);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          o[n][2 * h] *= corr;
          o[n][2 * h + 1] *= corr;
        }
      }
      // P as the A fragments of O += P . V (k = the 16 tokens): bf16 hi
      // and lo parts, so P keeps ~16 bits (V's values are exact in bf16)
      uint32_t pa[4], pl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = pr[i / 2][(i % 2) * 2], c = pr[i / 2][(i % 2) * 2 + 1];
        pa[i] = pack_bf16(a, c);
        pl[i] = pack_bf16(a - __uint_as_float(pa[i] << 16),
                          c - __uint_as_float(pa[i] & 0xffff0000u));
      }
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        uint32_t vb[4];
        const int tok = (mi % 2) * 8 + ri;
        const int piece = (jj * 2 + mi / 2) ^ (tok & 7);
        ldsm_x4_t(vb, vmat + tok * D * 2 + piece * 16);
        mma_bf16(o[2 * jj], pa, vb[0], vb[1]);
        mma_bf16(o[2 * jj], pl, vb[0], vb[1]);
        mma_bf16(o[2 * jj + 1], pa, vb[2], vb[3]);
        mma_bf16(o[2 * jj + 1], pl, vb[2], vb[3]);
      }
    } else {
#pragma unroll
      for (int step = 0; step < G::kSteps; ++step) {
        float kf[U][E], vf[U][E], ks[U], vs[U];
        int t[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int tt = step * G::kStepTok + (warp * kGroups + grp) * U + u;
          t[u] = c0 + s * G::kStageTok + tt;
#pragma unroll
          for (int pc = 0; pc < G::kPieces; ++pc) {
            const int off = (j + kLanesPerTok * pc) * G::kPieceBytes;
            Piece<KV, PE>::load(kbuf + tt * G::kRowBytes + off,
                                kf[u] + pc * PE);
            Piece<KV, PE>::load(vbuf + tt * G::kRowBytes + off,
                                vf[u] + pc * PE);
          }
          if (G::kQuant) {
            const float2 sc = tok_scale[buf * G::kStageTok + tt];
            ks[u] = sc.x; vs[u] = sc.y;
          } else {
            ks[u] = 1.f; vs[u] = 1.f;
          }
        }
#pragma unroll
        for (int r = 0; r < RC; ++r) {
          if (r >= nrows) continue;                // CTA-uniform
          float qv[E];
#pragma unroll
          for (int pc = 0; pc < G::kPieces; ++pc)
#pragma unroll
            for (int e = 0; e < PE; ++e)
              qv[pc * PE + e] =
                  G::kQReg
                      ? qreg[G::kQReg ? r : 0][G::kQReg ? pc * PE + e : 0]
                      : q_s[r * D + (j + kLanesPerTok * pc) * PE + e];
          float sv[U];
          float mx = m[r];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            float p0 = 0.f, p1 = 0.f;              // two chains for ILP
#pragma unroll
            for (int e = 0; e < E; e += 2) {
              p0 = fmaf(qv[e], kf[u][e], p0);
              p1 = fmaf(qv[e + 1], kf[u][e + 1], p1);
            }
            float part = p0 + p1;
            part += __shfl_xor_sync(0xffffffffu, part, 1);
            part += __shfl_xor_sync(0xffffffffu, part, 2);
            part += __shfl_xor_sync(0xffffffffu, part, 4);
            sv[u] = t[u] < lim[r] ? part * ks[u] : kNegInf;
            mx = fmaxf(mx, sv[u]);
          }
          const float corr = exp2f(m[r] - mx);
          m[r] = mx;
          float pv[U];
          float lsum = 0.f;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float pr = t[u] < lim[r] ? exp2f(sv[u] - mx) : 0.f;
            lsum += pr;
            pv[u] = pr * vs[u];
          }
          l[r] = fmaf(l[r], corr, lsum);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            float a = acc[r][e] * corr;
#pragma unroll
            for (int u = 0; u < U; ++u) a = fmaf(pv[u], vf[u][e], a);
            acc[r][e] = a;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                                 // the ring is free

  // each warp's (m, l, acc) per row into shared memory, then the warps
  float* red_acc = reinterpret_cast<float*>(ring);  // [warp][RT][D]
  float* red_ml = red_acc + kWarps * RT * D;        // [warp][RT][2]
  if constexpr (G::kMma) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ll = lr[h];                            // the quad's partial sums
      ll += __shfl_xor_sync(0xffffffffu, ll, 1);
      ll += __shfl_xor_sync(0xffffffffu, ll, 2);
      const int r = g + 8 * h;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float* dst = red_acc + (warp * RT + r) * D + n * 8 + qd * 2;
        dst[0] = o[n][2 * h];
        dst[1] = o[n][2 * h + 1];
      }
      if (qd == 0) {
        red_ml[(warp * RT + r) * 2] = mr[h];
        red_ml[(warp * RT + r) * 2 + 1] = ll;
      }
    }
  } else {
    // first the four lane groups of each warp
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      if (r >= nrows) continue;
      float mm = m[r];
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, 8));
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, 16));
      const float c = exp2f(m[r] - mm);
      float ll = l[r] * c;
      ll += __shfl_xor_sync(0xffffffffu, ll, 8);
      ll += __shfl_xor_sync(0xffffffffu, ll, 16);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float a = acc[r][e] * c;
        a += __shfl_xor_sync(0xffffffffu, a, 8);
        a += __shfl_xor_sync(0xffffffffu, a, 16);
        acc[r][e] = a;
      }
      if (grp == 0) {
#pragma unroll
        for (int pc = 0; pc < G::kPieces; ++pc)
#pragma unroll
          for (int e = 0; e < PE; ++e)
            red_acc[(warp * RT + r) * D + (j + kLanesPerTok * pc) * PE + e] =
                acc[r][pc * PE + e];
        if (j == 0) {
          red_ml[(warp * RT + r) * 2] = mm;
          red_ml[(warp * RT + r) * 2 + 1] = ll;
        }
      }
    }
  }
  __syncthreads();
  const bool direct = p.n_chunks == 1;
  for (int i = tid; i < nrows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mm = fmaxf(mm, red_ml[(w * RT + r) * 2]);
    float ll = 0.f, oo = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float cw = exp2f(red_ml[(w * RT + r) * 2] - mm);
      ll = fmaf(red_ml[(w * RT + r) * 2 + 1], cw, ll);
      oo = fmaf(red_acc[(w * RT + r) * D + c], cw, oo);
    }
    if (direct) {
      out[row_base(r) + c] = from_f<T>(ll > 0.f ? oo / ll : 0.f);
    } else {
      // workspace row (chunk, b, qi, h): acc[0:D], m, l
      const int rho = row0 + r;
      const int qi = rho / group, h = kvh * group + rho % group;
      float* w = p.ws + ((((size_t)chunk * p.batch + b) * p.qlen + qi) *
                             p.nh + h) * (D + 2);
      w[c] = oo;
      if (c == 0) { w[D] = mm; w[D + 1] = ll; }
    }
  }
}

// Second pass: one CTA of D threads per (window row, head) and request
// combines the live chunks' (acc, m, l) in base 2 and writes `out`.
template <int KIND, int D>
__global__ void __launch_bounds__(D)
paged_merge_kernel(const float* __restrict__ ws,
                   const int* __restrict__ seq_lens, void* out_, int batch,
                   int qlen, int nh, int chunk_tok, int table_tok) {
  using T = typename Kind<KIND>::T;
  const int b = blockIdx.y;
  const int row = blockIdx.x;                       // qi * nh + h
  const int c = threadIdx.x;
  const int len = min(seq_lens[b], table_tok);
  const int live = len > 0 ? (len + chunk_tok - 1) / chunk_tok : 0;
  const size_t chunk_stride = (size_t)batch * qlen * nh * (D + 2);
  const float* w = ws + ((size_t)b * qlen * nh + row) * (D + 2);
  float mm = kNegInf;
  for (int k = 0; k < live; ++k) mm = fmaxf(mm, w[k * chunk_stride + D]);
  float ll = 0.f, oo = 0.f;
  for (int k = 0; k < live; ++k) {
    const float* wk = w + k * chunk_stride;
    const float cw = exp2f(wk[D] - mm);   // 0 for a chunk the row cannot see
    ll = fmaf(wk[D + 1], cw, ll);
    oo = fmaf(wk[c], cw, oo);
  }
  T* out = static_cast<T*>(out_);
  out[((size_t)b * qlen * nh + row) * D + c] =
      from_f<T>(ll > 0.f ? oo / ll : 0.f);
}

template <int KIND, int D, int RT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using G = Geo<KIND, D, RT>;
  auto kernel = paged_split_kernel<KIND, D, RT>;
  if (G::kSmem > 48 * 1024) {
    // once per device: the attribute is the function's, per device
    static bool done[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || !done[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
      if (err != cudaSuccess) return err;
      if (dev < 64) done[dev] = true;
    }
  }
  const dim3 grid(p.n_chunks * p.row_tiles, p.batch, p.nh_kv);
  kernel<<<grid, kThreads, G::kSmem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_chunks == 1) return err;
  const dim3 mgrid(p.qlen * p.nh, p.batch);
  paged_merge_kernel<KIND, D><<<mgrid, D, 0, stream>>>(
      p.ws, p.seq_lens, p.out, p.batch, p.qlen, p.nh,
      p.chunk_pages * p.page_size, p.max_pages * p.page_size);
  return cudaGetLastError();
}

template <int KIND, int D>
cudaError_t by_rows(const Params& p, int rows_per_cta, cudaStream_t s) {
  switch (rows_per_cta) {
    case 1: return launch<KIND, D, 1>(p, s);
    case 2: return launch<KIND, D, 2>(p, s);
    case 4: return launch<KIND, D, 4>(p, s);
    case 8:
      if (D == 64) return launch<KIND, 64, 8>(p, s);
      break;
    case 16:
      if constexpr (KIND == 1 || KIND == 3) return launch<KIND, D, 16>(p, s);
      break;
  }
  return cudaErrorInvalidValue;
}

template <int KIND>
cudaError_t by_dim(const Params& p, int head_dim, int rows_per_cta,
                   cudaStream_t s) {
  if (head_dim == 64) return by_rows<KIND, 64>(p, rows_per_cta, s);
  if (head_dim == 128) return by_rows<KIND, 128>(p, rows_per_cta, s);
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (q and out); scales == nullptr: pools
// in q's dtype, else int8 pools. rows_per_cta: 1, 2, 4 or 8 (8 at d 64
// only) for the CUDA-core body, 16 for the tensor-core body (a bf16 q);
// the grid's row tiles follow from it.
int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const void* scales, const void* page_table,
             const void* seq_lens, void* out, void* ws, int batch, int qlen,
             int nh, int nh_kv, int head_dim, int page_size, int max_pages,
             int chunk_pages, int rows_per_cta, float scale, int dtype,
             void* stream) {
  if (batch <= 0) return 0;
  if (nh_kv <= 0 || nh % nh_kv || page_size <= 0 || max_pages <= 0 ||
      qlen < 1 || qlen > kMaxQlen || chunk_pages < 1 ||
      chunk_pages > kMaxChunkPages || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k_pages = k_pages; p.v_pages = v_pages;
  p.scales = static_cast<const float*>(scales);
  p.page_table = static_cast<const int*>(page_table);
  p.seq_lens = static_cast<const int*>(seq_lens);
  p.out = out; p.ws = static_cast<float*>(ws);
  p.batch = batch; p.qlen = qlen; p.nh = nh; p.nh_kv = nh_kv;
  p.page_size = page_size; p.max_pages = max_pages;
  p.chunk_pages = chunk_pages;
  p.n_chunks = (max_pages + chunk_pages - 1) / chunk_pages;
  const int rows = qlen * (nh / nh_kv);
  p.row_tiles = rows_per_cta > 0 ? (rows + rows_per_cta - 1) / rows_per_cta
                                 : 0;
  p.scale2 = scale * kLog2e;
  p.page_shift = (page_size & (page_size - 1)) ? -1 : __builtin_ctz(page_size);
  if (p.row_tiles <= 0 || (p.n_chunks > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kind = dtype + (scales != nullptr ? 2 : 0);
  switch (kind) {
    case 0: return (int)by_dim<0>(p, head_dim, rows_per_cta, s);
    case 1: return (int)by_dim<1>(p, head_dim, rows_per_cta, s);
    case 2: return (int)by_dim<2>(p, head_dim, rows_per_cta, s);
    default: return (int)by_dim<3>(p, head_dim, rows_per_cta, s);
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched). q, out (B, nh, d).
extern "C" int paged_attention_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* scales, const void* page_table, const void* seq_lens,
    void* out, void* workspace, int batch, int nh, int nh_kv, int head_dim,
    int page_size, int max_pages, int chunk_pages, int rows_per_cta,
    float scale, int dtype, void* stream) {
  return dispatch(q, k_pages, v_pages, scales, page_table, seq_lens, out,
                  workspace, batch, 1, nh, nh_kv, head_dim, page_size,
                  max_pages, chunk_pages, rows_per_cta, scale, dtype,
                  stream);
}

// q, out (B, qlen, nh, d), 1 <= qlen <= 8.
extern "C" int paged_attention_multiquery(
    const void* q, const void* k_pages, const void* v_pages,
    const void* scales, const void* page_table, const void* seq_lens,
    void* out, void* workspace, int batch, int qlen, int nh, int nh_kv,
    int head_dim, int page_size, int max_pages, int chunk_pages,
    int rows_per_cta, float scale, int dtype, void* stream) {
  return dispatch(q, k_pages, v_pages, scales, page_table, seq_lens, out,
                  workspace, batch, qlen, nh, nh_kv, head_dim, page_size,
                  max_pages, chunk_pages, rows_per_cta, scale, dtype,
                  stream);
}

extern "C" const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
