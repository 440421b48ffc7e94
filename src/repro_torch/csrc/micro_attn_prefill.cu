// Paged DistAttention MicroAttention partial, prefill chunk (paper Eq. 2).
//
// Replaces the Pallas TPU kernel repro/kernels/micro_attn_prefill.py::
// paged_prefill_micro_attention_kernel (body _kernel). A chunk of C query
// rows [C, H, D] attends over one rank's paged pool [NB, bs, K, D] through
// ONE shared -1-padded prefix table [MB]. There is no causal mask: every
// addressed token precedes every chunk query. Only the last valid slot is
// partial (tail_len tokens). Output: unnormalized o [C, H, D] and m, l
// [C, H], float32; an empty table gives (0, -inf, 0).
//
// Bound on the H100: the larger of the FLOPs, 4 * C * S * H * D against
// 989 TFLOP/s, and the bytes, S * K * D * 2 * itemsize against 3.35 TB/s;
// at chunk sizes of hundreds of tokens the FLOPs dominate.
//
// Design: flash attention on the CUDA cores, in float32 like the Pallas
// kernel. One thread block per (kv head, tile of TR = 64 of the C * G
// (query, head) rows that share that kv head). Tables are prefix-
// contiguous, so the block counts the valid slots once and walks the
// prefix's valid tokens [0, S) in tiles of TK = 64, wherever their table
// blocks lie (-1 slots and the masked tail are never read). Each K/V
// tile is staged in shared memory ONCE and used by all 64 rows, so the
// prefix is read from device memory C * G / 64 times per kv head. The
// 256 threads form a 16 x 16 grid: a thread holds a 4 x 4 register tile
// of scores (4 rows x 4 tokens, two 16-byte shared loads per 16 FMAs),
// row maxima and sums are reduced over the 16 threads of a row group with
// warp shuffles, and the running (o, m, l) of its 4 rows x D/16 output
// columns stays in registers. Simple first version: the products do not
// use the tensor cores (wgmma) and the tile loads are not overlapped with
// compute (no cp.async or TMA), which is where the FLOP bound would be
// approached.
#include "paged_attn.cuh"

namespace {

constexpr int TR = 64;        // query rows per thread block
constexpr int TK = 64;        // KV tokens per tile
constexpr int THREADS = 256;  // a 16 x 16 thread grid
constexpr int TRP = TR + 4;   // padded strides (bank spread, 16-byte rows)
constexpr int TKP = TK + 4;

// Dynamic shared memory (bytes) for head dim D and DPT columns a thread.
inline size_t smem_bytes(int D, int DPT) {
  return sizeof(float) * (static_cast<size_t>(D) * TRP     // q, [D][TRP]
                          + static_cast<size_t>(D) * TKP   // k, [D][TKP]
                          + static_cast<size_t>(TK) * 16 * DPT  // v
                          + static_cast<size_t>(TR) * TKP);  // p, [TR][TKP]
}

// VEC consecutive elements at p as float32 (16-byte aligned).
__device__ __forceinline__ void load_vec(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* x) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  paged_attn::unpack_bf16x2(w.x, x[0], x[1]);
  paged_attn::unpack_bf16x2(w.y, x[2], x[3]);
  paged_attn::unpack_bf16x2(w.z, x[4], x[5]);
  paged_attn::unpack_bf16x2(w.w, x[6], x[7]);
}

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);  // elements per 16-byte load
};

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// DPT: output columns per thread (D <= 16 * DPT).
template <typename T, int DPT>
__global__ void __launch_bounds__(THREADS)
    paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                         const T* __restrict__ pool_v,
                         const int* __restrict__ table,
                         const int* __restrict__ tail, float* __restrict__ o,
                         float* __restrict__ m_out, float* __restrict__ l_out,
                         int C, int H, int K, int D, int bs, int MB,
                         float scale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int DP = 16 * DPT;
  extern __shared__ float smem[];
  float* q_s = smem;               // [D][TRP]   q, transposed
  float* k_s = q_s + D * TRP;      // [D][TKP]   K tile, transposed
  float* v_s = k_s + D * TKP;      // [TK][DP]   V tile
  float* p_s = v_s + TK * DP;      // [TR][TKP]  probabilities

  const int kh = blockIdx.x;
  const int G = H / K;
  const int row0 = blockIdx.y * TR;
  const int nrows = min(TR, C * G - row0);
  const int tid = threadIdx.x;
  const int tx = tid & 15;         // token / column group
  const int ty = tid >> 4;         // row group: rows ty*4 .. ty*4+3

  const int S = paged_attn::valid_tokens(table, MB, bs, tail[0]);

  // q rows of the tile, transposed, zero past nrows.
  for (int idx = tid; idx < TR * D; idx += THREADS) {
    const int r = idx % TR, d = idx / TR, gr = row0 + r;
    float x = 0.f;
    if (r < nrows) {
      const size_t head = static_cast<size_t>(gr / G) * H + kh * G + gr % G;
      x = paged_attn::to_f32(q[head * D + d]);
    }
    q_s[d * TRP + r] = x;
  }

  float acc[4][DPT], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  const size_t tok_stride = static_cast<size_t>(K) * D;
  const int nch = D / VEC;  // 16-byte chunks in a row (D % 8 == 0)
  for (int t0 = 0; t0 < S; t0 += TK) {
    __syncthreads();  // previous tile fully consumed; q_s written
    // K tile, transposed: consecutive threads take consecutive tokens.
    for (int idx = tid; idx < TK * nch; idx += THREADS) {
      const int tok = idx % TK, ch = idx / TK, t = t0 + tok;
      const int blk = t < S ? table[t / bs] : -1;
      float x[VEC];
      if (blk >= 0) {
        load_vec(pool_k + (static_cast<size_t>(blk) * bs + t % bs) *
                              tok_stride + kh * D + ch * VEC, x);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) k_s[(ch * VEC + e) * TKP + tok] = x[e];
    }
    // V tile, row-major: consecutive threads take consecutive chunks.
    for (int idx = tid; idx < TK * (DP / VEC); idx += THREADS) {
      const int ch = idx % (DP / VEC), tok = idx / (DP / VEC), t = t0 + tok;
      const int blk = (t < S && ch < nch) ? table[t / bs] : -1;
      float x[VEC];
      if (blk >= 0) {
        load_vec(pool_v + (static_cast<size_t>(blk) * bs + t % bs) *
                              tok_stride + kh * D + ch * VEC, x);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) v_s[tok * DP + ch * VEC + e] = x[e];
    }
    __syncthreads();

    // Scores: rows ty*4+i, tokens tx*4+j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(q_s + d * TRP +
                                                         ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(k_s + d * TKP +
                                                         tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + tx * 4 + j;
      ok[j] = t < S && table[t / bs] >= 0;
    }
    // Online softmax per row, reduced over the row group's 16 threads.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? s[i][j] * scale : -CUDART_INF_F;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = group16_max(mt);
      const float m_new = fmaxf(m[i], mt);
      const float alpha = m[i] == -CUDART_INF_F ? 0.f : expf(m[i] - m_new);
      float p[4], sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p[j];
      }
      sum = group16_sum(sum);
      m[i] = m_new;
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= alpha;
      *reinterpret_cast<float4*>(p_s + (ty * 4 + i) * TKP + tx * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

    // acc[rows ty*4+i][cols tx*DPT+e] += p @ V.
    for (int c = 0; c < TK; c += 4) {
      float pa[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(
            p_s + (ty * 4 + i) * TKP + c);
        pa[i][0] = pv.x;
        pa[i][1] = pv.y;
        pa[i][2] = pv.z;
        pa[i][3] = pv.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float va[DPT];
#pragma unroll
        for (int e = 0; e < DPT; e += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(
              v_s + (c + cc) * DP + tx * DPT + e);
          va[e] = vv.x;
          va[e + 1] = vv.y;
          va[e + 2] = vv.z;
          va[e + 3] = vv.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < DPT; ++e)
            acc[i][e] = fmaf(pa[i][cc], va[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nrows) continue;
    const int gr = row0 + r;
    const size_t head = static_cast<size_t>(gr / G) * H + kh * G + gr % G;
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int d = tx * DPT + e;
      if (d < D) o[head * D + d] = acc[i][e];
    }
    if (tx == 0) {
      m_out[head] = m[i];
      l_out[head] = l[i];
    }
  }
}

template <typename T, int DPT>
int launch(const void* q, const void* pk, const void* pv, const void* table,
           const void* tail, void* o, void* m, void* l, int C, int H, int K,
           int D, int bs, int MB, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, DPT);
  auto kern = paged_prefill_kernel<T, DPT>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int rows = C * (H / K);
  const dim3 grid(K, (rows + TR - 1) / TR);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), static_cast<const int*>(table),
      static_cast<const int*>(tail), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), C, H, K, D, bs, MB,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const void* q, const void* pk, const void* pv,
             const void* table, const void* tail, void* o, void* m, void* l,
             int C, int H, int K, int D, int bs, int MB, float scale,
             cudaStream_t s) {
  if (D <= 128)
    return launch<T, 8>(q, pk, pv, table, tail, o, m, l, C, H, K, D, bs, MB,
                        scale, s);
  return launch<T, 16>(q, pk, pv, table, tail, o, m, l, C, H, K, D, bs, MB,
                       scale, s);
}

}  // namespace

// C entry: returns cudaGetLastError() after the launch (0 = success).
// dtype: 0 = float32, 1 = bfloat16 (q and both pools share it).
extern "C" int paged_prefill_launch(const void* q, const void* pool_k,
                                    const void* pool_v, const void* table,
                                    const void* tail, void* o, void* m,
                                    void* l, int C, int H, int K, int D,
                                    int bs, int MB, float scale, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, pool_k, pool_v, table, tail, o, m, l,
                                   C, H, K, D, bs, MB, scale, s);
  return launch_t<float>(q, pool_k, pool_v, table, tail, o, m, l, C, H, K, D,
                         bs, MB, scale, s);
}
