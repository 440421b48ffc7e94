// Causal (optionally sliding-window) flash attention over a whole prompt.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_prefill.py::
// flash_prefill_kernel (body _kernel). q [B, S, H, D] attends over
// k/v [B, S, K, D] (GQA: query head h reads kv head h / (H / K)) under the
// causal mask kp <= qp and, when window > 0, the window kp > qp - window.
// Output [B, S, H, D] in q's dtype, normalized; a row with no valid key
// writes 0, never NaN. q, k and v are upcast to float32 and every product,
// exponential and sum is float32, as in the Pallas kernel.
//
// Bound on the H100: P live (query, key) pairs (P = sum over qp of
// min(qp + 1, window), or of qp + 1 without a window) cost 4 * B * H * D * P
// FLOPs; the bytes are (2 * B * S * H * D + 2 * B * S * K * D) * itemsize.
// At prompt lengths of hundreds to thousands of tokens the FLOPs bound it
// by far (against the bf16 tensor-core peak for bf16 storage, the float32
// CUDA-core peak for float32).
//
// Design: one thread block per (tile of TQ = 64 query positions, query
// head, batch row); tiles are issued longest-first (the last query tile
// has the most keys when there is no window). The block visits ONLY the
// live KV tiles of TK = 64 tokens: from max(0, q_lo - window + 1) rounded
// down to a tile, up to the diagonal; tiles above the diagonal or wholly
// before the window are never loaded. Masks are per element (causal,
// window, ragged end of S). Each K/V tile is staged in shared memory once
// and used by all 64 rows; the 256 threads form a 16 x 16 grid holding
// 4 x 4 register tiles of scores, reduce row maxima and sums with warp
// shuffles, and keep the running (acc, m, l) of 4 rows x D/16 columns in
// registers (online softmax). A thread's columns are interleaved in groups
// of four (tx * 4 + 64 * j), so the 16 threads of a row group read one
// contiguous run of the V tile, free of shared-memory bank conflicts. D = 256 needs ~217 KB of dynamic shared
// memory (q and K transposed, V, the probability tile), one block per SM.
// Simple first version: float32 FMAs on the CUDA cores, no tensor cores
// (wgmma), no TMA or cp.async overlap, and the MQA case re-reads each K/V
// tile once per query head instead of sharing it across the group.
#include "paged_attn.cuh"

namespace {

constexpr int TQ = 64;        // query rows per thread block
constexpr int TK = 64;        // KV tokens per tile
constexpr int THREADS = 256;  // a 16 x 16 thread grid
constexpr int TQP = TQ + 4;   // padded strides (bank spread, 16-byte rows)
constexpr int TKP = TK + 4;

// Dynamic shared memory (bytes) for head dim D and DPT columns a thread.
inline size_t smem_bytes(int D, int DPT) {
  return sizeof(float) * (static_cast<size_t>(D) * TQP     // q, [D][TQP]
                          + static_cast<size_t>(D) * TKP   // k, [D][TKP]
                          + static_cast<size_t>(TK) * 16 * DPT  // v
                          + static_cast<size_t>(TQ) * TKP);  // p, [TQ][TKP]
}

// 16 bytes at p (VEC elements) as float32; p is 16-byte aligned.
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

__device__ __forceinline__ float from_f32(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float x, __nv_bfloat16*) {
  return __float2bfloat16(x);
}

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
    flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int S,
                         int H, int K, int D, int window, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int DP = 16 * DPT;
  extern __shared__ float smem[];
  float* q_s = smem;               // [D][TQP]   q tile, transposed
  float* k_s = q_s + D * TQP;      // [D][TKP]   K tile, transposed
  float* v_s = k_s + D * TKP;      // [TK][DP]   V tile
  float* p_s = v_s + TK * DP;      // [TQ][TKP]  probabilities

  const int n_qt = (S + TQ - 1) / TQ;
  const int q_lo = (n_qt - 1 - static_cast<int>(blockIdx.x)) * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  const int tx = tid & 15;         // token / column group
  const int ty = tid >> 4;         // row group: rows ty*4 .. ty*4+3
  const int nch = D / VEC;         // 16-byte chunks in a row (D % 8 == 0)

  const size_t q_tok = static_cast<size_t>(H) * D;   // q/o token stride
  const size_t kv_tok = static_cast<size_t>(K) * D;  // k/v token stride
  const T* qb = q + static_cast<size_t>(b) * S * q_tok + h * D;
  const T* kb = k + static_cast<size_t>(b) * S * kv_tok + kh * D;
  const T* vb = v + static_cast<size_t>(b) * S * kv_tok + kh * D;

  // q rows of the tile, transposed, zero past S.
  for (int idx = tid; idx < TQ * nch; idx += THREADS) {
    const int r = idx % TQ, ch = idx / TQ, t = q_lo + r;
    float x[VEC];
    if (t < S) {
      load_vec(qb + t * q_tok + ch * VEC, x);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) q_s[(ch * VEC + e) * TQP + r] = x[e];
  }

  float acc[4][DPT], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  // Live KV tiles only: from the window's first key (tile-aligned) to
  // the tile's diagonal.
  const int kv_end = min(S, q_lo + TQ);
  const int kv_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  for (int t0 = (kv_lo / TK) * TK; t0 < kv_end; t0 += TK) {
    __syncthreads();  // previous tile fully consumed; q_s written
    // K tile, transposed: consecutive threads take consecutive tokens.
    for (int idx = tid; idx < TK * nch; idx += THREADS) {
      const int tok = idx % TK, ch = idx / TK, t = t0 + tok;
      float x[VEC];
      if (t < kv_end) {
        load_vec(kb + t * kv_tok + ch * VEC, x);
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
      float x[VEC];
      if (t < kv_end && ch < nch) {
        load_vec(vb + t * kv_tok + ch * VEC, x);
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
      const float4 qv = *reinterpret_cast<const float4*>(q_s + d * TQP +
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
    // Online softmax per row, reduced over the row group's 16 threads.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_lo + ty * 4 + i;
      bool ok[4];
      float mt = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = t0 + tx * 4 + j;
        ok[j] = kp <= qp && kp < S && (window <= 0 || kp > qp - window);
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

    // acc[rows ty*4+i][cols (e/4)*64 + tx*4 + e%4] += p @ V.
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
              v_s + (c + cc) * DP + e * 16 + tx * 4);
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

  // Normalized output; a row without a valid key (l == 0) writes 0.
  T* ob = o + static_cast<size_t>(b) * S * q_tok + h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q_lo + ty * 4 + i;
    if (t >= S) continue;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int d = (e / 4) * 64 + tx * 4 + e % 4;
      if (d < D)
        ob[t * q_tok + d] = from_f32(acc[i][e] * inv, static_cast<T*>(nullptr));
    }
  }
}

template <typename T, int DPT>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int K, int D, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D, DPT);
  auto kern = flash_prefill_kernel<T, DPT>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const dim3 grid((S + TQ - 1) / TQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, K, D, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int K, int D, int window, float scale,
             cudaStream_t s) {
  if (D <= 128)
    return launch<T, 8>(q, k, v, o, B, S, H, K, D, window, scale, s);
  return launch<T, 16>(q, k, v, o, B, S, H, K, D, window, scale, s);
}

}  // namespace

// C entry: returns cudaGetLastError() after the launch (0 = success).
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and the output share it).
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* o, int B, int S,
                                    int H, int K, int D, int window,
                                    float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k, v, o, B, S, H, K, D, window, scale,
                                   s);
  return launch_t<float>(q, k, v, o, B, S, H, K, D, window, scale, s);
}
