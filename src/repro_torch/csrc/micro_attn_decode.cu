// Paged DistAttention MicroAttention partial, decode (paper Eq. 2).
//
// Replaces the Pallas TPU kernel repro/kernels/micro_attn_decode.py::
// paged_micro_attention_kernel (body _kernel). One query token per request
// attends over one rank's paged pool [NB, bs, K, D] through the request's
// -1-padded block table [R, MB]; only the last valid slot is partial
// (tail_len[r] tokens). Output: unnormalized o [R, H, D] and m, l [R, H],
// all float32; an empty table gives (0, -inf, 0).
//
// Bound on the H100: HBM bytes. Each step reads every valid K/V row once,
// R * S * K * D * 2 * itemsize bytes, against ~4 FLOPs per KV element, far
// below the card's ~295 FLOP/byte ridge. What limits a simple kernel is
// latency: the loads of one token depend on its table entry, so the
// kernel needs many independent loads in flight to approach the bound.
//
// Design: one thread block per (kv head, request, group of up to GT of
// the kv head's G query heads). Tables are prefix-contiguous, so the
// block counts the valid slots once (nblk) and knows the request's valid
// token range [0, S). Each of its WARPS warps walks its own interleaved
// share of those tokens, U tokens per iteration: it issues all U tokens'
// K and V row loads first (a lane loads PL consecutive elements of a row
// with one vector load; -1 slots and the masked tail are never read),
// then computes the GT * U scores in float32 with warp-shuffle reductions
// and folds them into its own online-softmax state (o, m, l) in
// registers. One K/V load serves all the group's query heads (the GQA
// saving). At the end the warps' partials are LSE-merged through shared
// memory. No split across thread blocks, no tensor cores, no TMA: R * K
// thread blocks is all the parallelism a step has.
#include "paged_attn.cuh"

namespace {

constexpr int WARPS = 16;  // warps per thread block

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// PL consecutive elements at p (16-byte aligned for PL == 8 in bf16 and
// every fp32 case, 8-byte aligned for PL == 4 in bf16) as float32.
template <int PL>
__device__ __forceinline__ void load_row(const float* p, float (&x)[PL]) {
#pragma unroll
  for (int i = 0; i < PL; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    x[i] = v.x;
    x[i + 1] = v.y;
    x[i + 2] = v.z;
    x[i + 3] = v.w;
  }
}

template <int PL>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&x)[PL]) {
  if constexpr (PL == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    paged_attn::unpack_bf16x2(w.x, x[0], x[1]);
    paged_attn::unpack_bf16x2(w.y, x[2], x[3]);
  } else {
#pragma unroll
    for (int i = 0; i < PL; i += 8) {
      const uint4 w = *reinterpret_cast<const uint4*>(p + i);
      paged_attn::unpack_bf16x2(w.x, x[i], x[i + 1]);
      paged_attn::unpack_bf16x2(w.y, x[i + 2], x[i + 3]);
      paged_attn::unpack_bf16x2(w.z, x[i + 4], x[i + 5]);
      paged_attn::unpack_bf16x2(w.w, x[i + 6], x[i + 7]);
    }
  }
}

// GT: query heads per thread block; PL: head-dim elements per lane
// (D <= 32 * PL); U: tokens a warp has in flight per iteration.
template <typename T, int GT, int PL, int U>
__global__ void __launch_bounds__(WARPS * 32)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                        const T* __restrict__ pool_v,
                        const int* __restrict__ table,
                        const int* __restrict__ tail, float* __restrict__ o,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        int H, int K, int D, int bs, int MB, float scale) {
  const int kh = blockIdx.x;
  const int r = blockIdx.y;
  const int G = H / K;
  const int g0 = blockIdx.z * GT;
  const int ng = min(GT, G - g0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* tab = table + static_cast<size_t>(r) * MB;
  const bool lane_on = lane * PL < D;  // D is a multiple of 8

  const int S = paged_attn::valid_tokens(tab, MB, bs, tail[r]);

  float qr[GT][PL], acc[GT][PL], m[GT], l[GT];
  const size_t h0 = static_cast<size_t>(r) * H + kh * G + g0;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const int d = lane * PL + i;
      qr[g][i] = (g < ng && lane_on) ? paged_attn::to_f32(q[(h0 + g) * D + d])
                                     : 0.f;
      acc[g][i] = 0.f;
    }
  }

  const size_t tok_stride = static_cast<size_t>(K) * D;
  for (int t0 = warp * U; t0 < S; t0 += WARPS * U) {
    float kr[U][PL], vr[U][PL];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      const int blk = t < S ? tab[t / bs] : -1;
      ok[u] = blk >= 0;
      if (ok[u] && lane_on) {
        const size_t off = (static_cast<size_t>(blk) * bs + t % bs) *
                               tok_stride + kh * D + lane * PL;
        load_row<PL>(pool_k + off, kr[u]);
        load_row<PL>(pool_v + off, vr[u]);
      } else {
#pragma unroll
        for (int i = 0; i < PL; ++i) kr[u][i] = vr[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g >= ng) break;
      float s[U];
      float mb = -CUDART_INF_F;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < PL; ++i) a = fmaf(qr[g][i], kr[u][i], a);
        a = warp_sum(a) * scale;
        s[u] = ok[u] ? a : -CUDART_INF_F;
        mb = fmaxf(mb, s[u]);
      }
      const float m_new = fmaxf(m[g], mb);
      if (m_new == -CUDART_INF_F) continue;  // nothing valid yet
      const float alpha = m[g] == -CUDART_INF_F ? 0.f : expf(m[g] - m_new);
      float p[U];
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = ok[u] ? expf(s[u] - m_new) : 0.f;
        sum += p[u];
      }
      m[g] = m_new;
      l[g] = l[g] * alpha + sum;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        float a = acc[g][i] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(p[u], vr[u][i], a);
        acc[g][i] = a;
      }
    }
  }

  // LSE-merge the warps' partials: shared [WARPS][GT] m and l, then
  // [WARPS][GT][D] accumulators.
  extern __shared__ float smem[];
  float* sm_m = smem;
  float* sm_l = sm_m + WARPS * GT;
  float* sm_acc = sm_l + WARPS * GT;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lane == 0) {
      sm_m[warp * GT + g] = m[g];
      sm_l[warp * GT + g] = l[g];
    }
    if (lane_on) {
#pragma unroll
      for (int i = 0; i < PL; ++i)
        sm_acc[(warp * GT + g) * D + lane * PL + i] = acc[g][i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ng * D; idx += blockDim.x) {
    const int g = idx / D, d = idx - g * D;
    float mx = -CUDART_INF_F;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w * GT + g]);
    float sum = 0.f;
    if (mx != -CUDART_INF_F) {
      for (int w = 0; w < WARPS; ++w) {
        const float mw = sm_m[w * GT + g];
        if (mw != -CUDART_INF_F)
          sum = fmaf(sm_acc[(w * GT + g) * D + d], expf(mw - mx), sum);
      }
    }
    o[(h0 + g) * D + d] = sum;
  }
  for (int g = threadIdx.x; g < ng; g += blockDim.x) {
    float mx = -CUDART_INF_F;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w * GT + g]);
    float sum = 0.f;
    if (mx != -CUDART_INF_F) {
      for (int w = 0; w < WARPS; ++w) {
        const float mw = sm_m[w * GT + g];
        if (mw != -CUDART_INF_F) sum = fmaf(sm_l[w * GT + g], expf(mw - mx),
                                            sum);
      }
    }
    m_out[h0 + g] = mx;
    l_out[h0 + g] = sum;
  }
}

template <typename T, int GT, int PL>
int launch(const void* q, const void* pk, const void* pv, const void* table,
           const void* tail, void* o, void* m, void* l, int R, int H, int K,
           int D, int bs, int MB, float scale, cudaStream_t stream) {
  constexpr int U = GT <= 2 ? 4 : 2;
  auto kern = paged_decode_kernel<T, GT, PL, U>;
  const size_t smem = static_cast<size_t>(WARPS) * GT * (D + 2) *
                      sizeof(float);
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int G = H / K;
  const dim3 grid(K, R, (G + GT - 1) / GT);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), static_cast<const int*>(table),
      static_cast<const int*>(tail), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), H, K, D, bs, MB,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int PL>
int launch_pl(const void* q, const void* pk, const void* pv,
              const void* table, const void* tail, void* o, void* m, void* l,
              int R, int H, int K, int D, int bs, int MB, float scale,
              cudaStream_t s) {
  const int G = H / K;
  if (G == 1)
    return launch<T, 1, PL>(q, pk, pv, table, tail, o, m, l, R, H, K, D, bs,
                            MB, scale, s);
  if (G == 2)
    return launch<T, 2, PL>(q, pk, pv, table, tail, o, m, l, R, H, K, D, bs,
                            MB, scale, s);
  return launch<T, 4, PL>(q, pk, pv, table, tail, o, m, l, R, H, K, D, bs,
                          MB, scale, s);
}

template <typename T>
int launch_t(const void* q, const void* pk, const void* pv,
             const void* table, const void* tail, void* o, void* m, void* l,
             int R, int H, int K, int D, int bs, int MB, float scale,
             cudaStream_t s) {
  if (D <= 128)
    return launch_pl<T, 4>(q, pk, pv, table, tail, o, m, l, R, H, K, D, bs,
                           MB, scale, s);
  return launch_pl<T, 8>(q, pk, pv, table, tail, o, m, l, R, H, K, D, bs,
                         MB, scale, s);
}

}  // namespace

// C entry: returns cudaGetLastError() after the launch (0 = success).
// dtype: 0 = float32, 1 = bfloat16 (q and both pools share it).
extern "C" int paged_decode_launch(const void* q, const void* pool_k,
                                   const void* pool_v, const void* table,
                                   const void* tail, void* o, void* m,
                                   void* l, int R, int H, int K, int D,
                                   int bs, int MB, float scale, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, pool_k, pool_v, table, tail, o, m, l,
                                   R, H, K, D, bs, MB, scale, s);
  return launch_t<float>(q, pool_k, pool_v, table, tail, o, m, l, R, H, K, D,
                         bs, MB, scale, s);
}
