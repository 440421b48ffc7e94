// Causal (optionally sliding-window) flash attention over a whole prompt.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_prefill.py::
// flash_prefill_kernel (body _kernel). q [B, S, H, D] attends over
// k/v [B, S, K, D] (GQA: query head h reads kv head h / (H / K)) under the
// causal mask kp <= qp and, when window > 0, the window kp > qp - window.
// Output [B, S, H, D] in q's dtype, normalized; a row with no valid key
// writes 0, never NaN.
//
// Bound on the H100: P live (query, key) pairs (P = sum over qp of
// min(qp + 1, window), or of qp + 1 without a window) cost 4 * B * H * D * P
// FLOPs; the bytes are (2 * B * S * H * D + 2 * B * S * K * D) * itemsize.
// At prompt lengths of hundreds of tokens and more the FLOPs bound it by
// far: at the hybrid admission (S = 6000, H = 16, K = 1, D = 256, window
// 2048) 167 GFLOP against 104 MB, 0.169 ms at 989 TFLOP/s (bf16 tensor
// cores) and 0.031 ms at 3.35 TB/s. Only the tensor cores approach it.
//
// bf16: tensor cores (mma.sync), FlashAttention-2 register layout, the
// tile step of paged_attn.cuh (qk_tile, softmax_tile, pv_tile) that the
// paged prefill-chunk kernel also runs.
// - One block per (tile of BM = 128 query positions, query head, batch
//   row), on a 1-D grid whose slowest index is the query tile, last tile
//   first: without a window the last tile has the most keys, so the
//   longest blocks start first. Up to D = 128 a block is 4 warps that own
//   two m16 row tiles each (32 rows; every K/V fragment feeds two
//   independent products); at D = 256 it is 8 warps of one m16 tile, whose
//   16 x 256 float32 output accumulator is 128 registers a thread alone.
//   128 rows a block either way: the reuse of a staged K/V tile is the
//   block's row count, and both give an SM 8 warps (D = 256: 203 KB of
//   shared memory, one block; D = 128: 104 KB, two).
// - Registers (ptxas -v, printed by chip_smoke.py; no spills): at D = 256
//   a tile step takes the whole 64-token tile; up to D = 128 it takes 32
//   tokens at a time (NJ = 4), which halves the 64 score registers of two
//   m16 tiles, where whole-tile steps spilled.
// - q (BM rows) stays in shared memory; its A fragments are loaded per k16
//   chunk for every tile (in registers they would take 64 more a thread at
//   D = 256). K/V tiles of 64 tokens arrive through cp.async.cg (16 bytes
//   a copy) in a ring of 2 stages: tile i+1's copies are in flight while
//   tile i's MMAs run. Tokens past S (and past the block's last query) are
//   zero-filled (src-size 0, no read). Rows are D rounded up to 16, plus 8
//   elements apart (ldmatrix without bank conflicts); for D % 16 == 8 the
//   reduction's last 8 columns are zeroed once.
// - Only live tiles are visited: from the window's first key, rounded
//   down to a tile, to the block's diagonal. Each warp classifies each
//   tile against its own rows, warp-uniformly: a tile wholly above its
//   diagonal or wholly before its window is skipped (no MMA; the warp only
//   joins the block's barriers), and only a tile that crosses its diagonal
//   or its window's first key builds the per-element mask. Keys past S
//   lie above every real row's diagonal, so the causal mask covers the
//   ragged end. At the hybrid admission shape 2 to 3 of the 33 to 35 tiles
//   a block visits are masked for any one warp.
// - GQA/MQA: a block serves one query head. At the hybrid shape the whole
//   K/V (6,000 x 256 x 2 bf16, 6 MB) sits in the 50 MB L2, the 16 heads'
//   blocks of a query tile are adjacent on the grid, and the reuse of a
//   staged tile is the block's 128 rows whichever heads they belong to; so
//   packing a kv group's heads into one block's rows (as the paged kernel
//   does) would save L2 reads, not HBM bytes. It is not built.
// - Why mma.sync and not wgmma: as in the paged prefill kernel, P passes
//   from the S accumulator to P V inside each warp's registers.
//
// Precision contract (bf16). The Pallas kernel and the plain twin upcast
// to float32 and round only the normalized output to bf16; the kernel is
// held to |kernel - plain| <= 1e-4 + 2^-7 |plain| (one bf16 ulp). (1) Q K^T:
// bf16 x bf16 products are exact in fp32; only the order of the sums
// differs. (2) P V: each float32 probability enters as bf16 hi + lo (two
// MMAs, at most 2^-16 relative per term). One rounding of p (2^-8) misses
// that tolerance at both main shapes and at short prompts, as the plain-
// PyTorch emulation in tests/test_torch_kernels.py shows on the CPU. (3) l
// is summed from the float32 p; m, the rescaling and 1 / l are float32.
//
// float32 keeps the CUDA-core kernel of the first port (one block of 256
// threads per (64 query positions, head, batch row), float32 FMAs on 4 x 4
// register tiles, q and K transposed in shared memory, about 217 KB at
// D = 256).
#include "paged_attn.cuh"

namespace {

using paged_attn::cp_async16;
using paged_attn::cp_async_commit;
using paged_attn::cp_async_wait;
using paged_attn::row_stride;
using paged_attn::smem_addr;

constexpr int MAX_DEVICES = 64;

// Raise kern's dynamic shared-memory limit to `bytes` (and prefer the
// largest carve-out) on the current device, once: ready[] is the calling
// instantiation's own flag per device.
template <typename Kern>
int allow_smem_once(Kern kern, size_t bytes, bool* ready) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < MAX_DEVICES && ready[dev]) return 0;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < MAX_DEVICES) ready[dev] = true;
  return 0;
}

// ---------------------------------------------------------------------
// float32: CUDA cores.
// ---------------------------------------------------------------------
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

// 4 floats at p (16-byte aligned).
__device__ __forceinline__ void load_vec(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
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

// One block per (64 query positions, head, batch row), tiles issued
// longest-first; only the live KV tiles of 64 tokens are visited, masks
// per element. Each K/V tile is staged in shared memory once for the 64
// rows; the 256 threads form a 16 x 16 grid holding 4 x 4 register tiles
// of scores, reduce row maxima and sums with warp shuffles, and keep the
// running (acc, m, l) of 4 rows x DPT columns in registers. A thread's
// columns are interleaved in groups of four (tx * 4 + 64 * j), so the 16
// threads of a row group read one contiguous run of the V tile.
// DPT: output columns per thread (D <= 16 * DPT).
template <int DPT>
__global__ void __launch_bounds__(THREADS)
    flash_prefill_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             float* __restrict__ o, int S, int H, int K,
                             int D, int window, float scale) {
  constexpr int VEC = 4;  // floats per 16-byte load
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
  const int nch = D / VEC;         // 16-byte chunks in a row

  const size_t q_tok = static_cast<size_t>(H) * D;   // q/o token stride
  const size_t kv_tok = static_cast<size_t>(K) * D;  // k/v token stride
  const float* qb = q + static_cast<size_t>(b) * S * q_tok + h * D;
  const float* kb = k + static_cast<size_t>(b) * S * kv_tok + kh * D;
  const float* vb = v + static_cast<size_t>(b) * S * kv_tok + kh * D;

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
  float* ob = o + static_cast<size_t>(b) * S * q_tok + h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q_lo + ty * 4 + i;
    if (t >= S) continue;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int d = (e / 4) * 64 + tx * 4 + e % 4;
      if (d < D) ob[t * q_tok + d] = acc[i][e] * inv;
    }
  }
}

template <int DPT>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int K, int D, int window, float scale,
               int smem_arg, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, DPT);
  if (static_cast<size_t>(smem_arg) != smem)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_prefill_f32_kernel<DPT>;
  static bool ready[MAX_DEVICES] = {};
  if (int e = allow_smem_once(kern, smem_bytes(16 * DPT, DPT), ready))
    return e;
  const dim3 grid((S + TQ - 1) / TQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, K, D,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// bf16: tensor cores.
// ---------------------------------------------------------------------
constexpr int BM = 128;                     // query rows a block
constexpr int BN = paged_attn::MMA_TOKENS;  // KV tokens a tile
constexpr int STAGES = 2;                   // cp.async ring depth

// q (BM rows) and the K/V ring, bf16.
inline size_t mma_smem_bytes(int D) {
  return static_cast<size_t>(BM + 2 * STAGES * BN) * row_stride(D) * 2;
}

// DMAX: the largest head dim of the instantiation (64, 128 or 256); the
// register arrays are sized for it and loops stop at the runtime D. MT:
// m16 row tiles a warp owns; MW: warps a block (16 * MT * MW == BM); NJ:
// n8 tiles of keys a tile step takes (8: the whole 64-token tile; 4: half
// of it at a time, with half the score registers).
template <int DMAX, int MT, int MW, int NJ>
__global__ void __launch_bounds__(MW * 32)
    flash_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             __nv_bfloat16* __restrict__ o, int S, int H,
                             int K, int D, int window, float scale) {
  static_assert(16 * MT * MW == BM, "a block owns BM rows");
  constexpr int KS = 8 * NJ;     // keys a tile step
  constexpr int NT = DMAX / 8;   // n8 tiles of the output columns
  constexpr int KC = DMAX / 16;  // k16 chunks of the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int DS = row_stride(D);
  const int DP = DS - 8;
  constexpr int nrows_s = BM + 2 * STAGES * BN;
  // q [BM][DS], then K [STAGES][BN][DS], then V [STAGES][BN][DS].
  __nv_bfloat16* q_s = sm;
  __nv_bfloat16* k_s = sm + BM * DS;

  // Block -> (query tile, head, batch row); the tile is the slowest index,
  // last tile first.
  const int n_qt = (S + BM - 1) / BM;
  const int hb = gridDim.x / n_qt;  // H * B
  const int q_lo = (n_qt - 1 - static_cast<int>(blockIdx.x) / hb) * BM;
  const int h = static_cast<int>(blockIdx.x) % hb % H;
  const int b = static_cast<int>(blockIdx.x) % hb / H;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nch = D / 8;  // 16-byte chunks in a row (D % 8 == 0)

  const int q_tok = H * D;   // q/o token stride
  const int kv_tok = K * D;  // k/v token stride
  // Offsets of the block's (batch row, head) in q/o and in k/v.
  const size_t qo = static_cast<size_t>(b) * S * q_tok +
                    static_cast<size_t>(h) * D;
  const size_t kv0 = static_cast<size_t>(b) * S * kv_tok +
                     static_cast<size_t>(kh) * D;

  // Zero the padded reduction columns [D, DP) once; cp.async never
  // writes them.
  if (DP > D) {
    const int w = DP - D;
    for (int idx = tid; idx < nrows_s * w; idx += blockDim.x)
      sm[(idx / w) * DS + D + idx % w] = __float2bfloat16_rn(0.f);
  }

  // q rows of the tile (zero past S).
  for (int idx = tid; idx < BM * nch; idx += blockDim.x) {
    const int r = idx / nch, ch = idx - r * nch, t = q_lo + r;
    const bool ok = t < S;
    cp_async16(smem_addr(q_s + r * DS + ch * 8),
               q + qo + (ok ? static_cast<size_t>(t) * q_tok + ch * 8 : 0),
               ok ? 16 : 0);
  }

  // Live KV tiles: from the window's first key (tile-aligned) up to the
  // block's last query; tokens at or past kv_end are zero-filled.
  const int kv_end = min(S, q_lo + BM);
  const int kv_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t_first = (kv_lo / BN) * BN;
  const int ntiles = (kv_end - t_first + BN - 1) / BN;

  // Stage K/V tile `it` into ring slot it % STAGES (K at k_sa + slot *
  // stage_bytes, V STAGES slots further): a thread keeps one 16-byte column
  // chunk and walks the tile's tokens, rpp apart. Few values stay live
  // across the main loop (32-bit shared offsets, k and v read from the
  // kernel's parameters), so that the accumulators keep the registers.
  const int rpp = blockDim.x / nch;  // tokens a pass
  const int my_tok = tid / nch;
  const size_t my_src = kv0 + (tid % nch) * 8;
  const uint32_t k_sa = smem_addr(k_s);
  const int stage_bytes = 2 * BN * DS;
  const uint32_t my_dst = k_sa + 2 * (my_tok * DS + (tid % nch) * 8);
  auto load_tile = [&](int it) {
    if (my_tok >= rpp) return;
    const uint32_t d0 = my_dst + (it % STAGES) * stage_bytes;
    const int t0 = t_first + it * BN;
    for (int tok = my_tok; tok < BN; tok += rpp) {
      const int t = t0 + tok;
      const bool ok = t < kv_end;
      const size_t off = my_src + (ok ? static_cast<size_t>(t) * kv_tok : 0);
      const uint32_t d = d0 + 2 * (tok - my_tok) * DS;
      cp_async16(d, k + off, ok ? 16 : 0);
      cp_async16(d + STAGES * stage_bytes, v + off, ok ? 16 : 0);
    }
  };

  load_tile(0);
  cp_async_commit();  // group 0: q and the first tile

  float oacc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      oacc[mt][j][0] = oacc[mt][j][1] = oacc[mt][j][2] = oacc[mt][j][3] = 0.f;
  // Per m16 tile, rows lane/4 and lane/4 + 8: the running max of the raw
  // scores (q . k, before the scale) and this thread's share of l.
  float m_r[MT][2], l_r[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_r[mt][0] = m_r[mt][1] = -CUDART_INF_F;
    l_r[mt][0] = l_r[mt][1] = 0.f;
  }
  const float c = scale * paged_attn::LOG2E;  // p = 2^((s - m) * c)

  // The warp's query positions [r0, r1].
  const int wrow = warp * 16 * MT;
  const int r0 = q_lo + wrow;
  const int r1 = r0 + 16 * MT - 1;
  const paged_attn::MmaLanes ln = paged_attn::mma_lanes(lane, wrow, DS);
  const uint32_t q_base = smem_addr(q_s);

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % STAGES;
    if (it + 1 < ntiles) {
      load_tile(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // Warp-uniform, per step of KS keys: skip one with no valid key for any
    // of the warp's rows (wholly above its diagonal, wholly before its
    // window, or rows past S only); mask only one that crosses its diagonal
    // or its window's first key.
#pragma unroll
    for (int ks = 0; ks < BN; ks += KS) {
      const int t0 = t_first + it * BN + ks;
      if (r0 >= S || t0 > r1 || (window > 0 && t0 + KS - 1 <= r0 - window))
        continue;
      const uint32_t k_st = k_sa + st * stage_bytes + 2 * ks * DS;
      float sacc[MT][NJ][4];
      paged_attn::qk_tile<MT, KC, NJ>(sacc, q_base, k_st, ln, DS, D);
      if (t0 + KS - 1 > r0 || (window > 0 && t0 <= r1 - window)) {
        // Key kp is valid for query qp iff 0 <= qp - kp < window (no upper
        // limit without a window): one unsigned compare an element.
        const unsigned lim = window > 0 ? window : 0x7fffffffu;
        const int d0 = r0 + (lane >> 2) - t0 - (lane & 3) * 2;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int dq = d0 + mt * 16 + (e >> 1) * 8 - j * 8 - (e & 1);
              if (static_cast<unsigned>(dq) >= lim)
                sacc[mt][j][e] = -CUDART_INF_F;
            }
      }
      paged_attn::softmax_tile<MT, NT, NJ>(sacc, oacc, m_r, l_r, c);
      paged_attn::pv_tile<MT, NT, NJ>(oacc, sacc,
                                      k_st + STAGES * stage_bytes, ln, DS, D);
    }
    __syncthreads();  // every warp is done with slot st before its reload
  }

  // Normalized output in bf16; a row without a valid key (l == 0) writes 0.
  __nv_bfloat16* ob = o + qo;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      // The quad's four threads share a row: sum their shares of l.
      float lr = l_r[mt][hh];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int t = r0 + mt * 16 + (lane >> 2) + hh * 8;
      if (t >= S) continue;
      const float inv = lr == 0.f ? 0.f : 1.f / lr;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = j * 8 + (lane & 3) * 2;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(
              ob + static_cast<size_t>(t) * q_tok + col) =
              __floats2bfloat162_rn(oacc[mt][j][2 * hh] * inv,
                                    oacc[mt][j][2 * hh + 1] * inv);
      }
    }
  }
}

template <int DMAX, int MT, int MW, int NJ>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int K, int D, int window, float scale,
               int smem_arg, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(D);
  if (static_cast<size_t>(smem_arg) != smem)
    return static_cast<int>(cudaErrorInvalidValue);
  const long blocks = static_cast<long>((S + BM - 1) / BM) * H * B;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_prefill_mma_kernel<DMAX, MT, MW, NJ>;
  static bool ready[MAX_DEVICES] = {};
  if (int e = allow_smem_once(kern, mma_smem_bytes(DMAX), ready)) return e;
  kern<<<static_cast<unsigned>(blocks), MW * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, H, K, D, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry: returns cudaGetLastError() after the launch (0 = success).
// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); q, k, v
// and the output share it. The caller plans the launch (kernels/
// flash_prefill.py::flash_plan): rows_per_block (bf16 128, float32 64)
// and smem_bytes must be what the instantiation for (D, dtype) lays out;
// any other value returns cudaErrorInvalidValue.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* o, int B, int S,
                                    int H, int K, int D, int window,
                                    int rows_per_block, int smem_bytes,
                                    float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (rows_per_block != BM) return static_cast<int>(cudaErrorInvalidValue);
    if (D <= 64)
      return launch_mma<64, 2, 4, 4>(q, k, v, o, B, S, H, K, D, window, scale,
                                  smem_bytes, s);
    if (D <= 128)
      return launch_mma<128, 2, 4, 4>(q, k, v, o, B, S, H, K, D, window, scale,
                                   smem_bytes, s);
    return launch_mma<256, 1, 8, 8>(q, k, v, o, B, S, H, K, D, window, scale,
                                 smem_bytes, s);
  }
  if (rows_per_block != TQ) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 128)
    return launch_f32<8>(q, k, v, o, B, S, H, K, D, window, scale,
                         smem_bytes, s);
  return launch_f32<16>(q, k, v, o, B, S, H, K, D, window, scale, smem_bytes,
                        s);
}
