// Paged DistAttention MicroAttention partial, prefill chunk (paper Eq. 2).
//
// Replaces the Pallas TPU kernel repro/kernels/micro_attn_prefill.py::
// paged_prefill_micro_attention_kernel (body _kernel), and its vmap over
// the rank axis (repro/kernels/ops.py::paged_prefill_attention_ranks). A
// chunk of C query rows [C, H, D] attends over one rank's paged pool
// [NB, bs, K, D] through ONE shared -1-padded prefix table [MB]. There is
// no causal mask: every addressed token precedes every chunk query. Only
// the last valid slot is partial (tail_len tokens). Output: unnormalized
// o [C, H, D] and m, l [C, H], float32; an empty table gives (0, -inf, 0).
//
// The rank kernels (paged_prefill_ranks_mma_kernel and, float32,
// paged_prefill_ranks_f32_kernel, below) replace the JAX package's vmap
// of that kernel over the global pool's rank axis: one launch covers NR
// rank pools, [NB, bs, K, D] slabs rank_stride elements apart (a
// per-layer view of the global pool, read in place); q [C, H, D] is
// shared by every rank, tables [NR, MB], tails [NR]. Outputs: stacked,
// one partial a rank [NR, C, ...], or merged over the ranks in the launch
// [C, ...] (what the global pool's steps take). Bound by operations as
// above, but the prefix is spread unevenly over the ranks (qwen2-moe's
// global chunk: 32 / 160 / 27 blocks), so a (kv head, row tile, rank)
// grid with splits planned from shapes left 64 blocks walking 2,560
// tokens while the card idled. The rank design is the decode rank
// kernel's (paged_attn.cuh): persistent blocks (as many as the card
// holds at once) take equal shares of every group's 64-token tiles of
// valid prefix, found from the tables on the card; a block loads its q
// tile once a run of one group's tiles and walks them across ranks, the
// pool rows resolved two tiles ahead from the tables (so 128-token blocks
// are read in place, without the single-rank wrapper's sub-block
// tables); the last partial of a group to arrive LSE-merges them (the
// rank merge folded into the launch). The tile step is the one below:
// bf16 on mma.sync with the hi + lo contract, float32 on the CUDA cores.
// At the main shape the balanced walk is 14 tiles a block; what bounds
// it then is the mma.sync tile step's issue rate (see PERF.md).
//
// Bound on the H100: the larger of the FLOPs, 4 * C * S * H * D against
// 989 TFLOP/s (bf16 tensor cores) or 67 TFLOP/s (float32), and the
// bytes, S * K * D * 2 * itemsize against 3.35 TB/s. At the qwen3 path's
// main shape (C=512, H=16, K=8, D=128, S~3,000, bf16) that is 12.6 GFLOP
// against 12 MB of K/V: 0.0127 ms, bound by operations. Only the tensor
// cores approach it.
//
// bf16 pools: tensor cores (mma.sync), FlashAttention-2 register layout.
// - Grid (K, ceil(C*G / BM), NR * nsplit), 4 warps (128 threads) a block.
//   GQA packing as the Pallas kernel: the C*G rows (query, head of the kv
//   head's group), kv-head-major, so a block's rows share one kv head and
//   each K/V tile is staged once for all G heads. The wrapper
//   (prefill_plan) chooses BM, the split and the shared memory and passes
//   them in; the C entry checks them. Up to D = 128 a warp
//   owns two m16 tiles (32 rows, BM = 128), so every K/V fragment feeds
//   two independent products; at D = 256 one (BM = 64), whose
//   accumulators fill the registers alone. At the main shape 8 x 8 = 64
//   work items would leave most SMs idle, so the wrapper splits the
//   prefix's slot range (kernels/micro_attn_decode.py::plan_splits, from
//   shapes alone) into nsplit = 4 runs of whole slots: 256 blocks, 2 per
//   SM (105 KB of shared memory each at D = 128; 170 KB, one per SM, at
//   D = 256), merged in the same launch by the last split's block
//   (paged_attn.cuh).
// - The block copies its split's table slots to shared memory once and
//   resolves each tile's pool rows (table[t / bs] * bs + t % bs, for any
//   bs <= 64, whether or not bs divides the tile) two tiles ahead. K/V
//   tiles of 64 tokens go to shared memory through cp.async.cg (16 bytes
//   a copy) in a ring of 2 stages: tile i+1's loads are in flight while
//   tile i's MMAs run. Tokens past the split's valid part and -1 slots
//   are zero-filled (cp.async with src-size 0, no read) and their scores
//   masked to -inf (only tiles holding such tokens look). Rows are D + 8
//   elements apart (ldmatrix without bank conflicts); for D % 16 == 8 the
//   reduction is zero-padded to 16 in shared memory.
// - S = Q K^T with mma.sync.m16n8k16 bf16 -> fp32, A and B by ldmatrix;
//   the online softmax runs on the S accumulator fragment in float32
//   (exp2 of one fma; the accumulators are rescaled only when a row's max
//   moved), and the probabilities become the A operand of P V in
//   registers (no trip through shared memory); V by ldmatrix.trans. This
//   tile step is paged_attn.cuh's (qk_tile, softmax_tile, pv_tile), shared
//   with the flash-prefill kernel; this kernel adds the paged loads and
//   the mask of invalid tokens.
// - Why mma.sync and not wgmma: the FlashAttention-2 layout passes P from
//   the S accumulator to the next product inside each warp's registers,
//   which mma.sync does with warp-sized tiles and no warpgroup
//   synchronization; at this size (12.6 GFLOP, about a tenth of a
//   millisecond) its rate meets the goal of this redesign. wgmma and TMA
//   are a later step.
// - Registers: 255 at D = 128 (two 16 x 128 float32 accumulators and two
//   16 x 64 score tiles a warp); ptxas reports the spills of each build.
//
// Precision contract (bf16 pools). The Pallas kernel upcasts to float32
// and accumulates in float32; the kernel is held to 1e-4 against that
// float32 plain twin. (1) Q K^T: bf16 x bf16 products are exact in fp32;
// only the order of the fp32 sums differs. (2) P V: p is float32;
// rounding it to bf16 once (2^-8 relative per term) would exceed 1e-4 at
// the main shape, so p is split into hi = bf16(p) and lo = bf16(p - hi),
// and two MMAs against the same bf16 V tile give at most 2^-16 relative
// per term (1.5x the useful tensor-core work). (3) l is summed in float32
// from the float32 p, never from hi + lo. (4) m, the rescaling and the
// split merge are float32 on the CUDA cores.
//
// float32 pools keep the CUDA-core kernel (float32 FMAs, one block of 256
// threads per (kv head, 64 rows), 4 x 4 register tiles, no split).
#include "paged_attn.cuh"

namespace {

using paged_attn::cp_async16;
using paged_attn::cp_async_commit;
using paged_attn::cp_async_wait;
using paged_attn::row_stride;
using paged_attn::smem_addr;

// ---------------------------------------------------------------------
// float32 pools: CUDA cores.
// ---------------------------------------------------------------------

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
                         long long rank_stride, float scale) {
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
  const int rank = blockIdx.z;     // the block's rank pool
  const size_t rank_rows = static_cast<size_t>(rank) * C * H;
  pool_k += rank * rank_stride;
  pool_v += rank * rank_stride;
  table += static_cast<size_t>(rank) * MB;
  tail += rank;
  o += rank_rows * D;
  m_out += rank_rows;
  l_out += rank_rows;

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

// ---------------------------------------------------------------------
// bf16 pools: tensor cores.
// ---------------------------------------------------------------------
constexpr int MW = 4;            // warps a block
constexpr int BN = paged_attn::MMA_TOKENS;  // KV tokens a tile
constexpr int STAGES = 2;        // cp.async ring depth of K/V tiles
constexpr int ROW_RING = 3;      // tiles whose pool rows are resolved

// q (BM rows) and the K/V ring (bf16), the resolved pool rows of
// ROW_RING tiles, their "every token valid" flags, and the split's slice
// of the table (int32).
inline size_t mma_smem_bytes(int D, int BM, int slots) {
  return static_cast<size_t>(BM + 2 * STAGES * BN) * row_stride(D) * 2 +
         sizeof(int) * (ROW_RING * BN + 2 * ROW_RING + slots);
}

// DMAX: the largest head dim of the instantiation (64, 128 or 256); the
// register arrays are sized for it and loops stop at the runtime D. MT:
// m16 tiles of query rows a warp owns, so BM = 16 * MT * MW rows a block
// (the caller's rows_per_block).
template <int DMAX, int MT>
__global__ void __launch_bounds__(MW * 32)
    paged_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ pool_k,
                             const __nv_bfloat16* __restrict__ pool_v,
                             const int* __restrict__ table,
                             const int* __restrict__ tail,
                             float* __restrict__ o, float* __restrict__ m_out,
                             float* __restrict__ l_out,
                             float* __restrict__ ws,
                             unsigned* __restrict__ tickets, int C, int H,
                             int K, int D, int bs, int bs_shift, int MB,
                             int nsplit, int slots_per_split,
                             long long rank_stride, float scale) {
  constexpr int BM = 16 * MT * MW;  // query rows a block
  constexpr int NT = DMAX / 8;      // n8 tiles of the output columns
  constexpr int KC = DMAX / 16;     // k16 chunks of the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int DS = row_stride(D);
  const int DP = DS - 8;
  const int nrows_s = BM + 2 * STAGES * BN;
  __nv_bfloat16* q_s = sm;                      // [BM][DS]
  __nv_bfloat16* k_s = sm + BM * DS;            // [STAGES][BN][DS]
  __nv_bfloat16* v_s = k_s + STAGES * BN * DS;  // [STAGES][BN][DS]
  int* rows_s = reinterpret_cast<int*>(sm + nrows_s * DS);  // [RING][BN]
  int* full_s = rows_s + ROW_RING * BN;         // [RING][2]
  int* tab_s = full_s + 2 * ROW_RING;           // the split's table slots

  const int kh = blockIdx.x;
  const int G = H / K;
  const int CG = C * G;
  const int row0 = blockIdx.y * BM;
  const int nrows = min(BM, CG - row0);
  const int rank = blockIdx.z / nsplit;
  const int split = blockIdx.z - rank * nsplit;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nch = D / 8;  // 16-byte chunks in a row (D % 8 == 0)
  // The block's rank: its pool slab, table, tail and outputs.
  const size_t rank_rows = static_cast<size_t>(rank) * C * H;
  pool_k += rank * rank_stride;
  pool_v += rank * rank_stride;
  table += static_cast<size_t>(rank) * MB;
  tail += rank;
  o += rank_rows * D;
  m_out += rank_rows;
  l_out += rank_rows;

  // Zero the padded reduction columns [D, DP) once; cp.async never
  // writes them.
  if (DP > D) {
    const int w = DP - D;
    for (int idx = tid; idx < nrows_s * w; idx += blockDim.x)
      sm[(idx / w) * DS + D + idx % w] = __float2bfloat16_rn(0.f);
  }

  // q rows of the tile (zero past nrows).
  for (int idx = tid; idx < BM * nch; idx += blockDim.x) {
    const int r = idx / nch, ch = idx - r * nch, gr = row0 + r;
    const __nv_bfloat16* src = q;
    int bytes = 0;
    if (r < nrows) {
      const size_t head = static_cast<size_t>(gr / G) * H + kh * G + gr % G;
      src = q + head * D + ch * 8;
      bytes = 16;
    }
    cp_async16(smem_addr(q_s + r * DS + ch * 8), src, bytes);
  }

  // The split's table slots, to shared memory; its valid tokens are
  // [t_lo, t_hi).
  const int s0 = split * slots_per_split;
  const int ns = max(0, min(MB, s0 + slots_per_split) - s0);
  const int t_lo = s0 * bs;
  const int t_hi = t_lo + paged_attn::load_split_slots(table, MB, s0, ns, bs,
                                                       tail[0], tab_s);
  const int ntiles = t_hi > t_lo ? (t_hi - t_lo + BN - 1) / BN : 0;
  const size_t tok_stride = static_cast<size_t>(K) * D;

  // Pool row (block * bs + offset) of every token of tile `it`, or -1 past
  // the valid tokens and for -1 slots: one thread a token (warps 0, 1),
  // and whether every token of the tile is valid.
  auto resolve_rows = [&](int it) {
    if (tid < BN) {
      const int t = t_lo + it * BN + tid;
      int row = -1;
      if (t < t_hi) {
        const int sl = bs_shift >= 0 ? t >> bs_shift : t / bs;
        const int blk = tab_s[sl - s0];
        if (blk >= 0) row = blk * bs + (t - sl * bs);
      }
      rows_s[(it % ROW_RING) * BN + tid] = row;
      const bool all = __all_sync(0xffffffffu, row >= 0);
      if (lane == 0) full_s[(it % ROW_RING) * 2 + warp] = all;
    }
  };
  // Stage K/V tile `it` into ring slot it % STAGES: a thread keeps one
  // 16-byte column chunk and walks the tile's tokens; a token whose row
  // is -1 is zero-filled and never read.
  const int rpp = blockDim.x / nch;  // tokens a pass
  const int my_ch = tid % nch, my_tok = tid / nch;
  auto load_tile = [&](int it) {
    if (my_tok >= rpp) return;
    const int st = it % STAGES;
    const int* rows = rows_s + (it % ROW_RING) * BN;
    const uint32_t kd = smem_addr(k_s + st * BN * DS + my_ch * 8);
    const uint32_t vd = smem_addr(v_s + st * BN * DS + my_ch * 8);
    const size_t col = static_cast<size_t>(kh) * D + my_ch * 8;
    for (int tok = my_tok; tok < BN; tok += rpp) {
      const int row = rows[tok];
      const size_t off = row >= 0 ? row * tok_stride + col : 0;
      const int bytes = row >= 0 ? 16 : 0;
      cp_async16(kd + 2 * tok * DS, pool_k + off, bytes);
      cp_async16(vd + 2 * tok * DS, pool_v + off, bytes);
    }
  };

  resolve_rows(0);
  resolve_rows(1);
  __syncthreads();
  if (ntiles > 0) load_tile(0);
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

  const int wrow = warp * 16 * MT;
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
    if (it + 2 < ntiles) resolve_rows(it + 2);
    __syncthreads();
    const uint32_t k_base = smem_addr(k_s + st * BN * DS);
    const uint32_t v_base = smem_addr(v_s + st * BN * DS);
    const int* rows = rows_s + (it % ROW_RING) * BN;
    const bool full = full_s[(it % ROW_RING) * 2] &&
                      full_s[(it % ROW_RING) * 2 + 1];

    float sacc[MT][8][4];
    paged_attn::qk_tile<MT, KC>(sacc, q_base, k_base, ln, DS, D);
    // Tokens past the valid ones score -inf (only a tile with such tokens
    // reads the row flags).
    if (!full) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int tk = j * 8 + (lane & 3) * 2;
        const bool ok0 = rows[tk] >= 0, ok1 = rows[tk + 1] >= 0;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (!ok0) sacc[mt][j][0] = sacc[mt][j][2] = -CUDART_INF_F;
          if (!ok1) sacc[mt][j][1] = sacc[mt][j][3] = -CUDART_INF_F;
        }
      }
    }
    paged_attn::softmax_tile<MT, NT>(sacc, oacc, m_r, l_r, c);
    paged_attn::pv_tile<MT, NT>(oacc, sacc, v_base, ln, DS, D);
    __syncthreads();  // every warp is done with slot st before its reload
  }
  cp_async_wait<0>();

  // Scratch [nsplit, NR, C, H, D + 2]: this rank's slice of each split.
  const int NR = gridDim.z / nsplit;
  const size_t split_stride = static_cast<size_t>(NR) * C * H * (D + 2);
  float* ws_r = ws + rank_rows * (D + 2);
  float* po = o;
  float* pm = m_out;
  float* pls = l_out;
  size_t ostride = D, sstride = 1;
  if (nsplit > 1) {
    po = ws_r + split * split_stride;
    pm = po + D;
    pls = po + D + 1;
    ostride = sstride = D + 2;
  }
  auto head_of = [&](int r) {  // local row -> output row (query, head)
    const int gr = row0 + r;
    return (gr / G) * H + kh * G + gr % G;
  };
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // The quad's four threads share a row: sum their shares of l.
      float lr = l_r[mt][h];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int r = wrow + mt * 16 + (lane >> 2) + h * 8;
      if (r >= nrows) continue;
      const size_t head = static_cast<size_t>(head_of(r));
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = j * 8 + (lane & 3) * 2;
        if (col < D)
          *reinterpret_cast<float2*>(po + head * ostride + col) =
              make_float2(oacc[mt][j][2 * h], oacc[mt][j][2 * h + 1]);
      }
      if ((lane & 3) == 0) {
        pm[head * sstride] = m_r[mt][h] * scale;  // m of the scaled scores
        pls[head * sstride] = lr;
      }
    }
  }
  if (nsplit == 1) return;
  const size_t item =
      (static_cast<size_t>(rank) * K + kh) * gridDim.y + blockIdx.y;
  if (paged_attn::last_split_arrives(tickets + item, nsplit))
    paged_attn::merge_splits(ws_r, split_stride, nsplit, nrows, D, head_of, o,
                             m_out, l_out, reinterpret_cast<float*>(k_s));
}

// ---------------------------------------------------------------------
// Rank forms: persistent blocks over units of valid tokens.
// ---------------------------------------------------------------------
// The merge groups of a rank prefill are (kv head, tile of query rows);
// their units are 64-token tiles of each rank's prefix (paged_attn.cuh).
// A block walks its segments with the tile step of the kernels above:
// q tile once a segment, K/V tiles of any rank of the group, the pool
// rows resolved from the tables two tiles ahead (no table copy, so
// blocks of any size are read in place), one partial a segment.

// Output row (query, head) of local row i of kv head kh's rows from row0.
__device__ __forceinline__ int head_row(int row0, int i, int G, int H,
                                        int kh) {
  const int gr = row0 + i;
  return (gr / G) * H + kh * G + gr % G;
}

// The groups of merge row rho with no valid token: (0, -inf, 0), block
// g % B writing group g. HG = K * row tiles, BM rows a tile.
__device__ __forceinline__ void write_empty_groups(
    const paged_attn::UnitPlan& pl, int CG, int BM, int G, int H, int C,
    int D, float* o, float* m_out, float* l_out) {
  const int nrt = pl.HG / (H / G);
  for (int g = blockIdx.x; g < pl.P * pl.HG; g += gridDim.x) {
    const int rho = g / pl.HG;
    if (pl.group_units(rho) != 0) continue;
    const int h = g - rho * pl.HG, kh = h / nrt, row0 = (h - kh * nrt) * BM;
    const int nrows = min(BM, CG - row0);
    const size_t base = static_cast<size_t>(rho) * C * H;
    for (int idx = threadIdx.x; idx < nrows * (D + 1); idx += blockDim.x) {
      const int i = idx / (D + 1), d = idx - i * (D + 1);
      const size_t row = base + head_row(row0, i, G, H, kh);
      if (d < D) {
        o[row * D + d] = 0.f;
      } else {
        m_out[row] = -CUDART_INF_F;
        l_out[row] = 0.f;
      }
    }
  }
}

inline size_t rank_mma_smem_bytes(int D, int BM, int NR, int P) {
  return static_cast<size_t>(BM + 2 * STAGES * BN) * row_stride(D) * 2 +
         sizeof(int) * (ROW_RING * BN + 3 * ROW_RING + 4 * NR + P + 3);
}

template <int DMAX, int MT>
__global__ void __launch_bounds__(MW * 32)
    paged_prefill_ranks_mma_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ pool_k,
        const __nv_bfloat16* __restrict__ pool_v,
        const int* __restrict__ table, const int* __restrict__ tail,
        float* __restrict__ o, float* __restrict__ m_out,
        float* __restrict__ l_out, float* __restrict__ ws,
        unsigned* __restrict__ tickets, int NR, int C, int H, int K, int D,
        int bs, int MB, int stacked, long long rank_stride, float scale) {
  constexpr int BM = 16 * MT * MW;  // query rows a block
  constexpr int NT = DMAX / 8;
  constexpr int KC = DMAX / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int DS = row_stride(D);
  const int DP = DS - 8;
  const int nrows_s = BM + 2 * STAGES * BN;
  __nv_bfloat16* q_s = sm;                      // [BM][DS]
  __nv_bfloat16* k_s = sm + BM * DS;            // [STAGES][BN][DS]
  __nv_bfloat16* v_s = k_s + STAGES * BN * DS;  // [STAGES][BN][DS]
  int* rows_s = reinterpret_cast<int*>(sm + nrows_s * DS);  // [RING][BN]
  int* full_s = rows_s + ROW_RING * BN;         // [RING][2]
  int* rank_s = full_s + 2 * ROW_RING;          // [RING]
  int* S_s = rank_s + ROW_RING;                 // [NR]
  int* cum_s = S_s + NR;                        // [P + 1]
  int* span_s = cum_s + (stacked ? NR : 1) + 1;  // [NR][3]
  int* info_s = span_s + 3 * NR;                // [2]

  const int G = H / K;
  const int CG = C * G;
  const int nrt = (CG + BM - 1) / BM;  // row tiles a kv head
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nch = D / 8;
  const size_t W = paged_attn::part_row(D);
  const paged_attn::UnitPlan pl = paged_attn::plan_units(
      table, tail, NR, 1, MB, bs, BN, K * nrt, stacked != 0, S_s, cum_s);
  write_empty_groups(pl, CG, BM, G, H, C, D, o, m_out, l_out);
  const size_t tok_stride = static_cast<size_t>(K) * D;
  const int rpp = blockDim.x / nch;  // tokens a load pass
  const int my_ch = tid % nch, my_tok = tid / nch;
  const float c = scale * paged_attn::LOG2E;  // p = 2^((s - m) * c)
  const int wrow = warp * 16 * MT;
  const paged_attn::MmaLanes ln = paged_attn::mma_lanes(lane, wrow, DS);
  const uint32_t q_base = smem_addr(q_s);

  long long p, p1;
  pl.block_units(blockIdx.x, p, p1);
  while (p < p1) {
    const paged_attn::Segment sg = paged_attn::segment_at(pl, p, p1);
    const int kh = sg.h / nrt;
    const int row0 = (sg.h - kh * nrt) * BM;
    const int nrows = min(BM, CG - row0);
    const size_t obase = static_cast<size_t>(sg.rho) * C * H;
    __syncthreads();  // the previous segment is done with shared memory
    // Zero the padded reduction columns [D, DP): cp.async never writes
    // them, a merge may have.
    if (DP > D) {
      const int w = DP - D;
      for (int idx = tid; idx < nrows_s * w; idx += blockDim.x)
        sm[(idx / w) * DS + D + idx % w] = __float2bfloat16_rn(0.f);
    }

    // q rows of the tile (zero past nrows).
    for (int idx = tid; idx < BM * nch; idx += blockDim.x) {
      const int r = idx / nch, ch = idx - r * nch;
      const __nv_bfloat16* src = q;
      int bytes = 0;
      if (r < nrows) {
        src = q + static_cast<size_t>(head_row(row0, r, G, H, kh)) * D +
              ch * 8;
        bytes = 16;
      }
      cp_async16(smem_addr(q_s + r * DS + ch * 8), src, bytes);
    }

    // Pool rows (block * bs + offset in the tile's rank slab) of tile j,
    // or -1 past the valid tokens: one thread a token (warps 0, 1), and
    // whether every token of the tile is valid.
    paged_attn::segment_spans<BN>(pl, sg, span_s, info_s);
    const int ntiles = info_s[1];
    paged_attn::TileWalk<BN> walk;
    walk.start(span_s, info_s[0]);
    auto resolve = [&](int j) {
      if (tid < BN) {
        const int t = walk.t + tid;
        int row = -1;
        if (walk.valid() && t < walk.t_end()) {
          const int blk =
              table[static_cast<size_t>(walk.k()) * MB + t / bs];
          if (blk >= 0) row = blk * bs + t % bs;
        }
        rows_s[(j % ROW_RING) * BN + tid] = row;
        const bool all = __all_sync(0xffffffffu, row >= 0);
        if (lane == 0) full_s[(j % ROW_RING) * 2 + warp] = all;
        if (tid == 0) rank_s[j % ROW_RING] = walk.valid() ? walk.k() : 0;
      }
      walk.next();
    };
    auto load_tile = [&](int it) {
      if (my_tok >= rpp) return;
      const int st = it % STAGES;
      const int* rows = rows_s + (it % ROW_RING) * BN;
      const long long pool_off = rank_s[it % ROW_RING] * rank_stride;
      const uint32_t kd = smem_addr(k_s + st * BN * DS + my_ch * 8);
      const uint32_t vd = smem_addr(v_s + st * BN * DS + my_ch * 8);
      const size_t col = static_cast<size_t>(kh) * D + my_ch * 8;
      for (int tok = my_tok; tok < BN; tok += rpp) {
        const int row = rows[tok];
        const size_t off = row >= 0 ? row * tok_stride + col : 0;
        const int bytes = row >= 0 ? 16 : 0;
        cp_async16(kd + 2 * tok * DS, pool_k + pool_off + off, bytes);
        cp_async16(vd + 2 * tok * DS, pool_v + pool_off + off, bytes);
      }
    };
    resolve(0);
    resolve(1);
    __syncthreads();
    if (ntiles > 0) load_tile(0);
    cp_async_commit();  // group 0: q and the first tile

    float oacc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        oacc[mt][j][0] = oacc[mt][j][1] = oacc[mt][j][2] = oacc[mt][j][3] =
            0.f;
    float m_r[MT][2], l_r[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      m_r[mt][0] = m_r[mt][1] = -CUDART_INF_F;
      l_r[mt][0] = l_r[mt][1] = 0.f;
    }
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % STAGES;
      if (it + 1 < ntiles) {
        load_tile(it + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      if (it + 2 < ntiles) resolve(it + 2);
      __syncthreads();
      const uint32_t k_base = smem_addr(k_s + st * BN * DS);
      const uint32_t v_base = smem_addr(v_s + st * BN * DS);
      const int* rows = rows_s + (it % ROW_RING) * BN;
      const bool full = full_s[(it % ROW_RING) * 2] &&
                        full_s[(it % ROW_RING) * 2 + 1];
      float sacc[MT][8][4];
      paged_attn::qk_tile<MT, KC>(sacc, q_base, k_base, ln, DS, D);
      if (!full) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int tk = j * 8 + (lane & 3) * 2;
          const bool ok0 = rows[tk] >= 0, ok1 = rows[tk + 1] >= 0;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (!ok0) sacc[mt][j][0] = sacc[mt][j][2] = -CUDART_INF_F;
            if (!ok1) sacc[mt][j][1] = sacc[mt][j][3] = -CUDART_INF_F;
          }
        }
      }
      paged_attn::softmax_tile<MT, NT>(sacc, oacc, m_r, l_r, c);
      paged_attn::pv_tile<MT, NT>(oacc, sacc, v_base, ln, DS, D);
      __syncthreads();  // every warp is done with slot st before its reload
    }
    cp_async_wait<0>();

    // The segment's partial: to the outputs (the group's only partial) or
    // to the block's scratch slot b + g ([slot][BM][part_row(D)], by local
    // row).
    const int pfirst = pl.block_of(sg.first);
    const int parts = pl.block_of(sg.end - 1) - pfirst + 1;
    float* slot = ws + (static_cast<size_t>(blockIdx.x) + sg.g) * BM * W;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float lr = l_r[mt][h];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        const int r = wrow + mt * 16 + (lane >> 2) + h * 8;
        if (r >= nrows) continue;
        float *po, *pm, *pls;
        if (parts > 1) {
          po = slot + r * W;
          pm = po + D;
          pls = po + D + 1;
        } else {
          const size_t row = obase + head_row(row0, r, G, H, kh);
          po = o + row * D;
          pm = m_out + row;
          pls = l_out + row;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = j * 8 + (lane & 3) * 2;
          if (col < D)
            *reinterpret_cast<float2*>(po + col) =
                make_float2(oacc[mt][j][2 * h], oacc[mt][j][2 * h + 1]);
        }
        if ((lane & 3) == 0) {
          *pm = m_r[mt][h] * scale;  // m of the scaled scores
          *pls = lr;
        }
      }
    }
    if (parts > 1 && paged_attn::last_split_arrives(tickets + sg.g, parts))
      paged_attn::merge_parts(
          ws, BM * W, pfirst + sg.g, parts, nrows, D,
          [&](int i) {
            return static_cast<int>(obase) + head_row(row0, i, G, H, kh);
          },
          o, m_out, l_out, reinterpret_cast<float*>(smem_raw));
    p = min(p1, sg.end);
  }
}

inline size_t rank_f32_smem_bytes(int D, int DPT, int NR, int P) {
  return smem_bytes(D, DPT) + sizeof(int) * (4 * NR + P + 3);
}

// float32 pools: the CUDA-core body of paged_prefill_kernel over the
// segments of its block (tiles of TK tokens, loaded synchronously).
template <int DPT>
__global__ void __launch_bounds__(THREADS)
    paged_prefill_ranks_f32_kernel(const float* __restrict__ q,
                                   const float* __restrict__ pool_k,
                                   const float* __restrict__ pool_v,
                                   const int* __restrict__ table,
                                   const int* __restrict__ tail,
                                   float* __restrict__ o,
                                   float* __restrict__ m_out,
                                   float* __restrict__ l_out,
                                   float* __restrict__ ws,
                                   unsigned* __restrict__ tickets, int NR,
                                   int C, int H, int K, int D, int bs,
                                   int MB, int stacked,
                                   long long rank_stride, float scale) {
  constexpr int VEC = Vec<float>::N;
  constexpr int DP = 16 * DPT;
  extern __shared__ float smem[];
  float* q_s = smem;               // [D][TRP]   q, transposed
  float* k_s = q_s + D * TRP;      // [D][TKP]   K tile, transposed
  float* v_s = k_s + D * TKP;      // [TK][DP]   V tile
  float* p_s = v_s + TK * DP;      // [TR][TKP]  probabilities
  int* S_s = reinterpret_cast<int*>(p_s + TR * TKP);  // [NR]
  int* cum_s = S_s + NR;                              // [P + 1]
  int* span_s = cum_s + (stacked ? NR : 1) + 1;       // [NR][3]
  int* info_s = span_s + 3 * NR;                      // [2]

  const int G = H / K;
  const int CG = C * G;
  const int nrt = (CG + TR - 1) / TR;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t W = paged_attn::part_row(D);
  const paged_attn::UnitPlan pl = paged_attn::plan_units(
      table, tail, NR, 1, MB, bs, TK, K * nrt, stacked != 0, S_s, cum_s);
  write_empty_groups(pl, CG, TR, G, H, C, D, o, m_out, l_out);
  const size_t tok_stride = static_cast<size_t>(K) * D;
  const int nch = D / VEC;

  long long p, p1;
  pl.block_units(blockIdx.x, p, p1);
  while (p < p1) {
    const paged_attn::Segment sg = paged_attn::segment_at(pl, p, p1);
    const int kh = sg.h / nrt;
    const int row0 = (sg.h - kh * nrt) * TR;
    const int nrows = min(TR, CG - row0);
    const size_t obase = static_cast<size_t>(sg.rho) * C * H;
    __syncthreads();  // the previous segment is done with shared memory
    for (int idx = tid; idx < TR * D; idx += THREADS) {
      const int r = idx % TR, d = idx / TR;
      q_s[d * TRP + r] =
          r < nrows ? q[static_cast<size_t>(head_row(row0, r, G, H, kh)) *
                            D + d]
                    : 0.f;
    }
    float acc[4][DPT], m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -CUDART_INF_F;
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
    }
    paged_attn::segment_spans<TK>(pl, sg, span_s, info_s);
    paged_attn::TileWalk<TK> walk;
    for (walk.start(span_s, info_s[0]); walk.valid(); walk.next()) {
      const int t0 = walk.t, S = walk.t_end();
      const int* tab = table + static_cast<size_t>(walk.k()) * MB;
      const float* pk = pool_k + walk.k() * rank_stride;
      const float* pv = pool_v + walk.k() * rank_stride;
      __syncthreads();  // previous tile fully consumed; q_s written
      for (int idx = tid; idx < TK * nch; idx += THREADS) {
        const int tok = idx % TK, ch = idx / TK, t = t0 + tok;
        const int blk = t < S ? tab[t / bs] : -1;
        float x[VEC];
        if (blk >= 0) {
          load_vec(pk + (static_cast<size_t>(blk) * bs + t % bs) *
                            tok_stride + kh * D + ch * VEC, x);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) x[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) k_s[(ch * VEC + e) * TKP + tok] = x[e];
      }
      for (int idx = tid; idx < TK * (DP / VEC); idx += THREADS) {
        const int ch = idx % (DP / VEC), tok = idx / (DP / VEC), t = t0 + tok;
        const int blk = (t < S && ch < nch) ? tab[t / bs] : -1;
        float x[VEC];
        if (blk >= 0) {
          load_vec(pv + (static_cast<size_t>(blk) * bs + t % bs) *
                            tok_stride + kh * D + ch * VEC, x);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) x[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) v_s[tok * DP + ch * VEC + e] = x[e];
      }
      __syncthreads();
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_s + d * TRP + ty * 4);
        const float4 kv =
            *reinterpret_cast<const float4*>(k_s + d * TKP + tx * 4);
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
        ok[j] = t < S && tab[t / bs] >= 0;
      }
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
        float pr[4], sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pr[j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
          sum += pr[j];
        }
        sum = group16_sum(sum);
        m[i] = m_new;
        l[i] = l[i] * alpha + sum;
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] *= alpha;
        *reinterpret_cast<float4*>(p_s + (ty * 4 + i) * TKP + tx * 4) =
            make_float4(pr[0], pr[1], pr[2], pr[3]);
      }
      __syncthreads();
      for (int cc0 = 0; cc0 < TK; cc0 += 4) {
        float pa[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 pv4 = *reinterpret_cast<const float4*>(
              p_s + (ty * 4 + i) * TKP + cc0);
          pa[i][0] = pv4.x;
          pa[i][1] = pv4.y;
          pa[i][2] = pv4.z;
          pa[i][3] = pv4.w;
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float va[DPT];
#pragma unroll
          for (int e = 0; e < DPT; e += 4) {
            const float4 vv = *reinterpret_cast<const float4*>(
                v_s + (cc0 + cc) * DP + tx * DPT + e);
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

    const int pfirst = pl.block_of(sg.first);
    const int parts = pl.block_of(sg.end - 1) - pfirst + 1;
    float* slot = ws + (static_cast<size_t>(blockIdx.x) + sg.g) * TR * W;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r >= nrows) continue;
      float *po, *pm, *pls;
      if (parts > 1) {
        po = slot + r * W;
        pm = po + D;
        pls = po + D + 1;
      } else {
        const size_t row = obase + head_row(row0, r, G, H, kh);
        po = o + row * D;
        pm = m_out + row;
        pls = l_out + row;
      }
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const int d = tx * DPT + e;
        if (d < D) po[d] = acc[i][e];
      }
      if (tx == 0) {
        *pm = m[i];
        *pls = l[i];
      }
    }
    if (parts > 1 && paged_attn::last_split_arrives(tickets + sg.g, parts))
      paged_attn::merge_parts(
          ws, TR * W, pfirst + sg.g, parts, nrows, D,
          [&](int i) {
            return static_cast<int>(obase) + head_row(row0, i, G, H, kh);
          },
          o, m_out, l_out, k_s);
    p = min(p1, sg.end);
  }
}

// Returns cudaErrorInvalidValue unless the caller's shared memory and
// ticket count are what this instantiation needs.
template <int DMAX, int MT>
int launch_mma(const void* q, const void* pk, const void* pv,
               const void* table, const void* tail, void* o, void* m,
               void* l, void* ws, void* tickets, int NR, int C, int H, int K,
               int D, int bs, int MB, long long rank_stride, int nsplit,
               int slots_per_split, int smem_bytes, int n_tickets,
               float scale, cudaStream_t stream) {
  constexpr int BM = 16 * MT * MW;
  const size_t smem = mma_smem_bytes(D, BM, slots_per_split);
  const int rows = C * (H / K);
  const dim3 grid(K, (rows + BM - 1) / BM, NR * nsplit);
  if (static_cast<size_t>(smem_bytes) != smem ||
      (nsplit > 1 && static_cast<long>(grid.x) * grid.y * NR > n_tickets))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = paged_prefill_mma_kernel<DMAX, MT>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  // Ask for the largest shared-memory carve-out, so that as many blocks
  // as their shared memory allows share an SM.
  cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  const int bs_shift = (bs & (bs - 1)) ? -1 : __builtin_ctz(bs);
  kern<<<grid, MW * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pk),
      static_cast<const __nv_bfloat16*>(pv), static_cast<const int*>(table),
      static_cast<const int*>(tail), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(ws), static_cast<unsigned*>(tickets), C, H, K, D,
      bs, bs_shift, MB, nsplit, slots_per_split, rank_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DPT>
int launch(const void* q, const void* pk, const void* pv, const void* table,
           const void* tail, void* o, void* m, void* l, int NR, int C, int H,
           int K, int D, int bs, int MB, long long rank_stride, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D, DPT);
  auto kern = paged_prefill_kernel<T, DPT>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int rows = C * (H / K);
  const dim3 grid(K, (rows + TR - 1) / TR, NR);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), static_cast<const int*>(table),
      static_cast<const int*>(tail), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), C, H, K, D, bs, MB,
      rank_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

// The rank kernels' launch: returns cudaErrorInvalidValue unless the
// plan is one the instantiation launches (the tile as the unit, the
// caller's shared memory its own, a ticket counter per merge group).
template <typename T>
int launch_rank_kernel(void (*kern)(const T*, const T*, const T*,
                                    const int*, const int*, float*, float*,
                                    float*, float*, unsigned*, int, int, int,
                                    int, int, int, int, int, long long,
                                    float),
                       size_t smem, int blocks, int threads,
                       cudaStream_t stream, const void* q, const void* pk,
                       const void* pv, const void* table, const void* tail,
                       void* o, void* m, void* l, void* ws, void* tickets,
                       int NR, int C, int H, int K, int D, int bs, int MB,
                       int stacked, long long rank_stride, float scale) {
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  kern<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), static_cast<const int*>(table),
      static_cast<const int*>(tail), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(ws),
      static_cast<unsigned*>(tickets), NR, C, H, K, D, bs, MB, stacked,
      rank_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry: returns cudaGetLastError() after the launch (0 = success).
// dtype: 0 = float32 (CUDA cores, nsplit must be 1), 1 = bfloat16 (tensor
// cores); q and both pools share it. NR rank pools (NR = 1: one pool)
// start rank_stride elements apart; tables are [NR, MB], tails [NR],
// outputs [NR, C, H, ...]. The caller plans the launch
// (kernels/micro_attn_prefill.py::prefill_plan): rows_per_block picks the
// instantiation (bf16: 128 up to D = 128, 64 above; float32: 64), and
// smem_bytes (bf16) must equal what that instantiation lays out; any
// other value, or NR < 1, returns cudaErrorInvalidValue. With nsplit > 1,
// ws is a float32 scratch [nsplit, NR, C, H, D + 2] and tickets n_tickets
// zeroed uint32 counters, at least one per (rank, kv head, row tile),
// that the kernel leaves at zero; both may be null when nsplit == 1.
extern "C" int paged_prefill_launch(const void* q, const void* pool_k,
                                    const void* pool_v, const void* table,
                                    const void* tail, void* o, void* m,
                                    void* l, void* ws, void* tickets, int NR,
                                    int C, int H, int K, int D, int bs,
                                    int MB, long long rank_stride,
                                    int nsplit, int slots_per_split,
                                    int rows_per_block, int smem_bytes,
                                    int n_tickets, float scale, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (NR < 1 || nsplit < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    // Up to D = 128 a warp owns two m16 tiles (32 rows), so every K/V
    // fragment feeds two independent products; at D = 256 one, whose
    // accumulators fill the registers alone.
    if (D <= 64 && rows_per_block == 32 * MW)
      return launch_mma<64, 2>(q, pool_k, pool_v, table, tail, o, m, l, ws,
                               tickets, NR, C, H, K, D, bs, MB, rank_stride,
                               nsplit, slots_per_split, smem_bytes,
                               n_tickets, scale, s);
    if (D > 64 && D <= 128 && rows_per_block == 32 * MW)
      return launch_mma<128, 2>(q, pool_k, pool_v, table, tail, o, m, l, ws,
                                tickets, NR, C, H, K, D, bs, MB, rank_stride,
                                nsplit, slots_per_split, smem_bytes,
                                n_tickets, scale, s);
    if (D > 128 && rows_per_block == 16 * MW)
      return launch_mma<256, 1>(q, pool_k, pool_v, table, tail, o, m, l, ws,
                                tickets, NR, C, H, K, D, bs, MB, rank_stride,
                                nsplit, slots_per_split, smem_bytes,
                                n_tickets, scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nsplit != 1 || rows_per_block != TR)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 128)
    return launch<float, 8>(q, pool_k, pool_v, table, tail, o, m, l, NR, C,
                            H, K, D, bs, MB, rank_stride, scale, s);
  return launch<float, 16>(q, pool_k, pool_v, table, tail, o, m, l, NR, C, H,
                           K, D, bs, MB, rank_stride, scale, s);
}

// C entry of the rank kernels: returns cudaGetLastError() after the
// launch (0 = success). NR rank pools start rank_stride elements apart;
// tables [NR, MB], tails [NR]; q [C, H, D] (dtype as paged_prefill_launch:
// bf16 on the tensor cores, float32 on the CUDA cores). stacked = 0: one
// partial over every rank, outputs [C, H, ...]; stacked = 1: one a rank,
// outputs [NR, C, H, ...]. The caller plans the launch
// (kernels/micro_attn_prefill.py::rank_prefill_plan): unit_tokens (the
// 64-token tile), blocks, rows_per_block (the instantiation, as for
// paged_prefill_launch) and the shared memory it lays out; ws is a float32
// scratch of blocks + groups slots of rows_per_block * (D + 4) floats and
// tickets n_tickets zeroed uint32 counters, at least one per merge group
// (1 or NR, times K times the row tiles), which the kernel leaves at zero.
// Any other plan, or NR < 1, returns cudaErrorInvalidValue.
extern "C" int paged_prefill_ranks_launch(
    const void* q, const void* pool_k, const void* pool_v, const void* table,
    const void* tail, void* o, void* m, void* l, void* ws, void* tickets,
    int NR, int C, int H, int K, int D, int bs, int MB,
    long long rank_stride, int stacked, int unit_tokens, int blocks,
    int rows_per_block, int smem_bytes, int n_tickets, float scale,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bm = rows_per_block;
  const int P = stacked ? NR : 1;
  if (NR < 1 || blocks < 1 || unit_tokens != BN || bm < 1 ||
      static_cast<long>(P) * K * ((C * (H / K) + bm - 1) / bm) > n_tickets)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(smem_bytes);
  auto run = [&](auto kern, size_t need, int threads) {
    if (smem != need) return static_cast<int>(cudaErrorInvalidValue);
    return launch_rank_kernel(kern, smem, blocks, threads, s, q, pool_k,
                              pool_v, table, tail, o, m, l, ws, tickets, NR,
                              C, H, K, D, bs, MB, stacked, rank_stride,
                              scale);
  };
  if (dtype == 1) {
    if (D <= 64 && bm == 32 * MW)
      return run(paged_prefill_ranks_mma_kernel<64, 2>,
                 rank_mma_smem_bytes(D, bm, NR, P), MW * 32);
    if (D > 64 && D <= 128 && bm == 32 * MW)
      return run(paged_prefill_ranks_mma_kernel<128, 2>,
                 rank_mma_smem_bytes(D, bm, NR, P), MW * 32);
    if (D > 128 && bm == 16 * MW)
      return run(paged_prefill_ranks_mma_kernel<256, 1>,
                 rank_mma_smem_bytes(D, bm, NR, P), MW * 32);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bm != TR) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 128)
    return run(paged_prefill_ranks_f32_kernel<8>,
               rank_f32_smem_bytes(D, 8, NR, P), THREADS);
  return run(paged_prefill_ranks_f32_kernel<16>,
             rank_f32_smem_bytes(D, 16, NR, P), THREADS);
}
