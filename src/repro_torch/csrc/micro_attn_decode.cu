// Paged DistAttention MicroAttention partial, decode (paper Eq. 2), split-KV.
//
// Replaces the Pallas TPU kernel repro/kernels/micro_attn_decode.py::
// paged_micro_attention_kernel (body _kernel), and its vmap over the rank
// axis (repro/kernels/ops.py::paged_micro_attention_ranks). One query
// token per request attends over one rank's paged pool [NB, bs, K, D]
// through the request's -1-padded block table [R, MB]; only the last valid
// slot is partial (tail_len[r] tokens). Output: unnormalized o [R, H, D]
// and m, l [R, H], all float32; an empty table gives (0, -inf, 0).
//
// The rank kernel (paged_decode_ranks_kernel, below) replaces the JAX
// package's vmap of that kernel over the global pool's rank axis: one
// launch covers NR rank pools, each a [NB, bs, K, D] slab rank_stride
// elements after the previous one (a per-layer view of the global pool
// [NR, L, NB, bs, K, D] is not contiguous; it is read in place, never
// copied). q [R, H, D] is shared by every rank; tables [NR, R, MB] and
// tails [NR, R]. Outputs: stacked, one partial a (rank, request) [NR, R,
// ...]; or merged, the ranks' partials LSE-merged in the launch [R, ...]
// (what the global pool's steps take). Its bound is the same HBM bytes,
// but where the bytes lie is known only on the card: in the paper's
// layout most of a request's KV sits on one rank (the owner's or one
// creditor's), so a split of every (rank, request) into equal runs of
// table slots, planned from shapes, leaves most blocks idle and a few
// walking thousands of tokens (qwen2-moe's global decode: 7 of 12
// (rank, request) pairs empty, one block a head walking 2,048 tokens
// against a mean of 192). The rank design:
// - Units of valid tokens, planned on the card (paged_attn.cuh): every
//   block finds each (rank, request)'s valid tokens from its table (an
//   L-ary search of the prefix-contiguous slots) and tail, cuts them into
//   units of at most U = 256 tokens and takes an equal share of all
//   groups' units, so no block walks more than ceil(units / blocks)
//   units however the KV is spread, and an empty pair reads no K/V. No
//   host read, no synchronization: the launch is persistent blocks, 3
//   an SM, from the shapes and the SM count (rank_decode_plan).
// - Units address tokens, not slots: a tile's pool rows (table[t / bs]
//   * bs + t % bs, on the tile's rank) are resolved two tiles ahead into
//   a ring in shared memory, so a block's walk crosses ranks and blocks
//   of any size without a copy of the tables.
// - The merge in the launch: a block stores one partial for each run of
//   one group's units it walked; the last of a group's partials to
//   arrive (ticket counter) LSE-merges them over every rank, and a group
//   with one partial is stored straight to the outputs. This folds the
//   rank merge (merge_partials over the stack, ~8 operations a layer)
//   into the launch.
// - The inner loop is the split-KV kernel's: CUDA cores, the cp.async
//   ring, GT query heads a K/V tile.
//
// Bound on the H100: HBM bytes. Each step reads every valid K/V row once,
// R * S * K * D * 2 * itemsize bytes, against ~4 FLOPs per KV element, far
// below the card's ~295 FLOP/byte ridge. At the qwen3 path's main shape
// (R=8, S~4,090, K=8, D=128, bf16) that is 134 MB, 0.040 ms at 3.35 TB/s.
// What keeps a kernel from it is latency: the loads of a token depend on
// its table entry, so the card needs megabytes of loads in flight, spread
// over every SM.
//
// Design: split-KV on the CUDA cores, K/V staged through shared memory.
// - Grid (K, R * ceil(G / GT), NR * nsplit), 4 warps a block: one block
//   per (kv head, request, group of GT <= 2 of the kv head's G query
//   heads, rank, split). The wrapper (decode_plan) chooses GT (1 where
//   G == 1, else 2) and passes it in, and splits each request's slot
//   range [0, MB) into nsplit contiguous runs of whole slots, from shapes
//   alone (never from the tables: a host read would synchronize the
//   step), so that the grid fills every SM and each split still spans
//   >= 256 tokens. At the
//   main shape: 64 work items x 6 splits = 384 blocks, ~3 per SM (71 KB
//   of shared memory each); at the serving phase's R=4 with a 64-slot
//   table, 32 x 4 = 128.
// - Each block copies its split's table slots and its q rows (float32)
//   to shared memory once, counts the table's valid slots (tables are
//   prefix-contiguous) and so knows the part of its split inside the
//   request's valid tokens; a split past them reads no K/V and yields
//   (0, -inf, 0).
// - K/V tiles (64 tokens of 256-byte rows; 32 or 16 tokens of wider
//   rows) go to shared memory through cp.async (16 bytes a copy) in a
//   ring of 2 stages, so a tile's loads are in flight while the previous
//   tile is computed and no register waits on device memory. -1 slots
//   and tokens past the valid ones are zero-filled, never read.
// - A warp takes a quarter of each tile. Scores: a token's q . k is split
//   over 32 / (tile / 4) lanes (2 at the main shape), each reading every
//   other 16-byte chunk of the K row, then one shuffle sums them; the
//   online softmax runs on the warp's tokens in float32. P V: a lane owns
//   D / 32 output columns and walks the warp's tokens, the probability
//   broadcast by a shuffle. One K/V tile serves the group's query heads
//   (the GQA saving). The warps' partials are LSE-merged through shared
//   memory; with nsplit > 1 the block stores that partial to the scratch
//   and the last split's block merges them (paged_attn.cuh: one launch
//   per call, a ticket counter per work item).
// - Warps per block: 4, because shared memory, not registers, bounds the
//   bytes in flight: a block keeps one 32 KB stage loading while it
//   computes the other, and ~3 blocks an SM keep ~100 KB in flight.
// Precision: float32 throughout (q, K and V upcast, the probabilities
// never rounded), as the Pallas kernel; the split changes only the order
// of the float32 sums. exp is taken as exp2 of a float32 product with
// log2(e) (2-ulp exp2, a relative error near 1e-6 at most).
#include "paged_attn.cuh"

namespace {

using paged_attn::cp_async16;
using paged_attn::cp_async_commit;
using paged_attn::cp_async_wait;
using paged_attn::LOG2E;
using paged_attn::smem_addr;

constexpr int WARPS = 4;  // warps per thread block
constexpr int STAGES = 2;  // cp.async ring depth of K/V tiles

// Tokens a K/V tile, by row size: 64 rows of up to 256 bytes, 32 of up
// to 512, 16 of up to 1 KB (a stage of K and V stays near 34 KB).
template <typename T, int DMAX>
__host__ __device__ constexpr int tile_tokens() {
  return DMAX * sizeof(T) <= 256 ? 64 : DMAX * sizeof(T) <= 512 ? 32 : 16;
}

// Shared-memory row stride (elements): the row plus 16 bytes, so that
// the lanes reading different rows at one column fall in distinct banks.
template <typename T>
__host__ __device__ inline int row_stride(int D) {
  return D + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int DMAX>
inline size_t smem_bytes(int D, int GT, int slots) {
  return static_cast<size_t>(2 * STAGES * tile_tokens<T, DMAX>()) *
             row_stride<T>(D) * sizeof(T) +
         sizeof(float) * GT * D + sizeof(int) * slots;
}

// N consecutive elements of shared memory (N * sizeof(T) a multiple of 8
// bytes, 8 or 16-byte aligned) as float32.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    x[i] = v.x;
    x[i + 1] = v.y;
    x[i + 2] = v.z;
    x[i + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&x)[N]) {
  if constexpr (N == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    paged_attn::unpack_bf16x2(w.x, x[0], x[1]);
    paged_attn::unpack_bf16x2(w.y, x[2], x[3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 w = *reinterpret_cast<const uint4*>(p + i);
      paged_attn::unpack_bf16x2(w.x, x[i], x[i + 1]);
      paged_attn::unpack_bf16x2(w.y, x[i + 2], x[i + 3]);
      paged_attn::unpack_bf16x2(w.z, x[i + 4], x[i + 5]);
      paged_attn::unpack_bf16x2(w.w, x[i + 6], x[i + 7]);
    }
  }
}

// GT: query heads a block serves (1 or 2); DMAX: 128 or 256, the largest
// head dim of the instantiation.
template <typename T, int GT, int DMAX>
__global__ void __launch_bounds__(WARPS * 32)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                        const T* __restrict__ pool_v,
                        const int* __restrict__ table,
                        const int* __restrict__ tail, float* __restrict__ o,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        float* __restrict__ ws, unsigned* __restrict__ tickets,
                        int R, int H, int K, int D, int bs, int bs_shift,
                        int MB, int nsplit, int slots_per_split,
                        long long rank_stride, float scale) {
  constexpr int TT = tile_tokens<T, DMAX>();  // tokens a tile
  constexpr int TPW = TT / WARPS;     // a warp's tokens of a tile
  constexpr int LPT = 32 / TPW;       // lanes sharing a token's q . k
  constexpr int VEC = 16 / sizeof(T);  // elements in 16 bytes
  constexpr int EPL = DMAX / 32;      // output columns a lane (P V)
  constexpr int MAXC = DMAX / VEC / LPT;  // q . k chunks a lane, at most
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DS = row_stride<T>(D);
  T* k_s = reinterpret_cast<T*>(smem_raw);      // [STAGES][TT][DS]
  T* v_s = k_s + STAGES * TT * DS;              // [STAGES][TT][DS]
  float* q_s = reinterpret_cast<float*>(v_s + STAGES * TT * DS);  // [GT][D]
  int* tab_s = reinterpret_cast<int*>(q_s + GT * D);  // the split's slots

  const int kh = blockIdx.x;
  const int G = H / K;
  const int ngroups = (G + GT - 1) / GT;
  const int r = blockIdx.y / ngroups;
  const int grp = blockIdx.y - r * ngroups;
  const int rank = blockIdx.z / nsplit;
  const int split = blockIdx.z - rank * nsplit;
  const int g0 = grp * GT;
  const int ng = min(GT, G - g0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // The block's rank: its table rows and tails here, its pool slab at
  // each load, its outputs in the epilogue (fewer values live in the
  // loop).
  const long long pool_off = rank * rank_stride;
  table += static_cast<size_t>(rank) * R * MB;
  tail += static_cast<size_t>(rank) * R;
  const int* tab = table + static_cast<size_t>(r) * MB;
  const size_t h0 = static_cast<size_t>(r) * H + kh * G + g0;

  // The group's q rows (float32) and the split's table slots, once; the
  // split's valid tokens are [t_lo, t_hi).
  for (int i = tid; i < GT * D; i += blockDim.x)
    q_s[i] = i < ng * D ? paged_attn::to_f32(q[h0 * D + i]) : 0.f;
  const int s0 = split * slots_per_split;
  const int ns = max(0, min(MB, s0 + slots_per_split) - s0);
  const int t_lo = s0 * bs;
  const int t_hi = t_lo + paged_attn::load_split_slots(tab, MB, s0, ns, bs,
                                                       tail[r], tab_s);
  const int ntiles = t_hi > t_lo ? (t_hi - t_lo + TT - 1) / TT : 0;
  const size_t tok_stride = static_cast<size_t>(K) * D;
  const int nchk = D / VEC;  // 16-byte chunks a row

  // Block of token t, or -1 past the valid tokens and for -1 slots.
  auto block_of = [&](int t) {
    if (t >= t_hi) return -1;
    return tab_s[(bs_shift >= 0 ? t >> bs_shift : t / bs) - s0];
  };
  // Stage tile `it` (K and V) into ring slot it % STAGES: a thread keeps
  // one 16-byte column chunk and walks the tile's tokens; a token with no
  // block is zero-filled and never read.
  const int rpp = blockDim.x / nchk;  // tokens a pass
  const int my_ch = tid % nchk, my_tok = tid / nchk;
  auto load_tile = [&](int it) {
    if (my_tok >= rpp) return;
    const int st = it % STAGES;
    const uint32_t kd = smem_addr(k_s + st * TT * DS + my_ch * VEC);
    const uint32_t vd = smem_addr(v_s + st * TT * DS + my_ch * VEC);
    const size_t col = static_cast<size_t>(kh) * D + my_ch * VEC;
    for (int tok = my_tok; tok < TT; tok += rpp) {
      const int t = t_lo + it * TT + tok;
      const int blk = block_of(t);
      size_t off = 0;
      int bytes = 0;
      if (blk >= 0) {
        const int in_blk = bs_shift >= 0 ? t & (bs - 1) : t % bs;
        off = (static_cast<size_t>(blk) * bs + in_blk) * tok_stride + col;
        bytes = 16;
      }
      cp_async16(kd + sizeof(T) * tok * DS, pool_k + pool_off + off, bytes);
      cp_async16(vd + sizeof(T) * tok * DS, pool_v + pool_off + off, bytes);
    }
  };

  __syncthreads();  // q_s written
  if (ntiles > 0) load_tile(0);
  cp_async_commit();

  // This warp's share of a tile: tokens warp * TPW + (lane % TPW); the
  // LPT lanes of a token split its 16-byte chunks (lane / TPW picks
  // every LPT-th). For P V a lane owns columns lane * EPL ...
  const int tw = warp * TPW + lane % TPW;
  const int sub = lane / TPW;
  const int e0 = lane * EPL;
  float m[GT], l[GT], acc[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
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
    __syncthreads();
    const T* kt = k_s + st * TT * DS;
    const T* vt = v_s + st * TT * DS;

    // Scores: a token's q . k over its lanes' chunks, then their sum.
    float part[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) part[g] = 0.f;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      const int c = sub + j * LPT;
      if (c < nchk) {
        float kv[VEC];
        load_vec<VEC>(kt + tw * DS + c * VEC, kv);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float qv[VEC];
          load_vec<VEC>(q_s + g * D + c * VEC, qv);
#pragma unroll
          for (int i = 0; i < VEC; ++i) part[g] = fmaf(qv[i], kv[i], part[g]);
        }
      }
    }
    const int t = t_lo + it * TT + tw;
    const bool ok = block_of(t) >= 0;
    float p[GT];
    bool rescale = false;
    float alpha[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int off = TPW; off < 32; off <<= 1)
        part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      const float sc = ok ? part[g] * scale : -CUDART_INF_F;
      float mx = sc;
#pragma unroll
      for (int off = 1; off < TPW; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      alpha[g] = m[g] == m_new ? 1.f
                 : m[g] == -CUDART_INF_F ? 0.f
                                         : exp2f((m[g] - m_new) * LOG2E);
      rescale |= alpha[g] != 1.f;
      p[g] = ok ? exp2f((sc - m_new) * LOG2E) : 0.f;
      float sum = p[g];
#pragma unroll
      for (int off = 1; off < TPW; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      m[g] = m_new;
      l[g] = l[g] * alpha[g] + sum;
    }
    if (rescale) {
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha[g];
    }
    // P V over the warp's tokens: lane j holds token j's probability.
#pragma unroll 4
    for (int j = 0; j < TPW; ++j) {
      float pj[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) pj[g] = __shfl_sync(0xffffffffu, p[g], j);
      if (e0 < D) {
        float vv[EPL];
        load_vec<EPL>(vt + (warp * TPW + j) * DS + e0, vv);
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[g][e] = fmaf(pj[g], vv[e], acc[g][e]);
      }
    }
    __syncthreads();  // every warp is done with slot st before its reload
  }
  cp_async_wait<0>();

  // LSE-merge the WARPS warps' partials through shared memory (the K
  // tiles' space): [WARPS][GT] m and l, then [WARPS][GT][D] accumulators.
  // The block's partial goes straight to the outputs (one split) or to
  // its split's scratch slice.
  float* sm_m = reinterpret_cast<float*>(smem_raw);
  float* sm_l = sm_m + WARPS * GT;
  float* sm_acc = sm_l + WARPS * GT;
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lane == 0) {
      sm_m[warp * GT + g] = m[g];
      sm_l[warp * GT + g] = l[g];
    }
    if (e0 < D) {
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        sm_acc[(warp * GT + g) * D + e0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  // This rank's outputs, and its slice of each split's scratch
  // [nsplit, NR, R, H, D + 2].
  const size_t rank_rows = static_cast<size_t>(rank) * R * H;
  o += rank_rows * D;
  m_out += rank_rows;
  l_out += rank_rows;
  const int NR = gridDim.z / nsplit;
  const size_t split_stride = static_cast<size_t>(NR) * R * H * (D + 2);
  float* ws_r = ws + rank_rows * (D + 2);
  float* po = o;
  float* pm = m_out;
  float* pl = l_out;
  size_t ostride = D, sstride = 1;
  if (nsplit > 1) {
    po = ws_r + split * split_stride;
    pm = po + D;
    pl = po + D + 1;
    ostride = sstride = D + 2;
  }
  // Thread (g, d) merges column d of head g; d == D merges m and l.
  for (int idx = tid; idx < ng * (D + 1); idx += blockDim.x) {
    const int g = idx / (D + 1), d = idx - g * (D + 1);
    float mx = -CUDART_INF_F;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w * GT + g]);
    float sum = 0.f;
    if (mx != -CUDART_INF_F) {
      for (int w = 0; w < WARPS; ++w) {
        const float mw = sm_m[w * GT + g];
        if (mw == -CUDART_INF_F) continue;
        const float x = d < D ? sm_acc[(w * GT + g) * D + d]
                              : sm_l[w * GT + g];
        sum = fmaf(x, exp2f((mw - mx) * LOG2E), sum);
      }
    }
    if (d < D) {
      po[(h0 + g) * ostride + d] = sum;
    } else {
      pm[(h0 + g) * sstride] = mx;
      pl[(h0 + g) * sstride] = sum;
    }
  }
  if (nsplit == 1) return;
  const size_t item =
      ((static_cast<size_t>(rank) * R + r) * ngroups + grp) * K + kh;
  if (paged_attn::last_split_arrives(tickets + item, nsplit))
    paged_attn::merge_splits(
        ws_r, split_stride, nsplit, ng, D,
        [h0](int i) { return static_cast<int>(h0) + i; }, o, m_out, l_out,
        sm_m);
}

// ---------------------------------------------------------------------
// Rank forms: persistent blocks over units of valid tokens.
// ---------------------------------------------------------------------
constexpr int RING = 3;  // tiles whose pool rows are resolved

template <typename T, int DMAX>
inline size_t rank_smem_bytes(int D, int GT, int R, int npair, int P) {
  return static_cast<size_t>(2 * STAGES * tile_tokens<T, DMAX>()) *
             row_stride<T>(D) * sizeof(T) +
         sizeof(float) * GT * D +
         sizeof(int) * (RING * tile_tokens<T, DMAX>() + RING + npair + P +
                        1 + 3 * (npair / R) + 2);
}

// The tile loop, the warps' merge and the loads of paged_decode_kernel,
// over a segment of units (paged_attn.cuh) instead of a split of slots:
// the K/V tiles' pool rows are resolved from the tables two tiles ahead
// into a ring (rows_s, with each tile's rank in rank_s), a tile may lie on
// any rank of the segment's group, and the block moves on to its next
// segment after storing this one's partial.
template <typename T, int GT, int DMAX>
__global__ void __launch_bounds__(WARPS * 32)
    paged_decode_ranks_kernel(const T* __restrict__ q,
                              const T* __restrict__ pool_k,
                              const T* __restrict__ pool_v,
                              const int* __restrict__ table,
                              const int* __restrict__ tail,
                              float* __restrict__ o,
                              float* __restrict__ m_out,
                              float* __restrict__ l_out,
                              float* __restrict__ ws,
                              unsigned* __restrict__ tickets, int NR, int R,
                              int H, int K, int D, int bs, int MB, int U,
                              int stacked, long long rank_stride,
                              float scale) {
  constexpr int TT = tile_tokens<T, DMAX>();  // tokens a tile
  constexpr int TPW = TT / WARPS;
  constexpr int LPT = 32 / TPW;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int EPL = DMAX / 32;
  constexpr int MAXC = DMAX / VEC / LPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DS = row_stride<T>(D);
  T* k_s = reinterpret_cast<T*>(smem_raw);      // [STAGES][TT][DS]
  T* v_s = k_s + STAGES * TT * DS;              // [STAGES][TT][DS]
  float* q_s = reinterpret_cast<float*>(v_s + STAGES * TT * DS);  // [GT][D]
  int* rows_s = reinterpret_cast<int*>(q_s + GT * D);  // [RING][TT]
  int* rank_s = rows_s + RING * TT;                    // [RING]
  int* S_s = rank_s + RING;                            // [NR * R]
  int* cum_s = S_s + NR * R;                           // [P + 1]
  int* span_s = cum_s + (stacked ? NR * R : R) + 1;    // [NR][3]
  int* info_s = span_s + 3 * NR;                       // [2]

  const int G = H / K;
  const int ngroups = (G + GT - 1) / GT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int B = gridDim.x;
  const paged_attn::UnitPlan pl =
      paged_attn::plan_units(table, tail, NR, R, MB, bs, U, K * ngroups,
                             stacked != 0, S_s, cum_s);
  const size_t tok_stride = static_cast<size_t>(K) * D;
  const int nchk = D / VEC;
  const size_t W = paged_attn::part_row(D);

  // Output rows of group g (merge row rho, head group h): rho * H + the
  // group's first head; the q rows: request r's.
  auto heads = [&](int h, int& ng) {
    const int kh = h / ngroups, g0 = (h - kh * ngroups) * GT;
    ng = min(GT, G - g0);
    return kh * G + g0;
  };
  // Groups with no valid token on any of their ranks: (0, -inf, 0).
  for (int g = blockIdx.x; g < pl.P * pl.HG; g += B) {
    const int rho = g / pl.HG;
    if (pl.group_units(rho) != 0) continue;
    int ng;
    const size_t h0 =
        static_cast<size_t>(rho) * H + heads(g - rho * pl.HG, ng);
    for (int i = tid; i < ng * D; i += blockDim.x) o[h0 * D + i] = 0.f;
    if (tid < ng) {
      m_out[h0 + tid] = -CUDART_INF_F;
      l_out[h0 + tid] = 0.f;
    }
  }

  const int tw = warp * TPW + lane % TPW;
  const int sub = lane / TPW;
  const int e0 = lane * EPL;
  const int rpp = blockDim.x / nchk;  // tokens a load pass
  const int my_ch = tid % nchk, my_tok = tid / nchk;
  long long p, p1;
  pl.block_units(blockIdx.x, p, p1);
  while (p < p1) {
    const paged_attn::Segment sg = paged_attn::segment_at(pl, p, p1);
    int ng;
    const int hoff = heads(sg.h, ng);
    const size_t h0 = static_cast<size_t>(sg.rho) * H + hoff;  // outputs
    const size_t hq = static_cast<size_t>(sg.r) * H + hoff;    // q rows
    const int kh = hoff / G;
    __syncthreads();  // the previous segment is done with shared memory
    for (int i = tid; i < GT * D; i += blockDim.x)
      q_s[i] = i < ng * D ? paged_attn::to_f32(q[hq * D + i]) : 0.f;
    paged_attn::segment_spans<TT>(pl, sg, span_s, info_s);
    const int ntiles = info_s[1];

    // Resolve tile j's pool rows (the walk is at tile j): block * bs +
    // offset within the tile's rank slab, -1 past the valid tokens.
    paged_attn::TileWalk<TT> walk;
    walk.start(span_s, info_s[0]);
    auto resolve = [&](int j) {
      if (tid < TT) {
        const int t = walk.t + tid;
        int row = -1;
        if (walk.valid() && t < walk.t_end()) {
          const int* tab =
              table + (static_cast<size_t>(walk.k()) * R + sg.r) * MB;
          const int blk = tab[t / bs];
          if (blk >= 0) row = blk * bs + t % bs;
        }
        rows_s[(j % RING) * TT + tid] = row;
        if (tid == 0) rank_s[j % RING] = walk.valid() ? walk.k() : 0;
      }
      walk.next();
    };
    auto load_tile = [&](int it) {
      if (my_tok >= rpp) return;
      const int st = it % STAGES;
      const int* rows = rows_s + (it % RING) * TT;
      const long long pool_off = rank_s[it % RING] * rank_stride;
      const uint32_t kd = smem_addr(k_s + st * TT * DS + my_ch * VEC);
      const uint32_t vd = smem_addr(v_s + st * TT * DS + my_ch * VEC);
      const size_t col = static_cast<size_t>(kh) * D + my_ch * VEC;
      for (int tok = my_tok; tok < TT; tok += rpp) {
        const int row = rows[tok];
        const size_t off = row >= 0 ? row * tok_stride + col : 0;
        const int bytes = row >= 0 ? 16 : 0;
        cp_async16(kd + sizeof(T) * tok * DS, pool_k + pool_off + off, bytes);
        cp_async16(vd + sizeof(T) * tok * DS, pool_v + pool_off + off, bytes);
      }
    };
    resolve(0);
    resolve(1);
    __syncthreads();  // q_s and the first rows written
    if (ntiles > 0) load_tile(0);
    cp_async_commit();

    float m[GT], l[GT], acc[GT][EPL];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      m[g] = -CUDART_INF_F;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
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
      const T* kt = k_s + st * TT * DS;
      const T* vt = v_s + st * TT * DS;
      float part[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) part[g] = 0.f;
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        const int c = sub + j * LPT;
        if (c < nchk) {
          float kv[VEC];
          load_vec<VEC>(kt + tw * DS + c * VEC, kv);
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            float qv[VEC];
            load_vec<VEC>(q_s + g * D + c * VEC, qv);
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              part[g] = fmaf(qv[i], kv[i], part[g]);
          }
        }
      }
      const bool ok = rows_s[(it % RING) * TT + tw] >= 0;
      float pr[GT];
      bool rescale = false;
      float alpha[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int off = TPW; off < 32; off <<= 1)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
        const float sc = ok ? part[g] * scale : -CUDART_INF_F;
        float mx = sc;
#pragma unroll
        for (int off = 1; off < TPW; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[g], mx);
        alpha[g] = m[g] == m_new ? 1.f
                   : m[g] == -CUDART_INF_F ? 0.f
                                           : exp2f((m[g] - m_new) * LOG2E);
        rescale |= alpha[g] != 1.f;
        pr[g] = ok ? exp2f((sc - m_new) * LOG2E) : 0.f;
        float sum = pr[g];
#pragma unroll
        for (int off = 1; off < TPW; off <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        m[g] = m_new;
        l[g] = l[g] * alpha[g] + sum;
      }
      if (rescale) {
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha[g];
      }
#pragma unroll 4
      for (int j = 0; j < TPW; ++j) {
        float pj[GT];
#pragma unroll
        for (int g = 0; g < GT; ++g)
          pj[g] = __shfl_sync(0xffffffffu, pr[g], j);
        if (e0 < D) {
          float vv[EPL];
          load_vec<EPL>(vt + (warp * TPW + j) * DS + e0, vv);
#pragma unroll
          for (int g = 0; g < GT; ++g)
#pragma unroll
            for (int e = 0; e < EPL; ++e)
              acc[g][e] = fmaf(pj[g], vv[e], acc[g][e]);
        }
      }
      __syncthreads();  // every warp is done with slot st before its reload
    }
    cp_async_wait<0>();

    // The warps' partials, LSE-merged through shared memory (the K tiles'
    // space), to the outputs (the group's only partial) or to the block's
    // scratch slot b + g ([slot][GT][part_row(D)]).
    const int pfirst = pl.block_of(sg.first);
    const int parts = pl.block_of(sg.end - 1) - pfirst + 1;
    float* sm_m = reinterpret_cast<float*>(smem_raw);
    float* sm_l = sm_m + WARPS * GT;
    float* sm_acc = sm_l + WARPS * GT;
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (lane == 0) {
        sm_m[warp * GT + g] = m[g];
        sm_l[warp * GT + g] = l[g];
      }
      if (e0 < D) {
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          sm_acc[(warp * GT + g) * D + e0 + e] = acc[g][e];
      }
    }
    __syncthreads();
    const size_t slot_stride = GT * W;
    float* po = o + h0 * D;
    float* pm = m_out + h0;
    float* pls = l_out + h0;
    size_t ostride = D, sstride = 1;
    if (parts > 1) {
      po = ws + (static_cast<size_t>(blockIdx.x) + sg.g) * slot_stride;
      pm = po + D;
      pls = po + D + 1;
      ostride = sstride = W;
    }
    for (int idx = tid; idx < ng * (D + 1); idx += blockDim.x) {
      const int g = idx / (D + 1), d = idx - g * (D + 1);
      float mx = -CUDART_INF_F;
      for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w * GT + g]);
      float sum = 0.f;
      if (mx != -CUDART_INF_F) {
        for (int w = 0; w < WARPS; ++w) {
          const float mw = sm_m[w * GT + g];
          if (mw == -CUDART_INF_F) continue;
          const float x = d < D ? sm_acc[(w * GT + g) * D + d]
                                : sm_l[w * GT + g];
          sum = fmaf(x, exp2f((mw - mx) * LOG2E), sum);
        }
      }
      if (d < D) {
        po[g * ostride + d] = sum;
      } else {
        pm[g * sstride] = mx;
        pls[g * sstride] = sum;
      }
    }
    if (parts > 1 && paged_attn::last_split_arrives(tickets + sg.g, parts))
      paged_attn::merge_parts(
          ws, slot_stride, pfirst + sg.g, parts, ng, D,
          [h0](int i) { return static_cast<int>(h0) + i; }, o, m_out, l_out,
          sm_m);
    p = min(p1, sg.end);
  }
}

struct Args {
  const void *q, *pk, *pv, *table, *tail;
  void *o, *m, *l, *ws, *tickets;
  int NR, R, H, K, D, bs, MB;
  long long rank_stride;
  int nsplit, slots_per_split, n_tickets;
  float scale;
};

// Returns cudaErrorInvalidValue when a split grid has more work items
// than the caller's ticket counters.
template <typename T, int GT, int DMAX>
int launch(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.K;
  const dim3 grid(a.K, a.R * ((G + GT - 1) / GT), a.NR * a.nsplit);
  if (a.nsplit > 1 &&
      static_cast<long>(grid.x) * grid.y * a.NR > a.n_tickets)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = paged_decode_kernel<T, GT, DMAX>;
  const size_t smem = smem_bytes<T, DMAX>(a.D, GT, a.slots_per_split);
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  const int bs_shift = (a.bs & (a.bs - 1)) ? -1 : __builtin_ctz(a.bs);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.pk),
      static_cast<const T*>(a.pv), static_cast<const int*>(a.table),
      static_cast<const int*>(a.tail), static_cast<float*>(a.o),
      static_cast<float*>(a.m), static_cast<float*>(a.l),
      static_cast<float*>(a.ws), static_cast<unsigned*>(a.tickets), a.R,
      a.H, a.K, a.D, a.bs, bs_shift, a.MB, a.nsplit, a.slots_per_split,
      a.rank_stride, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX>
int launch_g(const Args& a, int heads_per_block, cudaStream_t s) {
  if (heads_per_block == 1) return launch<T, 1, DMAX>(a, s);
  if (heads_per_block == 2) return launch<T, 2, DMAX>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_t(const Args& a, int heads_per_block, cudaStream_t s) {
  if (a.D <= 128) return launch_g<T, 128>(a, heads_per_block, s);
  return launch_g<T, 256>(a, heads_per_block, s);
}

// The rank kernel's launch plan (kernels/micro_attn_decode.py::
// rank_decode_plan).
struct RankPlan {
  int stacked, unit_tokens, blocks, heads_per_block, smem_bytes, n_tickets;
};

// Returns cudaErrorInvalidValue unless the plan is one this instantiation
// launches: U a positive multiple of its tile, the caller's shared memory
// its own, a ticket counter per merge group.
template <typename T, int GT, int DMAX>
int launch_ranks(const Args& a, const RankPlan& p, cudaStream_t stream) {
  const int G = a.H / a.K;
  const int npair = a.NR * a.R;
  const int P = p.stacked ? npair : a.R;
  const long groups = static_cast<long>(P) * a.K * ((G + GT - 1) / GT);
  const size_t smem = rank_smem_bytes<T, DMAX>(a.D, GT, a.R, npair, P);
  constexpr int TT = tile_tokens<T, DMAX>();
  if (p.unit_tokens < TT || p.unit_tokens % TT || p.blocks < 1 ||
      static_cast<size_t>(p.smem_bytes) != smem || groups > p.n_tickets)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = paged_decode_ranks_kernel<T, GT, DMAX>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  kern<<<p.blocks, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.pk),
      static_cast<const T*>(a.pv), static_cast<const int*>(a.table),
      static_cast<const int*>(a.tail), static_cast<float*>(a.o),
      static_cast<float*>(a.m), static_cast<float*>(a.l),
      static_cast<float*>(a.ws), static_cast<unsigned*>(a.tickets), a.NR,
      a.R, a.H, a.K, a.D, a.bs, a.MB, p.unit_tokens, p.stacked,
      a.rank_stride, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX>
int launch_ranks_g(const Args& a, const RankPlan& p, cudaStream_t s) {
  if (p.heads_per_block == 1) return launch_ranks<T, 1, DMAX>(a, p, s);
  if (p.heads_per_block == 2) return launch_ranks<T, 2, DMAX>(a, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_ranks_t(const Args& a, const RankPlan& p, cudaStream_t s) {
  if (a.D <= 128) return launch_ranks_g<T, 128>(a, p, s);
  return launch_ranks_g<T, 256>(a, p, s);
}

}  // namespace

// C entry: returns cudaGetLastError() after the launch (0 = success).
// dtype: 0 = float32, 1 = bfloat16 (q and both pools share it). NR rank
// pools (NR = 1: one pool) start rank_stride elements apart; tables are
// [NR, R, MB], tails [NR, R], outputs [NR, R, H, ...]. The caller plans
// the launch (kernels/micro_attn_decode.py::decode_plan): heads_per_block
// (GT, 1 or 2) picks the instantiation; any other value, or NR < 1,
// returns cudaErrorInvalidValue. With nsplit > 1, ws is a float32
// scratch [nsplit, NR, R, H, D + 2] and tickets n_tickets zeroed uint32
// counters, at least one per (rank, request, query-head group, kv head),
// that the kernel leaves at zero; both may be null when nsplit == 1.
extern "C" int paged_decode_launch(const void* q, const void* pool_k,
                                   const void* pool_v, const void* table,
                                   const void* tail, void* o, void* m,
                                   void* l, void* ws, void* tickets, int NR,
                                   int R, int H, int K, int D, int bs,
                                   int MB, long long rank_stride, int nsplit,
                                   int slots_per_split, int heads_per_block,
                                   int n_tickets, float scale, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (NR < 1 || nsplit < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,  pool_k, pool_v, table, tail, o,      m,
               l,  ws,     tickets, NR,  R,    H,      K,
               D,  bs,     MB,     rank_stride, nsplit, slots_per_split,
               n_tickets, scale};
  if (dtype == 1) return launch_t<__nv_bfloat16>(a, heads_per_block, s);
  return launch_t<float>(a, heads_per_block, s);
}

// C entry of the rank kernel: returns cudaGetLastError() after the launch
// (0 = success). NR rank pools start rank_stride elements apart; tables
// [NR, R, MB], tails [NR, R]; q [R, H, D] (dtype as paged_decode_launch).
// stacked = 0: one partial a request over every rank, outputs [R, H, ...];
// stacked = 1: one a (rank, request), outputs [NR, R, H, ...]. The caller
// plans the launch (kernels/micro_attn_decode.py::rank_decode_plan):
// unit_tokens U, blocks, heads_per_block (1 or 2) and the shared memory
// that instantiation lays out; ws is a float32 scratch of blocks + groups
// slots of heads_per_block * (D + 4) floats and tickets n_tickets zeroed
// uint32 counters, at least one per merge group (R or NR * R, times K
// times the query-head groups), which the kernel leaves at zero. Any other
// plan, or NR < 1, returns cudaErrorInvalidValue.
extern "C" int paged_decode_ranks_launch(
    const void* q, const void* pool_k, const void* pool_v, const void* table,
    const void* tail, void* o, void* m, void* l, void* ws, void* tickets,
    int NR, int R, int H, int K, int D, int bs, int MB,
    long long rank_stride, int stacked, int unit_tokens, int blocks,
    int heads_per_block, int smem_bytes, int n_tickets, float scale,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (NR < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,  pool_k, pool_v, table, tail, o,  m,           l,
               ws, tickets, NR,    R,     H,    K,  D,           bs,
               MB, rank_stride, 1,  1,     n_tickets, scale};
  const RankPlan p{stacked != 0, unit_tokens,    blocks,
                   heads_per_block, smem_bytes, n_tickets};
  if (dtype == 1) return launch_ranks_t<__nv_bfloat16>(a, p, s);
  return launch_ranks_t<float>(a, p, s);
}
