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
// Bound on the H100: the larger of the FLOPs, 4 * C * S * H * D against
// 989 TFLOP/s (bf16 tensor cores) or 165 TFLOP/s (float32 as 3xTF32 on
// the tf32 tensor cores; 67 on the CUDA cores), and the
// bytes, S * K * D * 2 * itemsize against 3.35 TB/s. At the qwen3 path's
// main shape (C=512, H=16, K=8, D=128, S~3,000, bf16) that is 12.6 GFLOP
// against 12 MB of K/V: 0.0127 ms, bound by operations. Only the tensor
// cores approach it, and only through wgmma at their full rate. The
// precision contract below runs P V twice (hi and lo), so the products
// executed are 1.5 times the bound's (0.019 ms there).
//
// bf16 pools: paged_prefill_wgmma_kernel, built for Hopper.
// - Rows: GQA packing as the Pallas kernel, the C*G rows (query, head of
//   the kv head's group) kv-head-major, so a tile of 128 rows shares one
//   kv head and each K/V tile is staged once for all G heads.
// - Work: persistent blocks, at most one an SM, take equal shares of
//   units (one row tile of one kv head crossed with one tile of the valid
//   prefix: 128 tokens, 64 at D 256), planned on the card from the table
//   (paged_attn.cuh's plan_units at NR = 1, no host read); a block
//   stores one partial a run of one row tile's units, and the last
//   partial of a row tile to arrive LSE-merges them (merge_parts, a
//   ticket counter a row tile). One launch a
//   call; no split planned from shapes. The wrapper launches a multiple
//   or a divisor of the row tiles in blocks (128 at the main shape: two
//   a row tile), so that a block's share starts and ends on a row tile's
//   boundary.
// - Warp specialisation: warpgroup 0 is the producer (setmaxnreg down to
//   40 registers; its first warp issues the loads), warpgroups 1 and 2
//   the consumers (232 registers), 64 rows each.
// - Loads: TMA over 4-D tensor maps of the pools [NB][bs][K][D]
//   (hopper.cuh, encoded once a pool: cached_rows_map), one box a table
//   block's share of a tile: 64 columns of one kv head by gcd(bs, tile)
//   tokens (16 at bs 16; a 128-token block is one box; 8 at bs 24),
//   128-byte swizzle, lane b of the producer warp issuing box b. Only the
//   valid tokens' boxes load. The ring holds 4 (D <= 64) or 3 (D <= 128)
//   tiles of 128 tokens, or 2 of 64 (D <= 256), of K and V, with mbarrier
//   full (TMA bytes) and empty (256 consumers) stages. TMA's zero fill
//   past D replaces padding code.
// - A consumer's q rows are (query, head) pairs, not a box of q: it
//   stages them once a run of units by 16-byte loads into the swizzled
//   layout (zero past the chunk and past D).
// - Tile step (flash_prefill.cu's, on hopper.cuh's pieces): S = Q K^T by
//   wgmma from shared memory (q and K K-major); the online softmax in
//   float32 on the accumulator (paged_attn::softmax_scores); p split into
//   bf16 hi + lo straight into the register-A fragments of O += P_hi V +
//   P_lo V (V read transposed, MN-major). Software-pipelined: tile t's S
//   is issued before tile t - 1's P V.
// - Masking: in the last tile of a run, tokens past the valid ones score
//   -inf by a select, and their V rows (stale rows of the last block, or
//   never loaded) are zeroed in shared memory (generic stores, then
//   fence.proxy.async) before the P V that reads them: 0 * NaN is NaN
//   inside wgmma.
// - ptxas serializes wgmmas in a loop it takes for divergent: the loop
//   bounds read from the plan are broadcast from lane 0
//   (paged_attn::uniform), the first tile is peeled off, every k16 step
//   runs.
//
// Precision contract (bf16 pools). The Pallas kernel upcasts to float32
// and accumulates in float32; the kernel is held to 1e-4 against that
// float32 plain twin. (1) Q K^T: bf16 x bf16 products are exact in fp32;
// only the order of the fp32 sums differs. (2) P V: p is float32;
// rounding it to bf16 once (2^-8 relative per term) would exceed 1e-4 at
// the main shape, so p is split into hi = bf16(p) and lo = bf16(p - hi),
// and two products against the same bf16 V tile give at most 2^-16
// relative per term. (3) l is summed in float32 from the float32 p,
// never from hi + lo. (4) m, the rescaling and the merge are float32 on
// the CUDA cores.
//
// float32 pools: paged_prefill_tf32_kernel, the bf16 kernel's design on
// the tf32 tensor cores in 3xTF32 (bound: 4 C S H D at 495 / 3 TFLOP/s,
// 0.0764 ms at the main shape), with the arithmetic, the V^T copy, the
// shared-memory sizing and the pipeline of flash_prefill.cu's float32
// kernel (see there): K_hi is the raw K tile TMA wrote, the producer
// warpgroup's warps 1-3 write K_lo and V^T's two halves, q_hi is register
// fragments up to D 128. Blocks of up to 128 tokens are read in place
// (TMA boxes of one table block's share of a tile, gcd(bs, tile) tokens:
// bs must be a multiple of 8, as for bf16, since a box starts on an
// 8-row swizzle atom of 128-byte rows: 32 float32 columns). Rows past a
// tail score -inf by a select, and the V^T columns of keys past the
// tile's valid ones are written as zeros, both halves (0 x NaN is NaN in
// wgmma). Merge groups: 128 rows up to D 128, 64 above (one consumer).
//
// The rank kernels (paged_prefill_ranks_mma_kernel and, float32,
// paged_prefill_ranks_f32_kernel, below) replace the JAX package's vmap
// of that kernel over the global pool's rank axis: one launch covers NR
// rank pools, [NB, bs, K, D] slabs rank_stride elements apart (a
// per-layer view of the global pool, read in place); q [C, H, D] is
// shared by every rank, tables [NR, MB], tails [NR]. Outputs: stacked,
// one partial a rank [NR, C, ...], or merged over the ranks in the launch
// [C, ...] (what the global pool's steps take). Their design (PR 24's):
// persistent blocks (as many as the card holds at once) take equal shares
// of every group's 64-token tiles of valid prefix, found from the tables
// on the card; a block loads its q tile once a run of one group's tiles
// and walks them across ranks, the pool rows resolved two tiles ahead
// from the tables (128-token blocks read in place); the last partial of a
// group to arrive LSE-merges them. Their tile step: bf16 on mma.sync with
// the hi + lo contract, float32 on the CUDA cores.
#include "hopper.cuh"
#include "paged_attn.cuh"

namespace {

using paged_attn::cp_async16;
using paged_attn::cp_async_commit;
using paged_attn::cp_async_wait;
using paged_attn::row_stride;
using paged_attn::smem_addr;

// ---------------------------------------------------------------------
// The float32 rank kernel's CUDA-core tile (paged_prefill_ranks_f32_kernel).
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

// Output row (query, head) of local row i of kv head kh's rows from row0.
__device__ __forceinline__ int head_row(int row0, int i, int G, int H,
                                        int kh) {
  const int gr = row0 + i;
  return (gr / G) * H + kh * G + gr % G;
}

// ---------------------------------------------------------------------
// Shared by the units kernels (the bf16 single-rank kernel, the rank
// kernels).
// ---------------------------------------------------------------------
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

// ---------------------------------------------------------------------
// bf16 pools: wgmma fed by TMA boxes, warp-specialised, persistent.
// ---------------------------------------------------------------------
constexpr int WG_THREADS = 128;
constexpr int WS_THREADS = 3 * WG_THREADS;  // producer + two consumers
constexpr int WG_ROWS = 64;                 // query rows a consumer
constexpr int ROW_TILE = 2 * WG_ROWS;       // rows a merge group
constexpr int PRODUCER_REGS = 40;           // 128 x 40 + 256 x 232
constexpr int CONSUMER_REGS = 232;          //   <= 65,536
constexpr int MERGE_BAR = 1;                // the consumers' barrier;
                                            // 2 + wg: one consumer's

// Shared memory of the instantiation: each consumer's q rows, then
// STAGES K tiles, then STAGES V tiles of TILE tokens, each as DMAX / 64
// boxes of 64 columns (128-byte swizzle); the merge's row weights (in the
// q rows, which are free while a run's partials merge, where they fit);
// the plan (S[1], cum[2]); the barriers. 1,024 bytes of slack align the
// tiles.
template <int DMAX, int TILE, int STAGES_>
struct PfLayout {
  static constexpr int BOXES = DMAX / 64;
  static constexpr int Q_BYTES = WG_ROWS * DMAX * 2;  // one consumer's q
  static constexpr int TILE_BYTES = TILE * DMAX * 2;  // a K or V tile
  static constexpr int MERGE_BYTES =
      ROW_TILE * (paged_attn::MERGE_CHUNK + 1) * 4;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES_ * TILE_BYTES;
  static constexpr bool MERGE_IN_Q = 2 * Q_BYTES >= MERGE_BYTES;
  static constexpr int MERGE_OFF =
      MERGE_IN_Q ? 0 : V_OFF + STAGES_ * TILE_BYTES;
  static constexpr int PLAN_OFF =
      V_OFF + STAGES_ * TILE_BYTES + (MERGE_IN_Q ? 0 : MERGE_BYTES);
  static constexpr int BAR_OFF = PLAN_OFF + 16;
  // K full, V full and K/V empty a stage.
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * 3 * STAGES_;
};

// One block an SM (384 threads): warpgroup 0's first warp is the
// producer, whose lane b issues box b of each tile; warpgroups 1 and 2
// are consumers of 64 query rows each (see the header). The maps read
// the pools in boxes of 64 columns of one kv head by box_rows tokens of
// one table block.
template <int DMAX, int TILE, int STAGES_>
__global__ void __launch_bounds__(WS_THREADS, 1)
    paged_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __nv_bfloat16* __restrict__ q,
                               const int* __restrict__ table,
                               const int* __restrict__ tail,
                               float* __restrict__ o,
                               float* __restrict__ m_out,
                               float* __restrict__ l_out,
                               float* __restrict__ ws,
                               unsigned* __restrict__ tickets, int C, int H,
                               int K, int D, int bs, int MB, int box_rows,
                               float scale) {
  using L = PfLayout<DMAX, TILE, STAGES_>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t k_s = base + L::K_OFF;
  const uint32_t v_s = base + L::V_OFF;
  float* merge_sm = reinterpret_cast<float*>(gbase + L::MERGE_OFF);
  int* plan_s = reinterpret_cast<int*>(gbase + L::PLAN_OFF);
  const uint32_t k_full = base + L::BAR_OFF;          // + 8 * stage
  const uint32_t v_full = k_full + 8 * STAGES_;       // + 8 * stage
  const uint32_t kv_empty = v_full + 8 * STAGES_;     // + 8 * stage
  constexpr uint32_t CONSUMERS = 2 * WG_THREADS;
  const int ncb = (D + 63) / 64;  // column boxes holding data
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES_; ++s) {
      hopper::mbar_init(k_full + 8 * s, 1);
      hopper::mbar_init(v_full + 8 * s, 1);
      hopper::mbar_init(kv_empty + 8 * s, CONSUMERS);
    }
    hopper::mbar_init_fence();
  }
  // Column boxes past the data (D 136..192 at DMAX 256) are never loaded:
  // zero them once, since every k16 step of S reads them.
  if (ncb < L::BOXES) {
    const int chunks = (L::BOXES - ncb) * TILE * 8;  // 16 bytes each
    for (int idx = threadIdx.x; idx < 2 * STAGES_ * chunks;
         idx += blockDim.x) {
      const int t = idx / chunks, j = idx - t * chunks;
      *reinterpret_cast<uint4*>(gbase + L::K_OFF + t * L::TILE_BYTES +
                                ncb * TILE * 128 + j * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    hopper::fence_proxy_async();
  }
  const int G = H / K;
  const int CG = C * G;
  const int nrt = (CG + ROW_TILE - 1) / ROW_TILE;  // row tiles a kv head
  // plan_units' first __syncthreads also publishes the barriers and the
  // zeroed boxes.
  const paged_attn::UnitPlan pl = paged_attn::plan_units(
      table, tail, 1, 1, MB, bs, TILE, K * nrt, false, plan_s, plan_s + 1);
  write_empty_groups(pl, CG, ROW_TILE, G, H, C, D, o, m_out, l_out);
  long long p, p1;
  pl.block_units(blockIdx.x, p, p1);
  p = paged_attn::uniform(p);
  p1 = paged_attn::uniform(p1);
  const int S = pl.S[0];
  // The warpgroup index, broadcast so that the compiler knows it is
  // uniform: wgmma in a path it takes for divergent is serialized.
  const int wg_idx =
      paged_attn::uniform(static_cast<int>(threadIdx.x) / WG_THREADS);
  if (wg_idx == 0) {
    // Producer: warp 0 issues the loads; the warpgroup's other warps hand
    // their registers to the consumers and finish.
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        hopper::prefetch_tensor_map(&tm_k);
        hopper::prefetch_tensor_map(&tm_v);
      }
      const uint32_t box_bytes = box_rows * 128;
      int stage = 0;
      uint32_t phase = 0;  // parity of the ring's current pass
      while (p < p1) {
        const paged_attn::Segment sg = paged_attn::segment_at(pl, p, p1);
        const int kh = sg.h / nrt;
        const int hi = min(sg.q1 * TILE, S);
        for (int t0 = sg.q0 * TILE; t0 < hi; t0 += TILE) {
          // Boxes of the tile's valid tokens; a -1 slot (past them) has
          // none.
          const int nb = (min(TILE, hi - t0) + box_rows - 1) / box_rows;
          int blk = 0, off = 0;
          if (lane < nb) {
            const int t = t0 + lane * box_rows;
            const int slot = t / bs;
            blk = table[slot];
            off = t - slot * bs;
          }
          hopper::mbar_wait(kv_empty + 8 * stage, phase ^ 1);
          const uint32_t kf = k_full + 8 * stage, vf = v_full + 8 * stage;
          if (lane == 0) {
            hopper::mbar_expect_tx(kf, nb * box_bytes * ncb);
            hopper::mbar_expect_tx(vf, nb * box_bytes * ncb);
          }
          __syncwarp();
          if (lane < nb) {
            const uint32_t at = stage * L::TILE_BYTES + lane * box_bytes;
            for (int c = 0; c < ncb; ++c) {
              hopper::tma_load_4d(k_s + at + c * TILE * 128, &tm_k, kf,
                                  c * 64, kh, off, blk);
              hopper::tma_load_4d(v_s + at + c * TILE * 128, &tm_v, vf,
                                  c * 64, kh, off, blk);
            }
          }
          if (++stage == STAGES_) {
            stage = 0;
            phase ^= 1;
          }
        }
        p = min(p1, sg.end);
      }
    }
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    constexpr int NJ = TILE / 8;   // n8 chunks of a score tile
    constexpr int NT = DMAX / 8;   // n8 chunks of the output
    constexpr int KV = TILE / 16;  // k16 steps of O += P V
    const int wg = wg_idx - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const float c = scale * paged_attn::LOG2E;  // p = 2^((s - m) * c)
    const paged_attn::WarpThreads consumers{WG_THREADS, 2 * WG_THREADS,
                                            MERGE_BAR};
    const size_t W = paged_attn::part_row(D);
    // Descriptors: q (this warpgroup's 64 rows) and K are K-major, V is
    // MN-major; a ring slot adds its byte offset / 16.
    const uint32_t q_wg = q_s + wg * L::Q_BYTES;
    const uint64_t q_desc = hopper::smem_desc(q_wg, 16, 1024);
    const uint64_t k_desc = hopper::smem_desc(k_s, 16, 1024);
    const uint64_t v_desc = hopper::smem_desc(v_s, TILE * 128, 1024);
    constexpr uint32_t SLOT = L::TILE_BYTES >> 4;
    int stage = 0;       // ring slot of the next tile
    uint32_t phase = 0;  // parity of the ring's current pass
    auto advance = [&] {
      if (++stage == STAGES_) {
        stage = 0;
        phase ^= 1;
      }
    };
    while (p < p1) {
      const paged_attn::Segment sg = paged_attn::segment_at(pl, p, p1);
      const int kh = sg.h / nrt;
      const int row0 = (sg.h - kh * nrt) * ROW_TILE;
      const int nrows = min(ROW_TILE, CG - row0);
      const int lo = paged_attn::uniform(sg.q0 * TILE);
      const int hi = paged_attn::uniform(min(sg.q1 * TILE, S));
      const int ntiles = (hi - lo + TILE - 1) / TILE;
      const int wrow0 = wg * WG_ROWS;  // the warpgroup's first local row
      const int active = paged_attn::uniform(wrow0 < nrows ? 1 : 0);
      float oacc[1][NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        oacc[0][j][0] = oacc[0][j][1] = oacc[0][j][2] = oacc[0][j][3] = 0.f;
      float m_r[1][2] = {{-CUDART_INF_F, -CUDART_INF_F}};
      float l_r[1][2] = {{0.f, 0.f}};
      if (!active) {
        // No row of this warpgroup in the tile: wait on each tile (its
        // TMA writes done) and release it without math.
        for (int t = 0; t < ntiles; ++t) {
          hopper::mbar_wait(k_full + 8 * stage, phase);
          hopper::mbar_wait(v_full + 8 * stage, phase);
          hopper::mbar_arrive(kv_empty + 8 * stage);
          advance();
        }
      } else {
        // The warpgroup's q rows, by vector loads into the swizzled
        // layout (the rows are (query, head) pairs, not a box of q);
        // zero past the chunk's rows and past D.
        unsigned char* qg = gbase + wg * L::Q_BYTES;
        for (int idx = tid; idx < WG_ROWS * (DMAX / 8); idx += WG_THREADS) {
          const int r = idx / (DMAX / 8);
          const int col = (idx - r * (DMAX / 8)) * 8;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (wrow0 + r < nrows && col < D)
            v = *reinterpret_cast<const uint4*>(
                q + static_cast<size_t>(head_row(row0, wrow0 + r, G, H, kh)) *
                        D + col);
          *reinterpret_cast<uint4*>(
              qg + (col >> 6) * WG_ROWS * 128 + r * 128 +
              ((((col >> 3) & 7) ^ (r & 7)) << 4)) = v;
        }
        hopper::fence_proxy_async();
        hopper::named_bar_sync(2 + wg, WG_THREADS);
        // Software pipeline over the tiles (flash_prefill.cu's): tile t's
        // S = Q K^T is issued before tile t - 1's P V, and its softmax
        // runs while that P V is on the tensor cores; the output is
        // rescaled once the P V is done. The first tile is peeled off, so
        // that every wait on the tensor cores is unconditional.
        float sacc[1][NJ][4];  // written by each tile's first k16 step
        uint32_t ph[KV][4], pl_[KV][4];
        float alpha[1][2];
        // S of tile t, its tokens past the valid ones masked to -inf by a
        // select, turned into float32 probabilities in place; returns
        // whether a row of the warp moved its max.
        auto softmax_step = [&](int t) {
          hopper::fence_regs(sacc[0]);
          const int nv = hi - lo - t * TILE;
          if (nv < TILE) {
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (j * 8 + (lane & 3) * 2 + (e & 1) >= nv)
                  sacc[0][j][e] = -CUDART_INF_F;
          }
          const bool moved =
              paged_attn::softmax_scores(sacc, m_r, l_r, alpha, c);
          return __any_sync(0xffffffffu, moved);
        };
        // p as the A fragments of the next P V.
        auto stage_probs = [&] {
          paged_attn::split_probs<KV>(sacc[0], ph, pl_);
          hopper::fence_regs(ph);
          hopper::fence_regs(pl_);
          hopper::fence_regs(oacc[0]);
        };
        hopper::mbar_wait(k_full + 8 * stage, phase);
        hopper::wgmma_fence();
        hopper::issue_qk<DMAX, TILE, WG_ROWS>(sacc[0], q_desc,
                                             k_desc + stage * SLOT);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        softmax_step(0);  // the output is still 0: no rescale
        stage_probs();
        int p_stage = stage;  // slot of the tile whose P V is pending
        uint32_t p_phase = phase;
        advance();
        for (int t = 1; t < ntiles; ++t) {
          hopper::mbar_wait(k_full + 8 * stage, phase);
          hopper::mbar_wait(v_full + 8 * p_stage, p_phase);
          hopper::wgmma_fence();
          hopper::issue_qk<DMAX, TILE, WG_ROWS>(sacc[0], q_desc,
                                               k_desc + stage * SLOT);
          hopper::wgmma_commit();
          hopper::issue_pv<DMAX, TILE>(oacc[0], ph, pl_,
                                       v_desc + p_stage * SLOT);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();
          const bool moved = softmax_step(t);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(oacc[0]);
          hopper::mbar_arrive(kv_empty + 8 * p_stage);
          if (moved) paged_attn::rescale_rows(oacc, alpha);
          stage_probs();
          p_stage = stage;
          p_phase = phase;
          advance();
        }
        hopper::mbar_wait(v_full + 8 * p_stage, p_phase);
        // The last tile's V rows past the valid tokens (stale rows of the
        // last block, or never loaded) are zeroed before P V reads them:
        // their p is 0, but 0 * NaN is NaN inside wgmma.
        const int nv_last = (hi - lo) - (ntiles - 1) * TILE;
        if (nv_last < TILE) {
          unsigned char* vt = gbase + L::V_OFF + p_stage * L::TILE_BYTES;
          const int n16 = (TILE - nv_last) * 8;  // 16-byte chunks a box
          for (int idx = tid; idx < n16 * L::BOXES; idx += WG_THREADS) {
            const int b = idx / n16, j = idx - b * n16;
            *reinterpret_cast<uint4*>(vt + b * TILE * 128 + nv_last * 128 +
                                      j * 16) = make_uint4(0u, 0u, 0u, 0u);
          }
          hopper::fence_proxy_async();
          hopper::named_bar_sync(2 + wg, WG_THREADS);
        }
        hopper::wgmma_fence();
        hopper::issue_pv<DMAX, TILE>(oacc[0], ph, pl_,
                                     v_desc + p_stage * SLOT);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(oacc[0]);
        hopper::mbar_arrive(kv_empty + 8 * p_stage);
      }

      // The segment's partial: to the outputs (the group's only partial)
      // or to the block's scratch slot b + g ([slot][ROW_TILE]
      // [part_row(D)], by local row).
      const int pfirst = pl.block_of(sg.first);
      const int parts = pl.block_of(sg.end - 1) - pfirst + 1;
      float* slot = ws + (static_cast<size_t>(blockIdx.x) + sg.g) *
                             ROW_TILE * W;
      if (active) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // The quad's four threads share a row: sum their shares of l.
          float lr = l_r[0][h];
          lr += __shfl_xor_sync(0xffffffffu, lr, 1);
          lr += __shfl_xor_sync(0xffffffffu, lr, 2);
          const int r = wrow0 + warp * 16 + (lane >> 2) + h * 8;
          if (r >= nrows) continue;
          float *po, *pm, *pls;
          if (parts > 1) {
            po = slot + r * W;
            pm = po + D;
            pls = po + D + 1;
          } else {
            const size_t row = head_row(row0, r, G, H, kh);
            po = o + row * D;
            pm = m_out + row;
            pls = l_out + row;
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int col = j * 8 + (lane & 3) * 2;
            if (col < D)
              *reinterpret_cast<float2*>(po + col) =
                  make_float2(oacc[0][j][2 * h], oacc[0][j][2 * h + 1]);
          }
          if ((lane & 3) == 0) {
            *pm = m_r[0][h] * scale;  // m of the scaled scores
            *pls = lr;
          }
        }
      }
      if (parts > 1 &&
          paged_attn::last_split_arrives(tickets + sg.g, parts, consumers))
        paged_attn::merge_parts(
            ws, ROW_TILE * W, pfirst + sg.g, parts, nrows, D,
            [&](int i) { return head_row(row0, i, G, H, kh); }, o, m_out,
            l_out, merge_sm, consumers);
      p = paged_attn::uniform(min(p1, sg.end));
    }
  }
}

// ---------------------------------------------------------------------
// Rank forms: persistent blocks over units of valid tokens.
// ---------------------------------------------------------------------
// The merge groups of a rank prefill are (kv head, tile of query rows);
// their units are 64-token tiles of each rank's prefix (paged_attn.cuh).
// A block walks its segments: q tile once a segment, K/V tiles of any
// rank of the group, the pool rows resolved from the tables two tiles
// ahead (no table copy, so blocks of any size are read in place), one
// partial a segment. The bf16
// tile step is mma.sync (paged_attn.cuh), float32 a CUDA-core tile step
// (the helpers above).
constexpr int MW = 4;            // warps a block
constexpr int BN = paged_attn::MMA_TOKENS;  // KV tokens a tile
constexpr int STAGES = 2;        // cp.async ring depth of K/V tiles
constexpr int ROW_RING = 3;      // tiles whose pool rows are resolved

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

// float32 pools: a CUDA-core tile step (64 rows x 64 tokens, 4 x 4
// register tiles a thread) over the segments of its block (tiles of TK
// tokens, loaded synchronously).
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

// Returns cudaErrorInvalidValue unless the plan is the instantiation's:
// its ring depth and shared memory, persistent blocks, a ticket counter
// per group (K x row tiles) and blocks of a multiple of 8 tokens (so
// that every box starts on a 1,024-byte swizzle atom).
template <int DMAX, int TILE, int STAGES_>
int launch_wgmma(const void* q, const void* pk, const void* pv,
                 const void* table, const void* tail, void* o, void* m,
                 void* l, void* ws, void* tickets, int C, int H, int K, int D,
                 int bs, int MB, int NB, int blocks, int kv_tile,
                 int stages, int smem_bytes, int n_tickets, float scale,
                 cudaStream_t stream) {
  using L = PfLayout<DMAX, TILE, STAGES_>;
  const long groups = static_cast<long>(K) *
                      ((C * (H / K) + ROW_TILE - 1) / ROW_TILE);
  if (kv_tile != TILE || stages != STAGES_ || smem_bytes != L::SMEM ||
      blocks < 1 ||
      groups > n_tickets || bs % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  int box_rows = TILE;  // gcd(bs, TILE): a box never crosses a block
  while (bs % box_rows) box_rows >>= 1;
  CUtensorMap tk, tv;
  if (int e = hopper::cached_rows_map(&tk, pk, D, K, bs, NB, box_rows))
    return e;
  if (int e = hopper::cached_rows_map(&tv, pv, D, K, bs, NB, box_rows))
    return e;
  auto kern = paged_prefill_wgmma_kernel<DMAX, TILE, STAGES_>;
  static int allowed[hopper::MAX_DEVICES] = {};
  if (int e = hopper::allow_smem(kern, L::SMEM, allowed)) return e;
  kern<<<blocks, WS_THREADS, L::SMEM, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q),
      static_cast<const int*>(table), static_cast<const int*>(tail),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(ws), static_cast<unsigned*>(tickets), C, H, K, D,
      bs, MB, box_rows, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// float32 pools: 3xTF32 wgmma fed by TMA boxes and split stages,
// warp-specialised, persistent.
// ---------------------------------------------------------------------
// 128 x 56 + 256 x 224 = 64,512 registers, the 384 x 168 the launch
// holds: setmaxnreg.inc waits for registers that setmaxnreg.dec freed,
// and a split needing the whole 65,536 (48 / 232) never starts.
constexpr int F32_PRODUCER_REGS = 56;
constexpr int F32_CONSUMER_REGS = 224;
constexpr int SPLITTERS = WG_THREADS - 32;  // the producer's warps 1-3

// Shared memory of a float32 instantiation (NC consumer warpgroups of 64
// rows, tiles of TILE tokens, SS stages, RV raw V slots): each consumer's
// q_lo (64 rows of DMAX, 128-byte-swizzled boxes of 32 columns), and q_hi
// after it unless q_hi lives in registers (QREG: DMAX <= 128); the merge's
// row weights use the q rows while a run's partials merge. The raw V
// slots (the TMA boxes' layout); the stages (K_hi: the raw K tile, which
// TMA writes there; K_lo as laid out; V^T_hi, V^T_lo as hopper.cuh
// split_v_tile writes them); the plan (S[1], cum[2]); the barriers. Tiles
// start on 1,024 bytes.
template <int DMAX, int TILE, int NC, int SS, int RV>
struct PfF32Layout {
  static constexpr bool QREG = DMAX <= 128;
  static constexpr int BOXES = DMAX / 32;
  static constexpr int Q_HALF = WG_ROWS * DMAX * 4;
  static constexpr int Q_WG = (QREG ? 1 : 2) * Q_HALF;
  static constexpr int TILE_BYTES = TILE * DMAX * 4;  // a K or V tile
  static constexpr int RAW_V = NC * Q_WG;
  static constexpr int STAGE = RAW_V + RV * TILE_BYTES;  // + stage * 4 tiles
  static constexpr int PLAN_OFF = STAGE + SS * 4 * TILE_BYTES;
  static constexpr int BAR_OFF = PLAN_OFF + 16;
  static_assert(RAW_V >= NC * WG_ROWS * (paged_attn::MERGE_CHUNK + 1) * 4,
                "the merge's row weights fit in the q rows");
  // raw V full / empty a slot, then K raw (TMA), K full (K_lo), K empty,
  // V full, V empty a stage.
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (2 * RV + 5 * SS);
};

// One block an SM ((1 + NC) x 128 threads): warpgroup 0's first warp is
// the producer, whose lane b issues box b of each raw tile; its warps 1-3
// split each raw tile into the tf32 halves of a split stage (K as laid
// out, V transposed, the rows past the tile's valid tokens zeroed),
// freeing each raw slot as soon as it is split; warpgroups 1..NC are
// consumers of 64 (query, head) rows each (see the header). A merge
// group is a tile of NC x 64 rows of one kv head.
template <int DMAX, int TILE, int NC, int SS, int RV>
__global__ void __launch_bounds__((1 + NC) * WG_THREADS, 1)
    paged_prefill_tf32_kernel(const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const float* __restrict__ q,
                              const int* __restrict__ table,
                              const int* __restrict__ tail,
                              float* __restrict__ o,
                              float* __restrict__ m_out,
                              float* __restrict__ l_out,
                              float* __restrict__ ws,
                              unsigned* __restrict__ tickets, int C, int H,
                              int K, int D, int bs, int MB, int box_rows,
                              float scale) {
  using L = PfF32Layout<DMAX, TILE, NC, SS, RV>;
  constexpr int RT = NC * WG_ROWS;  // rows a merge group
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw_addr);
  float* merge_sm = reinterpret_cast<float*>(gbase);
  int* plan_s = reinterpret_cast<int*>(gbase + L::PLAN_OFF);
  const uint32_t rv_full = base + L::BAR_OFF;      // + 16 * slot
  const uint32_t rv_empty = rv_full + 8;
  const uint32_t k_raw = rv_full + 16 * RV;        // + 40 * stage
  const uint32_t k_full = k_raw + 8;
  const uint32_t k_empty = k_raw + 16;
  const uint32_t v_full = k_raw + 24;
  const uint32_t v_empty = k_raw + 32;
  constexpr uint32_t CONSUMERS = NC * WG_THREADS;
  const int ncb = (D + 31) / 32;  // column boxes holding data
  if (threadIdx.x == 0) {
    for (int r = 0; r < RV; ++r) {
      hopper::mbar_init(rv_full + 16 * r, 1);
      hopper::mbar_init(rv_empty + 16 * r, SPLITTERS);
    }
    for (int s = 0; s < SS; ++s) {
      hopper::mbar_init(k_raw + 40 * s, 1);
      hopper::mbar_init(k_full + 40 * s, SPLITTERS);
      hopper::mbar_init(k_empty + 40 * s, CONSUMERS);
      hopper::mbar_init(v_full + 40 * s, SPLITTERS);
      hopper::mbar_init(v_empty + 40 * s, CONSUMERS);
    }
    hopper::mbar_init_fence();
  }
  // Column boxes of the K and V tiles past the data are never loaded:
  // zero them once (S reads every column of K_hi; the split copies every
  // column).
  if (ncb < L::BOXES) {
    const int chunks = (L::BOXES - ncb) * TILE * 8;  // 16 bytes each
    for (int idx = threadIdx.x; idx < (SS + RV) * chunks;
         idx += blockDim.x) {
      const int t = idx / chunks, j = idx - t * chunks;
      const int tile = t < SS ? L::STAGE + t * 4 * L::TILE_BYTES
                              : L::RAW_V + (t - SS) * L::TILE_BYTES;
      *reinterpret_cast<uint4*>(gbase + tile + ncb * TILE * 128 + j * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    hopper::fence_proxy_async();
  }
  const int G = H / K;
  const int CG = C * G;
  const int nrt = (CG + RT - 1) / RT;  // row tiles a kv head
  // plan_units' first __syncthreads also publishes the barriers and the
  // zeroed boxes.
  const paged_attn::UnitPlan pl = paged_attn::plan_units(
      table, tail, 1, 1, MB, bs, TILE, K * nrt, false, plan_s, plan_s + 1);
  write_empty_groups(pl, CG, RT, G, H, C, D, o, m_out, l_out);
  long long p, p1;
  pl.block_units(blockIdx.x, p, p1);
  p = paged_attn::uniform(p);
  p1 = paged_attn::uniform(p1);
  const int S = pl.S[0];
  const int wg_idx =
      paged_attn::uniform(static_cast<int>(threadIdx.x) / WG_THREADS);
  if (wg_idx == 0) {
    if constexpr (NC > 1) hopper::setmaxnreg_dec<F32_PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      // Loads: lane b issues box b of each raw tile (the valid tokens'
      // boxes only), K and V each into its ring as soon as a slot is
      // split.
      const int lane = threadIdx.x;
      if (lane == 0) {
        hopper::prefetch_tensor_map(&tm_k);
        hopper::prefetch_tensor_map(&tm_v);
      }
      const uint32_t box_bytes = box_rows * 128;
      hopper::Ring<SS> sp;
      hopper::Ring<RV> rv;
      while (p < p1) {
        const paged_attn::Segment sg = paged_attn::segment_at(pl, p, p1);
        const int kh = sg.h / nrt;
        const int hi = min(sg.q1 * TILE, S);
        for (int t0 = sg.q0 * TILE; t0 < hi; t0 += TILE) {
          const int nb = (min(TILE, hi - t0) + box_rows - 1) / box_rows;
          int blk = 0, off = 0;
          if (lane < nb) {
            const int t = t0 + lane * box_rows;
            const int slot = t / bs;
            blk = table[slot];
            off = t - slot * bs;
          }
          const uint32_t at = lane * box_bytes;
          const uint32_t kr = k_raw + 40 * sp.slot;
          hopper::mbar_wait(k_empty + 40 * sp.slot, sp.phase ^ 1);
          if (lane == 0) hopper::mbar_expect_tx(kr, nb * box_bytes * ncb);
          __syncwarp();
          if (lane < nb)
            for (int c = 0; c < ncb; ++c)
              hopper::tma_load_4d(base + L::STAGE +
                                      sp.slot * 4 * L::TILE_BYTES + at +
                                      c * TILE * 128,
                                  &tm_k, kr, c * 32, kh, off, blk);
          sp.next();
          const uint32_t vf = rv_full + 16 * rv.slot;
          hopper::mbar_wait(rv_empty + 16 * rv.slot, rv.phase ^ 1);
          if (lane == 0) hopper::mbar_expect_tx(vf, nb * box_bytes * ncb);
          __syncwarp();
          if (lane < nb)
            for (int c = 0; c < ncb; ++c)
              hopper::tma_load_4d(base + L::RAW_V +
                                      rv.slot * L::TILE_BYTES + at +
                                      c * TILE * 128,
                                  &tm_v, vf, c * 32, kh, off, blk);
          rv.next();
        }
        p = min(p1, sg.end);
      }
    } else {
      // The split, tile by tile: K's lo half once its raw tile has landed
      // (the stage's K was free before the load), then V's halves (rows
      // past the tile's valid tokens zeroed) when the stage's V is free.
      const int st = threadIdx.x - 32;
      hopper::Ring<RV> rv;
      hopper::Ring<SS> sp;
      while (p < p1) {
        const paged_attn::Segment sg = paged_attn::segment_at(pl, p, p1);
        const int hi = min(sg.q1 * TILE, S);
        for (int t0 = sg.q0 * TILE; t0 < hi; t0 += TILE) {
          unsigned char* dst =
              gbase + L::STAGE + sp.slot * 4 * L::TILE_BYTES;
          hopper::mbar_wait(k_raw + 40 * sp.slot, sp.phase);
          hopper::split_k_tile(dst, dst + L::TILE_BYTES, L::TILE_BYTES, st,
                               SPLITTERS);
          hopper::fence_proxy_async();
          hopper::mbar_arrive(k_full + 40 * sp.slot);
          hopper::mbar_wait(rv_full + 16 * rv.slot, rv.phase);
          hopper::mbar_wait(v_empty + 40 * sp.slot, sp.phase ^ 1);
          hopper::split_v_tile<DMAX, TILE>(
              gbase + L::RAW_V + rv.slot * L::TILE_BYTES,
              dst + 2 * L::TILE_BYTES, dst + 3 * L::TILE_BYTES,
              min(TILE, hi - t0), st, SPLITTERS);
          hopper::fence_proxy_async();
          hopper::mbar_arrive(v_full + 40 * sp.slot);
          hopper::mbar_arrive(rv_empty + 16 * rv.slot);
          rv.next();
          sp.next();
        }
        p = min(p1, sg.end);
      }
    }
  } else {
    if constexpr (NC > 1) hopper::setmaxnreg_inc<F32_CONSUMER_REGS>();
    constexpr int NJ = TILE / 8;   // n8 chunks of a score tile
    constexpr int NT = DMAX / 8;   // n8 chunks of the output
    const int wg = wg_idx - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const float c = scale * paged_attn::LOG2E;  // p = 2^((s - m) * c)
    const paged_attn::WarpThreads consumers{WG_THREADS, NC * WG_THREADS,
                                            MERGE_BAR};
    const size_t W = paged_attn::part_row(D);
    unsigned char* qg = gbase + wg * L::Q_WG;   // q_lo, then q_hi
    const uint32_t q_s = base + wg * L::Q_WG;
    const uint64_t ql_desc = hopper::smem_desc(q_s, 16, 1024);
    const uint64_t qh_desc = hopper::smem_desc(q_s + L::Q_HALF, 16, 1024);
    const uint32_t sp0 = base + L::STAGE;
    const uint64_t kh_desc = hopper::smem_desc(sp0, 16, 1024);
    const uint64_t kl_desc =
        hopper::smem_desc(sp0 + L::TILE_BYTES, 16, 1024);
    const uint64_t vh_desc = hopper::smem_desc_plain(
        sp0 + 2 * L::TILE_BYTES, 16 * DMAX, 128);
    const uint64_t vl_desc = hopper::smem_desc_plain(
        sp0 + 3 * L::TILE_BYTES, 16 * DMAX, 128);
    constexpr uint32_t SLOT = (4 * L::TILE_BYTES) >> 4;
    uint32_t qa[L::QREG ? NT : 1][4];  // q_hi fragments (QREG)
    hopper::Ring<SS> sp;  // split stage of the next tile
    while (p < p1) {
      const paged_attn::Segment sg = paged_attn::segment_at(pl, p, p1);
      const int kh = sg.h / nrt;
      const int row0 = (sg.h - kh * nrt) * RT;
      const int nrows = min(RT, CG - row0);
      const int lo = paged_attn::uniform(sg.q0 * TILE);
      const int hi = paged_attn::uniform(min(sg.q1 * TILE, S));
      const int ntiles = (hi - lo + TILE - 1) / TILE;
      const int wrow0 = wg * WG_ROWS;  // the warpgroup's first local row
      const int active = paged_attn::uniform(wrow0 < nrows ? 1 : 0);
      float oacc[1][NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        oacc[0][j][0] = oacc[0][j][1] = oacc[0][j][2] = oacc[0][j][3] = 0.f;
      float m_r[1][2] = {{-CUDART_INF_F, -CUDART_INF_F}};
      float l_r[1][2] = {{0.f, 0.f}};
      if (!active) {
        // No row of this warpgroup in the tile: wait on each tile and
        // release it without math.
        for (int t = 0; t < ntiles; ++t) {
          hopper::mbar_wait(k_full + 40 * sp.slot, sp.phase);
          hopper::mbar_arrive(k_empty + 40 * sp.slot);
          hopper::mbar_wait(v_full + 40 * sp.slot, sp.phase);
          hopper::mbar_arrive(v_empty + 40 * sp.slot);
          sp.next();
        }
      } else {
        // The warpgroup's q rows as tf32 halves, by 16-byte loads into
        // the swizzled layout (the rows are (query, head) pairs); zero
        // past the chunk's rows and past D.
        for (int idx = tid; idx < WG_ROWS * (DMAX / 4); idx += WG_THREADS) {
          const int r = idx / (DMAX / 4);
          const int ch = idx - r * (DMAX / 4);
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (wrow0 + r < nrows && ch * 4 < D)
            x = *reinterpret_cast<const float4*>(
                q + static_cast<size_t>(head_row(row0, wrow0 + r, G, H, kh)) *
                        D + ch * 4);
          const int off = hopper::swz128_f32(WG_ROWS, r, ch * 4);
          *reinterpret_cast<uint4*>(qg + off) = hopper::tf32_lo4(x);
          if constexpr (!L::QREG)
            *reinterpret_cast<float4*>(qg + L::Q_HALF + off) = x;
        }
        if constexpr (L::QREG)
          hopper::load_q_frags<DMAX>(
              qa,
              [&](int i) -> const float* {
                const int r = wrow0 + warp * 16 + i;
                return r < nrows
                           ? q + static_cast<size_t>(
                                     head_row(row0, r, G, H, kh)) * D
                           : nullptr;
              },
              D);
        hopper::fence_proxy_async();
        hopper::named_bar_sync(2 + wg, WG_THREADS);
        float sacc[1][NJ][4];  // written by each tile's first product
        uint32_t ph[NJ][4], pl_[NJ][4];
        float alpha[1][2];
        // S of tile t, its tokens past the valid ones masked to -inf by a
        // select, turned into float32 probabilities in place.
        auto softmax_step = [&](int t) {
          hopper::fence_regs(sacc[0]);
          const int nv = hi - lo - t * TILE;
          if (nv < TILE) {
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (j * 8 + (lane & 3) * 2 + (e & 1) >= nv)
                  sacc[0][j][e] = -CUDART_INF_F;
          }
          const bool moved =
              paged_attn::softmax_scores(sacc, m_r, l_r, alpha, c);
          return __any_sync(0xffffffffu, moved);
        };
        auto stage_probs = [&] {
          hopper::split_probs_tf32<NJ>(sacc[0], ph, pl_);
          hopper::fence_regs(ph);
          hopper::fence_regs(pl_);
          hopper::fence_regs(oacc[0]);
        };
        auto issue_s = [&] {
          if constexpr (L::QREG)
            hopper::issue_qk_tf32_rs<DMAX, TILE, WG_ROWS>(
                sacc[0], qa, ql_desc, kh_desc + sp.slot * SLOT,
                kl_desc + sp.slot * SLOT);
          else
            hopper::issue_qk_tf32<DMAX, TILE, WG_ROWS>(
                sacc[0], qh_desc, ql_desc, kh_desc + sp.slot * SLOT,
                kl_desc + sp.slot * SLOT);
        };
        hopper::mbar_wait(k_full + 40 * sp.slot, sp.phase);
        hopper::wgmma_fence();
        issue_s();
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sacc[0]);
        hopper::mbar_arrive(k_empty + 40 * sp.slot);
        softmax_step(0);  // the output is still 0: no rescale
        stage_probs();
        hopper::Ring<SS> pv = sp;  // stage of the tile whose P V is pending
        sp.next();
        for (int t = 1; t < ntiles; ++t) {
          hopper::mbar_wait(k_full + 40 * sp.slot, sp.phase);
          hopper::mbar_wait(v_full + 40 * pv.slot, pv.phase);
          hopper::wgmma_fence();
          issue_s();
          hopper::wgmma_commit();
          hopper::issue_pv_tf32<DMAX, TILE>(oacc[0], ph, pl_,
                                            vh_desc + pv.slot * SLOT,
                                            vl_desc + pv.slot * SLOT);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();
          hopper::fence_regs(sacc[0]);
          hopper::mbar_arrive(k_empty + 40 * sp.slot);
          const bool moved = softmax_step(t);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(oacc[0]);
          hopper::mbar_arrive(v_empty + 40 * pv.slot);
          if (moved) paged_attn::rescale_rows(oacc, alpha);
          stage_probs();
          pv = sp;
          sp.next();
        }
        hopper::mbar_wait(v_full + 40 * pv.slot, pv.phase);
        hopper::wgmma_fence();
        hopper::issue_pv_tf32<DMAX, TILE>(oacc[0], ph, pl_,
                                          vh_desc + pv.slot * SLOT,
                                          vl_desc + pv.slot * SLOT);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(oacc[0]);
        hopper::mbar_arrive(v_empty + 40 * pv.slot);
      }

      // The segment's partial: to the outputs (the group's only partial)
      // or to the block's scratch slot b + g ([slot][RT][part_row(D)], by
      // local row).
      const int pfirst = pl.block_of(sg.first);
      const int parts = pl.block_of(sg.end - 1) - pfirst + 1;
      float* slot = ws + (static_cast<size_t>(blockIdx.x) + sg.g) * RT * W;
      if (active) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float lr = l_r[0][h];
          lr += __shfl_xor_sync(0xffffffffu, lr, 1);
          lr += __shfl_xor_sync(0xffffffffu, lr, 2);
          const int r = wrow0 + warp * 16 + (lane >> 2) + h * 8;
          if (r >= nrows) continue;
          float *po, *pm, *pls;
          if (parts > 1) {
            po = slot + r * W;
            pm = po + D;
            pls = po + D + 1;
          } else {
            const size_t row = head_row(row0, r, G, H, kh);
            po = o + row * D;
            pm = m_out + row;
            pls = l_out + row;
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int col = j * 8 + (lane & 3) * 2;
            if (col < D)
              *reinterpret_cast<float2*>(po + col) =
                  make_float2(oacc[0][j][2 * h], oacc[0][j][2 * h + 1]);
          }
          if ((lane & 3) == 0) {
            *pm = m_r[0][h] * scale;  // m of the scaled scores
            *pls = lr;
          }
        }
      }
      // The merge's weights overwrite q rows: every consumer's last S has
      // completed before the barrier in last_split_arrives.
      if (parts > 1 &&
          paged_attn::last_split_arrives(tickets + sg.g, parts, consumers))
        paged_attn::merge_parts(
            ws, RT * W, pfirst + sg.g, parts, nrows, D,
            [&](int i) { return head_row(row0, i, G, H, kh); }, o, m_out,
            l_out, merge_sm, consumers);
      p = paged_attn::uniform(min(p1, sg.end));
    }
  }
}

template <int DMAX, int TILE, int NC, int SS, int RV>
int launch_tf32(const void* q, const void* pk, const void* pv,
                const void* table, const void* tail, void* o, void* m,
                void* l, void* ws, void* tickets, int C, int H, int K, int D,
                int bs, int MB, int NB, int blocks, int rows, int kv_tile,
                int stages, int smem_bytes, int n_tickets, float scale,
                cudaStream_t stream) {
  using L = PfF32Layout<DMAX, TILE, NC, SS, RV>;
  const long groups = static_cast<long>(K) *
                      ((C * (H / K) + NC * WG_ROWS - 1) / (NC * WG_ROWS));
  if (rows != NC * WG_ROWS || kv_tile != TILE || stages != SS ||
      smem_bytes != L::SMEM || blocks < 1 || groups > n_tickets || bs % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  int box_rows = TILE;  // gcd(bs, TILE): a box never crosses a block
  while (bs % box_rows) box_rows >>= 1;
  CUtensorMap tk, tv;
  if (int e = hopper::cached_rows_map(&tk, pk, D, K, bs, NB, box_rows, 4))
    return e;
  if (int e = hopper::cached_rows_map(&tv, pv, D, K, bs, NB, box_rows, 4))
    return e;
  auto kern = paged_prefill_tf32_kernel<DMAX, TILE, NC, SS, RV>;
  static int allowed[hopper::MAX_DEVICES] = {};
  if (int e = hopper::allow_smem(kern, L::SMEM, allowed)) return e;
  kern<<<blocks, (1 + NC) * WG_THREADS, L::SMEM, stream>>>(
      tk, tv, static_cast<const float*>(q), static_cast<const int*>(table),
      static_cast<const int*>(tail), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(ws),
      static_cast<unsigned*>(tickets), C, H, K, D, bs, MB, box_rows, scale);
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

// C entry of the single-rank kernels: returns cudaGetLastError() after
// the launch (0 = success). q [C, H, D], pools [NB, bs, K, D], table
// [MB], tail [1], outputs [C, H, ...]; dtype: 0 = float32 (3xTF32
// wgmma), 1 = bfloat16 (wgmma). The caller plans the launch
// (kernels/micro_attn_prefill.py::prefill_unit_plan): persistent blocks,
// rows_per_block (a merge group's rows: 128; float32 at D > 128: 64), the
// K/V tile (the unit), the ring's (bf16) or split (float32) stages and
// the shared memory of the instantiation for (D, dtype); ws a float32
// scratch of blocks + groups slots of rows_per_block * (D + 4) floats and
// tickets n_tickets zeroed uint32 counters, at least one per group (K x
// row tiles), which the kernel leaves at zero. Blocks of any size up to
// 128 tokens that is a multiple of 8 are read in place. Any other plan
// returns cudaErrorInvalidValue.
extern "C" int paged_prefill_launch(const void* q, const void* pool_k,
                                    const void* pool_v, const void* table,
                                    const void* tail, void* o, void* m,
                                    void* l, void* ws, void* tickets, int C,
                                    int H, int K, int D, int bs, int MB,
                                    int NB, int blocks, int rows_per_block,
                                    int kv_tile, int stages, int smem_bytes,
                                    int n_tickets, float scale, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (rows_per_block != ROW_TILE)
      return static_cast<int>(cudaErrorInvalidValue);
    auto run = [&](auto launch) {
      return launch(q, pool_k, pool_v, table, tail, o, m, l, ws, tickets, C,
                    H, K, D, bs, MB, NB, blocks, kv_tile, stages, smem_bytes,
                    n_tickets, scale, s);
    };
    if (D <= 64) return run(launch_wgmma<64, 128, 4>);
    if (D <= 128) return run(launch_wgmma<128, 128, 3>);
    return run(launch_wgmma<256, 64, 2>);
  }
  auto run = [&](auto launch) {
    return launch(q, pool_k, pool_v, table, tail, o, m, l, ws, tickets, C, H,
                  K, D, bs, MB, NB, blocks, rows_per_block, kv_tile, stages,
                  smem_bytes, n_tickets, scale, s);
  };
  if (D <= 64) return run(launch_tf32<64, 64, 2, 2, 2>);
  if (D <= 128) return run(launch_tf32<128, 32, 2, 2, 2>);
  return run(launch_tf32<256, 16, 1, 1, 2>);
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
