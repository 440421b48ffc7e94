// Paged DistAttention MicroAttention partial, prefill chunk (paper Eq. 2).
//
// Replaces the Pallas TPU kernel repro/kernels/micro_attn_prefill.py::
// paged_prefill_micro_attention_kernel (body _kernel), and its vmap over
// the rank axis (repro/kernels/ops.py::paged_prefill_attention_ranks). A
// chunk of C query rows [C, H, D] attends over NR rank pools [NB, bs, K,
// D] (slabs rank_stride elements apart: a per-layer view of the global
// pool, read in place; NR = 1 for the single-rank form), each through its
// own -1-padded prefix table [MB] shared by every query of the chunk. There
// is no causal mask: every addressed token precedes every chunk query.
// Only a table's last valid slot is partial (its tail tokens). Output:
// unnormalized o and m, l, float32, one partial a rank [NR, C, H, ...]
// (stacked) or one over every rank [C, H, ...] (merged, what the global
// pool's steps take); a row with no valid token gives (0, -inf, 0).
//
// Bound on the H100: the larger of the FLOPs, 4 * C * S * H * D against
// 989 TFLOP/s (bf16 tensor cores) or 165 TFLOP/s (float32 as 3xTF32 on
// the tf32 tensor cores; 67 on the CUDA cores), and the
// bytes, S * K * D * 2 * itemsize against 3.35 TB/s (S: the valid tokens
// of every rank). At the qwen3 path's
// main shape (C=512, H=16, K=8, D=128, S~3,000, bf16) that is 12.6 GFLOP
// against 12 MB of K/V: 0.0127 ms, bound by operations. Only the tensor
// cores approach it, and only through wgmma at their full rate. The
// precision contract below runs P V twice (hi and lo), so the products
// executed are 1.5 times the bound's (0.019 ms there).
//
// One kernel a dtype serves both forms: the single-rank one is the rank
// form at NR = 1, rank stride 0, merged.
//
// bf16 pools: paged_prefill_wgmma_kernel, built for Hopper.
// - Rows: GQA packing as the Pallas kernel, the C*G rows (query, head of
//   the kv head's group) kv-head-major, so a tile of 128 rows shares one
//   kv head and each K/V tile is staged once for all G heads.
// - Work: persistent blocks, at most one an SM, take equal shares of
//   units (one row tile of one kv head crossed with one tile of one
//   rank's valid prefix: 128 tokens, 64 at D 256), planned on the card
//   from the tables (paged_attn.cuh's plan_units, no host read). A merge
//   group is a row tile of a kv head (of one rank, when stacked); its
//   units are its ranks' tiles, rank by rank. The producer warp walks them
//   (paged_attn::UnitWalk) and writes each ring stage's valid tokens to
//   shared memory before the stage's loads, so the consumers (and the
//   float32 splitters) keep no walk and no more registers than a
//   single-rank kernel would. A block stores one partial a
//   run of one group's units, and the last partial of a group to arrive
//   LSE-merges them (merge_parts, a ticket counter a group): the rank
//   merge happens there too. One launch a call; no split planned from
//   shapes. The wrapper launches a multiple or a divisor of the groups in
//   blocks (128 at the main shape: two a row tile), so that a block's
//   share starts and ends on a group's boundary where groups hold equal
//   work.
// - Warp specialisation: warpgroup 0 is the producer (setmaxnreg down to
//   40 registers; its first warp issues the loads), warpgroups 1 and 2
//   the consumers (232 registers), 64 rows each.
// - Loads: TMA over 5-D tensor maps of the rank pools [NR][NB][bs][K][D]
//   (hopper.cuh, any rank stride, encoded once a view: cached_rows_map),
//   one box a table block's share of a tile: 64 columns of one kv head by
//   gcd(bs, tile) tokens (16 at bs 16; a 128-token block is one box; 8
//   at bs 24) of one rank, 128-byte swizzle, lane b of the producer warp
//   resolving box b's (block, offset) from its rank's table row and
//   issuing it. Only the valid tokens' boxes load. The ring holds 4 (D <=
//   64) or 3 (D <= 128) tiles of 128 tokens, or 2 of 64 (D <= 256), of K
//   and V, with mbarrier full (TMA bytes) and empty (256 consumers)
//   stages. TMA's zero fill past D replaces padding code.
// - A consumer's q rows are (query, head) pairs, not a box of q: it
//   stages them once a run of units by 16-byte loads into the swizzled
//   layout (zero past the chunk and past D).
// - Tile step (flash_prefill.cu's, on hopper.cuh's pieces): S = Q K^T by
//   wgmma from shared memory (q and K K-major); the online softmax in
//   float32 on the accumulator (paged_attn::softmax_scores); p split into
//   bf16 hi + lo straight into the register-A fragments of O += P_hi V +
//   P_lo V (V read transposed, MN-major). Software-pipelined: tile t's S
//   is issued before tile t - 1's P V.
// - Masking: in a tile that ends a rank's prefix, tokens past the valid
//   ones score -inf by a select, and their V rows (stale rows of the last
//   block, or never loaded) are zeroed in shared memory (generic stores,
//   then fence.proxy.async) before the P V that reads them: 0 * NaN is
//   NaN inside wgmma.
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
// rank's tail score -inf by a select, and the V^T columns of keys past
// the tile's valid ones are written as zeros, both halves (0 x NaN is NaN in
// wgmma). Merge groups: 128 rows up to D 128, 64 above (one consumer).
#include "hopper.cuh"
#include "paged_attn.cuh"

namespace {

using paged_attn::smem_addr;

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
// the barriers; each stage's valid tokens (NV_BYTES); the plan (S[NR],
// cum[P + 1]: plan_bytes). 1,024 bytes of slack align the tiles.
__host__ __device__ constexpr int plan_bytes(int NR, int P) {
  return (4 * (NR + P + 1) + 15) & ~15;
}
constexpr int NV_BYTES = 16;  // an int a stage, up to 4 stages

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
  static constexpr int BAR_OFF =
      V_OFF + STAGES_ * TILE_BYTES + (MERGE_IN_Q ? 0 : MERGE_BYTES);
  // K full, V full and K/V empty a stage.
  static constexpr int NV_OFF = BAR_OFF + 8 * 3 * STAGES_;
  static constexpr int PLAN_OFF = NV_OFF + NV_BYTES;
  static constexpr int smem(int NR, int P) {
    return 1024 + PLAN_OFF + plan_bytes(NR, P);
  }
};

// One block an SM (384 threads): warpgroup 0's first warp is the
// producer, whose lane b issues box b of each tile; warpgroups 1 and 2
// are consumers of 64 query rows each (see the header). The 5-D maps read
// the NR rank pools in boxes of 64 columns of one kv head by box_rows
// tokens of one table block of one rank.
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
                               unsigned* __restrict__ tickets, int NR, int C,
                               int H, int K, int D, int bs, int MB,
                               int stacked, int box_rows, float scale) {
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
  // The valid tokens of the tile in each stage, written by the producer
  // before the stage's loads (its arrive releases them to the consumers'
  // wait on the stage): the consumers keep no walk of their own.
  int* nv_s = reinterpret_cast<int*>(gbase + L::NV_OFF);
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
  const paged_attn::UnitPlan pl =
      paged_attn::plan_units(table, tail, NR, 1, MB, bs, TILE, K * nrt,
                             stacked != 0, plan_s, plan_s + NR);
  write_empty_groups(pl, CG, ROW_TILE, G, H, C, D, o, m_out, l_out);
  long long p, p1;
  pl.block_units(blockIdx.x, p, p1);
  p = paged_attn::uniform(p);
  p1 = paged_attn::uniform(p1);
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
        paged_attn::UnitWalk w(pl, sg);
        for (int u = sg.q0; u < sg.q1; ++u, w.next()) {
          // Boxes of the tile's valid tokens in its rank's pool; a -1 slot
          // (past them) has none.
          const int nb = (w.valid() + box_rows - 1) / box_rows;
          int blk = 0, off = 0;
          if (lane < nb) {
            const int t = w.t + lane * box_rows;
            const int slot = t / bs;
            blk = table[static_cast<size_t>(w.k) * MB + slot];
            off = t - slot * bs;
          }
          hopper::mbar_wait(kv_empty + 8 * stage, phase ^ 1);
          const uint32_t kf = k_full + 8 * stage, vf = v_full + 8 * stage;
          if (lane == 0) {
            nv_s[stage] = w.valid();
            hopper::mbar_expect_tx(kf, nb * box_bytes * ncb);
            hopper::mbar_expect_tx(vf, nb * box_bytes * ncb);
          }
          __syncwarp();
          if (lane < nb) {
            const uint32_t at = stage * L::TILE_BYTES + lane * box_bytes;
            for (int c = 0; c < ncb; ++c) {
              hopper::tma_load_5d(k_s + at + c * TILE * 128, &tm_k, kf,
                                  c * 64, kh, off, blk, w.k);
              hopper::tma_load_5d(v_s + at + c * TILE * 128, &tm_v, vf,
                                  c * 64, kh, off, blk, w.k);
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
      const size_t obase = static_cast<size_t>(sg.rho) * C * H;
      const int ntiles = paged_attn::uniform(sg.q1 - sg.q0);
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
        // The valid tokens of the tile in `stage` (every tile that ends a
        // rank's span may be partial), after the wait on its K.
        auto valid_of = [&](int slot) {
          return paged_attn::uniform(nv_s[slot]);
        };
        // S of a tile of nv valid tokens, those past them masked to -inf
        // by a select, turned into float32 probabilities in place; returns
        // whether a row of the warp moved its max.
        auto softmax_step = [&](int nv) {
          hopper::fence_regs(sacc[0]);
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
        // A tile's V rows past its nv valid tokens (stale rows of a
        // rank's last block, or never loaded) are zeroed before P V reads
        // them: their p is 0, but 0 * NaN is NaN inside wgmma.
        auto zero_v_tail = [&](int slot, int nv) {
          if (nv < TILE) {
            unsigned char* vt = gbase + L::V_OFF + slot * L::TILE_BYTES;
            const int n16 = (TILE - nv) * 8;  // 16-byte chunks a box
            for (int idx = tid; idx < n16 * L::BOXES; idx += WG_THREADS) {
              const int b = idx / n16, j = idx - b * n16;
              *reinterpret_cast<uint4*>(vt + b * TILE * 128 + nv * 128 +
                                        j * 16) = make_uint4(0u, 0u, 0u, 0u);
            }
            hopper::fence_proxy_async();
            hopper::named_bar_sync(2 + wg, WG_THREADS);
          }
        };
        hopper::mbar_wait(k_full + 8 * stage, phase);
        int nv = valid_of(stage);
        hopper::wgmma_fence();
        hopper::issue_qk<DMAX, TILE, WG_ROWS>(sacc[0], q_desc,
                                             k_desc + stage * SLOT);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        softmax_step(nv);  // the output is still 0: no rescale
        stage_probs();
        int p_stage = stage;  // slot of the tile whose P V is pending
        uint32_t p_phase = phase;
        int p_nv = nv;
        advance();
        for (int t = 1; t < ntiles; ++t) {
          hopper::mbar_wait(k_full + 8 * stage, phase);
          nv = valid_of(stage);
          hopper::mbar_wait(v_full + 8 * p_stage, p_phase);
          zero_v_tail(p_stage, p_nv);
          hopper::wgmma_fence();
          hopper::issue_qk<DMAX, TILE, WG_ROWS>(sacc[0], q_desc,
                                               k_desc + stage * SLOT);
          hopper::wgmma_commit();
          hopper::issue_pv<DMAX, TILE>(oacc[0], ph, pl_,
                                       v_desc + p_stage * SLOT);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();
          const bool moved = softmax_step(nv);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(oacc[0]);
          hopper::mbar_arrive(kv_empty + 8 * p_stage);
          if (moved) paged_attn::rescale_rows(oacc, alpha);
          stage_probs();
          p_stage = stage;
          p_phase = phase;
          p_nv = nv;
          advance();
        }
        hopper::mbar_wait(v_full + 8 * p_stage, p_phase);
        zero_v_tail(p_stage, p_nv);
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
            [&](int i) {
              return static_cast<int>(obase) + head_row(row0, i, G, H, kh);
            },
            o, m_out, l_out, merge_sm, consumers);
      p = paged_attn::uniform(min(p1, sg.end));
    }
  }
}

// The C entries' arguments: pointers, shapes (NR rank pools of NB blocks
// of bs tokens, rank_stride elements apart), the output form and the
// caller's plan.
struct PrefillArgs {
  const void *q, *pk, *pv, *table, *tail;
  void *o, *m, *l, *ws, *tickets;
  int NR, C, H, K, D, bs, MB, NB;
  long long rank_stride;
  int stacked, blocks, rows, kv_tile, stages, smem_bytes, n_tickets;
  float scale;
  cudaStream_t stream;
  int P() const { return stacked ? NR : 1; }
  // Whether the plan holds for an instantiation of RT-row merge groups,
  // TILE-token units, `stages` stages and `smem` bytes of shared memory:
  // persistent blocks, a ticket counter per group (P x K x row tiles) and
  // blocks of a multiple of 8 tokens (so that every box starts on a
  // 1,024-byte swizzle atom).
  bool plan_is(int RT, int TILE, int STG, int smem) const {
    const long groups = static_cast<long>(P()) * K *
                        ((C * (H / K) + RT - 1) / RT);
    return NR >= 1 && rows == RT && kv_tile == TILE && stages == STG &&
           smem_bytes == smem && blocks >= 1 && groups <= n_tickets &&
           bs % 8 == 0;
  }
  // The K and V maps (5-D over the ranks) in boxes of `box_rows` tokens:
  // gcd(bs, TILE), so a box never crosses a block.
  int maps(CUtensorMap* tk, CUtensorMap* tv, int TILE, int& box_rows,
           uint32_t elem_bytes) const {
    box_rows = TILE;
    while (bs % box_rows) box_rows >>= 1;
    if (int e = hopper::cached_rows_map(tk, pk, D, K, bs, NB, box_rows,
                                        elem_bytes, NR, rank_stride))
      return e;
    return hopper::cached_rows_map(tv, pv, D, K, bs, NB, box_rows,
                                   elem_bytes, NR, rank_stride);
  }
};

// Returns cudaErrorInvalidValue unless the plan is the instantiation's.
template <int DMAX, int TILE, int STAGES_>
int launch_wgmma(const PrefillArgs& a) {
  using L = PfLayout<DMAX, TILE, STAGES_>;
  const int smem = L::smem(a.NR, a.P());
  if (!a.plan_is(ROW_TILE, TILE, STAGES_, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tk, tv;
  int box_rows = 0;
  if (int e = a.maps(&tk, &tv, TILE, box_rows, 2)) return e;
  auto kern = paged_prefill_wgmma_kernel<DMAX, TILE, STAGES_>;
  static int allowed[hopper::MAX_DEVICES] = {};
  if (int e = hopper::allow_smem(kern, smem, allowed)) return e;
  kern<<<a.blocks, WS_THREADS, smem, a.stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const int*>(a.table), static_cast<const int*>(a.tail),
      static_cast<float*>(a.o), static_cast<float*>(a.m),
      static_cast<float*>(a.l), static_cast<float*>(a.ws),
      static_cast<unsigned*>(a.tickets), a.NR, a.C, a.H, a.K, a.D, a.bs,
      a.MB, a.stacked, box_rows, a.scale);
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
// split_v_tile writes them); the barriers; each stage's valid tokens
// (NV_BYTES); the plan (plan_bytes). Tiles start on 1,024 bytes.
template <int DMAX, int TILE, int NC, int SS, int RV>
struct PfF32Layout {
  static constexpr bool QREG = DMAX <= 128;
  static constexpr int BOXES = DMAX / 32;
  static constexpr int Q_HALF = WG_ROWS * DMAX * 4;
  static constexpr int Q_WG = (QREG ? 1 : 2) * Q_HALF;
  static constexpr int TILE_BYTES = TILE * DMAX * 4;  // a K or V tile
  static constexpr int RAW_V = NC * Q_WG;
  static constexpr int STAGE = RAW_V + RV * TILE_BYTES;  // + stage * 4 tiles
  static constexpr int BAR_OFF = STAGE + SS * 4 * TILE_BYTES;
  static_assert(RAW_V >= NC * WG_ROWS * (paged_attn::MERGE_CHUNK + 1) * 4,
                "the merge's row weights fit in the q rows");
  // raw V full / empty a slot, then K raw (TMA), K full (K_lo), K empty,
  // V full, V empty a stage.
  static constexpr int NV_OFF = BAR_OFF + 8 * (2 * RV + 5 * SS);
  static constexpr int PLAN_OFF = NV_OFF + NV_BYTES;
  static constexpr int smem(int NR, int P) {
    return 1024 + PLAN_OFF + plan_bytes(NR, P);
  }
};

// One block an SM ((1 + NC) x 128 threads): warpgroup 0's first warp is
// the producer, whose lane b issues box b of each raw tile; its warps 1-3
// split each raw tile into the tf32 halves of a split stage (K as laid
// out, V transposed, the rows past the tile's valid tokens zeroed),
// freeing each raw slot as soon as it is split; warpgroups 1..NC are
// consumers of 64 (query, head) rows each (see the header). A merge
// group is a tile of NC x 64 rows of one kv head (of one rank when
// stacked); the 5-D maps read the NR rank pools.
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
                              unsigned* __restrict__ tickets, int NR, int C,
                              int H, int K, int D, int bs, int MB,
                              int stacked, int box_rows, float scale) {
  using L = PfF32Layout<DMAX, TILE, NC, SS, RV>;
  constexpr int RT = NC * WG_ROWS;  // rows a merge group
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw_addr);
  float* merge_sm = reinterpret_cast<float*>(gbase);
  int* plan_s = reinterpret_cast<int*>(gbase + L::PLAN_OFF);
  // Each stage's valid tokens, as in the bf16 kernel: written by the
  // producer before the stage's K load, read by the splitters after it
  // lands and by the consumers after K's halves are ready.
  int* nv_s = reinterpret_cast<int*>(gbase + L::NV_OFF);
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
  const paged_attn::UnitPlan pl =
      paged_attn::plan_units(table, tail, NR, 1, MB, bs, TILE, K * nrt,
                             stacked != 0, plan_s, plan_s + NR);
  write_empty_groups(pl, CG, RT, G, H, C, D, o, m_out, l_out);
  long long p, p1;
  pl.block_units(blockIdx.x, p, p1);
  p = paged_attn::uniform(p);
  p1 = paged_attn::uniform(p1);
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
        paged_attn::UnitWalk w(pl, sg);
        for (int u = sg.q0; u < sg.q1; ++u, w.next()) {
          const int nb = (w.valid() + box_rows - 1) / box_rows;
          int blk = 0, off = 0;
          if (lane < nb) {
            const int t = w.t + lane * box_rows;
            const int slot = t / bs;
            blk = table[static_cast<size_t>(w.k) * MB + slot];
            off = t - slot * bs;
          }
          const uint32_t at = lane * box_bytes;
          const uint32_t kr = k_raw + 40 * sp.slot;
          hopper::mbar_wait(k_empty + 40 * sp.slot, sp.phase ^ 1);
          if (lane == 0) {
            nv_s[sp.slot] = w.valid();
            hopper::mbar_expect_tx(kr, nb * box_bytes * ncb);
          }
          __syncwarp();
          if (lane < nb)
            for (int c = 0; c < ncb; ++c)
              hopper::tma_load_5d(base + L::STAGE +
                                      sp.slot * 4 * L::TILE_BYTES + at +
                                      c * TILE * 128,
                                  &tm_k, kr, c * 32, kh, off, blk, w.k);
          sp.next();
          const uint32_t vf = rv_full + 16 * rv.slot;
          hopper::mbar_wait(rv_empty + 16 * rv.slot, rv.phase ^ 1);
          if (lane == 0) hopper::mbar_expect_tx(vf, nb * box_bytes * ncb);
          __syncwarp();
          if (lane < nb)
            for (int c = 0; c < ncb; ++c)
              hopper::tma_load_5d(base + L::RAW_V +
                                      rv.slot * L::TILE_BYTES + at +
                                      c * TILE * 128,
                                  &tm_v, vf, c * 32, kh, off, blk, w.k);
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
        for (int u = sg.q0; u < sg.q1; ++u) {
          unsigned char* dst =
              gbase + L::STAGE + sp.slot * 4 * L::TILE_BYTES;
          hopper::mbar_wait(k_raw + 40 * sp.slot, sp.phase);
          const int nv = nv_s[sp.slot];
          hopper::split_k_tile(dst, dst + L::TILE_BYTES, L::TILE_BYTES, st,
                               SPLITTERS);
          hopper::fence_proxy_async();
          hopper::mbar_arrive(k_full + 40 * sp.slot);
          hopper::mbar_wait(rv_full + 16 * rv.slot, rv.phase);
          hopper::mbar_wait(v_empty + 40 * sp.slot, sp.phase ^ 1);
          hopper::split_v_tile<DMAX, TILE>(
              gbase + L::RAW_V + rv.slot * L::TILE_BYTES,
              dst + 2 * L::TILE_BYTES, dst + 3 * L::TILE_BYTES,
              nv, st, SPLITTERS);
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
      const size_t obase = static_cast<size_t>(sg.rho) * C * H;
      const int ntiles = paged_attn::uniform(sg.q1 - sg.q0);
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
        // S of a tile of nv valid tokens (every tile that ends a rank's
        // span may be partial), those past them masked to -inf by a
        // select, turned into float32 probabilities in place.
        auto softmax_step = [&](int nv) {
          hopper::fence_regs(sacc[0]);
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
        int nv = paged_attn::uniform(nv_s[sp.slot]);
        hopper::wgmma_fence();
        issue_s();
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sacc[0]);
        hopper::mbar_arrive(k_empty + 40 * sp.slot);
        softmax_step(nv);  // the output is still 0: no rescale
        stage_probs();
        hopper::Ring<SS> pv = sp;  // stage of the tile whose P V is pending
        sp.next();
        for (int t = 1; t < ntiles; ++t) {
          hopper::mbar_wait(k_full + 40 * sp.slot, sp.phase);
          nv = paged_attn::uniform(nv_s[sp.slot]);
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
          const bool moved = softmax_step(nv);
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
            [&](int i) {
              return static_cast<int>(obase) + head_row(row0, i, G, H, kh);
            },
            o, m_out, l_out, merge_sm, consumers);
      p = paged_attn::uniform(min(p1, sg.end));
    }
  }
}

template <int DMAX, int TILE, int NC, int SS, int RV>
int launch_tf32(const PrefillArgs& a) {
  using L = PfF32Layout<DMAX, TILE, NC, SS, RV>;
  const int smem = L::smem(a.NR, a.P());
  if (!a.plan_is(NC * WG_ROWS, TILE, SS, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tk, tv;
  int box_rows = 0;
  if (int e = a.maps(&tk, &tv, TILE, box_rows, 4)) return e;
  auto kern = paged_prefill_tf32_kernel<DMAX, TILE, NC, SS, RV>;
  static int allowed[hopper::MAX_DEVICES] = {};
  if (int e = hopper::allow_smem(kern, smem, allowed)) return e;
  kern<<<a.blocks, (1 + NC) * WG_THREADS, smem, a.stream>>>(
      tk, tv, static_cast<const float*>(a.q),
      static_cast<const int*>(a.table), static_cast<const int*>(a.tail),
      static_cast<float*>(a.o), static_cast<float*>(a.m),
      static_cast<float*>(a.l), static_cast<float*>(a.ws),
      static_cast<unsigned*>(a.tickets), a.NR, a.C, a.H, a.K, a.D, a.bs,
      a.MB, a.stacked, box_rows, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for (D, dtype): bf16 wgmma or float32 3xTF32 wgmma,
// by D rounded up to 64, 128 or 256.
int launch(const PrefillArgs& a, int dtype) {
  if (dtype == 1) {
    if (a.D <= 64) return launch_wgmma<64, 128, 4>(a);
    if (a.D <= 128) return launch_wgmma<128, 128, 3>(a);
    return launch_wgmma<256, 64, 2>(a);
  }
  if (a.D <= 64) return launch_tf32<64, 64, 2, 2, 2>(a);
  if (a.D <= 128) return launch_tf32<128, 32, 2, 2, 2>(a);
  return launch_tf32<256, 16, 1, 1, 2>(a);
}

}  // namespace

// C entry of the single-rank form: returns cudaGetLastError() after the
// launch (0 = success). q [C, H, D], pools [NB, bs, K, D], table [MB],
// tail [1], outputs [C, H, ...]; dtype: 0 = float32 (3xTF32 wgmma), 1 =
// bfloat16 (wgmma). The caller plans the launch
// (kernels/micro_attn_prefill.py::prefill_unit_plan): persistent blocks,
// rows_per_block (a merge group's rows: 128; float32 at D > 128: 64), the
// K/V tile (the unit), the ring's (bf16) or split (float32) stages and
// the shared memory of the instantiation for (D, dtype); ws a float32
// scratch of blocks + groups slots of rows_per_block * (D + 4) floats and
// tickets n_tickets zeroed uint32 counters, at least one per group (K x
// row tiles), which the kernel leaves at zero. Blocks of any size up to
// 128 tokens that is a multiple of 8 are read in place. Any other plan
// returns cudaErrorInvalidValue. The kernels are the rank form's at NR 1.
extern "C" int paged_prefill_launch(const void* q, const void* pool_k,
                                    const void* pool_v, const void* table,
                                    const void* tail, void* o, void* m,
                                    void* l, void* ws, void* tickets, int C,
                                    int H, int K, int D, int bs, int MB,
                                    int NB, int blocks, int rows_per_block,
                                    int kv_tile, int stages, int smem_bytes,
                                    int n_tickets, float scale, int dtype,
                                    void* stream) {
  const PrefillArgs a{q,      pool_k, pool_v, table,   tail,
                      o,      m,      l,      ws,      tickets,
                      1,      C,      H,      K,       D,
                      bs,     MB,     NB,     0,       0,
                      blocks, rows_per_block, kv_tile, stages,
                      smem_bytes, n_tickets, scale,
                      static_cast<cudaStream_t>(stream)};
  return launch(a, dtype);
}

// C entry of the rank forms: returns cudaGetLastError() after the launch
// (0 = success). NR rank pools [NB, bs, K, D] start rank_stride elements
// apart (a multiple of 16 bytes); tables [NR, MB], tails [NR]; q [C, H,
// D] shared by every rank; dtype as paged_prefill_launch, whose kernels
// these are. stacked = 0: one partial over every rank, outputs [C, H,
// ...]; stacked = 1: one a rank, outputs [NR, C, H, ...]. The caller
// plans the launch (kernels/micro_attn_prefill.py::rank_prefill_plan) as
// for paged_prefill_launch, with P = 1 or NR times the merge groups, the
// ticket counters and the scratch slots, and the plan's shared memory
// for NR ranks. Any other plan, or NR < 1, returns cudaErrorInvalidValue.
extern "C" int paged_prefill_ranks_launch(
    const void* q, const void* pool_k, const void* pool_v, const void* table,
    const void* tail, void* o, void* m, void* l, void* ws, void* tickets,
    int NR, int C, int H, int K, int D, int bs, int MB, int NB,
    long long rank_stride, int stacked, int blocks, int rows_per_block,
    int kv_tile, int stages, int smem_bytes, int n_tickets, float scale,
    int dtype, void* stream) {
  const PrefillArgs a{q,      pool_k,          pool_v,  table,  tail,
                      o,      m,               l,       ws,     tickets,
                      NR,     C,               H,       K,      D,
                      bs,     MB,              NB,      rank_stride,
                      stacked != 0,            blocks,  rows_per_block,
                      kv_tile, stages,         smem_bytes, n_tickets,
                      scale,  static_cast<cudaStream_t>(stream)};
  return launch(a, dtype);
}

// Tensor maps this library has encoded (hopper::cached_rows_map): after a
// served step's first, the same step encodes none.
extern "C" unsigned long long paged_prefill_map_encodes() {
  return hopper::map_encodes();
}
