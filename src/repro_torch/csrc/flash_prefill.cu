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
// cores) and 0.031 ms at 3.35 TB/s. Only the tensor cores approach it,
// and only through wgmma (hopper.cuh) at their full rate. The precision
// contract below runs P V twice (hi and lo), so the products executed are
// 1.5 times the bound's.
//
// bf16: flash_prefill_wgmma_kernel, built for Hopper.
// - Persistent blocks, one an SM (384 threads, 1 block by registers), walk
//   work items (tile of BM = 128 query positions, head, batch row) in a
//   static longest-first order (the last query tile has the most keys);
//   block j takes item r * G + j in even rounds r and r * G + G - 1 - j in
//   odd ones, so the causal tail fills every SM. kernels/flash_prefill.py
//   ::flash_plan sets the block count (items and SMs) and the ring; the C
//   entry refuses any other plan.
// - Warp specialisation: warpgroup 0 is the producer (setmaxnreg down to
//   40 registers; one thread issues every load), warpgroups 1 and 2 the
//   consumers (232 registers), 64 query rows each. The producer loads an
//   item's q once (TMA, 128 rows) and its live K/V tiles of BN tokens into
//   a ring of STAGES slots, with mbarrier full (TMA bytes) and empty
//   (256 consumer threads) handshakes: D <= 64: BN 128, 4 stages; D <= 128:
//   BN 128, 3 stages (230,488 B); D <= 256: BN 64, 2 stages.
// - TMA reads q, k and v as 4-D [B, S, H|K, D] tensor maps, 64-column
//   boxes with the 128-byte swizzle that wgmma's descriptors name. It
//   fills zeros past S and past D up to the instantiation's width (D 40,
//   112, 120), so the kernel has no padding or zero-fill code; keys past S
//   lie above every real row's diagonal, so the causal mask covers them.
// - A consumer, per tile: S = Q K^T by wgmma with both operands in shared
//   memory; the mask only where the tile crosses its rows' diagonal or
//   window's first key; the online softmax in float32 on the accumulator
//   (paged_attn::softmax_scores: wgmma's m64nN accumulator gives each
//   warp the m16n8 fragment of mma.sync); p split into bf16 hi + lo
//   straight into the register-A fragments of O += P_hi V and O += P_lo V
//   (wgmma, V read transposed from the MN-major tile). Software-pipelined:
//   tile t's S is issued before tile t - 1's P V, and t's softmax runs
//   while that P V is on the tensor cores (the output is rescaled after
//   it). The two consumers interleave on their own (explicit ping-pong
//   turns between them were tried and not kept).
// - Only tiles from the window's first key, rounded down to BN, to the
//   item's diagonal are loaded; a tile with no valid key for a
//   warpgroup's 64 rows is waited on and released without math.
// - ptxas serializes wgmmas (notes C7515, C7520, printed by chip_smoke.py)
//   when a wgmma's issue or completion depends on a branch it takes for
//   divergent or cannot follow: the warpgroup index is broadcast from
//   lane 0, the first live tile is peeled off the pipelined loop, S's
//   first k16 step writes its accumulator afresh, and every k16 step runs
//   (D past the data reads zeros) rather than stopping at a runtime D.
// - After its last S = Q K^T of an item a warpgroup frees q, so the next
//   item's q and first K/V tiles load while it finishes the last tile
//   and its epilogue (normalize, bf16 stores from registers: the shared
//   memory holds the third K/V stage instead of an output tile).
// - GQA/MQA: a work item serves one query head; the heads of a kv group
//   are adjacent in the order, so the blocks running at once read the
//   same K/V tiles, mostly from L2.
//
// Precision contract (bf16). The Pallas kernel and the plain twin upcast
// to float32 and round only the normalized output to bf16; the kernel is
// held to |kernel - plain| <= 1e-4 + 2^-7 |plain| (one bf16 ulp). (1) Q K^T:
// bf16 x bf16 products are exact in fp32; only the order of the sums
// differs. (2) P V: each float32 probability enters as bf16 hi + lo (two
// products, at most 2^-16 relative per term). One rounding of p (2^-8)
// misses that tolerance at both main shapes and at short prompts, as the
// plain-PyTorch emulation in tests/test_torch_kernels.py shows on the CPU.
// (3) l is summed from the float32 p; m, the rescaling and 1 / l are
// float32.
//
// float32: flash_prefill_tf32_kernel, the same design on the tf32 tensor
// cores in 3xTF32 (bound: the FLOPs above at 495 / 3 TFLOP/s, 1.012 ms
// at the hybrid admission; the CUDA cores' 67 TFLOP/s would give 2.49).
// - Precision (held to 1e-4, FLASH_RTOL 0 in float32): each float32
//   operand x as hi = x itself and lo = x - trunc_tf32(x). hi is not
//   rounded by cvt.rna: the tf32 tensor cores ignore the low 13 mantissa
//   bits of a 32-bit operand, so the raw value is the truncated hi, and a
//   raw K tile serves as K_hi where TMA wrote it (tests/test_torch_cuda.py
//   pins the truncation with inputs whose low bits are 0x1FFF, which a
//   rounding unit would move by a tf32 ulp each). Every product of S = Q
//   K^T and O += P V runs as q_hi K_hi + q_hi K_lo + q_lo K_hi (P and V
//   likewise), the dropped lo lo under 2^-20 relative; one tf32 product
//   (up to 2^-9) misses 1e-4 (tests/test_torch_kernels.py emulates
//   both). l is summed from the float32 p; m, the rescaling and 1 / l
//   stay float32.
// - K-major only: tf32 wgmma reads shared-memory operands K-major, with no
//   transpose immediate. q [rows][D] and K [keys][D] are K-major for S; V
//   [keys][D] is not, for P V. The producer warpgroup's warps 1-3 (idle in
//   the bf16 kernel) write V^T [D][keys] hi and lo with generic stores in
//   wgmma's no-swizzle core-matrix layout (4 keys x 16 bytes a row, one
//   core-matrix column a 16 D-byte stride), then fence.proxy.async before
//   the barrier the consumers wait on. They also write K_lo (the raw
//   tile's layout) and zero nothing but never-loaded columns: a K tile
//   needs no transpose, so only its lo half is a copy. Within each 8-key
//   group V^T holds keys in the order k = i / 2 + 4 (i % 2): the S
//   accumulator gives a thread keys 2 (lane % 4) and + 1, the tf32 A
//   fragment wants k = lane % 4 and + 4, so p passes from S to P V in the
//   same registers, with no shuffle.
// - Swizzle: a 128-byte swizzle row is 32 float32 columns; TMA boxes are
//   32 columns wide, and a k8 step advances 32 bytes within them, the
//   bytes of a bf16 k16 step.
// - Shared memory (232,448 B) decides the tiles: each consumer keeps q_lo
//   of its 64 rows (32 KB at D 128) and its q_hi as register-A fragments
//   (64 registers at D 128), so S reads only K from shared memory in two
//   of its three products; a stage holds K_hi, K_lo, V^T_hi, V^T_lo, and
//   two raw V slots feed the split. D <= 64: 64-key tiles, 2 stages (193
//   KB); D <= 128: 32-key tiles, 2 stages (225 KB); D <= 256: q_hi too
//   in shared memory (q's halves 128 KB) for one consumer warpgroup of 64
//   rows, 16-key tiles, 1 stage (225 KB). kernels/flash_prefill.py::
//   flash_plan mirrors it; the C entry refuses any other plan.
// - Pipeline: TMA loads a raw K tile into its stage as soon as both
//   consumers have finished that stage's S, and a raw V tile into a free
//   raw slot; the split runs a stage ahead; a consumer releases K once S
//   is done and V once P V is, and issues tile t's S before tile t - 1's
//   P V as the bf16 kernel does.
// - Registers: setmaxnreg gives the producer warpgroup 56 and the
//   consumers 224 (64,512 in all, what the launch holds: 48 / 232 would
//   need the whole file, and setmaxnreg.inc then waits forever). The
//   split loops unroll twice (four times spilled the producer at D 128).
// - ptxas: the descriptors are made opaque at each issue (with one stage
//   every descriptor is loop-invariant, and hoisting them all spilled at
//   D 256); the wgmmas keep the bf16 kernel's uniform control flow.
#include "hopper.cuh"
#include "paged_attn.cuh"

namespace {

using paged_attn::smem_addr;

// ---------------------------------------------------------------------
// bf16: wgmma fed by a TMA ring, warp-specialised, persistent.
// ---------------------------------------------------------------------
constexpr int BM = 128;          // query rows a work item (two warpgroups)
constexpr int WG_ROWS = 64;      // query rows a consumer warpgroup
constexpr int WG_THREADS = 128;
constexpr int WS_THREADS = 3 * WG_THREADS;  // producer + two consumers
constexpr int PRODUCER_REGS = 40;        // 128 x 40 + 256 x 232 <= 65,536
constexpr int CONSUMER_REGS = 232;
constexpr int BOX_BYTES_ROW = 128;       // a swizzled box row: 64 bf16

// Shared memory of the instantiation: q (BM rows), then STAGES K tiles,
// then STAGES V tiles (BN rows each), each as DMAX / 64 boxes of 64
// columns; then the barriers. 1,024 bytes of slack align the tiles.
template <int DMAX, int BN, int STAGES>
struct WgLayout {
  static constexpr int BOXES = DMAX / 64;
  static constexpr int Q_BYTES = BM * DMAX * 2;
  static constexpr int TILE_BYTES = BN * DMAX * 2;  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * TILE_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * TILE_BYTES;
  // q full / empty, then K full, V full and K/V empty a stage.
  static constexpr int BARS = 2 + 3 * STAGES;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * BARS;
};

// Work item i of n_qt * H * B (tiles of ROWS query rows), in the static
// longest-first order:
// query tile n_qt - 1 - i / (H * B) (the last tile has the most keys),
// then batch row, then head (the heads of a kv group side by side, so
// that blocks running at once read the same K/V tiles from L2). Its live
// K/V tiles: from the window's first key, rounded down to BN, to the
// item's last query or S.
struct WorkItem {
  int q_lo, h, b, t_first, ntiles;
};

template <int BN, int ROWS = BM>
__device__ __forceinline__ WorkItem work_item(int i, int n_qt, int H, int HB,
                                              int S, int window) {
  WorkItem w;
  w.q_lo = (n_qt - 1 - i / HB) * ROWS;
  const int hb = i % HB;
  w.h = hb % H;
  w.b = hb / H;
  const int kv_end = min(S, w.q_lo + ROWS);
  const int kv_lo = window > 0 ? max(0, w.q_lo - window + 1) : 0;
  w.t_first = (kv_lo / BN) * BN;
  w.ntiles = (kv_end - w.t_first + BN - 1) / BN;
  return w;
}

// The block's item of round r (-1 past the end): persistent block j takes
// item r * G + j in even rounds and r * G + G - 1 - j in odd ones, so the
// longest items of each round alternate between the ends of the grid.
__device__ __forceinline__ int block_item(int r, int n_items) {
  const int G = gridDim.x;
  const int j = static_cast<int>(blockIdx.x);
  const int i = r * G + ((r & 1) ? G - 1 - j : j);
  return i < n_items ? i : -1;
}

// One block an SM (384 threads): warpgroup 0 is the producer, one thread
// of which issues every TMA load; warpgroups 1 and 2 are consumers of 64
// query rows each (see the header). Per work item the producer loads q
// (BM rows, once) and then the item's live K/V tiles into a ring of
// STAGES slots (full barriers count TMA bytes, empty barriers the
// consumers' 256 threads). After its last S of an item a warpgroup frees
// q for the next item's load, which so overlaps this item's last tile and
// its epilogue (normalize, store bf16 from registers).
template <int DMAX, int BN, int STAGES>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               __nv_bfloat16* __restrict__ o, int S, int H,
                               int K, int D, int window, float scale,
                               int n_items) {
  using L = WgLayout<DMAX, BN, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + L::K_OFF;
  const uint32_t v_s = base + L::V_OFF;
  const uint32_t q_full = base + L::BAR_OFF;
  const uint32_t q_empty = q_full + 8;
  const uint32_t k_full = q_full + 16;                // + 8 * stage
  const uint32_t v_full = k_full + 8 * STAGES;        // + 8 * stage
  const uint32_t kv_empty = v_full + 8 * STAGES;      // + 8 * stage
  constexpr uint32_t CONSUMERS = 2 * WG_THREADS;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, CONSUMERS);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(k_full + 8 * s, 1);
      hopper::mbar_init(v_full + 8 * s, 1);
      hopper::mbar_init(kv_empty + 8 * s, CONSUMERS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int n_qt = (S + BM - 1) / BM;
  const int HB = n_items / n_qt;  // H * B
  const int rounds = (n_items + static_cast<int>(gridDim.x) - 1) /
                     static_cast<int>(gridDim.x);

  // The warpgroup index, broadcast from lane 0 so that the compiler
  // knows it is uniform: wgmma in a path it takes for divergent is
  // serialized.
  const int wg_idx = __shfl_sync(0xffffffffu, threadIdx.x / WG_THREADS, 0);
  if (wg_idx == 0) {
    // Producer: one thread issues the loads; the warpgroup's other
    // threads hand their registers to the consumers and finish.
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hopper::prefetch_tensor_map(&tm_q);
      hopper::prefetch_tensor_map(&tm_k);
      hopper::prefetch_tensor_map(&tm_v);
      int stage = 0;
      uint32_t phase = 0;   // parity of the ring's current pass
      uint32_t q_phase = 0;
      for (int r = 0; r < rounds; ++r) {
        const int i = block_item(r, n_items);
        if (i < 0) continue;
        const WorkItem w = work_item<BN>(i, n_qt, H, HB, S, window);
        const int kh = w.h / (H / K);
        hopper::mbar_wait(q_empty, q_phase ^ 1);
        q_phase ^= 1;
        hopper::mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
        for (int c = 0; c < L::BOXES; ++c)
          hopper::tma_load_4d(q_s + c * BM * BOX_BYTES_ROW, &tm_q, q_full,
                              c * 64, w.h, w.q_lo, w.b);
        for (int t = 0; t < w.ntiles; ++t) {
          const int t0 = w.t_first + t * BN;
          hopper::mbar_wait(kv_empty + 8 * stage, phase ^ 1);
          const uint32_t kf = k_full + 8 * stage, vf = v_full + 8 * stage;
          const uint32_t ks = k_s + stage * L::TILE_BYTES;
          const uint32_t vs = v_s + stage * L::TILE_BYTES;
          hopper::mbar_expect_tx(kf, L::TILE_BYTES);
#pragma unroll
          for (int c = 0; c < L::BOXES; ++c)
            hopper::tma_load_4d(ks + c * BN * BOX_BYTES_ROW, &tm_k, kf,
                                c * 64, kh, t0, w.b);
          hopper::mbar_expect_tx(vf, L::TILE_BYTES);
#pragma unroll
          for (int c = 0; c < L::BOXES; ++c)
            hopper::tma_load_4d(vs + c * BN * BOX_BYTES_ROW, &tm_v, vf,
                                c * 64, kh, t0, w.b);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    constexpr int NJ = BN / 8;     // n8 chunks of a score tile
    constexpr int NT = DMAX / 8;   // n8 chunks of the output
    constexpr int KV = BN / 16;    // k16 steps of O += P V
    const int wg = wg_idx - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const float c = scale * paged_attn::LOG2E;  // p = 2^((s - m) * c)
    // Key kp is valid for query qp iff 0 <= qp - kp < window (no upper
    // limit without a window): one unsigned compare an element.
    const unsigned lim = window > 0 ? window : 0x7fffffffu;
    // Descriptors: q (this warpgroup's 64 rows) and K are K-major, V is
    // MN-major; a ring slot adds its byte offset / 16.
    const uint64_t q_desc = hopper::smem_desc(
        q_s + wg * WG_ROWS * BOX_BYTES_ROW, 16, 1024);
    const uint64_t k_desc = hopper::smem_desc(k_s, 16, 1024);
    const uint64_t v_desc =
        hopper::smem_desc(v_s, BN * BOX_BYTES_ROW, 1024);
    constexpr uint32_t SLOT = L::TILE_BYTES >> 4;
    int stage = 0;       // ring slot of the next tile
    uint32_t phase = 0;  // parity of the ring's current pass
    uint32_t q_phase = 0;
    auto advance = [&] {
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    // A tile with no valid key for the warpgroup's rows: waited on (its
    // TMA writes done) and released without math.
    auto pass_tile = [&] {
      hopper::mbar_wait(k_full + 8 * stage, phase);
      hopper::mbar_wait(v_full + 8 * stage, phase);
      hopper::mbar_arrive(kv_empty + 8 * stage);
      advance();
    };
    for (int r = 0; r < rounds; ++r) {
      const int i = block_item(r, n_items);
      if (i < 0) continue;
      const WorkItem w = work_item<BN>(i, n_qt, H, HB, S, window);
      // The warpgroup's query positions [r0, r1], this thread's rows, and
      // its live tiles [lo, hi): none for rows past S only; those wholly
      // before the window's first key of row r0 come first and those
      // wholly above the diagonal of row r1 last.
      const int r0 = w.q_lo + wg * WG_ROWS;
      const int r1 = r0 + WG_ROWS - 1;
      const int row = r0 + warp * 16 + (lane >> 2);
      int lo = 0, hi = 0;
      if (r0 < S) {
        hi = min(w.ntiles, (r1 - w.t_first) / BN + 1);
        const int x = r0 - window - BN + 1 - w.t_first;
        if (window > 0 && x >= 0) lo = min(hi, x / BN + 1);
      }
      float oacc[1][NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        oacc[0][j][0] = oacc[0][j][1] = oacc[0][j][2] = oacc[0][j][3] = 0.f;
      float m_r[1][2] = {{-CUDART_INF_F, -CUDART_INF_F}};
      float l_r[1][2] = {{0.f, 0.f}};
      hopper::mbar_wait(q_full, q_phase);
      q_phase ^= 1;
      for (int t = 0; t < lo; ++t) pass_tile();
      if (lo == hi) {
        hopper::mbar_arrive(q_empty);
      } else {
        // Software pipeline over the live tiles: tile t's S = Q K^T is
        // issued before tile t - 1's P V, and its softmax runs while that
        // P V is on the tensor cores; the output is rescaled once the
        // P V is done. The first live tile is peeled off, so that every
        // wait on the tensor cores is unconditional (the compiler
        // serializes wgmmas whose completion it cannot follow).
        float sacc[1][NJ][4];  // written by each tile's first k16 step
        uint32_t ph[KV][4], pl[KV][4];
        float alpha[1][2];
        // S of tile t, masked where the tile crosses the warpgroup's
        // diagonal or its window's first key, turned into float32
        // probabilities in place; returns whether a row of the warp moved
        // its max.
        auto softmax_step = [&](int t) {
          hopper::fence_regs(sacc[0]);
          if (t == hi - 1) hopper::mbar_arrive(q_empty);  // q read
          const int t0 = w.t_first + t * BN;
          if (t0 + BN - 1 > r0 || (window > 0 && t0 <= r1 - window)) {
            const int d0 = row - t0 - (lane & 3) * 2;
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int dq = d0 + (e >> 1) * 8 - j * 8 - (e & 1);
                if (static_cast<unsigned>(dq) >= lim)
                  sacc[0][j][e] = -CUDART_INF_F;
              }
          }
          const bool moved =
              paged_attn::softmax_scores(sacc, m_r, l_r, alpha, c);
          return __any_sync(0xffffffffu, moved);
        };
        // p as the A fragments of the next P V.
        auto stage_probs = [&] {
          paged_attn::split_probs<KV>(sacc[0], ph, pl);
          hopper::fence_regs(ph);
          hopper::fence_regs(pl);
          hopper::fence_regs(oacc[0]);
        };
        hopper::mbar_wait(k_full + 8 * stage, phase);
        hopper::wgmma_fence();
        hopper::issue_qk<DMAX, BN, BM>(sacc[0], q_desc,
                                       k_desc + stage * SLOT);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        softmax_step(lo);  // the output is still 0: no rescale
        stage_probs();
        int p_stage = stage;  // slot of the tile whose P V is pending
        uint32_t p_phase = phase;
        advance();
        for (int t = lo + 1; t < hi; ++t) {
          hopper::mbar_wait(k_full + 8 * stage, phase);
          hopper::mbar_wait(v_full + 8 * p_stage, p_phase);
            hopper::wgmma_fence();
          hopper::issue_qk<DMAX, BN, BM>(sacc[0], q_desc,
                                       k_desc + stage * SLOT);
          hopper::wgmma_commit();
          hopper::issue_pv<DMAX, BN>(oacc[0], ph, pl,
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
        hopper::wgmma_fence();
        hopper::issue_pv<DMAX, BN>(oacc[0], ph, pl,
                                   v_desc + p_stage * SLOT);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(oacc[0]);
        hopper::mbar_arrive(kv_empty + 8 * p_stage);
      }
      for (int t = hi; t < w.ntiles; ++t) pass_tile();
      // Normalized output in bf16; a row without a valid key (l == 0)
      // writes 0.
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // The quad's four threads share a row: sum their shares of l.
        float lr = l_r[0][hh];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        const int qp = row + hh * 8;
        if (qp >= S) continue;
        const float inv = lr == 0.f ? 0.f : 1.f / lr;
        __nv_bfloat16* orow =
            o + ((static_cast<size_t>(w.b) * S + qp) * H + w.h) * D;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = j * 8 + (lane & 3) * 2;
          if (col < D)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(oacc[0][j][2 * hh] * inv,
                                      oacc[0][j][2 * hh + 1] * inv);
        }
      }
    }
  }
}

template <int DMAX, int BN, int STAGES>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int H, int K, int D, int window, float scale,
                 int kv_tile, int stages, int blocks, int smem_arg,
                 cudaStream_t stream) {
  using L = WgLayout<DMAX, BN, STAGES>;
  const long n_items = static_cast<long>((S + BM - 1) / BM) * H * B;
  if (kv_tile != BN || stages != STAGES || smem_arg != L::SMEM ||
      blocks < 1 || blocks > n_items || n_items > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (int e = hopper::encode_rows_map(&tq, q, D, H, S, B, BM)) return e;
  if (int e = hopper::encode_rows_map(&tk, k, D, K, S, B, BN)) return e;
  if (int e = hopper::encode_rows_map(&tv, v, D, K, S, B, BN)) return e;
  auto kern = flash_prefill_wgmma_kernel<DMAX, BN, STAGES>;
  static int allowed[hopper::MAX_DEVICES] = {};
  if (int e = hopper::allow_smem(kern, L::SMEM, allowed)) return e;
  kern<<<blocks, WS_THREADS, L::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, H, K, D, window, scale,
      static_cast<int>(n_items));
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------
// float32: 3xTF32 wgmma fed by TMA rings and split stages,
// warp-specialised, persistent.
// ---------------------------------------------------------------------
// 128 x 56 + 256 x 224 = 64,512 registers, the 384 x 168 the launch
// holds: setmaxnreg.inc waits for registers that setmaxnreg.dec freed,
// and a split needing the whole 65,536 (48 / 232) never starts.
constexpr int F32_PRODUCER_REGS = 56;
constexpr int F32_CONSUMER_REGS = 224;
constexpr int SPLITTERS = WG_THREADS - 32;  // the producer's warps 1-3

// Shared memory of a float32 instantiation (NC consumer warpgroups of 64
// rows, K/V tiles of BN keys, SS stages, RV raw V slots). q_lo of each
// consumer (64 rows of DMAX, 128-byte-swizzled boxes of 32 columns), and
// q_hi after it unless q_hi lives in registers (QREG: DMAX <= 128); the
// raw V slots (TMA's layout); the stages, each K_hi (the raw K tile, which
// TMA writes there), K_lo (its layout), V^T_hi and V^T_lo (hopper.cuh
// split_v_tile's); then the barriers. Every region starts on 1,024 bytes.
template <int DMAX, int BN, int NC, int SS, int RV>
struct F32Layout {
  static constexpr bool QREG = DMAX <= 128;
  static constexpr int BOXES = DMAX / 32;
  static constexpr int Q_HALF = WG_ROWS * DMAX * 4;  // one consumer's hi or lo
  static constexpr int Q_WG = (QREG ? 1 : 2) * Q_HALF;  // lo [, hi]
  static constexpr int TILE = BN * DMAX * 4;         // a K or V tile
  static constexpr int RAW_V = NC * Q_WG;             // + slot * TILE
  static constexpr int STAGE = RAW_V + RV * TILE;     // + stage * 4 TILE
  static constexpr int BAR_OFF = STAGE + SS * 4 * TILE;
  // raw V full / empty a slot, then K raw (TMA), K full (K_lo), K empty,
  // V full, V empty a stage.
  static constexpr int BARS = 2 * RV + 5 * SS;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * BARS;
};

// One block an SM ((1 + NC) x 128 threads). Warpgroup 0: lane 0 of its
// first warp issues every TMA load (raw K and V tiles of an item's live
// keys into their rings); its warps 1-3 split each raw tile into the tf32
// halves of a split stage (K as laid out, V transposed), freeing each
// raw slot as soon as it is split. Warpgroups 1..NC are consumers of 64
// query rows each: they stage their q themselves (16-byte loads from
// global memory; q_lo, and q_hi unless QREG, into swizzled shared memory,
// q_hi as register-A fragments if QREG), then run the tile step of the
// bf16 kernel with 3xTF32 products.
template <int DMAX, int BN, int NC, int SS, int RV>
__global__ void __launch_bounds__((1 + NC) * WG_THREADS, 1)
    flash_prefill_tf32_kernel(const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const float* __restrict__ q,
                              float* __restrict__ o, int S, int H, int K,
                              int D, int window, float scale, int n_items) {
  using L = F32Layout<DMAX, BN, NC, SS, RV>;
  constexpr int ROWS = NC * WG_ROWS;  // query rows a work item
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw_addr);
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
    const int chunks = (L::BOXES - ncb) * BN * 8;  // 16 bytes each
    for (int idx = threadIdx.x; idx < (SS + RV) * chunks;
         idx += blockDim.x) {
      const int t = idx / chunks, j = idx - t * chunks;
      const int tile = t < SS ? L::STAGE + t * 4 * L::TILE
                              : L::RAW_V + (t - SS) * L::TILE;
      *reinterpret_cast<uint4*>(gbase + tile + ncb * BN * 128 + j * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    hopper::fence_proxy_async();
  }
  __syncthreads();

  const int n_qt = (S + ROWS - 1) / ROWS;
  const int HB = n_items / n_qt;  // H * B
  const int rounds = (n_items + static_cast<int>(gridDim.x) - 1) /
                     static_cast<int>(gridDim.x);
  // The warpgroup index, broadcast from lane 0 so that the compiler
  // knows it is uniform: wgmma in a path it takes for divergent is
  // serialized.
  const int wg_idx = __shfl_sync(0xffffffffu, threadIdx.x / WG_THREADS, 0);
  if (wg_idx == 0) {
    if constexpr (NC > 1) hopper::setmaxnreg_dec<F32_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      // TMA, for every live tile in order: the raw K tile into its
      // stage's K_hi as soon as the consumers are done with the stage's
      // K, the raw V tile into the V ring as soon as its slot is split.
      hopper::prefetch_tensor_map(&tm_k);
      hopper::prefetch_tensor_map(&tm_v);
      const uint32_t bytes = ncb * BN * 128;
      hopper::Ring<SS> sp;
      hopper::Ring<RV> rv;
      for (int r = 0; r < rounds; ++r) {
        const int i = block_item(r, n_items);
        if (i < 0) continue;
        const WorkItem w = work_item<BN, ROWS>(i, n_qt, H, HB, S, window);
        const int kh = w.h / (H / K);
        for (int t = 0; t < w.ntiles; ++t) {
          const int t0 = w.t_first + t * BN;
          const uint32_t kr = k_raw + 40 * sp.slot;
          hopper::mbar_wait(k_empty + 40 * sp.slot, sp.phase ^ 1);
          hopper::mbar_expect_tx(kr, bytes);
          for (int c = 0; c < ncb; ++c)
            hopper::tma_load_4d(
                base + L::STAGE + sp.slot * 4 * L::TILE + c * BN * 128,
                &tm_k, kr, c * 32, kh, t0, w.b);
          sp.next();
          const uint32_t vf = rv_full + 16 * rv.slot;
          hopper::mbar_wait(rv_empty + 16 * rv.slot, rv.phase ^ 1);
          hopper::mbar_expect_tx(vf, bytes);
          for (int c = 0; c < ncb; ++c)
            hopper::tma_load_4d(
                base + L::RAW_V + rv.slot * L::TILE + c * BN * 128, &tm_v,
                vf, c * 32, kh, t0, w.b);
          rv.next();
        }
      }
    } else if (threadIdx.x >= 32) {
      // The split: K's lo half once its raw tile has landed (the stage's
      // K was free before the load), then V's halves when the stage's V
      // is free; the raw V slot goes back to the loads once split.
      const int st = threadIdx.x - 32;
      hopper::Ring<RV> rv;
      hopper::Ring<SS> sp;
      for (int r = 0; r < rounds; ++r) {
        const int i = block_item(r, n_items);
        if (i < 0) continue;
        const WorkItem w = work_item<BN, ROWS>(i, n_qt, H, HB, S, window);
        for (int t = 0; t < w.ntiles; ++t) {
          unsigned char* dst = gbase + L::STAGE + sp.slot * 4 * L::TILE;
          hopper::mbar_wait(k_raw + 40 * sp.slot, sp.phase);
          hopper::split_k_tile(dst, dst + L::TILE, L::TILE, st, SPLITTERS);
          hopper::fence_proxy_async();
          hopper::mbar_arrive(k_full + 40 * sp.slot);
          hopper::mbar_wait(rv_full + 16 * rv.slot, rv.phase);
          hopper::mbar_wait(v_empty + 40 * sp.slot, sp.phase ^ 1);
          hopper::split_v_tile<DMAX, BN>(
              gbase + L::RAW_V + rv.slot * L::TILE, dst + 2 * L::TILE,
              dst + 3 * L::TILE, BN, st, SPLITTERS);
          hopper::fence_proxy_async();
          hopper::mbar_arrive(v_full + 40 * sp.slot);
          hopper::mbar_arrive(rv_empty + 16 * rv.slot);
          rv.next();
          sp.next();
        }
      }
    }
  } else {
    if constexpr (NC > 1) hopper::setmaxnreg_inc<F32_CONSUMER_REGS>();
    constexpr int NJ = BN / 8;     // n8 chunks of a score tile
    constexpr int NT = DMAX / 8;   // n8 chunks of the output
    const int wg = wg_idx - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const float c = scale * paged_attn::LOG2E;  // p = 2^((s - m) * c)
    const unsigned lim = window > 0 ? window : 0x7fffffffu;
    unsigned char* qg = gbase + wg * L::Q_WG;     // q_lo, then q_hi
    const uint32_t q_s = base + wg * L::Q_WG;
    const uint64_t ql_desc = hopper::smem_desc(q_s, 16, 1024);
    const uint64_t qh_desc = hopper::smem_desc(q_s + L::Q_HALF, 16, 1024);
    const uint32_t sp0 = base + L::STAGE;
    const uint64_t kh_desc = hopper::smem_desc(sp0, 16, 1024);
    const uint64_t kl_desc = hopper::smem_desc(sp0 + L::TILE, 16, 1024);
    const uint64_t vh_desc =
        hopper::smem_desc_plain(sp0 + 2 * L::TILE, 16 * DMAX, 128);
    const uint64_t vl_desc =
        hopper::smem_desc_plain(sp0 + 3 * L::TILE, 16 * DMAX, 128);
    constexpr uint32_t SLOT = (4 * L::TILE) >> 4;
    uint32_t qa[L::QREG ? NT : 1][4];  // q_hi fragments (QREG)
    hopper::Ring<SS> sp;  // split stage of the next tile
    // A tile with no valid key for the warpgroup's rows: waited on and
    // released without math.
    auto pass_tile = [&] {
      hopper::mbar_wait(k_full + 40 * sp.slot, sp.phase);
      hopper::mbar_arrive(k_empty + 40 * sp.slot);
      hopper::mbar_wait(v_full + 40 * sp.slot, sp.phase);
      hopper::mbar_arrive(v_empty + 40 * sp.slot);
      sp.next();
    };
    for (int r = 0; r < rounds; ++r) {
      const int i = block_item(r, n_items);
      if (i < 0) continue;
      const WorkItem w = work_item<BN, ROWS>(i, n_qt, H, HB, S, window);
      const int r0 = w.q_lo + wg * WG_ROWS;
      const int r1 = r0 + WG_ROWS - 1;
      const int row = r0 + warp * 16 + (lane >> 2);
      int lo = 0, hi = 0;
      if (r0 < S) {
        hi = min(w.ntiles, (r1 - w.t_first) / BN + 1);
        const int x = r0 - window - BN + 1 - w.t_first;
        if (window > 0 && x >= 0) lo = min(hi, x / BN + 1);
      }
      float oacc[1][NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        oacc[0][j][0] = oacc[0][j][1] = oacc[0][j][2] = oacc[0][j][3] = 0.f;
      float m_r[1][2] = {{-CUDART_INF_F, -CUDART_INF_F}};
      float l_r[1][2] = {{0.f, 0.f}};
      for (int t = 0; t < lo; ++t) pass_tile();
      if (lo < hi) {
        // The warpgroup's q rows as tf32 halves (zero past S and D). The
        // previous item's last S has completed (waited on), so q's
        // shared memory and registers are free.
        const float* qb = q + (static_cast<size_t>(w.b) * S * H + w.h) * D;
        for (int idx = tid; idx < WG_ROWS * (DMAX / 4); idx += WG_THREADS) {
          const int rr = idx / (DMAX / 4);
          const int ch = idx - rr * (DMAX / 4);
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r0 + rr < S && ch * 4 < D)
            x = *reinterpret_cast<const float4*>(
                qb + static_cast<size_t>(r0 + rr) * H * D + ch * 4);
          const int off = hopper::swz128_f32(WG_ROWS, rr, ch * 4);
          *reinterpret_cast<uint4*>(qg + off) = hopper::tf32_lo4(x);
          if constexpr (!L::QREG)
            *reinterpret_cast<float4*>(qg + L::Q_HALF + off) = x;
        }
        if constexpr (L::QREG)
          hopper::load_q_frags<DMAX>(
              qa,
              [&](int i) -> const float* {
                const int qp = r0 + warp * 16 + i;
                return qp < S ? qb + static_cast<size_t>(qp) * H * D
                              : nullptr;
              },
              D);
        hopper::fence_proxy_async();
        hopper::named_bar_sync(2 + wg, WG_THREADS);
        float sacc[1][NJ][4];  // written by each tile's first product
        uint32_t ph[NJ][4], pl[NJ][4];
        float alpha[1][2];
        auto softmax_step = [&](int t) {
          hopper::fence_regs(sacc[0]);
          const int t0 = w.t_first + t * BN;
          if (t0 + BN - 1 > r0 || (window > 0 && t0 <= r1 - window)) {
            const int d0 = row - t0 - (lane & 3) * 2;
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int dq = d0 + (e >> 1) * 8 - j * 8 - (e & 1);
                if (static_cast<unsigned>(dq) >= lim)
                  sacc[0][j][e] = -CUDART_INF_F;
              }
          }
          const bool moved =
              paged_attn::softmax_scores(sacc, m_r, l_r, alpha, c);
          return __any_sync(0xffffffffu, moved);
        };
        auto stage_probs = [&] {
          hopper::split_probs_tf32<NJ>(sacc[0], ph, pl);
          hopper::fence_regs(ph);
          hopper::fence_regs(pl);
          hopper::fence_regs(oacc[0]);
        };
        auto issue_s = [&] {
          if constexpr (L::QREG)
            hopper::issue_qk_tf32_rs<DMAX, BN, WG_ROWS>(
                sacc[0], qa, ql_desc, kh_desc + sp.slot * SLOT,
                kl_desc + sp.slot * SLOT);
          else
            hopper::issue_qk_tf32<DMAX, BN, WG_ROWS>(
                sacc[0], qh_desc, ql_desc, kh_desc + sp.slot * SLOT,
                kl_desc + sp.slot * SLOT);
        };
        // Software pipeline (the bf16 kernel's): tile t's S is issued
        // before tile t - 1's P V; K is released once S is done, V once
        // P V is.
        hopper::mbar_wait(k_full + 40 * sp.slot, sp.phase);
        hopper::wgmma_fence();
        issue_s();
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sacc[0]);
        hopper::mbar_arrive(k_empty + 40 * sp.slot);
        softmax_step(lo);  // the output is still 0: no rescale
        stage_probs();
        hopper::Ring<SS> pv = sp;  // stage of the tile whose P V is pending
        sp.next();
        for (int t = lo + 1; t < hi; ++t) {
          hopper::mbar_wait(k_full + 40 * sp.slot, sp.phase);
          hopper::mbar_wait(v_full + 40 * pv.slot, pv.phase);
          hopper::wgmma_fence();
          issue_s();
          hopper::wgmma_commit();
          hopper::issue_pv_tf32<DMAX, BN>(oacc[0], ph, pl,
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
        hopper::issue_pv_tf32<DMAX, BN>(oacc[0], ph, pl,
                                        vh_desc + pv.slot * SLOT,
                                        vl_desc + pv.slot * SLOT);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(oacc[0]);
        hopper::mbar_arrive(v_empty + 40 * pv.slot);
      }
      for (int t = hi; t < w.ntiles; ++t) pass_tile();
      // Normalized output; a row without a valid key (l == 0) writes 0.
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float lr = l_r[0][hh];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        const int qp = row + hh * 8;
        if (qp >= S) continue;
        const float inv = lr == 0.f ? 0.f : 1.f / lr;
        float* orow = o + ((static_cast<size_t>(w.b) * S + qp) * H + w.h) * D;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = j * 8 + (lane & 3) * 2;
          if (col < D)
            *reinterpret_cast<float2*>(orow + col) =
                make_float2(oacc[0][j][2 * hh] * inv,
                            oacc[0][j][2 * hh + 1] * inv);
        }
      }
    }
  }
}

template <int DMAX, int BN, int NC, int SS, int RV>
int launch_tf32(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int K, int D, int window, float scale,
                int rows, int kv_tile, int stages, int blocks, int smem_arg,
                cudaStream_t stream) {
  using L = F32Layout<DMAX, BN, NC, SS, RV>;
  const long n_items =
      static_cast<long>((S + NC * WG_ROWS - 1) / (NC * WG_ROWS)) * H * B;
  if (rows != NC * WG_ROWS || kv_tile != BN || stages != SS ||
      smem_arg != L::SMEM || blocks < 1 || blocks > n_items ||
      n_items > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tk, tv;
  if (int e = hopper::encode_rows_map(&tk, k, D, K, S, B, BN, 4)) return e;
  if (int e = hopper::encode_rows_map(&tv, v, D, K, S, B, BN, 4)) return e;
  auto kern = flash_prefill_tf32_kernel<DMAX, BN, NC, SS, RV>;
  static int allowed[hopper::MAX_DEVICES] = {};
  if (int e = hopper::allow_smem(kern, L::SMEM, allowed)) return e;
  kern<<<blocks, (1 + NC) * WG_THREADS, L::SMEM, stream>>>(
      tk, tv, static_cast<const float*>(q), static_cast<float*>(o), S, H, K,
      D, window, scale, static_cast<int>(n_items));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry: returns cudaGetLastError() after the launch (0 = success).
// dtype: 0 = float32 (3xTF32 wgmma), 1 = bfloat16 (wgmma); q, k, v and
// the output share it. The caller plans the launch (kernels/
// flash_prefill.py::flash_plan): rows_per_block (query rows a work item:
// bf16 128; float32 128, or 64 at D > 128), kv_tile, stages (bf16: the
// ring's; float32: the split stages), blocks (persistent, at most one a
// work item) and smem_bytes must be what the instantiation for (D,
// dtype) lays out; any other value returns cudaErrorInvalidValue.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* o, int B, int S,
                                    int H, int K, int D, int window,
                                    int rows_per_block, int kv_tile,
                                    int stages, int blocks, int smem_bytes,
                                    float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (rows_per_block != BM) return static_cast<int>(cudaErrorInvalidValue);
    if (D <= 64)
      return launch_wgmma<64, 128, 4>(q, k, v, o, B, S, H, K, D, window,
                                      scale, kv_tile, stages, blocks,
                                      smem_bytes, s);
    if (D <= 128)
      return launch_wgmma<128, 128, 3>(q, k, v, o, B, S, H, K, D, window,
                                       scale, kv_tile, stages, blocks,
                                       smem_bytes, s);
    return launch_wgmma<256, 64, 2>(q, k, v, o, B, S, H, K, D, window, scale,
                                    kv_tile, stages, blocks, smem_bytes, s);
  }
  if (D <= 64)
    return launch_tf32<64, 64, 2, 2, 2>(q, k, v, o, B, S, H, K, D, window,
                                           scale, rows_per_block, kv_tile,
                                           stages, blocks, smem_bytes, s);
  if (D <= 128)
    return launch_tf32<128, 32, 2, 2, 2>(q, k, v, o, B, S, H, K, D,
                                            window, scale, rows_per_block,
                                            kv_tile, stages, blocks,
                                            smem_bytes, s);
  return launch_tf32<256, 16, 1, 1, 2>(q, k, v, o, B, S, H, K, D, window,
                                          scale, rows_per_block, kv_tile,
                                          stages, blocks, smem_bytes, s);
}
