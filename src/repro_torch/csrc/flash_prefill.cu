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
// float32 keeps the CUDA-core kernel of the first port (one block of 256
// threads per (64 query positions, head, batch row), float32 FMAs on 4 x 4
// register tiles, q and K transposed in shared memory, about 217 KB at
// D = 256).
#include "hopper.cuh"
#include "paged_attn.cuh"

namespace {

using paged_attn::smem_addr;

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
  static int allowed[hopper::MAX_DEVICES] = {};
  if (int e = hopper::allow_smem(kern, smem_bytes(16 * DPT, DPT), allowed))
    return e;
  const dim3 grid((S + TQ - 1) / TQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, K, D,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

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

// Work item i of n_qt * H * B, in the static longest-first order:
// query tile n_qt - 1 - i / (H * B) (the last tile has the most keys),
// then batch row, then head (the heads of a kv group side by side, so
// that blocks running at once read the same K/V tiles from L2). Its live
// K/V tiles: from the window's first key, rounded down to BN, to the
// item's last query or S.
struct WorkItem {
  int q_lo, h, b, t_first, ntiles;
};

template <int BN>
__device__ __forceinline__ WorkItem work_item(int i, int n_qt, int H, int HB,
                                              int S, int window) {
  WorkItem w;
  w.q_lo = (n_qt - 1 - i / HB) * BM;
  const int hb = i % HB;
  w.h = hb % H;
  w.b = hb / H;
  const int kv_end = min(S, w.q_lo + BM);
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

}  // namespace

// C entry: returns cudaGetLastError() after the launch (0 = success).
// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (wgmma); q, k, v and the
// output share it. The caller plans the launch (kernels/flash_prefill.py::
// flash_plan): rows_per_block (bf16 128, float32 64), kv_tile, stages,
// blocks (bf16: persistent blocks, at most one a work item; float32: the
// grid's blocks) and smem_bytes must be what the instantiation for (D,
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
  if (rows_per_block != TQ || kv_tile != TK || stages != 1 ||
      static_cast<long>(blocks) != static_cast<long>((S + TQ - 1) / TQ) * H * B)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 128)
    return launch_f32<8>(q, k, v, o, B, S, H, K, D, window, scale,
                         smem_bytes, s);
  return launch_f32<16>(q, k, v, o, B, S, H, K, D, window, scale, smem_bytes,
                        s);
}
