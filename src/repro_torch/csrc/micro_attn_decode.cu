// Paged DistAttention MicroAttention partial, decode (paper Eq. 2).
//
// Replaces the Pallas TPU kernel repro/kernels/micro_attn_decode.py::
// paged_micro_attention_kernel (body _kernel), and its vmap over the rank
// axis (repro/kernels/ops.py::paged_micro_attention_ranks). One query
// token per request attends over one rank's paged pool [NB, bs, K, D]
// through the request's -1-padded block table [R, MB]; only the last valid
// slot is partial (tail_len[r] tokens). Output: unnormalized o [R, H, D]
// and m, l [R, H], all float32; an empty table gives (0, -inf, 0).
//
// Bound on the H100: HBM bytes. Each step reads every valid K/V row once,
// R * S * K * D * 2 * itemsize bytes, against 4 * G FLOPs per K/V element
// (G = H / K), below the card's ~295 FLOP/byte ridge at every served G.
// At the qwen3 path's main shape (R=8, S~4,090, K=8, D=128, bf16) that is
// 134 MB, 0.040 ms at 3.35 TB/s. What keeps a kernel from it: bytes in
// flight on every SM (the loads of a token depend on its table entry),
// work spread over the requests' valid tokens (known only from the
// tables, on the card), and, at large G, the math per byte.
//
// paged_decode_units_kernel (single rank), built for Hopper:
// - Work: persistent blocks (2 an SM; 1 where the shared memory or the
//   registers allow no more) take equal shares of units of at most U =
//   256 valid tokens of each request, planned on the card from the tables
//   (paged_attn.cuh's plan_units at NR = 1: an L-ary search of each
//   prefix-contiguous table, no host read). A short request's tokens are
//   a few units and an empty one none, so no block walks the longest
//   table's width. A block stores one partial a run of one group's
//   units; the last partial of a group to arrive LSE-merges them
//   (merge_parts, a ticket counter a group): one launch a call.
// - A group is (request, kv head, head group): every query head of a kv
//   head, up to 16, in one block, so each K/V byte crosses HBM and shared
//   memory once however large G is.
// - Loads: warp 0 issues TMA loads (hopper.cuh) of 4-D maps over the pools
//   [NB][bs][K][D], one box a table block's share of a tile (gcd(bs, TT)
//   tokens by 128 bytes of one kv head's columns, 128-byte swizzle),
//   into a ring of 3 tiles of K and V (2 where a tile is 32 KB), mbarrier
//   full / empty handshakes. The maps are encoded once a pool
//   (hopper::cached_rows_map). Four compute warps take a quarter of each
//   tile's tokens.
// - Tensor cores (bf16; what the plan picks from a measured A/B, see
//   kernels/micro_attn_decode.py::decode_unit_plan): a compute warp's 16
//   tokens against the group's heads as the rows of an m16 tile (zero
//   past G): S = Q K^T and O += P V on mma.sync, paged_attn.cuh's tile
//   step over the swizzled tiles, p as bf16 hi + lo (the prefill-chunk
//   kernel's contract: q K^T exact in float32, at most 2^-16 relative a
//   P V term, l from the float32 p).
// - CUDA cores (float32): a token's
//   q . k is split over 32 / (tile / 4) lanes reading its 16-byte chunks
//   (the swizzle keeps them off each other's banks), the online softmax
//   runs on the warp's tokens in float32, and in P V a lane owns D / 32
//   output columns; GT (2, 4, 8 or 16 >= the heads a block) query heads
//   share each K/V chunk read. Precision: float32 throughout (q, K and V
//   upcast, the probabilities never rounded), as the Pallas kernel.
// - Tokens past a request's valid ones in its last tile (stale rows, or
//   rows no table names) score -inf by a select; the CUDA cores never
//   read their V rows, the tensor cores zero them in shared memory first
//   (0 * NaN is NaN inside an MMA).
// - The compute warps' partials are LSE-merged through shared memory,
//   then stored to the outputs (a group's only partial) or to the
//   block's scratch slot.
//
// The rank kernel (paged_decode_ranks_kernel, below) replaces the JAX
// package's vmap of that kernel over the global pool's rank axis: one
// launch covers NR rank pools, each a [NB, bs, K, D] slab rank_stride
// elements after the previous one (a per-layer view of the global pool
// [NR, L, NB, bs, K, D] is not contiguous; it is read in place, never
// copied). q [R, H, D] is shared by every rank; tables [NR, R, MB] and
// tails [NR, R]. Outputs: stacked, one partial a (rank, request) [NR, R,
// ...]; or merged, the ranks' partials LSE-merged in the launch [R, ...]
// (what the global pool's steps take). Its design (PR 24's):
// - Units of valid tokens, planned on the card (paged_attn.cuh) over
//   every (rank, request) pair: an empty pair reads no K/V. The launch is
//   persistent blocks, 3 an SM, from the shapes and the SM count
//   (rank_decode_plan).
// - Units address tokens, not slots: a tile's pool rows (table[t / bs]
//   * bs + t % bs, on the tile's rank) are resolved two tiles ahead into
//   a ring in shared memory, so a block's walk crosses ranks and blocks
//   of any size without a copy of the tables.
// - The merge in the launch, as above; it folds the rank merge
//   (merge_partials over the stack, ~8 operations a layer) into the
//   launch.
// - The inner loop: CUDA cores, a 2-stage cp.async ring issued by the
//   compute warps, GT <= 2 query heads a K/V tile.
// exp is taken as exp2 of a float32 product with log2(e) (2-ulp exp2, a
// relative error near 1e-6 at most).
#include <type_traits>

#include "hopper.cuh"
#include "paged_attn.cuh"

namespace {

using paged_attn::cp_async16;
using paged_attn::cp_async_commit;
using paged_attn::cp_async_wait;
using paged_attn::LOG2E;
using paged_attn::smem_addr;

constexpr int WARPS = 4;   // warps of a rank-kernel block
constexpr int STAGES = 2;  // its cp.async ring depth of K/V tiles

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

// ---------------------------------------------------------------------
// The decode kernel: persistent blocks over units of valid tokens, every
// query head of a kv head in one block, K/V tiles through a TMA ring.
// ---------------------------------------------------------------------
constexpr int DW = 4;                        // compute warps
constexpr int DEC_THREADS = 32 * (DW + 1);   // warp 0 issues the loads
constexpr int DEC_BAR = 1;                   // the compute warps' barrier
constexpr int MMA_ROWS = 16;                 // query heads of an m16 tile

// Tokens a K/V tile: 64 on the tensor cores (16 a compute warp); on the
// CUDA cores by row size as the rank kernel's tiles (at most 16 KB).
template <typename T, int DMAX, bool TC>
__host__ __device__ constexpr int dec_tile_tokens() {
  return TC ? 64 : tile_tokens<T, DMAX>();
}

// Ring depth: 3 tiles of K and V (96 KB), 2 where a tile is 32 KB.
template <typename T, int DMAX, bool TC>
__host__ __device__ constexpr int dec_stages() {
  return dec_tile_tokens<T, DMAX, TC>() * DMAX * sizeof(T) > 16384 ? 2 : 3;
}

// Shared memory: the ring (K tiles, then V tiles, each the 128-byte boxes
// of D's columns by TT rows), its barriers (3 a stage), q (tensor cores:
// 16 bf16 rows of DMAX + 8; CUDA cores: GT float32 rows of DMAX), the
// compute warps' partials of `heads` rows
// (DW x heads x (D + 2) floats; reused by the group merge) and the plan
// (R + R + 1 ints); 1,024 bytes of slack align the ring.
struct DecLayout {
  int tile_bytes, stages, bar_off, q_off, part_off, plan_off, smem;
};

template <typename T, int DMAX, bool TC, int GT>
__host__ __device__ inline DecLayout dec_layout(int D, int heads, int R) {
  DecLayout L;
  L.tile_bytes = dec_tile_tokens<T, DMAX, TC>() *
                 ((D * static_cast<int>(sizeof(T)) + 127) / 128) * 128;
  L.stages = dec_stages<T, DMAX, TC>();
  L.bar_off = 2 * L.stages * L.tile_bytes;
  L.q_off = L.bar_off + ((24 * L.stages + 15) / 16) * 16;
  const int q_bytes = TC ? MMA_ROWS * (DMAX + 8) * 2
                         : GT * DMAX * static_cast<int>(sizeof(float));
  L.part_off = L.q_off + q_bytes;
  L.plan_off = L.part_off + DW * heads * (D + 2) * 4;
  L.smem = 1024 + L.plan_off + 4 * (2 * R + 1);
  return L;
}

// N elements of a token row's columns col0 .. col0 + N - 1 (in one or
// two 16-byte chunks) from a tile of 128-byte-swizzled boxes, TT rows a
// box, as float32.
template <int TT, typename T, int N>
__device__ __forceinline__ void load_swz(const unsigned char* tile, int row,
                                         int col0, float (&x)[N]) {
  constexpr int PER = 16 / static_cast<int>(sizeof(T)) < N
                          ? 16 / static_cast<int>(sizeof(T))
                          : N;
#pragma unroll
  for (int i = 0; i < N; i += PER) {
    const int byte = (col0 + i) * static_cast<int>(sizeof(T));
    const T* p = reinterpret_cast<const T*>(
        tile + (byte >> 7) * TT * 128 + row * 128 +
        ((((byte >> 4) & 7) ^ (row & 7)) << 4) + (byte & 15));
    float xi[PER];
    load_vec<PER>(p, xi);
#pragma unroll
    for (int e = 0; e < PER; ++e) x[i + e] = xi[e];
  }
}

// A compute warp's running partial: tensor cores, rows lane / 4 and + 8
// of the m16 tile (o as mma.sync's n8 fragments, raw-score max m, this
// thread's share of l); CUDA cores, GT heads and columns lane * EPL ...
// (m of the scaled scores).
template <int NT>
struct TcPartial {
  float o[1][NT][4], m[1][2], l[1][2];
};
template <int GT, int EPL>
struct CcPartial {
  float o[GT][EPL], m[GT], l[GT];
};

// One launch a call (see the header). T: float or bf16; DMAX 128 or 256;
// TC: the tensor-core form (bf16, G heads as the rows of an m16 tile);
// else the CUDA-core form with GT >= `heads` query heads a block. The
// maps read the pools in boxes of 128 bytes of one kv head's columns by
// box_rows tokens of one block.
template <typename T, int DMAX, bool TC, int GT, int MINB>
__global__ void __launch_bounds__(DEC_THREADS, MINB)
    paged_decode_units_kernel(const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const T* __restrict__ q,
                              const int* __restrict__ table,
                              const int* __restrict__ tail,
                              float* __restrict__ o,
                              float* __restrict__ m_out,
                              float* __restrict__ l_out,
                              float* __restrict__ ws,
                              unsigned* __restrict__ tickets, int R, int H,
                              int K, int D, int bs, int MB, int U, int heads,
                              int box_rows, float scale) {
  constexpr int TT = dec_tile_tokens<T, DMAX, TC>();
  constexpr int STAGES = dec_stages<T, DMAX, TC>();
  constexpr int EB = 128 / static_cast<int>(sizeof(T));  // elements a box
  const DecLayout L = dec_layout<T, DMAX, TC, GT>(D, heads, R);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t k_s = base, v_s = base + STAGES * L.tile_bytes;
  const uint32_t k_full = base + L.bar_off;
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t kv_empty = v_full + 8 * STAGES;
  float* part_s = reinterpret_cast<float*>(gbase + L.part_off);
  int* plan_s = reinterpret_cast<int*>(gbase + L.plan_off);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(k_full + 8 * s, 1);
      hopper::mbar_init(v_full + 8 * s, 1);
      hopper::mbar_init(kv_empty + 8 * s, DW * 32);
    }
    hopper::mbar_init_fence();
  }
  const int G = H / K;
  const int ngroups = (G + heads - 1) / heads;  // head groups a kv head
  // plan_units' first __syncthreads also publishes the barriers.
  const paged_attn::UnitPlan pl = paged_attn::plan_units(
      table, tail, 1, R, MB, bs, U, K * ngroups, false, plan_s,
      plan_s + R);
  // Output rows of head group h of request r: r * H + the first head.
  auto first_head = [&](int h, int& ng) {
    const int kh = h / ngroups, g0 = (h - kh * ngroups) * heads;
    ng = min(heads, G - g0);
    return kh * G + g0;
  };
  // Groups of a request with no valid token: (0, -inf, 0).
  for (int g = blockIdx.x; g < pl.P * pl.HG; g += gridDim.x) {
    const int rho = g / pl.HG;
    if (pl.group_units(rho) != 0) continue;
    int ng;
    const size_t h0 =
        static_cast<size_t>(rho) * H + first_head(g - rho * pl.HG, ng);
    for (int i = threadIdx.x; i < ng * D; i += blockDim.x) o[h0 * D + i] = 0.f;
    if (static_cast<int>(threadIdx.x) < ng) {
      m_out[h0 + threadIdx.x] = -CUDART_INF_F;
      l_out[h0 + threadIdx.x] = 0.f;
    }
  }
  long long p, p1;
  pl.block_units(blockIdx.x, p, p1);
  p = paged_attn::uniform(p);
  p1 = paged_attn::uniform(p1);
  const int warp = paged_attn::uniform(static_cast<int>(threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;

  if (warp == 0) {
    // The producer warp: lane b issues box b of each tile (K and V), lane
    // 0 arms the tile's barriers with the bytes of the boxes issued.
    if (lane == 0) {
      hopper::prefetch_tensor_map(&tm_k);
      hopper::prefetch_tensor_map(&tm_v);
    }
    const int ncb = (D + EB - 1) / EB;  // column boxes holding data
    const uint32_t box_bytes = box_rows * 128;
    int stage = 0;
    uint32_t phase = 0;
    while (p < p1) {
      const paged_attn::Segment sg = paged_attn::segment_at(pl, p, p1);
      const int kh = sg.h / ngroups;
      const int hi = min(sg.q1 * U, pl.S[sg.rho]);
      const int* tab = table + static_cast<size_t>(sg.rho) * MB;
      for (int t0 = sg.q0 * U; t0 < hi; t0 += TT) {
        const int nb = (min(TT, hi - t0) + box_rows - 1) / box_rows;
        int blk = 0, off = 0;
        if (lane < nb) {
          const int t = t0 + lane * box_rows;
          const int slot = t / bs;
          blk = tab[slot];
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
          const uint32_t at = stage * L.tile_bytes + lane * box_bytes;
          for (int c = 0; c < ncb; ++c) {
            hopper::tma_load_4d(k_s + at + c * TT * 128, &tm_k, kf, c * EB,
                                kh, off, blk);
            hopper::tma_load_4d(v_s + at + c * TT * 128, &tm_v, vf, c * EB,
                                kh, off, blk);
          }
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      p = min(p1, sg.end);
    }
    return;
  }

  // The compute warps.
  const int cw = warp - 1;
  const int ct = threadIdx.x - 32;
  const paged_attn::WarpThreads cws{32, DW * 32, DEC_BAR};
  const size_t W = paged_attn::part_row(D);
  constexpr int NT = DMAX / 8;      // n8 tiles of the output (tensor cores)
  constexpr int TPW = TT / DW;      // a warp's tokens of a tile
  constexpr int LPT = 32 / TPW;     // lanes sharing a token's q . k
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // a 16-byte chunk
  constexpr int EPL = DMAX / 32;    // output columns a lane (CUDA cores)
  constexpr int MAXC = DMAX / VEC / LPT;
  constexpr int QS = DMAX + 8;      // q row stride (tensor cores), bf16
  const float c2 = scale * LOG2E;   // p = 2^((s - m) * c2) (tensor cores)
  int stage = 0;
  uint32_t phase = 0;
  while (p < p1) {
    const paged_attn::Segment sg = paged_attn::segment_at(pl, p, p1);
    int ng;
    const int hoff = first_head(sg.h, ng);
    const size_t h0 = static_cast<size_t>(sg.rho) * H + hoff;
    const int lo = paged_attn::uniform(sg.q0 * U);
    const int hi = paged_attn::uniform(min(sg.q1 * U, pl.S[sg.rho]));
    const int ntiles = (hi - lo + TT - 1) / TT;
    // q rows of the group (zero past its heads and past D).
    if constexpr (TC) {
      __nv_bfloat16* q_s =
          reinterpret_cast<__nv_bfloat16*>(gbase + L.q_off);
      for (int idx = ct; idx < MMA_ROWS * (DMAX / 8); idx += DW * 32) {
        const int row = idx / (DMAX / 8), col = (idx - row * (DMAX / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row < ng && col < D)
          v = *reinterpret_cast<const uint4*>(q + (h0 + row) * D + col);
        *reinterpret_cast<uint4*>(q_s + row * QS + col) = v;
      }
    } else {
      float* q_s = reinterpret_cast<float*>(gbase + L.q_off);
      for (int i = ct; i < GT * DMAX; i += DW * 32) {
        const int g = i / DMAX, d = i - g * DMAX;
        q_s[i] = g < ng && d < D ? paged_attn::to_f32(q[(h0 + g) * D + d])
                                 : 0.f;
      }
    }
    hopper::named_bar_sync(DEC_BAR, DW * 32);

    std::conditional_t<TC, TcPartial<NT>, CcPartial<GT, EPL>> st;
#pragma unroll
    for (int g = 0; g < (TC ? 1 : GT); ++g) {
      if constexpr (TC) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
          st.o[0][j][0] = st.o[0][j][1] = st.o[0][j][2] = st.o[0][j][3] = 0.f;
        st.m[0][0] = st.m[0][1] = -CUDART_INF_F;
        st.l[0][0] = st.l[0][1] = 0.f;
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) st.o[g][e] = 0.f;
        st.m[g] = -CUDART_INF_F;
        st.l[g] = 0.f;
      }
    }
    for (int it = 0; it < ntiles; ++it) {
      hopper::mbar_wait(k_full + 8 * stage, phase);
      hopper::mbar_wait(v_full + 8 * stage, phase);
      const int nv = min(TT, hi - lo - it * TT);  // valid tokens
      const int nvw = min(TPW, nv - cw * TPW);    // ... of this warp
      bool zeroed = false;
      if constexpr (TC) {
        // The warp's 16 tokens: S = Q K^T, online softmax, O += P V on
        // mma.sync (paged_attn.cuh's tile step, K and V swizzled).
        if (nvw > 0) {
          const uint32_t kt = k_s + stage * L.tile_bytes;
          const uint32_t vt = v_s + stage * L.tile_bytes;
          const uint32_t qa = base + L.q_off +
                              2 * ((lane & 15) * QS + (lane >> 4) * 8);
          const int tok0 = cw * TPW;
          float sacc[1][2][4];
          paged_attn::qk_tile_at<1, DMAX / 16, 2>(
              sacc, [&](int, int kc) { return qa + 32 * kc; },
              [&](int, int kc) {
                return hopper::swz128(
                    kt, TT, tok0 + (lane & 7) + (lane >> 4) * 8,
                    2 * (kc * 16 + ((lane >> 3) & 1) * 8));
              },
              D);
          if (nvw < TPW) {
            // Tokens past the valid ones: scores -inf by a select, V rows
            // zeroed (the pool may hold NaN there; 0 * NaN is NaN).
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (j * 8 + (lane & 3) * 2 + (e & 1) >= nvw)
                  sacc[0][j][e] = -CUDART_INF_F;
            unsigned char* vg = gbase + (vt - base);
            const int CPR = (D * 2 + 127) / 128 * 8;  // 16-byte chunks a row
            for (int i = lane; i < (TPW - nvw) * CPR; i += 32) {
              const int row = tok0 + nvw + i / CPR, ch = i % CPR;
              *reinterpret_cast<uint4*>(vg + (ch >> 3) * TT * 128 +
                                        row * 128 + (ch & 7) * 16) =
                  make_uint4(0u, 0u, 0u, 0u);
            }
            __syncwarp();
            zeroed = true;
          }
          paged_attn::softmax_tile<1, NT, 2>(sacc, st.o, st.m, st.l, c2);
          paged_attn::pv_tile_at<1, NT, 2>(
              st.o, sacc,
              [&](int kc, int n16) {
                return hopper::swz128(
                    vt, TT, tok0 + kc * 16 + (lane & 7) +
                                ((lane >> 3) & 1) * 8,
                    2 * (n16 * 16 + (lane >> 4) * 8));
              },
              D);
        }
      } else {
        // CUDA cores: a token's q . k over LPT lanes' chunks, the online
        // softmax over the warp's TPW tokens, then P V with a lane owning
        // EPL columns; tokens past the valid ones score -inf and their
        // V rows are never read.
        const unsigned char* kt = gbase + (k_s - base) + stage * L.tile_bytes;
        const unsigned char* vt = gbase + (v_s - base) + stage * L.tile_bytes;
        const float* q_s = reinterpret_cast<const float*>(gbase + L.q_off);
        const int tw = cw * TPW + lane % TPW;
        const int sub = lane / TPW;
        const int nchk = D / VEC;
        float part[GT];
#pragma unroll
        for (int g = 0; g < GT; ++g) part[g] = 0.f;
#pragma unroll
        for (int j = 0; j < MAXC; ++j) {
          const int c = sub + j * LPT;
          if (c < nchk) {
            float kv[VEC];
            load_swz<TT, T>(kt, tw, c * VEC, kv);
#pragma unroll
            for (int g = 0; g < GT; ++g) {
              float qv[VEC];
              load_vec<VEC>(q_s + g * DMAX + c * VEC, qv);
#pragma unroll
              for (int i = 0; i < VEC; ++i)
                part[g] = fmaf(qv[i], kv[i], part[g]);
            }
          }
        }
        const bool ok = tw < nv;
        float pr[GT], alpha[GT];
        bool rescale = false;
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
          const float m_new = fmaxf(st.m[g], mx);
          alpha[g] = st.m[g] == m_new ? 1.f
                     : st.m[g] == -CUDART_INF_F
                         ? 0.f
                         : exp2f((st.m[g] - m_new) * LOG2E);
          rescale |= alpha[g] != 1.f;
          pr[g] = ok ? exp2f((sc - m_new) * LOG2E) : 0.f;
          float sum = pr[g];
#pragma unroll
          for (int off = 1; off < TPW; off <<= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          st.m[g] = m_new;
          st.l[g] = st.l[g] * alpha[g] + sum;
        }
        if (rescale) {
#pragma unroll
          for (int g = 0; g < GT; ++g)
#pragma unroll
            for (int e = 0; e < EPL; ++e) st.o[g][e] *= alpha[g];
        }
        const int e0 = lane * EPL;
#pragma unroll 4
        for (int j = 0; j < nvw; ++j) {
          float pj[GT];
#pragma unroll
          for (int g = 0; g < GT; ++g)
            pj[g] = __shfl_sync(0xffffffffu, pr[g], j);
          if (e0 < D) {
            float vv[EPL];
            load_swz<TT, T>(vt, cw * TPW + j, e0, vv);
#pragma unroll
            for (int g = 0; g < GT; ++g)
#pragma unroll
              for (int e = 0; e < EPL; ++e)
                st.o[g][e] = fmaf(pj[g], vv[e], st.o[g][e]);
          }
        }
      }
      // Generic stores to the slot before the next TMA write of it.
      if (zeroed) hopper::fence_proxy_async();
      hopper::mbar_arrive(kv_empty + 8 * stage);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // The warps' partials, LSE-merged through shared memory
    // ([DW][heads] m, [DW][heads] l, then [DW][heads][D] o), to the
    // outputs (the group's only partial) or to the block's scratch slot
    // b + g ([slot][heads][part_row(D)]).
    float* sm_m = part_s;
    float* sm_l = sm_m + DW * heads;
    float* sm_acc = sm_l + DW * heads;
    if constexpr (TC) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float lr = st.l[0][h];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        const int g = (lane >> 2) + h * 8;
        if (g < ng) {
          if ((lane & 3) == 0) {
            sm_m[cw * heads + g] = st.m[0][h] * scale;  // of scaled scores
            sm_l[cw * heads + g] = lr;
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int col = j * 8 + (lane & 3) * 2;
            if (col < D) {
              sm_acc[(cw * heads + g) * D + col] = st.o[0][j][2 * h];
              sm_acc[(cw * heads + g) * D + col + 1] = st.o[0][j][2 * h + 1];
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        if (g < ng) {
          if (lane == 0) {
            sm_m[cw * heads + g] = st.m[g];
            sm_l[cw * heads + g] = st.l[g];
          }
          if (lane * EPL < D) {
#pragma unroll
            for (int e = 0; e < EPL; ++e)
              sm_acc[(cw * heads + g) * D + lane * EPL + e] = st.o[g][e];
          }
        }
      }
    }
    hopper::named_bar_sync(DEC_BAR, DW * 32);
    const int pfirst = pl.block_of(sg.first);
    const int parts = pl.block_of(sg.end - 1) - pfirst + 1;
    float* po = o + h0 * D;
    float* pm = m_out + h0;
    float* pls = l_out + h0;
    size_t ostride = D, sstride = 1;
    if (parts > 1) {
      po = ws + (static_cast<size_t>(blockIdx.x) + sg.g) * heads * W;
      pm = po + D;
      pls = po + D + 1;
      ostride = sstride = W;
    }
    for (int idx = ct; idx < ng * (D + 1); idx += DW * 32) {
      const int g = idx / (D + 1), d = idx - g * (D + 1);
      float mx = -CUDART_INF_F;
      for (int w = 0; w < DW; ++w) mx = fmaxf(mx, sm_m[w * heads + g]);
      float sum = 0.f;
      if (mx != -CUDART_INF_F) {
        for (int w = 0; w < DW; ++w) {
          const float mw = sm_m[w * heads + g];
          if (mw == -CUDART_INF_F) continue;
          const float x = d < D ? sm_acc[(w * heads + g) * D + d]
                                : sm_l[w * heads + g];
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
    if (parts > 1 &&
        paged_attn::last_split_arrives(tickets + sg.g, parts, cws))
      paged_attn::merge_parts(
          ws, heads * W, pfirst + sg.g, parts, ng, D,
          [h0](int i) { return static_cast<int>(h0) + i; }, o, m_out, l_out,
          part_s, cws);
    p = paged_attn::uniform(min(p1, sg.end));
  }
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

// The rank kernel's arguments.
struct Args {
  const void *q, *pk, *pv, *table, *tail;
  void *o, *m, *l, *ws, *tickets;
  int NR, R, H, K, D, bs, MB;
  long long rank_stride;
  int n_tickets;
  float scale;
};

// The decode kernel's arguments (paged_decode_launch).
struct DecArgs {
  const void *q, *pk, *pv, *table, *tail;
  void *o, *m, *l, *ws, *tickets;
  int R, H, K, D, bs, MB, NB, U, blocks, heads, smem, n_tickets;
  float scale;
};

// Returns cudaErrorInvalidValue unless the plan is one this instantiation
// launches: the unit a positive multiple of its tile, at most its rows of
// heads a block, the caller's shared memory its layout's, a ticket
// counter per group, and blocks of a multiple of 8 tokens (so that every
// box starts on a 1,024-byte swizzle atom).
template <typename T, int DMAX, bool TC, int GT, int MINB>
int launch_units(const DecArgs& a, cudaStream_t stream) {
  constexpr int TT = dec_tile_tokens<T, DMAX, TC>();
  const int G = a.H / a.K;
  const int ngroups = a.heads > 0 ? (G + a.heads - 1) / a.heads : 0;
  const DecLayout L = dec_layout<T, DMAX, TC, GT>(a.D, a.heads, a.R);
  if (a.U < TT || a.U % TT || a.blocks < 1 || a.heads < 1 ||
      a.heads > (TC ? MMA_ROWS : GT) || a.smem != L.smem ||
      L.smem > hopper::max_smem_optin() ||
      static_cast<long>(a.R) * a.K * ngroups > a.n_tickets || a.bs % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  int box_rows = TT;  // gcd(bs, TT): a box never crosses a block
  while (a.bs % box_rows) box_rows >>= 1;
  CUtensorMap tk, tv;
  if (int e = hopper::cached_rows_map(&tk, a.pk, a.D, a.K, a.bs, a.NB,
                                      box_rows, sizeof(T)))
    return e;
  if (int e = hopper::cached_rows_map(&tv, a.pv, a.D, a.K, a.bs, a.NB,
                                      box_rows, sizeof(T)))
    return e;
  auto kern = paged_decode_units_kernel<T, DMAX, TC, GT, MINB>;
  static int allowed[hopper::MAX_DEVICES] = {};
  if (int e = hopper::allow_smem(kern, L.smem, allowed)) return e;
  kern<<<a.blocks, DEC_THREADS, L.smem, stream>>>(
      tk, tv, static_cast<const T*>(a.q), static_cast<const int*>(a.table),
      static_cast<const int*>(a.tail), static_cast<float*>(a.o),
      static_cast<float*>(a.m), static_cast<float*>(a.l),
      static_cast<float*>(a.ws), static_cast<unsigned*>(a.tickets), a.R,
      a.H, a.K, a.D, a.bs, a.MB, a.U, a.heads, box_rows, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// The CUDA-core form (float32): GT, the heads its registers hold, from
// the plan's heads a block (at most 16; 4 at D 256, whose accumulators
// are twice as wide). Two blocks an SM up to 8 heads; 16 heads'
// accumulators take the registers of one.
template <typename T, int DMAX>
int launch_cuda_cores(const DecArgs& a, cudaStream_t s) {
  if (a.heads <= 2) return launch_units<T, DMAX, false, 2, 2>(a, s);
  if (a.heads <= 4) return launch_units<T, DMAX, false, 4, 2>(a, s);
  if constexpr (DMAX <= 128) {
    if (a.heads <= 8) return launch_units<T, DMAX, false, 8, 2>(a, s);
    return launch_units<T, DMAX, false, 16, 1>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

// C entry of the decode kernel: returns cudaGetLastError() after the
// launch (0 = success). dtype: 0 = float32 (CUDA cores), 1 = bfloat16
// (tensor cores); q and both pools share it. Tables [R, MB], tails [R],
// outputs [R, H, ...]; the pools hold NB blocks. The caller plans the
// launch (kernels/micro_attn_decode.py::decode_unit_plan): unit_tokens U,
// persistent blocks, heads_per_block (query heads of one kv head a
// block) and the shared memory that layout takes; ws is a float32
// scratch of blocks + groups slots of heads_per_block * (D + 4) floats
// and tickets n_tickets zeroed uint32 counters, at least one per group
// (R x K x head groups), which the kernel leaves at zero. Any other plan
// returns cudaErrorInvalidValue.
extern "C" int paged_decode_launch(const void* q, const void* pool_k,
                                   const void* pool_v, const void* table,
                                   const void* tail, void* o, void* m,
                                   void* l, void* ws, void* tickets, int R,
                                   int H, int K, int D, int bs, int MB,
                                   int NB, int unit_tokens, int blocks,
                                   int heads_per_block, int smem_bytes,
                                   int n_tickets, float scale, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DecArgs a{q,  pool_k, pool_v, table,      tail,   o,
                  m,  l,      ws,     tickets,    R,      H,
                  K,  D,      bs,     MB,         NB,     unit_tokens,
                  blocks, heads_per_block, smem_bytes, n_tickets, scale};
  if (dtype == 1) {
    if (D <= 128)
      return launch_units<__nv_bfloat16, 128, true, MMA_ROWS, 2>(a, s);
    return launch_units<__nv_bfloat16, 256, true, MMA_ROWS, 1>(a, s);
  }
  if (D <= 128) return launch_cuda_cores<float, 128>(a, s);
  return launch_cuda_cores<float, 256>(a, s);
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
  const Args a{q,  pool_k, pool_v, table, tail,        o,         m,
               l,  ws,     tickets, NR,   R,           H,         K,
               D,  bs,     MB,      rank_stride, n_tickets, scale};
  const RankPlan p{stacked != 0, unit_tokens,    blocks,
                   heads_per_block, smem_bytes, n_tickets};
  if (dtype == 1) return launch_ranks_t<__nv_bfloat16>(a, p, s);
  return launch_ranks_t<float>(a, p, s);
}
