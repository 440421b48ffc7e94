// Paged DistAttention MicroAttention partial, decode (paper Eq. 2).
//
// Replaces the Pallas TPU kernel repro/kernels/micro_attn_decode.py::
// paged_micro_attention_kernel (body _kernel), and its vmap over the rank
// axis (repro/kernels/ops.py::paged_micro_attention_ranks). One query
// token per request [R, H, D] attends over NR rank pools [NB, bs, K, D]
// (slabs rank_stride elements apart: a per-layer view of the global pool
// [NR, L, NB, bs, K, D], read in place, never copied; NR = 1 and rank
// stride 0 for the single-rank form), each through the request's own
// -1-padded block table (tables [NR, R, MB], tails [NR, R]); only a
// table's last valid slot is partial (its tail tokens). Output:
// unnormalized o and m, l, float32, one partial a (rank, request) [NR, R,
// H, ...] (stacked) or one a request over every rank [R, H, ...] (merged,
// what the global pool's steps take; the single-rank form is merged at NR
// = 1); a row with no valid token gives (0, -inf, 0).
//
// Bound on the H100: HBM bytes. A call reads every valid K/V row of every
// rank once, S * K * D * 2 * itemsize bytes (S: the valid tokens of every
// pair), against 4 * G FLOPs per K/V element (G = H / K), below the card's
// ~295 FLOP/byte ridge at every served G. At the qwen3 path's single-rank
// main shape (R=8, S~4,090 each, K=8, D=128, bf16) that is 134 MB, 0.040
// ms at 3.35 TB/s; at the qwen2-moe global path's (MHA 16 x 128, three
// ranks, ~4,600 tokens in all) 38 MB, 0.011 ms. What keeps a kernel from
// it: bytes in flight on every SM (the loads of a token depend on its
// table entry), work spread over the requests' valid tokens on every rank
// (known only from the tables, on the card), and, at large G, the math
// per byte.
//
// One kernel a dtype serves both forms: paged_decode_units_kernel, built
// for Hopper.
// - Work: persistent blocks (2 an SM; 1 where the shared memory or the
//   registers allow no more; 3 on the CUDA cores at one head a block, on
//   a 2-stage ring) take equal shares of units of at most U = 256 valid
//   tokens of each (rank, request) pair, planned on the card from the
//   tables (paged_attn.cuh's plan_units over NR ranks: an L-ary search or
//   one scan of each prefix-contiguous table, no host read). A short
//   request's tokens are a few units and an empty pair none, so no block
//   walks the longest table's width. A rank table is sized for the whole
//   request but holds one rank's share, so the rank forms may let the
//   card halve U, down to a tile, while the valid tokens make fewer units
//   than the plan's min_units (kernels/micro_attn_decode.py::
//   rank_decode_plan says when). A merge group is (merge row, kv head,
//   head group); its units are its ranks' units, rank by rank. A block
//   stores one partial a run of one group's units; the last partial of a
//   group to arrive LSE-merges them (merge_parts, a ticket counter a
//   group): the rank merge happens there too. One launch a call.
// - A group holds every query head of a kv head, up to 16 (the rank
//   forms on the CUDA cores: 4), so each K/V byte crosses HBM and shared
//   memory once however large G is.
// - Loads: warp 0 issues TMA loads (hopper.cuh) of 5-D maps over the rank
//   pools [NR][NB][bs][K][D] (any rank stride a multiple of 16 bytes,
//   encoded once a view: hopper::cached_rows_map, shared with the prefill
//   kernels' maps of the same view), one box a table block's share of a
//   tile (gcd(bs, TT) tokens by 128 bytes of one kv head's columns of one
//   rank, 128-byte swizzle), into a ring of 3 tiles of K and V (2 where a
//   tile is 32 KB or a block holds one head on the CUDA cores), mbarrier
//   full / empty handshakes. It walks a
//   segment's units rank by rank (paged_attn::UnitWalk), resolves each box
//   from that rank's table row, and writes each ring stage's valid tokens
//   (and whether the tile ends the segment) to shared memory before the
//   stage's loads: the compute warps read it after the stage's wait and
//   keep no walk of their own (one costs registers). Four compute warps
//   take a quarter of each tile's tokens.
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
//   output columns; GT (1, 2, 4, 8 or 16 >= the heads a block) query heads
//   share each K/V chunk read. Precision: float32 throughout (q, K and V
//   upcast, the probabilities never rounded), as the Pallas kernel.
// - Every tile that ends a unit may be partial (a unit ends at its pair's
//   last valid token, inside a segment when the segment goes on to the
//   next rank): its tokens past the valid ones (stale rows of the last
//   block, or rows never loaded) score -inf by a select; the CUDA cores
//   never read their V rows, the tensor cores zero them in shared memory
//   first (0 * NaN is NaN inside an MMA).
// - The compute warps' partials are LSE-merged through shared memory,
//   then stored to the outputs (a group's only partial) or to the
//   block's scratch slot.
// exp is taken as exp2 of a float32 product with log2(e) (2-ulp exp2, a
// relative error near 1e-6 at most).
#include <type_traits>

#include "hopper.cuh"
#include "paged_attn.cuh"

namespace {

using paged_attn::LOG2E;
using paged_attn::smem_addr;

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

constexpr int LAST = 1 << 30;                // a stage's tag: ends a segment

// Tokens a K/V tile: 64 on the tensor cores (16 a compute warp); on the
// CUDA cores by row size, 64 rows of up to 256 bytes, 32 of up to 512, 16
// of up to 1 KB (a tile stays at most 16 KB).
template <typename T, int DMAX, bool TC>
__host__ __device__ constexpr int dec_tile_tokens() {
  return TC || DMAX * sizeof(T) <= 256 ? 64
         : DMAX * sizeof(T) <= 512     ? 32
                                       : 16;
}

// Ring depth: 3 tiles of K and V (96 KB), 2 where a tile is 32 KB, and 2
// on the CUDA cores at one head a block (GT 1), whose blocks fit 3 an SM.
template <typename T, int DMAX, bool TC, int GT>
__host__ __device__ constexpr int dec_stages() {
  return dec_tile_tokens<T, DMAX, TC>() * DMAX * sizeof(T) > 16384 ||
                 (!TC && GT == 1)
             ? 2
             : 3;
}

// Shared memory: the ring (K tiles, then V tiles, each the 128-byte boxes
// of D's columns by TT rows), its barriers (3 a stage) and each stage's
// tag (its valid tokens, | LAST where the tile ends a segment), q (tensor
// cores: 16 bf16 rows of DMAX + 8; CUDA cores: GT float32 rows of DMAX),
// the compute warps' partials of `heads` rows (DW x heads x (D + 2)
// floats; reused by the group merge) and the plan (the npair pairs' valid
// tokens and the P merge rows' first units, P + 1 ints); 1,024 bytes of
// slack align the ring.
struct DecLayout {
  int tile_bytes, stages, bar_off, tag_off, q_off, part_off, plan_off, smem;
};

template <typename T, int DMAX, bool TC, int GT>
__host__ __device__ inline DecLayout dec_layout(int D, int heads, int npair,
                                                int P) {
  DecLayout L;
  L.tile_bytes = dec_tile_tokens<T, DMAX, TC>() *
                 ((D * static_cast<int>(sizeof(T)) + 127) / 128) * 128;
  L.stages = dec_stages<T, DMAX, TC, GT>();
  L.bar_off = 2 * L.stages * L.tile_bytes;
  L.tag_off = L.bar_off + 24 * L.stages;
  L.q_off = L.bar_off + ((28 * L.stages + 15) / 16) * 16;
  const int q_bytes = TC ? MMA_ROWS * (DMAX + 8) * 2
                         : GT * DMAX * static_cast<int>(sizeof(float));
  L.part_off = L.q_off + q_bytes;
  L.plan_off = L.part_off + DW * heads * (D + 2) * 4;
  L.smem = 1024 + L.plan_off + 4 * (npair + P + 1);
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
// else the CUDA-core form with GT >= `heads` query heads a block. The 5-D
// maps read the NR rank pools in boxes of 128 bytes of one kv head's
// columns by box_rows tokens of one block of one rank.
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
                              unsigned* __restrict__ tickets, int NR, int R,
                              int H, int K, int D, int bs, int MB, int U,
                              int min_units, int stacked, int heads,
                              int box_rows, float scale) {
  constexpr int TT = dec_tile_tokens<T, DMAX, TC>();
  constexpr int STAGES = dec_stages<T, DMAX, TC, GT>();
  constexpr int EB = 128 / static_cast<int>(sizeof(T));  // elements a box
  const int npair = NR * R;
  const DecLayout L =
      dec_layout<T, DMAX, TC, GT>(D, heads, npair, stacked ? npair : R);
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
  // Each stage's tag, written by the producer before the stage's loads
  // (its arrive releases it to the compute warps' wait on the stage).
  int* tag_s = reinterpret_cast<int*>(gbase + L.tag_off);
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
  // plan_units' first __syncthreads also publishes the barriers. The
  // unit is U, or, given min_units, U halved down to a tile while the
  // valid tokens make fewer units.
  const paged_attn::UnitPlan pl = paged_attn::plan_units(
      table, tail, NR, R, MB, bs, U, K * ngroups, stacked != 0, plan_s,
      plan_s + npair, TT, min_units);
  // Head group h's first head (a merge row's output rows and a request's
  // q rows start at row * H + it).
  auto first_head = [&](int h, int& ng) {
    const int kh = h / ngroups, g0 = (h - kh * ngroups) * heads;
    ng = min(heads, G - g0);
    return kh * G + g0;
  };
  // Groups of a merge row with no valid token: (0, -inf, 0).
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
      paged_attn::UnitWalk w(pl, sg);
      for (int u = sg.q0; u < sg.q1; ++u, w.next()) {
        // The unit's tiles in its rank's pool, through its table row.
        const int* tab = table + (static_cast<size_t>(w.k) * R + sg.r) * MB;
        const int hi = w.t + w.valid();
        for (int t0 = w.t; t0 < hi; t0 += TT) {
          const int nv = min(TT, hi - t0);
          const int nb = (nv + box_rows - 1) / box_rows;
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
            tag_s[stage] = nv | (u + 1 == sg.q1 && t0 + TT >= hi ? LAST : 0);
            hopper::mbar_expect_tx(kf, nb * box_bytes * ncb);
            hopper::mbar_expect_tx(vf, nb * box_bytes * ncb);
          }
          __syncwarp();
          if (lane < nb) {
            const uint32_t at = stage * L.tile_bytes + lane * box_bytes;
            for (int c = 0; c < ncb; ++c) {
              hopper::tma_load_5d(k_s + at + c * TT * 128, &tm_k, kf,
                                  c * EB, kh, off, blk, w.k);
              hopper::tma_load_5d(v_s + at + c * TT * 128, &tm_v, vf,
                                  c * EB, kh, off, blk, w.k);
            }
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
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
    const size_t h0 = static_cast<size_t>(sg.rho) * H + hoff;  // outputs
    const size_t hq = static_cast<size_t>(sg.r) * H + hoff;    // q rows
    // q rows of the group (zero past its heads and past D).
    if constexpr (TC) {
      __nv_bfloat16* q_s =
          reinterpret_cast<__nv_bfloat16*>(gbase + L.q_off);
      for (int idx = ct; idx < MMA_ROWS * (DMAX / 8); idx += DW * 32) {
        const int row = idx / (DMAX / 8), col = (idx - row * (DMAX / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row < ng && col < D)
          v = *reinterpret_cast<const uint4*>(q + (hq + row) * D + col);
        *reinterpret_cast<uint4*>(q_s + row * QS + col) = v;
      }
    } else {
      float* q_s = reinterpret_cast<float*>(gbase + L.q_off);
      for (int i = ct; i < GT * DMAX; i += DW * 32) {
        const int g = i / DMAX, d = i - g * DMAX;
        q_s[i] = g < ng && d < D ? paged_attn::to_f32(q[(hq + g) * D + d])
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
    // The segment's tiles, as the producer tagged them.
    for (bool more = true; more;) {
      hopper::mbar_wait(k_full + 8 * stage, phase);
      hopper::mbar_wait(v_full + 8 * stage, phase);
      const int tag = paged_attn::uniform(tag_s[stage]);
      more = !(tag & LAST);
      const int nv = tag & (LAST - 1);          // valid tokens
      const int nvw = min(TPW, nv - cw * TPW);  // ... of this warp
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

// The C entry's arguments: pointers, shapes (NR rank pools of NB blocks
// of bs tokens, rank_stride elements apart), the output form and the
// caller's plan.
struct DecArgs {
  const void *q, *pk, *pv, *table, *tail;
  void *o, *m, *l, *ws, *tickets;
  int NR, R, H, K, D, bs, MB, NB;
  long long rank_stride;
  int stacked, U, min_units, blocks, heads, smem, n_tickets;
  float scale;
  cudaStream_t stream;
};

// Returns cudaErrorInvalidValue unless the plan is one this instantiation
// launches: at least one rank, the unit a tile times a power of two (at
// most 16), at most its rows of heads a block, the caller's shared memory its
// layout's, a ticket counter per merge group (R or NR x R merge rows x K
// x head groups), and blocks of a multiple of 8 tokens (so that every box
// starts on a 1,024-byte swizzle atom).
template <typename T, int DMAX, bool TC, int GT, int MINB>
int launch_units(const DecArgs& a) {
  constexpr int TT = dec_tile_tokens<T, DMAX, TC>();
  const int G = a.H / a.K;
  const int ngroups = a.heads > 0 ? (G + a.heads - 1) / a.heads : 0;
  const int npair = a.NR * a.R;
  const int P = a.stacked ? npair : a.R;
  const DecLayout L = dec_layout<T, DMAX, TC, GT>(a.D, a.heads, npair, P);
  if (a.NR < 1 || a.U < TT || a.U % TT || a.U > TT << 4 ||
      (a.U & (a.U - 1)) || a.min_units < 0 || a.blocks < 1 || a.heads < 1 ||
      a.heads > (TC ? MMA_ROWS : GT) || a.smem != L.smem ||
      L.smem > hopper::max_smem_optin() ||
      static_cast<long>(P) * a.K * ngroups > a.n_tickets || a.bs % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  int box_rows = TT;  // gcd(bs, TT): a box never crosses a block
  while (a.bs % box_rows) box_rows >>= 1;
  CUtensorMap tk, tv;
  if (int e = hopper::cached_rows_map(&tk, a.pk, a.D, a.K, a.bs, a.NB,
                                      box_rows, sizeof(T), a.NR,
                                      a.rank_stride))
    return e;
  if (int e = hopper::cached_rows_map(&tv, a.pv, a.D, a.K, a.bs, a.NB,
                                      box_rows, sizeof(T), a.NR,
                                      a.rank_stride))
    return e;
  auto kern = paged_decode_units_kernel<T, DMAX, TC, GT, MINB>;
  static int allowed[hopper::MAX_DEVICES] = {};
  if (int e = hopper::allow_smem(kern, L.smem, allowed)) return e;
  kern<<<a.blocks, DEC_THREADS, L.smem, a.stream>>>(
      tk, tv, static_cast<const T*>(a.q), static_cast<const int*>(a.table),
      static_cast<const int*>(a.tail), static_cast<float*>(a.o),
      static_cast<float*>(a.m), static_cast<float*>(a.l),
      static_cast<float*>(a.ws), static_cast<unsigned*>(a.tickets), a.NR,
      a.R, a.H, a.K, a.D, a.bs, a.MB, a.U, a.min_units, a.stacked, a.heads,
      box_rows, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// The CUDA-core form (float32): GT, the heads its registers hold, from
// the plan's heads a block (at most 16; 4 at D 256, whose accumulators
// are twice as wide). Three blocks an SM at one head (a 2-stage ring),
// two up to 8 heads; 16 heads' accumulators take the registers of one.
template <typename T, int DMAX>
int launch_cuda_cores(const DecArgs& a) {
  if (a.heads <= 1) return launch_units<T, DMAX, false, 1, 3>(a);
  if (a.heads <= 2) return launch_units<T, DMAX, false, 2, 2>(a);
  if (a.heads <= 4) return launch_units<T, DMAX, false, 4, 2>(a);
  if constexpr (DMAX <= 128) {
    if (a.heads <= 8) return launch_units<T, DMAX, false, 8, 2>(a);
    return launch_units<T, DMAX, false, 16, 1>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry of the decode kernel, both forms: returns cudaGetLastError()
// after the launch (0 = success). NR rank pools [NB, bs, K, D] start
// rank_stride elements apart (a multiple of 16 bytes; 0: packed); tables
// [NR, R, MB], tails [NR, R]; q [R, H, D] shared by every rank. dtype: 0 =
// float32 (CUDA cores), 1 = bfloat16 (tensor cores); q and both pools
// share it. stacked = 0: one partial a request over every rank, outputs
// [R, H, ...] (the single-rank form: NR 1, rank stride 0); stacked = 1:
// one a (rank, request), outputs [NR, R, H, ...]. The caller plans the
// launch (kernels/micro_attn_decode.py::decode_unit_plan): unit_tokens U
// (min_units > 0: the kernel halves it, down to a tile, while the valid
// tokens make fewer units), persistent blocks, heads_per_block (query
// heads of one kv head a block) and the shared memory that layout takes;
// ws is a float32 scratch of blocks + groups slots of heads_per_block * (D
// + 4) floats and tickets n_tickets zeroed uint32 counters, at least one
// per merge group (R or NR x R, times K x head groups), which the kernel
// leaves at zero. Any other plan, or NR < 1, returns
// cudaErrorInvalidValue.
extern "C" int paged_decode_launch(
    const void* q, const void* pool_k, const void* pool_v, const void* table,
    const void* tail, void* o, void* m, void* l, void* ws, void* tickets,
    int NR, int R, int H, int K, int D, int bs, int MB, int NB,
    long long rank_stride, int stacked, int unit_tokens, int min_units,
    int blocks, int heads_per_block, int smem_bytes, int n_tickets,
    float scale, int dtype, void* stream) {
  const DecArgs a{q,       pool_k,      pool_v,   table,      tail,
                  o,       m,           l,        ws,         tickets,
                  NR,      R,           H,        K,          D,
                  bs,      MB,          NB,       rank_stride, stacked != 0,
                  unit_tokens, min_units, blocks, heads_per_block,
                  smem_bytes, n_tickets, scale,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == 1) {
    if (D <= 128) return launch_units<__nv_bfloat16, 128, true, MMA_ROWS, 2>(a);
    return launch_units<__nv_bfloat16, 256, true, MMA_ROWS, 1>(a);
  }
  if (D <= 128) return launch_cuda_cores<float, 128>(a);
  return launch_cuda_cores<float, 256>(a);
}
