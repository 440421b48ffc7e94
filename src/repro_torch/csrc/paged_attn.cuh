// Helpers shared by the port's attention kernels (paged decode and prefill,
// flash prefill): the bf16 tensor-core tile step of the
// paged kernels (its online softmax and hi + lo split of p also serve the
// wgmma tiles of the flash-prefill and paged prefill-chunk kernels, whose
// accumulator has the same per-warp layout), and the paged kernels' work
// plan (units of valid tokens, planned on the card) and in-launch merge.
//
// Tensor-core tile step (FlashAttention-2 register layout, mma.sync
// m16n8k16 bf16 -> fp32; the decode kernel's). A warp owns MT m16 tiles of
// query rows; q and a K/V tile sit in shared memory, the lanes' ldmatrix
// addresses given by the caller (qk_tile_at, pv_tile_at). A step covers 8
// * NJ keys. qk_tile_at forms S = Q K^T (A and B by ldmatrix);
// softmax_tile runs the online softmax on the S accumulator fragment in
// float32 (exp2 of one fma, scores pre-scaled by scale * log2 e; the
// output accumulators are rescaled only when a row's max moved);
// pv_tile_at reuses the probabilities as the A operand of P V in
// registers, V by ldmatrix.trans. Precision: q K^T products of bf16 values are exact in
// fp32; each float32 probability p enters P V as bf16 hi = bf16(p) plus
// lo = bf16(p - hi), two MMAs against the same bf16 V (at most 2^-16
// relative per term; one rounding of p, 2^-8, misses the kernels'
// tolerances: tests/test_torch_kernels.py); l is summed from the float32
// p. The caller masks scores to -inf between qk_tile_at and softmax_tile.
//
// Work plan and merge, for the ports of the Pallas kernels repro/kernels/
// micro_attn_decode.py (bound by bytes) and micro_attn_prefill.py (bound
// by operations) and of their vmaps over a global pool's ranks: neither
// bound is approached with idle SMs, and where a request's tokens lie is
// known only from its table, on the card. So persistent blocks take equal
// shares of units of valid tokens (plan_units, below), store one partial
// (o, m, l) of paper Eq. 2 a run of one group's units, and the last
// partial of a group to arrive LSE-merges them (paper Eq. 3, merge_parts):
// one launch a call, no second merge kernel, float32 on the CUDA cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace paged_attn {

// The threads that run a merge: the whole block, or a warp-specialised
// kernel's compute warps (whole warps from thread `first`, synchronized
// by named barrier `bar`).
struct BlockThreads {
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return blockDim.x; }
  __device__ void sync() const { __syncthreads(); }
};

struct WarpThreads {
  int first, count, bar;
  __device__ int rank() const { return threadIdx.x - first; }
  __device__ int size() const { return count; }
  __device__ void sync() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(count) : "memory");
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The value of x in lane 0, which the compiler then knows to be uniform
// across the warp: a warp-specialised kernel's loop bounds read from the
// plan in shared memory are not, to it, and ptxas serializes wgmmas in a
// loop it takes for divergent.
__device__ __forceinline__ int uniform(int x) {
  return __shfl_sync(0xffffffffu, x, 0);
}
__device__ __forceinline__ long long uniform(long long x) {
  return __shfl_sync(0xffffffffu, x, 0);
}

// Two bf16 values packed in one 32-bit word, as float32.
__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float& a,
                                              float& b) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  a = f.x;
  b = f.y;
}

// Shared-memory address of p, for ldmatrix and the TMA / mbarrier ops.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------
// bf16 tensor cores: primitives and the tile step.
// ---------------------------------------------------------------------
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The hi and lo bf16 halves of two float32 probabilities, packed for the
// A operand (first value in the low 16 bits): one paired conversion each.
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The float32 probabilities of a score tile as bf16 hi + lo A fragments:
// k16 chunk kc from the n8 chunks 2 kc and 2 kc + 1 (m16n8k16's A).
template <int KV>
__device__ __forceinline__ void split_probs(const float (&s)[2 * KV][4],
                                            uint32_t (&ph)[KV][4],
                                            uint32_t (&pl)[KV][4]) {
#pragma unroll
  for (int kc = 0; kc < KV; ++kc) {
    split_pair(s[2 * kc][0], s[2 * kc][1], ph[kc][0], pl[kc][0]);
    split_pair(s[2 * kc][2], s[2 * kc][3], ph[kc][1], pl[kc][1]);
    split_pair(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[kc][2], pl[kc][2]);
    split_pair(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[kc][3], pl[kc][3]);
  }
}

// The tile step runs on NJ n8 tiles of keys (8 * NJ tokens, NJ even; 8
// covers a whole 64-token tile at once, 4 half of one with half the score
// registers), whose K and V rows start at k_base and v_base.
//
// S = Q K^T: the warp's MT x 16 rows against 8 * NJ tokens (raw scores,
// before the scale). KC: k16 chunks of the instantiation's largest head
// dim; chunks at or past D are skipped. a_at(mt, kc) and b_at(np, kc):
// this lane's ldmatrix address of the A chunk (q rows of m16 tile mt,
// columns 16 kc ..) and of the B chunk (K rows 16 np + (lane & 7) +
// (lane >> 4) * 8, columns 16 kc + ((lane >> 3) & 1) * 8).
template <int MT, int KC, int NJ, typename AAt, typename BAt>
__device__ __forceinline__ void qk_tile_at(float (&sacc)[MT][NJ][4],
                                           AAt a_at, BAt b_at, int D) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      sacc[mt][j][0] = sacc[mt][j][1] = sacc[mt][j][2] = sacc[mt][j][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    if (kc * 16 < D) {
      uint32_t a[MT][4], b[NJ / 2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[mt], a_at(mt, kc));
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) ldmatrix_x4(b[np], b_at(np, kc));
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(sacc[mt][2 * np], a[mt], b[np][0], b[np][1]);
          mma_bf16(sacc[mt][2 * np + 1], a[mt], b[np][2], b[np][3]);
        }
    }
  }
}

// Online softmax on the S fragment: per m16 tile a thread holds rows
// lane/4 (c0, c1) and lane/4 + 8 (c2, c3), tokens j * 8 + (lane % 4) * 2
// + {0, 1}; masked scores are -inf on entry, and 2^-inf = 0. Leaves the
// float32 probabilities 2^((s - m) * c) in sacc, updates the running max
// of the raw scores (m_r) and this thread's share of l (l_r), and sets
// each row's factor alpha for the output accumulators; returns whether
// any of this thread's rows moved its max (after the first tiles it
// rarely does). c = scale * log2 e.
template <int MT, int NJ>
__device__ __forceinline__ bool softmax_scores(float (&sacc)[MT][NJ][4],
                                               float (&m_r)[MT][2],
                                               float (&l_r)[MT][2],
                                               float (&alpha)[MT][2],
                                               float c) {
  bool rescale = false;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sacc[mt][j][0], sacc[mt][j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sacc[mt][j][2], sacc[mt][j][3]));
    }
    float mc[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[mt][h], mx[h]);
      alpha[mt][h] = m_r[mt][h] == m_new ? 1.f
                     : m_r[mt][h] == -CUDART_INF_F
                         ? 0.f
                         : exp2f((m_r[mt][h] - m_new) * c);
      rescale |= alpha[mt][h] != 1.f;
      m_r[mt][h] = m_new;
      mc[h] = m_new == -CUDART_INF_F ? 0.f : m_new * c;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sacc[mt][j][e], c, -mc[e >> 1]));
        sacc[mt][j][e] = p;
        psum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      l_r[mt][h] = l_r[mt][h] * alpha[mt][h] + psum[h];
  }
  return rescale;
}

// The output accumulators' rows times their alpha.
template <int MT, int NT>
__device__ __forceinline__ void rescale_rows(float (&oacc)[MT][NT][4],
                                             const float (&alpha)[MT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      oacc[mt][j][0] *= alpha[mt][0];
      oacc[mt][j][1] *= alpha[mt][0];
      oacc[mt][j][2] *= alpha[mt][1];
      oacc[mt][j][3] *= alpha[mt][1];
    }
}

// softmax_scores, then the output accumulators rescaled where a row of
// the warp moved its max.
template <int MT, int NT, int NJ = 8>
__device__ __forceinline__ void softmax_tile(float (&sacc)[MT][NJ][4],
                                             float (&oacc)[MT][NT][4],
                                             float (&m_r)[MT][2],
                                             float (&l_r)[MT][2], float c) {
  float alpha[MT][2];
  if (__any_sync(0xffffffffu, softmax_scores(sacc, m_r, l_r, alpha, c)))
    rescale_rows(oacc, alpha);
}

// O += P V with P = hi + lo, both bf16, from the S fragment; V fragments
// two column pairs at a time, each feeding MT x 4 products. NT: n8 tiles
// of the instantiation's largest head dim; columns at or past D are
// skipped. v_at(kc, n16): this lane's ldmatrix.trans address of V rows 16
// kc + (lane & 7) + ((lane >> 3) & 1) * 8, columns 16 n16 + (lane >> 4) *
// 8.
template <int MT, int NT, int NJ, typename VAt>
__device__ __forceinline__ void pv_tile_at(float (&oacc)[MT][NT][4],
                                           const float (&sacc)[MT][NJ][4],
                                           VAt v_at, int D) {
#pragma unroll
  for (int kc = 0; kc < NJ / 2; ++kc) {
    uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      split_pair(sacc[mt][2 * kc][0], sacc[mt][2 * kc][1], ph[mt][0],
                 pl[mt][0]);
      split_pair(sacc[mt][2 * kc][2], sacc[mt][2 * kc][3], ph[mt][1],
                 pl[mt][1]);
      split_pair(sacc[mt][2 * kc + 1][0], sacc[mt][2 * kc + 1][1],
                 ph[mt][2], pl[mt][2]);
      split_pair(sacc[mt][2 * kc + 1][2], sacc[mt][2 * kc + 1][3],
                 ph[mt][3], pl[mt][3]);
    }
#pragma unroll
    for (int n0 = 0; n0 < NT / 2; n0 += 2) {
      uint32_t b[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if ((n0 + i) * 16 < D) ldmatrix_x4_trans(b[i], v_at(kc, n0 + i));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if ((n0 + i) * 16 < D) {
          const int n = 2 * (n0 + i);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(oacc[mt][n], ph[mt], b[i][0], b[i][1]);
            mma_bf16(oacc[mt][n + 1], ph[mt], b[i][2], b[i][3]);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(oacc[mt][n], pl[mt], b[i][0], b[i][1]);
            mma_bf16(oacc[mt][n + 1], pl[mt], b[i][2], b[i][3]);
          }
        }
      }
    }
  }
}

// Valid tokens addressed by a -1-padded block table [MB] whose valid slots
// form a prefix (as every table of the serving path does) and whose last
// valid slot holds `tail` tokens. Every thread of the block must call it.
__device__ __forceinline__ int valid_tokens(const int* table, int MB, int bs,
                                            int tail) {
  int nblk = 0;
  for (int base = 0; base < MB; base += blockDim.x) {
    const int j = base + threadIdx.x;
    nblk += __syncthreads_count(j < MB && table[j] >= 0);
  }
  return nblk ? (nblk - 1) * bs + min(max(tail, 0), bs) : 0;
}

// Called by every thread of `th` after it stored its part of a partial of
// a group whose n partials come from n blocks. Returns true in the block
// that stored the group's last partial (its ticket counter is back at 0
// on return), whose threads then see every partial's stores.
template <typename Threads = BlockThreads>
__device__ __forceinline__ bool last_split_arrives(unsigned* ticket, int n,
                                                   Threads th = Threads()) {
  __shared__ int last;
  __threadfence();  // this block's partial is visible device-wide ...
  th.sync();        // ... before its ticket is drawn
  if (th.rank() == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    last = t == static_cast<unsigned>(n - 1);
    if (last) *ticket = 0u;  // every partial has drawn: ready for reuse
  }
  th.sync();
  const bool is_last = last;
  if (is_last) __threadfence();
  return is_last;
}

// Output columns a merge thread takes at once (MERGE_ILP column quads).
constexpr int MERGE_ILP = 8;

// ---------------------------------------------------------------------
// Work in units of valid tokens, planned on the device.
// ---------------------------------------------------------------------
// A paged kernel reads NR rank pools (NR = 1: the single-rank kernels)
// through tables [NR, R, MB] (the prefill chunk: R = 1) whose valid slots
// form a prefix. Pair (rank k,
// request r), index k * R + r, holds S valid tokens, cut into ceil(S / U)
// units of at most U tokens ([j * U, min((j + 1) * U, S))). A merge row
// rho is what one output row merges: the request r = rho over every rank
// (merged), or the pair rho alone (stacked). Each merge row has HG head
// groups (decode: kv head x query-head group; prefill: kv head x tile of
// query rows); merge group g = rho * HG + h holds the units of its pairs,
// rank by rank. The groups' units are numbered one after another (cum[rho]
// is the first unit of merge row rho's groups), T in all, and block b of
// the first B = min(gridDim.x, T) blocks takes units [b * T / B,
// (b + 1) * T / B), none of them empty. So every block
// walks at most ceil(T / B) units, whatever the spread over the ranks,
// and its units are a few runs (segments) of consecutive units of one
// group, each walked with one q tile and one online softmax and stored as
// one partial. The partials of a group come from the consecutive blocks
// [b_of(first unit), b_of(last unit)]; block b stores its partial of
// group g in scratch slot b + g (unique: a block's groups follow the
// previous block's), and the block that draws a group's last ticket
// LSE-merges them. A group with one partial is stored straight to the
// outputs; a group with no unit (no valid token on any of its ranks) is
// written (0, -inf, 0) by block g % B. kernels/rank_units.py is this
// plan in Python, held to its properties by the CPU tests.

// Valid slots of a prefix-contiguous table row [MB], by an L-ary search
// over the L lanes (a power of two <= 32) of one aligned group of a warp:
// each step probes L slots spread over the unknown range and keeps the
// part between the last valid probe and the first invalid one. Every lane
// of the group (mask) must call it; all get the count.
__device__ __forceinline__ int count_valid_slots(const int* row, int MB,
                                                 int L, unsigned mask) {
  const int lane = threadIdx.x & 31;
  const int j = lane % L;
  const int shift = lane - j;  // the group's first lane
  int lo = 0, hi = MB;         // slots < lo valid, slots >= hi not
  while (lo < hi) {
    const long long n = hi - lo;
    auto probe = [&](int i) {
      return lo + static_cast<int>((i + 1) * n / (L + 1));
    };
    const bool ok = row[probe(j)] >= 0;
    const int c = __popc((__ballot_sync(mask, ok) & mask) >> shift);
    if (c == 0) {
      hi = probe(0);
    } else {
      const int nlo = probe(c - 1) + 1;
      if (c < L) hi = probe(c);
      lo = nlo;
    }
  }
  return lo;
}

// The plan in shared memory: S[pair] valid tokens, cum[rho] (P + 1
// entries) first unit of merge row rho; T units in all.
struct UnitPlan {
  const int* S;
  const int* cum;
  int NR, R, U, HG, P, T;
  bool stacked;
  __device__ int rank_lo(int rho) const { return stacked ? rho / R : 0; }
  __device__ int rank_hi(int rho) const { return stacked ? rho / R + 1 : NR; }
  __device__ int request(int rho) const { return stacked ? rho % R : rho; }
  __device__ int units(int pair) const { return (S[pair] + U - 1) / U; }
  // Units of each of merge row rho's groups.
  __device__ int group_units(int rho) const {
    return (cum[rho + 1] - cum[rho]) / HG;
  }
  // Blocks that take units: none takes none.
  __device__ int busy_blocks() const {
    return min(static_cast<int>(gridDim.x), max(T, 1));
  }
  // Units [p0, p1) of block b (empty past the busy blocks).
  __device__ void block_units(int b, long long& p0, long long& p1) const {
    const int B = busy_blocks();
    p0 = b < B ? static_cast<long long>(b) * T / B : 0;
    p1 = b < B ? static_cast<long long>(b + 1) * T / B : 0;
  }
  // The block holding unit p.
  __device__ int block_of(long long p) const {
    return static_cast<int>(((p + 1) * busy_blocks() - 1) / T);
  }
  // Merge row of unit p (< T): the last rho with cum[rho] <= p.
  __device__ int row_of(long long p) const {
    int a = 0, b = P;  // cum[a] <= p < cum[b]
    while (b - a > 1) {
      const int mid = (a + b) >> 1;
      if (cum[mid] <= p) a = mid; else b = mid;
    }
    return a;
  }
};

// Tables of up to SCAN_INT4 16-byte loads a thread (all rows together)
// are counted in one pass of independent loads, each thread adding its
// loads' valid slots to their rows' counts in shared memory: one round
// trip to memory. Larger ones take the L-ary search, log_(L+1)(MB)
// dependent rounds.
constexpr int SCAN_INT4 = 8;

// Halvings of the unit a plan may take (256 tokens down to 16).
constexpr int UNIT_LEVELS = 5;

// Every thread of the block: the valid tokens of every pair (tables
// [NR * R][MB], tails [NR * R]), then the merge rows' first units.
// S: NR * R ints, cum: P + 1 ints of shared memory. min_units > 0 lets
// the card choose the unit from the valid tokens (which the host cannot
// see): U is halved, down to Umin (U / Umin a power of two, at most
// 2^(UNIT_LEVELS - 1)), while the units number fewer than min_units.
__device__ __forceinline__ UnitPlan plan_units(const int* __restrict__ table,
                                               const int* __restrict__ tail,
                                               int NR, int R, int MB, int bs,
                                               int U, int HG, bool stacked,
                                               int* S, int* cum,
                                               int Umin = 0,
                                               long long min_units = 0) {
  const int npair = NR * R;
  const int P = stacked ? npair : R;
  const int lane = threadIdx.x & 31;
  auto tokens = [&](int pair, int nv) {
    return nv ? (nv - 1) * bs + min(max(tail[pair], 0), bs) : 0;
  };
  const long n = static_cast<long>(npair) * MB;
  if (MB >= 4 && n <= 4L * SCAN_INT4 * blockDim.x &&
      (reinterpret_cast<uintptr_t>(table) & 15) == 0) {
    const int n4 = static_cast<int>(n / 4);
    int4 w[SCAN_INT4];
#pragma unroll
    for (int u = 0; u < SCAN_INT4; ++u) {
      const int j = threadIdx.x + u * blockDim.x;
      w[u] = j < n4 ? reinterpret_cast<const int4*>(table)[j]
                    : make_int4(-1, -1, -1, -1);
    }
    for (int i = threadIdx.x; i < npair; i += blockDim.x) S[i] = 0;
    __syncthreads();
#pragma unroll
    for (int u = 0; u < SCAN_INT4; ++u) {
      const int k = 4 * (threadIdx.x + u * blockDim.x);
      if (k >= 4 * n4) break;
      // Four consecutive slots span at most two rows (MB >= 4).
      const int a = k / MB, edge = (a + 1) * MB - k;
      const int v[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
      int ca = 0, cb = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (v[e] >= 0) (e < edge ? ca : cb) += 1;
      }
      if (ca) atomicAdd(S + a, ca);
      if (cb) atomicAdd(S + a + 1, cb);
    }
    if (threadIdx.x == 0)  // the slots past the last whole 16 bytes
      for (long k = 4L * n4; k < n; ++k)
        if (table[k] >= 0) atomicAdd(S + k / MB, 1);
    __syncthreads();
    for (int i = threadIdx.x; i < npair; i += blockDim.x)
      S[i] = tokens(i, S[i]);
  } else {
    int L = 32;  // lanes a pair's search
    while (L > 1 && L * npair > static_cast<int>(blockDim.x)) L >>= 1;
    const unsigned mask =
        L == 32 ? 0xffffffffu : ((1u << L) - 1u) << (lane - lane % L);
    const int per_pass = blockDim.x / L;
    for (int base = 0; base < npair; base += per_pass) {
      const int pair = base + static_cast<int>(threadIdx.x) / L;
      if (pair < npair) {  // the same for the whole lane group
        const int nv = count_valid_slots(
            table + static_cast<size_t>(pair) * MB, MB, L, mask);
        if (lane % L == 0) S[pair] = tokens(pair, nv);
      }
    }
  }
  __syncthreads();
  __shared__ int unit_s;  // the unit warp 0 chose (given min_units)
  if (threadIdx.x < 32) {
    if (min_units > 0 && Umin > 0 && U > Umin) {
      // The units at U, U / 2, ..., Umin, counted over every pair.
      long long n[UNIT_LEVELS] = {};
      for (int i = lane; i < npair; i += 32) {
#pragma unroll
        for (int j = 0; j < UNIT_LEVELS; ++j) {
          const int u = U >> j;
          if (u >= Umin) n[j] += (S[i] + u - 1) / u;
        }
      }
#pragma unroll
      for (int j = 0; j < UNIT_LEVELS; ++j)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          n[j] += __shfl_xor_sync(0xffffffffu, n[j], off);
      for (int j = 0; U > Umin && j + 1 < UNIT_LEVELS && n[j] * HG < min_units;
           ++j)
        U >>= 1;
    }
    if (min_units > 0 && lane == 0) unit_s = U;
    // Warp 0 scans the merge rows' unit counts.
    int carry = 0;
    if (lane == 0) cum[0] = 0;
    for (int base = 0; base < P; base += 32) {
      const int rho = base + lane;
      int t = 0;
      if (rho < P) {
        if (stacked) {
          t = (S[rho] + U - 1) / U;
        } else {
          for (int k = 0; k < NR; ++k) t += (S[k * R + rho] + U - 1) / U;
        }
      }
      t *= HG;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, t, off);
        if (lane >= off) t += y;
      }
      if (rho < P) cum[rho + 1] = carry + t;
      carry += __shfl_sync(0xffffffffu, t, 31);
    }
  }
  __syncthreads();
  if (min_units > 0) U = unit_s;
  return UnitPlan{S, cum, NR, R, U, HG, P, cum[P], stacked};
}

// One segment: a block's run of units [q0, q1) of merge group (rho, h)
// of request r over ranks [klo, khi). The group's units are its ranks'
// units, rank by rank (UnitWalk walks them).
struct Segment {
  int rho, h, g, r, klo, khi, q0, q1;
  long long first, end;  // the group's units [first, end) of all T
};

__device__ __forceinline__ Segment segment_at(const UnitPlan& pl,
                                              long long p, long long p1) {
  Segment s;
  s.rho = pl.row_of(p);
  const int tr = pl.group_units(s.rho);
  const int within = static_cast<int>(p - pl.cum[s.rho]);
  s.h = within / tr;
  s.q0 = within - s.h * tr;
  s.first = pl.cum[s.rho] + static_cast<long long>(s.h) * tr;
  s.end = s.first + tr;
  s.q1 = s.q0 + static_cast<int>(min(p1, s.end) - p);
  s.g = s.rho * pl.HG + s.h;
  s.r = pl.request(s.rho);
  s.klo = pl.rank_lo(s.rho);
  s.khi = pl.rank_hi(s.rho);
  return s;
}

// A segment's units one at a time, rank by rank (the empty ranks
// skipped): unit tokens [t, t + valid()) of rank k. Each thread walks it
// on its own, from the plan in shared memory: no barrier, so
// warp-specialised roles can each keep one.
struct UnitWalk {
  const int* S_;  // the plan's tokens a pair
  int R, U, r, khi, k, t, S;
  __device__ UnitWalk(const UnitPlan& pl, const Segment& s)
      : S_(pl.S), R(pl.R), U(pl.U), r(s.r), khi(s.khi) {
    int off = 0;
    for (k = s.klo; k + 1 < khi; ++k) {
      const int nu = pl.units(k * R + r);
      if (s.q0 < off + nu) break;
      off += nu;
    }
    t = (s.q0 - off) * U;
    S = S_[k * R + r];
  }
  __device__ int valid() const { return min(U, S - t); }
  __device__ void next() {
    t += U;
    while (t >= S && k + 1 < khi) {
      ++k;
      t = 0;
      S = S_[k * R + r];
    }
  }
};

// Scratch rows of the paged kernels: o (D floats), m, l, 2 floats of
// padding, so that every row starts on 16 bytes (D % 8 == 0).
__host__ __device__ constexpr int part_row(int D) { return D + 4; }

// LSE-merge np partials of nrows rows, stored in scratch slots slot0 ..
// slot0 + np - 1 (slot s at ws + s * slot_stride, row i part_row(D)
// floats after row 0: o, then m, then l), into (o, m, l) at out_row(i).
// The scratch is read past L1 (other blocks wrote it in this launch).
// First each row's max m, its m and l (Ls lanes a row: a power of two <=
// 32, up to np, while the block still has threads for every row); then
// o, four columns at a time, MERGE_ILP column quads a thread, over chunks
// of MERGE_CHUNK partials whose weights sit in shared memory (sm: nrows *
// (MERGE_CHUNK + 1) floats).
constexpr int MERGE_CHUNK = 32;

template <typename RowFn, typename Threads = BlockThreads>
__device__ void merge_parts(const float* ws, size_t slot_stride, int slot0,
                            int np, int nrows, int D, RowFn out_row,
                            float* o, float* m_out, float* l_out, float* sm,
                            Threads th = Threads()) {
  const int tid = th.rank(), nthreads = th.size();
  const int W = part_row(D);
  const float* base = ws + static_cast<size_t>(slot0) * slot_stride;
  float* mx_s = sm + nrows * MERGE_CHUNK;
  int Ls = 1;  // lanes a row: enough for np, no more than leave rows idle
  while (Ls < 32 && Ls < np && 2 * Ls * nrows <= nthreads) Ls <<= 1;
  const int sub = tid % Ls;
  const int rows_pass = nthreads / Ls;
  for (int i0 = 0; i0 < nrows; i0 += rows_pass) {
    const int i = i0 + tid / Ls;
    const float* p = base + static_cast<size_t>(i) * W + D;
    float mx = -CUDART_INF_F;
    if (i < nrows)
#pragma unroll 4
      for (int s = sub; s < np; s += Ls)
        mx = fmaxf(mx, __ldcg(p + s * slot_stride));
    for (int off = 1; off < Ls; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float l = 0.f;
    if (i < nrows && mx != -CUDART_INF_F)
#pragma unroll 4
      for (int s = sub; s < np; s += Ls) {
        const float2 ml =
            __ldcg(reinterpret_cast<const float2*>(p + s * slot_stride));
        if (ml.x != -CUDART_INF_F) l = fmaf(ml.y, expf(ml.x - mx), l);
      }
    for (int off = 1; off < Ls; off <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (i < nrows && sub == 0) {
      const size_t row = static_cast<size_t>(out_row(i));
      m_out[row] = mx;
      l_out[row] = l;
      mx_s[i] = mx;
    }
  }
  th.sync();
  // o: element e = (row, column quad); Ts lanes an element split the
  // partials (as many as keep MERGE_ILP elements a thread busy), then
  // sum theirs by shuffles.
  const int quads = D / 4;  // D % 8 == 0
  const int total = nrows * quads;
  int Ts = 1;
  while (Ts < 32 && Ts < np && 2 * Ts * total <= MERGE_ILP * nthreads)
    Ts <<= 1;
  const int epass = nthreads / Ts;  // elements a pass, an ILP slot
  const int esub = tid % Ts, e0 = tid / Ts;
  for (int c0 = 0; c0 < np; c0 += MERGE_CHUNK) {
    const int nc = min(MERGE_CHUNK, np - c0);
    for (int idx = tid; idx < nrows * nc; idx += nthreads) {
      const int i = idx / nc, s = idx - i * nc;
      const float ms = __ldcg(base + (c0 + s) * slot_stride +
                              static_cast<size_t>(i) * W + D);
      sm[i * MERGE_CHUNK + s] =
          ms == -CUDART_INF_F ? 0.f : expf(ms - mx_s[i]);
    }
    th.sync();
    const float* cb = base + c0 * slot_stride;
    for (int b0 = 0; b0 < total; b0 += MERGE_ILP * epass) {
      int off[MERGE_ILP], wrow[MERGE_ILP];
      float4 acc[MERGE_ILP];
#pragma unroll
      for (int u = 0; u < MERGE_ILP; ++u) {
        const int idx = min(b0 + e0 + u * epass, total - 1);
        const int i = idx / quads;
        off[u] = i * W + 4 * (idx - i * quads);
        wrow[u] = i * MERGE_CHUNK;
        acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll 2
      for (int s = esub; s < nc; s += Ts) {
        const float* p = cb + s * slot_stride;
#pragma unroll
        for (int u = 0; u < MERGE_ILP; ++u) {
          const float4 x =
              __ldcg(reinterpret_cast<const float4*>(p + off[u]));
          const float w = sm[wrow[u] + s];
          acc[u].x = fmaf(x.x, w, acc[u].x);
          acc[u].y = fmaf(x.y, w, acc[u].y);
          acc[u].z = fmaf(x.z, w, acc[u].z);
          acc[u].w = fmaf(x.w, w, acc[u].w);
        }
      }
      for (int sh = 1; sh < Ts; sh <<= 1) {
#pragma unroll
        for (int u = 0; u < MERGE_ILP; ++u) {
          acc[u].x += __shfl_xor_sync(0xffffffffu, acc[u].x, sh);
          acc[u].y += __shfl_xor_sync(0xffffffffu, acc[u].y, sh);
          acc[u].z += __shfl_xor_sync(0xffffffffu, acc[u].z, sh);
          acc[u].w += __shfl_xor_sync(0xffffffffu, acc[u].w, sh);
        }
      }
      if (esub == 0) {
#pragma unroll
        for (int u = 0; u < MERGE_ILP; ++u) {
          const int idx = b0 + e0 + u * epass;
          if (idx >= total) break;
          const int i = idx / quads;
          float4* dst = reinterpret_cast<float4*>(
              o + static_cast<size_t>(out_row(i)) * D + 4 * (idx - i * quads));
          if (c0 > 0) {
            const float4 prev = *dst;
            acc[u].x += prev.x;
            acc[u].y += prev.y;
            acc[u].z += prev.z;
            acc[u].w += prev.w;
          }
          *dst = acc[u];
        }
      }
    }
    th.sync();
  }
}

}  // namespace paged_attn
