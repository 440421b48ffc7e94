// Helpers shared by the port's attention kernels (paged decode and prefill,
// flash prefill): cp.async copies, the bf16 tensor-core tile step of the
// paged prefill-chunk and flash-prefill kernels, and the split-KV merge of
// the two paged kernels.
//
// Tensor-core tile step (FlashAttention-2 register layout, mma.sync
// m16n8k16 bf16 -> fp32). A warp owns MT m16 tiles of query rows; q and a
// 64-token K/V tile (MMA_TOKENS) sit in shared memory, rows row_stride(D)
// elements apart; a step takes the whole tile or half of it. qk_tile
// forms S = Q K^T (A and B by ldmatrix); softmax_tile runs the online
// softmax on the S accumulator fragment in float32 (exp2 of one fma,
// scores pre-scaled by scale * log2 e; the output accumulators are
// rescaled only when a row's max moved); pv_tile reuses the
// probabilities as the A operand of P V in registers, V by
// ldmatrix.trans. Precision: q K^T products of bf16 values are exact in
// fp32; each float32 probability p enters P V as bf16 hi = bf16(p) plus
// lo = bf16(p - hi), two MMAs against the same bf16 V (at most 2^-16
// relative per term; one rounding of p, 2^-8, misses the kernels'
// tolerances: tests/test_torch_kernels.py); l is summed from the float32
// p. The caller masks scores to -inf between qk_tile and softmax_tile.
//
// Split-KV, for the ports of the Pallas kernels repro/kernels/
// micro_attn_decode.py (bound by bytes) and micro_attn_prefill.py (bound
// by operations): neither bound is approached with idle SMs, and a
// (request or row tile, kv head) grid leaves most of 132 SMs idle at the
// serving path's shapes. So a paged kernel splits each work item's slot
// range [0, MB) into nsplit contiguous runs of whole table slots, the
// grid's z axis (the wrapper plans them from shapes alone: kernels/
// micro_attn_decode.py::plan_splits). Every split's block computes the
// unnormalized float32 partial (o, m, l) of its run (paper Eq. 2) and
// stores it in a scratch ws[split][out_row][D + 2] (o, then m, then l);
// a split that starts past the valid tokens stores (0, -inf, 0) and reads
// no K/V. Then it takes a ticket from a per-work-item counter after
// __threadfence(): the block that draws the last ticket resets the
// counter to 0 for the next launch and LSE-merges all nsplit partials
// (paper Eq. 3) into the contract's (o, m, l). One launch per call: no
// second merge kernel. The merge is float32 on the CUDA cores, in split
// order, so it adds only float32 rounding to the partials it combines.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace paged_attn {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Two bf16 values packed in one 32-bit word, as float32.
__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float& a,
                                              float& b) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  a = f.x;
  b = f.y;
}

// Shared-memory address of p, for cp.async and ldmatrix.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes when src_bytes == 0.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------
// bf16 tensor cores: primitives and the tile step.
// ---------------------------------------------------------------------
constexpr int MMA_TOKENS = 64;  // K/V tokens a tile of the tile step
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory row stride (elements) for head dim D: D rounded up to 16,
// plus 8 so that ldmatrix's 8 row addresses fall in distinct banks.
__host__ __device__ inline int row_stride(int D) {
  return ((D + 15) / 16) * 16 + 8;
}

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

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo_elem,
                                              __nv_bfloat16 hi_elem) {
  __nv_bfloat162 v;
  v.x = lo_elem;
  v.y = hi_elem;
  return *reinterpret_cast<uint32_t*>(&v);
}

// The hi and lo bf16 halves of two float32 probabilities, packed for the
// A operand (first value in the low 16 bits).
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 ha = __float2bfloat16_rn(a);
  const __nv_bfloat16 hb = __float2bfloat16_rn(b);
  hi = pack_bf16(ha, hb);
  lo = pack_bf16(__float2bfloat16_rn(a - __bfloat162float(ha)),
                 __float2bfloat16_rn(b - __bfloat162float(hb)));
}

// ldmatrix lane offsets (elements within a tile) of a warp whose rows
// start at wrow: the A operand (q), the B operand of Q K^T (K rows) and
// of P V (V rows, transposed).
struct MmaLanes {
  int a, k, v;
};

__device__ __forceinline__ MmaLanes mma_lanes(int lane, int wrow, int DS) {
  return {(wrow + (lane & 15)) * DS + (lane >> 4) * 8,
          ((lane & 7) + (lane >> 4) * 8) * DS + ((lane >> 3) & 1) * 8,
          ((lane & 7) + ((lane >> 3) & 1) * 8) * DS + (lane >> 4) * 8};
}

// The tile step runs on NJ n8 tiles of keys (8 * NJ tokens, NJ even; 8
// covers a whole 64-token tile at once, 4 half of one with half the score
// registers), whose K and V rows start at k_base and v_base.
//
// S = Q K^T: the warp's MT x 16 rows against 8 * NJ tokens (raw scores,
// before the scale). KC: k16 chunks of the instantiation's largest head
// dim; chunks at or past D are skipped.
template <int MT, int KC, int NJ = 8>
__device__ __forceinline__ void qk_tile(float (&sacc)[MT][NJ][4],
                                        uint32_t q_base, uint32_t k_base,
                                        const MmaLanes& ln, int DS, int D) {
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
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], q_base + 2 * (ln.a + mt * 16 * DS + kc * 16));
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np)
        ldmatrix_x4(b[np], k_base + 2 * (ln.k + np * 16 * DS + kc * 16));
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
// of the raw scores (m_r) and this thread's share of l (l_r), and
// rescales the output accumulators where a row's max moved (after the
// first tiles it rarely does). c = scale * log2 e.
template <int MT, int NT, int NJ = 8>
__device__ __forceinline__ void softmax_tile(float (&sacc)[MT][NJ][4],
                                             float (&oacc)[MT][NT][4],
                                             float (&m_r)[MT][2],
                                             float (&l_r)[MT][2], float c) {
  bool rescale = false;
  float alpha[MT][2];
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
  if (__any_sync(0xffffffffu, rescale)) {
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
}

// O += P V with P = hi + lo, both bf16, from the S fragment; V fragments
// two column pairs at a time, each feeding MT x 4 products. NT: n8 tiles
// of the instantiation's largest head dim; columns at or past D are
// skipped.
template <int MT, int NT, int NJ = 8>
__device__ __forceinline__ void pv_tile(float (&oacc)[MT][NT][4],
                                        const float (&sacc)[MT][NJ][4],
                                        uint32_t v_base, const MmaLanes& ln,
                                        int DS, int D) {
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
        if ((n0 + i) * 16 < D)
          ldmatrix_x4_trans(b[i], v_base + 2 * (ln.v + kc * 16 * DS +
                                                (n0 + i) * 16));
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

// Split-KV: called by every thread of a block after it stored its split's
// partial in the scratch. Returns true in the block that finished last
// for this work item (its ticket counter is back at 0 on return), whose
// threads then see every split's stores.
__device__ __forceinline__ bool last_split_arrives(unsigned* ticket,
                                                   int nsplit) {
  __shared__ int last;
  __threadfence();  // this block's partial is visible device-wide ...
  __syncthreads();  // ... before its ticket is drawn
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    last = t == static_cast<unsigned>(nsplit - 1);
    if (last) *ticket = 0u;  // every split has drawn: ready for reuse
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Split-KV: copy the split's table slots [s0, s0 + ns) to shared memory
// (tab_s) and return how many of the request's valid tokens they hold.
// Tables are prefix-contiguous with `tail` tokens in the last valid slot,
// so the split holds that slot iff one of its slots is -1 or the slot
// after it is. Every thread of the block must call it.
__device__ __forceinline__ int load_split_slots(const int* table, int MB,
                                                int s0, int ns, int bs,
                                                int tail, int* tab_s) {
  int n = 0;
  for (int base = 0; base < ns; base += blockDim.x) {
    const int i = base + threadIdx.x;
    int blk = -1;
    if (i < ns) {
      blk = table[s0 + i];
      tab_s[i] = blk;
    }
    n += __syncthreads_count(blk >= 0);
  }
  if (n == 0) return 0;
  const bool last_here = n < ns || s0 + ns >= MB || table[s0 + ns] < 0;
  return (n - 1) * bs + (last_here ? min(max(tail, 0), bs) : bs);
}

// Split-KV: LSE-merge nsplit (<= MAX_SPLITS) partials of `nrows` rows into
// (o, m, l). Row i of the work item lives at out_row(i) in the outputs and
// in every split's slice of the scratch ws ([nsplit][rows_total][D + 2];
// slices split_stride floats apart). The scratch is read past L1
// (__ldcg): other blocks wrote it during this launch. First each row's
// merged max, m, l and split weights exp(m_s - m) (into wsm, nrows *
// nsplit floats of shared memory); then o, two columns at a time, with
// MERGE_ILP column pairs of four splits in flight a thread, so the merge
// costs a few L2 round trips rather than one per column and split.
constexpr int MAX_SPLITS = 32;
constexpr int MERGE_ILP = 8;

template <typename RowFn>
__device__ void merge_splits(const float* ws, size_t split_stride,
                             int nsplit, int nrows, int D, RowFn out_row,
                             float* o, float* m_out, float* l_out,
                             float* wsm) {
  const size_t W = static_cast<size_t>(D) + 2;
  for (int i = threadIdx.x; i < nrows; i += blockDim.x) {
    const size_t row = static_cast<size_t>(out_row(i));
    const float* p = ws + row * W + D;
    float ms[MAX_SPLITS];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (s < nsplit) {
        ms[s] = __ldcg(p + s * split_stride);
        mx = fmaxf(mx, ms[s]);
      }
    }
    float l = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (s < nsplit) {
        const float w = ms[s] == -CUDART_INF_F ? 0.f : expf(ms[s] - mx);
        wsm[i * nsplit + s] = w;
        if (w != 0.f) l = fmaf(__ldcg(p + s * split_stride + 1), w, l);
      }
    }
    m_out[row] = mx;
    l_out[row] = l;
  }
  __syncthreads();
  const int pairs = D / 2;  // D is even
  const int total = nrows * pairs;
  for (int base = threadIdx.x; base < total;
       base += MERGE_ILP * blockDim.x) {
    // Offsets within one split's slice and within o (< 2^31 floats).
    int off[MERGE_ILP], out[MERGE_ILP], wrow[MERGE_ILP];
    float2 acc[MERGE_ILP];
#pragma unroll
    for (int u = 0; u < MERGE_ILP; ++u) {
      const int idx = min(base + u * static_cast<int>(blockDim.x),
                          total - 1);
      const int i = idx / pairs, c = 2 * (idx - i * pairs);
      const int row = out_row(i);
      off[u] = row * (D + 2) + c;  // the column pair in a split's slice
      out[u] = row * D + c;        // the column pair in o
      wrow[u] = i * nsplit;
      acc[u] = make_float2(0.f, 0.f);
    }
#pragma unroll 4
    for (int s = 0; s < nsplit; ++s) {
      const float* p = ws + s * split_stride;
#pragma unroll
      for (int u = 0; u < MERGE_ILP; ++u) {
        const float2 x = __ldcg(reinterpret_cast<const float2*>(p + off[u]));
        const float w = wsm[wrow[u] + s];
        acc[u].x = fmaf(x.x, w, acc[u].x);
        acc[u].y = fmaf(x.y, w, acc[u].y);
      }
    }
#pragma unroll
    for (int u = 0; u < MERGE_ILP; ++u) {
      if (base + u * static_cast<int>(blockDim.x) >= total) break;
      *reinterpret_cast<float2*>(o + out[u]) = acc[u];
    }
  }
}

}  // namespace paged_attn
