// Helpers shared by the port's attention kernels (paged decode and prefill,
// flash prefill), and the split-KV merge of the two paged kernels.
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
