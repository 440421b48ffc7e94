// Helpers shared by the port's attention kernels (paged decode and prefill,
// flash prefill).
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

}  // namespace paged_attn
