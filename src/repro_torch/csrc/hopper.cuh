// Hopper (sm_90a) building blocks of the port's kernels, written in PTX:
// tensor maps and TMA loads (cp.async.bulk.tensor), a cache of encoded
// maps, mbarriers, the async-proxy fence and named barriers, wgmma (bf16
// and tf32) with shared-memory descriptors (128-byte swizzle, and the
// no-swizzle layout of the float32 kernels' V^T) and register-A operands,
// the S = Q K^T and O += P V steps of the attention kernels built on
// them (bf16 hi + lo; 3xTF32 for float32, with its operand split), and
// setmaxnreg. The flash-prefill and paged prefill-chunk kernels run on
// all of them; the paged decode kernel on the maps and barriers.
//
// Shared-memory tiles are the layout a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B writes: boxes of 128 bytes a row (64 bf16 or
// 32 float32 columns), rows 128 bytes apart, the 16-byte chunks of row r
// XOR-ed with r % 8 (swz128 gives an element's address); every box starts
// on 1,024 bytes. A descriptor (smem_desc) names such a bf16 tile to
// wgmma:
// - K-major (the reduction dimension contiguous: q and K for S = Q K^T):
//   8-row groups 1,024 bytes apart (SBO); a k16 step inside a box moves
//   the start by 32 bytes, the next box by its size.
// - MN-major (V for O += P V, read transposed, which bf16 allows): the
//   reduction runs down the rows, 8-row groups 1,024 bytes apart (SBO),
//   the next 64 output columns one box further (LBO); a k16 step moves
//   the start by 16 rows (2,048 bytes).
// wgmma's float32 accumulator of an m64nN tile gives warp w of the
// warpgroup rows 16 w + lane / 4 and + 8, columns 8 j + 2 (lane % 4) + {0,
// 1} for j < N / 8: the m16n8 fragment of mma.sync, so the register-A
// operand of the next product (rows as above, k16 chunks of 4 registers)
// is built from it in place.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <unordered_map>

namespace hopper {

// ---------------------------------------------------------------------
// Tensor maps (host).
// ---------------------------------------------------------------------
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime's entry-point
// query (no link against libcuda); null if the driver does not have it.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// Map of a contiguous tensor [d3][d2][d1][d0] (d0 innermost) of bf16
// (elem_bytes 2) or float32 (4) whose boxes are {128 / elem_bytes, 1,
// rows, 1}: 128 bytes of columns of one (d1) slice over `rows`
// consecutive d2 indices, written to shared memory with the 128-byte
// swizzle. Reads outside the tensor (past d0 or d2) fill zeros. nr > 0
// makes it a 5-D map over nr such tensors (ranks), rank_stride elements
// apart (any stride that is a multiple of 16 bytes; 0: packed), boxes of
// one rank, loaded with tma_load_5d. Returns 0 or a CUDA error code.
inline int encode_rows_map(CUtensorMap* map, const void* base, uint64_t d0,
                           uint64_t d1, uint64_t d2, uint64_t d3,
                           uint32_t rows, uint32_t elem_bytes = 2,
                           uint64_t nr = 0, uint64_t rank_stride = 0) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (elem_bytes != 2 && elem_bytes != 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t slab = d0 * d1 * d2 * d3 * elem_bytes;
  const cuuint64_t dims[5] = {d0, d1, d2, d3, nr};
  const cuuint64_t strides[4] = {
      d0 * elem_bytes, d0 * d1 * elem_bytes, d0 * d1 * d2 * elem_bytes,
      rank_stride ? rank_stride * elem_bytes : slab};
  const cuuint32_t box[5] = {128 / elem_bytes, 1, rows, 1, 1};
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map,
      elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      nr ? 5 : 4, const_cast<void*>(base), dims, strides, box, one,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// encode_rows_map through a cache of up to MAP_CACHE maps, keyed on every
// argument (the rank count and stride too: two views of one base with
// other strides are other maps), emptied when full: the paged kernels'
// pools never move, so a served step pays no encode (a few microseconds
// of host time a map) after its first. A served global step asks for two
// maps a layer's view of the pool (28 x 2 for qwen3), a per-instance step
// as many for each instance. map_encodes() counts the encodes. Safe to
// call from several host threads.
constexpr int MAP_CACHE = 1024;

struct MapKey {
  const void* base;
  uint64_t d[4], nr, rank_stride;
  uint32_t rows, elem_bytes;
  bool operator==(const MapKey& o) const {
    return base == o.base && rows == o.rows && elem_bytes == o.elem_bytes &&
           nr == o.nr && rank_stride == o.rank_stride &&
           std::memcmp(d, o.d, sizeof(d)) == 0;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    uint64_t h = reinterpret_cast<uintptr_t>(k.base);
    const uint64_t v[8] = {k.d[0], k.d[1], k.d[2], k.d[3], k.nr,
                           k.rank_stride, k.rows, k.elem_bytes};
    for (uint64_t x : v) h = (h ^ x) * 0x100000001b3ull;
    return static_cast<size_t>(h ^ (h >> 29));
  }
};

inline unsigned long long& map_encodes() {
  static unsigned long long n = 0;
  return n;
}

inline int cached_rows_map(CUtensorMap* map, const void* base, uint64_t d0,
                           uint64_t d1, uint64_t d2, uint64_t d3,
                           uint32_t rows, uint32_t elem_bytes = 2,
                           uint64_t nr = 0, uint64_t rank_stride = 0) {
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  static std::mutex mu;
  const MapKey key{base, {d0, d1, d2, d3}, nr, rank_stride, rows,
                   elem_bytes};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return 0;
  }
  if (int err = encode_rows_map(map, base, d0, d1, d2, d3, rows, elem_bytes,
                                nr, rank_stride))
    return err;
  ++map_encodes();
  if (cache.size() >= MAP_CACHE) cache.clear();
  cache.emplace(key, *map);
  return 0;
}

constexpr int MAX_DEVICES = 64;

// Raise kern's dynamic shared-memory limit on the current device to at
// least `bytes` (and prefer the largest carve-out): allowed[] is the
// calling instantiation's own record of the limit set on each device, so
// the attribute is set only when a launch needs more.
template <typename Kern>
int allow_smem(Kern kern, size_t bytes, int* allowed) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < MAX_DEVICES && allowed[dev] >= static_cast<int>(bytes)) return 0;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < MAX_DEVICES) allowed[dev] = static_cast<int>(bytes);
  return 0;
}

// The most dynamic shared memory a block may ask for on the current
// device (0 if the query fails), read once a device.
inline int max_smem_optin() {
  static int known[MAX_DEVICES] = {};
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < MAX_DEVICES && known[dev]) return known[dev];
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  if (dev < MAX_DEVICES) known[dev] = v;
  return v;
}

// Shared-memory address of byte `col` of row `row` in a tile of 128-byte
// swizzled boxes of `box_rows` rows each, starting at `tile`.
__device__ __forceinline__ uint32_t swz128(uint32_t tile, int box_rows,
                                           int row, int col) {
  return tile + (col >> 7) * box_rows * 128 + row * 128 +
         ((((col >> 4) & 7) ^ (row & 7)) << 4) + (col & 15);
}

// ---------------------------------------------------------------------
// TMA and mbarriers (device). Addresses are shared-state (32-bit).
// ---------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Make initialized barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive and expect `bytes` more of transactions in the current phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// A position in a ring of N slots guarded by mbarriers: the slot and the
// parity of the ring's current pass.
template <int N>
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ void next() {
    if (++slot == N) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map at coordinates {c0, c1, c2, c3} into
// shared memory at dst; completes `bar`'s transactions by its bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// One box of a 5-D tensor map at coordinates {c0, .., c4}.
__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy accesses (wgmma operand reads, TMA writes of a reused slot).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads) over `count` threads, whole
// warps.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------
// Register hand-off between warpgroups (a whole warpgroup executes it).
// ---------------------------------------------------------------------
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------
// wgmma (a warpgroup of 128 threads issues each one together).
// ---------------------------------------------------------------------
// Descriptor of a 128-byte-swizzled shared-memory tile starting at addr
// (see the header): lbo and sbo in bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFFu) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) |
         (1ull << 62);
}

// Orders this thread's register writes before the wgmmas that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator or A-fragment registers in place around an
// asynchronous wgmma: the compiler may not move their reads or writes
// across this point.
template <int NJ>
__device__ __forceinline__ void fence_regs(float (&d)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

template <int NK>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[NK][4]) {
#pragma unroll
  for (int k = 0; k < NK; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[k][e])::"memory");
}

#define HK_D4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define HK_O4(j) "=f"(d[j][0]), "=f"(d[j][1]), "=f"(d[j][2]), "=f"(d[j][3])

// d (64 x N, float32) += A B^T, A (64 x 16) and B (N x 16) bf16 in
// shared memory, both K-major.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t da,
                                         uint64_t db);

// d (64 x N, float32) = A B^T (scale-d 0), d write-only:
// the values d held before are dead, so no write to them elsewhere is
// taken for a hazard of the pending wgmmas.
template <int N>
__device__ __forceinline__ void wgmma_ss_init(float (&d)[N / 8][4],
                                              uint64_t da, uint64_t db);

// d (64 x N, float32) += A B, A (64 x 16) bf16 from registers (4 words a
// thread, the m16n8k16 A fragment of the thread's warp), B (16 x N) bf16
// in shared memory, MN-major (read transposed).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4],
                                         const uint32_t (&a)[4], uint64_t db);

// float32 on the tensor cores (3xTF32; see issue_qk_tf32): wgmma's tf32
// forms, k8 a step (32 bytes of each operand, the bytes of a bf16 k16
// step). tf32 takes shared-memory operands K-major only (no transpose
// immediates), so P V reads a transposed copy of V (split_v_tile).
//
// d (64 x N, float32) += A B^T, A (64 x 8) and B (N x 8) tf32 in shared
// memory, both K-major.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 8][4],
                                              uint64_t da, uint64_t db);

// d (64 x N) = A B^T (scale-d 0), d write-only, as wgmma_ss_init.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss_init(float (&d)[N / 8][4],
                                                   uint64_t da, uint64_t db);

// d (64 x N, float32) += A B, A (64 x 8) tf32 from registers (4 words a
// thread: rows 16 w + lane / 4 and + 8, columns lane % 4 and + 4, the
// m16n8k8 tf32 A fragment of warp w), B (8 x N) tf32 in shared memory,
// K-major.
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db);

// d (64 x N) = A B (scale-d 0), A from registers, d write-only.
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs_init(float (&d)[N / 8][4],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[8][4],
                                             uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HK_D4(0), HK_D4(1), HK_D4(2), HK_D4(3),
        HK_D4(4), HK_D4(5), HK_D4(6), HK_D4(7)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[16][4],
                                              uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HK_D4(0), HK_D4(1), HK_D4(2), HK_D4(3),
        HK_D4(4), HK_D4(5), HK_D4(6), HK_D4(7),
        HK_D4(8), HK_D4(9), HK_D4(10), HK_D4(11),
        HK_D4(12), HK_D4(13), HK_D4(14), HK_D4(15)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_init<64>(float (&d)[8][4],
                                                  uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HK_O4(0), HK_O4(1), HK_O4(2), HK_O4(3),
        HK_O4(4), HK_O4(5), HK_O4(6), HK_O4(7)
      : "l"(da), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_ss_init<128>(float (&d)[16][4],
                                                  uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HK_O4(0), HK_O4(1), HK_O4(2), HK_O4(3),
        HK_O4(4), HK_O4(5), HK_O4(6), HK_O4(7),
        HK_O4(8), HK_O4(9), HK_O4(10), HK_O4(11),
        HK_O4(12), HK_O4(13), HK_O4(14), HK_O4(15)
      : "l"(da), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HK_D4(0), HK_D4(1), HK_D4(2), HK_D4(3),
        HK_D4(4), HK_D4(5), HK_D4(6), HK_D4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[16][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HK_D4(0), HK_D4(1), HK_D4(2), HK_D4(3),
        HK_D4(4), HK_D4(5), HK_D4(6), HK_D4(7),
        HK_D4(8), HK_D4(9), HK_D4(10), HK_D4(11),
        HK_D4(12), HK_D4(13), HK_D4(14), HK_D4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[32][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : HK_D4(0), HK_D4(1), HK_D4(2), HK_D4(3),
        HK_D4(4), HK_D4(5), HK_D4(6), HK_D4(7),
        HK_D4(8), HK_D4(9), HK_D4(10), HK_D4(11),
        HK_D4(12), HK_D4(13), HK_D4(14), HK_D4(15),
        HK_D4(16), HK_D4(17), HK_D4(18), HK_D4(19),
        HK_D4(20), HK_D4(21), HK_D4(22), HK_D4(23),
        HK_D4(24), HK_D4(25), HK_D4(26), HK_D4(27),
        HK_D4(28), HK_D4(29), HK_D4(30), HK_D4(31)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<16>(float (&d)[2][4],
    uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : HK_D4(0), HK_D4(1)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss_init<16>(float (&d)[2][4],
    uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : HK_O4(0), HK_O4(1)
      : "l"(da), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<32>(float (&d)[4][4],
    uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : HK_D4(0), HK_D4(1), HK_D4(2), HK_D4(3)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<64>(float (&d)[8][4],
    uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : HK_D4(0), HK_D4(1), HK_D4(2), HK_D4(3),
        HK_D4(4), HK_D4(5), HK_D4(6), HK_D4(7)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[8][4],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : HK_D4(0), HK_D4(1), HK_D4(2), HK_D4(3),
        HK_D4(4), HK_D4(5), HK_D4(6), HK_D4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float (&d)[16][4],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : HK_D4(0), HK_D4(1), HK_D4(2), HK_D4(3),
        HK_D4(4), HK_D4(5), HK_D4(6), HK_D4(7),
        HK_D4(8), HK_D4(9), HK_D4(10), HK_D4(11),
        HK_D4(12), HK_D4(13), HK_D4(14), HK_D4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<256>(float (&d)[32][4],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : HK_D4(0), HK_D4(1), HK_D4(2), HK_D4(3),
        HK_D4(4), HK_D4(5), HK_D4(6), HK_D4(7),
        HK_D4(8), HK_D4(9), HK_D4(10), HK_D4(11),
        HK_D4(12), HK_D4(13), HK_D4(14), HK_D4(15),
        HK_D4(16), HK_D4(17), HK_D4(18), HK_D4(19),
        HK_D4(20), HK_D4(21), HK_D4(22), HK_D4(23),
        HK_D4(24), HK_D4(25), HK_D4(26), HK_D4(27),
        HK_D4(28), HK_D4(29), HK_D4(30), HK_D4(31)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<32>(float (&d)[4][4],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : HK_D4(0), HK_D4(1), HK_D4(2), HK_D4(3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs_init<32>(float (&d)[4][4],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : HK_O4(0), HK_O4(1), HK_O4(2), HK_O4(3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs_init<64>(float (&d)[8][4],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : HK_O4(0), HK_O4(1), HK_O4(2), HK_O4(3),
        HK_O4(4), HK_O4(5), HK_O4(6), HK_O4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

#undef HK_D4
#undef HK_O4

// S = Q K^T of one tile of BN keys, issued (not committed): DMAX / 16 k16
// steps of wgmma from the q boxes (QROWS rows each) and the K boxes (BN
// rows each), 32 bytes a step inside a box, the first step writing s
// afresh. Steps past the data's D multiply TMA's (or the caller's) zero
// fill: skipping them on a runtime D would make the compiler serialize
// the wgmmas.
template <int DMAX, int BN, int QROWS>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 8][4],
                                         uint64_t q_desc, uint64_t k_desc) {
  wgmma_ss_init<BN>(s, q_desc, k_desc);
#pragma unroll
  for (int kk = 1; kk < DMAX / 16; ++kk) {
    const uint32_t qo = ((kk / 4) * QROWS * 128 + (kk % 4) * 32) >> 4;
    const uint32_t ko = ((kk / 4) * BN * 128 + (kk % 4) * 32) >> 4;
    wgmma_ss<BN>(s, q_desc + qo, k_desc + ko);
  }
}

// O += P_hi V, then O += P_lo V, issued (not committed): a k16 step is 16
// V rows (2,048 bytes) further.
template <int DMAX, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[DMAX / 8][4],
                                         const uint32_t (&ph)[BN / 16][4],
                                         const uint32_t (&pl)[BN / 16][4],
                                         uint64_t v_desc) {
#pragma unroll
  for (int kc = 0; kc < BN / 16; ++kc)
    wgmma_rs<DMAX>(o, ph[kc], v_desc + ((kc * 16 * 128) >> 4));
#pragma unroll
  for (int kc = 0; kc < BN / 16; ++kc)
    wgmma_rs<DMAX>(o, pl[kc], v_desc + ((kc * 16 * 128) >> 4));
}

// ---------------------------------------------------------------------
// 3xTF32: float32 products on the tf32 tensor cores.
// ---------------------------------------------------------------------
// A float32 x is carried as hi = trunc_tf32(x) and lo = x - hi. The tf32
// tensor cores ignore the low 13 mantissa bits of a 32-bit operand (they
// truncate it to tf32): so x itself, unmodified, is the operand hi, and
// no copy of it is made; lo = x - (x with its low 13 bits cleared) is
// exact in float32, |lo| < 2^-10 |x|, and the hardware's truncation of
// lo in turn loses less than 2^-20 |x|. A product x y runs as hi_x hi_y +
// hi_x lo_y + lo_x hi_y, the dropped lo_x lo_y under 2^-20 |x y|. One
// tf32 product alone is off by up to 2^-9 |x y|. The truncation is the
// hardware's, not assumed: tests/test_torch_cuda.py feeds the kernels
// inputs whose low 13 bits are 0x1FFF, where rounding an operand would
// move each by a tf32 ulp (2^-10) and miss 1e-4; tests/test_torch_
// kernels.py emulates the split on the CPU.
__device__ __forceinline__ uint32_t tf32_lo(float x) {
  return __float_as_uint(x - __uint_as_float(__float_as_uint(x) &
                                             0xFFFFE000u));
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = tf32_lo(x);
}

__device__ __forceinline__ uint4 tf32_lo4(const float4& x) {
  return make_uint4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
}

// Descriptor of a tile in wgmma's no-swizzle (interleaved) K-major
// layout: 8-row x 16-byte core matrices of 128 contiguous bytes, the next
// core matrix along K lbo bytes further, along M/N sbo bytes further.
__device__ __forceinline__ uint64_t smem_desc_plain(uint32_t addr,
                                                    uint32_t lbo,
                                                    uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFFu) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32);
}

// S = Q K^T of one tile of BN keys in 3xTF32, issued (not committed):
// for each of the DMAX / 8 k8 steps, q_hi K_hi, q_hi K_lo and q_lo K_hi
// from the 128-byte-swizzled q (QROWS rows a box) and K (BN rows a box)
// halves, 32 bytes a step inside a box; the first product writes s
// afresh. Every step runs (columns past the data are zeros).
template <int DMAX, int BN, int QROWS>
__device__ __forceinline__ void issue_qk_tf32(float (&s)[BN / 8][4],
                                              uint64_t qh, uint64_t ql,
                                              uint64_t kh, uint64_t kl) {
  // Opaque here, so that the step offsets are added at each issue: with
  // one stage every descriptor is loop-invariant, and hoisting all 4 x
  // DMAX / 8 of them (256 registers at D 256) made ptxas spill.
  asm volatile("" : "+l"(qh), "+l"(ql), "+l"(kh), "+l"(kl));
  wgmma_tf32_ss_init<BN>(s, qh, kh);
  wgmma_tf32_ss<BN>(s, qh, kl);
  wgmma_tf32_ss<BN>(s, ql, kh);
#pragma unroll
  for (int kk = 1; kk < DMAX / 8; ++kk) {
    const uint32_t qo = ((kk / 4) * QROWS * 128 + (kk % 4) * 32) >> 4;
    const uint32_t ko = ((kk / 4) * BN * 128 + (kk % 4) * 32) >> 4;
    wgmma_tf32_ss<BN>(s, qh + qo, kh + ko);
    wgmma_tf32_ss<BN>(s, qh + qo, kl + ko);
    wgmma_tf32_ss<BN>(s, ql + qo, kh + ko);
  }
}

// issue_qk_tf32 with q_hi as register-A fragments (qa[kk]: k8 step kk of
// the warp's rows) and q_lo in shared memory: q_hi K_hi and q_hi K_lo
// read only K from shared memory.
template <int DMAX, int BN, int QROWS>
__device__ __forceinline__ void issue_qk_tf32_rs(
    float (&s)[BN / 8][4], const uint32_t (&qa)[DMAX / 8][4], uint64_t ql,
    uint64_t kh, uint64_t kl) {
  asm volatile("" : "+l"(ql), "+l"(kh), "+l"(kl));
  wgmma_tf32_rs_init<BN>(s, qa[0], kh);
  wgmma_tf32_rs<BN>(s, qa[0], kl);
  wgmma_tf32_ss<BN>(s, ql, kh);
#pragma unroll
  for (int kk = 1; kk < DMAX / 8; ++kk) {
    const uint32_t qo = ((kk / 4) * QROWS * 128 + (kk % 4) * 32) >> 4;
    const uint32_t ko = ((kk / 4) * BN * 128 + (kk % 4) * 32) >> 4;
    wgmma_tf32_rs<BN>(s, qa[kk], kh + ko);
    wgmma_tf32_rs<BN>(s, qa[kk], kl + ko);
    wgmma_tf32_ss<BN>(s, ql + qo, kh + ko);
  }
}

// The float32 probabilities of a score tile as the tf32 hi and lo A
// fragments of P V: k8 step j from the accumulator's n8 chunk j. The
// accumulator gives a thread keys 2 (lane % 4) and + 1 of the chunk, the
// A fragment wants k = lane % 4 and + 4, so P V's k order within each
// 8-key group is k = i / 2 + 4 (i % 2) for key i, and split_v_tile
// writes V^T in that order.
template <int NJ>
__device__ __forceinline__ void split_probs_tf32(const float (&s)[NJ][4],
                                                 uint32_t (&ph)[NJ][4],
                                                 uint32_t (&pl)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    split_tf32(s[j][0], ph[j][0], pl[j][0]);
    split_tf32(s[j][2], ph[j][1], pl[j][1]);
    split_tf32(s[j][1], ph[j][2], pl[j][2]);
    split_tf32(s[j][3], ph[j][3], pl[j][3]);
  }
}

// O += P V in 3xTF32, issued (not committed): for each k8 step, P_hi V_hi,
// P_hi V_lo and P_lo V_hi, V^T in split_v_tile's layout (a k8 step is two
// core-matrix columns, 2 * 16 * DMAX bytes, further).
template <int DMAX, int BN>
__device__ __forceinline__ void issue_pv_tf32(float (&o)[DMAX / 8][4],
                                              const uint32_t (&ph)[BN / 8][4],
                                              const uint32_t (&pl)[BN / 8][4],
                                              uint64_t vh, uint64_t vl) {
  asm volatile("" : "+l"(vh), "+l"(vl));
#pragma unroll
  for (int kc = 0; kc < BN / 8; ++kc) {
    const uint32_t off = (kc * 2 * 16 * DMAX) >> 4;
    wgmma_tf32_rs<DMAX>(o, ph[kc], vh + off);
    wgmma_tf32_rs<DMAX>(o, ph[kc], vl + off);
    wgmma_tf32_rs<DMAX>(o, pl[kc], vh + off);
  }
}

// The hi halves (the raw values) of a warp's 16 rows of q as
// issue_qk_tf32_rs's register-A fragments (k8 step kk: rows lane / 4 and + 8, columns 8 kk +
// lane % 4 and + 4). row_of(i) gives the warp's row i (0-15) in global
// memory, or null for a row past the data (zeros); columns at or past D
// are zeros.
template <int DMAX, typename RowFn>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[DMAX / 8][4],
                                             RowFn row_of, int D) {
  const int lane = threadIdx.x & 31;
  const float* r0 = row_of(lane >> 2);
  const float* r1 = row_of((lane >> 2) + 8);
  const int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < DMAX / 8; ++kk) {
    const int c0 = kk * 8 + t, c1 = c0 + 4;
    qa[kk][0] = __float_as_uint(r0 != nullptr && c0 < D ? r0[c0] : 0.f);
    qa[kk][1] = __float_as_uint(r1 != nullptr && c0 < D ? r1[c0] : 0.f);
    qa[kk][2] = __float_as_uint(r0 != nullptr && c1 < D ? r0[c1] : 0.f);
    qa[kk][3] = __float_as_uint(r1 != nullptr && c1 < D ? r1[c1] : 0.f);
  }
}

// Byte offset of float column d of row r in a tile of 128-byte-swizzled
// boxes of 32 float32 columns and box_rows rows (a TMA load's layout).
__device__ __forceinline__ int swz128_f32(int box_rows, int r, int d) {
  return (d >> 5) * box_rows * 128 + r * 128 +
         ((((d >> 2) & 7) ^ (r & 7)) << 4) + (d & 3) * 4;
}

// A K tile's lo half: every 16 bytes of the raw tile (bytes of it, TMA's
// layout, which S reads K-major and whose raw values are its hi half)
// give lo at the same offset. Threads [0, nthreads) of the caller share
// the work.
__device__ __forceinline__ void split_k_tile(const unsigned char* raw,
                                             unsigned char* lo, int bytes,
                                             int tid, int nthreads) {
#pragma unroll 2
  for (int o = tid * 16; o < bytes; o += nthreads * 16)
    *reinterpret_cast<uint4*>(lo + o) =
        tf32_lo4(*reinterpret_cast<const float4*>(raw + o));
}

// A V tile's tf32 halves, transposed for P V: V^T is DMAX rows (d) by BN
// keys in the no-swizzle K-major layout (the 4 keys of core-matrix column
// m at m * 16 * DMAX bytes, row d 16 d bytes in), keys in P V's order
// (split_probs_tf32: key i of an 8-key group at k = i / 2 + 4 (i % 2)).
// raw: BN rows of DMAX in TMA's 128-byte-swizzled boxes. Keys at or past
// nv are written as zeros, whatever the raw rows hold (stale or never
// loaded rows: 0 x NaN is NaN inside wgmma). A thread takes one d and one
// column m: four reads of one swizzled row each (a warp's 32 d read
// whole rows), two 16-byte stores (a warp's stores contiguous).
template <int DMAX, int BN>
__device__ __forceinline__ void split_v_tile(const unsigned char* raw,
                                             unsigned char* hi,
                                             unsigned char* lo, int nv,
                                             int tid, int nthreads) {
#pragma unroll 2
  for (int idx = tid; idx < (BN / 4) * DMAX; idx += nthreads) {
    const int m = idx / DMAX, d = idx - m * DMAX;
    const int k0 = (m >> 1) * 8 + (m & 1);  // keys k0, k0 + 2, + 4, + 6
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 2 * e;
      x[e] = key < nv ? *reinterpret_cast<const float*>(
                            raw + swz128_f32(BN, key, d))
                      : 0.f;
    }
    const float4 v = make_float4(x[0], x[1], x[2], x[3]);
    const int off = m * 16 * DMAX + 16 * d;
    *reinterpret_cast<float4*>(hi + off) = v;
    *reinterpret_cast<uint4*>(lo + off) = tf32_lo4(v);
  }
}

}  // namespace hopper
