// Hopper (sm_90a) building blocks of the port's kernels, written in PTX:
// tensor maps and TMA loads (cp.async.bulk.tensor), a cache of encoded
// maps, mbarriers, the async-proxy fence and named barriers, wgmma with
// shared-memory descriptors (128-byte swizzle) and register-A operands,
// the S = Q K^T and O += P V steps of the attention kernels built on
// them, and setmaxnreg. The flash-prefill and paged prefill-chunk kernels
// run on all of them; the paged decode kernel on the maps and barriers.
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
// swizzle. Reads outside the tensor (past d0 or d2) fill zeros. Returns 0
// or a CUDA error code.
inline int encode_rows_map(CUtensorMap* map, const void* base, uint64_t d0,
                           uint64_t d1, uint64_t d2, uint64_t d3,
                           uint32_t rows, uint32_t elem_bytes = 2) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (elem_bytes != 2 && elem_bytes != 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[4] = {d0, d1, d2, d3};
  const cuuint64_t strides[3] = {d0 * elem_bytes, d0 * d1 * elem_bytes,
                                 d0 * d1 * d2 * elem_bytes};
  const cuuint32_t box[4] = {128 / elem_bytes, 1, rows, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(base), dims, strides, box, one,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// encode_rows_map through a cache of the last MAP_CACHE maps, keyed on
// every argument: the paged kernels' pools never move, so a served step
// pays no encode (a few microseconds of host time a map) after its first.
// Safe to call from several host threads.
constexpr int MAP_CACHE = 64;

inline int cached_rows_map(CUtensorMap* map, const void* base, uint64_t d0,
                           uint64_t d1, uint64_t d2, uint64_t d3,
                           uint32_t rows, uint32_t elem_bytes = 2) {
  struct Entry {
    const void* base;
    uint64_t d[4];
    uint32_t rows, elem_bytes;
    CUtensorMap map;
  };
  static Entry cache[MAP_CACHE];
  static int filled = 0, next = 0;
  static std::mutex mu;
  const Entry key{base, {d0, d1, d2, d3}, rows, elem_bytes, {}};
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < filled; ++i) {
    const Entry& e = cache[i];
    if (e.base == key.base && e.rows == key.rows &&
        e.elem_bytes == key.elem_bytes &&
        std::memcmp(e.d, key.d, sizeof(key.d)) == 0) {
      *map = e.map;
      return 0;
    }
  }
  if (int err = encode_rows_map(map, base, d0, d1, d2, d3, rows, elem_bytes))
    return err;
  cache[next] = key;
  cache[next].map = *map;
  next = (next + 1) % MAP_CACHE;
  if (filled < MAP_CACHE) ++filled;
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

}  // namespace hopper
