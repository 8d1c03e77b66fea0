// Hopper building blocks shared by the tensor-core bodies of K1
// (flash_attention.cu and its backward, flash_attention_bwd.cu), K3
// (paged_verify_wgmma.cuh) and K6
// (stx_matmul.cu), and by the TMA rings of K5 (rglru_scan.cu), K7b
// (stx_stencil.cu) and K8 (vrp_dot.cu), as inline PTX for sm_90a:
//   * mbarriers: init, arrive, arrive with an expected transaction count,
//     a wait on a phase's parity, and the same wait with a deadline that
//     traps (bar_wait) for the rings; a named barrier (one warpgroup);
//   * TMA tile loads (cp.async.bulk.tensor, 2-D, 3-D and 4-D) and plain
//     bulk copies that complete on an mbarrier, the tiles from a
//     CUtensorMap passed to the kernel by
//     value as a __grid_constant__ parameter (never written to a device
//     buffer, so a launch can be captured in a CUDA graph);
//   * the host-side encoders of those maps (bf16 with the 128-byte
//     swizzle, and plain f32 / bf16 boxes with no swizzle):
//     cuTensorMapEncodeTiled is a driver function, fetched once through
//     cudaGetDriverEntryPoint so that the library links no libcuda;
//   * the shared-memory matrix descriptor of wgmma for the 128-byte
//     swizzle that the maps write (every tile is a column of 64 bf16 =
//     128 bytes a row, 1024-byte aligned, 8-row swizzle atoms of 1024 B);
//   * wgmma.mma_async m64nNk16 f32 += bf16 * bf16 for N = 64, 128, 256,
//     with A from shared memory (ss) or from registers (rs), and the
//     fence / commit / wait around it.
//
// Operand majorness: a "K-major" operand has the reduction dimension
// contiguous (x of K6, q and k of K1); an "MN-major" one has M or N
// contiguous (w (K, N) of K6, v (keys, D) of K1), which wgmma reads
// through its transpose bit (bf16 only).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {
namespace hopper {

// ---------------------------------------------------------------------------
// shared memory addresses and mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and to
// the other threads; followed by a __syncthreads().
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival that also announces `bytes` of TMA transactions: the phase
// completes when every arrival is in and the bytes have landed.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` has completed. A fresh barrier
// is in phase 0: waiting on parity 1 returns at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// mbar_wait with a deadline: a phase that never completes (a fault in a
// ring's protocol) traps after 4 s instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t t = globaltimer();
    if (t0 == 0) t0 = t;
    else if (t - t0 > 4000000000ull) __trap();
  }
}

// ---------------------------------------------------------------------------
// TMA tile loads (global -> shared, completing on an mbarrier). Elements of
// the box outside the tensor's dims are written as zeros and still count
// toward the transaction bytes.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A plain bulk copy of `bytes` contiguous bytes (a multiple of 16; both
// addresses 16-byte aligned), completing on an mbarrier like the tiles.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// host: tensor maps (bf16 with the 128-byte swizzle; plain f32 / bf16 tiles)
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A rank-`rank` (1..5) map over a dense tensor of `type`: dims[0] is the
// contiguous one, strides[i] the byte stride of dims[i + 1] (multiples of
// 16), box the tile each load writes (box[0] times the element size a
// multiple of 16 bytes). Coordinates may be negative, but the innermost
// one must put the box's start on 16 bytes (else the load faults with an
// illegal instruction); elements of the box outside the dims load as
// zeros. False when the driver refuses the map (a base that is not
// 16-byte aligned, a stride that is not a multiple of 16) or its entry
// point is missing.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                       const void* base, const uint64_t* dims,
                       const uint64_t* strides, const uint32_t* box,
                       CUtensorMapSwizzle swizzle,
                       CUtensorMapL2promotion l2) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  return fn(map, type, rank, const_cast<void*>(base), d, s, b, e,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, l2,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor cores' bf16 operands: the 128-byte swizzle, so box[0] must be
// 64 (128 bytes, the swizzle's row).
inline bool make_bf16_map(CUtensorMap* map, const void* base, int rank,
                          const uint64_t* dims, const uint64_t* strides,
                          const uint32_t* box) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, base, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

// The rings' f32 / bf16 tiles (K5, K7b, K8): no swizzle, each box written
// densely into shared memory, row after row.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                     const void* base, const uint64_t* dims,
                     const uint64_t* strides, const uint32_t* box) {
  return encode_map(map, type, rank, base, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// The shared-memory matrix descriptor for a 128-byte-swizzled operand:
// start address >> 4 (bits 0-13), leading byte offset >> 4 (16-29),
// stride byte offset >> 4 (32-45), layout type 1 = 128B swizzle (62-63),
// base offset 0 (the swizzle atoms are 1024-byte aligned).
//   K-major: sbo = 1024 (next group of 8 rows); lbo is not read. A k16
//     step moves the start by 32 bytes inside the 128-byte row.
//   MN-major: lbo = the byte distance between two 64-wide column blocks
//     of M or N (our separate TMA boxes); sbo = 1024 (next 8 k rows). A
//     k16 step moves the start by 16 rows = 2048 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* smem, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(smem) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

// Makes this thread's ordinary shared-memory stores (a tile written by
// threads, not by TMA) visible to the async proxy that wgmma reads
// through; followed by a barrier before the first wgmma on the tile.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A named barrier (ids 1..15; 0 is __syncthreads) over `count` threads,
// a multiple of 32: e.g. the four warps of one warpgroup.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits until every committed wgmma group of this warpgroup is done.
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Waits until at most N committed wgmma groups are still running (groups
// complete in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait_upto() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Makes a value opaque to the compiler at this point, so that what is
// computed from it is not hoisted out of the enclosing loop (wgmma
// descriptors hoisted out of a loop hold registers for its whole length).
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma that is still in flight (it cannot see that wgmma writes
// them asynchronously): call after wgmma_wait and before the next issue.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two f32 as one bf16x2 register, `lo` in the low half (the lower k of a
// register A fragment).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator fragments: thread t of the warpgroup (warp w = t / 32, lane
// l) holds d[4 n + 2 i + j] = D[16 w + l / 4 + 8 i][8 n + 2 (l % 4) + j],
// n < N / 8, i, j in {0, 1}. The register A fragment of a k16 step is the
// same layout over 16 columns: a[0..3] = rows (r, r + 8, r, r + 8) x
// columns (2 (l % 4), +1) and (8 + 2 (l % 4), +1), packed in pairs.
#define REPRO_ACC4(d, i) \
  "+f"(d[i]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define REPRO_ACC16(d, i)                                            \
  REPRO_ACC4(d, i), REPRO_ACC4(d, (i) + 4), REPRO_ACC4(d, (i) + 8), \
      REPRO_ACC4(d, (i) + 12)
#define REPRO_ACC32(d) REPRO_ACC16(d, 0), REPRO_ACC16(d, 16)
#define REPRO_ACC64(d)                                       \
  REPRO_ACC16(d, 0), REPRO_ACC16(d, 16), REPRO_ACC16(d, 32), \
      REPRO_ACC16(d, 48)
#define REPRO_ACC128(d)                                         \
  REPRO_ACC16(d, 0), REPRO_ACC16(d, 16), REPRO_ACC16(d, 32),    \
      REPRO_ACC16(d, 48), REPRO_ACC16(d, 64), REPRO_ACC16(d, 80), \
      REPRO_ACC16(d, 96), REPRO_ACC16(d, 112)

// D (64 x N, f32) += A (64 x 16) * B (16 x N), bf16 operands; scale_d 0
// overwrites D instead. ss: A and B by descriptor; rs: A from registers.
// kTransB 0 for a K-major B, 1 for an MN-major one.
template <int N>
struct Wgmma;

template <> struct Wgmma<64> {
  template <int kTransB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : REPRO_ACC32(d)
        : "l"(a), "l"(b), "r"(scale_d), "n"(kTransB));
  }
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : REPRO_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(kTransB));
  }
};

template <> struct Wgmma<128> {
  template <int kTransB>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : REPRO_ACC64(d)
        : "l"(a), "l"(b), "r"(scale_d), "n"(kTransB));
  }
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : REPRO_ACC64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(kTransB));
  }
};

template <> struct Wgmma<256> {
  template <int kTransB>
  static __device__ __forceinline__ void ss(float (&d)[128], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103,"
        "%104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
        : REPRO_ACC128(d)
        : "l"(a), "l"(b), "r"(scale_d), "n"(kTransB));
  }
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103,"
        "%104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : REPRO_ACC128(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(kTransB));
  }
};

#undef REPRO_ACC4
#undef REPRO_ACC16
#undef REPRO_ACC32
#undef REPRO_ACC64
#undef REPRO_ACC128

}  // namespace hopper
}  // namespace repro
